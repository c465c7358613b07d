"""Back end of the port: keyframe maps, loop-closure registration and the
pose graph (rebvio_tpu/ba/).  The Schur bundle adjustment (``problem.py``,
``distributed.py``) is not ported yet."""
