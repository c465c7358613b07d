"""Back end of the port: keyframe maps, loop-closure registration, the pose
graph and the Schur-complement bundle adjustment, single-device and
landmark-sharded (rebvio_tpu/ba/)."""
