"""rebvio_tpu_torch: the PyTorch/CUDA port of rebvio_tpu.

The JAX package ``rebvio_tpu`` is the reference; this package carries its
own copies of the numpy-only modules and never imports JAX or ``rebvio_tpu``.
Plain tensor code is PyTorch; the seven Pallas kernels of the JAX package
are hand-written CUDA kernels for Hopper (``csrc/``, bound in
``ops/kernels.py``).
"""

import torch as _torch

# Mirrors rebvio_tpu/__init__.py: the 3x3/6x6 solves, the SO3 compositions
# and the band-matrix frontend need true float32, never TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def resolve_device(device="cuda") -> _torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) raises when no GPU is present: the port never moves to the
    CPU unless the caller asks for it."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "rebvio_tpu_torch: device 'cuda' requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev
