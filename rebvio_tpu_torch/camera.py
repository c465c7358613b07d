"""Camera model helpers (rebvio_tpu/camera.py).  This slice carries only the
forward rad-tan distortion that the synthetic renderer uses; the on-device
undistortion remap comes with the VIO slice."""

from __future__ import annotations

import numpy as np

from rebvio_tpu_torch.configs import CameraConfig


def distort_normalized(cam: CameraConfig, x: np.ndarray, y: np.ndarray):
    """Forward rad-tan distortion of normalized coords (OpenCV model)."""
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return xd, yd
