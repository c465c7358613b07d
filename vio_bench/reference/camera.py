"""Pinhole camera with rad-tan distortion and the on-device undistortion
remap (rebvio_tpu/camera.py).

The reference undistorts every input frame with ``cv::undistort`` through
a camera matrix built from the mean focal length fm (camera.hpp:39,54-58):
for each output pixel, the forward distortion of its normalized ray gives
the source location, sampled bilinearly.  The source grid is computed once
on the host (numpy); the per-frame remap is a four-tap gather on the
device.
"""

from __future__ import annotations

import numpy as np
import torch

from vio_bench.reference.configs import CameraConfig

f32 = torch.float32


def distort_normalized(cam: CameraConfig, x: np.ndarray, y: np.ndarray):
    """Forward rad-tan distortion of normalized coords (OpenCV model)."""
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return xd, yd


def make_undistort_map(cam: CameraConfig) -> np.ndarray:
    """[H,W,2] (src_x, src_y) sampling grid, with the mean-focal camera
    matrix exactly as the reference (camera.hpp:39)."""
    fm = cam.fm
    v, u = np.meshgrid(np.arange(cam.rows, dtype=np.float64),
                       np.arange(cam.cols, dtype=np.float64), indexing="ij")
    x = (u - cam.cx) / fm
    y = (v - cam.cy) / fm
    xd, yd = distort_normalized(cam, x, y)
    src_x = fm * xd + cam.cx
    src_y = fm * yd + cam.cy
    return np.stack([src_x, src_y], axis=-1).astype(np.float32)


class _Taps:
    """The four bilinear taps of a sampling grid: flat source indices
    (clipped) [4,N], per-tap in-bounds masks [4,N] and the fractions."""

    def __init__(self, grid: torch.Tensor, H: int, W: int):
        sx, sy = grid[..., 0].reshape(-1), grid[..., 1].reshape(-1)
        x0, y0 = torch.floor(sx), torch.floor(sy)
        self.fx, self.fy = sx - x0, sy - y0
        x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
        idx, inb = [], []
        for yy, xx in ((y0i, x0i), (y0i, x0i + 1), (y0i + 1, x0i), (y0i + 1, x0i + 1)):
            inb.append((yy >= 0) & (yy < H) & (xx >= 0) & (xx < W))
            idx.append(torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1))
        self.idx = torch.stack(idx)
        self.inb = torch.stack(inb)

    def __call__(self, img: torch.Tensor) -> torch.Tensor:
        """``img`` [..., H, W] -> [..., N]: leading dims (a batch of frames)
        gather at the same taps."""
        v = torch.where(self.inb, img.reshape(*img.shape[:-2], -1)[..., self.idx], 0.0)
        fx, fy = self.fx, self.fy
        out = (v[..., 0, :] * (1 - fx) * (1 - fy) + v[..., 1, :] * fx * (1 - fy)
               + v[..., 2, :] * (1 - fx) * fy + v[..., 3, :] * fx * fy)
        return out


def remap_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img [H,W] at grid [...,2] (src_x, src_y); each tap
    outside the image reads 0 (cv::undistort's constant-zero border)."""
    H, W = img.shape
    return _Taps(grid, H, W)(img).reshape(grid.shape[:-1])


class Undistorter:
    """Precomputed remap + gain, replacing imageCallback's convertTo(x3.0) +
    cv::undistort (rebvio.cpp:38-48), on ``device``.

    Every input dtype takes one path: cast to float32, gain, then the
    four-tap remap of ``remap_bilinear`` with the taps precomputed.  (The
    JAX package packs uint8 pixel pairs into float lanes to get around the
    TPU's byte-bound gather; it computes the same function up to summation
    order, and a GPU gather needs no such layout.)"""

    def __init__(self, cam: CameraConfig, gain: float = 3.0, device="cuda"):
        dev = torch.device(device)
        self.grid = torch.as_tensor(make_undistort_map(cam)).to(dev)
        self.gain = gain
        self._hw = (cam.rows, cam.cols)
        self._taps = _Taps(self.grid, cam.rows, cam.cols)

    def __call__(self, raw: torch.Tensor) -> torch.Tensor:
        """A frame [H, W], or a batch of frames [..., H, W], undistorted over
        the batch in one gather."""
        if tuple(raw.shape[-2:]) != self._hw:
            raise ValueError(f"Undistorter: frame shape {tuple(raw.shape)}, camera {self._hw}")
        img = raw.to(f32) * self.gain
        return self._taps(img).reshape(raw.shape)
