"""DoG scale space as banded-matrix products (rebvio_tpu/ops/scale_space.py).

The 3-pass box cascade of the reference's FastGaussian is linear and
separable, so each scale is one precomputed sandwich ``L @ img @ R``; the
band matrices are built in numpy (float64) exactly as in the JAX package
and uploaded once per geometry.  The products are plain ``torch.matmul``:
the JAX package left them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from vio_bench.reference.linalg import lane_matmul


def box_widths(sigma: float, n: int = 3) -> Tuple[List[int], float]:
    """Box-filter widths for an n-pass Gaussian(sigma) approximation, and the
    effective sigma after integer rounding (scale_space.cpp:20-35)."""
    w_ideal = math.sqrt(12.0 * sigma * sigma / (n + 1))
    w_l = int(w_ideal)
    if (w_l // 2) * 2 == w_l:
        w_l -= 1
    m = round((3 * n + 4 * n * w_l + n * w_l * w_l - 12.0 * sigma * sigma) / (4 + 4 * w_l))
    widths = [w_l] * m + [w_l + 2] * (n - m)
    sigma_true = math.sqrt((m * w_l * w_l + (n - m) * (w_l + 2.0) * (w_l + 2.0) - n) / 12.0)
    return widths, sigma_true


def _banded_ones(n: int, d: int) -> np.ndarray:
    d2 = d // 2
    i = np.arange(n)
    return (np.abs(i[:, None] - i[None, :]) <= d2).astype(np.float64)


def _clip_counts(n: int, d: int) -> np.ndarray:
    d2 = d // 2
    i = np.arange(n)
    return (np.minimum(i + d2, n - 1) - np.maximum(i - d2, 0) + 1).astype(np.float64)


def _cascade_ops(n: int, widths: List[int]) -> np.ndarray:
    op = np.eye(n)
    for d in widths:
        op = (np.diag(1.0 / _clip_counts(n, d)) @ _banded_ones(n, d)) @ op
    return op


def _offset_band(n: int, d: int) -> np.ndarray:
    d2 = d // 2
    i = np.arange(n)
    diff = i[None, :] - i[:, None]
    return np.where(np.abs(diff) <= d2, diff, 0).astype(np.float64)


class FrontendMatrices(NamedTuple):
    """Device-resident banded operators for one (rows, cols) geometry."""

    LL: torch.Tensor   # [2H,H] stacked scale-0/scale-1 left cascades
    R0: torch.Tensor   # [W,W]
    R1: torch.Tensor   # [W,W]
    S5H: torch.Tensor  # [H,H] 5x5 window row-sum
    S5W: torch.Tensor  # [W,W] 5x5 window col-sum
    XW: torch.Tensor   # [W,W] x-ramp band
    YH: torch.Tensor   # [H,H] y-ramp band


class ScaleSpaceParams:
    """Static parameters of the two-scale DoG pyramid (scale_space.cpp:186)."""

    SIGMA0 = 3.56359
    SCALE_FACTOR = 1.2599

    def __init__(self, rows: int, cols: int, plane_fit_size: int = 2) -> None:
        self.rows, self.cols = rows, cols
        self.widths0, self.sigma0_true = box_widths(self.SIGMA0, 3)
        self.widths1, self.sigma1_true = box_widths(self.sigma0_true * self.SCALE_FACTOR, 3)
        H, W = rows, cols
        d5 = 2 * plane_fit_size + 1
        self._np_mats = dict(
            LL=np.concatenate(
                [_cascade_ops(H, self.widths0), _cascade_ops(H, self.widths1)], axis=0),
            R0=_cascade_ops(W, self.widths0).T,
            R1=_cascade_ops(W, self.widths1).T,
            S5H=_banded_ones(H, d5),
            S5W=_banded_ones(W, d5),
            XW=_offset_band(W, d5).T,
            YH=_offset_band(H, d5),
        )

    def matrices(self, device="cuda") -> FrontendMatrices:
        dev = torch.device(device)
        return FrontendMatrices(**{
            k: torch.as_tensor(v.astype(np.float32), device=dev)
            for k, v in self._np_mats.items()})


def mxu_dot(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """Band-operator product: f32, or bf16 operands with f32 accumulation
    where the profile opts in (EdgeDetectorConfig.frontend_bf16); one
    product a lane under vmap (linalg.lane_matmul)."""
    if not bf16:
        return lane_matmul(a, b)
    # bf16-rounded operands, f32 products and sums
    bf = torch.bfloat16
    return lane_matmul(a.to(bf).to(torch.float32), b.to(bf).to(torch.float32))


def build_scale_space(img: torch.Tensor, mats: FrontendMatrices, bf16: bool = False):
    """Returns (scale0, dog, mag) for a float image (scale_space.cpp:203-233)."""
    H, W = img.shape
    left = mxu_dot(mats.LL, img, bf16)
    s0 = mxu_dot(left[:H], mats.R0, bf16)
    s1 = mxu_dot(left[H:], mats.R1, bf16)
    dog = s1 - s0
    # the central differences inside a zero border
    pad = torch.nn.functional.pad
    dx = pad(s0[1:H - 1, 2:] - s0[1:H - 1, :-2], (1, 1, 1, 1))
    dy = pad(s0[2:, 1:W - 1] - s0[:-2, 1:W - 1], (1, 1, 1, 1))
    mag = dx * dx + dy * dy
    return s0, dog, mag


def smooth(img: torch.Tensor, widths: Tuple[int, ...]) -> torch.Tensor:
    """The standalone box cascade ``L @ img @ R`` for the given widths
    (scale_space.smooth)."""
    H, W = img.shape
    L = torch.as_tensor(_cascade_ops(H, list(widths)), dtype=torch.float32, device=img.device)
    R = torch.as_tensor(_cascade_ops(W, list(widths)).T, dtype=torch.float32, device=img.device)
    return L @ img @ R
