"""DoG scale space as banded-matrix products (rebvio_tpu/ops/scale_space.py).

The 3-pass box cascade of the reference's FastGaussian is linear and
separable, so each scale is one precomputed sandwich ``L @ img @ R``; the
band matrices are built in numpy (float64) exactly as in the JAX package
and uploaded once per geometry, each with its band (``kernels.Band``).  The
JAX package left the products to XLA, outside any Pallas kernel; on the
card each is one launch of csrc/band_matmul.cu over the band, on the CPU
the dense ``torch.matmul``.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch.ops import kernels


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
    """Device-resident banded operators for one (rows, cols) geometry, and
    each one's band by name (``bands``)."""

    LL: torch.Tensor   # [2H,H] stacked scale-0/scale-1 left cascades
    R0: torch.Tensor   # [W,W]
    R1: torch.Tensor   # [W,W]
    S5H: torch.Tensor  # [H,H] 5x5 window row-sum
    S5W: torch.Tensor  # [W,W] 5x5 window col-sum
    XW: torch.Tensor   # [W,W] x-ramp band
    YH: torch.Tensor   # [H,H] y-ramp band
    bands: Dict[str, kernels.Band]


OPERATORS = FrontendMatrices._fields[:-1]
LEFT_OPERATORS = ("LL", "S5H", "YH")    # they multiply from the left; the others from the right
# each operator's dense operand in the frontend (build_scale_space,
# edge_detect._detect_core) in multiples of (rows, cols)
OPERANDS = {"LL": (1, 1), "R0": (1, 1), "R1": (1, 1), "S5H": (1, 3), "S5W": (3, 1), "XW": (1, 1),
            "YH": (1, 1)}


def band_form(op: np.ndarray, left: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(k0 [lines] int32, coef [lines, taps] float32) of a band operator's
    matrix: for each output line (a row of ``op @ X`` where ``left``, else a
    column of ``X @ op``) its first k and the ``taps`` entries from there,
    taps the widest line's run from its first to its last non-zero; a first
    k is pulled back where the run would pass the matrix's end."""
    m = op if left else op.T
    depth = m.shape[1]
    nz = m != 0
    some = nz.any(axis=1)
    first = np.where(some, nz.argmax(axis=1), 0)
    last = np.where(some, depth - 1 - nz[:, ::-1].argmax(axis=1), 0)
    taps = int((last - first).max()) + 1
    k0 = np.minimum(first, depth - taps)
    coef = np.take_along_axis(m, k0[:, None] + np.arange(taps), axis=1)
    return k0.astype(np.int32), np.ascontiguousarray(coef, dtype=np.float32)


def upload(ops: Dict[str, np.ndarray], device) -> FrontendMatrices:
    """The seven float32 operators ``ops`` (numpy, by name) on ``device``,
    with their bands; on the card each band sums as the library's dense
    product at the frontend's shape (kernels.band_library_splits)."""
    dev = resolve_device(device)
    rows, cols = ops["S5H"].shape[0], ops["S5W"].shape[0]
    dense, bands = {}, {}
    for name in OPERATORS:
        left = name in LEFT_OPERATORS
        k0, coef = band_form(ops[name], left)
        tiles = np.asarray(kernels.band_tiles(k0, coef.shape[1]), np.int32)
        dense[name] = torch.as_tensor(ops[name], device=dev)
        band = kernels.Band(torch.as_tensor(k0, device=dev), torch.as_tensor(coef, device=dev),
                            torch.as_tensor(tiles, device=dev), left,
                            ops[name].shape[1 if left else 0],
                            torch.ones((1,), dtype=torch.int32, device=dev))
        if dev.type == "cuda":
            shape = (OPERANDS[name][0] * rows, OPERANDS[name][1] * cols)
            band = band._replace(splits=kernels.band_library_splits(dense[name], band, shape))
        bands[name] = band
    return FrontendMatrices(**dense, bands=bands)


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
        return upload({k: v.astype(np.float32) for k, v in self._np_mats.items()}, device)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def mxu_dot(mats: FrontendMatrices, name: str, x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """Band operator ``name`` of ``mats`` times ``x``: ``op @ x`` for a left
    operator (LEFT_OPERATORS), ``x @ op`` for a right one.  f32, or bf16
    operands with f32 products and sums where the profile opts in
    (EdgeDetectorConfig.frontend_bf16).  On the card one launch of
    csrc/band_matmul.cu, over all lanes under vmap (kernels.band_matmul)."""
    op, band = getattr(mats, name), mats.bands[name]
    if bf16:
        op, band, x = _bf16(op), band._replace(coef=_bf16(band.coef)), _bf16(x)
    return kernels.band_matmul(x, op, band)


def build_scale_space(img: torch.Tensor, mats: FrontendMatrices, bf16: bool = False):
    """Returns (scale0, dog, mag) for a float image (scale_space.cpp:203-233)."""
    H, W = img.shape
    left = mxu_dot(mats, "LL", img, bf16)
    s0 = mxu_dot(mats, "R0", left[:H], bf16)
    s1 = mxu_dot(mats, "R1", left[H:], bf16)
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
