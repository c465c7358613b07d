"""Small fixed-size linear algebra (rebvio_tpu/geometry/linalg.py): the
adjugate 3x3 inverse, the unrolled Cholesky inverse (one CUDA launch on the
card), the pivot-free Gauss-Jordan solve with the reference's NaN
semantics, the SVD solve; and ``lane_matmul``, the product whose lanes under
vmap are the unbatched product's bit for bit."""

from __future__ import annotations

import torch

from rebvio_tpu_torch.ops import kernels


@torch.library.custom_op("rebvio::lane_matmul", mutates_args=())
def lane_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; under torch.func.vmap one product a lane
    (``_lane_matmul_lanes``), so that a lane of the batched step
    (parallel/batch.py) sums as the unbatched step does.  For the products
    whose summation order moves the trajectory: the refinement's Gram over
    all keylines (ops/tracker.py), and on the CPU the frontend's band
    products (kernels.band_matmul_plain; on the card csrc/band_matmul.cu
    keeps a lane's order itself)."""
    return a @ b


@lane_matmul.register_vmap
def _lane_matmul_lanes(info, in_dims, a, b):
    """Each lane's product as the unbatched call makes it: the same shapes
    and strides, so the same library kernel and summation order.  One
    batched product sums in another order; on the card that moved ~1400 of
    16000 keylines' subpixel positions a frame and 1.3e-5 rad of the first
    estimate's rotation, and the pixel walk's integer steps turned that into
    0.02 m of a lane's 120-frame trajectory (tools/lane_ab.py)."""
    da, db = in_dims
    a = a if da is None else a.movedim(da, 0)
    b = b if db is None else b.movedim(db, 0)
    return torch.stack([(a if da is None else a[i]) @ (b if db is None else b[i])
                        for i in range(info.batch_size)]), 0


def invert3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of a 3x3 matrix (definitions.hpp:40-53)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    return adj / det[..., None, None]


def chol_inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverse via an unpivoted Cholesky factorization
    (TooN::Cholesky::get_inverse): NaN on non-positive-definite input.

    ``m`` is a ``[..., n, n]`` float32 batch.  On a CUDA tensor the whole
    recurrence is one launch of csrc/chol_inverse.cu (one thread per matrix,
    n <= 8) with no host round trip; on a CPU tensor it is the plain version
    below.  Both run the same float32 operations in the same order."""
    if not kernels._on_cuda(m):
        return chol_inverse_plain(m)
    return torch.ops.rebvio.chol_inverse(m)


def chol_inverse_plain(m: torch.Tensor) -> torch.Tensor:
    """The same unrolled scalar recurrence as the JAX version
    (_chol_inverse_unrolled), on ``m``'s own device."""
    n = m.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = m[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s) if i == j else s / L[j][j]
    Li = [[None] * n for _ in range(n)]
    for j in range(n):
        Li[j][j] = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = L[i][j] * Li[j][j]
            for k in range(j + 1, i):
                s = s + L[i][k] * Li[k][j]
            Li[i][j] = -s / L[i][i]
    zero = torch.zeros_like(m[..., 0, 0])
    rows = []
    for i in range(n):
        row = []
        for j in range(n):
            s = zero
            for k in range(max(i, j), n):
                s = s + Li[k][i] * Li[k][j]
            row.append(s)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def gj_inverse(m: torch.Tensor) -> torch.Tensor:
    """Unrolled pivot-free Gauss-Jordan inverse (linalg.gj_inverse)."""
    n = m.shape[-1]
    a = torch.cat([m, torch.eye(n, dtype=m.dtype, device=m.device)], dim=-1)
    for i in range(n):
        piv_row = a[i:i + 1, :] / a[i:i + 1, i:i + 1]
        fac = a[:, i:i + 1]
        a = a - fac @ piv_row
        a = torch.cat([a[:i], piv_row, a[i + 1:]], dim=0)
    return a[:, n:]


def gj_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``A^-1 b`` by the unrolled Gauss-Jordan inverse with the reference's
    NaN semantics (linalg.gj_solve): finite-but-singular input -> zeros,
    non-finite input -> NaN propagates."""
    x = (gj_inverse(A) @ b[:, None])[:, 0]
    inputs_finite = torch.isfinite(A).all() & torch.isfinite(b).all()
    singular = inputs_finite & ~torch.isfinite(x).all()
    return torch.where(singular, torch.zeros_like(x), x)


def sym_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct solve for symmetric (near-)PD normal matrices
    (linalg.sym_solve): ``gj_solve``, the path JAX takes at the sizes the
    step solves (n <= 8)."""
    return gj_solve(A, b)


def svd_solve(A: torch.Tensor, b: torch.Tensor, rcond: float = 1e-9) -> torch.Tensor:
    """Least squares by SVD with singular values under ``rcond`` times the
    largest dropped (linalg.svd_solve, TooN::SVD::backsub).  Non-finite
    ``A`` gives NaN, as JAX's SVD does (torch's refuses such input)."""
    finite = torch.isfinite(A).all()
    U, s, Vh = torch.linalg.svd(torch.where(torch.isfinite(A), A, 0.0), full_matrices=False)
    cutoff = rcond * torch.max(s)
    s_inv = torch.where(s > cutoff, 1.0 / torch.where(s > 0, s, 1.0), 0.0)
    x = Vh.T @ (s_inv * (U.T @ b))
    return torch.where(finite, x, torch.full_like(x, float("nan")))
