"""Small fixed-size linear algebra (rebvio_tpu/geometry/linalg.py): the
adjugate 3x3 inverse, the unrolled Cholesky inverse (one CUDA launch on the
card) and the pivot-free Gauss-Jordan solve with the reference's NaN
semantics."""

from __future__ import annotations

import torch

from rebvio_tpu_torch.ops import kernels


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


def sym_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct solve for symmetric (near-)PD normal matrices with the
    reference's NaN semantics: finite-but-singular input -> zeros,
    non-finite input -> NaN propagates (linalg.sym_solve / gj_solve)."""
    x = (gj_inverse(A) @ b[:, None])[:, 0]
    inputs_finite = torch.isfinite(A).all() & torch.isfinite(b).all()
    singular = inputs_finite & ~torch.isfinite(x).all()
    return torch.where(singular, torch.zeros_like(x), x)
