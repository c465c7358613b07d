"""The port's SO(3) maps and small linear algebra against the JAX package,
on random inputs from numpy seeds, including the small-angle and near-pi
branches and the NaN semantics of the solves."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import t2n  # noqa: E402

from rebvio_tpu.geometry import linalg as jla, so3 as jso3  # noqa: E402
from rebvio_tpu_torch.geometry import linalg as tla, so3 as tso3  # noqa: E402


def _vecs(seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(64, 3)
    ang = np.concatenate([rng.uniform(0, 3.0, 40), rng.uniform(0, 1e-5, 12),
                          np.pi - rng.uniform(0, 5e-4, 12)])
    return (w / np.linalg.norm(w, axis=-1, keepdims=True) * ang[:, None]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_hat_exp_log_match_jax(seed):
    w = _vecs(seed)
    np.testing.assert_array_equal(t2n(tso3.hat(torch.as_tensor(w))),
                                  np.asarray(jso3.hat(jnp.asarray(w))))
    R = np.asarray(jso3.exp(jnp.asarray(w)))
    # float32 Rodrigues: sin/cos of the runtime libraries differ by an ulp
    np.testing.assert_allclose(t2n(tso3.exp(torch.as_tensor(w))), R, rtol=0, atol=2e-6)
    # log near pi goes through arcsin/sqrt of ~1e-4 quantities: 1e-3 there,
    # 1e-5 elsewhere
    lw = t2n(tso3.log(torch.as_tensor(R)))
    lj = np.asarray(jso3.log(jnp.asarray(R)))
    near_pi = np.linalg.norm(w, axis=-1) > np.pi - 1e-3
    np.testing.assert_allclose(lw[~near_pi], lj[~near_pi], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lw[near_pi], lj[near_pi], rtol=0, atol=1e-3)


def test_rotation_between_matches_jax():
    rng = np.random.RandomState(3)
    a = rng.randn(32, 3).astype(np.float32)
    b = rng.randn(32, 3).astype(np.float32)
    b[:4] = -a[:4]                     # antipodal branch
    b[4:8] = a[4:8] * 2.0              # identity
    want = np.asarray(jso3.rotation_between(jnp.asarray(a), jnp.asarray(b)))
    got = t2n(tso3.rotation_between(torch.as_tensor(a), torch.as_tensor(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_invert3_and_chol_inverse_match_jax():
    rng = np.random.RandomState(4)
    for n in (3, 6):
        A = rng.randn(16, n, n).astype(np.float32)
        spd = (A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).astype(np.float32)
        ci = t2n(tla.chol_inverse(torch.as_tensor(spd)))
        np.testing.assert_allclose(ci, np.asarray(jla.chol_inverse(jnp.asarray(spd))),
                                   rtol=1e-5, atol=1e-7)
        if n == 3:
            np.testing.assert_allclose(t2n(tla.invert3(torch.as_tensor(spd))),
                                       np.asarray(jla.invert3(jnp.asarray(spd))),
                                       rtol=1e-5, atol=1e-7)
    # non-positive-definite input: NaN where the JAX version has NaN
    bad = np.diag([1.0, -1.0, 2.0, 1.0, 1.0, 1.0]).astype(np.float32)
    np.testing.assert_array_equal(np.isnan(t2n(tla.chol_inverse(torch.as_tensor(bad)))),
                                  np.isnan(np.asarray(jla.chol_inverse(jnp.asarray(bad)))))


def test_sym_solve_matches_jax_semantics():
    rng = np.random.RandomState(5)
    A = rng.randn(6, 6).astype(np.float32)
    A = (A @ A.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    np.testing.assert_allclose(t2n(tla.sym_solve(torch.as_tensor(A), torch.as_tensor(b))),
                               np.asarray(jla.sym_solve(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    z = torch.zeros(6, 6)
    assert (t2n(tla.sym_solve(z, torch.zeros(6))) == 0).all()      # singular -> 0
    zn = z.clone()
    zn[0, 0] = float("nan")
    assert np.isnan(t2n(tla.sym_solve(zn, torch.zeros(6)))).any()   # NaN propagates
