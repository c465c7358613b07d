"""The SAB filter (ops/sab.py) and kernel K3's plain version
(kernels.estimate_bias_plain) against the JAX package on the CPU: the XLA
form against JAX's XLA form, the plain version against
estimate_bias_pallas in interpret mode, and the port's estimate_bias
against JAX's with REBVIO_PALLAS_SAB=1."""

from __future__ import annotations

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_sab import _problem  # noqa: E402
from torch_helpers import t2n  # noqa: E402

from rebvio_tpu.geometry import linalg as jlinalg, so3 as jso3  # noqa: E402
from rebvio_tpu.ops import pallas_kernels as jpk, sab as jsab  # noqa: E402
from rebvio_tpu_torch.ops import kernels, sab as tsab  # noqa: E402

ITERS = 8


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def _problem_t(jp):
    return tsab.SabProblem(*[None if v is None else _t(v) for v in jp])


def _trial(trial: int):
    """test_sab.py::test_pallas_estimate_bias_matches_xla's inputs for
    ``trial`` (same generator, same draws), as a dict of numpy arrays."""
    rng = np.random.RandomState(0)
    for t in range(trial + 1):
        scale = [4.0, 1.5, 7.0, 3.0][t]
        g = np.asarray([0.3, -9.7, 0.5], np.float32) + rng.randn(3).astype(np.float32) * 0.1
        a_s = rng.randn(3).astype(np.float32)
        a_v = (a_s + g) / scale
        X = np.concatenate([[np.arctan(scale * 0.8)], g, rng.randn(3) * 1e-3]).astype(np.float32)
        Pm = rng.randn(7, 7).astype(np.float32) * 3e-2
        P = Pm @ Pm.T + np.eye(7, dtype=np.float32) * 1e-2
        Wm = rng.randn(6, 6).astype(np.float32)
        Wvw = Wm @ Wm.T + np.eye(6, dtype=np.float32) * 1e3
        Rot = np.asarray(jso3.exp(jnp.asarray(rng.randn(3) * 0.05, jnp.float32)))
        Xvw = (rng.randn(6) * 1e-2).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    return dict(a_s=a_s, a_v=a_v, kP=np.float32(1.0), Rot=Rot, X=X, P=P, Qg=eye * 1e-6,
                Qrot=eye * 1e-8, Qbias=eye * 1e-10, QKp=np.float32(1e-4), Rg=np.float32(1e2),
                Rs=eye * 1e-5, Rv=eye * 1e-4, Wvw=Wvw, Xvw=Xvw, g_gravit=np.float32(9.81))


def _kernel_inputs(kw):
    """K3's inputs for a trial: JAX's KF predict (sab.estimate_bias's first
    half), W_rest built from the predicted covariance."""
    rot, X, P = (jnp.asarray(kw[k]) for k in ("Rot", "X", "P"))
    F = jnp.zeros((7, 7), jnp.float32).at[0, 0].set(1.0).at[1:4, 1:4].set(rot.T)
    F = F.at[4:7, 4:7].set(jnp.eye(3, dtype=jnp.float32))
    g = X[1:4]
    GProd = jnp.array([[0.0, g[2], -g[1]], [-g[2], 0.0, g[0]], [g[1], -g[0], 0.0]])
    tan_a = jnp.tan(X[0])
    Q = jnp.zeros((7, 7), jnp.float32).at[0, 0].set(kw["QKp"] / (1.0 + tan_a * tan_a))
    Q = Q.at[1:4, 1:4].set(GProd.T @ jnp.asarray(kw["Qrot"]) @ GProd + jnp.asarray(kw["Qg"]))
    Q = Q.at[4:7, 4:7].set(jnp.asarray(kw["Qbias"]))
    Pp = F @ P @ F.T + Q
    prob = jsab.SabProblem(a_v=kw["a_v"], a_s=kw["a_s"], G=kw["g_gravit"], x_p=F @ X, Pp=Pp,
                           W_pp=jlinalg.chol_inverse(Pp), Rv=kw["Rv"], Rs=kw["Rs"], Rg=kw["Rg"])
    return dict(a_s=kw["a_s"], a_v=kw["a_v"], x_p=np.asarray(F @ X),
                W_rest=np.asarray(jsab._w_rest(prob)), Rs=kw["Rs"], Rv=kw["Rv"], Wvw=kw["Wvw"],
                Xvw=kw["Xvw"], g_gravit=kw["g_gravit"])


_JIT = {}


def _jit(key, fn):
    """One jitted wrapper per key (a fresh function, so its own trace cache):
    the JAX SAB chain is thousands of scalar ops, seconds each call eagerly."""
    if key not in _JIT:
        _JIT[key] = jax.jit(fn)
    return _JIT[key]


def _pallas(ki, iters=ITERS):
    f = _jit(("pallas", iters), lambda *a: jpk.estimate_bias_pallas(*a, iters=iters,
                                                                      interpret=True))
    K, X, P, Xvw = f(*(jnp.asarray(v) for v in ki.values()))
    return [np.asarray(v) for v in (K.reshape(()), X.reshape(7), P, Xvw.reshape(6))]


def _jax_estimate_bias(monkeypatch, kw, pallas: bool):
    """JAX's sab.estimate_bias with REBVIO_PALLAS_SAB set (read at trace time)."""
    monkeypatch.setenv("REBVIO_PALLAS_SAB", "1" if pallas else "0")
    f = _jit(("estimate_bias", pallas), lambda **a: jsab.estimate_bias(**a, iters=ITERS))
    return f(**{k: jnp.asarray(v) for k, v in kw.items()})


def _close(got, want, name):
    """The port's SAB against JAX's, either form: the same float32 chain with
    small products summed in another order and another libm's sin/cos.
    Measured on the four trials: at most 6.2e-6 on K (~7), 1.9e-6 on X
    (~10), 8.9e-8 on P (~0.02), 2.5e-8 on Xvw (~0.03), each an order or more
    inside this bound, which is itself 10x tighter than the bound
    test_sab.py puts between JAX's own two forms (rtol 2e-3 and up)."""
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6 * max(1.0, np.abs(want).max()),
                               err_msg=name)


def _plain(ki, iters=ITERS):
    return [t2n(v) for v in kernels.estimate_bias_plain(*(_t(v) for v in ki.values()), iters)]


def test_sab_problem_matches_jax():
    jp, X_true = _problem()
    tp = _problem_t(jp)
    X0 = X_true + np.asarray([0.2, 0.5, -0.4, 0.3, 0.005, -0.004, 0.003], np.float32)
    for X in (X_true, X0):
        jJ, jF = (np.asarray(v) for v in jsab.sab_problem(jp, jnp.asarray(X)))
        tJ, tF = (t2n(v) for v in tsab.sab_problem(tp, _t(X)))
        # the same float32 expressions in another reduction order; the
        # information weights (1e4) amplify the rounding of F
        np.testing.assert_allclose(tJ, jJ, rtol=1e-5, atol=1e-5 * np.abs(jJ).max())
        np.testing.assert_allclose(tF, jF, rtol=1e-4, atol=1e-5 * np.abs(jF).max())


def test_sab_gauss_newton_matches_jax():
    jp, X_true = _problem()
    X0 = X_true + np.asarray([0.2, 0.5, -0.4, 0.3, 0.005, -0.004, 0.003], np.float32)
    jX = np.asarray(jsab.sab_gauss_newton(jp, jnp.asarray(X0), iters=20))
    tX = t2n(tsab.sab_gauss_newton(_problem_t(jp), _t(X0), iters=20))
    # converged state; within test_sab.py's Pallas-vs-XLA tolerance
    np.testing.assert_allclose(tX, jX, rtol=2e-3, atol=2e-3)
    assert abs(tX[0] - X_true[0]) < 5e-3


def test_sab_bias_saturation():
    jp, X_true = _problem()
    X0 = X_true.copy()
    X0[4:] = 0.5  # way past the saturation limit
    tX = t2n(tsab.sab_gauss_newton(_problem_t(jp), _t(X0), iters=1))
    assert np.all(np.abs(tX[4:]) <= 0.02 + 1e-6)
    # the kernel's plain version saturates the same way, starting from a prior
    # whose bias is far outside the limit
    ki = _kernel_inputs(_trial(0))
    ki["x_p"] = ki["x_p"].copy()
    ki["x_p"][4:] = [0.5, -0.5, 0.3]
    got, want = _plain(ki, 1), _pallas(ki, 1)
    assert np.all(np.abs(got[1][4:]) <= np.float32(0.02))
    np.testing.assert_array_equal(np.abs(got[1][4:]) == np.float32(0.02),
                                  np.abs(want[1][4:]) == np.float32(0.02))


@pytest.mark.parametrize("trial", range(4))
def test_estimate_bias_xla_form_matches_jax(trial, monkeypatch):
    kw = _trial(trial)
    ref = _jax_estimate_bias(monkeypatch, kw, pallas=False)
    out = tsab.estimate_bias(**{k: _t(v) for k, v in kw.items()}, iters=ITERS, kernel=False)
    for name in ("K", "X", "P", "Xvw"):
        _close(t2n(getattr(out, name)), np.asarray(getattr(ref, name)), name)


@pytest.mark.parametrize("trial", range(4))
def test_estimate_bias_plain_matches_pallas_interpret(trial):
    """K3's plain version repeats the Pallas body op for op: only the sum
    order of the small products and the libm sin/cos differ."""
    ki = _kernel_inputs(_trial(trial))
    got, want = _plain(ki), _pallas(ki)
    for name, g, w in zip(("K", "X", "P", "Xvw"), got, want):
        _close(g, w, name)


def test_estimate_bias_matches_jax_pallas(monkeypatch):
    """The port's sab.estimate_bias (predict in torch, K3's plain version on
    the CPU) against JAX's with the Pallas SAB kernel in interpret mode
    (REBVIO_PALLAS_SAB=1, as use_pallas sets it)."""
    for trial in range(4):
        kw = _trial(trial)
        ref = _jax_estimate_bias(monkeypatch, kw, pallas=True)
        out = tsab.estimate_bias(**{k: _t(v) for k, v in kw.items()}, iters=ITERS)
        for name in ("K", "X", "P", "g_est", "b_est", "Xvw"):
            _close(t2n(getattr(out, name)), np.asarray(getattr(ref, name)),
                   f"trial {trial} {name}")


def test_gj_inverse_mosaic_matches_jax():
    rng = np.random.RandomState(5)
    for n in (3, 6, 7):
        m = rng.randn(n, n).astype(np.float32)
        m = m @ m.T + np.eye(n, dtype=np.float32)
        want = np.asarray(jpk._gj_inverse_mosaic(jnp.asarray(m)))
        got = t2n(kernels.gj_inverse_mosaic(_t(m)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_angle_wrap_rounds_half_to_even():
    """At exact half-way points a/2pi = k + 1/2 the wrap keeps jnp.round's
    half-to-even: f32(pi) stays +pi (roundf would give -pi)."""
    two_pi = float(2.0 * np.pi)
    a = np.float32([np.pi, -np.pi, 3 * np.pi, 5 * np.pi, 1.0, -7.5])
    q = np.float32(a) * np.float32(1.0 / two_pi)
    assert q[0] == 0.5 and q[1] == -0.5      # the half-way cases are exact
    want = np.asarray(jnp.asarray(a) - two_pi * jnp.round(jnp.asarray(a) * (1.0 / two_pi)))
    got = t2n(kernels.wrap_angle(_t(a)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(math.pi) and got[1] == -np.float32(math.pi)
