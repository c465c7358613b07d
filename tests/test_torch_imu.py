"""Inter-frame IMU integration and the gyro-bias fusion of the port against
the JAX package, on seeded IMU windows with the reference's first-sample dt
quirk (0.005 s) at the EuRoC camera's extrinsics."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import t2n, to_np  # noqa: E402

from rebvio_tpu.configs import CameraConfig  # noqa: E402
from rebvio_tpu.ops import imu as jimu, tracker as jtr  # noqa: E402
from rebvio_tpu_torch import interop  # noqa: E402
from rebvio_tpu_torch.ops import imu as timu, tracker as ttr  # noqa: E402


def _window(n: int, seed: int):
    """n samples of a 200 Hz IMU (5 ms +- jitter) with EuRoC-like rates."""
    rng = np.random.RandomState(seed)
    ts = np.cumsum(rng.randint(4800, 5200, max(n, 1))).astype(np.int64)[:n] + 1_000_000
    gyro = (rng.randn(n, 3) * 0.4).astype(np.float32)
    acc = (np.array([0.0, 0.0, 9.81]) + rng.randn(n, 3) * 0.5).astype(np.float32)
    return gyro, acc, ts


@pytest.mark.parametrize("n", [0, 1, 7, 32])
def test_integrate_imu_matches_jax(n):
    cam = CameraConfig()
    R_c2i, t_c2i = cam.R_c2i_np(), cam.t_c2i_np()
    gyro, acc, ts = _window(n, seed=n)
    jdata = jimu.pack_imu_window(gyro, acc, ts, 32)
    want = to_np(jimu.integrate_imu(jdata, jnp.asarray(R_c2i), jnp.asarray(t_c2i)))
    tdata = interop.imu_frame_from_numpy(to_np(jdata), device="cpu")
    assert tdata.dt[0] == np.float32(0.005 if n else 0.0)
    got = timu.integrate_imu(tdata, torch.as_tensor(R_c2i), torch.as_tensor(t_c2i))
    # the rotation is a product of up to 32 float32 Rodrigues factors taken
    # in another association (pairwise vs JAX's scan): a few ulp of 1
    np.testing.assert_allclose(t2n(got.R), want["R"], rtol=0, atol=2e-6)
    # masked means and the lever-arm term: float32 sums in another order
    for k in ("gyro", "acc", "dgyro", "cacc"):
        np.testing.assert_allclose(t2n(getattr(got, k)), want[k], rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(want[k]).max()), err_msg=k)
    np.testing.assert_array_equal(t2n(got.dt_s), want["dt_s"])
    if n == 0:
        np.testing.assert_array_equal(t2n(got.R), np.eye(3, dtype=np.float32))
        assert not t2n(got.cacc).any()
    if n <= 1:
        assert not t2n(got.dgyro).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_gyro_bias_correction_matches_jax(seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(6, 6).astype(np.float32)
    Wx = (A @ A.T * 1e4 + np.eye(6) * 1e3).astype(np.float32)   # 6-DoF information
    X = (rng.randn(6) * 1e-3).astype(np.float32)
    Wb = (np.eye(3) * 1e-2).astype(np.float32)
    dt = 0.05
    Rg = (np.eye(3) * (1.6968e-04 * dt) ** 2).astype(np.float32)
    Rb = (np.eye(3) * (1.9393e-05 * dt) ** 2).astype(np.float32)
    want = [np.asarray(v) for v in jtr.gyro_bias_correction(
        *(jnp.asarray(v) for v in (X, Wx, Wb, Rg, Rb)))]
    got = [t2n(v) for v in ttr.gyro_bias_correction(
        *(torch.as_tensor(v) for v in (X, Wx, Wb, Rg, Rb)))]
    # adjugate inverses of ~1e11-scale 3x3 information matrices and an
    # unrolled Cholesky: the same float32 ops, other sum orders
    for name, g, w in zip(("X", "Wx", "Wb", "dgbias"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * np.abs(w).max(), err_msg=name)


def test_pack_imu_window_defaults_to_the_card():
    """Like every public entry point, pack_imu_window defaults to
    device="cuda" and raises without a GPU."""
    if torch.cuda.is_available():
        w = timu.pack_imu_window(*_window(3, 0), 32)
        assert w.gyro.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        timu.pack_imu_window(*_window(3, 0), 32)
    w = timu.pack_imu_window(*_window(3, 0), 32, device="cpu")
    assert w.gyro.device.type == "cpu" and int(w.n) == 3
