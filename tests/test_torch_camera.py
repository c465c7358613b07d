"""The port's undistortion (camera.py) against the JAX package: the host
sampling grid, the bilinear remap with out-of-bounds taps, and the
Undistorter on float and uint8 frames for the EuRoC camera and a camera
whose grid reaches the last row and column."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import t2n  # noqa: E402

import rebvio_tpu.configs as jcfg  # noqa: E402
import rebvio_tpu_torch.configs as tcfg  # noqa: E402
from rebvio_tpu import camera as jcam  # noqa: E402
from rebvio_tpu_torch import camera as tcam  # noqa: E402

# tests/test_camera.py's partial-footprint camera: pincushion distortion
# pushes border samples onto and past the last row and column
BORDER = dict(rows=32, cols=48, cx=24.3, cy=16.7, fx=30, fy=30, k1=0.2, k2=0.0, k3=0.0,
              p1=0.01, p2=-0.01)
CAMERAS = {"euroc": {}, "border": BORDER}


@pytest.mark.parametrize("name", CAMERAS)
def test_undistort_map_equals_jax(name):
    kw = CAMERAS[name]
    np.testing.assert_array_equal(tcam.make_undistort_map(tcfg.CameraConfig(**kw)),
                                  jcam.make_undistort_map(jcfg.CameraConfig(**kw)))


def test_remap_bilinear_matches_jax_out_of_bounds():
    rng = np.random.RandomState(0)
    img = (rng.rand(32, 48) * 765).astype(np.float32)
    grid = np.stack([rng.uniform(-3, 50, (20, 30)), rng.uniform(-3, 34, (20, 30))],
                    -1).astype(np.float32)
    grid[0, :4] = [[-1.0, 5.0], [47.0, 5.0], [47.5, 31.5], [-0.5, -0.5]]  # edge taps
    want = np.asarray(jcam.remap_bilinear(jnp.asarray(img), jnp.asarray(grid)))
    got = t2n(tcam.remap_bilinear(torch.as_tensor(img), torch.as_tensor(grid)))
    x0, y0 = np.floor(grid[..., 0]), np.floor(grid[..., 1])
    assert ((x0 < 0) | (y0 < 0) | (x0 >= 47) | (y0 >= 31)).sum() > 50  # partial/outside
    assert (want == 0).any()
    # the same float32 expression; XLA may contract a multiply-add
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("name", CAMERAS)
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_undistorter_matches_jax(name, dtype):
    kw = CAMERAS[name]
    jc, tc = jcfg.CameraConfig(**kw), tcfg.CameraConfig(**kw)
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 256, size=(tc.rows, tc.cols)).astype(dtype)
    if dtype == "float32":
        raw = raw + rng.random((tc.rows, tc.cols), dtype=np.float32)
    want = np.asarray(jcam.Undistorter(jc, gain=3.0)(jnp.asarray(raw)))
    got = t2n(tcam.Undistorter(tc, gain=3.0, device="cpu")(torch.as_tensor(raw)))
    assert got.shape == want.shape == (tc.rows, tc.cols)
    # JAX's uint8 path packs pixel pairs into float lanes: the same bilinear
    # function up to summation order (test_camera.py's own 1e-3 bound)
    assert np.abs(got - want).max() < 1e-3
    assert (got == 0).any() == (want == 0).any()


def test_undistorter_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        tcam.Undistorter(tcfg.CameraConfig(**BORDER))
