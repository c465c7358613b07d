"""The port's frontend against the JAX package on synthetic frames at the
small preset: the band matrices, the scale space, and detection with its
seed stack.  Integer planes and the keyline count match exactly.  Then the
band storage of the operators and the band product's CPU paths
(kernels.band_matmul), at the small preset and at EuRoC's 480x752."""

from __future__ import annotations

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import small_configs, t2n, to_np  # noqa: E402

from rebvio_tpu.data import synthetic as jsyn  # noqa: E402
from rebvio_tpu.ops import edge_detect as jED, scale_space as jSS  # noqa: E402
from rebvio_tpu.pipeline import frontend_matrices as jmats  # noqa: E402
from rebvio_tpu_torch.ops import edge_detect as tED, kernels, scale_space as tSS  # noqa: E402
from rebvio_tpu_torch.pipeline import frontend_matrices as tmats  # noqa: E402


@pytest.fixture(scope="module")
def frames():
    jc, tc = small_configs()
    seq = jsyn.generate(jc.camera, n_frames=3, seed=2)
    return [im.astype(np.float32) * jc.image_gain for im in seq.images], jc, tc


def test_band_matrices_identical(frames):
    _, jc, tc = frames
    j = to_np(jmats(jc))
    mats = tmats(tc, "cpu")
    t = {k: t2n(getattr(mats, k)) for k in tSS.OPERATORS}
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert jSS.box_widths(3.56359) == tSS.box_widths(3.56359)


def test_scale_space_matches_jax(frames):
    imgs, jc, tc = frames
    j = jSS.build_scale_space(jnp.asarray(imgs[0]), jmats(jc))
    t = tSS.build_scale_space(torch.as_tensor(imgs[0]), tmats(tc, "cpu"))
    # band-matrix products summed in another order (Eigen vs MKL/oneDNN)
    for name, a, b in zip(("s0", "dog", "mag"), t, j):
        b = np.asarray(b)
        np.testing.assert_allclose(t2n(a), b, rtol=0, atol=1e-4 * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("i,threshold", [(0, 0.01), (1, 0.02), (2, 0.005)])
def test_detect_with_seeds_matches_jax(frames, i, threshold):
    imgs, jc, tc = frames
    sr = int(jc.core.search_range)
    em, stack = jED.detect_with_seeds(jnp.asarray(imgs[i]), jnp.float32(threshold), jmats(jc),
                                      jc.detector, jc.camera, jc.field_scale, sr)
    tem, tstack = tED.detect_with_seeds(torch.as_tensor(imgs[i]), torch.tensor(threshold),
                                        tmats(tc, "cpu"), tc.detector, tc.camera,
                                        tc.field_scale, sr)
    j = to_np(em)
    t = {k: t2n(v) for k, v in vars(tem).items()}
    assert int(t["count"]) == int(j["count"]) > 300
    for k in ("kl_id_img", "id_next", "id_prev", "valid", "count", "match_id",
              "matches", "match_id_keyframe"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # subpixel positions and gradients come from the band-matrix sums
    for k in ("pos", "pos_img", "grad", "grad_norm", "threshold"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-3, err_msg=k)
    st, jst = t2n(tstack), np.asarray(stack)
    R = st.shape[0] // 5
    st, jst = st.reshape(5, R, -1), jst.reshape(5, R, -1)
    # A seed passes the stack's gate g2 >= threshold^2 with a threshold that
    # comes from the band-matrix sums (1e-6 relative apart here): a keyline
    # within 1e-5 of the gate may seed on one side only.  Every other cell
    # matches exactly.
    diff = st[2] != jst[2]
    kid = np.maximum(st[2][diff], jst[2][diff]).astype(np.int64)
    g2 = (t["grad"][kid] ** 2).sum(-1)
    thr2 = float(j["threshold"]) ** 2
    assert np.all(np.abs(g2 - thr2) <= 1e-5 * thr2), (kid, g2, thr2)
    assert diff.sum() <= 2
    np.testing.assert_allclose(st[:, ~diff], jst[:, ~diff], rtol=1e-4, atol=1e-3)


def test_autogain_threshold_matches_jax(frames):
    _, jc, tc = frames
    for count in (0, 900, 1200, 5000):
        for thr in (0.004, 0.01, 0.6):
            a = jED.autogain_threshold(jnp.float32(thr), jnp.int32(count), jc.detector)
            b = tED.autogain_threshold(torch.tensor(thr), torch.tensor(count, dtype=torch.int32),
                                       tc.detector)
            assert float(b) == float(a)


# ---- the band storage and kernels.band_matmul's CPU paths

BAND_GEOMETRIES = [(48, 64), (480, 752)]


@functools.lru_cache(maxsize=None)
def band_mats(rows: int, cols: int):
    return tSS.ScaleSpaceParams(rows, cols).matrices("cpu")


def band_operand(mats, name: str, lanes=(), seed: int = 0) -> torch.Tensor:
    """A random dense operand of operator ``name``: [depth, cols] for a left
    operator, [rows, depth] for a right one, with ``lanes`` leading."""
    band = mats.bands[name]
    rows, cols = mats.S5H.shape[0], mats.S5W.shape[0]
    shape = (band.depth, cols) if band.left else (rows, band.depth)
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*lanes, *shape, generator=g) * 50.0


def dense_product(mats, name: str, x: torch.Tensor) -> torch.Tensor:
    op = getattr(mats, name)
    return op @ x if mats.bands[name].left else x @ op


def band_kernel_emulation(x: np.ndarray, band) -> np.ndarray:
    """csrc/band_matmul.cu's indexing in float64: each tile stages
    BAND_TILE_LINES + taps - 1 rows of x's band axis from its first k (zeros
    past x's edge), and each of its lines takes ``taps`` of them from its
    offset into that span."""
    k0, coef, tiles = t2n(band.k0), t2n(band.coef).astype(np.float64), t2n(band.tiles)
    lines, taps = coef.shape
    span = kernels.BAND_TILE_LINES + taps - 1
    xk = x if band.left else x.T                    # [depth, free]
    padded = np.zeros((xk.shape[0] + span, xk.shape[1]))
    padded[:xk.shape[0]] = xk
    out = np.zeros((lines, xk.shape[1]))
    for first, n, kbase in tiles:
        staged = padded[kbase:kbase + span]
        for line in range(first, first + n):
            off = k0[line] - kbase
            assert 0 <= off and off + taps <= span
            out[line] = coef[line] @ staged[off:off + taps]
    return out if band.left else out.T


@pytest.mark.parametrize("geometry", BAND_GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", tSS.OPERATORS)
def test_band_storage_rebuilds_operator(geometry, name):
    """Each operator's band holds all of it: rebuilt densely from (k0, coef)
    it is the float32 matrix exactly; every line's run of taps lies inside
    the matrix; the tiles take every line once, in order, each tile's runs
    inside the span its block stages."""
    mats = band_mats(*geometry)
    band = mats.bands[name]
    dense = t2n(getattr(mats, name))
    m = dense if band.left else dense.T
    k0, coef, tiles = t2n(band.k0), t2n(band.coef), t2n(band.tiles)
    lines, taps = coef.shape
    assert m.shape == (lines, band.depth) and band.left == (name in tSS.LEFT_OPERATORS)
    assert k0.min() >= 0 and (k0 + taps).max() <= band.depth
    rebuilt = np.zeros_like(m)
    rebuilt[np.arange(lines)[:, None], k0[:, None] + np.arange(taps)] = coef
    np.testing.assert_array_equal(rebuilt, m)
    assert np.array_equal(tiles[:, 0], np.concatenate([[0], np.cumsum(tiles[:-1, 1])]))
    assert tiles[:, 1].sum() == lines and tiles[:, 1].max() <= kernels.BAND_TILE_LINES
    for first, n, kbase in tiles:
        run = k0[first:first + n]
        assert run.min() == kbase
        assert run.max() + taps - kbase <= kernels.BAND_TILE_LINES + taps - 1


@pytest.mark.parametrize("geometry", BAND_GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("name", tSS.OPERATORS)
def test_band_kernel_indexing_is_the_product(geometry, name):
    """The kernel's tiles, staging and offsets, emulated in float64, give
    the dense product (summed in another order, so to float64 rounding)."""
    mats = band_mats(*geometry)
    x = t2n(band_operand(mats, name)).astype(np.float64)
    op = t2n(getattr(mats, name)).astype(np.float64)
    want = op @ x if mats.bands[name].left else x @ op
    got = band_kernel_emulation(x, mats.bands[name])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("name", tSS.OPERATORS)
def test_band_matmul_plain_is_the_dense_product(name):
    """On CPU tensors kernels.band_matmul is the dense product bit for bit,
    launching nothing; mxu_dot's bf16 path rounds the operands first."""
    mats = band_mats(48, 64)
    x = band_operand(mats, name)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.band_matmul(x, getattr(mats, name), mats.bands[name]),
                       dense_product(mats, name, x))
    assert torch.equal(tSS.mxu_dot(mats, name, x, False), dense_product(mats, name, x))
    rounded = mats._replace(**{name: tSS._bf16(getattr(mats, name))})
    assert torch.equal(tSS.mxu_dot(mats, name, x, True),
                       dense_product(rounded, name, tSS._bf16(x)))
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("name", tSS.OPERATORS)
def test_band_matmul_vmap_cpu_lanes_are_lane_products(name):
    """torch.func.vmap of kernels.band_matmul over CPU lanes: each lane is
    the unbatched dense product bit for bit (one product a lane)."""
    mats = band_mats(48, 64)
    xs = band_operand(mats, name, lanes=(3,), seed=1)
    got = torch.func.vmap(
        lambda x: kernels.band_matmul(x, getattr(mats, name), mats.bands[name]))(xs)
    want = torch.stack([dense_product(mats, name, x) for x in xs])
    assert torch.equal(got, want)


def test_band_matmul_operator_refuses_cpu_lanes_and_a_batched_band():
    """The operator's vmap rule launches the kernel or raises: CPU lanes go
    to the plain version, and a band that differs by lane is refused."""
    mats = band_mats(48, 64)
    band = mats.bands["YH"]
    xs = band_operand(mats, "YH", lanes=(2,))
    op = torch.ops.rebvio.band_matmul
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch.func.vmap(lambda x: op(x, band.k0, band.coef, band.tiles, band.splits, True))(xs)
    with pytest.raises(ValueError, match="same for every lane"):
        torch.func.vmap(lambda x, c: op(x, band.k0, c, band.tiles, band.splits, True))(
            xs, band.coef.expand(2, *band.coef.shape))
    with pytest.raises(ValueError, match="depth"):
        kernels.band_matmul(xs[0].T, mats.YH, band)
