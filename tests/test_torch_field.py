"""The port's attribute field against the JAX package: the dense seed stack
(bit-exact) and the plain jump flood of kernel K1 against ``_att_flood``
run by Pallas in interpret mode on the same stack (ids exact)."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_flood import norm  # noqa: E402
from torch_helpers import SMALL_CAMERA, small_configs, t2n  # noqa: E402

from rebvio_tpu.ops import distance_field as jDF, edge_detect as jED  # noqa: E402
from rebvio_tpu.ops.pallas_kernels import _att_flood, _flood_pad  # noqa: E402
from rebvio_tpu.pipeline import frontend_matrices as jmats  # noqa: E402
from rebvio_tpu.data import synthetic as jsyn  # noqa: E402
from rebvio_tpu_torch.ops import distance_field as tDF, kernels  # noqa: E402


def _random_stack(rng, rows, cols, sr, density=0.05):
    """A seed stack in the flood's layout with random seeds: coords within
    half a cell of their cell, unique ids, random gradients."""
    pad = _flood_pad(sr)
    Rp = rows + pad
    st = np.zeros((5, Rp, cols), np.float32)
    st[0] = st[1] = 1e9
    st[2] = -1.0
    mask = rng.rand(rows, cols) < density
    ys, xs = np.nonzero(mask)
    st[0, ys, xs] = ys + rng.uniform(-0.5, 0.5, len(ys))
    st[1, ys, xs] = xs + rng.uniform(-0.5, 0.5, len(xs))
    st[2, ys, xs] = rng.permutation(len(ys))
    st[3, ys, xs] = rng.normal(0, 100, len(ys))
    st[4, ys, xs] = rng.normal(0, 100, len(ys))
    return st.reshape(5 * Rp, cols)


def _compare_flood(stack, sr, rows, cols, scale):
    ref = np.asarray(_att_flood(jnp.asarray(stack), sr, rows, cols, scale, interpret=True))
    out = t2n(kernels.att_flood(torch.as_tensor(stack), sr, rows, cols, scale))
    assert out.shape == ref.shape == (8, rows * cols)
    # ids, seeds and gradients bit-exact: same candidates, same order, strict <
    exact = [0, 2, 3, 4, 6, 7]
    np.testing.assert_array_equal(out[exact], ref[exact])
    # d2 and |g| are sums of two squares: XLA:CPU contracts them into an FMA,
    # the port rounds the product first (as the CUDA kernel does with
    # --fmad=false), so the two may differ by one float32 ulp.  The port's
    # |g| is also the correctly rounded norm of JAX's planes 3 and 4, bit for
    # bit (torch_flood.norm, the kernel's __fsqrt_rn)
    np.testing.assert_allclose(out[[1, 5]], ref[[1, 5]], rtol=2.4e-7, atol=0)
    gnorm = norm(torch.as_tensor(ref[3]), torch.as_tensor(ref[4])).numpy()
    np.testing.assert_array_equal(out[5].view(np.int32), gnorm.view(np.int32))
    return out


@pytest.mark.parametrize("seed,rows,cols,sr,density", [
    (0, 60, 94, 5, 0.05), (1, 48, 64, 10, 0.01), (2, 40, 56, 3, 0.2),
])
def test_flood_plain_matches_pallas_random(seed, rows, cols, sr, density):
    rng = np.random.RandomState(seed)
    stack = _random_stack(rng, rows, cols, sr, density)
    out = _compare_flood(stack, sr, rows, cols, 2)
    assert (out[2] >= 0).any() and (out[2] < 0).any()


@pytest.fixture(scope="module")
def detected():
    jc, tc = small_configs()
    seq = jsyn.generate(jc.camera, n_frames=2, seed=0)
    img = seq.images[1].astype(np.float32) * jc.image_gain
    sr = int(jc.core.search_range)
    mats = jmats(jc)
    thr = jnp.float32(jc.detector.threshold)
    em, (xs, ys, t0, t1) = jED._detect_core(jnp.asarray(img), thr, mats, jc.detector,
                                            jc.camera, jc.field_scale)
    args = [np.asarray(a) for a in (em.kl_id_img, xs, ys, t0, t1, em.threshold)]
    return args, sr, jc


def _compare_seed_stack(args, sr, H, W, scale):
    ref = np.asarray(jDF.seed_stack_dense(*[jnp.asarray(a) for a in args], sr, H, W, scale))
    out = t2n(tDF.seed_stack_dense(*[torch.as_tensor(a) for a in args], sr, H, W, scale))
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    return out


@pytest.mark.parametrize("field_scale", [1, 2, 3])
def test_seed_stack_dense_exact(detected, field_scale):
    args, sr, jc = detected
    H, W = SMALL_CAMERA["rows"], SMALL_CAMERA["cols"]
    out = _compare_seed_stack(args, sr, H, W, field_scale)
    assert (out >= 0).sum() > 100


@pytest.mark.parametrize("field_scale,threshold", [(2, 0.0), (3, 30.0)])
def test_seed_stack_dense_collisions_exact(field_scale, threshold):
    """Nine keyline pixels in four share a field cell (keylines on most
    pixels, sub-pixel offsets up to half a pixel, some gated out by the
    threshold): the largest id wins the cell and its pixel's five values are
    gathered, as JAX's 9-tap reduce has it."""
    rng = np.random.RandomState(field_scale)
    H, W = 23, 31
    kl = rng.rand(H, W) < 0.9
    kl_id = np.where(kl, np.cumsum(kl).reshape(H, W) - 1, -1).astype(np.int32)
    sub = rng.uniform(-0.5, 0.5, (2, H, W)).astype(np.float32)
    g = rng.normal(0, 40, (2, H, W)).astype(np.float32)
    args = (kl_id, sub[0], sub[1], g[0], g[1], np.float32(threshold))
    out = _compare_seed_stack(args, 7, H, W, field_scale)
    frows, fcols, _ = tDF.field_geometry(7, H, W, field_scale)
    ids = out.reshape(5, -1, fcols)[2, :frows]
    assert (ids >= 0).sum() > 0.8 * frows * fcols
    assert (ids >= 0).sum() < kl.sum() / 2          # most cells had several candidates


def test_flood_plain_matches_pallas_on_detection(detected):
    args, sr, jc = detected
    H, W = SMALL_CAMERA["rows"], SMALL_CAMERA["cols"]
    s = jc.field_scale
    stack = np.asarray(jDF.seed_stack_dense(*[jnp.asarray(a) for a in args], sr, H, W, s))
    frows, fcols, fsr = tDF.field_geometry(sr, H, W, s)
    out = _compare_flood(stack, fsr, frows, fcols, s)
    assert (out[2] >= 0).mean() > 0.3


def test_flood_geometry_matches_jax():
    for sr in (1, 2, 3, 5, 10, 17, 20, 40):
        assert tDF.flood_pad(sr) == _flood_pad(sr)
    assert tDF.field_geometry(40, 480, 752, 2) == (240, 376, 20)
    assert tDF.flood_steps(20) == [16, 8, 4, 2, 1, 1]


def test_round_half_away():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -0.51], np.float32)
    np.testing.assert_array_equal(t2n(tDF._round_half_away(torch.as_tensor(x))),
                                  np.asarray(jDF._round_half_away(jnp.asarray(x))))


@pytest.mark.parametrize("scale", [1, 2])
def test_build_att_field_vs_jax_jfa_state(monkeypatch, scale):
    """``distance_field._jfa_state``, JAX's XLA fixed-point flood (the CPU
    default, pinned by REBVIO_PALLAS_JFA=0), has no port of its own: K1's
    plain version plays its role.  The port's ``build_att_field`` from the
    keyline table (the scatter seeding, then the flood; exact subpixel
    metric) against JAX's on that route, under
    tests/test_torch_nn_field.py's rule for ``build_nn_field``: a differing
    id must be of a keyline no farther than the fixed-point band (0.6 in
    d2), in at most 0.2 % of the cells; and every cell's attribute planes
    must be those of the keyline it names."""
    from torch_helpers import make_random_map

    monkeypatch.setenv("REBVIO_PALLAS_JFA", "0")
    rng = np.random.RandomState(7)
    H, W, K, kmax, R = 40, 56, 36, 64, 8
    jem, tem = make_random_map(rng, K, kmax, H, W)
    want = np.asarray(jDF.build_att_field(jem, R, H, W, scale))
    got = t2n(tDF.build_att_field(tem, R, H, W, scale))
    frows, fcols, _ = tDF.field_geometry(R, H, W, scale)
    assert got.shape == want.shape == (8, frows * fcols)
    pos = np.asarray(jem.pos)
    grad = np.asarray(jem.grad)
    gnorm = np.asarray(jem.grad_norm)
    yy, xx = np.divmod(np.arange(frows * fcols), fcols)
    gid, wid = got[2].astype(np.int64), want[2].astype(np.int64)
    assert (gid >= 0).sum() > 0.2 * gid.size
    mismatch = 0
    for i in np.nonzero(gid != wid)[0]:
        g, w = gid[i], wid[i]
        if (g < 0) != (w < 0):
            mismatch += 1
            continue
        dg = (pos[g, 0] / scale - xx[i]) ** 2 + (pos[g, 1] / scale - yy[i]) ** 2
        dw = (pos[w, 0] / scale - xx[i]) ** 2 + (pos[w, 1] / scale - yy[i]) ** 2
        mismatch += abs(dg - dw) > 0.6
    assert mismatch <= 0.002 * frows * fcols, mismatch
    # the attribute planes of every cell are those of the keyline it names
    # (the gradient norm recomputed by the flood within an ulp of the map's;
    # the port's bit for bit the correctly rounded norm of the keyline's
    # gradient, torch_flood.norm, as the kernel's __fsqrt_rn)
    k = gid >= 0
    gn = norm(torch.as_tensor(grad[gid[k], 0]), torch.as_tensor(grad[gid[k], 1])).numpy()
    np.testing.assert_array_equal(got[5][k].view(np.int32), gn.view(np.int32))
    for field, ids in ((got, gid), (want, wid)):
        k = ids >= 0
        np.testing.assert_array_equal(field[3][k], grad[ids[k], 0])
        np.testing.assert_array_equal(field[4][k], grad[ids[k], 1])
        np.testing.assert_allclose(field[5][k], gnorm[ids[k]], rtol=2e-7)
        np.testing.assert_array_equal(field[6][k], pos[ids[k], 0])
        np.testing.assert_array_equal(field[7][k], pos[ids[k], 1])
