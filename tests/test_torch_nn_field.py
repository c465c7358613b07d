"""The scatter-seeded fields of the port against the JAX package: the plain
versions of kernel K1b (``att_field``) and kernel K7 (``nn_field``) against
``att_field_pallas`` and ``nn_field_pallas`` run by Pallas in interpret
mode on the same keyline tables, with collisions (several keylines in one
field cell: the largest index wins and the whole row comes from it), the
threshold gate and keylines outside the field; and ``build_nn_field``
against the JAX package's fixed-point flood."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import make_random_map, map_from_table, t2n  # noqa: E402

from rebvio_tpu.ops import distance_field as jDF  # noqa: E402
from rebvio_tpu.ops.pallas_kernels import att_field_pallas, nn_field_pallas  # noqa: E402
from rebvio_tpu_torch.ops import distance_field as tDF, kernels  # noqa: E402


def _att_both(jem, tem, R, H, W, scale):
    ref = np.asarray(att_field_pallas(jem, R, H, W, scale=scale, interpret=True))
    out = t2n(tDF.build_att_field(tem, R, H, W, scale))
    assert out.shape == ref.shape
    return out, ref


def _assert_att_equal(out, ref):
    # ids exact; float planes at tests/test_nn_field.py's tolerance (measured:
    # seeds, gradients and positions equal, d2 and |g| within one float32 ulp,
    # XLA:CPU contracting the sums of two squares into an FMA)
    np.testing.assert_array_equal(out[tDF.ATT_ID], ref[tDF.ATT_ID])
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)
    exact = [0, 2, 3, 4, 6, 7]
    np.testing.assert_array_equal(out[exact], ref[exact])


def _cells(tem, scale, frows, fcols):
    """Field cell of every valid in-field keyline of a port EdgeMap."""
    pos = t2n(tem.pos) * np.float32(1.0 / scale)
    r = np.floor(pos[:, 1] + 0.5).astype(int)
    c = np.floor(pos[:, 0] + 0.5).astype(int)
    ok = t2n(tem.valid) & (r >= 0) & (r < frows) & (c >= 0) & (c < fcols)
    return r, c, ok


@pytest.mark.parametrize("scale,seed,K", [(1, 3, 36), (2, 4, 150), (3, 5, 150)])
def test_att_field_plain_matches_pallas(scale, seed, K):
    rng = np.random.RandomState(seed)
    H, W, kmax, R = 48, 64, 192, 10
    jem, tem = make_random_map(rng, K, kmax, H, W)
    out, ref = _att_both(jem, tem, R, H, W, scale)
    _assert_att_equal(out, ref)
    frows, fcols, _ = tDF.field_geometry(R, H, W, scale)
    r, c, ok = _cells(tem, scale, frows, fcols)
    n_cells = len(set(zip(r[ok], c[ok])))
    # at scale > 1 several keylines share a cell: collisions are the normal case
    assert (n_cells < ok.sum()) == (scale > 1)
    assert (out[tDF.ATT_ID] >= 0).any() and (out[tDF.ATT_ID] < 0).any()


def _collision_table():
    """A 24x32 image at scale 2 (field 12x16): three keylines in field cell
    (3, 4) of which the last is gated out by ``valid``, two in cell (8, 10),
    one alone, one out of the field on each side."""
    pos = np.array([
        [8.3, 6.2], [7.6, 5.7], [8.9, 6.4], [8.1, 6.1],     # cell (3, 4); slot 3 invalid
        [20.2, 16.4], [19.7, 15.6],                          # cell (8, 10)
        [27.5, 20.5],                                        # alone, cell (10, 14)
        [-3.0, 5.0], [40.0, 5.0], [5.0, -2.0], [5.0, 30.0],  # out of the field
    ], np.float32)
    K = len(pos)
    grad = np.stack([100.0 + 10.0 * np.arange(K), -50.0 - 7.0 * np.arange(K)],
                    axis=-1).astype(np.float32)
    valid = np.ones(K, bool)
    valid[3] = False
    return pos, grad, valid


def test_collisions_largest_index_wins_whole_row():
    H, W, R, scale = 24, 32, 8, 2
    pos, grad, valid = _collision_table()
    jem, tem = map_from_table(pos, grad, 16, H, W, valid=valid)
    frows, fcols, sr = tDF.field_geometry(R, H, W, scale)
    use = tDF.keyline_gate(tem)
    winner, _, _ = kernels.seed_winner_plain(tem.pos, use, frows, fcols, 1.0 / scale)
    winner = t2n(winner).reshape(frows, fcols)
    want = np.full((frows, fcols), -1, np.int32)
    want[3, 4], want[8, 10], want[10, 14] = 2, 5, 6
    np.testing.assert_array_equal(winner, want)

    stack = t2n(kernels.seed_stack_plain(tem.pos, tem.grad, use, R, H, W, scale))
    Rp = frows + tDF.flood_pad(sr)
    st = stack.reshape(5, Rp, fcols)
    for (r, c), k in (((3, 4), 2), ((8, 10), 5), ((10, 14), 6)):
        row = st[:, r, c]
        np.testing.assert_array_equal(
            row, [pos[k, 1] * np.float32(0.5), pos[k, 0] * np.float32(0.5), k,
                  grad[k, 0], grad[k, 1]])
    assert (st[2] >= 0).sum() == 3
    np.testing.assert_array_equal(st[:, frows:, :],
                                  np.broadcast_to(np.array([1e9, 1e9, -1, 0, 0], np.float32)
                                                  [:, None, None], (5, Rp - frows, fcols)))
    out, ref = _att_both(jem, tem, R, H, W, scale)
    _assert_att_equal(out, ref)
    assert set(np.unique(out[tDF.ATT_ID])) <= {-1.0, 2.0, 5.0, 6.0}
    # the id-only field applies the same rule (positions already in field units)
    jem_s = jem.replace(pos=jem.pos / scale)
    nn_ref = np.asarray(nn_field_pallas(jem_s, sr, frows, fcols, interpret=True))
    nn_out = t2n(tDF.build_nn_field(tem, R, H, W, scale))
    np.testing.assert_array_equal(nn_out, nn_ref)
    assert set(np.unique(nn_out)) == {-1, 2, 5, 6}


def test_threshold_gate_on_stored_grad_norm():
    rng = np.random.RandomState(1)
    H, W, K, kmax, R = 32, 40, 60, 64, 6
    jem, tem = make_random_map(rng, K, kmax, H, W, unique_cells=False)
    gn = np.asarray(jem.grad_norm)[:K]
    thr = float(np.median(gn))
    jem = jem.replace(threshold=jnp.asarray(thr, jnp.float32))
    tem = tem.replace(threshold=torch.tensor(thr, dtype=torch.float32))
    gated_out = set(np.nonzero(gn < thr)[0].tolist())
    assert 10 < len(gated_out) < K - 10
    for scale in (1, 2):
        out, ref = _att_both(jem, tem, R, H, W, scale)
        _assert_att_equal(out, ref)
        present = set(int(i) for i in out[tDF.ATT_ID][out[tDF.ATT_ID] >= 0])
        assert present and not (present & gated_out)
    nn = t2n(tDF.build_nn_field(tem, R, H, W))
    np.testing.assert_array_equal(
        nn, np.asarray(nn_field_pallas(jem, R, H, W, interpret=True)))
    assert not (set(nn[nn >= 0].tolist()) & gated_out)


@pytest.mark.parametrize("seed,H,W,K,R,unique", [
    (2, 40, 56, 36, 8, True), (6, 33, 47, 200, 5, False), (7, 24, 36, 12, 20, True)])
def test_nn_field_plain_matches_pallas(seed, H, W, K, R, unique):
    rng = np.random.RandomState(seed)
    jem, tem = make_random_map(rng, K, 256, H, W, unique_cells=unique)
    ref = np.asarray(nn_field_pallas(jem, R, H, W, interpret=True))
    out = t2n(kernels.nn_field(tem.pos, tDF.keyline_gate(tem), R, H, W))
    assert out.dtype == np.int32 and out.shape == (H * W,)
    np.testing.assert_array_equal(out, ref)
    assert (out >= 0).any()


@pytest.mark.parametrize("scale", [1, 2])
def test_build_nn_field_distance_correct_vs_jax(scale):
    """The port's field keeps the exact subpixel metric; the JAX package's
    ``build_nn_field`` packs seed coordinates as fixed point (<= 0.25 px), so
    the two are held to distance-correctness: a differing id must be of a
    keyline no farther than the quantization band (0.6 in d2), in at most
    0.2 % of the cells (tests/test_nn_field.py's rule)."""
    rng = np.random.RandomState(2)
    H, W, K, kmax, R = 40, 56, 36, 64, 8
    jem, tem = make_random_map(rng, K, kmax, H, W)
    want = np.asarray(jDF.build_nn_field(jem, R, H, W, scale))
    got = t2n(tDF.build_nn_field(tem, R, H, W, scale))
    frows, fcols, _ = tDF.field_geometry(R, H, W, scale)
    assert got.shape == want.shape == (frows * fcols,)
    pos = np.asarray(jem.pos) / scale
    yy, xx = np.divmod(np.arange(frows * fcols), fcols)
    diff = np.nonzero(got != want)[0]
    mismatch = 0
    for i in diff:
        g, w = got[i], want[i]
        if (g < 0) != (w < 0):
            mismatch += 1
            continue
        dg = (pos[g, 0] - xx[i]) ** 2 + (pos[g, 1] - yy[i]) ** 2
        dw = (pos[w, 0] - xx[i]) ** 2 + (pos[w, 1] - yy[i]) ** 2
        mismatch += abs(dg - dw) > 0.6
    assert mismatch <= 0.002 * frows * fcols, (mismatch, len(diff))


def test_build_att_field_branches_and_rows():
    """With a seed stack only the flood runs; without one the keyline table
    is scattered first.  Both give the same field when the stack holds the
    same seeds, and att_rows is the [N, 8] view of the planes."""
    rng = np.random.RandomState(8)
    H, W, K, R, scale = 30, 44, 50, 8, 2
    _, tem = make_random_map(rng, K, 64, H, W)
    stack = kernels.seed_stack_plain(tem.pos, tem.grad, tDF.keyline_gate(tem), R, H, W, scale)
    a = tDF.build_att_field(tem, R, H, W, scale)
    b = tDF.build_att_field(None, R, H, W, scale, seed_stack=stack)
    assert torch.equal(a, b)
    rows = tDF.att_rows(a)
    assert rows.shape == (a.shape[1], 8) and torch.equal(rows, a.T)


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.RandomState(9)
    _, tem = make_random_map(rng, 20, 32, 24, 32)
    before = dict(kernels.LAUNCHES)
    assert "att_field" in before and "nn_field" in before
    use = tDF.keyline_gate(tem)
    a = kernels.att_field(tem.pos, tem.grad, use, 6, 24, 32, 2)
    n = kernels.nn_field(tem.pos, use, 6, 24, 32)
    assert torch.equal(a, kernels.att_field_plain(tem.pos, tem.grad, use, 6, 24, 32, 2))
    assert torch.equal(n, kernels.nn_field_plain(tem.pos, use, 6, 24, 32))
    assert kernels.LAUNCHES == before      # no kernel was launched on the CPU


def test_detect_is_detection_without_seeds():
    """edge_detect.detect returns the map that detect_with_seeds returns."""
    from torch_helpers import small_configs

    from rebvio_tpu_torch.data import synthetic
    from rebvio_tpu_torch.ops import edge_detect
    from rebvio_tpu_torch.pipeline import frontend_matrices

    _, tc = small_configs()
    seq = synthetic.generate(tc.camera, n_frames=1, seed=3)
    img = torch.as_tensor(seq.images[0]).to(torch.float32) * tc.image_gain
    thr = torch.tensor(tc.detector.threshold, dtype=torch.float32)
    mats = frontend_matrices(tc, "cpu")
    em = edge_detect.detect(img, thr, mats, tc.detector, tc.camera, tc.field_scale)
    em2, _ = edge_detect.detect_with_seeds(img, thr, mats, tc.detector, tc.camera,
                                           tc.field_scale, int(tc.core.search_range))
    assert int(em.count) > 100
    for name in ("pos", "grad", "grad_norm", "valid", "kl_id_img", "id_next", "threshold"):
        assert torch.equal(getattr(em, name), getattr(em2, name)), name


def test_field_tool_needs_a_gpu():
    from rebvio_tpu_torch.tools import jfa_ab

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would run")
    with pytest.raises(RuntimeError, match="cuda"):
        jfa_ab.main()
