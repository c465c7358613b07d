"""The port's frontend against the JAX package on synthetic frames at the
small preset: the band matrices, the scale space, and detection with its
seed stack.  Integer planes and the keyline count match exactly."""

from __future__ import annotations

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
from rebvio_tpu_torch.ops import edge_detect as tED, scale_space as tSS  # noqa: E402
from rebvio_tpu_torch.pipeline import frontend_matrices as tmats  # noqa: E402


@pytest.fixture(scope="module")
def frames():
    jc, tc = small_configs()
    seq = jsyn.generate(jc.camera, n_frames=3, seed=2)
    return [im.astype(np.float32) * jc.image_gain for im in seq.images], jc, tc


def test_band_matrices_identical(frames):
    _, jc, tc = frames
    j = to_np(jmats(jc))
    t = {k: t2n(v) for k, v in tmats(tc, "cpu")._asdict().items()}
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
