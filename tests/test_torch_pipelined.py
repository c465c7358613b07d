"""The runner's modes and the pipelined chunk on the CPU, against the JAX
package, for the reference-semantics variants (``df_mode="raster"`` /
``"jfa"`` with ``matcher="walk"``): ``VioRunner.run`` streaming, in exact
chunks and in pipelined chunks (``pipeline.step_chunk_pipelined``: the
detection threshold held for the chunk), and the CLI's ``--matcher``,
``--df-mode`` and ``--chunk-mode``.  Small preset (120x188, 2048
keylines), seeded numpy inputs; the Pallas kernels JAX reaches run in
interpret mode."""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import (PALLAS_FLAGS, empty_window, jax_windows, small_config,  # noqa: E402
                           t2n, to_np, use_pallas, variant_configs)

import rebvio_tpu.configs as jcfg  # noqa: E402
import rebvio_tpu_torch.configs as tcfg  # noqa: E402
from rebvio_tpu import pipeline as jpipe, types as jT  # noqa: E402
from rebvio_tpu.data import synthetic as jsyn  # noqa: E402
from rebvio_tpu_torch import interop, pipeline as tpipe  # noqa: E402
from rebvio_tpu_torch import types as tT  # noqa: E402
from rebvio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from rebvio_tpu_torch.runner import VioRunner  # noqa: E402

VIO_FLAGS = PALLAS_FLAGS + ("SAB",)
ODO = ("orientation", "position", "num_matches", "run_ok")


@pytest.mark.parametrize("df_mode,matcher,vio,n", [("raster", "walk", True, 10),
                                                   ("jfa", "walk", False, 9)],
                         ids=["raster_walk_vio", "jfa_walk_vo"])
def test_runner_modes_match_jax(df_mode, matcher, vio, n):
    """VioRunner.run over distorted VIO frames (raster + walk; SAB engaged
    from frame 8) or VO frames (jfa + walk): streaming against JAX's runner
    (matches within 1 %, positions within 2 % of the span); chunks of 4 equal
    streaming bit for bit; the pipelined chunk against JAX's pipelined chunk
    at the same tolerance as streaming, and against the exact chunk at JAX's
    own tolerance (tests/test_scan_chunk.py: positions rtol/atol 1e-3,
    matches within 2 % from frame 1).  The tail frames past the last full
    chunk go one at a time, in both packages."""
    from rebvio_tpu.runner import VioRunner as JRunner

    with pytest.MonkeyPatch.context() as mp:
        use_pallas(mp, *VIO_FLAGS)
        jc, tc = variant_configs(vio, df_mode, matcher)
        seq = jsyn.generate(jc.camera, n_frames=n, seed=0, distort=vio,
                            imu_preroll_s=0.1 if vio else 0.0)
        jr = JRunner(jc, undistort=vio).run(seq)
        jp = JRunner(jc, undistort=vio).run(seq, chunk=4, pipelined=True)
        jax.clear_caches()
    a, b, c = (VioRunner(tc, undistort=vio, device="cpu") for _ in range(3))
    ra, rb, rc = a.run(seq), b.run(seq, chunk=4), c.run(seq, chunk=4, pipelined=True)
    assert sorted(b._programs) == [(1, "exact"), (4, "exact")]
    assert sorted(c._programs) == [(1, "exact"), (4, "pipelined")]
    for f in ("ts_us",) + ODO:
        np.testing.assert_array_equal(getattr(rb, f), getattr(ra, f), err_msg=f)
    for x, y in zip(tT.tree_leaves(a.state), tT.tree_leaves(b.state)):
        assert torch.equal(x, y)
    span = np.linalg.norm(jr.position[-1] - jr.position[0])
    assert span > 0
    for mine, ref in ((ra, jr), (rc, jp)):
        assert mine.run_ok.all() and ref.run_ok.all()
        assert mine.num_matches[0] == ref.num_matches[0] == 0
        np.testing.assert_allclose(mine.num_matches[1:], ref.num_matches[1:], rtol=0.01)
        assert np.max(np.linalg.norm(mine.position - ref.position, axis=-1)) < 0.02 * span
    np.testing.assert_allclose(rc.position, rb.position, rtol=1e-3, atol=1e-3)
    nm_a, nm_b = rb.num_matches[1:], rc.num_matches[1:]
    assert (np.abs(nm_a - nm_b) <= 0.02 * np.maximum(nm_a, 1)).all(), (nm_a, nm_b)
    assert int(c.state.frames_seen) == n


def test_step_chunk_pipelined_matches_jax():
    """pipeline.step_chunk_pipelined against JAX's over six small VO frames
    of the default variant (jfa + tube) from the same inputs (the JAX
    version vmaps the detections, the port runs them in a row): the chunk's
    threshold, matches within 1 %, positions within 2 % of the span; and
    against the port's exact chunk at JAX's tolerance."""
    with pytest.MonkeyPatch.context() as mp:
        use_pallas(mp, *VIO_FLAGS)
        jc = small_config(jcfg)
        tc = small_config(tcfg)
        n = 6
        seq = jsyn.generate(jc.camera, n_frames=n, seed=0)
        frames = np.stack([seq.images[i] * jc.image_gain for i in range(n)]).astype(np.float32)
        imu_b = jax.tree.map(lambda *xs: jnp.stack(xs), *jax_windows(seq, n, jc.imu.sample_max))
        dts = np.full((n,), 0.05, np.float32)
        mats = jpipe.frontend_matrices(jc)
        jstate, jodo = jpipe.step_chunk_pipelined(jT.init_vio_state(jc), jnp.asarray(frames),
                                                  imu_b, jnp.asarray(dts), jc, mats)
        jax.clear_caches()
    args = (torch.as_tensor(frames), interop.imu_frame_from_numpy(to_np(imu_b), device="cpu"),
            torch.as_tensor(dts), tc, interop.matrices_from_numpy(to_np(mats), device="cpu"))
    tstate, todo = tpipe.step_chunk_pipelined(tT.init_vio_state(tc, device="cpu"), *args)
    _, exact = tpipe.step_chunk(tT.init_vio_state(tc, device="cpu"), *args)
    np.testing.assert_allclose(t2n(tstate.detector_threshold),
                               np.asarray(jstate.detector_threshold), rtol=1e-5)
    jm, tm = np.asarray(jodo.num_matches), t2n(todo.num_matches)
    assert jm[0] == tm[0] == 0
    np.testing.assert_allclose(tm[1:], jm[1:], rtol=0.01)
    jp, tp = np.asarray(jodo.position), t2n(todo.position)
    span = np.linalg.norm(jp[-1] - jp[0])
    assert span > 0.01
    assert np.max(np.linalg.norm(tp - jp, axis=-1)) < 0.02 * span
    np.testing.assert_allclose(tp, t2n(exact.position), rtol=1e-3, atol=1e-3)
    nm_a, nm_b = t2n(exact.num_matches)[1:], tm[1:]
    assert (np.abs(nm_a - nm_b) <= 0.02 * np.maximum(nm_a, 1)).all()
    assert bool(tstate.run_ok) and t2n(todo.run_ok).all()


def test_pipelined_chunk_holds_the_threshold():
    """The pipelined chunk detects every frame at the threshold of the
    chunk's start: its maps are detect_map's at that threshold, and the
    state carries that threshold out."""
    tc = small_config(tcfg)
    seq = tsyn.generate(tc.camera, n_frames=3, seed=0)
    imgs = torch.as_tensor(np.stack(seq.images).astype(np.float32) * tc.image_gain)
    win = tT.tree_map(lambda x: torch.stack([x] * 3), empty_window(tc))
    s0 = tT.init_vio_state(tc, device="cpu")
    s0 = s0.replace(detector_threshold=s0.detector_threshold * 1.5,
                    keylines_count=torch.tensor(1500, dtype=torch.int32))
    st, _ = tpipe.step_chunk_pipelined(s0, imgs, win, torch.full((3,), 0.05), tc)
    from rebvio_tpu_torch.ops import edge_detect

    thr = edge_detect.autogain_threshold(s0.detector_threshold, s0.keylines_count, tc.detector)
    assert torch.equal(st.detector_threshold, thr)
    last = tpipe.detect_map(imgs[2], thr, tpipe.frontend_matrices(tc, "cpu"), tc)
    assert torch.equal(st.keylines_count, last.count)
    assert torch.equal(st.edge_map.kl_id_img, last.kl_id_img)


# ---------------------------------------------------------------------------
# the CLI


@pytest.mark.parametrize("flags", [["--matcher", "walk"], ["--df-mode", "jfa", "--matcher", "walk"],
                                   ["--chunk", "4", "--chunk-mode", "pipelined"],
                                   ["--matcher", "walk", "--chunk", "4", "--chunk-mode",
                                    "pipelined"]],
                         ids=["walk", "jfa_walk", "pipelined", "walk_pipelined"])
def test_run_cli_variants(capsys, flags):
    from rebvio_tpu_torch import run as run_mod

    base = ["--dataset", "synthetic", "--mode", "vo", "--frames", "6", "--preset", "small",
            "--device", "cpu"]
    assert run_mod.main(base + flags) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["run_ok"] and out["frames"] == 6 and np.isfinite(out["ate_sim3"])


def test_run_cli_refuses_tube_on_the_raster_field(capsys):
    from rebvio_tpu_torch import run as run_mod

    with pytest.raises(SystemExit):
        run_mod.main(["--preset", "small", "--frames", "2", "--device", "cpu", "--df-mode",
                      "raster", "--matcher", "tube"])
    assert "requires --df-mode jfa" in capsys.readouterr().err


@pytest.mark.parametrize("matcher,df_mode,want", [("tube", None, "jfa"), ("walk", None, "raster"),
                                                  ("walk", "jfa", "jfa")],
                         ids=["tube", "walk", "jfa_walk"])
def test_default_df_mode(matcher, df_mode, want):
    """The field each matcher runs on unless one is named: JAX's CLI rule
    (rebvio_tpu/run.py), shared by run.py and profile_step."""
    assert tcfg.default_df_mode(matcher, df_mode) == want
