"""The streaming runner's modes and the pieces that keep the step free of
host syncs, on the small preset (CPU, plain versions), against the JAX
package where it has the same function: ``advance``'s device selects (first
frame, failure latch, recovery; tests/test_e2e.py:62-104), the detector's
fixed-size compaction against ``torch.nonzero``, the staged IMU window,
``step_chunk`` / ``run(chunk=N)`` (tests/test_scan_chunk.py),
``run_realtime``'s accounting (tests/test_e2e.py:189-216), the staging
ring's slot-reuse rule, the keyframe map's stored copies and the CLI's
``--chunk`` / ``--realtime``."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import edge_map_t, small_configs, small_vio_configs, t2n, to_np  # noqa: E402

from rebvio_tpu import pipeline as jpipe, types as jT  # noqa: E402
from rebvio_tpu.data import synthetic as jsyn  # noqa: E402
from rebvio_tpu.ops import imu as jimu  # noqa: E402
from rebvio_tpu.runner import VioRunner as JRunner  # noqa: E402
from rebvio_tpu_torch import interop, pipeline as tpipe, runner as trunner  # noqa: E402
from rebvio_tpu_torch import types as tT  # noqa: E402
from rebvio_tpu_torch.ba.keyframe_map import KeyframeMapBuilder  # noqa: E402
from rebvio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from rebvio_tpu_torch.graph import SlotLayout, StagingRing  # noqa: E402
from rebvio_tpu_torch.ops import edge_detect, imu as timu  # noqa: E402
from rebvio_tpu_torch.runner import VioRunner  # noqa: E402

ODO = ("orientation", "position", "num_matches", "run_ok")


# ---------------------------------------------------------------------------
# the detector's compaction


@pytest.mark.parametrize("density,kmax", [(0.0, 64), (0.01, 256), (0.2, 256)],
                         ids=["none", "under_kmax", "over_kmax"])
def test_compaction_matches_nonzero(density, kmax):
    """Slot s holds the (s+1)-th candidate in raster order, bit for bit as
    ``nonzero`` then the cutoff; the id image as the scatter of the kept
    indices."""
    H, W = 37, 53
    cand = torch.as_tensor(np.random.RandomState(3).rand(H * W) < density)
    idx, valid, total = edge_detect.compact_raster(cand, kmax)
    nz = torch.nonzero(cand).squeeze(1)[:kmax]
    n = nz.shape[0]
    assert {"none": n == 0, "under_kmax": 0 < n < kmax,
            "over_kmax": int(cand.sum()) > kmax}[
        {0.0: "none", 0.01: "under_kmax", 0.2: "over_kmax"}[density]]
    want = torch.zeros((kmax,), dtype=torch.int64)
    want[:n] = nz
    assert torch.equal(idx, want)
    assert torch.equal(valid, torch.arange(kmax) < n)
    assert int(total) == int(cand.sum())
    img = torch.full((H * W,), -1, dtype=torch.int32)
    img[nz] = torch.arange(n, dtype=torch.int32)
    assert torch.equal(edge_detect.id_image(idx, valid, H, W), img.reshape(H, W))


# ---------------------------------------------------------------------------
# the staged IMU window


@pytest.mark.parametrize("n", [0, 1, 9, 40], ids=["empty", "one", "many", "over_sample_max"])
def test_staged_imu_window_matches_jax(n):
    """A window packed into frame 1 of a two-frame staging slot reads back,
    through the slot's views, as JAX's pack_imu_window, bit for bit; so does
    the port's pack_imu_window (the host packer and one upload)."""
    S = 32
    rng = np.random.RandomState(4)
    ts = np.cumsum(rng.randint(4000, 6000, 40)).astype(np.int64) + 1_000_000
    g = rng.randn(40, 3).astype(np.float32)
    a = rng.randn(40, 3).astype(np.float32)
    want = to_np(jimu.pack_imu_window(g[:n], a[:n], ts[:n], S))
    layout = SlotLayout(2, (5, 7), np.uint8, S)
    slot = torch.zeros((layout.nbytes,), dtype=torch.uint8)
    img = rng.randint(0, 255, (5, 7)).astype(np.uint8)
    layout.pack(slot.numpy(), 1, img, g[:n], a[:n], ts[:n], 0.05)
    frames, imu, dts = layout.views(slot)
    staged = tT.tree_map(lambda x: x[1], imu)
    direct = timu.pack_imu_window(g[:n], a[:n], ts[:n], S, device="cpu")
    for got in (staged, direct):
        for k, w in want.items():
            v = t2n(getattr(got, k))
            assert v.dtype == w.dtype and v.shape == w.shape, k
            np.testing.assert_array_equal(v, w, err_msg=k)
    assert int(staged.n) == min(n, S)
    np.testing.assert_array_equal(t2n(frames[1]), img)
    assert float(dts[1]) == float(np.float32(0.05))
    assert not t2n(frames[0]).any() and int(imu.n[0]) == 0


# ---------------------------------------------------------------------------
# advance's device selects against JAX's advance


@pytest.fixture(scope="module")
def advance_inputs():
    """A JAX state after two small VO frames, frame 2's detection and an
    empty IMU window."""
    jc, tc = small_configs()
    seq = jsyn.generate(jc.camera, n_frames=3, seed=1)
    mats = jpipe.frontend_matrices(jc)
    win = jimu.pack_imu_window(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0, np.int64),
                               jc.imu.sample_max)
    frames = [jnp.asarray(seq.images[i] * jc.image_gain, jnp.float32) for i in range(3)]
    st = jT.init_vio_state(jc)
    for i in range(2):
        st, _ = jpipe.step(st, frames[i], win, jnp.float32(0.05), jc, mats)
    new_map, thr = jpipe.detect_frame(st, frames[2], mats, jc)
    return jc, tc, st, new_map, thr, win


@pytest.mark.parametrize("case", ["first", "frozen", "recover"])
def test_advance_selects_match_jax(advance_inputs, case):
    """First frame, failure latch, and the recovery re-seed: the selected
    state is the stored detection (with cleared histories and run_ok on
    recovery), leaf for leaf as JAX's, and the odometry the idle one."""
    jc, tc, st, new_map, thr, win = advance_inputs
    if case == "first":
        st = st.replace(frames_seen=jnp.zeros((), jnp.int32))
    else:
        st = st.replace(run_ok=jnp.zeros((), bool))
    if case == "recover":
        jc = dataclasses.replace(jc, recover_on_failure=True)
        tc = dataclasses.replace(tc, recover_on_failure=True)
    jstate, jodo = jax.jit(jpipe.advance, static_argnames="config")(
        st, new_map, thr, win, jnp.float32(0.05), config=jc)
    tstate, todo = tpipe.advance(
        interop.state_from_numpy(to_np(st), device="cpu"), edge_map_t(new_map),
        torch.as_tensor(np.asarray(thr)), interop.imu_frame_from_numpy(to_np(win), device="cpu"),
        torch.full((), 0.05), tc)
    want, got = to_np(jstate), interop.to_numpy(tstate)

    def same(w, g, path=""):
        if isinstance(w, dict):
            for k in w:
                same(w[k], g[k], f"{path}.{k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)

    same(want, got)
    assert bool(got["run_ok"]) == (case != "frozen")
    if case == "recover":
        assert not got["imu_state"]["vel_hist"].any()
    assert int(got["frames_seen"]) == int(st.frames_seen) + 1
    np.testing.assert_array_equal(t2n(todo.position), np.asarray(jodo.position))
    np.testing.assert_allclose(t2n(todo.orientation), np.asarray(jodo.orientation), atol=1e-6)
    assert int(todo.num_matches) == int(jodo.num_matches) == 0
    assert bool(todo.run_ok) == bool(jodo.run_ok)


@pytest.mark.parametrize("recover", [False, True], ids=["latch", "recovery"])
def test_failure_latch_and_recovery_match_jax(recover):
    """Blank frames (tests/test_e2e.py:62-104 on the small preset): the
    failure latches run_ok and freezes the pose; with recover_on_failure the
    run re-seeds after the gap and tracks again.  run_ok frame for frame as
    the JAX runner, and the match counts within 1 %."""
    jc, tc = small_configs()
    if recover:
        jc = dataclasses.replace(jc, recover_on_failure=True)
        tc = dataclasses.replace(tc, recover_on_failure=True)
    n, lo, hi = (16, 5, 8) if recover else (8, 4, 8)
    seq = jsyn.generate(jc.camera, n_frames=n, seed=1)
    seq.images[lo:hi] = 25.0     # blank
    want = JRunner(jc, undistort=False).run(seq)
    got = VioRunner(tc, undistort=False, device="cpu").run(seq)
    np.testing.assert_array_equal(got.run_ok, want.run_ok)
    assert (got.num_matches == 0).tolist() == (want.num_matches == 0).tolist()
    np.testing.assert_allclose(got.num_matches, want.num_matches, rtol=0.01)
    i_fail = int(np.argmin(got.run_ok))
    assert not got.run_ok[i_fail] and got.run_ok[:i_fail].all()
    if recover:
        assert got.run_ok[-1] and got.num_matches[-1] > tc.core.global_min_matches_threshold
    else:
        assert not got.run_ok[i_fail:].any()
        assert np.array_equal(got.position[i_fail:], np.broadcast_to(got.position[i_fail],
                                                                     got.position[i_fail:].shape))


# ---------------------------------------------------------------------------
# exact chunks


def test_step_chunk_matches_jax():
    """pipeline.step_chunk against JAX's (a lax.scan of the step) over ten
    small VIO frames from the same inputs (tests/test_scan_chunk.py): the
    same matches within 1 %, run_ok, and the pose once the SAB filter is
    engaged (frame 8) within 2 % of the travelled span."""
    jc, tc = small_vio_configs()
    n = 10
    seq = jsyn.generate(jc.camera, n_frames=n, seed=0)
    frames = np.stack([seq.images[i] * jc.image_gain for i in range(n)]).astype(np.float32)
    wins, cursor = [], 0
    for i in range(n):
        j = cursor
        while j < len(seq.imu_ts_us) and seq.imu_ts_us[j] <= seq.ts_us[i]:
            j += 1
        wins.append(jimu.pack_imu_window(seq.imu_gyro[cursor:j], seq.imu_acc[cursor:j],
                                         seq.imu_ts_us[cursor:j], jc.imu.sample_max))
        cursor = j
    imu_b = jax.tree.map(lambda *xs: jnp.stack(xs), *wins)
    dts = np.full((n,), 0.05, np.float32)
    mats = jpipe.frontend_matrices(jc)
    _, jodo = jpipe.step_chunk(jT.init_vio_state(jc), jnp.asarray(frames), imu_b,
                               jnp.asarray(dts), jc, mats)
    tstate, todo = tpipe.step_chunk(
        tT.init_vio_state(tc, device="cpu"), torch.as_tensor(frames),
        interop.imu_frame_from_numpy(to_np(imu_b), device="cpu"), torch.as_tensor(dts), tc,
        interop.matrices_from_numpy(to_np(mats), device="cpu"))
    jm, tm = np.asarray(jodo.num_matches), t2n(todo.num_matches)
    assert jm[0] == tm[0] == 0
    np.testing.assert_allclose(tm[1:], jm[1:], rtol=0.01)
    assert t2n(todo.run_ok).all() and np.asarray(jodo.run_ok).all()
    jp, tp = np.asarray(jodo.position), t2n(todo.position)
    span = np.linalg.norm(jp[-1] - jp[0])
    assert span > 0 and int(tstate.num_frames) == n - 1
    assert np.max(np.linalg.norm(tp - jp, axis=-1)) < 0.02 * span


def test_run_chunk_equals_streaming():
    """run(seq, chunk=4) over ten distorted VIO frames (two chunks, then two
    tail frames one by one) is streaming, bit for bit, final state included;
    the pipelined chunk mode runs its own program for the chunks and the
    per-frame one for the tail, and equals step_chunk_pipelined's chunks."""
    _, tc = small_vio_configs()
    seq = tsyn.generate(tc.camera, n_frames=10, seed=0, distort=True, imu_preroll_s=0.1)
    a = VioRunner(tc, undistort=True, device="cpu")
    b = VioRunner(tc, undistort=True, device="cpu")
    ra, rb = a.run(seq), b.run(seq, chunk=4)
    assert sorted(b._programs) == [(1, "exact"), (4, "exact")]
    for f in ("ts_us",) + ODO:
        np.testing.assert_array_equal(getattr(rb, f), getattr(ra, f), err_msg=f)
    for x, y in zip(tT.tree_leaves(a.state), tT.tree_leaves(b.state)):
        assert torch.equal(x, y)
    assert ra.run_ok.all() and ra.num_matches[-1] > tc.core.global_min_matches_threshold
    b.reset()
    rp = b.run(seq, chunk=4, pipelined=True)
    assert sorted(b._programs) == [(1, "exact"), (4, "exact"), (4, "pipelined")]
    assert rp.run_ok.all() and rp.num_matches[0] == 0
    # the threshold held for each chunk: JAX's tolerance against the exact
    # mode (tests/test_scan_chunk.py)
    np.testing.assert_allclose(rp.position, ra.position, rtol=1e-3, atol=1e-3)
    nm_a, nm_p = ra.num_matches[1:], rp.num_matches[1:]
    assert (np.abs(nm_a - nm_p) <= 0.02 * np.maximum(nm_a, 1)).all(), (nm_a, nm_p)


# ---------------------------------------------------------------------------
# run_realtime, on a simulated clock


class _Clock:
    """perf_counter / sleep of a simulated clock; each frame's step takes
    ``cost`` seconds of it."""

    def __init__(self, cost: float):
        self.t, self.cost = 0.0, cost

    def perf_counter(self):
        return self.t

    def sleep(self, d):
        self.t += d


def _paced(monkeypatch, runner, cost):
    clock = _Clock(cost)
    monkeypatch.setattr(trunner, "time", clock)
    run = runner._run

    def timed(prog, k):
        clock.t += clock.cost
        return run(prog, k)

    monkeypatch.setattr(runner, "_run", timed)
    return clock


def test_run_realtime_keepup_and_drops(monkeypatch):
    """tests/test_e2e.py:189-216 on a simulated clock (a step costs 30 ms):
    at a slow playback speed (a frame every 100 ms) every frame is processed
    and none dropped; at 1000x with a queue of one, everything due after
    frame 0's step is dropped but the newest: processed + dropped stays the
    frame count, the order stays monotonic, and the dropped frames' IMU goes
    to the next processed frame (the same window as a two-frame run)."""
    _, tc = small_vio_configs()
    seq = tsyn.generate(tc.camera, n_frames=10, seed=0)
    runner = VioRunner(tc, undistort=False, device="cpu")
    _paced(monkeypatch, runner, 0.03)
    rt = runner.run_realtime(seq, speed=0.5)
    assert rt.processed == 10 and rt.dropped == 0
    assert rt.frame_idx.tolist() == list(range(10)) and rt.result.run_ok.all()
    assert 0.03 <= rt.worst_latency_s < 0.3
    np.testing.assert_array_equal(rt.result.ts_us, seq.ts_us)

    runner.reset()
    rt2 = runner.run_realtime(seq, speed=1000.0, queue_size=1)
    assert rt2.processed + rt2.dropped == 10 and rt2.dropped == 8
    assert rt2.frame_idx.tolist() == [0, 9]
    assert (np.diff(rt2.frame_idx) > 0).all()
    # frame 9 integrates every IMU sample since frame 0
    pair = dataclasses.replace(seq, images=seq.images[[0, 9]], ts_us=seq.ts_us[[0, 9]])
    ref = VioRunner(tc, undistort=False, device="cpu").run(pair)
    for f in ODO:
        np.testing.assert_array_equal(getattr(rt2.result, f), getattr(ref, f), err_msg=f)


# ---------------------------------------------------------------------------
# the staging ring, the stored keyframe maps, the CLI


class _Event:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def synchronize(self):
        self.log.append(("sync", self.name))


def test_staging_ring_reuses_a_slot_after_its_reader():
    """A slot goes out again only after the event of the replay that read it
    has been waited on; a slot still held cannot go out twice."""
    log = []
    ring = StagingRing(["s0", "s1", "s2"])
    assert [ring.acquire() for _ in range(3)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="still held"):
        ring.acquire()
    ring.release(0, _Event(log, "replay 0"))
    ring.release(1, None)                    # the CPU: read when released
    log.append(("acquire", ring.acquire()))
    log.append(("acquire", ring.acquire()))
    assert log == [("sync", "replay 0"), ("acquire", 0), ("acquire", 1)]
    with pytest.raises(RuntimeError, match="still held"):
        ring.acquire()                       # slot 2: acquired, not released
    ring.release(2, _Event(log, "replay 2"))
    assert ring.acquire() == 2 and log[-1] == ("sync", "replay 2")


def test_keyframe_map_stores_a_copy():
    """A graphed runner rewrites state.edge_map in place every frame: the
    mapper keeps copies, not references."""
    _, tc = small_configs()
    mapper = KeyframeMapBuilder(tc, kf_every=1, store_maps=True)
    em = tT.init_vio_state(tc, device="cpu").edge_map
    mapper.add_frame(em, np.zeros(3, np.float32), np.zeros(3, np.float32))
    em.rho.fill_(7.0)
    em.valid.fill_(True)
    kept = mapper.kf_maps[0]
    assert float(kept.rho.max()) == tT.RHO_INIT and not bool(kept.valid.any())


def test_run_cli_chunk_and_realtime(capsys):
    from rebvio_tpu_torch import run as run_mod

    base = ["--dataset", "synthetic", "--mode", "vo", "--frames", "6", "--preset", "small",
            "--device", "cpu"]
    assert run_mod.main(base + ["--chunk", "4"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["run_ok"] and out["frames"] == 6 and np.isfinite(out["ate_sim3"])
    assert run_mod.main(base + ["--realtime", "1000", "--rt-queue", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rt_processed"] + out["rt_dropped"] == 6 and out["frames"] == out["rt_processed"]
    for flags in (["--realtime", "1", "--chunk", "4"], ["--realtime", "1", "--pose-graph"],
                  ["--df-mode", "raster", "--matcher", "tube"]):
        with pytest.raises(SystemExit):
            run_mod.main(base + flags)
    capsys.readouterr()
