"""Batched multi-sequence VIO of the port (parallel/batch.py): the port's
``batched_step`` (torch.func.vmap of its own ``pipeline.step``) against the
JAX package's ``batched_step`` (jax.vmap of its step, the Pallas kernels in
interpret mode) on the same seeded inputs, at the small preset, where
tests/test_torch_pipeline.py set its tolerances (at tests/test_batched.py's
48x64 configuration the port's UNBATCHED step already lies 1.2e-3 m from
JAX's at its second estimate, one of 220 matches flipping: beyond them, and
not a matter of batching), each lane against the port's
unbatched step, repeated lanes bit for bit, each kernel's plain version
under vmap against B unbatched calls, and the kernels' operators' vmap rule
(the lane plumbing of ops/kernels.py, with the launches emulated by the
plain versions: the CUDA kernels themselves run only on the card, in
chip_smoke.py)."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_helpers import (PALLAS_FLAGS, jax_windows, small_configs,  # noqa: E402
                           small_vio_configs, t2n, to_np, use_pallas)

import rebvio_tpu.configs as jcfg  # noqa: E402
import rebvio_tpu_torch.configs as tcfg  # noqa: E402
from rebvio_tpu.data import synthetic as jsyn  # noqa: E402
from rebvio_tpu.parallel import batch as JB  # noqa: E402
from rebvio_tpu_torch import interop, pipeline as tpipe, types as tT  # noqa: E402
from rebvio_tpu_torch.geometry import linalg  # noqa: E402
from rebvio_tpu_torch.ops import kernels  # noqa: E402
from rebvio_tpu_torch.parallel import batch as TB  # noqa: E402

B, N_STEPS = 3, 3
SEEDS = (0, 1, 0)        # lane 2 repeats lane 0


def tiny(mod, use_imu: bool):
    """tests/test_batched.py's tiny configuration (48x64, 256 keylines); VIO
    with a 2-frame bias-init window."""
    cam = mod.CameraConfig(rows=48, cols=64, cx=32, cy=24, fx=60, fy=60,
                           k1=0, k2=0, k3=0, p1=0, p2=0)
    return mod.PipelineConfig(camera=cam,
                              detector=mod.EdgeDetectorConfig(keylines_max=256, keylines_ref=128),
                              core=mod.CoreConfig(search_range=8, global_min_matches_threshold=5),
                              imu=mod.ImuConfig(sample_max=8, init_bias_frame_num=2),
                              use_imu=use_imu)


def lane_inputs(jc, n: int):
    """Per step: frames [B, H, W] float32 (gained), the JAX IMU windows
    (leaves [B, ...]) and the frame intervals [B]."""
    seqs = [jsyn.generate(jc.camera, n_frames=n, seed=s) for s in SEEDS]
    wins = [jax_windows(s, n, jc.imu.sample_max) for s in seqs]
    steps = []
    for i in range(n):
        frames = np.stack([s.images[i].astype(np.float32) * jc.image_gain for s in seqs])
        dts = np.array([0.0 if i == 0 else (s.ts_us[i] - s.ts_us[i - 1]) / 1e6 for s in seqs],
                       np.float32)
        jw = jax.tree.map(lambda *xs: jnp.stack(xs), *[w[i] for w in wins])
        steps.append((frames, jw, dts))
    return steps


def port_window(jw, lane=None):
    d = to_np(jw)
    if lane is not None:
        d = {k: v[lane] for k, v in d.items()}
    return interop.imu_frame_from_numpy(d, device="cpu")


def run_port(tc, steps):
    """The port's batched run and each lane's unbatched run: (batched
    odometry rows, batched final state, [per-lane odometry rows] + [the
    lanes' final unbatched states])."""
    mats = tpipe.frontend_matrices(tc, "cpu")
    st = TB.init_batched_state(tc, B, device="cpu")
    rows, lanes = [], [[] for _ in range(B)]
    singles = [tT.init_vio_state(tc, device="cpu") for _ in range(B)]
    lanes.append(singles)
    for frames, jw, dts in steps:
        st, odo = TB.batched_step(st, torch.as_tensor(frames), port_window(jw),
                                  torch.as_tensor(dts), tc, mats)
        rows.append({k: t2n(getattr(odo, k)) for k in ("orientation", "position",
                                                       "num_matches", "run_ok")})
        for b in range(B):
            singles[b], o = tpipe.step(singles[b], torch.as_tensor(frames[b]),
                                       port_window(jw, b), float(dts[b]), tc, mats)
            lanes[b].append({k: t2n(getattr(o, k)) for k in rows[-1]})
    return rows, st, lanes


@pytest.fixture(scope="module")
def vo_runs():
    with pytest.MonkeyPatch.context() as mp:
        use_pallas(mp, *PALLAS_FLAGS)
        jc, tc = small_configs()
        steps = lane_inputs(jc, N_STEPS)
        jst = JB.init_batched_state(jc, B)
        jrows = []
        for frames, jw, dts in steps:
            jst, jodo = JB.batched_step(jst, jnp.asarray(frames), jw, jnp.asarray(dts), jc)
            jrows.append(to_np(jodo))
        jax.clear_caches()
    return jrows, to_np(jst), run_port(tc, steps)


@pytest.fixture(scope="module")
def vio_runs():
    jc, tc = small_vio_configs()
    return run_port(tc, lane_inputs(jc, 9))      # the SAB filter engages at frame 8


def stack(rows, key):
    return np.stack([r[key] for r in rows])            # [steps, B, ...]


def test_batched_step_matches_jax(vo_runs):
    """test_torch_pipeline.py's tolerances for one step: matches within 1 %,
    positions within 2 % of the travelled span, orientations within 2e-3."""
    jrows, js, (trows, ts, _lanes) = vo_runs
    jm, tm = stack(jrows, "num_matches"), stack(trows, "num_matches")
    assert (jm[0] == 0).all() and (tm[0] == 0).all()
    np.testing.assert_allclose(tm[1:], jm[1:], rtol=0.01)
    assert stack(trows, "run_ok").all() and stack(jrows, "run_ok").all()
    jp, tp = stack(jrows, "position"), stack(trows, "position")
    span = np.linalg.norm(jp[-1] - jp[0], axis=-1).max()
    assert span > 0
    assert np.max(np.linalg.norm(tp - jp, axis=-1)) < 0.02 * span
    assert np.max(np.abs(stack(trows, "orientation") - stack(jrows, "orientation"))) < 2e-3
    tem = interop.to_numpy(ts)["edge_map"]
    assert tem["rho"].shape == js["edge_map"]["rho"].shape == (B, 2048)
    assert np.mean(tem["kl_id_img"] == js["edge_map"]["kl_id_img"]) > 0.99


# Each lane of the batched step against the port's unbatched step on its
# inputs: positions within LANE_TOL_REL of the lane's largest position, the
# final R_global within LANE_TOL_R, match counts within 1 %.  Measured on
# the CPU (torch 2.13, small preset): positions within 2.0e-6 m of 0.021 m
# (VO, 3 steps: 0.01 %) and 2.0e-5 m of 0.0061 m (VIO, 9 steps, the SAB
# filter's first estimate at the last: 0.33 %), R_global within 1e-7 (VO)
# and 2.2e-4 (VIO: the first gravity alignment), match counts equal.  Not
# bit for bit: under vmap a matrix product with a batched operand
# runs as one batched product (the frontend's band products, the Gram sums),
# whose kernels sum in another order than the unbatched product's; from the
# first frame on a few keylines' depths then differ.  The VIO odometry's
# rotation vectors are not compared: they sit near a half turn, where
# so3.log turns 1e-7 in the matrix into 1e-3 in the vector (test_torch_vio.py).
LANE_TOL_REL = 0.01
LANE_TOL_R = 1e-3
LANE_MATCH_RTOL = 0.01


@pytest.mark.parametrize("runs", ["vo_runs", "vio_runs"])
def test_lanes_match_unbatched_step(runs, request):
    out = request.getfixturevalue(runs)
    rows, st, lanes = out[-1] if runs == "vo_runs" else out
    singles = lanes[B]
    for b in range(B):
        lp = np.stack([r["position"] for r in lanes[b]])
        bp = stack(rows, "position")[:, b]
        np.testing.assert_allclose(stack(rows, "num_matches")[:, b],
                                   [r["num_matches"] for r in lanes[b]], rtol=LANE_MATCH_RTOL)
        print(runs, "lane", b, "max position difference", float(np.max(np.abs(lp - bp))))
        assert np.max(np.abs(lp - bp)) < LANE_TOL_REL * np.abs(lp).max()
        assert float((st.R_global[b] - singles[b].R_global).abs().max()) < LANE_TOL_R
        if runs == "vo_runs":
            lo = np.stack([r["orientation"] for r in lanes[b]])
            assert np.max(np.abs(lo - stack(rows, "orientation")[:, b])) < 1e-5
    if runs == "vio_runs":
        assert np.abs(stack(rows, "position")[-1]).max() > 0    # the filter engaged


@pytest.mark.parametrize("runs", ["vo_runs", "vio_runs"])
def test_repeated_lanes_bit_identical(runs, request):
    out = request.getfixturevalue(runs)
    rows, st = (out[-1][0], out[-1][1]) if runs == "vo_runs" else (out[0], out[1])
    for key in ("orientation", "position", "num_matches", "run_ok"):
        a = stack(rows, key)
        np.testing.assert_array_equal(a[:, 0], a[:, 2], err_msg=key)
    for x in tT.tree_leaves(st):
        assert torch.equal(x[0], x[2])


# ---- the kernels: the plain versions under vmap, and the operators' rule

STEP_KERNELS = ("att_flood", "minimize_vel", "tube_match", "match_reg_ekf", "estimate_bias")


@pytest.fixture(scope="module")
def kernel_lanes():
    """Each step kernel's arguments at frame 1 of the tiny VIO run, per lane
    (seeds 0, 1, 2), recorded from the port's unbatched step; and the
    Cholesky inverse's [7, 7] SAB prior."""
    tc = tiny(tcfg, True)
    jc = tiny(jcfg, True)
    mats = tpipe.frontend_matrices(tc, "cpu")
    rec = {name: [] for name in STEP_KERNELS + ("chol_inverse",)}
    originals = {name: getattr(kernels, name) for name in STEP_KERNELS}
    chol = linalg.chol_inverse

    def recorder(name, fn):
        def call(*args):
            rec[name].append(args)
            return fn(*args)
        return call

    lanes = []
    with pytest.MonkeyPatch.context() as mp:
        for name in STEP_KERNELS:
            mp.setattr(kernels, name, recorder(name, originals[name]))
        mp.setattr(linalg, "chol_inverse", recorder("chol_inverse", chol))
        for seed in (0, 1, 2):
            seq = jsyn.generate(jc.camera, n_frames=2, seed=seed)
            win = jax_windows(seq, 2, 8)
            st = tT.init_vio_state(tc, device="cpu")
            for i in range(2):
                for v in rec.values():
                    v.clear()
                st, _ = tpipe.step(st, torch.as_tensor(seq.images[i].astype(np.float32) * 3.0),
                                   port_window(win[i]), 0.05 * (i > 0), tc, mats)
            lanes.append({k: v[0] for k, v in rec.items()} |
                         {"chol_inverse": [a for a in rec["chol_inverse"]
                                           if a[0].shape == (7, 7)][0]})
    return lanes


PLAIN = {"att_flood": kernels.att_flood_plain, "minimize_vel": kernels.minimize_vel_plain,
         "try_vel": kernels.try_vel_plain, "tube_match": kernels.tube_match_plain,
         "match_reg_ekf": kernels.match_reg_ekf_plain,
         "estimate_bias": kernels.estimate_bias_plain,
         "chol_inverse": linalg.chol_inverse_plain}


def batched_args(lanes, name):
    """(stacked args, in_dims): tensors stacked over the lanes, the rest
    (constants, NamedTuples) taken from lane 0."""
    per = [ln[name] for ln in lanes]
    args, dims = [], []
    for i, a in enumerate(per[0]):
        if torch.is_tensor(a):
            args.append(torch.stack([p[i] for p in per]))
            dims.append(0)
        else:
            args.append(a)
            dims.append(None)
    return args, tuple(dims), per


def try_vel_lanes(lanes):
    """try_vel's single pass on minimize_vel's inputs, random residuals."""
    rng = np.random.RandomState(5)
    out = []
    for ln in lanes:
        a = ln["minimize_vel"]
        res = torch.as_tensor(rng.uniform(0, 6, a[1].shape[0]).astype(np.float32))
        out.append({"try_vel": (*a[:5], res, a[5] + 0.01, a[6], a[7])})
    return out


def as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


# The plain versions under vmap against B unbatched calls.  Bit for bit but
# where a batched matrix product may sum in another order (try_vel's and the
# LM solve's Gram products, the SAB solve's products): there 1e-5 relative
# to the output's largest entry; ids and counts exact everywhere.
PLAIN_EXACT = {"att_flood", "tube_match", "match_reg_ekf", "chol_inverse"}


@pytest.mark.parametrize("name", list(PLAIN))
def test_plain_versions_under_vmap(kernel_lanes, name):
    lanes = try_vel_lanes(kernel_lanes) if name == "try_vel" else kernel_lanes
    args, dims, per = batched_args(lanes, name)
    got = as_list(torch.func.vmap(lambda *a: PLAIN[name](*a), in_dims=dims)(*args))
    for b in range(B):
        want = as_list(PLAIN[name](*per[b]))
        for g, w in zip(got, want):
            g = g[b]
            if name in PLAIN_EXACT or not g.is_floating_point():
                assert torch.equal(g, w) or (g.is_floating_point() and
                                             torch.equal(g.isnan(), w.isnan()) and
                                             torch.equal(g.nan_to_num(), w.nan_to_num())), name
            else:
                fin = torch.isfinite(w)
                assert torch.equal(fin, torch.isfinite(g))
                scale = w[fin].abs().max().clamp(min=1e-30) if fin.any() else 1.0
                if fin.any():
                    assert float(((g - w)[fin].abs() / scale).max()) < 1e-5, name


def _emulated_launches(mp):
    """The operators' launches emulated on CPU tensors by the plain versions,
    lane by lane (the test's stand-in for the CUDA kernels), and the
    wrappers routed to the operators."""
    mp.setattr(kernels, "_on_cuda", lambda *ts: True)

    def flood(stack, sr, rows, cols, scale):
        return torch.stack([kernels.att_flood_plain(s, sr, rows, cols, scale) for s in stack])

    def solve(name, pos_img, rho, sr, grad, use_f, res, vel, att, g, it):
        outs, rs, ms = [], [], []
        for b in range(rho.shape[0]):
            a = (pos_img[b], rho[b], sr[b], grad[b], use_f[b])
            if res is None:
                v, JtJ, JtF, F, r, m, gains, acc, trials = kernels.minimize_vel_plain(
                    *a, vel[b], att[b], g, it, debug=True)
                outs.append(torch.cat([v, JtJ.reshape(9), JtF, F.reshape(1), gains,
                                       acc.to(torch.float32), trials]))
            else:
                F, JtJ, JtF, r, m = kernels.try_vel_plain(*a, res[b], vel[b], att[b], g)
                outs.append(torch.cat([torch.zeros(3), JtJ.reshape(9), JtF, F.reshape(1)]))
            rs.append(r)
            ms.append(m)
        return torch.stack(outs), torch.stack(rs), torch.stack(ms)

    def tube(kl, att, dyn, M2, g):
        return torch.stack([kernels.tube_match_plain(*a, g) for a in zip(kl, att, dyn, M2)])

    def mre(ins, p):
        fo, io, failed = [], [], []
        for b in range(ins[0].shape[0]):
            x = [t[b] for t in ins]
            # plain argument order: tube_out first, then the map planes
            o = kernels.match_reg_ekf_plain(x[13], *x[:8], x[14], x[15], *x[8:13], x[16],
                                            x[17], p)
            K = x[0].shape[0]
            fo.append(torch.cat([o[0], o[1], o[6], o[4].reshape(-1), o[5].reshape(-1)]))
            io.append(torch.cat([o[2], o[3], o[7], o[8].reshape(1),
                                 torch.zeros(-(-K // 128), dtype=torch.int32)]))
            failed.append(o[9])
        return torch.stack(fo), torch.stack(io), torch.stack(failed)

    def sab(ins, iters):
        outs = [kernels.estimate_bias_plain(*(t[b] for t in ins), iters)
                for b in range(ins[0].shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    mp.setattr(kernels, "_launch_att_flood", flood)
    mp.setattr(kernels, "_launch_minimize_vel", solve)
    mp.setattr(kernels, "_launch_tube_match", tube)
    mp.setattr(kernels, "_launch_match_reg_ekf", mre)
    mp.setattr(kernels, "_launch_estimate_bias", sab)
    mp.setattr(kernels, "_launch_chol_inverse", linalg.chol_inverse_plain)


WRAPPERS = {"att_flood": "att_flood", "minimize_vel": "minimize_vel", "try_vel": "try_vel",
            "tube_match": "tube_match", "match_reg_ekf": "match_reg_ekf",
            "estimate_bias": "estimate_bias"}


@pytest.mark.parametrize("name", list(WRAPPERS) + ["chol_inverse"])
def test_operator_vmap_rule_lanes(kernel_lanes, name):
    """Each wrapper under vmap reaches its operator's vmap rule once, which
    hands the launch [B, ...] lanes (an unbatched argument expanded), and
    the wrapper's slicing of the [B, ...] outputs gives every lane what an
    unbatched call gives: bit for bit, since the emulated launch computes
    lane by lane."""
    lanes = try_vel_lanes(kernel_lanes) if name == "try_vel" else kernel_lanes
    args, dims, per = batched_args(lanes, name)
    fn = linalg.chol_inverse if name == "chol_inverse" else None
    with pytest.MonkeyPatch.context() as mp:
        _emulated_launches(mp)
        calls = []
        for launch in ("_launch_att_flood", "_launch_minimize_vel", "_launch_tube_match",
                       "_launch_match_reg_ekf", "_launch_estimate_bias", "_launch_chol_inverse"):
            inner = getattr(kernels, launch)

            def counted(*a, _inner=inner, _name=launch):
                calls.append(_name)
                return _inner(*a)
            mp.setattr(kernels, launch, counted)
        fn = fn or getattr(kernels, WRAPPERS[name])
        want = [as_list(fn(*p)) for p in per]
        n_unbatched = len(calls)
        # one argument left unbatched where the wrapper takes one: the rule
        # expands it to the lanes
        if name in ("tube_match",):
            dims = list(dims)
            args[3], dims[3] = args[3][0], None
            dims = tuple(dims)
            want = [as_list(fn(*p[:3], per[0][3], *p[4:])) for p in per]
            n_unbatched = len(calls) - n_unbatched
            calls.clear()
        else:
            calls.clear()
        got = as_list(torch.func.vmap(lambda *a: fn(*a), in_dims=dims)(*args))
    assert len(calls) == 1, calls                  # one launch for all lanes
    for b in range(B):
        for g, w in zip(got, want[b]):
            assert torch.equal(g[b], w) or torch.equal(g[b].nan_to_num(), w.nan_to_num()), name


def test_rule_refuses_cpu_tensors():
    """Reached with CPU tensors (never, through the wrappers), the rule
    raises: no plain fallback, no loop over lanes."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        torch.func.vmap(torch.ops.rebvio.chol_inverse)(torch.eye(3).expand(2, 3, 3))


def test_batched_runner_equals_batched_step():
    """``VioRunner(batch=B).run_batched`` on distorted streams (each lane
    with its own IMU cursor, the B frames undistorted over the batch in one
    gather, one program a batched frame from a staging slot of B frames)
    equals ``batched_step`` driven by hand on the lanes' undistorted frames
    and packed windows, bit for bit; ``process_batch`` continues the streams;
    a batched runner runs nothing else, an unbatched one no batch."""
    from rebvio_tpu_torch.camera import Undistorter
    from rebvio_tpu_torch.data import synthetic as tsyn
    from rebvio_tpu_torch.ops.imu import pack_imu_window
    from rebvio_tpu_torch.runner import VioRunner

    _, tc = small_vio_configs()
    n = 4
    seqs = [tsyn.generate(tc.camera, n_frames=n, seed=s, distort=True, imu_preroll_s=0.1)
            for s in SEEDS]
    runner = VioRunner(tc, undistort=True, device="cpu", batch=B)
    res = runner.run_batched(seqs)
    und = Undistorter(tc.camera, tc.image_gain, "cpu")
    st = TB.init_batched_state(tc, B, device="cpu")
    cursors = [0] * B
    for i in range(n):
        wins = []
        for b, s in enumerate(seqs):
            hi = int(np.searchsorted(s.imu_ts_us, s.ts_us[i], side="right"))
            w = pack_imu_window(s.imu_gyro[cursors[b]:hi], s.imu_acc[cursors[b]:hi],
                                s.imu_ts_us[cursors[b]:hi], tc.imu.sample_max, device="cpu")
            wins.append(w)
            cursors[b] = hi
        win = tT.tree_map(lambda *xs: torch.stack(xs), *wins)
        frames = torch.stack([und(torch.as_tensor(np.asarray(s.images[i]))) for s in seqs])
        dts = torch.tensor([0.0 if i == 0 else (s.ts_us[i] - s.ts_us[i - 1]) / 1e6
                            for s in seqs], dtype=torch.float32)
        st, odo = TB.batched_step(st, frames, win, dts, tc)
        for b in range(B):
            np.testing.assert_array_equal(res[b].position[i], t2n(odo.position[b]))
            np.testing.assert_array_equal(res[b].num_matches[i], t2n(odo.num_matches[b]))
    runner.reset()
    head = runner.run_batched(seqs, range(0, 2))
    rows = [t2n(runner.process_batch(seqs, i)) for i in range(2, n)]
    for b in range(B):
        np.testing.assert_array_equal(head[b].position, res[b].position[:2])
        np.testing.assert_array_equal(np.stack([r[b, 3:6] for r in rows]), res[b].position[2:])
    with pytest.raises(ValueError, match="batch"):
        runner.run(seqs[0])
    with pytest.raises(ValueError, match="batch"):
        VioRunner(tc, undistort=True, device="cpu").run_batched(seqs)
