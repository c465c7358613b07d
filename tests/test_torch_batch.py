"""Batched multi-sequence VIO of the port (parallel/batch.py): the port's
``batched_step`` (torch.func.vmap of its own ``pipeline.step``) against the
JAX package's ``batched_step`` (jax.vmap of its step, the Pallas kernels in
interpret mode) on the same seeded inputs, at the small preset, where
tests/test_torch_pipeline.py set its tolerances (at tests/test_batched.py's
48x64 configuration the port's UNBATCHED step already leaves JAX's from its
second estimate: a tube probe lands on either side of a pixel edge at float
noise and reads another old keyline, tests/test_torch_tiny_config.py; not a
matter of batching), each lane against the port's
unbatched step, repeated lanes bit for bit, each kernel's plain version
under vmap against B unbatched calls, and the kernels' operators' vmap rule
(the lane plumbing of ops/kernels.py, with the launches emulated by the
plain versions: the CUDA kernels themselves run only on the card, in
chip_smoke.py).  The reference-semantics step batched:
tests/test_torch_batch_rw.py."""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_flood import normed  # noqa: E402
from torch_helpers import (PALLAS_FLAGS, as_list, batched_args,  # noqa: E402
                           check_lanes_match_unbatched, check_plain_under_vmap,
                           check_repeated_lanes, emulated_launches, lane_inputs,
                           record_kernel_lanes, run_jax_lanes, run_port_lanes, small_configs,
                           small_vio_configs, stack, t2n, tiny_config, use_pallas)

import rebvio_tpu.configs as jcfg  # noqa: E402
import rebvio_tpu_torch.configs as tcfg  # noqa: E402
from rebvio_tpu_torch import interop, types as tT  # noqa: E402
from rebvio_tpu_torch.geometry import linalg  # noqa: E402
from rebvio_tpu_torch.ops import kernels  # noqa: E402
from rebvio_tpu_torch.parallel import batch as TB  # noqa: E402

B, N_STEPS = 3, 3
SEEDS = (0, 1, 0)        # lane 2 repeats lane 0


@pytest.fixture(scope="module")
def vo_runs():
    with pytest.MonkeyPatch.context() as mp:
        use_pallas(mp, *PALLAS_FLAGS)
        jc, tc = small_configs()
        steps = lane_inputs(jc, N_STEPS, SEEDS)
        jrows, jst = run_jax_lanes(jc, steps)
        jax.clear_caches()
    return jrows, jst, run_port_lanes(tc, steps)


@pytest.fixture(scope="module")
def vio_runs():
    jc, tc = small_vio_configs()
    return run_port_lanes(tc, lane_inputs(jc, 9, SEEDS))   # the SAB filter engages at frame 8


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


# LANE_TOL_* (tests/torch_helpers.py): positions, R_global and match counts
@pytest.mark.parametrize("runs", ["vo_runs", "vio_runs"])
def test_lanes_match_unbatched_step(runs, request):
    out = request.getfixturevalue(runs)
    rows, st, lanes = out[-1] if runs == "vo_runs" else out
    check_lanes_match_unbatched(rows, st, lanes, vo=runs == "vo_runs")


@pytest.mark.parametrize("runs", ["vo_runs", "vio_runs"])
def test_repeated_lanes_bit_identical(runs, request):
    out = request.getfixturevalue(runs)
    rows, st = (out[-1][0], out[-1][1]) if runs == "vo_runs" else (out[0], out[1])
    check_repeated_lanes(rows, st, 0, 2)


# ---- the kernels: the plain versions under vmap, and the operators' rule

STEP_KERNELS = ("att_flood", "minimize_vel", "tube_match", "match_reg_ekf", "estimate_bias")


@pytest.fixture(scope="module")
def kernel_lanes():
    """Each step kernel's arguments at frame 1 of the tiny VIO run, per lane
    (seeds 0, 1, 2), recorded from the port's unbatched step; and the
    Cholesky inverse's [7, 7] SAB prior."""
    return record_kernel_lanes(tiny_config(tcfg, True), tiny_config(jcfg, True),
                               STEP_KERNELS + ("chol_inverse",))


PLAIN = {"att_flood": kernels.att_flood_plain, "minimize_vel": kernels.minimize_vel_plain,
         "try_vel": kernels.try_vel_plain, "tube_match": kernels.tube_match_plain,
         "match_reg_ekf": kernels.match_reg_ekf_plain,
         "estimate_bias": kernels.estimate_bias_plain,
         "chol_inverse": linalg.chol_inverse_plain}


def try_vel_lanes(lanes):
    """try_vel's single pass on minimize_vel's inputs, random residuals."""
    rng = np.random.RandomState(5)
    out = []
    for ln in lanes:
        a = ln["minimize_vel"]
        res = torch.as_tensor(rng.uniform(0, 6, a[1].shape[0]).astype(np.float32))
        out.append({"try_vel": (*a[:5], res, a[5] + 0.01, a[6], a[7])})
    return out


# The plain versions under vmap against B unbatched calls.  Bit for bit but
# where a batched matrix product may sum in another order (try_vel's and the
# LM solve's Gram products, the SAB solve's products): there 1e-5 relative
# to the output's largest entry; ids and counts exact everywhere.
PLAIN_EXACT = {"att_flood", "tube_match", "match_reg_ekf", "chol_inverse"}


def held(name):
    """One lane's expected outputs: att_flood's gradient-norm plane (5), a
    function of planes 3 and 4 alone, as the correctly rounded norm of the
    expected planes 3 and 4 (torch_flood.normed, the kernel's __fsqrt_rn),
    which the batched plane must equal bit for bit."""
    if name != "att_flood":
        return lambda outs: outs
    return lambda outs: [normed(outs[0])] + list(outs[1:])


@pytest.mark.parametrize("name", list(PLAIN))
def test_plain_versions_under_vmap(kernel_lanes, name):
    lanes = try_vel_lanes(kernel_lanes) if name == "try_vel" else kernel_lanes
    args, dims, per = batched_args(lanes, name)
    check_plain_under_vmap(lambda *a: PLAIN[name](*a), args, dims, per, name in PLAIN_EXACT,
                           held(name))


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
    fn = linalg.chol_inverse if name == "chol_inverse" else getattr(kernels, WRAPPERS[name])
    with pytest.MonkeyPatch.context() as mp:
        calls = emulated_launches(mp)
        want = [as_list(fn(*p)) for p in per]
        # one argument left unbatched where the wrapper takes one: the rule
        # expands it to the lanes
        if name in ("tube_match",):
            dims = list(dims)
            args[3], dims[3] = args[3][0], None
            dims = tuple(dims)
            want = [as_list(fn(*p[:3], per[0][3], *p[4:])) for p in per]
        calls.clear()
        got = as_list(torch.func.vmap(lambda *a: fn(*a), in_dims=dims)(*args))
    assert len(calls) == 1, calls                  # one launch for all lanes
    for b in range(B):
        for g, w in zip([g[b] for g in got], held(name)(want[b])):
            assert torch.equal(g, w) or torch.equal(g.nan_to_num(), w.nan_to_num()), name


@pytest.mark.parametrize("case", ["batched@unbatched", "unbatched@batched",
                                  "transposed@batched"])
def test_lane_matmul_lanes_are_unbatched_products(case):
    """linalg.lane_matmul under vmap: each lane's product is the unbatched
    call on that lane's operands, bit for bit (the same shapes and strides:
    a transposed view stays one), in one call of the rule."""
    rng = np.random.RandomState(7)
    x = torch.as_tensor(rng.randn(B, 40, 30).astype(np.float32))
    w = torch.as_tensor(rng.randn(30, 20).astype(np.float32))
    left = torch.as_tensor(rng.randn(50, 40).astype(np.float32))
    if case == "batched@unbatched":
        got = torch.func.vmap(linalg.lane_matmul, in_dims=(0, None))(x, w)
        want = [x[b] @ w for b in range(B)]
    elif case == "unbatched@batched":
        got = torch.func.vmap(linalg.lane_matmul, in_dims=(None, 0))(left, x)
        want = [left @ x[b] for b in range(B)]
    else:
        got = torch.func.vmap(lambda a: linalg.lane_matmul(a.T, a))(x)
        want = [x[b].T @ x[b] for b in range(B)]
    for b in range(B):
        assert torch.equal(got[b], want[b])


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
