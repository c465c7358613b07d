"""The reference-semantics step (``df_mode="raster"``, ``matcher="walk"``)
batched: the port's ``parallel.batch.batched_step`` (torch.func.vmap of its
own ``pipeline.step``) against the JAX package's (jax.vmap of its step, K2
and K5 in Pallas interpret mode) at the small preset; each lane against the
port's unbatched R+W step; repeated lanes bit for bit; the two kernels this
path launches with a lane axis, K2 on ``tracker.raster_att``'s
full-resolution table and K5 alone (``kernels.reg_ekf``: one launch of its
own kernel; the fused plain version also as the card called it for K5 alone
before, nothing matched, its all-zero K4 output, ``eye(3)`` and zero flag
unbatched), as plain versions under vmap against B unbatched calls and
through their operators' vmap rule with the launches emulated
(tests/torch_helpers.emulated_launches); and no op through vmap's per-lane
fallback.  The jfa/tube step batched: tests/test_torch_batch.py."""

from __future__ import annotations

import os
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_helpers import (as_list, batched_args, check_lanes_match_unbatched,  # noqa: E402
                           check_plain_under_vmap, check_repeated_lanes, emulated_launches,
                           lane_inputs, port_window, record_kernel_lanes, run_jax_lanes,
                           run_port_lanes, stack, tiny_config, use_pallas, variant_configs)

import rebvio_tpu.configs as jcfg  # noqa: E402
import rebvio_tpu_torch.configs as tcfg  # noqa: E402
from rebvio_tpu_torch import interop  # noqa: E402
from rebvio_tpu_torch.ops import kernels  # noqa: E402
from rebvio_tpu_torch.parallel import batch as TB  # noqa: E402

RW = dict(df_mode="raster", matcher="walk")
B, N_STEPS = 3, 3
SEEDS = (0, 1, 0)        # lane 2 repeats lane 0


@pytest.fixture(scope="module")
def vo_runs():
    with pytest.MonkeyPatch.context() as mp:
        use_pallas(mp, "TRYVEL", "REGEKF")
        jc, tc = variant_configs(False, **RW)
        steps = lane_inputs(jc, N_STEPS, SEEDS)
        jrows, jst = run_jax_lanes(jc, steps)
        jax.clear_caches()
    return jrows, jst, run_port_lanes(tc, steps)


@pytest.fixture(scope="module")
def vio_runs():
    jc, tc = variant_configs(True, **RW)
    return run_port_lanes(tc, lane_inputs(jc, 9, SEEDS))   # the SAB filter engages at frame 8


def test_batched_rw_step_matches_jax(vo_runs):
    """test_batched_step_matches_jax's tolerances: matches within 1 %,
    positions within 2 % of the travelled span, orientations within 2e-3."""
    jrows, js, (trows, ts, _lanes) = vo_runs
    jm, tm = stack(jrows, "num_matches"), stack(trows, "num_matches")
    assert (jm[0] == 0).all() and (tm[0] == 0).all()
    np.testing.assert_allclose(tm[1:], jm[1:], rtol=0.01)
    assert stack(trows, "run_ok").all() and stack(jrows, "run_ok").all()
    jp, tp = stack(jrows, "position"), stack(trows, "position")
    span = np.linalg.norm(jp[-1] - jp[0], axis=-1).max()
    assert span > 0
    print("matches", jm.tolist(), tm.tolist(), "position gap",
          float(np.max(np.linalg.norm(tp - jp, axis=-1))), "span", float(span))
    assert np.max(np.linalg.norm(tp - jp, axis=-1)) < 0.02 * span
    assert np.max(np.abs(stack(trows, "orientation") - stack(jrows, "orientation"))) < 2e-3
    tem = interop.to_numpy(ts)["edge_map"]
    assert tem["rho"].shape == js["edge_map"]["rho"].shape == (B, 2048)
    assert np.mean(tem["kl_id_img"] == js["edge_map"]["kl_id_img"]) > 0.99


@pytest.mark.parametrize("runs", ["vo_runs", "vio_runs"])
def test_rw_lanes_match_unbatched_step(runs, request):
    """LANE_TOL_* (tests/torch_helpers.py), VO over 3 steps and VIO over 9."""
    out = request.getfixturevalue(runs)
    rows, st, lanes = out[-1] if runs == "vo_runs" else out
    check_lanes_match_unbatched(rows, st, lanes, vo=runs == "vo_runs")


@pytest.mark.parametrize("runs", ["vo_runs", "vio_runs"])
def test_rw_repeated_lanes_bit_identical(runs, request):
    out = request.getfixturevalue(runs)
    rows, st = (out[-1][0], out[-1][1]) if runs == "vo_runs" else (out[0], out[1])
    check_repeated_lanes(rows, st, 0, 2)


def test_rw_batched_step_has_no_vmap_fallback():
    """Every op of the batched R+W step has a batching rule: none runs lane
    by lane through vmap's fallback (which warns when asked to)."""
    jc, tc = (tiny_config(m, True, **RW) for m in (jcfg, tcfg))
    steps = lane_inputs(jc, 2, SEEDS)
    st = TB.init_batched_state(tc, B, device="cpu")
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for frames, jw, dts in steps:
                st, odo = TB.batched_step(st, torch.as_tensor(frames), port_window(jw),
                                          torch.as_tensor(dts), tc)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert [str(w.message) for w in caught if "batching rule" in str(w.message)] == []
    assert (odo.num_matches > 0).all()


# ---- the two kernels the batched R+W step launches with a lane axis

@pytest.fixture(scope="module")
def rw_kernel_lanes():
    """K2's and K5's wrapper arguments at frame 1 of the tiny R+W VIO run,
    per lane (seeds 0, 1, 2): minimize_vel on the raster table [8, 48*64],
    reg_ekf on the walk-matched map."""
    return record_kernel_lanes(tiny_config(tcfg, True, **RW), tiny_config(jcfg, True, **RW),
                               ("minimize_vel", "reg_ekf"))


def _alone_lanes(lanes):
    """match_reg_ekf with nothing matched, per lane: the all-zero K4 output,
    eye(3) and the zero flag (unbatched under vmap, so in_dims None),
    match_id for the two id planes the tail would copy."""
    out = []
    for ln in lanes:
        (rho, sr, grad, gn, idn, idp, valid, mid, pos, mpos, mgrad, mgn, vel, p) = ln["reg_ekf"]
        K = rho.shape[0]
        out.append({"match_reg_ekf": (
            torch.zeros((12, K)), rho, sr, grad, gn, idn, idp, valid, mid, mid, mid, pos, mpos,
            mgrad, mgn, vel, torch.eye(3), torch.zeros((), dtype=torch.bool),
            kernels.MatchRegEkfParams(*p, cx=0.0, cy=0.0, min_matches=0))})
    return out


UNBATCHED_ARGS = (0, 16, 17)   # match_reg_ekf alone: tube_out, R_tot, fail_nan


@pytest.mark.parametrize("name", ["minimize_vel", "reg_ekf", "match_reg_ekf"])
def test_rw_plain_versions_under_vmap(rw_kernel_lanes, name):
    """K2's plain LM solve on the raster table (its Gram products may sum in
    another order batched: 1e-5 of the largest entry), K5's plain version
    alone and the fused plain version with nothing matched (bit for bit)
    under vmap against one call a lane."""
    lanes = _alone_lanes(rw_kernel_lanes) if name == "match_reg_ekf" else rw_kernel_lanes
    args, dims, per = batched_args(lanes, name)
    if name == "match_reg_ekf":
        dims = list(dims)
        for i in UNBATCHED_ARGS:
            args[i], dims[i] = args[i][0], None
        dims = tuple(dims)
    if name == "minimize_vel":
        assert args[6].shape[1:] == (8, 48 * 64)       # the full-resolution raster table
    plain = getattr(kernels, name + "_plain")
    check_plain_under_vmap(lambda *a: plain(*a), args, dims, per, exact=name != "minimize_vel")


@pytest.mark.parametrize("name", ["minimize_vel", "reg_ekf"])
def test_rw_operator_vmap_rule_lanes(rw_kernel_lanes, name):
    """The wrapper under vmap reaches its operator's vmap rule once (K5
    alone: its own launcher, not the fused stage's), and every lane gets
    what an unbatched call gives, bit for bit (the emulated launch computes
    lane by lane)."""
    args, dims, per = batched_args(rw_kernel_lanes, name)
    fn = getattr(kernels, name)
    with pytest.MonkeyPatch.context() as mp:
        calls = emulated_launches(mp)
        want = [as_list(fn(*p)) for p in per]
        assert len(calls) == B
        calls.clear()
        got = as_list(torch.func.vmap(lambda *a: fn(*a), in_dims=dims)(*args))
    assert calls == ["_launch_minimize_vel" if name == "minimize_vel"
                     else "_launch_reg_ekf"]             # one launch for all lanes
    for b in range(B):
        for g, w in zip(got, want[b]):
            assert torch.equal(g[b], w) or torch.equal(g[b].nan_to_num(), w.nan_to_num()), name

