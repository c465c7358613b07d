"""What decides ``correct``, driven through the rest of a run on the CPU at
a small size (the look for a card skipped): a sound run passes, the TF32
control fails, and so does a run whose timed path is broken underneath
in each way the cell can be: a step that returns its state unchanged, half
the batch left out, an answer altered where it is produced, one lane's
tracking broken, and leaves that no pose reads at once left unchanged (the
depth uncertainty, the SAB filter's covariance).  (The cells run on one
card, so no exchange between cards can be left out.)"""

import math
import time

import numpy as np
import pytest
import torch

from vio_bench import check, harness

SEED = 2 ** 31 + 99
LIVE = dict(warmup_frames=16, check_steps=2)
FLEET = dict(lanes=2, session_frames=17, check_from_frame=16, check_sessions=2)


def unchanged(step):
    def broken(state, *args):
        return (state, *step(state, *args)[1:])
    return broken


def half_batch(step):
    def broken(state, *args):
        new, *rest = step(state, *args)
        from rebvio_tpu_torch import types as T

        h = new.Pos.shape[0] // 2
        return (T.tree_map(lambda n, o: torch.cat([n[:h], o[h:]]), new, state), *rest)
    return broken


def sigma_unchanged(step):
    def broken(state, *args):
        new, *rest = step(state, *args)
        em = new.edge_map.replace(sigma_rho=state.edge_map.sigma_rho)
        return (new.replace(edge_map=em), *rest)
    return broken


def sab_cov_unchanged(step):
    def broken(state, *args):
        new, *rest = step(state, *args)
        return (new.replace(sab_state=new.sab_state.replace(P=state.sab_state.P)), *rest)
    return broken


def one_lane_tracking(step):
    """Lane 0's pose moved by 1 cm, on its tracking steps only."""
    def broken(state, *args):
        new, odo, *rest = step(state, *args)
        shift = torch.zeros_like(new.Pos)
        shift[0] = 0.01 * (state.frames_seen[0] > 0).to(shift.dtype)
        return (new.replace(Pos=new.Pos + shift), odo.replace(position=odo.position + shift),
                *rest)
    return broken


def altered(step):
    def broken(state, *args):
        new, odo, *rest = step(state, *args)
        return (new, odo.replace(position=odo.position + 0.01), *rest)
    return broken


def run_small(small_cell, name, traffic, seconds, control=False):
    c = small_cell(name, **traffic)
    ctx = harness.Ctx(c, SEED, seconds, False, "cpu", time.perf_counter())
    return harness.run_cell(ctx, control=control)


@pytest.mark.parametrize("name,traffic,seconds,mode,fault", [
    ("parity.live20", LIVE, 0.5, "exact", None),
    ("parity.live20", LIVE, 0.5, "exact", unchanged),
    ("parity.live20", LIVE, 0.5, "exact", altered),
    ("parity.live20", LIVE, 0.5, "exact", sigma_unchanged),
    ("parity.live20", LIVE, 0.5, "exact", sab_cov_unchanged),
    ("rw.fleet8", FLEET, 0.0, "batched", None),
    ("rw.fleet8", FLEET, 0.0, "batched", unchanged),
    ("rw.fleet8", FLEET, 0.0, "batched", half_batch),
    ("rw.fleet8", FLEET, 0.0, "batched", altered),
    ("rw.fleet8", FLEET, 0.0, "batched", sigma_unchanged),
    ("rw.fleet8", FLEET, 0.0, "batched", sab_cov_unchanged),
    ("rw.fleet8", FLEET, 0.0, "batched", one_lane_tracking),
    ("parity.fleet8", FLEET, 0.0, "batched", None),
    ("parity.fleet8", FLEET, 0.0, "batched", unchanged),
    ("parity.fleet8", FLEET, 0.0, "batched", half_batch),
    ("parity.fleet8", FLEET, 0.0, "batched", altered),
    ("parity.fleet8", FLEET, 0.0, "batched", one_lane_tracking),
], ids=["live-sound", "live-unchanged", "live-altered", "live-sigma-unchanged",
        "live-sab-cov-unchanged", "fleet-sound", "fleet-unchanged", "fleet-half-batch",
        "fleet-altered", "fleet-sigma-unchanged", "fleet-sab-cov-unchanged",
        "fleet-one-lane-tracking", "parity-fleet-sound", "parity-fleet-unchanged",
        "parity-fleet-half-batch", "parity-fleet-altered", "parity-fleet-one-lane-tracking"])
def test_broken_timed_path_is_not_correct(small_cell, monkeypatch, name, traffic, seconds, mode,
                                          fault):
    from rebvio_tpu_torch import runner

    if fault is not None:
        monkeypatch.setitem(runner.MODES, mode, fault(runner.MODES[mode]))
    res = run_small(small_cell, name, traffic, seconds)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-1] == "checks"
    limits = [lim for _, lim in res["checks"].values() if lim is not None]
    assert limits and all(np.isfinite(limits))


@pytest.mark.parametrize("name,traffic,seconds", [("parity.live20", LIVE, 0.5),
                                                  ("rw.fleet8", FLEET, 0.0),
                                                  ("parity.fleet8", FLEET, 0.0)],
                         ids=["live", "fleet", "parity-fleet"])
def test_control_is_not_correct(small_cell, name, traffic, seconds):
    res = run_small(small_cell, name, traffic, seconds, control=True)
    limits = {k: lim for k, (_, lim) in res["control"].items() if lim is not None}
    control = {k: v for k, (v, _) in res["control"].items()}
    assert res["correct"] and not check.verdict(control, limits), res["control"]


def test_tf32_rounding():
    from vio_bench.reference.oracle import round_tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 3 * 2 ** -11), 3e38,
                      float("inf"), 0.0])
    y = round_tf32(x)
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -9)]
    assert (y.view(torch.int32) & 0x1FFF).eq(0).all() and y[5] == float("inf")
    r = torch.randn(10000)
    assert ((round_tf32(r) - r).abs() <= r.abs() * 2 ** -11).all()


@pytest.mark.parametrize("first,tracking,deviant,caught", [
    (8, 32, 3, False), (8, 32, 4, True), (1, 12, 1, False), (1, 12, 2, True), (8, 32, 16, True)])
def test_the_step_percentile(first, tracking, deviant, caught):
    """Up to three deviant tracking steps of a fleet run's 32 pass the
    percentile (K2's summation order moves one step in hundreds), and one
    of a live run's 12; one lane's four, two live steps or half the batch
    do not.  The worst step is judged whatever the percentile says."""
    per_step = [dict.fromkeys(check.NUMBERS, 1e-9) for _ in range(first + tracking)]
    flags = [False] * first + [True] * tracking
    for s in per_step[first:first + deviant]:
        s.update(pose_gap_mm=float("inf"), depth_gap=1.0)
    out = check.summarize(per_step, flags)
    assert (out["pose_gap_mm"] == float("inf")) is caught
    assert (out["depth_gap"] == 1.0) is caught
    assert out["pose_gap_mm.worst"] == float("inf") and out["depth_gap.worst"] == 1.0
    # a first frame's step counts for the worst step only
    per_step[0]["sigma_gap"] = float("nan")
    out = check.summarize(per_step, flags)
    assert out["sigma_gap"] == 1e-9 and math.isnan(out["sigma_gap.worst"])


def test_the_groups_cover_every_leaf():
    """Every leaf of the state after a step, and every field of its
    odometry, belongs to one number."""
    from vio_bench import spec
    from vio_bench.reference import types as T
    from vio_bench.tests.conftest import SMALL_CAMERA, SMALL_KEYLINES

    cfg = spec.resolve("parity.live20").config["pipeline"]
    cfg["camera"].update(SMALL_CAMERA)
    cfg["detector"].update(SMALL_KEYLINES)
    from vio_bench.reference import oracle

    state = T.init_vio_state(oracle.build_config(cfg), "cpu")
    grouped = [k for leaves in check.GROUPS.values() for k, _ in leaves]
    assert len(grouped) == len(set(grouped))
    want = set(spec.leaves(state)) | {f"odometry.{f}" for f in check.ODOMETRY}
    assert set(grouped) == want
    odo = T.Odometry(orientation=torch.zeros(3), position=torch.zeros(3),
                     num_matches=torch.zeros((), dtype=torch.int32),
                     run_ok=torch.ones((), dtype=torch.bool))
    assert set(spec.leaves(odo)) == set(check.ODOMETRY)
    rec = check.record(spec.leaves(odo), spec.leaves(state))
    assert set(check.step_numbers(rec, rec).values()) == {0.0}
    # a NaN on one side fails the exact comparison as well as its own number
    bad = dict(rec, Pos=np.full(3, np.nan, np.float32))
    out = check.step_numbers(bad, rec)
    assert out["pose_gap_mm"] == math.inf and out["exact_gap"] == 1.0
