"""Product checks: numbers that a traffic loop adds to ``correct`` beside
the step numbers, driven through ``harness.run_cell`` on the CPU by a stub
loop that hands back one step sample (frame 0 of a small stream, as the
reference computes it) and one product check with a planted gap; and the
cells without product checks, judged as before on recorded numbers."""

import json
import sys
import time
import types

import pytest

from vio_bench import check, control, frames, harness, spec
from vio_bench.tests.conftest import SMALL_CAMERA, SMALL_KEYLINES

SEED = 2 ** 31 + 5
KIND = "stub_products"
LIMIT = 1e-3


@pytest.fixture(scope="module")
def step_sample():
    """A small rw.fleet8 cell and frame 0 of one of its streams, with the
    reference's own step as the program's outputs."""
    import torch

    from vio_bench.reference import oracle

    c = spec.resolve("rw.fleet8")
    p = c.config["pipeline"]
    p["camera"].update(SMALL_CAMERA)
    p["detector"].update(SMALL_KEYLINES)
    rcfg = oracle.build_config(p)
    stream = frames.streams(rcfg.camera, c.traffic["scene"], 2, SEED, 1, "cpu")[0]
    with torch.no_grad():
        st, odo = oracle.Reference(rcfg, "cpu").step(oracle.init_state(rcfg, "cpu"), stream, 0,
                                                     True)
    return c, harness.Sample(stream, 0, None, check.record(spec.leaves(odo), spec.leaves(st)))


def stub(monkeypatch, step_sample, numbers=("map_gap",), gap=1e-5, control_gap=1.0,
         limits=None):
    """The cell of ``step_sample`` run by a stub loop declaring ``numbers``,
    whose one product check gives ``gap`` (None: no number) and
    ``control_gap``; ``limits`` added to the cell's."""
    cell, sample = step_sample

    def product(ctx, control):
        prog = {} if gap is None else {"map_gap": gap}
        return prog, ({"map_gap": control_gap} if control else None)

    def run(ctx):
        out = harness.Outcome()
        out.setup_s, out.attempted, out.metrics = 1.0, 1, {"frames_per_s": 1.0}
        out.samples.append(sample)
        out.products.append(product)
        return out

    mod = types.ModuleType(f"vio_bench.loops.{KIND}")
    mod.NUMBERS, mod.run = numbers, run
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    c = spec.Cell(name="stub", chips=1, config=cell.config, traffic=dict(cell.traffic, kind=KIND),
                  cell={"limits": dict(cell.cell["limits"], **(limits or {"map_gap": LIMIT})),
                        "worst_limits": dict(cell.cell["worst_limits"], map_gap=LIMIT)},
                  end_to_end=cell.end_to_end, per_layer=cell.per_layer)
    return c


def run_stub(c, control=False):
    return harness.run_cell(harness.Ctx(c, SEED, 0.0, False, "cpu", time.perf_counter()),
                            control=control)


@pytest.mark.parametrize("gap,limits,correct", [
    (1e-5, None, True),
    (1e-2, None, False),
    (None, None, False),
    (1e-5, {"map_gap": LIMIT, "ghost_gap": 1.0}, False),
], ids=["within", "past-limit", "never-produced", "limit-of-no-number"])
def test_product_check_decides_correct(monkeypatch, step_sample, gap, limits, correct):
    res = run_stub(stub(monkeypatch, step_sample, gap=gap, limits=limits))
    assert res["correct"] is correct, res["checks"]
    assert list(res)[-1] == "checks"
    # the step numbers are judged as before, beside the product's
    assert res["checks"]["pose_gap_mm"][0] <= res["checks"]["pose_gap_mm"][1]
    if gap is None:
        assert res["checks"]["map_gap"] == [None, LIMIT]
        assert res["checks"]["map_gap.worst"] == [None, LIMIT]
    else:
        assert res["checks"]["map_gap"] == [gap, LIMIT]
        assert res["checks"]["map_gap.worst"] == [gap, LIMIT]
    if limits and "ghost_gap" in limits:
        assert res["checks"]["ghost_gap"] == [None, 1.0]


@pytest.mark.parametrize("numbers", [("pose_gap_mm",), ("map_gap", "map_gap"),
                                     ("map_gap.worst",)],
                         ids=["step-number", "twice", "worst"])
def test_a_declared_number_must_be_new(monkeypatch, step_sample, numbers):
    with pytest.raises(ValueError, match="clash"):
        run_stub(stub(monkeypatch, step_sample, numbers=numbers))


def test_an_undeclared_number_raises(monkeypatch, step_sample):
    with pytest.raises(ValueError, match="does not declare"):
        run_stub(stub(monkeypatch, step_sample, numbers=("other_gap",)))


def test_control_numbers_are_merged(monkeypatch, step_sample, capsys):
    """``vio_bench.control`` prints the product's numbers for the program
    and for the control beside the step numbers."""
    c = stub(monkeypatch, step_sample)
    monkeypatch.setattr(control.spec, "resolve", lambda name: c)
    assert control.main(["--workload", "stub", "--seeds", str(SEED), "--seconds", "0",
                         "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["program"]["map_gap"] == [1e-5, LIMIT]
    assert line["control"]["map_gap"] == [1.0, LIMIT]
    assert line["per_product"] == [{"map_gap": 1e-5}]
    assert line["control_per_product"] == [{"map_gap": 1.0}]
    assert set(check.NUMBERS) < set(line["control"]) and len(line["control_per_step"]) == 1
    limits = {k: lim for k, (_, lim) in line["control"].items() if lim is not None}
    assert not check.verdict({k: v for k, (v, _) in line["control"].items()}, limits)


def _floats(x):
    """A recorded line's numbers, non-finite ones read back from the
    strings ``harness.finite`` wrote."""
    if isinstance(x, str):
        return float(x)
    if isinstance(x, dict):
        return {k: _floats(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_floats(v) for v in x]
    return x


RECORDED = spec.HERE / "tests" / "data" / "recorded_checks.json"


@pytest.mark.parametrize("name", ["parity.live20", "rw.fleet8"])
def test_existing_cells_judged_as_before(monkeypatch, name):
    """Per-step numbers of the program and of the control that
    ``vio_bench.control`` recorded on an H100 before product checks
    existed, put through ``run_cell`` again: the same ``checks`` and
    control lines, key for key and value for value, and the same
    ``correct``."""
    rec = json.loads(RECORDED.read_text())[name]
    c = spec.resolve(name)

    def run(ctx):
        out = harness.Outcome()
        out.setup_s = 1.0
        out.metrics = {m["name"]: 1.0 for m in c.end_to_end}
        out.samples = [harness.Sample(None, 0, {} if t else None, {}) for t in rec["tracking"]]
        return out

    monkeypatch.setattr(harness.loop(c.traffic["kind"]), "run", run)
    monkeypatch.setattr(harness, "reference_numbers", lambda ctx, samples, control=False: (
        _floats(rec["per_step"]), _floats(rec["control_per_step"]) if control else None))
    res = harness.run_cell(harness.Ctx(c, rec["seed"], 0.0, False, "cpu", time.perf_counter()),
                           control=True)
    assert harness.finite(res["checks"]) == rec["program"]
    assert harness.finite(res["control"]) == rec["control"]
    assert res["correct"] is rec["correct"] is True
    ctrl = {k: v for k, (v, _) in res["control"].items()}
    assert not check.verdict(ctrl, check.all_limits(c.cell))
