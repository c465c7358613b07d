"""BENCHMARK.json and the files it names: every cell resolves to its
configuration, traffic, cell and metric files, within the contract's
limits; a cell, a configuration, a mix and a metric are added by new files
and entries alone."""

import dataclasses
import hashlib
import json
import re
import shutil
import sys
import types
from pathlib import Path

import pytest

from vio_bench import check, harness, spec
from vio_bench.reference import oracle

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vio_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", spec.cells())
def test_cell_resolves_to_its_files(name):
    from rebvio_tpu_torch.configs import PipelineConfig

    c = spec.resolve(name)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in c.end_to_end}
    # one file states every key of the pipeline: the program and the
    # reference build the same configuration from it
    prog = spec.build(PipelineConfig, c.config["pipeline"])
    ref = oracle.build_config(c.config["pipeline"])
    assert dataclasses.asdict(prog) == dataclasses.asdict(ref)
    entry = {x["name"]: x for x in BENCH["configs"]}[
        {w["name"]: w for w in BENCH["workloads"]}[name]["config"]]
    # a cut of scale is a key of the file, named in `reduced`, never a width
    assert c.config["reduced"] == entry["reduced"] and c.traffic["kind"]
    for k in c.config["reduced"]:
        assert k in c.config and k in c.config["reduced_why"] and not k.endswith(("_dim", "_rank"))
    # a cell that runs recorded sequences runs them at the length its
    # configuration states
    if "session_frames" in c.traffic:
        assert c.traffic["session_frames"] == c.config["sequence_frames"]
    # a limit holds a step number or a number that the cell's loop declares
    assert c.cell["limits"] and set(check.all_limits(c.cell)) <= judged(c.traffic["kind"])


def judged(kind: str) -> set:
    """Every number a cell of a loop of ``kind`` can give a limit."""
    names = harness.loop_numbers(harness.loop(kind))
    return set(check.summarize_all([dict.fromkeys(check.NUMBERS, 0.0)], [True],
                                   [dict.fromkeys(names, 0.0)], names))


def test_a_limit_needs_a_number_that_is_produced(monkeypatch):
    """A cell's limit on a number that neither the steps nor its loop's
    product checks give is refused; a declared one is accepted."""
    mod = types.ModuleType("vio_bench.loops.stub_declares")
    mod.NUMBERS = ("map_gap",)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    assert {"map_gap", "map_gap.worst", "pose_gap_mm.worst"} <= judged("stub_declares")
    for kind in ("closed_loop_fleet", "stub_declares"):
        assert "ghost_gap" not in judged(kind)
    assert "map_gap" not in judged("closed_loop_fleet")


def test_config_file_states_every_key():
    from rebvio_tpu_torch.configs import PipelineConfig

    p = spec.resolve(spec.cells()[0]).config["pipeline"]
    with pytest.raises(ValueError, match="missing"):
        spec.build(PipelineConfig, {k: v for k, v in p.items() if k != "df_mode"})
    with pytest.raises(ValueError, match="unknown"):
        spec.build(PipelineConfig, dict(p, extra=1))


def _digests(root: Path):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix, cell
    and per-layer metric: the harness lists and resolves them, and no file
    that was there changed."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "vio_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root / "vio_bench")
    b = root / "vio_bench"
    conf = json.loads((b / "configs" / "euroc-parity.json").read_text())
    conf["name"] = "euroc-fast"
    conf["pipeline"]["detector"]["keylines_max"] = 8192
    (b / "configs" / "euroc-fast.json").write_text(json.dumps(conf))
    traffic = json.loads((b / "traffic" / "fleet8.json").read_text())
    traffic["lanes"] = 32
    (b / "traffic" / "fleet32.json").write_text(json.dumps(traffic))
    (b / "cells" / "fast.fleet32.json").write_text(json.dumps({"limits": {}}))
    (b / "metrics" / "step.device_ms.fleet32.py").write_text(
        "def read(t):\n    return t.busy_ms_per_step()\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "euroc-fast", "source": "https://example.org/x",
                             "file": "vio_bench/configs/euroc-fast.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "fast.fleet32", "config": "euroc-fast",
                               "traffic": "fleet32", "chips": 1, "why": "test"})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index("frames_per_s")][
        "workloads"].append("fast.fleet32")
    bench["per_layer"].append({"name": "step.device_ms.fleet32", "unit": "ms",
                               "better": "lower", "source": "device_trace", "layer": "step",
                               "moves": "frames_per_s", "workloads": ["fast.fleet32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    assert "fast.fleet32" in spec.cells(root)
    c = spec.resolve("fast.fleet32", root)
    assert c.traffic["lanes"] == 32 and c.config["pipeline"]["detector"]["keylines_max"] == 8192
    assert [m["name"] for m in c.per_layer] == ["step.device_ms.fleet32"]
    assert spec.metric_reader("step.device_ms.fleet32", root) is not None
    after = _digests(root / "vio_bench")
    assert {k: v for k, v in after.items() if k in before} == before
