"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout names each cell's configuration, traffic mix and per-layer
metrics; each lives in a file of its own under this folder:

    configs/<config>.json    a deployment: its source, every key of the
                             pipeline's configuration, what is assumed
    traffic/<traffic>.json   a traffic mix: the loop it runs under
                             (``kind``) and the generator's parameters
    cells/<cell>.json        a cell's correctness sample and the limit of
                             each number compared
    metrics/<metric>.py      a per-layer metric's reader

A new cell adds files and entries; no file here is edited for it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import typing
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json, resolved to its files."""

    name: str
    chips: int
    config: dict                   # configs/<config>.json
    traffic: dict                  # traffic/<traffic>.json
    cell: dict                     # cells/<cell>.json
    end_to_end: List[dict]         # the end-to-end metrics this cell reports
    per_layer: List[dict]          # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str, end_to_end_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list,
    else every cell (an end-to-end metric) or every cell that reports the
    end-to-end metric it ``moves`` (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end_names is None or metric["moves"] in end_to_end_names


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its files; raises
    KeyError for a cell the file does not name."""
    bench = load_json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    base = root / bench["paths"][0]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=load_json(root / conf["file"]),
                traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
                cell=load_json(base / "cells" / f"{name}.json"), end_to_end=e2e,
                per_layer=layer)


def cells(root: Path = ROOT) -> List[str]:
    """Every workload name of ``root``/BENCHMARK.json."""
    return [w["name"] for w in load_json(root / "BENCHMARK.json")["workloads"]]


def metric_reader(name: str, root: Path = ROOT):
    """``read(trace) -> float | None`` of metrics/<name>.py."""
    path = root / "vio_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"vio_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def build(cls, d: dict):
    """An instance of the (frozen, nested) dataclass ``cls`` from ``d``,
    which must give every field and no other key: the file states every
    key it runs with."""
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    if set(d) != set(fields):
        raise ValueError(f"{cls.__name__}: keys missing {sorted(set(fields) - set(d))}, "
                         f"unknown {sorted(set(d) - set(fields))}")
    kw = {}
    for name, value in d.items():
        t = hints[name]
        if dataclasses.is_dataclass(t):
            kw[name] = build(t, value)
        elif isinstance(value, list):
            kw[name] = tuple(value)
        else:
            kw[name] = value
    return cls(**kw)


def leaves(tree, prefix: str = "") -> Dict[str, object]:
    """The tensors of a tree of dataclasses by dotted path."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(leaves(getattr(tree, f.name), f"{prefix}{f.name}."))
        return out
    return {prefix[:-1]: tree}


def from_leaves(cls, flat: Dict[str, object], prefix: str = ""):
    """The dataclass tree ``cls`` with its tensors taken from ``flat`` (by
    dotted path, as ``leaves`` gives them)."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        t = hints[f.name]
        path = f"{prefix}{f.name}"
        kw[f.name] = from_leaves(t, flat, path + ".") if dataclasses.is_dataclass(t) else flat[path]
    return cls(**kw)

