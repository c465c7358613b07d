"""The parts of a run that every cell shares: the run's context, the
samples and product checks a traffic loop hands back, the check against
the reference, and the result object."""

import gc
import importlib
import math
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vio_bench import check, spec
from vio_bench.trace import Trace

# top-level modules that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "rebvio_tpu")


class Ctx:
    """One run: the cell, its seed and window, and the device."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float):
        from rebvio_tpu_torch.configs import PipelineConfig

        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), float(seconds), trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.traffic = cell.traffic
        self.config = spec.build(PipelineConfig, cell.config["pipeline"])
        self.check_rng = np.random.RandomState(
            np.random.SeedSequence([self.seed % (1 << 64), 1]).generate_state(1)[0])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Sample:
    """One step to hold to the reference: frame ``i`` of ``stream``, the
    program's state before it (dotted leaves; None: the stream's first
    frame, from the reference's own initial state) and its outputs."""

    def __init__(self, stream, i: int, before: Optional[Dict[str, torch.Tensor]],
                 after: Dict[str, np.ndarray]):
        self.stream, self.i, self.before, self.after = stream, i, before, after


# one item's numbers against its plain reference: check(ctx, control) ->
# (the program's {number: gap}, the TF32 control's, or None unless control)
ProductCheck = Callable[[Ctx, bool], Tuple[Dict[str, float], Optional[Dict[str, float]]]]


class Outcome:
    """What a traffic loop hands back: besides the steps to hold to the
    reference (``samples``), the checks of what else its timed path produced
    (``products``), each called once the window has closed and the
    program's state is freed, giving numbers that its loop declares
    (``NUMBERS`` of ``loops/<kind>.py``; ``loop_numbers``)."""

    def __init__(self):
        self.setup_s: float = None
        self.attempted = 0
        self.failed = 0
        self.metrics: Dict[str, float] = {}
        self.samples: List[Sample] = []
        self.products: List[ProductCheck] = []
        self.memory_peak_bytes = 0
        self.trace: Optional[Trace] = None
        self.notes: Dict[str, object] = {}


def snapshot(state) -> Dict[str, torch.Tensor]:
    """A copy of the program's state in host memory (so that the device's
    peak stays the program's), by dotted leaf path."""
    return {k: v.to("cpu", copy=True) for k, v in spec.leaves(state).items()}


def reference_numbers(ctx: Ctx, samples: List[Sample], control: bool = False):
    """Each sample's step worked out by the reference from the program's
    state before it.  Returns (per-sample numbers of the program against
    the reference, per-sample numbers of the control against the
    reference, or None)."""
    from vio_bench.reference import oracle

    from vio_bench.reference import so3

    rcfg = oracle.build_config(ctx.cell.config["pipeline"])
    ref = oracle.Reference(rcfg, ctx.device)
    prog, ctrl = [], []

    def judge(rec, want):
        # the odometry's rotation vector is log(R_global) of the same step,
        # and near an angle of pi a float32 log magnifies R's rounding ten
        # thousand times: it is held to the reference's log of the R it
        # was taken from, which is itself held to the reference's R
        R = torch.as_tensor(rec["R_global"]).to(ctx.device)
        return check.step_numbers(rec, dict(want, **{
            "odometry.orientation": check.np_(so3.log(R))}))

    for s in samples:
        def state():
            if s.before is None:
                return oracle.init_state(rcfg, ctx.device)
            return oracle.state_from({k: v.to(ctx.device) for k, v in s.before.items()})

        first = s.before is None
        with torch.no_grad():
            st, odo = ref.step(state(), s.stream, s.i, first)
            want = check.record(spec.leaves(odo), spec.leaves(st))
            prog.append(judge(s.after, want))
            if control:
                with oracle.tf32():
                    st_c, odo_c = ref.step(state(), s.stream, s.i, first)
                ctrl.append(judge(check.record(spec.leaves(odo_c), spec.leaves(st_c)), want))
    return prog, (ctrl if control else None)


def product_numbers(ctx: Ctx, checks: List[ProductCheck], names: tuple, control: bool = False):
    """Each product check's numbers: (the program's, the control's or
    None), one dict an item.  A number its loop did not declare raises."""
    prog, ctrl = [], []
    for c in checks:
        p, q = c(ctx, control)
        for got in (p, q or {}):
            if not set(got) <= set(names):
                raise ValueError(f"a product check gave {sorted(set(got) - set(names))}, "
                                 f"which its loop does not declare ({names})")
        prog.append(p)
        ctrl.append(q)
    return prog, (ctrl if control else None)


def loop(kind: str):
    return importlib.import_module(f"vio_bench.loops.{kind}")


def loop_numbers(mod) -> tuple:
    """The numbers a loop module declares for its product checks (its
    ``NUMBERS``): each is new, given once, and not a ``.worst``."""
    names = tuple(getattr(mod, "NUMBERS", ()))
    bad = sorted({n for n in names if n in check.NUMBERS or n.endswith(check.WORST)
                  or names.count(n) > 1})
    if bad:
        raise ValueError(f"product numbers {bad} clash with the step numbers, end in "
                         f"{check.WORST!r} or are declared twice")
    return names


def smi() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def run_cell(ctx: Ctx, control: bool = False) -> dict:
    """Drive the cell, check it, and return the result object."""
    mod = loop(ctx.traffic["kind"])
    names = loop_numbers(mod)
    out = mod.run(ctx)
    limits = check.all_limits(ctx.cell.cell)
    # the program's state is freed before the reference runs
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    per_step, ctrl = reference_numbers(ctx, out.samples, control)
    per_product, ctrl_product = product_numbers(ctx, out.products, names, control)
    out.notes["check_s"] = time.perf_counter() - t_check
    tracking = [s.before is not None for s in out.samples]
    numbers = check.summarize_all(per_step, tracking, per_product, names)
    correct = check.verdict(numbers, limits)
    res = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed}
    if ctx.trace:
        tr = out.trace
        res["metrics"] = {}
        for m in ctx.cell.per_layer:
            v = spec.metric_reader(m["name"])(tr)
            if v is not None:
                res["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = dict(out.metrics, setup_s=out.setup_s)
        res["metrics"] = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                          for m in ctx.cell.end_to_end}
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": ctx.cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    if ctx.trace and out.trace.profile is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.profile.window_s
        res["breakdown"] = out.trace.breakdown()
    res["device"] = dev
    res["notes"] = out.notes
    if control:
        res["control"] = check.lines(
            check.summarize_all(ctrl, tracking, ctrl_product, names), limits)
        res["tracking"] = tracking
        res["control_per_step"] = ctrl
        res["per_step"] = per_step
        res["control_per_product"] = ctrl_product
        res["per_product"] = per_product
    res["checks"] = check.lines(numbers, limits)
    return res


def finite(obj):
    """``obj`` with each non-finite float written as a string, so that the
    line stays strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
