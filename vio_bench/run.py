"""Run one cell of the benchmark once.

    python -m vio_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Measures ``rebvio_tpu_torch`` (the PyTorch/CUDA port) on one NVIDIA GPU,
driving it as its users do (``traffic/<mix>.json`` names its loop,
``loops/<kind>.py``), then holds sampled steps of what the timed path
produced to the plain reference (``check.py``, ``reference/``).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared, with its limit.
The numbers compared are also the last lines of standard error.  Without a
CUDA device, or with fewer than the cell asks for, it exits with code 3
and prints no result."""

import time

T_START = time.perf_counter()   # set-up is timed from here

import argparse       # noqa: E402
import json           # noqa: E402
import sys            # noqa: E402

import torch          # noqa: E402

from vio_bench import harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vio_bench: cell {cell.name} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    ctx = harness.Ctx(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    res = harness.run_cell(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"vio_bench: the run loaded {bad}", file=sys.stderr)
        return 4
    print(f"vio_bench: card {harness.smi()}", file=sys.stderr)
    print(json.dumps(harness.finite({"notes": res.pop("notes")})))
    for k, (v, lim) in res["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(harness.finite(res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
