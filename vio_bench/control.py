"""Readings for the limits of ``cells/<cell>.json``: for each seed, a run of
the cell (a window of ``--seconds``, the cell's own load and sample) and,
for every sampled step and every item a product check returns, both the
program and the control held to the reference.  The control is the
reference itself computed one precision below the configuration's
(``reference.oracle.tf32``: TF32 products where the configuration states
float32 with TF32 off), put in the program's place.  One JSON line a
seed; the benchmark's own runs never run this.  Each seed's runner leaves
its CUDA graphs' memory pool in the process, so give a process a few dozen
seeds: some 85 fleet seeds fill the card.

    python -m vio_bench.control --workload <cell> --seeds 1,2,3 --seconds 3
"""

import time

T_START = time.perf_counter()

import argparse       # noqa: E402
import json           # noqa: E402
import sys            # noqa: E402

from vio_bench import harness, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.resolve(args.workload)
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(cell, seed, args.seconds, False, args.device, t)
        res = harness.run_cell(ctx, control=True)
        print(json.dumps(harness.finite({"seed": seed, "correct": res["correct"],
                                         "program": res["checks"], "control": res["control"],
                                         "metrics": res["metrics"], "notes": res["notes"],
                                         "per_step": res["per_step"],
                                         "control_per_step": res["control_per_step"],
                                         "tracking": res["tracking"],
                                         "per_product": res["per_product"],
                                         "control_per_product": res["control_per_product"]})),
              flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
