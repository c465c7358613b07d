"""Times the step's small solves and its depth stage on the GPU at the EuRoC
parity profile (752x480, 16000 keylines): the translation LM solve
(``tracker.minimize_vel``, kernel K2: every tryVel pass and the update
between them), K2's single pass (``kernels.try_vel``), the SAB solve (``kernels.estimate_bias``, kernel K3), the
7x7 Cholesky inverse (``linalg.chol_inverse``), the tube matcher alone
(``kernels.tube_match``, K4), the depth update's wrapper alone
(``kernels.reg_ekf``, K5 alone, the reference-semantics step's call: one
launch of its own kernel), K5's fused wrapper
(``kernels.match_reg_ekf``: the matcher's tail, the gates, the depth
update) and the whole matcher-and-depth stage as the step runs it
(``matching.match_and_update_depth``: the geometry, K4, then K5), on inputs
taken from the first VIO frame with the SAB filter engaged (seed-0
reference-anchor stream).  For the stage also ``host_after_k4``: the host
time per call from K4's wrapper's return to the stage's return.

    python -m rebvio_tpu_torch.tools.solve_ab [--out FILE]

Prints one JSON line.  Per function: microseconds per call between two CUDA
events over a run of calls (device time plus launch gaps and whatever host
work the device waits for), the host's wall time per call of that run, the
device time per call (all device activities under ``torch.profiler``,
summed), the device activities per call, and the host syncs per call under
``torch.cuda.set_sync_debug_mode``.  Two checkouts that have these entry
points can be timed on the same card one after the other: copy this file
into the other checkout's ``tools/`` and run it there.  Needs a GPU; the
card's name and power limit are in the line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
import warnings

import torch

from rebvio_tpu_torch.configs import CameraConfig, PipelineConfig
from rebvio_tpu_torch.data import synthetic
from rebvio_tpu_torch.geometry import linalg
from rebvio_tpu_torch.ops import kernels, matching, tracker
from rebvio_tpu_torch.runner import VioRunner
from rebvio_tpu_torch.tools.jfa_ab import time_us

CALLS = 200
PROFILED = 20


def device_profile(fn, calls: int = PROFILED):
    """(device microseconds, device activities) per call under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ev = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(ev) / calls, len(ev) / calls


def host_syncs(fn, calls: int = 4) -> float:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(calls):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's own "prototype feature" notice, raised once, is not a sync)
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught) / calls


def _depth_stage(vcfg, stage_call, tube_call) -> dict:
    """The matcher-and-depth stage's timed calls on one frame's inputs."""
    a, kw = stage_call
    core, cam, ecfg = vcfg.core, vcfg.camera, vcfg.edge_map
    new, V = a[0], a[2]
    p = kernels.RegEkfParams(threshold=float(ecfg.regularization_threshold),
                             q_abs2=core.reshape_q_abs ** 2,
                             pu2=float(core.pixel_uncertainty) ** 2, fm=cam.fm)
    reg_args = (new.rho, new.sigma_rho, new.grad.contiguous(), new.grad_norm, new.id_next,
                new.id_prev, new.valid, new.match_id, new.pos_img.contiguous(),
                new.match_pos_img.contiguous(), new.match_grad.contiguous(),
                new.match_grad_norm, V.contiguous(), p)
    o = kernels.tube_match(*tube_call)
    mp = kernels.MatchRegEkfParams(*p, cx=cam.cx, cy=cam.cy,
                                   min_matches=int(core.global_min_matches_threshold))
    margs = (o, new.rho, new.sigma_rho, new.grad.contiguous(), new.grad_norm, new.id_next,
             new.id_prev, new.valid, new.match_id, new.matches, new.match_id_keyframe,
             new.pos_img.contiguous(), new.match_pos_img.contiguous(),
             new.match_grad.contiguous(), new.match_grad_norm, V.contiguous(),
             a[4].T.contiguous(), torch.isnan(V).any(), mp)
    return {"tube_match (K4)": lambda: kernels.tube_match(*tube_call),
            "reg_ekf wrapper (K5 alone)": lambda: kernels.reg_ekf(*reg_args),
            "match_reg_ekf wrapper (K5 fused)": lambda: kernels.match_reg_ekf(*margs),
            STAGE: lambda: matching.match_and_update_depth(*a, **kw)}


STAGE = "matcher + depth stage (geometry, K4, K5 fused)"


def _after_k4_us(stage, calls: int = CALLS) -> float:
    """Host microseconds per call of ``stage`` after kernels.tube_match returns."""
    plain = kernels.tube_match
    marks = []

    def timed(*a):
        out = plain(*a)
        marks.append(time.perf_counter())
        return out

    kernels.tube_match = timed
    try:
        total = 0.0
        for _ in range(calls):
            stage()
            total += time.perf_counter() - marks[-1]
    finally:
        kernels.tube_match = plain
    torch.cuda.synchronize()
    return total / calls * 1e6


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("solve_ab needs a GPU (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)

    vcfg = PipelineConfig()
    engaged = 4 + vcfg.imu.init_bias_frame_num + 2       # first frame with SAB engaged
    seq = synthetic.generate(CameraConfig(), n_frames=engaged, seed=0, distort=True,
                             imu_preroll_s=0.1)
    solves, sab_args, chol_args = [], [], []
    plain = (tracker.minimize_vel, kernels.estimate_bias, linalg.chol_inverse)

    def rec_solve(old, att, vel0, *rest, **kw):
        solves.append((old, att, vel0.clone(), rest, kw))
        return plain[0](old, att, vel0, *rest, **kw)

    def rec_sab(*a):
        sab_args.append(tuple(t.clone() if torch.is_tensor(t) else t for t in a))
        return plain[1](*a)

    def rec_chol(m):
        chol_args.append(m.clone())
        return plain[2](m)

    plain_stage, plain_tube = matching.match_and_update_depth_stages, kernels.tube_match
    stage_args, tube_args = [], []

    def rec_stage(*a, **kw):
        stage_args.append((a, kw))
        return plain_stage(*a, **kw)

    def rec_tube(*a):
        tube_args.append(a)
        return plain_tube(*a)

    tracker.minimize_vel, kernels.estimate_bias, linalg.chol_inverse = rec_solve, rec_sab, rec_chol
    matching.match_and_update_depth_stages, kernels.tube_match = rec_stage, rec_tube
    try:
        runner = VioRunner(vcfg, undistort=True, device="cuda", graph=False)   # eager: recorded
        for i in range(engaged):
            runner.process_frame(seq.images[i], int(seq.ts_us[i]), seq.imu_ts_us, seq.imu_gyro,
                                 seq.imu_acc)
    finally:
        tracker.minimize_vel, kernels.estimate_bias, linalg.chol_inverse = plain
        matching.match_and_update_depth_stages, kernels.tube_match = plain_stage, plain_tube
    old, att, vel0, rest, kw = solves[-1]
    m7 = [m for m in chol_args if m.shape[-1] == 7][-1]
    H, W = old.kl_id_img.shape
    srm = tracker.estimate_quantile(old, vcfg.core.quantile_cutoff, vcfg.core.quantile_num_bins)
    one_pass = (old.pos_img.contiguous(), old.rho, old.sigma_rho, old.grad.contiguous(),
                tracker._use_mask(old, srm), torch.zeros_like(old.rho), vel0, att,
                tracker._try_vel_geom(H, W, vcfg.field_scale, vcfg.core, vcfg.camera))
    fns = {
        "minimize_vel (LM solve, K2)": lambda: tracker.minimize_vel(old, att, vel0, *rest, **kw),
        "try_vel (one pass, K2's wrapper)": lambda: kernels.try_vel(*one_pass),
        "estimate_bias (SAB solve, K3)": lambda: kernels.estimate_bias(*sab_args[-1]),
        "chol_inverse 7x7": lambda: linalg.chol_inverse(m7),
    }
    fns.update(_depth_stage(vcfg, stage_args[-1], tube_args[-1]))
    out = {"card": card.stdout.strip().splitlines()[0] if card.returncode == 0 else "unknown",
           "device": torch.cuda.get_device_name(0), "keylines": int(old.rho.shape[0]),
           "lm_iterations": vcfg.core.iterations, "sab_iterations": vcfg.imu.sab_iterations,
           "calls": CALLS, "us_per_call": {}}
    for name, fn in fns.items():
        ev_us, wall_us = time_us(fn, CALLS)
        dev_us, dev_ops = device_profile(fn)
        out["us_per_call"][name] = {"between_events": ev_us, "host": wall_us, "device": dev_us,
                                    "device_activities": dev_ops, "host_syncs": host_syncs(fn)}
    out["us_per_call"][STAGE]["host_after_k4"] = _after_k4_us(fns[STAGE])
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
