"""The VIO step's two keyline-sized scatter-max calls on the GPU, in two
forms: every keyline that targets nothing sent to one shared dump slot, and
each such keyline given a slot of its own past the K targets.

    python -m rebvio_tpu_torch.tools.scatter_ab

The calls are ``edge_detect._join_edges``' id_prev (which index links to a
keyline) and ``forward_match``'s winner (which old keyline's depth a new
keyline takes).  Their inputs are recorded on the first VIO frame with the
SAB filter engaged (frame 16 of the seed-0 synthetic sequence, distorted,
undistorted on the device).  Both forms are checked to agree on the K
targets, then timed: the device time of the scatter kernels per call under
``torch.profiler``.  Prints one JSON line: per call, the elements, the
keylines that target nothing, and the microseconds of each form.  The card's
name and power limit are printed first.  Needs a GPU.
"""

from __future__ import annotations

import json
import subprocess

import torch

from rebvio_tpu_torch.configs import CameraConfig, PipelineConfig
from rebvio_tpu_torch.data import synthetic
from rebvio_tpu_torch.ops import edge_detect, matching
from rebvio_tpu_torch.runner import VioRunner

CALLS = 20


def scatter_us(fn, calls: int = CALLS) -> float:
    """Device microseconds per call of the scatter kernels that ``fn`` launches."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "scatter" in e.name.lower()) / calls


def record_inputs():
    """(_join_edges' args, forward_match's args) of the first VIO frame with
    the SAB filter engaged."""
    cfg = PipelineConfig()
    engaged = 4 + cfg.imu.init_bias_frame_num + 2
    seq = synthetic.generate(CameraConfig(), n_frames=engaged + 1, seed=0, distort=True,
                             imu_preroll_s=0.1)
    runner = VioRunner(cfg, undistort=True, device="cuda", graph=False)   # eager: recorded
    joins, fwds = [], []
    plain_join, plain_fwd = edge_detect._join_edges, matching.forward_match

    def rec_join(*a):
        joins.append(a)
        return plain_join(*a)

    def rec_fwd(*a):
        fwds.append(a)
        return plain_fwd(*a)

    edge_detect._join_edges, matching.forward_match = rec_join, rec_fwd
    try:
        for i in range(engaged + 1):
            runner.process_frame(seq.images[i], int(seq.ts_us[i]), seq.imu_ts_us,
                                 seq.imu_gyro, seq.imu_acc)
    finally:
        edge_detect._join_edges, matching.forward_match = plain_join, plain_fwd
    return joins[-1], fwds[-1]


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("scatter_ab needs a GPU (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip().splitlines()[0] if card.returncode == 0 else "unknown")
    (pos, grad, valid, kl_id_img), (old, _new) = record_inputs()
    kmax = pos.shape[0]
    dev = pos.device
    i32 = torch.int32
    ar = torch.arange(kmax, device=dev)
    id_next, _ = edge_detect._join_edges(pos, grad, valid, kl_id_img)
    linked = valid & (id_next >= 0)
    cand = old.valid & (old.match_id_forward >= 0)
    order = torch.argsort(torch.where(cand, old.rho, -matching._F32_MAX), stable=True)
    rank_of = torch.empty_like(order)
    rank_of[order] = ar
    key = torch.where(cand, rank_of + 1, 0)
    sites = {
        "ops/edge_detect.py _join_edges (id_prev)": (
            linked,
            lambda: torch.full((kmax + 1,), -1, dtype=i32, device=dev).scatter_reduce(
                0, torch.where(linked, id_next, kmax).to(torch.int64), ar.to(i32),
                reduce="amax"),
            lambda: torch.full((2 * kmax,), -1, dtype=i32, device=dev).scatter_reduce(
                0, torch.where(linked, id_next.to(torch.int64), kmax + ar), ar.to(i32),
                reduce="amax")),
        "ops/matching.py forward_match (winner)": (
            cand,
            lambda: torch.zeros((kmax + 1,), dtype=torch.int64, device=dev).scatter_reduce(
                0, torch.where(cand, old.match_id_forward, kmax).to(torch.int64), key,
                reduce="amax"),
            lambda: torch.zeros((2 * kmax,), dtype=torch.int64, device=dev).scatter_reduce(
                0, torch.where(cand, old.match_id_forward.to(torch.int64), kmax + ar), key,
                reduce="amax")),
    }
    out = {}
    for site, (hit, one_slot, own_slots) in sites.items():
        if not torch.equal(one_slot()[:kmax], own_slots()[:kmax]):
            raise RuntimeError(f"{site}: the two forms disagree")
        out[site] = {"elements": kmax, "target_nothing": int((~hit).sum()),
                     "one_slot_us": scatter_us(one_slot), "own_slots_us": scatter_us(own_slots)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
