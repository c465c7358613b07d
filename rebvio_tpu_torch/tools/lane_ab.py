"""How far a lane of the batched step lies from the step it vmaps, one frame
at a time (parallel/batch.py).

    python -m rebvio_tpu_torch.tools.lane_ab [--matcher walk] [--frames 120] [--batch 8]

B lanes of the same stream (the distorted seed-0 reference-anchor stream,
undistorted on the device, the EuRoC parity profile) step in lockstep,
eagerly; at every frame the unbatched ``pipeline.step`` runs from lane 0's
state before the batched step, on the same inputs, and the two results are
compared: the detected keylines whose positions differ, the keylines whose
match ids differ, the largest relative gap of the depths, the gaps of the
position and of the scale K; and the matcher's inputs in the two (lane 0's
taken from inside the vmap): the velocity, its covariance, the rotation
and the two maps' planes.  With ``--matcher walk`` each frame also runs
the pixel walk under vmap on B copies of the unbatched step's own matcher
inputs and counts the match ids that differ from the unbatched walk's on
them.  A gap that starts anew at each frame is the batched step's own
(its products sum in another order); what the free runs add on top of it
is the trajectory's sensitivity.  Prints one JSON line: the per-frame
gaps, their summary and the card's name and power limit.  Needs a GPU
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.camera import Undistorter
from rebvio_tpu_torch.configs import CameraConfig, PipelineConfig, default_df_mode
from rebvio_tpu_torch.data import synthetic
from rebvio_tpu_torch.ops import matching
from rebvio_tpu_torch.ops.imu import pack_imu_window
from rebvio_tpu_torch.parallel import batch as TB
from rebvio_tpu_torch.pipeline import frontend_matrices, step

_MATCHER = {"walk": "directed_match", "tube": "match_and_update_depth_stages"}
_MAP_PLANES = ("pos_img", "grad", "rho", "sigma_rho", "valid", "kl_id_img")


def _lane0(x):
    """A tensor, or lane 0 of a tensor batched by torch.func.vmap, as a plain
    copy."""
    f = torch._C._functorch
    if f.is_batchedtensor(x):
        return f.get_unwrapped(x).movedim(f.maybe_get_bdim(x), 0)[0].clone()
    return x.clone()


def _recording(calls: list, fn):
    """``fn`` that records lane 0 of its (new, old, vel, Rvel, Rback) first."""
    def call(new, old, vel, Rvel, Rback, *a, **kw):
        calls.append(([T.tree_map(_lane0, new), T.tree_map(_lane0, old)]
                      + [_lane0(x) for x in (vel, Rvel, Rback)], a, kw))
        return fn(new, old, vel, Rvel, Rback, *a, **kw)
    return call


def _input_gaps(b, u) -> dict:
    (nb, ob, *xb), (nu, ou, *xu) = b, u
    gaps = {k: float((x - y).abs().max()) for k, x, y in zip(("vel", "Rvel", "Rback"), xb, xu)}
    for side, mb, mu in (("new", nb, nu), ("old", ob, ou)):
        for k in _MAP_PLANES:
            x, y = getattr(mb, k), getattr(mu, k)
            gaps[f"{side}.{k}"] = (float((x - y).abs().max()) if x.is_floating_point()
                                   else int((x != y).sum()))
    return gaps


def _gaps(em_b: T.EdgeMap, em_u: T.EdgeMap, st_b: T.VioState, st_u: T.VioState) -> dict:
    valid = em_b.valid & em_u.valid
    rho_rel = ((em_b.rho - em_u.rho).abs() / em_u.rho.abs().clamp(min=1e-6))[valid]
    return {"keylines": int(em_u.valid.sum()),
            "valid_differs": int((em_b.valid != em_u.valid).sum()),
            "pos_differs": int((em_b.pos != em_u.pos).any(-1).sum()),
            "match_id_differs": int((em_b.match_id != em_u.match_id).sum()),
            "rho_max_rel": float(rho_rel.max()) if rho_rel.numel() else 0.0,
            "position_gap_m": float((st_b.Pos - st_u.Pos).norm()),
            "K_gap": float((st_b.K - st_u.K).abs())}


def _walk_vmap_gap(ins, a, B: int) -> int:
    """Match ids that differ between the pixel walk under vmap on B copies
    of one step's matcher inputs and the walk on them unbatched."""
    new, old, *xs = ins
    want, _ = matching.directed_match(new, old, *xs, *a)

    def one(nl, ol, vel, Rvel, Rback):
        em, _ = matching.directed_match(TB._unflatten(new, nl), TB._unflatten(old, ol), vel,
                                        Rvel, Rback, *a)
        return em.match_id

    lanes = [T.tree_leaves(T.tree_map(lambda x: x.expand(B, *x.shape).clone(), m))
             for m in (new, old)]
    got = torch.func.vmap(one)(*lanes, *(x.expand(B, *x.shape).clone() for x in xs))
    return int((got != want.match_id).sum())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matcher", choices=["tube", "walk"], default="tube")
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cpu: the plain versions")
    args = ap.parse_args(argv)
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lane_ab needs a GPU (torch.cuda.is_available() is False)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True) \
        if dev == "cuda" else None
    cfg = PipelineConfig(matcher=args.matcher, df_mode=default_df_mode(args.matcher))
    B, n = args.batch, args.frames
    seq = synthetic.generate(CameraConfig(), n_frames=n, seed=0, distort=True,
                             imu_preroll_s=0.1)
    und = Undistorter(cfg.camera, cfg.image_gain, dev)
    mats = frontend_matrices(cfg, dev)
    st_b = TB.init_batched_state(cfg, B, device=dev)
    rows, cursor = [], 0
    for i in range(n):
        hi = int(np.searchsorted(seq.imu_ts_us, seq.ts_us[i], side="right"))
        win = pack_imu_window(seq.imu_gyro[cursor:hi], seq.imu_acc[cursor:hi],
                              seq.imu_ts_us[cursor:hi], cfg.imu.sample_max, device=dev)
        cursor = hi
        frame = und(torch.as_tensor(np.asarray(seq.images[i])).to(dev))
        dt = 0.0 if i == 0 else (seq.ts_us[i] - seq.ts_us[i - 1]) / 1e6
        lane0 = T.tree_map(lambda x: x[0].clone(), st_b)
        name = _MATCHER[args.matcher]
        fn, calls = getattr(matching, name), []
        setattr(matching, name, _recording(calls, fn))
        try:
            st_b, _ = TB.batched_step(st_b, frame.expand(B, *frame.shape),
                                      T.tree_map(lambda x: x.expand(B, *x.shape), win),
                                      torch.full((B,), dt, dtype=torch.float32, device=dev),
                                      cfg, mats)
            st_u, _ = step(lane0, frame, win, dt, cfg, mats)
        finally:
            setattr(matching, name, fn)
        b0 = T.tree_map(lambda x: x[0], st_b)
        row = _gaps(b0.edge_map, st_u.edge_map, b0, st_u)
        (ins_b, _, _), (ins_u, a, kw) = calls
        row["matcher_inputs"] = _input_gaps(ins_b, ins_u)
        if args.matcher == "walk":
            row["walk_vmap_differs"] = _walk_vmap_gap(ins_u, a, B)
        rows.append(row)
    keys = ("pos_differs", "match_id_differs", "valid_differs")
    out = {"tool": "lane_ab", "card": card.stdout.strip() if card else dev,
           "matcher": args.matcher,
           "df_mode": cfg.df_mode, "batch": B, "frames": n,
           "summary": {**{f"frames_{k}": sum(r[k] > 0 for r in rows) for k in keys},
                       **{f"mean_{k}": float(np.mean([r[k] for r in rows])) for k in keys},
                       "max_rho_rel": max(r["rho_max_rel"] for r in rows),
                       "max_position_gap_m": max(r["position_gap_m"] for r in rows),
                       "max_K_gap": max(r["K_gap"] for r in rows)},
           "per_frame": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
