#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: the vision-only VO step at
the EuRoC parity profile (752x480, 16000 keylines, 8 tube probes).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: card name and power limit, torch/CUDA versions, kernel build;
  2. kernels: each CUDA kernel of the path (att_flood, try_vel, tube_match,
     reg_ekf) against its plain PyTorch version on the card, on inputs taken
     from a real frame pair at the path's shapes plus seeded random cases,
     with its time, the plain version's time and its bound;
  3. slice: VioRunner over 24 synthetic frames, with the launch counters set
     to 0 just before and read just after, the trajectory held against the
     committed JAX golden (tests/data/torch_golden_vo_euroc_seed0_24.txt).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "data" / "torch_golden_vo_euroc_seed0_24.txt"
N_FRAMES = 24
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
F32_FLOP_PER_S = 67e12      # H100 SXM float32 peak outside the tensor cores
# Bounds against the JAX golden, sized from the spread between the JAX
# package's own two paths on this sequence (Pallas interpret vs XLA, on the
# CPU): sim3 cross-ATE 2.9e-4 m over a 0.109 m trajectory, per-frame
# num_matches within 0.54 %.  Each bound is about twice that spread or more.
ATE_BOUND_M = 0.002         # sim3 cross-ATE, m
MATCH_RTOL = 0.01           # per-frame num_matches, relative
REPLACES = {
    "att_flood": "rebvio_tpu/ops/pallas_kernels.py:206",
    "try_vel": "rebvio_tpu/ops/pallas_kernels.py:314",
    "tube_match": "rebvio_tpu/ops/pallas_kernels.py:921",
    "reg_ekf": "rebvio_tpu/ops/pallas_kernels.py:422",
}
# outputs (index -> planes; None = the whole output) that hold ids and must
# match the plain version exactly
EXACT = {"att_flood": {0: (2,)}, "try_vel": {4: (None,)}, "tube_match": {0: (0, 1)},
         "reg_ekf": {}}
SOURCES = {
    "att_flood": "rebvio_tpu_torch/csrc/flood.cu",
    "try_vel": "rebvio_tpu_torch/csrc/try_vel.cu",
    "tube_match": "rebvio_tpu_torch/csrc/tube_match.cu",
    "reg_ekf": "rebvio_tpu_torch/csrc/reg_ekf.cu",
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def median_ms(torch, fn, reps: int = 25, warm: int = 3) -> float:
    """Median over ``reps`` single calls, each between two CUDA events
    (includes the wrapper's host overhead, which dominates at these sizes)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    if not (REPO / "rebvio_tpu_torch" / "__init__.py").exists():
        return fail(f"rebvio_tpu_torch/ not found beside {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke test needs a GPU")

    from rebvio_tpu_torch import eval as ev
    from rebvio_tpu_torch.configs import CameraConfig, PipelineConfig
    from rebvio_tpu_torch.data import synthetic
    from rebvio_tpu_torch.ops import _build, kernels
    from rebvio_tpu_torch.runner import VioRunner

    dev = torch.device("cuda")
    # ---------------- phase 1: device and build
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    _build.load()
    print(f"kernel build: {_build.BUILD_INFO['seconds']:.2f} s -> {_build.BUILD_INFO['path']}")
    for line in _build.BUILD_INFO["ptxas"].splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    cfg = PipelineConfig(use_imu=False)
    cam = cfg.camera
    seq = synthetic.generate(CameraConfig(), n_frames=N_FRAMES, seed=0)

    # ---------------- phase 2: kernels against their plain versions
    # inputs of each kernel's first call on a real frame pair (frames 0, 1)
    captured = {}
    originals = {name: getattr(kernels, name) for name in REPLACES}

    def recorder(name):
        def call(*args):
            captured.setdefault(name, tuple(a.clone() if torch.is_tensor(a) else a
                                            for a in args))
            return originals[name](*args)
        return call

    for name in REPLACES:
        setattr(kernels, name, recorder(name))
    try:
        VioRunner(cfg, device="cuda").run(
            synthetic.Sequence(images=seq.images[:2], ts_us=seq.ts_us[:2],
                               imu_ts_us=seq.imu_ts_us, imu_gyro=seq.imu_gyro,
                               imu_acc=seq.imu_acc, gt_pos=seq.gt_pos[:2],
                               gt_R_wc=seq.gt_R_wc[:2]))
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    missing = set(REPLACES) - set(captured)
    if missing:
        return fail(f"the slice never called {sorted(missing)}")

    rng = np.random.RandomState(0)
    cases = {name: [("frame 1", captured[name])] for name in REPLACES}

    def on_dev(a):
        return torch.as_tensor(a).to(dev)

    # seeded random cases at the same shapes
    st, sr, rows, cols, scale = captured["att_flood"]
    pad = st.shape[0] // 5 - rows
    rs = np.zeros((5, rows + pad, cols), np.float32)
    rs[0] = rs[1] = 1e9
    rs[2] = -1.0
    ys, xs = np.nonzero(rng.rand(rows, cols) < 0.05)
    rs[0, ys, xs] = ys + rng.uniform(-0.5, 0.5, len(ys))
    rs[1, ys, xs] = xs + rng.uniform(-0.5, 0.5, len(xs))
    rs[2, ys, xs] = rng.permutation(len(ys))
    rs[3, ys, xs] = rng.normal(0, 100, len(ys))
    rs[4, ys, xs] = rng.normal(0, 100, len(ys))
    cases["att_flood"].append(("random seeds", (on_dev(rs.reshape(st.shape)), sr, rows, cols,
                                                scale)))
    a = list(captured["try_vel"])
    K = a[1].shape[0]
    a[5] = on_dev(rng.uniform(0, 6, K).astype(np.float32))        # residuals
    a[6] = on_dev(rng.normal(0, 0.02, 3).astype(np.float32))       # vel
    cases["try_vel"].append(("random vel/residuals", tuple(a)))
    a = list(captured["tube_match"])
    th = rng.uniform(-0.05, 0.05)
    a[3] = on_dev(np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                           np.float32))
    dyn = a[2].clone()
    dyn[0] = on_dev(rng.uniform(0.05, 3.0, K).astype(np.float32))
    a[2] = dyn
    cases["tube_match"].append(("random rotation/depths", tuple(a)))
    a = list(captured["reg_ekf"])
    a[0] = on_dev(rng.uniform(0.05, 3.0, K).astype(np.float32))     # rho
    a[12] = on_dev(rng.normal(0, 0.02, 3).astype(np.float32))      # vel
    cases["reg_ekf"].append(("random depths/vel", tuple(a)))

    plain = {"att_flood": kernels.att_flood_plain, "try_vel": kernels.try_vel_plain,
             "tube_match": kernels.tube_match_plain, "reg_ekf": kernels.reg_ekf_plain}

    def as_list(out):
        return list(out) if isinstance(out, (tuple, list)) else [out]

    report = {}
    for name in REPLACES:
        worst_abs, worst_rel, exact = 0.0, 0.0, {}
        for label, args in cases[name]:
            got = as_list(getattr(kernels, name)(*args))
            ref = as_list(plain[name](*args))
            torch.cuda.synchronize()
            for i, (g, r) in enumerate(zip(got, ref)):
                for plane in EXACT[name].get(i, ()):
                    gp, rp = (g, r) if plane is None else (g[plane], r[plane])
                    key = f"{label}: out{i}" + ("" if plane is None else f"[{plane}]")
                    exact[key] = [int((gp == rp).sum()), int(gp.numel())]
                    if not torch.equal(gp, rp):
                        return fail(f"{name}: {key} differs in {int((gp != rp).sum())} "
                                    f"of {gp.numel()} entries")
                if g.dtype == torch.float32:
                    fin = torch.isfinite(r)
                    if not torch.equal(fin, torch.isfinite(g)):
                        return fail(f"{name}: finite masks differ ({label}, out{i})")
                    d = (g[fin] - r[fin]).abs()
                    if d.numel():
                        worst_abs = max(worst_abs, float(d.max()))
                        worst_rel = max(worst_rel, float((d / r[fin].abs().clamp(min=1e-6)).max()))
        # elementwise outputs repeat the plain arithmetic op for op; only
        # try_vel's Gram/score sums add up 16000 terms in another order
        tol = 1e-4 if name == "try_vel" else 1e-6
        if worst_rel > tol:
            return fail(f"{name}: max relative error {worst_rel:.3g} above {tol}")
        args = cases[name][0][1]
        kern_ms = median_ms(torch, lambda: getattr(kernels, name)(*args))
        plain_ms = median_ms(torch, lambda: plain[name](*args))
        report[name] = dict(max_abs_err=worst_abs, max_rel_err=worst_rel, tol_rel=tol,
                            exact=exact, ms=kern_ms, plain_ms=plain_ms)

    # bound: least bytes (each input read once, each output written once;
    # gathered field/neighbour values counted per access) and float32 ops
    st, sr, rows, cols, _ = cases["att_flood"][0][1]
    n = rows * cols
    steps = 0
    s = 1
    while 2 * s < sr:
        s *= 2
    while s >= 1:
        steps, s = steps + 1, s // 2
    steps += 1
    b = {"att_flood": bound_ms(st.numel() * 4 + 8 * n * 4, steps * 8 * 7 * n + 4 * n)}
    K = captured["try_vel"][1].shape[0]
    b["try_vel"] = bound_ms(K * (8 * 4 + 6 * 4 + 8) + 12 + 68, K * 75)
    P = captured["tube_match"][4].P
    b["tube_match"] = bound_ms(K * 13 * 4 + P * K * 10 * 4 + 16 + 12 * K * 4, P * K * 55)
    b["reg_ekf"] = bound_ms(K * (15 * 4 + 1) + K * 2 * 5 * 4 + 12 + 2 * K * 4, K * 80)
    for name in REPLACES:
        report[name]["bound_ms"], report[name]["bound_by"] = b[name]
        print(json.dumps({"kernel": name, **report[name]}), flush=True)

    # ---------------- phase 3: the slice, 24 frames on the card
    runner = VioRunner(cfg, device="cuda")
    runner.process_frame(seq.images[0], int(seq.ts_us[0]), seq.imu_ts_us[:0],
                         seq.imu_gyro[:0], seq.imu_acc[:0])       # warm-up frame
    runner.reset()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = runner.run(seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ms_per_frame = wall / N_FRAMES * 1e3

    if res.position.shape != (N_FRAMES, 3) or not np.isfinite(res.position).all():
        return fail("trajectory is not finite or has the wrong shape")
    if not res.run_ok.all():
        return fail(f"run_ok dropped at frame {int(np.argmin(res.run_ok))}")
    est = N_FRAMES - 1
    want = {"att_flood": N_FRAMES, "try_vel": est * (1 + cfg.core.iterations),
            "tube_match": est, "reg_ekf": est}
    if launches != want:
        return fail(f"launch counts {launches}, expected {want}")
    g = np.loadtxt(GOLDEN)
    ate = ev.ate_rmse(res.position, g[:, 4:7])
    rel = np.abs(res.num_matches[1:] - g[1:, 7]) / g[1:, 7]
    print(json.dumps({"slice": "vo parity 752x480 K=16000 P=8", "frames": N_FRAMES,
                      "ms_per_frame": ms_per_frame, "card": card,
                      "cross_ate_sim3_m": ate, "ate_bound_m": ATE_BOUND_M,
                      "max_match_rel_diff": float(rel.max()), "match_rtol": MATCH_RTOL,
                      "num_matches": res.num_matches.tolist(), "launches": launches}),
          flush=True)
    if not ate < ATE_BOUND_M:
        return fail(f"cross-ATE {ate:.4g} m against the JAX golden above {ATE_BOUND_M}")
    if not rel.max() <= MATCH_RTOL or res.num_matches[0] != 0:
        return fail(f"num_matches off the JAX golden by {rel.max():.3%}")

    out = []
    for name in REPLACES:
        r = report[name]
        out.append(dict(name=name, route="cuda", source=SOURCES[name],
                        replaces=REPLACES[name], launches=launches[name],
                        max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                        bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None))
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
