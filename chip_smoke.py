#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU at the EuRoC parity
profile (752x480, 16000 keylines, 8 tube probes): the vision-only VO step
and the VIO step (IMU, gyro-bias fusion, SAB filter, undistortion).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: card name and power limit, torch/CUDA versions, kernel build;
  2. kernels: each CUDA kernel of the two paths (att_flood, try_vel,
     tube_match, reg_ekf, estimate_bias) against its plain PyTorch version
     on the card, on inputs taken from the paths at their shapes (a VO frame
     pair; estimate_bias at the first frame the SAB filter is engaged) plus
     seeded random cases, with its time, the plain version's time and its
     bound;
  3. VO slice: VioRunner(undistort=False) over 24 synthetic frames, with the
     launch counters set to 0 just before and read just after, the
     trajectory held against the committed JAX golden
     (tests/data/torch_golden_vo_euroc_seed0_24.txt);
  4. VIO slice: VioRunner(PipelineConfig(), undistort=True) over the 120
     distorted frames of the seed-0 reference-anchor stream, counters as in
     3, held against the committed JAX golden
     (tests/data/torch_golden_vio_euroc_seed0_120.txt) and the reference
     binary's golden (tests/data/anchor_ref_trajectory_seed0_120.txt).
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
VIO_GOLDEN = REPO / "tests" / "data" / "torch_golden_vio_euroc_seed0_120.txt"
REF_GOLDEN = REPO / "tests" / "data" / "anchor_ref_trajectory_seed0_120.txt"
N_FRAMES = 24
N_VIO = 120
HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
F32_FLOP_PER_S = 67e12      # H100 SXM float32 peak outside the tensor cores
# Bounds against the JAX golden, sized from the spread between the JAX
# package's own two paths on this sequence (Pallas interpret vs XLA, on the
# CPU): sim3 cross-ATE 2.9e-4 m over a 0.109 m trajectory, per-frame
# num_matches within 0.54 %.  Each bound is about twice that spread or more.
ATE_BOUND_M = 0.002         # sim3 cross-ATE, m
MATCH_RTOL = 0.01           # per-frame num_matches, relative
# VIO bounds against the JAX golden, about twice the spread between JAX's own
# two paths on the 120-frame stream (CPU, `python tests/test_torch_vio.py`):
# sim3 cross-ATE 0.0039 m, rigid cross-ATE 0.0119 m, per-frame num_matches
# 1.85 %, final K 0.145, final g_est 0.0028 m/s^2
VIO_BOUNDS = dict(ate_sim3_m=0.008, ate_rigid_m=0.024, match_rtol=0.04, K_abs=0.3,
                  g_est_abs=0.006)
# the reference binary's golden, at tests/test_reference_anchor.py's bounds
REF_ATE_BOUND_M = 0.05      # sim3 cross-ATE
REF_GT_MARGIN_M = 0.05      # ATE vs ground truth no worse than the reference's + this
REPLACES = {
    "att_flood": "rebvio_tpu/ops/pallas_kernels.py:206",
    "try_vel": "rebvio_tpu/ops/pallas_kernels.py:314",
    "tube_match": "rebvio_tpu/ops/pallas_kernels.py:921",
    "reg_ekf": "rebvio_tpu/ops/pallas_kernels.py:422",
    "estimate_bias": "rebvio_tpu/ops/pallas_kernels.py:720",
}
# outputs (index -> planes; None = the whole output) that hold ids and must
# match the plain version exactly
EXACT = {"att_flood": {0: (2,)}, "try_vel": {4: (None,)}, "tube_match": {0: (0, 1)},
         "reg_ekf": {}, "estimate_bias": {}}
SOURCES = {
    "att_flood": "rebvio_tpu_torch/csrc/flood.cu",
    "try_vel": "rebvio_tpu_torch/csrc/try_vel.cu",
    "tube_match": "rebvio_tpu_torch/csrc/tube_match.cu",
    "reg_ekf": "rebvio_tpu_torch/csrc/reg_ekf.cu",
    "estimate_bias": "rebvio_tpu_torch/csrc/sab.cu",
}


# relative tolerance of each kernel against its plain version on the card.
# The elementwise kernels repeat the plain arithmetic op for op (1e-6);
# try_vel's Gram/score sums add up 16000 terms in another order (1e-4);
# estimate_bias (normwise) sums its small products in another order than
# cuBLAS, through a 5-step Gauss-Newton chain whose bias block carries the
# ~1e13 prior information (measured up to 3.3e-6 on the card, engaged VIO
# frame and test_sab.py's trials; 1e-4)
TOL_REL = {"att_flood": 1e-6, "try_vel": 1e-4, "tube_match": 1e-6, "reg_ekf": 1e-6,
           "estimate_bias": 1e-4}


def prefix(sq, n: int):
    """The first ``n`` frames of a synthetic Sequence (with its whole IMU stream)."""
    return type(sq)(images=sq.images[:n], ts_us=sq.ts_us[:n], imu_ts_us=sq.imu_ts_us,
                    imu_gyro=sq.imu_gyro, imu_acc=sq.imu_acc, gt_pos=sq.gt_pos[:n],
                    gt_R_wc=sq.gt_R_wc[:n])


def sab_random_cases(dev, kernels, recorder, originals, captured, iters: int):
    """estimate_bias's inputs from tests/test_sab.py's seeded generator (four
    trials: scale, gravity, prior covariance and rigid-transform information
    drawn from RandomState(0)), through the port's KF predict."""
    import numpy as np
    import torch

    from rebvio_tpu_torch.geometry import so3
    from rebvio_tpu_torch.ops import sab

    rng = np.random.RandomState(0)
    eye = np.eye(3, dtype=np.float32)

    def T(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dev)

    n0 = len(captured["estimate_bias"])
    kernels.estimate_bias = recorder("estimate_bias")
    try:
        for scale in (4.0, 1.5, 7.0, 3.0):
            g = np.asarray([0.3, -9.7, 0.5], np.float32) + rng.randn(3).astype(np.float32) * 0.1
            a_s = rng.randn(3).astype(np.float32)
            X = np.concatenate([[np.arctan(scale * 0.8)], g, rng.randn(3) * 1e-3])
            Pm = rng.randn(7, 7).astype(np.float32) * 3e-2
            Wm = rng.randn(6, 6).astype(np.float32)
            Rot = so3.exp(torch.as_tensor(rng.randn(3) * 0.05, dtype=torch.float32)).to(dev)
            sab.estimate_bias(T(a_s), T((a_s + g) / scale), T(1.0), Rot, T(X),
                              T(Pm @ Pm.T + np.eye(7) * 1e-2), T(eye * 1e-6), T(eye * 1e-8),
                              T(eye * 1e-10), T(1e-4), T(1e2), T(eye * 1e-5), T(eye * 1e-4),
                              T(Wm @ Wm.T + np.eye(6) * 1e3), T(rng.randn(6) * 1e-2), T(9.81),
                              iters=iters)
    finally:
        kernels.estimate_bias = originals["estimate_bias"]
    return [(f"test_sab trial {i}", a) for i, a in enumerate(captured["estimate_bias"][n0:])]


def sab_flops(iters: int) -> int:
    """float32 operations of one estimate_bias call (csrc/sab.cu's loops)."""
    def gj(n):      # per pivot: scale the [2n] row, update n x 2n (mul + sub)
        return n * (2 * n + 2 * n * 2 * n)

    def mm(n, k, m):
        return 2 * n * k * m

    problem = (gj(3) + 4 * mm(3, 3, 3) + 2 * mm(3, 3, 1) + 2 * mm(11, 11, 1)
               + mm(11, 11, 6) + 3 * mm(6, 11, 1) + mm(6, 11, 6) + 120)  # + residual, Rodrigues
    step = problem + gj(7) + mm(7, 7, 1) + 7
    return iters * step + problem + gj(7) + gj(6) + 2 * mm(6, 6, 1) + mm(3, 3, 1)


def read_vio_golden(path):
    """(table [N, 8], final K, final g_est [3]) of the JAX VIO golden."""
    import numpy as np

    final = [ln for ln in path.read_text().splitlines() if ln.startswith("# final K")][0].split()
    return np.loadtxt(path), float(final[3]), np.array([float(v) for v in final[5:8]])


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
    seq = synthetic.generate(CameraConfig(), n_frames=N_FRAMES, seed=0)
    vcfg = PipelineConfig()
    vseq = synthetic.generate(CameraConfig(), n_frames=N_VIO, seed=0, distort=True,
                              imu_preroll_s=0.1)

    # ---------------- phase 2: kernels against their plain versions
    # inputs of each kernel's calls: the VO kernels on a real frame pair
    # (frames 0, 1), estimate_bias on the VIO stream up to the first frame
    # with the SAB filter engaged (num_frames > 4 + init_bias_frame_num)
    captured = {}
    originals = {name: getattr(kernels, name) for name in REPLACES}

    def recorder(name):
        def call(*args):
            captured.setdefault(name, []).append(
                tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return originals[name](*args)
        return call

    def capture(names, run_cfg, sq, n, undistort):
        for name in names:
            setattr(kernels, name, recorder(name))
        try:
            VioRunner(run_cfg, undistort=undistort, device="cuda").run(prefix(sq, n))
        finally:
            for name in names:
                setattr(kernels, name, originals[name])

    vo_names = [n for n in REPLACES if n != "estimate_bias"]
    capture(vo_names, cfg, seq, 2, undistort=False)
    engaged_call = 4 + vcfg.imu.init_bias_frame_num   # call i runs at frame i + 1
    capture(["estimate_bias"], vcfg, vseq, engaged_call + 2, undistort=True)
    missing = set(REPLACES) - set(captured)
    if missing:
        return fail(f"the slices never called {sorted(missing)}")

    rng = np.random.RandomState(0)
    cases = {name: [("frame 1", captured[name][0])] for name in vo_names}
    cases["estimate_bias"] = [(f"VIO frame {engaged_call + 1} (SAB engaged)",
                               captured["estimate_bias"][engaged_call])]

    def on_dev(a):
        return torch.as_tensor(a).to(dev)

    # seeded random cases at the same shapes
    st, sr, rows, cols, scale = captured["att_flood"][0]
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
    a = list(captured["try_vel"][0])
    K = a[1].shape[0]
    a[5] = on_dev(rng.uniform(0, 6, K).astype(np.float32))        # residuals
    a[6] = on_dev(rng.normal(0, 0.02, 3).astype(np.float32))       # vel
    cases["try_vel"].append(("random vel/residuals", tuple(a)))
    a = list(captured["tube_match"][0])
    th = rng.uniform(-0.05, 0.05)
    a[3] = on_dev(np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                           np.float32))
    dyn = a[2].clone()
    dyn[0] = on_dev(rng.uniform(0.05, 3.0, K).astype(np.float32))
    a[2] = dyn
    cases["tube_match"].append(("random rotation/depths", tuple(a)))
    a = list(captured["reg_ekf"][0])
    a[0] = on_dev(rng.uniform(0.05, 3.0, K).astype(np.float32))     # rho
    a[12] = on_dev(rng.normal(0, 0.02, 3).astype(np.float32))      # vel
    cases["reg_ekf"].append(("random depths/vel", tuple(a)))
    cases["estimate_bias"] += sab_random_cases(dev, kernels, recorder, originals, captured,
                                               vcfg.imu.sab_iterations)

    plain = {"att_flood": kernels.att_flood_plain, "try_vel": kernels.try_vel_plain,
             "tube_match": kernels.tube_match_plain, "reg_ekf": kernels.reg_ekf_plain,
             "estimate_bias": kernels.estimate_bias_plain}

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
                        # estimate_bias: normwise (error over the output's
                        # largest entry: P and Xvw hold entries near 0)
                        den = (r[fin].abs().max().clamp(min=1e-30) if name == "estimate_bias"
                               else r[fin].abs().clamp(min=1e-6))
                        worst_rel = max(worst_rel, float((d / den).max()))
        tol = TOL_REL[name]
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
    K = captured["try_vel"][0][1].shape[0]
    b["try_vel"] = bound_ms(K * (8 * 4 + 6 * 4 + 8) + 12 + 68, K * 75)
    P = captured["tube_match"][0][4].P
    b["tube_match"] = bound_ms(K * 13 * 4 + P * K * 10 * 4 + 16 + 12 * K * 4, P * K * 55)
    b["reg_ekf"] = bound_ms(K * (15 * 4 + 1) + K * 2 * 5 * 4 + 12 + 2 * K * 4, K * 80)
    # estimate_bias: its inputs (3+3+7+88+9+9+36+6+1 floats) read once and its
    # outputs (1+7+49+6) written once
    b["estimate_bias"] = bound_ms((162 + 63) * 4, sab_flops(vcfg.imu.sab_iterations))
    for name in REPLACES:
        report[name]["bound_ms"], report[name]["bound_by"] = b[name]
        print(json.dumps({"kernel": name, **report[name]}), flush=True)

    # ---------------- phase 3: the slice, 24 frames on the card
    runner = VioRunner(cfg, undistort=False, device="cuda")
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
            "tube_match": est, "reg_ekf": est, "estimate_bias": 0}
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

    # ---------------- phase 4: the VIO slice, 120 frames on the card
    runner = VioRunner(vcfg, undistort=True, device="cuda")
    runner.process_frame(vseq.images[0], int(vseq.ts_us[0]), vseq.imu_ts_us[:0],
                         vseq.imu_gyro[:0], vseq.imu_acc[:0])      # warm-up frame
    runner.reset()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = runner.run(vseq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vlaunches = dict(kernels.LAUNCHES)
    K_fin = float(runner.state.K)
    g_fin = runner.state.sab_state.g_est.cpu().numpy()

    if res.position.shape != (N_VIO, 3) or not np.isfinite(res.position).all():
        return fail("VIO trajectory is not finite or has the wrong shape")
    if not res.run_ok.all():
        return fail(f"VIO run_ok dropped at frame {int(np.argmin(res.run_ok))}")
    est = N_VIO - 1
    want = {"att_flood": N_VIO, "try_vel": est * (1 + vcfg.core.iterations),
            "tube_match": est, "reg_ekf": est, "estimate_bias": est}
    if vlaunches != want:
        return fail(f"VIO launch counts {vlaunches}, expected {want}")
    g, gK, gg = read_vio_golden(VIO_GOLDEN)
    rel = np.abs(res.num_matches[1:] - g[1:, 7]) / g[1:, 7]
    ref = np.loadtxt(REF_GOLDEN)[: N_VIO - 1, 4:7]   # the reference emits frames 1..N-1
    gt = vseq.gt_pos[1:N_VIO]
    vio = {"slice": "vio parity 752x480 K=16000 P=8 imu sab_iterations=5 undistort",
           "frames": N_VIO, "ms_per_frame": wall / N_VIO * 1e3, "card": card,
           "cross_ate_sim3_m": ev.ate_rmse(res.position, g[:, 4:7]),
           "cross_ate_rigid_m": ev.ate_rmse(res.position, g[:, 4:7], with_scale=False),
           "max_match_rel_diff": float(rel.max()), "K": K_fin, "K_golden": gK,
           "g_est": g_fin.tolist(), "g_est_golden": gg.tolist(),
           "ref_cross_ate_sim3_m": ev.ate_rmse(res.position[1:N_VIO], ref),
           "ate_gt_m": ev.ate_rmse(res.position[1:N_VIO], gt),
           "ref_ate_gt_m": ev.ate_rmse(ref, gt), "bounds": VIO_BOUNDS,
           "num_matches": res.num_matches.tolist(), "launches": vlaunches}
    print(json.dumps(vio), flush=True)
    checks = [
        (vio["cross_ate_sim3_m"] < VIO_BOUNDS["ate_sim3_m"], "sim3 cross-ATE vs the JAX golden"),
        (vio["cross_ate_rigid_m"] < VIO_BOUNDS["ate_rigid_m"],
         "rigid cross-ATE vs the JAX golden"),
        (rel.max() <= VIO_BOUNDS["match_rtol"] and res.num_matches[0] == 0,
         "num_matches vs the JAX golden"),
        (abs(K_fin - gK) <= VIO_BOUNDS["K_abs"], "final K vs the JAX golden"),
        (np.abs(g_fin - gg).max() <= VIO_BOUNDS["g_est_abs"], "final g_est vs the JAX golden"),
        (vio["ref_cross_ate_sim3_m"] < REF_ATE_BOUND_M,
         "sim3 cross-ATE vs the reference binary's golden"),
        (vio["ate_gt_m"] < vio["ref_ate_gt_m"] + REF_GT_MARGIN_M,
         "ATE vs ground truth against the reference binary's"),
    ]
    for ok, what in checks:
        if not ok:
            return fail(f"VIO slice: {what} out of bounds")

    out = []
    for name in REPLACES:
        r = report[name]
        out.append(dict(name=name, route="cuda", source=SOURCES[name],
                        replaces=REPLACES[name], launches=vlaunches[name],
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
