"""Shared helpers of the port's CPU tests: the same inputs through the JAX
package and through rebvio_tpu_torch (device="cpu", plain versions).

Imported in a pytest-xdist worker, this module also gives the worker its
share of the CPUs for PyTorch's OpenMP (intra-op), MKL and inter-op pools.
Left at their default, every worker spins up one thread per CPU for each
parallel op, and the port's many small CPU ops then wait on each other's
threads. XLA's own CPU thread pool is left as it is: narrowing it made the
suite slower."""

from __future__ import annotations

import dataclasses
import os

import jax
import numpy as np
import torch

import rebvio_tpu.configs as jcfg
import rebvio_tpu_torch.configs as tcfg
from rebvio_tpu_torch import interop


def thread_budget(cpu_max: str = "/sys/fs/cgroup/cpu.max") -> int:
    """CPU threads for one test process: the CPUs this process may use (the
    affinity mask, lowered to the cgroup v2 quota in ``cpu_max``, which is
    only read) split evenly over the xdist workers, at least one."""
    n_cpus = len(os.sched_getaffinity(0))
    try:
        with open(cpu_max) as f:
            quota, period = f.read().split()
    except OSError:
        quota = "max"
    if quota != "max":
        n_cpus = min(n_cpus, max(1, int(quota) // int(period)))
    return max(1, n_cpus // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


# Every xdist worker collects every test file, so this runs before its first
# test (the controller runs no test and never imports this module). The
# variables are assigned outright, not kept from the controller's
# environment, and subprocesses that tests start inherit them.
THREAD_BUDGET = thread_budget() if os.environ.get("PYTEST_XDIST_WORKER") else None
if THREAD_BUDGET is not None:
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(THREAD_BUDGET)
    torch.set_num_threads(THREAD_BUDGET)
    torch.set_num_interop_threads(THREAD_BUDGET)

PALLAS_FLAGS = ("JFA", "TRYVEL", "TUBE", "REGEKF")

# run.py's `small` preset: 120x188 frames, 2048 = 16x128 keylines, search range 10
SMALL_CAMERA = dict(rows=120, cols=188, fx=114.6, fy=114.3, cx=91.8, cy=62.1,
                    k1=0, k2=0, k3=0, p1=0, p2=0)
SMALL_DETECTOR = dict(keylines_max=2048, keylines_ref=1200)
SMALL_CORE = dict(search_range=10, global_min_matches_threshold=100)


# EuRoC's rad-tan coefficients (normalized coordinates, so any resolution)
EUROC_DISTORTION = dict(k1=-0.28340811, k2=0.07395907, k3=0.0, p1=0.00019359,
                        p2=1.76187114e-05)


def small_config(mod, **kw):
    """The small vision-only PipelineConfig from configs module ``mod``
    (rebvio_tpu.configs or rebvio_tpu_torch.configs)."""
    return mod.PipelineConfig(camera=mod.CameraConfig(**SMALL_CAMERA),
                              detector=mod.EdgeDetectorConfig(**SMALL_DETECTOR),
                              core=mod.CoreConfig(**SMALL_CORE), use_imu=False, **kw)


def small_configs(**kw):
    return small_config(jcfg, **kw), small_config(tcfg, **kw)


def small_vio_config(mod):
    """The small preset with the IMU and SAB filter on, a camera with EuRoC's
    distortion, and a 2-frame bias-init window: SAB is engaged once
    num_frames > 4 + 2, from frame 8 (the 8th estimate) on."""
    return mod.PipelineConfig(camera=mod.CameraConfig(**{**SMALL_CAMERA, **EUROC_DISTORTION}),
                              detector=mod.EdgeDetectorConfig(**SMALL_DETECTOR),
                              core=mod.CoreConfig(**SMALL_CORE),
                              imu=mod.ImuConfig(init_bias_frame_num=2), use_imu=True)


def small_vio_configs():
    return small_vio_config(jcfg), small_vio_config(tcfg)


def variant_configs(vio: bool, df_mode: str, matcher: str):
    """(JAX, port) small configs, VO (small_config) or VIO
    (small_vio_config), with the field and matcher variant."""
    return tuple(dataclasses.replace(small_vio_config(m) if vio else small_config(m),
                                     df_mode=df_mode, matcher=matcher) for m in (jcfg, tcfg))


def jax_windows(seq, n: int, sample_max: int):
    """The JAX package's packed IMU windows of a sequence's first ``n``
    frames (the runner's drain rule: samples with ts <= frame ts)."""
    from rebvio_tpu.ops import imu as jimu

    wins, cursor = [], 0
    for i in range(n):
        j = cursor
        while j < len(seq.imu_ts_us) and seq.imu_ts_us[j] <= seq.ts_us[i]:
            j += 1
        wins.append(jimu.pack_imu_window(seq.imu_gyro[cursor:j], seq.imu_acc[cursor:j],
                                         seq.imu_ts_us[cursor:j], sample_max))
        cursor = j
    return wins


def empty_window(tc):
    """The port's empty IMU window for config ``tc``, on the CPU."""
    from rebvio_tpu_torch.ops.imu import pack_imu_window

    return pack_imu_window(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(0, np.int64),
                           tc.imu.sample_max, device="cpu")


def use_pallas(monkeypatch, *flags):
    """Force the named Pallas kernels (interpret mode off the TPU) and drop
    jit caches that baked in another choice at trace time."""
    for f in flags:
        monkeypatch.setenv("REBVIO_PALLAS_" + f, "1")
    jax.clear_caches()


def to_np(tree):
    """A JAX state pytree (flax struct dataclass / NamedTuple) as a nested
    dict of numpy arrays with the same field names."""
    if dataclasses.is_dataclass(tree):
        return {f.name: to_np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if hasattr(tree, "_asdict"):
        return {k: to_np(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def edge_map_t(jax_em):
    return interop.edge_map_from_numpy(to_np(jax_em), device="cpu")


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def small_frame_pair(monkeypatch):
    """Two detected frames of the small synthetic sequence as JAX EdgeMaps
    with their attribute fields (Pallas flood in interpret mode), and the
    JAX config.  Returns (m0, m1, config)."""
    import jax.numpy as jnp

    from rebvio_tpu.data import synthetic
    from rebvio_tpu.ops import distance_field as DF, edge_detect
    from rebvio_tpu.pipeline import frontend_matrices

    use_pallas(monkeypatch, "JFA")
    jc, _ = small_configs()
    cam, det = jc.camera, jc.detector
    sr = int(jc.core.search_range)
    mats = frontend_matrices(jc)
    seq = synthetic.generate(cam, n_frames=2, seed=0)
    maps = []
    for i in range(2):
        em, stack = edge_detect.detect_with_seeds(
            jnp.asarray(seq.images[i] * jc.image_gain), jnp.float32(det.threshold), mats,
            det, cam, jc.field_scale, sr)
        att = DF.build_att_field(em, sr, cam.rows, cam.cols, jc.field_scale,
                                 seed_stack=stack)
        maps.append(em.replace(att_img=att))
    return maps[0], maps[1], jc


def make_random_map(rng, K, kmax, H, W, margin=3, unique_cells=True):
    """Random valid keylines with plausible geometry (the port's copy of
    tests/helpers.make_random_map), as a JAX EdgeMap and the same map as the
    port's EdgeMap on the CPU.  ``unique_cells`` keeps one keyline per pixel
    cell, as the detector does; without it positions are free, so several
    keylines may share a cell even at scale 1."""
    pos = np.zeros((K, 2), np.float32)
    cells_used = set()
    for i in range(K):
        for _ in range(200):
            c = np.array([rng.uniform(margin, W - margin), rng.uniform(margin, H - margin)])
            cell = (int(np.floor(c[1] + 0.5)), int(np.floor(c[0] + 0.5)))
            if not unique_cells or cell not in cells_used:
                cells_used.add(cell)
                pos[i] = c
                break
        else:
            raise RuntimeError("could not place unique keyline")
    ang = rng.uniform(0, 2 * np.pi, K)
    mag = rng.uniform(50.0, 300.0, K)
    grad = np.stack([np.cos(ang) * mag, np.sin(ang) * mag], axis=-1).astype(np.float32)
    return map_from_table(pos, grad, kmax, H, W,
                          rho=rng.uniform(0.05, 3.0, K).astype(np.float32),
                          sigma_rho=rng.uniform(0.1, 10.0, K).astype(np.float32))


def map_from_table(pos, grad, kmax, H, W, valid=None, rho=None, sigma_rho=None,
                   threshold=-1.0):
    """(JAX EdgeMap, port EdgeMap) holding the keyline table ``pos``/``grad``
    [K, 2] in slots 0..K-1; ``valid`` [K] defaults to all."""
    import jax.numpy as jnp

    from rebvio_tpu import types as jT

    K = len(pos)
    pos = np.asarray(pos, np.float32)
    grad = np.asarray(grad, np.float32)
    v = np.zeros(kmax, bool)
    v[:K] = True if valid is None else valid
    id_img = np.full((H, W), -1, np.int32)
    for i in range(K):
        r, c = int(np.floor(pos[i, 1] + 0.5)), int(np.floor(pos[i, 0] + 0.5))
        if v[i] and 0 <= r < H and 0 <= c < W:
            id_img[r, c] = i
    pos_img = pos - np.array([W / 2.0, H / 2.0], np.float32)

    def pad(a, fill=0.0):
        out = np.full((kmax,) + a.shape[1:], fill, a.dtype)
        out[:K] = a
        return jnp.asarray(out)

    em = jT.empty_edge_map(kmax, H, W).replace(
        pos=pad(pos), pos_img=pad(pos_img), match_pos_img=pad(pos_img),
        grad=pad(grad), grad_norm=pad(np.linalg.norm(grad, axis=-1).astype(np.float32)),
        valid=jnp.asarray(v), count=jnp.asarray(int(v.sum()), jnp.int32),
        kl_id_img=jnp.asarray(id_img), threshold=jnp.asarray(threshold, jnp.float32))
    if rho is not None:
        em = em.replace(rho=pad(rho, jT.RHO_INIT), sigma_rho=pad(sigma_rho, 20.0))
    return em, edge_map_t(em)


# ---- batched lanes (tests/test_torch_batch.py, tests/test_torch_batch_rw.py,
# tests/test_torch_tiny_config.py)

def tiny_config(mod, use_imu: bool, **kw):
    """tests/test_batched.py's tiny configuration (48x64, 256 keylines) from
    configs module ``mod``; VIO with a 2-frame bias-init window."""
    cam = mod.CameraConfig(rows=48, cols=64, cx=32, cy=24, fx=60, fy=60,
                           k1=0, k2=0, k3=0, p1=0, p2=0)
    return mod.PipelineConfig(camera=cam,
                              detector=mod.EdgeDetectorConfig(keylines_max=256, keylines_ref=128),
                              core=mod.CoreConfig(search_range=8, global_min_matches_threshold=5),
                              imu=mod.ImuConfig(sample_max=8, init_bias_frame_num=2),
                              use_imu=use_imu, **kw)


def lane_inputs(jc, n: int, seeds):
    """Per step of the lanes' synthetic sequences ``seeds``: frames [B, H, W]
    float32 (gained), the JAX IMU windows (leaves [B, ...]) and the frame
    intervals [B]."""
    import jax.numpy as jnp

    from rebvio_tpu.data import synthetic as jsyn

    seqs = [jsyn.generate(jc.camera, n_frames=n, seed=s) for s in seeds]
    wins = [jax_windows(s, n, jc.imu.sample_max) for s in seqs]
    steps = []
    for i in range(n):
        frames = np.stack([s.images[i].astype(np.float32) * jc.image_gain for s in seqs])
        dts = np.array([0.0 if i == 0 else (s.ts_us[i] - s.ts_us[i - 1]) / 1e6 for s in seqs],
                       np.float32)
        jw = jax.tree.map(lambda *xs: jnp.stack(xs), *[w[i] for w in wins])
        steps.append((frames, jw, dts))
    return steps


def port_window(jw, lane=None):
    """A JAX IMU window (lane ``lane`` of a batched one) as the port's, on
    the CPU."""
    d = to_np(jw)
    if lane is not None:
        d = {k: v[lane] for k, v in d.items()}
    return interop.imu_frame_from_numpy(d, device="cpu")


ODO_KEYS = ("orientation", "position", "num_matches", "run_ok")


def run_port_lanes(tc, steps):
    """The port's batched run over ``steps`` (lane_inputs) and each lane's
    unbatched run: (batched odometry rows, batched final state, [per-lane
    odometry rows] + [the lanes' final unbatched states])."""
    from rebvio_tpu_torch import pipeline as tpipe, types as tT
    from rebvio_tpu_torch.parallel import batch as TB

    B = steps[0][0].shape[0]
    mats = tpipe.frontend_matrices(tc, "cpu")
    st = TB.init_batched_state(tc, B, device="cpu")
    rows, lanes = [], [[] for _ in range(B)]
    singles = [tT.init_vio_state(tc, device="cpu") for _ in range(B)]
    lanes.append(singles)
    for frames, jw, dts in steps:
        st, odo = TB.batched_step(st, torch.as_tensor(frames), port_window(jw),
                                  torch.as_tensor(dts), tc, mats)
        rows.append({k: t2n(getattr(odo, k)) for k in ODO_KEYS})
        for b in range(B):
            singles[b], o = tpipe.step(singles[b], torch.as_tensor(frames[b]),
                                       port_window(jw, b), float(dts[b]), tc, mats)
            lanes[b].append({k: t2n(getattr(o, k)) for k in ODO_KEYS})
    return rows, st, lanes


def run_jax_lanes(jc, steps):
    """The JAX package's batched_step over ``steps``: (odometry rows as
    dicts of numpy arrays, final state as a dict)."""
    import jax.numpy as jnp

    from rebvio_tpu.parallel import batch as JB

    jst = JB.init_batched_state(jc, steps[0][0].shape[0])
    rows = []
    for frames, jw, dts in steps:
        jst, jodo = JB.batched_step(jst, jnp.asarray(frames), jw, jnp.asarray(dts), jc)
        rows.append(to_np(jodo))
    return rows, to_np(jst)


def stack(rows, key):
    return np.stack([r[key] for r in rows])            # [steps, B, ...]


# Each lane of the batched step against the port's unbatched step on its
# inputs: positions within LANE_TOL_REL of the lane's largest position, the
# final R_global within LANE_TOL_R, match counts within 1 %.  Measured on
# the CPU (torch 2.13, small preset, jfa/tube): positions within 2.0e-6 m
# of 0.021 m (VO, 3 steps: 0.01 %) and 2.0e-5 m of 0.0061 m (VIO, 9 steps,
# the SAB filter's first estimate at the last: 0.33 %), R_global within
# 1e-7 (VO) and 2.2e-4 (VIO: the first gravity alignment), match counts
# equal.  Not bit for bit: under vmap a matrix product with a batched
# operand runs as one batched product (on the CPU the LM solve's plain
# Gram products, the small rotation products), whose kernels sum in another
# order than the unbatched product's; from the first frame on a few
# keylines' depths then differ.  The frontend's band products and the
# refinement's Gram run one product a lane (linalg.lane_matmul).
# The VIO odometry's rotation vectors are not compared: they sit near a
# half turn, where so3.log turns 1e-7 in the matrix into 1e-3 in the vector
# (test_torch_vio.py).
LANE_TOL_REL = 0.01
LANE_TOL_R = 1e-3
LANE_MATCH_RTOL = 0.01


def check_lanes_match_unbatched(rows, st, lanes, vo: bool):
    """LANE_TOL_*: each lane of a run_port_lanes run against its unbatched
    run."""
    B = len(lanes) - 1
    singles = lanes[B]
    for b in range(B):
        lp = np.stack([r["position"] for r in lanes[b]])
        bp = stack(rows, "position")[:, b]
        np.testing.assert_allclose(stack(rows, "num_matches")[:, b],
                                   [r["num_matches"] for r in lanes[b]], rtol=LANE_MATCH_RTOL)
        print("lane", b, "max position difference", float(np.max(np.abs(lp - bp))))
        assert np.max(np.abs(lp - bp)) < LANE_TOL_REL * np.abs(lp).max()
        assert float((st.R_global[b] - singles[b].R_global).abs().max()) < LANE_TOL_R
        if vo:
            lo = np.stack([r["orientation"] for r in lanes[b]])
            assert np.max(np.abs(lo - stack(rows, "orientation")[:, b])) < 1e-5
    if not vo:
        assert np.abs(stack(rows, "position")[-1]).max() > 0    # the filter engaged


def check_repeated_lanes(rows, st, a: int, b: int):
    """Lanes ``a`` and ``b`` of a batched run (the same inputs) bit for bit."""
    from rebvio_tpu_torch import types as tT

    for key in ODO_KEYS:
        x = stack(rows, key)
        np.testing.assert_array_equal(x[:, a], x[:, b], err_msg=key)
    for x in tT.tree_leaves(st):
        assert torch.equal(x[a], x[b])


def record_kernel_lanes(tc, jc, names, seeds=(0, 1, 2), frame: int = 1):
    """The arguments each wrapper ``names`` (ops/kernels.py; "chol_inverse":
    geometry/linalg.py, its [7, 7] SAB prior) got at step ``frame`` of the
    port's unbatched step, one dict a lane (synthetic ``seeds``)."""
    import pytest

    from rebvio_tpu.data import synthetic as jsyn
    from rebvio_tpu_torch import pipeline as tpipe, types as tT
    from rebvio_tpu_torch.geometry import linalg
    from rebvio_tpu_torch.ops import kernels

    mats = tpipe.frontend_matrices(tc, "cpu")
    rec = {name: [] for name in names}

    def recorder(name, fn):
        def call(*args):
            rec[name].append(args)
            return fn(*args)
        return call

    lanes = []
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            mod = linalg if name == "chol_inverse" else kernels
            mp.setattr(mod, name, recorder(name, getattr(mod, name)))
        for seed in seeds:
            seq = jsyn.generate(jc.camera, n_frames=frame + 1, seed=seed)
            win = jax_windows(seq, frame + 1, jc.imu.sample_max)
            st = tT.init_vio_state(tc, device="cpu")
            for i in range(frame + 1):
                for v in rec.values():
                    v.clear()
                st, _ = tpipe.step(st, torch.as_tensor(seq.images[i].astype(np.float32)
                                                       * jc.image_gain),
                                   port_window(win[i]), 0.05 * (i > 0), tc, mats)
            lanes.append({k: ([a for a in v if a[0].shape == (7, 7)][0]
                              if k == "chol_inverse" else v[0]) for k, v in rec.items()})
    return lanes


def batched_args(lanes, name):
    """(stacked args, in_dims, per-lane args): tensors stacked over the
    lanes, the rest (constants, NamedTuples) taken from lane 0."""
    per = [ln[name] for ln in lanes]
    args, dims = [], []
    for i, a in enumerate(per[0]):
        if torch.is_tensor(a):
            args.append(torch.stack([p[i] for p in per]))
            dims.append(0)
        else:
            args.append(a)
            dims.append(None)
    return args, tuple(dims), per


def as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def check_plain_under_vmap(fn, args, dims, per, exact: bool, held=lambda outs: outs):
    """``fn`` under vmap against one call a lane: bit for bit where
    ``exact`` (and for ids and counts everywhere), else within 1e-5 of each
    output's largest finite entry (a batched matrix product may sum in
    another order).  ``held`` maps one lane's expected outputs (the
    unbatched call's) before the batched ones are compared with them."""
    got = as_list(torch.func.vmap(fn, in_dims=dims)(*args))
    for b, p in enumerate(per):
        want = held(as_list(fn(*p)))
        for g, w in zip([g[b] for g in got], want):
            if exact or not g.is_floating_point():
                assert torch.equal(g, w) or (g.is_floating_point() and
                                             torch.equal(g.isnan(), w.isnan()) and
                                             torch.equal(g.nan_to_num(), w.nan_to_num()))
            else:
                fin = torch.isfinite(w)
                assert torch.equal(fin, torch.isfinite(g))
                if fin.any():
                    scale = w[fin].abs().max().clamp(min=1e-30)
                    assert float(((g - w)[fin].abs() / scale).max()) < 1e-5


def emulated_launches(mp):
    """The kernels' operators' launches emulated on CPU tensors by the plain
    versions, lane by lane (the tests' stand-in for the CUDA kernels), and
    the wrappers routed to the operators.  Returns the launch log: one
    launcher name a launch."""
    from rebvio_tpu_torch.geometry import linalg
    from rebvio_tpu_torch.ops import kernels

    mp.setattr(kernels, "_on_cuda", lambda *ts: True)

    def flood(stack, sr, rows, cols, scale):
        return torch.stack([kernels.att_flood_plain(s, sr, rows, cols, scale) for s in stack])

    def solve(name, pos_img, rho, sr, grad, use_f, res, vel, att, g, it):
        outs, rs, ms = [], [], []
        for b in range(rho.shape[0]):
            a = (pos_img[b], rho[b], sr[b], grad[b], use_f[b])
            if res is None:
                v, JtJ, JtF, F, r, m, gains, acc, trials = kernels.minimize_vel_plain(
                    *a, vel[b], att[b], g, it, debug=True)
                outs.append(torch.cat([v, JtJ.reshape(9), JtF, F.reshape(1), gains,
                                       acc.to(torch.float32), trials]))
            else:
                F, JtJ, JtF, r, m = kernels.try_vel_plain(*a, res[b], vel[b], att[b], g)
                outs.append(torch.cat([torch.zeros(3), JtJ.reshape(9), JtF, F.reshape(1)]))
            rs.append(r)
            ms.append(m)
        return torch.stack(outs), torch.stack(rs), torch.stack(ms)

    def tube(kl, att, dyn, M2, g):
        return torch.stack([kernels.tube_match_plain(*a, g) for a in zip(kl, att, dyn, M2)])

    def mre(ins, p):
        fo, io, failed = [], [], []
        for b in range(ins[0].shape[0]):
            x = [t[b] for t in ins]
            # plain argument order: tube_out first, then the map planes
            o = kernels.match_reg_ekf_plain(x[13], *x[:8], x[14], x[15], *x[8:13], x[16],
                                            x[17], p)
            K = x[0].shape[0]
            fo.append(torch.cat([o[0], o[1], o[6], o[4].reshape(-1), o[5].reshape(-1)]))
            io.append(torch.cat([o[2], o[3], o[7], o[8].reshape(1),
                                 torch.zeros(-(-K // 128), dtype=torch.int32)]))
            failed.append(o[9])
        return torch.stack(fo), torch.stack(io), torch.stack(failed)

    def reg(ins, p):
        return torch.stack([torch.stack(kernels.reg_ekf_plain(*(t[b] for t in ins), p))
                            for b in range(ins[0].shape[0])])

    def sab(ins, iters):
        outs = [kernels.estimate_bias_plain(*(t[b] for t in ins), iters)
                for b in range(ins[0].shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))

    calls = []
    for launch, fn in (("_launch_att_flood", flood), ("_launch_minimize_vel", solve),
                       ("_launch_tube_match", tube), ("_launch_match_reg_ekf", mre),
                       ("_launch_reg_ekf", reg),
                       ("_launch_estimate_bias", sab),
                       ("_launch_chol_inverse", linalg.chol_inverse_plain)):
        def counted(*a, _fn=fn, _name=launch):
            calls.append(_name)
            return _fn(*a)
        mp.setattr(kernels, launch, counted)
    return calls
