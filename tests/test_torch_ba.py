"""The port's Schur-complement bundle adjustment against the JAX package on
the synthetic problems of tests/test_ba.py: the observation Jacobians
against ``jax.jacfwd``, every ``BATerms`` field, the reduction, solve and
back-substitution, ``optimize``'s cost history, poses and inverse depths,
tests/test_ba.py's three convergence assertions on the port,
``shard_problem`` bit for bit, and the landmark-sharded optimize over four
gloo processes against JAX's ``make_distributed_optimize`` on four of
conftest's virtual devices.

Run as a script, this file writes the two goldens that chip_smoke.py's
phase 9 holds the port's BA to on the card: JAX's ``--ba`` summary of the
120-frame parity VIO run from both JAX paths (Pallas interpret and XLA; the
spread sizes the bounds) and JAX's ``BAProblem`` of that run with its
optimized result:

    JAX_PLATFORMS=cpu python tests/test_torch_ba.py
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from test_ba import make_synthetic_ba  # noqa: E402
from torch_helpers import PALLAS_FLAGS, t2n, to_np  # noqa: E402

from rebvio_tpu.ba import distributed as jbd, problem as jbap  # noqa: E402
from rebvio_tpu_torch import eval as tev, interop  # noqa: E402
from rebvio_tpu_torch.ba import distributed as tbd, problem as tbap  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SUMMARY_GOLDEN = REPO / "tests" / "data" / "torch_golden_ba_vio_euroc_seed0_120.json"
PROBLEM_GOLDEN = REPO / "tests" / "data" / "torch_golden_ba_problem_seed0_120.npz"
WORKER = REPO / "tests" / "torch_ba_worker.py"

# JAX's accumulation as one compiled program (op by op it dispatches the
# vmapped jacfwd eagerly, several seconds a call)
jax_terms = jax.jit(jbap.accumulate_terms, static_argnums=1)

# (seed, make_synthetic_ba kwargs, iterations, huber delta, invalidate every
# other observation): tests/test_ba.py's three problems
CASES = {
    "converge": (0, {}, 15, 0.0, False),
    "noise_huber": (1, dict(noise_px=0.001), 10, 2.0, False),
    "masked": (2, dict(F=4, L=40), 12, 0.0, True),
}


def jax_problem(name):
    seed, kw, _, _, masked = CASES[name]
    p, gt = make_synthetic_ba(np.random.RandomState(seed), **kw)
    if masked:
        ov = np.array(p.obs_valid)
        ov[::2] = False
        p = p._replace(obs_valid=jnp.asarray(ov))
    return p, gt


def port(p):
    return interop.ba_problem_from_numpy(to_np(p), device="cpu")


@pytest.fixture(scope="module")
def runs():
    """Each case's optimize through both packages (the same inputs)."""
    out = {}
    for name, (_, _, iters, hub, _) in CASES.items():
        p, gt = jax_problem(name)
        jp, jh = jbap.optimize(p, iters=iters, huber_delta=hub)
        tp, th = tbap.optimize(port(p), iters=iters, huber_delta=hub)
        out[name] = dict(p=p, gt=gt, jp=jp, jh=np.asarray(jh), tp=tp, th=t2n(th))
    return out


def test_obs_jacobians_match_jacfwd():
    """One jvp over 13 unit tangents against three jax.jacfwd under vmap, at
    the perturbed poses (residuals of a few pixels) of the first problem."""
    p, _ = jax_problem("converge")
    L, F = p.rho.shape[0], p.R.shape[0]
    lm = np.clip(np.asarray(p.obs_lm), 0, L - 1)
    kf = np.clip(np.asarray(p.obs_kf), 0, F - 1)
    akf = np.clip(np.asarray(p.anchor_kf)[lm], 0, F - 1)
    args = [np.asarray(a) for a in (p.R[akf], p.t[akf], p.R[kf], p.t[kf], p.rho[lm],
                                    p.anchor_ray[lm], p.obs_uv)]
    jr, jJa, jJb, jJr = jax.jit(jax.vmap(jbap._obs_jacobian))(*[jnp.asarray(a) for a in args])
    tr, tJa, tJb, tJr = tbap.obs_jacobians(*[torch.as_tensor(a) for a in args])
    assert tJa.dtype == torch.float32 and tJa.shape == (len(lm), 2, 6)
    # measured, against each output's largest entry: residual 2.4e-7 of
    # 0.19, d/dpa 4.8e-7 of 3.0, d/dpb 7.2e-7 of 3.5, d/drho 2.3e-6 of 2.9
    # (at most 1.3e-6 of the largest); bound 5e-6 of the largest
    for t, j in ((tr, jr), (tJa, jJa), (tJb, jJb), (tJr, jJr)):
        j = np.asarray(j)
        np.testing.assert_allclose(t2n(t), j, rtol=0, atol=5e-6 * np.abs(j).max())
    assert np.abs(np.asarray(jJa)).max() > 1.0


@pytest.mark.parametrize("name", list(CASES))
def test_accumulate_terms_match_jax(name):
    p, _ = jax_problem(name)
    hub = CASES[name][3]
    jt = jax_terms(p, hub)
    tt = tbap.accumulate_terms(port(p), hub)
    for f in jbap.BATerms._fields:
        a, b = np.asarray(getattr(jt, f)), t2n(getattr(tt, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        # float32 sums of the same products in another order (a dense
        # product and a segmented scan against scatter-adds): measured within
        # 1.13e-6 of each field's largest entry (cost 1.1e-7); 1e-5
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * max(np.abs(a).max(), 1e-30),
                                   err_msg=f)
    assert int(tt.n_obs) == int(jt.n_obs) > 0
    assert float(tbap.problem_cost(port(p), hub)) == pytest.approx(float(jt.cost), rel=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_schur_solve_backsub_match_jax(name):
    """The reduction, the damped solve and the back-substitution from the
    same (JAX's) terms."""
    p, _ = jax_problem(name)
    jt = jax_terms(p, CASES[name][3])
    tt = tbap.BATerms(**{k: torch.as_tensor(np.array(v)) for k, v in to_np(jt).items()})
    for lam in (1e-3, 0.5):
        for fix_first in (True, False):
            S, rhs = jbap.schur_reduce(jt, jnp.float32(lam))
            dp = jbap.solve_reduced(S, rhs, jnp.float32(lam), fix_first)
            drho = jbap.backsub_landmarks(jt, dp, jnp.float32(lam))
            tl = torch.tensor(lam, dtype=torch.float32)
            tS, trhs = tbap.schur_reduce(tt, tl)
            tdp = tbap.solve_reduced(tS, trhs, tl, fix_first)
            tdrho = tbap.backsub_landmarks(tt, tdp, tl)
            # measured against each output's largest entry: S equal, rhs
            # 1.7e-7, dp 1.2e-3 and drho 4.8e-5 (both at lam 1e-3 with a free
            # gauge, an ill-conditioned solve; 3.5e-6 and 6.8e-7 at lam 0.5);
            # bounds 2e-6, 2e-6, 5e-3, 5e-4
            for a, b, rel in ((S, tS, 2e-6), (rhs, trhs, 2e-6), (dp, tdp, 5e-3),
                              (drho, tdrho, 5e-4)):
                a = np.asarray(a)
                np.testing.assert_allclose(t2n(b), a, rtol=0, atol=rel * np.abs(a).max())
            if fix_first:
                assert not t2n(tdp)[:6].any()


def test_apply_update_matches_jax():
    p, _ = jax_problem("converge")
    rng = np.random.RandomState(7)
    dp = (rng.randn(6 * p.R.shape[0]) * 0.05).astype(np.float32)
    drho = (rng.randn(p.rho.shape[0]) * 0.3).astype(np.float32)
    jn = jbap.apply_update(p, jnp.asarray(dp), jnp.asarray(drho), rho_min=0.05, rho_max=0.3)
    tn = tbap.apply_update(port(p), torch.as_tensor(dp), torch.as_tensor(drho), rho_min=0.05,
                           rho_max=0.3)
    np.testing.assert_allclose(t2n(tn.R), np.asarray(jn.R), atol=1e-6)
    np.testing.assert_array_equal(t2n(tn.t), np.asarray(jn.t))
    np.testing.assert_array_equal(t2n(tn.rho), np.asarray(jn.rho))
    assert t2n(tn.rho).min() == np.float32(0.05) and t2n(tn.rho).max() == np.float32(0.3)


@pytest.mark.parametrize("name", list(CASES))
def test_optimize_matches_jax(runs, name):
    r = runs[name]
    jh, th = r["jh"], r["th"]
    assert th.shape == jh.shape == (CASES[name][2],)
    # the same damped steps in float32; the free scale gauge (only the
    # damping holds it) amplifies the summation order's rounding in each
    # step: measured within 6.0e-4 relative while the cost is above 1e-6 of
    # the starting cost, and within 1.0e-6 of it absolute once both sit on
    # float32's noise floor; poses within 7.2e-5, inverse depths within
    # 5.0e-5 relative (median)
    cost0 = float(jax_terms(r["p"], CASES[name][3]).cost)
    np.testing.assert_allclose(th, jh, rtol=3e-3, atol=5e-6 * cost0)
    np.testing.assert_allclose(t2n(r["tp"].t), np.asarray(r["jp"].t), atol=5e-4)
    np.testing.assert_allclose(t2n(r["tp"].R), np.asarray(r["jp"].R), atol=5e-4)
    jr = np.asarray(r["jp"].rho)
    assert np.median(np.abs(t2n(r["tp"].rho) - jr) / jr) < 5e-4
    # keyframe 0 is the gauge: untouched
    np.testing.assert_array_equal(t2n(r["tp"].t[0]), np.asarray(r["p"].t[0]))
    assert (np.diff(th) <= 0).all()


def test_ba_converges_to_ground_truth(runs):
    """tests/test_ba.py::test_ba_converges_to_ground_truth on the port."""
    r = runs["converge"]
    _, t_gt, rho_gt = r["gt"]
    assert r["th"][-1] < r["th"][0] * 1e-4, r["th"]
    t_est = t2n(r["tp"].t).astype(np.float64)
    s, Ru, tu = tev.umeyama(t_est, t_gt.astype(np.float64), with_scale=True)
    t_al = (s * (Ru @ t_est.T)).T + tu
    assert np.linalg.norm(t_al - t_gt, axis=-1).max() < 1e-3
    rho_err = np.abs(t2n(r["tp"].rho) / s - rho_gt) / rho_gt
    assert np.median(rho_err) < 5e-3, np.median(rho_err)


def test_ba_with_noise_reduces_cost(runs):
    th = runs["noise_huber"]["th"]
    assert th[-1] < th[0] * 0.5


def test_ba_masked_invalid_obs(runs):
    th = runs["masked"]["th"]
    assert th[-1] < th[0] * 1e-3


def test_segment_sums_order_fixed():
    """segment_sums against a float64 scatter-add (empty segments, one long
    segment, keys in random order); a second call gives the same bits."""
    rng = np.random.RandomState(0)
    key = np.concatenate([rng.randint(0, 50, 300), np.full(200, 77)])
    rng.shuffle(key)
    vals = rng.randn(len(key), 5).astype(np.float32)
    kt, vt = torch.as_tensor(key), torch.as_tensor(vals)
    out = tbap.segment_sums(vt, kt, 100)
    ref = np.zeros((100, 5))
    np.add.at(ref, key, vals.astype(np.float64))
    np.testing.assert_allclose(t2n(out), ref, atol=2e-5)
    assert not t2n(out)[50:77].any() and not t2n(out)[78:].any()
    assert torch.equal(out, tbap.segment_sums(vt, kt, 100))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_shard_problem_equals_jax(n):
    p, _ = jax_problem("masked")
    lm = np.array(p.obs_lm)
    lm[5] = -1                                  # an invalid landmark index too
    p = p._replace(obs_lm=jnp.asarray(lm))
    js = to_np(jbd.shard_problem(p, n))
    ts = interop.to_numpy(tbd.shard_problem(port(p), n))
    assert js.keys() == ts.keys()
    for k in js:
        assert js[k].dtype == ts[k].dtype and js[k].shape == ts[k].shape, k
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    shards = [tbd.local_shard(tbd.shard_problem(port(p), n), r, n) for r in range(n)]
    assert sum(int(s.obs_valid.sum()) for s in shards) == int((np.asarray(p.obs_valid)
                                                              & (lm >= 0)).sum())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_distributed_gloo_matches_jax(tmp_path):
    """Four gloo processes, each optimizing its landmark shard with one
    all-reduce of S, rhs and the cost per iteration, against JAX's
    make_distributed_optimize on four virtual devices (tests/test_ba.py's
    distributed problem) and against the port's single-process optimize."""
    from jax.sharding import Mesh

    n, iters = 4, 12
    assert len(jax.devices()) >= n
    p, _ = make_synthetic_ba(np.random.RandomState(3), F=5, L=64)
    ps = jbd.shard_problem(p, n)
    mesh = Mesh(np.asarray(jax.devices()[:n]), axis_names=("lm",))
    jp, jh = jbd.make_distributed_optimize(mesh, iters=iters)(jbd.place(ps, mesh))
    jh = np.asarray(jh)

    src = tmp_path / "sharded.npz"
    np.savez(src, **to_np(ps))
    port_no = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(n), str(port_no),
                               str(src), str(tmp_path / f"out{r}.npz"), str(iters)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(n)]
    for pr in procs:
        out, _ = pr.communicate(timeout=120)
        assert pr.returncode == 0, out.decode()[-2000:]
    res = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(n)]
    for r in res[1:]:                       # replicated poses, one decision
        for k in ("R", "t", "hist"):
            np.testing.assert_array_equal(r[k], res[0][k])
    Ls = np.asarray(ps.rho).shape[0] // n
    rho = np.concatenate([r["rho"] for r in res])
    np.testing.assert_array_equal(np.concatenate([r["obs_lm"] for r in res]),
                                  np.asarray(ps.obs_lm))
    # measured against JAX: the history within 5.8e-4 relative above the
    # noise floor (6.7e-7 of the starting cost absolute), poses within
    # 2.2e-5, inverse depths 1.4e-5 relative (median); against the port's
    # single process (S summed in another order): 1.2e-3, 7.1e-7, 8.1e-6.
    # The bounds of test_optimize_matches_jax
    cost0 = float(jax_terms(ps, 0.0).cost)
    np.testing.assert_allclose(res[0]["hist"], jh, rtol=3e-3, atol=5e-6 * cost0)
    np.testing.assert_allclose(res[0]["t"], np.asarray(jp.t), atol=5e-4)
    np.testing.assert_allclose(res[0]["R"], np.asarray(jp.R), atol=5e-4)
    jr = np.asarray(jp.rho)
    assert np.median(np.abs(rho - jr) / jr) < 5e-4
    assert res[0]["hist"][-1] < res[0]["hist"][0] * 1e-3
    # against the port's single-process optimize on the padded problem
    sp, sh = tbap.optimize(port(ps), iters=iters)
    np.testing.assert_allclose(res[0]["hist"], t2n(sh), rtol=3e-3, atol=5e-6 * cost0)
    np.testing.assert_allclose(res[0]["t"], t2n(sp.t), atol=5e-4)
    assert Ls * n == rho.shape[0]


# ---------------------------------------------------------------------------
# the goldens of chip_smoke.py's phase 9

BA_KF_EVERY = 5
BA_ITERS = 10
BA_HUBER = 3.0


def _jax_ba_run(pallas: bool, n_frames: int = 120):
    """JAX's ``--ba`` path on chip_smoke's VIO stream: the 120 distorted
    frames of the seed-0 anchor stream through ``VioRunner.run_mapped``
    (PipelineConfig(), undistortion on the device, a keyframe every 5
    frames at phase 4), ``build_problem(min_obs=2)``, then
    ``optimize(iters=10, huber_delta=3.0)``.  Returns (summary, problem,
    optimized problem, cost history, cost before)."""
    for f in PALLAS_FLAGS + ("SAB",):
        os.environ["REBVIO_PALLAS_" + f] = "1" if pallas else "0"
    jax.clear_caches()
    from rebvio_tpu import eval as jev
    from rebvio_tpu.ba.keyframe_map import KeyframeMapBuilder
    from rebvio_tpu.configs import CameraConfig, PipelineConfig
    from rebvio_tpu.data import synthetic as jsyn
    from rebvio_tpu.runner import VioRunner

    seq = jsyn.generate(CameraConfig(), n_frames=n_frames, seed=0, distort=True,
                        imu_preroll_s=0.1)
    cfg = PipelineConfig()
    builder = KeyframeMapBuilder(cfg, kf_every=BA_KF_EVERY, kf_phase=BA_KF_EVERY - 1)
    res = VioRunner(cfg, undistort=True).run_mapped(seq, builder, chunk=BA_KF_EVERY)
    assert res.run_ok.all()
    p = builder.build_problem(min_obs=2)
    terms0 = jbap.accumulate_terms(p)
    p_opt, hist = jbap.optimize(p, iters=BA_ITERS, huber_delta=BA_HUBER)
    terms1 = jbap.accumulate_terms(p_opt)
    n_obs = max(int(terms0.n_obs), 1)
    kf_idx = np.asarray([k.index for k in builder.keyframes])
    summary = dict(
        ba_keyframes=builder.n_keyframes(), ba_landmarks=int(np.asarray(p.lm_valid).sum()),
        ba_observations=int(np.asarray(p.obs_valid).sum()),
        ba_rms_before_px=float(np.sqrt(float(terms0.cost) / n_obs)),
        ba_rms_after_px=float(np.sqrt(float(terms1.cost) / n_obs)),
        ba_ate_sim3=jev.ate_rmse(np.asarray(p_opt.t), seq.gt_pos[kf_idx], align=True,
                                 with_scale=True),
        ba_ate_sim3_before=jev.ate_rmse(np.asarray(p.t), seq.gt_pos[kf_idx], align=True,
                                        with_scale=True),
        kf_index=kf_idx.tolist())
    cost0 = float(jbap.accumulate_terms(p, BA_HUBER).cost)
    return summary, p, p_opt, np.asarray(hist), cost0


def problem_golden(p, p_opt, hist, cost0) -> dict:
    """The arrays of the problem golden: JAX's problem (``p_*``), its
    optimized poses and inverse depths (``opt_*``) with the cost history and
    starting cost, its normal equations at ``huber_delta`` 3.0
    (``terms_*``), and the first iteration's reduced system, pose update and
    landmark update at lam 1e-3 (``S``, ``rhs``, ``dp``, ``drho``)."""
    out = {"p_" + k: v for k, v in to_np(p).items()}
    out.update({"opt_" + k: np.asarray(getattr(p_opt, k)) for k in ("R", "t", "rho")})
    terms = jbap.accumulate_terms(p, BA_HUBER)
    out.update({"terms_" + k: v for k, v in to_np(terms).items()})
    lam = jnp.float32(1e-3)
    S, rhs = jbap.schur_reduce(terms, lam)
    dp = jbap.solve_reduced(S, rhs, lam, True)
    out.update(S=np.asarray(S), rhs=np.asarray(rhs), dp=np.asarray(dp),
               drho=np.asarray(jbap.backsub_landmarks(terms, dp, lam)), hist=hist,
               cost0=np.float32(cost0))
    return out


def order_spread(p, summary, n_orders: int = 3) -> dict:
    """How far JAX's own optimize moves the RMS after and the keyframe ATE
    when only the order of the observations changes (the same problem,
    another float32 summation order; the full-width problem is
    ill-conditioned): the largest deviation from ``summary`` over
    ``n_orders`` seeded permutations."""
    from rebvio_tpu import eval as jev
    from rebvio_tpu.configs import CameraConfig
    from rebvio_tpu.data import synthetic as jsyn

    gt = jsyn.generate(CameraConfig(), n_frames=120, seed=0, distort=True,
                       imu_preroll_s=0.1).gt_pos[np.asarray(summary["kf_index"])]
    opt = jax.jit(jbap.optimize, static_argnames=("iters", "huber_delta"))
    n_obs = max(int(summary["ba_observations"]), 1)
    dev = {"ba_rms_after_px": 0.0, "ba_ate_sim3": 0.0}
    for seed in range(1, n_orders + 1):
        perm = np.random.RandomState(seed).permutation(p.obs_lm.shape[0])
        q = p._replace(**{k: jnp.asarray(np.asarray(getattr(p, k))[perm])
                          for k in ("obs_lm", "obs_kf", "obs_uv", "obs_w", "obs_valid")})
        q_opt, _ = opt(q, iters=BA_ITERS, huber_delta=BA_HUBER)
        got = {"ba_rms_after_px": float(np.sqrt(float(jax_terms(q_opt, 0.0).cost) / n_obs)),
               "ba_ate_sim3": jev.ate_rmse(np.asarray(q_opt.t), gt, align=True, with_scale=True)}
        print(f"observation order {seed}:", json.dumps(got))
        for k in dev:
            dev[k] = max(dev[k], abs(got[k] - summary[k]))
    return dev


def write_goldens():
    t0 = time.time()
    a, p, p_opt, hist, cost0 = _jax_ba_run(pallas=True)
    print(f"JAX Pallas path ({time.time() - t0:.0f} s):", json.dumps(a))
    orders = order_spread(p, a)
    print("observation-order spread:", json.dumps(orders))
    t0 = time.time()
    b, *_ = _jax_ba_run(pallas=False)
    print(f"JAX XLA path ({time.time() - t0:.0f} s):", json.dumps(b))
    spread = {k: abs(a[k] - b[k]) for k in a if k != "kf_index"}
    print("spread:", json.dumps(spread))
    SUMMARY_GOLDEN.write_text(json.dumps(
        {"source": "JAX run_mapped + build_problem(min_obs=2) + optimize(iters=10, "
                   "huber_delta=3.0) on the 120 distorted frames of the seed-0 anchor stream "
                   "(PipelineConfig(), undistort=True, kf_every 5, kf_phase 4)",
         "pallas": a, "xla": b, "spread": spread, "order_spread": orders}, indent=1) + "\n")
    np.savez_compressed(PROBLEM_GOLDEN, **problem_golden(p, p_opt, hist, cost0))
    print(f"wrote {SUMMARY_GOLDEN} and {PROBLEM_GOLDEN} "
          f"({PROBLEM_GOLDEN.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_goldens()
