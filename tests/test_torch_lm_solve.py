"""The port's fused LM solve (kernels.minimize_vel, kernel K2's plain version
on the CPU) and its Cholesky inverse against the JAX package, and source
checks that the step's modules never read a tensor back to the host (nor
index the field seeding by a boolean mask, nor upload Python scalars in the
matcher, the rotation helpers, the detector, the IMU and the pipeline, nor
cast a tensor to a Python scalar in the pipeline, nor call nonzero in
ops/)."""

from __future__ import annotations

import ast
import dataclasses
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import edge_map_t, small_frame_pair, t2n, use_pallas  # noqa: E402

from rebvio_tpu.geometry import linalg as jla  # noqa: E402
from rebvio_tpu.ops import tracker as jTr  # noqa: E402
from rebvio_tpu_torch.configs import CameraConfig, CoreConfig  # noqa: E402
from rebvio_tpu_torch.geometry import linalg as tla  # noqa: E402
from rebvio_tpu_torch.ops import kernels, tracker as tTr  # noqa: E402
from rebvio_tpu_torch.ops.matching import estimate_quantile  # noqa: E402

PORT = Path(__file__).resolve().parent.parent / "rebvio_tpu_torch"
STEP_SOURCES = sorted(str(p.relative_to(PORT)) for d in ("geometry", "ops")
                      for p in (PORT / d).glob("*.py"))
OPS_SOURCES = [r for r in STEP_SOURCES if r.startswith("ops/")]


@pytest.mark.parametrize("n", [3, 6, 7])
def test_chol_inverse_matches_jax(n):
    """The same unrolled recurrence on both sides: float32 rounding of the
    two runtimes' sqrt and division only (rtol 1e-5), and NaN in the same
    entries for a matrix that is not positive definite."""
    rng = np.random.RandomState(10 + n)
    A = rng.randn(16, n, n).astype(np.float32)
    spd = (A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).astype(np.float32)
    got = t2n(tla.chol_inverse(torch.as_tensor(spd)))
    want = np.asarray(jla.chol_inverse(jnp.asarray(spd)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got @ spd, np.broadcast_to(np.eye(n), spd.shape), atol=1e-4)
    assert np.array_equal(got, t2n(tla.chol_inverse_plain(torch.as_tensor(spd))))
    bad = spd[0].copy()
    bad[1, 1] = -1.0
    got_bad = t2n(tla.chol_inverse(torch.as_tensor(bad)))
    want_bad = np.asarray(jla.chol_inverse(jnp.asarray(bad)))
    assert np.isnan(got_bad).any()
    np.testing.assert_array_equal(np.isnan(got_bad), np.isnan(want_bad))


def _tcfg(jc, iterations):
    cam = CameraConfig(**{k: getattr(jc.camera, k) for k in jc.camera.__dataclass_fields__})
    core = CoreConfig(**{k: getattr(jc.core, k) for k in jc.core.__dataclass_fields__})
    return cam, dataclasses.replace(core, iterations=iterations)


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        m0, m1, jc = small_frame_pair(mp)
        rng = np.random.RandomState(5)
        # spread depths so the participation gate and the reweight act
        K = m0.kmax
        m0 = m0.replace(rho=jnp.asarray(rng.uniform(0.2, 2.0, K).astype(np.float32)),
                        sigma_rho=jnp.asarray(rng.uniform(0.5, 25.0, K).astype(np.float32)))
        use_pallas(mp, "TRYVEL")
        yield m0, m1, jc
        jax.clear_caches()


def _solve_inputs(m0, m1, jc, iterations):
    """kernels.minimize_vel's arguments for the frame pair, as
    tracker.minimize_vel builds them."""
    cam, core = _tcfg(jc, iterations)
    old = edge_map_t(m0)
    H, W = old.kl_id_img.shape
    geom = tTr._try_vel_geom(H, W, jc.field_scale, core, cam)
    srm = estimate_quantile(old, core.quantile_cutoff, core.quantile_num_bins)
    return (old.pos_img.contiguous(), old.rho, old.sigma_rho, old.grad.contiguous(),
            tTr._use_mask(old, srm), torch.zeros(3), torch.as_tensor(np.asarray(m1.att_img)),
            geom, iterations)


@pytest.mark.parametrize("iterations", [0, 1, 5])
def test_minimize_vel_wrapper_matches_jax(pair, iterations):
    m0, m1, jc = pair
    jcore = dataclasses.replace(jc.core, iterations=iterations)
    v, Rv, old, F = jTr.minimize_vel(m0, m1, m1.att_img, jnp.zeros(3, jnp.float32), jcore,
                                     jc.camera, jc.field_scale, use_att=True)
    args = _solve_inputs(m0, m1, jc, iterations)
    vel, JtJ, JtF, score, res, mif, gains, accepts, trials = kernels.minimize_vel(
        *args, debug=True)
    assert gains.shape == accepts.shape == trials.shape == (iterations,)
    assert accepts.dtype == torch.bool
    # 1 + iterations dependent LM steps on float32 Gram sums of 2048 terms in
    # another order: the velocity to 1e-5 (test_minimize_vel_matches_jax's)
    np.testing.assert_allclose(t2n(vel), np.asarray(v), atol=1e-5, rtol=1e-3)
    np.testing.assert_allclose(t2n(tla.invert3(JtJ)), np.asarray(Rv), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(float(score), float(F), rtol=1e-4)
    assert np.mean(t2n(mif) == np.asarray(old.match_id_forward)) > 0.999
    if iterations:
        assert bool(accepts[0])                 # the first step from rest improves the score
        assert float(score) <= float(trials[0]) * (1 + 1e-6)
    # the tracker's entry point is this one call
    cam, core = _tcfg(jc, iterations)
    tv, tRv, told, tF = tTr.minimize_vel(edge_map_t(m0), args[6], torch.zeros(3), core, cam,
                                         jc.field_scale)
    assert torch.equal(tv, vel) and torch.equal(tF, score)
    assert torch.equal(told.match_id_forward, mif) and torch.equal(tRv, tla.invert3(JtJ))


def test_minimize_vel_without_iterations_is_one_pass(pair):
    """iterations = 0 is exactly one tryVel pass from zero residuals."""
    m0, m1, jc = pair
    pos_img, rho, sr, grad, use_f, vel0, att, geom, _ = _solve_inputs(m0, m1, jc, 0)
    vel0 = torch.tensor([0.004, -0.003, 0.01])
    vel, JtJ, JtF, score, res, mif = kernels.minimize_vel(pos_img, rho, sr, grad, use_f, vel0,
                                                          att, geom, 0)
    one = kernels.try_vel(pos_img, rho, sr, grad, use_f, torch.zeros_like(rho), vel0, att, geom)
    assert torch.equal(vel, vel0)
    for got, want in zip((score, JtJ, JtF, res, mif), one):
        assert torch.equal(got, want)
    assert int((mif >= 0).sum()) > 500


def _host_reads(tree):
    """Calls that copy a tensor to the host: .cpu(), .item(), .tolist(),
    .to("cpu") / .to(device="cpu")."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        if attr in ("cpu", "item", "tolist"):
            yield node.lineno, attr
        elif attr == "to":
            vals = list(node.args) + [k.value for k in node.keywords]
            if any(isinstance(a, ast.Constant) and a.value == "cpu" for a in vals):
                yield node.lineno, 'to("cpu")'


@pytest.mark.parametrize("rel", STEP_SOURCES + ["pipeline.py"])
def test_step_modules_never_read_back(rel):
    """geometry/, ops/ and pipeline.py hold the step's device code: a host
    copy there is a sync on the frame path (and on the card a piece of the
    step on the CPU), and it cannot be captured into the runner's graph."""
    found = list(_host_reads(ast.parse((PORT / rel).read_text())))
    assert not found, f"{rel}: host reads at {found}"


def test_host_read_detector_sees_them():
    src = "def f(m):\n    a = m.to('cpu')\n    b = m.cpu()\n    return a.item(), b.tolist()\n"
    assert sorted(a for _, a in _host_reads(ast.parse(src))) == [
        "cpu", "item", 'to("cpu")', "tolist"]
    assert STEP_SOURCES and "geometry/linalg.py" in STEP_SOURCES


# the modules whose per-frame constants no longer go to the device as
# torch.tensor of Python scalars
NO_SCALAR_UPLOADS = ("ops/matching.py", "geometry/so3.py", "ops/edge_detect.py", "ops/imu.py",
                     "pipeline.py", "ops/distance_field.py", "ops/tracker.py")


def _scalar_uploads(tree):
    """``torch.tensor`` of a list, tuple or number literal: on a device each
    call is a host-to-device copy from pageable memory, a host sync."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "tensor" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "torch" and node.args
                and isinstance(node.args[0], (ast.List, ast.Tuple, ast.Constant))):
            yield node.lineno


@pytest.mark.parametrize("rel", NO_SCALAR_UPLOADS)
def test_step_modules_never_upload_scalars(rel):
    found = list(_scalar_uploads(ast.parse((PORT / rel).read_text())))
    assert not found, f"{rel}: torch.tensor of Python scalars at lines {found}"


def test_scalar_upload_detector_sees_them():
    src = ("def f(cx, cy, d, x):\n    a = torch.tensor([cx, cy], device=d)\n"
           "    b = torch.tensor(2.0, device=d)\n    c = torch.tensor((cx, 1.0))\n"
           "    return a, b, c, torch.tensor(x), torch.as_tensor(x)\n")
    assert sorted(_scalar_uploads(ast.parse(src))) == [2, 3, 4]


MASK_NAMES = ("win", "mask")


def _mask_subscripts(tree):
    """Subscripts by a boolean mask named ``win`` or ``mask`` (``x[win]``,
    ``x[r, mask]``): on a device tensor each is a nonzero and a host sync."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Subscript):
            idx = node.slice.elts if isinstance(node.slice, ast.Tuple) else [node.slice]
            for e in idx:
                if isinstance(e, ast.Name) and e.id in MASK_NAMES:
                    yield node.lineno, e.id


def test_field_seeding_never_masks():
    """ops/distance_field.py seeds the field every frame without a host sync:
    no boolean-mask indexing (and no host read, above)."""
    found = list(_mask_subscripts(ast.parse((PORT / "ops" / "distance_field.py").read_text())))
    assert not found, f"ops/distance_field.py: mask indexing at {found}"


def test_mask_subscript_detector_sees_them():
    src = "def f(a, win, mask, w):\n    b = a[win]\n    a[0, mask] = 1\n    return b, a[w]\n"
    assert sorted(n for _, n in _mask_subscripts(ast.parse(src))) == ["mask", "win"]


def _host_scalar_casts(tree):
    """``bool(x)``, ``int(x)``, ``float(x)`` of anything but a literal: on a
    device tensor each reads it back to the host, and a branch on it cannot
    be captured into a graph."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("bool", "int", "float") and node.args
                and not isinstance(node.args[0], ast.Constant)):
            yield node.lineno, node.func.id


def test_pipeline_never_casts_to_host_scalars():
    """pipeline.py decides first frame, failure latch and recovery by device
    selects, as JAX does: no Python bool/int/float of a tensor."""
    found = list(_host_scalar_casts(ast.parse((PORT / "pipeline.py").read_text())))
    assert not found, f"pipeline.py: host scalar casts at {found}"


def test_host_scalar_cast_detector_sees_them():
    src = ("def f(s, c):\n    a = bool(s.run_ok == 0)\n    b = int(c.search_range)\n"
           "    return a, b, float(s.K), float(2), int('3')\n")
    assert sorted(_host_scalar_casts(ast.parse(src))) == [(2, "bool"), (3, "int"), (4, "float")]


def _nonzero_calls(tree):
    """``torch.nonzero(x)`` and ``x.nonzero()``: the result's size is read
    back to the host."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "nonzero"):
            yield node.lineno


@pytest.mark.parametrize("rel", OPS_SOURCES + ["pipeline.py"])
def test_ops_never_call_nonzero(rel):
    """ops/ and pipeline.py size nothing on the host: the detector's
    compaction and the pixel walk's phase-2 compaction are a prefix sum and a
    binary search at a fixed size (keylines_max, matching.WALK_CAP)."""
    found = list(_nonzero_calls(ast.parse((PORT / rel).read_text())))
    assert not found, f"{rel}: nonzero at lines {found}"


def test_nonzero_detector_sees_them():
    src = "def f(m, np):\n    a = torch.nonzero(m)\n    return a, m.nonzero(), np.flatnonzero(m)\n"
    assert sorted(_nonzero_calls(ast.parse(src))) == [2, 3]
    assert "ops/edge_detect.py" in OPS_SOURCES
