"""The public helpers of the JAX package that the step does not reach, each
held to its JAX counterpart on the same seeded inputs: ``scale_space.smooth``,
``linalg.svd_solve`` and ``gj_solve`` (a PD, a singular-finite and a NaN
case each, and a rank-deficient one for the SVD), ``types.empty_imu_frame``,
``tracker.TryVelOut`` (what ``tracker.try_vel`` returns) and
``tracker.pack_target_fields`` (and ``raster_att``'s planes built from it);
and the scan of top-level public names: every function and class of a JAX
module has its counterpart in the port's module of the same path, but the
names held by design."""

from __future__ import annotations

import ast
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_helpers import make_random_map, small_configs, t2n  # noqa: E402

from rebvio_tpu import types as jT  # noqa: E402
from rebvio_tpu.geometry import linalg as jla  # noqa: E402
from rebvio_tpu.ops import scale_space as jss, tracker as jtr  # noqa: E402
from rebvio_tpu_torch import types as tT  # noqa: E402
from rebvio_tpu_torch.geometry import linalg as tla  # noqa: E402
from rebvio_tpu_torch.ops import scale_space as tss, tracker as ttr  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# A float result against JAX's: within 1e-5 of its largest entry (XLA's and
# PyTorch's products and factorizations sum in other orders), NaN where
# JAX's is NaN.
REL_TOL = 1e-5


def _system(case: str, n: int = 6):
    """(A, b) float32: a PD matrix; one of rank n - 2 (a PD block and two
    zero rows and columns, permuted, so that two singular values are
    exactly 0: float32 noise above ``rcond`` would be inverted); a zero
    (singular, finite) matrix; a PD one with a NaN."""
    rng = np.random.RandomState(11)
    M = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    if case == "pd":
        A = M @ M.T + n * np.eye(n, dtype=np.float32)
    elif case == "rank_deficient":
        A = np.zeros((n, n), np.float32)
        A[:n - 2, :n - 2] = M[:n - 2, :n - 2] @ M[:n - 2, :n - 2].T + np.eye(n - 2)
        perm = rng.permutation(n)
        A = A[perm][:, perm]
    elif case == "singular":
        A = np.zeros((n, n), np.float32)
    else:
        A = M @ M.T + n * np.eye(n, dtype=np.float32)
        A[1, 2] = np.nan
    return A, b


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    scale = max(float(np.abs(want[fin]).max()) if fin.any() else 0.0, 1e-30)
    assert float(np.abs(got[fin] - want[fin]).max(initial=0.0)) <= REL_TOL * scale


def _maps():
    rng = np.random.RandomState(2)
    jc, _ = small_configs()
    return make_random_map(rng, 300, 512, jc.camera.rows, jc.camera.cols), jc


def check_smooth():
    img = np.random.RandomState(1).rand(120, 188).astype(np.float32) * 255
    for widths in ((3, 3, 5), (1,), (7, 9)):
        _close(t2n(tss.smooth(torch.as_tensor(img), widths)),
               jss.smooth(jnp.asarray(img), widths))


def check_solve(name, case):
    A, b = _system(case)
    got = t2n(getattr(tla, name)(torch.as_tensor(A), torch.as_tensor(b)))
    want = np.asarray(getattr(jla, name)(jnp.asarray(A), jnp.asarray(b)))
    print(name, case, got, want)
    _close(got, want)
    if case == "singular":
        assert (got == 0).all()
    if case == "nan":
        assert np.isnan(got).all()


def check_empty_imu_frame():
    got, want = tT.empty_imu_frame(8, device="cpu"), jT.empty_imu_frame(8)
    for name in ("gyro", "acc", "dt", "n", "dt_interval"):
        a, w = t2n(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.dtype == w.dtype and a.shape == w.shape, name
        np.testing.assert_array_equal(a, w)


def check_try_vel_out():
    """tracker.try_vel returns a TryVelOut, which unpacks as the tuple it was."""
    assert ttr.TryVelOut._fields == jtr.TryVelOut._fields
    (_jem, tem), _jc = _maps()
    _, tc = small_configs()
    att = ttr.raster_att(tem, torch.full((120 * 188,), -1, dtype=torch.int32))
    out = ttr.try_vel(tem, att, torch.zeros(3), torch.tensor(1e9), torch.zeros(512), tc.core,
                      tc.camera)
    assert isinstance(out, ttr.TryVelOut) and len(out) == 5
    score, JtJ, JtF, res, mif = out
    assert out.JtJ is JtJ and out.match_id_forward is mif
    assert JtJ.shape == (3, 3) and JtF.shape == (3,) and res.shape == mif.shape == (512,)


def check_pack_target_fields():
    (jem, tem), _ = _maps()
    got = t2n(ttr.pack_target_fields(tem))
    want = np.asarray(jtr.pack_target_fields(jem))
    assert got.shape == want.shape == (512, 8)
    np.testing.assert_array_equal(got, want)
    # raster_att's planes 2..7: the id, then the packed fields gathered at it
    ids = np.random.RandomState(3).randint(-1, 512, 120 * 188).astype(np.int32)
    att = t2n(ttr.raster_att(tem, torch.as_tensor(ids)))
    np.testing.assert_array_equal(att[:2], 0.0)
    np.testing.assert_array_equal(att[2], ids.astype(np.float32))
    np.testing.assert_array_equal(att[3:], want[np.clip(ids, 0, 511)][:, :5].T)


CASES = {
    "smooth": check_smooth,
    **{f"{name}-{case}": (lambda name=name, case=case: check_solve(name, case))
       for name in ("svd_solve", "gj_solve") for case in ("pd", "singular", "nan")},
    "svd_solve-rank_deficient": lambda: check_solve("svd_solve", "rank_deficient"),
    "empty_imu_frame": check_empty_imu_frame,
    "TryVelOut": check_try_vel_out,
    "pack_target_fields": check_pack_target_fields,
}


@pytest.mark.parametrize("case", list(CASES))
def test_public_helper_matches_jax(case):
    CASES[case]()


# JAX names with no counterpart of the same name, by design (ROADMAP Queue
# 1): the Pallas kernels (ops/kernels.py and csrc/ hold theirs) and the mesh
# placement helpers (the port's take a torch.distributed group)
HELD_BY_DESIGN = {
    "ops/pallas_kernels.py": None,                  # the whole module
    "ba/distributed.py": {"make_distributed_optimize", "place"},
    "parallel/keyline_shard.py": {"make_kl_mesh"},
}


def _public_defs(path: Path) -> set:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


def test_public_names_have_counterparts():
    missing = {}
    for jf in sorted((REPO / "rebvio_tpu").rglob("*.py")):
        rel = jf.relative_to(REPO / "rebvio_tpu").as_posix()
        pf = REPO / "rebvio_tpu_torch" / rel
        miss = _public_defs(jf) - (_public_defs(pf) if pf.exists() else set())
        held = HELD_BY_DESIGN.get(rel, set())
        miss = set() if held is None else miss - held
        if miss:
            missing[rel] = sorted(miss)
    assert missing == {}
