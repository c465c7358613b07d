"""What decides ``correct``: sampled steps of the timed path held to the
plain reference.

The program's state is a filter carried from frame to frame, and two
float32 implementations of it drift apart over a sequence by the rounding
of thousands of keyline decisions, so a whole trajectory has no sharp
limit.  The check follows the program step by step instead: for each
sampled (frame, lane), the program's state before the step (its own, as
the timed path left it) goes to the reference, which works the step out
again from the raw inputs (the distorted uint8 frame, the IMU stream, the
timestamps); the step's odometry and every leaf of the state after it are
compared with what the timed path produced for that step.  The first frame
of a stream starts from the reference's own initial state, so the start is
checked by itself.

Every leaf belongs to one number (``GROUPS``; a test holds that the groups
cover ``spec.leaves`` of the state whole), and a number is the largest gap
of its leaves.  A leaf's gap, by its kind:

    mm       |program - reference|, mm (the position)
    chord    the orientation, |Ra - Rb|_F / sqrt(2), urad: the chord of the
             angle between, exact near 0 where an arccos of a float32 trace
             is not; the odometry's rotation vector goes through exp first
             (and is held to the log of its own step's R_global, which is
             held to the reference's: harness.reference_numbers)
    rel      |a - b| / max(|b|, 1) for counts, / |b| for a scalar
    norm     |a - b|_F over the larger of |b|_F and the median |.|_F of the
             number's leaves (a filter's leaves, some all but zero)
    dist     a keyline array as a distribution: per column, the mean gap
             between the 1st..99th percentiles of the two maps' valid
             keylines, over the reference's mean |value|; keylines are not
             compared slot by slot, since one keyline gained or lost early
             in raster order shifts every later slot
    planes   the field's attribute planes, each as a distribution over its
             cells, as ``dist``
    occ      a keyline id image: the share of pixels whose occupancy
             (id >= 0) differs
    exact    counters and flags: 1 where they differ

A NaN or infinity where the other side has none reads as infinity, and
adds 1 to ``exact_gap`` besides, whose limit is 0.

Each number is judged twice over a run's sampled steps:

* ``<number>``: the 90th percentile (``STEP_QUANTILE``, a sampled value)
  over the tracking steps, those after a stream's first frame: of 12 live
  steps the 11th smallest, of 32 fleet steps (four a lane) the 29th.  K2
  sums its Gram in another order than its plain version, and on about one
  step in 500 that moves one step by up to 0.045 mm, as far as the TF32
  control moves some steps: a rounding difference, not a fault.  The
  percentile passes one such step (up to three of 32) and fails what
  touches more: every step, a state left unchanged, one lane's tracking
  (four of 32).
* ``<number>.worst``: the largest over every sampled step, the first
  frames too, judged where the control's smallest worst step stands 30
  times or more above the worst sound step seen in any cell (K2's
  rare step has a long tail), with a limit a third of the control's: a
  gross gap on a single step fails it, and a NaN or an infinity fails
  ``exact_gap.worst``.

A cell whose product is more than a VIO step (a map, a trajectory refined
after the fact) holds it to a plain reference by product checks of its
traffic loop (``harness.Outcome.products``).  The loop declares the names
of their numbers (``harness.loop_numbers``); each is summarized like a step
number over the items the checks return, ``<number>`` and
``<number>.worst``, and judged by the cell file's limits.  A limit that
no step and no product check gives a number for fails."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

STEP_QUANTILE = 0.9
QUANTILES = np.linspace(0.01, 0.99, 99)
WORST = ".worst"

# number -> ((leaf, kind), ...); "odometry." leaves are the step's output
# record, the others the state after the step (spec.leaves)
GROUPS = {
    "pose_gap_mm": (("odometry.position", "mm"), ("Pos", "mm")),
    "rot_gap_urad": (("R_global", "chord"), ("odometry.orientation", "chord")),
    "scale_gap": (("K", "rel"), ("P_Kp", "rel")),
    "matches_gap": (("odometry.num_matches", "rel"),),
    "keylines_gap": (("edge_map.count", "rel"), ("keylines_count", "rel"),
                     ("edge_map.valid", "rel")),
    "depth_gap": (("edge_map.rho", "dist"),),
    "sigma_gap": (("edge_map.sigma_rho", "dist"),),
    "frontend_gap": (("edge_map.pos", "dist"), ("edge_map.pos_img", "dist"),
                     ("edge_map.grad", "dist"), ("edge_map.grad_norm", "dist"),
                     ("edge_map.id_prev", "dist"), ("edge_map.id_next", "dist"),
                     ("edge_map.kl_id_img", "occ"), ("edge_map.threshold", "rel"),
                     ("detector_threshold", "rel")),
    "field_gap": (("edge_map.att_img", "planes"),),
    "match_gap": (("edge_map.match_pos_img", "dist"), ("edge_map.match_grad", "dist"),
                  ("edge_map.match_grad_norm", "dist"), ("edge_map.match_id", "dist"),
                  ("edge_map.match_id_forward", "dist"), ("edge_map.match_id_keyframe", "dist"),
                  ("edge_map.matches", "dist")),
    "sab_gap": (("sab_state.X", "norm"), ("sab_state.P", "norm"), ("sab_state.g_est", "norm"),
                ("sab_state.b_est", "norm")),
    "imu_gap": tuple((f"imu_state.{k}", "norm") for k in (
        "Bg", "W_Bg", "RGBias", "u_est", "gyro_init_acc", "g_init_acc", "vel_hist", "dt_hist",
        "acc_hist")),
    "exact_gap": (("num_frames", "exact"), ("frames_seen", "exact"), ("run_ok", "exact"),
                  ("odometry.run_ok", "exact"), ("imu_state.initialized", "exact"),
                  ("imu_state.num_gyro_init", "exact")),
}
NUMBERS = tuple(GROUPS)
ODOMETRY = ("orientation", "position", "num_matches", "run_ok")


def np_(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _finite_or(a: np.ndarray, b: np.ndarray) -> Optional[float]:
    """None where both sides are finite; else 0 where they are equal NaN for
    NaN, infinity where not."""
    if np.all(np.isfinite(a)) and np.all(np.isfinite(b)):
        return None
    return 0.0 if a.shape == b.shape and np.array_equal(a, b, equal_nan=True) else math.inf


def _exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues, in float64."""
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + math.sin(th) / th * K + (1 - math.cos(th)) / th ** 2 * K @ K


def _columns(a: np.ndarray, b: np.ndarray) -> float:
    """The largest over columns of the mean gap between the 1st..99th
    percentiles of ``a`` and ``b`` (rows are samples), over the mean |b|."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return 0.0 if a.shape[0] == b.shape[0] else math.inf
    bad = _finite_or(a, b)
    if bad is not None:
        return bad
    qa, qb = np.quantile(a, QUANTILES, axis=0), np.quantile(b, QUANTILES, axis=0)
    scale = np.maximum(np.mean(np.abs(b), axis=0), 1e-12)
    return float(np.max(np.mean(np.abs(qa - qb), axis=0) / scale))


def leaf_gap(kind: str, a, b, valid_a=None, valid_b=None, floor: float = 0.0) -> float:
    """One leaf's gap by its ``kind`` (module docstring)."""
    counted = not np.issubdtype(np.asarray(b).dtype, np.floating)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if kind == "dist":
        rows = lambda x, v: x[v].reshape(int(v.sum()), int(np.prod(x.shape[1:])))  # noqa: E731
        return _columns(rows(a, valid_a), rows(b, valid_b))
    if kind == "planes":
        return _columns(a.reshape(a.shape[0], -1).T, b.reshape(b.shape[0], -1).T)
    if kind == "occ":
        return float(np.mean((a >= 0) != (b >= 0)))
    bad = _finite_or(a, b)
    if bad is not None:
        return bad
    if kind == "exact":
        return float(not np.array_equal(a, b))
    if kind == "mm":
        return float(np.linalg.norm(a - b)) * 1e3
    if kind == "chord":
        if a.shape == (3,):
            a, b = _exp(a), _exp(b)
        return float(np.linalg.norm(a - b) / math.sqrt(2.0)) * 1e6
    if kind == "rel":
        if a.ndim:                              # a mask: its count
            a, b = np.sum(a), np.sum(b)
        return abs(float(a) - float(b)) / max(abs(float(b)), 1.0 if counted else 1e-12)
    if kind == "norm":
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor, 1e-12))
    raise ValueError(f"unknown kind {kind!r}")


def step_numbers(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The numbers of one step: ``prog`` / ``ref`` as ``record`` gives them."""
    va, vb = (x["edge_map.valid"].astype(bool) for x in (prog, ref))
    out = {}
    for name, leaves in GROUPS.items():
        norms = [np.linalg.norm(np.asarray(ref[k], np.float64)) for k, kind in leaves
                 if kind == "norm"]
        floor = float(np.median(norms)) if norms else 0.0
        out[name] = max(leaf_gap(kind, prog[k], ref[k], va, vb, floor) for k, kind in leaves)
    # a NaN or an infinity on one side only is never rounding
    out["exact_gap"] += sum(1 for k, v in out.items() if k != "exact_gap" and math.isinf(v))
    return out


def record(odometry: Dict[str, object], state: Dict[str, object]) -> Dict[str, np.ndarray]:
    """One step's outputs on the host: the odometry's fields as
    ``odometry.<field>`` and the state's leaves (``spec.leaves``)."""
    out = {f"odometry.{k}": np_(odometry[k]) for k in ODOMETRY}
    out.update({k: np_(v) for k, v in state.items()})
    return out


def summarize(per_step: List[Dict[str, float]], tracking: Sequence[bool],
              names: Sequence[str] = NUMBERS) -> Dict[str, float]:
    """Each of ``names``' STEP_QUANTILE over the tracking steps (a sampled
    value, numpy's "higher" method; infinity sorts last) and, as
    ``<number>.worst``, its largest over every step.  A number that no step
    gives is left out (its limit, if any, then fails: ``verdict``)."""
    tracked = [s for s, t in zip(per_step, tracking) if t] or per_step
    out = {}
    for k in names:
        xs = [s[k] for s in tracked if k in s]
        if xs:
            out[k] = float(np.quantile(xs, STEP_QUANTILE, method="higher"))
            out[k + WORST] = float(max(s[k] for s in per_step if k in s))
    return out


def summarize_all(per_step: List[Dict[str, float]], tracking: Sequence[bool],
                  per_product: List[Dict[str, float]], products: Sequence[str]
                  ) -> Dict[str, float]:
    """The step numbers (``summarize``) and, summarized the same way over
    every item a product check returned, the loop's declared ``products``."""
    out = summarize(per_step, tracking)
    out.update(summarize(per_product, [True] * len(per_product), products))
    return out


def all_limits(cell: dict) -> Dict[str, float]:
    """A cell file's limits by the name of the number they hold:
    ``limits`` on the percentiles, ``worst_limits`` on the worst steps."""
    out = dict(cell["limits"])
    out.update({k + WORST: v for k, v in cell.get("worst_limits", {}).items()})
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limit met by its number (a number without a limit is reported,
    not judged; a limit without a number fails: a check that stopped
    producing its number cannot pass)."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())


def lines(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> Dict[str, list]:
    """name -> [number, limit] for the result line and standard error; a
    limit that no number met reads [None, limit]."""
    out = {k: [numbers[k], limits.get(k)] for k in numbers}
    out.update({k: [None, lim] for k, lim in limits.items() if k not in numbers})
    return out
