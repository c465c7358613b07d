"""Trajectory evaluation: Umeyama alignment, ATE/RPE, odometry file I/O.

The reference's regression contract is bitwise trajectory equality against a
committed golden file (ros_rebvio/test/test_ros_rebvio.cpp:37-43); as laid
out in SURVEY.md section 4, the TPU build grades by ATE bound instead, since
XLA float32 will not bit-match TooN.  The odometry text format matches the
reference's logger: "ts ox oy oz px py pz" with 6 decimals
(rebvio.cpp:279-286).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform aligning src -> dst: (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale and var_s > 0 else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est: np.ndarray, gt: np.ndarray, align: bool = True, with_scale: bool = True
) -> float:
    """Absolute trajectory error (RMSE) after optional Umeyama alignment."""
    if align:
        s, R, t = umeyama(est, gt, with_scale=with_scale)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


def rpe_rmse(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation drift) error over a frame delta."""
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    return float(np.sqrt(np.mean(np.sum((de - dg) ** 2, axis=-1))))


def write_odometry(path: str, ts_us: np.ndarray, orientation: np.ndarray, position: np.ndarray):
    """Reference-format odometry log (rebvio.cpp:279-286)."""
    with open(path, "w") as f:
        for i in range(len(ts_us)):
            f.write(
                f"{int(ts_us[i])} "
                f"{orientation[i][0]:.6f} {orientation[i][1]:.6f} {orientation[i][2]:.6f} "
                f"{position[i][0]:.6f} {position[i][1]:.6f} {position[i][2]:.6f}\n"
            )


def read_odometry(path: str):
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    return data[:, 0].astype(np.int64), data[:, 1:4], data[:, 4:7]
