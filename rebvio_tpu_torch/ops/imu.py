"""The acceleration history estimators and the host-side IMU window packing
(rebvio_tpu/ops/imu.py; core.cpp:284-346, imu.hpp:54-81).  The estimate
step calls both estimators in vision-only mode too; the inter-frame IMU
integration belongs to the VIO path."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rebvio_tpu_torch import types as T


def estimate_ls4_acceleration(vel, R, dt, vel_hist, dt_hist):
    """5-point least-squares slope of the rotated velocity history
    (core.cpp:284-332).  vel_hist rows = [V, V0, V1, V2, V3].
    Returns (acc, new_vel_hist, new_dt_hist)."""
    rot = vel_hist @ R
    new_hist = torch.cat([vel[None, :], rot[:4]], dim=0)
    new_dt = torch.cat([dt_hist[1:], dt.reshape(1)])
    Tt = torch.cat([torch.zeros((1,), dtype=torch.float32, device=vel.device),
                    torch.cumsum(new_dt, 0)])
    mt = torch.sum(Tt[1:]) / 5.0
    den = torch.sum((Tt - mt) * (Tt - mt))
    tw = torch.flip(Tt, (0,)) - mt
    vm = torch.mean(new_hist, dim=0)
    num = torch.sum((new_hist - vm[None, :]) * tw[:, None], dim=0)
    acc = torch.where(den > 0, num / den, torch.zeros_like(num))
    return acc, new_hist, new_dt


def estimate_mean_acceleration(sacc, R, acc_hist) -> Tuple[torch.Tensor, torch.Tensor]:
    """4-frame rotated running mean of the compensated acceleration
    (core.cpp:334-346).  acc_hist rows = [A, A0, A1, A2]."""
    rot = acc_hist @ R
    new_hist = torch.cat([sacc[None, :], rot[:3]], dim=0)
    return 0.25 * torch.sum(new_hist, dim=0), new_hist


def pack_imu_window(gyro, acc, ts_us, sample_max: int, device="cpu") -> T.ImuFrameData:
    """One inter-frame IMU window as ImuFrameData: per-sample dt with the
    first sample's dt fixed at 0.005 s (imu.hpp:54-58) and the interval dt
    by integer-microsecond extrapolation (last-init)/(n-1)*n (imu.hpp:81)."""
    n = len(ts_us)
    g = np.zeros((sample_max, 3), np.float32)
    a = np.zeros((sample_max, 3), np.float32)
    d = np.zeros((sample_max,), np.float32)
    dt_interval_us = 0
    if n > 0:
        n = min(n, sample_max)
        g[:n] = gyro[:n]
        a[:n] = acc[:n]
        d[0] = 0.005
        if n > 1:
            d[1:n] = (ts_us[1:n] - ts_us[: n - 1]).astype(np.float64) / 1e6
            dt_interval_us = int(ts_us[n - 1] - ts_us[0]) // (n - 1) * n
    return T.ImuFrameData(
        gyro=torch.as_tensor(g, device=device),
        acc=torch.as_tensor(a, device=device),
        dt=torch.as_tensor(d, device=device),
        n=torch.tensor(n, dtype=torch.int32, device=device),
        dt_interval=torch.tensor(dt_interval_us / 1e6, dtype=torch.float32, device=device),
    )
