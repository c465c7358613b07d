"""Inter-frame IMU integration, the acceleration history estimators and the
host-side IMU window packing (rebvio_tpu/ops/imu.py; imu.hpp:35-151,
core.cpp:284-346).

The incremental add()/get() accumulation of the reference becomes one
masked reduction over the fixed [S] sample buffer; the inter-frame rotation
is the ordered product of the per-sample exponentials, taken as a log-depth
pairwise product of batched [S,3,3] matmuls."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vio_bench.reference import types as T
from vio_bench.reference import so3

f32 = torch.float32


def integrate_imu(data: T.ImuFrameData, R_c2i: torch.Tensor,
                  t_c2i: torch.Tensor) -> T.IntegratedImu:
    """Integrate one inter-frame sample buffer (imu.hpp:51-94).

    Gyro/acc are rotated into the camera frame sample by sample; the
    inter-frame rotation is R = prod_i exp(gyro_c_i * dt_i), invalid
    samples contributing the identity.  The product is taken pairwise
    (5 levels for S = 32): only the last prefix of JAX's associative scan
    is used, and this is the same product in another association."""
    S = data.gyro.shape[0]
    n = data.n
    dev = data.gyro.device
    valid = torch.arange(S, device=dev) < n
    gyro_c = data.gyro @ R_c2i  # == (R_c2i^T @ g_i)^T rows
    acc_c = data.acc @ R_c2i

    nf = torch.clamp(n.to(f32), min=1.0)
    gyro_mean = torch.sum(torch.where(valid[:, None], gyro_c, 0.0), dim=0) / nf
    acc_mean = torch.sum(torch.where(valid[:, None], acc_c, 0.0), dim=0) / nf

    eye = torch.eye(3, dtype=f32, device=dev)
    dRs = torch.where(valid[:, None, None], so3.exp(gyro_c * data.dt[:, None]), eye)
    while dRs.shape[0] > 1:
        if dRs.shape[0] % 2:
            dRs = torch.cat([dRs, eye[None]])
        dRs = dRs[0::2] @ dRs[1::2]
    R = dRs[0]

    dt_s = data.dt_interval
    # dgyro = R_c2i^T (gyro_last - gyro_init) / dt_s (imu.hpp:85), only n > 1
    first = data.gyro[0]
    # the last sample by index_select: indexing by a 0-d device tensor would
    # read the index back to the host
    last_i = torch.clamp(n.to(torch.int64) - 1, 0, S - 1).reshape(1)
    last = torch.index_select(data.gyro, 0, last_i)[0]
    dt_safe = torch.where(dt_s > 0, dt_s, 1.0)
    dgyro = torch.where(n > 1, (R_c2i.T @ (last - first)) / dt_safe, 0.0)
    # lever-arm compensation (imu.hpp:88)
    cacc = acc_mean + torch.linalg.cross(dgyro, -(R_c2i.T @ t_c2i))
    # n == 0: identity rotation and zeros (the JAX package's clean definition)
    empty = n == 0
    return T.IntegratedImu(
        R=torch.where(empty, eye, R),
        gyro=torch.where(empty, 0.0, gyro_mean),
        acc=torch.where(empty, 0.0, acc_mean),
        dgyro=dgyro,
        cacc=torch.where(empty, 0.0, cacc),
        dt_s=dt_s,
    )


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


def imu_words(sample_max: int) -> int:
    """float32 words of one packed IMU window: gyro [S,3], acc [S,3], dt [S],
    n (int32 bits), dt_interval."""
    return 7 * sample_max + 2


def pack_imu_host(out: np.ndarray, gyro, acc, ts_us, sample_max: int) -> None:
    """Fill ``out`` (float32 [imu_words]) with one inter-frame IMU window:
    per-sample dt with the first sample's dt fixed at 0.005 s (imu.hpp:54-58)
    and the interval dt by integer-microsecond extrapolation
    (last-init)/(n-1)*n (imu.hpp:81).  Host only: the runner packs into a
    pinned staging slot and uploads it with one non-blocking copy."""
    S = sample_max
    out[:] = 0.0
    g = out[:3 * S].reshape(S, 3)
    a = out[3 * S:6 * S].reshape(S, 3)
    d = out[6 * S:7 * S]
    n = min(len(ts_us), S)
    dt_interval_us = 0
    if n > 0:
        g[:n] = gyro[:n]
        a[:n] = acc[:n]
        d[0] = 0.005
        if n > 1:
            d[1:n] = (ts_us[1:n] - ts_us[: n - 1]).astype(np.float64) / 1e6
            dt_interval_us = int(ts_us[n - 1] - ts_us[0]) // (n - 1) * n
    out[7 * S:7 * S + 1].view(np.int32)[0] = n
    out[7 * S + 1] = dt_interval_us / 1e6


def imu_window_view(block: torch.Tensor, sample_max: int) -> T.ImuFrameData:
    """ImuFrameData as views of packed windows ``block`` (float32
    [..., imu_words]; a leading axis stacks windows): no copy, no kernel."""
    S = sample_max
    lead = tuple(block.shape[:-1])
    return T.ImuFrameData(
        gyro=block[..., :3 * S].reshape(lead + (S, 3)),
        acc=block[..., 3 * S:6 * S].reshape(lead + (S, 3)),
        dt=block[..., 6 * S:7 * S],
        n=block[..., 7 * S].view(torch.int32),
        dt_interval=block[..., 7 * S + 1],
    )


def pack_imu_window(gyro, acc, ts_us, sample_max: int, device="cuda") -> T.ImuFrameData:
    """One inter-frame IMU window as ImuFrameData on ``device``
    (``pack_imu_host``, then one upload from pageable memory)."""
    dev = torch.device(device)
    block = np.empty((imu_words(sample_max),), np.float32)
    pack_imu_host(block, gyro, acc, ts_us, sample_max)
    return imu_window_view(torch.from_numpy(block).to(dev), sample_max)
