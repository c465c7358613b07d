"""EuRoC-shaped synthetic streams made from a seed: distorted uint8 frames
on the device and an exact 200 Hz IMU on the host.

The scene, the trajectory, the rad-tan model and the IMU synthesis are a
frozen numpy copy of ``rebvio_tpu_torch/data/synthetic.py`` (``generate``):
a cloud of 3-D line segments, a smooth analytic camera path with
MAV-like excitation, gyro = body rates and accelerometer = specific force
in the IMU frame.  The rendering (``_splat`` there: every segment sampled
along its 3-D length, each sample splatted with a 4x4 Gaussian kernel) runs
here on the device for all frames at once, summing the splats in 2^-32
fixed point so that the same seed gives the same bytes on every run; the
numpy version sums in float32 in order, so the two agree to rounding
(``tests/test_frames.py``).  Frames are rounded to uint8, as EuRoC's MONO8
camera and the program's own streaming inputs are.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

FIXED_ONE = float(1 << 32)      # the splat sum's fixed point
SPLAT_CHUNK_POINTS = 1 << 22    # samples splatted at once (x16 taps)
RENDER_CHUNK_FRAMES = 32        # frames rendered at once


@dataclasses.dataclass
class Stream:
    """One sequence: frames [N, H, W] uint8 on the device, timestamps and the
    IMU on the host (as a recorded EuRoC sequence hands them over)."""

    images: torch.Tensor    # [N,H,W] uint8
    ts_us: np.ndarray       # [N] int64
    imu_ts_us: np.ndarray   # [M] int64
    imu_gyro: np.ndarray    # [M,3] float32, IMU frame
    imu_acc: np.ndarray     # [M,3] float32, IMU frame


def rng_for(seed: int, *words: int) -> np.random.RandomState:
    """A RandomState for (seed, words...): any seed, 64-bit and beyond."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), *words]).generate_state(1)[0]
    return np.random.RandomState(int(state))


# ---------------------------------------------------------------------------
# frozen copy of rebvio_tpu_torch/data/synthetic.py and camera.py


def distort_normalized(cam, x: np.ndarray, y: np.ndarray):
    """Forward rad-tan distortion of normalized coords (OpenCV model)."""
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return xd, yd


def make_segments(rng: np.random.RandomState, n: int = 260) -> np.ndarray:
    """Random 3-D line segments in a box in front of the start pose: [n,2,3]."""
    segs = []
    for _ in range(n):
        c = np.array(
            [rng.uniform(-6, 6), rng.uniform(-4, 4), rng.uniform(2.0, 14.0)]
        )
        if rng.rand() < 0.75:
            d = np.zeros(3)
            d[rng.randint(3)] = 1.0
        else:
            d = rng.randn(3)
            d /= np.linalg.norm(d)
        L = rng.uniform(0.8, 4.0)
        segs.append([c - d * L / 2, c + d * L / 2])
    return np.asarray(segs)


def trajectory(t: np.ndarray, speed: float = 0.35, yaw_amp: float = 0.06,
               excitation: float = 1.0):
    """Smooth analytic camera trajectory.  Returns (pos[N,3], R_wc[N,3,3],
    vel[N,3], acc[N,3], omega_body[N,3])."""
    ax_, ay_ = 0.35, 0.22
    wx_, wy_ = 0.9 * excitation, 0.7 * excitation
    pos = np.stack([ax_ * np.sin(wx_ * t), ay_ * np.sin(wy_ * t + 0.5), speed * t], axis=-1)
    vel = np.stack([ax_ * wx_ * np.cos(wx_ * t), ay_ * wy_ * np.cos(wy_ * t + 0.5),
                    np.full_like(t, speed)], axis=-1)
    acc = np.stack([-ax_ * wx_ * wx_ * np.sin(wx_ * t),
                    -ay_ * wy_ * wy_ * np.sin(wy_ * t + 0.5), np.zeros_like(t)], axis=-1)
    yaw = yaw_amp * np.sin(0.8 * t)
    pitch = 0.5 * yaw_amp * np.sin(0.6 * t + 0.3)
    dyaw = yaw_amp * 0.8 * np.cos(0.8 * t)
    dpitch = 0.5 * yaw_amp * 0.6 * np.cos(0.6 * t + 0.3)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    N = len(t)
    R_wc = np.zeros((N, 3, 3))
    for i in range(N):
        Ry = np.array([[cy[i], 0, sy[i]], [0, 1, 0], [-sy[i], 0, cy[i]]])
        Rx = np.array([[1, 0, 0], [0, cp[i], -sp[i]], [0, sp[i], cp[i]]])
        R_wc[i] = Ry @ Rx
    omega = np.zeros((N, 3))
    for i in range(N):
        Ry = np.array([[cy[i], 0, sy[i]], [0, 1, 0], [-sy[i], 0, cy[i]]])
        w_w = np.array([0.0, dyaw[i], 0.0]) + Ry @ np.array([dpitch[i], 0.0, 0.0])
        omega[i] = R_wc[i].T @ w_w
    return pos, R_wc, vel, acc, omega


def imu_stream(cam, n_frames: int, fps: float, imu_rate: float, t0: float,
               imu_preroll_s: float, gravity, speed: float, excitation: float,
               yaw_amp: float):
    """(imu_ts_us, gyro, acc): the exact IMU of ``generate`` over the frames'
    span, starting ``imu_preroll_s`` before the first frame."""
    n_imu = int((n_frames / fps + imu_preroll_s) * imu_rate)
    ti = np.arange(n_imu) / imu_rate - imu_preroll_s + t0
    _, R_wc_i, _, acc_i, omega_i = trajectory(ti, speed=speed, yaw_amp=yaw_amp,
                                              excitation=excitation)
    g = np.asarray(gravity)
    R_c2i = np.asarray(cam.R_c2i, dtype=np.float32).reshape(3, 3).astype(np.float64)
    gyro = np.zeros((len(ti), 3))
    accm = np.zeros((len(ti), 3))
    for k in range(len(ti)):
        f_cam = R_wc_i[k].T @ (acc_i[k] - g)
        gyro[k] = R_c2i @ omega_i[k]
        accm[k] = R_c2i @ f_cam
    imu_ts_us = (ti * 1e6).astype(np.int64) + 1_000_000
    return imu_ts_us, gyro.astype(np.float32), accm.astype(np.float32)


# ---------------------------------------------------------------------------
# the device renderer


def render(segs: np.ndarray, pos: np.ndarray, R_wc: np.ndarray, cam, device,
           distort: bool, bg: float = 25.0, fg: float = 235.0,
           width: float = 1.4) -> torch.Tensor:
    """``synthetic.render_frame`` for every pose at once: [N, H, W] float32
    intensities on ``device``."""
    H, W = cam.rows, cam.cols
    d64 = dict(dtype=torch.float64, device=device)
    fx, fy = (cam.fm, cam.fm) if distort else (cam.fx, cam.fy)
    S = torch.as_tensor(segs, **d64)                       # [S,2,3]
    P = torch.as_tensor(pos, **d64)                        # [N,3]
    R = torch.as_tensor(R_wc, **d64)                       # [N,3,3]
    N = P.shape[0]
    # camera-frame endpoints: R_cw @ (x - pos)
    rel = S[None] - P[:, None, None, :]                    # [N,S,2,3]
    pc = torch.einsum("nji,nskj->nski", R, rel)
    pa, pb = pc[:, :, 0], pc[:, :, 1]
    za, zb = pa[..., 2:3], pb[..., 2:3]
    tcut = (0.3 - za) / (zb - za)
    cut = pa + tcut * (pb - pa)
    pa_c = torch.where(za < 0.3, cut, pa)
    pb_c = torch.where((zb < 0.3) & (za >= 0.3), cut, pb)
    ua = torch.stack([fx * pa_c[..., 0] / pa_c[..., 2] + cam.cx,
                      fy * pa_c[..., 1] / pa_c[..., 2] + cam.cy], -1)
    ub = torch.stack([fx * pb_c[..., 0] / pb_c[..., 2] + cam.cx,
                      fy * pb_c[..., 1] / pb_c[..., 2] + cam.cy], -1)
    length = torch.linalg.norm(ub - ua, dim=-1)
    keep = ~((za < 0.3) & (zb < 0.3))[..., 0] & (length >= 1.0)
    n = torch.where(keep, torch.clamp(length * 2.0, max=4000.0).floor(),
                    torch.zeros_like(length)).to(torch.int64)           # [N,S]
    counts = n.reshape(-1).cpu()
    acc = torch.zeros(N * H * W, dtype=torch.int64, device=device)
    ends = torch.cumsum(counts, 0)
    first = 0
    while first < counts.numel():
        # a run of (frame, segment) pairs holding at most SPLAT_CHUNK_POINTS samples
        base = int(ends[first - 1]) if first else 0
        last = int(torch.searchsorted(ends, base + SPLAT_CHUNK_POINTS, right=True))
        last = max(last, first + 1)
        _splat_chunk(acc, n.reshape(-1)[first:last], first, pa_c.reshape(-1, 3),
                     pb_c.reshape(-1, 3), S.shape[0], cam, fx, fy, distort, width, H, W)
        first = last
    stroke = torch.clamp((acc.to(torch.float64) / FIXED_ONE).to(torch.float32) / 1.2, 0.0, 1.0)
    return (bg + (fg - bg) * stroke).reshape(N, H, W)


def _splat_chunk(acc, n, first: int, pa, pb, n_segs: int, cam, fx, fy, distort: bool,
                 width: float, H: int, W: int) -> None:
    """Splat the samples of (frame, segment) pairs ``first ..`` (``n``
    samples each) into ``acc`` [N*H*W] int64 fixed point."""
    dev = acc.device
    pair = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n) + first
    if pair.numel() == 0:
        return
    offs = torch.cumsum(n, 0) - n
    k = torch.arange(pair.numel(), device=dev) - offs[pair - first]
    nk = n[pair - first].to(torch.float64)
    # numpy.linspace(0, 1, n): k * (1 / (n - 1)), the last sample exactly 1
    t = torch.where(k == nk.to(torch.int64) - 1, 1.0, k.to(torch.float64) * (1.0 / (nk - 1.0)))
    a, b = pa[pair], pb[pair]
    if distort:
        p3 = a + t[:, None] * (b - a)
        xd, yd = distort_normalized(cam, p3[:, 0] / p3[:, 2], p3[:, 1] / p3[:, 2])
        px, py = fx * xd + cam.cx, fy * yd + cam.cy
    else:
        ua = torch.stack([fx * a[:, 0] / a[:, 2] + cam.cx, fy * a[:, 1] / a[:, 2] + cam.cy], -1)
        ub = torch.stack([fx * b[:, 0] / b[:, 2] + cam.cx, fy * b[:, 1] / b[:, 2] + cam.cy], -1)
        p2 = ua + t[:, None] * (ub - ua)
        px, py = p2[:, 0], p2[:, 1]
    inb = (px > -3) & (px < W + 3) & (py > -3) & (py < H + 3)
    frame = torch.div(pair, n_segs, rounding_mode="floor")
    px, py, frame = px[inb], py[inb], frame[inb]
    x0, y0 = torch.floor(px), torch.floor(py)
    fxp, fyp = px - x0, py - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    for dy in (-1, 0, 1, 2):
        for dx in (-1, 0, 1, 2):
            wgt = torch.exp(-(((dx - fxp) ** 2 + (dy - fyp) ** 2)) / (width * width))
            xx, yy = x0 + dx, y0 + dy
            ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            idx = (frame * H + yy) * W + xx
            acc.index_add_(0, idx[ok], torch.round(wgt[ok] * FIXED_ONE).to(torch.int64))


def make_stream(cam, scene: dict, n_frames: int, seed: int, lane: int, device) -> Stream:
    """One sequence of ``n_frames`` from (seed, lane): its own segment cloud
    and a start time on the trajectory, both drawn from the seed.  ``scene``:
    the traffic file's generator parameters."""
    rng = rng_for(seed, lane)
    segs = make_segments(rng, scene["segments"])
    t0 = rng.uniform(0.0, scene["start_time_max_s"])
    fps = scene["fps"]
    tf = t0 + np.arange(n_frames) / fps
    traj = dict(speed=scene["speed"], yaw_amp=scene["yaw_amp"], excitation=scene["excitation"])
    pos, R_wc, _, _, _ = trajectory(tf, **traj)
    images = torch.cat([
        torch.clamp(torch.round(render(segs, pos[a:a + RENDER_CHUNK_FRAMES],
                                       R_wc[a:a + RENDER_CHUNK_FRAMES], cam, device,
                                       distort=scene["distort"])), 0, 255).to(torch.uint8)
        for a in range(0, n_frames, RENDER_CHUNK_FRAMES)])
    imu_ts, gyro, acc = imu_stream(cam, n_frames, fps, scene["imu_rate"], t0,
                                   scene["imu_preroll_s"], tuple(scene["gravity"]), **traj)
    ts_us = (tf * 1e6).astype(np.int64) + 1_000_000
    return Stream(images=images, ts_us=ts_us, imu_ts_us=imu_ts, imu_gyro=gyro, imu_acc=acc)


def streams(cam, scene: dict, n_frames: int, seed: int, lanes: int, device) -> Tuple[Stream, ...]:
    """``lanes`` sequences of ``n_frames`` each, lane ``b`` from (seed, b)."""
    return tuple(make_stream(cam, scene, n_frames, seed, b, device) for b in range(lanes))
