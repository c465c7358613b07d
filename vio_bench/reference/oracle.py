"""The reference's entry points: its configuration from a deployment file,
its initial state, and one step from raw sensor inputs (the distorted
uint8 frame, the IMU stream and the frame timestamps), with the runner's
input rules worked out again here: undistortion and gain, the IMU samples
with ``prev_ts < ts <= frame ts`` (all up to the first frame's ts on the
first frame), the frame interval (0 on the first frame).

``tf32()`` is the control: the same code with every float32 product's
operands rounded to TF32 (10 mantissa bits), as the tensor cores compute
a product when TF32 is allowed; the configurations state float32 with
TF32 off."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from vio_bench import spec
from vio_bench.reference import camera, configs, imu, pipeline, types as T


def build_config(pipeline_dict: dict) -> configs.PipelineConfig:
    return spec.build(configs.PipelineConfig, pipeline_dict)


def init_state(config: configs.PipelineConfig, device) -> T.VioState:
    return T.init_vio_state(config, device)


def state_from(flat: Dict[str, torch.Tensor]) -> T.VioState:
    """A VioState from tensors by dotted field path (``spec.leaves``)."""
    return spec.from_leaves(T.VioState, flat)


def imu_window(stream, prev_ts: Optional[int], ts: int, sample_max: int, device):
    """The packed IMU window of the frame at ``ts`` after the frame at
    ``prev_ts`` (None: the first frame of the stream)."""
    its = np.asarray(stream.imu_ts_us)
    lo = 0 if prev_ts is None else int(np.searchsorted(its, prev_ts, side="right"))
    hi = int(np.searchsorted(its, ts, side="right"))
    return imu.pack_imu_window(stream.imu_gyro[lo:hi], stream.imu_acc[lo:hi], its[lo:hi],
                               sample_max, device=device)


class Reference:
    """One step of the plain reference on ``device``."""

    def __init__(self, config: configs.PipelineConfig, device):
        self.config = config
        self.device = torch.device(device)
        self.undistorter = camera.Undistorter(config.camera, config.image_gain, self.device)
        self.mats = pipeline.frontend_matrices(config, self.device)

    def step(self, state: T.VioState, stream, i: int, first: bool):
        """Frame ``i`` of ``stream`` from ``state``; ``first``: the first frame
        the runner takes from this stream (no previous frame, dt 0).
        Returns (state', odometry)."""
        ts = int(stream.ts_us[i])
        prev = None if first else int(stream.ts_us[i - 1])
        win = imu_window(stream, prev, ts, self.config.imu.sample_max, self.device)
        dt = 0.0 if first else (ts - prev) / 1e6
        raw = torch.as_tensor(np.asarray(stream.images[i])).to(self.device)
        with float32_products():
            frame = self.undistorter(raw)
            return pipeline.step(state, frame, win, dt, self.config, self.mats)


@contextlib.contextmanager
def float32_products():
    """The configurations' precision, whatever the process set: float32
    matrix products, TF32 off (the flags are restored after)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


_PRODUCTS = {torch.matmul, torch.mm, torch.bmm, torch.einsum, torch.linalg.matmul,
             torch.Tensor.matmul, torch.Tensor.mm, torch.Tensor.bmm,
             torch.Tensor.__matmul__, torch.Tensor.__rmatmul__}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (ties to even)."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF    # the bits, unsigned
    b = ((b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000) & 0xFFFFFFFF
    b = torch.where(b >= 1 << 31, b - (1 << 32), b)
    out = b.to(torch.int32).view(torch.float32).view(x.shape)
    return torch.where(torch.isfinite(x), out, x)


class tf32(TorchFunctionMode):
    """Inside it every float32 operand of a matrix product is rounded to
    TF32 first."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(round_tf32(a) if torch.is_tensor(a) and a.dtype == torch.float32
                         else a for a in args)
        return func(*args, **kwargs)
