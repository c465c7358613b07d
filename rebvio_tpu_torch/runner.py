"""Host-side sequence runner (rebvio_tpu/runner.py, streaming mode): per
frame, the IMU samples with ts <= frame ts are packed into the fixed
buffer (the drain rule of rebvio.cpp:77-84), the raw frame is undistorted
and gained on the device (``camera.Undistorter``; ``undistort=False``
only casts and gains frames that arrive undistorted), and the step runs
on the device."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.camera import Undistorter
from rebvio_tpu_torch.configs import PipelineConfig
from rebvio_tpu_torch.ops.imu import pack_imu_window
from rebvio_tpu_torch.pipeline import frontend_matrices, stack_odometry, step


@dataclasses.dataclass
class RunResult:
    ts_us: np.ndarray        # [N]
    orientation: np.ndarray  # [N,3]
    position: np.ndarray     # [N,3]
    num_matches: np.ndarray  # [N]
    run_ok: np.ndarray       # [N] bool


class VioRunner:
    def __init__(self, config: PipelineConfig, undistort: bool = True, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.undistorter = (Undistorter(config.camera, config.image_gain, self.device)
                            if undistort else None)
        self.mats = frontend_matrices(config, self.device)
        self.state = T.init_vio_state(config, self.device)
        self._last_ts: Optional[int] = None
        self._imu_cursor = 0

    def reset(self):
        self.state = T.init_vio_state(self.config, self.device)
        self._last_ts = None
        self._imu_cursor = 0

    def process_frame(self, image, ts_us: int, imu_ts, imu_gyro, imu_acc) -> T.Odometry:
        """Process one frame given the entire IMU stream; the runner keeps a
        cursor and consumes the samples with ts <= frame ts."""
        c = j = self._imu_cursor
        while j < len(imu_ts) and imu_ts[j] <= ts_us:
            j += 1
        window = pack_imu_window(imu_gyro[c:j], imu_acc[c:j], imu_ts[c:j],
                                 self.config.imu.sample_max, self.device)
        self._imu_cursor = j
        frame_dt = 0.0 if self._last_ts is None else (ts_us - self._last_ts) / 1e6
        self._last_ts = ts_us
        raw = torch.as_tensor(image).to(self.device)
        if self.undistorter is not None:
            img = self.undistorter(raw)
        else:
            img = raw.to(torch.float32) * self.config.image_gain
        self.state, odo = step(self.state, img, window, frame_dt, self.config, self.mats)
        return odo

    def run(self, seq) -> RunResult:
        """Run a synthetic/EuRoC Sequence object end to end, one step per
        frame; the odometry is read back once at the end."""
        ts, odos = [], []
        for i in range(len(seq.images)):
            odos.append(self.process_frame(seq.images[i], int(seq.ts_us[i]), seq.imu_ts_us,
                                           seq.imu_gyro, seq.imu_acc))
            ts.append(int(seq.ts_us[i]))
        o = stack_odometry(odos)
        return RunResult(ts_us=np.asarray(ts), orientation=o.orientation.cpu().numpy(),
                         position=o.position.cpu().numpy(),
                         num_matches=o.num_matches.cpu().numpy(),
                         run_ok=o.run_ok.cpu().numpy())
