"""Logging setup mirroring the reference's spdlog wrapper (util/log.hpp:58-69;
rebvio_tpu/utils/logging.py): a console logger plus an optional odometry
file logger whose file name and format match the reference
(yyyy-mm-dd_hh-mm-ss_rebvio_odometry.txt, "ts ox oy oz px py pz" at 6
decimals, log.cpp:26-41, rebvio.cpp:279-286)."""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

_LOG = logging.getLogger("rebvio_tpu_torch")


def init(level: int = logging.INFO) -> logging.Logger:
    if not _LOG.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s"))
        _LOG.addHandler(h)
    _LOG.setLevel(level)
    return _LOG


def get() -> logging.Logger:
    return _LOG


class OdometryLogger:
    """Streaming odometry file writer in the reference's format."""

    def __init__(self, directory: str = ".", filename: Optional[str] = None):
        if filename is None:
            stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
            filename = f"{stamp}_rebvio_odometry.txt"
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, filename)
        self._f = open(self.path, "w")

    def write(self, ts_us: int, orientation, position) -> None:
        self._f.write(
            f"{int(ts_us)} "
            f"{orientation[0]:.6f} {orientation[1]:.6f} {orientation[2]:.6f} "
            f"{position[0]:.6f} {position[1]:.6f} {position[2]:.6f}\n"
        )

    def close(self) -> None:
        self._f.close()
