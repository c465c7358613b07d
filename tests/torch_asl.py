"""Writers of EuRoC's ASL format for the port's tests and chip_smoke.py:
8-bit grayscale (and RGB) PNGs with any of the five row filters, and an ASL tree
(mav0/cam0 PNGs and data.csv, imu0, the ground truth) of a synthetic
sequence.  numpy and the standard library only: no JAX, no torch."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_FILTERS = (0, 1, 2, 3, 4)      # none, sub, up, avg, paeth


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png_gray(path, img: np.ndarray, filters=0, level: int = 6):
    """8-bit grayscale PNG of ``img`` [H, W] uint8 (an RGB one of [H, W, 3]):
    ``filters`` one row filter type for every row, or a sequence cycled
    over the rows.  Every predictor is taken from the image itself (the
    decoded bytes), so the rows are encoded at once."""
    H, W = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    kinds = np.array([filters] if isinstance(filters, int) else list(filters))
    ft = kinds[np.arange(H) % len(kinds)][:, None]
    x = img.reshape(H, W * ch).astype(np.int64)
    left = np.pad(x, ((0, 0), (ch, 0)))[:, :-ch]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(x, ((1, 0), (ch, 0)))[:-1, :-ch]
    pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                     [left, up, (left + up) >> 1, _paeth(left, up, upleft)], 0)
    raw = np.hstack([ft, (x - pred) % 256]).astype(np.uint8).tobytes()

    def chunk(typ, data):
        c = typ + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, {1: 0, 3: 2}[ch], 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, level)))
        f.write(chunk(b"IEND", b""))


def write_asl_tree(root, frames, seq, n: int, filters=PNG_FILTERS, level: int = 6):
    """An ASL tree under ``root`` of the first ``n`` uint8 ``frames`` at
    ``seq.ts_us``, ``seq``'s IMU stream and its ground-truth positions at
    the frames' times (identity orientation)."""
    root = Path(root)
    cam = root / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    with open(cam / "data.csv", "w") as f:
        f.write("#timestamp [ns],filename\n")
        for i in range(n):
            name = f"{int(seq.ts_us[i]) * 1000}.png"
            write_png_gray(cam / "data" / name, frames[i], filters, level)
            f.write(f"{int(seq.ts_us[i]) * 1000},{name}\n")
    (root / "mav0" / "imu0").mkdir(parents=True)
    with open(root / "mav0" / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for k in range(len(seq.imu_ts_us)):
            g, a = seq.imu_gyro[k], seq.imu_acc[k]
            f.write(f"{int(seq.imu_ts_us[k]) * 1000},{g[0]},{g[1]},{g[2]},{a[0]},{a[1]},{a[2]}\n")
    gt = root / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    with open(gt / "data.csv", "w") as f:
        f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
        for i in range(n):
            p = seq.gt_pos[i]
            f.write(f"{int(seq.ts_us[i]) * 1000},{p[0]},{p[1]},{p[2]},1,0,0,0\n")
