"""EuRoC MAV ASL-format sequence reader (rebvio_tpu/data/euroc.py), numpy
only:

    <root>/mav0/cam0/data.csv + data/<ts>.png
    <root>/mav0/imu0/data.csv
    <root>/mav0/state_groundtruth_estimate0/data.csv   (optional)

Timestamps go from ns to us (the reference works in us, image.hpp:19-22).
Frames decode either in process (``_read_png_gray``: PIL where it imports,
as the JAX package does, else ``_decode_png_numpy``, zlib and the five PNG
row filters in numpy) or through the native prefetch ring
(data/native_loader.py); all give uint8 frames, which the runner's staging
ring carries to the device as they are.
"""

from __future__ import annotations

import csv
import dataclasses
import os
import struct
import zlib
from typing import List, Optional

import numpy as np

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
NATIVE_DECODERS = 3     # the native ring's decoder threads
NATIVE_RING = 8         # and its slots


def _unfilter_row(ft: int, row: np.ndarray, prev: np.ndarray, ch: int) -> np.ndarray:
    """One PNG row (uint8) with its filter ``ft`` undone against the
    previous reconstructed row ``prev``."""
    if ft == 0:
        return row
    if ft == 1:     # sub: the running sum of each channel's bytes, modulo 256
        return (np.cumsum(row.reshape(-1, ch).astype(np.int64), axis=0) & 0xFF
                ).astype(np.uint8).reshape(-1)
    if ft == 2:     # up
        return ((row.astype(np.int64) + prev) & 0xFF).astype(np.uint8)
    out = row.astype(np.int64)
    up = prev.astype(np.int64)
    if ft == 3:     # avg
        for i in range(out.size):
            left = out[i - ch] if i >= ch else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    elif ft == 4:   # paeth
        for i in range(out.size):
            a = out[i - ch] if i >= ch else 0
            b = up[i]
            c = up[i - ch] if i >= ch else 0
            pp = a + b - c
            pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG filter type {ft}")
    return out.astype(np.uint8)


def _read_png_gray(path: str) -> np.ndarray:
    """A PNG as uint8 [H, W] (EuRoC's images are 8-bit gray), as
    rebvio_tpu/data/euroc.py:28-35 reads it: ``PIL.Image.open(path)
    .convert("L")`` first (an RGB file gives its luma), and where PIL does
    not import or fails on the file, ``_decode_png_numpy`` (an RGB file
    gives its first channel)."""
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("L"), dtype=np.uint8)
    except (ImportError, OSError):      # no PIL; a file PIL cannot read
        return _decode_png_numpy(path)


def _decode_png_numpy(path: str) -> np.ndarray:
    """8-bit PNG (gray, gray+alpha, RGB or RGBA, not interlaced) -> its first
    channel as uint8 [H, W], in numpy."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat = 8, []
    width = height = bit_depth = color_type = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            width, height, bit_depth, color_type = struct.unpack(">IIBB", chunk[:10])
            if chunk[12] != 0:
                raise ValueError(f"{path}: interlaced PNG")
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if bit_depth != 8 or color_type not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {bit_depth}, color type "
                         f"{color_type})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    ch = _CHANNELS[color_type]
    stride = width * ch
    img = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        off = r * (stride + 1)
        prev = img[r] = _unfilter_row(int(raw[off]), raw[off + 1:off + 1 + stride], prev, ch)
    return img.reshape(height, width, ch)[..., 0]


@dataclasses.dataclass
class EurocSequence:
    image_paths: List[str]
    ts_us: np.ndarray
    imu_ts_us: np.ndarray
    imu_gyro: np.ndarray
    imu_acc: np.ndarray
    gt_ts_us: Optional[np.ndarray] = None
    gt_pos: Optional[np.ndarray] = None
    # "native": the threaded C++ prefetch ring (native/loader.cpp); "python":
    # the in-process decoder; "auto": native when its library builds here
    loader: str = "auto"
    rows: int = 480
    cols: int = 752

    def __len__(self):
        return len(self.image_paths)

    def resolved_loader(self) -> str:
        """The decoder ``images`` uses: "native" or "python".  ``loader=
        "native"`` raises with the compiler's message if the library does not
        build."""
        if self.loader == "python":
            return "python"
        from rebvio_tpu_torch.data import native_loader

        if self.loader == "native":
            native_loader.load_library()
            return "native"
        if self.loader != "auto":
            raise ValueError(f"loader {self.loader!r}: auto, native or python")
        return "native" if native_loader.available() else "python"

    @property
    def images(self):
        """The frames as an indexable (what VioRunner.run reads): through
        the native prefetch ring, read in order from 0 (the runner's
        pattern), or the in-process decoder.  Memoized, so repeated reads
        share one ring."""
        cached = getattr(self, "_images_cache", None)
        if cached is None:
            cached = (_NativeSeqImages(self.image_paths, self.rows, self.cols)
                      if self.resolved_loader() == "native" else _LazyImages(self.image_paths))
            self._images_cache = cached
        return cached


class _LazyImages:
    """Frames decoded in process on access, uint8."""

    def __init__(self, paths):
        self.paths = paths

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        return _read_png_gray(self.paths[i])


class _NativeSeqImages:
    """In-order view of the native prefetch ring (NATIVE_DECODERS decoders
    run ahead of the consumer, the reference's acquisition thread and queue,
    rebvio.cpp:56-90).  Index 0 after a later index reopens the ring; any
    other out-of-order index decodes in process."""

    def __init__(self, paths, rows, cols):
        from rebvio_tpu_torch.data import native_loader

        self.paths = paths
        self._make = lambda: native_loader.NativeImageLoader(
            paths, rows, cols, n_threads=NATIVE_DECODERS, ring=NATIVE_RING, gain=1.0)
        self._ldr = None
        self._next_i = 0

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        if i == 0 and self._next_i != 0:
            if self._ldr is not None:
                self._ldr.close()
            self._ldr, self._next_i = None, 0
        if i != self._next_i:
            return _read_png_gray(self.paths[i])
        if self._ldr is None:
            self._ldr = self._make()
        self._next_i += 1
        f = self._ldr.next()
        if f is None:
            raise IndexError(i)
        # gain 1: exact integers in float32; uint8 to the device
        return f.astype(np.uint8)


def _rows(path: str):
    with open(path) as f:
        for row in csv.reader(f):
            if row and not row[0].startswith("#"):
                yield row


def load(root: str, start_s: Optional[float] = None, end_s: Optional[float] = None,
         loader: str = "auto", rows: int = 480, cols: int = 752) -> EurocSequence:
    """An ASL-format sequence; ``start_s`` / ``end_s``: a window in seconds
    from the first frame (the IMU from 100 ms before it); ``loader``:
    "native", "python" or "auto"."""
    mav = os.path.join(root, "mav0")
    img_ts, img_paths = [], []
    for row in _rows(os.path.join(mav, "cam0", "data.csv")):
        img_ts.append(int(row[0]) // 1000)
        img_paths.append(os.path.join(mav, "cam0", "data", row[1].strip()))
    imu_ts, gyro, acc = [], [], []
    for row in _rows(os.path.join(mav, "imu0", "data.csv")):
        imu_ts.append(int(row[0]) // 1000)
        gyro.append([float(x) for x in row[1:4]])
        acc.append([float(x) for x in row[4:7]])
    img_ts = np.asarray(img_ts, np.int64)
    imu_ts = np.asarray(imu_ts, np.int64)
    gyro = np.asarray(gyro, np.float32)
    acc = np.asarray(acc, np.float32)

    if start_s is not None or end_s is not None:
        t0 = img_ts[0]
        lo = t0 + int((start_s or 0) * 1e6)
        hi = t0 + int((end_s or 1e12) * 1e6)
        sel = (img_ts >= lo) & (img_ts <= hi)
        img_ts = img_ts[sel]
        img_paths = [p for p, s in zip(img_paths, sel) if s]
        seli = (imu_ts >= lo - 100_000) & (imu_ts <= hi)
        imu_ts, gyro, acc = imu_ts[seli], gyro[seli], acc[seli]

    gt_ts = gt_pos = None
    gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        # not named `rows`: that is the image height passed on below
        gt_rows = [[int(row[0]) // 1000] + [float(x) for x in row[1:4]] for row in _rows(gt_csv)]
        arr = np.asarray(gt_rows)
        gt_ts = arr[:, 0].astype(np.int64)
        gt_pos = arr[:, 1:4].astype(np.float32)

    return EurocSequence(image_paths=img_paths, ts_us=img_ts, imu_ts_us=imu_ts, imu_gyro=gyro,
                         imu_acc=acc, gt_ts_us=gt_ts, gt_pos=gt_pos, loader=loader, rows=rows,
                         cols=cols)
