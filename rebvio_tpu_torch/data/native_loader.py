"""ctypes binding of the native prefetching image loader, ``native/loader.cpp``
(rebvio_tpu/data/native_loader.py): N worker threads decode 8-bit grayscale
PNGs ahead of the consumer through the C ABI ``rebvio_loader_open`` /
``_next`` / ``_close``.

The library is built from ``native/loader.cpp`` at first use with ``g++
-O3 -fPIC -std=c++17 -shared ... -lz -lpthread`` into ``build/rebvio_loader/``
(git-ignored), named by a hash of the source and flags; ``native/`` is never
written.  A failed build raises with the compiler's message (``available()``
answers False instead, for the "auto" choice of data/euroc.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "loader.cpp"
BUILD_DIR = REPO / "build" / "rebvio_loader"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lz", "-lpthread")
BUILD_INFO = {"seconds": None, "path": None}

_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None


def load_library() -> ctypes.CDLL:
    """The loaded loader library, built first if needed; raises RuntimeError
    with the compiler's output when the build fails."""
    global _LIB, _ERROR
    if _LIB is not None:
        return _LIB
    if _ERROR is not None:
        raise RuntimeError(_ERROR)
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"librebvio_loader_{h.hexdigest()[:16]}.so"
    t0 = time.time()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            out = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            _ERROR = f"native loader: g++ could not run: {e}"
            raise RuntimeError(_ERROR) from e
        if out.returncode != 0:
            _ERROR = f"native loader: building {SOURCE.name} failed:\n{out.stdout}"
            raise RuntimeError(_ERROR)
        tmp.replace(so)
    lib = ctypes.CDLL(str(so))
    lib.rebvio_loader_open.restype = ctypes.c_void_p
    lib.rebvio_loader_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.rebvio_loader_next.restype = ctypes.c_int
    lib.rebvio_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int)]
    lib.rebvio_loader_close.restype = None
    lib.rebvio_loader_close.argtypes = [ctypes.c_void_p]
    BUILD_INFO.update(seconds=time.time() - t0, path=str(so))
    _LIB = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load_library()
    except RuntimeError:
        return False
    return True


class NativeImageLoader:
    """Threaded prefetching PNG loader; yields float32 [rows, cols] frames with
    ``gain`` applied (the reference's convertTo(x3.0), rebvio.cpp:43)."""

    def __init__(self, paths: List[str], rows: int, cols: int, n_threads: int = 2,
                 ring: int = 8, gain: float = 1.0):
        self._lib = load_library()
        self.rows, self.cols = rows, cols
        self._paths = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        self._h = self._lib.rebvio_loader_open(self._paths, len(paths), n_threads, ring,
                                               ctypes.c_float(gain))
        self._buf = np.zeros((rows * cols,), np.float32)
        self.n = len(paths)

    def __len__(self):
        return self.n

    def __iter__(self):
        while True:
            f = self.next()
            if f is None:
                return
            yield f

    def next(self) -> Optional[np.ndarray]:
        """The next frame, None at the end of the sequence."""
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.rebvio_loader_next(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(w), ctypes.byref(h))
        if rc == 0:
            return None
        if rc < 0:
            raise IOError("native loader: decode failed")
        if h.value != self.rows or w.value != self.cols:
            raise ValueError(f"frame size {h.value}x{w.value} != {self.rows}x{self.cols}")
        return self._buf.reshape(self.rows, self.cols).copy()

    def close(self):
        if self._h:
            self._lib.rebvio_loader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
