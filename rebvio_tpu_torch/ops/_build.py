"""Builds the CUDA kernels of ``csrc/`` into one shared library with a
plain C interface and loads it with ctypes.

The library is built at first use from the sources in the checkout into
``build/rebvio_kernels/`` (git-ignored), one ``nvcc`` per source, all
started together, then linked; the sources share ``csrc/*.cuh``.
``--fmad=false`` keeps ``a*b + c`` as two rounded operations, as on the
CPU: the flood's tie-breaks and the gates' thresholds then see the same
float32 values as the plain versions.  The library file is named by a hash
of the sources, the headers and the flags, so a rebuilt checkout never
loads a stale one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rebvio_kernels"
SOURCES = ("flood.cu", "try_vel.cu", "tube_match.cu", "reg_ekf.cu", "sab.cu",
           "seed_scatter.cu", "nn_flood.cu", "chol_inverse.cu", "band_matmul.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
BUILD_INFO = {"seconds": None, "path": None, "ptxas": ""}

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    "rk_att_flood": [P, P, P, I, I, I, I, I, F, P, I, I, I, I, P],
    "rk_att_flood_max_blocks": [],
    "rk_att_field": [P, P, P, I, F, P, P, I, I, I, I, I, F, P, I, I, I, I, P],
    "rk_att_field_max_blocks": [],
    "rk_minimize_vel": [P] * 8 + [I] * 6 + [F] * 6 + [I] + [P] * 4 + [I, P],
    "rk_minimize_vel_blocks": [I],
    "rk_minimize_vel_max_blocks": [],
    "rk_minimize_vel_lanes_max": [],
    "rk_minimize_vel_items_max": [],
    "rk_tube_match": [P] * 4 + [I] * 7 + [F] * 3 + [P, P],
    "rk_match_reg_ekf": [P, P, I, I, I] + [F] * 6 + [P],
    "rk_reg_ekf": [P, P, I, I] + [F] * 4 + [P],
    "rk_estimate_bias": [P] * 9 + [I] + [P] * 4 + [I, P],
    "rk_seed_winner": [P, P, I, F, I, I, P, P],
    "rk_nn_cluster_occupancy": [I] * 5,
    "rk_nn_cluster": [P] * 3 + [I] * 10 + [P],
    "rk_chol_inverse": [P, P, I, I, P],
    "rk_band_matmul": [P, L, P, P, P, I, P, P, I, I, I, I, I, I, P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load():
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / name for name in SOURCES] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    tag = h.hexdigest()[:16]
    so = BUILD_DIR / f"librebvio_kernels_{tag}.so"
    t0 = time.time()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name in SOURCES:
            obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        logs, objs = [], []
        for obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {obj.name}:\n{out}")
            objs.append(str(obj))
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, so)
        (BUILD_DIR / f"ptxas_{tag}.log").write_text("".join(logs))
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    log = BUILD_DIR / f"ptxas_{tag}.log"
    BUILD_INFO.update(seconds=time.time() - t0, path=str(so),
                      ptxas=log.read_text() if log.exists() else "")
    _LIB = lib
    return lib
