"""Where the time of K1's kernel (csrc/flood.cu) goes, phase by phase.

    python -m rebvio_tpu_torch.tools.flood_phases

Builds a copy of csrc/flood.cu with ``%globaltimer`` stamps (block start, each
long pass's end and the grid sync after it, the first tile's load, steps and
planes, block end) into ``build/flood_phases/``, runs it on random seeds at
the parity field (240x376) at search ranges 5, 10, 20 and 40, checks it
against ``att_flood_plain`` (all eight planes), and prints per search range
the time per call (CUDA events over back-to-back calls) and, for each stamp,
(min, median, max) over the blocks in microseconds from the earliest block
start.  The card's name and power limit are printed first.  Needs a GPU and
nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch.ops import _build, kernels

ROWS, COLS = 240, 376
CALLS = 300
STAMPS = ("pass1", "pass2", "pass3", "sync1", "sync2", "sync3", "tile_loaded", "steps_done",
          "planes_done", "end")
# (anchor in csrc/flood.cu, text put before it) for the instrumented copy;
# stamp k goes to column k of the block's row
_PROBES = (
    ("namespace {\n", "__device__ unsigned long long g_stamps[4096][16];\n"
                      "__device__ __forceinline__ void stamp(int k) {\n"
                      "  unsigned long long t;\n"
                      "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
                      "  if (threadIdx.x == 0) g_stamps[blockIdx.x][k] = t;\n}\n"),
    ("  // buf: (sy, sx)", "  stamp(15);\n"),
    ("      grid.sync();\n", "      if (k < 3) stamp(k);\n"),
    ("    }\n  }\n  const bool from_stack", "      if (k < 3) stamp(3 + k);\n"),
    ("    int m = H, cur = 0;", "    if (t == blockIdx.x) stamp(6);\n"),
    ("    for (int e = threadIdx.x; e < kTile * kTile;", "    if (t == blockIdx.x) stamp(7);\n"),
    ("  }\n}\n\n}  // namespace", "    if (t == blockIdx.x) stamp(8);\n"),
    ("}\n\n}  // namespace", "  stamp(9);\n"),
)


def instrumented_source() -> str:
    src = (_build.CSRC / "flood.cu").read_text()
    for anchor, text in _PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"flood_phases: anchor {anchor!r} not found once in csrc/flood.cu")
        src = src.replace(anchor, text + anchor)
    return src + ("\nextern \"C\" int rk_stamps(unsigned long long* host) {\n"
                  "  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n")


def build():
    out = _build.BUILD_DIR.parent / "flood_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flood_phases.cu").write_text(instrumented_source())
    so = out / "libflood_phases.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                        str(out / "flood_phases.cu")], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.rk_att_flood.argtypes = _build._SIGNATURES["rk_att_flood"]
    lib.rk_att_flood_max_blocks.argtypes = []
    lib.rk_stamps.argtypes = [ctypes.c_void_p]
    print("ptxas:", [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                     if "Used" in ln or "spill" in ln])
    return lib


def random_stack(rng, sr: int, density: float, dev) -> torch.Tensor:
    pad, Rp = kernels.flood_layout(ROWS, sr)
    st = np.zeros((5, Rp, COLS), np.float32)
    st[0] = st[1] = 1e9
    st[2] = -1.0
    ys, xs = np.nonzero(rng.rand(ROWS, COLS) < density)
    st[0, ys, xs] = ys + rng.uniform(-0.5, 0.5, len(ys))
    st[1, ys, xs] = xs + rng.uniform(-0.5, 0.5, len(xs))
    st[2, ys, xs] = rng.permutation(len(ys))
    st[3, ys, xs] = rng.normal(0, 100, len(ys))
    st[4, ys, xs] = rng.normal(0, 100, len(ys))
    return torch.as_tensor(st.reshape(5 * Rp, COLS)).to(dev)


def main() -> dict:
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip().splitlines()[0] if card.returncode == 0 else "unknown")
    lib = build()
    limit = lib.rk_att_flood_max_blocks()
    rng = np.random.RandomState(0)
    report = {}
    for sr in (5, 10, 20, 40):
        stack = random_stack(rng, sr, 0.05, dev)
        pad, _ = kernels.flood_layout(ROWS, sr)
        steps, n_long, n_short, halo = kernels._flood_args(sr, pad)
        state = torch.empty((2, 3, ROWS * COLS), dtype=torch.float32, device=dev)
        out = torch.empty((8, ROWS * COLS), dtype=torch.float32, device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

        def call():
            err = lib.rk_att_flood(ctypes.c_void_p(stack.data_ptr()),
                                   ctypes.c_void_p(state.data_ptr()),
                                   ctypes.c_void_p(out.data_ptr()), ROWS, COLS, pad, sr, 2.0,
                                   steps, n_long, n_short, halo, limit, stream)
            if err:
                raise RuntimeError(f"flood_phases: launch failed with cudaError {err}")

        for _ in range(5):
            call()
        torch.cuda.synchronize()
        exact = bool(torch.equal(out.view(torch.int32), kernels.att_flood_plain(
            stack, sr, ROWS, COLS, 2).view(torch.int32)))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(CALLS):
            call()
        b.record()
        b.synchronize()
        stamps = np.zeros((4096, 16), np.uint64)
        call()
        torch.cuda.synchronize()
        if lib.rk_stamps(ctypes.c_void_p(stamps.ctypes.data)) != 0:
            raise RuntimeError("flood_phases: reading the stamps failed")
        s = stamps[stamps[:, 15] > 0].astype(np.int64)     # the blocks of the last call
        t0 = s[:, 15].min()
        phases = {}
        for k, name in enumerate(STAMPS):
            v = (s[s[:, k] >= t0, k] - t0) / 1e3
            if len(v):
                phases[name] = [float(v.min()), float(np.median(v)), float(v.max())]
        report[sr] = dict(steps=list(steps), long_steps=n_long, blocks=len(s),
                          us_per_call=a.elapsed_time(b) * 1e3 / CALLS, exact=exact,
                          phases_us_min_median_max=phases)
        print(f"search range {sr}: {report[sr]}", flush=True)
    return report


if __name__ == "__main__":
    main()
