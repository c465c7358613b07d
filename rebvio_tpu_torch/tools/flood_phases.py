"""Where the time of K1's and K1b's kernels (csrc/flood.cu) goes, phase by
phase.

    python -m rebvio_tpu_torch.tools.flood_phases

Builds a copy of csrc/flood.cu with ``%globaltimer`` stamps (block start, each
long pass's end and the grid sync after it, the first tile's load, steps and
planes, block end; for K1b also its kernel's start and the end of the grid
syncs after its winner plane's clear and its atomics) into
``build/flood_phases/``, runs K1 on random seeds and K1b on a random table of
16000 keylines (positions over the 480x752 image, a quarter of them on the
cells of others, a tenth gated out) at the parity field (240x376) at search
ranges 5, 10, 20 and 40, checks each against its plain version
(``att_flood_plain``, ``att_field_plain``: all eight planes), and prints per
kernel and search range the time per call (CUDA events over back-to-back
calls) and, for each stamp, (min, median, max) over the blocks in
microseconds from the earliest block start (K1b: from its kernel's start).
The card's name and power limit are printed first.  Needs a GPU and nvcc.
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
          "planes_done", "end", "k1b_start", "k1b_cleared", "k1b_seeded")
# (anchor in csrc/flood.cu, text put before it) for the instrumented copy;
# stamp k goes to column k of the block's row.  The stamps sit in the flood
# body that K1's and K1b's kernels share; only K1's is launched here
_K1 = "__global__ void __launch_bounds__(kThreads)\n    att_flood_kernel"
_PROBES = (
    ("namespace {\n", "__device__ unsigned long long g_stamps[4096][16];\n"
                      "__device__ __forceinline__ void stamp(int k) {\n"
                      "  unsigned long long t;\n"
                      "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
                      "  if (threadIdx.x == 0) g_stamps[blockIdx.x][k] = t;\n}\n"),
    ("  // buf: (sy, sx)", "  stamp(15);\n"),
    ("      grid.sync();\n", "      if (k < 3) stamp(k);\n"),
    ("    }\n  }\n  const bool from_seeds", "      if (k < 3) stamp(3 + k);\n"),
    ("    int m = H, cur = 0;", "    if (t == blockIdx.x) stamp(6);\n"),
    ("    for (int e = threadIdx.x; e < kTile * kTile;", "    if (t == blockIdx.x) stamp(7);\n"),
    ("  }\n}\n\n" + _K1, "    if (t == blockIdx.x) stamp(8);\n"),
    ("}\n\n" + _K1, "  stamp(9);\n"),
    ("  cg::grid_group grid = cg::this_grid();\n  const int t0", "  stamp(10);\n"),
    ("  for (int i = t0; i < g.B * K; i += nt) {", "  stamp(11);\n"),
    ("  flood(TableSeeds{", "  stamp(12);\n"),
)


def instrumented_source() -> str:
    src = (_build.CSRC / "flood.cu").read_text()
    for anchor, text in _PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"flood_phases: anchor {anchor!r} not found once in csrc/flood.cu")
        src = src.replace(anchor, text + anchor)
    return src + ("\nextern \"C\" int rk_stamps(unsigned long long* host) {\n"
                  "  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));\n}\n"
                  "extern \"C\" int rk_stamps_clear() {\n"
                  "  void* p = nullptr;\n"
                  "  if (cudaGetSymbolAddress(&p, g_stamps) != cudaSuccess) return 1;\n"
                  "  return (int)cudaMemset(p, 0, sizeof(g_stamps));\n}\n")


def build():
    out = _build.BUILD_DIR.parent / "flood_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flood_phases.cu").write_text(instrumented_source())
    so = out / "libflood_phases.so"
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                        "-o", str(so), str(out / "flood_phases.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.rk_att_flood.argtypes = _build._SIGNATURES["rk_att_flood"]
    lib.rk_att_flood_max_blocks.argtypes = []
    lib.rk_att_field.argtypes = _build._SIGNATURES["rk_att_field"]
    lib.rk_att_field_max_blocks.argtypes = []
    lib.rk_stamps.argtypes = [ctypes.c_void_p]
    lib.rk_stamps_clear.argtypes = []
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


def random_table(rng, K: int, dev):
    """(pos, grad, use) of K keylines over the 480x752 image: a quarter of
    them on the cells of others, a tenth gated out."""
    pos = np.stack([rng.uniform(0, 2 * COLS, K), rng.uniform(0, 2 * ROWS, K)], -1)
    q = K // 4
    pos[K - q:] = pos[:q] + rng.uniform(-0.4, 0.4, (q, 2))
    return (torch.as_tensor(pos.astype(np.float32)).to(dev),
            torch.as_tensor(rng.normal(0, 100, (K, 2)).astype(np.float32)).to(dev),
            torch.as_tensor(rng.rand(K) < 0.9).to(dev))


def measure(lib, call, t0_col: int) -> dict:
    """Time per call over CALLS back-to-back calls, then one call's stamps:
    per stamp (min, median, max) over the blocks, microseconds from the
    earliest stamp in column ``t0_col``."""
    for _ in range(5):
        call()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(CALLS):
        call()
    b.record()
    b.synchronize()
    stamps = np.zeros((4096, 16), np.uint64)
    if lib.rk_stamps_clear() != 0:
        raise RuntimeError("flood_phases: clearing the stamps failed")
    call()
    torch.cuda.synchronize()
    if lib.rk_stamps(ctypes.c_void_p(stamps.ctypes.data)) != 0:
        raise RuntimeError("flood_phases: reading the stamps failed")
    s = stamps[stamps[:, t0_col] > 0].astype(np.int64)     # the blocks of that call
    t0 = s[:, t0_col].min()
    phases = {}
    for k, name in enumerate(STAMPS):
        v = (s[s[:, k] >= t0, k] - t0) / 1e3
        if len(v):
            phases[name] = [float(v.min()), float(np.median(v)), float(v.max())]
    return dict(blocks=len(s), us_per_call=a.elapsed_time(b) * 1e3 / CALLS,
                phases_us_min_median_max=phases)


def main() -> dict:
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print("card:", card.stdout.strip().splitlines()[0] if card.returncode == 0 else "unknown")
    lib = build()
    limit, limit_b = lib.rk_att_flood_max_blocks(), lib.rk_att_field_max_blocks()
    rng = np.random.RandomState(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    K = 16000
    pos, grad, use = random_table(rng, K, dev)
    report = {}
    for sr in (5, 10, 20, 40):
        stack = random_stack(rng, sr, 0.05, dev)
        pad, _ = kernels.flood_layout(ROWS, sr)
        steps, n_long, n_short, halo = kernels._flood_args(sr, pad)
        scratch = torch.empty((7 * ROWS * COLS,), dtype=torch.float32, device=dev)
        out = torch.empty((8, ROWS * COLS), dtype=torch.float32, device=dev)

        def k1():
            err = lib.rk_att_flood(ctypes.c_void_p(stack.data_ptr()),
                                   ctypes.c_void_p(scratch.data_ptr()),
                                   ctypes.c_void_p(out.data_ptr()), 1, ROWS, COLS, pad, sr,
                                   2.0, steps, n_long, n_short, halo, limit, stream)
            if err:
                raise RuntimeError(f"flood_phases: K1's launch failed with cudaError {err}")

        def k1b():
            err = lib.rk_att_field(ctypes.c_void_p(pos.data_ptr()),
                                   ctypes.c_void_p(grad.data_ptr()),
                                   ctypes.c_void_p(use.data_ptr()), K, 0.5,
                                   ctypes.c_void_p(scratch.data_ptr()),
                                   ctypes.c_void_p(out.data_ptr()), 1, ROWS, COLS, pad, sr,
                                   2.0, steps, n_long, n_short, halo, limit_b, stream)
            if err:
                raise RuntimeError(f"flood_phases: K1b's launch failed with cudaError {err}")

        for name, call, t0_col, plain in (
                ("K1", k1, 15, lambda: kernels.att_flood_plain(stack, sr, ROWS, COLS, 2)),
                ("K1b", k1b, 10, lambda: kernels.att_field_plain(pos, grad, use, 2 * sr,
                                                                  2 * ROWS, 2 * COLS, 2))):
            call()
            torch.cuda.synchronize()
            exact = bool(torch.equal(out.view(torch.int32), plain().view(torch.int32)))
            report[f"{name} sr {sr}"] = rec = dict(steps=list(steps), long_steps=n_long,
                                                   exact=exact, **measure(lib, call, t0_col))
            print(f"{name} search range {sr}: {rec}", flush=True)
    return report


if __name__ == "__main__":
    main()
