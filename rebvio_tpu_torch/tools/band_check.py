"""The frontend's seven band-operator products on the card:
csrc/band_matmul.cu (``kernels.band_matmul``) against the dense product
``a @ b`` (cuBLAS) that the frontend ran before it, at the parity profile's
480x752 on the operands of real detections (frames of the seed-0 synthetic
sequence, one a lane).

    python -m rebvio_tpu_torch.tools.band_check [--lanes 8] [--out FILE]

For each product, one lane and ``--lanes`` lanes: the kernel against ``a @
b`` bit for bit (``torch.equal``; else the count of differing elements and
the largest difference); under ``torch.func.vmap`` (one launch over the
lanes) against one-lane launches and against each lane's ``a @ b``; the
kernel's time between CUDA events and its device time (``torch.profiler``)
beside its bound (least bytes over 3.35 TB/s, or float32 band operations
over 67 TFLOP/s) and beside the dense products' device time, one product a
lane as ``linalg.lane_matmul`` ran them; the dense product's device kernel
names.  One JSON line a product and lane count, then the totals.  Needs a
GPU; the card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch.configs import PipelineConfig
from rebvio_tpu_torch.data import synthetic
from rebvio_tpu_torch.geometry.linalg import lane_matmul
from rebvio_tpu_torch.ops import edge_detect, kernels
from rebvio_tpu_torch.pipeline import frontend_matrices
from rebvio_tpu_torch.tools.jfa_ab import device_us, time_us
from rebvio_tpu_torch.tools.roofline import bound_ms


def record_operands(mats, config: PipelineConfig, frames) -> dict:
    """{operator name: [B, ...] dense operands} of the detections of the B
    float ``frames``, in the frontend's order of products."""
    names = {id(band): name for name, band in mats.bands.items()}
    seen, plain = {}, kernels.band_matmul

    def recording(x, dense, band):
        seen.setdefault(names[id(band)], []).append(x.clone())
        return plain(x, dense, band)

    kernels.band_matmul = recording
    try:
        for frame in frames:
            thr = torch.full((), 0.01, dtype=torch.float32, device=frame.device)
            edge_detect.detect(frame, thr, mats, config.detector, config.camera,
                               field_scale=config.field_scale)
    finally:
        kernels.band_matmul = plain
    return {name: torch.stack(xs) for name, xs in seen.items()}


def parity_operands(lanes: int, device) -> tuple:
    """(matrices, operands) of ``lanes`` detections at the parity profile."""
    config = PipelineConfig()
    seq = synthetic.generate(config.camera, n_frames=lanes, seed=0)
    frames = [torch.as_tensor(im).to(device).to(torch.float32) * config.image_gain
              for im in seq.images]
    mats = frontend_matrices(config, device)
    return mats, record_operands(mats, config, frames)


def _dense(dense, band, x):
    return dense @ x if band.left else x @ dense


def _kernel_names(fn) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def band_counts(x: torch.Tensor, out_numel: int, band) -> tuple:
    """(bytes, operations) of a product: x and the band read once, the
    output written once; two operations a tap of every output."""
    return (4 * (x.numel() + out_numel + band.coef.numel() + band.k0.numel()),
            2 * out_numel * band.coef.shape[1])


def check(mats, operands: dict, lanes: int) -> list:
    """One record a product over the first ``lanes`` lanes of ``operands``
    (see the module docstring)."""
    vmap = torch.func.vmap
    rows = []
    for name, xs in operands.items():
        xs = xs[:lanes]
        dense, band = getattr(mats, name), mats.bands[name]
        want = torch.stack([_dense(dense, band, x) for x in xs])
        one = torch.stack([kernels.band_matmul(x, dense, band) for x in xs])
        got = vmap(lambda x: kernels.band_matmul(x, dense, band))(xs)
        # the lanes as rows of larger lanes (the step's left[:H]): a lane stride, no copy
        strided = torch.cat([xs, torch.zeros_like(xs)], dim=1)[:, :xs.shape[1]]
        got_strided = vmap(lambda x: kernels.band_matmul(x, dense, band))(strided)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        launch = (lambda: kernels.band_matmul(xs[0], dense, band)) if lanes == 1 else (
            lambda: vmap(lambda x: kernels.band_matmul(x, dense, band))(xs))
        per_lane = (lambda: _dense(dense, band, xs[0])) if lanes == 1 else (
            lambda: vmap(lambda x: lane_matmul(dense, x) if band.left
                         else lane_matmul(x, dense))(xs))
        ev_us, _wall = time_us(launch, calls=50)
        dev_us, acts = device_us(launch)
        dense_us, dense_acts = device_us(per_lane)
        bms, by = bound_ms(*band_counts(xs, want.numel(), band))
        rows.append(dict(
            product=name, left=band.left, lanes=lanes, operand=list(xs.shape[1:]),
            out=list(want.shape[1:]), taps=band.coef.shape[1], tiles=band.tiles.shape[0],
            bit_equal_dense=torch.equal(got, want), equal_one_lane_launches=torch.equal(got, one),
            one_lane_equal_dense=torch.equal(one, want),
            equal_strided_lanes=torch.equal(got_strided, got),
            differing=int((got != want).sum()), max_abs_diff=float(diff.max()),
            max_rel_diff=float(diff.max() / want.abs().max().clamp_min(1e-30)),
            kernel_ms_events=ev_us / 1e3, kernel_device_ms=dev_us / 1e3,
            kernel_device_activities=acts, bound_ms=bms, bound_by=by,
            dense_device_ms=dense_us / 1e3, dense_device_activities=dense_acts,
            dense_kernels=_kernel_names(lambda: _dense(dense, band, xs[0]))))
    return rows


def totals(rows: list) -> dict:
    keys = ("kernel_ms_events", "kernel_device_ms", "bound_ms", "dense_device_ms")
    out = {k: sum(r[k] for r in rows) for k in keys}
    out["bound_share_pct"] = 100.0 * out["bound_ms"] / out["kernel_device_ms"]
    out["not_bit_equal"] = [r["product"] for r in rows if not r["bit_equal_dense"]]
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("band_check needs a GPU (torch.cuda.is_available() is False)")
    dev = resolve_device("cuda")
    card = card_line()
    print("card:", card, flush=True)
    mats, operands = parity_operands(args.lanes, dev)
    result = {"card": card}
    lines = []
    for lanes in sorted({1, args.lanes}):
        rows = check(mats, operands, lanes)
        lines += [json.dumps(r) for r in rows]
        result[f"lanes_{lanes}"] = totals(rows)
        lines.append(json.dumps({"lanes": lanes, "card": card, **result[f"lanes_{lanes}"]}))
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return result


if __name__ == "__main__":
    main()
