"""Closed loop: a fleet of recorded sequences reprocessed together.

``lanes`` sequences, lane b made from (seed, b), go through
``VioRunner(config, undistort=True, batch=lanes).run_batched`` in sessions
of ``session_frames`` frames, back to back; ``VioRunner.reset()`` between
sessions starts the recorded sequences over, as a fleet does when it takes
its next logs.  Each session's poses reach the host when ``run_batched``
returns.  The window runs whole sessions until ``--seconds`` have passed;
its rate counts every lane's frames over the window's whole length.  A
frame whose pose comes back with tracking lost counts as failed.  One
session before the window (its first frame captures the batched step's
CUDA graph) is the warm-up.

Traffic keys: ``lanes``, ``session_frames``, ``check_sessions`` (the
window's first sessions; in the first, frame 0 of every lane is held to
the reference from the initial state, in each later one a frame drawn from
the seed at or after ``check_from_frame``: the session runs in three calls
around it), ``scene``
(frames.make_stream).  A ``--trace 1`` run profiles the session after
them."""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from vio_bench import check, frames, roofline, stats
from vio_bench.harness import Outcome, Sample, snapshot
from vio_bench.trace import Profile, Trace, span


def _lane(flat: dict, b: int) -> dict:
    return {k: v[b] for k, v in flat.items()}


def run(ctx) -> Outcome:
    from rebvio_tpu_torch.runner import VioRunner

    tr, cfg = ctx.traffic, ctx.config
    parts = {"start": time.perf_counter() - ctx.t_start}
    B, F = int(tr["lanes"]), int(tr["session_frames"])
    made = frames.streams(cfg.camera, tr["scene"], F, ctx.seed, B, ctx.device)
    seqs = [dataclasses.replace(s, images=s.images.cpu().numpy()) for s in made]
    del made
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    parts["frames"] = time.perf_counter() - ctx.t_start
    runner = VioRunner(cfg, undistort=True, device=ctx.device, batch=B)
    parts["runner"] = time.perf_counter() - ctx.t_start
    runner.run_batched(seqs)
    runner.reset()
    ctx.sync()
    # what set-up left is never collected in the window
    gc.collect()
    gc.freeze()
    out = Outcome()
    out.setup_s = time.perf_counter() - ctx.t_start

    n_check = int(tr["check_sessions"])
    plan = {0: 0, **{s: int(ctx.check_rng.randint(min(int(tr["check_from_frame"]), F - 1), F))
                     for s in range(1, n_check)}}
    trace_session = n_check if ctx.trace else None
    prof = Profile(ctx.device) if ctx.trace else None
    checked = []          # (frame, before, odometry rows, after)
    done = failed = 0
    s = 0
    session_s = []
    t0 = time.perf_counter()
    while s <= max(plan) or (trace_session is not None and s <= trace_session) \
            or time.perf_counter() - t0 < ctx.seconds:
        traced = s == trace_session
        t_s = time.perf_counter()
        if traced:
            prof.start()
        with span("session", traced):
            if s in plan:
                f = plan[s]
                pieces = [runner.run_batched(seqs, range(0, f))] if f else []
                before = snapshot(runner.state) if f else None
                mid = runner.run_batched(seqs, range(f, f + 1))
                checked.append((f, before, mid, snapshot(runner.state)))
                pieces.append(mid)
                if f + 1 < F:
                    pieces.append(runner.run_batched(seqs, range(f + 1, F)))
            else:
                pieces = [runner.run_batched(seqs)]
            runner.reset()
        if traced:
            prof.stop()
        session_s.append(time.perf_counter() - t_s)
        for res in pieces:
            failed += sum(int(np.sum(~r.run_ok)) for r in res)
        done += B * F
        s += 1
    window = time.perf_counter() - t0
    if ctx.device.type == "cuda":
        out.memory_peak_bytes = int(torch.cuda.max_memory_allocated(ctx.device))
    out.metrics = {"frames_per_s": stats.rate(done, window)}
    out.attempted, out.failed = done, failed
    out.notes = {"setup_parts_s": parts, "sessions": s, "frames": done, "window_s": window,
                 "lanes": B, "session_frames": F,
                 "session_s_quartiles": [stats.percentile(session_s, q)
                                         for q in (0, 25, 50, 75, 100)]}
    if ctx.trace:
        out.trace = Trace(prof, F, B, roofline.kernel_counts(ctx.cell.config["pipeline"]), {}, {})
    for f, before, mid, after in checked:
        for b in range(B):
            odo = {k: getattr(mid[b], k)[0] for k in check.ODOMETRY}
            out.samples.append(Sample(seqs[b], f, None if before is None else _lane(before, b),
                                      check.record(odo, _lane(after, b))))
    del runner
    return out
