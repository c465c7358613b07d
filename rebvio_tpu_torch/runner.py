"""Host-side sequence runner (rebvio_tpu/runner.py): per frame, the IMU
samples with ts <= frame ts are packed into the fixed buffer (the drain rule
of rebvio.cpp:77-84), the raw frame is undistorted and gained on the device
(``camera.Undistorter``; ``undistort=False`` only casts and gains frames
that arrive undistorted), and the step runs on the device.

On a CUDA device undistortion and the step are one CUDA graph, captured at
the first frame and replayed for every frame after it (``graph.py``), fed
from a pinned staging ring: ``run`` uploads frame i+1 before it replays
step i.  ``graph=False`` runs the same functions eagerly (the reference the
graph is held to); on the CPU they always run eagerly.  ``VioRunner(config,
batch=B)`` steps B sequences in lockstep (``run_batched``: the B frames of
one instant undistorted over the batch, ``parallel.batch.batched_step``, one
replay a batched frame).  Modes, as in the JAX
runner: streaming (``run``, ``process_frame``), exact chunks
(``run(seq, chunk=N)``: N steps in one replay), pipelined chunks
(``run(seq, chunk=N, pipelined=True)``: N detections at the chunk's
threshold, then N estimates, in one replay), paced (``run_realtime``) and
mapped (``run_mapped``: exact chunks that also emit the keyframe-map
builder's per-frame trace, read back once a chunk)."""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.camera import Undistorter
from rebvio_tpu_torch.configs import PipelineConfig
from rebvio_tpu_torch.graph import (ODO_WORDS, SlotLayout, StepProgram, np_dtype, copy_tree_,
                                    odometry_view, pack_trace, trace_words, unpack_trace)
from rebvio_tpu_torch.parallel.batch import batched_step, init_batched_state
from rebvio_tpu_torch.pipeline import (frontend_matrices, step_chunk, step_chunk_pipelined,
                                       step_chunk_traced)


# staging slots per program: run_realtime's default of 3 frames in flight,
# plus the one being packed
RING_SLOTS = 4
# what one replay of a program runs: exact chunks (streaming is a chunk of
# one), pipelined chunks, exact chunks with the mapping trace, one frame of
# each of B sequences (the slot's n frames are the B lanes)
MODES = {"exact": step_chunk, "pipelined": step_chunk_pipelined, "traced": step_chunk_traced,
         "batched": batched_step}


class _Feed:
    """One sequence's input cursor: the IMU samples since the last frame with
    ts <= the frame's ts (the drain rule of rebvio.cpp:77-84), and the frame
    interval."""

    def __init__(self):
        self.last_ts: Optional[int] = None
        self.cursor = 0

    def inputs(self, image, ts_us: int, imu_ts, imu_gyro, imu_acc):
        """(image, gyro, acc, ts, dt) of one frame."""
        c = j = self.cursor
        while j < len(imu_ts) and imu_ts[j] <= ts_us:
            j += 1
        self.cursor = j
        dt = 0.0 if self.last_ts is None else (ts_us - self.last_ts) / 1e6
        self.last_ts = ts_us
        return image, imu_gyro[c:j], imu_acc[c:j], imu_ts[c:j], dt


@dataclasses.dataclass
class RunResult:
    ts_us: np.ndarray        # [N]
    orientation: np.ndarray  # [N,3]
    position: np.ndarray     # [N,3]
    num_matches: np.ndarray  # [N]
    run_ok: np.ndarray       # [N] bool


@dataclasses.dataclass
class RealtimeResult:
    """run_realtime output: the processed frames' trajectory plus keep-up
    accounting (frames dropped by the bounded queue, worst completion
    latency behind the sensor deadline)."""
    result: RunResult
    frame_idx: np.ndarray    # [P] dataset indices of processed frames
    processed: int
    dropped: int
    worst_latency_s: float


def _result(ts, packed: torch.Tensor) -> RunResult:
    """RunResult from packed odometry rows (one readback)."""
    o = odometry_view(packed.cpu())
    return RunResult(ts_us=np.asarray(ts), orientation=o.orientation.numpy(),
                     position=o.position.numpy(), num_matches=o.num_matches.numpy(),
                     run_ok=o.run_ok.numpy())


class VioRunner:
    def __init__(self, config: PipelineConfig, undistort: bool = True, device="cuda",
                 graph: bool = True, batch: int = 0):
        """``graph``: on a CUDA device, capture and replay the step as one CUDA
        graph (False: run it eagerly).  ``batch`` > 0: a runner of ``batch``
        sequences in lockstep (``run_batched`` only), its state's leaves
        [batch, ...]."""
        self.config = config
        self.device = resolve_device(device)
        self.undistorter = (Undistorter(config.camera, config.image_gain, self.device)
                            if undistort else None)
        self.mats = frontend_matrices(config, self.device)
        self.graph = graph and self.device.type == "cuda"
        self.batch = batch
        self._init_state = (init_batched_state(config, batch, self.device) if batch else
                            T.init_vio_state(config, self.device))
        # with a graph, the static state: updated in place by every replay
        self.state = T.tree_map(torch.clone, self._init_state)
        # (frames per replay, mode of MODES) -> program
        self._programs: Dict[Tuple[int, str], StepProgram] = {}
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.last_event: Optional[torch.cuda.Event] = None
        self._feed = _Feed()
        self._feeds = [_Feed() for _ in range(batch)]

    def reset(self):
        """Back to the initial state; with a graph, copied into the static
        state (its addresses are captured)."""
        if self.graph:
            copy_tree_(self.state, self._init_state)
        else:
            self.state = T.tree_map(torch.clone, self._init_state)
        self._feed = _Feed()
        self._feeds = [_Feed() for _ in range(self.batch)]

    def _frames(self, raw):
        """A slot's frames [n, H, W] undistorted (or cast and gained) over the
        batch."""
        if self.undistorter is not None:
            return self.undistorter(raw)
        return raw.to(torch.float32) * self.config.image_gain

    def _steps(self, state, raw, imu, dts, mode: str = "exact"):
        """Undistortion (or the cast and gain) and the step function of
        ``mode`` over a slot's frames: what one replay runs.  The traced
        mode's trace comes back packed (``graph.pack_trace``)."""
        out = MODES[mode](state, self._frames(raw), imu, dts, self.config, self.mats)
        if mode == "traced":
            return out[0], out[1], pack_trace(out[2])
        return out

    def _frame_inputs(self, image, ts_us: int, imu_ts, imu_gyro, imu_acc):
        """(image, gyro, acc, ts, dt) of one frame: the IMU samples since the
        last frame with ts <= ts_us, and the frame interval."""
        return self._feed.inputs(image, ts_us, imu_ts, imu_gyro, imu_acc)

    def _stage(self, frames, mode: str = "exact"):
        """Stage the frames' inputs (a list of ``_frame_inputs``) in a slot of
        the program for their count and ``mode``.  Returns (program, slot)."""
        if (mode == "batched") != bool(self.batch):
            raise ValueError(f"a runner of batch {self.batch} cannot run mode {mode!r}: "
                             "run_batched is the batched runner's one mode")
        key = (len(frames), mode)
        prog = self._programs.get(key)
        if prog is None:
            image = frames[0][0]
            if not torch.is_tensor(image):
                image = torch.from_numpy(np.asarray(image))
            layout = SlotLayout(len(frames), image.shape, np_dtype(image.dtype),
                                self.config.imu.sample_max)
            words = trace_words(self.config.detector.keylines_max) if mode == "traced" else 0
            prog = StepProgram(functools.partial(self._steps, mode=mode), layout, self.device,
                               RING_SLOTS, self.graph, self._copy_stream, trace_words=words)
            self._programs[key] = prog
        return prog, prog.stage(frames)

    def _run(self, prog: StepProgram, k: int) -> torch.Tensor:
        self.state, packed, self.last_event = prog.run(k, self.state)
        return packed

    def _seq_frame(self, seq, i: int):
        return self._frame_inputs(seq.images[i], int(seq.ts_us[i]), seq.imu_ts_us,
                                  seq.imu_gyro, seq.imu_acc)

    def continue_after(self, ts_us: int, imu_ts) -> None:
        """Continue a stream after its frame at ``ts_us`` (a resumed state):
        the next frame's interval is taken from it, and the IMU samples of
        ``imu_ts`` (the stream the frames will be passed with) up to it count
        as consumed."""
        self._feed.last_ts = int(ts_us)
        self._feed.cursor = int(np.searchsorted(np.asarray(imu_ts), ts_us, side="right"))

    def process_frame(self, image, ts_us: int, imu_ts, imu_gyro, imu_acc) -> T.Odometry:
        """Process one frame given the entire IMU stream; the runner keeps a
        cursor and consumes the samples with ts <= frame ts.  ``image``: host
        memory, or a tensor already on the runner's card (copied on the
        device into the staging slot).  The odometry is the runner's own
        copy (the next frame does not overwrite it)."""
        packed = self._run(*self._stage([self._frame_inputs(image, ts_us, imu_ts, imu_gyro,
                                                            imu_acc)]))
        return odometry_view(packed[0])

    def run(self, seq, chunk: int = 0, pipelined: bool = False) -> RunResult:
        """Run a synthetic/EuRoC Sequence object end to end.  Streaming: one
        replay per frame, frame i+1 staged and uploaded before step i is
        launched.  ``chunk`` > 1: ``chunk`` frames per replay
        (``pipeline.step_chunk``, exact mode: the same results as
        streaming; with ``pipelined``, ``pipeline.step_chunk_pipelined``:
        the threshold held for the chunk), the tail frames through the
        per-frame program, as JAX's ``_run_chunked`` streams them.  The
        odometry is read back once, at the end."""
        n = len(seq.images)
        size = chunk if chunk and chunk > 1 else 1
        mode = "pipelined" if pipelined and size > 1 else "exact"
        groups = [(range(lo, lo + size), mode) for lo in range(0, n - n % size, size)]
        groups += [(range(i, i + 1), "exact") for i in range(n - n % size, n)]

        def stage(g):
            idx, mode = groups[g]
            return self._stage([self._seq_frame(seq, i) for i in idx], mode)

        outs = self._replay_prefetched(len(groups), stage)
        return _result([int(t) for t in seq.ts_us[:n]], torch.cat(outs))

    def _replay_prefetched(self, n: int, stage) -> List[torch.Tensor]:
        """Replay ``n`` slots in order, ``stage(g)`` staging slot g: slot g+1
        is staged and uploaded before slot g is launched.  Returns each
        replay's packed odometry."""
        outs = []
        staged = stage(0) if n else None
        for g in range(n):
            nxt = stage(g + 1) if g + 1 < n else None
            outs.append(self._run(*staged))
            staged = nxt
        return outs

    def run_batched(self, seqs, frames: range = None) -> List[RunResult]:
        """Run ``batch`` sequences in lockstep (rebvio_tpu/parallel/batch.py):
        frame i of every sequence (each with its own IMU cursor) in one staging
        slot, undistorted over the batch and stepped by
        ``parallel.batch.batched_step``, one replay a batched frame, frame i+1
        staged before step i.  ``frames``: the frame indices to run (default:
        all the sequences have); a later call continues the streams (``reset``
        starts them over).  The odometry is read back once, at the end.
        Returns one RunResult a sequence."""
        self._check_batch(seqs)
        idx = list(frames if frames is not None else range(min(len(sq.images) for sq in seqs)))
        outs = self._replay_prefetched(len(idx), lambda k: self._stage_batch(seqs, idx[k]))
        packed = torch.stack(outs, dim=1) if outs else torch.zeros((self.batch, 0, ODO_WORDS))
        return [_result([int(sq.ts_us[i]) for i in idx], packed[b]) for b, sq in enumerate(seqs)]

    def _check_batch(self, seqs):
        if len(seqs) != self.batch:
            raise ValueError(f"{len(seqs)} sequences for a runner of batch {self.batch}")

    def _stage_batch(self, seqs, i: int):
        return self._stage([f.inputs(sq.images[i], int(sq.ts_us[i]), sq.imu_ts_us,
                                     sq.imu_gyro, sq.imu_acc)
                            for f, sq in zip(self._feeds, seqs)], "batched")

    def process_batch(self, seqs, i: int) -> torch.Tensor:
        """Frame ``i`` of each of the ``batch`` sequences as one batched step
        (continuing their streams).  Returns the packed odometry [batch,
        ODO_WORDS] on the runner's device (its own copy; nothing is read
        back: ``graph.odometry_view`` reads it)."""
        self._check_batch(seqs)
        return self._run(*self._stage_batch(seqs, i))

    def run_mapped(self, seq, builder, chunk: int = 0) -> RunResult:
        """Run with a ``KeyframeMapBuilder`` at chunk speed
        (rebvio_tpu/runner.py:230-351): ``chunk`` frames a replay of
        ``pipeline.step_chunk_traced`` (the exact chunk, the same results as
        streaming), whose odometry and mapping trace land in one static
        buffer, copied to the host once a chunk (non-blocking, into one of
        two pinned buffers).  The host builder works on chunk i after chunk
        i+1 has been launched.  The builder's full edge map (loop closure)
        is snapshotted only at chunk boundaries, as a device clone taken on
        the compute stream before the next replay, so the keyframes must be
        chunk-aligned: ``chunk`` a multiple of ``kf_every`` and ``kf_phase ==
        (chunk - 1) % kf_every``.  The tail frames run one by one with the
        per-frame builder."""
        chunk = chunk or builder.kf_every
        if chunk % builder.kf_every != 0 or builder.kf_phase != (chunk - 1) % builder.kf_every:
            raise ValueError(
                f"run_mapped requires chunk-aligned keyframes: chunk ({chunk}) must be a "
                f"multiple of kf_every ({builder.kf_every}) and kf_phase ({builder.kf_phase}) "
                f"must equal (chunk-1) % kf_every; otherwise keyframes land mid-chunk, where "
                f"no edge-map snapshot exists")
        n = len(seq.images)
        kmax = self.config.detector.keylines_max
        starts = list(range(0, n - n % chunk, chunk))
        cuda = self.device.type == "cuda"
        host = [torch.empty((chunk, ODO_WORDS + trace_words(kmax)), dtype=torch.float32,
                            pin_memory=cuda) for _ in range(2)]
        rows = []

        def stage(g):
            return self._stage([self._seq_frame(seq, i) for i in range(starts[g],
                                                                       starts[g] + chunk)],
                               "traced")

        def process(rows_host, event, snapshot):
            if event is not None:
                event.synchronize()                 # the chunk's one readback
            buf = rows_host.numpy()
            odo = buf[:, :ODO_WORDS].copy()
            valid, match_id, pos_img, rho, K = unpack_trace(buf[:, ODO_WORDS:], kmax)
            for k in range(chunk):
                builder.add_frame_arrays(valid[k], match_id[k], pos_img[k], rho[k], odo[k, 0:3],
                                         odo[k, 3:6], K_scale=float(K[k]),
                                         edge_map=snapshot if k == chunk - 1 else None)
            rows.append(odo)

        pending = None
        staged = stage(0) if starts else None
        for g in range(len(starts)):
            nxt = stage(g + 1) if g + 1 < len(starts) else None
            prog = staged[0]
            self._run(*staged)
            h = host[g % 2]
            h.copy_(prog.buf, non_blocking=cuda)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            snapshot = T.tree_map(torch.clone, self.state.edge_map) if builder.store_maps else None
            if pending is not None:
                process(*pending)
            pending = (h, event, snapshot)
            staged = nxt
        if pending is not None:
            process(*pending)
        for i in range(n - n % chunk, n):          # tail: the per-frame builder
            odo = self._run(*self._stage([self._seq_frame(seq, i)])).cpu().numpy()
            builder.add_frame(self.state.edge_map, odo[0, 0:3], odo[0, 3:6],
                              K_scale=float(self.state.K))
            rows.append(odo)
        packed = torch.from_numpy(np.concatenate(rows)) if rows else torch.zeros((0, ODO_WORDS))
        return _result([int(t) for t in seq.ts_us[:n]], packed)

    def run_realtime(self, seq, speed: float = 1.0, queue_size: int = 2,
                     inflight: int = 3) -> RealtimeResult:
        """Run at sensor rate x ``speed`` with keep-up semantics
        (rebvio_tpu/runner.py:153-232; the reference's paced player and
        bounded subscriber queues, ros_rebvio.cpp:89-126): each frame is due
        at its scaled timestamp; when the loop falls behind, only the newest
        ``queue_size`` due frames are kept (drop-oldest), and the IMU samples
        of dropped frames are consumed by the next processed frame.  At most
        ``inflight`` frames are in flight: the oldest is fenced on the event
        recorded after its step before another is launched, so the latency
        (fence time - due time) is the device's, not the queue's."""
        n = len(seq.images)
        ts0 = int(seq.ts_us[0])
        deadlines = (np.asarray(seq.ts_us, np.float64) - ts0) / 1e6 / max(speed, 1e-9)
        pending = collections.deque()
        ts, outs, idxs = [], [], []
        dropped = 0
        worst = 0.0
        start = time.perf_counter()

        def fence_oldest():
            nonlocal worst
            jj, ev = pending.popleft()
            if ev is not None:
                ev.synchronize()
            worst = max(worst, (time.perf_counter() - start) - deadlines[jj])

        i = 0
        while i < n:
            now = time.perf_counter() - start
            if deadlines[i] > now:
                time.sleep(min(deadlines[i] - now, 0.05))
                continue
            j_due = i
            while j_due + 1 < n and deadlines[j_due + 1] <= now:
                j_due += 1
            first_kept = max(i, j_due - queue_size + 1)
            dropped += first_kept - i
            j = first_kept
            outs.append(self._run(*self._stage([self._seq_frame(seq, j)])))
            pending.append((j, self.last_event))
            ts.append(int(seq.ts_us[j]))
            idxs.append(j)
            if len(pending) >= inflight:
                fence_oldest()
            i = j + 1
        while pending:
            fence_oldest()
        return RealtimeResult(result=_result(ts, torch.cat(outs)), frame_idx=np.asarray(idxs),
                              processed=len(idxs), dropped=dropped, worst_latency_s=worst)
