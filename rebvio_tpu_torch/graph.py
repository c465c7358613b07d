"""The runner's step as one CUDA graph, fed from a pinned staging ring
(the port of rebvio_tpu/runner.py:59-78 and :124-139).

The JAX runner traces undistortion and the step into one ``jax.jit`` and
hands it frame i+1's device buffer before it dispatches step i.  Here:

- ``SlotLayout``: one staging slot's bytes: n raw frames, then n packed
  IMU windows each followed by the frame dt (float32).  One slot is one
  host-to-device copy.
- ``StagingRing``: round-robin slots.  A slot is handed out again only after
  the event recorded behind the replay that read it has completed, so the
  host never overwrites a pinned buffer the device has yet to read.
- ``StepProgram``: the step over the n frames of a slot.  On a CUDA device
  with ``graph=True`` it is captured once into a CUDA graph (``CapturedGraph``)
  over static buffers (the input slot, the caller's state, the packed
  odometry and, for the mapped runner, the packed mapping trace beside it)
  and replayed; otherwise it runs eagerly.  A capture or replay that fails
  raises: there is no eager fallback on the card.

Upload: the host packs a slot, copies it on a copy stream into the slot's
device twin (``non_blocking`` from pinned memory) and records an event; the
launch makes the compute stream wait on that event, copies the twin into
the graph's static input and replays.  So frame i+1's upload overlaps step
i, and a slot's twin is reread only after its own copy.
"""

from __future__ import annotations

import ctypes
import gc
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.ops import kernels
from rebvio_tpu_torch.ops.imu import imu_window_view, imu_words, pack_imu_host

f32 = torch.float32
ODO_WORDS = 8       # orientation 3, position 3, num_matches (int32 bits), run_ok (first byte)


def odometry_view(packed: torch.Tensor) -> T.Odometry:
    """Odometry as views of packed rows ``[..., ODO_WORDS]`` float32."""
    return T.Odometry(orientation=packed[..., 0:3], position=packed[..., 3:6],
                      num_matches=packed[..., 6].view(torch.int32),
                      run_ok=packed[..., 7:8].view(torch.uint8)[..., 0].view(torch.bool))


def trace_words(kmax: int) -> int:
    """Words of one frame's packed mapping trace (``pack_trace``)."""
    return 5 * kmax + 1


def pack_trace(trace: dict) -> torch.Tensor:
    """``pipeline.step_chunk_traced``'s trace as float32 rows [n,
    trace_words(K)]: valid (0/1), match_id (its int32 bits), pos_img (x, y
    interleaved), rho, then K.  Exact: no value is rounded."""
    n = trace["valid"].shape[0]
    return torch.cat([trace["valid"].to(f32), trace["match_id"].view(f32),
                      trace["pos_img"].reshape(n, -1), trace["rho"], trace["K"][:, None]], dim=1)


def unpack_trace(rows: np.ndarray, kmax: int):
    """Host rows [n, trace_words(kmax)] -> (valid [n, K] bool, match_id
    int32, pos_img [n, K, 2], rho [n, K], K [n]), views of ``rows``."""
    K = kmax
    return (rows[:, :K] > 0.5, rows[:, K:2 * K].view(np.int32),
            rows[:, 2 * K:4 * K].reshape(-1, K, 2), rows[:, 4 * K:5 * K], rows[:, 5 * K])


def np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def copy_tree_(dst, src) -> None:
    """``copy_`` every leaf of ``src`` into the matching leaf of ``dst``.  A
    source leaf that lies in the storage of another destination leaf would
    be overwritten before it is read: that raises."""
    d, s = T.tree_leaves(dst), T.tree_leaves(src)
    owner = {x.untyped_storage().data_ptr(): i for i, x in enumerate(d)}
    for i, (x, y) in enumerate(zip(d, s)):
        j = owner.get(y.untyped_storage().data_ptr(), i)
        if j != i:
            raise RuntimeError(f"copy_tree_: source leaf {i} aliases destination leaf {j}")
    for x, y in zip(d, s):
        x.copy_(y)


class SlotLayout:
    """Bytes of one staging slot: ``n`` frames ``shape`` of numpy ``dtype``,
    then float32 rows ``[n, imu_words(S) + 1]`` (the packed IMU window, then
    the frame dt)."""

    def __init__(self, n: int, shape, dtype, sample_max: int):
        self.n, self.shape, self.dtype, self.S = n, tuple(shape), np.dtype(dtype), sample_max
        self.torch_dtype = torch.from_numpy(np.empty(0, self.dtype)).dtype
        self.frame_bytes = n * int(np.prod(self.shape)) * self.dtype.itemsize
        self.imu_off = -(-self.frame_bytes // 16) * 16
        self.words = imu_words(sample_max) + 1
        self.nbytes = self.imu_off + n * self.words * 4

    def check(self, shape, dtype) -> None:
        """Raise unless a frame of ``shape`` and numpy ``dtype`` fits a slot."""
        if tuple(shape) != self.shape or dtype != self.dtype:
            raise ValueError(f"frame {dtype} {tuple(shape)}: this runner's static input "
                             f"takes {self.dtype} {self.shape}")

    def pack(self, slot: np.ndarray, k: int, image, gyro, acc, ts_us, dt: float) -> None:
        """Frame ``k`` of the slot (host bytes ``slot``); ``image`` None
        leaves the frame's bytes as they are (a frame already on the card is
        copied into the slot's device twin instead: ``StepProgram.stage``)."""
        if image is not None:
            image = np.asarray(image)
            self.check(image.shape, image.dtype)
            slot[:self.frame_bytes].view(self.dtype).reshape((self.n,) + self.shape)[k] = image
        row = slot[self.imu_off:].view(np.float32).reshape(self.n, self.words)[k]
        pack_imu_host(row[:-1], gyro, acc, ts_us, self.S)
        row[-1] = dt

    def views(self, slot: torch.Tensor):
        """(frames [n, H, W], ImuFrameData with leaves [n, ...], dts [n]) as
        views of the slot's bytes ``slot`` (a uint8 tensor)."""
        frames = slot[:self.frame_bytes].view(self.torch_dtype).view((self.n,) + self.shape)
        rows = slot[self.imu_off:].view(f32).view(self.n, self.words)
        return frames, imu_window_view(rows[:, :-1], self.S), rows[:, -1]


class StagingRing:
    """Round-robin staging slots.  ``acquire`` hands out the next slot once
    the event that ``release`` recorded for its last reader has completed
    (``event.synchronize()``); a slot handed out and not yet released cannot
    be handed out again.  ``slots`` must exceed the frames in flight."""

    def __init__(self, slots: List):
        self.slots = slots
        self._events: List[Optional[object]] = [None] * len(slots)
        self._held = [False] * len(slots)
        self._next = 0

    def acquire(self) -> int:
        k = self._next
        if self._held[k]:
            raise RuntimeError(f"staging slot {k} is still held: more frames staged than the "
                               f"ring's {len(self.slots)} slots")
        ev = self._events[k]
        if ev is not None:
            ev.synchronize()
            self._events[k] = None
        self._held[k] = True
        self._next = (k + 1) % len(self.slots)
        return k

    def release(self, k: int, event) -> None:
        """The device's last read of slot ``k`` is ordered before ``event``
        (None: the read is done, as on the CPU)."""
        self._held[k] = False
        self._events[k] = event


class StepProgram:
    """``fn(state, frames, imu, dts) -> (state', odometry [n])`` over the n
    frames of one staging slot, for one runner state; with ``trace_words``,
    ``-> (state', odometry [n], trace rows [n, trace_words])``.  Its outputs
    land in the static buffer ``buf`` [n, ODO_WORDS + trace_words]: the
    packed odometry (``out``), then the trace (``trace``), so one copy reads
    both back.

    ``stage`` packs frames into a free slot and starts its upload; ``run``
    runs the step on a staged slot.  With ``graph`` (CUDA only) the first
    ``run`` warms the step up twice on a side stream from a copy of the
    state (filling every cache, the kernel build and cuBLAS's
    workspaces), then captures it with ``state`` as static input and output
    (the new state is ``copy_``-ed into it, never rebound) and replays it
    from then on.  Launches counted in ``kernels.LAUNCHES`` during warm-up
    and capture are taken back; each replay adds the captured ones.
    ``keep_graph`` keeps the captured ``cudaGraph_t`` beside its executable
    (``CUDAGraph(keep_graph=True)``, instantiated at capture) so that a
    caller can read it, e.g. its node count."""

    def __init__(self, fn: Callable, layout: SlotLayout, device: torch.device, n_slots: int,
                 graph: bool, copy_stream=None, trace_words: int = 0, keep_graph: bool = False):
        self.fn, self.layout, self.device = fn, layout, device
        self.keep_graph = keep_graph
        self.cuda = device.type == "cuda"
        self.graph = graph and self.cuda
        self.ring = StagingRing([torch.empty(layout.nbytes, dtype=torch.uint8,
                                             pin_memory=self.cuda) for _ in range(n_slots)])
        self._copied: List[Optional[torch.cuda.Event]] = [None] * n_slots
        if self.cuda:
            self.twins = [torch.empty(layout.nbytes, dtype=torch.uint8, device=device)
                          for _ in range(n_slots)]
            self.static_in = torch.empty(layout.nbytes, dtype=torch.uint8, device=device)
            self.copy_stream = copy_stream
        self.buf = torch.zeros((layout.n, ODO_WORDS + trace_words), dtype=f32, device=device)
        self.out = self.buf[:, :ODO_WORDS]
        self.trace = self.buf[:, ODO_WORDS:] if trace_words else None
        self._graph: Optional[CapturedGraph] = None

    def stage(self, frames) -> int:
        """Pack ``frames`` (n tuples (image, gyro, acc, ts_us, dt)) into a free
        slot and, on the card, start its upload.  An image that is a tensor
        on the card is copied into the slot's device twin on the copy stream,
        after the host bytes and after the work queued so far on the current
        stream, not through the host.  Returns the slot."""
        k = self.ring.acquire()
        host = self.ring.slots[k]
        buf = host.numpy()
        resident = [(i, fr[0]) for i, fr in enumerate(frames)
                    if torch.is_tensor(fr[0]) and fr[0].is_cuda]
        if resident and not self.cuda:
            raise ValueError("a frame on the card for a program on the CPU")
        for i, fr in enumerate(frames):
            image = None if torch.is_tensor(fr[0]) and fr[0].is_cuda else fr[0]
            self.layout.pack(buf, i, image, *fr[1:])
        if self.cuda:
            with torch.cuda.stream(self.copy_stream):
                self.twins[k].copy_(host, non_blocking=True)
                if resident:
                    self.copy_stream.wait_stream(torch.cuda.current_stream(self.device))
                    slot_frames = self.layout.views(self.twins[k])[0]
                    for i, image in resident:
                        self.layout.check(image.shape, np_dtype(image.dtype))
                        slot_frames[i].copy_(image)
                        image.record_stream(self.copy_stream)
                ev = torch.cuda.Event()
                ev.record(self.copy_stream)
            self._copied[k] = ev
        return k

    def stage_resident(self, frames: torch.Tensor, imu: T.ImuFrameData, dts: torch.Tensor) -> int:
        """Stage inputs that already lie on the program's device (frames [n,
        H, W] of the layout's dtype, windows with leaves [n, ...], dts [n]):
        copied into a free slot's device twin on the current stream (on the
        CPU, into the slot).  Returns the slot; a slot's inputs stay until it
        is staged again, so ``run`` may replay it more than once."""
        k = self.ring.acquire()
        slot = self.twins[k] if self.cuda else self.ring.slots[k]
        f, w, d = self.layout.views(slot)
        self.layout.check(frames.shape[1:], np_dtype(frames.dtype))
        f.copy_(frames)
        copy_tree_(w, imu)
        d.copy_(dts)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._copied[k] = ev
        return k

    def run(self, k: int, state: T.VioState):
        """The step over staged slot ``k`` from ``state``.  Returns (state,
        packed odometry [n, ODO_WORDS] (a fresh tensor), event recorded after
        the step, None on the CPU).  With a graph, ``state`` is the static
        state and is returned as it is, updated in place."""
        if not self.cuda:
            frames, imu, dts = self.layout.views(self.ring.slots[k])
            state, *outs = self.fn(state, frames, imu, dts)
            self._store(outs)
            self.ring.release(k, None)
            return state, self.out.clone(), None
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(self._copied[k])
        self.static_in.copy_(self.twins[k])
        if self.graph:
            if self._graph is None:
                self._capture(state)
            self._graph.replay()
        else:
            frames, imu, dts = self.layout.views(self.static_in)
            state, *outs = self.fn(state, frames, imu, dts)
            self._store(outs)
        done = torch.cuda.Event()
        done.record(cur)
        self.ring.release(k, done)
        return state, self.out.clone(), done

    def _store(self, outs) -> None:
        """The step's outputs (odometry[, trace rows]) into ``buf``."""
        copy_tree_(odometry_view(self.out), outs[0])
        if self.trace is not None:
            self.trace.copy_(outs[1])

    def _capture(self, state: T.VioState) -> None:
        frames, imu, dts = self.layout.views(self.static_in)
        scratch = []

        def warm():             # from a copy of the state, which stays as it is
            s = scratch.pop() if scratch else T.tree_map(torch.clone, state)
            scratch.append(self.fn(s, frames, imu, dts)[0])

        def step():
            new_state, *outs = self.fn(state, frames, imu, dts)
            copy_tree_(state, new_state)
            self._store(outs)

        self._graph = CapturedGraph(step, warm=warm, device=self.device,
                                    keep_graph=self.keep_graph)


class CapturedGraph:
    """``fn()`` (device work that never syncs the host) captured into one
    CUDA graph on a side stream: ``warm()`` (default ``fn``) runs twice
    there first, filling every cache, the kernel build and cuBLAS's
    workspaces; ``out`` holds the capture's outputs, which every replay
    rewrites.  Launches counted in ``kernels.LAUNCHES`` during warm-up and
    capture are taken back; each ``replay`` adds the captured ones.
    ``keep_graph`` keeps the ``cudaGraph_t`` beside its executable
    (instantiated here) so that a caller can read it, e.g. its node count."""

    def __init__(self, fn: Callable, warm: Callable = None, device=None,
                 keep_graph: bool = False):
        device = torch.device("cuda") if device is None else torch.device(device)
        before = dict(kernels.LAUNCHES)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                (warm or fn)()
        torch.cuda.current_stream(device).wait_stream(side)
        after_warm = dict(kernels.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        # no garbage collection while capturing: a collected cycle holding a
        # CUDA graph or an event (an earlier runner) would free it with a
        # CUDA call that the capture does not permit, and invalidate it
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=side):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()
        self.captured = {name: n - after_warm[name] for name, n in kernels.LAUNCHES.items()
                         if n != after_warm[name]}
        kernels.LAUNCHES.update(before)
        if keep_graph:
            self.graph.instantiate()

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.captured.items():
            kernels.LAUNCHES[name] += n

    def nodes(self) -> Optional[int]:
        """Nodes of the captured graph (kept with ``keep_graph``), from
        libcuda's ``cuGraphGetNodes``; None where it cannot be read."""
        try:
            get = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
            get.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
            get.restype = ctypes.c_int
            n = ctypes.c_size_t(0)
            rc = get(self.graph.raw_cuda_graph(), None, ctypes.byref(n))
            return int(n.value) if rc == 0 else None
        except (OSError, AttributeError, RuntimeError):
            return None

    def seconds(self, n: int = 20, warm: int = 3, repeats: int = 3) -> float:
        """Best over ``repeats`` of the host time of ``n`` back-to-back
        replays, fenced by ``torch.cuda.synchronize``, per replay."""
        for _ in range(warm):
            self.replay()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(n):
                self.replay()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) / n)
        return best
