"""Multi-process set-up and the pod mesh (rebvio_tpu/parallel/multihost.py)
on ``torch.distributed``, one GPU (or, on the CPU, one process) per rank.

* ``init_distributed`` starts the process group: NCCL for CUDA, gloo when
  the caller asks for the CPU; a no-op for one process.  Nothing in the
  environment names a cluster, so the caller gives the rendezvous address
  (``host:port``), the number of processes and this process's rank.
* ``make_pod_mesh`` builds the 2-D ``DeviceMesh`` with dims ``("seq",
  inner)``: the ``seq`` axis for independent sequences (no collectives) and
  an ``lm`` / ``kl`` axis for map-sharded work whose all-reduces stay
  inside a host.  With one process and no group it starts a world-size-1
  group over an in-process store, so the same code runs everywhere.
* ``local_batch_slice``: the contiguous block of a seq-sharded batch that
  this rank owns, JAX's rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     device="cuda") -> None:
    """Join ``num_processes`` processes at ``coordinator_address`` (``host:port``)
    as rank ``process_id``; NCCL on ``device="cuda"`` (the rank's GPU is
    ``process_id`` modulo the visible count), gloo on ``"cpu"``.  No-op for a
    single process."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("init_distributed: several processes need coordinator_address "
                         "(host:port) and process_id")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(_backend(device), init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _ensure_group(device) -> None:
    """A world-size-1 group over an in-process store, where none exists."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(device), store=dist.HashStore(), rank=0,
                                world_size=1)


def make_pod_mesh(seq_parallel: Optional[int] = None, inner_axis: str = "lm",
                  device="cuda") -> DeviceMesh:
    """(seq, inner) mesh over the group's ranks.  ``seq_parallel`` defaults to
    the number of processes, so the sequence axis spans them and the inner
    axis holds what a process has (one device here); ``inner_axis`` is "lm"
    for BA landmark sharding or "kl" for keyline sharding."""
    _ensure_group(device)
    n = dist.get_world_size()
    if seq_parallel is None:
        seq_parallel = n
    if n % seq_parallel != 0:
        raise ValueError(f"{n} devices not divisible by seq_parallel={seq_parallel}")
    return init_device_mesh(torch.device(device).type, (seq_parallel, n // seq_parallel),
                            mesh_dim_names=("seq", inner_axis))


def local_batch_slice(global_batch: int, mesh: DeviceMesh) -> Tuple[int, int]:
    """(start, size) of this rank's slice of a seq-sharded global batch:
    processes own contiguous blocks of the seq axis in mesh order."""
    seq = mesh.mesh.shape[mesh.mesh_dim_names.index("seq")]
    if global_batch % seq != 0:
        raise ValueError(f"batch {global_batch} not divisible by seq={seq}")
    per = global_batch // seq
    pid = dist.get_rank()
    procs = max(dist.get_world_size(), 1)
    rows_per_proc = max(seq // procs, 1)
    start = (pid * rows_per_proc) * per
    return start, rows_per_proc * per
