"""Batched multi-sequence VIO (rebvio_tpu/parallel/batch.py): B independent
sequences stepped in lockstep as one program, every operation over B lanes.

``batched_step`` is ``torch.func.vmap`` of the port's own ``pipeline.step``,
as JAX vmaps its step: there is no second copy of the step with a batch axis
written in, so the unbatched step stays the single code path.  The
hand-written kernels are reached through operators whose vmap rule launches
each kernel once over all B lanes (ops/kernels.py); on CPU tensors their
plain versions run under vmap as they are.  ``runner.VioRunner(config,
batch=B).run_batched`` captures the batched step (with the undistortion of
the B frames) as one CUDA graph per batched frame (graph.StepProgram, mode
"batched").

``make_seq_mesh`` / ``shard_batch`` / ``sharded_step_fn``: the sequence axis
over the ranks of a ``torch.distributed`` group, one GPU a rank.  Each rank
steps its contiguous block of lanes (multihost.local_batch_slice); nothing
on the step's path crosses ranks.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.configs import PipelineConfig
from rebvio_tpu_torch.parallel import multihost
from rebvio_tpu_torch.pipeline import frontend_matrices, step
from rebvio_tpu_torch.ops.scale_space import FrontendMatrices


def init_batched_state(config: PipelineConfig, batch: int, device="cuda") -> T.VioState:
    """``batch`` copies of the initial state, every leaf [batch, ...]."""
    one = T.init_vio_state(config, device)
    return T.tree_map(lambda x: x.expand(batch, *x.shape).clone(), one)


def _unflatten(template, leaves):
    it = iter(leaves)
    return T.tree_map(lambda _: next(it), template)


def batched_step(states: T.VioState, frames: torch.Tensor, imu: T.ImuFrameData,
                 frame_dt: torch.Tensor, config: PipelineConfig,
                 mats: FrontendMatrices = None) -> Tuple[T.VioState, T.Odometry]:
    """``pipeline.step`` over B lanes: ``states`` and ``imu`` with leaves
    [B, ...], ``frames`` [B, H, W], ``frame_dt`` [B].  Returns (states,
    odometry), every leaf [B, ...]."""
    if mats is None:
        mats = frontend_matrices(config, states.Pos.device)
    win0 = T.tree_map(lambda x: x[0], imu)

    def one(state_leaves, frame, win_leaves, dt):
        s, o = step(_unflatten(states, state_leaves), frame, _unflatten(win0, win_leaves), dt,
                    config, mats)
        return T.tree_leaves(s), T.tree_leaves(o)

    s_leaves, o_leaves = torch.func.vmap(one)(T.tree_leaves(states), frames,
                                              T.tree_leaves(imu), frame_dt)
    odo = T.Odometry(*o_leaves)
    return _unflatten(states, s_leaves), odo


def make_seq_mesh(device="cuda") -> DeviceMesh:
    """1-D mesh ``("seq",)`` over the group's ranks, one device each."""
    import torch.distributed as dist

    multihost._ensure_group(device)
    return init_device_mesh(torch.device(device).type, (dist.get_world_size(),),
                            mesh_dim_names=("seq",))


def shard_batch(tree, mesh: DeviceMesh):
    """This rank's contiguous block of the leading (lane) axis of every leaf of
    a batched tree, on the mesh's device type."""
    leaves = T.tree_leaves(tree)
    start, size = multihost.local_batch_slice(leaves[0].shape[0], mesh)
    dev = torch.device(mesh.device_type)
    return T.tree_map(lambda x: x[start:start + size].to(dev).contiguous(), tree)


def sharded_step_fn(mesh: DeviceMesh, config: PipelineConfig) -> Tuple[Callable, Callable]:
    """(fn, local): ``fn(states, frames, imu, frame_dt)`` steps this rank's
    lanes (``batched_step``); ``local(tree)`` cuts a global batch down to
    them (``shard_batch``)."""
    def fn(states, frames, imu, frame_dt):
        return batched_step(states, frames, imu, frame_dt, config)

    return fn, lambda tree: shard_batch(tree, mesh)
