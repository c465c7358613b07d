"""Checkpoint and resume of the whole estimator state
(rebvio_tpu/utils/checkpoint.py).  The reference keeps its filter state in
function statics and has no checkpoint (core.cpp:287-292, 335-338); here
the state is one tree of tensors, so a checkpoint is an ``.npz`` of its
leaves.  The keys are the JAX package's key paths (".edge_map/.pos",
".K", ...), so a state that JAX's ``checkpoint.save`` wrote resumes in the
port, and the port's in JAX.

``load`` returns a new tree on the template's devices; a runner's graphed
static state must be ``copy_``-ed into (``graph.copy_tree_``), never
rebound: its captured graphs hold its addresses."""

from __future__ import annotations

import dataclasses
import os
from typing import Any, List, Tuple

import numpy as np
import torch


def _leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(JAX key path, leaf) of a tree of dataclasses and NamedTuples, depth
    first in field order."""
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif hasattr(tree, "_asdict"):
        items = list(tree._asdict().items())
    else:
        return [(prefix, tree)]
    out = []
    for name, v in items:
        if v is not None:
            out += _leaves_with_paths(v, f"{prefix}/.{name}" if prefix else f".{name}")
    return out


def _rebuild(tree: Any, leaves: dict, prefix: str = "") -> Any:
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves,
                             f"{prefix}/.{f.name}" if prefix else f".{f.name}")
            for f in dataclasses.fields(tree)})
    if hasattr(tree, "_asdict"):
        return tree._replace(**{k: None if v is None else _rebuild(
            v, leaves, f"{prefix}/.{k}" if prefix else f".{k}") for k, v in tree._asdict().items()})
    return leaves[prefix]


def save(path: str, state: Any) -> None:
    """Save a tree of tensors (VioState, BAProblem, ...) to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: v.detach().cpu().numpy()
                                 for k, v in _leaves_with_paths(state)})


def load(path: str, template: Any) -> Any:
    """The checkpoint at ``path`` in the structure of ``template``: every
    leaf's shape checked, cast to the template leaf's dtype and placed on
    its device.  A missing leaf raises KeyError, a shape mismatch
    ValueError, both naming the leaf."""
    leaves = {}
    with np.load(path, allow_pickle=False) as data:
        for k, tv in _leaves_with_paths(template):
            if k not in data:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            v = data[k]
            if tuple(v.shape) != tuple(tv.shape):
                raise ValueError(f"leaf {k!r}: checkpoint shape {v.shape} != state "
                                 f"{tuple(tv.shape)}")
            leaves[k] = torch.as_tensor(np.array(v)).to(device=tv.device, dtype=tv.dtype)
    return _rebuild(template, leaves)
