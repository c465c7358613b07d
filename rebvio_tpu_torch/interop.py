"""Carry estimator state between the JAX package and the port.

The JAX package's ``VioState`` / ``EdgeMap`` / ``FrontendMatrices`` travel
as (nested) dicts of numpy arrays with the same field names; these helpers
turn such a dict into the port's dataclasses on a chosen device, and back.
This system has no weights: its state and the band matrices are what is
carried.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rebvio_tpu_torch import resolve_device
from rebvio_tpu_torch import types as T
from rebvio_tpu_torch.ops import scale_space
from rebvio_tpu_torch.ops.scale_space import FrontendMatrices

_NESTED = {"edge_map": T.EdgeMap, "imu_state": T.ImuState, "sab_state": T.SabState}


def _from_numpy(cls, d: dict, dev):
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.name in _NESTED:
            kw[f.name] = _from_numpy(_NESTED[f.name], v, dev)
        else:
            kw[f.name] = torch.as_tensor(np.array(v, copy=True)).to(dev)
    return cls(**kw)


def edge_map_from_numpy(d: dict, device="cuda") -> T.EdgeMap:
    return _from_numpy(T.EdgeMap, d, resolve_device(device))


def state_from_numpy(d: dict, device="cuda") -> T.VioState:
    return _from_numpy(T.VioState, d, resolve_device(device))


def imu_frame_from_numpy(d: dict, device="cuda") -> T.ImuFrameData:
    """A JAX ``ImuFrameData`` (as a dict of numpy arrays) on ``device``."""
    return _from_numpy(T.ImuFrameData, d, resolve_device(device))


def matrices_from_numpy(d: dict, device="cuda") -> FrontendMatrices:
    """The JAX package's seven band operators (by name) on ``device``, with
    their bands."""
    return scale_space.upload({k: np.array(d[k], np.float32) for k in scale_space.OPERATORS},
                              device)


def pose_graph_from_numpy(d: dict, device="cuda"):
    """A JAX ``PoseGraph`` (as a dict of numpy arrays; ``f_wt`` may be None)
    on ``device``."""
    from rebvio_tpu_torch.ba.pose_graph import PoseGraph

    dev = resolve_device(device)
    return PoseGraph(**{k: None if d.get(k) is None
                        else torch.as_tensor(np.array(d[k], copy=True)).to(dev)
                        for k in PoseGraph._fields})


def ba_problem_from_numpy(d: dict, device="cuda"):
    """A JAX ``BAProblem`` (as a dict of numpy arrays) on ``device``."""
    from rebvio_tpu_torch.ba.problem import BAProblem

    dev = resolve_device(device)
    return BAProblem(**{k: torch.as_tensor(np.array(d[k], copy=True)).to(dev)
                        for k in BAProblem._fields})


def to_numpy(obj) -> dict:
    """A port dataclass (or NamedTuple of tensors) as a nested dict of numpy
    arrays."""
    if hasattr(obj, "_asdict"):    # PoseGraph, BAProblem, BATerms
        return {k: None if v is None else v.cpu().numpy() for k, v in obj._asdict().items()}
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = to_numpy(v) if dataclasses.is_dataclass(v) else v.cpu().numpy()
    return out
