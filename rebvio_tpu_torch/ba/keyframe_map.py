"""Keyframe map construction from the live VIO run
(rebvio_tpu/ba/keyframe_map.py).

The host tracks keyline identity across frames through the directed-match
chains (new_map.match_id points into the previous frame's map,
edge_map.cpp:186-218), assigns persistent track ids, and at keyframes
records (track, keyframe, normalized-pixel) landmark observations plus the
current VIO pose and per-keyline inverse depth.  With ``store_maps`` each
keyframe's whole EdgeMap is kept on its device for loop-closure
registration (ba/loop_closure.register_pair).

The conversion of the accumulated map to a bundle-adjustment problem
(``build_problem`` of the JAX package) belongs to the Schur BA back end and
is not part of this module yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from rebvio_tpu_torch.configs import PipelineConfig
from rebvio_tpu_torch.geometry import so3


@dataclasses.dataclass
class Keyframe:
    index: int                 # frame index in the run
    R_wc: np.ndarray           # [3,3]
    t_wc: np.ndarray           # [3]
    obs_tracks: np.ndarray     # [M] track ids observed here
    obs_uv: np.ndarray         # [M,2] normalized coords (pos_img / fm)
    obs_rho: np.ndarray        # [M] VIO inverse depth (visual units)


class KeyframeMapBuilder:
    """Host-side accumulator; feed it each step's post-update edge map."""

    def __init__(self, config: PipelineConfig, kf_every: int = 5, min_track_len: int = 2,
                 max_tracks_per_kf: int = 2000, store_maps: bool = False, kf_phase: int = 0):
        self.config = config
        self.kf_every = kf_every
        # keyframes fire at frames f with f % kf_every == kf_phase
        self.kf_phase = kf_phase % kf_every
        self.min_track_len = min_track_len
        self.max_tracks_per_kf = max_tracks_per_kf
        self.keyframes: List[Keyframe] = []
        self.store_maps = store_maps
        self.kf_maps: List = []
        self._track_of_slot: Optional[np.ndarray] = None
        self._next_track = 0
        self._frame = 0

    def add_frame(self, edge_map, orientation: np.ndarray, position: np.ndarray,
                  K_scale: float = 1.0) -> None:
        """edge_map: the post-step state.edge_map; pose from the step's
        odometry output.  Copies four [K] fields to the host per frame."""
        self.add_frame_arrays(
            edge_map.valid.cpu().numpy(), edge_map.match_id.cpu().numpy(),
            edge_map.pos_img.cpu().numpy(), edge_map.rho.cpu().numpy(),
            orientation, position, K_scale=K_scale, edge_map=edge_map)

    def add_frame_arrays(self, valid: np.ndarray, match_id: np.ndarray, pos_img: np.ndarray,
                         rho: np.ndarray, orientation: np.ndarray, position: np.ndarray,
                         K_scale: float = 1.0, edge_map=None) -> None:
        """Core accumulator over host arrays (no device access).

        ``edge_map`` (optional, device-resident) is stored for loop closure
        when this frame is a keyframe and store_maps is set."""
        kmax = len(valid)

        # --- track propagation through the match chain ---
        new_tracks = np.full(kmax, -1, np.int64)
        if self._track_of_slot is not None:
            has = valid & (match_id >= 0)
            src = np.clip(match_id, 0, kmax - 1)
            prev = self._track_of_slot[src]
            new_tracks = np.where(has, prev, -1)
        fresh = valid & (new_tracks < 0)
        n_fresh = int(fresh.sum())
        new_tracks[fresh] = self._next_track + np.arange(n_fresh)
        self._next_track += n_fresh
        self._track_of_slot = new_tracks

        if self._frame % self.kf_every == self.kf_phase:
            sel = valid & (new_tracks >= 0)
            idx = np.nonzero(sel)[0]
            if len(idx) > self.max_tracks_per_kf:
                idx = idx[np.linspace(0, len(idx) - 1, self.max_tracks_per_kf).astype(int)]
            fm = self.config.camera.fm
            R_wc = so3.exp(torch.as_tensor(np.asarray(orientation, np.float32))).numpy()
            self.keyframes.append(Keyframe(
                index=self._frame,
                R_wc=R_wc,
                t_wc=np.asarray(position, np.float64),
                obs_tracks=new_tracks[idx],
                obs_uv=np.asarray(pos_img)[idx] / fm,
                obs_rho=np.asarray(rho)[idx] / max(K_scale, 1e-6),
            ))
            if self.store_maps and edge_map is not None:
                self.kf_maps.append(edge_map)
        self._frame += 1

    def n_keyframes(self) -> int:
        return len(self.keyframes)
