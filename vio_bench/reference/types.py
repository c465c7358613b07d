"""Estimator state as dataclasses of tensors.

Same field names, shapes and dtypes as ``rebvio_tpu/types.py``: keylines in
``[KMAX]`` structure-of-arrays with a validity mask, the nearest-keyline
attribute field as ``[8, N]`` planes, and the filter state that the
reference keeps in locals and function statics made explicit.
"""

from __future__ import annotations

import dataclasses

import torch

from vio_bench.reference.configs import PipelineConfig

# Inverse-depth constants (types/keyline.hpp:17-19)
RHO_MAX = 20.0
RHO_MIN = 1e-3
RHO_INIT = 1.0
SIGMA_RHO_INIT = 20.0

f32 = torch.float32
i32 = torch.int32


class _TensorTree:
    """replace() for the state dataclasses, as on the JAX package's structs."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def finish(stages):
    """Run a generator to its end (the step's stage generators,
    pipeline.STAGES); returns what it returns."""
    while True:
        try:
            next(stages)
        except StopIteration as done:
            return done.value


def tree_leaves(tree):
    """The tensors of a state dataclass, depth first in field order."""
    if isinstance(tree, _TensorTree):
        return [x for f in dataclasses.fields(tree) for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the matching leaves of state dataclasses of one type."""
    t0 = trees[0]
    if isinstance(t0, _TensorTree):
        return dataclasses.replace(t0, **{f.name: tree_map(fn, *(getattr(t, f.name) for t in trees))
                                          for f in dataclasses.fields(t0)})
    return fn(*trees)


def tree_where(cond: torch.Tensor, a, b):
    """Leafwise ``torch.where(cond, a, b)`` (the JAX package's _tree_where):
    a device select, so no host sync decides between the two states."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


@dataclasses.dataclass
class EdgeMap(_TensorTree):
    """Fixed-shape keyline map of one frame (rebvio_tpu.types.EdgeMap)."""

    pos: torch.Tensor            # [K,2] subpixel pixel coords
    pos_img: torch.Tensor        # [K,2] principal-point-centered coords
    match_pos_img: torch.Tensor  # [K,2]
    grad: torch.Tensor           # [K,2]
    match_grad: torch.Tensor     # [K,2]
    grad_norm: torch.Tensor      # [K]
    match_grad_norm: torch.Tensor  # [K]
    rho: torch.Tensor            # [K]
    sigma_rho: torch.Tensor      # [K]
    id_prev: torch.Tensor        # [K] int32
    id_next: torch.Tensor        # [K] int32
    match_id: torch.Tensor       # [K] int32
    match_id_forward: torch.Tensor  # [K] int32
    match_id_keyframe: torch.Tensor  # [K] int32
    matches: torch.Tensor        # [K] int32
    valid: torch.Tensor          # [K] bool
    count: torch.Tensor          # [] int32
    kl_id_img: torch.Tensor      # [H,W] int32
    att_img: torch.Tensor        # [8,N] f32 attribute planes
    threshold: torch.Tensor      # [] f32

    @property
    def kmax(self) -> int:
        return self.pos.shape[0]


def empty_edge_map(kmax: int, rows: int, cols: int, field_scale: int = 1,
                   device="cuda") -> EdgeMap:
    z = dict(device=torch.device(device))
    f = torch.zeros((kmax,), dtype=f32, **z)
    f2 = torch.zeros((kmax, 2), dtype=f32, **z)
    i = torch.full((kmax,), -1, dtype=i32, **z)
    fr = (rows + field_scale - 1) // field_scale
    fc = (cols + field_scale - 1) // field_scale
    return EdgeMap(
        pos=f2, pos_img=f2.clone(), match_pos_img=f2.clone(), grad=f2.clone(),
        match_grad=f2.clone(), grad_norm=f, match_grad_norm=f.clone(),
        rho=torch.full((kmax,), RHO_INIT, dtype=f32, **z),
        sigma_rho=torch.full((kmax,), SIGMA_RHO_INIT, dtype=f32, **z),
        id_prev=i, id_next=i.clone(), match_id=i.clone(),
        match_id_forward=i.clone(), match_id_keyframe=i.clone(),
        matches=torch.zeros((kmax,), dtype=i32, **z),
        valid=torch.zeros((kmax,), dtype=torch.bool, **z),
        count=torch.zeros((), dtype=i32, **z),
        kl_id_img=torch.full((rows, cols), -1, dtype=i32, **z),
        att_img=torch.full((8, fr * fc), -1.0, dtype=f32, **z),
        threshold=torch.full((), -1.0, dtype=f32, **z),
    )


@dataclasses.dataclass
class ImuFrameData(_TensorTree):
    """Inter-frame IMU sample buffer (rebvio_tpu.types.ImuFrameData)."""

    gyro: torch.Tensor     # [S,3]
    acc: torch.Tensor      # [S,3]
    dt: torch.Tensor       # [S]
    n: torch.Tensor        # [] int32
    dt_interval: torch.Tensor  # [] f32


def empty_imu_frame(sample_max: int, device="cuda") -> ImuFrameData:
    """An IMU window with no sample (types.empty_imu_frame)."""
    z = dict(device=torch.device(device))
    return ImuFrameData(gyro=torch.zeros((sample_max, 3), dtype=f32, **z),
                        acc=torch.zeros((sample_max, 3), dtype=f32, **z),
                        dt=torch.zeros((sample_max,), dtype=f32, **z),
                        n=torch.zeros((), dtype=i32, **z),
                        dt_interval=torch.zeros((), dtype=f32, **z))


@dataclasses.dataclass
class IntegratedImu(_TensorTree):
    """Result of integrating one inter-frame IMU buffer (imu.hpp:80-94)."""

    R: torch.Tensor      # [3,3] inter-frame rotation (camera frame)
    gyro: torch.Tensor   # [3] mean gyro (camera frame)
    acc: torch.Tensor    # [3] mean accelerometer (camera frame)
    dgyro: torch.Tensor  # [3] angular acceleration (camera frame)
    cacc: torch.Tensor   # [3] lever-arm-compensated acceleration
    dt_s: torch.Tensor   # [] integration interval [s]


@dataclasses.dataclass
class SabState(_TensorTree):
    """Scale/attitude/bias filter state (sab_estimator.hpp:37-64); carried,
    unused in vision-only mode.  X = [alpha, g(3), b(3)], K = tan(alpha)."""

    X: torch.Tensor    # [7]
    P: torch.Tensor    # [7,7]
    g_est: torch.Tensor  # [3]
    b_est: torch.Tensor  # [3]


def init_sab_state(cfg, device="cuda") -> SabState:
    import math

    device = torch.device(device)
    X = torch.tensor([math.pi / 4, 0.0, cfg.g_norm, 0.0, 0.0, 0.0, 0.0], dtype=f32,
                     device=device)
    P = torch.diag(torch.tensor([
        cfg.scale_std_dev_init ** 2, 100.0, 100.0, 100.0,
        cfg.vbias_std_dev ** 2 * 1e1, cfg.vbias_std_dev ** 2 * 1e1,
        cfg.vbias_std_dev ** 2 * 1e1,
    ], dtype=f32, device=device))
    z3 = torch.zeros(3, dtype=f32, device=device)
    return SabState(X=X, P=P, g_est=z3, b_est=z3.clone())


@dataclasses.dataclass
class ImuState(_TensorTree):
    """Inertial-fusion state threaded through frames (rebvio_tpu.types.ImuState)."""

    Bg: torch.Tensor
    W_Bg: torch.Tensor
    RGBias: torch.Tensor
    u_est: torch.Tensor
    initialized: torch.Tensor
    num_gyro_init: torch.Tensor
    gyro_init_acc: torch.Tensor
    g_init_acc: torch.Tensor
    vel_hist: torch.Tensor   # [5,3]
    dt_hist: torch.Tensor    # [4]
    acc_hist: torch.Tensor   # [4,3]


def init_imu_state(device="cuda") -> ImuState:
    device = torch.device(device)
    z = dict(dtype=f32, device=device)
    return ImuState(
        Bg=torch.zeros(3, **z),
        W_Bg=torch.eye(3, **z) * 1e-2,
        RGBias=torch.eye(3, **z),
        u_est=torch.tensor([1.0, 0.0, 0.0], **z),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
        num_gyro_init=torch.zeros((), dtype=i32, device=device),
        gyro_init_acc=torch.zeros(3, **z),
        g_init_acc=torch.zeros(3, **z),
        vel_hist=torch.zeros((5, 3), **z),
        dt_hist=torch.zeros((4,), **z),
        acc_hist=torch.zeros((4, 3), **z),
    )


@dataclasses.dataclass
class VioState(_TensorTree):
    """Full estimator state (rebvio_tpu.types.VioState)."""

    edge_map: EdgeMap
    imu_state: ImuState
    sab_state: SabState
    K: torch.Tensor
    Pos: torch.Tensor
    R_global: torch.Tensor
    P_Kp: torch.Tensor
    num_frames: torch.Tensor
    frames_seen: torch.Tensor
    detector_threshold: torch.Tensor
    keylines_count: torch.Tensor
    run_ok: torch.Tensor


@dataclasses.dataclass
class Odometry(_TensorTree):
    """Per-frame output record."""

    orientation: torch.Tensor  # [3]
    position: torch.Tensor     # [3]
    num_matches: torch.Tensor  # [] int32
    run_ok: torch.Tensor       # [] bool


def init_vio_state(config: PipelineConfig, device="cuda") -> VioState:
    dev = torch.device(device)
    kmax = config.detector.keylines_max
    cam = config.camera
    z = dict(dtype=f32, device=dev)
    return VioState(
        edge_map=empty_edge_map(kmax, cam.rows, cam.cols, config.field_scale, dev),
        imu_state=init_imu_state(dev),
        sab_state=init_sab_state(config.imu, dev),
        K=torch.ones((), **z),
        Pos=torch.zeros(3, **z),
        R_global=torch.eye(3, **z),
        P_Kp=torch.full((), 5e-6, **z),
        num_frames=torch.zeros((), dtype=i32, device=dev),
        frames_seen=torch.zeros((), dtype=i32, device=dev),
        detector_threshold=torch.full((), config.detector.threshold, **z),
        keylines_count=torch.zeros((), dtype=i32, device=dev),
        run_ok=torch.ones((), dtype=torch.bool, device=dev),
    )
