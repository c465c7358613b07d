"""Shared helpers of the port's CPU tests: the same inputs through the JAX
package and through rebvio_tpu_torch (device="cpu", plain versions)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

import rebvio_tpu.configs as jcfg
import rebvio_tpu_torch.configs as tcfg
from rebvio_tpu_torch import interop

PALLAS_FLAGS = ("JFA", "TRYVEL", "TUBE", "REGEKF")

# run.py's `small` preset: 120x188 frames, 2048 = 16x128 keylines, search range 10
SMALL_CAMERA = dict(rows=120, cols=188, fx=114.6, fy=114.3, cx=91.8, cy=62.1,
                    k1=0, k2=0, k3=0, p1=0, p2=0)
SMALL_DETECTOR = dict(keylines_max=2048, keylines_ref=1200)
SMALL_CORE = dict(search_range=10, global_min_matches_threshold=100)


# EuRoC's rad-tan coefficients (normalized coordinates, so any resolution)
EUROC_DISTORTION = dict(k1=-0.28340811, k2=0.07395907, k3=0.0, p1=0.00019359,
                        p2=1.76187114e-05)


def small_config(mod, **kw):
    """The small vision-only PipelineConfig from configs module ``mod``
    (rebvio_tpu.configs or rebvio_tpu_torch.configs)."""
    return mod.PipelineConfig(camera=mod.CameraConfig(**SMALL_CAMERA),
                              detector=mod.EdgeDetectorConfig(**SMALL_DETECTOR),
                              core=mod.CoreConfig(**SMALL_CORE), use_imu=False, **kw)


def small_configs(**kw):
    return small_config(jcfg, **kw), small_config(tcfg, **kw)


def small_vio_config(mod):
    """The small preset with the IMU and SAB filter on, a camera with EuRoC's
    distortion, and a 2-frame bias-init window: SAB is engaged once
    num_frames > 4 + 2, from frame 8 (the 8th estimate) on."""
    return mod.PipelineConfig(camera=mod.CameraConfig(**{**SMALL_CAMERA, **EUROC_DISTORTION}),
                              detector=mod.EdgeDetectorConfig(**SMALL_DETECTOR),
                              core=mod.CoreConfig(**SMALL_CORE),
                              imu=mod.ImuConfig(init_bias_frame_num=2), use_imu=True)


def small_vio_configs():
    return small_vio_config(jcfg), small_vio_config(tcfg)


def use_pallas(monkeypatch, *flags):
    """Force the named Pallas kernels (interpret mode off the TPU) and drop
    jit caches that baked in another choice at trace time."""
    for f in flags:
        monkeypatch.setenv("REBVIO_PALLAS_" + f, "1")
    jax.clear_caches()


def to_np(tree):
    """A JAX state pytree (flax struct dataclass / NamedTuple) as a nested
    dict of numpy arrays with the same field names."""
    if dataclasses.is_dataclass(tree):
        return {f.name: to_np(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if hasattr(tree, "_asdict"):
        return {k: to_np(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def edge_map_t(jax_em):
    return interop.edge_map_from_numpy(to_np(jax_em), device="cpu")


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def small_frame_pair(monkeypatch):
    """Two detected frames of the small synthetic sequence as JAX EdgeMaps
    with their attribute fields (Pallas flood in interpret mode), and the
    JAX config.  Returns (m0, m1, config)."""
    import jax.numpy as jnp

    from rebvio_tpu.data import synthetic
    from rebvio_tpu.ops import distance_field as DF, edge_detect
    from rebvio_tpu.pipeline import frontend_matrices

    use_pallas(monkeypatch, "JFA")
    jc, _ = small_configs()
    cam, det = jc.camera, jc.detector
    sr = int(jc.core.search_range)
    mats = frontend_matrices(jc)
    seq = synthetic.generate(cam, n_frames=2, seed=0)
    maps = []
    for i in range(2):
        em, stack = edge_detect.detect_with_seeds(
            jnp.asarray(seq.images[i] * jc.image_gain), jnp.float32(det.threshold), mats,
            det, cam, jc.field_scale, sr)
        att = DF.build_att_field(em, sr, cam.rows, cam.cols, jc.field_scale,
                                 seed_stack=stack)
        maps.append(em.replace(att_img=att))
    return maps[0], maps[1], jc
