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


def make_random_map(rng, K, kmax, H, W, margin=3, unique_cells=True):
    """Random valid keylines with plausible geometry (the port's copy of
    tests/helpers.make_random_map), as a JAX EdgeMap and the same map as the
    port's EdgeMap on the CPU.  ``unique_cells`` keeps one keyline per pixel
    cell, as the detector does; without it positions are free, so several
    keylines may share a cell even at scale 1."""
    pos = np.zeros((K, 2), np.float32)
    cells_used = set()
    for i in range(K):
        for _ in range(200):
            c = np.array([rng.uniform(margin, W - margin), rng.uniform(margin, H - margin)])
            cell = (int(np.floor(c[1] + 0.5)), int(np.floor(c[0] + 0.5)))
            if not unique_cells or cell not in cells_used:
                cells_used.add(cell)
                pos[i] = c
                break
        else:
            raise RuntimeError("could not place unique keyline")
    ang = rng.uniform(0, 2 * np.pi, K)
    mag = rng.uniform(50.0, 300.0, K)
    grad = np.stack([np.cos(ang) * mag, np.sin(ang) * mag], axis=-1).astype(np.float32)
    return map_from_table(pos, grad, kmax, H, W,
                          rho=rng.uniform(0.05, 3.0, K).astype(np.float32),
                          sigma_rho=rng.uniform(0.1, 10.0, K).astype(np.float32))


def map_from_table(pos, grad, kmax, H, W, valid=None, rho=None, sigma_rho=None,
                   threshold=-1.0):
    """(JAX EdgeMap, port EdgeMap) holding the keyline table ``pos``/``grad``
    [K, 2] in slots 0..K-1; ``valid`` [K] defaults to all."""
    import jax.numpy as jnp

    from rebvio_tpu import types as jT

    K = len(pos)
    pos = np.asarray(pos, np.float32)
    grad = np.asarray(grad, np.float32)
    v = np.zeros(kmax, bool)
    v[:K] = True if valid is None else valid
    id_img = np.full((H, W), -1, np.int32)
    for i in range(K):
        r, c = int(np.floor(pos[i, 1] + 0.5)), int(np.floor(pos[i, 0] + 0.5))
        if v[i] and 0 <= r < H and 0 <= c < W:
            id_img[r, c] = i
    pos_img = pos - np.array([W / 2.0, H / 2.0], np.float32)

    def pad(a, fill=0.0):
        out = np.full((kmax,) + a.shape[1:], fill, a.dtype)
        out[:K] = a
        return jnp.asarray(out)

    em = jT.empty_edge_map(kmax, H, W).replace(
        pos=pad(pos), pos_img=pad(pos_img), match_pos_img=pad(pos_img),
        grad=pad(grad), grad_norm=pad(np.linalg.norm(grad, axis=-1).astype(np.float32)),
        valid=jnp.asarray(v), count=jnp.asarray(int(v.sum()), jnp.int32),
        kl_id_img=jnp.asarray(id_img), threshold=jnp.asarray(threshold, jnp.float32))
    if rho is not None:
        em = em.replace(rho=pad(rho, jT.RHO_INIT), sigma_rho=pad(sigma_rho, 20.0))
    return em, edge_map_t(em)
