"""The port's tube matcher (kernel K4's plain version inside
``directed_match_tube``) against the JAX ``directed_match_tube`` with
``tube_match_pallas`` in interpret mode, at 8 and 4 probes."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import edge_map_t, small_frame_pair, t2n, to_np, use_pallas  # noqa: E402

from rebvio_tpu.configs import EdgeMapConfig as JEdgeMapConfig  # noqa: E402
from rebvio_tpu.ops import matching as jM, tracker as jTr  # noqa: E402
from rebvio_tpu_torch.configs import CameraConfig, CoreConfig, EdgeMapConfig  # noqa: E402
from rebvio_tpu_torch.geometry import so3 as tso3  # noqa: E402
from rebvio_tpu_torch.ops import kernels, matching as tM  # noqa: E402


@pytest.fixture(scope="module")
def matched_pair():
    """(new map after forward matching, rotated old map, vel, Rvel, config)
    from a real small frame pair, with evolved depths on the old map."""
    with pytest.MonkeyPatch.context() as mp:
        m0, m1, jc = small_frame_pair(mp)
        use_pallas(mp, "TRYVEL", "TUBE")
        rng = np.random.RandomState(11)
        K = m0.kmax
        m0 = m0.replace(rho=jnp.asarray(rng.uniform(0.3, 1.5, K).astype(np.float32)),
                        sigma_rho=jnp.asarray(rng.uniform(0.05, 1.0, K).astype(np.float32)),
                        matches=jnp.asarray(rng.randint(0, 7, K).astype(np.int32)),
                        match_id_keyframe=jnp.asarray(rng.randint(-1, 30, K).astype(np.int32)))
        v, Rv, old, _ = jTr.minimize_vel(m0, m1, m1.att_img, jnp.zeros(3, jnp.float32),
                                         jc.core, jc.camera, jc.field_scale, use_att=True)
        new, _ = jM.forward_match(old, m1)
        yield new, old, v, Rv, jc, mp
        jax.clear_caches()


def _cams(jc):
    cam = CameraConfig(**{k: getattr(jc.camera, k) for k in jc.camera.__dataclass_fields__})
    core = CoreConfig(**{k: getattr(jc.core, k) for k in jc.core.__dataclass_fields__})
    return cam, core


@pytest.mark.parametrize("probes,w", [(8, (0.004, -0.006, 0.003)), (8, (0.0, 0.0, 0.0)),
                                      (4, (0.004, -0.006, 0.003))])
def test_directed_match_tube_matches_pallas(matched_pair, probes, w):
    new, old, v, Rv, jc, _ = matched_pair
    cam, core = _cams(jc)
    jem = JEdgeMapConfig(tube_probes=probes)
    tem = EdgeMapConfig(tube_probes=probes)
    R = t2n(tso3.exp(torch.tensor(w, dtype=torch.float32)))
    Rback = R.T.copy()
    old_r = jM.rotate_keylines(old, jnp.asarray(R), jc.camera.fm)
    M2 = R[:2, :2].copy()
    want, n = jM.directed_match_tube(new, old_r, v, Rv, jnp.asarray(Rback), jem, jc.core,
                                     jc.camera, field_scale=jc.field_scale,
                                     grad_rot2=jnp.asarray(M2), use_pallas=True)
    got, tn = tM.directed_match_tube(edge_map_t(new), edge_map_t(old_r),
                                     torch.as_tensor(np.asarray(v)),
                                     torch.as_tensor(np.asarray(Rv)), torch.as_tensor(Rback),
                                     tem, core, cam, field_scale=jc.field_scale,
                                     grad_rot2=torch.as_tensor(M2))
    assert int(tn) == int(n) > 300
    w_, g = to_np(want), {k: t2n(x) for k, x in vars(got).items()}
    # winners, ids and counters exact; the winner's payload is copied
    # through unchanged, the replayed gradient and pose are float32
    # products (XLA:CPU may fuse them into FMAs)
    for k in ("match_id", "matches", "match_id_keyframe", "rho", "sigma_rho",
              "match_grad_norm"):
        np.testing.assert_array_equal(g[k], w_[k], err_msg=k)
    for k in ("match_grad", "match_pos_img"):
        np.testing.assert_allclose(g[k], w_[k], rtol=1e-6, atol=1e-4, err_msg=k)


def test_tube_kernel_plain_tie_rule():
    """Two probes landing on the same candidate: the first probe wins, the
    payload is the candidate's, and no candidate means id -1."""
    K, N = 2, 4
    att = torch.full((8, N), -1.0)
    att[2, 1] = 0.0          # cell 1 holds keyline 0
    att[3, 1], att[4, 1], att[5, 1] = 1.0, 0.0, 1.0
    att[6, 1], att[7, 1] = 1.0, 0.0
    kl = torch.zeros((13, K))
    kl[0] = 1.0                               # tx
    kl[4], kl[5] = 0.0, 1.0                   # window [0, 1]
    kl[7] = 1.0                               # nt_eff
    kl[9], kl[11] = 1.0, 1.0                  # new gradient (1, 0), |g| 1
    kl[12] = torch.tensor([1.0, 0.0])         # only keyline 0 is valid
    dyn = torch.tensor([[0.5, 0.5], [5.0, 5.0], [3.0, 3.0], [7.0, 7.0]])
    geom = kernels.TubeGeom(P=2, H=1, W=4, field_scale=1, pum=2.0, cang_min=0.7,
                            norm_thr=1.0)
    out = kernels.tube_match(kl, att, dyn, torch.eye(2), geom)
    found, mid = t2n(out[0]), t2n(out[1])
    assert found.tolist() == [1.0, 0.0] and mid.tolist() == [0.0, -1.0]
    assert t2n(out[9])[0] == 3.0 and t2n(out[10])[0] == 7.0
