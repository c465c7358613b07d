"""The port's step against JAX's at tests/test_batched.py's tiny
configuration (48x64, 256 keylines, VIO with a 2-frame bias-init window,
synthetic seed 0): where the two leave each other and why.

At frame 1 both count 232 matches, but new keyline 116 matches old keyline
106 in JAX and 112 in the port.  The matcher is not at fault: fed JAX's
inputs the port's ``directed_match_tube`` gives JAX's ids, and JAX's (the
Pallas tube in interpret mode) fed the port's gives the port's.  Probe 1 of
keyline 116 projects to x = 59.50005 px on JAX's inputs and 59.49999 on the
port's: on either side of the pixel edge at 59.5, so it reads another cell
of the old map's field (old keyline 126, priority 2.0, which loses to 106
at 0.77; or 112 at 0.16, which wins).  The inputs are 6.5e-5 px apart
there, from two float-noise sources, both present in JAX itself:
- ``so3.exp``'s (1 - cos t) / t^2 at t ~ 2.5e-4 rad (an IMU sample's
  rotation) is a one-ulp difference over t^2: XLA's cos rounds to
  1 - 2^-24 and PyTorch's to 1, so the coefficient is 0.92 in JAX and 0 in
  the port (0.5 is right).  Over 8 samples ``integrate_imu``'s R is 8 ulp
  apart; with XLA's cos the port's R is JAX's.
- ``tracker.ext_rot_vel``'s 7x7 Gram over 256 keylines sums in another
  order (XLA's dot, PyTorch's matmul): 6.5e-8 relative on the same inputs.
Neither is an order the port could copy (a library's cos; a library's
product), so the flip is pinned here: its inputs' gap bounded, the edge
shown, the whole step held at the bounds the flip allows."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_helpers import (PALLAS_FLAGS, jax_windows, port_window, t2n, tiny_config,  # noqa: E402
                           to_np, use_pallas)

import rebvio_tpu.configs as jcfg  # noqa: E402
import rebvio_tpu_torch.configs as tcfg  # noqa: E402
from rebvio_tpu import pipeline as JP, types as jT  # noqa: E402
from rebvio_tpu.data import synthetic as jsyn  # noqa: E402
from rebvio_tpu.ops import imu as jimu, matching as JM, tracker as JTR  # noqa: E402
from rebvio_tpu_torch import interop, pipeline as TP, types as tT  # noqa: E402
from rebvio_tpu_torch.geometry import so3 as tso3  # noqa: E402
from rebvio_tpu_torch.ops import imu as timu, kernels, matching as TM, tracker as TTR  # noqa: E402

N_FRAMES = 4
FLIP = {116: (106, 112)}        # new keyline: (JAX's old keyline, the port's)
# the matcher's inputs at frame 1, port against JAX (measured on the CPU,
# torch 2.13, JAX jitted: V, Rback 1.04e-6, 1.0e-6; grad_rot2 4.8e-7; the
# rotated old map's pos_img 9.3e-5 px = fm x 1.6e-6 rad; every other float
# plane of both maps 2.5e-5; every integer and bool plane equal)
GAP = dict(V=4e-6, Rback=4e-6, grad_rot2=2e-6, P_V=1e-9, old_pos_img=3e-4, planes=1e-4)
EDGE_PX = 1e-4                  # the flipping probe's distance to its pixel edge
ULP = 2.0 ** -24             # float32's spacing just below 1
# whole step, frames 0..3: match counts within 1 % (VIO 232, 217 / 215, 229 /
# 230; VO 233, 220 / 221, 232 / 232); VO positions 1.9e-3 m apart in a
# 0.0199 m span (9.7 %; at frame 1, before any flip, 3.1e-7 m)
MATCH_RTOL = 0.01
POS_SPAN_FRAC = 0.2


def _inputs(jc, n):
    seq = jsyn.generate(jc.camera, n_frames=n, seed=0)
    wins = jax_windows(seq, n, jc.imu.sample_max)
    frames = [seq.images[i].astype(np.float32) * jc.image_gain for i in range(n)]
    dts = [0.0 if i == 0 else (seq.ts_us[i] - seq.ts_us[i - 1]) / 1e6 for i in range(n)]
    return frames, wins, dts


def _jax_run(jc, frames, wins, dts, record=False):
    """JAX's jitted step over the frames; with ``record`` the tube matcher's
    inputs and output ids and ext_rot_vel's inputs at every estimate,
    passed out of the jitted step by host callbacks."""
    calls = {"tube": [], "erv": []}
    with pytest.MonkeyPatch.context() as mp:
        if record:
            tube, erv = JM.directed_match_tube, JTR.ext_rot_vel

            def tube_rec(new, old, vel, Rvel, Rback, cfg, core_cfg, cam, **kw):
                out = tube(new, old, vel, Rvel, Rback, cfg, core_cfg, cam, **kw)
                jax.debug.callback(lambda *a: calls["tube"].append(jax.tree.map(np.asarray, a)),
                                   (new, old, vel, Rvel, Rback, kw["grad_rot2"]),
                                   out[0].match_id)
                return out

            def erv_rec(new, vel, cfg, cam):
                jax.debug.callback(lambda *a: calls["erv"].append(jax.tree.map(np.asarray, a)),
                                   new, vel)
                return erv(new, vel, cfg, cam)

            mp.setattr(JM, "directed_match_tube", tube_rec)
            mp.setattr(JTR, "ext_rot_vel", erv_rec)
        jax.clear_caches()
        jstep = jax.jit(JP.step, static_argnames=("config",))
        st, rows = jT.init_vio_state(jc), []
        for i in range(len(frames)):
            st, o = jstep(st, jnp.asarray(frames[i]), wins[i], jnp.float32(dts[i]), config=jc)
            rows.append(to_np(o))
        jax.block_until_ready(st)
        jax.clear_caches()
    return rows, calls


def _port_run(tc, frames, wins, dts, mp=None):
    """The port's step over the frames; with ``mp`` the matcher's inputs at
    every estimate (match_and_update_depth's arguments, which the step passes
    to its stage generator match_and_update_depth_stages)."""
    calls = []
    if mp is not None:
        stage = TM.match_and_update_depth_stages

        def rec(*a, **kw):
            calls.append((a, kw))
            return stage(*a, **kw)
        mp.setattr(TM, "match_and_update_depth_stages", rec)
    mats = TP.frontend_matrices(tc, "cpu")
    st, rows = tT.init_vio_state(tc, device="cpu"), []
    for i in range(len(frames)):
        st, o = TP.step(st, torch.as_tensor(frames[i]), port_window(wins[i]), dts[i], tc, mats)
        rows.append({k: t2n(getattr(o, k)) for k in ("position", "num_matches")})
    return rows, calls


@pytest.fixture(scope="module")
def vio():
    with pytest.MonkeyPatch.context() as mp:
        use_pallas(mp, *PALLAS_FLAGS)
        jc, tc = tiny_config(jcfg, True), tiny_config(tcfg, True)
        frames, wins, dts = _inputs(jc, N_FRAMES)
        jrows, jcalls = _jax_run(jc, frames, wins, dts, record=True)
        trows, tcalls = _port_run(tc, frames, wins, dts, mp)
        # frame 1's matcher inputs: (new, old, V, P_V, Rback, grad_rot2)
        jin = jcalls["tube"][1][0]
        a, kw = tcalls[1]
        tin = (*a[:5], kw["grad_rot2"])
        return dict(jc=jc, tc=tc, jrows=jrows, trows=trows, jin=jin, jids=jcalls["tube"][1][1],
                    tin=tin, erv=jcalls["erv"][1], win=wins[1])


def _port_edge_map(d):
    return interop.edge_map_from_numpy(to_np(d), device="cpu")


def _jax_edge_map(em):
    return jT.EdgeMap(**{k: jnp.asarray(v) for k, v in interop.to_numpy(em).items()})


def _jax_inputs_as_port(jin):
    new, old, *rest = jin
    return (_port_edge_map(new), _port_edge_map(old), *(torch.as_tensor(np.array(x))
                                                        for x in rest))


def _port_match(tc, new, old, V, P_V, Rback, M2):
    """The port's directed_match_tube: (match ids, K4's probes [11, P, K]
    (kernels.tube_probes), K4's per-keyline inputs [13, K], its geometry)."""
    rec = {}
    tube = kernels.tube_match

    def recording(*a):
        rec["a"] = a
        return tube(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "tube_match", recording)
        em, _klm = TM.directed_match_tube(new, old, V, P_V, Rback, tc.edge_map, tc.core,
                                          tc.camera, field_scale=tc.field_scale, grad_rot2=M2)
    return t2n(em.match_id), kernels.tube_probes(*rec["a"]), rec["a"][0], rec["a"][-1]


def test_port_matcher_gives_jax_ids_on_jax_inputs(vio):
    ids, *_ = _port_match(vio["tc"], *_jax_inputs_as_port(vio["jin"]))
    np.testing.assert_array_equal(ids, vio["jids"])


def test_jax_matcher_gives_port_ids_on_port_inputs(vio):
    """The flip is JAX's own sensitivity: its matcher, fed the port's
    inputs, flips the same keyline the same way."""
    jc = vio["jc"]
    new, old, V, P_V, Rback, M2 = vio["tin"]
    port_ids, *_ = _port_match(vio["tc"], *vio["tin"])
    em, _ = JM.directed_match_tube(_jax_edge_map(new), _jax_edge_map(old),
                                   *(jnp.asarray(t2n(x)) for x in (V, P_V, Rback)), jc.edge_map,
                                   jc.core, jc.camera, field_scale=jc.field_scale,
                                   grad_rot2=jnp.asarray(t2n(M2)))
    np.testing.assert_array_equal(np.asarray(em.match_id), port_ids)
    flipped = np.nonzero(port_ids != vio["jids"])[0]
    assert {int(k): (int(vio["jids"][k]), int(port_ids[k])) for k in flipped} == FLIP


def test_flip_is_a_probe_on_a_pixel_edge(vio):
    """Each probe of the flipped keyline on both inputs: the old keyline it
    reads and its priority (1e9: a gate failed); the one probe that reads
    another keyline projects within EDGE_PX of a pixel edge, on either side
    of it."""
    (k, (j_old, t_old)), = FLIP.items()
    side = {}
    for label, ins in (("JAX's inputs", _jax_inputs_as_port(vio["jin"])),
                       ("the port's inputs", vio["tin"])):
        _ids, probes, kl, g = _port_match(vio["tc"], *ins)
        lam = torch.arange(g.P, dtype=torch.float32) / (g.P - 1)
        t = kl[4, k] + (kl[5, k] - kl[4, k]) * lam
        px, py = kl[0, k] * t + kl[2, k], kl[1, k] * t + kl[3, k]
        side[label] = (t2n(probes[0, :, k]).astype(int), t2n(probes[10, :, k]), t2n(px), t2n(py))
        print(f"keyline {k} on {label}: (probe, old keyline, priority, x, y)",
              [(p, int(o), float(s), float(x), float(y))
               for p, (o, s, x, y) in enumerate(zip(*side[label]))])
    (jo, js, jx, jy), (to, ts, tx, ty) = side.values()
    assert jo[np.argmin(js)] == j_old and to[np.argmin(ts)] == t_old
    (p,) = np.nonzero(jo != to)[0]
    assert t_old in to and t_old not in jo
    print(f"the winners: JAX {j_old} at {js.min()}, the port {t_old} at {ts.min()}; probe {p} "
          f"x {jx[p]} / {tx[p]}, y {jy[p]} / {ty[p]}")
    for a, b in ((jx[p], tx[p]), (jy[p], ty[p])):
        edge = np.floor(a + 0.5) - 0.5 if np.floor(a + 0.5) != np.floor(b + 0.5) else None
        if edge is not None:
            print(f"probe {p}: {a - edge:+.3g} / {b - edge:+.3g} px from the edge at {edge}")
            assert abs(a - edge) < EDGE_PX and abs(b - edge) < EDGE_PX
            break
    else:
        raise AssertionError("the flipped probe rounds to the same pixel on both inputs")


def test_matcher_input_gaps_bounded(vio):
    jnew, jold, *jrest = vio["jin"]
    tnew, told, *trest = vio["tin"]
    gaps = {name: float(np.abs(np.asarray(j) - t2n(t)).max())
            for name, j, t in zip(("V", "P_V", "Rback", "grad_rot2"), jrest, trest)}
    planes = {}
    for side, j, t in (("new", to_np(jnew), interop.to_numpy(tnew)),
                       ("old", to_np(jold), interop.to_numpy(told))):
        for name, a in j.items():
            a, b = np.asarray(a), t[name]
            if a.dtype.kind == "f":
                planes[f"{side}.{name}"] = float(np.abs(a.astype(np.float64) - b).max())
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{side}.{name}")
    gaps["old_pos_img"] = planes.pop("old.pos_img")
    gaps["planes"] = max(planes.values())
    print("frame 1's matcher inputs, port against JAX:", gaps, planes)
    for name, bound in GAP.items():
        assert gaps[name] < bound, (name, gaps[name], bound)


def test_first_gaps_are_float_noise(vio):
    """Walking back from the matcher: the first stages whose outputs differ
    by more than a few ulp.  integrate_imu's R (8 ulp) comes from so3.exp's
    (1 - cos t) / t^2 at t ~ 2.5e-4 rad, a one-ulp difference of cos: with
    XLA's cos the port's R is JAX's.  ext_rot_vel on JAX's own inputs: its
    Gram (the sum over 256 keylines) and solve in another order."""
    jc, tc = vio["jc"], vio["tc"]
    R_c2i = np.asarray(jc.camera.R_c2i_np(), np.float32)
    t_c2i = np.asarray(jc.camera.t_c2i_np(), np.float32)
    want = np.asarray(jax.jit(jimu.integrate_imu)(vio["win"], R_c2i, t_c2i).R)

    def port_R():
        return t2n(timu.integrate_imu(port_window(vio["win"]), torch.as_tensor(R_c2i),
                                      torch.as_tensor(t_c2i)).R)

    gap = float(np.abs(port_R() - want).max())
    xla_cos = jax.jit(jnp.cos)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tso3.torch, "cos",
                   lambda x, _cos=torch.cos: torch.as_tensor(np.array(xla_cos(t2n(x))))
                   if x.dtype == torch.float32 else _cos(x))
        gap_xla_cos = float(np.abs(port_R() - want).max())
    t = np.float32(2.5e-4)
    print(f"integrate_imu R: {gap} ({gap / ULP:.1f} ulp below 1), with XLA's cos "
          f"{gap_xla_cos}; (1 - cos t) at t = {t}: XLA {1 - np.asarray(xla_cos(t))}, PyTorch "
          f"{1 - t2n(torch.cos(torch.as_tensor(t)))}, exact {1 - np.cos(np.float64(t))}")
    assert ULP < gap <= 16 * ULP
    assert gap_xla_cos < 1e-9

    new, vel = vio["erv"]
    jX, jW = jax.jit(JTR.ext_rot_vel, static_argnames=("cfg", "cam"))(
        jT.EdgeMap(**to_np(new)), vel, cfg=jc.core, cam=jc.camera)
    tX, tW = TTR.ext_rot_vel(_port_edge_map(new), torch.as_tensor(np.array(vel)), tc.core,
                             tc.camera)
    w_rel = float(np.abs(np.asarray(jW) - t2n(tW)).max() / np.abs(np.asarray(jW)).max())
    x_gap = float(np.abs(np.asarray(jX) - t2n(tX)).max())
    print(f"ext_rot_vel on JAX's inputs: Gram {w_rel} relative, X {x_gap}")
    assert 0 < w_rel < 1e-6 and x_gap < 1e-6


@pytest.mark.parametrize("mode", ["vio", "vo"])
def test_whole_step_agreement(vio, mode):
    """Frames 0..3: match counts within MATCH_RTOL; VO positions within
    POS_SPAN_FRAC of JAX's span (VIO's stay at the origin until the SAB
    filter engages, after frame 6)."""
    if mode == "vio":
        jrows, trows = vio["jrows"], vio["trows"]
    else:
        with pytest.MonkeyPatch.context() as mp:
            use_pallas(mp, *PALLAS_FLAGS)
            jc, tc = tiny_config(jcfg, False), tiny_config(tcfg, False)
            frames, wins, dts = _inputs(jc, N_FRAMES)
            jrows, _ = _jax_run(jc, frames, wins, dts)
            trows, _ = _port_run(tc, frames, wins, dts)
    jm = np.array([r["num_matches"] for r in jrows])
    tm = np.array([r["num_matches"] for r in trows])
    jp = np.stack([r["position"] for r in jrows])
    tp = np.stack([r["position"] for r in trows])
    span = float(np.linalg.norm(jp - jp[0], axis=-1).max())
    gap = np.linalg.norm(tp - jp, axis=-1)
    print(mode, "matches", jm.tolist(), tm.tolist(), "span", span, "position gaps", gap.tolist())
    assert jm[0] == tm[0] == 0
    np.testing.assert_allclose(tm[1:], jm[1:], rtol=MATCH_RTOL)
    if mode == "vo":
        assert span > 0 and gap.max() < POS_SPAN_FRAC * span
