"""The port's parallel helpers over two gloo processes on the CPU
(tests/torch_parallel_worker.py): ``keyline_shard.make_minimize_vel_sharded``
on the attribute-field and id-field routes against the JAX package's
unsharded ``tracker.minimize_vel`` (tests/test_keyline_shard.py's inputs and
tolerances), ``multihost.make_pod_mesh`` / ``local_batch_slice`` against
JAX's for two processes, and ``batch.sharded_step_fn``: the two ranks'
lanes, gathered, against the one-process batched step."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_helpers import make_random_map  # noqa: E402

from rebvio_tpu.configs import CameraConfig as JCamera, CoreConfig as JCore  # noqa: E402
from rebvio_tpu.ops import distance_field as jDF, tracker as jtracker  # noqa: E402
from rebvio_tpu.parallel import multihost as JMH  # noqa: E402
from rebvio_tpu_torch import interop, types as tT  # noqa: E402
from rebvio_tpu_torch.configs import (CameraConfig, CoreConfig, EdgeDetectorConfig,  # noqa: E402
                                      ImuConfig, PipelineConfig)
from rebvio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from rebvio_tpu_torch.ops.imu import pack_imu_window  # noqa: E402
from rebvio_tpu_torch.parallel import batch as TB  # noqa: E402

WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD = 2
H, W, K, KMAX, R, FS = 48, 64, 100, 128, 8, 2
CAM = dict(rows=H, cols=W, cx=W / 2, cy=H / 2, fx=100, fy=100, k1=0, k2=0, k3=0, p1=0, p2=0)
TINY_CAMERA = dict(rows=48, cols=64, cx=32, cy=24, fx=60, fy=60, k1=0, k2=0, k3=0, p1=0, p2=0)
TINY_DETECTOR = dict(keylines_max=256, keylines_ref=128)
TINY_CORE = dict(search_range=8, global_min_matches_threshold=5)
LANES, STEPS = 4, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tiny_config() -> PipelineConfig:
    return PipelineConfig(camera=CameraConfig(**TINY_CAMERA),
                          detector=EdgeDetectorConfig(**TINY_DETECTOR),
                          core=CoreConfig(**TINY_CORE), imu=ImuConfig(sample_max=8),
                          use_imu=True)


def batch_inputs():
    """(frames [STEPS, LANES, H, W], IMU window leaves [STEPS, LANES, ...],
    intervals [STEPS, LANES]) of four synthetic sequences."""
    pc = tiny_config()
    seqs = [tsyn.generate(pc.camera, n_frames=STEPS, seed=s) for s in range(LANES)]
    frames = np.stack([[s.images[i].astype(np.float32) * pc.image_gain for s in seqs]
                       for i in range(STEPS)])
    wins = []
    for i in range(STEPS):
        lane = []
        for s in seqs:
            lo = np.searchsorted(s.imu_ts_us, s.ts_us[i - 1], side="right") if i else 0
            hi = np.searchsorted(s.imu_ts_us, s.ts_us[i], side="right")
            lane.append(interop.to_numpy(pack_imu_window(
                s.imu_gyro[lo:hi], s.imu_acc[lo:hi], s.imu_ts_us[lo:hi], 8, device="cpu")))
        wins.append({k: np.stack([w[k] for w in lane]) for k in lane[0]})
    imu = {k: np.stack([w[k] for w in wins]) for k in wins[0]}
    dts = np.stack([[0.0 if i == 0 else (s.ts_us[i] - s.ts_us[i - 1]) / 1e6 for s in seqs]
                    for i in range(STEPS)]).astype(np.float32)
    return frames, imu, dts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.RandomState(0)
    old_j, old_t = make_random_map(rng, K, KMAX, H, W)
    new_j, new_t = make_random_map(rng, K, KMAX, H, W)
    ids = jDF.field_id(jDF.build_distance_field(new_j, R, H, W), KMAX)
    att = jDF.build_att_field(new_j, R, H, W, FS)
    cam, core = JCamera(**CAM), JCore(search_range=R)
    want = {}
    for route, field, kw in (("id", ids, {}), ("att", att, dict(field_scale=FS, use_att=True))):
        vel, Rvel, old_out, F = jtracker.minimize_vel(old_j, new_j, field, jnp.zeros(3),
                                                      core, cam, **kw)
        want[route] = (np.asarray(vel), float(F), np.asarray(old_out.match_id_forward))
    frames, imu, dts = batch_inputs()
    cfg = dict(camera=CAM, core=dict(search_range=R), fs=FS, tiny_camera=TINY_CAMERA,
               tiny_detector=TINY_DETECTOR, tiny_core=TINY_CORE)
    src = tmp / "in.npz"
    np.savez(src, config=json.dumps(cfg), att=np.asarray(att), ids=np.asarray(ids),
             frames=frames, dts=dts, **{f"imu.{k}": v for k, v in imu.items()},
             **{f"old.{k}": v for k, v in interop.to_numpy(old_t).items()},
             **{f"new.{k}": v for k, v in interop.to_numpy(new_t).items()})
    port_no = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(WORLD), str(port_no),
                               str(src), str(tmp / f"out{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    for pr in procs:
        out, _ = pr.communicate(timeout=120)
        assert pr.returncode == 0, out.decode()[-3000:]
    return want, [dict(np.load(tmp / f"out{r}.npz")) for r in range(WORLD)], (frames, imu, dts)


@pytest.mark.parametrize("route", ["att", "id"])
def test_keyline_sharded_minimize_vel_matches_jax(runs, route):
    """tests/test_keyline_shard.py's tolerances: vel rtol 1e-4 atol 1e-6,
    score rtol 1e-4, the forward ids equal; both ranks hold one solution."""
    want, res, _ = runs
    vel, F, mif = want[route]
    for r in res:
        np.testing.assert_allclose(r[f"{route}.vel"], vel, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(r[f"{route}.score"]), F, rtol=1e-4)
        np.testing.assert_array_equal(r[f"{route}.mif"], mif)
    np.testing.assert_array_equal(res[0][f"{route}.vel"], res[1][f"{route}.vel"])
    assert (mif >= 0).sum() >= 10          # random maps: a few forward matches


def test_pod_mesh_and_batch_slice_match_jax(runs, monkeypatch):
    """Two processes: JAX's mesh over its 8 virtual devices (4 a process) and
    the port's over its two ranks (one device each) share the seq axis and
    its names, and each process owns the same block of a global batch."""
    _, res, _ = runs
    assert len(jax.devices()) >= 8
    monkeypatch.setattr(jax, "process_count", lambda: WORLD)
    for rank, r in enumerate(res):
        monkeypatch.setattr(jax, "process_index", lambda rank=rank: rank)
        jmesh = JMH.make_pod_mesh(inner_axis="kl")
        assert list(r["mesh_names"]) == list(jmesh.axis_names) == ["seq", "kl"]
        assert r["mesh_shape"][0] == jmesh.shape["seq"] == WORLD
        assert r["mesh_shape"][1] == 1
        assert tuple(r["slice8"]) == JMH.local_batch_slice(8, jmesh) == (4 * rank, 4)


def test_sharded_step_fn_equals_one_process(runs):
    """The ranks' lanes, gathered, equal the one-process batched step over
    all lanes, bit for bit (one thread in every process)."""
    _, res, (frames, imu, dts) = runs
    pc = tiny_config()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        st = TB.init_batched_state(pc, LANES, device="cpu")
        for i in range(STEPS):
            win = interop.imu_frame_from_numpy({k: v[i] for k, v in imu.items()}, device="cpu")
            st, odo = TB.batched_step(st, torch.as_tensor(frames[i]), win,
                                      torch.as_tensor(dts[i]), pc)
            rows = np.concatenate([odo.orientation.numpy(), odo.position.numpy(),
                                   odo.num_matches.numpy()[:, None]], axis=1)
            np.testing.assert_array_equal(np.concatenate([r[f"odo{i}"] for r in res]), rows)
    finally:
        torch.set_num_threads(threads)
    assert (rows[:, -1] > 0).all()
    for j, x in enumerate(tT.tree_leaves(st)):
        np.testing.assert_array_equal(np.concatenate([r[f"state{j}"] for r in res]), x.numpy())
