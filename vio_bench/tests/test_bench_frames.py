"""The frozen generator against the program's ``data.synthetic.generate``
on a small camera: the scene, the trajectory and the IMU bit for bit, the
device renderer's frames within rounding."""

import dataclasses

import numpy as np
import torch

from vio_bench import frames
from vio_bench.tests.conftest import SMALL_CAMERA

SCENE = dict(fps=20.0, imu_rate=200.0, imu_preroll_s=0.1, gravity=(0.0, -9.81, 0.0),
             speed=0.35, excitation=2.2, yaw_amp=0.06)


def _program_sequence(n: int, seed: int):
    from rebvio_tpu_torch.configs import CameraConfig
    from rebvio_tpu_torch.data import synthetic

    cam = CameraConfig(**SMALL_CAMERA)
    return cam, synthetic.generate(cam, n_frames=n, seed=seed, distort=True, imu_preroll_s=0.1,
                                   speed=SCENE["speed"], excitation=SCENE["excitation"],
                                   yaw_amp=SCENE["yaw_amp"])


def test_scene_trajectory_and_imu_bit_for_bit():
    from rebvio_tpu_torch.data import synthetic

    n, seed = 12, 7
    cam, seq = _program_sequence(n, seed)
    segs = frames.make_segments(np.random.RandomState(seed))
    assert np.array_equal(segs, synthetic.make_segments(np.random.RandomState(seed)))
    t = np.arange(n) / SCENE["fps"]
    for a, b in zip(frames.trajectory(t, 0.35, 0.06, 2.2),
                    synthetic.trajectory(t, 0.35, 0.06, 2.2)):
        assert np.array_equal(a, b)
    its, gyro, acc = frames.imu_stream(cam, n, SCENE["fps"], SCENE["imu_rate"], 0.0,
                                       SCENE["imu_preroll_s"], SCENE["gravity"], SCENE["speed"],
                                       SCENE["excitation"], SCENE["yaw_amp"])
    assert np.array_equal(its, seq.imu_ts_us)
    assert np.array_equal(gyro, seq.imu_gyro) and np.array_equal(acc, seq.imu_acc)


def test_device_render_equals_the_numpy_render_to_rounding():
    n, seed = 6, 3
    cam, seq = _program_sequence(n, seed)
    segs = frames.make_segments(np.random.RandomState(seed))
    pos, R_wc, _, _, _ = frames.trajectory(np.arange(n) / SCENE["fps"], 0.35, 0.06, 2.2)
    img = frames.render(segs, pos, R_wc, cam, "cpu", distort=True).numpy()
    assert np.abs(img - seq.images).max() < 1e-3
    u8 = np.clip(np.round(img), 0, 255).astype(np.uint8)
    ref = np.clip(np.round(seq.images), 0, 255).astype(np.uint8)
    diff = np.abs(u8.astype(int) - ref)
    assert diff.max() <= 1 and np.mean(diff > 0) < 1e-4


def test_same_seed_same_bytes_other_seed_other_scene():
    from rebvio_tpu_torch.configs import CameraConfig

    cam = CameraConfig(**SMALL_CAMERA)
    scene = dict(SCENE, segments=260, start_time_max_s=2.0, distort=True)
    big = 2 ** 31 + 12345
    a = frames.make_stream(cam, scene, 4, big, 0, "cpu")
    b = frames.make_stream(cam, scene, 4, big, 0, "cpu")
    c = frames.make_stream(cam, scene, 4, big, 1, "cpu")
    assert a.images.dtype == torch.uint8 and a.images.shape == (4, cam.rows, cam.cols)
    for f in dataclasses.fields(frames.Stream):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (torch.equal(x, y) if torch.is_tensor(x) else np.array_equal(x, y)), f.name
    assert not torch.equal(a.images, c.images)
    # the IMU covers the frames, from before the first
    assert a.imu_ts_us[0] < a.ts_us[0] and a.imu_ts_us[-1] >= a.ts_us[-1] - 5000
