"""The port's ``utils``: the checkpoint round trip, its shape and key checks,
a checkpoint written by the JAX package loaded into the port (and the
port's into JAX), resume into a runner's state by copy (the addresses a
graph captures stay) continuing the stream bit for bit, the CLI's
``--checkpoint-out`` / ``--resume`` / ``--timing``, and the edge-image PNG
and the odometry file byte-equal to the JAX package's."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_helpers import make_random_map, small_configs, to_np  # noqa: E402

from rebvio_tpu import types as jT  # noqa: E402
from rebvio_tpu.utils import checkpoint as jck, logging as jlog, visualize as jvis  # noqa: E402
from rebvio_tpu_torch import interop, types as tT  # noqa: E402
from rebvio_tpu_torch.data import synthetic as tsyn  # noqa: E402
from rebvio_tpu_torch.graph import copy_tree_  # noqa: E402
from rebvio_tpu_torch.runner import VioRunner  # noqa: E402
from rebvio_tpu_torch.utils import checkpoint, logging as tlog, timing, visualize  # noqa: E402


def _filled_jax_state(jc, seed=0):
    """A JAX VioState whose leaves all hold seeded values (bools flipped,
    ints and floats random), so a leaf read into the wrong place shows."""
    rng = np.random.RandomState(seed)

    def fill(x):
        a = np.asarray(x)
        if a.dtype == bool:
            return jnp.asarray(rng.rand(*a.shape) < 0.5)
        if np.issubdtype(a.dtype, np.integer):
            return jnp.asarray(rng.randint(-1, 1000, a.shape).astype(a.dtype))
        return jnp.asarray(np.asarray(rng.randn(*a.shape)).astype(a.dtype))

    import jax

    return jax.tree.map(fill, jT.init_vio_state(jc))


def _equal_trees(a, b):
    la, lb = tT.tree_leaves(a), tT.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_checkpoint_round_trip(tmp_path):
    jc, tc = small_configs()
    state = interop.state_from_numpy(to_np(_filled_jax_state(jc)), device="cpu")
    path = str(tmp_path / "sub" / "ck.npz")
    checkpoint.save(path, state)
    back = checkpoint.load(path, tT.init_vio_state(tc, device="cpu"))
    _equal_trees(back, state)
    with np.load(path) as z:
        assert ".edge_map/.pos" in z and ".K" in z and len(z.files) == len(tT.tree_leaves(state))


def test_checkpoint_shape_mismatch_and_missing_leaf_raise(tmp_path):
    jc, tc = small_configs()
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, tT.init_vio_state(tc, device="cpu"))
    other = dataclasses.replace(tc, detector=dataclasses.replace(tc.detector, keylines_max=1024))
    with pytest.raises(ValueError, match=r"\.edge_map/\.pos"):
        checkpoint.load(path, tT.init_vio_state(other, device="cpu"))
    with np.load(path) as z:
        kept = {k: z[k] for k in z.files if k != ".K"}
    np.savez(str(tmp_path / "short.npz"), **kept)
    with pytest.raises(KeyError, match=r"\.K"):
        checkpoint.load(str(tmp_path / "short.npz"), tT.init_vio_state(tc, device="cpu"))


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    """A state saved by the JAX package's checkpoint.save loads equal to
    interop.state_from_numpy of the same state, and the port's file loads
    into the JAX package's template equal to the original."""
    jc, tc = small_configs()
    js = _filled_jax_state(jc, seed=1)
    jck.save(str(tmp_path / "jax.npz"), js)
    got = checkpoint.load(str(tmp_path / "jax.npz"), tT.init_vio_state(tc, device="cpu"))
    _equal_trees(got, interop.state_from_numpy(to_np(js), device="cpu"))
    checkpoint.save(str(tmp_path / "port.npz"), got)
    back = jck.load(str(tmp_path / "port.npz"), jT.init_vio_state(jc))
    import jax

    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_resume_copies_into_the_state_and_continues_the_stream(tmp_path):
    """12 frames, a checkpoint, then a fresh runner resumed from it (copied
    into its state: every leaf keeps its address) runs frames 12..19: equal
    to frames 12..19 of one 20-frame run, bit for bit."""
    _, tc = small_configs()
    seq = tsyn.generate(tc.camera, n_frames=20, seed=0)
    full = VioRunner(tc, undistort=False, device="cpu").run(seq)
    first = VioRunner(tc, undistort=False, device="cpu")
    head = dataclasses.replace(seq, images=seq.images[:12], ts_us=seq.ts_us[:12])
    first.run(head)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, first.state)

    r = VioRunner(tc, undistort=False, device="cpu")
    ptrs = [x.data_ptr() for x in tT.tree_leaves(r.state)]
    copy_tree_(r.state, checkpoint.load(path, r.state))
    assert [x.data_ptr() for x in tT.tree_leaves(r.state)] == ptrs
    assert int(r.state.frames_seen) == 12
    r.continue_after(int(seq.ts_us[11]), seq.imu_ts_us)
    tail = r.run(dataclasses.replace(seq, images=seq.images[12:], ts_us=seq.ts_us[12:]))
    for f in ("ts_us", "orientation", "position", "num_matches", "run_ok"):
        np.testing.assert_array_equal(getattr(tail, f), getattr(full, f)[12:], err_msg=f)


def test_run_cli_checkpoint_resume_timing(tmp_path, capsys):
    from rebvio_tpu_torch import run as run_mod

    base = ["--device", "cpu", "--preset", "small", "--mode", "vo"]
    ck, a, b = (str(tmp_path / n) for n in ("ck.npz", "a.txt", "b.txt"))
    assert run_mod.main(base + ["--frames", "14", "--odometry-out", a]) == 0
    assert run_mod.main(base + ["--frames", "8", "--checkpoint-out", ck]) == 0
    capsys.readouterr()
    assert run_mod.main(base + ["--frames", "14", "--resume", ck, "--odometry-out", b,
                                "--timing"]) == 0
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert out["frames"] == 6 and out["run_ok"]
    assert "run " in cap.err and "section" in cap.err
    with open(a) as fa, open(b) as fb:
        assert fb.read().splitlines() == fa.read().splitlines()[8:]
    with pytest.raises(SystemExit):
        run_mod.main(base + ["--frames", "8", "--resume", ck])   # nothing left to run
    capsys.readouterr()


def test_timing_sections():
    timing.reset()
    with timing.section("off"):
        pass
    timing.enable(True)
    try:
        for _ in range(3):
            with timing.section("on", sync=torch.zeros(1)):
                pass
        rep = timing.report()
    finally:
        timing.enable(False)
        timing.reset()
    assert "on " in rep and "off" not in rep and " 3 " in rep


def test_png_and_odometry_file_equal_jax(tmp_path):
    """render_edge_image + write_png_rgb on the same frame and map (port:
    tensors; JAX: arrays), and the odometry logger on the same rows: the
    same bytes."""
    rng = np.random.RandomState(3)
    H, W = 60, 90
    jem, tem = make_random_map(rng, 300, 512, H, W)
    mid = np.where(rng.rand(512) < 0.5, 3, -1).astype(np.int32)
    jem = jem.replace(match_id=jnp.asarray(mid))
    tem = tem.replace(match_id=torch.as_tensor(mid))
    frame = rng.uniform(0, 300, (H, W)).astype(np.float32)
    jimg = jvis.render_edge_image(frame, jem, gain=0.9)
    timg = visualize.render_edge_image(torch.as_tensor(frame), tem, gain=0.9)
    np.testing.assert_array_equal(timg, jimg)
    assert (timg[..., 0] != timg[..., 1]).sum() > 200
    jvis.write_png_rgb(str(tmp_path / "j.png"), jimg)
    visualize.write_png_rgb(str(tmp_path / "t.png"), timg)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()

    jl = jlog.OdometryLogger(str(tmp_path), "j.txt")
    tl = tlog.OdometryLogger(str(tmp_path), "t.txt")
    for i in range(5):
        o, p = rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32)
        jl.write(1_000_000 + 50_000 * i, o, p)
        tl.write(1_000_000 + 50_000 * i, o, p)
    jl.close()
    tl.close()
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert tlog.init() is tlog.get()
