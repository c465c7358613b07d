"""EuRoC input of the port: ``data/euroc.py`` against the JAX package's
``euroc.load`` field by field on an ASL tree written by
tests/test_native_loader.py's writers, the in-process PNG decoder on every
row filter, the reader against JAX's with PIL and with PIL blocked, the
native prefetch ring (built from native/loader.cpp into
build/rebvio_loader/) against that decoder, and the CLI's ``--dataset
euroc`` against ``VioRunner(undistort=True)`` on the same uint8 frames and
IMU, bit for bit."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_asl import PNG_FILTERS, write_png_gray  # noqa: E402
from torch_helpers import SMALL_CAMERA  # noqa: E402
from tests.test_native_loader import _write_asl_tree  # noqa: E402

from rebvio_tpu.configs import CameraConfig as JCamera  # noqa: E402
from rebvio_tpu.data import euroc as jeuroc, synthetic as jsyn  # noqa: E402
from rebvio_tpu_torch import run as trun  # noqa: E402
from rebvio_tpu_torch.data import euroc as teuroc, native_loader  # noqa: E402

N_FRAMES = 8


@pytest.fixture(scope="module")
def asl_tree(tmp_path_factory):
    """An ASL tree (uint8 frames, alternately unfiltered and up-filtered,
    IMU, ground truth) of the small preset's synthetic stream, and that
    stream."""
    root = tmp_path_factory.mktemp("asl")
    cam = JCamera(**SMALL_CAMERA)
    seq = jsyn.generate(cam, n_frames=N_FRAMES, seed=0)
    _write_asl_tree(root, cam, seq, N_FRAMES, with_gt=True)
    return root, seq


def native_skip_reason():
    """Why the native loader cannot be built here, or None."""
    if shutil.which("g++") is None:
        return "g++ is not installed"
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <zlib.h>\n",
                           capture_output=True, text=True)
    if probe.returncode != 0:
        return "zlib.h is not installed"
    return None


@pytest.mark.parametrize("window", [(None, None), (0.1, 0.3)], ids=["whole", "start-end"])
def test_load_matches_jax(asl_tree, window):
    root, _ = asl_tree
    kw = dict(rows=SMALL_CAMERA["rows"], cols=SMALL_CAMERA["cols"], loader="python")
    j = jeuroc.load(str(root), *window, **kw)
    t = teuroc.load(str(root), *window, **kw)
    assert t.image_paths == j.image_paths and len(t) == len(j)
    if window[0] is not None:
        assert 0 < len(t) < N_FRAMES
    for name in ("ts_us", "imu_ts_us", "imu_gyro", "imu_acc", "gt_ts_us", "gt_pos"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (t.rows, t.cols, t.loader) == (j.rows, j.cols, j.loader)
    assert isinstance(t.rows, int)
    for i in (0, len(t) - 1):
        np.testing.assert_array_equal(t.images[i], j.images[i])


@pytest.mark.parametrize("filters", list(PNG_FILTERS) + [PNG_FILTERS],
                         ids=["none", "sub", "up", "avg", "paeth", "mixed"])
def test_read_png_gray_filters(tmp_path, filters):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (19, 29)).astype(np.uint8)
    img[5:9] = 255                         # flat rows: the predictors' wrap-around
    path = str(tmp_path / "f.png")
    write_png_gray(path, img, filters)
    for read in (teuroc._read_png_gray, teuroc._decode_png_numpy):
        got = read(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, img)


@pytest.fixture(scope="module")
def five_filter_tree(tmp_path_factory):
    """tests/torch_asl.py's ASL tree of the small stream, its rows cycling
    through the five PNG filters, and one RGB file."""
    from torch_asl import write_asl_tree

    pytest.importorskip("PIL.Image")
    root = tmp_path_factory.mktemp("asl5")
    seq = jsyn.generate(JCamera(**SMALL_CAMERA), n_frames=4, seed=1)
    frames = [np.clip(np.asarray(im), 0, 255).astype(np.uint8) for im in seq.images]
    write_asl_tree(root, frames, seq, len(frames))
    rgb = str(root / "rgb.png")
    write_png_gray(rgb, np.random.RandomState(6).randint(0, 256, (17, 23, 3)).astype(np.uint8),
                   PNG_FILTERS)
    return sorted(str(p) for p in (root / "mav0" / "cam0" / "data").glob("*.png")), rgb


@pytest.mark.parametrize("pil", [True, False], ids=["PIL", "PIL-blocked"])
def test_read_png_gray_matches_jax(five_filter_tree, monkeypatch, pil):
    """The port's reader is JAX's, bit for bit, with PIL (luma of an RGB
    file) and with PIL's import blocked (the numpy decoders: an RGB file's
    first channel)."""
    grays, rgb = five_filter_tree
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    for p in grays + [rgb]:
        got, want = teuroc._read_png_gray(p), jeuroc._read_png_gray(p)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=p)
    channel0 = teuroc._decode_png_numpy(rgb)
    assert np.array_equal(teuroc._read_png_gray(rgb), channel0) != pil


def test_numpy_decoder_equals_pil_on_gray(five_filter_tree):
    from PIL import Image

    grays, _ = five_filter_tree
    for p in grays:
        with Image.open(p) as im:
            np.testing.assert_array_equal(teuroc._decode_png_numpy(p), np.asarray(im))


def test_native_loader_matches_python_decoder(tmp_path):
    reason = native_skip_reason()
    if reason is not None:
        pytest.skip(f"the native loader cannot be built: {reason}")
    rng = np.random.RandomState(4)
    H, W = 21, 33
    paths, imgs = [], []
    for i, filters in enumerate(list(PNG_FILTERS) + [PNG_FILTERS]):
        img = rng.randint(0, 256, (H, W)).astype(np.uint8)
        paths.append(str(tmp_path / f"f{i}.png"))
        write_png_gray(paths[-1], img, filters)
        imgs.append(img)
    ld = native_loader.NativeImageLoader(paths, H, W, n_threads=2, ring=3, gain=1.0)
    for p, img in zip(paths, imgs):
        f = ld.next()
        np.testing.assert_array_equal(f, teuroc._read_png_gray(p).astype(np.float32))
        np.testing.assert_array_equal(f, img.astype(np.float32))
    assert ld.next() is None
    ld.close()
    assert native_loader.BUILD_INFO["path"].startswith(str(native_loader.BUILD_DIR))


def test_native_request_raises_with_compiler_message(monkeypatch, tmp_path):
    """loader="native" surfaces a failed build with the compiler's words;
    "auto" falls back to the in-process decoder and says so."""
    bad = tmp_path / "loader.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "_ERROR", None)
    seq = teuroc.EurocSequence(image_paths=[], ts_us=np.zeros(0, np.int64),
                               imu_ts_us=np.zeros(0, np.int64), imu_gyro=np.zeros((0, 3)),
                               imu_acc=np.zeros((0, 3)), loader="native")
    with pytest.raises(RuntimeError, match="no_such_header_here"):
        seq.resolved_loader()
    assert teuroc.EurocSequence(**{**seq.__dict__, "loader": "auto"}).resolved_loader() == \
        "python"


@pytest.mark.parametrize("loader", ["python", "native"])
def test_cli_euroc_equals_runner(asl_tree, monkeypatch, loader):
    """``--dataset euroc --device cpu --preset small``: the CLI's trajectory is
    VioRunner(undistort=True)'s on the same uint8 frames and IMU, bit for
    bit, and the JSON line carries the ATE against the tree's ground truth
    and the loader that ran."""
    if loader == "native" and native_skip_reason() is not None:
        pytest.skip(f"the native loader cannot be built: {native_skip_reason()}")
    root, seq = asl_tree
    results = []
    run_orig = trun.VioRunner.run

    def recording_run(self, *a, **kw):
        results.append(run_orig(self, *a, **kw))
        return results[-1]

    monkeypatch.setattr(trun.VioRunner, "run", recording_run)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trun.main(["--dataset", "euroc", "--root", str(root), "--device", "cpu",
                        "--preset", "small", "--mode", "vio", "--loader", loader])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    print("CLI", out)
    assert out["frames"] == N_FRAMES and out["loader"] == loader
    assert np.isfinite(out["ate_sim3"]) and np.isfinite(out["ate_se3"])

    cfg = trun.preset_config("small", use_imu=True)
    mem = SimpleNamespace(images=[seq.images[i].astype(np.uint8) for i in range(N_FRAMES)],
                          ts_us=seq.ts_us[:N_FRAMES], imu_ts_us=seq.imu_ts_us,
                          imu_gyro=seq.imu_gyro.astype(np.float32),
                          imu_acc=seq.imu_acc.astype(np.float32))
    want = run_orig(trun.VioRunner(cfg, undistort=True, device="cpu"), mem)
    got = results[-1]
    for name in ("ts_us", "position", "orientation", "num_matches", "run_ok"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
