"""The entry point's refusals, and one run on the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from vio_bench import harness, run, spec


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "parity.live20", "--seed", "1", "--seconds", "1"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "needs 1 CUDA device" in err


def test_benchmark_files_alone_fail(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder the program is missing: the run fails and prints no result."""
    shutil.copytree(spec.HERE, tmp_path / "vio_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "vio_bench.run", "--workload", "rw.fleet8",
                        "--seed", "1", "--seconds", "1"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rebvio_tpu_torch_x", sys)
    assert "rebvio_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in harness.forbidden_modules()


@pytest.mark.card
@pytest.mark.parametrize("name", spec.cells())
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "-m", "vio_bench.run", "--workload", name, "--seed",
                        str(2 ** 31 + 7), "--seconds", "3", "--trace", "0"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in spec.resolve(name).end_to_end}
