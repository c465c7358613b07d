"""Each xdist worker holds its share of PyTorch's CPU threads, set when
tests/torch_helpers.py is imported.

Without it every worker runs one OpenMP thread per CPU, and the workers'
small CPU ops oversubscribe the machine. `thread_budget` is held to
hand-worked figures with a stubbed affinity mask and cgroup file, the quota
branch included; the worker's pools and variables are held to it.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_helpers  # noqa: E402


@pytest.mark.parametrize("cpu_max, n_cpus, n_workers, expected", [
    (None, 8, "6", 1),                  # no cgroup file
    ("max 100000\n", 8, "6", 1),        # no quota: 8 // 6
    ("max 100000\n", 8, "2", 4),
    ("max 100000\n", 8, None, 8),       # no xdist: one process
    ("max 100000\n", 3, "6", 1),        # fewer CPUs than workers
    ("150000 100000\n", 8, "6", 1),     # 1.5 CPUs of quota
    ("400000 100000\n", 8, "2", 2),     # the quota, not the mask, decides
    ("400000 100000\n", 2, "1", 2),     # the mask, not the quota, decides
    ("50000 100000\n", 8, None, 1),     # half a CPU: at least one
])
def test_thread_budget(tmp_path, monkeypatch, cpu_max, n_cpus, n_workers, expected):
    path = tmp_path / "cpu.max"
    if cpu_max is not None:
        path.write_text(cpu_max)
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(n_cpus)))
    if n_workers is None:
        monkeypatch.delenv("PYTEST_XDIST_WORKER_COUNT", raising=False)
    else:
        monkeypatch.setenv("PYTEST_XDIST_WORKER_COUNT", n_workers)
    assert torch_helpers.thread_budget(str(path)) == expected


def test_worker_holds_its_thread_budget():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        # a run without xdist has the machine to itself: nothing is set
        assert torch_helpers.THREAD_BUDGET is None
        return
    budget = torch_helpers.thread_budget()
    assert torch_helpers.THREAD_BUDGET == budget
    assert os.environ.get("OMP_NUM_THREADS") == str(budget)
    assert os.environ.get("MKL_NUM_THREADS") == str(budget)
    assert torch.get_num_threads() == budget
    assert torch.get_num_interop_threads() == budget
    info = torch.__config__.parallel_info()
    assert f"at::get_num_threads() : {budget}\n" in info
    assert f"at::get_num_interop_threads() : {budget}\n" in info
