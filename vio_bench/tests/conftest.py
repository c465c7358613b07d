"""CPU tests of the benchmark harness (``python -m pytest vio_bench/tests``).

Tests that need an NVIDIA card carry the ``card`` marker and decide inside
the test whether one is present, skipping on the CPU."""

import pytest

from vio_bench import spec

# a small camera with EuRoC's distortion: the CPU runs the port's plain
# versions at this size in seconds
SMALL_CAMERA = dict(rows=120, cols=188, fx=114.66, fy=114.32, cx=91.8, cy=62.1)
SMALL_KEYLINES = dict(keylines_max=2048, keylines_ref=1500)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def small_cell():
    """``small_cell(name, **traffic)``: the cell ``name`` of BENCHMARK.json
    with the small camera and keyline budget, its traffic keys replaced."""
    def make(name, **traffic):
        c = spec.resolve(name)
        p = c.config["pipeline"]
        p["camera"].update(SMALL_CAMERA)
        p["detector"].update(SMALL_KEYLINES)
        c.traffic.update(traffic)
        return c
    return make
