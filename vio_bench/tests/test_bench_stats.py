"""The metric arithmetic on hand-made samples."""

import pytest

from vio_bench import stats
from vio_bench.trace import Profile, Trace


def test_percentile_over_every_sample():
    ms = [float(x) for x in range(1, 401)]          # 400 frames, 1..400 ms
    assert stats.percentile(ms, 50) == pytest.approx(200.5)
    assert stats.percentile(ms, 95) == pytest.approx(380.05)
    # one stall in the window moves the tail, whatever the order
    stalled = ms[:-1] + [5000.0]
    assert stats.percentile(list(reversed(stalled)), 100) == 5000.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate_over_the_whole_window():
    # 31 sessions of 512 frames in 20.4 s: every frame over all the time
    assert stats.rate(31 * 512, 20.4) == pytest.approx(15872 / 20.4)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_idle_share_from_overlapping_intervals():
    ops = [(0.0, 2.0), (1.0, 3.0), (2.5, 4.0), (6.0, 7.0), (6.5, 6.8)]
    assert stats.union(ops) == [(0.0, 4.0), (6.0, 7.0)]
    assert stats.busy(ops) == pytest.approx(5.0)
    assert stats.gaps(ops) == [(4.0, 6.0)]
    assert stats.idle_share(ops, 10.0) == pytest.approx(0.5)


def test_trace_reads_busy_time_kernels_and_roofline():
    p = Profile("cpu")
    p.window_s = 10e-6 * 2
    # two steps: a port kernel and a PyTorch kernel each, overlapping
    p.ops = [("minimize_vel_kernel(float const*)", 0.0, 4.0),
             ("void at::native::elementwise_kernel<4>", 2.0, 6.0),
             ("Memcpy HtoD (Pinned -> Device)", 6.0, 7.0),
             ("minimize_vel_kernel(float const*)", 10.0, 14.0),
             ("void at::native::elementwise_kernel<4>", 14.0, 16.0)]
    counts = {"minimize_vel": (3.35e12 * 1e-9, 0.0)}      # a bound of 1 ns a lane
    t = Trace(p, steps=2, lanes=8, counts=counts, host_spans={"process_frame": [1e-3, 3e-3]},
              stages={"detect": 0.5, "att_field": 0.25})
    assert t.busy_s() == pytest.approx(13e-6)
    assert t.busy_ms_per_step() == pytest.approx(6.5e-3)
    assert t.idle_share() == pytest.approx(1 - 13 / 20)
    assert t.kernels_per_step() == 2.0
    assert t.roofline_pct() == pytest.approx(100 * 2 * 8e-6 / 8e-3)
    assert t.host_ms("process_frame") == pytest.approx(2.0)
    assert t.stage_ms("detect", "att_field") == pytest.approx(0.75)
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("minimize_vel_kernel")
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx([3e-6])
