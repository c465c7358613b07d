"""95th percentile, in ms, of the latency from due time to pose on the host
over the window's untraced frames: the live tail, read per layer because
its runs spread too widely for an end-to-end bound (the card's slow state
at the start of a window lasts a random stretch)."""

from vio_bench import stats


def read(t):
    xs = t.host_spans.get("frame_latency")
    return stats.percentile([x * 1e3 for x in xs], 95) if xs else None
