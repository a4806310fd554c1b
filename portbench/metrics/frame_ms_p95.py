"""95th percentile of one sensor frame's latency over every frame of the
window: from handing its clouds over as host tensors to the refreshed SDF,
synchronized. Host clock, milliseconds."""

from portbench.stats import percentile


def read(run):
    return 1e3 * percentile(run.latencies, 95)
