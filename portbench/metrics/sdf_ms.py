"""Mean milliseconds a frame in the SDF refresh (the EDT), from the
benchmark's synchronized span around it in a traced run."""

from portbench.stats import mean


def read(run):
    m = mean(run.spans.durations.get("sdf", []))
    return None if m is None else 1e3 * m
