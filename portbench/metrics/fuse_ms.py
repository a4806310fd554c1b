"""Mean milliseconds a frame in the fusion call (``OnlineMapper.integrate``
or ``voxelize_pointclouds``), from the benchmark's synchronized span
around it in a traced run."""

from portbench.stats import mean


def read(run):
    m = mean(run.spans.durations.get("fuse", []))
    return None if m is None else 1e3 * m
