"""Mean milliseconds a frame in the fusion filter, as the program's
``VoxelizerRuntime.filtering_time`` gives it (a span between two device
synchronizations)."""

from portbench.stats import mean


def read(run):
    m = mean(run.spans.durations.get("filter", []))
    return None if m is None else 1e3 * m
