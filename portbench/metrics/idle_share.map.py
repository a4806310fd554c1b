"""Share of the traced window in which no operation ran on the device, in
percent: 100 * (1 - union of the device's busy intervals / window), from
the profiler's trace of the mapping cell's traced frames."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
