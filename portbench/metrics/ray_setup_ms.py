"""Mean milliseconds a frame of device time launched inside the program's
``vgt.fusion.ray_setup`` spans (the grid-frame transform and each ray's
clip and walk setup, before the carve kernel), from the profiler's trace
of the traced frames."""

from portbench import program_spans

program_spans.install()


def read(run):
    s = program_spans.of(run)
    if s is None:
        return None
    return 1e3 * program_spans.subtree(
        s.span_busy_s, "vgt.fusion.ray_setup") / run.traced_steps
