"""Mean milliseconds a frame of device time launched inside the program's
``vgt.edt.combine`` spans: the EDT's signed combine, ``sqrt`` of each
field in float64 scaled by the resolution (in the slab-streamed EDT, chunk
by chunk into the result), from the profiler's trace of the traced frames.
A program without the span gives nothing to read."""

from portbench import program_spans

program_spans.install()

SPAN = "vgt.edt.combine"


def read(run):
    s = program_spans.of(run)
    if s is None or SPAN not in s.span_ops:
        return None
    return 1e3 * program_spans.subtree(s.span_busy_s, SPAN) / run.traced_steps
