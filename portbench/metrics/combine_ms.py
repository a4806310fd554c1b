"""Mean milliseconds a frame of device time launched inside the program's
``vgt.edt.combine`` spans: the EDT's signed combine, ``sqrt`` of each
squared-distance field scaled by the resolution, the one subtracted from
the other. On the card that is one ``edt_combine_kernel`` launch a frame,
which the slab-streamed float32 EDT makes in place over its first field;
whatever the program launches in the span counts. From the profiler's
trace of the traced frames. A program without the span gives nothing to
read."""

from portbench import program_spans

program_spans.install()

SPAN = "vgt.edt.combine"


def read(run):
    s = program_spans.of(run)
    if s is None or SPAN not in s.span_ops:
        return None
    return 1e3 * program_spans.subtree(s.span_busy_s, SPAN) / run.traced_steps
