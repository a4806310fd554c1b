"""Mean milliseconds a frame of device time launched inside the program's
``vgt.edt.slab_writeback`` spans: the slab-streamed EDT's copy of each
slab's seed or envelope result back into its field, from the profiler's
trace of the traced frames. A program without the span (the dense EDT, an
older commit) gives nothing to read."""

from portbench import program_spans

program_spans.install()

SPAN = "vgt.edt.slab_writeback"


def read(run):
    s = program_spans.of(run)
    if s is None or SPAN not in s.span_ops:
        return None
    return 1e3 * program_spans.subtree(s.span_busy_s, SPAN) / run.traced_steps
