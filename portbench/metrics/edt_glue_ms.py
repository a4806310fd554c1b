"""Mean milliseconds a frame of device time launched inside the program's
``vgt.edt`` spans, less the best-first envelope kernels' time (the
``edt_bestfirst_*`` kernels): the EDT's seed pass, layout copies, signed
combine and lock, from the profiler's trace of the traced frames."""

from portbench import program_spans

program_spans.install()


def read(run):
    s = program_spans.of(run)
    if s is None:
        return None
    kernels_s, _ = s.kernels_matching("edt_bestfirst")
    busy_s = program_spans.subtree(s.span_busy_s, "vgt.edt")
    return 1e3 * (busy_s - kernels_s) / run.traced_steps
