"""Mean milliseconds a frame in which the device was idle while the host
was inside the program's ``vgt.fusion`` spans, from the profiler's trace of
the traced frames."""

from portbench import program_spans

program_spans.install()


def read(run):
    s = program_spans.of(run)
    if s is None:
        return None
    return 1e3 * program_spans.subtree(
        s.span_idle_s, "vgt.fusion") / run.traced_steps
