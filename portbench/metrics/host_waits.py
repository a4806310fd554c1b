"""Mean count a frame of the host's blocking calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, ``cudaMemcpy``) made
inside the program's ``vgt.*`` spans, from the profiler's trace of the
traced frames: each drains the device's queue."""

from portbench import program_spans

program_spans.install()


def read(run):
    s = program_spans.of(run)
    if s is None:
        return None
    return sum(v for k, v in s.span_waits.items() if k) / run.traced_steps
