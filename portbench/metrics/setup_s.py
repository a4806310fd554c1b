"""Set-up: from the process's start (imports, loading, the scene and its
frames, the warm-up, and on a checkout's first run the kernels' build) to
the window's start. Host clock, seconds."""


def read(run):
    return run.setup_s
