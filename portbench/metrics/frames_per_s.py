"""Frames completed over the whole window, per second. Host clock."""


def read(run):
    return len(run.latencies) / run.elapsed_s
