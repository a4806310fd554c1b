"""The best-first EDT kernel's share of its byte bound, in percent, from
the elements its launches pass: each launch reads its float32 input once
and writes its result once (8 bytes an element), at the published HBM
rate; over the device time of the ``edt_bestfirst_*`` kernels in the
traced steps. The elements are the program's own counter
(``kernels/edt_bestfirst.elements_launched``) over the same steps, so a
launch on one slab of one field, as the slab-streamed EDT makes, counts
that slab and not the whole grid. A program without the counter (an older
commit) names no counter here, and the reader reports nothing."""

import importlib

from portbench import roofline

_M = "voxelized_geometry_tools_tpu_torch.kernels.edt_bestfirst"
BYTES_PER_ELEMENT = 2 * 4  # one float32 read, one written

COUNTERS = ({"edt_elements": [f"{_M}:elements_launched"]}
            if hasattr(importlib.import_module(_M), "elements_launched")
            else {})


def read(run):
    elements = run.counters.get("edt_elements")
    if run.trace is None or not elements:
        return None
    device_s, kernels = run.trace.kernels_matching("edt_bestfirst")
    if kernels == 0:
        return None
    bound = roofline.bound_seconds(BYTES_PER_ELEMENT * elements)
    return roofline.share_percent(bound, device_s)
