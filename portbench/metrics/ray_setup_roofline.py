"""The per-ray setup kernel's share of its byte bound, in percent: each
launch reads one camera's points once (12 bytes a point) and writes each
ray's setup once (the 66 bytes a ray that the carve kernel reads), at the
published HBM rate; over the device time of the ``ray_setup_kernel`` in
the traced steps. The launches are the program's own counter
(``kernels/ray_setup.launches``, one a camera) over the same steps. A
program without the kernel (an older commit) names no counter here, and
the reader reports nothing."""

import importlib.util

from portbench import roofline

_M = "voxelized_geometry_tools_tpu_torch.kernels.ray_setup"
POINT_BYTES = 3 * 4
SETUP_BYTES = roofline.CARVE_RAY_BYTES

COUNTERS = ({"ray_setup_launches": [f"{_M}:launches"]}
            if importlib.util.find_spec(_M) is not None else {})


def read(run):
    launches = run.counters.get("ray_setup_launches")
    if run.trace is None or not launches:
        return None
    device_s, kernels = run.trace.kernels_matching("ray_setup_kernel")
    if kernels == 0:
        return None
    cam = run.config["camera"]
    n_rays = cam["width"] * cam["height"]
    bound = launches * roofline.bound_seconds(
        (POINT_BYTES + SETUP_BYTES) * n_rays)
    return roofline.share_percent(bound, device_s)
