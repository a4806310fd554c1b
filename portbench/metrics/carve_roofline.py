"""The tiled carve kernel's share of its byte bound, in percent: each
launch reads its rays' 66-byte setup once and writes both int32 tracking
grids once, at the published HBM rate; over the device time of the carve
kernels (``carve_*`` in ``kernels/csrc/carve.cu``) in the traced steps.
The launches are the program's own counter over the same steps."""

from portbench import roofline

COUNTERS = {"carve_launches": [
    "voxelized_geometry_tools_tpu_torch.kernels.carve:launches_tiled"]}


def read(run):
    if run.trace is None or not run.counters.get("carve_launches"):
        return None
    device_s, kernels = run.trace.kernels_matching("carve_")
    if kernels == 0:
        return None
    cam, grid = run.config["camera"], run.config["grid"]
    n_rays = cam["width"] * cam["height"]
    bound = run.counters["carve_launches"] * roofline.bound_seconds(
        roofline.carve_bytes(n_rays, grid["counts"]))
    return roofline.share_percent(bound, device_s)
