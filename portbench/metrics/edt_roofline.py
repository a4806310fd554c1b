"""The best-first EDT kernel's share of its byte bound, in percent: each
launch is one envelope pass that reads and writes the two stacked float32
fields once, at the published HBM rate; over the device time of the
``edt_bestfirst_*`` kernels in the traced steps. The launches are the
program's own counters over the same steps."""

from portbench import roofline

_M = "voxelized_geometry_tools_tpu_torch.kernels.edt_bestfirst"
COUNTERS = {"edt_launches": [f"{_M}:launches_staged",
                             f"{_M}:launches_cluster", f"{_M}:launches",
                             f"{_M}:launches_inkernel"]}


def read(run):
    if run.trace is None or not run.counters.get("edt_launches"):
        return None
    device_s, kernels = run.trace.kernels_matching("edt_bestfirst")
    if kernels == 0:
        return None
    bound = run.counters["edt_launches"] * roofline.bound_seconds(
        roofline.edt_pass_bytes(run.config["grid"]["counts"], fields=2))
    return roofline.share_percent(bound, device_s)
