"""Pointcloud voxelization example: two-camera fusion on every backend.

The port of ``examples/pointcloud_voxelization.py``: a 2 m^3 8-cell/axis
grid with a filled floor, two synthetic depth cameras whose analytic
planes shadow opposite halves of the volume, fused with
percent_seen_free=1.0 by every available backend (the accelerator on the
card or, with ``--device cpu``, its PyTorch twins on the CPU; the native
C++ runtime), each checked against the analytic oracle.
"""

from __future__ import annotations

import numpy as np

from .. import GridSpec, OccupancyMap
from ..io import viz
from ..ops import backends, voxelize
from ._common import Printer, device_of, parser


def _rotz(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rotx(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _iso(rotation=None, translation=(0.0, 0.0, 0.0)):
    m = np.eye(4)
    if rotation is not None:
        m[:3, :3] = rotation
    m[:3, 3] = translation
    return m


def make_scene(device):
    """The reference scene: a floor and two cameras."""
    X_WG = _iso(translation=(-1.0, -1.0, -1.0))
    spec = GridSpec.from_grid_sizes(0.25, (2.0, 2.0, 2.0))
    static_env = OccupancyMap.create(spec, X_WG.astype(np.float32), "world",
                                     device=device)
    occ = static_env.occupancy.clone()
    occ[:, :, 0] = 1.0  # filled floor
    static_env = static_env.replace(occupancy=occ)

    X_CO = _iso(rotation=_rotz(-np.pi / 2) @ _rotx(-np.pi / 2))
    xs = np.arange(-2.0, 2.0 + 1e-9, 0.03125)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")

    def make_cloud(X_WC, z_rule):
        z = z_rule(gx)
        pts = np.stack([gx.ravel(), gy.ravel(), z.ravel()], axis=-1)
        return voxelize.PointCloud.create(
            pts.astype(np.float32), (X_WC @ X_CO).astype(np.float32),
            device=device)

    cam1 = make_cloud(_iso(translation=(-2.0, 0.0, 0.0)),
                      lambda x: np.where(x <= 0.0, 2.125, 4.0))
    cam2 = make_cloud(_iso(rotation=_rotz(np.pi / 2),
                           translation=(0.0, -2.0, 0.0)),
                      lambda x: np.where(x >= 0.0, 2.125, 4.0))
    return static_env, [cam1, cam2]


def check_voxelization(occ):
    """The expected-region oracle."""
    nx, ny, nz = occ.shape
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                v = occ[x, y, z]
                assert z != 0 or v == 1.0, (x, y, z, v)
                if z >= 1:
                    if (x == 3 and y >= 3) or (x >= 3 and y == 3):
                        assert v == 0.0, (x, y, z, v)
                    if (x == 4 and y >= 4) or (x >= 4 and y == 4):
                        assert v == 1.0, (x, y, z, v)
                    if x > 4 and y > 4:
                        assert v == 0.5, (x, y, z, v)


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)
    out = Printer()
    filter_options = voxelize.FilterOptions(
        percent_seen_free=1.0, outlier_points_threshold=1,
        num_cameras_seen_free=1)

    available = backends.get_available_backends()
    if dev.type == "cpu":
        # The accelerator backend's PyTorch twins, asked for by device.
        available.insert(0, backends.AvailableBackend(
            "accelerator (cpu)", {}, backends.BackendOption.ACCELERATOR))
    results = {}
    for backend in available:
        name = backend.device_name()
        out(f"Trying {name} voxelizer...")
        voxelizer = backends.make_pointcloud_voxelizer(
            backend, logging_fn=out, device=dev)
        static_env, clouds = make_scene(
            dev if backend.backend_option()
            == backends.BackendOption.ACCELERATOR else "cpu")

        def log_runtime(rt):
            out(f"  raycasting {rt.raycasting_time:.4f}s, "
                f"filtering {rt.filtering_time:.4f}s")

        voxelized = voxelizer.voxelize_pointclouds(
            static_env, filter_options, clouds, runtime_log_fn=log_runtime)
        results[name] = voxelized.occupancy.cpu().numpy()
        marker = viz.export_occupancy_for_display(
            voxelized, collision_color=(0.25, 0.0, 0.0, 0.5),
            free_color=(0.0, 0.25, 0.0, 0.5),
            unknown_color=(0.0, 0.0, 0.25, 0.5))
        out(f"  display: {marker.num_cells} cells")

    # Every backend against the analytic oracle.
    for name, occ in results.items():
        check_voxelization(occ)
        out(f"{name}: oracle check PASSED")

    # Best-available selection.
    backends.make_best_available_pointcloud_voxelizer(logging_fn=out)
    out("...done")
    return out.lines


if __name__ == "__main__":
    main()
