"""Rank targets of the sharded tests, for ``launch.World.run``: each takes
the rank's mesh and the call's arguments and runs one collective or one
sharded function of the port. This module imports the port alone, so the
ranks that import it to run a target never import JAX."""

import torch

from voxelized_geometry_tools_tpu_torch.core.grid import GridSpec
from voxelized_geometry_tools_tpu_torch.parallel import collectives as coll
from voxelized_geometry_tools_tpu_torch.parallel import mesh_utils, sharded
from voxelized_geometry_tools_tpu_torch.parallel.mesh_utils import Mesh
from voxelized_geometry_tools_tpu_torch.parallel.targets import (
    make_cloud, make_field)


def collectives_probe(mesh: Mesh, x: torch.Tensor) -> dict:
    """Every collective on this rank's ``x`` (a ``[a n, b, c]`` block):
    the tiled all-to-all both ways, the reduce-scatter of ``x * (rank +
    1)`` along each axis, the all-reduce (sum, min, max), the all-gather,
    both ppermute forms; and the collective statistics."""
    mesh.stats = mesh_utils.CollectiveStats()
    r = mesh.rank
    xs = x * (r + 1)
    out = {
        "a2a_0_2": coll.all_to_all(x, mesh, 0, 2),
        "a2a_2_0": coll.all_to_all(coll.all_to_all(x, mesh, 0, 2), mesh,
                                   2, 0),
        "a2a_1_0": coll.all_to_all(x.repeat(1, mesh.size, 1), mesh, 1, 0),
        "rs_0": coll.reduce_scatter(xs, mesh, 0),
        "rs_2": coll.reduce_scatter(xs.repeat(1, 1, mesh.size), mesh, 2),
        "sum": coll.all_reduce(xs, mesh),
        "min": coll.all_reduce(xs, mesh, "min"),
        "max": coll.all_reduce(xs, mesh, "max"),
        "gather_1": coll.all_gather(x, mesh, 1),
        "next_wrap": coll.ppermute_from_next(x, mesh, wrap=True),
        "next": coll.ppermute_from_next(x, mesh, wrap=False),
    }
    out["stats"] = mesh.stats.as_dict()
    mesh.stats = None
    out["untimed"] = coll.all_reduce(xs, mesh)
    return out


def fail_on_rank(mesh: Mesh, rank: int) -> torch.Tensor:
    """Raises on ``rank``; the others wait in an all-reduce it never
    joins."""
    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} failed on purpose")
    return coll.all_reduce(torch.ones(4, device=mesh.device), mesh)


def squared_edt(mesh: Mesh, seed: torch.Tensor, **kwargs) -> torch.Tensor:
    """``sharded_squared_edt`` of this rank's Z slab."""
    return sharded.sharded_squared_edt(seed, mesh, **kwargs)


def signed_distance(mesh: Mesh, is_filled: torch.Tensor, resolution: float,
                    **kwargs) -> torch.Tensor:
    """``sharded_signed_distance`` of this rank's Z slab."""
    return sharded.sharded_signed_distance(is_filled, resolution, mesh,
                                           **kwargs)


def raycast(mesh: Mesh, spec: GridSpec, grid_origin, cloud, **kwargs):
    """``sharded_raycast_pointcloud`` of ``cloud`` (``(points, pose,
    max_range)``, whole): ``(seen_free, seen_filled)``."""
    grid = sharded.sharded_raycast_pointcloud(
        spec, grid_origin, make_cloud(mesh, cloud), mesh, **kwargs)
    return grid.seen_free, grid.seen_filled


def isosurface(mesh: Mesh, distances: torch.Tensor, spec: GridSpec, origin,
               gathered: bool = False, **kwargs) -> dict:
    """``sharded_extract_isosurface`` of this rank's X slab: its vertices,
    valid flags, count and overflow flag, every rank's count, and with
    ``gathered`` the overflow flag and total of ``gather_isosurface``."""
    local, counts = sharded.sharded_extract_isosurface(
        make_field(mesh, distances, spec, origin), mesh, **kwargs)
    out = {"vertices": local.vertices, "valid": local.valid,
           "count": local.num_triangles.reshape(1),
           "overflowed": local.overflowed.reshape(1), "counts": counts}
    if gathered:
        whole = sharded.gather_isosurface(local, mesh)
        out["gathered_overflowed"] = whole.overflowed
        out["gathered_total"] = whole.num_triangles
        out["gathered_capacity"] = whole.capacity
    return out


def slab_table(mesh: Mesh, distances: torch.Tensor, spec: GridSpec, origin,
               grid_axis: int) -> torch.Tensor:
    """``sharded_build_corner_table`` of this rank's slab along
    ``grid_axis``: its rows."""
    return sharded.sharded_build_corner_table(
        make_field(mesh, distances, spec, origin), mesh,
        grid_axis=grid_axis).rows
