"""Rank targets for :meth:`.launch.World.run`: each takes the rank's mesh
and the call's arguments (numpy arrays arrive as tensors on the rank's
device, cut by the call's in-specs), builds the port's objects, runs one
sharded function and returns tensors for the launcher to put together.

They are what a caller outside a world (``chip_smoke.py``, the
``sharded_pipeline`` example) runs in one: the functions of
:mod:`.sharded` take a mesh and the port's map, cloud and camera objects,
which these make from plain arrays (``make_field``, ``make_camera``,
``make_cloud``).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from ..core.grid import GridSpec
from ..core.maps import OccupancyMap, SignedDistanceField
from ..ops import render, sdf_query, voxelize
from . import collectives as coll
from . import mesh_utils, sharded
from .mesh_utils import Mesh


def make_field(mesh: Mesh, distances: torch.Tensor, spec: GridSpec,
           origin) -> SignedDistanceField:
    """A field whose distances are this rank's part (any layout): the
    spec is the global grid's."""
    return sharded._sharded_field(spec, distances.to(torch.float32), origin,
                                  "", float("inf"), mesh)


def make_camera(mesh: Mesh, camera: dict) -> render.PinholeCamera:
    """A camera from ``{"pose", "width", "height", "fx", "fy", "cx",
    "cy"}`` on the rank's device."""
    return render.PinholeCamera.create(
        camera["pose"], camera["width"], camera["height"], fx=camera["fx"],
        fy=camera["fy"], cx=camera["cx"], cy=camera["cy"],
        device=mesh.device)


def make_cloud(mesh: Mesh, cloud) -> voxelize.PointCloud:
    points, pose, max_range = cloud
    return voxelize.PointCloud.create(
        torch.as_tensor(points, device=mesh.device),
        torch.as_tensor(pose, device=mesh.device), max_range=max_range,
        device=mesh.device)


def extract_sdf(mesh: Mesh, occupancy: torch.Tensor, spec: GridSpec,
                origin, **kwargs):
    """:func:`.sharded.sharded_extract_sdf` of this rank's Z slab:
    ``(distances, minimum, maximum)``."""
    sdf = sharded.sharded_extract_sdf(occupancy, spec, origin, mesh,
                                      **kwargs)
    return sdf.distances, sdf.minimum, sdf.maximum


def voxelize_pointclouds(mesh: Mesh, spec: GridSpec, origin,
                         occupancy: torch.Tensor, options: tuple,
                         clouds: Sequence, **kwargs) -> torch.Tensor:
    """:func:`.sharded.sharded_voxelize_pointclouds` of the whole static
    environment ``occupancy`` and clouds: this rank's occupancy."""
    env = OccupancyMap.create(spec, origin, "world", device=mesh.device)
    env = env.replace(occupancy=occupancy.to(torch.float32))
    out = sharded.sharded_voxelize_pointclouds(
        env, voxelize.FilterOptions(*options),
        [make_cloud(mesh, c) for c in clouds], mesh, **kwargs)
    return out.occupancy


def _table(sdf: SignedDistanceField, kind: Optional[str]):
    if kind is None:
        return None
    if kind == "brick":
        return sdf_query.build_corner_table(sdf)
    if kind == "pair":
        return sdf_query.build_corner_pair_table(sdf)
    raise ValueError(f"Unknown table kind {kind!r}")


def render_pixels(mesh: Mesh, distances: torch.Tensor, spec: GridSpec,
                  origin, camera: dict, table: Optional[str] = None,
                  **kwargs) -> torch.Tensor:
    """:func:`.sharded.sharded_render_depth` of the whole field with a
    ``"brick"`` or ``"pair"`` table or none: this rank's depth rows."""
    sdf = make_field(mesh, distances, spec, origin)
    return sharded.sharded_render_depth(
        sdf, make_camera(mesh, camera), mesh,
        corner_table=_table(sdf, table), **kwargs)


def render_grid(mesh: Mesh, distances: torch.Tensor, spec: GridSpec, origin,
                camera: dict, grid_axis: int = 2, table: bool = False,
                **kwargs):
    """:func:`.sharded.sharded_render_depth_grid_sharded` of this rank's
    slab along ``grid_axis``, with the slab table or without:
    ``(depth, phases)``."""
    sdf = make_field(mesh, distances, spec, origin)
    rows = (sharded.sharded_build_corner_table(sdf, mesh, grid_axis=grid_axis)
            if table else None)
    stats = {}
    depth = sharded.sharded_render_depth_grid_sharded(
        sdf, make_camera(mesh, camera), mesh, grid_axis=grid_axis,
        corner_rows=rows, stats=stats, **kwargs)
    return depth, stats["phases"]


def _launches() -> dict:
    from ..kernels import (carve, edt_bestfirst, edt_combine, fusion_filter,
                           ray_setup)
    return {"edt_bestfirst_staged": edt_bestfirst.launches_staged,
            "ray_setup": ray_setup.launches,
            "carve_tiled": carve.launches_tiled,
            "fusion_filter": fusion_filter.launches,
            "edt_combine": edt_combine.launches}


def _reset_launches() -> None:
    from ..kernels import (carve, edt_bestfirst, edt_combine, fusion_filter,
                           ray_setup)
    edt_bestfirst.launches_staged = 0
    ray_setup.launches = 0
    carve.launches_tiled = 0
    fusion_filter.launches = 0
    edt_combine.launches = 0


def pipeline(mesh: Mesh, spec: GridSpec, clouds: Sequence,
             sphere: torch.Tensor, camera: dict, num_steps: int,
             schedule: dict, grid_render: dict, iso_cap: int,
             carve_only: bool = False) -> dict:
    """The sharded path of one world, step by step, on the rank's device:

    1. the clouds (``(points, pose, max_range)``, whole) into a fresh
       ``spec`` map (:func:`.sharded.sharded_voxelize_pointclouds`, Z
       slabs);
    2. the SDF of that occupancy, and of ``sphere`` (this rank's Z slab of
       a filled mask) (:func:`.sharded.sharded_extract_sdf`);

    and unless ``carve_only``, on the sphere's field:

    3. the pixel-row render of the whole field (all-gathered from the
       slabs) with its corner table, on ``schedule`` and on the fixed
       ``num_steps`` march;
    4. the slabs resharded to X slabs (one all-to-all), the slab table
       along x and the grid-sharded render with it, without and with the
       cone prepass (``grid_render``: its knobs, ``coarse_factor`` etc.
       for the second);
    5. the X-slab isosurface, ``iso_cap`` triangles a rank.

    Returns each step's outputs (this rank's parts), wall time, the rank's
    peak device memory, the kernel launches and the collectives' bytes
    and ms of each step (timed here only: each collective synchronizes
    the device before and after)."""
    dev = mesh.device
    steps, out = {}, {}
    _reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def step(name, fn):
        mesh.stats = mesh_utils.CollectiveStats()
        before = _launches()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        result = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        after = _launches()
        steps[name] = {
            "ms": (time.perf_counter() - t0) * 1e3,
            # The whole card's memory in use (every rank's) at the end.
            "card_used_bytes": (
                torch.cuda.mem_get_info(dev)[1]
                - torch.cuda.mem_get_info(dev)[0]
                if dev.type == "cuda" else 0),
            "launches": {k: after[k] - before[k] for k in after},
            "collectives": mesh.stats.as_dict()}
        return result

    env = OccupancyMap.create(spec, None, "world", device=dev)
    occ = step("voxelize", lambda: sharded.sharded_voxelize_pointclouds(
        env, voxelize.FilterOptions(),
        [make_cloud(mesh, c) for c in clouds], mesh).occupancy)
    del env
    out["occupancy"] = occ
    out["pipe_sdf"] = step("sdf_pipeline", lambda: sharded.sharded_extract_sdf(
        occ, spec, None, mesh).distances)
    del occ
    sdf = step("sdf_sphere", lambda: sharded.sharded_extract_sdf(
        sphere.to(torch.float32), spec, None, mesh))
    out["sphere_sdf"] = sdf.distances
    if not carve_only:
        cam = make_camera(mesh, camera)

        def pixels():
            whole = sdf.replace(distances=coll.all_gather(sdf.distances,
                                                          mesh, 2))
            table = sdf_query.build_corner_table(whole)
            with torch.no_grad():
                shipped = sharded.sharded_render_depth(
                    whole, cam, mesh, num_steps=num_steps,
                    corner_table=table, **schedule)
                fixed = sharded.sharded_render_depth(
                    whole, cam, mesh, num_steps=num_steps,
                    corner_table=table)
            return shipped, fixed

        out["render_schedule"], out["render_fixed"] = step("render_pixels",
                                                           pixels)

        def grid():
            xs = sdf.replace(distances=sharded.reshard_slabs(
                sdf.distances, mesh, from_axis=2, to_axis=0))
            table = sharded.sharded_build_corner_table(xs, mesh, grid_axis=0)
            knobs = {k: v for k, v in grid_render.items()
                     if k in ("steps_per_exchange", "ray_chunks")}
            plain_stats, cone_stats = {}, {}
            with torch.no_grad():
                plain = sharded.sharded_render_depth_grid_sharded(
                    xs, cam, mesh, num_steps=num_steps, grid_axis=0,
                    corner_rows=table, stats=plain_stats, **knobs)
                cone = sharded.sharded_render_depth_grid_sharded(
                    xs, cam, mesh, num_steps=num_steps, grid_axis=0,
                    corner_rows=table, stats=cone_stats, **grid_render)
            return xs, plain, cone, plain_stats["phases"], \
                cone_stats["phases"]

        xs, out["grid_fixed"], out["grid_cone"], p0, p1 = step("render_grid",
                                                               grid)
        out["grid_phases"] = torch.tensor([p0, p1])
        del sdf

        def iso():
            local, counts = sharded.sharded_extract_isosurface(
                xs, mesh, max_triangles_per_shard=iso_cap, frame="grid")
            if bool(local.overflowed):
                raise RuntimeError(f"rank {mesh.rank}: isosurface overflowed "
                                   f"{iso_cap} triangles")
            return local, counts

        local, counts = step("isosurface", iso)
        out.update(iso_vertices=local.vertices, iso_valid=local.valid,
                   iso_counts=counts)
    out["steps"] = steps
    out["launches"] = _launches()
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else 0)
    out["mesh"] = mesh.describe()
    mesh.stats = None
    return out
