"""Sharded implementations of the dense passes over a ``torch.distributed``
world.

Port of ``voxelized_geometry_tools_tpu/parallel/sharded.py``. The JAX
package runs each function as one ``shard_map`` over a mesh axis; the port
runs it SPMD, one process per rank (:mod:`.launch` starts them), and each
function takes this rank's part of its inputs and returns this rank's part
of its outputs, in the layouts the JAX function's ``in_specs`` and
``out_specs`` name (``P(None, None, axis)``: Z slabs; ``P(axis)``:
leading-axis shards of rays, rows or planes; ``P()``: the whole array on
every rank). A map or field whose tensor is a shard keeps the global
``spec``; its ``minimum`` / ``maximum`` are the global ones.

* **EDT**: Z slabs. The X and Y passes are local; the Z pass transposes the
  grid through :func:`.collectives.all_to_all` (X slabs with whole Z
  lines), runs locally and transposes back. Both signed fields ride one
  transpose.
* **Carving**: each rank walks its share of the rays into full-size
  counters; one all-reduce (or reduce-scatter to Z slabs) fuses them.
* **Rendering**: pixel rows over the ranks with the field on every rank
  (:func:`sharded_render_depth`), or the field in slabs with the rays on
  every rank, each ray advanced by the rank that owns its sample's cell
  (:func:`sharded_render_depth_grid_sharded`).
* **Isosurface**: X slabs plus one halo plane from the next rank.

Every result equals the single-device port's bit for bit (integer sums
commute; each float is formed by exactly one rank and summed with zeros),
the renders within the JAX tests' tolerances where the single-device
path's interpolation differs. The JAX package's collectives map as
:mod:`.collectives` says.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import transforms
from ..core.constants import constant
from ..core.grid import GridSpec
from ..core.maps import OccupancyMap, SignedDistanceField, _default_transform
from ..kernels import edt_seed
from ..ops import edt as edt_ops
from ..ops import isosurface as iso_ops
from ..ops import render as render_ops
from ..ops import sdf_query
from ..ops import voxelize as voxelize_ops
from . import collectives as coll
from .mesh_utils import Mesh, P, shard

Tensor = torch.Tensor

_EDT_BACKENDS = (("auto", "plain", "cuda-bestfirst", "cuda-envelope",
                  "cuda-windowed") + tuple(edt_ops.BACKEND_ALIASES))


def _axis_size(mesh: Mesh, axis_name: str) -> int:
    if axis_name != mesh.axis_name:
        raise ValueError(f"the mesh has no axis {axis_name!r} (its axis is "
                         f"{mesh.axis_name!r})")
    return mesh.size


def _f32(x, device) -> Tensor:
    return constant(x, torch.float32, device)


# -- Sharded EDT -------------------------------------------------------------


def _check_edt_sharding(shape, n_shards, backend):
    """``shape`` is the global grid's."""
    nx, _, nz = shape
    if backend not in _EDT_BACKENDS:
        raise ValueError(f"Unknown EDT backend {backend!r}")
    # The Z-pass all_to_all splits axis 0 (2*nx when both signed fields are
    # stacked): nx % n keeps both layouts valid.
    if nx % n_shards or nz % n_shards:
        raise ValueError(
            f"the mesh axis size {n_shards} must divide both "
            f"nx ({nx}) and nz ({nz})")


def _z_pass(d: Tensor, mesh: Mesh, block: int, backend: str) -> Tensor:
    """The envelope along Z of Z-slab lines: to X slabs, the pass, back."""
    d = coll.all_to_all(d, mesh, split_axis=0, concat_axis=2)
    d = edt_ops._envelope_last(d, block, backend)
    return coll.all_to_all(d, mesh, split_axis=2, concat_axis=0)


def sharded_squared_edt(seed: Tensor, mesh: Mesh, axis_name: str = "z",
                        block: int = 512, backend: str = "auto") -> Tensor:
    """Exact squared EDT of a Z-slab-sharded ``[nx, ny, nz]`` bool grid.

    ``seed``: this rank's Z slab ``[nx, ny, nz / n]`` (``P(None, None,
    axis)``); returns its slab of the squared distances, the same layout.
    ``backend`` is the envelope pass's (:func:`..ops.edt.squared_edt`: the
    port's names or the JAX package's), resolved against the local shapes:
    on the card ``"auto"`` launches the best-first kernel on the local Y
    lines and on the transposed Z lines."""
    n = _axis_size(mesh, axis_name)
    seed = seed.bool()
    nx, ny, lz = seed.shape
    _check_edt_sharding((nx, ny, lz * n), n, backend)
    d = edt_seed.seed_fields(seed)
    if ny > 1:
        d = edt_ops._envelope_last(d.movedim(1, -1), block,
                                   backend).movedim(-1, 1)
    if lz * n > 1:
        d = _z_pass(d, mesh, block, backend)
    return d.contiguous()


def sharded_signed_distance(is_filled: Tensor, resolution: float,
                            mesh: Mesh, axis_name: str = "z",
                            block: int = 512, backend: str = "auto",
                            dtype=torch.float32) -> Tensor:
    """Sharded two-field signed combine (matches
    :func:`..ops.edt.signed_distance_from_filled_mask`): ``is_filled`` is
    this rank's Z slab, and so is the result. The filled- and free-seeded
    fields are stacked along axis 0 after the binary X pass, so each Y / Z
    envelope pass and each transpose runs once over both."""
    n = _axis_size(mesh, axis_name)
    is_filled = is_filled.bool()
    nx, ny, lz = is_filled.shape
    _check_edt_sharding((nx, ny, lz * n), n, backend)
    d = edt_seed.seed_fields(is_filled, 2)  # [2nx, ny, lz]
    if ny > 1:
        d = edt_ops._envelope_last(d.movedim(1, -1), block,
                                   backend).movedim(-1, 1)
    if lz * n > 1:
        d = _z_pass(d, mesh, block, backend)
    return edt_ops._combine_stacked(d, resolution, dtype)


def _sharded_field(spec: GridSpec, values: Tensor, origin_transform,
                   frame: str, oob_value: float,
                   mesh: Mesh) -> SignedDistanceField:
    """A locked field whose distances are this rank's shard; its minimum
    and maximum are reduced over the ranks."""
    spec.enforce_uniform_voxel_size()
    return SignedDistanceField(
        origin_transform=_default_transform(origin_transform, values.dtype,
                                            values.device),
        distances=values,
        minimum=coll.all_reduce(torch.amin(values), mesh, "min"),
        maximum=coll.all_reduce(torch.amax(values), mesh, "max"),
        spec=spec, frame=frame, locked=True, oob_value=float(oob_value))


def sharded_extract_sdf(occupancy: Tensor, spec: GridSpec, origin_transform,
                        mesh: Mesh, axis_name: str = "z", frame: str = "",
                        unknown_is_filled: bool = True,
                        oob_value: float = float("inf"),
                        block: int = 512,
                        backend: str = "auto") -> SignedDistanceField:
    """The SDF of a Z-slab-sharded occupancy channel: ``occupancy`` is this
    rank's slab, and the returned locked field holds this rank's slab of
    the distances (``spec`` the global grid's)."""
    # Fail fast like the single-device entry point.
    spec.enforce_uniform_voxel_size()
    mask = edt_ops.filled_mask_from_occupancy(occupancy, unknown_is_filled)
    values = sharded_signed_distance(mask, spec.resolution, mesh, axis_name,
                                     block, backend)
    return _sharded_field(spec, values, origin_transform, frame, oob_value,
                          mesh)


def reshard_slabs(x: Tensor, mesh: Mesh, from_axis: int,
                  to_axis: int) -> Tensor:
    """This rank's slab along ``to_axis`` from its slab along
    ``from_axis``: one all-to-all (e.g. Z slabs to X slabs, for a
    grid-sharded render along x)."""
    return coll.all_to_all(x, mesh, split_axis=to_axis,
                           concat_axis=from_axis).contiguous()


def sharded_extract_isosurface(sdf: SignedDistanceField, mesh: Mesh,
                               axis_name: str = "z", level: float = 0.0,
                               max_triangles_per_shard: int = 1 << 16,
                               frame: str = "world"):
    """X-slab-sharded isosurface extraction (:mod:`..ops.isosurface`).

    ``sdf.distances`` is this rank's X slab ``[nx / n, ny, nz]``
    (``P(axis)``). Each rank adds ONE halo plane from the next rank
    (:func:`.collectives.ppermute_from_next`, no wrap: the last rank's cube
    layer past its slab is masked out) and sweeps its own cubes, so
    per-triangle values equal the single-device extractor's, and the
    ranks' valid triangles concatenated in rank order are its output.

    Returns ``(IsoMesh, shard_counts)``: this rank's mesh (capacity
    ``max_triangles_per_shard``, ``shard_counts`` its own count, so
    ``overflowed`` is this shard's flag) and every rank's true count
    (``[n]`` int32, on every rank). :func:`gather_isosurface` puts the
    meshes together in the JAX function's layout."""
    d = iso_ops._validated_field(sdf, level, frame)
    spec = sdf.spec
    n = _axis_size(mesh, axis_name)
    nx = spec.num_x
    if nx % n:
        raise ValueError(f"the mesh axis size {n} must divide nx ({nx})")
    if nx // n < 2:
        raise ValueError("shards need >= 2 planes each")
    sx = nx // n
    if d.shape[0] != sx:
        raise ValueError(f"sdf.distances has {d.shape[0]} x planes; this "
                         f"rank's X slab has {sx}")
    halo = coll.ppermute_from_next(d[:1], mesh, wrap=False)
    d_ext = torch.cat([d, halo], dim=0)  # [sx + 1, ny, nz]
    n_valid = sx - (1 if mesh.rank == n - 1 else 0)
    verts, valid, count = iso_ops._extract_planes(
        d_ext, sx, n_valid, float(mesh.rank * sx), spec.resolution,
        int(max_triangles_per_shard))
    verts = iso_ops._verts_to_frame(verts, sdf, frame)
    counts = coll.all_gather(count.reshape(1), mesh, axis=0)
    local = iso_ops.IsoMesh(vertices=verts, valid=valid, num_triangles=count,
                            shard_counts=count.reshape(1))
    return local, counts


def gather_isosurface(local: iso_ops.IsoMesh, mesh: Mesh) -> iso_ops.IsoMesh:
    """Every rank's mesh from :func:`sharded_extract_isosurface`, in the JAX
    function's layout: the buffers concatenated in rank order (valid rows
    not contiguous), the total count, every rank's count as
    ``shard_counts`` (so ``overflowed`` flags any one shard's)."""
    counts = coll.all_gather(local.shard_counts, mesh, axis=0)
    return iso_ops.IsoMesh(
        vertices=coll.all_gather(local.vertices, mesh, axis=0),
        valid=coll.all_gather(local.valid, mesh, axis=0),
        num_triangles=counts.sum(dtype=torch.int32), shard_counts=counts)


# -- Sharded ray carving -----------------------------------------------------


def sharded_raycast_pointcloud(spec: GridSpec, grid_origin_transform,
                               cloud: voxelize_ops.PointCloud, mesh: Mesh,
                               axis_name: str = "z",
                               max_steps: Optional[int] = None,
                               ray_chunk: int = 16384,
                               run_axis="auto",
                               reduce: str = "all"
                               ) -> voxelize_ops.TrackingGrid:
    """Carve one cloud with its rays cut over the ranks.

    ``cloud`` is the whole cloud on every rank; its points are padded with
    ``inf`` (rays that mark nothing) to a multiple of the world size, and
    rank ``r`` walks the ``r``-th block of them (the JAX function's
    ``P(axis)``), by the fusion paths' carve route: on a CUDA device the
    tiled carve kernel; on the CPU ``run_axis`` picks the column carve's
    run axis (``"auto"``: from the cloud, which is always concrete here;
    ``"split"``; 0-2) or the voxel walk (None), all with the same bits.

    ``reduce``: ``"all"`` all-reduces the counters (every rank gets the
    whole fused grid, ``P()``); ``"scatter"`` reduce-scatters them along z
    (this rank's Z slab, ``P(None, None, axis)``; needs ``n | nz``)."""
    if isinstance(run_axis, str):
        if run_axis not in ("auto", "split"):
            raise ValueError(f"Unknown run_axis {run_axis!r}")
        if run_axis == "auto":
            run_axis = voxelize_ops.pick_run_axis(cloud,
                                                  grid_origin_transform)
    n = _axis_size(mesh, axis_name)
    if reduce not in ("all", "scatter"):
        raise ValueError(f"Unknown reduce mode {reduce!r}")
    if reduce == "scatter" and spec.counts[2] % n:
        raise ValueError(
            f"reduce='scatter' needs the mesh axis size {n} to "
            f"divide nz ({spec.counts[2]})")
    points = cloud.points
    pad = (-points.shape[0]) % n
    if pad:
        points = torch.cat([points, points.new_full((pad, 3), float("inf"))])
    local = dataclasses.replace(
        cloud, points=shard(points, P(axis_name), n, mesh.rank, axis_name))
    grid = voxelize_ops._carve_cloud(spec, grid_origin_transform, local,
                                     max_steps, ray_chunk, run_axis)
    if reduce == "scatter":
        return voxelize_ops.TrackingGrid(
            coll.reduce_scatter(grid.seen_free, mesh, 2),
            coll.reduce_scatter(grid.seen_filled, mesh, 2))
    return voxelize_ops.TrackingGrid(coll.all_reduce(grid.seen_free, mesh),
                                     coll.all_reduce(grid.seen_filled, mesh))


def sharded_voxelize_pointclouds(
        static_environment: OccupancyMap,
        filter_options: voxelize_ops.FilterOptions,
        pointclouds: Sequence[voxelize_ops.PointCloud], mesh: Mesh,
        axis_name: str = "z", max_steps: Optional[int] = None,
        run_axis="auto") -> OccupancyMap:
    """Multi-rank ``VoxelizePointClouds``: each cloud carved by
    :func:`sharded_raycast_pointcloud`, then the fusion filter.

    ``static_environment`` and the clouds are whole on every rank. When the
    world size divides ``nz`` each cloud's counters reduce-scatter to Z
    slabs and the filter (pointwise over voxels) runs on this rank's slab:
    the returned map's occupancy is this rank's Z slab, what
    :func:`sharded_extract_sdf` takes. Otherwise the counters are
    all-reduced and the occupancy is whole."""
    filter_options.validate()
    spec = static_environment.spec
    n = _axis_size(mesh, axis_name)
    sharded_out = spec.counts[2] % n == 0
    reduce = "scatter" if sharded_out else "all"
    grids = [sharded_raycast_pointcloud(
        spec, static_environment.origin_transform, c, mesh, axis_name,
        max_steps, run_axis=run_axis, reduce=reduce) for c in pointclouds]
    occupancy = static_environment.occupancy
    if sharded_out:
        occupancy = shard(occupancy, P(None, None, axis_name), n, mesh.rank,
                          axis_name)
    if grids:
        seen_free = torch.stack([g.seen_free for g in grids])
        seen_filled = torch.stack([g.seen_filled for g in grids])
        del grids
    else:
        seen_free = torch.zeros((0,) + tuple(occupancy.shape),
                                dtype=torch.int32, device=occupancy.device)
        seen_filled = seen_free.clone()
    occupancy = voxelize_ops.combine_and_filter(
        filter_options, seen_free, seen_filled, occupancy)
    return static_environment.replace(occupancy=occupancy)


# -- Sharded rendering -------------------------------------------------------


def sharded_render_depth(sdf: SignedDistanceField,
                         camera: render_ops.PinholeCamera, mesh: Mesh,
                         axis_name: str = "z", num_steps: int = 64,
                         max_depth: float = 100.0,
                         corner_table=None,
                         early_exit: bool = False,
                         head_steps: int = 8,
                         tail_chunks: int = 8,
                         coarse_factor: int = 0,
                         cone_steps: Optional[int] = None,
                         cone_tail_chunks: int = 1) -> Tensor:
    """Render with pixel rows cut over the ranks; returns this rank's rows
    ``[H / n, W]`` of the depth image (``P(axis)``).

    The field and ``corner_table`` are whole on every rank (``P()``). The
    knobs are :func:`..ops.render.render_depth`'s, and each rank's
    early-exit wave, sorted tail and cone certificates adapt to its own
    pixels. With ``coarse_factor`` dividing ``H / n`` the cone prepass runs
    on this rank's rows alone (a camera with ``cy`` shifted by its first
    row: the same per-block bits) and the tail sorts whole ``f x f``
    blocks; when only ``f | H``, every rank runs the whole prepass and
    keeps its rows, and the tail sorts rays. Differentiable in
    ``sdf.distances`` and ``camera.pose`` on the fixed march."""
    n = _axis_size(mesh, axis_name)
    if camera.height % n:
        raise ValueError(f"{n} shards must divide camera height "
                         f"{camera.height}")
    lh = camera.height // n
    rows = slice(mesh.rank * lh, (mesh.rank + 1) * lh)
    origins, dirs = render_ops.camera_rays(camera)
    origins, dirs = origins[rows], dirs[rows]

    t_init = t_valid = sort_key = cert_miss = None
    # The prepass needs f | W and f | H; the per-rank block relayout also
    # needs f | H / n. When only that fails, keep the prepass and sort rays.
    block_layout_ok = bool(coarse_factor
                           and camera.height % (coarse_factor * n) == 0)
    if coarse_factor:
        if camera.width % coarse_factor or camera.height % coarse_factor:
            raise ValueError(
                f"coarse_factor={coarse_factor} must divide the image "
                f"dimensions {camera.width}x{camera.height}")
        thresh = 0.25 * sdf.resolution
        if block_layout_ok:
            # Rows [row0, row0 + lh) of the full camera: (v - (cy - row0))
            # == ((v + row0) - cy), so ray and block math is the full
            # camera's bit for bit.
            row0 = _f32(float(mesh.rank * lh), camera.cy.device)
            cam = dataclasses.replace(camera, cy=camera.cy - row0, height=lh)
            images = render_ops._cone_prepass(
                sdf, cam, coarse_factor, num_steps, thresh, max_depth,
                corner_table, max_cone_steps=cone_steps,
                cone_tail_chunks=cone_tail_chunks)
        else:
            images = [x[rows] for x in render_ops._cone_prepass(
                sdf, camera, coarse_factor, num_steps, thresh, max_depth,
                corner_table, max_cone_steps=cone_steps,
                cone_tail_chunks=cone_tail_chunks)]
        # Control data: no gradient flows through the prepass.
        t_init, t_valid, cone_slow, cert_miss = (x.detach() for x in images)
        if head_steps == 0:
            sort_key = cone_slow
        elif not early_exit:
            cert_miss = None

    kwargs = {}
    from_blocks = None
    if (block_layout_ok and early_exit and sort_key is not None
            and tail_chunks > 1):
        # Block-tail schedule inside the rank (as render_depth): every
        # cone block lies in this rank's rows.
        f = int(coarse_factor)
        to_blocks, from_blocks = render_ops.block_relayout(lh, camera.width,
                                                           f)
        origins, dirs, t_init, t_valid, sort_key = (
            to_blocks(x) for x in (origins, dirs, t_init, t_valid, sort_key))
        if cert_miss is not None:
            cert_miss = to_blocks(cert_miss)
        kwargs["sort_block"] = f * f
    result = render_ops.sphere_trace(
        sdf, origins, dirs, num_steps=num_steps, max_depth=max_depth,
        corner_table=corner_table, early_exit=early_exit,
        head_steps=head_steps, tail_chunks=tail_chunks, t_init=t_init,
        t_init_valid_from=t_valid, sort_key=sort_key,
        certified_miss=cert_miss, **kwargs)
    if from_blocks is not None:
        return from_blocks(result.depth)
    return result.depth


@dataclasses.dataclass(frozen=True)
class SlabCornerTable:
    """Slab-local corner rows + the grid axis they were built along.

    The rows' shape is axis-independent on cubic grids, so an untagged
    tensor built along one axis and rendered along another would silently
    give garbage depths: the tag lets the renderer reject the mismatch."""
    rows: Tensor  # [n_cells / n, 8], this rank's block of P(axis)
    grid_axis: int


# Planes of a slab per step of the slab table's build.
_TABLE_SLAB = 16


def _check_slab(d: Tensor, counts, ax: int, lsz: int) -> None:
    want = list(counts)
    want[ax] = lsz
    if tuple(d.shape) != tuple(want):
        raise ValueError(f"sdf.distances has shape {tuple(d.shape)}; this "
                         f"rank's slab along axis {ax} has {tuple(want)}")


def sharded_build_corner_table(sdf: SignedDistanceField, mesh: Mesh,
                               axis_name: str = "z",
                               grid_axis: int = 2) -> SlabCornerTable:
    """Slab-local corner-brick rows for
    :func:`sharded_render_depth_grid_sharded`, the grid-sharded twin of
    :func:`..ops.sdf_query.build_corner_table`.

    ``sdf.distances`` is this rank's slab along ``grid_axis``. Each rank
    builds the rows of the base cells it owns from its slab plus ONE halo
    plane from the next rank (:func:`.collectives.ppermute_from_next` with
    wrap), so the table shards as the grid does. Row ``flat_local(b)``
    (C order over the permuted local shape, slab axis major) holds the 8
    corrected corners in the permuted order ``c = 4*d_ax + 2*d_o1 +
    d_o2``; the renderer re-orders lanes to ``4*dx + 2*dy + dz``. The last
    rank's top row is built from the wrapped halo and is garbage by
    construction (base cells clamp to ``n_ax - 2``, so it is never
    read)."""
    spec = sdf.spec
    n = _axis_size(mesh, axis_name)
    counts = spec.counts
    ax = int(grid_axis)
    if ax not in (0, 1, 2):
        raise ValueError(f"grid_axis must be 0, 1, or 2, got {grid_axis}")
    n_ax = counts[ax]
    if n_ax % n:
        raise ValueError(f"{n} shards must divide counts[{ax}] ({n_ax})")
    lsz = n_ax // n
    other = [a for a in range(3) if a != ax]
    n1, n2 = counts[other[0]], counts[other[1]]
    d = sdf.distances
    _check_slab(d, counts, ax, lsz)
    half = sdf_query._scalar(sdf.resolution * 0.5, d)
    halo = coll.ppermute_from_next(d.narrow(ax, 0, 1), mesh, wrap=True)
    ext = torch.cat([d, halo], dim=ax).movedim(ax, 0)  # [lsz + 1, n1, n2]
    rows = torch.empty((lsz * n1 * n2, 8), dtype=d.dtype, device=d.device)
    for a0 in range(0, lsz, _TABLE_SLAB):
        a1 = min(a0 + _TABLE_SLAB, lsz)
        w = a1 - a0
        # Planes a0 .. a1 (the halo plane covers the slab's top stencil),
        # corrected and edge-padded by one along both other axes.
        pl = sdf_query._pull_to_surface(ext[a0:a1 + 1], half)
        pl = torch.cat([pl, pl[:, -1:]], dim=1)
        pl = torch.cat([pl, pl[:, :, -1:]], dim=2)
        chans = [pl[da:da + w, d1:d1 + n1, d2:d2 + n2]
                 for da in (0, 1) for d1 in (0, 1) for d2 in (0, 1)]
        rows[a0 * n1 * n2:a1 * n1 * n2] = torch.stack(
            chans, dim=-1).reshape(-1, 8)
    return SlabCornerTable(rows=rows, grid_axis=ax)


def sharded_render_depth_grid_sharded(
        sdf: SignedDistanceField, camera: render_ops.PinholeCamera,
        mesh: Mesh, axis_name: str = "z", num_steps: int = 64,
        max_depth: float = 100.0,
        surface_threshold: Optional[float] = None,
        steps_per_exchange: int = 8,
        grid_axis: int = 2,
        ray_chunks: int = 16,
        corner_rows: Optional[SlabCornerTable] = None,
        coarse_factor: int = 0,
        cone_steps: Optional[int] = None,
        cone_tail_chunks: int = 1,
        stats: Optional[dict] = None) -> Tensor:
    """Render with the GRID in slabs (for grids too big for one device);
    rays are on every rank, and so is the returned ``[H, W]`` depth image
    (``P()``).

    ``sdf.distances`` is this rank's slab along ``grid_axis``; with the
    halo plane from the next rank it covers every trilinear stencil whose
    base cell it owns. The march runs in phases: each rank advances only
    the rays whose stencil base it owns, for up to ``steps_per_exchange``
    steps (a ray that steps out of the slab freezes for the rest of the
    phase), then one sum over the ranks per carry reconciles ``(t, alive,
    steps)``: each ray was advanced by exactly one rank, so ``t +
    allreduce(t_n - t)`` is its new depth. A ray's samples and budget do
    not depend on the schedule, so the depths are the same for every
    ``steps_per_exchange``, ``ray_chunks`` and ``grid_axis``.

    Each phase sorts (stably) this rank's owned and runnable rays to the
    front and marches them in ``ray_chunks`` chunks; chunks with no such
    ray cost one check. Shard along an axis perpendicular to the view
    (``grid_axis=0`` for a camera looking along z), so rays stay in their
    slab and every rank marches its own at once.

    ``corner_rows`` (a :class:`SlabCornerTable` of the same mesh and
    ``grid_axis``) makes each owned sample one row gather with the
    single-device table interpolation, bit for bit. ``coarse_factor``,
    ``cone_steps`` and ``cone_tail_chunks`` run the cone prepass with the
    same arithmetic on every rank, each sample summed over the ranks (its
    owner's value), so the certificates are the single-device prepass's.
    ``stats`` (a dict) receives the number of march phases."""
    spec = sdf.spec
    n = _axis_size(mesh, axis_name)
    counts = spec.counts
    ax = int(grid_axis)
    if ax not in (0, 1, 2):
        raise ValueError(f"grid_axis must be 0, 1, or 2, got {grid_axis}")
    n_ax = counts[ax]
    if n_ax % n:
        raise ValueError(f"{n} shards must divide counts[{ax}] ({n_ax})")
    lsz = n_ax // n
    other = [a for a in range(3) if a != ax]
    n1, n2 = counts[other[0]], counts[other[1]]
    if coarse_factor:
        if camera.width % coarse_factor or camera.height % coarse_factor:
            raise ValueError(
                f"coarse_factor={coarse_factor} must divide the image "
                f"dimensions {camera.width}x{camera.height}")
    if corner_rows is not None:
        if not isinstance(corner_rows, SlabCornerTable):
            raise TypeError(
                "corner_rows must be a SlabCornerTable from "
                "sharded_build_corner_table (the grid_axis tag is what "
                "catches an axis mismatch: raw rows built along one axis "
                "render silent garbage along another)")
        if corner_rows.grid_axis != ax:
            raise ValueError(
                f"corner_rows was built with grid_axis="
                f"{corner_rows.grid_axis} but the render shards along "
                f"grid_axis={ax}")
        if tuple(corner_rows.rows.shape) != (lsz * n1 * n2, 8):
            raise ValueError(
                f"corner_rows.rows shape {tuple(corner_rows.rows.shape)} "
                f"does not match this grid's slab ({lsz * n1 * n2} cells)")
    d_local = sdf.distances
    _check_slab(d_local, counts, ax, lsz)
    dev = d_local.device

    res = _f32(spec.resolution, dev)
    if surface_threshold is None:
        surface_threshold = 0.25 * spec.resolution
    thresh = _f32(surface_threshold, dev)
    eps = _f32(1e-3 * spec.resolution, dev)
    max_d = _f32(max_depth, dev)
    zero = _f32(0.0, dev)

    origins_img, dirs_img = render_ops.camera_rays(camera)
    img_shape = tuple(origins_img.shape[:-1])
    n_rays = int(np.prod(img_shape))
    origins = origins_img.reshape(n_rays, 3)
    dirs = dirs_img.reshape(n_rays, 3)
    t_enter, t_exit, hits_grid = render_ops._clip_to_grid(sdf, origins, dirs)
    t0 = torch.where(hits_grid, t_enter + eps, max_d)
    t_stop = torch.minimum(t_exit, max_d)
    inv = sdf.inverse_origin_transform()
    counts_i = constant(tuple(counts), torch.int32, dev)
    b_hi = torch.clamp(counts_i - 2, min=0)

    k_ex = max(1, int(steps_per_exchange))
    kc = max(1, int(ray_chunks))
    pad = (-n_rays) % kc
    chunk = (n_rays + pad) // kc

    # Lanes of the slab table's permuted corner order (slab axis major) in
    # the canonical order c = 4*dx + 2*dy + dz.
    lane_perm = np.zeros(8, np.int64)
    for cc in range(8):
        d3 = ((cc >> 2) & 1, (cc >> 1) & 1, cc & 1)
        lane_perm[cc] = 4 * d3[ax] + 2 * d3[other[0]] + d3[other[1]]
    lane_perm = torch.as_tensor(lane_perm, device=dev)

    a_lo = mesh.rank * lsz
    local_rows = None if corner_rows is None else corner_rows.rows
    if local_rows is None:
        # +axis halo plane from the next rank (the last rank's, wrapped, is
        # never read: base cells there clamp to n_ax - 2, in its own
        # planes).
        half = res * 0.5
        halo = coll.ppermute_from_next(d_local.narrow(ax, 0, 1), mesh,
                                       wrap=True)
        ext = torch.cat([d_local, halo], dim=ax)
        corrected = torch.where(ext >= 0.0, ext - half, ext + half)
        ext_shape = tuple(ext.shape)
        del ext

    def base_cells(pos):
        """Stencil base cell, trilinear fractions, in-bounds flag and
        ownership of flat ``[m, 3]`` world positions."""
        p_grid = transforms.apply_isometry(inv, pos)
        finite = torch.all(torch.isfinite(pos), dim=-1)
        p_g = torch.where(finite[:, None], p_grid, zero)
        index = spec.location_in_grid_frame_to_grid_index(p_g)
        valid = finite & spec.check_grid_index_in_bounds(index)
        s = p_g / res - 0.5
        b = torch.minimum(torch.clamp(torch.floor(s).to(torch.int32), min=0),
                          b_hi)
        frac = s - b.to(torch.float32)
        mine = (b[:, ax] >= a_lo) & (b[:, ax] < a_lo + lsz)
        return b, frac, valid, mine

    def sample_local(pos):
        """(value, valid, mine): the value is right only where mine."""
        b, frac, valid, mine = base_cells(pos)
        b = b.long()
        b_ax = torch.where(mine, b[:, ax] - a_lo, torch.zeros_like(b[:, ax]))
        if local_rows is not None:
            # One local row gather + the single-device table interpolation.
            flat = b_ax * (n1 * n2) + b[:, other[0]] * n2 + b[:, other[1]]
            corners = local_rows.index_select(0, flat)[:, lane_perm]
            tx = frac[:, 0:1]
            ty = frac[:, 1:2]
            tz = frac[:, 2:3]
            cx = corners[:, 0:4] * (1 - tx) + corners[:, 4:8] * tx
            cy = cx[:, 0:2] * (1 - ty) + cx[:, 2:4] * ty
            value = cy[:, 0] * (1 - tz[:, 0]) + cy[:, 1] * tz[:, 0]
            return value, valid, mine
        i0 = [b[:, 0], b[:, 1], b[:, 2]]
        i0[ax] = b_ax
        i1 = [torch.clamp(b[:, k] + 1, max=counts[k] - 1) for k in range(3)]
        i1[ax] = b_ax + 1  # the halo plane covers the slab's top stencil
        flat_c = corrected.reshape(-1)
        s1, s2 = ext_shape[1], ext_shape[2]

        def corner(ox, oy, oz):
            x = i1[0] if ox else i0[0]
            y = i1[1] if oy else i0[1]
            z = i1[2] if oz else i0[2]
            return flat_c.index_select(0, x * (s1 * s2) + y * s2 + z)

        tx, ty, tz = frac[:, 0], frac[:, 1], frac[:, 2]
        c00 = corner(0, 0, 0) * (1 - tx) + corner(1, 0, 0) * tx
        c10 = corner(0, 1, 0) * (1 - tx) + corner(1, 1, 0) * tx
        c01 = corner(0, 0, 1) * (1 - tx) + corner(1, 0, 1) * tx
        c11 = corner(0, 1, 1) * (1 - tx) + corner(1, 1, 1) * tx
        c0 = c00 * (1 - ty) + c10 * ty
        c1 = c01 * (1 - ty) + c11 * ty
        return c0 * (1 - tz) + c1 * tz, valid, mine

    def sample_global(pos):
        value, valid, mine = sample_local(pos)
        return coll.all_reduce(torch.where(mine, value, zero), mesh), valid

    def march_chunk(t, alive, steps, o, d_ray, stop):
        """Up to k_ex owner steps of one chunk; a chunk with no live ray
        costs one check."""
        active = alive
        for _ in range(k_ex):
            if not bool(active.any()):
                break
            d, valid, mine = sample_local(o + d_ray * t[:, None])
            active = mine & alive & (steps < num_steps)
            d = torch.where(valid, d, thresh)
            converged = valid & (d <= thresh)
            adv = active & ~converged
            new_t = torch.where(adv, t + torch.maximum(d, eps), t)
            alive = torch.where(active, alive & ~converged & (new_t < stop),
                                alive)
            steps = steps + active.to(torch.int32)
            # A ray stays active next step only if it advanced; ownership is
            # re-derived from the new position, freezing rays that left.
            t, active = new_t, adv
        return t, alive, steps

    # -- Cone prepass: the same arithmetic on every rank, summed samples.
    t0_l, alive0 = t0, hits_grid
    slow_flat = None
    if coarse_factor:
        def raw_sum_sample(pos):
            shape = tuple(pos.shape[:-1])
            v, valid = sample_global(pos.reshape(-1, 3))
            return sdf_query.DistanceQuery(v.reshape(shape),
                                           valid.reshape(shape))

        t_i, t_v, cone_slow, c_m = (
            x.detach().reshape(n_rays) for x in render_ops._cone_prepass(
                sdf, camera, int(coarse_factor), num_steps,
                float(surface_threshold), max_depth, None,
                max_cone_steps=cone_steps,
                cone_tail_chunks=cone_tail_chunks,
                raw_sample_fn=raw_sum_sample))
        slow_flat = cone_slow
        # sphere_trace's certificate rule: retire rays whose in-grid span
        # lies inside the certified miss; start the rest at the certified
        # depth where their entry is covered.
        killed = c_m & (t_stop <= t_i) & (t_enter >= t_v)
        ti = torch.minimum(t_i, t_stop)
        ti = torch.where(t_enter >= t_v, ti, t0)
        t0_l = torch.maximum(t0, ti)
        alive0 = hits_grid & ~killed

    def prep(x, order, fill):
        xs = render_ops._pad_rows(x[order], pad, fill)
        return xs.reshape((kc, chunk) + tuple(x.shape[1:]))

    def phase(t, alive, steps):
        """This rank's owned rays advanced up to k_ex steps; no
        collectives."""
        _, _, _, mine_now = base_cells(origins + dirs * t[:, None])
        runnable = alive & (steps < num_steps)
        key = (~(mine_now & runnable)).to(torch.float32) * 1e12
        if slow_flat is not None:
            key = key - slow_flat
        order = torch.argsort(key, stable=True)
        cols = [prep(t, order, 0.0), prep(alive, order, False),
                prep(steps, order, num_steps), prep(origins, order, 0.0),
                prep(dirs, order, 0.0), prep(t_stop, order, 0.0)]
        outs = [march_chunk(*(c[i] for c in cols)) for i in range(kc)]

        def unsort(i, ref):
            flat = torch.cat([o[i] for o in outs])[:n_rays]
            out = torch.empty_like(ref)
            out[order] = flat
            return out

        return unsort(0, t), unsort(1, alive), unsort(2, steps)

    t, alive = t0_l, alive0
    steps = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    phases = 0
    while int(coll.all_reduce(
            (alive & (steps < num_steps)).sum(dtype=torch.int32),
            mesh)) > 0:
        t_n, alive_n, steps_n = phase(t, alive, steps)
        # Each ray was advanced by at most one rank, so summed deltas are
        # exact.
        t = t + coll.all_reduce(t_n - t, mesh)
        killed = alive & ~alive_n
        alive = alive & ~(coll.all_reduce(killed.to(torch.int32), mesh) > 0)
        steps = steps + coll.all_reduce(steps_n - steps, mesh)
        phases += 1
    if stats is not None:
        stats["phases"] = phases

    final_d, valid = sample_global(origins + dirs * t[:, None])
    final_d = torch.where(valid, final_d, _f32(float("inf"), dev))
    hit = hits_grid & valid & (final_d <= thresh * 2.0)
    refined = t + torch.where(hit, final_d, zero)
    return torch.where(hit, refined, max_d).reshape(img_shape)
