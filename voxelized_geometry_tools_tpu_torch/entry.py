"""The port's flagship forward: a sphere-traced depth render over a voxel
SDF, differentiable in the voxel values and the camera pose (the port's
counterpart of ``entry()`` in the repository's ``__graft_entry__.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.device import default_device
from .core.grid import GridSpec
from .core.maps import SignedDistanceField
from .ops import edt, render


def _build_scene(counts, resolution: float = 0.25, device=None):
    """A centered sphere of radius ``min(counts) // 4`` voxels, as a locked
    ``SignedDistanceField`` built by the exact EDT on ``device``."""
    spec = GridSpec.from_voxel_counts(resolution, counts)
    cx, cy, cz = [c // 2 for c in counts]
    r = min(counts) // 4
    xs, ys, zs = np.meshgrid(*[np.arange(c) for c in counts], indexing="ij")
    filled = ((xs - cx) ** 2 + (ys - cy) ** 2 + (zs - cz) ** 2) <= r * r
    sdf = edt.extract_signed_distance_field(
        torch.as_tensor(filled, device=default_device(device)), spec, None,
        frame="bench")
    return spec, sdf


def entry(device=None):
    """``(forward, (distances, pose))``: ``forward(distances, pose)``
    renders a 64x64 depth image of a 64^3 sphere SDF in 48 fixed march
    steps; both inputs are differentiable. Runs on ``device``; None means
    the CUDA card."""
    spec, sdf = _build_scene((64, 64, 64), device=device)
    width, height = 64, 64

    center = np.asarray(spec.grid_sizes) / 2.0
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = center + np.array([0.0, 0.0, -1.5 * spec.grid_sizes[2]])
    camera = render.PinholeCamera.create(pose, width, height, focal=64.0,
                                         device=sdf.distances.device)

    def forward(distances: torch.Tensor,
                camera_pose: torch.Tensor) -> torch.Tensor:
        cur_sdf = sdf.replace(distances=distances)
        cur_cam = dataclasses.replace(camera, pose=camera_pose)
        return render.render_depth(cur_sdf, cur_cam, num_steps=48).depth

    return forward, (sdf.distances, camera.pose)


def _dryrun_scene(scene_n: int, device):
    """``__graft_entry__.dryrun_multichip``'s tiny scene for ``scene_n``
    ranks: a ``(2n, 8, 2n)`` grid, an 8x8 depth cloud, an 8 x max(2n, 8)
    camera and its flat target depth."""
    from .core.maps import OccupancyMap
    from .ops import voxelize

    n = scene_n
    counts = (2 * n, 8, 2 * n)
    spec = GridSpec.from_voxel_counts(0.25, counts)
    env = OccupancyMap.create(spec, None, "world", device=device)
    grid_sizes = np.asarray(spec.grid_sizes)
    uv = np.stack(np.meshgrid(np.linspace(-0.4, 0.4, 8),
                              np.linspace(-0.4, 0.4, 8), indexing="ij"), -1)
    pts = np.concatenate(
        [uv, np.full((8, 8, 1), 0.6 * grid_sizes[2])], -1).reshape(-1, 3)
    cam_pose = np.eye(4, dtype=np.float32)
    cam_pose[:3, 3] = grid_sizes / 2.0 - np.array([0, 0, grid_sizes[2]])
    cloud = voxelize.PointCloud.create(pts.astype(np.float32), cam_pose,
                                       device=device)
    height = max(2 * n, 8)
    camera = render.PinholeCamera.create(cam_pose, width=8, height=height,
                                         focal=8.0, device=device)
    target = torch.full((height, 8), 0.6 * float(grid_sizes[2]),
                        dtype=torch.float32, device=device)
    return spec, env, cloud, camera, target


def _dryrun_rank(mesh, scene_n: int) -> dict:
    """One rank of :func:`dryrun_multichip` on ``scene_n``'s scene: the
    sharded training step, then the grid-sharded fast render. Returns the
    loss, this rank's Z slab of the distances' gradient and of the updated
    distances, the pose tangent's gradient and update, and the
    grid-sharded depth image."""
    from .models.fusion_pipeline import perturb_pose
    from .ops import voxelize
    from .parallel import collectives, sharded

    dev = mesh.device
    spec, env, cloud, camera, target = _dryrun_scene(scene_n, dev)
    lr = 0.05
    lz = spec.counts[2] // mesh.size
    distances_prev = torch.zeros(spec.counts[:2] + (lz,), device=dev)
    tangent = torch.zeros(6, device=dev, requires_grad=True)

    # 1. Rays over the ranks, counters reduce-scattered into Z slabs.
    carved = sharded.sharded_voxelize_pointclouds(
        env, voxelize.FilterOptions(), [cloud], mesh)
    # 2. Z-slab EDT with all-to-all transposes.
    sdf = sharded.sharded_extract_sdf(carved.occupancy, spec,
                                      carved.origin_transform, mesh)
    # Blend with the trainable voxel values (this rank's slab).
    distances = (0.5 * sdf.distances + 0.5 * distances_prev).requires_grad_()

    # 3. Pixel rows over the ranks on the all-gathered field. The backward
    # pass of the gather reduce-scatters the voxels' gradient, and the
    # pose's (replicated) gradient is summed over the ranks: what the JAX
    # partitioner does for replicated inputs.
    whole = collectives.AllGather.apply(distances, mesh, 2)
    cam = dataclasses.replace(camera, pose=perturb_pose(camera.pose, tangent))
    depth = sharded.sharded_render_depth(sdf.replace(distances=whole), cam,
                                         mesh, num_steps=16)
    lh = camera.height // mesh.size
    rows = target[mesh.rank * lh:(mesh.rank + 1) * lh]
    local_loss = ((depth - rows) ** 2).sum() / target.numel()
    local_loss.backward()
    loss = collectives.all_reduce(local_loss.detach(), mesh)
    grad_d = distances.grad
    grad_t = collectives.all_reduce(tangent.grad, mesh)
    new_d = distances.detach() - lr * grad_d
    new_t = tangent.detach() - lr * grad_t

    # 4. The grid-sharded fast render: slab corner table along x (the Z
    # slabs resharded by one all-to-all) and the cone prepass.
    counts = spec.counts
    filled = torch.zeros(counts, dtype=torch.float32, device=dev)
    filled[counts[0] // 4: counts[0] // 2, 2:6,
           counts[2] // 4: counts[2] // 2] = 1.0
    sdf2 = sharded.sharded_extract_sdf(
        filled[:, :, mesh.rank * lz:(mesh.rank + 1) * lz], spec, None, mesh)
    sdf2 = sdf2.replace(distances=sharded.reshard_slabs(
        sdf2.distances, mesh, from_axis=2, to_axis=0))
    table = sharded.sharded_build_corner_table(sdf2, mesh, grid_axis=0)
    cf = 4 if (camera.width % 4 == 0 and camera.height % 4 == 0) else 2
    depth_gs = sharded.sharded_render_depth_grid_sharded(
        sdf2, camera, mesh, grid_axis=0, num_steps=16, corner_rows=table,
        coarse_factor=cf, cone_steps=8, cone_tail_chunks=2,
        steps_per_exchange=16, ray_chunks=4)
    return {"loss": loss, "grad_d": grad_d, "new_d": new_d, "grad_t": grad_t,
            "new_t": new_t, "depth_gs": depth_gs}


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """One full sharded training step in a world of ``n_devices`` ranks
    (the counterpart of ``dryrun_multichip`` in the repository's
    ``__graft_entry__.py``): sharded carve -> Z-slab EDT -> blend with
    trainable distances -> pixel-sharded render, differentiable in the
    voxels and the pose -> loss, gradients and an SGD step; then the
    grid-sharded render with the slab table and the cone prepass, on tiny
    shapes. ``device`` None means the card; ``backend`` None means NCCL on
    the card (one card a rank) and gloo on the CPU. Returns the outputs,
    put together; raises on a non-finite loss or depth.

    Below 8 ranks the scene's field holds +inf (no surface on some lines),
    whose interpolation makes the pose gradient NaN, in the JAX package's
    step as in this one (the JAX function asserts a finite pose update,
    which holds at its own 8 ranks only); the line printed says whether
    the pose update is finite."""
    from .parallel import launch
    from .parallel.mesh_utils import P

    device = default_device(device).type
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    slabs = P(None, None, "z")
    out = launch.run(n_devices, _dryrun_rank, backend=backend, device=device,
                     out_specs={"loss": P(), "grad_d": slabs, "new_d": slabs,
                                "grad_t": P(), "new_t": P(),
                                "depth_gs": P()},
                     scene_n=n_devices)
    if not (np.isfinite(out["loss"]) and np.isfinite(out["depth_gs"]).all()):
        raise AssertionError("non-finite loss or depth in the multichip "
                             "dryrun")
    print(f"dryrun_multichip({n_devices}): loss={float(out['loss']):.6f}, "
          f"pose update finite: {bool(np.isfinite(out['new_t']).all())}, "
          f"{backend} on {device}: OK")
    return out
