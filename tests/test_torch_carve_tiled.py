"""The tiled carve's plain model (``kernels/carve.py::carve_tiled_plain``:
each walk cut into per-tile segments by the bin pass's closed-form exits,
each segment re-walked from its saved state, both grids written in full)
against the plain walk and the JAX package's walk run op by op, bit for bit,
on small tiles that cut the rays many times; the tiled kernel's bound on
its list entries; the voxelizers' carve into one stacked pair; and, on a
card, the tiled kernel against the plain walk.

The JAX package runs op by op (``jax.disable_jit()``), as in
``test_torch_voxelize.py``: its compiled walk contracts ``a * b + c`` into
fused multiply-adds and picks other voxels at near-ties.
"""

import numpy as np
import jax  # noqa: F401  (imported before torch, as the other port tests)
import pytest
import torch

from test_torch_voxelize import SCENES, _eager, _tcloud, _tmat, _tspec
from test_voxelize import make_scene
from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.ops import voxelize as jv
from voxelized_geometry_tools_tpu_torch import interop
from voxelized_geometry_tools_tpu_torch.kernels import carve
from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv

# A value no carve writes: the tiled carve must overwrite all of it.
GARBAGE = -7


def _oracle(i):
    env, clouds = make_scene()
    return env.spec, np.asarray(env.origin_transform), clouds[i]


def _axis_aligned():
    """Rays along the grid axes and in axis planes (t0 = inf and dt = 0 on
    the axes they do not cross), from a camera at a voxel centre inside a
    16^3 grid, so that the in-plane diagonals tie at every crossing; some
    end inside, some beyond the grid, some range-clipped."""
    spec = JGridSpec.from_voxel_counts(0.1, (16, 16, 16))
    dirs = []
    for axis in range(3):
        for sign in (1.0, -1.0):
            d = np.zeros(3)
            d[axis] = sign
            dirs.append(d)
    for a, b in ((0, 1), (1, 2), (0, 2)):
        for sa in (1.0, -1.0):
            for sb in (1.0, -1.0):
                d = np.zeros(3)
                d[a], d[b] = sa, sb
                dirs.append(d)
                d = d.copy()
                d[b] *= 0.5
                dirs.append(d)
    dirs = np.array(dirs)
    pts = np.concatenate([dirs * 0.45, dirs * 0.9, dirs * 3.0])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.85, 0.75, 0.65)
    cloud = jv.PointCloud.create(pts.astype(np.float32), pose, max_range=1.2)
    return spec, np.eye(4, dtype=np.float32), cloud


def _axis_from_outside():
    """Axis-aligned rays from a camera outside a 16^3 grid: the walk
    starts at the entry voxel."""
    spec = JGridSpec.from_voxel_counts(0.1, (16, 16, 16))
    ys, zs = np.meshgrid(np.linspace(-0.5, 0.5, 7), np.linspace(-0.4, 0.4, 5))
    pts = np.stack([np.full(ys.size, 2.5), ys.ravel(), zs.ravel()], -1)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (-0.55, 0.8, 0.8)
    cloud = jv.PointCloud.create(pts.astype(np.float32), pose)
    return spec, np.eye(4, dtype=np.float32), cloud


def _sentinels():
    """Huge finite sentinels and NaN with max_range = inf
    (test_torch_voxelize's sentinel case) beside ordinary points."""
    spec = JGridSpec.from_voxel_counts(1.0, (8, 8, 8))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (4.5, 4.5, 4.5)
    pts = np.array([[0.0, 0.0, -1e10], [0.0, 1e-6, -3.4e38],
                    [np.nan, 0.0, 0.0], [3.4e38, 1.0, 2.0],
                    [1.2, -2.1, 0.7], [-3.0, 0.4, 2.2]], np.float32)
    return spec, np.eye(4, dtype=np.float32), jv.PointCloud.create(pts, pose)


CASES = dict(SCENES)
CASES.update({"oracle camera 1": lambda: _oracle(0),
              "oracle camera 2": lambda: _oracle(1),
              "axis aligned": _axis_aligned,
              "axis aligned from outside": _axis_from_outside,
              "sentinels": _sentinels})
# Tiles that cut the rays every few voxels, one that divides no grid here,
# and one larger than every grid (a one-tile grid).
TILES = [(4, 4, 8), (2, 2, 4), (3, 5, 7), (64, 64, 128)]


@pytest.fixture(scope="module")
def refs():
    """Per (case, max_steps): the JAX package's grids (op by op) and the
    port's plain walk's, both flat."""
    cache = {}

    def get(name, max_steps):
        key = (name, max_steps)
        if key not in cache:
            spec, origin, cloud = CASES[name]()
            ref = _eager(jv.raycast_pointcloud, spec, origin, cloud,
                         max_steps=max_steps)
            tspec = _tspec(spec)
            setup = tv.ray_setup(tspec, _tmat(origin), _tcloud(cloud))
            n_steps = carve.segment_steps(max_steps or sum(tspec.counts) + 2)
            free = torch.zeros(tspec.num_total, dtype=torch.int32)
            filled = torch.zeros_like(free)
            carve.carve_plain(tspec.counts, setup, n_steps, free, filled)
            cache[key] = (tspec, setup, n_steps,
                          np.asarray(ref.seen_free).ravel(),
                          np.asarray(ref.seen_filled).ravel(), free, filled)
        return cache[key]

    return get


def _tiled(tspec, setup, n_steps, tile):
    free = torch.full((tspec.num_total,), GARBAGE, dtype=torch.int32)
    filled = free.clone()
    carve.carve_tiled_plain(tspec.counts, setup, n_steps, free, filled, tile)
    return free, filled


@pytest.mark.parametrize("tile", TILES, ids=str)
@pytest.mark.parametrize("max_steps", [None, 5])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tiled_plain_matches_walk_and_jax(refs, name, max_steps, tile):
    """Every case, both the default budget and one that ends inside the
    walks (5 steps, rounded to 64), every tile shape: the tiled model
    equals the plain walk and the JAX package's walk, bitwise, and writes
    every voxel."""
    tspec, setup, n_steps, jfree, jfilled, free, filled = refs(name,
                                                               max_steps)
    got_free, got_filled = _tiled(tspec, setup, n_steps, tile)
    assert torch.equal(got_free, free) and torch.equal(got_filled, filled)
    np.testing.assert_array_equal(got_free.numpy(), jfree)
    np.testing.assert_array_equal(got_filled.numpy(), jfilled)


@pytest.mark.parametrize("n_steps", [1, 2, 3, 7, 20, 45])
@pytest.mark.parametrize("name", ["inside", "long", "outside",
                                  "axis aligned"])
def test_budgets_that_end_inside_a_tile(refs, name, n_steps):
    """Budgets below a segment (the kernel's own argument, not rounded)
    stop walks part-way through a tile: the tiled model equals the plain
    walk, and budgets up to 7 steps cut some walks."""
    tspec, setup, _, _, _, free, _ = refs(name, None)
    want_free = torch.zeros_like(free)
    want_filled = torch.zeros_like(free)
    carve.carve_plain(tspec.counts, setup, n_steps, want_free, want_filled)
    for tile in ((4, 4, 8), (3, 5, 7)):
        got_free, got_filled = _tiled(tspec, setup, n_steps, tile)
        assert torch.equal(got_free, want_free)
        assert torch.equal(got_filled, want_filled)
    visits = carve.count_visits(tspec.counts, setup, n_steps)
    full = carve.count_visits(tspec.counts, setup, 10_000)
    assert 0 < visits <= full and (visits < full or n_steps > 7)


def test_long_walks_cross_many_tiles(refs):
    """The long scene's 90-100 voxel walks along z are cut into many
    segments by (3, 5, 7) tiles, and the 64-step budget (max_steps 5) cuts
    the walks themselves."""
    tspec, setup, n_steps, *_ = refs("long", 5)
    segments, _ = carve.count_entries(tspec.counts, setup, n_steps,
                                      (3, 5, 7))
    assert segments >= 9 * int(setup.hit.sum())
    assert carve.count_visits(tspec.counts, setup, n_steps) < \
        carve.count_visits(tspec.counts, setup, 10_000)


def _empty():
    """A cloud without points."""
    spec = JGridSpec.from_voxel_counts(0.1, (12, 9, 10))
    cloud = jv.PointCloud.create(np.zeros((0, 3), np.float32))
    return spec, np.eye(4, dtype=np.float32), cloud


@pytest.mark.parametrize("tile", TILES, ids=str)
def test_empty_cloud(tile):
    """No rays: both grids are written with zeros, as the JAX package's."""
    spec, _, cloud = _empty()
    ref = _eager(jv.raycast_pointcloud, spec, np.eye(4), cloud)
    tspec = _tspec(spec)
    setup = tv.ray_setup(tspec, torch.eye(4), _tcloud(cloud))
    free, filled = _tiled(tspec, setup, 64, tile)
    np.testing.assert_array_equal(free.numpy(),
                                  np.asarray(ref.seen_free).ravel())
    np.testing.assert_array_equal(filled.numpy(),
                                  np.asarray(ref.seen_filled).ravel())
    assert carve.count_entries(tspec.counts, setup, 64, tile) == (0, 0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_entries_within_bound(refs, name):
    """The bin pass's segments a ray never exceed the bound the kernel's
    lists are sized by (1 + sum(tiles along an axis - 1), at most the
    budget), and the entries fit its capacity."""
    tspec, setup, n_steps, *_ = refs(name, None)
    n_rays = setup.hit.shape[0]
    for tile in TILES:
        shape = carve.tile_shape(tspec.counts, tile)
        ray, _ = carve._bin_segments(tspec.counts, shape, setup, n_steps)
        per_ray = torch.bincount(ray, minlength=n_rays)
        tiles = [-(-n // e) for n, e in zip(tspec.counts, shape)]
        assert int(per_ray.max()) <= min(sum(tiles) - 2, n_steps)
        segments, ends = carve.count_entries(tspec.counts, setup, n_steps,
                                             tile)
        assert segments == ray.numel()
        assert segments + ends <= carve.entry_capacity(
            tspec.counts, shape, n_rays, n_steps)


def test_tile_shape_and_checks():
    """Tiles are cut to the grid; bad or too large tiles raise; the kernel
    refuses CPU tensors and counts no launch (no fallback)."""
    assert carve.tile_shape((512, 512, 512)) == carve.TILE
    assert carve.tile_shape((6, 40, 30)) == (6, 16, 30)
    assert carve.tile_smem_bytes(carve.TILE) == 4 * int(np.prod(carve.TILE))
    with pytest.raises(ValueError, match="positive"):
        carve.tile_shape((8, 8, 8), (0, 4, 4))
    spec, origin, cloud = SCENES["inside"]()
    tspec = _tspec(spec)
    setup = tv.ray_setup(tspec, _tmat(origin), _tcloud(cloud))
    grid = torch.zeros(tspec.num_total, dtype=torch.int32)
    before = carve.launches_tiled
    with pytest.raises(ValueError, match="CUDA"):
        carve.carve_tiled(tspec.counts, setup, 64, grid, grid.clone())
    with pytest.raises(ValueError, match="shared memory"):
        carve.carve_tiled((64, 64, 64), setup, 64, grid, grid.clone(),
                          (64, 64, 64))
    assert carve.launches_tiled == before


def test_stacked_pair_matches_fresh_grids():
    """voxelize_pointclouds and the CPU accelerator carve into one stacked
    pair; raycast_pointcloud with ``_out`` writes the given slices in full
    (over garbage) and returns them; wrong ``_out`` grids raise."""
    env, clouds = make_scene()
    tspec = _tspec(env.spec)
    G = _tmat(env.origin_transform)
    tclouds = [_tcloud(c) for c in clouds]
    stacked = tv.TrackingGrid(*(torch.full((len(clouds),) + tspec.counts,
                                           GARBAGE, dtype=torch.int32)
                                for _ in range(2)))
    for i, c in enumerate(tclouds):
        fresh = tv.raycast_pointcloud(tspec, G, c)
        got = tv.raycast_pointcloud(
            tspec, G, c, _out=tv.TrackingGrid(stacked.seen_free[i],
                                              stacked.seen_filled[i]))
        assert got.seen_free.data_ptr() == stacked.seen_free[i].data_ptr()
        assert torch.equal(got.seen_free, fresh.seen_free)
        assert torch.equal(got.seen_filled, fresh.seen_filled)
    with pytest.raises(ValueError, match="_out"):
        tv.raycast_pointcloud(tspec, G, tclouds[0], _out=tv.TrackingGrid(
            stacked.seen_free[0].float(), stacked.seen_filled[0]))
    tenv = interop.occupancy_map_from_numpy(
        tspec, np.asarray(env.occupancy), np.asarray(env.origin_transform),
        env.frame, device="cpu")
    want = tv.combine_and_filter(tv.FilterOptions(1.0, 1, 1),
                                 stacked.seen_free, stacked.seen_filled,
                                 tenv.occupancy)
    out = tv.voxelize_pointclouds(tenv, tv.FilterOptions(1.0, 1, 1),
                                  tclouds)
    assert torch.equal(out.occupancy, want)


@pytest.mark.cuda
def test_cuda_tiled_kernel_matches_plain_and_walk():
    """On the card: the tiled kernel (every tile shape here, the default
    included) against the plain walk on the CPU, bitwise, over grids of
    garbage, an empty cloud included; raycast_pointcloud launches it once
    a cloud, into fresh grids and into a slice of a stacked pair."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, case in list(CASES.items()) + [("empty", _empty)]:
        spec, origin, cloud = case()
        tspec = _tspec(spec)
        host = tv.ray_setup(tspec, _tmat(origin), _tcloud(cloud))
        dev = carve.RaySetup(*(t.cuda() for t in host))
        for max_steps in (None, 5, 3):
            n_steps = (3 if max_steps == 3 else carve.segment_steps(
                max_steps or sum(tspec.counts) + 2))
            want_free = torch.zeros(tspec.num_total, dtype=torch.int32)
            want_filled = torch.zeros_like(want_free)
            carve.carve_plain(tspec.counts, host, n_steps, want_free,
                              want_filled)
            for tile in TILES + [carve.TILE]:
                free = torch.full((tspec.num_total,), GARBAGE,
                                  dtype=torch.int32, device="cuda")
                filled = free.clone()
                before = carve.launches_tiled
                carve.carve_tiled(tspec.counts, dev, n_steps, free, filled,
                                  tile)
                torch.cuda.synchronize()
                assert carve.launches_tiled == before + 1
                assert torch.equal(free.cpu(), want_free), name
                assert torch.equal(filled.cpu(), want_filled), name
        cuda_cloud = interop.pointcloud_from_numpy(
            np.asarray(cloud.points), np.asarray(cloud.origin_transform),
            np.asarray(cloud.max_range), device="cuda")
        stacked = [torch.full((3,) + tspec.counts, GARBAGE,
                              dtype=torch.int32, device="cuda")
                   for _ in range(2)]
        ref = tv.raycast_pointcloud(tspec, _tmat(origin), _tcloud(cloud))
        for out in (None, tv.TrackingGrid(stacked[0][1], stacked[1][1])):
            tiled = carve.launches_tiled
            got = tv.raycast_pointcloud(tspec, _tmat(origin).cuda(),
                                        cuda_cloud, _out=out)
            assert carve.launches_tiled == tiled + 1
            assert torch.equal(got.seen_free.cpu(), ref.seen_free), name
            assert torch.equal(got.seen_filled.cpu(), ref.seen_filled), name
        for g in stacked:
            assert bool((g[0] == GARBAGE).all() & (g[2] == GARBAGE).all())
