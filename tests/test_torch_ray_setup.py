"""The carve's setup on the card: the setup kernel (``kernels/ray_setup.py``)
and the transform product kernel (``kernels/transform_product.py``), bit
for bit.

The card tests hold the setup kernel against its plain version, the
PyTorch setup of ``ops/voxelize.py`` run on the card, for every field of
``RaySetup``, and the product kernel against the host's FMA chains
(``core/transforms._fma_chain``, ``_fma_chain_f64``), on the clouds of
``tests/test_torch_voxelize.py`` (made here in numpy), fault F1's rotated
grid origin and edge rays: non-finite points, range-clipped rays, rays
that start outside the grid, grazing and zero-length rays, the 1e9 and
``FLT_MAX`` sentinels. The CPU tests hold what surrounds the kernels: the
CPU route keeps the plain setup and launches nothing, the setup's one
buffer, the wrappers' checks and the range's upload. This file imports no JAX, so the card tests run where JAX is not
installed.
"""

import math

import numpy as np
import pytest
import torch

from voxelized_geometry_tools_tpu_torch import GridSpec
from voxelized_geometry_tools_tpu_torch.core import transforms
from voxelized_geometry_tools_tpu_torch.kernels import (carve, ray_setup,
                                                        transform_product)
from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv

FLT_MAX = float(np.finfo(np.float32).max)


def _translation(t):
    return transforms.np_isometry_from_translation(t)


def _rotation(q):
    """Rotation matrix of the unit quaternion ``q / |q|`` (w, x, y, z)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _rotz(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _inside():
    """test_torch_voxelize.py's camera inside a 20x24x28 grid."""
    rng = np.random.default_rng(42)
    o = rng.uniform(0.2, 0.9, 3)
    pts = rng.uniform(-0.3, 1.6, (600, 3))
    return (GridSpec.from_voxel_counts(0.05, (20, 24, 28)),
            np.eye(4, dtype=np.float32), (pts - o).astype(np.float32),
            _translation(o), 3.0)


def _long():
    """test_torch_voxelize.py's camera below a 6x6x90 column."""
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(-0.2, 0.2, 400), rng.uniform(-0.2, 0.2, 400),
                    rng.uniform(4.6, 5.0, 400)], -1).astype(np.float32)
    return (GridSpec.from_voxel_counts(0.05, (6, 6, 90)),
            np.eye(4, dtype=np.float32), pts,
            _translation((0.15, 0.15, -0.1)), math.inf)


def _outside():
    """test_torch_voxelize.py's rotated camera outside a translated 25^3
    grid: NaN and infinite points, the 1e9 and FLT_MAX sentinels, clipped
    rays, final voxels beyond the grid."""
    rng = np.random.default_rng(3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rotz(0.4)
    pose[:3, 3] = (-0.4, 0.5, 0.5)
    pts = rng.uniform(-0.2, 1.8, (600, 3)).astype(np.float32)
    pts[:4] = np.nan
    pts[4, 0] = np.inf
    pts[5:8] = (1e9, 2e9, -1e9)
    pts[8] = (3.4e38, 1e-6, 2.0)
    pts[9] = (0.0, 0.0, -3.4e38)
    return (GridSpec.from_voxel_counts(0.04, (25, 25, 25)),
            _translation((0.2, -0.1, 0.05)), pts, pose, 1.1)


def _f1():
    """Fault F1's input (tests/test_torch_transforms_exact.py, seed 1): a
    grid origin rotated about all three axes, a rotated camera inside."""
    rng = np.random.default_rng(1)
    n, res = 64, 0.02
    origin = np.eye(4, dtype=np.float32)
    origin[:3, :3] = _rotation(rng.normal(size=4))
    origin[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    cam_grid = np.full(3, n) * res * rng.uniform(0.3, 0.7, 3)
    cam_rot = _rotation(rng.normal(size=4))
    pts = rng.uniform(-2, 2, (2000, 3)).astype(np.float32)
    o = origin.astype(np.float64)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = o[:3, :3] @ cam_rot
    pose[:3, 3] = o[:3, :3] @ cam_grid + o[:3, 3]
    return GridSpec.from_voxel_counts(res, (n,) * 3), origin, pts, pose, 5.0


def _edges():
    """Edge rays from a camera outside a 16^3 grid at 0.1 m, level with its
    y = 0 face and its z = 1.6 m face: rays along and grazing the faces
    (direction components of 0, -0, 1e-12 and 1e-9 of the length), rays
    that miss it, reach it or pass it, zero-length rays, points on voxel
    boundaries, subnormal components, non-finite points and sentinels,
    and range-clipped rays; max_range 2.5 m."""
    pts = [(0.0, 0.0, 0.0), (-0.0, -0.0, -0.0), (1.0, 0.0, 0.0),
           (1.0, -0.0, 0.0), (2.0, 1e-12, 0.0), (2.0, 1e-9, -1e-9),
           (3.0, 0.0, -1e-12), (1.5, 0.3, -0.4), (0.45, 0.5, -0.3),
           (0.4, 0.0, -1.6), (1e-45, 1e-45, 1e-45), (0.9, -1e-38, 1e-40),
           (1e9, 0.0, 0.0), (-1e9, 1e9, 1e9), (FLT_MAX, 0.0, 0.0),
           (0.0, -FLT_MAX, FLT_MAX), (np.nan, 0.0, 0.0),
           (0.0, np.inf, 0.0), (-np.inf, np.inf, 1.0), (5.0, 5.0, 5.0),
           (-1.0, 0.0, 0.0), (0.1, 0.1, 0.1), (0.2, 0.0, 0.0),
           (1.7, 0.0, 0.0), (0.0, 1.6, 0.0), (0.0, 0.0, -1.6)]
    pose = _translation((-0.1, 0.0, 1.6))
    return (GridSpec.from_voxel_counts(0.1, (16, 16, 16)),
            np.eye(4, dtype=np.float32), np.array(pts, np.float32), pose,
            2.5)


def _edges_inside():
    """The edge rays from a camera at a voxel corner inside the grid
    (every start voxel its own), with max_range inf and a rotated grid."""
    spec, _, pts, _, _ = _edges()
    origin = np.eye(4, dtype=np.float32)
    origin[:3, :3] = _rotz(0.3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rotz(0.3)
    pose[:3, 3] = origin[:3, :3].astype(np.float64) @ (0.8, 0.8, 0.8)
    return spec, origin, pts, pose, math.inf


SCENES = {"inside": _inside, "long": _long, "outside": _outside, "F1": _f1,
          "edges": _edges, "edges_inside": _edges_inside}


def _cloud(scene, device):
    spec, origin, pts, pose, max_range = SCENES[scene]()
    cloud = tv.PointCloud.create(pts, pose, max_range=max_range,
                                 device=device)
    return spec, torch.from_numpy(origin).to(device), cloud


def _bits(t):
    """The tensor's bits, on the CPU (floats as int32)."""
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# -- CPU -----------------------------------------------------------------


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cpu_cloud_takes_the_plain_setup(scene, monkeypatch):
    """On a CPU cloud ``ray_setup`` is the plain setup, bit for bit, and
    launches neither kernel."""
    spec, origin, cloud = _cloud(scene, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU cloud reached a kernel")

    monkeypatch.setattr(ray_setup, "ray_setup", refuse)
    monkeypatch.setattr(transform_product, "fma_chain_product", refuse)
    got = tv.ray_setup(spec, origin, cloud)
    X_GC = transforms.compose(transforms.invert_isometry(origin),
                              cloud.origin_transform)
    want = tv._ray_visits(spec, *tv._prepare_rays(spec, X_GC, cloud.points,
                                                  cloud.max_range))
    for name in carve.RaySetup._fields:
        assert torch.equal(_bits(getattr(got, name)),
                           _bits(getattr(want, name))), name
    assert bool(got.hit.any())


def test_setup_arrays_are_what_the_carve_kernel_checks():
    """The kernel's output arrays have the shapes, types and layout the
    carve kernel checks, and their bytes a ray are ``SETUP_BYTES``, the
    reader's ``RAY_BYTES`` less the point's."""
    for n in (0, 1, 1000):
        s = ray_setup._empty_setup(n, "cpu")
        for name in carve.RaySetup._fields:
            t = getattr(s, name)
            assert t.is_contiguous(), name
            assert t.shape == ((n, 3) if name in ("start", "final", "step",
                                                  "t0", "dt") else (n,))
        assert sum(t.nbytes for t in s) == n * ray_setup.SETUP_BYTES
    assert (s.start.dtype, s.final.dtype, s.step.dtype, s.t0.dtype,
            s.dt.dtype, s.hit.dtype, s.end_flat.dtype,
            s.end_filled.dtype) == (torch.int32,) * 3 + (torch.float32,) * 2 \
        + (torch.bool, torch.int32, torch.bool)
    assert ray_setup.RAY_BYTES == 12 + 66


def test_kernel_wrappers_refuse_cpu_tensors_before_launching():
    """Both wrappers check their operands before building or launching:
    CPU tensors, mixed or unsupported types and bad shapes raise."""
    a = torch.eye(4)
    with pytest.raises(ValueError):
        transform_product.fma_chain_product(a, a)
    with pytest.raises(TypeError):
        transform_product.fma_chain_product(a, a.double())
    with pytest.raises(TypeError):
        transform_product.fma_chain_product(a.half(), a.half())
    with pytest.raises(ValueError):
        transform_product.fma_chain_product(a, torch.eye(3))
    with pytest.raises(ValueError):
        ray_setup.ray_setup(a, torch.zeros(5, 3), torch.tensor(1.0),
                            (4, 4, 4), 0.1, (0.4, 0.4, 0.4))


@pytest.mark.parametrize("max_range", [0.5, 1.1, 3.0, 1 / 3, math.inf,
                                       3.4028235e38, 1e39, np.float64(2.2),
                                       4])
def test_point_cloud_range_is_filled_in_place(max_range):
    """``PointCloud.create``'s range is the float32 rounding of the value,
    as ``torch.tensor`` rounds it, made without a host copy."""
    cloud = tv.PointCloud.create(np.zeros((2, 3), np.float32),
                                 max_range=max_range, device="cpu")
    want = torch.tensor(float(max_range), dtype=torch.float32)
    assert cloud.max_range.shape == () and cloud.max_range.dtype == \
        torch.float32
    assert torch.equal(cloud.max_range.view(torch.int32),
                       want.view(torch.int32))


# -- On the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cuda_setup_kernel_matches_plain(card, scene):
    """The setup kernel against the plain setup on the card, from the same
    X_GC, every field bitwise (t0 and dt as bits, NaN included); one
    launch a cloud; the plain setup on the CPU agrees on the walked rays
    (a float to int conversion of NaN differs between devices), their
    final voxels where they fit in int32 (beyond it the card's conversion
    saturates and the CPU's gives INT_MIN; the step's sign agrees, since
    the difference wraps)."""
    spec, origin, cloud = _cloud(scene, card)
    X_GC = tv._grid_frame_transform(origin, cloud)
    before = ray_setup.launches
    got = tv.ray_setup(spec, origin, cloud)
    assert ray_setup.launches == before + 1
    want = tv.ray_setup_plain(spec, X_GC, cloud.points, cloud.max_range)
    torch.cuda.synchronize()
    for name in carve.RaySetup._fields:
        assert torch.equal(_bits(getattr(got, name)),
                           _bits(getattr(want, name))), (scene, name)
    spec_cpu, origin_cpu, host = _cloud(scene, "cpu")
    cpu = tv.ray_setup(spec_cpu, origin_cpu, host)
    hit = cpu.hit
    assert torch.equal(got.hit.cpu(), hit)
    final = cpu.final.long()
    fits = ((final > -2 ** 31) & (final < 2 ** 31 - 1)).all(-1)
    for name in carve.RaySetup._fields:
        rays = hit & fits if name == "final" else hit
        assert torch.equal(_bits(getattr(got, name))[rays],
                           _bits(getattr(cpu, name))[rays]), (scene, name)


@pytest.mark.cuda
def test_cuda_setup_kernel_on_an_empty_cloud(card):
    """No rays: no launch, empty arrays; the carve still writes zeros."""
    spec = GridSpec.from_voxel_counts(0.1, (8, 8, 8))
    cloud = tv.PointCloud.create(np.zeros((0, 3), np.float32),
                                 device=card)
    before = ray_setup.launches
    got = tv.ray_setup(spec, torch.eye(4, device=card), cloud)
    assert ray_setup.launches == before
    assert got.hit.shape == (0,) and got.start.shape == (0, 3)
    grids = tv.raycast_pointcloud(spec, torch.eye(4, device=card), cloud)
    assert not bool(grids.seen_free.any() | grids.seen_filled.any())


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_cuda_carve_through_the_kernel_setup_matches_plain_walk(card,
                                                                 scene):
    """The card's carve route (the kernels' X_GC and setup, then the tiled
    carve) gives the CPU's plain walk's grids."""
    spec, origin, cloud = _cloud(scene, card)
    got = tv.raycast_pointcloud(spec, origin, cloud)
    spec_cpu, origin_cpu, host = _cloud(scene, "cpu")
    want = tv.raycast_pointcloud(spec_cpu, origin_cpu, host)
    assert torch.equal(got.seen_free.cpu(), want.seen_free)
    assert torch.equal(got.seen_filled.cpu(), want.seen_filled)


def _same_bits_or_nan(got, want):
    """Equal bits, where a NaN equals any NaN (the host's NaN bits are
    numpy's, the card's its own)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got.clone(), want.clone()
    g[nan] = 0
    w[nan] = 0
    bits = torch.int32 if got.dtype == torch.float32 else torch.int64
    assert torch.equal(g.view(bits), w.view(bits))


def _adversarial(rng, dtype, shape):
    """Products whose FMA chain differs from rounded products summed:
    cancelling terms, wide exponents, signed zeros, subnormals, values
    near overflow (float32 only: the float64 host chain cannot round a
    sum beyond float64's range) and non-finite values."""
    tiny = np.finfo(dtype).tiny
    big = np.finfo(dtype).max if dtype == np.float32 else 1e150
    pool = np.array([0.0, -0.0, 1.0, -1.0, 1 + np.finfo(dtype).eps,
                     1 - np.finfo(dtype).eps / 2, tiny, tiny / 8, -tiny / 3,
                     big, -big, big / 2, 3.0, 1 / 3, 1e-20, 1e20, np.inf,
                     -np.inf, np.nan], dtype)
    out = rng.choice(pool, size=shape)
    rnd = rng.normal(size=shape).astype(dtype) * dtype(10.0) ** rng.integers(
        -8, 9, size=shape).astype(dtype)
    return np.where(rng.random(shape) < 0.5, out, rnd).astype(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_product_kernel_matches_host_chain(card, seed):
    """The product kernel against ``_fma_chain`` (float32, 4x4, 4x1, 3x3)
    and ``_fma_chain_f64`` (float64, K <= 3), random rotated isometries
    and adversarial operands, contiguous and transposed: the same bits, a
    NaN where the host has one; one launch a product."""
    rng = np.random.default_rng(seed)
    for dtype, chain, shapes in (
            (np.float32, transforms._fma_chain,
             [(4, 4, 4), (4, 4, 1), (3, 3, 3), (3, 3, 1), (2, 5, 3)]),
            (np.float64, transforms._fma_chain_f64,
             [(4, 3, 4), (3, 3, 1), (3, 2, 3), (4, 1, 4)])):
        for m, k, n in shapes:
            for trial in range(60):
                if trial < 20:
                    a = rng.normal(size=(m, k)).astype(dtype)
                    b = rng.normal(size=(k, n)).astype(dtype)
                else:
                    a = _adversarial(rng, dtype, (m, k))
                    b = _adversarial(rng, dtype, (k, n))
                want = torch.from_numpy(chain(a, b))
                for ta, tb in ((torch.from_numpy(a).to(card),
                                torch.from_numpy(b).to(card)),
                               (torch.from_numpy(a.T.copy()).to(card).T,
                                torch.from_numpy(b.T.copy()).to(card).T)):
                    before = transform_product.launches
                    got = transforms.matmul(ta, tb).cpu()
                    assert transform_product.launches == before + 1
                    _same_bits_or_nan(got, want)
    for _ in range(50):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _rotation(rng.normal(size=4))
        m[:3, 3] = rng.uniform(-2.0, 2.0, 3)
        mc = torch.from_numpy(m).to(card)
        inv = transforms.invert_isometry(mc)
        assert torch.equal(inv.cpu(),
                           transforms.invert_isometry(torch.from_numpy(m)))
        assert torch.equal(transforms.compose(inv, mc).cpu(),
                           torch.from_numpy(transforms._fma_chain(
                               inv.cpu().numpy(), m)))


@pytest.mark.cuda
def test_cuda_f1_grid_frame_transform_matches_cpu(card):
    """Fault F1's rotated grid origin: the card's X_GC is the CPU's bit
    for bit, its two products (the inverse's and the composition) formed
    on the card."""
    spec, origin, cloud = _cloud("F1", card)
    _, origin_cpu, host = _cloud("F1", "cpu")
    before = transform_product.launches
    got = tv._grid_frame_transform(origin, cloud)
    assert transform_product.launches == before + 2
    want = tv._grid_frame_transform(origin_cpu, host)
    assert torch.equal(_bits(got), _bits(want))
