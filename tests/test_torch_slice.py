"""The ported main path as a whole against the JAX package: occupancy ->
signed EDT -> corner table -> depth render, and the port's ``entry()``
against ``__graft_entry__.entry()`` (forward depth and both gradients).
Also: the port imports no JAX, and (on a CUDA card only) the CUDA kernel
equals its plain version."""

import ast
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__
from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import render as jr
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu_torch import GridSpec, OccupancyMap, interop
from voxelized_geometry_tools_tpu_torch import entry as tentry
from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst
from voxelized_geometry_tools_tpu_torch.ops import edt
from voxelized_geometry_tools_tpu_torch.ops import render as tr
from voxelized_geometry_tools_tpu_torch.ops import sdf_query as tq

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "voxelized_geometry_tools_tpu_torch"

# Same contracts as tests/test_torch_render.py, for the same reasons: depth
# within 1e-4 m on common hits, hit flips only on tangent grazers (at most
# 0.5% of pixels), gradients rtol 1e-3 / atol 1e-4.
DEPTH_ATOL = 1e-4
MAX_HIT_FLIPS = 0.005
GRAZER_BAND = 0.08
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


def _check_render(ref, got, resolution):
    ref_hit, got_hit = np.asarray(ref.hit), got.hit.cpu().numpy()
    flips = ref_hit != got_hit
    assert flips.mean() <= MAX_HIT_FLIPS
    hitter = np.where(ref_hit, np.asarray(ref.distance),
                      got.distance.cpu().numpy())
    graze = np.abs(hitter - 0.25 * resolution) <= GRAZER_BAND * resolution
    assert not (flips & ~graze).any()
    m = ref_hit & got_hit
    assert m.any()
    np.testing.assert_allclose(got.depth.cpu().numpy()[m],
                               np.asarray(ref.depth)[m], rtol=0,
                               atol=DEPTH_ATOL)


def _clutter_occupancy(shape, seed):
    """A floor slab, a few spheres and a band of unknown cells."""
    rng = np.random.default_rng(seed)
    xs, ys, zs = np.meshgrid(*[np.arange(c) for c in shape], indexing="ij",
                             sparse=True)
    occ = np.zeros(shape, np.float32)
    occ[:, :, :3] = 1.0
    for _ in range(4):
        c = rng.uniform(0.2, 0.8, 3) * np.asarray(shape)
        r = rng.uniform(3.0, 7.0)
        occ[((xs - c[0]) ** 2 + (ys - c[1]) ** 2 + (zs - c[2]) ** 2)
            <= r * r] = 1.0
    occ[rng.random(shape) < 0.002] = 0.5
    return occ


@pytest.mark.parametrize("early_exit", [False, True])
def test_slice_matches_jax(early_exit):
    """occupancy -> extract_sdf_from_occupancy -> build_corner_table ->
    render_depth, through both packages on the same occupancy."""
    shape, res = (40, 36, 32), 0.05
    occ = _clutter_occupancy(shape, 12)
    js = jedt.extract_sdf_from_occupancy(
        occ, JGridSpec.from_voxel_counts(res, shape), None)
    spec = GridSpec.from_voxel_counts(res, shape)
    occ_map = OccupancyMap.create(spec, None, "world", device="cpu")
    occ_map = occ_map.replace(occupancy=torch.from_numpy(occ))
    ts = edt.extract_sdf_from_occupancy(occ_map.occupancy, occ_map.spec,
                                        occ_map.origin_transform)
    np.testing.assert_array_equal(ts.distances.numpy(),
                                  np.asarray(js.distances))
    jt, tt = jq.build_corner_table(js), tq.build_corner_table(ts)
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))

    sizes = np.asarray(js.spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 + np.array([0.0, 0.0, 1.4 * sizes[2]])
    pose[:3, :3] = np.diag([1.0, -1.0, -1.0])  # looking down at the floor
    jc = jr.PinholeCamera.create(pose, 64, 48, focal=50.0)
    tc = interop.camera_from_numpy(np.asarray(jc.pose), jc.fx, jc.fy, jc.cx,
                                   jc.cy, 64, 48, device="cpu")
    kw = dict(num_steps=64, early_exit=early_exit, tail_chunks=1)
    ref = jr.render_depth(js, jc, corner_table=jt, **kw)
    got = tr.render_depth(ts, tc, corner_table=tt, **kw)
    _check_render(ref, got, res)
    assert 0.3 < got.hit.numpy().mean()


@pytest.fixture(scope="module")
def entries():
    return __graft_entry__.entry(), tentry.entry(device="cpu")


def test_entry_forward_matches_jax(entries):
    (jfn, (jd, jp)), (tfn, (td, tp)) = entries
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    ref = np.asarray(jax.jit(jfn)(jd, jp))
    got = tfn(td, tp).numpy()
    assert got.shape == ref.shape == (64, 64)
    hit = ref < 100.0
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(got < 100.0, hit)
    np.testing.assert_allclose(got[hit], ref[hit], rtol=0, atol=DEPTH_ATOL)


def test_entry_gradients_match_jax(entries):
    (jfn, (jd, jp)), (tfn, (td, tp)) = entries
    jg_d, jg_p = jax.jit(jax.grad(lambda d, p: jnp.mean(jfn(d, p)),
                                  argnums=(0, 1)))(jd, jp)
    d = td.clone().requires_grad_(True)
    p = tp.clone().requires_grad_(True)
    torch.mean(tfn(d, p)).backward()
    assert float(torch.abs(d.grad).sum()) > 0.0
    assert float(torch.abs(p.grad).sum()) > 0.0
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jg_d),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg_p),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax():
    """Static: no file of the port (nor chip_smoke.py) imports jax or the
    JAX package. (sys.modules cannot tell: jax may be preloaded.)"""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for module in ("native/loader.py", "ops/voxelize.py", "ops/backends.py",
                   "models/fusion_pipeline.py", "kernels/carve.py",
                   "interop.py", "ops/mesh.py", "ops/isosurface.py",
                   "ops/topology.py", "ops/map_ops.py",
                   "core/conversions.py", "core/serialization.py",
                   "core/dsh.py", "io/messages.py", "io/pointcloud2.py",
                   "io/viz.py", "utils/profiling.py",
                   "parallel/mesh_utils.py", "parallel/collectives.py",
                   "parallel/launch.py", "parallel/sharded.py",
                   "parallel/targets.py", "entry.py",
                   "examples/_common.py", "examples/voxel_raycasting.py",
                   "examples/differentiable_fitting.py",
                   "examples/tutorial.py", "examples/estimate_distance.py",
                   "examples/pointcloud_voxelization.py",
                   "examples/online_mapping.py",
                   "examples/isosurface_export.py",
                   "examples/spatial_segments.py",
                   "examples/sharded_pipeline.py"):
        assert PORT / module in files
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib",
                                       "voxelized_geometry_tools_tpu"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The CUDA best-first kernel against its plain version, bitwise, on
    ragged shapes, degenerate fields, negative values and +inf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    cases = []
    for shape in [(7, 13, 37), (3, 50), (1, 1, 4), (64,), (5, 33, 300)]:
        f = rng.uniform(-80.0, 300.0, shape).astype(np.float32)
        f[rng.uniform(size=shape) < 0.4] = np.inf
        cases.append(f)
    for fill in (np.inf, 0.0, 1e6):
        cases.append(np.full((6, 40), fill, np.float32))
    for f in cases:
        x = torch.from_numpy(f).cuda()
        before = edt_bestfirst.launches_staged
        got = edt_bestfirst.parabolic_envelope_last(x)
        torch.cuda.synchronize()
        assert edt_bestfirst.launches_staged == before + 1
        ref = edt_bestfirst.parabolic_envelope_last_plain(x)
        assert torch.equal(got, ref)
