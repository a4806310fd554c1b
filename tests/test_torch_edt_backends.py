"""The port's EDT envelope backends against the JAX package's Pallas kernels,
bit for bit (tolerance 0).

Every envelope kernel computes ``d[q] = min_k (q - k)^2 + f[k]``; each
candidate is rounded once and min is exact, so the port's plain version
(what each wrapper runs on a CPU tensor) must equal each JAX kernel run in
interpret mode, as tests/test_pallas_kernels.py runs them: the full sweep
(``"pallas"``), the windowed walk (``"pallas-windowed"``, on ``f >= 0``
only, its contract) and the best-first kernel with in-kernel minima
(``hoist_cmin=False``). Also: the JAX package's backend names resolve, a
kernel backend refuses a CPU tensor, and the kernel build keys on the
shared header. Inputs come from numpy seeds.
"""

import re
import shutil
import tomllib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu.kernels import edt_pallas
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu_torch.kernels import (
    build, edt_bestfirst, edt_envelope, edt_windowed)
from voxelized_geometry_tools_tpu_torch.ops import edt

KERNEL_BACKENDS = ["cuda-bestfirst", "cuda-envelope", "cuda-windowed",
                   "pallas", "pallas-windowed", "pallas-bestfirst"]


def _field(shape, seed, lo=0.0, hi=300.0, p_inf=0.4, p_inf_line=0.0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(lo, hi, shape).astype(np.float32)
    f[rng.uniform(size=shape) < p_inf] = np.inf
    if len(shape) > 1 and p_inf_line:
        f[..., rng.uniform(size=shape[-2]) < p_inf_line, :] = np.inf
    return f


@pytest.mark.parametrize("shape", [(7, 13, 37), (3, 50), (1, 1, 4), (64,)])
@pytest.mark.parametrize("lo", [0.0, -80.0])
def test_full_sweep_matches_jax_pallas(shape, lo):
    f = _field(shape, 42, lo=lo, p_inf=0.25)
    got = edt_envelope.parabolic_envelope_last(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(edt_pallas.parabolic_envelope_last_pallas(
            jnp.asarray(f), tile_lines=8, interpret=True)))


@pytest.mark.parametrize("lines,n", [(5, 48), (260, 33), (64, 160), (7, 96)])
def test_windowed_matches_jax_pallas(lines, n):
    """f >= 0 with +inf holes and whole +inf lines (the tiles that sweep
    every chunk), at line counts that are not multiples of any tile."""
    f = _field((lines, n), 77 + lines, hi=100.0, p_inf=0.3, p_inf_line=0.2)
    f[0] = np.inf
    got = edt_windowed.parabolic_envelope_last(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(edt_pallas.parabolic_envelope_last_pallas_windowed(
            jnp.asarray(f), tile_lines=128, tile_q=16, interpret=True)))


@pytest.mark.parametrize("fill", [np.inf, 0.0, 1e6])
def test_windowed_degenerate_fields(fill):
    f = np.full((6, 40), fill, np.float32)
    got = edt_windowed.parabolic_envelope_last(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(edt_pallas.parabolic_envelope_last_pallas_windowed(
            jnp.asarray(f), tile_lines=8, tile_q=8, interpret=True)))


@pytest.mark.parametrize("shape", [(7, 13, 37), (3, 50), (1, 1, 4)])
@pytest.mark.parametrize("lo", [0.0, -80.0])
def test_bestfirst_inkernel_minima_matches_jax(shape, lo):
    """``hoist_cmin=False``: the JAX package's ``_bestfirst_kernel``."""
    f = _field(shape, 3, lo=lo)
    got = edt_bestfirst.parabolic_envelope_last(
        torch.from_numpy(f), hoist_cmin=False).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(edt_pallas.parabolic_envelope_last_pallas_bestfirst(
            jnp.asarray(f), tile_lines=8, tile_q=16, interpret=True,
            hoist_cmin=False)))


@pytest.mark.parametrize("seed", [7, 8])
def test_squared_edt_envelope_matches_jax_pallas(seed):
    mask = np.random.default_rng(seed).uniform(size=(24, 17, 33)) < 0.1
    np.testing.assert_array_equal(
        edt_envelope.squared_edt_envelope(torch.from_numpy(mask)).numpy(),
        np.asarray(edt_pallas.squared_edt_pallas(
            jnp.asarray(mask), tile_lines=8, interpret=True)))


@pytest.mark.parametrize("full", [False, True])
def test_squared_edt_envelope_empty_and_full(full):
    mask = np.full((4, 5, 6), full)
    got = edt_envelope.squared_edt_envelope(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(edt_pallas.squared_edt_pallas(
            jnp.asarray(mask), tile_lines=8, interpret=True)))
    assert np.all(got == 0.0) if full else np.all(np.isinf(got))


def test_wrappers_take_plain_version_on_cpu():
    """On a CPU tensor every wrapper runs the plain version and counts no
    launch."""
    f = torch.from_numpy(_field((4, 5, 21), 1))
    ref = edt_bestfirst.parabolic_envelope_last_plain(f)
    assert edt_envelope.parabolic_envelope_last_plain is \
        edt_bestfirst.parabolic_envelope_last_plain
    assert edt_windowed.parabolic_envelope_last_plain is \
        edt_bestfirst.parabolic_envelope_last_plain
    before = (edt_bestfirst.launches, edt_bestfirst.launches_inkernel,
              edt_envelope.launches, edt_windowed.launches)
    for got in (edt_bestfirst.parabolic_envelope_last(f, hoist_cmin=False),
                edt_envelope.parabolic_envelope_last(f),
                edt_windowed.parabolic_envelope_last(f)):
        assert torch.equal(got, ref)
    assert before == (edt_bestfirst.launches, edt_bestfirst.launches_inkernel,
                      edt_envelope.launches, edt_windowed.launches)


@pytest.mark.parametrize("alias", sorted(edt.BACKEND_ALIASES))
def test_jax_backend_names_resolve(alias):
    f = torch.zeros(3, 4)
    assert edt._resolve_edt_backend(alias, f) == edt.BACKEND_ALIASES[alias]
    assert edt._resolve_edt_backend("auto", f) == "plain"


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_kernel_backends_need_a_cuda_tensor(backend):
    mask = torch.from_numpy(np.random.default_rng(2).random((6, 7, 8)) < 0.2)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        edt.squared_edt(mask, backend=backend)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        edt.signed_distance_from_filled_mask(mask, 0.1, backend=backend)


@pytest.mark.parametrize("backend", ["xla", "plain", "auto"])
def test_plain_backends_match_jax_xla(backend):
    mask = np.random.default_rng(4).uniform(size=(24, 17, 33)) < 0.1
    np.testing.assert_array_equal(
        edt.squared_edt(torch.from_numpy(mask), backend=backend).numpy(),
        np.asarray(jedt.squared_edt(jnp.asarray(mask), backend="xla")))


def test_library_path_keys_on_shared_header(tmp_path, monkeypatch):
    """An edited shared header must rebuild every library that may include
    it, and an edited source only its own."""
    src = tmp_path / "csrc"
    shutil.copytree(build.SRC_DIR, src)
    monkeypatch.setattr(build, "SRC_DIR", src)
    names = ("edt_bestfirst", "edt_envelope", "edt_windowed")
    first = {n: build.library_path(n) for n in names}
    assert len(set(first.values())) == len(names)
    header = src / "edt_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    second = {n: build.library_path(n) for n in names}
    assert all(second[n] != first[n] for n in names)
    cu = src / "edt_envelope.cu"
    cu.write_bytes(cu.read_bytes() + b"\n")
    third = {n: build.library_path(n) for n in names}
    assert third["edt_envelope"] != second["edt_envelope"]
    assert third["edt_bestfirst"] == second["edt_bestfirst"]


def test_kernel_sources_include_only_shipped_headers():
    """Every local ``#include "..."`` of a kernel source is a ``csrc/*.cuh``
    file, so the build hash and the package data cover it."""
    pyproject = tomllib.loads(
        (build.SRC_DIR.parents[2] / "pyproject.toml").read_text())
    data = pyproject["tool"]["setuptools"]["package-data"][
        "voxelized_geometry_tools_tpu_torch.kernels"]
    assert "csrc/*.cu" in data and "csrc/*.cuh" in data
    sources = sorted(build.SRC_DIR.glob("*.cu"))
    assert {s.stem for s in sources} == {"carve", "edt_bestfirst",
                                         "edt_combine", "edt_envelope",
                                         "edt_seed", "edt_windowed",
                                         "fusion_filter", "probes",
                                         "ray_setup", "transform_product"}
    for src in sources:
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert inc.endswith(".cuh") and (build.SRC_DIR / inc).is_file()


@pytest.mark.cuda
def test_cuda_envelope_kernels_match_plain_version():
    """On a card: each new kernel against the plain version, bitwise (the
    windowed kernel on f >= 0 only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    kernels = [
        (edt_envelope.parabolic_envelope_last, -80.0),
        (lambda x: edt_bestfirst.parabolic_envelope_last(
            x, hoist_cmin=False), -80.0),
        (edt_windowed.parabolic_envelope_last, 0.0),
    ]
    for fn, lo in kernels:
        for shape in [(7, 13, 37), (3, 50), (1, 1, 4), (64,), (5, 33, 300)]:
            x = torch.from_numpy(_field(shape, 0, lo=lo, p_inf_line=0.2))
            x = x.cuda()
            got = fn(x)
            torch.cuda.synchronize()
            assert torch.equal(
                got, edt_bestfirst.parabolic_envelope_last_plain(x))
