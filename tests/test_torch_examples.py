"""The port's nine examples (``voxelized_geometry_tools_tpu_torch/examples``)
on the CPU at small arguments, each against the JAX package's example
(``examples/<name>.py``) run in-process with the same arguments: the
printed counts, booleans and hit pixels exactly, the printed floats to
within their printed precision (the module behind them agrees to far
less), timings not at all.

The JAX online-mapping example runs op by op (``jax.disable_jit()``):
its mapper's compiled carve contracts multiply-adds, which moves the
endpoints of the analytic box's rays (tests/test_torch_online_mapper.py).
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import pytest

REPO = Path(__file__).resolve().parent.parent
NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _jax_example(name, args, op_by_op=False):
    """The lines the JAX package's example prints with ``args``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    saved = sys.argv
    sys.argv = [name] + list(args)
    try:
        with contextlib.redirect_stdout(buf), (
                jax.disable_jit() if op_by_op else contextlib.nullcontext()):
            module.main()
    finally:
        sys.argv = saved
    return buf.getvalue().splitlines()


def _port_example(name, args):
    module = importlib.import_module(
        f"voxelized_geometry_tools_tpu_torch.examples.{name}")
    return module.main(["--device", "cpu"] + list(args))


def _lines(lines, prefix):
    found = [line for line in lines if line.strip().startswith(prefix)]
    assert found, f"no line starting {prefix!r} in {lines}"
    return found


def _same(port, ref, atol, skip=(), text=True):
    """Lines equal but for their numbers; integers equal, decimals within
    ``atol``; number ``i`` in ``skip`` not compared."""
    assert len(port) == len(ref), (port, ref)
    for p, r in zip(port, ref):
        if text:
            assert NUM.sub("#", p) == NUM.sub("#", r), (p, r)
        pn, rn = NUM.findall(p), NUM.findall(r)
        assert len(pn) == len(rn), (p, r)
        for i, (a, b) in enumerate(zip(pn, rn)):
            if i in skip:
                continue
            if "." in a or "." in b or "e" in a or "e" in b:
                assert abs(float(a) - float(b)) <= atol, (p, r)
            else:
                assert a == b, (p, r)


def _compare(name, args, keys, op_by_op=False, jax_args=None):
    port = _port_example(name, args)
    ref = _jax_example(name, args if jax_args is None else jax_args,
                       op_by_op)
    for prefix, atol, skip in keys:
        _same(_lines(port, prefix), _lines(ref, prefix), atol, skip)
    return port, ref


def test_voxel_raycasting():
    _compare("voxel_raycasting", ["--iterations", "3"],
             [("3 raycast cycles", 0, ()), ("Last-ray display", 0, ()),
              ("...done", 0, ())])


def test_differentiable_fitting():
    _compare("differentiable_fitting", ["--iters", "3"],
             [("Rasterized mesh", 0, ()), ("SDF extrema", 1e-4, ()),
              ("Target render", 0, ()), ("Loss", 1e-5, ()),
              ("Max pose-entry error", 1e-3, ()), ("Pose fit", 0, ())])


def test_tutorial():
    keys = [("Index query result - stored", 0, ()),
            ("Location query result - stored", 0, ()),
            ("There are", 0, ()), ("Occupancy display", 0, ()),
            ("Maximum distance", 2e-6, ()), ("Minimum distance", 2e-6, ()),
            ("Index query result - estimated", 2e-6, ()),
            ("Location query result - estimated", 2e-6, ()),
            ("Index gradient", 1e-6, ()), ("Location gradient", 1e-6, ())]
    _compare("tutorial", [], keys)


def test_estimate_distance():
    _compare("estimate_distance", [],
             [("SDF display", 0, ()), ("Estimated distance", 2e-4, ()),
              ("Subsampled queries", 0, ()), ("Fine gradients", 2e-4, ()),
              ("Query at grid", 2e-4, ())])


def test_pointcloud_voxelization():
    """Every backend passes the oracle and displays the same cells; the
    backends' names differ between the packages."""
    port, ref = _compare("pointcloud_voxelization", [],
                         [("display:", 0, ())])
    assert len([line for line in port if line.endswith("PASSED")]) == 2
    assert "Selected backend BackendOption.NATIVE_CPU" in port


def test_online_mapping():
    _compare("online_mapping", ["--frames", "1"],
             [("frame 0", 0, ()),
              ("scan-fold replay", 0, ()), ("SDF at box center", 1e-3, ()),
              ("novel top-down view", 0, ()), ("OK", 0, ())],
             op_by_op=True)


def test_isosurface_export(tmp_path):
    port = _port_example("isosurface_export", [str(tmp_path / "port.obj")])
    ref = _jax_example("isosurface_export", [str(tmp_path / "jax.obj")])
    for prefix, atol in [("extracted", 0), ("TRIANGLE_LIST", 0),
                         ("round trip", 1e-3)]:
        _same(_lines(port, prefix), _lines(ref, prefix), atol)
    # The path differs; the welded counts do not.
    _same(_lines(port, "wrote"), _lines(ref, "wrote"), 0, text=False)
    assert (tmp_path / "port.obj").read_text() == \
        (tmp_path / "jax.obj").read_text()


def test_spatial_segments():
    port, ref = _compare(
        "spatial_segments", [],
        [("Environment display", 0, ()),
         ("Spatial segments", 1, (1,)),  # the count; not the time
         ("segment display", 0, ())])
    per_segment = [line for line in port if line.strip().startswith("object")]
    assert per_segment == [line for line in ref
                           if line.strip().startswith("object")]


def test_sharded_pipeline():
    """Two gloo ranks against the JAX example's eight virtual devices:
    the same carve, EDT and render, whatever the shard count."""
    port = _port_example("sharded_pipeline", ["--world-size", "2",
                                              "--backend", "gloo"])
    ref = _jax_example("sharded_pipeline", [])
    _same(_lines(port, "carved over"), _lines(ref, "carved over"), 0,
          skip=(0,))
    _same(_lines(port, "rendered"), _lines(ref, "rendered"), 0, skip=(2,))
    assert _lines(port, "sharded EDT")[0].endswith("True")
    assert _lines(ref, "sharded EDT")[0].endswith("True")
    assert "render: True" in _lines(port, "grid-sharded render")[0]
    assert _lines(ref, "grid-sharded render")[0].endswith("True")
    assert port[-1] == "...done"


@pytest.mark.parametrize("name", [
    "voxel_raycasting", "differentiable_fitting", "tutorial",
    "estimate_distance", "pointcloud_voxelization", "online_mapping",
    "isosurface_export", "spatial_segments", "sharded_pipeline"])
def test_example_defaults_to_the_card(name):
    """Without ``--device`` an example runs on the card, and raises where
    there is none (it never falls back to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    module = importlib.import_module(
        f"voxelized_geometry_tools_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
