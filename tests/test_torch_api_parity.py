"""The port's public surface against the JAX package's, name by name.

An ``ast`` walk of both packages (no import) lists every public
module-level function and class, every public method of a public class
(plus ``__init__`` and ``create``), its properties, its dataclass or
NamedTuple fields and class constants, every public module-level
assignment (constants and aliases), and the names each package
``__init__.py`` binds. Each JAX name must exist in the port module of the
same dotted path, with the same parameter names, order, kinds and defaults.

A difference that is meant is declared in ``DELIBERATE`` with its reason;
the test fails on a difference that is not declared, and on a declared one
that the walk no longer finds (a stale entry).
"""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = "voxelized_geometry_tools_tpu"
PORT_PKG = "voxelized_geometry_tools_tpu_torch"

# A default written ``jnp.X`` in the JAX package is written ``torch.X`` in
# the port; the JAX package's ``_INF`` is ``float("inf")``.
_DEFAULT_ALIASES = {
    "jnp.float32": "torch.float32",
    "jnp.float64": "torch.float64",
    "_INF": "float('inf')",
}


# -- the walk -----------------------------------------------------------------


def _module_files(root: pathlib.Path):
    """``{dotted module path relative to the package: file}``; a package's
    ``__init__.py`` is its own dotted path ("" for the root)."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = path
    return out


def _default(node):
    if node is None:
        return None
    text = ast.unparse(node)
    return _DEFAULT_ALIASES.get(text, text)


def _params(fn: ast.FunctionDef):
    """``[(kind, name, default)]`` in declaration order."""
    a = fn.args
    out = []
    positional = a.posonlyargs + a.args
    defaults = [None] * (len(positional) - len(a.defaults)) + list(a.defaults)
    for i, (arg, d) in enumerate(zip(positional, defaults)):
        kind = "positional" if i < len(a.posonlyargs) else "arg"
        out.append((kind, arg.arg, _default(d)))
    if a.vararg is not None:
        out.append(("*", a.vararg.arg, None))
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        out.append(("keyword", arg.arg, _default(d)))
    if a.kwarg is not None:
        out.append(("**", a.kwarg.arg, None))
    return out


def _decorator_kind(fn):
    for d in fn.decorator_list:
        name = ast.unparse(d)
        if name in ("staticmethod", "classmethod", "property"):
            return name
        if name.endswith(".setter"):
            return "setter"
    return "method"


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def _assigned_names(stmt):
    if isinstance(stmt, ast.Assign):
        return [t.id for t in stmt.targets if isinstance(t, ast.Name)]
    if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
        return [stmt.target.id]
    return []


def _toplevel(body):
    """Module-level statements, with those of top-level ``if`` / ``try``
    blocks (optional imports) flattened in."""
    for stmt in body:
        if isinstance(stmt, ast.If):
            yield from _toplevel(stmt.body)
            yield from _toplevel(stmt.orelse)
        elif isinstance(stmt, ast.Try):
            yield from _toplevel(stmt.body)
            for h in stmt.handlers:
                yield from _toplevel(h.body)
            yield from _toplevel(stmt.orelse)
        else:
            yield stmt


class _Package:
    """The parsed modules of one package and name resolution across them."""

    def __init__(self, root: pathlib.Path):
        self.files = _module_files(root)
        self.trees = {}

    def tree(self, module):
        if module not in self.trees:
            self.trees[module] = ast.parse(self.files[module].read_text())
        return self.trees[module]

    def bindings(self, module):
        """``{name: node}`` of what the module binds at its top level: a
        ``def`` or ``class`` wins over a later assignment to the same name
        (``X = _register(X, ...)``); an import binds an ``ast.alias``
        tagged with its resolved source."""
        out = {}
        for stmt in _toplevel(self.tree(module).body):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                out[stmt.name] = stmt
            elif isinstance(stmt, (ast.Import, ast.ImportFrom)):
                for alias in stmt.names:
                    name = alias.asname or alias.name.split(".")[0]
                    out.setdefault(name, ("import", stmt, alias))
            else:
                for name in _assigned_names(stmt):
                    if not isinstance(out.get(name),
                                      (ast.FunctionDef, ast.ClassDef)):
                        out[name] = stmt
        return out

    def _import_target(self, module, stmt, alias):
        """(module, name) inside this package that an import refers to, or
        None for an outside import. ``name`` None: a submodule."""
        if not isinstance(stmt, ast.ImportFrom) or stmt.level == 0:
            return None
        base = module.split(".") if module else []
        is_pkg = self.files[module].name == "__init__.py"
        if not is_pkg:
            base = base[:-1]
        if stmt.level > 1:
            base = base[:len(base) - (stmt.level - 1)]
        src = ".".join(base + (stmt.module.split(".") if stmt.module else []))
        sub = ".".join(p for p in (src, alias.name) if p)
        if sub in self.files:
            return sub, None
        if src in self.files:
            return src, alias.name
        return None

    def resolve(self, module, name, _depth=0):
        """(module, node) of the definition ``module.name`` refers to,
        following imports inside the package; None if unbound. A
        submodule resolves to ``(submodule, None)``; an outside import to
        its import statement."""
        node = self.bindings(module).get(name)
        if node is None:
            sub = f"{module}.{name}" if module else name
            return (sub, None) if sub in self.files else None
        if isinstance(node, tuple):
            _, stmt, alias = node
            target = self._import_target(module, stmt, alias)
            if target is None or _depth > 8:
                return module, stmt
            src, src_name = target
            if src_name is None:
                return src, None
            return self.resolve(src, src_name, _depth + 1)
        return module, node

    def class_members(self, module, cls: ast.ClassDef, _depth=0):
        """``{name: node}`` of a class's body, bases first (bases inside
        the package, resolved by name), so an own member overrides."""
        out = {}
        for base in cls.bases:
            if isinstance(base, ast.Name) and _depth < 8:
                found = self.resolve(module, base.id)
                if found and isinstance(found[1], ast.ClassDef):
                    out.update(self.class_members(found[0], found[1],
                                                  _depth + 1))
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                kind = _decorator_kind(stmt)
                key = stmt.name if kind != "setter" else stmt.name + ".setter"
                out[key] = stmt
            elif isinstance(stmt, ast.ClassDef):
                out[stmt.name] = stmt
            else:
                for name in _assigned_names(stmt):
                    out[name] = stmt
        return out


def _field_default(node):
    """A field's default; ``dataclasses.field(default=...)`` (the JAX
    package marks static pytree fields so) reads as its ``default``."""
    if (isinstance(node, ast.Call)
            and ast.unparse(node.func) in ("dataclasses.field", "field")):
        for kw in node.keywords:
            if kw.arg == "default":
                return _default(kw.value)
            if kw.arg == "default_factory":
                return f"{_default(kw.value)}()"
        return None
    return _default(node)


def _fields(cls: ast.ClassDef):
    """Dataclass / NamedTuple fields: the class body's annotated names, in
    order, with their defaults."""
    return [(s.target.id, _field_default(s.value)) for s in cls.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)]


def _literal(node):
    try:
        return ("literal", repr(ast.literal_eval(node.value)))
    except (ValueError, TypeError, SyntaxError, AttributeError):
        return None


def _signature_diff(ref, got):
    """A short, stable account of how ``got``'s parameters differ from
    ``ref``'s, or None when they agree."""
    if ref == got:
        return None
    ref_names = [p[1] for p in ref]
    got_names = [p[1] for p in got]
    parts = []
    for p in ref:
        if p[1] not in got_names:
            parts.append(f"-{p[1]}")
    for p in got:
        if p[1] not in ref_names:
            parts.append(f"+{p[1]}" + (f"={p[2]}" if p[2] is not None
                                       else ""))
    for p in ref:
        for q in got:
            if p[1] == q[1] and p != q:
                if p[0] != q[0]:
                    parts.append(f"~{p[1]}: {p[0]} -> {q[0]}")
                if p[2] != q[2]:
                    parts.append(f"~{p[1]}={p[2]} -> {q[2]}")
    common_ref = [n for n in ref_names if n in got_names]
    common_got = [n for n in got_names if n in ref_names]
    if common_ref != common_got:
        parts.append("order")
    return " ".join(parts) if parts else "changed"


def _compare_function(dotted, ref, got, diffs):
    if not isinstance(got, (ast.FunctionDef, ast.AsyncFunctionDef)):
        diffs.add(("kind", dotted, "not a function"))
        return
    rk, gk = _decorator_kind(ref), _decorator_kind(got)
    if rk != gk:
        diffs.add(("kind", dotted, f"{rk} -> {gk}"))
    d = _signature_diff(_params(ref), _params(got))
    if d is not None:
        diffs.add(("signature", dotted, d))


def _compare_class(jax, port, dotted, jmod, jcls, pmod, pcls, diffs):
    if not isinstance(pcls, ast.ClassDef):
        diffs.add(("kind", dotted, "not a class"))
        return
    rf, gf = _fields(jcls), _fields(pcls)
    if rf and rf != gf:
        diffs.add(("fields", dotted, _signature_diff(
            [("field",) + f for f in rf], [("field",) + f for f in gf])))
    ref_members = jax.class_members(jmod, jcls)
    got_members = port.class_members(pmod, pcls)
    for name, node in ref_members.items():
        if not (_is_public(name) or name in ("__init__",)):
            continue
        full = f"{dotted}.{name}"
        other = got_members.get(name)
        if other is None:
            diffs.add(("missing", full, ""))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _compare_function(full, node, other, diffs)
        elif isinstance(node, ast.ClassDef):
            _compare_class(jax, port, full, jmod, node, pmod, other, diffs)
        elif isinstance(node, ast.Assign):
            lit = _literal(node)
            if lit is not None and lit != _literal(other):
                diffs.add(("value", full, ""))


def compare_packages(jax_root: pathlib.Path, port_root: pathlib.Path):
    """Every difference of the port's public surface from the JAX
    package's, as a set of ``(what, dotted name, detail)``."""
    jax, port = _Package(jax_root), _Package(port_root)
    diffs = set()
    for module in jax.files:
        is_init = jax.files[module].name == "__init__.py"
        if module not in port.files:
            # Each public name of a module the port does not have.
            for name, node in jax.bindings(module).items():
                if _is_public(name) and (is_init
                                         or not isinstance(node, tuple)):
                    diffs.add(("missing", f"{module}.{name}", ""))
            continue
        for name, node in jax.bindings(module).items():
            if not _is_public(name) and name not in ("__all__",
                                                     "__version__"):
                continue
            dotted = f"{module}.{name}" if module else name
            if isinstance(node, tuple) and not is_init:
                continue  # a module's own imports are not its surface
            if isinstance(node, tuple):
                # A package re-export: the port's package binds it too.
                if name not in port.bindings(module):
                    diffs.add(("missing", dotted, ""))
                continue
            found = port.resolve(module, name)
            if found is None:
                diffs.add(("missing", dotted, ""))
                continue
            pmod, other = found
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _compare_function(dotted, node, other, diffs)
            elif isinstance(node, ast.ClassDef):
                _compare_class(jax, port, dotted, module, node, pmod, other,
                               diffs)
            elif isinstance(node, ast.Assign) and name.isupper():
                lit = _literal(node)
                if lit is not None and lit != _literal(other):
                    diffs.add(("value", dotted, ""))
    return diffs


def unlisted(diffs, deliberate):
    """The differences ``deliberate`` does not declare."""
    listed = {entry[:3] for entry in deliberate}
    return sorted(d for d in diffs if d not in listed)


def stale(diffs, deliberate):
    """The declared differences the walk does not find."""
    return sorted(entry[:3] for entry in deliberate
                  if entry[:3] not in diffs)


# -- what differs on purpose --------------------------------------------------

_DEVICE = ("device=None: the port's entry points that make tensors from "
           "host data or from nothing take the device, and None means the "
           "CUDA card (core/device.py)")
_ARRAY = ("the JAX module's Array alias (jnp.ndarray) is the port's "
          "Tensor (torch.Tensor)")
_EDT_PALLAS = ("the Pallas envelope passes are the port's hand-written "
               "CUDA kernels, one module each: ")

# (what, dotted name, detail, reason): every difference the walk finds.
DELIBERATE = [
    *[("signature", name, "+device=None", _DEVICE) for name in (
        "core.maps.OccupancyMap.create",
        "core.maps.OccupancyComponentMap.create",
        "core.maps.TaggedObjectOccupancyMap.create",
        "core.maps.TaggedObjectOccupancyComponentMap.create",
        "core.maps.SignedDistanceField.create",
        "core.transforms.identity_isometry",
        "core.transforms.isometry_from_axis_angle",
        "core.transforms.isometry_from_quaternion_translation",
        "core.transforms.isometry_from_rotation_translation",
        "core.transforms.isometry_from_translation",
        "core.serialization.deserialize",
        "core.serialization.from_file_bytes",
        "core.serialization.load_from_file",
        "io.messages.load_from_message_representation",
        "io.pointcloud2.pointcloud_from_pointcloud2",
        "models.online_mapper.OnlineMapper.__init__",
        "ops.backends.AcceleratorPointCloudVoxelizer.__init__",
        "ops.backends.make_pointcloud_voxelizer",
        "ops.mesh.rasterize_mesh_into_occupancy_map",
        "ops.mesh.rasterize_mesh_into_occupancy_component_map",
        "ops.render.PinholeCamera.create",
        "ops.voxelize.PointCloud.create",
        "ops.voxelize.raycast_single_point",
        "core.dsh.DynamicSpatialHashedOccupancyMap.pack",
        "core.dsh.DynamicSpatialHashedOccupancyMap.to_occupancy_map",
        "utils.profiling.PhaseTimer.__init__",
    )],
    ("signature", "models.fusion_pipeline.reconstruct",
     "+voxelizer=None +runtime_log_fn=None",
     "the caller may pass its own voxelizer (the ACCELERATOR one keeps its "
     "carve buffers between calls) and a log function for its runtimes"),
    ("signature", "ops.voxelize.raycast_pointcloud",
     "+backend='auto' +_out=None",
     "backend picks the carve's route (the hand-written tiled kernel on "
     "the card, 'plain' the PyTorch walk); _out lets the voxelizer reuse "
     "its counter grids"),
    ("signature", "parallel.sharded.sharded_render_depth_grid_sharded",
     "+stats=None",
     "stats collects the march's collective counts and times"),
    ("signature", "parallel.mesh_utils.make_mesh",
     "-devices +device=None +group=None",
     "a torch.distributed mesh is this rank's process group and its one "
     "device, not a list of JAX devices"),
    ("missing", "parallel.sharded.shard_map", "",
     "jax.shard_map, which the JAX module imports; each port function "
     "runs SPMD in its rank's process instead"),
    ("missing", "kernels.edt_pallas", "",
     _EDT_PALLAS + "kernels.edt_bestfirst, edt_envelope, edt_windowed"),
    ("missing", "kernels.edt_pallas.parabolic_envelope_last_pallas", "",
     _EDT_PALLAS + "kernels.edt_envelope.parabolic_envelope_last"),
    ("missing", "kernels.edt_pallas.squared_edt_pallas", "",
     _EDT_PALLAS + "kernels.edt_envelope.squared_edt_envelope"),
    ("missing", "kernels.edt_pallas.parabolic_envelope_last_pallas_windowed",
     "", _EDT_PALLAS + "kernels.edt_windowed.parabolic_envelope_last"),
    ("missing", "kernels.edt_pallas.parabolic_envelope_last_pallas_bestfirst",
     "", _EDT_PALLAS + "kernels.edt_bestfirst.parabolic_envelope_last"),
    *[("missing", f"{module}.Array", "", _ARRAY) for module in (
        "core.dsh", "core.grid", "core.maps", "core.transforms",
        "kernels.edt_pallas", "models.fusion_pipeline",
        "models.online_mapper", "ops.edt", "ops.isosurface", "ops.map_ops",
        "ops.mesh", "ops.render", "ops.sdf_query", "ops.topology",
        "ops.voxelize", "parallel.sharded")],
]


# -- the tests ----------------------------------------------------------------


def test_public_surface_matches_jax():
    diffs = compare_packages(REPO / JAX_PKG, REPO / PORT_PKG)
    assert unlisted(diffs, DELIBERATE) == []
    assert stale(diffs, DELIBERATE) == []


def test_deliberate_entries_have_reasons():
    keys = [entry[:3] for entry in DELIBERATE]
    assert len(keys) == len(set(keys))
    for entry in DELIBERATE:
        assert len(entry) == 4 and entry[3].strip(), entry


def _init_names(pkg, sub=""):
    package = _Package(REPO / pkg)
    return {n for n in package.bindings(sub) if _is_public(n)}


def _literal_all(pkg):
    tree = _Package(REPO / pkg).tree("")
    for stmt in tree.body:
        if "__all__" in _assigned_names(stmt):
            return set(ast.literal_eval(stmt.value))
    raise AssertionError(f"{pkg} has no __all__")


@pytest.mark.parametrize("sub", ["", "core"])
def test_package_exports_match(sub):
    """The root's and ``core``'s exports are the same sets of names."""
    assert _init_names(PORT_PKG, sub) == _init_names(JAX_PKG, sub)
    if sub == "":
        assert _literal_all(PORT_PKG) == _literal_all(JAX_PKG)


def test_version_matches():
    import voxelized_geometry_tools_tpu as jvgt
    import voxelized_geometry_tools_tpu_torch as tvgt
    from voxelized_geometry_tools_tpu_torch import __version__
    assert __version__ == jvgt.__version__ == "0.5.0"
    assert "__version__" in tvgt.__all__


# -- the walker's own cases ---------------------------------------------------

_REF_SOURCE = """
def kept(a, b=1, *, c=None):
    pass

def gone(x):
    pass

def defaulted(x, scale=2.0):
    pass

def made(spec, value=0.0):
    pass
"""

_PORT_SOURCES = {
    "missing function": ("gone", "ref"),
    "changed default": ("defaulted", "def defaulted(x, scale=3.0):\n"
                        "    pass\n"),
    "added device=None": ("made", "def made(spec, value=0.0, device=None):\n"
                          "    pass\n"),
}


def _write_package(root: pathlib.Path, source: str):
    root.mkdir()
    (root / "__init__.py").write_text("")
    (root / "mod.py").write_text(source)


@pytest.mark.parametrize("case", sorted(_PORT_SOURCES))
def test_walker_reports(case, tmp_path):
    """On two tiny packages: a missing function, a changed default and an
    added trailing ``device=None`` are each reported, and a declared
    difference is excused (and turns stale once the difference goes)."""
    name, change = _PORT_SOURCES[case]
    ref_src = _REF_SOURCE
    if change == "ref":
        port_src = _REF_SOURCE.replace("def gone(x):\n    pass\n", "")
    else:
        start = ref_src.index(f"def {name}(")
        end = ref_src.index("pass\n", start) + len("pass\n")
        port_src = ref_src[:start] + change + ref_src[end:]
    _write_package(tmp_path / "ref", ref_src)
    _write_package(tmp_path / "port", port_src)
    same = compare_packages(tmp_path / "ref", tmp_path / "ref")
    assert same == set()
    diffs = compare_packages(tmp_path / "ref", tmp_path / "port")
    expected = {
        "missing function": ("missing", "mod.gone", ""),
        "changed default": ("signature", "mod.defaulted",
                            "~scale=2.0 -> 3.0"),
        "added device=None": ("signature", "mod.made", "+device=None"),
    }[case]
    assert diffs == {expected}
    assert unlisted(diffs, []) == [expected]
    declared = [expected + ("a reason",)]
    assert unlisted(diffs, declared) == []
    assert stale(diffs, declared) == []
    assert stale(same, declared) == [expected]
    nothing = ("missing", "mod.nothing", "")
    assert stale(diffs, declared + [nothing + ("a reason",)]) == [nothing]
