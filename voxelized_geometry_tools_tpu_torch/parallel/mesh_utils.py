"""The device mesh of a ``torch.distributed`` world, and layouts.

Port of ``voxelized_geometry_tools_tpu/parallel/mesh_utils.py``. The JAX
package runs each sharded function as one ``shard_map`` over a
``jax.sharding.Mesh``; the port runs it SPMD, one process per rank of a
``torch.distributed`` process group, and a :class:`Mesh` is that group
seen from one rank: its axis name, size, rank, device and transport.

A layout is a :class:`PartitionSpec`, as in JAX: ``P(None, None, "z")``
cuts the last axis into Z slabs, ``P("z")`` the leading axis (rays, rows,
planes), ``P()`` replicates. :func:`shard` cuts a rank's part out of a
global array and :func:`gather` puts parts back together, both on the host
or within one process; :class:`NamedSharding` (from :func:`grid_sharding`,
:func:`ray_sharding`, :func:`replicated`) cuts and all-gathers within a
running world.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# The transports (collectives.py): NCCL between ranks that each have a
# card of their own; gloo between CPU ranks, or between ranks that share
# one card (NCCL refuses two ranks on one device), where each collective
# stages the tensor through host memory.
TRANSPORTS = ("nccl", "gloo")


class PartitionSpec(tuple):
    """A layout: entry ``a`` names the mesh axis that cuts array axis ``a``
    (None: not cut). Axes past the end are not cut."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass
class CollectiveStats:
    """Calls, bytes sent by this rank and wall milliseconds of each
    collective (staging included), and the bytes staged through host
    memory."""
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    staged_bytes: int = 0

    def add(self, name: str, n_bytes: int, ms: float, staged: int) -> None:
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0) + int(n_bytes)
        self.ms[name] = self.ms.get(name, 0.0) + float(ms)
        self.staged_bytes += int(staged)

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self.ms.clear()
        self.staged_bytes = 0

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "ms": dict(self.ms), "staged_bytes": self.staged_bytes}


@dataclasses.dataclass
class Mesh:
    """One rank's view of a one-axis mesh over a process group.

    ``transport`` is ``"nccl"`` or ``"gloo"``. ``group`` None means the
    default group; a mesh whose group was never initialized can still run
    every check a sharded function makes before its first collective.
    ``stats`` None leaves the collectives untimed; a
    :class:`CollectiveStats` receives each call's bytes and wall time,
    which synchronizes the device before and after every collective."""
    axis_name: str
    size: int
    rank: int
    device: torch.device
    transport: str = "gloo"
    group: Optional[object] = None
    stats: Optional[CollectiveStats] = None

    def __post_init__(self):
        if self.transport not in TRANSPORTS:
            raise ValueError(f"transport must be one of {TRANSPORTS}, got "
                             f"{self.transport!r}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")
        self.device = torch.device(self.device)
        if self.transport == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl transport needs a CUDA device")

    @property
    def host_staged(self) -> bool:
        """Whether each collective copies its tensor to host memory and
        back: gloo with a CUDA device."""
        return self.transport == "gloo" and self.device.type == "cuda"

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis_name: size}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: self.size}

    def describe(self) -> str:
        staging = (", each collective staged through host memory"
                   if self.host_staged else "")
        return (f"mesh axis {self.axis_name!r}: rank {self.rank} of "
                f"{self.size} on {self.device}, {self.transport}{staging}")


def make_mesh(axis_names: Sequence[str] = ("z",),
              axis_sizes: Optional[Sequence[int]] = None,
              device=None, group=None) -> Mesh:
    """This rank's :class:`Mesh` over the initialized process group
    (``group`` None: the default one). One axis only: every sharded
    function of the port cuts along one. ``device`` None means the card
    this rank uses, ``cuda:<rank % cards>``, whatever the backend; it
    raises when there is no card, and CPU ranks pass ``device="cpu"``."""
    import torch.distributed as dist

    from ..core.device import default_device

    if len(axis_names) != 1:
        raise ValueError("the port's meshes have one axis")
    size = dist.get_world_size(group)
    if axis_sizes is not None and tuple(axis_sizes) != (size,):
        raise ValueError(f"axis_sizes {tuple(axis_sizes)} != the group's "
                         f"size ({size},)")
    transport = dist.get_backend(group)
    if transport not in TRANSPORTS:
        raise ValueError(f"unsupported process-group backend {transport!r}")
    rank = dist.get_rank(group)
    if device is None:
        default_device()  # raises without a card
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(axis_names[0], size, rank, torch.device(device), transport,
                group)


def _cut_axis(spec: Sequence, axis_name: str) -> Optional[int]:
    """The array axis that ``axis_name`` cuts in ``spec`` (None: none)."""
    cut = [a for a, name in enumerate(spec) if name == axis_name]
    if len(cut) > 1:
        raise ValueError(f"{spec!r} cuts two axes along {axis_name!r}")
    for name in spec:
        if name is not None and name != axis_name:
            raise ValueError(f"{spec!r} names an axis other than "
                             f"{axis_name!r}")
    return cut[0] if cut else None


def shard(x, spec: Sequence, size: int, rank: int, axis_name: str = "z"):
    """Rank ``rank``'s part of the global array ``x`` (numpy or torch) in
    layout ``spec`` over ``size`` ranks: a view. Raises ``ValueError`` when
    ``size`` does not divide the cut axis."""
    a = _cut_axis(spec, axis_name)
    if a is None:
        return x
    n = x.shape[a]
    if n % size:
        raise ValueError(f"the mesh axis size {size} must divide axis {a} "
                         f"({n})")
    w = n // size
    index = [slice(None)] * x.ndim
    index[a] = slice(rank * w, (rank + 1) * w)
    return x[tuple(index)]


def gather(parts: List, spec: Sequence, axis_name: str = "z"):
    """The global array from every rank's part, in rank order (numpy or
    torch); a replicated layout takes rank 0's."""
    a = _cut_axis(spec, axis_name)
    if a is None:
        return parts[0]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(list(parts), dim=a)
    return np.concatenate(list(parts), axis=a)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on a running mesh: :meth:`shard` cuts this rank's part of a
    global tensor (no communication); :meth:`gather` all-gathers the parts
    into the global tensor on every rank."""
    mesh: Mesh
    spec: PartitionSpec

    def shard(self, x):
        return shard(x, self.spec, self.mesh.size, self.mesh.rank,
                     self.mesh.axis_name)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        from . import collectives
        a = _cut_axis(self.spec, self.mesh.axis_name)
        if a is None:
            return local
        return collectives.all_gather(local, self.mesh, axis=a)


def grid_sharding(mesh: Mesh, axis_name: str = "z") -> NamedSharding:
    """Z-slab layout for ``[nx, ny, nz]`` grids: the last axis is cut."""
    return NamedSharding(mesh, P(None, None, axis_name))


def ray_sharding(mesh: Mesh, axis_name: str = "z") -> NamedSharding:
    """Leading-axis layout for ray/point batches ``[N, ...]``."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
