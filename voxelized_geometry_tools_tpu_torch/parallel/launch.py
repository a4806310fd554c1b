"""Host-side launcher of a ``torch.distributed`` world: the counterpart of
the outer call of ``shard_map``.

A :class:`World` spawns ``size`` rank processes (the ``spawn`` start
method: a fresh interpreter each, never a fork of a process that may have
started CUDA), which rendezvous through a ``FileStore`` in a temporary
directory (no TCP port to collide with another world on the same host),
build their :class:`.mesh_utils.Mesh` and wait for work. :meth:`World.run`
sends every rank one call: each rank cuts its shard out of the global
numpy inputs by the in-specs (:func:`.mesh_utils.shard`), makes it a
tensor on its device, calls the target with its mesh first and sends its
outputs back as numpy; the launcher puts them together by the out-specs
(:func:`.mesh_utils.gather`; a replicated output must be the same bits on
every rank). Arrays travel through named shared-memory segments, the
pipes carry only their names.

Targets are module-level functions, passed by reference: a rank imports
the target's module and what it imports, so :meth:`World.run` refuses a
target whose module imports JAX or the JAX package (the ranks run the
port alone). A rank that
raises makes :meth:`World.run` raise with that rank's traceback, and every
wait has a timeout: a rank that hangs (in a collective its failed peers
never join) fails the call instead of blocking its caller. Either way the
world is then shut down, and the next call starts a fresh one.
"""

from __future__ import annotations

import ast
import datetime
import inspect
import multiprocessing
import multiprocessing.connection
import os
import shutil
import tempfile
import sys
import time
import traceback
from multiprocessing import shared_memory
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.device import default_device
from . import mesh_utils

# Top-level modules a rank target's module may not import.
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "voxelized_geometry_tools_tpu")

# Seconds a world may take to start, and a call (and a collective) to end.
START_TIMEOUT = 120.0
CALL_TIMEOUT = 600.0
# Seconds the launcher waits for the other ranks after one has failed.
GRACE = 5.0
# Arrays of this many bytes or more travel through shared memory.
SHARED_MIN_BYTES = 1 << 16


class RankError(RuntimeError):
    """A rank raised (its traceback is in the message), died or timed
    out."""


class _Shared(NamedTuple):
    """A numpy array left in a named shared-memory segment: the pipes
    between the launcher and its ranks carry only this (a pipe moves bulk
    data far slower than memory, 10 MB/s in some sandboxes)."""
    name: str
    shape: tuple
    dtype: str


def _pack(x, segments: list):
    """``x`` with every numpy array of ``SHARED_MIN_BYTES`` or more moved
    into a new shared-memory segment (appended to ``segments``)."""
    if isinstance(x, np.ndarray) and x.nbytes >= SHARED_MIN_BYTES:
        shm = shared_memory.SharedMemory(create=True, size=x.nbytes)
        segments.append(shm)
        view = np.ndarray(x.shape, x.dtype, buffer=shm.buf)
        view[...] = x
        del view
        return _Shared(shm.name, tuple(x.shape), x.dtype.str)
    if isinstance(x, (tuple, list)) and not isinstance(x, _Shared):
        return type(x)(_pack(v, segments) for v in x)
    if isinstance(x, dict):
        return {k: _pack(v, segments) for k, v in x.items()}
    return x


def _unpack(x, cut=None, unlink: bool = False):
    """``x`` with each :class:`_Shared` copied out of its segment
    (``cut``: a function of the array taking the part to copy) and the
    segment closed, and with ``unlink`` removed."""
    if isinstance(x, _Shared):
        shm = shared_memory.SharedMemory(name=x.name)
        try:
            view = np.ndarray(x.shape, np.dtype(x.dtype), buffer=shm.buf)
            out = np.array(view if cut is None else cut(view))
            del view
        finally:
            shm.close()
            if unlink:
                shm.unlink()
        return out
    if isinstance(x, (tuple, list)):
        return type(x)(_unpack(v, None, unlink) for v in x)
    if isinstance(x, dict):
        return {k: _unpack(v, None, unlink) for k, v in x.items()}
    return x


def _release(segments: list) -> None:
    for shm in segments:
        shm.close()
        shm.unlink()
    segments.clear()


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x


def _check_target(target) -> None:
    """Raises ``ValueError`` unless ``target`` is a module-level function
    whose module imports nothing of ``FORBIDDEN_IMPORTS``."""
    module = sys.modules.get(getattr(target, "__module__", None) or "")
    name = getattr(target, "__qualname__", "")
    if module is None or getattr(module, name, None) is not target:
        raise ValueError(f"a rank target must be a module-level function, "
                         f"got {target!r}")
    try:
        tree = ast.parse(inspect.getsource(module))
    except (OSError, TypeError) as e:
        raise ValueError(f"the source of {module.__name__}, the module of "
                         f"rank target {name}, cannot be read") from e
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for imported in names:
            if imported.split(".")[0] in FORBIDDEN_IMPORTS:
                raise ValueError(
                    f"rank target {name}: its module {module.__name__} "
                    f"imports {imported}, and the ranks run the port alone")


def _rank_device(device: str, backend: str, rank: int) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("device='cuda' but this process sees no CUDA "
                           "device")
    if backend == "nccl" and rank >= n_cards:
        raise RuntimeError(f"nccl needs one card per rank: rank {rank} of a "
                           f"world on {n_cards} card(s)")
    return torch.device("cuda", rank % n_cards)


def _rank_main(rank, size, store_dir, backend, device, conn):
    """A rank's process: join the group, then serve calls until told to
    stop."""
    import torch.distributed as dist

    try:
        # Ranks run side by side: one PyTorch CPU thread each.
        torch.set_num_threads(1)
        dev = _rank_device(device, backend, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(store_dir, "store"), size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=CALL_TIMEOUT))
        mesh = mesh_utils.make_mesh(("z",), device=dev)
        conn.send(("ready", rank, mesh.describe()))
    except BaseException:
        conn.send(("error", rank, traceback.format_exc()))
        return
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            target, args, in_specs, kwargs = msg
            t0 = time.perf_counter()
            try:
                local = []
                for a, spec in zip(args, in_specs):
                    cut = None if spec is None else (
                        lambda v, spec=spec: mesh_utils.shard(
                            v, spec, size, rank))
                    if isinstance(a, _Shared):
                        a = _unpack(a, cut)  # copies only this rank's part
                    else:
                        a = _unpack(a)
                        if cut is not None:
                            a = cut(a)
                    if isinstance(a, np.ndarray):
                        a = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    local.append(a)
                t1 = time.perf_counter()
                out = target(mesh, *local, **kwargs)
                t2 = time.perf_counter()
                segments = []
                out = _pack(_to_numpy(out), segments)
                # The launcher unlinks the segments once it has copied them.
                for shm in segments:
                    shm.close()
                timing = {"inputs_s": t1 - t0, "target_s": t2 - t1,
                          "outputs_s": time.perf_counter() - t2}
                conn.send(("ok", rank, (out, timing)))
            except BaseException:
                conn.send(("error", rank, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``size`` ranks on ``backend`` (``"gloo"`` or ``"nccl"``) with
    tensors on ``device`` (``"cuda"`` or ``"cpu"``; None means the card
    and raises when there is none: NCCL puts rank ``r`` on card ``r``;
    gloo puts ranks on the cards in turn and stages every collective
    through host memory). Use as a context manager, or call
    :meth:`close`."""

    def __init__(self, size: int, backend: str = "gloo", device=None):
        if backend not in mesh_utils.TRANSPORTS:
            raise ValueError(f"backend must be one of "
                             f"{mesh_utils.TRANSPORTS}, got {backend!r}")
        device = default_device(device).type
        if device not in ("cpu", "cuda"):
            raise ValueError(f"device must be 'cpu' or 'cuda', got "
                             f"{device!r}")
        if backend == "nccl" and device != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        self.size = int(size)
        self.backend, self.device = backend, device
        self.descriptions = []
        # Each rank's seconds in the last call: making its inputs, in the
        # target, converting its outputs; and the call's wall seconds.
        self.last_timings = []
        self._procs, self._conns, self._dir = [], [], None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def running(self) -> bool:
        return bool(self._procs)

    def start(self) -> None:
        """Spawn the ranks and wait (``START_TIMEOUT``) until each has
        joined the group."""
        if self.running:
            return
        ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="vgt_world_")
        try:
            for rank in range(self.size):
                parent, child = ctx.Pipe()
                proc = ctx.Process(
                    target=_rank_main, daemon=True,
                    args=(rank, self.size, self._dir, self.backend,
                          self.device, child))
                proc.start()
                child.close()
                self._procs.append(proc)
                self._conns.append(parent)
            ready = self._collect(START_TIMEOUT, "start")
            self.descriptions = [ready[r] for r in range(self.size)]
        except BaseException:
            self.close()
            raise

    def _collect(self, timeout: float, what: str) -> dict:
        """Each rank's reply, by rank; raises :class:`RankError` (after
        shutting the world down) on an error, a dead rank or the
        timeout."""
        replies, errors = {}, {}
        pending = dict(enumerate(self._conns))
        deadline = time.monotonic() + timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            for conn in multiprocessing.connection.wait(
                    list(pending.values()), timeout=left):
                rank = next(r for r, c in pending.items() if c is conn)
                try:
                    kind, _, payload = conn.recv()
                except EOFError:
                    kind, payload = "error", "the rank's process died"
                del pending[rank]
                (errors if kind == "error" else replies)[rank] = payload
                if kind == "error":
                    # The others may hang in a collective the failed rank
                    # never joins: give them a grace period, no more.
                    deadline = min(deadline, time.monotonic() + GRACE)
        if errors or pending:
            for payload in replies.values():
                _unpack(payload, unlink=True)  # free their segments
            self.close()
            if errors:
                rank = min(errors)
                raise RankError(f"{what}: rank {rank} of {self.size} "
                                f"raised:\n{errors[rank]}")
            raise RankError(f"{what}: ranks {sorted(pending)} of {self.size} "
                            f"gave no reply within {timeout:.0f} s")
        return replies

    def run(self, target, *args, in_specs: Optional[Sequence] = None,
            out_specs=None, **kwargs):
        """``target(mesh, *shards, **kwargs)`` on every rank. ``in_specs``
        gives one layout per argument (None: the argument is passed whole;
        numpy arrays become tensors on the rank's device either way).
        ``out_specs`` None returns the list of each rank's outputs (as
        numpy); a layout, or a tuple (dict) of them for a tuple (dict) of
        outputs, returns them put together (a dict key whose layout is
        None: the list of each rank's)."""
        _check_target(target)
        if in_specs is None:
            in_specs = (None,) * len(args)
        if len(in_specs) != len(args):
            raise ValueError(f"{len(in_specs)} in_specs for {len(args)} "
                             "arguments")
        self.start()
        t0 = time.perf_counter()
        segments = []
        try:
            shared_args = _pack(tuple(args), segments)
            for conn in self._conns:
                conn.send((target, shared_args, tuple(in_specs), kwargs))
            replies = self._collect(CALL_TIMEOUT, target.__name__)
        finally:
            _release(segments)
        self.last_timings = [dict(replies[r][1], reply_s=(
            time.perf_counter() - t0)) for r in range(self.size)]
        outs = [_unpack(replies[r][0], unlink=True)
                for r in range(self.size)]
        if out_specs is None:
            return outs
        if isinstance(out_specs, mesh_utils.PartitionSpec):
            return _assemble(outs, out_specs, target.__name__)
        if isinstance(out_specs, dict):
            return {k: ([o[k] for o in outs] if spec is None else
                        _assemble([o[k] for o in outs], spec,
                                  f"{target.__name__} output {k}"))
                    for k, spec in out_specs.items()}
        return tuple(_assemble([o[i] for o in outs], spec,
                               f"{target.__name__} output {i}")
                     for i, spec in enumerate(out_specs))

    def close(self) -> None:
        """Stop every rank (politely, then by force) and remove the store's
        directory."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        deadline = time.monotonic() + GRACE
        for proc in self._procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
                proc.join(GRACE)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


def _assemble(parts, spec, what):
    """The global output from each rank's part; a replicated output must be
    the same on every rank."""
    if mesh_utils._cut_axis(spec, "z") is None:
        for r, part in enumerate(parts[1:], 1):
            same = (np.array_equal(part, parts[0],
                                   equal_nan=part.dtype.kind in "fc")
                    if isinstance(part, np.ndarray) else part == parts[0])
            if not same:
                raise RankError(f"{what}: a replicated output differs "
                                f"between rank 0 and rank {r}")
        return parts[0]
    return mesh_utils.gather(parts, spec)


def run(size: int, target, *args, backend: str = "gloo", device=None,
        in_specs: Optional[Sequence] = None, out_specs=None, **kwargs):
    """One call in a world of its own: :meth:`World.run` in a fresh
    :class:`World` that is closed afterwards."""
    with World(size, backend, device) as world:
        return world.run(target, *args, in_specs=in_specs,
                         out_specs=out_specs, **kwargs)
