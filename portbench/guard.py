"""What a benchmark process may not have loaded: JAX and the JAX package.

Modules are compared by their whole top-level name (the part before the
first dot), so the port, whose name begins with the JAX package's, is not
taken for it.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax",
                       "voxelized_geometry_tools_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: what this
    process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(m) for m in names} & FORBIDDEN)
