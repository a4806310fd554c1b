"""The sharded paths on ``torch.distributed``: the port of the JAX
package's ``parallel/`` (``mesh_utils``, ``sharded``), the collectives
its ``shard_map`` functions use, the launcher of a world of rank
processes, and the rank targets."""

from . import mesh_utils, sharded  # noqa: F401
