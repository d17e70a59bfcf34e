"""Data parallelism over a ``torch.distributed`` group (the JAX package's
``data`` mesh): :mod:`.mesh`."""

from .mesh import (Mesh, all_reduce_grads, broadcast_module, engaged,
                   global_sum, make_mesh, shard_rows)

__all__ = ["Mesh", "all_reduce_grads", "broadcast_module", "engaged",
           "global_sum", "make_mesh", "shard_rows"]
