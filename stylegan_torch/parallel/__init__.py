"""Data parallelism over ranks (the port's counterpart of
``stylegan_tpu/parallel``): one process per device, joined by
``torch.distributed``.  The spatial (2-D mesh) names are not ported yet."""

from .distributed import (average_gradients, broadcast_, global_shard,
                          host_count, host_index, initialize_distributed,
                          is_multihost, replicate, spawn)
from .mesh import (Mesh, compatible_mesh_size, create_mesh, device_count,
                   resolve_max_devices)

__all__ = ["Mesh", "create_mesh", "device_count", "compatible_mesh_size",
           "resolve_max_devices", "host_count", "host_index",
           "initialize_distributed", "is_multihost", "global_shard",
           "replicate", "broadcast_", "average_gradients", "spawn"]
