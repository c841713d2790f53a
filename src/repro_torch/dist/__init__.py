"""Distribution substrate: logical activation axes, collectives and
placement (the port of the reference's ``repro.dist``).

``repro_torch.dist.context`` binds the *logical* activation axes ("dp",
"tp") to a mesh's axes and holds the collectives of each rank's
program; ``repro_torch.dist.sharding`` holds the placement policies
(parameter, batch and cache specs) and maps them to DTensor placements.
The reference's ``dist.compat`` aliases JAX API drift
(``jax.set_mesh``, ``jax.shard_map``) and has no counterpart in torch.
"""

from . import context, sharding

__all__ = ["context", "sharding"]
