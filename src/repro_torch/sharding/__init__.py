"""Partition rules and mesh placement of the port (``src/repro/sharding``):
the rules (``rules``), one rank's share of a sharded serving engine
(``placement``) and the collectives it issues (``comm``)."""
from repro_torch.sharding.rules import (ArchSharding, dp_size, fsdp_axes,
                                        host_to_mesh, shard, tp_size,
                                        unshard)

__all__ = ["ArchSharding", "dp_size", "fsdp_axes", "host_to_mesh", "shard",
           "tp_size", "unshard"]
