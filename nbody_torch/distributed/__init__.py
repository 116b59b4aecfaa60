"""The slab domain decomposition of the port (one process, a list of
shards): :mod:`collectives`, :mod:`sharding`, :mod:`fft`, :mod:`domain`
and :mod:`measure`."""

from nbody_torch.distributed.collectives import ShardGroup
from nbody_torch.distributed.domain import (
    domain_decompose,
    domain_gather,
    make_domain_p3m_force,
    run_cosmological_domain,
)
from nbody_torch.distributed.sharding import device_mesh, shard_state

__all__ = [
    "ShardGroup",
    "device_mesh",
    "shard_state",
    "domain_decompose",
    "domain_gather",
    "make_domain_p3m_force",
    "run_cosmological_domain",
]
