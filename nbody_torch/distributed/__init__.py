"""The port's multi-device layer (one process, a list of shards):
:mod:`collectives`, :mod:`fft`, :mod:`measure` (the sharded P(k) and the
domain ICs' realized spectrum), the slab domain decomposition of
:mod:`domain`, its slab-resident ICs (:mod:`ic`), and :mod:`sharding`'s
block-sharded forces (the ring all-pairs and ring Ewald forces, the
sharded PM and the replicated-grid P3M)."""

from nbody_torch.distributed.collectives import ShardGroup
from nbody_torch.distributed.domain import (
    domain_decompose,
    domain_gather,
    make_domain_p3m_force,
    run_cosmological_domain,
)
from nbody_torch.distributed.ic import lpt_ic_domain
from nbody_torch.distributed.measure import realized_spectrum_domain
from nbody_torch.distributed.sharding import (
    device_mesh,
    make_ring_acc_fn,
    make_ring_ewald_acc_fn,
    make_sharded_p3m_cosmo_force,
    make_sharded_pm_cosmo_force,
    shard_state,
)

__all__ = [
    "ShardGroup",
    "device_mesh",
    "shard_state",
    "make_ring_acc_fn",
    "make_ring_ewald_acc_fn",
    "make_sharded_pm_cosmo_force",
    "make_sharded_p3m_cosmo_force",
    "domain_decompose",
    "domain_gather",
    "make_domain_p3m_force",
    "run_cosmological_domain",
    "lpt_ic_domain",
    "realized_spectrum_domain",
]
