"""The shard group of a run and block sharding of a state.

Counterpart of :func:`nbody.distributed.sharding.device_mesh` and
:func:`~nbody.distributed.sharding.shard_state`.  The ring all-pairs and
sharded-PM forces of that module are not ported yet.
"""

from __future__ import annotations

import torch

from nbody_torch.core.types import ParticleState
from nbody_torch.distributed.collectives import ShardGroup


def device_mesh(n_devices: int | None = None, device="cuda") -> ShardGroup:
    """A 1-D group of ``n_devices`` shards on ``device``'s kind, placed
    round-robin over the visible cards (shard d on ``cuda:(d % cards)``),
    so four shards on a one-card machine share ``cuda:0``.  ``None`` (or
    0) means one shard a visible card; on the CPU every shard lives on
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("device_mesh: no CUDA device is visible")
        n = n_devices or cards
        return ShardGroup([torch.device("cuda", d % cards) for d in range(n)])
    if device.type != "cpu":
        raise ValueError(f"device_mesh: no shards on {device}")
    return ShardGroup([device] * (n_devices or 1))


def shard_state(state: ParticleState, group: ShardGroup) -> list:
    """The state's particles block-sharded over the group: shard d holds
    rows [d N / D, (d + 1) N / D), on its device."""
    D = group.size
    if state.n % D:
        raise ValueError(f"N={state.n} not divisible by {D} devices")
    n = state.n // D
    return [ParticleState(pos=state.pos[d * n:(d + 1) * n].to(dev),
                          vel=state.vel[d * n:(d + 1) * n].to(dev),
                          mass=state.mass[d * n:(d + 1) * n].to(dev),
                          time=state.time.to(dev))
            for d, dev in enumerate(group.devices)]
