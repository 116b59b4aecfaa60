"""Carrying a particle state or a frozen column plan between the JAX
package and the port.

The JAX package's state crosses as numpy (``np.asarray`` of its arrays);
a config crosses as its JSON: the port's ``SimulationConfig.from_dict``
takes the JAX package's ``SimulationConfig.to_dict()`` (or its
config.json) whole, the capacity knobs the driver heals
(``column_capacity``, ``column_window``, ``cell_capacity``, ...)
included, and raises ``TypeError`` on a field it does not know.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.core.types import ParticleState
from nbody_torch.forces.p3m_columns import ColumnPlan


def state_from_numpy(pos, vel, mass, time, *, device,
                     dtype=torch.float32) -> ParticleState:
    """A port state from numpy arrays (pos, vel (N, 3); mass (N,) or a
    scalar; time the scale factor)."""
    # np.array copies: JAX hands out read-only buffers
    return ParticleState.create(np.array(pos), np.array(vel),
                                np.array(mass), np.array(time),
                                device=device, dtype=dtype)


def state_to_numpy(state: ParticleState):
    """(pos, vel, mass, time) numpy arrays of a port state, in its dtype."""
    return tuple(
        t.detach().cpu().numpy()
        for t in (state.pos, state.vel, state.mass, state.time)
    )


#: the port's dtype of each ColumnPlan field (the JAX package holds the
#: indices in int32)
_PLAN_DTYPES = dict(pos0=torch.float32, src_g=torch.int64,
                    starts=torch.int64, counts=torch.int64, ws=torch.int32,
                    nch=torch.int32, gidx=torch.int64, ov=torch.int64)


def plan_from_numpy(*fields, device) -> ColumnPlan:
    """A port :class:`ColumnPlan` from the numpy arrays of a JAX
    ``ColumnPlan``'s fields, in their order (``[np.asarray(f) for f in
    plan]``)."""
    if len(fields) != len(ColumnPlan._fields):
        raise ValueError(f"a ColumnPlan has {len(ColumnPlan._fields)} "
                         f"fields, got {len(fields)}")
    return ColumnPlan(*(
        torch.as_tensor(np.array(f), dtype=_PLAN_DTYPES[name], device=device)
        for name, f in zip(ColumnPlan._fields, fields)))


def domain_state_from_numpy(pos, vel, mass, time, *, n_dev: int, devices,
                            dtype=torch.float32) -> list:
    """The port's slab-resident shards from the JAX package's block-sharded
    domain state as numpy ((D * C, 3) positions and velocities, (D * C,)
    masses, the scale factor): shard d takes rows [d C, (d + 1) C) onto
    ``devices[d]`` (a :class:`~nbody_torch.distributed.collectives.
    ShardGroup`'s ``devices``)."""
    pos, vel, mass = np.array(pos), np.array(vel), np.array(mass)
    if pos.shape[0] % n_dev:
        raise ValueError(f"{pos.shape[0]} rows do not split over {n_dev} "
                         f"shards")
    C = pos.shape[0] // n_dev
    return [ParticleState.create(pos[d * C:(d + 1) * C],
                                 vel[d * C:(d + 1) * C],
                                 mass[d * C:(d + 1) * C], np.array(time),
                                 device=devices[d], dtype=dtype)
            for d in range(n_dev)]


def domain_state_to_numpy(shards: list):
    """(pos, vel, mass, time) numpy arrays of slab-resident shards in the
    JAX package's block-sharded layout (shard d's C rows at [d C,
    (d + 1) C))."""
    cat = [np.concatenate([getattr(s, f).detach().cpu().numpy()
                           for s in shards]) for f in ("pos", "vel", "mass")]
    return (*cat, shards[0].time.detach().cpu().numpy())


def cnn_params_from_jax(params) -> dict:
    """A :class:`~nbody_torch.emulator.model.CosmoCNN` state_dict from the
    JAX package's flax params of a ``CosmoCNN`` (a nested dict of numpy
    arrays: ``jax.tree_util.tree_map(np.asarray, params)``).

    Conv kernels go from DHWIO to OIDHW and Dense kernels from (in, out)
    to (out, in); the last Dense layer is the head.  The flatten of
    ``global_pool=False`` is channel-last in both packages, so its Dense
    kernel needs no other permutation.  A variational model's
    ``kernel_mu`` / ``kernel_rho`` take the same layouts and its
    ``bias_mu`` / ``bias_rho`` carry over."""
    def layers(prefix):
        names = sorted((k for k in params if k.startswith(prefix + "_")),
                       key=lambda k: int(k.rsplit("_", 1)[1]))
        return [params[k] for k in names]

    variational = any(k.startswith("Conv3DVariational_") for k in params)
    convs = layers("Conv3DVariational" if variational else "Conv")
    denses = layers("DenseVariational" if variational else "Dense")
    named = [(f"convs.{i}", p, (4, 3, 0, 1, 2)) for i, p in enumerate(convs)]
    named += [(f"denses.{j}", p, (1, 0)) for j, p in enumerate(denses[:-1])]
    named.append(("head", denses[-1], (1, 0)))
    out = {}
    for name, p, perm in named:
        kernels = (("kernel_mu", "kernel_rho") if variational
                   else ("kernel",))
        for key, arr in p.items():
            arr = np.asarray(arr, dtype=np.float32)
            if key in kernels:
                arr = arr.transpose(perm)
            field = {"kernel": "weight", "bias": "bias"}.get(key, key)
            out[f"{name}.{field}"] = torch.tensor(arr)
    return out
