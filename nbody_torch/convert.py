"""Carrying a particle state between the JAX package and the port.

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
