"""Particle state: a dataclass of tensors.

Counterpart of :class:`nbody.core.types.ParticleState`.  The fields and
their meaning are the same; the arrays are torch tensors on one device.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParticleState:
    """Positions, velocities (or canonical momenta) and masses.

    Attributes:
      pos:  (N, 3) positions. Comoving for cosmological runs.
      vel:  (N, 3). For cosmological runs the canonical momentum
            p = a^2 dx/dt per unit mass.
      mass: (N,) particle masses.
      time: 0-d tensor: the scale factor a for cosmological runs.
    """

    pos: torch.Tensor
    vel: torch.Tensor
    mass: torch.Tensor
    time: torch.Tensor

    @classmethod
    def create(cls, pos, vel, mass, time=0.0, *, device=None,
               dtype=None) -> "ParticleState":
        pos = torch.as_tensor(pos, device=device, dtype=dtype)
        kw = dict(device=pos.device, dtype=pos.dtype)
        vel = torch.as_tensor(vel, **kw)
        mass = torch.as_tensor(mass, **kw)
        if mass.ndim == 0:
            mass = mass.expand(pos.shape[0]).clone()
        return cls(pos=pos, vel=vel, mass=mass,
                   time=torch.as_tensor(time, **kw))

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    def replace(self, **changes) -> "ParticleState":
        return dataclasses.replace(self, **changes)

    def to(self, device=None, dtype=None) -> "ParticleState":
        return ParticleState(
            pos=self.pos.to(device=device, dtype=dtype),
            vel=self.vel.to(device=device, dtype=dtype),
            mass=self.mass.to(device=device, dtype=dtype),
            time=self.time.to(device=device, dtype=dtype),
        )
