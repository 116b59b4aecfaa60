"""Adaptive time-stepping: a global adaptive step and rung diagnostics.

Counterpart of :mod:`nbody.integrate.adaptive`:

  * a **global adaptive step**: dt = eta * sqrt(eps / max |a|), the
    standard collisionless criterion, chosen on the device, capped by the
    time left so that the run ends exactly at t_end;
  * **rung diagnostics** with CONCEPT's rung semantics (rung r wants
    dt/2^r).

The JAX package's ``lax.while_loop`` becomes a Python loop that reads its
stop test on the host only every :data:`CHECK_EVERY` steps.  The steps in
between that start at or past t_end (or past ``max_steps``) are no-ops:
their step is 0, they leave the state as it was, and they count in
neither ``n_steps`` nor ``dt_min``/``dt_max``, which stay on the device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from nbody_torch.core.types import ParticleState

#: steps between the host reads of the stop test
CHECK_EVERY = 16


def required_dt(acc, eps: float, eta: float = 0.025):
    """Per-particle step demand: dt_i = eta * sqrt(eps / |a_i|)."""
    amag = torch.linalg.norm(acc, dim=-1)
    return eta * torch.sqrt(eps / torch.clamp_min(amag, 1e-30))


def rung_population(acc, dt_base: float, eps: float, eta: float = 0.025,
                    n_rungs: int = 8):
    """How many particles want rung r (dt_base / 2^r), the observable
    CONCEPT logs per step.  Returns an (n_rungs,) int64 tensor."""
    dt_req = required_dt(acc, eps, eta)
    r = torch.clamp(
        torch.ceil(torch.log2(torch.clamp_min(dt_base / dt_req, 1.0))),
        0, n_rungs - 1,
    ).to(torch.int64)
    return torch.bincount(r, minlength=n_rungs)


class AdaptiveResult(NamedTuple):
    state: ParticleState
    n_steps: torch.Tensor  # 0-d int32: steps actually taken
    dt_min: torch.Tensor   # smallest step used
    dt_max: torch.Tensor   # largest step used


def run_adaptive(
    state: ParticleState,
    t_end,
    acc_fn: Callable,
    eps: float,
    eta: float = 0.025,
    dt_limit: float = math.inf,
    max_steps: int = 100_000,
) -> AdaptiveResult:
    """KDK with a globally adaptive dt until ``t_end`` (exact arrival).

    ``acc_fn(pos, mass) -> (acc, phi)`` as in
    :func:`nbody_torch.integrate.leapfrog.run`.  The step is the minimum
    particle demand (so it shrinks through close encounters and collapse),
    capped by ``dt_limit`` and by the remaining time; at most
    ``max_steps`` steps are taken.  The host reads whether the run is done
    every :data:`CHECK_EVERY` steps; up to ``CHECK_EVERY - 1`` force
    evaluations past the end are discarded.
    """
    dtype, dev = state.pos.dtype, state.pos.device
    t_end = torch.as_tensor(t_end, dtype=dtype, device=dev)
    acc, _ = acc_fn(state.pos, state.mass)
    n = torch.zeros((), dtype=torch.int32, device=dev)
    dmin = torch.full((), math.inf, dtype=dtype, device=dev)
    dmax = torch.full((), -math.inf, dtype=dtype, device=dev)
    pos, vel, time = state.pos, state.vel, state.time
    zero = torch.zeros((), dtype=dtype, device=dev)
    while True:
        for _ in range(CHECK_EVERY):
            live = (time < t_end) & (n < max_steps)
            dt = torch.min(required_dt(acc, eps, eta))
            dt = torch.minimum(torch.clamp_max(dt, dt_limit), t_end - time)
            dt = torch.where(live, dt, zero)
            v_half = vel + 0.5 * dt * acc
            pos_new = pos + dt * v_half
            acc_new, _ = acc_fn(pos_new, state.mass)
            vel_new = v_half + 0.5 * dt * acc_new
            pos = torch.where(live, pos_new, pos)
            vel = torch.where(live, vel_new, vel)
            acc = torch.where(live, acc_new, acc)
            time = time + dt
            n = n + live.to(torch.int32)
            dmin = torch.where(live, torch.minimum(dmin, dt), dmin)
            dmax = torch.where(live, torch.maximum(dmax, dt), dmax)
        if not bool((time < t_end) & (n < max_steps)):
            break
    return AdaptiveResult(state=state.replace(pos=pos, vel=vel, time=time),
                          n_steps=n, dt_min=dmin, dt_max=dmax)
