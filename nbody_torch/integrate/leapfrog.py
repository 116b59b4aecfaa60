"""KDK (kick-drift-kick) leapfrog integration for Newtonian systems.

Counterpart of :mod:`nbody.integrate.leapfrog`.  The steps run as a
Python loop in place of ``lax.scan``, with the acceleration carried
between steps: one force evaluation per step, plus one at the start.
Nothing is read back to the host inside the loop; the diagnostics are
reductions on the state's device, stacked at the end.

The force callback has signature ``acc_fn(pos, mass) -> (acc, phi)`` where
``phi`` is the per-particle potential (used for the energy diagnostics;
return zeros if unavailable).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from nbody_torch.core.types import ParticleState

ForceFn = Callable[[torch.Tensor, torch.Tensor], tuple]


class StepDiagnostics(NamedTuple):
    """Reductions of one state, or of a series of states stacked along a
    first axis."""

    time: torch.Tensor
    e_kin: torch.Tensor
    e_pot: torch.Tensor
    momentum: torch.Tensor          # (3,)
    angular_momentum: torch.Tensor  # (3,)
    com: torch.Tensor               # (3,)


def _diagnostics(state: ParticleState, phi) -> StepDiagnostics:
    m = state.mass
    v = state.vel
    e_kin = 0.5 * torch.sum(m * torch.sum(v * v, dim=-1))
    e_pot = 0.5 * torch.sum(m * phi)
    mom = torch.sum(m[:, None] * v, dim=0)
    ang = torch.sum(m[:, None] * torch.linalg.cross(state.pos, v), dim=0)
    com = torch.sum(m[:, None] * state.pos, dim=0) / torch.sum(m)
    return StepDiagnostics(state.time, e_kin, e_pot, mom, ang, com)


def kdk_step(state: ParticleState, acc, dt, acc_fn: ForceFn):
    """One KDK step given the acceleration at the current positions.

    Returns (new_state, new_acc, new_phi).
    """
    v_half = state.vel + 0.5 * dt * acc
    pos_new = state.pos + dt * v_half
    acc_new, phi_new = acc_fn(pos_new, state.mass)
    vel_new = v_half + 0.5 * dt * acc_new
    new_state = state.replace(pos=pos_new, vel=vel_new, time=state.time + dt)
    return new_state, acc_new, phi_new


def run(state: ParticleState, dt, n_steps: int, acc_fn: ForceFn) -> ParticleState:
    """Integrate n_steps of KDK; returns only the final state."""
    acc, _ = acc_fn(state.pos, state.mass)
    for _ in range(n_steps):
        state, acc, _ = kdk_step(state, acc, dt, acc_fn)
    return state


def run_with_diagnostics(
    state: ParticleState,
    dt,
    n_steps: int,
    acc_fn: ForceFn,
    diag_every: int = 1,
):
    """Integrate and collect StepDiagnostics every ``diag_every`` steps
    (``n_steps`` must be a multiple of it).

    Returns (final state, the diagnostics of the initial state, the
    diagnostics after every ``diag_every`` steps stacked along a first
    axis of n_steps // diag_every), all on the state's device: the host
    reads them once, when the caller does.
    """
    if diag_every < 1 or n_steps % diag_every:
        raise ValueError(f"n_steps={n_steps} is not a multiple of "
                         f"diag_every={diag_every}")
    acc, phi0 = acc_fn(state.pos, state.mass)
    init_diag = _diagnostics(state, phi0)
    samples = []
    for k in range(1, n_steps + 1):
        state, acc, phi = kdk_step(state, acc, dt, acc_fn)
        if k % diag_every == 0:
            samples.append(_diagnostics(state, phi))
    diags = StepDiagnostics(*(torch.stack(field) for field in zip(*samples))) \
        if samples else None
    return state, init_diag, diags
