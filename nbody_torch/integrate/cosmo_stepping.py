"""Comoving-coordinate KDK stepping in the scale factor a.

Counterpart of the fixed-step part of :mod:`nbody.integrate.cosmo_stepping`
(the plain KDK, the split-Hamiltonian subcycled KDK and the per-particle
rungs).  The exact kick/drift factors are pre-integrated on the host (the
same numpy) and the steps run as a Python loop in place of ``lax.scan``,
with the same KDK order and ``mod(box)`` wrap.

Conventions: x comoving, p = a^2 dx/dt,
  dx/da = p / (a^3 H(a)),   dp/da = g(x, a) / (a H(a)),
and a KDK step over [a0, a1] with geometric midpoint am uses
  K1 = int_{a0}^{am} da/(a H),  Dr = int_{a0}^{a1} da/(a^3 H),
  K2 = int_{am}^{a1} da/(a H).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from nbody_torch.core.cosmology import Cosmology
from nbody_torch.core.types import ParticleState

CosmoForceFn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]


def cosmo_kick_drift_factors(cosmo: Cosmology, a_grid: np.ndarray):
    """Host-side exact kick/drift factors for each step of ``a_grid``:
    (K1, Dr, K2, a_mid), numpy arrays of length len(a_grid) - 1, by
    trapezoid in log a."""
    a_grid = np.asarray(a_grid, dtype=np.float64)
    H0 = float(cosmo.H0)
    Om, OL = float(cosmo.Omega_m), float(cosmo.Omega_L)

    def H(a):
        return H0 * np.sqrt(Om / a**3 + OL)

    def integrate(f, lo, hi, n=256):
        lna = np.linspace(np.log(lo), np.log(hi), n)
        a = np.exp(lna)
        return np.trapezoid(f(a) * a, lna)

    a0s, a1s = a_grid[:-1], a_grid[1:]
    ams = np.sqrt(a0s * a1s)
    K1 = np.array([integrate(lambda a: 1 / (a * H(a)), lo, m) for lo, m in zip(a0s, ams)])
    K2 = np.array([integrate(lambda a: 1 / (a * H(a)), m, hi) for m, hi in zip(ams, a1s)])
    Dr = np.array([integrate(lambda a: 1 / (a**3 * H(a)), lo, hi) for lo, hi in zip(a0s, a1s)])
    return K1, Dr, K2, ams


def log_a_steps(a_begin: float, a_end: float, n_steps: int) -> np.ndarray:
    """Log-uniform scale-factor grid of n_steps steps."""
    return np.geomspace(a_begin, a_end, n_steps + 1)


def _max_overflow(acc, ov):
    """Running max of the overflow words: a device tensor stays on the
    device (no sync per step); a plain 0 from a tier that drops nothing
    leaves it as it is."""
    if isinstance(ov, torch.Tensor):
        return ov if acc is None else torch.maximum(acc, ov)
    if ov:
        raise ValueError(f"a host overflow word must be 0, got {ov}")
    return acc


def kdk_steps(state: ParticleState, cosmo: Cosmology, a_grid, acc_fn,
              box: float, g=None):
    """KDK over ``a_grid`` for a checked ``acc_fn(pos, mass, a) ->
    (g, overflow)``.

    ``g``: the force at ``state`` if the caller already has it (the last
    force of the previous call, at the same positions and a), so a run
    cut into several calls evaluates the force once per step plus once at
    the start.  Returns (state, g, overflow): the overflow words are
    reduced with max on the device and read on the host once, at the end."""
    a_grid = np.asarray(a_grid, dtype=np.float64)
    K1, Dr, K2, _ = cosmo_kick_drift_factors(cosmo, a_grid)
    pos, vel, mass = state.pos, state.vel, state.mass
    overflow = None
    if g is None:
        g, ov = acc_fn(pos, mass, float(state.time))
        overflow = _max_overflow(overflow, ov)
    for a1, k1, dr, k2 in zip(a_grid[1:], K1, Dr, K2):
        p_half = vel + g * float(k1)
        pos = torch.remainder(pos + p_half * float(dr), box)
        g, ov = acc_fn(pos, mass, float(a1))
        overflow = _max_overflow(overflow, ov)
        vel = p_half + g * float(k2)
    time = torch.as_tensor(float(a_grid[-1]), device=pos.device,
                           dtype=pos.dtype)
    return (state.replace(pos=pos, vel=vel, time=time), g,
            0 if overflow is None else int(overflow))


def run_cosmological_checked(state: ParticleState, cosmo: Cosmology, a_grid,
                             acc_fn, box: float):
    """Integrate comoving KDK from a_grid[0] to a_grid[-1] with a checked
    ``acc_fn(pos, mass, a) -> (g, overflow)``; returns
    (final_state, max overflow over every force evaluation)."""
    final, _, overflow = kdk_steps(state, cosmo, a_grid, acc_fn, box)
    return final, overflow


def run_cosmological(state: ParticleState, cosmo: Cosmology, a_grid,
                     acc_fn: CosmoForceFn, box: float) -> ParticleState:
    """Integrate comoving KDK from a_grid[0] to a_grid[-1];
    ``acc_fn(pos, mass, a) -> g`` is the canonical-momentum force and
    ``state.vel`` holds p = a^2 dx/dt."""
    final, _, _ = kdk_steps(state, cosmo, a_grid,
                            lambda p, m, a: (acc_fn(p, m, a), 0), box)
    return final


# ---------------------------------------------------------------------------
# Split-Hamiltonian subcycling (far field at the global step)
# ---------------------------------------------------------------------------


def subcycle_tables(cosmo: Cosmology, a_grid, n_sub: int):
    """Host-side factors of the short-range KDKs inside each global step
    of ``a_grid``: the step cut into n_sub log-uniform subcycles.  Returns
    (Ks1, Drs, Ks2, A_sub), each (n_steps, n_sub): the subcycles' kick,
    drift and kick factors and the scale factor at each one's end."""
    a_grid = np.asarray(a_grid, dtype=np.float64)
    n_steps = len(a_grid) - 1
    Ks1, Drs, Ks2, A_sub = (np.empty((n_steps, n_sub)) for _ in range(4))
    for i in range(n_steps):
        sub = np.geomspace(a_grid[i], a_grid[i + 1], n_sub + 1)
        Ks1[i], Drs[i], Ks2[i], _ = cosmo_kick_drift_factors(cosmo, sub)
        A_sub[i] = sub[1:]
    return Ks1, Drs, Ks2, A_sub


def run_cosmological_subcycled(state: ParticleState, cosmo: Cosmology,
                               a_grid, acc_long_fn, acc_short_fn, box: float,
                               n_sub: int, acc_both_fn=None, frozen_fns=None,
                               frozen_both_fn=None,
                               stats: dict | None = None):
    """Split-Hamiltonian KDK over ``a_grid``: the far field kicks at the
    global step's half-steps, and the short-range force drives ``n_sub``
    KDKs inside it (counterpart of the JAX package's
    ``run_cosmological_subcycled``).  Each global step evaluates one long
    and ``n_sub`` short forces: the last subcycle's short force is the
    next step's first, and the long kicks move no particle, so no force is
    evaluated twice at one position.  The run starts with one evaluation
    at the state's positions.

    ``acc_long_fn(pos, mass, a) -> g``; ``acc_short_fn(pos, mass, a) ->
    (g, overflow)``.  ``acc_both_fn(pos, mass, a_s, a_l) -> (gs, gl,
    overflow)`` gives the last subcycle's short force and the closing
    long force from one evaluation at the same positions (and the first
    evaluation).  ``frozen_fns = (freeze_fn, short_frozen_fn,
    drift_ok_fn)`` evaluates the subcycles' short force on a column plan
    frozen at the start and refrozen when ``drift_ok_fn`` fails
    (``short_frozen_fn(pos, mass, a, plan) -> (g, overflow)``);
    ``frozen_both_fn(pos, mass, a_s, a_l, plan) -> (gs, gl, overflow)``
    puts the fused boundary evaluation on the same plan.  The port reads
    ``drift_ok_fn`` on the host once before each evaluation on the plan
    (the JAX package's ``lax.cond``).

    Returns (final_state, the max overflow of every evaluation, read on
    the host once, at the end).  ``stats``, when given, receives the
    counts of long, short, frozen-plan and fused evaluations, plan
    refreezes and host reads of the drift predicate."""
    a_grid = np.asarray(a_grid, dtype=np.float64)
    n_sub = int(n_sub)
    KL1, _, KL2, _ = cosmo_kick_drift_factors(cosmo, a_grid)
    Ks1, Drs, Ks2, A_sub = subcycle_tables(cosmo, a_grid, n_sub)
    pos, vel, mass = state.pos, state.vel, state.mass
    n = dict(long_evals=0, short_evals=0, frozen_evals=0, both_evals=0,
             refreezes=0, drift_reads=0)
    overflow = None
    a0 = float(state.time)
    if acc_both_fn is not None:
        gs, gl, ov = acc_both_fn(pos, mass, a0, a0)
        n["both_evals"] += 1
    else:
        gl = acc_long_fn(pos, mass, a0)
        gs, ov = acc_short_fn(pos, mass, a0)
        n["long_evals"] += 1
        n["short_evals"] += 1
    overflow = _max_overflow(overflow, ov)
    plan = None
    if frozen_fns is not None:
        freeze_fn, short_frozen_fn, drift_ok_fn = frozen_fns
        plan = freeze_fn(pos, mass)

    def current_plan(p):
        """The carried plan, refrozen at ``p`` when it has gone stale."""
        nonlocal plan
        n["drift_reads"] += 1
        if not bool(drift_ok_fn(p, plan)):
            plan = freeze_fn(p, mass)
            n["refreezes"] += 1
        return plan

    fused = acc_both_fn is not None
    for i in range(len(a_grid) - 1):
        p = vel + gl * float(KL1[i])
        for j in range(n_sub):
            p = p + gs * float(Ks1[i, j])
            pos = torch.remainder(pos + p * float(Drs[i, j]), box)
            a_s = float(A_sub[i, j])
            if fused and j == n_sub - 1:
                a1 = float(a_grid[i + 1])
                if frozen_both_fn is not None and plan is not None:
                    gs, gl, ov = frozen_both_fn(pos, mass, a_s, a1,
                                                current_plan(pos))
                else:
                    gs, gl, ov = acc_both_fn(pos, mass, a_s, a1)
                n["both_evals"] += 1
            elif plan is not None:
                gs, ov = short_frozen_fn(pos, mass, a_s, current_plan(pos))
                n["frozen_evals"] += 1
            else:
                gs, ov = acc_short_fn(pos, mass, a_s)
                n["short_evals"] += 1
            overflow = _max_overflow(overflow, ov)
            p = p + gs * float(Ks2[i, j])
        if not fused:
            gl = acc_long_fn(pos, mass, float(a_grid[i + 1]))
            n["long_evals"] += 1
        vel = p + gl * float(KL2[i])
    if stats is not None:
        stats.update(n)
    time = torch.as_tensor(float(a_grid[-1]), device=pos.device,
                           dtype=pos.dtype)
    return (state.replace(pos=pos, vel=vel, time=time),
            0 if overflow is None else int(overflow))


# ---------------------------------------------------------------------------
# Per-particle rung stepping (CONCEPT's rung subdivision)
# ---------------------------------------------------------------------------


def rung_kick_tables(cosmo: Cosmology, a_grid, n_rungs: int):
    """Host-side per-rung kick factors for block-step KDK: each global
    step of ``a_grid`` is cut into n_sub = 2^(n_rungs - 1) log-uniform
    sub-ticks, and rung r kicks every 2^(n_rungs - 1 - r)-th of them with
    the exact factors of its own sub-intervals (half-kicks around their
    geometric midpoints).

    Returns (Fk, Dr, A_sub): Fk (n_steps, n_sub + 1, n_rungs) the kick
    factor applied at tick j to a rung-r particle (0 when r is inactive at
    j; ticks 0 and n_sub carry the opening and closing half-kicks), Dr
    (n_steps, n_sub) the drift factor of each sub-tick, A_sub (n_steps,
    n_sub) the scale factor at the end of each sub-tick."""
    a_grid = np.asarray(a_grid, dtype=np.float64)
    n_steps = len(a_grid) - 1
    n_sub = 2 ** (n_rungs - 1)
    Fk = np.zeros((n_steps, n_sub + 1, n_rungs))
    Dr = np.empty((n_steps, n_sub))
    A_sub = np.empty((n_steps, n_sub))
    for i in range(n_steps):
        t = np.geomspace(a_grid[i], a_grid[i + 1], n_sub + 1)
        _, dr, _, _ = cosmo_kick_drift_factors(cosmo, t)
        Dr[i] = dr
        A_sub[i] = t[1:]
        for r in range(n_rungs):
            m = 2 ** (n_rungs - 1 - r)
            bounds = t[::m]
            k1, _, k2, _ = cosmo_kick_drift_factors(cosmo, bounds)
            for b in range(len(bounds) - 1):
                Fk[i, b * m, r] += k1[b]
                Fk[i, (b + 1) * m, r] += k2[b]
    return Fk, Dr, A_sub


def rung_active_min(j: int, n_rungs: int) -> int:
    """Lowest active rung at sub-tick j (1 .. n_sub - 1): the rungs whose
    sub-interval boundary falls on j, r >= n_rungs - 1 - v2(j)."""
    v2 = 0
    while j % 2 == 0:
        j //= 2
        v2 += 1
    return n_rungs - 1 - v2


def _rung_demand(vel, gl, gs, a0, cell, eta_disp, eta_acc_eps2, H0, Om, OL):
    """Per-particle step demand dla_i, the smaller of the displacement
    (dt <= eta_disp cell / |dx/dt|) and acceleration (dt <= sqrt(2 eta_acc
    eps a / |g|)) criteria; ``a0`` and the other factors are 0-d tensors
    of the state's dtype, as the JAX package's scan carries them, and
    ``eta_acc_eps2`` None turns the acceleration criterion off."""
    H = H0 * torch.sqrt(Om / a0**3 + OL)
    speed = torch.linalg.vector_norm(vel, dim=-1)
    dla_disp = eta_disp * cell * a0**2 * H / torch.clamp_min(speed, 1e-30)
    if eta_acc_eps2 is None:
        return dla_disp
    gmag = torch.linalg.vector_norm(gl + gs, dim=-1)
    dla_acc = H * torch.sqrt(eta_acc_eps2 * a0 / torch.clamp_min(gmag, 1e-30))
    return torch.minimum(dla_disp, dla_acc)


def _assign_rungs(dla_i, dla_step, n_rungs: int):
    """Rung r wants the global step / 2^r: r = ceil(log2(step / demand)),
    clipped to [0, n_rungs - 1]; int64."""
    r = torch.ceil(torch.log2(dla_step / torch.clamp_min(dla_i, 1e-30)))
    return torch.clamp(r, 0, n_rungs - 1).to(torch.int64)


def run_cosmological_rungs(state: ParticleState, cosmo: Cosmology, a_grid,
                           acc_both_fn, acc_short_masked_fn, box: float,
                           n_rungs: int, cell: float,
                           eta_disp: float = 0.25, eta_acc: float = 0.025,
                           eps: float = 0.0, frozen_both_fns=None,
                           stats: dict | None = None):
    """Block-step KDK with per-particle rungs (CONCEPT's scheme) over
    ``a_grid``: counterpart of the JAX package's fixed-grid
    ``run_cosmological_rungs`` (its full-N kicks, and both halves of the
    boundary force from one evaluation; the compact active-row kicks are
    not ported).

    Each global step assigns rungs from the displacement and acceleration
    demand, kicks the far field at the half-steps and kicks rung r at
    every 2^(n_rungs - 1 - r)-th of the n_sub = 2^(n_rungs - 1) sub-ticks.
    Interior sub-ticks evaluate the short force for the active rungs
    only: ``acc_short_masked_fn(pos, mass, act, a) -> (g, ov_source,
    ov_target, occupancy)`` (the two-plane cell kernel), or, with the
    six-function ``frozen_both_fns = (freeze_fn, both_frozen_fn,
    drift_ok_fn, masked_frozen_fn, stale_fn, fresh_plan_fn)``, the masked
    column kernel on the plan frozen at the last boundary.  Boundary ticks
    evaluate both halves at once (``acc_both_fn(pos, mass, a_s, a_l) ->
    (gs, gl, ov)``, or the frozen-plan forms, which refreeze when
    ``drift_ok_fn`` fails).
    With the three-function ``frozen_both_fns`` (freeze, both_frozen,
    drift_ok) only the boundary rides the plan.

    The run starts with one evaluation at the state's positions, as the
    JAX package's scan does.  The step's rung histogram is read on the
    host once per step: tick j has an active set exactly when the deepest
    populated rung is >= rung_active_min(j), so the masked evaluation of a
    tick without one is skipped (its kick would add 0), and the frozen
    boundary reads its drift predicate once.  Every other quantity stays
    on the device until the end.

    Returns (final_state, boundary overflow, masked source overflow,
    target overflow, target occupancy, plan staleness, hists (n_steps,
    n_rungs) numpy): the channels heal different knobs.  ``stats``, when
    given, receives the counts of boundary evaluations, interior
    evaluations and plan refreezes."""
    a_grid = np.asarray(a_grid, dtype=np.float64)
    n_steps = len(a_grid) - 1
    n_sub = 2 ** (n_rungs - 1)
    KL1, _, KL2, _ = cosmo_kick_drift_factors(cosmo, a_grid)
    Fk, Dr, A_sub = rung_kick_tables(cosmo, a_grid, n_rungs)
    pos, vel, mass = state.pos, state.vel, state.mass
    dev, dtype = pos.device, pos.dtype

    def dev_t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    a0s, a1s, Fk_d = dev_t(a_grid[:-1]), dev_t(a_grid[1:]), dev_t(Fk)
    H0, Om, OL = float(cosmo.H0), float(cosmo.Omega_m), float(cosmo.Omega_L)
    cell_t, eta_t = dev_t(cell), dev_t(eta_disp)
    acc_t = dev_t(2.0 * eta_acc * eps) if eta_acc * eps > 0 else None

    fns = frozen_both_fns
    if fns is not None:
        freeze_fn, both_frozen_fn, drift_ok_fn = fns[:3]
    masked_frozen_fn, stale_fn, fresh_plan_fn = (
        fns[3:6] if fns is not None and len(fns) > 5 else (None,) * 3)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    ovb = ovm = ovt = occt = ovst = zero
    n_b = n_i = n_refreeze = 0

    a_start = float(a_grid[0])
    plan = None
    if fresh_plan_fn is not None:
        gs, gl, ov0, plan = fresh_plan_fn(pos, mass, a_start, a_start)
    else:
        gs, gl, ov0 = acc_both_fn(pos, mass, a_start, a_start)
        if fns is not None:
            plan = freeze_fn(pos, mass)
    ovb = _max_overflow(ovb, ov0)
    n_b += 1

    hists = np.zeros((n_steps, n_rungs), dtype=np.int64)
    for i in range(n_steps):
        dla_i = _rung_demand(vel, gl, gs, a0s[i], cell_t, eta_t, acc_t,
                             H0, Om, OL)
        rung = _assign_rungs(dla_i, torch.log(a1s[i]) - torch.log(a0s[i]),
                             n_rungs)
        hists[i] = torch.bincount(rung, minlength=n_rungs).tolist()
        deepest = int(np.nonzero(hists[i])[0].max())

        p = vel + gl * float(KL1[i])
        p = p + gs * Fk_d[i, 0][rung][:, None]
        for j in range(1, n_sub + 1):
            pos = torch.remainder(pos + p * float(Dr[i, j - 1]), box)
            a_s = float(A_sub[i, j - 1])
            if j < n_sub:
                if deepest < rung_active_min(j, n_rungs):
                    continue
                act = rung >= rung_active_min(j, n_rungs)
                if masked_frozen_fn is not None:
                    # interior tick on the carried plan, unconditionally:
                    # drift beyond skin/2 shows on the staleness channel
                    g, o = masked_frozen_fn(pos, mass, act, a_s, plan)
                    ovb = _max_overflow(ovb, o)
                    ovst = _max_overflow(ovst, stale_fn(pos, plan))
                else:
                    g, o, ot, oc = acc_short_masked_fn(pos, mass, act, a_s)
                    ovm, ovt = _max_overflow(ovm, o), _max_overflow(ovt, ot)
                    occt = _max_overflow(occt, oc)
                n_i += 1
            else:
                # boundary tick: the full short force and the closing long
                # force at the same positions
                a1 = float(a_grid[i + 1])
                if fns is not None:
                    keep = bool(drift_ok_fn(pos, plan))
                    if not keep:
                        n_refreeze += 1
                    if keep or fresh_plan_fn is None:
                        if not keep:
                            plan = freeze_fn(pos, mass)
                        g, gl_new, o = both_frozen_fn(pos, mass, a_s, a1, plan)
                    else:
                        g, gl_new, o, plan = fresh_plan_fn(pos, mass, a_s, a1)
                else:
                    g, gl_new, o = acc_both_fn(pos, mass, a_s, a1)
                gs = g
                ovb = _max_overflow(ovb, o)
                n_b += 1
            p = p + g * Fk_d[i, j][rung][:, None]
        gl = gl_new
        vel = p + gl * float(KL2[i])

    if stats is not None:
        stats.update(boundary_evals=n_b, interior_evals=n_i,
                     refreezes=n_refreeze)
    chans = torch.stack([ovb, ovm, ovt, occt, ovst]).tolist()
    time = torch.as_tensor(float(a_grid[-1]), device=dev, dtype=dtype)
    final = state.replace(pos=pos, vel=vel, time=time)
    return (final, *chans, hists)
