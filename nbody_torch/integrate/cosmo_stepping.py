"""Comoving-coordinate KDK stepping in the scale factor a.

Counterpart of :mod:`nbody.integrate.cosmo_stepping` (the plain KDK, the
split-Hamiltonian subcycled KDK and the per-particle rungs, on a fixed
grid or with adaptive steps).  On a fixed grid the exact kick/drift
factors are pre-integrated on the host (the same numpy); an adaptive step
integrates its own on the device.  The steps run as a Python loop in
place of ``lax.scan`` and ``lax.while_loop``, with the same KDK order and
``mod(box)`` wrap.

Conventions: x comoving, p = a^2 dx/dt,
  dx/da = p / (a^3 H(a)),   dp/da = g(x, a) / (a H(a)),
and a KDK step over [a0, a1] with geometric midpoint am uses
  K1 = int_{a0}^{am} da/(a H),  Dr = int_{a0}^{a1} da/(a^3 H),
  K2 = int_{am}^{a1} da/(a H).
"""

from __future__ import annotations

import functools
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


def _compact_rows(rung, capacity: int, n_act: int):
    """(idx_act, act_valid): the rows with rung >= 1, ascending, in a
    (capacity,) index (0 past their count, as ``jnp.nonzero(size=,
    fill_value=0)`` pads), and the mask of its valid entries.  ``n_act``,
    their count, comes from the step's histogram on the host, so nothing
    here reads the device."""
    act_any = rung >= 1
    slot = torch.cumsum(act_any, 0) - 1
    target = torch.where(act_any & (slot < capacity), slot, capacity)
    rows = torch.arange(rung.shape[0], device=rung.device)
    # the rows past the capacity all land on the dropped slot `capacity`
    idx = torch.zeros(capacity + 1, dtype=torch.int64,
                      device=rung.device).scatter_(0, target, rows)
    valid = (torch.arange(capacity, device=rung.device)
             < min(int(n_act), capacity))
    return idx[:capacity], valid


def _rung_block_step(pos, vel, mass, gl, gs, rung, hist, tables, *,
                     box: float, n_rungs: int, acc_both_fn,
                     acc_short_masked_fn, frozen_both_fns=None, plan=None,
                     active_capacity: int = 0, chans: dict, n: dict):
    """One global KDK step with per-particle rung short-range kicks: the
    step of the fixed-grid :func:`run_cosmological_rungs` and of the
    adaptive :func:`make_adaptive_rung_runner` (the JAX package's
    ``_rung_block_step``).

    ``tables = (a1, kl1, kl2, Fk, Dr, A_sub)``: the step's end, the long
    half-kick factors, the per-tick rung kick factors Fk (n_sub + 1,
    n_rungs) as a tensor of the state's dtype on its device, and the
    sub-ticks' drift factors and end scale factors; everything but Fk is
    host floats.  ``hist`` is the step's rung histogram on the host: a
    tick whose lowest active rung is above the deepest populated one is
    skipped (its kick would add 0), and with ``active_capacity > 0`` on
    the frozen route the interior kicks go to the step's rows with rung
    >= 1 only (the compact active-row kicks: K5's slot table gathered at
    those rows and added back into them, bit for bit the full-N kick);
    their count past the capacity is ``n['truncated']``.

    ``chans`` holds the overflow words (ovb, ovm, ovt, occt, ovst) on the
    device and ``n`` the counts (boundary_evals, interior_evals,
    refreezes, drift_reads, truncated); both are updated in place.
    Returns (pos, vel, gl_new, gs_new, plan)."""
    a1, kl1, kl2, Fk, Dr, A_sub = tables
    n_sub = 2 ** (n_rungs - 1)
    deepest = max((r for r, c in enumerate(hist) if c), default=0)
    fns = frozen_both_fns
    if fns is not None:
        freeze_fn, both_frozen_fn, drift_ok_fn = fns[:3]
    masked_frozen_fn, stale_fn, fresh_plan_fn = (
        fns[3:6] if fns is not None and len(fns) > 5 else (None,) * 3)
    compact = masked_frozen_fn is not None and active_capacity > 0

    p = vel + gl * kl1
    p = p + gs * Fk[0][rung][:, None]
    if compact:
        n_act = int(sum(hist[1:]))
        n["truncated"] = max(n["truncated"], n_act - active_capacity)
        idx_act, act_valid = _compact_rows(rung, active_capacity, n_act)
        rung_act = rung[idx_act]
        slot_act = plan.gidx[idx_act]
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
    for j in range(1, n_sub + 1):
        pos = torch.remainder(pos + p * Dr[j - 1], box)
        a_s = A_sub[j - 1]
        if j < n_sub:
            if deepest < rung_active_min(j, n_rungs):
                continue
            act = rung >= rung_active_min(j, n_rungs)
            if masked_frozen_fn is not None:
                # interior tick on the carried plan, unconditionally:
                # drift beyond skin/2 shows on the staleness channel
                if compact:
                    buckets, o = masked_frozen_fn(pos, mass, act, a_s, plan,
                                                  buckets=True)
                    fk = torch.where(act_valid, Fk[j][rung_act], zero)
                    p = p.index_add(0, idx_act,
                                    buckets[slot_act] * fk[:, None])
                    g = None
                else:
                    g, o = masked_frozen_fn(pos, mass, act, a_s, plan)
                chans["ovb"] = _max_overflow(chans["ovb"], o)
                chans["ovst"] = _max_overflow(chans["ovst"],
                                              stale_fn(pos, plan))
            else:
                g, o, ot, oc = acc_short_masked_fn(pos, mass, act, a_s)
                chans["ovm"] = _max_overflow(chans["ovm"], o)
                chans["ovt"] = _max_overflow(chans["ovt"], ot)
                chans["occt"] = _max_overflow(chans["occt"], oc)
            n["interior_evals"] += 1
        else:
            # boundary tick: the full short force and the closing long
            # force at the same positions
            if fns is not None:
                keep = bool(drift_ok_fn(pos, plan))
                n["drift_reads"] += 1
                if not keep:
                    n["refreezes"] += 1
                if keep or fresh_plan_fn is None:
                    if not keep:
                        plan = freeze_fn(pos, mass)
                    g, gl_new, o = both_frozen_fn(pos, mass, a_s, a1, plan)
                else:
                    g, gl_new, o, plan = fresh_plan_fn(pos, mass, a_s, a1)
            else:
                g, gl_new, o = acc_both_fn(pos, mass, a_s, a1)
            gs = g
            chans["ovb"] = _max_overflow(chans["ovb"], o)
            n["boundary_evals"] += 1
        if g is not None:
            p = p + g * Fk[j][rung][:, None]
    return pos, p + gl_new * kl2, gl_new, gs, plan


def _rung_start(pos, mass, a, acc_both_fn, frozen_both_fns):
    """The rung runners' first evaluation at ``pos``: (gs, gl, overflow,
    plan), the plan from the fresh fused evaluation where the frozen
    route has one, else frozen after it (None off the frozen route)."""
    fns = frozen_both_fns
    if fns is not None and len(fns) > 5:
        return fns[5](pos, mass, a, a)
    gs, gl, ov = acc_both_fn(pos, mass, a, a)
    return gs, gl, ov, (fns[0](pos, mass) if fns is not None else None)


def _rung_chans(dev) -> dict:
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    return dict(ovb=zero, ovm=zero, ovt=zero, occt=zero, ovst=zero)


def _rung_counts() -> dict:
    return dict(boundary_evals=0, interior_evals=0, refreezes=0,
                drift_reads=0, step_reads=0, truncated=0)


def _rung_channels(chans: dict, n: dict) -> list:
    """The five channels on the host (one read): boundary, masked source,
    target (or the compact rows' truncation), target occupancy, plan
    staleness."""
    out = torch.stack([chans[k] for k in ("ovb", "ovm", "ovt", "occt",
                                          "ovst")]).tolist()
    out[2] = max(out[2], n["truncated"])
    return out


def run_cosmological_rungs(state: ParticleState, cosmo: Cosmology, a_grid,
                           acc_both_fn, acc_short_masked_fn, box: float,
                           n_rungs: int, cell: float,
                           eta_disp: float = 0.25, eta_acc: float = 0.025,
                           eps: float = 0.0, frozen_both_fns=None,
                           active_capacity: int = 0,
                           stats: dict | None = None):
    """Block-step KDK with per-particle rungs (CONCEPT's scheme) over
    ``a_grid``: counterpart of the JAX package's fixed-grid
    ``run_cosmological_rungs`` (both halves of the boundary force from one
    evaluation).

    Each global step assigns rungs from the displacement and acceleration
    demand, kicks the far field at the half-steps and kicks rung r at
    every 2^(n_rungs - 1 - r)-th of the n_sub = 2^(n_rungs - 1) sub-ticks
    (:func:`_rung_block_step`).  Interior sub-ticks evaluate the short
    force for the active rungs only: ``acc_short_masked_fn(pos, mass, act,
    a) -> (g, ov_source, ov_target, occupancy)`` (the two-plane cell
    kernel), or, with the six-function ``frozen_both_fns = (freeze_fn,
    both_frozen_fn, drift_ok_fn, masked_frozen_fn, stale_fn,
    fresh_plan_fn)``, the masked column kernel on the plan frozen at the
    last boundary (``masked_frozen_fn(..., buckets=True)`` returns its
    slot table, which the compact kicks of ``active_capacity > 0``
    gather).  Boundary ticks evaluate both halves at once
    (``acc_both_fn(pos, mass, a_s, a_l) -> (gs, gl, ov)``, or the
    frozen-plan forms, which refreeze when ``drift_ok_fn`` fails).  With
    the three-function ``frozen_both_fns`` (freeze, both_frozen,
    drift_ok) only the boundary rides the plan.

    The run starts with one evaluation at the state's positions, as the
    JAX package's scan does.  The step's rung histogram is read on the
    host once per step, and the frozen boundary reads its drift
    predicate once; every other quantity stays on the device until the
    end.

    Returns (final_state, boundary overflow, masked source overflow,
    target overflow (on the compact route: the active rows past
    ``active_capacity``), target occupancy, plan staleness, hists
    (n_steps, n_rungs) numpy): the channels heal different knobs.
    ``stats``, when given, receives the counts of boundary evaluations,
    interior evaluations, plan refreezes and host reads."""
    a_grid = np.asarray(a_grid, dtype=np.float64)
    n_steps = len(a_grid) - 1
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
    chans, n = _rung_chans(dev), _rung_counts()

    gs, gl, ov0, plan = _rung_start(pos, mass, float(a_grid[0]),
                                    acc_both_fn, frozen_both_fns)
    chans["ovb"] = _max_overflow(chans["ovb"], ov0)
    n["boundary_evals"] += 1

    hists = np.zeros((n_steps, n_rungs), dtype=np.int64)
    for i in range(n_steps):
        dla_i = _rung_demand(vel, gl, gs, a0s[i], cell_t, eta_t, acc_t,
                             H0, Om, OL)
        rung = _assign_rungs(dla_i, torch.log(a1s[i]) - torch.log(a0s[i]),
                             n_rungs)
        hists[i] = torch.bincount(rung, minlength=n_rungs).tolist()
        n["step_reads"] += 1
        tables = (float(a_grid[i + 1]), float(KL1[i]), float(KL2[i]),
                  Fk_d[i], Dr[i].tolist(), A_sub[i].tolist())
        pos, vel, gl, gs, plan = _rung_block_step(
            pos, vel, mass, gl, gs, rung, hists[i], tables, box=box,
            n_rungs=n_rungs, acc_both_fn=acc_both_fn,
            acc_short_masked_fn=acc_short_masked_fn,
            frozen_both_fns=frozen_both_fns, plan=plan,
            active_capacity=active_capacity, chans=chans, n=n)

    if stats is not None:
        stats.update(n)
    time = torch.as_tensor(float(a_grid[-1]), device=dev, dtype=dtype)
    final = state.replace(pos=pos, vel=vel, time=time)
    return (final, *_rung_channels(chans, n), hists)


# ---------------------------------------------------------------------------
# Adaptive stepping (CONCEPT's adaptive background step)
# ---------------------------------------------------------------------------

# 16-point Gauss-Legendre nodes and weights on [0, 1]: the kick and drift
# integrals of a step chosen at run time, evaluated on the device
_GL_X, _GL_W = np.polynomial.legendre.leggauss(16)
_GL_X = (_GL_X + 1.0) / 2.0
_GL_W = _GL_W / 2.0


@functools.lru_cache(maxsize=16)
def _gl_nodes(dtype, device):
    """The nodes and weights as tensors, one copy a device and dtype (an
    upload in every step would wait for the device)."""
    return (torch.as_tensor(_GL_X, dtype=dtype, device=device),
            torch.as_tensor(_GL_W, dtype=dtype, device=device))


def _gl_int(f, lo, hi):
    """Integral of f(a) da over [lo, hi] (tensors, broadcast) by the
    16-point Gauss-Legendre rule in ln a, in ``lo``'s dtype on its
    device."""
    x, w = _gl_nodes(lo.dtype, lo.device)
    lnl, lnh = torch.log(lo), torch.log(hi)
    a = torch.exp(lnl[..., None] + x * (lnh - lnl)[..., None])
    return (lnh - lnl) * torch.sum(w * f(a) * a, dim=-1)


def _hubble(H0: float, Om: float, OL: float):
    def H(a):
        return H0 * torch.sqrt(Om / a**3 + OL)

    return H


def _kick(H, lo, hi):
    """The kick factor int da / (a H) over [lo, hi]."""
    return _gl_int(lambda a: 1.0 / (a * H(a)), lo, hi)


def _drift(H, lo, hi):
    """The drift factor int da / (a^3 H) over [lo, hi]."""
    return _gl_int(lambda a: 1.0 / (a**3 * H(a)), lo, hi)


def _rung_tables_device(a0, a1, n_rungs: int, H0: float, Om: float,
                        OL: float):
    """The rung kick tables of one global step [a0, a1] (0-d tensors) on
    the device, in their dtype: (kl1, kl2, Fk (n_sub + 1, n_rungs), Dr
    (n_sub,), A_sub (n_sub,)), the layout of :func:`rung_kick_tables`
    for one step, by 16-point Gauss-Legendre in place of its trapezoid."""
    n_sub = 2 ** (n_rungs - 1)
    H = _hubble(H0, Om, OL)
    lnl, lnh = torch.log(a0), torch.log(a1)
    t = torch.exp(lnl + torch.arange(n_sub + 1, dtype=a0.dtype,
                                     device=a0.device) / n_sub * (lnh - lnl))
    Dr = _drift(H, t[:-1], t[1:])
    am = torch.sqrt(a0 * a1)
    kl1, kl2 = _kick(H, a0, am), _kick(H, am, a1)
    Fk = torch.zeros((n_sub + 1, n_rungs), dtype=a0.dtype, device=a0.device)
    for r in range(n_rungs):
        m = 2 ** (n_rungs - 1 - r)
        bounds = t[::m]
        bm = torch.sqrt(bounds[:-1] * bounds[1:])
        Fk[0:n_sub:m, r] += _kick(H, bounds[:-1], bm)
        Fk[m:n_sub + 1:m, r] += _kick(H, bm, bounds[1:])
    return kl1, kl2, Fk, Dr, t[1:]


def _step_end(a0, dla, a_end_t):
    """The step's end exp(ln a0 + dla), and a_end itself when the step is
    the rest of the way: the run then arrives at a_end exactly in the
    state's dtype (exp(ln a0 + ln a_end - ln a0) can land an ulp short,
    and a float32 time an ulp short of a_end would take another step)."""
    rem = torch.log(a_end_t) - torch.log(a0)
    return torch.where(dla >= rem, a_end_t, torch.exp(torch.log(a0) + dla))


def _host_read(*parts) -> list:
    """One host read of the step's numbers: the 0-d and 1-d tensors
    concatenated in float64 (exact for the state's float32 values and
    for counts)."""
    return torch.cat([x.reshape(-1).double() for x in parts]).tolist()


def _time_of(state: ParticleState):
    """(the state's time as a 0-d tensor of its dtype on its device, the
    same on the host)."""
    t = torch.as_tensor(state.time).to(device=state.pos.device,
                                       dtype=state.pos.dtype)
    return t, float(t)


def _end_of(a_end: float, like):
    """a_end in the state's dtype: (0-d tensor on its device, host)."""
    a_h = float(torch.tensor(float(a_end), dtype=like.dtype))
    return torch.full((), a_h, dtype=like.dtype, device=like.device), a_h


def make_adaptive_cosmo_runner(cosmo: Cosmology, acc_fn, box: float,
                               cell: float, *, dla_max: float = 0.03,
                               eta_disp: float = 0.25, n_rungs: int = 8,
                               split_fns=None, n_sub: int = 1,
                               acc_both_fn=None):
    """An adaptive KDK runner (the JAX package's
    ``make_adaptive_cosmo_runner``): each step takes a global Delta(ln a)

      dla = clip(min_i dla_i, dla_max / 2^(n_rungs - 1), dla_max),
      dla_i = eta_disp * cell * a^2 H(a) / |p_i|   (drift <= eta cell),

    and the last one ends exactly at a_end.  The kick and drift factors of
    the chosen step are 16-point Gauss-Legendre integrals on the device,
    in the state's dtype, as the JAX package computes them; the step, the
    factors and the rung histogram (rung r wants dla_max / 2^r) come to
    the host in one read a step, and the forces take the step's scale
    factors as host floats (the same float32 values).

    ``acc_fn(pos, mass, a) -> (g, overflow)``.  ``split_fns = (long_fn,
    short_fn)`` with ``n_sub > 1`` subcycles the short-range KDK n_sub
    times inside each chosen step, the far field kicking at its
    half-steps; ``acc_both_fn(pos, mass, a_short, a_long) -> (gs, gl,
    overflow)`` fuses the last subcycle's short force with the closing
    long force.

    Returns ``run(state, a_end, max_steps=None, stats=None) -> (state,
    n_steps, overflow, dla_last, rung_hist)``: it starts with an
    evaluation at the state's positions and steps until a_end, or
    ``max_steps`` steps (the caller's stretch); the overflow words are
    reduced on the device and read once, at the end.  ``stats`` receives
    the counts of evaluations by kind and of host reads."""
    H0, Om, OL = float(cosmo.H0), float(cosmo.Omega_m), float(cosmo.Omega_L)
    dla_floor = dla_max / 2 ** (n_rungs - 1)
    H = _hubble(H0, Om, OL)
    subcycled = split_fns is not None and n_sub > 1

    def run(state: ParticleState, a_end: float, max_steps: int | None = None,
            stats: dict | None = None):
        pos, vel, mass = state.pos, state.vel, state.mass
        t, t_h = _time_of(state)
        a_end_t, a_end_h = _end_of(a_end, pos)
        n = dict(evals=0, long_evals=0, short_evals=0, both_evals=0,
                 step_reads=0)
        if subcycled:
            long_fn, short_fn = split_fns
            gl = long_fn(pos, mass, t_h)
            gs, ov = short_fn(pos, mass, t_h)
            n["long_evals"] += 1
            n["short_evals"] += 1
        else:
            g, ov = acc_fn(pos, mass, t_h)
            n["evals"] += 1
        overflow = _max_overflow(None, ov)
        steps, dla_h, hist = 0, float(dla_max), [0] * n_rungs
        while t_h < a_end_h and (max_steps is None or steps < max_steps):
            speed = torch.linalg.vector_norm(vel, dim=-1)
            dla_i = eta_disp * cell * t**2 * H(t) / torch.clamp_min(speed,
                                                                    1e-30)
            dla = torch.minimum(torch.clamp(torch.min(dla_i), dla_floor,
                                            dla_max),
                                torch.log(a_end_t) - torch.log(t))
            a1 = _step_end(t, dla, a_end_t)
            rung = torch.clamp(torch.ceil(torch.log2(
                dla_max / torch.clamp_min(dla_i, 1e-30))), 0, n_rungs - 1)
            hist_t = torch.bincount(rung.to(torch.int64), minlength=n_rungs)
            am = torch.sqrt(t * a1)
            kl1, kl2 = _kick(H, t, am), _kick(H, am, a1)
            if subcycled:
                lnr = (torch.log(a1) - torch.log(t)) / n_sub
                js = torch.arange(n_sub, dtype=t.dtype, device=t.device)
                b0 = torch.exp(torch.log(t) + js * lnr)
                b1 = torch.exp(torch.log(t) + (js + 1) * lnr)
                bm = torch.sqrt(b0 * b1)
                sub = (b1, _kick(H, b0, bm), _drift(H, b0, b1),
                       _kick(H, bm, b1))
            else:
                sub = (_drift(H, t, a1),)
            vals = _host_read(dla, a1, kl1, kl2, *sub, hist_t)
            n["step_reads"] += 1
            dla_h, a1_h, k1, k2 = vals[:4]
            hist = [int(x) for x in vals[-n_rungs:]]
            if subcycled:
                b1s, ks1, drs, ks2 = (vals[4 + q * n_sub: 4 + (q + 1) * n_sub]
                                      for q in range(4))
                p = vel + gl * k1
                for j in range(n_sub):
                    p = p + gs * ks1[j]
                    pos = torch.remainder(pos + p * drs[j], box)
                    if acc_both_fn is not None and j == n_sub - 1:
                        gs, gl, o = acc_both_fn(pos, mass, b1s[j], a1_h)
                        n["both_evals"] += 1
                    else:
                        gs, o = short_fn(pos, mass, b1s[j])
                        n["short_evals"] += 1
                    overflow = _max_overflow(overflow, o)
                    p = p + gs * ks2[j]
                if acc_both_fn is None:
                    gl = long_fn(pos, mass, a1_h)
                    n["long_evals"] += 1
                vel = p + gl * k2
            else:
                p_half = vel + g * k1
                pos = torch.remainder(pos + p_half * vals[4], box)
                g, o = acc_fn(pos, mass, a1_h)
                n["evals"] += 1
                overflow = _max_overflow(overflow, o)
                vel = p_half + g * k2
            t, t_h = a1, a1_h
            steps += 1
        if stats is not None:
            stats.update(n)
        final = state.replace(pos=pos, vel=vel, time=t)
        return (final, steps, 0 if overflow is None else int(overflow),
                dla_h, hist)

    return run


def make_adaptive_rung_runner(cosmo: Cosmology, acc_both_fn,
                              acc_short_masked_fn, box: float, cell: float,
                              *, dla_max: float = 0.03,
                              eta_disp: float = 0.25, eta_acc: float = 0.025,
                              eps: float = 0.0, n_rungs: int = 3,
                              frozen_both_fns=None,
                              active_capacity: int = 0):
    """The adaptive global step composed with per-particle rungs (the JAX
    package's ``make_adaptive_rung_runner``, CONCEPT's integrator
    structure): each step takes the demand dla_i of
    :func:`run_cosmological_rungs` and the global step

        dla = min(dla_max, 2^(n_rungs - 1) min_i dla_i, ln a_end - ln a0),

    floored at 1e-8, so the deepest rung serves the fastest particle; the
    last step ends exactly at a_end.  The step's kick tables come from
    :func:`_rung_tables_device` in the state's dtype, and its body is
    :func:`_rung_block_step`, the fixed grid's, on both of its routes
    (the masked cell kernel, or the frozen plans of ``frozen_both_fns``
    with the compact kicks of ``active_capacity > 0``).  The chosen step,
    its tables and the rung histogram come to the host in one read a
    step; the frozen boundary adds its read of the drift predicate.

    Returns ``run(state, a_end, max_steps=None, stats=None) -> (state,
    n_steps, overflow_boundary, overflow_masked_source, overflow_target,
    occupancy_target, plan_stale, dla_last, rung_hist)`` with the
    channels of :func:`run_cosmological_rungs`, read once at the end.  A
    call starts with an evaluation at the state's positions (and a fresh
    plan) and steps until a_end, or ``max_steps`` steps."""
    H0, Om, OL = float(cosmo.H0), float(cosmo.Omega_m), float(cosmo.Omega_L)
    depth = float(2 ** (n_rungs - 1))
    n_sub = 2 ** (n_rungs - 1)

    def run(state: ParticleState, a_end: float, max_steps: int | None = None,
            stats: dict | None = None):
        pos, vel, mass = state.pos, state.vel, state.mass
        dev, dtype = pos.device, pos.dtype

        def dev_t(x):
            return torch.full((), float(x), dtype=dtype, device=dev)

        t, t_h = _time_of(state)
        a_end_t, a_end_h = _end_of(a_end, pos)
        cell_t, eta_t, dla_max_t = dev_t(cell), dev_t(eta_disp), dev_t(dla_max)
        acc_t = dev_t(2.0 * eta_acc * eps) if eta_acc * eps > 0 else None
        chans, n = _rung_chans(dev), _rung_counts()
        gs, gl, ov0, plan = _rung_start(pos, mass, t_h, acc_both_fn,
                                        frozen_both_fns)
        chans["ovb"] = _max_overflow(chans["ovb"], ov0)
        n["boundary_evals"] += 1
        steps, dla_h, hist = 0, float(dla_max), [0] * n_rungs
        while t_h < a_end_h and (max_steps is None or steps < max_steps):
            dla_i = _rung_demand(vel, gl, gs, t, cell_t, eta_t, acc_t,
                                 H0, Om, OL)
            dla = torch.minimum(
                torch.minimum(dla_max_t, depth * torch.min(dla_i)),
                torch.log(a_end_t) - torch.log(t))
            dla = torch.clamp_min(dla, 1e-8)
            a1 = _step_end(t, dla, a_end_t)
            kl1, kl2, Fk, Dr, A_sub = _rung_tables_device(t, a1, n_rungs,
                                                          H0, Om, OL)
            rung = _assign_rungs(dla_i, dla, n_rungs)
            hist_t = torch.bincount(rung, minlength=n_rungs)
            vals = _host_read(dla, a1, kl1, kl2, Dr, A_sub, hist_t)
            n["step_reads"] += 1
            dla_h, a1_h = vals[0], vals[1]
            hist = [int(x) for x in vals[4 + 2 * n_sub:]]
            tables = (a1_h, vals[2], vals[3], Fk, vals[4:4 + n_sub],
                      vals[4 + n_sub:4 + 2 * n_sub])
            pos, vel, gl, gs, plan = _rung_block_step(
                pos, vel, mass, gl, gs, rung, hist, tables, box=box,
                n_rungs=n_rungs, acc_both_fn=acc_both_fn,
                acc_short_masked_fn=acc_short_masked_fn,
                frozen_both_fns=frozen_both_fns, plan=plan,
                active_capacity=active_capacity, chans=chans, n=n)
            t, t_h = a1, a1_h
            steps += 1
        if stats is not None:
            stats.update(n)
        final = state.replace(pos=pos, vel=vel, time=t)
        return (final, steps, *_rung_channels(chans, n), dla_h, hist)

    return run
