"""Quickest proof that the torch port runs its main paths on one GPU.

    python3 chip_smoke.py

Phases, each on a line of its own; the first that fails raises and the
script exits non-zero:

1. a CUDA card is present; print its name and power limit;
2. build the CUDA kernel library from the sources in this checkout;
3. K1 (the short-range P3M pair sum: a Hilbert sort, a tile cull)
   against its plain PyTorch version in float64, on the card, at the
   default run's shape (N = 32,768 uniform, box 500 Mpc, mesh 64), for
   all four split x softening variants: relative L2 and per target
   (``target_err`` within TARGET_TOL), two launches equal bit for bit,
   the cull narrowed by r_cut/2 (``scripts/torch_k1_ablation.py``'s
   planted ``narrowed`` variant, built in phase 2 with its ``original``,
   the kernel before its redesign) above the per-target limit, the
   original timed beside it, the visits the cull leaves against the
   dense count, with both times;
4. the wrappers' argument checks raise on the card (K1-K4);
5. the default ``SimulationConfig()`` run (32^3 particles, P3M dense tier,
   142 steps) through ``nbody_torch.driver.simulate.run_simulation`` on
   the card, with K1's launch count, wall time and steps/s (no snapshot:
   it needs h5py); then K1 on the run's final (clustered) state with
   [3]'s gates;
6. the 16^3 run from the JAX package's committed white noise, whose P(k)
   at a = 1 must match the JAX package's committed P(k);
7. K2 (supercell deposit; here and in phases 11 and 19 two launches
   equal bit for bit) and K3 (fused PM readback + column pair sum,
   plain, interlaced and split_out) against their plain versions on the
   supercell tier's plane of the 64^3 production run, and K4 (column pair
   sum) on its columns tier's plane: on the ICs at the geometry each run
   starts from (the driver's own pre-warm and heal rules), and again on
   the final state of each run of phase 9 at its healed geometry.  Here
   and in phases 11, 19 and 20, K3, K4 and K5 are also held per target
   (``target_err`` within TARGET_TOL), two launches must be equal bit
   for bit, the reach narrowed by r_cut/2 (``scripts/
   torch_columns_ablation.py``'s planted ``narrowed`` variant, built in
   phase 2 with its ``original``, the design before the redesign) must
   fail the per-target gate, and the original is timed beside the
   kernel on the same plane;
8. the supercell, columns, cells and dense tiers of ``p3m_acc`` agree at
   the 64^3 ICs;
9. the 64^3 production run (``cfg64``: 64^3 particles, box 500 Mpc, mesh
   128, 142 steps, spline softening; the supercell tier) through
   ``run_simulation`` with no device argument, with its pre-warms, heals,
   K2/K3 launch counts, wall time and steps/s; then the same run on the
   columns tier (``shortrange='columns'``), which launches K4;
10. the 16^3 supercell run from the committed white noise against the
    JAX package's committed supercell P(k);
11. K6 (the cell-pair sum, one-plane and two-plane) against its float64
    plain version on the 32^3 ICs, a late 32^3 state and the 64^3 ICs,
    the targets of the two-plane form the particles above rung 0 at the
    rung runs' final states; at each K6 site here and in [19]-[21]
    (``k6_check``): relative L2, per target (``target_err`` within
    TARGET_TOL), two launches equal bit for bit, the neighbourhood with a
    neighbour cell left out (``scripts/torch_k6_ablation.py``'s planted
    ``narrowed`` variant, built in phase 2 with its ``original``, the
    kernel before its redesign) above the per-target limit, and at the
    timed launches the call, the kernel alone, the original beside them,
    the dense visits, lane slots and pairs inside r_cut; K5 (the masked column pair sum) on the cfg64 plan
    frozen at the ICs, at the ICs and at drift skin/2, and with every
    chunk listed against K4; K2 and K3 on the frozen plane at skin/2
    against their plain versions and a fresh evaluation, and a planted
    wrong wrap of K2's that the same check must catch;
12. the default 32^3 config with ``rungs=3`` (K1 at the boundary ticks,
    K6 at the interior ticks) and
13. cfg64 with ``rungs=3`` (frozen column plans: K2 + K3 at the boundary
    ticks, K5 at the interior ticks), each through ``run_simulation``
    with launch counts equal to those counted from run.log;
14. the 16^3 rung runs (dense and supercell, a = 0.3 to 1 in 6 steps)
    from the committed white noise against the JAX package's P(k) and
    per-step rung populations;
15. K7 (the all-pairs kernel, ``allpairs_pallas`` and
    ``block_acc_pallas``) against its float64 plain version and the
    dense oracles at N = 2, 1,000 and 32,768 with and without a box, at
    3,001 targets against 5,000 sources, and its float64 form on the
    Kepler pair and through the Kepler and solar-system drives against
    the same drives on the CPU; its launch shape at N = 262,144 (R, S,
    resident blocks) with two launches equal bit for bit, one launch
    against K7's design before its redesign for Hopper (built in this run
    by ``scripts/torch_k7_ablation.py`` as its ``original`` variant), and
    its time there;
16. the Ewald PP force (K1 with the Gaussian split plus the k-space sum)
    at the 32^3 ICs in float32 against float64, K1 alone there with
    [3]'s gates (r_cut 0.4999 box: the sources in slices), the default
    ``SimulationConfig(solver='pp')`` run through ``run_simulation`` with
    K1's launch count, and the 16^3 PP run from the committed white noise
    against the JAX package's P(k);
17. ``plummer(4096)`` over 200 steps against the JAX package's committed
    energy and momentum series, then the Plummer drive at N = 262,144
    (``run_with_diagnostics``, 250 steps, dt 1e-3, eps 0.05) with its
    energy and momentum gates, K7's launch count, steps/s and
    interactions/s;
18. K8 (the Gram-form all-pairs kernel, ``allpairs_pallas_mxu``) against
    its float64 plain version at N = 200, 1,500 and 32,768, sorted and
    unsorted, and its wrapper's refusals; at the JAX package's own bench
    conditions (``scripts/exp_mxu.py``: N = 2^18 uniform in a 500 box) its
    launch's and its function's time beside K7's, and its error against
    K7's float64 form at 2^15 and 2^18; then the Plummer drive of [17]
    with K8 as its force (251 K8 launches, no other kernel).

19. the slab domain decomposition, four shards on the one card: (a) the
    slab sites of K2 (its haloed slab after the halo exchange, with a
    planted unsent halo plane that must fail the check), K3 (plain,
    interlaced, split_out) and K4 on every shard's plane of the cfg64
    ICs, and K6 on the 32^3 ICs and the default run's final state, each
    at the domain driver's geometry, against their plain versions; (b) the domain force of the supercell,
    columns and cells tiers against the single-device force of the same
    tier, per particle within the JAX package's limits; (c) cfg64 (the
    supercell tier), cfg64 with ``shortrange='columns'`` and the default
    32^3 config (the cells tier) with ``devices=4`` through
    ``run_simulation`` with no device argument: the slab sites' launches
    equal 4 x the force evaluations counted from run.log, and P(k) at
    a = 1 matches the single-device run of [5] / [9], with wall time,
    steps/s, heals and peak device memory beside the single-device run's
    (P(k) in three bands of k, see DOMAIN_PK_BANDS);
    (d) the 16^3 domain runs (cells on 2 and 4 shards, supercell and
    columns on 4) from the committed white noise against the JAX
    package's committed domain P(k);
20. rungs on the slab domain decomposition, four shards on the one card:
    (d) cfg64 and the default config with ``devices=4, rungs=3`` (frozen
    local column plans, K5's slab site, until a staleness heal at the
    skin's ceiling moves the interior ticks to the masked cell planes)
    and the default config with ``column_skin=0`` (K6's two-plane slab
    site) through ``run_simulation`` with no device argument: K5's and
    K6's launches equal those counted from run.log, P(k) at a = 1 in
    DOMAIN_PK_BANDS and the rung populations at a = 1 within
    DOMAIN_POP_TOL of the single-device rung runs of [13] / [12], with
    wall time, steps/s, heals, plan freezes, peak device memory, the
    route each run finished on and its stale_max; (a) K5's slab site on
    every shard's frozen plan of the cfg64 run's final state (undrifted
    and at 0.999 skin/2) and (b) K6's masked slab site on the 32^3 cell
    run's final state, each at the driver's geometry against its float64
    plain version, and K6's on the 32^3 ICs with that state's active
    set; (c) the two hazards planted: a massive particle
    outside its shard's slab raises its plan's word and the rung
    runner's plan channel, a drift past skin/2 is counted by
    local_plan_stale, and both read 0 when sound; (e) the 16^3 domain
    rung runs (2 and 4 shards on frozen plans, 4 on the cell planes)
    from the committed white noise against the JAX package's P(k) and
    rung populations.
21. the ring and replicated-grid forces of ``nbody_torch.distributed.
    sharding``, four shards on the one card: (a) K7's ring site: the ring
    force of plummer(262,144) against the single-device K7 and float64,
    one ring launch against its plain version, its launch shape with two
    launches equal bit for bit and against the design before the
    redesign, as in [15], and 100 steps of [17]'s
    drive through the ring (K7 launches = 16 x 101, [17]'s energy and
    momentum limits); (b) K6's replicated-grid site: every shard's x-slab
    of the whole cell plane at the cfg64 ICs (and at the final state of
    one device's cfg64 cells run) against the plain version,
    the sharded P3M against one device's cells tier (at the ICs to
    TIER_TOL, per particle on random positions) and at the JAX package's
    16^3 ICs against its committed output; cfg64's 142 steps through
    ``run_cosmological_checked`` with the checked force,
    healing by doubling the capacity (K6 launches = 4 x evaluations, P(k)
    at a = 1 within DOMAIN_PK_BANDS of one device's cells run); (c)
    ``solver='pp'`` with ``devices=4`` through ``run_simulation`` with no
    device argument (the ring Ewald force against one device's at the
    32^3 ICs, P(k) against [16]'s run, no kernel launched) and the 16^3
    run against the JAX package's P(k); (d) a planted capacity of 8 must
    report dropped particles.
22. the subcycled KDK and the slab-resident ICs: (a) ``lpt_ic_domain``
    on four shards of the card from the JAX package's committed per-slab
    noise (16^3, orders 1 and 2) against its committed ICs row for row,
    and ``realized_spectrum_domain`` of the same noise against its
    committed table; (b) ``scripts/parity_study.py``'s cfg64 with
    ``subcycles=4`` (its measurement options, the default transfer
    function) and the default 32^3 config with ``subcycles=4`` through
    ``run_simulation`` with no device argument: launches equal to the
    evaluations counted from run.log (cfg64: K2 = K3 = the fused boundary
    evaluations on the carried plan, K4 = the interior subcycles on it;
    32^3: K1 = both), the plan refreezes and host reads of the drift
    predicate; (c) K4 at its frozen site on the plan the driver carries,
    at the cfg64-sub4 ICs and final state drifted to 0.999 skin/2, with
    [7]'s gates; (d) cfg64-sub4 with ``devices=4, ic_realization=
    'domain'``: no IC exchange overflow, the slab sites' launches (K2 =
    K3 = 4 x the fused evaluations, K4 = 4 x the short ones) equal to the
    evaluations counted; (e) the 16^3 subcycled runs (dense, supercell,
    supercell on four shards) from the committed noise against the JAX
    package's committed P(k).
23. adaptive time stepping, after the deterministic CIC deposit: (0)
    ``cic_deposit`` (the fixed-point ``scatter_sum``) bit for bit over two
    calls and against its float64 form to DEPOSIT_TOL at the default
    32^3 ICs (mesh 64) and the cfg64 ICs (mesh 128), timed beside the
    ``index_add_`` form it replaced; (a) the 16^3 adaptive runs (plain,
    ``subcycles=4``, ``rungs=3``, ``rungs=2`` on four shards) from the
    committed noise through ``run_simulation`` with no device argument,
    against the JAX package's committed P(k) (PK_REL_TOL) and its total
    adaptive steps (equal) and "dln(a)" lines; (b) the committed adaptive
    64^3 config (``tests/data/parity/adaptive/config.json``, the default
    transfer function) plain, with ``rungs=3`` and with ``subcycles=4``:
    the final time a_end itself, the step trace, the wall, and launches
    equal to the evaluations of run.log's summary, which must equal the
    counts from its stretches, steps and heals; (c) the rung run with the
    compact active-row kicks (``rung_active_capacity=COMPACT_CAPACITY``,
    N / 8) beside (b)'s, both walls, each from no capacity learned in
    the process (``forget_capacities``): the final state and the P(k)
    file equal (b)'s bit for bit; the plain run of (b) is made twice so,
    with the same steps, final state and P(k) bits (K2's sums are exact,
    so the supercell runs repeat); (d) (b)'s rung run on four shards of
    the card:
    K6 = 4 x the boundary and masked evaluations, P(k) within
    DOMAIN_PK_BANDS of (b)'s rung run.
24. the ensemble (the reference's NN-data pipeline, the JAX package's
    ``vmap`` tier): (b) ``run_ensemble(SimulationConfig() without
    snapshots, 8, A_s_values=draw_A_s(8), batch=8)``: no member failed
    and K1 launched n_steps + 1 times for the chunk, then each member
    through ``run_simulation(member, base=config)`` (8 x n_steps + 1),
    every member's final positions (``run_members_batched``) within
    ENSEMBLE_POS_TOL and its P(k) within ENSEMBLE_PK_TOL of its
    sequential run, with both walls; (a) K1's batched site (one launch
    over the 8 members) at their ICs and final states against its
    float64 plain version (relative L2, per target) and each member equal
    bit for bit to its own launch, timed beside the 8 single launches;
    (d) ``benchmark_fn`` on the batched call and a ``trace`` of one
    ensemble step that names the K1 kernel; the analysis port with no
    figure (``ensemble_scatter`` over the pipeline's P(k) files,
    ``density_projection`` bit for bit over two calls,
    ``compare_solver_spectra`` at 16^3); (c) the committed 16^3
    ensemble (4 members, the JAX noise) through ``run_members_batched``
    against the JAX package's P(k) to PK_REL_TOL.
25. the batched tier on the plane tiers and PP: (a) the repair of the
    column sums' dependence on the capacity
    (``scripts/torch_capacity_bits.py``): K2's mass grid and K3's and
    K4's per-particle sums at cfg64's ICs, K5's at cfg64-rungs3's final
    state and K6's, each at the driver's capacity and at twice it, equal
    bit for bit; cfg64 run twice in one process, the second from the
    capacities the first learned (no ``forget_capacities()`` between):
    the same steps, final state and P(k) file; (b) each batched site over
    B members (K2 and K3 at 8 members' cfg64 ICs, K4 and K6 at 4 members'
    32^3 ICs on the columns and cells tiers, K1's Ewald site at the
    same): one launch, two launches equal bit for bit, each member equal
    bit for bit to its own launch, against the float64 plain version (K2
    to NODE_MASS_TOL of the largest node, the sums to FORCE_REL_L2_TOL
    and TARGET_TOL), timed beside the B single launches; (c)
    cfg64-ensemble8 (``run_ensemble(cfg64, 8, batch=8)``, A_s from
    ``draw_A_s(8)``) against its sequential tier; (d) 4 members of the
    default 32^3 config on the columns, cells and PP tiers against their
    sequential tiers: every member's final state and P(k) file equal bit
    for bit to its sequential run's, K2 + K3 (K4, K6, K1) launched once
    an evaluation, both walls and the heals.
26. the emulator (the 3D CNN, its datasets, ``fit`` and the MC-dropout
    ``evaluate_uq``) on the card through its entry points, with no
    device argument: (a) ``scripts/torch_emulator_scale.py``'s protocol
    (200 train/val volumes of 32^3 from ``create_linear_dataset``, 100
    test volumes, read back by the native loader; ``fit`` of
    ``CosmoCNN(n_out=1, n_conv=2)`` at batch 16, lr 4e-3 with
    augmentation for EMULATOR_EPOCHS; ``evaluate_uq`` with 50 passes):
    the walls, ms a step, the A_s abs deviation (EMULATOR_DEV_TOL), the
    1/2/3-sigma coverage (3 sigma: EMULATOR_COV3) and the MC sigma
    against the JAX package's float32 loop on the same volumes: the
    card's ``evaluate_uq`` of that loop's weights to JAX's
    (EMULATOR_SIGMA_TOL) and the card's fit's sigma to the loop's
    (EMULATOR_SIGMA_FACTOR); (b) the simulation source without HDF5:
    ``create_simulation_dataset`` runs 8 + 4 members of
    ``PipelineConfig().sim_config()`` (32^3, P3M, 142 steps) through
    ``run_ensemble``'s batched tier, each split one chunk (K1's batched
    site: 143 launches a split), and ``state_to_delta`` of each final
    state in memory, every
    volume finite with |mean delta| < 1e-5, then ``run_experiment``
    ('SIM3', 20 epochs, no figure) whose train loss must fall; (c) the
    card's float32 model against its float64 version on the CPU with the
    fixture's weights at 32^3, batch 4 (the outputs and one step's
    gradients to EMULATOR_F64_TOL), two forwards with dropout from one
    seed bit for bit, and two 3-epoch fits of one seed (where they part,
    if they do); (d) the committed 16^3 fixture's 3-epoch fit against
    the JAX package's ``_fit_host_loop`` history
    (EMULATOR_HISTORY_TOL).

Phases 12 and 13 run before 11, which takes its active sets from their
final states.  The line before the last but one is a JSON object of the
kernels (launches from the run of each kernel's path, errors and times
from phases 3, 7, 11, 15, 16, 18, 19, 20, 21, 22, 24 and 25, and each kernel's
bound:
the larger of the bytes the function needs over the card's memory rate
and its operations over its float32 rate, for K8 its rsqrts over the SFU's rate
and its TF32 products over the tensor cores'); then the card's name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  Run outputs go to
``output/chip_smoke/`` (git-ignored).
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "output", "chip_smoke")
PORT_DATA = os.path.join(ROOT, "tests", "data", "torch_port")

# K1 against its float64 plain version: relative L2 error over all
# targets.  float32 positions, r^2 and rsqrtf (2 ulp) with ~100 pairs
# inside r_cut per target give a few 1e-7..1e-6; 1e-4 leaves room for
# the pairs' partial cancellation while catching a wrong pair set or
# weight (a single missing neighbour is an O(1e-2) error).  K3 and K4
# sum the same pairs from a float32 plane and K3 adds a float32 CIC read
# of the force grids, so the same reasoning and bound hold.
# [15] K7 reads 1e-7-3e-6 against float64 (sums of 128-source tiles added
# tile by tile).  [16] the float32 Ewald force reads 5.0e-5 at the 32^3
# ICs, where the real-space sum reaches every minimum image within 0.4999
# box and cancels: the float32 separations and weights, not the order of
# the kernel's sums, set it (K1's plain float32 version reads 7e-5 on a
# subset of targets); the k-space half alone 2.1e-5.  TF32 in the k-space
# products (~3e-4 of each phase) would read far above the limit.
K1_REL_L2_TOL = 1e-4
FORCE_REL_L2_TOL = 1e-4
# K3, K4 and K5 per target (target_err): the largest |got - ref| of an
# output plane's slots over the RMS force of its targets, against the
# float64 plain version.  The relative L2 over 262,144 targets cannot see
# one dropped pair, an O(1e-2) error on one target.
TARGET_TOL = 1e-3
# K2 against its float32 plain version (the same coordinates, rounded op
# by op): only the order of the float32 sums differs, the kernel's adds
# being atomic; relative to the largest node mass
NODE_MASS_TOL = 1e-5
# K2 on a frozen plane against K2 on a fresh plane of the same
# positions: the frozen plane holds a particle that drifted across the
# box edge at its unwrapped coordinate (near 0) and the fresh one at its
# wrapped coordinate (near the box side, where one float32 ulp is 3e-5
# Mpc, 8e-6 mesh cells at 128^3 in 500 Mpc), so their CIC weights differ
# by up to ~1e-5; relative to the largest node mass.  A wrong wrap moves
# whole particle masses: phase 11 plants one (a particle's corners left
# off the mesh) and requires it to read above this limit.
FROZEN_NODE_TOL = 1e-4
# the three tiers at the 64^3 ICs: max |difference| / max |acc|, the JAX
# package's tier-vs-tier tolerance (tests/test_supercell.py)
TIER_TOL = 2e-5
# 16^3 runs from the JAX noise: float32 on the card against the JAX
# package's float32 CPU run over 142 steps, bin by bin for
# k <= k_Nyquist/2 of the PM mesh.  The two agree to a few 1e-6 (on a
# CPU and on the card); 1e-3 leaves that two orders of magnitude for
# summation order (atomic CIC deposits, cuFFT) while a wrong force,
# step or measurement moves P(k) by far more.
PK_REL_TOL = 1e-3

# K7 in float64 against the float64 plain version and oracles: only the
# order of the sums differs
F64_REL_TOL = 1e-12
# the Kepler and solar-system drives through the float64 K7 on the card
# against the same drives through the plain version on the CPU, relative
# to the largest position: float64 summation order, grown over the drive
F64_DRIVE_TOL = 1e-9
# [17] the Plummer drive at N = 262,144 over 250 steps: |dE/E|.  The JAX
# package's canonical drive (plummer(4096), 200 steps) expects < 1e-5 and
# its float32 run of the same protocol on a TPU read 4.2e-7 over 10,000
# steps (tests/data/energy_10k.json); a wrong potential or a force that is
# not the gradient of that potential drifts by far more
PLUMMER_DRIFT_TOL = 1e-5
# |total momentum| over sum m |v|: float32 rounding of the forces and of
# the reduction leaves ~1e-8 (the committed JAX series of plummer(4096)
# reads 5.7e-9 absolute); forces that are not pairwise antisymmetric (a
# missing or doubled source tile) break it by orders of magnitude more
MOMENTUM_TOL = 1e-6
# the plummer(4096) energy series against the JAX package's committed
# float32 series, every 25 steps over 200: |E_kin|, |E_pot| and |E|
# differences over |E_0|.  Both are float32 (rsqrt and sums in another
# order), so the series differ by ~1e-7-1e-6 of |E_0|; a wrong G, softening
# or self-term moves E_pot by 1e-3 or more; momentum differences are held
# to 1e-7 absolute (both series read ~1e-9)
SERIES_E_TOL = 1e-5
SERIES_P_TOL = 1e-7

# [18] K8 against float64: the JAX package's float32 envelope for this
# kernel (tests/test_forces.py::test_mxu_matches_exact_kernel_f32), per
# particle relative force error: the median below 1e-4 (the 3xTF32 Gram
# r^2 keeps ~22 bits, and a typical particle reads ~1e-6) and the largest
# below 1e-2 (a pair much closer together than to its tile centre is where
# the Gram form loses accuracy); a one-pass TF32 Gram reads a median above
# the limit (tests/test_torch_mxu.py plants one); E_pot, a sum of positive
# terms, to 1e-5
K8_MEDIAN_TOL = 1e-4
K8_MAX_TOL = 1e-2
K8_EPOT_TOL = 1e-5
# [18] the Plummer drive through K8: |dE/E| < 1e-4 over the run, the
# repo's energy contract (BASELINE.json); the momentum limit is [17]'s
K8_DRIFT_TOL = 1e-4

# The card's published peaks (NVIDIA H100 SXM data sheet, dense, at the
# 700 W limit): float32 outside the tensor cores, TF32 on the tensor
# cores and device memory; and the SFU's rsqrt rate of sm_90 (the CUDA
# programming guide's throughput table), scaled by the SM clock.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
RSQRT_PER_CLOCK_SM = 16
# float32 operations per source visit (an FMA counts 2): 3 differences +
# r^2 (5) + the cutoff test (2), the minimum image taken once a column (the
# column kernels) or a tile (K1) and not a pair; and the weight of a visit
# inside r_cut (rsqrt, the split and softening polynomials, the mass and
# three FMAs).
FLOPS_VISIT_COLUMNS = 10
FLOPS_INSIDE = 40
# K7: the JAX package's cost estimate for one pair (pallas_pp.py:136)
FLOPS_PAIR_K7 = 20
# K8's Gram r^2 on the tensor cores: two m16n8k8 products (2 x 1,024
# multiply-adds) for each 16 x 8 block of pairs
FLOPS_PAIR_K8_TC = 32
# K2: the coordinates (3 x multiply, 2 subtractions), floors and
# fractions, and 8 corner weights and adds
FLOPS_DEPOSIT = 50
# K3's PM read per target: 8 corners x (weight + 3 FMAs)
FLOPS_PM_READ = 8 * 8
# rung populations of the 16^3 runs against the JAX package's, at every
# step and rung: a fraction of N.  float32 on the card against float32 on
# the JAX package's CPU; a particle near a rung boundary may land on the
# other side of it (20 of the 4,096 particles), a wrong rung rule moves
# hundreds
POP_TOL = 0.005
#: the Plummer drive's particle count: the JAX package's energy protocol
#: (scripts/energy_10k.py) and bench.py's exact all-pairs size
PLUMMER_N = 262144


#: {phase number: seconds}: the time from one phase line to the next,
#: counted to the phase whose line ends it
PHASE_S: dict[int, float] = {}
START = time.perf_counter()
_LAST_LINE = [START]


def phase(msg: str) -> None:
    tag = re.match(r"\[(\d+)\]", msg)
    if tag:
        now = time.perf_counter()
        key = int(tag.group(1))
        PHASE_S[key] = PHASE_S.get(key, 0.0) + now - _LAST_LINE[0]
        _LAST_LINE[0] = now
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up
    call unless ``warm`` is false."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least ms the card could take, what sets it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_l2(got, ref) -> float:
    return float((got.double() - ref).norm() / ref.norm())


def max_abs(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max())


def target_err(got, ref) -> float:
    """The largest per-target error of a column kernel's output plane: the
    largest |got - ref| over its slots (rows 0-5, the force and a split-off
    PM force, as one vector) over the RMS of |ref| over the slots where it
    is nonzero."""
    d = (got[:6].double() - ref[:6].double()).norm(dim=0)
    r = ref[:6].double().norm(dim=0)
    return float(d.max()) / float(r[r > 0].square().mean().sqrt())


def _columns_variants() -> dict:
    """{name: library} of ``scripts/torch_columns_ablation.py``'s
    ``original`` (the column kernels' design before their redesign for
    Hopper) and ``narrowed`` (the reach cut by r_cut / 2, a planted fault)
    variants, built in this run."""
    if not hasattr(_columns_variants, "libs"):
        abl = _ablation("torch_columns_ablation")
        _columns_variants.libs = {
            name: lib for name, (lib, _) in abl.load_variants(
                ["original", "narrowed"]).items()}
    return _columns_variants.libs


def _k1_variants():
    """``scripts/torch_k1_ablation.py`` (the module) and {name: library} of
    its ``original`` (K1 before its redesign for Hopper) and ``narrowed``
    (the cull's reach cut by r_cut / 2, a planted fault) variants, built
    in this run."""
    if not hasattr(_k1_variants, "libs"):
        abl = _ablation("torch_k1_ablation")
        _k1_variants.abl = abl
        _k1_variants.libs = {name: lib for name, (lib, _) in
                             abl.load_variants(["original",
                                                "narrowed"]).items()}
    return _k1_variants.abl, _k1_variants.libs


def k1_check(tag: str, pos, mass, args, reps: int) -> dict:
    """K1 at one site: relative L2 (K1_REL_L2_TOL) and per-target error
    (TARGET_TOL) against the float64 plain version, two launches equal bit
    for bit, the planted narrowed cull above TARGET_TOL, the design before
    the redesign within K1_REL_L2_TOL and timed beside it; the visits of
    the cull (``k1_plan`` at the launch's targets a thread and tile)
    against the dense N x npad, and the bound of the work these inputs
    need: the pairs inside r_cut x (FLOPS_VISIT_COLUMNS + FLOPS_INSIDE)
    operations (a pair's visit without a minimum image, which the kernel
    takes once a tile), 16 bytes a source and 12 a target.  Checks that
    the kernel library's cull reach is ``k1_reach``'s, the CPU model of
    the plan.  Returns the numbers of the kernels line."""
    import ctypes

    from nbody_torch._kernels import load_library
    from nbody_torch.forces.p3m import (
        k1_card_geometry,
        k1_plan,
        k1_reach,
        k1_visits,
        p3m_short_acc,
        p3m_short_plain,
    )

    box, eps, r_s, r_cut, G, split, soft = args
    abl, libs = _k1_variants()
    got = p3m_short_acc(pos, mass, *args)
    again = p3m_short_acc(pos, mass, *args)
    torch.cuda.synchronize()
    ref = p3m_short_plain(pos.double(), mass.double(), *args)
    rel, err = rel_l2(got, ref), target_err(got.T, ref.T)
    same = torch.equal(got, again)
    planted = target_err(abl.variant_acc("narrowed", libs["narrowed"], pos,
                                         mass, *args).T, ref.T)
    orig = lambda: abl.variant_acc("original", libs["original"], pos, mass,
                                   *args)
    orig_rel = rel_l2(orig(), ref)
    ms = cuda_time_ms(lambda: p3m_short_acc(pos, mass, *args), reps)
    o_ms = cuda_time_ms(orig, max(2, reps // 10))
    plain_ms = cuda_time_ms(lambda: p3m_short_plain(pos, mass, *args), 2)
    geo = k1_card_geometry(pos, box, r_cut, split, soft)
    plan = k1_plan(pos, mass, box, r_cut)
    reach = (ctypes.c_double * 1)()
    if load_library().p3m_short_reach(box, r_cut, reach) != 0 or \
            reach[0] != k1_reach(box, r_cut):
        raise AssertionError(f"{tag}: the library's cull reach {reach[0]} "
                             f"is not k1_reach's {k1_reach(box, r_cut)}")
    n = pos.shape[0]
    dense = n * (-(-n // 128) * 128)
    visits = k1_visits(plan)
    inside = count_inside_dense(pos, box, r_cut)
    b_ms, b_by = bound(16 * n + 12 * n,
                       inside * (FLOPS_VISIT_COLUMNS + FLOPS_INSIDE))
    phase(f"{tag}: rel L2 {rel:.3e} (tol {K1_REL_L2_TOL:g}), per-target "
          f"error {err:.3e} (tol {TARGET_TOL:g}); two launches "
          f"{'equal bit for bit' if same else 'DIFFERENT'}; the planted cull "
          f"narrowed by r_cut/2 {planted:.3e} (must exceed the tol); kernel "
          f"{ms:.4f} ms ({geo.groups} x {geo.slices} blocks), plain f32 {plain_ms:.3f} "
          f"ms; the design before the redesign (scripts/"
          f"torch_k1_ablation.py's original, built in this run) {o_ms:.4f} "
          f"ms ({o_ms / ms:.2f}x), rel L2 {orig_rel:.3e}; visits "
          f"{visits:.4e} of the dense {dense:.4e} ({visits / dense:.4f}), "
          f"{inside:.4e} pairs inside r_cut; bound {b_ms:.4f} ms ({b_by}) "
          f"from the pairs inside")
    if not rel <= K1_REL_L2_TOL:
        raise AssertionError(f"{tag}: K1 disagrees: {rel}")
    if not err <= TARGET_TOL:
        raise AssertionError(f"{tag}: a target's force is off by {err}")
    if not same:
        raise AssertionError(f"{tag}: two launches differ")
    if not planted > TARGET_TOL:
        raise AssertionError(f"{tag}: the per-target gate missed the "
                             f"narrowed cull ({planted})")
    if not orig_rel <= K1_REL_L2_TOL:
        raise AssertionError(f"{tag}: the design before the redesign "
                             f"disagrees: {orig_rel}")
    return dict(max_abs_err=max_abs(got, ref), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def column_gates(tag: str, got: list, ref: list, again, variant) -> float:
    """The gates of a K3/K4/K5 site beyond relative L2, on one output plane
    a shard: the per-target error of ``got`` against the float64 plain
    version ``ref`` within TARGET_TOL, a second launch (``again()``) equal
    to ``got`` bit for bit, and the planted narrowed reach
    (``variant("narrowed")``) above TARGET_TOL.  Returns the per-target
    error."""
    err = max(target_err(g, r) for g, r in zip(got, ref))
    same = all(torch.equal(g, a) for g, a in zip(got, again()))
    planted = max(target_err(n, r) for n, r in zip(variant("narrowed"), ref))
    phase(f"{tag}: per-target error {err:.3e} (tol {TARGET_TOL:g}); two "
          f"launches {'equal bit for bit' if same else 'DIFFERENT'}; the "
          f"planted reach narrowed by r_cut/2 {planted:.3e} (must exceed "
          f"the tol)")
    if not err <= TARGET_TOL:
        raise AssertionError(f"{tag}: a target's force is off by {err}")
    if not same:
        raise AssertionError(f"{tag}: two launches differ")
    if not planted > TARGET_TOL:
        raise AssertionError(f"{tag}: the per-target gate missed the "
                             f"narrowed reach ({planted})")
    return err


def original_beside(tag: str, ms: float, ref: list, variant,
                    reps: int) -> float:
    """The design before the redesign (``variant("original")``) on the
    same planes, timed beside the redesign's ``ms`` a launch; it must agree
    with the float64 plain version ``ref`` to FORCE_REL_L2_TOL."""
    rel = max(rel_l2(o, r) for o, r in zip(variant("original"), ref))
    o_ms = cuda_time_ms(lambda: variant("original"), reps) / len(ref)
    phase(f"{tag}: the design before the redesign (scripts/"
          f"torch_columns_ablation.py's original, built in this run) "
          f"{o_ms:.4f} ms a launch against {ms:.4f} ({o_ms / ms:.2f}x); rel "
          f"L2 vs float64 {rel:.3e} (tol {FORCE_REL_L2_TOL:g})")
    if not rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"{tag}: the design before the redesign "
                             f"disagrees: {rel}")
    return o_ms


def reach_visits(plane, ws, nch, *, box: float, drift=None, cht=None,
                 lib=None, **kw) -> tuple[int, int]:
    """(the visits the column kernels of the library ``lib`` (the port's
    by default) make on a plane, computed from the plain reach rule
    ``column_reach`` with that build's targets a block and probe spacing
    (the whole windows for a build without the search): their blocks'
    reach times the targets a block; the visits of the whole windows, the
    design before the redesign's)."""
    from nbody_torch._kernels import load_library
    from nbody_torch.forces.p3m_columns import column_info, column_reach

    group, fence, search = column_info(load_library() if lib is None
                                       else lib)
    keys = ("ncell", "stride", "W", "maxch", "gz", "chunk", "r_cut", "nx")
    first, lo, hi = column_reach(plane, ws, nch, box=box, drift=drift,
                                 cht=cht, group=group, fence=fence,
                                 **{k: kw[k] for k in keys if k in kw})
    whole = first.numel() * 9 * kw["W"] * group
    if not search:
        return whole, whole
    return int(torch.clamp_min(hi - lo, 0).sum()) * group, whole


def count_inside_dense(pos, box: float, r_cut: float) -> int:
    """Minimum-image pairs (self pairs included) with r^2 < r_cut^2: the
    visits on which K1 evaluates the weight."""
    n = pos.shape[0]
    step = max(1, (1 << 26) // n)
    inside = 0
    for i0 in range(0, n, step):
        d = pos[None, :, :] - pos[i0:i0 + step, None, :]
        d -= box * torch.round(d / box)
        inside += int(((d * d).sum(-1).clamp_min(1e-30) < r_cut**2).sum())
    return inside


def check_wrappers_raise(pos, mass, box, eps, r_s, r_cut, G):
    """K1-K6's wrappers refuse what their kernels do not take."""
    from nbody_torch.forces.p3m import (
        build_padded_plane,
        p3m_short_acc,
        run_cell_plane,
    )
    from nbody_torch.forces.p3m_columns import (
        build_column_plane,
        plane_geometry,
        run_column_plane,
        run_column_plane_masked,
    )
    from nbody_torch.forces.pm_supercell import (
        run_fused_column_plane,
        supercell_deposit_from_plane,
        supercell_params,
    )

    bad = {
        "K1 float64": lambda: p3m_short_acc(pos.double(), mass.double(), box,
                                            eps, r_s, r_cut, G),
        "K1 non-contiguous": lambda: p3m_short_acc(pos.T.contiguous().T, mass,
                                                   box, eps, r_s, r_cut, G),
        "K1 shape": lambda: p3m_short_acc(pos[:, :2].contiguous(), mass, box,
                                          eps, r_s, r_cut, G),
    }
    nmesh = 64
    _, rc, ncell, ck, w = supercell_params(box, nmesh, pos.shape[0])
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, rc, ck, w)
    plane, ws, nch, _, _, _, counts = build_column_plane(
        pos, mass, box, rc, ncell, CK, W, chunk=chunk)
    kw = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
              chunk=chunk, eps=eps, r_s=r_s, r_cut=rc, split="spline",
              softening="spline")
    grids = torch.zeros((3, nmesh, nmesh, nmesh), device=pos.device)
    dkw = dict(box=box, nmesh=nmesh, ncell=ncell, stride=stride, gz=gz)
    kw4 = dict(kw, box=box)
    bad.update({
        "K4 float64 plane": lambda: run_column_plane(plane.double(), ws, nch,
                                                     **kw4),
        "K4 int64 ws": lambda: run_column_plane(plane, ws.long(), nch, **kw4),
        "K4 plane shape": lambda: run_column_plane(plane[:4].contiguous(), ws,
                                                   nch, **kw4),
        "K4 without the box": lambda: run_column_plane(plane, ws, nch, **kw),
        "K4 float64 drift": lambda: run_column_plane(
            plane, ws, nch, drift=torch.zeros((), dtype=torch.float64,
                                              device=pos.device), **kw4),
        "K3 grids shape": lambda: run_fused_column_plane(
            plane, ws, nch, grids[:2].contiguous(), S=nmesh // ncell,
            scale=nmesh / box, **kw),
        "K3 float64 grids": lambda: run_fused_column_plane(
            plane, ws, nch, grids.double(), S=nmesh // ncell,
            scale=nmesh / box, **kw),
        "K2 short counts": lambda: supercell_deposit_from_plane(
            plane, counts[:-1].contiguous(), **dkw),
        "K5 int64 chunk table": lambda: run_column_plane_masked(
            plane, ws, nch, torch.zeros(nch.numel() * maxch,
                                        dtype=torch.int64,
                                        device=pos.device), **kw4),
    })
    cplane, _, K, _, ccounts = build_padded_plane(pos, mass, box, r_cut,
                                                  int(box / r_cut), 128)
    ckw = dict(nx=int(box / r_cut), ncell=int(box / r_cut), K=K,
               eps2=eps**2, r_s=r_s, r_cut=r_cut)
    bad.update({
        "K6 float64 plane": lambda: run_cell_plane(cplane.double(), ccounts,
                                                   **ckw),
        "K6 int64 counts": lambda: run_cell_plane(cplane, ccounts.long(),
                                                  **ckw),
        "K6 plane_j without K_j": lambda: run_cell_plane(
            cplane, ccounts, plane_j=cplane, **ckw),
        "K6 short counts": lambda: run_cell_plane(
            cplane, ccounts[:-1].contiguous(), **ckw),
        "K6 short source counts": lambda: run_cell_plane(
            cplane, ccounts, plane_j=cplane, K_j=K,
            counts_j=ccounts[:-1].contiguous(), **ckw),
    })
    from nbody_torch.forces.pallas_pp import allpairs_pallas, block_acc_pallas

    bad.update({
        "K7 float16": lambda: allpairs_pallas(pos.half(), mass.half(), eps),
        "K7 non-contiguous": lambda: allpairs_pallas(pos.T.contiguous().T,
                                                     mass, eps),
        "K7 shape": lambda: allpairs_pallas(pos[:, :2].contiguous(), mass,
                                            eps),
        "K7 mixed dtypes": lambda: block_acc_pallas(pos, pos.double(), mass,
                                                    eps),
        "K7 eps 0": lambda: allpairs_pallas(pos, mass, 0.0),
    })
    for what, fn in bad.items():
        try:
            fn()
        except (TypeError, ValueError):
            continue
        raise AssertionError(f"a wrapper accepted: {what}")
    return list(bad)


def driver_knobs(state, config, cfg_run, prewarm: bool):
    """The knobs the driver gives the column kernels at ``state``:
    ``cfg_run``'s (after the driver's own pre-warm when ``prewarm``, as
    at the start of a stretch of steps), healed by the driver's own rule
    until the plane drops nothing; for B members' ``state`` (B, N, 3) the
    batch's knobs (pre-warmed over every member, healed on the batch's
    overflow word).  Returns (config, run.log lines)."""
    from nbody_torch.driver.simulate import (
        HEAL_ATTEMPTS,
        column_knobs,
        heal_capacity,
        prewarm_capacity,
    )
    from nbody_torch.forces.p3m import p3m_short_params
    from nbody_torch.forces.p3m_columns import (
        build_column_plane,
        encode_overflow,
        plane_geometry,
    )

    box = config.box
    r_cut = p3m_short_params(box, config.mesh_size, config.n_particles)[1]
    lines = []
    if prewarm:
        cfg_run, lines = prewarm_capacity(config, cfg_run, state.pos)
    for _ in range(HEAL_ATTEMPTS):
        ncell, ck, w = column_knobs(config, cfg_run)
        CK, _, _, W, _, chunk = plane_geometry(box, r_cut, ck, w)
        _, _, _, ovb, ovw, _, _ = build_column_plane(
            state.pos, state.mass, box, r_cut, ncell, CK, W, chunk=chunk)
        ov = int(encode_overflow(ovb, ovw))
        if ov == 0:
            return cfg_run, lines
        cfg_run, line = heal_capacity(config, cfg_run, ov)
        lines.append(line)
    raise AssertionError(f"the plane still overflows after {HEAL_ATTEMPTS} "
                         f"heals: {lines}")


def driver_plane(state, config, cfg_run, prewarm: bool):
    """The column plane of ``state`` at :func:`driver_knobs`' geometry:
    (knobs line, plane, ws, nch, counts, the kernels' geometry
    keywords)."""
    from nbody_torch.driver.simulate import column_knobs
    from nbody_torch.forces.p3m import p3m_short_params
    from nbody_torch.forces.p3m_columns import (
        build_column_plane,
        plane_geometry,
    )

    box = config.box
    r_cut = p3m_short_params(box, config.mesh_size, config.n_particles)[1]
    cfg_run, lines = driver_knobs(state, config, cfg_run, prewarm)
    ncell, ck, w = column_knobs(config, cfg_run)
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut, ck, w)
    plane, ws, nch, _, _, _, counts = build_column_plane(
        state.pos, state.mass, box, r_cut, ncell, CK, W, chunk=chunk)
    knobs = (f"column grid {ncell}^2, capacity {CK}, window {W}, stride "
             f"{stride}, chunk {chunk}" + "".join(f"; {x}" for x in lines))
    return knobs, plane, ws, nch, counts, dict(
        ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz, chunk=chunk)


def needed_work(plane, counts, *, ncell: int, stride: int, gz: int,
                r_cut: float, targets=None, nx: int | None = None, **_):
    """The work the column pair sum needs, counted on the plane: (the
    source visits, the pairs inside r_cut, the (P^2, stride) bool of the
    plane slots those visits read, the number of targets).  A visit is a
    massive slot of a real target's 9 neighbour columns within +-r_cut of
    it in z; a pair inside r_cut also has r^2 < r_cut^2 (self pairs
    included, as K1's count has them).  ``targets`` (ncol, stride) bool
    restricts the targets (K5: the active particles only).  The kernels
    also visit the rest of their blocks' reach (``reach_visits``), and
    targets in the ghost slots of a column's last chunk (and K5 the
    inactive targets of an active chunk); that is not counted.  ``nx``: a slab
    plane's interior x-rows (its ghost x-rows are the neighbours')."""
    P = ncell + 2
    nx = ncell if nx is None else nx
    x = plane[:4].reshape(4, (nx + 2) * P, stride)
    ic = torch.arange(nx * ncell, device=plane.device)
    cx, cy = ic // ncell, ic % ncell
    cmax = int(counts.max())
    t = x[:, (cx + 1) * P + (cy + 1), gz:gz + cmax]
    real = (torch.arange(cmax, device=plane.device)[None, :]
            < counts.to(torch.int64)[:, None])
    if targets is not None:
        real = real & targets[:, gz:gz + cmax]
    rc2 = float(r_cut) ** 2
    group = max(1, (1 << 26) // (cmax * stride))
    visits = inside = 0
    read = torch.zeros(((nx + 2) * P, stride), dtype=torch.bool,
                       device=plane.device)
    for o2 in range(9):
        scol = (cx + o2 // 3) * P + (cy + o2 % 3)
        src = x[:, scol]
        for c0 in range(0, ic.numel(), group):
            tt, ss = t[:, c0:c0 + group], src[:, c0:c0 + group]
            pair = real[c0:c0 + group, :, None] & (ss[3] > 0)[:, None, :]
            dz = ss[2][:, None, :] - tt[2][:, :, None]
            near = pair & (dz.abs() <= r_cut)
            visits += int(near.sum())
            read[scol[c0:c0 + group]] |= near.any(1)
            dx = ss[0][:, None, :] - tt[0][:, :, None]
            dy = ss[1][:, None, :] - tt[1][:, :, None]
            r2 = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-30)
            inside += int((near & (r2 < rc2)).sum())
    return visits, inside, read, int(real.sum())


def needed_bytes(n_sources: int, n_targets: int,
                 target_plane: bool = False) -> int:
    """The bytes a pair sum must move: x, y, z and m of each source it
    reads, the x, y, z of each target from a plane of its own
    (``target_plane``: K6's two-plane form) and the three force components
    it writes per target, float32."""
    return 16 * n_sources + 12 * n_targets * (2 if target_plane else 1)


def _pair_kw(cfg, geo: dict) -> dict:
    """The column kernels' keywords for ``cfg`` on a plane of ``geo``."""
    from nbody_torch.forces.p3m import p3m_short_params

    r_s, r_cut, _, _ = p3m_short_params(cfg.box, cfg.mesh_size,
                                        cfg.n_particles)
    return dict(eps=cfg.eps, r_s=r_s, r_cut=r_cut, split=cfg.force_split,
                softening=cfg.softening_kernel, **geo)


def supercell_kernels_check(state, config, cfg_run, tag: str,
                            prewarm: bool) -> dict:
    """K2 and K3 (3 variants) against their plain versions on the plane of
    ``state`` at the supercell tier's driver geometry; returns each
    kernel's numbers for the JSON line."""
    from nbody_torch.forces.pm import pm_module
    from nbody_torch.forces.pm_supercell import (
        deposit_node_masses_plain,
        fold_node_masses,
        fused_column_plane_plain,
        launch_fused,
        run_fused_column_plane,
        supercell_deposit_from_plane,
        supercell_geometry,
    )
    from nbody_torch.mesh.cic import cic_deposit

    box, nmesh = config.box, config.mesh_size
    knobs, plane, ws, nch, counts, geo = driver_plane(state, config,
                                                      cfg_run, prewarm)
    phase(f"[7] {tag}: {knobs}")
    kw = _pair_kw(config, geo)
    ncell, stride, gz = geo["ncell"], geo["stride"], geo["gz"]
    S, ZP = supercell_geometry(nmesh, ncell)
    pos, mass = state.pos, state.mass
    scale = nmesh / box
    out = {}

    # -- K2: deposit at both shifts against the float32 plain version ---
    dkw = dict(box=box, nmesh=nmesh, ncell=ncell, stride=stride, gz=gz)
    pkw = dict(ncell=ncell, S=S, ZP=ZP, stride=stride, gz=gz, scale=scale)

    def k2_plain(p, shift=0.0):
        nodes = deposit_node_masses_plain(p, counts, shift=shift, **pkw)
        return fold_node_masses(nodes, ncell=ncell, S=S, ZP=ZP, nmesh=nmesh)

    for shift in (0.0, 0.5):
        got = supercell_deposit_from_plane(plane, counts, shift=shift, **dkw)
        torch.cuda.synchronize()
        ref32 = k2_plain(plane, shift)
        ref64 = k2_plain(plane.double(), shift)
        err = max_abs(got, ref32) / float(ref32.abs().max())
        err64 = max_abs(got, ref64) / float(ref64.abs().max())
        phase(f"[7] {tag} K2 shift {shift}: max |node - plain f32| / max "
              f"{err:.3e} (tol {NODE_MASS_TOL:g}), vs float64 {err64:.3e}; "
              f"mass {float(got.sum()):.6e} of {float(mass.sum()):.6e}")
        if not err <= NODE_MASS_TOL:
            raise AssertionError(f"K2 disagrees with its plain version: {err}")
        if shift == 0.0:
            rho, k2_err = got, max_abs(got, ref32)
    n_real = int(counts.sum())
    times = k2_timing(f"[7] {tag} K2", [dict(
        plane=plane, counts=counts, nx=ncell, shift=0.0, row0=0, **dkw)])
    k2_ms = times["ms"]
    k2_plain_ms = cuda_time_ms(lambda: k2_plain(plane), 3)
    lib_ms = cuda_time_ms(lambda: cic_deposit(pos, box, nmesh, weights=mass),
                          50)
    b_ms, b_by = bound(n_real * 16 + counts.numel() * 4 + nmesh**3 * 4,
                       n_real * FLOPS_DEPOSIT)
    out["K2"] = dict(max_abs_err=k2_err, plain_ms=k2_plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, **times)
    phase(f"[7] {tag} K2: the call {k2_ms:.4f} ms, plain f32 "
          f"{k2_plain_ms:.3f} ms, cic_deposit (index_add_) {lib_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}); {n_real} particles")

    # -- the real force grids, then K3 ------------------------------------
    mass_sum = torch.sum(mass)
    amp = 4.0 * math.pi * mass_sum / box**3
    split = config.force_split
    filt = dict(longrange_split=kw["r_s"] if split == "gaussian" else 0.0,
                spline_split=kw["r_cut"] if split == "spline" else 0.0)
    pm3, pm6 = (pm_module(box, nmesh, config.deconvolve_p, il,
                          filt["longrange_split"], filt["spline_split"],
                          config.pm_gradient, 0.0, pos.device, torch.float32)
                for il in (False, True))
    grids3 = pm3.force_grids_from_rho(rho, amp, mass_sum).contiguous()
    rho1 = supercell_deposit_from_plane(plane, counts, shift=0.5, **dkw)
    grids6 = pm6.force_grids_from_rho(rho, amp, mass_sum,
                                      rho1=rho1).contiguous()
    p64 = plane.double()
    visits, inside, _, n_t = needed_work(plane, counts, **kw)
    libs = _columns_variants()
    for il, so in ((False, False), (True, False), (False, True)):
        g = grids6 if il else grids3
        fkw = dict(S=S, scale=scale, split_out=so, interlaced=il, **kw)
        got = run_fused_column_plane(plane, ws, nch, g, **fkw)
        torch.cuda.synchronize()
        ref = fused_column_plane_plain(p64, ws, nch, g.double(), **fkw)
        rel = rel_l2(got, ref)
        phase(f"[7] {tag} K3 interlaced={il} split_out={so}: rel L2 "
              f"{rel:.3e} (tol {FORCE_REL_L2_TOL:g}), max abs "
              f"{max_abs(got, ref):.3e}")
        if not rel <= FORCE_REL_L2_TOL:
            raise AssertionError(f"K3 disagrees with its plain version: {rel}")

        def variant(name, g=g, fkw=fkw):
            return [launch_fused(libs[name], plane, ws, nch, g, nx=ncell,
                                 row0=0, box=box, drift=None, **fkw)]

        column_gates(f"[7] {tag} K3 interlaced={il} split_out={so}", [got],
                     [ref], lambda g=g, fkw=fkw: [run_fused_column_plane(
                         plane, ws, nch, g, **fkw)], variant)
        if not il and not so:
            k3_err, ref0, variant0 = max_abs(got, ref), ref, variant
    fkw = dict(S=S, scale=scale, **kw)
    k3_ms = cuda_time_ms(
        lambda: run_fused_column_plane(plane, ws, nch, grids3, **fkw), 20)
    original_beside(f"[7] {tag} K3", k3_ms, [ref0], variant0, 5)
    k3_plain_ms = cuda_time_ms(
        lambda: fused_column_plane_plain(plane, ws, nch, grids3, **fkw), 2)
    # every stored particle is a target and reads itself: n_t sources
    b_ms, b_by = bound(needed_bytes(n_t, n_t) + grids3.numel() * 4,
                       visits * FLOPS_VISIT_COLUMNS + inside * FLOPS_INSIDE
                       + n_real * FLOPS_PM_READ)
    out["K3"] = dict(max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None)
    reach, whole = reach_visits(plane, ws, nch, box=box, **kw)
    phase(f"[7] {tag} K3: kernel {k3_ms:.4f} ms, plain f32 {k3_plain_ms:.3f}"
          f" ms, bound {b_ms:.4f} ms ({b_by}); {visits:.4e} visits within "
          f"r_cut in z (the kernel's reach by column_reach {reach:.4e}, "
          f"the whole windows "
          f"{whole:.4e}), {inside:.4e} inside r_cut")
    return out


def columns_kernel_check(state, config, cfg_run, tag: str,
                         prewarm: bool) -> dict:
    """K4 against its plain version on the plane of ``state`` at the
    columns tier's driver geometry; returns its numbers for the JSON
    line."""
    from nbody_torch.forces.p3m_columns import (
        column_plane_plain,
        launch_columns,
        run_column_plane,
    )

    knobs, plane, ws, nch, counts, geo = driver_plane(state, config,
                                                      cfg_run, prewarm)
    phase(f"[7] {tag}: {knobs}")
    kw = _pair_kw(config, geo)
    box = config.box
    p64 = plane.double()
    got = run_column_plane(plane, ws, nch, box=box, **kw)
    torch.cuda.synchronize()
    ref = column_plane_plain(p64, ws, nch, **kw)
    rel = rel_l2(got, ref)
    k4_err = max_abs(got, ref)
    phase(f"[7] {tag} K4: rel L2 {rel:.3e} (tol {FORCE_REL_L2_TOL:g}), max "
          f"abs {k4_err:.3e}")
    if not rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"K4 disagrees with its plain version: {rel}")
    libs = _columns_variants()

    def variant(name):
        return [launch_columns(libs[name], plane, ws, nch, None,
                               nx=geo["ncell"], box=box, drift=None, **kw)]

    column_gates(f"[7] {tag} K4", [got], [ref],
                 lambda: [run_column_plane(plane, ws, nch, box=box, **kw)],
                 variant)
    k4_ms = cuda_time_ms(lambda: run_column_plane(plane, ws, nch, box=box,
                                                  **kw), 20)
    original_beside(f"[7] {tag} K4", k4_ms, [ref], variant, 5)
    k4_plain_ms = cuda_time_ms(lambda: column_plane_plain(plane, ws, nch,
                                                          **kw), 2)
    visits, inside, _, n_t = needed_work(plane, counts, **kw)
    b_ms, b_by = bound(needed_bytes(n_t, n_t),
                       visits * FLOPS_VISIT_COLUMNS + inside * FLOPS_INSIDE)
    reach, whole = reach_visits(plane, ws, nch, box=box, **kw)
    phase(f"[7] {tag} K4: kernel {k4_ms:.4f} ms, plain f32 {k4_plain_ms:.3f}"
          f" ms, bound {b_ms:.4f} ms ({b_by}); {visits:.4e} visits within "
          f"r_cut in z (the kernel's reach by column_reach {reach:.4e}, "
          f"the whole windows "
          f"{whole:.4e}), {inside:.4e} inside r_cut")
    return {"K4": dict(max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)}


def needed_work_cells(plane, counts, K: int, plane_j, counts_j, K_j: int, *,
                      ncell: int, r_cut: float, nx: int | None = None, **_):
    """The work of the cell pair sum on the planes: (the dense visits,
    every stored source of a stored target's 27 neighbour cells, which the
    kernel makes; the pairs among them inside r_cut, the work the function
    needs; the distinct particles those pairs read (a ghost slot is its
    periodic image's particle); the number of targets).  ``nx``: a slab
    plane's real x-layers (its ghost x-layers hold the neighbours'
    particles, no images)."""
    from nbody_torch.forces.p3m import _real_cells

    dev = plane.device
    M = ncell + 2
    nx = ncell if nx is None else nx
    counts, counts_j = counts.to(torch.int64), counts_j.to(torch.int64)
    cells = _real_cells(nx, ncell, dev)
    ci = counts[cells]
    tcell = torch.repeat_interleave(cells, ci)
    first = torch.repeat_interleave(torch.cumsum(ci, 0) - ci, ci)
    tslot = tcell * K + torch.arange(tcell.numel(), device=dev) - first
    xt = plane[0:3, tslot]
    kmax = int(counts_j.max())
    jr = torch.arange(kmax, device=dev)
    rc2 = float(r_cut) ** 2
    step = max(1, (1 << 24) // max(kmax, 1))
    visits = inside = 0
    # each padded cell's periodic image among the real cells
    fold = (torch.arange(M, device=dev) - 1) % ncell + 1
    fold_x = fold if nx == ncell else torch.arange(nx + 2, device=dev)
    image = ((fold_x[:, None, None] * M + fold[None, :, None]) * M
             + fold[None, None, :]).reshape(-1)
    read = torch.zeros((nx + 2) * M * M * kmax, dtype=torch.bool, device=dev)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                off = (ox * M + oy) * M + oz
                for t0 in range(0, tslot.numel(), step):
                    sc = tcell[t0:t0 + step] + off
                    live = jr[None, :] < counts_j[sc][:, None]
                    src = torch.where(live, sc[:, None] * K_j + jr[None, :], 0)
                    d = plane_j[0:3, src] - xt[:, t0:t0 + step, None]
                    visits += int(live.sum())
                    r2 = torch.clamp_min((d * d).sum(0), 1e-30)
                    near = live & (r2 < rc2)
                    inside += int(near.sum())
                    read[(image[sc][:, None] * kmax + jr[None, :])[near]] = True
    return visits, inside, int(read.sum()), tslot.numel()


def k6_lane_slots(counts, counts_j, *, nx: int, ncell: int,
                  warps: int) -> int:
    """The lane slots K6 issues on a plane (32 for each step of a warp
    through a tile, idle lanes included), from the kernel's deal
    (``k6_work``): a target cell's neighbourhood in tiles of K6_TILE
    sources of one cell, tile q to share q mod S, each of its G groups'
    warps stepping ceil(n / L) times through a tile of n sources."""
    from nbody_torch.forces.p3m import K6_TILE, _real_cells, k6_work

    M = ncell + 2
    counts, counts_j = counts.tolist(), counts_j.tolist()
    offsets = [(ox * M + oy) * M + oz for ox in (-1, 0, 1)
               for oy in (-1, 0, 1) for oz in (-1, 0, 1)]
    slots = 0
    for tcell in _real_cells(nx, ncell, "cpu").tolist():
        c = counts[tcell]
        if c == 0:
            continue
        work = k6_work(c, warps)
        tiles = [min(K6_TILE, counts_j[tcell + o] - u) for o in offsets
                 for u in range(0, counts_j[tcell + o], K6_TILE)]
        slots += 32 * work.groups * sum(-(-n // work.lanes) for n in tiles)
    return slots


def rung_mask(state, cfg):
    """The particles above rung 0 at ``state``: the rung rule of ``cfg``
    (its rungs, etas and last step of its grid) on the state's velocities
    and both halves of its force."""
    from nbody_torch.driver.simulate import build_cosmo_force_both
    from nbody_torch.integrate.cosmo_stepping import (
        _assign_rungs,
        _rung_demand,
        log_a_steps,
    )

    a0, a1 = log_a_steps(cfg.a_begin, cfg.a_end, cfg.n_steps)[-2:]
    gs, gl, _ = build_cosmo_force_both(cfg)(state.pos, state.mass, a0, a0)
    cosmo = cfg.cosmology()

    def t(x):
        return torch.tensor(float(x), device=state.pos.device)

    dla = _rung_demand(state.vel, gl, gs, t(a0), t(cfg.box / cfg.mesh_size),
                       t(cfg.step_eta_disp),
                       t(2.0 * cfg.step_eta_acc * cfg.eps),
                       float(cosmo.H0), float(cosmo.Omega_m),
                       float(cosmo.Omega_L))
    rung = _assign_rungs(dla, torch.log(t(a1)) - torch.log(t(a0)), cfg.rungs)
    return rung >= 1


def k6_one_device_launches(state, act, config) -> dict:
    """[11]'s K6 launches at ``state``: {"one-plane": [kw], "two-plane":
    [kw]}, the keywords of ``run_cell_plane`` (planes included) on the
    cell planes of ``state`` at the driver's pre-warmed cell capacity, the
    two-plane form's targets the ``act`` particles at the pre-warmed
    target capacity."""
    from nbody_torch.driver.simulate import _cell_knobs, prewarm_capacity
    from nbody_torch.forces.p3m import build_padded_plane, cell_ids

    cells_cfg = config.replace(shortrange="cells")
    ncell = _cell_knobs(cells_cfg, cells_cfg)[2]
    occ = int(torch.bincount(cell_ids(state.pos[act], config.box, ncell),
                             minlength=ncell**3).max())
    grown = prewarm_capacity(cells_cfg, cells_cfg, state.pos,
                             rung_occ=occ)[0]
    r_s, r_cut, ncell, cap = _cell_knobs(cells_cfg, grown)
    tcap = grown.rung_capacity or 128
    pos, mass = state.pos, state.mass
    plane, ov, K, _, counts = build_padded_plane(pos, mass, config.box,
                                                 r_cut, ncell, cap)
    plane_i, ov_i, K_i, _, counts_i = build_padded_plane(
        pos, mass, config.box, r_cut, ncell, tcap, valid=act)
    if int(ov) or int(ov_i):
        raise AssertionError(f"[11] cell planes spill ({int(ov)}, "
                             f"{int(ov_i)})")
    kw = dict(nx=ncell, ncell=ncell, eps2=config.eps**2, r_s=r_s,
              r_cut=r_cut, split=config.force_split,
              softening=config.softening_kernel)
    return {"one-plane": [dict(plane=plane, counts=counts, K=K, **kw)],
            "two-plane": [dict(plane=plane_i, counts=counts_i, K=K_i,
                               plane_j=plane, K_j=K, counts_j=counts, **kw)]}


def k6_slab_launches(state, config) -> tuple[list, str]:
    """[19]'s K6 launches: every shard's cell slab plane of ``state`` at
    the domain geometry's bucket capacity, healed by the driver's rule.
    Returns (the launches' keywords, a line on the geometry)."""
    from nbody_torch.distributed import domain as td

    group, geom, shards, _, _, lines = domain_setup(state, config, "cells")
    nx = geom.ncell // group.size
    built = td.build_local_plane(
        [s.pos for s in shards], [s.mass for s in shards], box=config.box,
        r_cut=geom.r_cut, ncell=geom.ncell, group=group,
        capacity=geom.bucket_capacity)
    K = built[0][2]
    kw = dict(nx=nx, ncell=geom.ncell, K=K, eps2=config.eps**2,
              r_s=geom.r_s, r_cut=geom.r_cut, split=config.force_split,
              softening=config.softening_kernel)
    return ([dict(plane=b[0], counts=b[4], **kw) for b in built],
            f"{group.size} shards of {nx} x {geom.ncell}^2 cells, K {K} "
            f"(capacity {geom.bucket_capacity})"
            + "".join(f"; {x}" for x in lines))


def k6_masked_slab_launches(state, act, cfg, tcap: int) -> tuple[list, str]:
    """[20]'s K6 launches: on every shard, the plane of the ``act``
    particles of ``state`` (capacity ``tcap``, doubled by the driver's
    rule while it spills) against the slab's cell plane (the domain
    geometry's bucket capacity, healed as in [19]).  Returns (the
    launches' keywords, a line on the geometry)."""
    from nbody_torch.distributed import domain as td

    group, geom, shards, _, _, lines = domain_setup(state, cfg, "cells")
    D, box = group.size, cfg.box
    nxl = geom.ncell // D
    act = shard_rows(act, state, box, geom.ncell, shards)
    act = [a & (s.mass > 0) for a, s in zip(act, shards)]
    pos, mass = [s.pos for s in shards], [s.mass for s in shards]
    pkw = dict(box=box, r_cut=geom.r_cut, ncell=geom.ncell, group=group)
    src = td.build_local_plane(pos, mass, capacity=geom.bucket_capacity,
                               **pkw)
    while True:
        tgt = td.build_local_plane(pos, mass, capacity=tcap, valid=act, **pkw)
        if max(int(t[1]) for t in tgt) == 0:
            break
        tcap *= 2
    K_j, K_i = src[0][2], tgt[0][2]
    kw = dict(nx=nxl, ncell=geom.ncell, eps2=cfg.eps**2, r_s=geom.r_s,
              r_cut=geom.r_cut, split=cfg.force_split,
              softening=cfg.softening_kernel)
    return ([dict(plane=t[0], counts=t[4], K=K_i, plane_j=s[0], K_j=K_j,
                  counts_j=s[4], **kw) for s, t in zip(src, tgt)],
            f"{D} shards of {nxl} x {geom.ncell}^2 cells, source K {K_j}, "
            f"target K {K_i}; {sum(int(a.sum()) for a in act)} active "
            f"particles" + "".join(f"; {x}" for x in lines))


def k6_replicated_launches(state, cfg) -> tuple[list, str]:
    """[21]'s K6 launches: every shard's x-slab of the whole cell plane of
    ``state`` (the default capacity, doubled until the plane drops
    nothing).  Returns (the launches' keywords, a line on the geometry)."""
    from nbody_torch.distributed.sharding import (
        sharded_p3m_geometry,
        slice_plane,
    )
    from nbody_torch.forces.p3m import build_padded_plane
    from nbody_torch.mesh.cells import cell_capacity

    box, nmesh, n = cfg.box, cfg.mesh_size, cfg.n_particles
    r_s, r_cut, ncell, nxl = sharded_p3m_geometry(box, nmesh, DOMAIN_SHARDS)
    cap = cell_capacity(n, ncell)
    while True:
        plane, ov, K, _, counts = build_padded_plane(
            state.pos, state.mass, box, r_cut, ncell, cap)
        if int(ov) == 0:
            break
        cap *= 2
    kw = dict(nx=nxl, ncell=ncell, K=K, eps2=cfg.eps**2, r_s=r_s,
              r_cut=r_cut, split=cfg.force_split,
              softening=cfg.softening_kernel)
    return ([dict(plane=lp, counts=lc, **kw) for lp, lc in (
                slice_plane(plane, counts, d=d, nxl=nxl, ncell=ncell, K=K)
                for d in range(DOMAIN_SHARDS))],
            f"{ncell}^3 cells (r_cut {r_cut:.4f} Mpc), {DOMAIN_SHARDS} shards"
            f" of {nxl} x-layers, capacity {cap} (K {K})")


def _k6_variants():
    """``scripts/torch_k6_ablation.py`` (the module) and {name: library}
    of its ``original`` (K6 before its redesign for Hopper) and
    ``narrowed`` (a neighbour cell left out, a planted fault) variants,
    built in this run."""
    if not hasattr(_k6_variants, "libs"):
        abl = _ablation("torch_k6_ablation")
        _k6_variants.abl = abl
        _k6_variants.libs = {name: lib for name, (lib, _) in
                             abl.load_variants(["original",
                                                "narrowed"]).items()}
    return _k6_variants.abl, _k6_variants.libs


def _ablation(name: str):
    """``scripts/<name>.py``, the module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k2_variants():
    """``scripts/torch_k2_ablation.py`` (the module) and {name: library}
    of its ``original`` (K2 before its redesign for Hopper), built in this
    run."""
    if not hasattr(_k2_variants, "libs"):
        abl = _ablation("torch_k2_ablation")
        _k2_variants.abl = abl
        _k2_variants.libs = {name: lib for name, (lib, _) in
                             abl.load_variants(["original"]).items()}
    return _k2_variants.abl, _k2_variants.libs


def _k8_original():
    """``scripts/torch_k8_ablation.py`` (the module) and the library of
    its ``original`` (K8 before its redesign for Hopper), built in this
    run."""
    if not hasattr(_k8_original, "lib"):
        abl = _ablation("torch_k8_ablation")
        _k8_original.abl = abl
        _k8_original.lib = abl.build_all(["original"])["original"][0]
    return _k8_original.abl, _k8_original.lib


def enqueue_ms(fn, calls: int = 50) -> float:
    """The host's time to enqueue one call of ``fn`` (no synchronisation
    inside a run of ``calls`` calls, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return host


def k2_timing(tag: str, kws: list, reps: int = 50) -> dict:
    """K2 at one site (``kws``: ``scripts/torch_k2_ablation.py``'s call
    keywords, one a shard): two launches equal bit for bit on every
    shard (the fixed-point sums), the call (CUDA events around
    back-to-back ``supercell_deposit_from_plane`` calls, the wrapper's
    host work included), the kernel alone (the memset and the three
    passes by one library call on prepared buffers: the device's time),
    the host's enqueue of a call, and K2 before its redesign (the
    ablation's ``original``: its call through its own wrapper, the mesh
    fill included, and its kernel alone), means over the shards; the
    original's deposit must agree with the float32 plain version to
    NODE_MASS_TOL.  Returns the times."""
    from nbody_torch._kernels import load_library
    from nbody_torch.forces.pm_supercell import supercell_deposit_from_plane

    abl, libs = _k2_variants()

    def call(kw):
        return supercell_deposit_from_plane(
            kw["plane"], kw["counts"], box=kw["box"], nmesh=kw["nmesh"],
            ncell=kw["ncell"], stride=kw["stride"], gz=kw["gz"],
            shift=kw["shift"], nx=kw["nx"], row0=kw["row0"])

    same = all(torch.equal(call(kw), call(kw)) for kw in kws)
    ms = _mean_ms([lambda kw=kw: call(kw) for kw in kws], reps)
    kern = [abl.kernel_launch("redesign", load_library(), kw) for kw in kws]
    kernel_ms = _mean_ms([k[0] for k in kern], reps)
    host = enqueue_ms(lambda: [call(kw) for kw in kws], reps) / len(kws)
    orig = libs["original"]
    o_ms = _mean_ms([lambda kw=kw: abl.variant_call("original", orig, kw)
                     for kw in kws], reps)
    o_kern = [abl.kernel_launch("original", orig, kw) for kw in kws]
    o_kernel_ms = _mean_ms([k[0] for k in o_kern], reps)
    o_err = 0.0
    for kw in kws:
        ref = abl.plain(kw)
        o_err = max(o_err, max_abs(abl.variant_call("original", orig, kw),
                                   ref) / float(ref.abs().max()))
    phase(f"{tag}: two launches equal bit for bit: {same}; the call "
          f"{ms:.4f} ms, the kernel alone {kernel_ms:.4f} ms (the memset and"
          f" the three passes), the host's enqueue {host:.4f} ms a call; K2 "
          f"before the redesign (scripts/torch_k2_ablation.py's original, "
          f"built in this run): the call {o_ms:.4f} ms ({o_ms / ms:.2f}x), "
          f"its kernel alone {o_kernel_ms:.4f} ms, max |node - plain f32| / "
          f"max {o_err:.3e}")
    if not same:
        raise AssertionError(f"{tag}: two K2 launches differ")
    if o_err > NODE_MASS_TOL:
        raise AssertionError(f"{tag}: K2 before the redesign disagrees: "
                             f"{o_err}")
    return dict(ms=ms, kernel_ms=kernel_ms, enqueue_ms=host,
                original_ms=o_ms, original_kernel_ms=o_kernel_ms)


def _plain64(kw: dict) -> dict:
    """``run_cell_plane``'s keywords with float64 copies of the planes."""
    out = dict(kw, plane=kw["plane"].double())
    if "plane_j" in kw:
        out["plane_j"] = kw["plane_j"].double()
    return out


def k6_check(tag: str, launches: list, timed: bool = True) -> dict:
    """K6 at one site (``launches``: ``run_cell_plane``'s keywords, one a
    shard): relative L2 (FORCE_REL_L2_TOL) and per target (``target_err``
    within TARGET_TOL) against the float64 plain version, two launches
    equal bit for bit, the planted narrowed neighbourhood
    (``scripts/torch_k6_ablation.py``'s ``narrowed``: a neighbour cell left
    out) above TARGET_TOL.  With ``timed``: the whole call (CUDA events
    around back-to-back ``run_cell_plane`` calls, the wrapper's host work
    included), the kernel alone (back-to-back library calls on prepared
    planes: the device's time), the float32 plain version and the design
    before the redesign (the ablation's ``original``, through its own
    wrapper), a launch each, means over the shards; the dense visits (the
    kernel's) and its lane slots beside the pairs inside r_cut, and the
    bound of the work these inputs need: the pairs inside r_cut x
    (FLOPS_VISIT_COLUMNS + FLOPS_INSIDE) operations, or the bytes of
    ``needed_bytes``.  Returns the numbers of the kernels line."""
    from nbody_torch._kernels import load_library
    from nbody_torch.forces.p3m import cell_plane_plain, run_cell_plane

    abl, libs = _k6_variants()
    got = [run_cell_plane(**kw) for kw in launches]
    again = [run_cell_plane(**kw) for kw in launches]
    torch.cuda.synchronize()
    ref = [cell_plane_plain(**_plain64(kw)) for kw in launches]
    rel = max(rel_l2(g, r) for g, r in zip(got, ref))
    err = max(target_err(g, r) for g, r in zip(got, ref))
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    planted = max(target_err(abl.variant_call("narrowed", libs["narrowed"],
                                              kw), r)
                  for kw, r in zip(launches, ref))
    phase(f"{tag}: rel L2 {rel:.3e} (tol {FORCE_REL_L2_TOL:g}), per-target "
          f"error {err:.3e} (tol {TARGET_TOL:g}); two launches "
          f"{'equal bit for bit' if same else 'DIFFERENT'}; the planted "
          f"neighbourhood with a neighbour cell left out {planted:.3e} (must "
          f"exceed the tol)")
    if not rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"{tag}: K6 disagrees with its plain version: "
                             f"{rel}")
    if not err <= TARGET_TOL:
        raise AssertionError(f"{tag}: a target's force is off by {err}")
    if not same:
        raise AssertionError(f"{tag}: two launches differ")
    if not planted > TARGET_TOL:
        raise AssertionError(f"{tag}: the per-target gate missed the "
                             f"narrowed neighbourhood ({planted})")
    row = dict(max_abs_err=max(max_abs(g, r) for g, r in zip(got, ref)))
    if not timed:
        return row
    ms = _mean_ms([lambda kw=kw: run_cell_plane(**kw) for kw in launches],
                  20)
    kernel = [abl.kernel_launch("redesign", load_library(), kw)
              for kw in launches]
    dev_ms = _mean_ms([k[0] for k in kernel], 20)
    o_ms = _mean_ms([lambda kw=kw: abl.variant_call(
        "original", libs["original"], kw) for kw in launches], 20)
    orig_rel = max(rel_l2(abl.variant_call("original", libs["original"],
                                           kw), r)
                   for kw, r in zip(launches, ref))
    plain_ms = _mean_ms([lambda kw=kw: cell_plane_plain(**kw)
                         for kw in launches], 2)
    dense = inside = nbytes = slots = targets = 0
    for kw, (_, geo, _) in zip(launches, kernel):
        pj = kw.get("plane_j", kw["plane"])
        cj = kw.get("counts_j", kw["counts"])
        v, i, n_src, n_t = needed_work_cells(
            kw["plane"], kw["counts"], kw["K"], pj, cj,
            kw.get("K_j", kw["K"]), ncell=kw["ncell"], r_cut=kw["r_cut"],
            nx=kw["nx"])
        dense, inside, targets = dense + v, inside + i, targets + n_t
        nbytes += needed_bytes(n_src, n_t, "plane_j" in kw)
        slots += k6_lane_slots(kw["counts"].cpu(), cj.cpu(), nx=kw["nx"],
                               ncell=kw["ncell"], warps=geo.warps)
    D = len(launches)
    b_ms, b_by = bound(nbytes / D, inside * (FLOPS_VISIT_COLUMNS
                                             + FLOPS_INSIDE) / D)
    geo = kernel[0][1]
    phase(f"{tag}: kernel {dev_ms:.4f} ms a launch alone (the device), "
          f"{ms:.4f} ms a call (the wrapper's host work included), plain "
          f"f32 {plain_ms:.3f} ms; the design before the redesign "
          f"(scripts/torch_k6_ablation.py's original, built in this run) "
          f"{o_ms:.4f} ms a call ({o_ms / ms:.2f}x), rel L2 {orig_rel:.3e}; "
          f"{geo.blocks} blocks of {geo.warps} warps, {geo.blocks_per_sm} "
          f"resident an SM; {targets} targets, {dense:.4e} visits (dense: "
          f"every stored source of the 27 cells, the kernel's), {slots:.4e} "
          f"lane slots ({dense / max(slots, 1):.3f} live), {inside:.4e} "
          f"pairs inside r_cut, over {D} launch(es); bound {b_ms:.5f} ms "
          f"({b_by}) from the pairs inside")
    if not orig_rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"{tag}: the design before the redesign "
                             f"disagrees: {orig_rel}")
    return dict(row, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def cell_kernel_check(state, act, config, tag: str) -> dict:
    """[11] K6 in its one-plane and two-plane forms (``k6_check``) on the
    cell planes of ``state``; returns the two-plane form's numbers for the
    JSON line."""
    out = {}
    for form, launches in k6_one_device_launches(state, act,
                                                 config).items():
        kw = launches[0]
        phase(f"[11] {tag} K6 {form}: cell grid {kw['ncell']}^3, K {kw['K']}"
              + (f" against source K {kw['K_j']}" if "K_j" in kw else ""))
        out = k6_check(f"[11] {tag} K6 {form}", launches)
    return out


def _frozen_setup(state, cfg_run, frac: float, seed: int = 7,
                  stale: int = 0):
    """A plan frozen at ``state`` at the driver's frozen geometry for
    ``cfg_run`` and the positions drifted by frac * skin/2 in random
    directions, and ``stale`` particles moved a column side down in z
    beyond that: (plan, moved, geometry keywords, skin)."""
    from nbody_torch.driver.simulate import _frozen_geometry
    from nbody_torch.forces.p3m_columns import (
        freeze_column_plan,
        plane_geometry,
    )

    _, r_s, r_cut, ncell, ck, w, skin = _frozen_geometry(cfg_run)
    box = cfg_run.box
    plan = freeze_column_plan(state.pos, state.mass, box, r_cut, ncell, ck,
                              w, skin=skin)
    if int(plan.ov):
        raise AssertionError(f"the frozen plan overflows: {int(plan.ov)}")
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(state.pos.shape, generator=g, dtype=torch.float64)
    u = (u / u.norm(dim=1, keepdim=True)).to(state.pos)
    moved = state.pos + frac * 0.5 * skin * u
    if stale:
        moved[torch.randperm(moved.shape[0], generator=g)[:stale], 2] -= \
            box / ncell
    CK, gz, stride, W, maxch, chunk = plane_geometry(box, r_cut, ck, w)
    geo = dict(ncell=ncell, stride=stride, W=W, maxch=maxch, gz=gz,
               chunk=chunk)
    return plan, moved, geo, dict(r_s=r_s, r_cut=r_cut, ck=ck, w=w,
                                  CK=CK, skin=skin)


def masked_column_check(state, act, config, cfg_run, tag: str,
                        frac: float, stale: int = 0) -> dict:
    """K5 against its float64 plain version on the plan frozen at
    ``state`` (the driver's frozen geometry), at positions drifted by frac
    * skin/2 (and ``stale`` particles a column side past that, as the
    driver keeps up to stale_tolerance of them), for the chunks that hold
    an ``act`` particle; and K5 with every chunk listed against K4 on the
    same plane (equal bit for bit).  Returns K5's numbers for the JSON
    line."""
    from nbody_torch.forces.p3m_columns import (
        active_chunk_table,
        column_plane_plain,
        frozen_plane,
        launch_columns,
        run_column_plane,
        run_column_plane_masked,
    )

    plan, moved, geo, g = _frozen_setup(state, cfg_run, frac, stale=stale)
    box = config.box
    plane, interior, drift = frozen_plane(moved, state.mass, plan, box,
                                          g["r_cut"], geo["ncell"], g["CK"],
                                          geo["gz"], geo["stride"])
    nch_act, cht = active_chunk_table(act, plan, interior, CK=g["CK"],
                                      ncell=geo["ncell"], gz=geo["gz"],
                                      maxch=geo["maxch"], chunk=geo["chunk"])
    kw = _pair_kw(config, geo)
    # the plane's measured drift, as the frozen callers give the kernel
    kk = dict(box=box, drift=drift, **kw)
    got = run_column_plane_masked(plane, plan.ws, nch_act, cht, **kk)
    torch.cuda.synchronize()
    ref = column_plane_plain(plane.double(), plan.ws, nch_act, cht=cht, **kw)
    rel, err = rel_l2(got, ref), max_abs(got, ref)
    if not rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"K5 disagrees with its plain version: {rel}")
    libs = _columns_variants()

    def variant(name):
        return [launch_columns(libs[name], plane, plan.ws, nch_act, cht,
                               nx=geo["ncell"], **kk)]

    column_gates(f"[11] {tag} K5 at drift {frac:g} x skin/2"
                 + (f" and {stale} stale" if stale else ""), [got], [ref],
                 lambda: [run_column_plane_masked(plane, plan.ws, nch_act,
                                                  cht, **kk)], variant)
    if stale:
        # the drift a plan's skin/2 allows at most, as if no particle
        # were stale: the reach it gives can drop pairs (reported only)
        within = torch.full((), 0.25 * (box / geo["ncell"] - g["r_cut"]),
                            device=plane.device)
        err_within = target_err(run_column_plane_masked(
            plane, plan.ws, nch_act, cht, **dict(kk, drift=within)), ref)
        phase(f"[11] {tag}: {stale} particles moved {box / geo['ncell']:.2f}"
              f" Mpc down in z, measured drift {float(drift):.3f} Mpc; with "
              f"the drift of a plan's largest skin/2 ({float(within):.3f} "
              f"Mpc) in its place, the per-target error would read "
              f"{err_within:.3e}")
    ncol, maxch = geo["ncell"] ** 2, geo["maxch"]
    every = torch.arange(maxch, device=plane.device,
                         dtype=torch.int32).repeat(ncol)
    if not torch.equal(run_column_plane_masked(plane, plan.ws, plan.nch,
                                               every, **kk),
                       run_column_plane(plane, plan.ws, plan.nch, **kk)):
        raise AssertionError("K5 with every chunk listed differs from K4")
    ms = cuda_time_ms(
        lambda: run_column_plane_masked(plane, plan.ws, nch_act, cht, **kk),
        20)
    original_beside(f"[11] {tag} K5", ms, [ref], variant, 5)
    plain_ms = cuda_time_ms(lambda: column_plane_plain(
        plane, plan.ws, nch_act, cht=cht, **kw), 2)
    counts = torch.clamp_max(plan.counts, g["CK"]).to(torch.int32)
    targets = act[plan.src_g] & interior
    visits, inside, read, n_t = needed_work(plane, counts, targets=targets,
                                            **kw)
    # the particles behind the slots read: a ghost column is its periodic
    # image's, whose slot map (z ghosts included) is the plan's
    P = geo["ncell"] + 2
    fold = (torch.arange(P, device=plane.device) - 1) % geo["ncell"]
    image = (fold[:, None] * geo["ncell"] + fold[None, :]).reshape(-1)
    seen = torch.zeros(state.pos.shape[0], dtype=torch.bool,
                       device=plane.device)
    seen[plan.src_g[image][read]] = True
    n_src = int(seen.sum())
    b_ms, b_by = bound(needed_bytes(n_src, n_t),
                       visits * FLOPS_VISIT_COLUMNS + inside * FLOPS_INSIDE)
    reach, whole = reach_visits(plane, plan.ws, nch_act, cht=cht, **kk)
    phase(f"[11] {tag}: drift {frac:g} x skin/2 (skin {g['skin']:.3f} Mpc,"
          f" the measured drift {float(drift):.3f}), {int(act.sum())} active "
          f"particles in {int(nch_act.sum())} of {int(plan.nch.sum())} "
          f"chunks; K5 rel L2 {rel:.3e} (tol {FORCE_REL_L2_TOL:g}), max abs "
          f"{err:.3e}; every chunk listed == K4; kernel {ms:.4f} ms, plain "
          f"f32 {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); {visits:.4e}"
          f" visits of active targets within r_cut in z (the kernel's reach "
          f"by column_reach "
          f"{reach:.4e}, the whole windows {whole:.4e}), {inside:.4e} inside "
          f"r_cut, {n_src} sources read, {n_t} targets")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def frozen_supercell_check(state, config, cfg_run, tag: str) -> None:
    """K2 and K3 on the plane of a plan frozen at ``state`` at positions
    drifted by 0.999 skin/2 (which leave the box and the frozen columns):
    each against its plain version, the frozen deposit against the
    deposit of a fresh plane at the same positions (and a planted wrong
    wrap against the same, which must fail that limit), and the frozen
    evaluation (both halves, plain and interlaced) against a fresh one."""
    from nbody_torch.forces.pm import pm_module
    from nbody_torch.forces.pm_supercell import (
        deposit_node_masses_plain,
        fold_node_masses,
        fused_column_plane_plain,
        launch_fused,
        p3m_supercell_acc,
        p3m_supercell_frozen,
        run_fused_column_plane,
        supercell_deposit_from_plane,
        supercell_geometry,
    )
    from nbody_torch.forces.p3m_columns import (
        build_column_plane,
        frozen_plane,
    )

    plan, moved, geo, g = _frozen_setup(state, cfg_run, 0.999)
    box, nmesh, mass = config.box, config.mesh_size, state.mass
    ncell, stride, gz = geo["ncell"], geo["stride"], geo["gz"]
    S, ZP = supercell_geometry(nmesh, ncell)
    plane, _, drift = frozen_plane(moved, mass, plan, box, g["r_cut"], ncell,
                                   g["CK"], gz, stride)
    counts = torch.clamp_max(plan.counts, g["CK"]).to(torch.int32)
    fresh = build_column_plane(moved, mass, box, g["r_cut"], ncell, g["CK"],
                               geo["W"], chunk=geo["chunk"])
    if int(fresh[3]) or int(fresh[4]):
        raise AssertionError(f"[11] {tag}: the fresh plane overflows")
    # particles whose plane coordinates (freeze position + minimum-image
    # drift) lie outside the box
    d = torch.remainder(moved, box) - plan.pos0
    unwrapped = plan.pos0 + d - box * torch.round(d / box)
    outside = int(((unwrapped < 0) | (unwrapped >= box)).any(1).sum())
    dkw = dict(box=box, nmesh=nmesh, ncell=ncell, stride=stride, gz=gz)
    pkw = dict(ncell=ncell, S=S, ZP=ZP, stride=stride, gz=gz,
               scale=nmesh / box)
    for shift in (0.0, 0.5):
        rho = supercell_deposit_from_plane(plane, counts, shift=shift, **dkw)
        torch.cuda.synchronize()
        rho_f = supercell_deposit_from_plane(fresh[0], fresh[6], shift=shift,
                                             **dkw)
        top = float(rho_f.abs().max())
        err_f = max_abs(rho, rho_f) / top
        msg = (f"[11] {tag} K2 shift {shift}: max |node - the fresh plane's "
               f"deposit| / max {err_f:.3e}")
        err = 0.0
        if shift == 0.0:
            # the plain version's node grid reaches one node below the
            # column: exact up to one cell of drift unshifted, half a cell
            # at the half-cell shift (the driver's interlaced clamp)
            ref = fold_node_masses(deposit_node_masses_plain(
                plane, counts, shift=shift, **pkw), ncell=ncell, S=S, ZP=ZP,
                nmesh=nmesh)
            err = max_abs(rho, ref) / top
            msg += f", vs plain f32 {err:.3e}"
        phase(f"{msg} (tol {FROZEN_NODE_TOL:g} and {NODE_MASS_TOL:g}); "
              f"{outside} particles' plane coordinates outside [0, box)")
        if not (err <= NODE_MASS_TOL and err_f <= FROZEN_NODE_TOL):
            raise AssertionError(f"K2 on the frozen plane: {err}, {err_f}")
    k2_timing(f"[11] {tag} K2", [dict(plane=plane, counts=counts, nx=ncell,
                                      shift=0.0, row0=0, **dkw)])
    # planted wrong wraps: the frozen plane with the masses of particles
    # whose plane coordinates lie past the box's upper edge zeroed, as a
    # deposit that left their corners off the mesh reads; the particle
    # farthest out alone, and all of them.  Both must read above
    # FROZEN_NODE_TOL.
    past = (unwrapped - box).amax(1)
    n_past = int((past >= 0).sum())
    if n_past == 0:
        raise AssertionError(f"[11] {tag}: no plane coordinate past the box")
    far = torch.argsort(past, descending=True)
    rho_f = supercell_deposit_from_plane(fresh[0], fresh[6], **dkw)
    planted = []
    for sel in (far[:1], far[:n_past]):
        bad = plane.clone()
        bad[3, plan.gidx[sel]] = 0.0
        got = supercell_deposit_from_plane(bad, counts, **dkw)
        planted.append(max_abs(got, rho_f) / float(rho_f.abs().max()))
    phase(f"[11] {tag} K2 planted wrong wrap: max |node - the fresh plane's "
          f"deposit| / max {planted[0]:.3e} for the particle farthest past "
          f"the upper edge ({float(past[far[0]]):.3f} Mpc), {planted[1]:.3e}"
          f" for all {n_past} past it (tol {FROZEN_NODE_TOL:g})")
    if not min(planted) > FROZEN_NODE_TOL:
        raise AssertionError(f"a planted wrong wrap reads within the "
                             f"tolerance: {planted}")
    kw = _pair_kw(config, geo)
    mass_sum = torch.sum(mass)
    amp = 4.0 * math.pi * mass_sum / box**3
    split = config.force_split
    for il in (False, True):
        pm = pm_module(box, nmesh, config.deconvolve_p, il,
                       kw["r_s"] if split == "gaussian" else 0.0,
                       kw["r_cut"] if split == "spline" else 0.0,
                       config.pm_gradient, 0.0, mass.device, torch.float32)
        rho = supercell_deposit_from_plane(plane, counts, **dkw)
        rho1 = (supercell_deposit_from_plane(plane, counts, shift=0.5, **dkw)
                if il else None)
        grids = pm.force_grids_from_rho(rho, amp, mass_sum,
                                        rho1=rho1).contiguous()
        fkw = dict(S=S, scale=nmesh / box, split_out=True, interlaced=il,
                   **kw)
        got = run_fused_column_plane(plane, plan.ws, plan.nch, grids,
                                     drift=drift, **fkw)
        torch.cuda.synchronize()
        ref = fused_column_plane_plain(plane.double(), plan.ws, plan.nch,
                                       grids.double(), **fkw)
        column_gates(
            f"[11] {tag} K3 interlaced={il} split_out", [got], [ref],
            lambda: [run_fused_column_plane(plane, plan.ws, plan.nch, grids,
                                            drift=drift, **fkw)],
            lambda name: [launch_fused(_columns_variants()[name], plane,
                                       plan.ws, plan.nch, grids, nx=ncell,
                                       row0=0, box=box, drift=drift, **fkw)])
        rel = rel_l2(got, ref)
        ekw = dict(G=1.0, eps=config.eps, r_s=kw["r_s"], r_cut=kw["r_cut"],
                   deconvolve_p=config.deconvolve_p, split=split,
                   softening=config.softening_kernel, ncell=ncell,
                   col_capacity=g["ck"], window=g["w"],
                   grad_order=config.pm_gradient, part_split=True,
                   interlace=il)
        fz = p3m_supercell_frozen(moved, mass, plan, box, nmesh, **ekw)
        fr = p3m_supercell_acc(moved, mass, box, nmesh, **ekw)
        tot_fz, tot_fr = fz[0] + fz[1], fr[0] + fr[1]
        rel_fr = rel_l2(tot_fz, tot_fr.double())
        phase(f"[11] {tag} K3 interlaced={il} split_out: rel L2 {rel:.3e} vs"
              f" plain; frozen vs fresh evaluation at the same positions: "
              f"rel L2 {rel_fr:.3e} (tol {FORCE_REL_L2_TOL:g})")
        if not (rel <= FORCE_REL_L2_TOL and rel_fr <= FORCE_REL_L2_TOL
                and int(fz[2]) == 0 and int(fr[2]) == 0):
            raise AssertionError(f"K3 on the frozen plane: {rel}, {rel_fr}")


# [19] the slab domain decomposition: four shards on the one card
DOMAIN_SHARDS = 4
# the domain force against the single-device force of the same tier, per
# particle |g - g_ref| / |g_ref|: the JAX package's own limits
# (tests/test_domain.py:257, :930, :1024), set there on random
# positions: the median below 1e-5, the largest below 1e-4 (cells,
# columns) or 2e-4 (supercell).  At the Zel'dovich ICs a particle's force
# is a near cancellation (the smallest |g| ~1% of the median), and the
# float32 PM half of the two solves (a slab FFT against cuFFT's 3-D
# transform) differs by ~1e-5 of the median |g| at every particle, so a
# few particles read above those limits (the supercell tier's pair sums
# agree bit for bit).  There the domain force is held, as the tiers are
# held to each other in [8], to TIER_TOL of the largest |g|, and the JAX
# limits apply on uniform random positions of the same count.
DOMAIN_MEDIAN_TOL = 1e-5
DOMAIN_MAX_TOL = {"cells": 1e-4, "columns": 1e-4, "supercell": 2e-4}
# the devices=4 runs' P(k) at a = 1 against the single-device run of the
# same config, bin by bin, in three bands of k / k_Nyq: float32
# trajectories of the same ICs diverge at small scales: at 64^3 the
# single-device run against a repeat of itself reads up to 5.5e-4 in the
# top band (its bins reach the particle grid's own Nyquist scale), 1.6e-4
# below k_Nyq/4 and 3.7e-5 below k_Nyq/8, the domain runs against one
# device up to 9.2e-4, 1.5e-4 and 6.3e-5 (this phase and
# scripts/torch_profile_domain.py on the H100).  A domain fault that
# loses or misplaces force moves the large scales: particles dropped at
# the slab cuts (found with this phase, now fixed) read 2.2e-4 - 4.7e-4
# in the first four bins.
DOMAIN_PK_BANDS = ((1 / 8, 2e-4), (1 / 4, 1e-3), (1 / 2, 2e-3))


def domain_setup(state, config, tier: str):
    """``state`` decomposed into DOMAIN_SHARDS shards on the card, at the
    knobs the domain driver starts ``config`` from on ``tier``
    (``domain_column_knobs``), healed by the driver's own rule
    (``heal_domain``) until the tier's slab planes drop nothing at
    ``state``.  Returns (group, geom, shards, ck, cw, run.log lines)."""
    from nbody_torch.distributed import domain as td
    from nbody_torch.distributed.sharding import device_mesh
    from nbody_torch.driver.simulate import (
        HEAL_ATTEMPTS,
        domain_column_knobs,
        heal_domain,
    )
    from nbody_torch.forces.p3m import supercell_ncell
    from nbody_torch.forces.p3m_columns import column_window, encode_overflow

    D, box = DOMAIN_SHARDS, config.box
    group = device_mesh(D)
    geom = td.domain_p3m_geometry(box, config.mesh_size, D,
                                  config.n_particles,
                                  bucket_capacity=config.cell_capacity or None)
    shards = td.domain_decompose(state, group, box,
                                 td.slab_grid(geom, tier))
    ck, cw = domain_column_knobs(config, tier, geom)
    E = max(64, shards[0].pos.shape[0] // 8)
    pos, mass = [s.pos for s in shards], [s.mass for s in shards]
    lines = []
    for _ in range(HEAL_ATTEMPTS):
        if tier == "cells":
            ov = max(int(b[1]) for b in td.build_local_plane(
                pos, mass, box=box, r_cut=geom.r_cut, ncell=geom.ncell,
                group=group, capacity=geom.bucket_capacity))
        else:
            nct = (supercell_ncell(box, config.mesh_size, geom.r_cut)
                   if tier == "supercell" else geom.ncell)
            ov = max(int(encode_overflow(b[3], b[4]))
                     for b in td.build_local_column_plane(
                         pos, mass, box=box, r_cut=geom.r_cut, ncell=nct,
                         group=group, col_capacity=ck,
                         window=cw or column_window(box, geom.r_cut, ck)))
        if ov == 0:
            return group, geom, shards, ck, cw, lines
        geom, ck, cw, E, new = heal_domain(config, tier, geom, ck, cw, E, ov,
                                           0)
        lines += new
    raise AssertionError(f"the slab planes still overflow: {lines}")


def _mean_ms(fns, reps: int) -> float:
    """Device time of one call, averaged over calling every fn of ``fns``
    (one a shard) ``reps`` times."""
    return cuda_time_ms(lambda: [f() for f in fns], reps) / len(fns)


def _slab_row(errs, ms, plain_ms, nbytes, flops, D, lib_ms=None) -> dict:
    """A kernel row of a slab site: times per launch (the mean over the
    shards' launches), its bound the mean of the shards' bounds."""
    b_ms, b_by = bound(nbytes / D, flops / D)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def slab_supercell_check(state, config) -> dict:
    """[19](a) K2's and K3's slab sites on every shard's local column plane
    at the domain driver's supercell geometry: K2 against its float32
    plain version after the halo exchange (and a right halo plane left
    unsent, which must fail the same check), K3 plain, interlaced and
    split_out against its float64 plain version on the slab's haloed
    force grids (slices of the whole box's solve: the slab solve's
    values).  Returns the two rows for the JSON line."""
    from nbody_torch.distributed import domain as td
    from nbody_torch.forces.p3m import supercell_ncell
    from nbody_torch.forces.p3m_columns import column_window, plane_geometry
    from nbody_torch.forces.pm import pm_module
    from nbody_torch.forces.pm_supercell import (
        deposit_node_masses_plain,
        extract_local_subgrids,
        fold_slab_node_masses,
        fused_column_plane_plain,
        launch_fused,
        run_fused_column_plane,
        slab_halo_fold,
        supercell_deposit_from_plane,
        supercell_geometry,
    )

    group, geom, shards, ck, cw, lines = domain_setup(state, config,
                                                      "supercell")
    D, box, nmesh = group.size, config.box, config.mesh_size
    sc = supercell_ncell(box, nmesh, geom.r_cut)
    S, ZP = supercell_geometry(nmesh, sc)
    nx = sc // D
    CK, gz, stride, W, maxch, chunk = plane_geometry(
        box, geom.r_cut, ck, cw or column_window(box, geom.r_cut, ck))
    pos, mass = [s.pos for s in shards], [s.mass for s in shards]
    built = td.build_local_column_plane(
        pos, mass, box=box, r_cut=geom.r_cut, ncell=sc, group=group,
        col_capacity=CK, window=W, chunk=chunk)
    planes = [b[0] for b in built]
    counts = [b[6] for b in built]
    rows0 = [d * nx for d in range(D)]
    phase(f"[19] supercell slab planes: {D} shards of {nx} x {sc} columns, "
          f"capacity {CK}, window {W}, stride {stride}, chunk {chunk}"
          + "".join(f"; {x}" for x in lines))
    dkw = dict(box=box, nmesh=nmesh, ncell=sc, stride=stride, gz=gz,
               chunk=chunk, nx=nx)
    pkw = dict(ncell=sc, S=S, ZP=ZP, stride=stride, gz=gz,
               scale=nmesh / box, nx=nx)

    def plain_ext(p, c, r0, shift):
        return fold_slab_node_masses(
            deposit_node_masses_plain(p, c, shift=shift, row0=r0, **pkw),
            nx=nx, ncell=sc, S=S, ZP=ZP, nmesh=nmesh)

    k2_errs = []
    for shift in (0.0, 0.5):
        exts = [supercell_deposit_from_plane(p, c, shift=shift, row0=r0,
                                             **dkw)
                for p, c, r0 in zip(planes, counts, rows0)]
        torch.cuda.synchronize()
        got = torch.cat(slab_halo_fold(exts, group))
        ref = torch.cat(slab_halo_fold(
            [plain_ext(p, c, r0, shift)
             for p, c, r0 in zip(planes, counts, rows0)], group))
        scale_m = float(ref.abs().max())
        err = max_abs(got, ref) / scale_m
        unsent = [e.clone() for e in exts]
        for e in unsent:
            e[-2] = 0.0  # node nml deposited, never sent to the right
        bad = max_abs(torch.cat(slab_halo_fold(unsent, group)), ref) / scale_m
        phase(f"[19] K2 slab shift {shift}: max |node - plain f32| / max "
              f"{err:.3e} (tol {NODE_MASS_TOL:g}); planted unsent halo plane "
              f"{bad:.3e} (must exceed the tol); mass {float(got.sum()):.6e} "
              f"of {float(sum(m.sum() for m in mass)):.6e}")
        if not err <= NODE_MASS_TOL:
            raise AssertionError(f"K2 slab disagrees with its plain version: "
                                 f"{err}")
        if bad <= NODE_MASS_TOL:
            raise AssertionError(f"the K2 slab check missed an unsent halo "
                                 f"plane: {bad}")
        if shift == 0.0:
            rho = got
        k2_errs.append(max_abs(got, ref))
    n_real = sum(int(c.sum()) for c in counts)
    times = k2_timing("[19] K2 slab", [
        dict(plane=p, counts=c, row0=r0, shift=0.0,
             **{k: v for k, v in dkw.items() if k != "chunk"})
        for p, c, r0 in zip(planes, counts, rows0)])
    k2_ms = times["ms"]
    k2_plain_ms = _mean_ms([lambda p=p, c=c, r0=r0: plain_ext(p, c, r0, 0.0)
                            for p, c, r0 in zip(planes, counts, rows0)], 2)
    lib_ms = cuda_time_ms(lambda: td.slab_deposit(
        pos, mass, box=box, nmesh=nmesh, group=group), 20) / D
    nml = nx * S
    k2 = _slab_row(k2_errs, k2_ms, k2_plain_ms,
                   n_real * 16 + sum(c.numel() for c in counts) * 4
                   + D * (nml + 3) * nmesh**2 * 4, n_real * FLOPS_DEPOSIT, D,
                   lib_ms)
    k2.update(times)
    phase(f"[19] K2 slab: the call {k2_ms:.4f} ms a shard, plain f32 "
          f"{k2_plain_ms:.3f} ms, slab_deposit (index_add_) {lib_ms:.4f} ms "
          f"a shard, bound {k2['bound_ms']:.4f} ms ({k2['bound_by']}); "
          f"{n_real} particles over {D} shards")

    # the whole box's force grids from the slab deposit, cut into slabs
    mass_sum = torch.sum(rho)
    amp = 4.0 * math.pi * mass_sum / box**3
    kw = _pair_kw(config, dict(ncell=sc, stride=stride, W=W, maxch=maxch,
                               gz=gz, chunk=chunk, nx=nx))
    split = config.force_split
    halos = {}
    rho1 = torch.cat(slab_halo_fold(
        [supercell_deposit_from_plane(p, c, shift=0.5, row0=r0, **dkw)
         for p, c, r0 in zip(planes, counts, rows0)], group))
    for il in (False, True):
        pm = pm_module(box, nmesh, config.deconvolve_p, il,
                       kw["r_s"] if split == "gaussian" else 0.0,
                       kw["r_cut"] if split == "spline" else 0.0,
                       config.pm_gradient, 0.0, rho.device, torch.float32)
        grids = pm.force_grids_from_rho(rho, amp, mass_sum,
                                        rho1=rho1 if il else None)
        halos[il] = extract_local_subgrids(
            list(torch.chunk(grids.contiguous(), D, dim=1)), group)
    k3_errs = []
    libs = _columns_variants()
    for il, so in ((False, False), (True, False), (False, True)):
        fkw = dict(S=S, scale=nmesh / box, split_out=so, interlaced=il, **kw)
        args = list(zip(built, planes, halos[il], rows0))
        rels, gots, refs = [], [], []
        for b, p, h, r0 in args:
            got = run_fused_column_plane(p, b[1], b[2], h, row0=r0, **fkw)
            torch.cuda.synchronize()
            ref = fused_column_plane_plain(p.double(), b[1], b[2], h.double(),
                                           row0=r0, **fkw)
            rels.append(rel_l2(got, ref))
            gots.append(got)
            refs.append(ref)
            if not il and not so:
                k3_errs.append(max_abs(got, ref))
        phase(f"[19] K3 slab interlaced={il} split_out={so}: rel L2 per "
              f"shard {', '.join(f'{r:.3e}' for r in rels)} (tol "
              f"{FORCE_REL_L2_TOL:g})")
        if not max(rels) <= FORCE_REL_L2_TOL:
            raise AssertionError(f"K3 slab disagrees with its plain "
                                 f"version: {rels}")

        def variant(name, args=args, fkw=fkw):
            return [launch_fused(libs[name], p, b[1], b[2], h, row0=r0,
                                 box=box, drift=None, **fkw)
                    for b, p, h, r0 in args]

        column_gates(f"[19] K3 slab interlaced={il} split_out={so}", gots,
                     refs, lambda args=args, fkw=fkw: [run_fused_column_plane(
                         p, b[1], b[2], h, row0=r0, **fkw)
                         for b, p, h, r0 in args], variant)
        if not il and not so:
            refs0, variant0 = refs, variant
    fkw = dict(S=S, scale=nmesh / box, **kw)
    args = list(zip(built, planes, halos[False], rows0))
    k3_ms = _mean_ms([lambda b=b, p=p, h=h, r0=r0: run_fused_column_plane(
        p, b[1], b[2], h, row0=r0, **fkw) for b, p, h, r0 in args], 20)
    original_beside("[19] K3 slab", k3_ms, refs0, variant0, 5)
    k3_plain_ms = _mean_ms([lambda b=b, p=p, h=h, r0=r0:
                            fused_column_plane_plain(p, b[1], b[2], h,
                                                     row0=r0, **fkw)
                            for b, p, h, r0 in args], 1)
    visits = inside = n_t = nbytes = 0
    for b, p, h in zip(built, planes, halos[False]):
        v, i, _, t = needed_work(p, b[6], **kw)
        visits, inside, n_t = visits + v, inside + i, n_t + t
        nbytes += needed_bytes(t, t) + h.numel() * 4
    k3 = _slab_row(k3_errs, k3_ms, k3_plain_ms, nbytes,
                   visits * FLOPS_VISIT_COLUMNS + inside * FLOPS_INSIDE
                   + n_real * FLOPS_PM_READ, D)
    reach = [reach_visits(p, b[1], b[2], box=box, **kw)
             for b, p in zip(built, planes)]
    phase(f"[19] K3 slab: kernel {k3_ms:.4f} ms a launch, plain f32 "
          f"{k3_plain_ms:.3f} ms, bound {k3['bound_ms']:.4f} ms "
          f"({k3['bound_by']}); {visits:.4e} visits within r_cut in z over "
          f"{D} shards (the kernels' reach by column_reach "
          f"{sum(r[0] for r in reach):.4e}, "
          f"the whole windows {sum(r[1] for r in reach):.4e}), "
          f"{inside:.4e} inside r_cut")
    return {"K2s": k2, "K3s": k3}


def slab_columns_check(state, config) -> dict:
    """[19](a) K4's slab site on every shard's local column plane at the
    domain driver's columns geometry, against its float64 plain
    version."""
    from nbody_torch.distributed import domain as td
    from nbody_torch.forces.p3m_columns import (
        column_plane_plain,
        column_window,
        launch_columns,
        plane_geometry,
        run_column_plane,
    )

    group, geom, shards, ck, cw, lines = domain_setup(state, config,
                                                      "columns")
    D, box = group.size, config.box
    nx = geom.ncell // D
    CK, gz, stride, W, maxch, chunk = plane_geometry(
        box, geom.r_cut, ck, cw or column_window(box, geom.r_cut, ck))
    built = td.build_local_column_plane(
        [s.pos for s in shards], [s.mass for s in shards], box=box,
        r_cut=geom.r_cut, ncell=geom.ncell, group=group, col_capacity=CK,
        window=W, chunk=chunk)
    phase(f"[19] columns slab planes: {D} shards of {nx} x {geom.ncell} "
          f"columns, capacity {CK}, window {W}, stride {stride}, chunk "
          f"{chunk}" + "".join(f"; {x}" for x in lines))
    kw = _pair_kw(config, dict(ncell=geom.ncell, stride=stride, W=W,
                               maxch=maxch, gz=gz, chunk=chunk, nx=nx))
    rels, errs, gots, refs = [], [], [], []
    for b in built:
        got = run_column_plane(b[0], b[1], b[2], box=box, **kw)
        torch.cuda.synchronize()
        ref = column_plane_plain(b[0].double(), b[1], b[2], **kw)
        rels.append(rel_l2(got, ref))
        errs.append(max_abs(got, ref))
        gots.append(got)
        refs.append(ref)
    phase(f"[19] K4 slab: rel L2 per shard {', '.join(f'{r:.3e}' for r in rels)}"
          f" (tol {FORCE_REL_L2_TOL:g})")
    if not max(rels) <= FORCE_REL_L2_TOL:
        raise AssertionError(f"K4 slab disagrees with its plain version: "
                             f"{rels}")
    libs = _columns_variants()

    def variant(name):
        return [launch_columns(libs[name], b[0], b[1], b[2], None, box=box,
                               drift=None, **kw) for b in built]

    column_gates("[19] K4 slab", gots, refs, lambda: [run_column_plane(
        b[0], b[1], b[2], box=box, **kw) for b in built], variant)
    ms = _mean_ms([lambda b=b: run_column_plane(b[0], b[1], b[2], box=box,
                                                **kw)
                   for b in built], 20)
    original_beside("[19] K4 slab", ms, refs, variant, 5)
    plain_ms = _mean_ms([lambda b=b: column_plane_plain(b[0], b[1], b[2],
                                                        **kw)
                         for b in built], 1)
    visits = inside = nbytes = 0
    for b in built:
        v, i, _, t = needed_work(b[0], b[6], **kw)
        visits, inside, nbytes = visits + v, inside + i, \
            nbytes + needed_bytes(t, t)
    row = _slab_row(errs, ms, plain_ms, nbytes,
                    visits * FLOPS_VISIT_COLUMNS + inside * FLOPS_INSIDE, D)
    phase(f"[19] K4 slab: kernel {ms:.4f} ms a launch, plain f32 "
          f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); {visits:.4e} visits within r_cut in z over "
          f"{D} shards, {inside:.4e} inside r_cut")
    return {"K4s": row}


def slab_cells_check(state, config, tag: str = "[19] K6 slab",
                     timed: bool = True) -> dict:
    """[19](a) K6's slab site on every shard's cell plane of ``state``
    (the domain geometry's bucket capacity, healed by the driver's rule),
    with ``k6_check``'s gates."""
    launches, geo = k6_slab_launches(state, config)
    phase(f"{tag}: cell slab planes: {geo}")
    return {"K6s": k6_check(tag, launches, timed=timed)}


def domain_force_check(state, config, tier: str, single_knobs: dict,
                       per_particle: bool) -> None:
    """[19](b) the domain force of ``tier`` (DOMAIN_SHARDS shards, the
    domain driver's knobs at ``state``) against the single-device force
    of the same tier (``single_knobs``: its capacity and window), rows
    matched by position: per particle within the JAX package's limits
    (``per_particle``), else to TIER_TOL of the largest force."""
    from nbody_torch.core import units
    from nbody_torch.distributed import domain as td
    from nbody_torch.forces.p3m import p3m_acc

    group, geom, shards, ck, cw, _ = domain_setup(state, config, tier)
    box, nmesh, a = config.box, config.mesh_size, 0.5
    fkw = dict(split=config.force_split, softening=config.softening_kernel,
               interlace=config.interlace, deconvolve_p=config.deconvolve_p,
               grad_order=config.pm_gradient)
    acc_fn, _ = td.make_domain_p3m_force(
        config.cosmology(), box, nmesh, group, config.eps,
        config.n_particles, bucket_capacity=geom.bucket_capacity,
        shortrange=tier, col_capacity=ck or None, col_window=cw or None,
        **fkw)
    g, ov = acc_fn([s.pos for s in shards], [s.mass for s in shards], a)
    g = torch.cat([x[s.mass > 0] for x, s in zip(g, shards)]).double()
    ref, ov1 = p3m_acc(state.pos, state.mass, box, nmesh, G=units.COSMO.G,
                       eps=config.eps, shortrange=tier, with_overflow=True,
                       **single_knobs, **fkw)
    if int(ov) or int(ov1):
        raise AssertionError(f"[19] {tier} force overflows ({int(ov)}, "
                             f"{int(ov1)})")
    # the domain's rows: each slab's particles in their original order
    xgrid = td.slab_grid(geom, tier)
    slab = td._slab_of(state.pos[:, 0].cpu(), box, xgrid,
                       xgrid // group.size).numpy()
    perm = np.argsort(slab, kind="stable")
    ref = (ref / a).double()[torch.as_tensor(perm, device=ref.device)]
    rel = (g - ref).norm(dim=1) / torch.clamp_min(ref.norm(dim=1), 1e-12)
    med, worst = float(rel.median()), float(rel.max())
    scale = float((g - ref).norm(dim=1).max() / ref.norm(dim=1).max())
    small = float(ref.norm(dim=1)[rel.argmax()] / ref.norm(dim=1).median())
    where = ("random positions" if per_particle else "the ICs")
    gate = (f"per particle median tol {DOMAIN_MEDIAN_TOL:g}, max tol "
            f"{DOMAIN_MAX_TOL[tier]:g}" if per_particle
            else f"max |diff| / max |g| tol {TIER_TOL:g}")
    phase(f"[19] {tier} domain force ({group.size} shards) vs one device at "
          f"{where}, N={config.n_particles}: per particle median {med:.3e}, "
          f"max {worst:.3e} (at |g| = {small:.3e} of the median); max "
          f"|diff| / max |g| {scale:.3e} ({gate})")
    ok = (med < DOMAIN_MEDIAN_TOL and worst < DOMAIN_MAX_TOL[tier]
          if per_particle else scale <= TIER_TOL)
    if not ok:
        raise AssertionError(f"[19] {tier} domain force disagrees at "
                             f"{where}: {med}, {worst}, {scale}")


def domain_run(cfg, tag: str, single: dict) -> dict:
    """[19](c) ``run_simulation(cfg)`` with no device argument on
    DOMAIN_SHARDS shards: launches of the tier's slab sites = D x the
    force evaluations counted from run.log (heals included), a finite
    state at a = 1, and P(k) at a = 1 against the single-device run of
    the same config (``single``: its powerspec, wall, steps/s and peak
    memory) bin by bin for k <= k_Nyq/2.  Returns the launch counts."""
    from nbody_torch.driver.simulate import _domain_tier, run_simulation

    work = os.path.join(OUT, f"domain_{tag}")
    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = run_simulation(cfg, 0, work)
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**20
    lines = run_log(work)
    tier = _domain_tier(cfg, cfg.devices)
    m = [re.match(r"Domain force evaluations: (\d+) on (\d+) shards", x)
         for x in lines]
    evals = next(int(x.group(1)) for x in m if x)
    segments = sum(1 for x in lines if x.startswith("Time step"))
    heals = sum(1 for x in lines if "re-running" in x)
    if evals != cfg.n_steps + segments + rerun_evals(lines):
        raise AssertionError(f"[19] {tag}: {evals} evaluations, but "
                             f"{cfg.n_steps} steps + {segments} segments + "
                             f"{rerun_evals(lines)} repeated")
    for line in lines:
        if ("Domain" in line or "re-running" in line or "Energy" in line
                or "Capacity" in line):
            phase(f"    run.log: {line}")
    check_run_outputs(res, cfg, f"[19] {tag}")
    D = cfg.devices
    want = zero_launches(
        K2=D * evals if tier == "supercell" else 0,
        K3=D * evals if tier == "supercell" else 0,
        K4=D * evals if tier == "columns" else 0,
        K6=D * evals if tier == "cells" else 0)
    if counts != want:
        raise AssertionError(f"[19] {tag}: launches {counts}, expected {want}")
    bands = pk_bands(res.powerspecs[0], single["pk"], cfg, f"[19] {tag}")
    phase(f"[19] {tag} ({tier} tier, {D} shards): {cfg.n_steps} steps in "
          f"{res.wall_s:.3f} s ({cfg.n_steps / res.wall_s:.2f} steps/s), "
          f"{heals} heals, peak device memory {peak:.1f} MiB; one device: "
          f"{single['wall']:.3f} s ({cfg.n_steps / single['wall']:.2f} "
          f"steps/s), {single['mem']:.1f} MiB; launches {counts} = {D} x "
          f"{evals} evaluations; P(k) vs one device, max rel "
          + bands_text(bands))
    check_bands(bands, f"[19] {tag}")
    return counts


# ---------------------------------------------------------------------------
# [20] rungs on the slab domain decomposition
# ---------------------------------------------------------------------------

# the devices=4 rung runs' rung populations at a = 1 against the
# single-device rung run of the same config: each rung's count within 1%
# of N (the 16^3 runs against the JAX package's are held to POP_TOL)
DOMAIN_POP_TOL = 0.01


def shard_rows(values, state, box: float, ncell: int, shards: list) -> list:
    """A per-particle tensor of ``state`` as the rows of the slab-resident
    ``shards`` that domain_decompose made of it on the ``ncell`` grid:
    each slab's particles in their original order, then the empty slots
    (zeros)."""
    from nbody_torch.distributed import domain as td

    D = len(shards)
    slab = td._slab_of(state.pos[:, 0].cpu(), box, ncell,
                       ncell // D).to(values.device)
    out = []
    for d, s in enumerate(shards):
        v = values[slab == d]
        pad = torch.zeros((s.pos.shape[0] - v.shape[0],) + tuple(
            v.shape[1:]), dtype=v.dtype, device=v.device)
        out.append(torch.cat([v, pad]).to(s.pos.device))
    return out


def slab_sources_read(read, plans: list, d: int, *, ncell: int,
                      nxl: int) -> int:
    """The distinct particles behind the plane slots that shard d's pair
    sum reads (``read``: ((nxl + 2) P, stride) bool): the interior x-rows
    are the shard's own columns, the ghost x-rows its neighbours' edge
    rows, and a y-ghost column is its periodic image; each plan's slot
    map (z ghosts included) names the particle."""
    D, P = len(plans), ncell + 2
    dev = read.device
    iy = (torch.arange(P, device=dev) - 1) % ncell
    seen = {}
    for px in range(nxl + 2):
        owner = (d - 1) % D if px == 0 else (d + 1) % D if px == nxl + 1 \
            else d
        lx = nxl - 1 if px == 0 else 0 if px == nxl + 1 else px - 1
        plan = plans[owner]
        if owner not in seen:
            seen[owner] = torch.zeros(plan.pos0.shape[0], dtype=torch.bool,
                                      device=dev)
        r = read[px * P:(px + 1) * P]
        seen[owner][plan.src_g[lx * ncell + iy][r]] = True
    return sum(int(v.sum()) for v in seen.values())


def frozen_slab_setup(state, cfg, cfg_run):
    """``state`` on DOMAIN_SHARDS shards with every shard's frozen local
    plan at the geometry the domain driver gives ``cfg``'s run
    (``domain_frozen_knobs`` with the run's healed capacity and window,
    its grown skin if it grew one), healed by the driver's rule
    (``heal_domain_frozen``) until no plan's word is nonzero.  Returns
    (group, geom, shards, plans, knobs, run.log lines)."""
    from nbody_torch.distributed import domain as td
    from nbody_torch.distributed.sharding import device_mesh
    from nbody_torch.driver.simulate import (
        HEAL_ATTEMPTS,
        domain_frozen_knobs,
        heal_domain_frozen,
    )
    from nbody_torch.forces.p3m_columns import freeze_local_column_plan

    D, box = DOMAIN_SHARDS, cfg.box
    group = device_mesh(D)
    geom = td.domain_p3m_geometry(box, cfg.mesh_size, D, cfg.n_particles)
    skin, ck, cw = domain_frozen_knobs(cfg, geom, cfg_run.column_capacity)
    if cfg_run.column_skin > 0.0:
        skin = cfg_run.column_skin
    cw = max(cw, cfg_run.column_window)
    if skin <= 0.0:
        raise AssertionError(f"{cfg}: no frozen plans at this geometry")
    shards = td.domain_decompose(state, group, box, geom.ncell)
    lines = []
    for _ in range(HEAL_ATTEMPTS):
        plans = freeze_local_column_plan(
            [s.pos for s in shards], [s.mass for s in shards], box=box,
            r_cut=geom.r_cut, ncell=geom.ncell, group=group,
            col_capacity=ck, window=cw, skin=skin)
        ov = max(int(pl.ov) for pl in plans)
        if ov == 0:
            return group, geom, shards, plans, dict(
                ck=ck, cw=cw, skin=skin), lines
        ck, cw, skin, new, _ = heal_domain_frozen(cfg, geom, ck, cw, skin,
                                                  ov, 0)
        lines += new
    raise AssertionError(f"the frozen slab plans still overflow: {lines}")


def k5_slab_check(res, cfg) -> dict:
    """[20](a) K5's slab site on every shard's frozen local plan of the
    cfg64 rung run's final state (the driver's geometry), the targets the
    particles above rung 0 there (the rung rule of [11]): at the freeze
    positions and at a drift of 0.999 skin/2, against the float64 plain
    version; times and the bound at the drift."""
    from nbody_torch.forces.p3m_columns import (
        _frozen_buf,
        _local_plane_from_buf,
        active_chunk_table,
        column_plane_plain,
        launch_columns,
        plane_geometry,
        run_column_plane_masked,
    )

    group, geom, shards, plans, knobs, lines = frozen_slab_setup(
        res.state, cfg, res.config_run)
    D, box = group.size, cfg.box
    nxl = geom.ncell // D
    CK, gz, stride, W, maxch, chunk = plane_geometry(
        box, geom.r_cut, knobs["ck"], knobs["cw"])
    act = shard_rows(rung_mask(res.state, cfg.replace(devices=1)),
                     res.state, box, geom.ncell, shards)
    act = [a & (s.mass > 0) for a, s in zip(act, shards)]
    phase(f"[20] frozen slab plans of the 64^3 rung run's final state: {D} "
          f"shards of {nxl} x {geom.ncell} columns, capacity {CK}, window "
          f"{W}, stride {stride}, skin {knobs['skin']:.4f} Mpc; "
          f"{sum(int(a.sum()) for a in act)} active particles"
          + "".join(f"; {x}" for x in lines))
    kw = _pair_kw(cfg, dict(ncell=geom.ncell, stride=stride, W=W,
                            maxch=maxch, gz=gz, chunk=chunk, nx=nxl))
    libs = _columns_variants()
    for frac in (0.0, 0.999):
        gen = torch.Generator().manual_seed(20)
        moved = []
        for s in shards:
            u = torch.randn(tuple(s.pos.shape), generator=gen,
                            dtype=torch.float64)
            u = (u / u.norm(dim=1, keepdim=True)).to(s.pos)
            moved.append(s.pos + frac * 0.5 * knobs["skin"] * u)
        frozen = [_frozen_buf(p, s.mass, pl, box, geom.r_cut, CK, gz, stride)
                  for p, s, pl in zip(moved, shards, plans)]
        planes = [pl for pl, _ in _local_plane_from_buf(
            [b for b, _, _ in frozen], box=box, r_cut=geom.r_cut,
            ncell=geom.ncell, group=group, stride=stride)]
        tables = [active_chunk_table(a, pl, f[1], CK=CK, nx=nxl,
                                     ncell=geom.ncell, gz=gz, maxch=maxch,
                                     chunk=chunk)
                  for a, pl, f in zip(act, plans, frozen)]
        # the measured drift, the largest of the shards', as the frozen
        # caller gives the kernel
        kks = [dict(box=box, drift=dr, **kw)
               for dr in group.pmax([f[2] for f in frozen])]
        rels, errs, gots, refs = [], [], [], []
        args = list(zip(planes, plans, tables, kks))
        for plane, pl, (nch_act, cht), kk in args:
            got = run_column_plane_masked(plane, pl.ws, nch_act, cht, **kk)
            torch.cuda.synchronize()
            ref = column_plane_plain(plane.double(), pl.ws, nch_act, cht=cht,
                                     **kw)
            rels.append(rel_l2(got, ref))
            errs.append(max_abs(got, ref))
            gots.append(got)
            refs.append(ref)
        phase(f"[20] K5 slab at drift {frac:g} x skin/2: rel L2 per shard "
              f"{', '.join(f'{r:.3e}' for r in rels)} (tol "
              f"{FORCE_REL_L2_TOL:g}); {sum(int(t[0].sum()) for t in tables)}"
              f" of {sum(int(pl.nch.sum()) for pl in plans)} chunks active")
        if not max(rels) <= FORCE_REL_L2_TOL:
            raise AssertionError(f"K5 slab disagrees with its plain version "
                                 f"at drift {frac}: {rels}")

        def variant(name, args=args):
            return [launch_columns(libs[name], p, pl.ws, t[0], t[1], **kk)
                    for p, pl, t, kk in args]

        column_gates(f"[20] K5 slab at drift {frac:g} x skin/2", gots, refs,
                     lambda args=args: [run_column_plane_masked(
                         p, pl.ws, t[0], t[1], **kk)
                         for p, pl, t, kk in args], variant)
    launch = [lambda p=p, pl=pl, t=t, kk=kk: run_column_plane_masked(
        p, pl.ws, t[0], t[1], **kk) for p, pl, t, kk in args]
    ms = _mean_ms(launch, 20)
    original_beside("[20] K5 slab", ms, refs, variant, 5)
    plain_ms = _mean_ms([lambda p=p, pl=pl, t=t: column_plane_plain(
        p, pl.ws, t[0], cht=t[1], **kw)
        for p, pl, t in zip(planes, plans, tables)], 1)
    visits = inside = nbytes = 0
    for d, (plane, pl, a, f) in enumerate(zip(planes, plans, act, frozen)):
        counts = torch.clamp_max(pl.counts, CK).to(torch.int32)
        v, i, read, n_t = needed_work(plane, counts,
                                      targets=a[pl.src_g] & f[1], **kw)
        n_src = slab_sources_read(read, plans, d, ncell=geom.ncell, nxl=nxl)
        visits, inside = visits + v, inside + i
        nbytes += needed_bytes(n_src, n_t)
    row = _slab_row(errs, ms, plain_ms, nbytes,
                    visits * FLOPS_VISIT_COLUMNS + inside * FLOPS_INSIDE, D)
    reach = [reach_visits(p, pl.ws, t[0], cht=t[1], **kk)
             for p, pl, t, kk in args]
    phase(f"[20] K5 slab: kernel {ms:.4f} ms a launch, plain f32 "
          f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); {visits:.4e} visits of active targets "
          f"within r_cut in z over {D} shards (the kernels' reach by "
          f"column_reach "
          f"{sum(r[0] for r in reach):.4e}, the whole windows "
          f"{sum(r[1] for r in reach):.4e}), {inside:.4e} inside r_cut")
    return {"K5s": row}


def k6_masked_slab_check(state, act, cfg, tcap: int, tag: str,
                         timed: bool = True) -> dict:
    """[20](b) K6's two-plane slab site on every shard of ``state``: the
    plane of the ``act`` particles (capacity ``tcap``, the run's rung
    capacity) against the slab's cell plane, with ``k6_check``'s gates."""
    launches, geo = k6_masked_slab_launches(state, act, cfg, tcap)
    phase(f"{tag}: masked cell slab planes: {geo}")
    return {"K6ms": k6_check(tag, launches, timed=timed)}


def planted_hazards_check(res, cfg) -> None:
    """[20](c) the two hazards the port makes loud, planted in the cfg64
    rung run's final state at the driver's frozen geometry: a massive
    particle moved into the next shard's slab with no exchange must raise
    its plan's non-resident count (the bucket field of the word) and the
    rung runner's plan channel, and a drift of 1.01 skin/2 must be counted
    by local_plan_stale; the sound plans and positions read 0."""
    from nbody_torch.distributed import domain as td
    from nbody_torch.forces.p3m_columns import (
        freeze_local_column_plan,
        local_plan_stale,
    )

    group, geom, shards, plans, knobs, _ = frozen_slab_setup(
        res.state, cfg, res.config_run)
    D, box, skin = group.size, cfg.box, knobs["skin"]
    fkw = dict(box=box, r_cut=geom.r_cut, ncell=geom.ncell, group=group,
               col_capacity=knobs["ck"], window=knobs["cw"], skin=skin)
    pos = [s.pos.clone() for s in shards]
    row = int(torch.nonzero(shards[0].mass > 0)[0])
    pos[0][row, 0] = 1.5 * box / D
    planted = freeze_local_column_plan(pos, [s.mass for s in shards], **fkw)
    words = [int(pl.ov) for pl in planted]
    stale = []
    for frac in (0.0, 1.01):
        moved = [s.pos.clone() for s in shards]
        for p in moved:
            p[:64, 0] += frac * 0.5 * skin
        stale.append([int(local_plan_stale(p, pl, box, skin))
                      for p, pl in zip(moved, plans)])
    # one step of the run's own last step size, from its final state
    from nbody_torch.integrate.cosmo_stepping import log_a_steps

    a0 = float(res.state.time)
    a_last = log_a_steps(cfg.a_begin, cfg.a_end, cfg.n_steps)[-2:]
    a_step = [a0, a0 * float(a_last[1] / a_last[0])]
    kw = dict(box=box, nmesh=cfg.mesh_size, eps=cfg.eps,
              n_global=cfg.n_particles, geom=geom, split=cfg.force_split,
              softening=cfg.softening_kernel, rungs=cfg.rungs,
              eta_disp=cfg.step_eta_disp, eta_acc=cfg.step_eta_acc,
              target_capacity=res.config_run.rung_capacity or 128,
              rung_frozen=True, col_capacity=knobs["ck"],
              col_window=knobs["cw"], column_skin=skin)
    runs = {}
    for tag, p in (("sound", [s.pos for s in shards]), ("planted", pos)):
        st = [s.replace(pos=x) for s, x in zip(shards, p)]
        runs[tag] = td.run_cosmological_domain(st, cfg.cosmology(), a_step,
                                               group, **kw)
    phase(f"[20] planted hazards: non-resident massive particle -> plan "
          f"words {words} (sound {[int(pl.ov) for pl in plans]}), rung "
          f"runner plan channel {runs['planted'].plan_overflow} (sound "
          f"{runs['sound'].plan_overflow}, {runs['planted'].plan_freezes} "
          f"freeze); local_plan_stale per shard undrifted {stale[0]}, 64 "
          f"rows drifted 1.01 x skin/2 {stale[1]}")
    if not (words[0] >> 16 >= 1 and all(int(pl.ov) == 0 for pl in plans)
            and runs["planted"].plan_overflow >> 16 >= 1
            and runs["sound"].plan_overflow == 0
            and runs["planted"].plan_freezes == 1):
        raise AssertionError("[20] the non-resident particle is not counted")
    if not (stale[0] == [0] * D and min(stale[1]) >= 64):
        raise AssertionError(f"[20] the drift past skin/2 is not counted: "
                             f"{stale}")


def domain_rung_run(cfg, tag: str, **kw):
    """[20] ``run_simulation(cfg)`` with rungs on DOMAIN_SHARDS shards,
    every launch count reset before and read after: K5's launches must be
    D x the frozen-plan interior evaluations and K6's (the one-plane
    boundary and the two-plane masked interior forms) D x the boundary and
    masked interior evaluations, each counted from run.log: a boundary
    evaluation per step and per segment, an interior one per sub-tick j
    whose deepest populated rung is >= rung_active_min(j), on the route
    its segment finished on (frozen plans until a heal moves column_skin
    to 0), and those repeated after heals.  Returns (result, run numbers
    for the report)."""
    from nbody_torch.driver.simulate import run_simulation
    from nbody_torch.integrate.cosmo_stepping import rung_active_min

    work = os.path.join(OUT, f"domain_rungs_{tag}")
    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = run_simulation(cfg, 0, work, **kw)
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**20
    lines = run_log(work)
    R, D = cfg.rungs, cfg.devices
    route = ("frozen" if "frozen rung plans" in next(
        x for x in lines if x.startswith("Domain decomposition"))
        else "masked")
    interior = {"frozen": 0, "masked": 0}
    for line in lines:
        if "healing column_skin to 0" in line:
            route = "masked"
        if "Rung population" in line:
            deepest = len(line.split("matter:")[1].split(",")) - 1
            interior[route] += sum(1 for j in range(1, 2 ** (R - 1))
                                   if deepest >= rung_active_min(j, R))
    segments = sum(1 for x in lines
                   if re.match(r"Time step\s+\d+\s+a = \S+\s+\(\d+ steps", x))
    m = next(re.match(r"Domain rung stepping: (\d+) boundary, (\d+) "
                      r"frozen-plan interior and (\d+) masked interior force "
                      r"evaluations, (\d+) plan freezes", x) for x in lines
             if x.startswith("Domain rung stepping"))
    B, F, M, Z = (int(x) for x in m.groups())
    want_b = cfg.n_steps + segments + rerun_evals(lines)
    want_f = interior["frozen"] + rerun_evals(lines, "frozen-plan interior")
    want_m = interior["masked"] + rerun_evals(lines, "masked interior")
    if (B, F, M) != (want_b, want_f, want_m):
        raise AssertionError(f"[20] {tag}: run.log counts {(B, F, M)}, the "
                             f"populations give {(want_b, want_f, want_m)}")
    want = zero_launches(K5=D * F, K6=D * (B + M))
    if counts != want:
        raise AssertionError(f"[20] {tag}: launches {counts}, expected {want}")
    check_run_outputs(res, cfg, f"[20] {tag}")
    final = "masked" if res.config_run.column_skin == 0.0 else route
    for line in lines:
        if ("Domain" in line or "re-running" in line or "drift note" in line
                or "Capacity" in line or "pre-warming" in line):
            phase(f"    run.log: {line}")
    return res, dict(B=B, F=F, M=M, Z=Z, peak=peak, route=final,
                     heals=sum(1 for x in lines if "re-running" in x),
                     pops=rung_populations(lines), counts=counts)


def domain_rung_vs_single(cfg, tag: str, single: dict) -> tuple:
    """[20](d) a full-width rung run on DOMAIN_SHARDS shards against the
    single-device rung run of the same config (``single``: its P(k) file,
    wall, peak memory and populations at a = 1): P(k) at a = 1 in
    DOMAIN_PK_BANDS and each rung's count at a = 1 within DOMAIN_POP_TOL of
    N.  Returns (result, run numbers)."""
    res, run = domain_rung_run(cfg, tag)
    bands = pk_bands(res.powerspecs[0], single["pk"], cfg, f"[20] {tag}")
    pops, ref = run["pops"][-1], single["pops"]
    n = max(len(pops), len(ref))
    dpop = max(abs(a - b) for a, b in zip(pops + [0] * (n - len(pops)),
                                          ref + [0] * (n - len(ref))))
    phase(f"[20] {tag} ({DOMAIN_SHARDS} shards, interior ticks finished on "
          f"the {run['route']} route, stale_max {res.stale_max}): "
          f"{cfg.n_steps} steps in {res.wall_s:.3f} s "
          f"({cfg.n_steps / res.wall_s:.2f} steps/s), {run['heals']} heals, "
          f"{run['Z']} plan freezes, peak device memory {run['peak']:.1f} MiB; one device: "
          f"{single['wall']:.3f} s ({cfg.n_steps / single['wall']:.2f} "
          f"steps/s), {single['mem']:.1f} MiB; evaluations {run['B']} "
          f"boundary, {run['F']} frozen-plan and {run['M']} masked interior;"
          f" launches {run['counts']}; populations at a = 1 {pops} vs one "
          f"device {ref} (largest difference {dpop}, tol "
          f"{DOMAIN_POP_TOL * cfg.n_particles:g}); P(k) vs one device, max "
          f"rel " + bands_text(bands))
    check_bands(bands, f"[20] {tag}")
    if not dpop <= DOMAIN_POP_TOL * cfg.n_particles:
        raise AssertionError(f"[20] {tag}: populations differ by {dpop}")
    return res, run


# ---------------------------------------------------------------------------
# [21] the ring and replicated-grid forces of sharding.py
# ---------------------------------------------------------------------------

#: [21](a) the float64 check of the ring force: every this-many-th target
RING_F64_STRIDE = 64


def pk_bands(got_path: str, ref_path: str, cfg, tag: str) -> list:
    """(band fraction of k_Nyq, tol, bins, max rel difference) of the P(k)
    file ``got_path`` against ``ref_path`` in each of DOMAIN_PK_BANDS;
    raises if the bins differ (:func:`check_bands` holds the limits)."""
    got_pk, ref_pk = np.loadtxt(got_path), np.loadtxt(ref_path)
    if not np.array_equal(got_pk[:, 1], ref_pk[:, 1]):
        raise AssertionError(f"{tag}: P(k) bins differ")
    rel_pk = np.abs(got_pk[:, 2] / ref_pk[:, 2] - 1.0)
    k_nyq = np.pi * cfg.mesh_size / cfg.box
    bands, lo = [], 0.0
    for frac, tol in DOMAIN_PK_BANDS:
        sel = (ref_pk[:, 0] > lo) & (ref_pk[:, 0] <= frac * k_nyq)
        bands.append((frac, tol, int(sel.sum()), float(rel_pk[sel].max())))
        lo = frac * k_nyq
    return bands


def bands_text(bands: list) -> str:
    return ", ".join(f"{m:.3e} at {n} bins to k_Nyq*{f:g} (tol {t:g})"
                     for f, t, n, m in bands)


def check_bands(bands: list, tag: str) -> None:
    for f, t, _, m in bands:
        if not m <= t:
            raise AssertionError(f"{tag}: P(k) differs from one device by "
                                 f"{m} up to k_Nyq*{f:g}")


def ring_site_check(n: int, steps: int, k7_run: dict) -> tuple[dict, int]:
    """[21](a) K7's ring site: the ring force of plummer(n) on
    DOMAIN_SHARDS shards of the card at the ICs against the single-device
    allpairs_pallas and against float64 on every RING_F64_STRIDE-th
    target; one launch (N/D targets against a visiting block of N/D
    sources) against its float32 plain version, timed; then ``steps``
    steps of [17]'s drive with the ring force: |dE/E|, momentum and K7
    launches = D^2 x (steps + 1).  Returns (the row, the launches)."""
    from nbody_torch.distributed.sharding import device_mesh, make_ring_acc_fn
    from nbody_torch.forces.pallas_pp import (
        allpairs_pallas,
        block_acc_pallas,
        pp_block_plain,
    )
    from nbody_torch.ic import systems

    eps, D = 0.05, DOMAIN_SHARDS
    ring = make_ring_acc_fn(device_mesh(D), eps)
    st = systems.plummer(n, seed=0)
    pos, mass = st.pos, st.mass
    acc, phi = ring(pos, mass)
    acc1, phi1 = allpairs_pallas(pos, mass, eps)
    torch.cuda.synchronize()
    r1 = max(rel_l2(acc, acc1.double()), rel_l2(phi, phi1.double()))
    sub = torch.arange(0, n, RING_F64_STRIDE, device=pos.device)
    raw, pot = pp_block_plain(pos[sub].double(), pos.double(), mass.double(),
                              eps)
    phi_ref = -(pot - mass[sub].double() / eps)
    r64 = max(rel_l2(acc[sub], raw), rel_l2(phi[sub], phi_ref))
    phase(f"[21] ring force ({D} shards) at plummer({n}): vs one device "
          f"rel L2 {r1:.3e}, vs float64 at {sub.numel()} targets {r64:.3e} "
          f"(tol {FORCE_REL_L2_TOL:g})")
    if not max(r1, r64) <= FORCE_REL_L2_TOL:
        raise AssertionError(f"[21] the ring force disagrees: {r1}, {r64}")

    nl = n // D
    blk = [(pos[d * nl:(d + 1) * nl], mass[d * nl:(d + 1) * nl])
           for d in range(D)]
    pi, (pj, mj) = blk[0][0], blk[D - 1]
    got = block_acc_pallas(pi, pj, mj, eps)
    torch.cuda.synchronize()
    plain = pp_block_plain(pi, pj, mj, eps)
    rel = max(rel_l2(got[0], plain[0].double()),
              rel_l2(got[1], plain[1].double()))
    err = max(max_abs(got[0], plain[0]), max_abs(got[1], plain[1]))
    if not rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"[21] a ring launch disagrees: {rel}")
    k7_shape_check("[21]", pi, pj, mj, eps)
    ms = _mean_ms([lambda d=d, h=h: block_acc_pallas(
        blk[d][0], blk[(d - h) % D][0], blk[(d - h) % D][1], eps)
        for d in range(D) for h in range(D)], 5)
    plain_ms = cuda_time_ms(lambda: pp_block_plain(pi, pj, mj, eps), 1,
                            warm=False)
    b_ms, b_by = bound(12 * nl + 16 * nl + 16 * nl, FLOPS_PAIR_K7 * nl * nl)
    phase(f"[21] K7 ring launch ({nl} x {nl}): rel L2 vs plain f32 "
          f"{rel:.3e} (tol {FORCE_REL_L2_TOL:g}), max abs {err:.3e}; kernel "
          f"{ms:.4f} ms a launch ({nl * nl / ms * 1e3:.4e} interactions/s), "
          f"plain f32 {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")

    run = plummer_run(n, steps, ring)
    phase(plummer_line("[21] ring", n, steps, run, PLUMMER_DRIFT_TOL)
          + f"; {1e3 / run['steps_per_s']:.2f} ms a step against one "
          f"device's {1e3 / k7_run['steps_per_s']:.2f} ([17])")
    launches = D * D * (steps + 1)
    want = zero_launches(K7b=launches)
    if run["counts"] != want or not run["sound"]:
        raise AssertionError(f"[21] ring launches {run['counts']}, expected "
                             f"{want}; sound {run['sound']}")
    if not (run["drift"] < PLUMMER_DRIFT_TOL and run["mom"] < MOMENTUM_TOL):
        raise AssertionError(f"[21] ring |dE/E| {run['drift']}, |P| "
                             f"{run['mom']}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None), launches


def sharded_p3m_fn(cfg, group, **kw):
    """The replicated-grid P3M force of ``cfg`` (its eps, split and
    softening) on ``group``."""
    from nbody_torch.distributed.sharding import make_sharded_p3m_cosmo_force

    return make_sharded_p3m_cosmo_force(
        cfg.cosmology(), cfg.box, cfg.mesh_size, group, eps=cfg.eps,
        split=cfg.force_split, softening=cfg.softening_kernel, **kw)


def replicated_grid_check(state, cfg) -> dict:
    """[21](b) K6's replicated-grid site at ``state``: every shard's
    x-slab of the whole cell plane (the default capacity, doubled until
    the plane drops nothing) with ``k6_check``'s gates, timed; the sharded
    P3M force against the single-device cells tier at ``state`` and on
    uniform positions.  Returns the row."""
    from nbody_torch.core import units
    from nbody_torch.distributed.sharding import device_mesh
    from nbody_torch.driver.simulate import prewarm_capacity
    from nbody_torch.forces.p3m import p3m_acc

    D = DOMAIN_SHARDS
    box, nmesh, n = cfg.box, cfg.mesh_size, cfg.n_particles
    launches, geo = k6_replicated_launches(state, cfg)
    phase(f"[21] replicated grid: {geo}")
    row = k6_check("[21] K6 replicated-grid site at the ICs", launches)

    # the force against one device's cells tier, as [19] holds the domain
    # force: at the ICs to TIER_TOL of the largest |g|, and per particle
    # within the JAX package's limits on uniform positions of the same
    # count (at the ICs a particle whose pulls cancel has a tiny |g|, and
    # its relative error says nothing of the sum)
    a = 0.5
    gen = torch.Generator().manual_seed(21)
    rnd = (torch.rand(tuple(state.pos.shape), generator=gen,
                      dtype=torch.float64) * box).to(state.pos.device,
                                                     torch.float32)
    cells = cfg.replace(shortrange="cells")
    for pos, per_particle in ((state.pos, False), (rnd, True)):
        grown, _ = prewarm_capacity(cells, cells, pos)
        ref, ov1 = p3m_acc(pos, state.mass, box, nmesh, G=units.COSMO.G,
                           eps=cfg.eps, shortrange="cells",
                           split=cfg.force_split,
                           softening=cfg.softening_kernel,
                           capacity=grown.cell_capacity or None,
                           with_overflow=True)
        g, ov = sharded_p3m_fn(cfg, device_mesh(D),
                               capacity=grown.cell_capacity or None,
                               checked=True)(pos, state.mass, a)
        if int(ov) or int(ov1):
            raise AssertionError(f"[21] overflow: {int(ov)}, {int(ov1)}")
        ref = (ref / a).double()
        rel = (g.double() - ref).norm(dim=1) / torch.clamp_min(
            ref.norm(dim=1), 1e-12)
        med, worst = float(rel.median()), float(rel.max())
        scale = float((g.double() - ref).norm(dim=1).max()
                      / ref.norm(dim=1).max())
        small = float(ref.norm(dim=1)[rel.argmax()] / ref.norm(dim=1).median())
        where = "random positions" if per_particle else "the ICs"
        gate = (f"per particle median tol {DOMAIN_MEDIAN_TOL:g}, max tol "
                f"{DOMAIN_MAX_TOL['cells']:g}" if per_particle
                else f"max |diff| / max |g| tol {TIER_TOL:g}")
        phase(f"[21] sharded P3M ({D} shards) vs one device's cells tier at "
              f"{where}, N={n}: per particle median {med:.3e}, max "
              f"{worst:.3e} (at |g| = {small:.3e} of the median); max "
              f"|diff| / max |g| {scale:.3e} ({gate})")
        ok = (med < DOMAIN_MEDIAN_TOL and worst < DOMAIN_MAX_TOL["cells"]
              if per_particle else scale <= TIER_TOL)
        if not ok:
            raise AssertionError(f"[21] sharded P3M disagrees at {where}: "
                                 f"{med}, {worst}, {scale}")
    return row


def sharded_p3m_vs_jax(noise) -> None:
    """[21](b) the sharded P3M at the JAX package's 16^3 ICs against its
    committed make_sharded_p3m_cosmo_force output, to TIER_TOL of max
    |g|."""
    from nbody_torch.distributed.sharding import (
        device_mesh,
        make_sharded_p3m_cosmo_force,
    )
    from nbody_torch.driver import SimulationConfig
    from nbody_torch.driver.simulate import realize_ics

    c16 = SimulationConfig(n_side=16)
    pos, want = np.load(os.path.join(PORT_DATA,
                                     "sharded_p3m_n16_d4_seed0.npy"))
    mass = realize_ics(c16, 0, noise=noise).mass
    g = make_sharded_p3m_cosmo_force(
        c16.cosmology(), c16.box, c16.mesh_size, device_mesh(DOMAIN_SHARDS),
        eps=c16.eps, split=c16.force_split)(
            torch.as_tensor(pos, device=mass.device), mass, c16.a_begin)
    want = torch.as_tensor(want, dtype=torch.float64, device=g.device)
    err = float((g.double() - want).norm(dim=1).max()
                / want.norm(dim=1).max())
    phase(f"[21] sharded P3M at the JAX 16^3 ICs vs the committed JAX force: "
          f"max |diff| / max |g| {err:.3e} (tol {TIER_TOL:g})")
    if not err <= TIER_TOL:
        raise AssertionError(f"[21] sharded P3M differs from JAX: {err}")


def sharded_p3m_run(cfg, state, single_pk: str) -> int:
    """[21](b) ``cfg``'s log-a steps from ``state`` through
    run_cosmological_checked with the checked replicated-grid force, in
    the driver's stretches of SAMPLE_EVERY_STEPS steps: a stretch that
    dropped force doubles the capacity and re-runs (the driver's heal).
    K6 launches = D x evaluations, re-runs included; a finite state at
    a = 1 whose P(k) is within DOMAIN_PK_BANDS of the single-device cells
    run (``single_pk``).  Returns the launches."""
    from nbody_torch.distributed.sharding import (
        device_mesh,
        sharded_p3m_geometry,
    )
    from nbody_torch.driver.simulate import (
        HEAL_ATTEMPTS,
        SAMPLE_EVERY_STEPS,
        measure_powerspec,
    )
    from nbody_torch.integrate.cosmo_stepping import (
        log_a_steps,
        run_cosmological_checked,
    )
    from nbody_torch.mesh.cells import cell_capacity

    D = DOMAIN_SHARDS
    group = device_mesh(D)
    cosmo = cfg.cosmology()
    _, _, ncell, _ = sharded_p3m_geometry(cfg.box, cfg.mesh_size, D)
    cap = cell_capacity(cfg.n_particles, ncell)
    a_grid = log_a_steps(cfg.a_begin, cfg.a_end, cfg.n_steps)
    heals, evals = [], 0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i0 in range(0, cfg.n_steps, SAMPLE_EVERY_STEPS):
        a_seg = a_grid[i0:i0 + SAMPLE_EVERY_STEPS + 1]
        for _ in range(HEAL_ATTEMPTS):
            fn = sharded_p3m_fn(cfg, group, capacity=cap, checked=True)
            new, ov = run_cosmological_checked(state, cosmo, a_seg, fn,
                                               cfg.box)
            evals += len(a_seg)
            if ov == 0:
                break
            heals.append(f"a = {a_seg[0]:.4f}: {ov} particles dropped at "
                         f"capacity {cap}, doubling to {2 * cap}")
            cap *= 2
        else:
            raise AssertionError(f"[21] capacity heals exhausted: {heals}")
        state = new
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    for line in heals:
        phase(f"    [21] heal: {line}")
    want = zero_launches(K6=D * evals)
    if counts != want:
        raise AssertionError(f"[21] sharded P3M run launches {counts}, "
                             f"expected {want}")
    st = state
    if not (st.pos.shape == (cfg.n_particles, 3)
            and all(bool(torch.isfinite(t).all()) for t in (st.pos, st.vel))
            and abs(float(st.time) - cfg.a_end) <= 1e-6):
        raise AssertionError("[21] the sharded P3M run is not finite at "
                             "a = 1")
    path = os.path.join(OUT, "cfg64_sharded_p3m", "powerspec_a=1.00")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    measure_powerspec(st.pos, cfg, cfg.a_end, path=path, seed=0)
    tag = "[21] cfg64 sharded P3M"
    bands = pk_bands(path, single_pk, cfg, tag)
    phase(f"{tag} ({D} shards, {ncell}^3 cells): {cfg.n_steps} steps in "
          f"{wall:.3f} s ({cfg.n_steps / wall:.2f} steps/s), {len(heals)} "
          f"heals, final capacity {cap}; launches {counts} = {D} x {evals} "
          f"evaluations; P(k) vs one device's cells run, max rel "
          + bands_text(bands))
    check_bands(bands, tag)
    return counts["K6"]


def planted_capacity_check(state, cfg) -> None:
    """[21](d) the replicated-grid force at ``state`` with capacity 8 must
    report dropped particles."""
    from nbody_torch.distributed.sharding import device_mesh

    _, ov = sharded_p3m_fn(cfg, device_mesh(DOMAIN_SHARDS), capacity=8,
                           checked=True)(state.pos, state.mass, 0.5)
    phase(f"[21] planted capacity 8 at the 64^3 ICs: overflow word {int(ov)}"
          f" (must be > 0)")
    if not int(ov) > 0:
        raise AssertionError("[21] the planted overflow is not reported")


def ring_ewald_check(noise, single_pk: str) -> None:
    """[21](c) solver='pp' with devices=4 through run_simulation with no
    device argument on the default 32^3 config: its force at the ICs
    against the single-device Ewald force, its P(k) at a = 1 within
    DOMAIN_PK_BANDS of the single-device PP run of [16] (``single_pk``),
    no kernel launched (the ring Ewald's real-space block is torch ops,
    as in the JAX package); the 16^3 run from the JAX noise against the
    JAX package's P(k)."""
    from nbody_torch.core import units
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import (
        build_cosmo_force,
        realize_ics,
        run_simulation,
    )
    from nbody_torch.forces.ewald import ewald_pp_acc

    D = DOMAIN_SHARDS
    cfg = SimulationConfig(solver="pp", devices=D,
                           output=OutputConfig(snapshot=False))
    ics = realize_ics(cfg, 0)
    a = cfg.a_begin
    ring = build_cosmo_force(cfg)
    g = ring(ics.pos, ics.mass, a) * a
    ref = ewald_pp_acc(ics.pos, ics.mass, cfg.box, eps=cfg.eps,
                       G=units.COSMO.G, softening=cfg.softening_kernel)
    rel = rel_l2(g, ref.double())
    ring_ms = cuda_time_ms(lambda: ring(ics.pos, ics.mass, a), 3)
    one_ms = cuda_time_ms(lambda: ewald_pp_acc(
        ics.pos, ics.mass, cfg.box, eps=cfg.eps, G=units.COSMO.G,
        softening=cfg.softening_kernel), 3)
    phase(f"[21] ring Ewald ({D} shards) at the 32^3 ICs vs one device's "
          f"ewald_pp_acc: rel L2 {rel:.3e} (tol {FORCE_REL_L2_TOL:g}); an "
          f"evaluation {ring_ms:.3f} ms against {one_ms:.3f} ms")
    if not rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"[21] the ring Ewald force disagrees: {rel}")

    work = os.path.join(OUT, "default_pp_d4")
    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    res = run_simulation(cfg, 0, work)
    counts = read_launches()
    check_run_outputs(res, cfg, "[21] default PP d4")
    tag = "[21] default PP on 4 devices"
    bands = pk_bands(res.powerspecs[0], single_pk, cfg, tag)
    phase(f"{tag}: {cfg.n_steps} steps in {res.wall_s:.3f} s "
          f"({cfg.n_steps / res.wall_s:.2f} steps/s); launches {counts}; "
          f"P(k) vs one device, max rel " + bands_text(bands))
    check_bands(bands, tag)
    if counts != zero_launches():
        raise AssertionError(f"[21] the ring Ewald run launched {counts}")

    c16 = SimulationConfig(n_side=16, solver="pp", devices=D,
                           output=OutputConfig(snapshot=False))
    work16 = os.path.join(OUT, "n16_pp_d4")
    shutil.rmtree(work16, ignore_errors=True)
    r16 = run_simulation(c16, 0, work16,
                         initial_state=realize_ics(c16, 0, noise=noise))
    pk_vs_reference(r16, c16, "powerspec_a=1.00_n16_pp_d4_seed0",
                    "[21] 16^3 PP on 4 devices from the JAX noise")


# ---------------------------------------------------------------------------
# [22] the subcycled KDK and the slab-resident ICs
# ---------------------------------------------------------------------------

# [22](a) the domain ICs on the card against the JAX package's from the
# same float32 noise: float32 arithmetic in both, other FFTs, so positions
# and momenta within 1e-5 of their largest magnitude (a few ulp of a
# 500 Mpc position); the realized spectrum per bin to 1e-5 (measured on
# the CPU: 6e-7)
DOMAIN_IC_TOL = 1e-5


def domain_ic_check() -> None:
    """[22](a) ``lpt_ic_domain`` and ``realized_spectrum_domain`` on four
    shards of the card from the JAX package's per-slab noise, against its
    committed ICs (orders 1 and 2) and table."""
    from nbody_torch.distributed.ic import lpt_ic_domain
    from nbody_torch.distributed.measure import realized_spectrum_domain
    from nbody_torch.distributed.sharding import device_mesh
    from nbody_torch.driver import SimulationConfig
    from nbody_torch.driver.simulate import (
        _linear_power_fn,
        _measurement_options,
    )
    from nbody_torch.ic.gaussian import GRFSpec

    D = DOMAIN_SHARDS
    cfg = SimulationConfig(n_side=16)
    noise = np.load(os.path.join(PORT_DATA,
                                 f"white_noise_n16_domain{D}_seed0.npy"))
    group = device_mesh(D)
    spec = GRFSpec(nmesh=cfg.n_side, box=cfg.box)
    cosmo = cfg.cosmology()
    power = _linear_power_fn(cosmo, cfg.transfer)
    for order in (1, 2):
        ref = np.load(os.path.join(
            PORT_DATA, f"lpt_ic_domain_n16_domain{D}_order{order}_seed0.npz"))
        t0 = time.perf_counter()
        shards, ov = lpt_ic_domain(0, spec, power, cosmo, cfg.a_begin, group,
                                   order=order, noise=list(noise))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = [int((s.mass > 0).sum()) for s in shards]
        if ov or counts != ref["counts"].tolist() or \
                shards[0].pos.shape[0] != int(ref["capacity"]):
            raise AssertionError(f"[22] domain ICs order {order}: overflow "
                                 f"{ov}, shard counts {counts} against "
                                 f"{ref['counts'].tolist()}")
        pos = torch.cat([s.pos[:c] for s, c in zip(shards, counts)])
        vel = torch.cat([s.vel[:c] for s, c in zip(shards, counts)])
        d = pos.double().cpu().numpy() - ref["pos"]
        d -= cfg.box * np.round(d / cfg.box)
        ep = float(np.abs(d).max()) / float(np.abs(ref["pos"]).max())
        ev = float(np.abs(vel.double().cpu().numpy() - ref["vel"]).max()) \
            / float(np.abs(ref["vel"]).max())
        mass_ok = all(bool((s.mass[:c] == float(ref["mass"])).all())
                      and bool((s.mass[c:] == 0).all())
                      for s, c in zip(shards, counts))
        phase(f"[22] lpt_ic_domain order {order} on {D} shards of the card "
              f"from the JAX noise: {wall:.3f} s; shard counts {counts} of "
              f"{shards[0].pos.shape[0]} rows; max |dpos| / max |pos| "
              f"{ep:.3e}, max |dvel| / max |vel| {ev:.3e} (tol "
              f"{DOMAIN_IC_TOL:g}); masses {'exact' if mass_ok else 'DIFFER'};"
              f" exchange overflow {ov}")
        if not (ep <= DOMAIN_IC_TOL and ev <= DOMAIN_IC_TOL and mass_ok):
            raise AssertionError(f"[22] domain ICs order {order} differ "
                                 f"from the JAX package's")
    table = np.loadtxt(os.path.join(PORT_DATA,
                                    f"realized_spectrum_n16_domain{D}"
                                    f"_seed0.txt"))
    got = realized_spectrum_domain(0, spec, power, group,
                                   _measurement_options(cfg)[0],
                                   noise=list(noise))
    same = np.array_equal(got.n_modes.cpu().numpy(), table[:, 1])
    m = table[:, 1] > 0
    rel = float(np.abs(got.power.cpu().numpy()[m] / table[m, 2] - 1).max())
    phase(f"[22] realized_spectrum_domain from the JAX noise: {int(m.sum())}"
          f" populated bins, modes {'equal' if same else 'DIFFER'}, max rel "
          f"{rel:.3e} (tol {DOMAIN_IC_TOL:g})")
    if not (same and rel <= DOMAIN_IC_TOL):
        raise AssertionError("[22] the realized spectrum differs from JAX's")


def subcycled_counts(lines: list[str]) -> dict:
    """run.log's "Subcycled stepping" counts: long, short, frozen, both,
    refreezes, reads."""
    line = next(x for x in lines if x.startswith("Subcycled stepping"))
    m = re.search(r"(\d+) long, (\d+) short, (\d+) frozen-plan short and "
                  r"(\d+) fused force evaluations, (\d+) plan refreezes, "
                  r"(\d+) host reads", line)
    keys = ("long", "short", "frozen", "both", "refreezes", "reads")
    return dict(zip(keys, (int(x) for x in m.groups())))


def subcycled_run(cfg, tag: str) -> tuple:
    """[22](b) ``run_simulation(cfg)`` with subcycles, every launch count
    reset before and read after: the evaluations the run must have made,
    counted from run.log's stretches and heals (a fused or long evaluation
    a step and one at each attempt of a stretch, n_sub - 1 short ones a
    step on the plan or fresh, a drift read before each evaluation on the
    plan), held to the run's own counts, and the launches held to those:
    K2 = K3 = the fused evaluations and K4 = the short ones on the
    supercell tier (its fused tick on the carried plan), K1 = both kinds
    on the dense tier.  Returns (result, launches, run.log counts)."""
    from nbody_torch.driver.simulate import (
        _resolved_shortrange,
        run_simulation,
    )

    work = os.path.join(OUT, tag)
    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = run_simulation(cfg, 0, work)
    counts = read_launches()
    lines = run_log(work)
    c = subcycled_counts(lines)
    n_sub = cfg.subcycles
    stretches = sum(1 for x in lines if x.startswith("Time step"))
    heals = sum(1 for x in lines if "re-running" in x)
    steps_run = c["both"] - stretches - heals
    tier = _resolved_shortrange(cfg)
    frozen = tier in ("columns", "supercell")
    want_c = dict(long=0, both=cfg.n_steps + stretches + rerun_evals(lines),
                  short=0 if frozen else (n_sub - 1) * steps_run,
                  frozen=(n_sub - 1) * steps_run if frozen else 0,
                  reads=n_sub * steps_run if frozen else 0)
    if any(c[k] != v for k, v in want_c.items()):
        raise AssertionError(f"[22] {tag}: run.log counts {c}, expected "
                             f"{want_c}")
    if tier == "supercell":
        want = zero_launches(K2=c["both"], K3=c["both"],
                             K4=c["short"] + c["frozen"])
    elif tier == "allpairs":
        want = zero_launches(K1=c["short"] + c["both"])
    else:
        raise AssertionError(f"[22] {tag}: unexpected tier {tier}")
    if counts != want:
        raise AssertionError(f"[22] {tag}: launches {counts}, expected "
                             f"{want}")
    check_run_outputs(res, cfg, f"[22] {tag}")
    for line in lines:
        if ("pre-warming" in line or "re-running" in line
                or "Capacity heals" in line or "Subcycled" in line):
            phase(f"    {tag} run.log: {line}")
    pre = sum(1 for x in lines if "pre-warming" in x)
    phase(f"[22] {tag} ({tier} tier, subcycles={n_sub}): N="
          f"{cfg.n_particles} mesh {cfg.mesh_size} {cfg.n_steps} steps in "
          f"{res.wall_s:.3f} s ({cfg.n_steps / res.wall_s:.2f} steps/s), "
          f"{stretches} stretches, {pre} pre-warms, {heals} heals, "
          f"{c['refreezes']} plan refreezes, {c['reads']} host reads of the "
          f"drift predicate, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches "
          f"{counts} = the evaluations counted; column_capacity "
          f"{res.config_run.column_capacity}, column_window "
          f"{res.config_run.column_window}")
    return res, counts, c


def frozen_columns_check(state, config, cfg_run, tag: str,
                         frac: float) -> dict:
    """[22](c) K4 at its frozen site (``p3m_short_columns_frozen``) against
    its float64 plain version, on the plan frozen at ``state`` at the
    driver's frozen geometry for ``cfg_run`` (the interior subcycles'
    plan, ``build_cosmo_force_frozen``) with the positions drifted by frac
    x skin/2, through :func:`column_gates`; the design before the redesign
    timed beside it.  Returns its numbers for the JSON line."""
    from nbody_torch.forces.p3m_columns import (
        column_plane_plain,
        frozen_plane,
        launch_columns,
        run_column_plane,
    )

    plan, moved, geo, g = _frozen_setup(state, cfg_run, frac)
    box = config.box
    plane, _, drift = frozen_plane(moved, state.mass, plan, box, g["r_cut"],
                                   geo["ncell"], g["CK"], geo["gz"],
                                   geo["stride"])
    kw = _pair_kw(config, geo)
    kk = dict(box=box, drift=drift, **kw)
    got = run_column_plane(plane, plan.ws, plan.nch, **kk)
    torch.cuda.synchronize()
    ref = column_plane_plain(plane.double(), plan.ws, plan.nch, **kw)
    rel, err = rel_l2(got, ref), max_abs(got, ref)
    phase(f"[22] {tag} K4 frozen at drift {frac:g} x skin/2 (skin "
          f"{g['skin']:.3f} Mpc, the measured drift {float(drift):.3f}; "
          f"column grid {geo['ncell']}^2, capacity {g['CK']}, window "
          f"{geo['W']}): rel L2 {rel:.3e} (tol {FORCE_REL_L2_TOL:g}), max "
          f"abs {err:.3e}")
    if not rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"[22] K4 frozen disagrees with its plain "
                             f"version: {rel}")
    libs = _columns_variants()

    def variant(name):
        return [launch_columns(libs[name], plane, plan.ws, plan.nch, None,
                               nx=geo["ncell"], **kk)]

    column_gates(f"[22] {tag} K4 frozen", [got], [ref],
                 lambda: [run_column_plane(plane, plan.ws, plan.nch, **kk)],
                 variant)
    ms = cuda_time_ms(lambda: run_column_plane(plane, plan.ws, plan.nch,
                                               **kk), 20)
    original_beside(f"[22] {tag} K4 frozen", ms, [ref], variant, 5)
    plain_ms = cuda_time_ms(lambda: column_plane_plain(plane, plan.ws,
                                                       plan.nch, **kw), 2)
    counts = torch.clamp_max(plan.counts, g["CK"]).to(torch.int32)
    visits, inside, _, n_t = needed_work(plane, counts, **kw)
    b_ms, b_by = bound(needed_bytes(n_t, n_t),
                       visits * FLOPS_VISIT_COLUMNS + inside * FLOPS_INSIDE)
    reach, whole = reach_visits(plane, plan.ws, plan.nch, **kk)
    phase(f"[22] {tag} K4 frozen: kernel {ms:.4f} ms, plain f32 "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); {visits:.4e} "
          f"visits within r_cut in z (the kernel's reach by column_reach "
          f"{reach:.4e}, the whole windows {whole:.4e}), {inside:.4e} inside "
          f"r_cut")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def domain_subcycled_run(cfg, tag: str) -> tuple:
    """[22](d) ``run_simulation(cfg)`` with subcycles on DOMAIN_SHARDS
    shards: the evaluations counted from run.log (a far-field evaluation
    a step and one at each attempt of a segment, the fused ones all but
    the attempts' first; a short one at each attempt's start and n_sub - 1
    a step) held to the run's own counts, the slab sites' launches (K2 =
    K3 = D x the fused, K4 = D x the short) to those; no exchange
    overflow, neither in the ICs (the driver raises on it) nor in a
    step.  Returns (result, launches)."""
    from nbody_torch.driver.simulate import _domain_tier, run_simulation

    work = os.path.join(OUT, f"domain_{tag}")
    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = run_simulation(cfg, 0, work)
    counts = read_launches()
    lines = run_log(work)
    m = next(re.search(r"(\d+) far-field \((\d+) of them fused with the "
                       r"last subcycle's short force\) and (\d+) short-range",
                       x) for x in lines
             if x.startswith("Domain subcycled stepping"))
    total, fused, short = (int(x) for x in m.groups())
    segments = sum(1 for x in lines if x.startswith("Time step"))
    heals = sum(1 for x in lines if "re-running" in x)
    attempts = segments + heals
    n_sub = cfg.subcycles
    tier = _domain_tier(cfg, cfg.devices)
    if tier != "supercell":
        raise AssertionError(f"[22] {tag}: tier {tier}")
    steps_run = total - attempts
    want_c = (cfg.n_steps + segments + rerun_evals(lines), steps_run,
              attempts + (n_sub - 1) * steps_run)
    if (total, fused, short) != want_c:
        raise AssertionError(f"[22] {tag}: run.log counts "
                             f"{(total, fused, short)}, expected {want_c}")
    D = cfg.devices
    want = zero_launches(K2=D * fused, K3=D * fused, K4=D * short)
    if counts != want:
        raise AssertionError(f"[22] {tag}: launches {counts}, expected "
                             f"{want}")
    exchange_heals = sum(1 for x in lines if "slab-exchange overflow" in x)
    if exchange_heals:
        raise AssertionError(f"[22] {tag}: {exchange_heals} exchange "
                             f"overflows")
    check_run_outputs(res, cfg, f"[22] {tag}")
    for line in lines:
        if ("Domain" in line or "re-running" in line or "Capacity" in line
                or "Initial" in line):
            phase(f"    {tag} run.log: {line}")
    phase(f"[22] {tag} ({tier} tier, {D} shards, subcycles={n_sub}, ICs "
          f"{cfg.ic_realization}): {cfg.n_steps} steps in {res.wall_s:.3f} s"
          f" ({cfg.n_steps / res.wall_s:.2f} steps/s), {heals} heals, "
          f"exchange overflow 0, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches "
          f"{counts} = {D} x ({fused} fused, {short} short) evaluations")
    return res, counts


# ---------------------------------------------------------------------------
# [23] adaptive time stepping, after the deterministic CIC deposit
# ---------------------------------------------------------------------------

#: [23](0) the float32 deposit against the float64 deposit of the same
#: positions: the largest node difference over the largest node.  The
#: float32 cell coordinate x nmesh / box rounds by up to 7.6e-6 at mesh
#: 128 (half an ulp of 64-128), and every corner weight carries it
DEPOSIT_TOL = 3e-5
#: [23](c) the compact kicks' capacity: N / 8, above cfg64's rows on
#: rungs >= 1 at every step (22,878 at a = 1), so that the run heals
#: nothing and its wall compares with the full-N run's (the doubling heal
#: is tests/test_torch_adaptive.py's)
COMPACT_CAPACITY = 32768
#: [23](a) the JAX package's committed adaptive 16^3 runs: tag -> the
#: change to the 16^3 config (the rung runs start at a = 0.3, as [14])
ADAPTIVE_16 = {
    "adaptive": {},
    "adaptive_sub4": dict(subcycles=4),
    "adaptive_rungs3": dict(rungs=3, a_begin=0.3, n_steps=6),
    "domain4_adaptive_rungs2": dict(rungs=2, a_begin=0.3, n_steps=6,
                                    devices=4),
}


def deposit_check(tag: str, pos, mass, box: float, nmesh: int) -> dict:
    """[23](0) the CIC deposit at a run's shape: two calls equal bit for
    bit, the float32 grid against the float64 one, and its time beside
    the ``index_add_`` form it replaced (in turns: old, new, new, old),
    with whether two calls of that form are equal."""
    from nbody_torch.mesh.cic import _cic_corners, cic_deposit

    def new():
        return cic_deposit(pos, box, nmesh, weights=mass)

    def old():
        lin, w = _cic_corners(pos, box, nmesh)
        flat = torch.zeros(nmesh**3, device=pos.device, dtype=pos.dtype)
        flat.index_add_(0, lin.reshape(-1), (w * mass).reshape(-1))
        return flat.reshape(nmesh, nmesh, nmesh)

    a, b = new(), new()
    same = bool(torch.equal(a, b))
    ref = cic_deposit(pos.double(), box, nmesh, weights=mass.double())
    err = float((a.double() - ref).abs().max() / ref.abs().max())
    old_same = bool(torch.equal(old(), old()))
    reps = 20
    t_old = [cuda_time_ms(old, reps)]
    t_new = [cuda_time_ms(new, reps), cuda_time_ms(new, reps)]
    t_old.append(cuda_time_ms(old, reps))
    out = dict(new_ms=float(np.mean(t_new)), old_ms=float(np.mean(t_old)),
               err=err, same=same, old_same=old_same)
    phase(f"[23] deposit {tag} (N={pos.shape[0]}, mesh {nmesh}): two calls "
          f"equal bit for bit: {same}; max |f32 - f64| / max {err:.3e} (tol "
          f"{DEPOSIT_TOL:g}); fixed-point scatter_sum {t_new[0]:.4f} / "
          f"{t_new[1]:.4f} ms, index_add_ {t_old[0]:.4f} / {t_old[1]:.4f} "
          f"ms (its two calls equal bit for bit: {old_same})")
    if not same or not err <= DEPOSIT_TOL:
        raise AssertionError(f"[23] deposit {tag}: bit for bit {same}, "
                             f"error {err}")
    return out


def adaptive_trace(lines: list[str]) -> tuple[list, int]:
    """run.log's stretch lines as (step count, a, dln(a)) and its total
    adaptive steps."""
    trace = []
    for line in lines:
        m = re.match(r"Time step\s+(\d+)\s+a = (\S+)\s+dln\(a\) = (\S+)",
                     line)
        if m:
            trace.append((int(m.group(1)), float(m.group(2)),
                          float(m.group(3))))
    total = next(int(x.split(":")[1]) for x in lines
                 if x.startswith("Total adaptive steps"))
    return trace, total


def adaptive_run(cfg, tag: str, **kw):
    """[23] ``run_simulation(cfg)`` with adaptive steps and no device
    argument, every launch count reset before and read after: the final
    time a_end itself and a finite state; the evaluations of run.log's
    summary line against those its stretches, steps and heals give (an
    evaluation at each stretch's start and one a step; with subcycles
    n_sub - 1 short ones a step; with rungs the masked interior ones of
    the summary), and the launches against those (supercell tier: K2 = K3
    = the boundary, plain or fused evaluations, K4 = the short ones, K5 =
    the interior ones; dense tier: K1 and K6; four shards: K6 = 4 x the
    boundary and masked ones).  Returns (result, launches, dict of the
    run's numbers)."""
    from nbody_torch.driver.simulate import (
        _resolved_shortrange,
        run_simulation,
    )

    work = os.path.join(OUT, tag)
    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = run_simulation(cfg, 0, work, **kw)
    counts = read_launches()
    lines = run_log(work)
    trace, total = adaptive_trace(lines)
    stretches, heals = len(trace), sum(1 for x in lines if "re-running" in x)
    rr, rm = rerun_evals(lines), rerun_evals(lines, "masked interior")
    D = cfg.devices if cfg.devices > 1 else 1
    tier = "cells" if D > 1 else _resolved_shortrange(cfg)
    if D > 1:
        B = int(re.search(r"Domain force evaluations: (\d+)",
                          "\n".join(lines)).group(1))
        m = re.search(r"Domain rung stepping: \d+ boundary, (\d+) "
                      r"frozen-plan interior and (\d+) masked interior",
                      "\n".join(lines))
        F, M = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
        ok = B == total + stretches + rr and F == 0
        want = zero_launches(K6=D * (B + M))
        what = f"{B} boundary and {M} masked interior evaluations"
    elif cfg.rungs >= 2:
        m = re.search(r"Rung stepping: (\d+) boundary and (\d+) masked "
                      r"interior", "\n".join(lines))
        B, M = int(m.group(1)), int(m.group(2))
        ok = B == total + stretches
        want = (zero_launches(K2=B + rr, K3=B + rr, K5=M + rm)
                if tier == "supercell" else zero_launches(K1=B + rr,
                                                          K6=M + rm))
        what = (f"{B} boundary and {M} masked interior evaluations (+ {rr} "
                f"and {rm} repeated)")
    else:
        m = re.search(r"(\d+) plain, (\d+) long, (\d+) short and (\d+) fused",
                      "\n".join(lines))
        P, L, S, F = (int(x) for x in m.groups())
        if cfg.subcycles > 1:
            ok = (L + F == stretches + total + rr and S == stretches
                  + (cfg.subcycles - 1) * total
                  + rerun_evals(lines, "short-range"))
            want = (zero_launches(K2=F, K3=F, K4=S) if tier == "supercell"
                    else zero_launches(K1=S + F))
        else:
            ok = P == stretches + total + rr
            want = (zero_launches(K2=P, K3=P) if tier == "supercell"
                    else zero_launches(K1=P))
        what = f"{P} plain, {L} long, {S} short and {F} fused evaluations"
    if not ok:
        raise AssertionError(f"[23] {tag}: run.log's {what} differ from its "
                             f"{stretches} stretches, {total} steps and "
                             f"heals")
    if counts != want:
        raise AssertionError(f"[23] {tag}: launches {counts}, expected "
                             f"{want}")
    st = res.state
    if float(st.time) != float(np.float32(cfg.a_end)):
        raise AssertionError(f"[23] {tag}: ended at a = {float(st.time)!r}, "
                             f"not a_end")
    check_run_outputs(res, cfg, f"[23] {tag}")
    for line in lines:
        if ("pre-warming" in line or "re-running" in line
                or "Capacity heals" in line or "stepping" in line):
            phase(f"    {tag} run.log: {line}")
    dlas = [d for _, _, d in trace]
    phase(f"[23] {tag} ({tier} tier{f', {D} shards' if D > 1 else ''}, "
          f"rungs={cfg.rungs}, subcycles={cfg.subcycles}): N="
          f"{cfg.n_particles} mesh {cfg.mesh_size}, {total} adaptive steps "
          f"in {res.wall_s:.3f} s ({total / res.wall_s:.2f} steps/s), "
          f"{stretches} stretches, {heals} heals, a = {float(st.time)!r}; "
          f"dln(a) at the stretches' ends {dlas}; {what}; launches {counts} "
          f"= the evaluations counted; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return res, counts, dict(total=total, trace=trace, heals=heals,
                             stretches=stretches, wall=res.wall_s)


def adaptive_16_runs(noise) -> None:
    """[23](a) the 16^3 adaptive runs from the committed noise against the
    JAX package's: P(k) at a = 1 to PK_REL_TOL, the total adaptive steps
    equal (every step but the last takes dla_max in both runs, so the
    count is ceil(ln(a_end / a_begin) / dla_max), which no float32
    rounding moves: 130.4 and 40.1 here), and each stretch line's step
    count, a and dln(a) to their printed digits."""
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics

    for tag, change in ADAPTIVE_16.items():
        cfg = SimulationConfig(n_side=16, time_stepping="adaptive",
                               output=OutputConfig(snapshot=False), **change)
        res, _, run = adaptive_run(
            cfg, f"n16_{tag}", initial_state=realize_ics(cfg, 0, noise=noise))
        with open(os.path.join(PORT_DATA,
                               f"adaptive_steps_n16_{tag}_seed0.txt")) as f:
            ref_trace, ref_total = adaptive_trace(f.read().splitlines())
        worst = max(max(abs(a - b), abs(d - e) * 10.0)
                    for (_, a, d), (_, b, e) in zip(run["trace"], ref_trace))
        same = ([s for s, _, _ in run["trace"]]
                == [s for s, _, _ in ref_trace]) and worst <= 1.5e-4
        phase(f"[23] 16^3 {tag}: {run['total']} adaptive steps (JAX "
              f"{ref_total}), stretch lines equal to JAX's to their digits: "
              f"{same}")
        if run["total"] != ref_total or not same:
            raise AssertionError(f"[23] 16^3 {tag}: steps {run['trace']} vs "
                                 f"JAX {ref_trace}")
        pk_vs_reference(res, cfg, f"powerspec_a=1.00_n16_{tag}_seed0",
                        f"[23] 16^3 {tag} from the JAX noise")


def same_run(tag: str, res, other, what: str) -> None:
    """Two runs' final states equal bit for bit, and their P(k) files."""
    same = (torch.equal(res.state.pos, other.state.pos)
            and torch.equal(res.state.vel, other.state.vel))
    with open(res.powerspecs[0], "rb") as f, \
            open(other.powerspecs[0], "rb") as g:
        same_pk = f.read() == g.read()
    phase(f"[23] {tag}: final positions and velocities equal bit for bit to "
          f"{what}: {same}; P(k) files equal byte for byte: {same_pk}")
    if not (same and same_pk):
        raise AssertionError(f"[23] {tag} parts from {what}")


def adaptive_64_runs() -> dict:
    """[23](b)-(d) the committed adaptive 64^3 config at full width.  The
    runs compared with each other start with no capacity learned in the
    process (``forget_capacities``), as in a fresh one, so that their
    walls and heals compare like with like; their bits no longer depend
    on the capacities they start from ([25](a))."""
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import forget_capacities

    with open(os.path.join(ROOT, "tests", "data", "parity", "adaptive",
                           "config.json")) as f:
        d = json.load(f)
    # the reference's transfer table is not in the repository
    d.update(transfer="eh")
    d.pop("output")
    base = SimulationConfig.from_dict(d).replace(
        output=OutputConfig(snapshot=False))
    out = {}
    # (b) plain (twice: the same steps, the same bits), rungs=3,
    # subcycles=4
    results = {}
    for tag, cfg in (("cfg64_adaptive", base),
                     ("cfg64_adaptive_again", base),
                     ("cfg64_adaptive_rungs3", base.replace(rungs=3)),
                     ("cfg64_adaptive_sub4", base.replace(subcycles=4))):
        if tag != "cfg64_adaptive_sub4":
            forget_capacities()
        res, counts, run = adaptive_run(cfg, tag)
        out[tag] = dict(run, counts=counts, pk=res.powerspecs[0])
        if tag in ("cfg64_adaptive", "cfg64_adaptive_rungs3"):
            results[tag] = res
        if tag == "cfg64_adaptive_again":
            first = out["cfg64_adaptive"]
            phase(f"[23] cfg64_adaptive twice: {first['total']} and "
                  f"{run['total']} steps, {first['wall']:.3f} and "
                  f"{run['wall']:.3f} s")
            if run["total"] != first["total"]:
                raise AssertionError("[23] two cfg64_adaptive calls took "
                                     f"{first['total']} and {run['total']} "
                                     f"steps")
            same_run(tag, res, results.pop("cfg64_adaptive"),
                     "the first call")
        del res
    # (c) the compact kicks: the whole run bit for bit against (b)'s
    # full-N rung run, both from no learned capacity
    forget_capacities()
    ccfg = base.replace(rungs=3, rung_active_capacity=COMPACT_CAPACITY)
    res, counts, run = adaptive_run(ccfg, "cfg64_adaptive_rungs3_compact")
    full = out["cfg64_adaptive_rungs3"]
    phase(f"[23] compact active-row kicks (rung_active_capacity "
          f"{COMPACT_CAPACITY}, {run['heals']} heals): {run['total']} steps "
          f"in {run['wall']:.3f} s against the full-N kicks' "
          f"{full['total']} in {full['wall']:.3f} s")
    same_run("cfg64_adaptive_rungs3_compact", res,
             results.pop("cfg64_adaptive_rungs3"), "the full-N kicks' run")
    out["cfg64_adaptive_rungs3_compact"] = dict(run, counts=counts)
    del res
    # (d) four shards of the card
    dcfg = base.replace(rungs=3, devices=DOMAIN_SHARDS)
    res, counts, run = adaptive_run(dcfg, "cfg64_adaptive_rungs3_d4")
    bands = pk_bands(res.powerspecs[0], full["pk"], dcfg, "[23] d4")
    phase(f"[23] cfg64 adaptive rungs=3 on {DOMAIN_SHARDS} shards: "
          f"{run['total']} steps in {run['wall']:.3f} s (one device "
          f"{full['total']} in {full['wall']:.3f} s); P(k) vs one device's "
          f"rung run, max rel " + bands_text(bands))
    check_bands(bands, "[23] d4")
    out["cfg64_adaptive_rungs3_d4"] = dict(run, counts=counts)
    return out


# ---------------------------------------------------------------------------
# [24] the ensemble: K1's batched site and the NN-data pipeline
# ---------------------------------------------------------------------------

#: [24] the reference's NN-data pipeline: members of SimulationConfig()
#: integrated at once (the JAX package's vmap tier), and the committed
#: 16^3 ensemble's members
ENSEMBLE_MEMBERS = 8
ENSEMBLE_16_MEMBERS = 4
#: [24](b) the batched tier's members against the sequential tier's runs:
#: positions to 1e-6 relative and 1e-6 of the box (tests/test_driver.py's
#: bound on the JAX package's two tiers), P(k) at a = 1 to 1e-4
ENSEMBLE_POS_TOL = 1e-6
ENSEMBLE_PK_TOL = 1e-4


def batched_k1_check(tag: str, pos, mass, args, reps: int) -> dict:
    """[24](a) K1's batched site on B members (pos (B, N, 3)): relative
    L2 (K1_REL_L2_TOL) and per target (TARGET_TOL, each member against
    the RMS of its own force) against the float64 plain version, one
    launch per call, each member equal bit for bit to its own single
    launch; the batched launch timed beside the B single launches and the
    float32 plain version; the bound: every member's pairs inside r_cut x
    (FLOPS_VISIT_COLUMNS + FLOPS_INSIDE), 28 bytes a particle."""
    from nbody_torch.forces.p3m import p3m_short_acc, p3m_short_plain

    B, n = pos.shape[0], pos.shape[1]
    box, _, _, r_cut = args[:4]
    before = p3m_short_acc.launches
    got = p3m_short_acc(pos, mass, *args)
    torch.cuda.synchronize()
    one_launch = p3m_short_acc.launches == before + 1
    same = all(torch.equal(got[b], p3m_short_acc(pos[b], mass[b], *args))
               for b in range(B))
    ref = p3m_short_plain(pos.double(), mass.double(), *args)
    rel = rel_l2(got, ref)
    err = max(target_err(got[b].T, ref[b].T) for b in range(B))
    ms = cuda_time_ms(lambda: p3m_short_acc(pos, mass, *args), reps)
    singles = cuda_time_ms(lambda: [p3m_short_acc(pos[b], mass[b], *args)
                                    for b in range(B)], reps)
    plain_ms = cuda_time_ms(lambda: p3m_short_plain(pos, mass, *args), 1)
    inside = sum(count_inside_dense(pos[b], box, r_cut) for b in range(B))
    b_ms, b_by = bound(28 * n * B,
                       inside * (FLOPS_VISIT_COLUMNS + FLOPS_INSIDE))
    phase(f"{tag}: {B} members x {n}: one launch {one_launch}; each member "
          f"equal bit for bit to its own launch: {same}; rel L2 {rel:.3e} "
          f"(tol {K1_REL_L2_TOL:g}), per-target error {err:.3e} (tol "
          f"{TARGET_TOL:g}); the batched launch {ms:.4f} ms ({ms / B:.4f} ms "
          f"a member), {B} single launches {singles:.4f} ms, plain f32 "
          f"{plain_ms:.3f} ms; {inside:.4e} pairs inside r_cut, bound "
          f"{b_ms:.4f} ms ({b_by})")
    if not (one_launch and same):
        raise AssertionError(f"{tag}: one launch {one_launch}, bit for bit "
                             f"{same}")
    if not (rel <= K1_REL_L2_TOL and err <= TARGET_TOL):
        raise AssertionError(f"{tag}: K1 batched disagrees: {rel}, {err}")
    return dict(max_abs_err=max_abs(got, ref), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                singles_ms=singles)


def ensemble_phase(cfg) -> tuple[dict, int]:
    """[24] the ensemble on the card.  (b) the NN-data pipeline,
    ``run_ensemble(cfg, 8, batch=8)``: no member failed, K1 launched once
    a force evaluation for the chunk; the sequential tier, each member
    through ``run_simulation(member, base=cfg)``, K1 8 times as often;
    every member's final positions (the batched tier's from
    ``run_members_batched``) and P(k) files against its sequential run;
    both walls.  (a) K1's batched site on the 8 members' ICs and their
    final states.  (c) the committed 16^3 ensemble from the JAX noise
    against the JAX package's P(k).  (d) ``benchmark_fn`` on K1's batched
    call and a ``trace`` around one ensemble step; the analysis functions
    with no figure path.  Returns K1's batched
    row and its launches in the pipeline's chunk."""
    from nbody_torch.analysis import (
        compare_solver_spectra,
        density_projection,
        ensemble_scatter,
    )
    from nbody_torch.core import units
    from nbody_torch.diagnostics.profiling import benchmark_fn, trace
    from nbody_torch.driver.ensemble import (
        draw_A_s,
        realize_members,
        run_ensemble,
        run_members_batched,
    )
    from nbody_torch.driver.simulate import (
        build_cosmo_force,
        measure_powerspec,
        run_simulation,
    )
    from nbody_torch.forces.p3m import p3m_short_acc, p3m_short_params
    from nbody_torch.integrate.cosmo_stepping import kdk_steps, log_a_steps

    B = ENSEMBLE_MEMBERS
    A_s = draw_A_s(B)
    work = os.path.join(OUT, "ensemble")
    shutil.rmtree(work, ignore_errors=True)
    # (b) the pipeline, batched and sequential
    reset_launches()
    ens = run_ensemble(cfg, B, os.path.join(work, "batched"), A_s_values=A_s,
                       batch=B)
    batched = read_launches()
    per_chunk = cfg.n_steps + 1
    phase(f"[24] run_ensemble(SimulationConfig(), {B}, batch={B}): "
          f"{ens.wall_s:.3f} s, failed {ens.failed}, skipped {ens.skipped}; "
          f"launches {batched}")
    if ens.failed or batched != zero_launches(K1=per_chunk):
        raise AssertionError(f"[24] the batched tier: failed {ens.failed}, "
                             f"launches {batched}")
    seeds = ens.seeds
    reset_launches()
    t0 = time.perf_counter()
    seq = [run_simulation(cfg.replace(A_s=float(A_s[i])), int(seeds[i]),
                          os.path.join(work, "sequential", f"m{i}"),
                          base=cfg) for i in range(B)]
    seq_wall = time.perf_counter() - t0
    sequential = read_launches()
    phase(f"[24] the sequential tier: {B} x run_simulation(member, "
          f"base=cfg) in {seq_wall:.3f} s ({seq_wall / B:.3f} s a member); "
          f"launches {sequential}")
    if sequential != zero_launches(K1=B * per_chunk):
        raise AssertionError(f"[24] the sequential tier: launches "
                             f"{sequential}")
    t0 = time.perf_counter()
    states = run_members_batched(cfg, seeds, A_s, base=cfg)
    torch.cuda.synchronize()
    again_wall = time.perf_counter() - t0
    pos_err, pk_err = 0.0, 0.0
    for i in range(B):
        check_run_outputs(seq[i], cfg.replace(A_s=float(A_s[i])),
                          f"[24] member {i}")
        d = (states.pos[i] - seq[i].state.pos).abs()
        d = torch.minimum(d, cfg.box - d).double()
        ref = seq[i].state.pos.abs().double()
        pos_err = max(pos_err, float((d / (ENSEMBLE_POS_TOL * ref
                                            + ENSEMBLE_POS_TOL * cfg.box)
                                      ).max()))
        got_pk = np.loadtxt(os.path.join(ens.run_dirs[i], "powerspec",
                                         f"powerspec_a={cfg.a_end:.2f}"))
        ref_pk = np.loadtxt(seq[i].powerspecs[0])
        pk_err = max(pk_err, float(np.abs(got_pk[:, 2] / ref_pk[:, 2]
                                          - 1.0).max()))
    phase(f"[24] batched members against their sequential runs: positions "
          f"at most {pos_err:.3f} of the bound (rtol {ENSEMBLE_POS_TOL:g}, "
          f"atol {ENSEMBLE_POS_TOL:g} box), P(k) max rel {pk_err:.3e} (tol "
          f"{ENSEMBLE_PK_TOL:g}); walls: batched tier {ens.wall_s:.3f} s "
          f"(run_members_batched alone {again_wall:.3f} s), sequential "
          f"{seq_wall:.3f} s ({seq_wall / ens.wall_s:.2f}x)")
    if not (pos_err <= 1.0 and pk_err <= ENSEMBLE_PK_TOL):
        raise AssertionError(f"[24] batched members part from the "
                             f"sequential runs: {pos_err}, {pk_err}")
    # (a) K1's batched site at the members' ICs and final states
    r_s, r_cut, _, _ = p3m_short_params(cfg.box, cfg.mesh_size,
                                        cfg.n_particles)
    args = (cfg.box, cfg.eps, r_s, r_cut, units.COSMO.G, cfg.force_split,
            cfg.softening_kernel)
    ics = realize_members(cfg, seeds, A_s, cfg)
    row = batched_k1_check("[24] K1 batched at the members' ICs",
                           ics.pos.contiguous(), ics.mass.contiguous(), args,
                           20)
    batched_k1_check("[24] K1 batched at the members' final states",
                     states.pos.contiguous(), states.mass.contiguous(), args,
                     5)
    # (d) the profiling port: benchmark_fn and a trace of one step
    bench = benchmark_fn(p3m_short_acc, ics.pos.contiguous(),
                         ics.mass.contiguous(), *args, reps=5)
    acc_fn = build_cosmo_force(cfg, checked=True)
    a_grid = log_a_steps(cfg.a_begin, cfg.a_end, cfg.n_steps)
    tdir = os.path.join(work, "trace")
    with trace(tdir) as prof:
        kdk_steps(ics, cfg.cosmology(), a_grid[:2], acc_fn, cfg.box)
    names = [e.key for e in prof.key_averages()]
    k1_ms = sum(getattr(e, "device_time_total", None)
                or getattr(e, "cuda_time_total", 0.0)
                for e in prof.key_averages() if "k1_pairs" in e.key) / 1e3
    path = os.path.join(tdir, "trace.json")
    with open(path) as f:
        named = "k1_pairs" in f.read()
    phase(f"[24] benchmark_fn(K1 batched): median {bench * 1e3:.4f} ms of 5 "
          f"calls; trace of one ensemble step: {path} "
          f"({os.path.getsize(path)} bytes), names the K1 kernel: {named}; "
          f"{len(names)} ops, K1's device time {k1_ms:.4f} ms over 2 "
          f"evaluations")
    if not (named and os.path.getsize(path) > 0):
        raise AssertionError("[24] the trace does not name the K1 kernel")
    # the analysis port on the card, with no figure (matplotlib may be
    # absent): the realization scatter of the pipeline's P(k) files, a
    # density image bit for bit over two calls, the solver study at 16^3
    k, mean, std, count = ensemble_scatter(os.path.join(work, "batched"))
    img = density_projection(states.pos[0], cfg.box, res=256)
    same_img = torch.equal(img, density_projection(states.pos[0], cfg.box,
                                                   res=256))
    study = compare_solver_spectra(cfg.replace(n_side=16),
                                   solvers=("pm", "p3m"))
    phase(f"[24] analysis: ensemble_scatter over {count} members, "
          f"{len(k)} bins, std / mean at the first bin "
          f"{std[0] / mean[0]:.3e}; density_projection 256^2 on the card, "
          f"two calls equal bit for bit: {same_img}, mass "
          f"{float(img.sum()):.1f} of {cfg.n_particles}; "
          f"compare_solver_spectra at 16^3: mean relative error vs linear "
          + ", ".join(f"{s} {r['mean_rel_err']:.3e} ({r['wall_s']:.3f} s)"
                      for s, r in study.items()))
    if not (count == B and same_img and np.all(np.isfinite(mean))
            and abs(float(img.sum()) - cfg.n_particles) < 1e-3
            * cfg.n_particles):
        raise AssertionError("[24] the analysis port failed on the card")
    # (c) the committed 16^3 ensemble from the JAX noise
    cfg16 = cfg.replace(n_side=16)
    noise = np.load(os.path.join(
        PORT_DATA, f"white_noise_n16_ensemble{ENSEMBLE_16_MEMBERS}_seed0.npy"))
    members = np.loadtxt(os.path.join(PORT_DATA,
                                      "ensemble_n16_members_seed0.txt"))
    t0 = time.perf_counter()
    st16 = run_members_batched(cfg16, members[:, 0].astype(np.int64),
                               members[:, 1], base=cfg16, noise=noise)
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    for b in range(ENSEMBLE_16_MEMBERS):
        member = cfg16.replace(A_s=float(members[b, 1]))
        path = os.path.join(work, f"powerspec_n16_member{b}")
        measure_powerspec(st16.pos[b], member, cfg16.a_end, path=path)
        name = (f"powerspec_a=1.00_n16_ensemble{ENSEMBLE_16_MEMBERS}_member"
                f"{b}_seed0")
        pk_file_vs_reference(path, member, name,
                             f"[24] 16^3 batched member {b} from the JAX "
                             f"noise", wall16)
    return row, per_chunk


# ---------------------------------------------------------------------------
# [25] the batched tier on the plane tiers and PP, after the capacity repair
# ---------------------------------------------------------------------------

#: [25](c) cfg64's members integrated at once (the 64^3 parity study's
#: runs) and (d) the default 32^3 config's members on the columns, cells
#: and PP tiers
CFG64_MEMBERS = 8
BATCH32_MEMBERS = 4


def capacity_repair_check(cfg64, ics64, rung, card: str) -> None:
    """[25](a) the sites at the driver's column capacity CK and at 2 CK
    (``scripts/torch_capacity_bits.py``): K2's mass grid, K3's and K4's
    per-particle sums at cfg64's ICs, the supercell force, K5's at
    cfg64-rungs3's final state (``rung``: pos, mass, active mask, healed
    config) and K6's, each equal bit for bit; then cfg64 run twice in one
    process without ``forget_capacities()`` in between (the second from
    the capacities the first learned): the same steps and final state
    bytes and the same P(k) file."""
    from nbody_torch.driver.simulate import forget_capacities, run_simulation

    abl = _ablation("torch_capacity_bits")
    lines = abl.capacity_checks(cfg64, ics64.pos, ics64.mass, card, k5=rung)
    for line in lines:
        phase(f"[25] {line['site']} at capacities {line['knobs']}: equal "
              f"bit for bit {line['equal']}, max rel {line['max_rel']:.3e}")
    if not all(line["equal"] for line in lines):
        raise AssertionError("[25] a site's bits depend on the capacity")
    forget_capacities()
    runs = []
    for k in range(2):
        work = os.path.join(OUT, f"cfg64_repeat{k}")
        shutil.rmtree(work, ignore_errors=True)
        runs.append((run_simulation(cfg64, 0, work), run_log(work)))
    (r0, l0), (r1, l1) = runs
    steps = [sum(line.startswith("Time step") for line in lg)
             for lg in (l0, l1)]
    same = (torch.equal(r0.state.pos, r1.state.pos)
            and torch.equal(r0.state.vel, r1.state.vel))
    with open(r0.powerspecs[0], "rb") as f0, open(r1.powerspecs[0],
                                                  "rb") as f1:
        same_pk = f0.read() == f1.read()
    grown = [line for line in l0 if "pre-warming" in line or "re-running"
             in line]
    phase(f"[25] cfg64 twice in one process, no forget_capacities() between:"
          f" run 1 from the config's capacities ({len(grown)} pre-warms and "
          f"heals: column capacity {r0.config_run.column_capacity}, window "
          f"{r0.config_run.column_window} at its end) in {r0.wall_s:.3f} s; "
          f"run 2 from the learned ones in {r1.wall_s:.3f} s ({steps} "
          f"logged stretches); final state equal bit for bit {same}, P(k) "
          f"file equal {same_pk}")
    if not (same and same_pk and steps[0] == steps[1] and grown):
        raise AssertionError(f"[25] cfg64 repeated from learned capacities "
                             f"parts: state {same}, P(k) {same_pk}, steps "
                             f"{steps}, pre-warms {len(grown)}")


def batched_site_check(tag: str, fn, batch: tuple, member, kw: dict,
                       ref64, plain32, nbytes: float, flops: float,
                       nodes: bool = False, reps: int = 10) -> dict:
    """[25](b) one batched site: ``fn(*batch, **kw)`` launches once for
    the B members, twice gives the same bits, and member b equals its own
    launch ``fn(*member(b), **kw)`` bit for bit; against the float64
    plain version ``ref64()`` (B, ...) the pair sums to relative L2
    FORCE_REL_L2_TOL and per target TARGET_TOL, and K2 (``nodes``), as
    at its single site ([7]), against its float32 plain version
    ``plain32()`` (the same coordinates, rounded op by op) to
    NODE_MASS_TOL of each member's largest node, its float64 distance
    reported (the float32 coordinates' rounding); the batched launch timed
    beside the B single launches and the float32 plain version
    ``plain32``, with CUDA events; the bound of ``nbytes`` and ``flops``.
    Returns the kernels line's numbers."""
    before = fn.launches
    got = fn(*batch, **kw)
    torch.cuda.synchronize()
    one = fn.launches == before + 1
    B = got.shape[0]
    twice = torch.equal(got, fn(*batch, **kw))
    own = all(torch.equal(got[b], fn(*member(b), **kw)) for b in range(B))
    ref = ref64()
    if nodes:
        ref32 = plain32()

        def node_err(r):
            return max(max_abs(got[b], r[b]) / float(r[b].abs().max())
                       for b in range(B))

        err = node_err(ref32)
        ok, text = err <= NODE_MASS_TOL, (
            f"max |node - plain f32| / max node {err:.3e} (tol "
            f"{NODE_MASS_TOL:g}), against float64 {node_err(ref):.3e}")
    else:
        rel = rel_l2(got, ref)
        err = max(target_err(got[b], ref[b]) for b in range(B))
        ok = rel <= FORCE_REL_L2_TOL and err <= TARGET_TOL
        text = (f"rel L2 {rel:.3e} (tol {FORCE_REL_L2_TOL:g}), per target "
                f"{err:.3e} (tol {TARGET_TOL:g})")
    ms = cuda_time_ms(lambda: fn(*batch, **kw), reps)
    singles = cuda_time_ms(lambda: [fn(*member(b), **kw) for b in range(B)],
                           reps)
    plain_ms = cuda_time_ms(plain32, 1, warm=False)
    b_ms, b_by = bound(nbytes, flops)
    phase(f"{tag}: {B} members, one launch {one}, two launches equal bit "
          f"for bit {twice}, each member equal bit for bit to its own launch "
          f"{own}; {text}; a launch of {B} members {ms:.4f} ms ({ms / B:.4f}"
          f" a member), {B} single launches {singles:.4f} ms; plain f32 "
          f"{plain_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
    if not (one and twice and own and ok):
        raise AssertionError(f"{tag}: one launch {one}, twice {twice}, own "
                             f"{own}, {text}")
    return dict(max_abs_err=max_abs(got, ref), ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                singles_ms=singles)


def batched_supercell_sites(state, config) -> dict:
    """[25](b) K2 and K3 over B members at their ICs (cfg64-ensemble8's
    shapes), at the batched driver knobs."""
    from nbody_torch.forces.pm import pm_module
    from nbody_torch.forces.pm_supercell import (
        deposit_node_masses_plain,
        fold_node_masses,
        fused_column_plane_plain,
        run_fused_column_plane,
        supercell_deposit_from_plane,
        supercell_geometry,
    )

    box, nmesh = config.box, config.mesh_size
    # the driver's knobs for the batch: the pre-warm over every member,
    # the heal until the batch's plane drops nothing
    knobs, plane, ws, nch, counts, geo = driver_plane(state, config, config,
                                                      True)
    B = plane.shape[0]
    phase(f"[25] the batch's plane at {B} members' ICs: {knobs}")
    ncell, stride, gz = geo["ncell"], geo["stride"], geo["gz"]
    S, ZP = supercell_geometry(nmesh, ncell)
    scale = nmesh / box
    dkw = dict(box=box, nmesh=nmesh, ncell=ncell, stride=stride, gz=gz,
               chunk=geo["chunk"])

    def k2_plain(p):
        return torch.stack([fold_node_masses(deposit_node_masses_plain(
            p[b], counts[b], ncell=ncell, S=S, ZP=ZP, stride=stride, gz=gz,
            scale=scale), ncell=ncell, S=S, ZP=ZP, nmesh=nmesh)
            for b in range(B)])

    n_real = int(counts.sum())
    out = {"K2": batched_site_check(
        "[25] K2 batched", supercell_deposit_from_plane, (plane, counts),
        lambda b: (plane[b], counts[b]), dkw,
        lambda: k2_plain(plane.double()), lambda: k2_plain(plane),
        n_real * 16 + counts.numel() * 4 + B * nmesh**3 * 4,
        n_real * FLOPS_DEPOSIT, nodes=True)}
    rho = supercell_deposit_from_plane(plane, counts, **dkw)
    kw = _pair_kw(config, geo)
    mass_sum = torch.sum(state.mass, dim=-1, dtype=torch.float64).to(
        torch.float32)
    split = config.force_split
    pm = pm_module(box, nmesh, config.deconvolve_p, False,
                   kw["r_s"] if split == "gaussian" else 0.0,
                   kw["r_cut"] if split == "spline" else 0.0,
                   config.pm_gradient, 0.0, plane.device, torch.float32)
    grids = pm.force_grids_from_rho(rho, 4.0 * math.pi * mass_sum / box**3,
                                    mass_sum).contiguous()
    fkw = dict(S=S, scale=scale, **kw)
    work = [needed_work(plane[b], counts[b], **kw) for b in range(B)]
    visits = sum(w[0] for w in work)
    inside = sum(w[1] for w in work)
    n_t = sum(w[3] for w in work)
    out["K3"] = batched_site_check(
        "[25] K3 batched", run_fused_column_plane, (plane, ws, nch, grids),
        lambda b: (plane[b], ws[b], nch[b], grids[b]), fkw,
        lambda: fused_column_plane_plain(plane.double(), ws, nch,
                                         grids.double(), **fkw),
        lambda: fused_column_plane_plain(plane, ws, nch, grids, **fkw),
        needed_bytes(n_t, n_t) + grids.numel() * 4,
        visits * FLOPS_VISIT_COLUMNS + inside * FLOPS_INSIDE
        + n_real * FLOPS_PM_READ, reps=5)
    return out


def batched_columns_site(state, config) -> dict:
    """[25](b) K4 over B members at their ICs (the 32^3 columns tier)."""
    from nbody_torch.forces.p3m_columns import (
        column_plane_plain,
        run_column_plane,
    )

    knobs, plane, ws, nch, counts, geo = driver_plane(state, config, config,
                                                      True)
    B = plane.shape[0]
    phase(f"[25] the batch's plane at {B} members' ICs: {knobs}")
    kw = _pair_kw(config, geo)
    work = [needed_work(plane[b], counts[b], **kw) for b in range(B)]
    n_t = sum(w[3] for w in work)
    return batched_site_check(
        "[25] K4 batched", run_column_plane, (plane, ws, nch),
        lambda b: (plane[b], ws[b], nch[b]), dict(kw, box=config.box),
        lambda: column_plane_plain(plane.double(), ws, nch, **kw),
        lambda: column_plane_plain(plane, ws, nch, **kw),
        needed_bytes(n_t, n_t),
        sum(w[0] for w in work) * FLOPS_VISIT_COLUMNS
        + sum(w[1] for w in work) * FLOPS_INSIDE)


def batched_cells_site(state, config) -> dict:
    """[25](b) K6 over B members at their ICs (the 32^3 cells tier, one
    plane form), at the pre-warmed cell capacity."""
    from nbody_torch.driver.simulate import prewarm_capacity
    from nbody_torch.forces.p3m import (
        build_padded_plane,
        cell_plane_plain,
        p3m_short_params,
        run_cell_plane,
    )

    box = config.box
    r_s, r_cut, _, _ = p3m_short_params(box, config.mesh_size,
                                        config.n_particles)
    ncell = int(box / r_cut)
    cap = prewarm_capacity(config, config, state.pos)[0].cell_capacity
    plane, ov, K, _, counts = build_padded_plane(state.pos, state.mass, box,
                                                 r_cut, ncell, cap)
    if int(ov.max()):
        raise AssertionError(f"[25] the batched cell plane overflows: {ov}")
    B = plane.shape[0]
    kw = dict(nx=ncell, ncell=ncell, K=K, eps2=float(config.eps) ** 2,
              r_s=r_s, r_cut=r_cut, split=config.force_split,
              softening=config.softening_kernel)
    nbytes = inside = 0
    for b in range(B):
        _, i, n_src, n_t = needed_work_cells(plane[b], counts[b], K,
                                             plane[b], counts[b], K,
                                             ncell=ncell, r_cut=r_cut)
        inside += i
        nbytes += needed_bytes(n_src, n_t)
    return batched_site_check(
        "[25] K6 batched", run_cell_plane, (plane, counts),
        lambda b: (plane[b], counts[b]), kw,
        lambda: cell_plane_plain(plane.double(), counts, **kw),
        lambda: cell_plane_plain(plane, counts, **kw), nbytes,
        inside * (FLOPS_VISIT_COLUMNS + FLOPS_INSIDE))


def batched_tier_run(cfg, B: int, tag: str, work: str, want: tuple):
    """[25](c)/(d) ``B`` members of ``cfg`` through ``run_ensemble(batch=B)``
    and through the sequential tier (B x ``run_simulation(member,
    base=cfg)``), then ``run_members_batched`` again for the final states:
    each member's state and P(k) file equal bit for bit to its sequential
    run's; the walls, the launches of each tier (the kernels ``want``
    once an evaluation, B times as often in the sequential tier) and the
    heals.  ``run_members_batched`` runs warm, its wall the batched tier's
    beside the sequential tier's; each tier starts from no learned
    capacity, so the walls compare like with like (the bits do not depend
    on it, (a)).  Returns the batched tier's launches of ``want``."""
    from nbody_torch.driver.ensemble import (
        draw_A_s,
        run_ensemble,
        run_members_batched,
    )
    from nbody_torch.driver.simulate import forget_capacities, run_simulation

    A_s = draw_A_s(B)
    shutil.rmtree(work, ignore_errors=True)
    forget_capacities()
    reset_launches()
    ens = run_ensemble(cfg, B, os.path.join(work, "batched"),
                       A_s_values=A_s, batch=B)
    batched = read_launches()
    log0 = os.path.join(ens.run_dirs[0], "run.log")
    # the batched tier's run.log holds its pre-warm and heal lines, if any
    logged = run_log(ens.run_dirs[0]) if os.path.exists(log0) else []
    evals = cfg.n_steps + 1 + rerun_evals(logged)
    seeds = ens.seeds
    forget_capacities()
    reset_launches()
    t0 = time.perf_counter()
    seq = [run_simulation(cfg.replace(A_s=float(A_s[i])), int(seeds[i]),
                          os.path.join(work, "sequential", f"m{i}"),
                          base=cfg) for i in range(B)]
    seq_wall = time.perf_counter() - t0
    sequential = read_launches()
    seq_logs = [run_log(os.path.join(work, "sequential", f"m{i}"))
                for i in range(B)]
    seq_evals = sum(cfg.n_steps + 1 + rerun_evals(lg) for lg in seq_logs)
    seq_heals = sum("re-running" in line for lg in seq_logs for line in lg)
    forget_capacities()
    t0 = time.perf_counter()
    states = run_members_batched(cfg, seeds, A_s, base=cfg,
                                 log=lambda msg: None)
    torch.cuda.synchronize()
    again = time.perf_counter() - t0
    same = [torch.equal(states.pos[i], seq[i].state.pos)
            and torch.equal(states.vel[i], seq[i].state.vel)
            for i in range(B)]
    same_pk = []
    for i in range(B):
        check_run_outputs(seq[i], cfg.replace(A_s=float(A_s[i])),
                          f"{tag} member {i}")
        with open(os.path.join(ens.run_dirs[i], "powerspec",
                               f"powerspec_a={cfg.a_end:.2f}"), "rb") as f:
            got = f.read()
        with open(seq[i].powerspecs[0], "rb") as f:
            same_pk.append(got == f.read())
    heals = [line for line in logged if "re-running" in line]
    phase(f"{tag}: run_ensemble(batch={B}) {ens.wall_s:.3f} s (its first "
          f"call here; run_members_batched again {again:.3f} s), failed "
          f"{ens.failed}; launches {batched} for {evals} evaluations, heals "
          f"{len(heals)} ({'; '.join(heals) or 'none'}); the sequential tier"
          f" {seq_wall:.3f} s ({seq_wall / B:.3f} s a member), launches "
          f"{sequential} for {seq_evals} evaluations, heals {seq_heals}; "
          f"{seq_wall / again:.2f}x"
          f" the batched tier's warm wall; members equal bit for bit: "
          f"states {same}, P(k) files {same_pk}")
    if ens.failed or batched != zero_launches(**dict.fromkeys(want, evals)) \
            or sequential != zero_launches(**dict.fromkeys(want, seq_evals)):
        raise AssertionError(f"{tag}: failed {ens.failed}, launches "
                             f"{batched} / {sequential}")
    if not (all(same) and all(same_pk)):
        raise AssertionError(f"{tag}: batched members part from their "
                             f"sequential runs: {same}, {same_pk}")
    return {key: batched[key] for key in want}


def batched_planes_phase(cfg64, ics64, rung, run_cfg, card: str) -> tuple:
    """[25] (a) the capacity repair; (b) each batched site against its
    plain version, its single launches and itself; (c) cfg64-ensemble8
    and (d) 4 members of the default 32^3 config on the columns, cells
    and PP tiers, each batched against its sequential tier, bit for bit.
    Returns ({row key: numbers}, {row key: launches})."""
    from nbody_torch.core import units
    from nbody_torch.driver.ensemble import draw_A_s, realize_members
    from nbody_torch.driver.simulate import forget_capacities

    capacity_repair_check(cfg64, ics64, rung, card)
    rows, launches = {}, {}
    B = CFG64_MEMBERS
    seeds = np.arange(B) + 100
    ics8 = realize_members(cfg64, seeds, draw_A_s(B), cfg64)
    rows.update(batched_supercell_sites(ics8, cfg64))
    del ics8
    col32 = run_cfg.replace(shortrange="columns")
    cells32 = run_cfg.replace(shortrange="cells")
    pp32 = run_cfg.replace(solver="pp")
    b32 = BATCH32_MEMBERS
    ics4 = realize_members(run_cfg, seeds[:b32], draw_A_s(b32), run_cfg)
    rows["K4"] = batched_columns_site(ics4, col32)
    rows["K6"] = batched_cells_site(ics4, cells32)
    G = units.COSMO.G
    args = (pp32.box, pp32.eps, pp32.box / 16.0, 0.4999 * pp32.box, G,
            "gaussian", pp32.softening_kernel)
    rows["K1"] = batched_k1_check("[25] K1's Ewald site batched",
                                  ics4.pos.contiguous(),
                                  ics4.mass.contiguous(), args, 5)
    del ics4
    forget_capacities()
    launches.update(batched_tier_run(
        cfg64, B, "[25] cfg64-ensemble8", os.path.join(OUT, "ensemble64"),
        ("K2", "K3")))
    for key, cfg, name in (("K4", col32, "columns"), ("K6", cells32, "cells"),
                           ("K1", pp32, "pp")):
        launches.update(batched_tier_run(
            cfg, b32, f"[25] default-32^3-{name}-ensemble{b32}",
            os.path.join(OUT, f"ensemble32_{name}"), (key,)))
    return rows, launches


# ---------------------------------------------------------------------------
# [26] the emulator: the 3D CNN trained on the card, its data and the
# simulation source
# ---------------------------------------------------------------------------

#: [26](a) the reference's scale (``scripts/torch_emulator_scale.py``'s
#: protocol).  Its 1000 epochs take 96-104 s on the H100 (the script's
#: three seeds), more than the 90 s this phase may take, so it runs 200
#: epochs and holds the A_s abs deviation to 4% and the 3-sigma coverage
#: to at least 0.95 (the full run's 2.3%, twice the JAX package's 1.148%
#: in tests/data/emulator_scale.json, is read from the script's committed
#: runs, tests/data/torch_port/emulator_scale_h100.json).  The MC-dropout
#: sigma is held to the JAX package's float32 loop on the same volumes
#: (``scripts/torch_emulator_calibration.py --nmesh 32 --maker port
#: --epochs 200``, on the CPU; its lines in EMULATOR_JAX_RUNS): the card's
#: ``evaluate_uq`` (EMULATOR_EVAL_PASSES passes) of that fit's weights
#: (EMULATOR_JAX_PARAMS) to the mean sigma of JAX's ``evaluate_uq`` of
#: them within EMULATOR_SIGMA_TOL, and the card's own fit's mean sigma to
#: the JAX fit's within a factor EMULATOR_SIGMA_FACTOR.  That loop covers
#: 0.99 at 1 sigma after 200 epochs (its sigma 3.1 times its RMS error),
#: and 0.75 and 0.99 for its two seeds after 1000: its sigma is that of
#: the epoch the best val loss falls on.  So the 1-sigma band (0.55,
#: 0.85), which the TPU's bfloat16 run met (0.71), is printed beside the
#: coverage and is not a gate (PERF.md §6)
EMULATOR_EPOCHS = 200
EMULATOR_DEV_TOL = 4.0
EMULATOR_COV3 = 0.95
EMULATOR_COV1_BAND = (0.55, 0.85)
EMULATOR_JAX_PARAMS = "emulator_jax_n32_e200_seed0.npz"
EMULATOR_JAX_RUNS = "emulator_calibration_cpu.jsonl"
EMULATOR_EVAL_PASSES = 200
EMULATOR_SIGMA_TOL = 0.05
EMULATOR_SIGMA_FACTOR = 1.5
#: [26](b) the simulation source: train/val and test members of
#: PipelineConfig().sim_config(), each split one batched chunk
#: (pipeline.SIM_BATCH members at most)
EMULATOR_SIM_MEMBERS = (8, 4)
EMULATOR_SIM_EPOCHS = 20
#: [26](c) the card's float32 model against its float64 version on the
#: CPU (relative L2 of the outputs and of one step's gradients)
EMULATOR_F64_TOL = 1e-5
#: [26](d) the card's fit against the JAX package's committed history
EMULATOR_HISTORY_TOL = 1e-4
EMULATOR_FIXTURE = "emulator_n16_seed0.npz"


def emulator_fixture():
    """The committed 16^3 fixture: (npz, the JAX init params as a port
    state_dict, train and val ``DeltaDataset``)."""
    from nbody_torch.convert import cnn_params_from_jax
    from nbody_torch.emulator.data import DeltaDataset

    z = np.load(os.path.join(PORT_DATA, EMULATOR_FIXTURE))
    params = {}
    for key in z.files:
        if key.startswith("param:"):
            layer, name = key[len("param:"):].split("/")
            params.setdefault(layer, {})[name] = z[key]
    return (z, cnn_params_from_jax(params),
            DeltaDataset(z["X_train"], z["y_train"], z["maxima"]),
            DeltaDataset(z["X_val"], z["y_val"], z["maxima"]))


def emulator_jax_reference():
    """The JAX package's float32 loop on [26](a)'s volumes: (the fit's
    line at EMULATOR_EPOCHS, the mean over the MC seeds of the mean
    sigma of its ``evaluate_uq`` of EMULATOR_JAX_PARAMS, the fit's weights
    as a port state_dict)."""
    from nbody_torch.convert import cnn_params_from_jax

    with open(os.path.join(PORT_DATA, EMULATOR_JAX_RUNS)) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    fit_line = next(line for line in lines
                    if line["package"] == "jax" and "params" not in line
                    and line["nmesh"] == 32
                    and line["epochs"] == EMULATOR_EPOCHS)
    evals = [line["mean_sigma_percent"] for line in lines
             if line["package"] == "jax"
             and line.get("params", "").endswith(EMULATOR_JAX_PARAMS)]
    z = np.load(os.path.join(PORT_DATA, EMULATOR_JAX_PARAMS))
    params = {}
    for key in z.files:
        layer, name = key.split("/")
        params.setdefault(layer, {})[name] = z[key]
    return fit_line, float(np.mean(evals)), cnn_params_from_jax(params)


def first_parting(a: dict, b: dict) -> str | None:
    """Where two fits part: the first history entry or parameter that
    differs, or None when they are equal bit for bit."""
    for key in ("train_loss", "val_loss"):
        for e, (x, y) in enumerate(zip(a.history[key], b.history[key])):
            if x != y:
                return f"{key} at epoch {e}: {x!r} vs {y!r}"
    for name in a.params:
        if not torch.equal(a.params[name], b.params[name]):
            d = float((a.params[name] - b.params[name]).abs().max())
            return f"parameter {name}: max |diff| {d:.3e}"
    return None


def emulator_phase(cfg) -> None:
    """[26] the emulator on the card through its entry points, with no
    device argument.  (a) the reference's scale; (b) the simulation
    source: ``create_simulation_dataset`` (each split one chunk of
    ``run_ensemble``'s batched tier, K1's batched site, then
    ``state_to_delta`` of each member's final state in memory), then
    ``run_experiment`` for 20 epochs; (c) the model against its float64
    version on the CPU, and two forwards and two 3-epoch fits of one seed
    bit for bit; (d) the committed fixture's fit against the JAX
    package's history."""
    from nbody_torch.driver.ensemble import TEST_DRAW_SEED, draw_A_s
    from nbody_torch.driver.pipeline import (
        SIM_BATCH,
        PipelineConfig,
        create_simulation_dataset,
        run_experiment,
    )
    from nbody_torch.emulator.data import DeltaDataset
    from nbody_torch.emulator.model import (
        CosmoCNN,
        deterministic_cudnn,
        mse_loss,
    )
    from nbody_torch.emulator.train import evaluate_uq, fit

    scale = _ablation("torch_emulator_scale")
    work = os.path.join(OUT, "emulator")
    shutil.rmtree(work, ignore_errors=True)
    # (a) the reference's scale
    data_wall = scale.make_data(os.path.join(work, "linear"))
    splits, read_wall = scale.load_splits(os.path.join(work, "linear"))
    run = scale.protocol(splits, EMULATOR_EPOCHS, seed=0)
    cov = run["coverage_1_2_3_sigma"]
    lo, hi = EMULATOR_COV1_BAND
    band = "met" if lo <= cov[0] <= hi else "not met"
    jfit, jsigma, jstate = emulator_jax_reference()
    jmodel = CosmoCNN(n_out=1, n_conv=2)
    jev = evaluate_uq(jmodel, jstate, splits[2], n_mc=EMULATOR_EVAL_PASSES,
                      seed=0, batch_size=4)
    card_sigma = float(100 * np.mean(jev.sigma_total[:, 0]
                                     / jev.y_true[:, 0]))
    sigma_err = card_sigma / jsigma - 1.0
    factor = run["mean_sigma_percent"] / jfit["mean_sigma_percent"]
    phase(f"[26](a) the reference's scale: {len(splits[0])} train, "
          f"{len(splits[1])} val, {len(splits[2])} test volumes of "
          f"{splits[0].dim}^3 in {data_wall:.3f} s (read back by the native "
          f"loader in {read_wall:.3f} s); fit {run['epochs_run']} epochs, "
          f"{run['steps']} steps in {run['train_wall_s']:.3f} s "
          f"({run['ms_per_step']:.4f} ms a step), best epoch "
          f"{run['best_epoch']}; evaluate_uq (50 passes) "
          f"{run['eval_wall_s']:.3f} s; A_s abs dev "
          f"{run['abs_dev_percent_A_s']:.4f}% (tol {EMULATOR_DEV_TOL}%), "
          f"coverage 1/2/3 sigma {cov[0]:.3f} / {cov[1]:.3f} / {cov[2]:.3f} "
          f"(3 sigma >= {EMULATOR_COV3}; the 1-sigma band "
          f"({lo}, {hi}): {band}); "
          f"mean MC sigma {run['mean_sigma_percent']:.3f}% against the RMS "
          f"error {run['rms_err_percent']:.3f}%.  The JAX package's float32 "
          f"loop on these volumes ({EMULATOR_JAX_RUNS}, CPU): A_s abs dev "
          f"{jfit['abs_dev_percent_A_s']:.4f}%, coverage "
          f"{' / '.join(f'{c:.3f}' for c in jfit['coverage_1_2_3_sigma'])}, "
          f"mean MC sigma {jfit['mean_sigma_percent']:.3f}% against "
          f"{jfit['rms_err_percent']:.3f}%; the card's fit's sigma is "
          f"{factor:.3f} times it (within a factor {EMULATOR_SIGMA_FACTOR}); "
          f"evaluate_uq ({EMULATOR_EVAL_PASSES} passes) of the JAX fit's "
          f"weights on the card: mean sigma {card_sigma:.3f}% against the "
          f"JAX package's {jsigma:.3f}% (rel err {sigma_err:+.4f}, tol "
          f"{EMULATOR_SIGMA_TOL}), A_s abs dev "
          f"{float(jev.abs_dev_percent[0]):.4f}%, coverage "
          f"{' / '.join(f'{c:.3f}' for c in jev.coverage[0])}")
    if not (run["abs_dev_percent_A_s"] <= EMULATOR_DEV_TOL
            and cov[2] >= EMULATOR_COV3
            and abs(sigma_err) <= EMULATOR_SIGMA_TOL
            and 1 / EMULATOR_SIGMA_FACTOR <= factor <= EMULATOR_SIGMA_FACTOR):
        raise AssertionError(f"[26](a) the emulator misses its gates: {run};"
                             f" the JAX weights' sigma on the card "
                             f"{card_sigma} against {jsigma}")

    # (b) the simulation source in memory (the card has no h5py)
    n_tv, n_te = EMULATOR_SIM_MEMBERS
    pcfg = PipelineConfig(n_trainval=n_tv, n_test=n_te, val_size=0.25,
                          epochs=EMULATOR_SIM_EPOCHS, batch_size=2)
    sim = pcfg.sim_config()
    if (sim.n_side, sim.solver, sim.n_steps) != (cfg.n_side, cfg.solver,
                                                 cfg.n_steps) or max(
            EMULATOR_SIM_MEMBERS) > SIM_BATCH:
        raise AssertionError(f"[26](b) the pipeline's simulation config "
                             f"{sim} is not the default run's, or a split "
                             f"takes more than one chunk of {SIM_BATCH}")
    sim_root = os.path.join(work, "sim")
    walls, launches = [], []
    for n, A_s, test in ((n_tv, draw_A_s(n_tv), False),
                         (n_te, draw_A_s(n_te, draw_seed=TEST_DRAW_SEED),
                          True)):
        reset_launches()
        t0 = time.perf_counter()
        create_simulation_dataset(pcfg, sim_root, n, A_s, test=test)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches.append(read_launches())
    evals = sim.n_steps + 1
    vols = np.concatenate([DeltaDataset.from_directory(sim_root, s).X
                           for s in ("train", "val", "test")])
    means = np.abs(vols.reshape(len(vols), -1).astype(np.float64)
                   .mean(axis=1))
    info = run_experiment("SIM3", pcfg, {"sim": sim_root,
                                         "linear": sim_root}, work,
                          plot=False)
    with open(os.path.join(work, "SIM3_result.json")) as f:
        hist = json.load(f)["history"]["train_loss"]
    phase(f"[26](b) the simulation source: {n_tv} + {n_te} members of "
          f"PipelineConfig().sim_config() ({sim.n_side}^3, {sim.solver}, "
          f"{sim.n_steps} steps) through run_ensemble's batched tier, "
          f"state_to_delta in memory: train/val in {walls[0]:.3f} s, "
          f"launches {launches[0]}; test in {walls[1]:.3f} s, launches "
          f"{launches[1]} ({evals} evaluations a split, K1's batched "
          f"site); {len(vols)} volumes finite: "
          f"{bool(np.isfinite(vols).all())}, max |mean delta| "
          f"{means.max():.3e}; SIM3 {len(hist)} epochs in "
          f"{info['wall_s']} s, train loss {hist[0]:.4e} -> {hist[-1]:.4e} "
          f"(best of the last 5 {min(hist[-5:]):.4e}), A_s abs dev "
          f"{info['abs_dev_percent'][0]:.3f}% on {info['n_test']} members")
    if not (launches == [zero_launches(K1=evals)] * 2
            and np.isfinite(vols).all() and means.max() < 1e-5
            and min(hist[-5:]) < hist[0] and len(vols) == n_tv + n_te):
        raise AssertionError(f"[26](b) the simulation source failed: "
                             f"launches {launches}, means {means.max()}, "
                             f"loss {hist}")

    # (c) the card's model against its float64 version on the CPU
    z, state, fx_train, fx_val = emulator_fixture()
    train = splits[0]
    x, y = train.X[:4], train.y[:4]
    gpu = CosmoCNN()
    gpu.load_state_dict(state)
    gpu.cuda()
    cpu = CosmoCNN()
    cpu.load_state_dict(state)
    cpu.double()
    pg, _ = gpu(torch.as_tensor(x, device="cuda"))
    pc, _ = cpu(torch.as_tensor(x, dtype=torch.float64))
    fwd_err = rel_l2(pg.detach().cpu(), pc.detach())
    with deterministic_cudnn():
        mse_loss(pg, torch.as_tensor(y, device="cuda")).backward()
    mse_loss(pc, torch.as_tensor(y, dtype=torch.float64)).backward()
    gg = torch.cat([p.grad.reshape(-1).cpu() for p in gpu.parameters()])
    gc = torch.cat([p.grad.reshape(-1) for p in cpu.parameters()])
    grad_err = rel_l2(gg, gc)
    xg = torch.as_tensor(train.X[:16], device="cuda")
    same_fwd = torch.equal(
        gpu(xg, torch.Generator("cuda").manual_seed(3))[0],
        gpu(xg, torch.Generator("cuda").manual_seed(3))[0])
    fits = [fit(CosmoCNN(), train, splits[1], epochs=3, seed=0)
            for _ in range(2)]
    parted = first_parting(*fits)
    phase(f"[26](c) CosmoCNN at {train.dim}^3, batch 4, the fixture's "
          f"weights: the card's float32 against float64 on the CPU, forward "
          f"rel L2 {fwd_err:.3e}, one step's gradients {grad_err:.3e} (tol "
          f"{EMULATOR_F64_TOL:g}); two forwards with dropout from one seed "
          f"equal bit for bit: {same_fwd}; two 3-epoch fits of seed 0 "
          f"(augmentation, dropout): "
          + ("equal bit for bit" if parted is None
             else f"part at {parted}")
          + f"; walls {fits[0].wall_s:.3f} / {fits[1].wall_s:.3f} s")
    if not (fwd_err <= EMULATOR_F64_TOL and grad_err <= EMULATOR_F64_TOL
            and same_fwd):
        raise AssertionError(f"[26](c) the card's model parts from float64:"
                             f" {fwd_err}, {grad_err}, {same_fwd}")

    # (d) the committed fixture's fit against the JAX package's history
    res = fit(CosmoCNN(dropout_rate=0.0), fx_train, fx_val, epochs=3,
              batch_size=4, lr=4e-3, seed=0, augment=False,
              init_state=state)
    errs = [float(np.max(np.abs(np.asarray(res.history[k]) / z[k] - 1.0)))
            for k in ("train_loss", "val_loss")]
    phase(f"[26](d) the 16^3 fixture's 3-epoch fit on the card against "
          f"_fit_host_loop's committed history: max rel err train "
          f"{errs[0]:.3e}, val {errs[1]:.3e} (tol {EMULATOR_HISTORY_TOL:g}); "
          f"best epoch {res.best_epoch} (JAX {int(z['best_epoch'])})")
    if not (max(errs) <= EMULATOR_HISTORY_TOL
            and res.best_epoch == int(z["best_epoch"])):
        raise AssertionError(f"[26](d) the card's fit parts from the JAX "
                             f"history: {errs}, {res.history}")


def _wrappers() -> dict:
    from nbody_torch.forces.pallas_mxu import allpairs_pallas_mxu
    from nbody_torch.forces.pallas_pp import allpairs_pallas, block_acc_pallas
    from nbody_torch.forces.p3m import p3m_short_acc, run_cell_plane
    from nbody_torch.forces.p3m_columns import (
        run_column_plane,
        run_column_plane_masked,
    )
    from nbody_torch.forces.pm_supercell import (
        run_fused_column_plane,
        supercell_deposit_from_plane,
    )

    return {"K1": p3m_short_acc, "K2": supercell_deposit_from_plane,
            "K3": run_fused_column_plane, "K4": run_column_plane,
            "K5": run_column_plane_masked, "K6": run_cell_plane,
            "K7": allpairs_pallas, "K7b": block_acc_pallas,
            "K8": allpairs_pallas_mxu}


def zero_launches(**counts) -> dict:
    """A launch-count dict with every kernel at 0 but ``counts``."""
    return {key: counts.get(key, 0) for key in _wrappers()}


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {key: fn.launches for key, fn in _wrappers().items()}


def run_log(work: str) -> list[str]:
    with open(os.path.join(work, "run.log")) as f:
        return [line.rstrip() for line in f]


def check_run_outputs(res, cfg, tag: str) -> None:
    st = res.state
    finite = all(bool(torch.isfinite(t).all())
                 for t in (st.pos, st.vel, st.mass))
    if not finite or st.pos.shape != (cfg.n_particles, 3):
        raise AssertionError(f"{tag}: final state is not finite (N, 3)")
    if abs(float(st.time) - cfg.a_end) > 1e-6:
        raise AssertionError(f"{tag}: run ended at a = {float(st.time)}")
    if len(res.powerspecs) != 1 or not os.path.exists(res.powerspecs[0]):
        raise AssertionError(f"{tag}: no powerspec file written")
    pk = np.loadtxt(res.powerspecs[0])
    if pk.ndim != 2 or pk.shape[1] != 5 or not np.all(np.isfinite(pk)) \
            or not np.all(pk[:, 2] > 0):
        raise AssertionError(f"{tag}: powerspec file is not finite positive")


def pk_vs_reference(res, cfg, ref_name: str, tag: str) -> None:
    pk_file_vs_reference(res.powerspecs[0], cfg, ref_name, tag, res.wall_s)


def pk_file_vs_reference(path: str, cfg, ref_name: str, tag: str,
                         wall: float) -> None:
    got_pk = np.loadtxt(path)
    ref_pk = np.loadtxt(os.path.join(PORT_DATA, ref_name))
    k_half = 0.5 * np.pi * cfg.mesh_size / cfg.box
    m = ref_pk[:, 0] <= k_half
    # same bins: equal mode counts, and bin-mean k equal to float32
    # summation order
    if got_pk.shape != ref_pk.shape or not np.array_equal(
            got_pk[:, 1], ref_pk[:, 1]) or not np.allclose(
            got_pk[:, 0], ref_pk[:, 0], rtol=1e-5):
        raise AssertionError(f"{tag}: P(k) bins differ from the JAX run's")
    rel_pk = np.abs(got_pk[m, 2] / ref_pk[m, 2] - 1.0)
    phase(f"{tag}: P(k) vs JAX at {int(m.sum())} bins k <= {k_half:.4f}/Mpc:"
          f" max rel {rel_pk.max():.3e} (tol {PK_REL_TOL:g}); run "
          f"{wall:.3f} s")
    if not rel_pk.max() <= PK_REL_TOL:
        raise AssertionError(f"{tag}: P(k) differs from JAX: {rel_pk.max()}")


def rerun_evals(lines: list[str], what: str = "force") -> int:
    """Force evaluations (``what='masked interior'``: the rung tier's
    interior evaluations) the driver repeated after capacity heals."""
    for line in lines:
        m = re.match(rf"Capacity heals repeated (\d+) {what} evaluations",
                     line)
        if m:
            return int(m.group(1))
    return 0


def rung_populations(lines: list[str]) -> list[list[int]]:
    """The counts of run.log's "Rung population" lines, one list a step."""
    return [[int(x) for x in line.split("matter:")[1].split(",")]
            for line in lines if "Rung population" in line]


def rung_run(cfg, tag: str, work: str, **kw):
    """``run_simulation(cfg)`` with rungs, with every launch count reset
    before and read after.  Returns (result, launches, run.log lines, the
    boundary and the masked interior evaluations the run must have made,
    counted from run.log: a boundary evaluation at the start of each
    stretch of steps and at each step, an interior one at each sub-tick
    j whose deepest populated rung is >= rung_active_min(j), and those
    repeated after heals)."""
    from nbody_torch.driver.simulate import run_simulation
    from nbody_torch.integrate.cosmo_stepping import rung_active_min

    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = run_simulation(cfg, 0, work, **kw)
    launches = read_launches()
    lines = run_log(work)
    pops = rung_populations(lines)
    stretches = sum(1 for line in lines
                    if re.match(r"Time step\s+\d+\s+a = \S+\s+\(\d+ steps",
                                line))
    if len(pops) != cfg.n_steps or any(sum(p) != cfg.n_particles
                                       for p in pops):
        raise AssertionError(f"{tag}: rung populations {pops}")
    boundary = cfg.n_steps + stretches + rerun_evals(lines)
    interior = rerun_evals(lines, "masked interior") + sum(
        1 for p in pops for j in range(1, 2 ** (cfg.rungs - 1))
        if len(p) - 1 >= rung_active_min(j, cfg.rungs))
    check_run_outputs(res, cfg, tag)
    return res, launches, lines, boundary, interior


def rung_lines(tag: str, lines: list[str]) -> None:
    """Print a rung run's first and last population lines and its heal,
    staleness and summary lines."""
    pops = [line for line in lines if "Rung population" in line]
    for line in [pops[0], pops[-1]] + [
            line for line in lines
            if "pre-warming" in line or "re-running" in line
            or "drift note" in line or "Rung stepping" in line
            or "Capacity heals" in line]:
        phase(f"    {tag} run.log: {line}")


def pp_kernel_check(sizes=(2, 1000, 32768)) -> None:
    """[15] K7 against its float64 plain version and the dense oracles on
    the card: allpairs_pallas (acc, phi) with and without a box,
    block_acc_pallas with other targets than sources, and the float64
    instantiation on the Kepler pair and through the Kepler and
    solar-system drives."""
    from nbody_torch.core import units
    from nbody_torch.diagnostics.energy import momentum, total_energy
    from nbody_torch.forces.allpairs import (
        direct_acc,
        direct_acc_chunked,
        direct_acc_periodic,
    )
    from nbody_torch.forces.pallas_pp import (
        allpairs_pallas,
        block_acc_pallas,
        pp_block_plain,
    )
    from nbody_torch.ic import systems
    from nbody_torch.integrate.leapfrog import run

    eps, G = 0.05, 1.3
    for n in sizes:
        st = systems.plummer(n, seed=n)
        pos, mass = st.pos, st.mass
        p64, m64 = pos.double(), mass.double()
        for box in (0.0, 2.0):
            acc, phi = allpairs_pallas(pos, mass, eps, G, box=box)
            torch.cuda.synchronize()
            raw, pot = pp_block_plain(p64, p64, m64, eps, box)
            phi_ref = -G * (pot - m64 / eps)
            if box == 0.0:
                acc_ref, epot = direct_acc_chunked(p64, m64, eps, G)
                e_err = abs(float(0.5 * torch.sum(m64 * phi.double()) - epot)
                            / float(epot))
            else:
                # the dense oracle holds (N, N, 3): the chunked plain
                # version above 1,000 particles
                acc_ref = (direct_acc_periodic(p64, m64, box, eps, G)
                           if n <= 1000 else G * raw)
                e_err = 0.0
            ra, rp = rel_l2(acc, acc_ref), rel_l2(phi, phi_ref)
            phase(f"[15] K7 allpairs N={n} box={box:g}: acc rel L2 {ra:.3e},"
                  f" phi rel L2 {rp:.3e} (tol {FORCE_REL_L2_TOL:g})"
                  + (f", E_pot vs direct_acc_chunked {e_err:.3e}"
                     if box == 0.0 else ""))
            if not max(ra, rp, e_err) <= FORCE_REL_L2_TOL:
                raise AssertionError(f"K7 N={n} box={box} disagrees: {ra}, "
                                     f"{rp}, {e_err}")
    ti = systems.plummer(3001, seed=11).pos
    src = systems.plummer(5000, seed=12, total_mass=2.0)
    acc, pot = block_acc_pallas(ti, src.pos, src.mass, eps)
    torch.cuda.synchronize()
    ref = pp_block_plain(ti.double(), src.pos.double(), src.mass.double(), eps)
    ra, rp = rel_l2(acc, ref[0]), rel_l2(pot, ref[1])
    phase(f"[15] K7 block_acc Ni=3001 Nj=5000: acc rel L2 {ra:.3e}, pot rel "
          f"L2 {rp:.3e} (tol {FORCE_REL_L2_TOL:g})")
    if not max(ra, rp) <= FORCE_REL_L2_TOL:
        raise AssertionError(f"K7 block_acc disagrees: {ra}, {rp}")

    # float64: the Kepler pair, then the Kepler orbit for one period and
    # ten years of the solar system, each against the same drive on the
    # CPU (the plain version)
    Gs = units.SOLAR.G
    kep = systems.two_body(G=Gs)
    acc, _ = allpairs_pallas(kep.pos, kep.mass, 1e-8, Gs)
    ra = rel_l2(acc, direct_acc(kep.pos, kep.mass, 1e-8, Gs))
    if acc.dtype != torch.float64 or not ra <= F64_REL_TOL:
        raise AssertionError(f"K7 float64 on the Kepler pair: {acc.dtype}, "
                             f"{ra}")
    period = systems.kepler_period(1.0, 1.0 + 3.0035e-6, G=Gs)
    drives = {"Kepler": (kep, period / 2048, 2048, 1e-8),
              "solar system": (systems.solar_system(), 1.0 / 365.25, 3652,
                               1e-6)}
    for name, (st0, dt, steps, e) in drives.items():
        def acc_fn(p, m, e=e):
            return allpairs_pallas(p, m, e, Gs)

        before = block_acc_pallas.launches
        t0 = time.perf_counter()
        fin = run(st0, dt, steps, acc_fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if block_acc_pallas.launches - before != steps + 1:
            raise AssertionError(f"{name}: the drive did not run K7")
        fin_cpu = run(st0.to("cpu"), dt, steps, acc_fn)
        scale = float(fin_cpu.pos.abs().max())
        d_pos = float((fin.pos.cpu() - fin_cpu.pos).abs().max()) / scale
        e0 = float(total_energy(st0, eps=e, G=Gs))
        drift = abs(float(total_energy(fin, eps=e, G=Gs)) / e0 - 1.0)
        p_max = float(momentum(fin).abs().max())
        msg = (f"[15] K7 float64 {name}: {steps} steps in {wall:.2f} s; "
               f"final positions vs the CPU drive {d_pos:.3e} (tol "
               f"{F64_DRIVE_TOL:g}); |dE/E| {drift:.3e}, max |P| {p_max:.3e}")
        if name == "Kepler":
            sep0, sep1 = st0.pos[1] - st0.pos[0], fin.pos[1] - fin.pos[0]
            closure = float((sep1 - sep0).abs().max())
            msg += f"; orbit closure {closure:.3e} AU (tol 2e-4)"
            ok = closure <= 2e-4
        else:
            # tests/test_systems.py's gates for 100 years
            msg += " (tol 5e-6, 1e-10)"
            ok = drift < 5e-6 and p_max < 1e-10
        phase(msg)
        if not (ok and d_pos <= F64_DRIVE_TOL):
            raise AssertionError(f"K7 float64 {name} drive: {msg}")


def _k7_original():
    """K7's design before its redesign for Hopper (one target a thread,
    rsqrtf, no source slices): ``scripts/torch_k7_ablation.py``'s
    ``original`` variant, built in this run.  Returns (the ablation
    module, the loaded library)."""
    if not hasattr(_k7_original, "built"):
        abl = _ablation("torch_k7_ablation")
        so, _ = abl.build_all(["original"])[
            abl.source_tag(abl.VARIANTS["original"][0])]
        _k7_original.built = (abl, abl.load(so))
    return _k7_original.built


def k7_shape_check(tag: str, pos_i, pos_j, mass_j, eps: float) -> None:
    """K7's launch shape for targets ``pos_i`` against sources ``pos_j``
    (R, target blocks, slices S, resident blocks per SM); two launches on
    the same inputs, which must be equal bit for bit; and one launch of
    the design before the redesign on the same inputs, which must agree
    to FORCE_REL_L2_TOL, timed beside the redesign's launch."""
    from nbody_torch.forces.pallas_pp import (
        _run,
        block_acc_pallas,
        card_geometry,
    )

    geo = card_geometry(pos_i, pos_j)
    first = block_acc_pallas(pos_i, pos_j, mass_j, eps)
    second = block_acc_pallas(pos_i, pos_j, mass_j, eps)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    abl, lib = _k7_original()
    old_geo = abl.variant_geometry(lib, 1, pos_i, pos_j)
    old = _run(lib, old_geo, pos_i, pos_j, mass_j, eps, 0.0)
    rel = max(rel_l2(old[:, :3], first[0].double()),
              rel_l2(old[:, 3], first[1].double()))
    old_ms = cuda_time_ms(
        lambda: _run(lib, old_geo, pos_i, pos_j, mass_j, eps, 0.0), 5)
    new_ms = cuda_time_ms(
        lambda: block_acc_pallas(pos_i, pos_j, mass_j, eps), 5)
    phase(f"{tag} K7 launch shape {pos_i.shape[0]} x {pos_j.shape[0]}: R "
          f"{geo.targets_per_thread} targets a thread, {geo.target_blocks} "
          f"target blocks x S {geo.slices} slices of {geo.slice_sources} "
          f"sources, {geo.blocks_per_sm} resident blocks per SM on "
          f"{geo.sms} SMs; two launches equal bit for bit: {same}; the "
          f"design before the redesign (R {old_geo.targets_per_thread}, S "
          f"{old_geo.slices}, built in this run) {old_ms:.4f} ms a launch "
          f"against {new_ms:.4f} ms ({old_ms / new_ms:.3f}x), rel L2 "
          f"between them {rel:.3e} (tol {FORCE_REL_L2_TOL:g})")
    if not same:
        raise AssertionError(f"{tag} two K7 launches on the same inputs "
                             f"differ")
    if not rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"{tag} K7 and its design before the "
                             f"redesign disagree: {rel}")


def pp_kernel_time(n: int) -> dict:
    """[15] K7 at N particles (the Plummer drive's shape): each wrapper's
    time, its plain version's and the bound; returns the two rows'
    numbers (max_abs_err against the float64 plain version)."""
    from nbody_torch.forces.pallas_pp import (
        allpairs_pallas,
        block_acc_pallas,
        pp_block_plain,
    )
    from nbody_torch.ic import systems

    eps = 0.05
    st = systems.plummer(n, seed=0)
    pos, mass = st.pos, st.mass
    # x, y, z and m of each particle read once, four sums written for each
    b_ms, b_by = bound(16 * n + 16 * n, FLOPS_PAIR_K7 * n * n)

    def allpairs_plain(p, m):
        acc, pot = pp_block_plain(p, p, m, eps)
        return acc, -(pot - m / eps)

    k7_shape_check("[15]", pos, pos, mass, eps)
    raw64 = pp_block_plain(pos.double(), pos.double(), mass.double(), eps)
    out = {}
    for key, fn, plain, ref in (
            ("K7", lambda: allpairs_pallas(pos, mass, eps), allpairs_plain,
             (raw64[0], -(raw64[1] - mass.double() / eps))),
            ("K7b", lambda: block_acc_pallas(pos, pos, mass, eps),
             lambda p, m: pp_block_plain(p, p, m, eps), raw64)):
        got = fn()
        torch.cuda.synchronize()
        err = max(max_abs(got[0], ref[0]), max_abs(got[1], ref[1]))
        rel = rel_l2(got[0], ref[0])
        ms = cuda_time_ms(fn, 10)
        plain_ms = cuda_time_ms(lambda: plain(pos, mass), 1, warm=False)
        phase(f"[15] {key} at N={n}: acc rel L2 {rel:.3e} (tol "
              f"{FORCE_REL_L2_TOL:g}), max abs {err:.3e}; kernel {ms:.4f} ms"
              f" ({n * n / ms * 1e3:.4e} interactions/s), plain f32 "
              f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        if not rel <= FORCE_REL_L2_TOL:
            raise AssertionError(f"{key} at N={n} disagrees: {rel}")
        out[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return out


def ewald_check(noise, n_side: int = 32) -> int:
    """[16] The Ewald PP force at the default 32^3 ICs, float32 on the card
    against float64 on the card (K1's and the k-space half's plain
    versions); the default solver='pp' run through run_simulation with
    K1's launches equal to the evaluations counted from run.log; the
    16^3 PP run from the JAX noise against the JAX P(k), and K1 alone at
    the ICs (``k1_check``).  Returns K1's launches in the default PP run,
    its P(k) file and K1's numbers at the ICs for the kernels line."""
    from nbody_torch.core import units
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import realize_ics, run_simulation
    from nbody_torch.forces.ewald import ewald_kspace_acc, ewald_pp_acc
    from nbody_torch.forces.p3m import p3m_short_plain

    cfg = SimulationConfig(n_side=n_side, solver="pp",
                           output=OutputConfig(snapshot=False))
    box, eps, G = cfg.box, cfg.eps, units.COSMO.G
    soft = cfg.softening_kernel
    st = realize_ics(cfg, 0)
    pos, mass = st.pos, st.mass
    got = ewald_pp_acc(pos, mass, box, eps=eps, G=G, softening=soft)
    torch.cuda.synchronize()
    p64, m64 = pos.double(), mass.double()
    sr = p3m_short_plain(p64, m64, box, eps, box / 16.0, 0.4999 * box, G=G,
                         split="gaussian", softening=soft)
    lr = ewald_kspace_acc(p64, m64, box, G=G)
    rel, rel_lr = rel_l2(got, sr + lr), rel_l2(
        ewald_kspace_acc(pos, mass, box, G=G), lr)
    lr_ms = cuda_time_ms(lambda: ewald_kspace_acc(pos, mass, box, G=G), 20)
    phase(f"[16] ewald_pp_acc at the {n_side}^3 ICs, float32 vs float64: "
          f"rel L2 {rel:.3e} (tol {FORCE_REL_L2_TOL:g}), k-space half alone "
          f"{rel_lr:.3e}; |acc| real-space {float(sr.norm()):.4e}, k-space "
          f"{float(lr.norm()):.4e}; k-space half {lr_ms:.4f} ms")
    if not rel <= FORCE_REL_L2_TOL:
        raise AssertionError(f"[16] ewald_pp_acc float32 disagrees: {rel}")
    k1_pp = k1_check("[16] K1 (Gaussian split, r_cut 0.4999 box) at the "
                     f"{n_side}^3 ICs", pos, mass,
                     (box, eps, box / 16.0, 0.4999 * box, G, "gaussian",
                      soft), 20)

    work = os.path.join(OUT, "default_pp")
    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    res = run_simulation(cfg, 0, work)
    counts = read_launches()
    lines = run_log(work)
    evals = cfg.n_steps + 1 + rerun_evals(lines)
    phase(f"[16] default PP run: N={cfg.n_particles} {cfg.n_steps} steps in "
          f"{res.wall_s:.3f} s ({cfg.n_steps / res.wall_s:.2f} steps/s); "
          f"launches {counts}; a = {float(res.state.time):.4f}")
    for line in lines:
        phase("    run.log: " + line)
    check_run_outputs(res, cfg, "[16]")
    want = zero_launches(K1=evals)
    if counts != want or res.config_run != cfg:
        raise AssertionError(f"[16] launches {counts}, expected {want}")

    pp16 = SimulationConfig(n_side=16, solver="pp",
                            output=OutputConfig(snapshot=False))
    work16 = os.path.join(OUT, "n16_pp")
    shutil.rmtree(work16, ignore_errors=True)
    res16 = run_simulation(pp16, 0, work16,
                           initial_state=realize_ics(pp16, 0, noise=noise))
    pk_vs_reference(res16, pp16, "powerspec_a=1.00_n16_pp_seed0",
                    "[16] 16^3 PP from the JAX noise")
    return counts["K1"], res.powerspecs[0], k1_pp


def plummer_run(n: int, steps: int, acc_fn) -> dict:
    """``steps`` steps of run_with_diagnostics on plummer(n) (dt 1e-3, a
    sample every 25 steps) through ``acc_fn``, with every launch count
    reset before and read after: wall, steps/s, interactions/s, |dE/E|,
    |P| / sum m|v|, E0, the launch counts and whether the state is sound."""
    from nbody_torch.ic import systems
    from nbody_torch.integrate.leapfrog import run_with_diagnostics

    state = systems.plummer(n, seed=0)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    final, d0, diags = run_with_diagnostics(state, 1e-3, steps, acc_fn,
                                            diag_every=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    e = torch.cat([(d0.e_kin + d0.e_pot)[None],
                   diags.e_kin + diags.e_pot]).double().cpu().numpy()
    mom = float(diags.momentum.double().abs().max())
    p_scale = float(torch.sum(final.mass * final.vel.norm(dim=1)))
    sound = final.pos.shape == (n, 3) and all(
        bool(torch.isfinite(t).all()) for t in (final.pos, final.vel))
    return dict(wall=wall, steps_per_s=steps / wall,
                rate=n * n * (steps + 1) / wall,
                drift=float(np.abs(e - e[0]).max() / abs(e[0])),
                mom=mom / p_scale, e0=float(e[0]), samples=len(e),
                counts=counts, sound=sound)


def plummer_line(tag: str, n: int, steps: int, run: dict, tol: float) -> str:
    return (f"{tag} Plummer N={n}: {steps} steps in {run['wall']:.3f} s "
            f"({run['steps_per_s']:.3f} steps/s, {run['rate']:.4e} "
            f"interactions/s); |dE/E| {run['drift']:.3e} over "
            f"{run['samples']} samples (tol {tol:g}); max |P| / sum m|v| "
            f"{run['mom']:.3e} (tol {MOMENTUM_TOL:g}); E0 {run['e0']:.8f}; "
            f"launches {run['counts']}")


def plummer_drive(n: int, steps: int) -> dict:
    """[17] plummer(4096) over 200 steps against the JAX package's
    committed energy and momentum series; then the Plummer drive at N
    particles through K7 (:func:`plummer_run`, eps 0.05).  Returns that
    run's numbers."""
    from nbody_torch.forces.pallas_pp import allpairs_pallas
    from nbody_torch.ic import systems
    from nbody_torch.integrate.leapfrog import run_with_diagnostics

    def acc_fn(p, m):
        return allpairs_pallas(p, m, eps=0.05)

    ref = np.loadtxt(os.path.join(PORT_DATA, "plummer4096_energy_seed0.txt"))
    _, d0, diags = run_with_diagnostics(systems.plummer(4096, seed=0), 1e-3,
                                        200, acc_fn, diag_every=25)
    e_kin = torch.cat([d0.e_kin[None], diags.e_kin]).double().cpu().numpy()
    e_pot = torch.cat([d0.e_pot[None], diags.e_pot]).double().cpu().numpy()
    mom = torch.cat([d0.momentum[None], diags.momentum]).double().cpu().numpy()
    e0 = abs(ref[0, 4])
    e_err = max(np.abs(e_kin - ref[:, 2]).max(), np.abs(e_pot - ref[:, 3]).max(),
                np.abs(e_kin + e_pot - ref[:, 4]).max()) / e0
    p_err = np.abs(mom - ref[:, 5:]).max()
    drift = np.abs(e_kin + e_pot - e_kin[0] - e_pot[0]).max() / e0
    phase(f"[17] plummer(4096) vs the JAX series at {len(ref)} samples over "
          f"200 steps: energies {e_err:.3e} of |E0| (tol {SERIES_E_TOL:g}), "
          f"momentum {p_err:.3e} (tol {SERIES_P_TOL:g}); |dE/E| {drift:.3e} "
          f"(JAX {np.abs(ref[:, 4] - ref[0, 4]).max() / e0:.3e})")
    if not (e_err <= SERIES_E_TOL and p_err <= SERIES_P_TOL):
        raise AssertionError(f"[17] the plummer(4096) series differs: "
                             f"{e_err}, {p_err}")

    run = plummer_run(n, steps, acc_fn)
    phase(plummer_line("[17]", n, steps, run, PLUMMER_DRIFT_TOL))
    want = zero_launches(K7=steps + 1, K7b=steps + 1)
    if run["counts"] != want or not run["sound"]:
        raise AssertionError(f"[17] launches {run['counts']}, expected "
                             f"{want}; sound {run['sound']}")
    if not (run["drift"] < PLUMMER_DRIFT_TOL and run["mom"] < MOMENTUM_TOL):
        raise AssertionError(f"[17] |dE/E| {run['drift']}, |P| {run['mom']}")
    return run


def k8_errors(acc, phi, mass, ref, ref_phi):
    """(median and largest per-particle relative force error, relative
    E_pot error) of K8's float32 output against float64 references."""
    err = (acc.double() - ref).norm(dim=1) / ref.norm(dim=1)
    e_pot = float(torch.sum(mass.double() * phi.double()))
    e_ref = float(torch.sum(mass.double() * ref_phi))
    return float(err.median()), float(err.max()), abs(e_pot / e_ref - 1.0)


def k8_gate(tag: str, med: float, worst: float, e_err: float) -> str:
    if not (med < K8_MEDIAN_TOL and worst < K8_MAX_TOL
            and e_err <= K8_EPOT_TOL):
        raise AssertionError(f"{tag}: median {med}, max {worst}, E_pot "
                             f"{e_err}")
    return (f"force error median {med:.3e} (tol {K8_MEDIAN_TOL:g}), max "
            f"{worst:.3e} (tol {K8_MAX_TOL:g}); E_pot {e_err:.3e} (tol "
            f"{K8_EPOT_TOL:g})")


def mxu_kernel_check(sizes=(200, 1500, 32768)) -> None:
    """[18] K8 against its float64 plain version, uniform in a 500 box with
    eps 0.5 and unit masses (the JAX package's envelope shape), sorted and
    unsorted; its wrapper refuses eps = 0, float64 and non-contiguous
    positions without launching."""
    from nbody_torch.forces.pallas_mxu import (
        allpairs_pallas_mxu,
        gram_allpairs_plain,
    )

    eps = 0.5
    for n in sizes:
        rng = np.random.default_rng(n)
        pos = torch.tensor(rng.uniform(0, 500.0, (n, 3)),
                           dtype=torch.float32, device="cuda")
        mass = torch.ones(n, device="cuda")
        for sort in (True, False):
            acc, phi = allpairs_pallas_mxu(pos, mass, eps, sort=sort)
            torch.cuda.synchronize()
            ref, ref_phi = gram_allpairs_plain(pos.double(), mass.double(),
                                               eps, sort=sort)
            tag = f"[18] K8 N={n} sort={sort}"
            phase(f"{tag} vs float64: "
                  + k8_gate(tag, *k8_errors(acc, phi, mass, ref, ref_phi)))
    before = allpairs_pallas_mxu.launches
    bad = {"eps = 0": lambda: allpairs_pallas_mxu(pos, mass, 0.0),
           "float64": lambda: allpairs_pallas_mxu(pos.double(), mass.double(),
                                                  eps),
           "non-contiguous": lambda: allpairs_pallas_mxu(
               pos.T.contiguous().T, mass, eps)}
    for what, fn in bad.items():
        try:
            fn()
        except (TypeError, ValueError):
            continue
        raise AssertionError(f"[18] K8's wrapper accepted: {what}")
    if allpairs_pallas_mxu.launches != before:
        raise AssertionError("[18] a refused call launched K8")
    phase(f"[18] K8's wrapper refuses: {', '.join(bad)}")


def mxu_bench(n: int) -> dict:
    """[18] K8 at the JAX package's bench conditions (scripts/exp_mxu.py:
    N uniform in a 500 box, eps 0.03 * 500 / 64, default_rng(7), unit
    masses, default tiles): its error against K7's float64 form at 2^15
    (exp_mxu's check) and at N; the launch's time (CUDA events around the
    launch alone), the whole function's (sort and scatter included), K7's
    on the same positions and the plain version's; and the bound.  Returns
    K8's row."""
    from nbody_torch.forces import pallas_mxu as mx
    from nbody_torch.forces.pallas_pp import allpairs_pallas

    box = 500.0
    eps = 0.03 * box / round(n ** (1 / 3))
    rng = np.random.default_rng(7)
    pos = torch.tensor(rng.uniform(0, box, (n, 3)), dtype=torch.float32,
                       device="cuda")
    mass = torch.ones(n, device="cuda")
    for m in (1 << 15, n):
        p, pm = pos[:m].contiguous(), mass[:m]
        acc, phi = mx.allpairs_pallas_mxu(p, pm, eps)
        ref, ref_phi = allpairs_pallas(p.double(), pm.double(), eps)
        torch.cuda.synchronize()
        tag = f"[18] K8 N={m} (exp_mxu)"
        phase(f"{tag} vs K7 float64: "
              + k8_gate(tag, *k8_errors(acc, phi, pm, ref, ref_phi)))
    err = max(max_abs(acc, ref), max_abs(phi, ref_phi))
    again = mx.allpairs_pallas_mxu(pos, mass, eps)
    same = torch.equal(acc, again[0]) and torch.equal(phi, again[1])
    # K8 before its redesign on the same sorted particles
    abl, orig = _k8_original()
    perm, pos_s, mass_s, ctr = mx._sorted_tiles(pos, mass, 256, 1024, True, 6)
    pos4 = torch.cat([pos_s, mass_s[:, None]], dim=1)
    o_launch, o_out = abl.launcher("original", orig, dict(pos4=pos4, ctr=ctr),
                                   eps)
    o_launch()
    o_acc, o_phi = mx._unsort(perm, o_out[:n, :3], -o_out[:n, 3])
    o_err = k8_errors(o_acc, o_phi, mass, ref, ref_phi)
    phase(f"[18] K8 at N={n}: two launches "
          f"{'equal bit for bit' if same else 'DIFFERENT'}; K8 before the "
          f"redesign (scripts/torch_k8_ablation.py's original, built in this "
          f"run) vs K7 float64: " + k8_gate("[18] K8 original", *o_err))
    if not same:
        raise AssertionError("[18] two K8 launches differ")
    del ref, ref_phi, o_acc, o_phi

    ms = cuda_time_ms(lambda: mx._launch(pos4, ctr, 256, eps), 10)
    o_ms = cuda_time_ms(o_launch, 10)
    fn_ms = cuda_time_ms(lambda: mx.allpairs_pallas_mxu(pos, mass, eps), 10)
    host = enqueue_ms(lambda: mx.allpairs_pallas_mxu(pos, mass, eps), 3)
    k7_ms = cuda_time_ms(lambda: allpairs_pallas(pos, mass, eps), 10)
    info = (ctypes.c_int * 4)()
    from nbody_torch._kernels import load_library

    load_library().pp_gram_info(info)
    plain_ms = cuda_time_ms(lambda: mx.gram_allpairs_plain(pos, mass, eps), 1,
                            warm=False)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pairs = pos4.shape[0] ** 2
    t_sfu = pairs / (RSQRT_PER_CLOCK_SM * sms * clock_mhz * 1e6) * 1e3
    t_tc = FLOPS_PAIR_K8_TC * pairs / PEAK_TF32_FLOPS * 1e3
    # x, y, z and m of each particle read once, four sums written for each
    t_bytes = 32 * n / PEAK_BYTES_PER_S * 1e3
    b_ms = max(t_sfu, t_tc, t_bytes)
    b_by = "bytes" if b_ms == t_bytes else "operations"
    phase(f"[18] K8 at N={n} (exp_mxu, eps {eps:g}): launch {ms:.4f} ms "
          f"({n * n / ms * 1e3:.4e} interactions/s; blocks of {info[0]} "
          f"targets, {info[2]} warps, tiles of {info[1]} sources, {info[3]} "
          f"resident an SM), the function {fn_ms:.4f} ms "
          f"({n * n / fn_ms * 1e3:.4e}/s), its host enqueue {host:.4f} ms; "
          f"K7 {k7_ms:.4f} ms ({n * n / k7_ms * 1e3:.4e}/s; K8/K7 "
          f"{ms / k7_ms:.3f}); K8 before the redesign {o_ms:.4f} ms "
          f"({o_ms / ms:.3f}x); plain f32 {plain_ms:.3f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}: rsqrt on the SFU {t_sfu:.4f} ms at "
          f"{clock_mhz:g} MHz x {sms} SMs, TF32 products {t_tc:.4f} ms, "
          f"bytes {t_bytes:.4f} ms); max abs error vs float64 {err:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, function_ms=fn_ms,
                enqueue_ms=host, k7_ms=k7_ms, original_ms=o_ms)


def mxu_drive(n: int, steps: int, k7_run: dict) -> int:
    """[18] the Plummer drive of [17] with K8 as its force (the JAX
    package's ForceFn contract, eps 0.05).  Returns K8's launches."""
    from nbody_torch.forces.pallas_mxu import allpairs_pallas_mxu

    def acc_fn(p, m):
        return allpairs_pallas_mxu(p, m, eps=0.05)

    run = plummer_run(n, steps, acc_fn)
    phase(plummer_line("[18] K8", n, steps, run, K8_DRIFT_TOL))
    phase(f"[18] beside K7's [17] drive: {run['steps_per_s']:.3f} vs "
          f"{k7_run['steps_per_s']:.3f} steps/s, {run['rate']:.4e} vs "
          f"{k7_run['rate']:.4e} interactions/s, |dE/E| {run['drift']:.3e} "
          f"vs {k7_run['drift']:.3e}")
    want = zero_launches(K8=steps + 1)
    if run["counts"] != want or not run["sound"]:
        raise AssertionError(f"[18] launches {run['counts']}, expected "
                             f"{want}; sound {run['sound']}")
    if not (run["drift"] < K8_DRIFT_TOL and run["mom"] < MOMENTUM_TOL):
        raise AssertionError(f"[18] |dE/E| {run['drift']}, |P| {run['mom']}")
    return run["counts"]["K8"]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from nbody_torch import _kernels
    from nbody_torch.core import units
    from nbody_torch.driver import OutputConfig, SimulationConfig
    from nbody_torch.driver.simulate import (
        _resolved_shortrange,
        build_cosmo_force_frozen_both,
        column_knobs,
        prewarm_capacity,
        realize_ics,
        run_simulation,
        stale_tolerance,
    )
    from nbody_torch.forces.p3m import p3m_acc, p3m_short_params
    from nbody_torch.forces.p3m_columns import (
        REACH_FENCE,
        REACH_TARGETS,
        column_info,
    )
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    phase(f"[1] card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    _kernels.load_library()
    phase(f"[2] kernel library {os.path.basename(_kernels.build_info['path'])}"
          f" {'built' if _kernels.build_info['built'] else 'loaded'} in "
          f"{time.perf_counter() - t0:.2f} s")
    info = column_info(_kernels.load_library())
    if info != (REACH_TARGETS, REACH_FENCE, True):
        raise AssertionError(f"the column kernels' targets a block, probe "
                             f"spacing and search {info} differ from "
                             f"column_reach's {(REACH_TARGETS, REACH_FENCE)}")
    t0 = time.perf_counter()
    _columns_variants()
    phase(f"[2] the column kernels' design before the redesign and the "
          f"planted narrowed reach (scripts/torch_columns_ablation.py) built "
          f"in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _k1_variants()
    phase(f"[2] K1's design before the redesign and the planted narrowed "
          f"cull (scripts/torch_k1_ablation.py) built in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _k6_variants()
    phase(f"[2] K6's design before the redesign and the planted narrowed "
          f"neighbourhood (scripts/torch_k6_ablation.py) built in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    _k2_variants()
    _k8_original()
    phase(f"[2] K2's and K8's designs before the redesign "
          f"(scripts/torch_k2_ablation.py, scripts/torch_k8_ablation.py) "
          f"built in {time.perf_counter() - t0:.2f} s")

    # -- 3. K1 against its plain version at the main path's shape ---------
    cfg = SimulationConfig()
    n, box = cfg.n_particles, cfg.box
    r_s, r_cut, _, _ = p3m_short_params(box, cfg.mesh_size, n)
    G = units.COSMO.G
    # uniform random positions (no lattice cancellation to hide behind)
    # with the default run's particle masses
    gen = torch.Generator().manual_seed(1)
    pos = (torch.rand((n, 3), generator=gen, dtype=torch.float64)
           * box).to(dev, torch.float32)
    mass = realize_ics(cfg, 0).mass
    main_variant = (cfg.force_split, cfg.softening_kernel)
    k1 = {}
    for split in ("gaussian", "spline"):
        for soft in ("plummer", "spline"):
            k1[(split, soft)] = k1_check(
                f"[3] K1 {split}/{soft}", pos, mass,
                (box, cfg.eps, r_s, r_cut, G, split, soft), 50)

    # -- 4. the wrappers refuse what the kernels do not take --------------
    checked = check_wrappers_raise(pos, mass, box, cfg.eps, r_s, r_cut, G)
    phase(f"[4] wrapper checks raise for: {', '.join(checked)}")

    # -- 5. the default run through the entry point -----------------------
    run_cfg = cfg.replace(output=OutputConfig(snapshot=False))
    work = os.path.join(OUT, "default")
    shutil.rmtree(work, ignore_errors=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = run_simulation(run_cfg, 0, work)
    counts = read_launches()
    k1_launches = counts["K1"]
    # the single-device runs [19] sets its domain runs beside
    single = {"default": dict(pk=res.powerspecs[0], wall=res.wall_s,
                              mem=torch.cuda.max_memory_allocated() / 2**20)}
    phase(f"[5] default run: N={run_cfg.n_particles} mesh "
          f"{run_cfg.mesh_size} {run_cfg.n_steps} steps in {res.wall_s:.3f} s"
          f" ({run_cfg.n_steps / res.wall_s:.2f} steps/s); launches "
          f"{counts}; a = {float(res.state.time):.4f}")
    for line in run_log(work):
        phase("    run.log: " + line)
    check_run_outputs(res, run_cfg, "[5]")
    want = zero_launches(K1=run_cfg.n_steps + 1)
    if counts != want:
        raise AssertionError(f"[5] launches {counts}, expected {want}")
    k1_check("[5] K1 on the run's final state", res.state.pos.contiguous(),
             res.state.mass.contiguous(),
             (box, cfg.eps, r_s, r_cut, G, *main_variant), 50)

    # -- 6. parity with the JAX package through committed data ------------
    noise = np.load(os.path.join(PORT_DATA, "white_noise_n16_seed0.npy"))
    par_cfg = SimulationConfig(n_side=16, output=OutputConfig(snapshot=False))
    work16 = os.path.join(OUT, "n16")
    shutil.rmtree(work16, ignore_errors=True)
    res16 = run_simulation(par_cfg, 0, work16,
                           initial_state=realize_ics(par_cfg, 0, noise=noise))
    pk_vs_reference(res16, par_cfg, "powerspec_a=1.00_n16_seed0",
                    "[6] 16^3 from the JAX noise")

    # -- 7. K2-K4 against their plain versions at cfg64's shapes ----------
    # each tier's plane at the geometry its run starts from: the driver's
    # pre-warm on the ICs, healed by its rule until nothing overflows
    cfg64 = SimulationConfig(n_side=64, box=500.0, pm_grid=128, n_steps=142,
                             softening_kernel="spline",
                             output=OutputConfig(snapshot=False))
    col64 = cfg64.replace(shortrange="columns")
    ics64 = realize_ics(cfg64, 0)
    kernels = supercell_kernels_check(ics64, cfg64, cfg64,
                                      "64^3 ICs, supercell tier", True)
    kernels.update(columns_kernel_check(ics64, col64, col64,
                                        "64^3 ICs, columns tier", True))

    # -- 8. the three tiers agree at the 64^3 ICs -------------------------
    akw = dict(G=G, eps=cfg64.eps, split=cfg64.force_split,
               softening=cfg64.softening_kernel, with_overflow=True)
    accs = {}
    cells64 = cfg64.replace(shortrange="cells")
    for tier, tcfg in (("supercell", cfg64), ("columns", col64),
                       ("cells", cells64), ("allpairs", None)):
        knobs = {}
        if tier == "cells":
            # the cell capacity the driver's pre-warm gives
            grown, _ = prewarm_capacity(cells64, cells64, ics64.pos)
            knobs = dict(capacity=grown.cell_capacity)
        elif tcfg is not None:
            # the capacity and window the driver's pre-warm and heal reach
            healed, _ = driver_knobs(ics64, tcfg, tcfg, True)
            _, ck_t, w_t = column_knobs(tcfg, healed)
            knobs = dict(capacity=ck_t, window=w_t)
        t_tier = time.perf_counter()
        acc, ov = p3m_acc(ics64.pos, ics64.mass, cfg64.box, cfg64.mesh_size,
                          shortrange=tier, **knobs, **akw)
        torch.cuda.synchronize()
        if int(ov):
            raise AssertionError(f"[8] {tier} tier overflows at the ICs: "
                                 f"{int(ov)}")
        accs[tier] = acc.double()
        phase(f"[8] {tier} {knobs}: {time.perf_counter() - t_tier:.3f} s")
    scale = float(accs["allpairs"].norm(dim=1).max())
    for tier in ("supercell", "columns", "cells"):
        err = float((accs[tier] - accs["allpairs"]).norm(dim=1).max()) / scale
        phase(f"[8] {tier} vs allpairs at the 64^3 ICs: max |diff| / max "
              f"|acc| {err:.3e} (tol {TIER_TOL:g})")
        if not err <= TIER_TOL:
            raise AssertionError(f"[8] {tier} disagrees with allpairs: {err}")
    del accs

    # -- 9. the 64^3 production run, and its columns-tier twin ------------
    launch_counts = {}
    results = {}
    for run64 in (cfg64, col64):
        work64 = os.path.join(OUT, f"cfg64_{run64.shortrange}")
        shutil.rmtree(work64, ignore_errors=True)
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res64 = run_simulation(run64, 0, work64)
        counts = read_launches()
        lines = run_log(work64)
        resolved = _resolved_shortrange(run64)
        healed = res64.config_run
        phase(f"[9] 64^3 run ({resolved} tier): N={run64.n_particles} mesh "
              f"{run64.mesh_size} {run64.n_steps} steps in {res64.wall_s:.3f}"
              f" s ({run64.n_steps / res64.wall_s:.2f} steps/s); launches "
              f"{counts}; column_capacity {healed.column_capacity}, "
              f"column_window {healed.column_window}; a = "
              f"{float(res64.state.time):.4f}")
        for line in lines:
            if ("pre-warming" in line or "re-running" in line
                    or "Capacity heals" in line or "Initial" in line
                    or line.startswith("Time step")):
                phase("    run.log: " + line)
        check_run_outputs(res64, run64, f"[9] {resolved}")
        evals = run64.n_steps + 1 + rerun_evals(lines)
        fused = "K3" if resolved == "supercell" else "K4"
        want = zero_launches(K2=evals if resolved == "supercell" else 0,
                             K3=evals if resolved == "supercell" else 0,
                             K4=evals if resolved == "columns" else 0)
        if counts != want:
            raise AssertionError(f"[9] {resolved}: launches {counts}, "
                                 f"expected {want}")
        if run64 is cfg64 and resolved != "supercell":
            raise AssertionError(f"cfg64 resolved to {resolved}")
        launch_counts[resolved] = counts
        results[resolved] = res64
        single[resolved] = dict(pk=res64.powerspecs[0], wall=res64.wall_s,
                                mem=torch.cuda.max_memory_allocated() / 2**20)
        phase(f"[9] {resolved}: {fused} launched {counts[fused]} = "
              f"{run64.n_steps} steps + 1 + {evals - run64.n_steps - 1} "
              f"re-run evaluations")
    # the last force evaluation of each run was at its final state, with
    # the healed config
    sc, col = results["supercell"], results["columns"]
    supercell_kernels_check(sc.state, cfg64, sc.config_run,
                            "final state of the supercell run", False)
    columns_kernel_check(col.state, col64, col.config_run,
                         "final state of the columns run", False)
    del results, sc, col

    # -- 10. the 16^3 supercell run against the committed JAX P(k) --------
    sc16 = SimulationConfig(n_side=16, shortrange="supercell",
                            output=OutputConfig(snapshot=False))
    work16s = os.path.join(OUT, "n16_supercell")
    shutil.rmtree(work16s, ignore_errors=True)
    res16s = run_simulation(sc16, 0, work16s,
                            initial_state=realize_ics(sc16, 0, noise=noise))
    pk_vs_reference(res16s, sc16, "powerspec_a=1.00_n16_supercell_seed0",
                    "[10] 16^3 supercell from the JAX noise")

    # -- 12. the default 32^3 config with rungs=3 (K1 + K6) ---------------
    r32 = run_cfg.replace(rungs=3)
    res32, counts, lines, boundary, interior = rung_run(
        r32, "[12]", os.path.join(OUT, "default_rungs3"))
    phase(f"[12] default 32^3 run, rungs=3: {r32.n_steps} steps in "
          f"{res32.wall_s:.3f} s ({r32.n_steps / res32.wall_s:.2f} steps/s);"
          f" launches {counts}; cell_capacity "
          f"{res32.config_run.cell_capacity}, rung_capacity "
          f"{res32.config_run.rung_capacity}")
    rung_lines("[12]", lines)
    want = zero_launches(K1=boundary, K6=interior)
    if counts != want:
        raise AssertionError(f"[12] launches {counts}, expected {want}")
    k6_launches = counts["K6"]
    single["rungs32"] = dict(pk=res32.powerspecs[0], wall=res32.wall_s,
                             mem=torch.cuda.max_memory_allocated() / 2**20,
                             pops=rung_populations(lines)[-1])

    # -- 13. cfg64 with rungs=3: frozen plans, K2 + K3 and K5 ------------
    r64 = cfg64.replace(rungs=3)
    res64r, counts, lines, boundary, interior = rung_run(
        r64, "[13]", os.path.join(OUT, "cfg64_rungs3"))
    frozen = build_cosmo_force_frozen_both(res64r.config_run)
    if frozen is None or len(frozen) != 6:
        raise AssertionError("[13] cfg64 rungs=3 does not ride the frozen "
                             "masked column path")
    phase(f"[13] 64^3 run, rungs=3 (supercell tier, frozen plans): "
          f"{r64.n_steps} steps in {res64r.wall_s:.3f} s "
          f"({r64.n_steps / res64r.wall_s:.2f} steps/s); launches {counts};"
          f" column_capacity {res64r.config_run.column_capacity}, "
          f"column_window {res64r.config_run.column_window}, stale_max "
          f"{res64r.stale_max}; a = {float(res64r.state.time):.4f}")
    rung_lines("[13]", lines)
    want = zero_launches(K2=boundary, K3=boundary, K5=interior)
    if counts != want:
        raise AssertionError(f"[13] launches {counts}, expected {want}")
    k5_launches = counts["K5"]
    single["rungs64"] = dict(pk=res64r.powerspecs[0], wall=res64r.wall_s,
                             mem=torch.cuda.max_memory_allocated() / 2**20,
                             pops=rung_populations(lines)[-1])

    # -- 11. K5, K6 and the frozen-plane K2/K3 at full-size shapes --------
    # active sets from the rung rule at the late states of [5] and [13]
    act32 = rung_mask(res.state, r32)
    act64 = rung_mask(res64r.state, res64r.config_run)
    ics32 = realize_ics(cfg, 0)
    cell_kernel_check(ics32, act32, r32, "32^3 ICs")
    k6 = cell_kernel_check(res.state, act32, r32, "32^3 late state")
    cell_kernel_check(ics64, act64, r64, "64^3 ICs")
    k5 = masked_column_check(ics64, act64, r64, res64r.config_run,
                             "64^3 ICs, K5", 0.0)
    masked_column_check(ics64, act64, r64, res64r.config_run,
                        "64^3 ICs drifted, K5", 0.999)
    masked_column_check(ics64, act64, r64, res64r.config_run,
                        "64^3 ICs drifted with stale particles, K5", 0.999,
                        stale=stale_tolerance(r64))
    frozen_supercell_check(ics64, r64, res64r.config_run,
                           "64^3 ICs drifted to skin/2")
    kernels.update(K5=k5, K6=k6)

    # -- 14. the 16^3 rung runs against the committed JAX runs -------------
    for tag, shortrange in (("", "auto"), ("_supercell", "supercell")):
        r16 = SimulationConfig(n_side=16, rungs=3, a_begin=0.3, n_steps=6,
                               shortrange=shortrange,
                               output=OutputConfig(snapshot=False))
        res16r, counts, lines, boundary, interior = rung_run(
            r16, f"[14]{tag}", os.path.join(OUT, f"n16{tag}_rungs3"),
            initial_state=realize_ics(r16, 0, noise=noise))
        want = (zero_launches(K2=boundary, K3=boundary, K5=interior)
                if shortrange == "supercell"
                else zero_launches(K1=boundary, K6=interior))
        if counts != want:
            raise AssertionError(f"[14]{tag}: launches {counts}, expected "
                                 f"{want}")
        pk_vs_reference(res16r, r16, f"powerspec_a=1.00_n16{tag}_rungs3_seed0",
                        f"[14] 16^3{tag} rungs=3 from the JAX noise")
        ref = np.loadtxt(os.path.join(PORT_DATA, f"rung_population_n16{tag}"
                                                 f"_rungs3_seed0.txt"),
                         dtype=np.int64)
        got = np.array([p + [0] * (3 - len(p))
                        for p in rung_populations(lines)])
        worst = int(np.abs(got - ref[:, 1:]).max())
        phase(f"[14] 16^3{tag} rung populations vs JAX at {len(got)} steps: "
              f"largest difference {worst} particles (tol "
              f"{POP_TOL * r16.n_particles:g}); last {got[-1].tolist()} vs "
              f"{ref[-1, 1:].tolist()}; launches {counts}")
        if not worst <= POP_TOL * r16.n_particles:
            raise AssertionError(f"[14]{tag}: populations differ by {worst}")

    # -- 15. K7 against its plain version; its time at N = 262,144 --------
    pp_kernel_check()
    kernels.update(pp_kernel_time(PLUMMER_N))

    # -- 16. the Ewald PP solver (K1 with the Gaussian split) -------------
    k1_pp_launches, pp_pk, k1_pp = ewald_check(noise)

    # -- 17. the Plummer drive at N = 262,144 through K7 ------------------
    k7_run = plummer_drive(PLUMMER_N, 250)
    k7_launches = k7_run["counts"]["K7"]

    # -- 18. K8 against its plain version, at exp_mxu's shape, the drive --
    mxu_kernel_check()
    kernels["K8"] = mxu_bench(PLUMMER_N)
    k8_launches = mxu_drive(PLUMMER_N, 250, k7_run)

    # -- 19. the slab domain decomposition: four shards on the card -------
    # (a) each slab site against its plain version, at the domain
    # driver's geometry on every shard's plane
    kernels.update(slab_supercell_check(ics64, cfg64))
    kernels.update(slab_columns_check(ics64, col64))
    kernels.update(slab_cells_check(ics32, run_cfg, "[19] K6 slab at the "
                                    "32^3 ICs"))
    slab_cells_check(res.state, run_cfg, "[19] K6 slab at the default run's "
                     "final state", timed=False)
    # (b) the domain force against the single-device force of its tier,
    # at the ICs and on uniform random positions of the same count
    for ics, tcfg, tier in ((ics64, cfg64, "supercell"),
                            (ics64, col64, "columns"),
                            (ics32, run_cfg, "cells")):
        gen = torch.Generator().manual_seed(19)
        rnd = ics.replace(pos=(torch.rand(tuple(ics.pos.shape), generator=gen,
                                          dtype=torch.float64) * tcfg.box
                               ).to(dev, torch.float32))
        for st, per_particle in ((ics, False), (rnd, True)):
            if tier == "cells":
                cells_cfg = tcfg.replace(shortrange="cells")
                grown, _ = prewarm_capacity(cells_cfg, cells_cfg, st.pos)
                knobs = dict(capacity=grown.cell_capacity or None)
            else:
                healed, _ = driver_knobs(st, tcfg, tcfg, True)
                _, ck_t, w_t = column_knobs(tcfg, healed)
                knobs = dict(capacity=ck_t, window=w_t)
            domain_force_check(st, tcfg, tier, knobs, per_particle)
    # (c) the full runs through run_simulation with no device argument
    domain_counts = {
        "supercell": domain_run(cfg64.replace(devices=DOMAIN_SHARDS),
                                "cfg64_supercell", single["supercell"]),
        "columns": domain_run(col64.replace(devices=DOMAIN_SHARDS),
                              "cfg64_columns", single["columns"]),
        "cells": domain_run(run_cfg.replace(devices=DOMAIN_SHARDS),
                            "default_cells", single["default"]),
    }
    # (d) the 16^3 domain runs against the JAX package's committed P(k)
    for n_dev, shortrange, name in ((2, "auto", "domain2"),
                                    (4, "auto", "domain4"),
                                    (4, "supercell", "domain4_supercell"),
                                    (4, "columns", "domain4_columns")):
        c16 = SimulationConfig(n_side=16, devices=n_dev,
                               shortrange=shortrange,
                               output=OutputConfig(snapshot=False))
        work16d = os.path.join(OUT, f"n16_{name}")
        shutil.rmtree(work16d, ignore_errors=True)
        r16 = run_simulation(c16, 0, work16d,
                             initial_state=realize_ics(c16, 0, noise=noise))
        pk_vs_reference(r16, c16, f"powerspec_a=1.00_n16_{name}_seed0",
                        f"[19] 16^3 {name} from the JAX noise")

    # -- 20. rungs on the slab domain decomposition: four shards ---------
    # (d) the full-width runs through run_simulation with no device
    # argument, each beside the single-device rung run of [13] / [12]
    r64d, run64d = domain_rung_vs_single(
        r64.replace(devices=DOMAIN_SHARDS), "cfg64_rungs3", single["rungs64"])
    domain_rung_vs_single(r32.replace(devices=DOMAIN_SHARDS),
                          "default_rungs3", single["rungs32"])
    r32c, run32c = domain_rung_vs_single(
        r32.replace(devices=DOMAIN_SHARDS, column_skin=0.0),
        "default_rungs3_cells", single["rungs32"])
    if run64d["F"] == 0 or run32c["M"] == 0:
        raise AssertionError("[20] K5's or K6's masked slab site was not "
                             "launched by its run")
    # (a) K5's slab site and (b) K6's masked slab site at the runs'
    # geometries; (c) the two hazards, planted
    kernels.update(k5_slab_check(r64d, r64.replace(devices=DOMAIN_SHARDS)))
    c32c = r32.replace(devices=DOMAIN_SHARDS, column_skin=0.0)
    act32c = rung_mask(r32c.state, c32c.replace(devices=1))
    tcap32c = r32c.config_run.rung_capacity or 128
    kernels.update(k6_masked_slab_check(
        r32c.state, act32c, c32c, tcap32c, "[20] K6 masked slab at the 32^3 "
        "rung run's final state"))
    k6_masked_slab_check(ics32, act32c, c32c, tcap32c, "[20] K6 masked slab "
                         "at the 32^3 ICs (the final state's active set)",
                         timed=False)
    planted_hazards_check(r64d, r64.replace(devices=DOMAIN_SHARDS))
    # (e) the 16^3 domain rung runs against the JAX package's committed
    # runs (the same route: every JAX run kept its stale particles, at
    # most the port's tolerance)
    for n_dev, skin, name in ((2, -1.0, "domain2"), (4, -1.0, "domain4"),
                              (4, 0.0, "domain4_cells")):
        c16 = SimulationConfig(n_side=16, rungs=3, a_begin=0.3, n_steps=6,
                               devices=n_dev, column_skin=skin,
                               output=OutputConfig(snapshot=False))
        r16, run16 = domain_rung_run(
            c16, f"n16_{name}", initial_state=realize_ics(c16, 0, noise=noise))
        pk_vs_reference(r16, c16, f"powerspec_a=1.00_n16_{name}_rungs3_seed0",
                        f"[20] 16^3 {name} rungs=3 from the JAX noise")
        ref = np.loadtxt(os.path.join(
            PORT_DATA, f"rung_population_n16_{name}_rungs3_seed0.txt"),
            dtype=np.int64)
        got = np.array([p + [0] * (3 - len(p)) for p in run16["pops"]])
        worst = int(np.abs(got - ref[:, 1:]).max())
        phase(f"[20] 16^3 {name} rung populations vs JAX at {len(got)} steps:"
              f" largest difference {worst} particles (tol "
              f"{POP_TOL * c16.n_particles:g}); interior ticks on the "
              f"{run16['route']} route, stale_max {r16.stale_max}")
        if not worst <= POP_TOL * c16.n_particles:
            raise AssertionError(f"[20] {name}: populations differ by {worst}")

    # -- 21. the ring and replicated-grid forces of sharding.py ---------
    # (a) K7's ring site: the Plummer drive on four shards
    kernels["K7r"], k7r_launches = ring_site_check(PLUMMER_N, 100, k7_run)
    # (b) K6's replicated-grid site: cfg64 on four shards, beside one
    # device's cells tier; (d) the planted capacity
    kernels["K6r"] = replicated_grid_check(ics64, cfg64)
    sharded_p3m_vs_jax(noise)
    planted_capacity_check(ics64, cfg64)
    work_c = os.path.join(OUT, "cfg64_cells")
    shutil.rmtree(work_c, ignore_errors=True)
    res_c = run_simulation(cells64, 0, work_c)
    check_run_outputs(res_c, cells64, "[21] cfg64 cells")
    launches, geo = k6_replicated_launches(res_c.state, cfg64)
    phase(f"[21] replicated grid at the cfg64 cells run's final state: {geo}")
    k6_check("[21] K6 replicated-grid site at the final state", launches,
             timed=False)
    del launches
    phase(f"[21] cfg64 on one device's cells tier: {cells64.n_steps} steps "
          f"in {res_c.wall_s:.3f} s; cell_capacity "
          f"{res_c.config_run.cell_capacity}")
    k6r_launches = sharded_p3m_run(cfg64, ics64, res_c.powerspecs[0])
    # (c) solver='pp' on four devices through the driver
    ring_ewald_check(noise, pp_pk)

    # -- 22. the subcycled KDK and the slab-resident ICs ----------------
    # (a) the domain ICs and their realized spectrum from the JAX noise
    domain_ic_check()
    # (b) scripts/parity_study.py's cfg64 with subcycles=4 and its
    # measurement options (the default transfer function), and the
    # default 32^3 config with subcycles=4
    sub64 = cfg64.replace(subcycles=4, output=OutputConfig(
        snapshot=False, powerspec_bins=48, powerspec_binning="concept",
        realization_correction=True))
    res_s64, counts_s64, _ = subcycled_run(sub64, "cfg64_sub4")
    subcycled_run(run_cfg.replace(subcycles=4), "default_sub4")
    # (c) K4 at its frozen site on the plan the driver carries: at the
    # ICs (the knobs of the stretch's start) and at the final state (the
    # run's healed knobs), drifted to the edge of skin/2
    start, _ = driver_knobs(ics64, sub64, sub64, True)
    kernels["K4f"] = frozen_columns_check(ics64, sub64, start,
                                          "cfg64-sub4 ICs", 0.999)
    frozen_columns_check(res_s64.state, sub64, res_s64.config_run,
                         "cfg64-sub4 final state", 0.999)
    del res_s64
    # (d) the same run on four shards of the card from the domain ICs
    domain_subcycled_run(sub64.replace(devices=DOMAIN_SHARDS,
                                       ic_realization="domain"),
                         "cfg64_d4_sub4_icdomain")
    # (e) the 16^3 subcycled runs against the JAX package's P(k)
    for name, kw in (("sub4", {}),
                     ("supercell_sub4", dict(shortrange="supercell")),
                     ("domain4_supercell_sub4",
                      dict(shortrange="supercell", devices=DOMAIN_SHARDS))):
        c16 = SimulationConfig(n_side=16, subcycles=4,
                               output=OutputConfig(snapshot=False), **kw)
        work16s = os.path.join(OUT, f"n16_{name}")
        shutil.rmtree(work16s, ignore_errors=True)
        r16 = run_simulation(c16, 0, work16s,
                             initial_state=realize_ics(c16, 0, noise=noise))
        ref_name = f"powerspec_a=1.00_n16_{name}_seed0"
        tag16 = f"[22] 16^3 {name} from the JAX noise"
        if c16.devices > 1:
            bands = pk_bands(r16.powerspecs[0],
                             os.path.join(PORT_DATA, ref_name), c16, tag16)
            phase(f"{tag16}: P(k) vs JAX, max rel {bands_text(bands)}; run "
                  f"{r16.wall_s:.3f} s")
            check_bands(bands, tag16)
        else:
            pk_vs_reference(r16, c16, ref_name, tag16)

    # -- 23. adaptive time stepping, after the deterministic deposit ------
    # (0) the CIC deposit at the default run's and cfg64's PM shapes
    deposit_check("32^3 ICs", ics32.pos, ics32.mass, cfg.box, cfg.mesh_size)
    deposit_check("64^3 ICs", ics64.pos, ics64.mass, cfg64.box,
                  cfg64.mesh_size)
    # (a) the 16^3 runs against the JAX package's
    adaptive_16_runs(noise)
    # (b)-(d) the committed adaptive 64^3 config at full width
    adaptive_64_runs()

    # -- 24. the ensemble: K1's batched site, the NN-data pipeline -------
    k1b, k1b_launches = ensemble_phase(run_cfg)

    # -- 25. the batched tier on the plane tiers and PP, after the repair
    # of the column sums' dependence on the capacity -------------------
    k25, l25 = batched_planes_phase(
        cfg64, ics64, (res64r.state.pos, res64r.state.mass, act64,
                       res64r.config_run), run_cfg, card)

    # -- 26. the emulator: trained on the card, its simulation source ----
    emulator_phase(run_cfg)

    rows = [{
        "name": "p3m_short_acc", "route": "cuda",
        "source": "nbody_torch/forces/csrc/p3m_short.cu",
        "replaces": "nbody/forces/p3m.py:194", "launches": k1_launches,
        **k1[main_variant],
    }, {
        "name": "p3m_short_acc (Ewald real space)", "route": "cuda",
        "source": "nbody_torch/forces/csrc/p3m_short.cu",
        "replaces": "nbody/forces/ewald.py:123", "launches": k1_pp_launches,
        **k1_pp,
    }, {
        "name": "p3m_short_acc (batched members)", "route": "cuda",
        "source": "nbody_torch/forces/csrc/p3m_short.cu",
        "replaces": "nbody/forces/p3m.py:226", "launches": k1b_launches,
        **k1b,
    }]
    launch_counts["rungs"] = zero_launches(K5=k5_launches, K6=k6_launches)
    for key, name, source, replaces, path in (
            ("K2", "supercell_deposit_from_plane", "pm_supercell.cu",
             "nbody/forces/pm_supercell.py:117", "supercell"),
            ("K3", "run_fused_column_plane", "pm_supercell.cu",
             "nbody/forces/pm_supercell.py:353", "supercell"),
            ("K4", "run_column_plane", "p3m_columns.cu",
             "nbody/forces/p3m_columns.py:480", "columns"),
            ("K5", "run_column_plane_masked", "p3m_columns.cu",
             "nbody/forces/p3m_columns.py:849", "rungs"),
            ("K6", "run_cell_plane", "p3m_cells.cu",
             "nbody/forces/p3m.py:760", "rungs")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"nbody_torch/forces/csrc/{source}",
                     "replaces": replaces,
                     "launches": launch_counts[path][key], **kernels[key]})
    launch_counts["plummer"] = zero_launches(K7=k7_launches, K7b=k7_launches)
    for key, name, replaces in (
            ("K7", "allpairs_pallas", "nbody/forces/pallas_pp.py:76"),
            ("K7b", "block_acc_pallas", "nbody/forces/pallas_pp.py:151")):
        rows.append({"name": name, "route": "cuda",
                     "source": "nbody_torch/forces/csrc/pp_allpairs.cu",
                     "replaces": replaces,
                     "launches": launch_counts["plummer"][key],
                     **kernels[key]})
    rows.append({"name": "allpairs_pallas_mxu", "route": "cuda",
                 "source": "nbody_torch/forces/csrc/pp_gram.cu",
                 "replaces": "nbody/forces/pallas_mxu.py:176",
                 "launches": k8_launches, **kernels["K8"]})
    for key, name, source, replaces, path, site in (
            ("K2s", "supercell_deposit_local", "pm_supercell.cu",
             "nbody/forces/pm_supercell.py:609", "supercell", "K2"),
            ("K3s", "run_fused_column_plane (slab)", "pm_supercell.cu",
             "nbody/distributed/domain.py:862", "supercell", "K3"),
            ("K4s", "p3m_short_columns_local", "p3m_columns.cu",
             "nbody/forces/p3m_columns.py:1282", "columns", "K4"),
            ("K6s", "run_cell_plane (slab)", "p3m_cells.cu",
             "nbody/distributed/domain.py:904", "cells", "K6")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"nbody_torch/forces/csrc/{source}",
                     "replaces": replaces,
                     "launches": domain_counts[path][site], **kernels[key]})
    for key, name, source, replaces, launches in (
            ("K5s", "p3m_local_columns_frozen_masked", "p3m_columns.cu",
             "nbody/forces/p3m_columns.py:1656",
             DOMAIN_SHARDS * run64d["F"]),
            ("K6ms", "run_cell_plane (masked slab)", "p3m_cells.cu",
             "nbody/distributed/domain.py:941",
             DOMAIN_SHARDS * run32c["M"])):
        rows.append({"name": name, "route": "cuda",
                     "source": f"nbody_torch/forces/csrc/{source}",
                     "replaces": replaces, "launches": launches,
                     **kernels[key]})
    for key, name, source, launches in (
            ("K7r", "block_acc_pallas (ring)", "pp_allpairs.cu",
             k7r_launches),
            ("K6r", "run_cell_plane (replicated grid)", "p3m_cells.cu",
             k6r_launches)):
        rows.append({"name": name, "route": "cuda",
                     "source": f"nbody_torch/forces/csrc/{source}",
                     "replaces": "nbody/distributed/sharding.py:"
                                 + ("100" if key == "K7r" else "388"),
                     "launches": launches, **kernels[key]})
    rows.append({"name": "p3m_short_columns_frozen", "route": "cuda",
                 "source": "nbody_torch/forces/csrc/p3m_columns.cu",
                 "replaces": "nbody/forces/p3m_columns.py:774",
                 "launches": counts_s64["K4"], **kernels["K4f"]})
    # the batched sites ([25]): the JAX package's vmap of the ensemble
    # runner (nbody/driver/ensemble.py:164) over each pallas_call
    for key, name, source, replaces in (
            ("K2", "supercell_deposit_from_plane (batched members)",
             "pm_supercell.cu", "nbody/forces/pm_supercell.py:140"),
            ("K3", "run_fused_column_plane (batched members)",
             "pm_supercell.cu", "nbody/forces/pm_supercell.py:401"),
            ("K4", "run_column_plane (batched members)", "p3m_columns.cu",
             "nbody/forces/p3m_columns.py:510"),
            ("K6", "run_cell_plane (batched members)", "p3m_cells.cu",
             "nbody/forces/p3m.py:743"),
            ("K1", "p3m_short_acc (Ewald real space, batched members)",
             "p3m_short.cu", "nbody/forces/ewald.py:123")):
        rows.append({"name": name, "route": "cuda",
                     "source": f"nbody_torch/forces/csrc/{source}",
                     "replaces": replaces, "launches": l25[key],
                     **k25[key]})
    walls = {f"[{k}]": round(v, 1) for k, v in sorted(PHASE_S.items())}
    print(f"phase walls (s): {json.dumps(walls)}; total "
          f"{time.perf_counter() - START:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
