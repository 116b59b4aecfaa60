"""Where K7's time goes, on one GPU: the kernel against variants of itself.

    python scripts/torch_k7_ablation.py [--reps 5] [--rounds 3] [--out PATH]

Each variant is a copy of ``nbody_torch/forces/csrc/pp_allpairs.cu`` with
one change, built with nvcc (one process each, all started together) into
``output/k7_ablation/`` (git-ignored), loaded with ctypes and launched
through the port's own launch (``pallas_pp._run``).  Variants:

* ``redesign``: the source as it is (R = 4 targets a thread, the
  one-instruction rsqrt, S source slices from ``launch_geometry``, the
  source loop unrolled 2 deep);
* ``R = 2``, ``R = 1``: 2 or 1 targets a thread (S from the geometry);
* ``S = 1``: the source as it is, launched with one slice;
* ``rsqrtf``: rsqrtf in place of the one-instruction rsqrt (nvcc adds a
  three-instruction denormal guard);
* ``original``: R = 1, rsqrtf, one slice and the original loop
  (unrolled 8 deep, r^2 + eps^2 summed left to right) together: one
  thread a target, K7 as it was before its redesign for Hopper;
* ``unroll 1``, ``unroll 4``: the source loop not unrolled, or 4 deep;
* ``no rsqrt``: a multiply in place of rsqrt (wrong: time only);
* ``no tile sums``: every pair added straight into the running sums, not
  each tile's sums once per tile (what that rounding rule costs);
* ``S x2``, ``S /2``: twice or half the geometry's slices.

Shapes: the Plummer drive's launch (``plummer(262144, seed=0)`` against
itself, eps 0.05) and one launch of the ring on four shards (its first
65,536 particles against its last 65,536).  Every variant is timed in
each of ``--rounds`` rounds, in turn with the others (CUDA events around
``--reps`` launches after a warm-up), and the median is kept; the SM clock
and power are sampled with nvidia-smi while the rounds run.  Each
variant's error is the relative L2 of its acceleration against K7's float64
form on every 64th target.

From the build: registers a thread (``-Xptxas -v``) and resident blocks
per SM (``pp_allpairs_info``) of the float32 kernel, and from the built
object's SASS (``cuobjdump -sass``) the instructions of the hot loop (of
the innermost loops, the one that holds the most MUFU.RSQ) by kind, per
pair (written to ``output/k7_ablation/<variant>.loop.sass``): the
issue slots a pair, and the issue floor (pairs x slots / (32 lanes x 4
schedulers x SMs x clock)) at the sampled clock.  Prints one line per
variant and shape and writes all of it as JSON to ``--out`` (default
``output/k7_ablation.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from nbody_torch import _kernels  # noqa: E402
from nbody_torch.forces import pallas_pp as pp  # noqa: E402

BUILD = os.path.join(ROOT, "output", "k7_ablation")
R_LINE = "constexpr int kTargetsF32 = 4;"
RSQRT = 'asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));'
R2 = [(R_LINE, R_LINE.replace("4", "2"))]
R1 = [(R_LINE, R_LINE.replace("4", "1"))]
RSQRTF = [(RSQRT, "r = rsqrtf(x);")]
# the original inner loop: unrolled 8 deep, r^2 + eps^2 summed left to
# right (a multiply, two FMAs and an add)
ORIGINAL_LOOP = [("#pragma unroll 2", "#pragma unroll 8"),
            ("dx * dx + (dy * dy + (dz * dz + eps2));  // 3 FMAs",
             "dx * dx + dy * dy + dz * dz + eps2;")]
U1 = ("#pragma unroll 2", "#pragma unroll 1")
U4 = ("#pragma unroll 2", "#pragma unroll 4")
NOTILE = [("""    T tx[R], ty[R], tz[R], tp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) tx[r] = ty[r] = tz[r] = tp[r] = T(0);""",
           "    T *tx = ax, *ty = ay, *tz = az, *tp = pot;"),
          ("""      ax[r] += tx[r];
      ay[r] += ty[r];
      az[r] += tz[r];
      pot[r] += tp[r];""", "")]
# name: (source changes, slice count in place of the geometry's: an int,
# or a float that multiplies the geometry's)
VARIANTS = {
    "redesign": ([], None),
    "R = 2": (R2, None),
    "R = 1": (R1, None),
    "S = 1": ([], 1),
    "rsqrtf": (RSQRTF, None),
    "original": (R1 + RSQRTF + ORIGINAL_LOOP, 1),
    "unroll 1": ([U1], None),
    "unroll 4": ([U4], None),
    "no rsqrt": ([(RSQRT, "r = x * 1e-3f;")], None),
    "no tile sums": (NOTILE, None),
    "S x2": ([], 2.0),
    "S /2": ([], 0.5),
}
EPS = 0.05


def variant_source(changes) -> str:
    src = open(os.path.join(_kernels.SOURCE_DIR, "pp_allpairs.cu")).read()
    for old, new in changes:
        if src.count(old) != 1:
            raise RuntimeError(f"the patch does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.path.dirname(_kernels._nvcc()), name)


def build_all(names=VARIANTS) -> dict:
    """The distinct sources of the variants ``names``, built in parallel:
    {tag: (so, ptxas log)}."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        changes = VARIANTS[name][0]
        tag = source_tag(changes)
        if tag in procs:
            continue
        cu = os.path.join(BUILD, f"{tag}.cu")
        so = os.path.join(BUILD, f"{tag}.so")
        with open(cu, "w") as f:
            f.write(variant_source(changes))
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so, cu]
        procs[tag] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    built = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        built[tag] = (so, log)
    return built


def source_tag(changes) -> str:
    return "_".join(["k7"] + [re.sub(r"\W+", "", new)[-12:]
                              for old, new in changes])


def load(so: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(so)
    for name in ("pp_allpairs_f32", "pp_allpairs_f64", "pp_allpairs_info"):
        fn = getattr(lib, name)
        sig = _kernels._ENTRY_POINTS[name]
        fn.argtypes = [_kernels._CTYPES[c] for c in sig]
        fn.restype = ctypes.c_int
    return lib


def variant_geometry(lib, slices, pos_i, pos_j) -> pp.Geometry:
    """The launch shape of a variant: the geometry's, with ``slices`` (an
    int, or a float times the geometry's count) slices of whole tiles in
    place of its own where given."""
    geo = pp.card_geometry(pos_i, pos_j, 0.0, lib)
    if slices is None:
        return geo
    if isinstance(slices, float):
        slices = max(1, round(slices * geo.slices))
    tiles = -(-pos_j.shape[0] // geo.threads)
    per = -(-tiles // slices)
    return geo._replace(slices=-(-tiles // per),
                        slice_sources=per * geo.threads)


def registers(log: str) -> dict:
    """ptxas's registers and spills of each kernel, by mangled name."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            out[fn + ":spill"] = int(m.group(1))
    return out


def f32_kernel(names) -> str:
    """The mangled name of pp_kernel<float, R, false>."""
    hits = [n for n in names if "pp_kernelIfLi" in n and "Lb0E" in n
            and not n.endswith(":spill")]
    if len(hits) != 1:
        raise RuntimeError(f"no single float32 kernel among {list(names)}")
    return hits[0]


def sass_loop(so: str) -> dict:
    """The hot loop of pp_kernel<float, R, false> in the built object's
    SASS: its instructions by kind, the MUFU.RSQ in it (one a pair) and the
    issue slots a pair."""
    text = subprocess.run([tool("cuobjdump"), "-sass", so],
                          capture_output=True, text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = [f for f in funcs[1:] if "pp_kernelIfLi" in f.split("\n", 1)[0]
            and "Lb0E" in f.split("\n", 1)[0]]
    if len(body) != 1:
        raise RuntimeError("cuobjdump: no single float32 kernel")
    insts, labels, pending = [], {}, []
    for line in body[0].splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insts.append((addr, m.group(2).strip()))
    loops = []  # (first, last) address of each backward branch's body
    for addr, ins in insts:
        m = re.search(r"\bBRA\b\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", ins)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target < addr:
            loops.append((target, addr))
    best = None
    for lo, hi in loops:
        # innermost: no other loop inside this one
        if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in loops):
            continue
        loop = [i for a, i in insts if lo <= a <= hi]
        rsq = sum("MUFU.RSQ" in i for i in loop)
        if rsq and (best is None or rsq > best[0]):
            best = (rsq, loop)
    if best is None:  # a variant without rsqrt
        return dict(pairs_in_loop=0, instructions=0,
                    slots_per_pair=float("nan"), per_pair={}, loop=[])
    rsq, loop = best
    kinds = {}
    for ins in loop:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]
        kinds[op] = kinds.get(op, 0) + 1
    return dict(pairs_in_loop=rsq, instructions=len(loop),
                slots_per_pair=len(loop) / rsq,
                per_pair={k: v / rsq for k, v in sorted(kinds.items())},
                loop=loop)


class ClockSampler:
    """nvidia-smi sampling the SM clock and power every 100 ms."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        rows = []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            try:
                rows.append((float(parts[0]), float(parts[1])))
            except (ValueError, IndexError):
                continue
        self.mhz = [r[0] for r in rows]
        self.watts = [r[1] for r in rows]
        return False


def time_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "k7_ablation.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k7_ablation: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                           "clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}",
          flush=True)
    built = build_all()
    libs, meta = {}, {}
    for name, (changes, _) in VARIANTS.items():
        so, log = built[source_tag(changes)]
        libs[name] = load(so)
        regs = registers(log)
        fn = f32_kernel(regs)
        meta[name] = dict(registers=regs[fn], spill=regs.get(fn + ":spill", 0),
                          sass=sass_loop(so))
    from nbody_torch.ic import systems

    st = systems.plummer(1 << 18, seed=0)
    pos, mass = st.pos, st.mass
    nl = pos.shape[0] // 4
    shapes = {"plummer 262144^2": (pos, pos, mass),
              "ring 65536^2": (pos[:nl], pos[3 * nl:], mass[3 * nl:])}
    results = {"card": card, "variants": {}}
    for shape, (pi, pj, mj) in shapes.items():
        sub = torch.arange(0, pi.shape[0], 64, device=pi.device)
        ref = pp._launch(pi[sub].double(), pj.double(), mj.double(), EPS, 0.0)
        ref = ref[:, :3]
        times = {name: [] for name in VARIANTS}
        errs, geos = {}, {}
        with ClockSampler() as clocks:
            for _ in range(args.rounds):
                for name, (_, slices) in VARIANTS.items():
                    geo = geos.setdefault(name, variant_geometry(
                        libs[name], slices, pi, pj))

                    def launch(name=name, geo=geo):
                        return pp._run(libs[name], geo, pi, pj, mj, EPS, 0.0)

                    times[name].append(time_ms(launch, args.reps))
                    if name not in errs:
                        got = launch()[sub, :3].double()
                        errs[name] = float((got - ref).norm() / ref.norm())
        mhz = statistics.median(clocks.mhz) if clocks.mhz else float("nan")
        watts = (statistics.median(clocks.watts) if clocks.watts
                 else float("nan"))
        print(f"{shape}: SM clock median {mhz:.0f} MHz (min "
              f"{min(clocks.mhz, default=float('nan')):.0f}), power median "
              f"{watts:.1f} W over the rounds", flush=True)
        pairs = pi.shape[0] * pj.shape[0]
        base = statistics.median(times["original"])
        for name in VARIANTS:
            ms = statistics.median(times[name])
            geo, m = geos[name], meta[name]
            floor = (pairs * m["sass"]["slots_per_pair"]
                     / (32 * 4 * geo.sms * mhz * 1e6) * 1e3)
            row = dict(ms=ms, ms_rounds=times[name], rate=pairs / ms * 1e3,
                       vs_original=base / ms, rel_l2_f64=errs[name],
                       R=geo.targets_per_thread, S=geo.slices,
                       slice_sources=geo.slice_sources,
                       target_blocks=geo.target_blocks,
                       blocks_per_sm=geo.blocks_per_sm, sms=geo.sms,
                       registers=m["registers"], spill_bytes=m["spill"],
                       slots_per_pair=m["sass"]["slots_per_pair"],
                       issue_floor_ms=floor, sm_mhz=mhz, power_w=watts)
            results["variants"].setdefault(name, {})[shape] = row
            print(f"  {name}: {ms:.4f} ms a launch ({row['rate']:.4e} "
                  f"interactions/s, {row['vs_original']:.3f}x the "
                  f"original's), rounds "
                  f"{', '.join(f'{t:.4f}' for t in times[name])}; R "
                  f"{row['R']}, S {row['S']} ({geo.target_blocks} target "
                  f"blocks, {geo.slice_sources} sources a slice), "
                  f"{m['registers']} registers ({m['spill']} B spilled), "
                  f"{geo.blocks_per_sm} resident blocks/SM on {geo.sms} SMs; "
                  f"{row['slots_per_pair']:.2f} issue slots a pair, floor "
                  f"{floor:.4f} ms at {mhz:.0f} MHz; rel L2 vs float64 "
                  f"{errs[name]:.3e}", flush=True)
    for name, m in meta.items():
        s = m["sass"]
        with open(os.path.join(BUILD, f"{source_tag(VARIANTS[name][0])}"
                                      ".loop.sass"), "w") as f:
            f.write("\n".join(s.pop("loop")) + "\n")
        print(f"SASS hot loop, {name}: {s['instructions']} instructions for "
              f"{s['pairs_in_loop']} pairs; a pair: "
              + ", ".join(f"{k} {v:.2f}" for k, v in s["per_pair"].items()),
              flush=True)
        results["variants"][name]["sass"] = s
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
