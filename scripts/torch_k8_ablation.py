"""Where K8's time goes, on one GPU: the kernel against variants of itself.

    python scripts/torch_k8_ablation.py [--variants a,b] [--reps 5]
        [--rounds 3] [--refine-k K ...] [--no-busy] [--out PATH]

Each variant is a copy of ``nbody_torch/forces/csrc/pp_gram.cu`` with its
changes, built with nvcc (one process a variant, all started together)
into ``output/k8_ablation/`` (git-ignored) and loaded with ctypes beside
the port's own library.  Every copy also counts, warp tile by warp tile,
the tiles on which it ran the per-pair test and those it took from their
separations (some pair below lambda, or the warp's own targets).  The
kernel carries only the redesign; every other design lives here, and a
change that no longer applies stops the script.  Variants:

* ``redesign``: the source as it is (the box vote before each tile: a
  tile the boxes clear takes the Gram form with no per-pair test, the
  others the per-pair test beside their sums; 4 blocks an SM);
* ``original``: K8 before its redesign for Hopper
  (``scripts/torch_k8_original.cu``: the per-pair test on every tile,
  the tile's Gram sums kept apart until the warp's vote, the own tile's
  Gram sums computed and dropped);
* ``no vote``: the redesign with every tile on the per-pair test;
* ``direct sums``: a cleared tile's sums straight into the running sums
  (no tile sums: fewer registers, float32 sums of 2^18 terms);
* ``two passes``: a checked tile's per-pair test first, on the Gram r^2
  alone, then its sums as on a cleared tile;
* ``3 blocks/SM``, ``5 blocks/SM``: ``__launch_bounds__`` asking for 3 or
  5 resident blocks an SM (4 in the redesign);
* ``8 warps``: blocks of 8 warps, 256 targets, and tiles of 256 sources;
* ``4 row blocks``: 64 targets a warp (each B fragment and ``mx`` load
  serves twice the pairs), 256 a block;
* ``unroll 4``: the Gram loop of a tile's sums unrolled 4 deep, not 16.

Then the redesign at each threshold ``--refine-k`` (lambda_i =
max(eps^2, k |xic_i|^2)).  Inputs: the JAX package's bench conditions
(``scripts/exp_mxu.py``: N = 2^18 uniform in a 500 box, eps
0.03 * 500 / 64, default_rng(7)) and the Plummer drive's ICs
(``plummer(262144, seed=0)``, eps 0.05).  Times are CUDA events around
``--reps`` launches after a warm-up, the median of ``--rounds`` rounds
taken in turn over the variants; K7 (``allpairs_pallas``, the port's) is
timed in the same rounds on the same positions.  Errors are per-particle
relative force errors against K7's float64 form.  For each variant: its
registers, resident blocks an SM (``pp_gram_info``; achieved occupancy
is not measurable without a profiler of the card's counters), and the
SASS of its Gram blocks (the straight runs of code with 64 or more
MUFU.RSQ): instructions a pair by kind.  Last (unless ``--no-busy``), a
``torch.profiler`` window over 25 Plummer steps through K8 gives the
device's busy share.  Prints one line per variant and threshold, and
writes all of it as JSON to ``--out`` (default
``output/k8_ablation.json``).
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
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nbody_torch import _kernels  # noqa: E402
from nbody_torch.forces import pallas_mxu as mx  # noqa: E402

BUILD = os.path.join(ROOT, "output", "k8_ablation")
ORIGINAL = os.path.join(ROOT, "scripts", "torch_k8_original.cu")
COUNTER = """
__device__ unsigned long long k8_routes[2];
"""
EXPORT = """
extern "C" int k8_route_count(unsigned long long* host, int reset) {
  unsigned long long zero[2] = {0, 0};
  return reset ? cudaMemcpyToSymbol(k8_routes, zero, sizeof(zero))
               : cudaMemcpyFromSymbol(host, k8_routes, sizeof(zero));
}
"""
# the redesign's counters: a warp's checked and redone tiles in registers,
# added once at the end
COUNT_REDESIGN = [
    ("  unsigned unsafe = 0u;\n",
     "  unsigned unsafe = 0u;\n  unsigned n_checked = 0u, n_exact = 0u;\n"),
    ("    if (jt == own) {\n", "    if (jt == own) {\n      ++n_exact;\n"),
    ("      float rmin[kRowBlocks][2];\n",
     "      ++n_checked;\n      float rmin[kRowBlocks][2];\n"),
    ("      if (__any_sync(0xffffffffu, low)) {\n",
     "      if (__any_sync(0xffffffffu, low)) {\n        ++n_exact;\n"),
    ("  // the quad's four column sets, then the epilogue\n",
     "  if (lane == 0) {\n    atomicAdd(&k8_routes[0], (unsigned long long)"
     "n_checked);\n    atomicAdd(&k8_routes[1], (unsigned long long)"
     "n_exact);\n  }\n  // the quad's four column sets, then the epilogue\n"),
]
# the original's: every tile checked, the redone ones counted as they come
COUNT_ORIGINAL = [
    ("      // rare: the tile's Gram sums are dropped, and every pair of it is\n",
     "      if (lane == 0) atomicAdd(&k8_routes[1], 1ull);\n"
     "      // rare: the tile's Gram sums are dropped, and every pair of it is\n"),
    ("    bool low = false;\n",
     "    if (lane == 0) atomicAdd(&k8_routes[0], 1ull);\n"
     "    bool low = false;\n"),
]
# the checked tiles in two passes: the per-pair test on the Gram r^2
# alone, then the sums as on a cleared tile (no tile sums held beside
# the least r^2)
DIRECT = ("""  float part[kRowBlocks][2][5] = {};
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    float r2[kRowBlocks][4];
    gram(tile.frag[q][lane], a1, a2, r2);
    gram_sums(r2, tile.mx[8 * q + 2 * t], tile.mx[8 * q + 2 * t + 1], part);
  }
#pragma unroll
  for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 5; ++k) tot[rb][h][k] += part[rb][h][k];
""", """#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    float r2[kRowBlocks][4];
    gram(tile.frag[q][lane], a1, a2, r2);
    gram_sums(r2, tile.mx[8 * q + 2 * t], tile.mx[8 * q + 2 * t + 1], tot);
  }
""")
TWO_PASSES = ("""      float part[kRowBlocks][2][5] = {};
      float rmin[kRowBlocks][2];
#pragma unroll
      for (int rb = 0; rb < kRowBlocks; ++rb)
        rmin[rb][0] = rmin[rb][1] = __int_as_float(0x7f800000);
#pragma unroll
      for (int q = 0; q < kGroups; ++q) {
        float r2[kRowBlocks][4];
        gram(tile.frag[q][lane], a1, a2, r2);
#pragma unroll
        for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rmin[rb][e >> 1] = fminf(rmin[rb][e >> 1], r2[rb][e]);
        gram_sums(r2, tile.mx[8 * q + 2 * t], tile.mx[8 * q + 2 * t + 1],
                  part);
      }
""", """      float rmin[kRowBlocks][2];
#pragma unroll
      for (int rb = 0; rb < kRowBlocks; ++rb)
        rmin[rb][0] = rmin[rb][1] = __int_as_float(0x7f800000);
#pragma unroll 4
      for (int q = 0; q < kGroups; ++q) {
        float r2[kRowBlocks][4];
        gram(tile.frag[q][lane], a1, a2, r2);
#pragma unroll
        for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            rmin[rb][e >> 1] = fminf(rmin[rb][e >> 1], r2[rb][e]);
      }
""")
TWO_PASSES_ADD = ("""      } else {
#pragma unroll
        for (int rb = 0; rb < kRowBlocks; ++rb)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int k = 0; k < 5; ++k) tot[rb][h][k] += part[rb][h][k];
      }
    }
""", """      } else {
        gram_tile(tile, lane, t, a1, a2, tot);
      }
    }
""")
BLOCKS = "constexpr int kMinBlocks = 4;"
VARIANTS = {
    "redesign": [],
    "original": None,
    "no vote": [("      unsafe = unsafe_vote(boxes, jt, ntiles, lane, cx, cy, "
                 "cz, wb, eps2);\n", "      unsafe = 0xffffffffu;\n")],
    "direct sums": [DIRECT],
    "two passes": [TWO_PASSES, TWO_PASSES_ADD],
    "3 blocks/SM": [(BLOCKS, "constexpr int kMinBlocks = 3;")],
    "5 blocks/SM": [(BLOCKS, "constexpr int kMinBlocks = 5;")],
    "8 warps": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                ("constexpr int kTile = 128; ", "constexpr int kTile = 256; "),
                (BLOCKS, "constexpr int kMinBlocks = 2;")],
    "4 row blocks": [("constexpr int kRowBlocks = 2; ",
                      "constexpr int kRowBlocks = 4; "),
                     (BLOCKS, "constexpr int kMinBlocks = 3;")],
    "unroll 4": [("#pragma unroll\n  for (int q = 0; q < kGroups; ++q) {\n"
                  "    float r2[kRowBlocks][4];\n"
                  "    gram(tile.frag[q][lane], a1, a2, r2);\n",
                  "#pragma unroll 4\n  for (int q = 0; q < kGroups; ++q) {\n"
                  "    float r2[kRowBlocks][4];\n"
                  "    gram(tile.frag[q][lane], a1, a2, r2);\n")],
}


def variant_source(name: str) -> str:
    changes = VARIANTS[name]
    if changes is None:
        src, count = open(ORIGINAL).read(), COUNT_ORIGINAL
    else:
        src = open(os.path.join(_kernels.SOURCE_DIR, "pp_gram.cu")).read()
        count = COUNT_REDESIGN
    for old, new in (changes or []) + count + [
            ("namespace {\n", COUNTER + "namespace {\n"),
            ("}  // namespace\n", "}  // namespace\n" + EXPORT)]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the change does not apply: {old!r}")
        src = src.replace(old, new)
    return src


def tag(name: str) -> str:
    return re.sub(r"\W+", "_", name).strip("_")


def build_all(names) -> dict:
    """{name: (library, ptxas log, so)}, the builds started together."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        cu = os.path.join(BUILD, f"{tag(name)}.cu")
        so = os.path.join(BUILD, f"{tag(name)}.so")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so,
               cu]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    out = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        sig = "ppiiddpp" if name == "original" else "ppiiddppp"
        lib.pp_gram_f32.argtypes = [_kernels._CTYPES[c] for c in sig]
        lib.pp_gram_f32.restype = ctypes.c_int
        lib.k8_route_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        out[name] = (lib, log, so)
    return out


def registers(log: str) -> dict:
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "gram_kernel" in fn:
            out["gram_kernel"] = int(m.group(1))
    return out


def resident(lib) -> int | None:
    """The gram kernel's resident blocks an SM (``pp_gram_info``)."""
    if not hasattr(lib, "pp_gram_info"):
        return None
    info = (ctypes.c_int * 4)()
    lib.pp_gram_info.argtypes = [ctypes.c_void_p]
    if lib.pp_gram_info(info) != 0:
        return None
    return info[3]


def sass_blocks(so: str) -> list:
    """The straight runs of the gram kernel's SASS (no label or branch
    inside) that hold 64 or more MUFU.RSQ: for each, its pairs (one
    MUFU.RSQ each), its instructions and the instructions a pair by kind."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = [f for f in funcs[1:] if "gram_kernel" in f.split("\n", 1)[0]]
    if len(body) != 1:
        raise RuntimeError("cuobjdump: no single gram kernel")
    blocks, cur = [], []
    for line in body[0].splitlines():
        if re.match(r"\s*\.L_x_\d+:", line):
            blocks.append(cur)
            cur = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if not m:
            continue
        ins = m.group(1).strip()
        cur.append(ins)
        if re.search(r"\b(BRA|EXIT|RET|BSYNC|WARPSYNC)\b", ins):
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    out = []
    for blk in blocks:
        rsq = sum("MUFU.RSQ" in i for i in blk)
        if rsq < 64:
            continue
        kinds = {}
        for ins in blk:
            op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0].split(".")[0]
            kinds[op] = kinds.get(op, 0) + 1
        out.append(dict(pairs=rsq, instructions=len(blk),
                        slots_per_pair=len(blk) / rsq,
                        per_pair={k: v / rsq for k, v in sorted(kinds.items())}))
    return out


def inputs(which: str):
    """(pos, mass, eps) on the card."""
    if which == "bench":
        n, box = 1 << 18, 500.0
        rng = np.random.default_rng(7)
        pos = torch.tensor(rng.uniform(0, box, (n, 3)), dtype=torch.float32,
                           device="cuda")
        return pos, torch.ones(n, device="cuda"), 0.03 * box / 64
    from nbody_torch.ic import systems

    st = systems.plummer(1 << 18, seed=0)
    return st.pos, st.mass, 0.05


def launcher(name: str, lib, prep: dict, eps: float,
             refine_k: float = mx.REFINE_K):
    """A function that launches variant ``name`` once on ``prep``'s
    sorted particles (``_sorted_tiles``, ti 256), and its output."""
    pos4, ctr = prep["pos4"], prep["ctr"]
    out = torch.empty_like(pos4)
    boxes = pos4.new_empty(pos4.shape[0] // 16)
    stream = torch.cuda.current_stream().cuda_stream
    if name == "original":
        args = (pos4.data_ptr(), ctr.data_ptr(), pos4.shape[0], 256,
                eps * eps, refine_k, out.data_ptr(), stream)
    else:
        args = (pos4.data_ptr(), ctr.data_ptr(), pos4.shape[0], 256,
                eps * eps, refine_k, boxes.data_ptr(), out.data_ptr(),
                stream)

    def launch():
        err = lib.pp_gram_f32(*args)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed: {err}")

    return launch, out


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


def routes(name: str, lib, prep: dict, eps: float, refine_k: float) -> dict:
    """The warp tiles the variant checked pair by pair and took from their
    separations, each as a share of all warp tiles, from one launch."""
    launch, out = launcher(name, lib, prep, eps, refine_k)
    counts = (ctypes.c_ulonglong * 2)()
    lib.k8_route_count(None, 1)
    launch()
    torch.cuda.synchronize()
    lib.k8_route_count(counts, 0)
    npad = prep["pos4"].shape[0]
    warp_tiles = (npad // 32) * (npad // 128)
    if name in ("8 warps", "4 row blocks"):
        warp_tiles = (npad // (64 if name == "4 row blocks" else 32)) * (
            npad // (256 if name == "8 warps" else 128))
    acc = torch.empty_like(out[:, :3])
    acc[prep["perm"]] = out[:, :3]
    return dict(checked=counts[0] / warp_tiles, redone=counts[1] / warp_tiles,
                acc=acc)


def busy_share(steps: int = 25) -> dict:
    """Device time over wall time of ``steps`` Plummer steps through K8."""
    from torch.profiler import ProfilerActivity, profile

    from nbody_torch.ic import systems
    from nbody_torch.integrate.leapfrog import run_with_diagnostics

    def acc_fn(p, m):
        return mx.allpairs_pallas_mxu(p, m, eps=0.05)

    state = systems.plummer(1 << 18, seed=0)
    run_with_diagnostics(state, 1e-3, 25, acc_fn, diag_every=25)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_with_diagnostics(state, 1e-3, steps, acc_fn, diag_every=25)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ms
    device_ms = sum(by_name.values())
    return dict(steps=steps, wall_ms=wall * 1e3, device_ms=device_ms,
                busy=device_ms / (wall * 1e3),
                top=sorted(by_name.items(), key=lambda kv: -kv[1])[:8])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--refine-k", type=float, nargs="*",
                    default=[5e-3, 2.5e-3, 1e-3])
    ap.add_argument("--no-busy", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "k8_ablation.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k8_ablation: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    names = args.variants.split(",")
    for name in names:
        if name not in VARIANTS:
            raise SystemExit(f"unknown variant {name!r}")
    from nbody_torch.forces.pallas_pp import allpairs_pallas

    libs = build_all(names)
    results = {"card": card, "variants": {}, "refine_k": {}, "k7": {}}
    for name in names:
        lib, log, so = libs[name]
        results["variants"][name] = dict(
            registers=registers(log), blocks_per_sm=resident(lib),
            sass=sass_blocks(so))
        blk = results["variants"][name]["sass"]
        print(f"{name}: registers {registers(log)}, resident blocks an SM "
              f"{resident(lib)}; Gram blocks: " + "; ".join(
                  f"{b['pairs']} pairs, {b['slots_per_pair']:.3f} "
                  f"instructions a pair ({', '.join(f'{k} {v:.3f}' for k, v in b['per_pair'].items())})"
                  for b in blk), flush=True)
    for which in ("bench", "plummer"):
        pos, mass, eps = inputs(which)
        ref = allpairs_pallas(pos.double(), mass.double(), eps)[0]
        perm, pos_s, mass_s, ctr = mx._sorted_tiles(pos, mass, 256, 1024,
                                                    True, 6)
        prep = dict(perm=perm, ctr=ctr,
                    pos4=torch.cat([pos_s, mass_s[:, None]], dim=1))
        times = {name: [] for name in names}
        k7 = []
        for _ in range(args.rounds):
            k7.append(time_ms(lambda: allpairs_pallas(pos, mass, eps),
                              args.reps))
            for name in names:
                launch, _ = launcher(name, libs[name][0], prep, eps)
                times[name].append(time_ms(launch, args.reps))
        results["k7"][which] = dict(ms=statistics.median(k7), rounds=k7)
        print(f"{which}: K7 (allpairs_pallas) {statistics.median(k7):.4f} ms "
              f"(rounds {', '.join(f'{t:.4f}' for t in k7)})", flush=True)

        def err_row(acc):
            err = (acc.double() - ref).norm(dim=1) / ref.norm(dim=1)
            return dict(err_median=float(err.median()),
                        err_max=float(err.max()),
                        above_1e_2=int((err > 1e-2).sum()))

        for name in names:
            r = routes(name, libs[name][0], prep, eps, mx.REFINE_K)
            row = dict(ms=statistics.median(times[name]),
                       rounds=times[name], checked=r["checked"],
                       redone=r["redone"], **err_row(r["acc"]))
            results["variants"][name][which] = row
            base = statistics.median(times.get("redesign", times[name]))
            print(f"  {name}: {row['ms']:.4f} ms ({row['ms'] / base:.3f}x "
                  f"the redesign's; rounds "
                  f"{', '.join(f'{t:.4f}' for t in row['rounds'])}), "
                  f"checked {row['checked']:.3e} and redone "
                  f"{row['redone']:.3e} of the warp tiles, error median "
                  f"{row['err_median']:.2e} max {row['err_max']:.2e} "
                  f"({row['above_1e_2']} above 1e-2)", flush=True)
        if "redesign" in names:
            for k in args.refine_k:
                launch, _ = launcher("redesign", libs["redesign"][0], prep,
                                     eps, k)
                ms = time_ms(launch, args.reps)
                r = routes("redesign", libs["redesign"][0], prep, eps, k)
                row = dict(ms=ms, checked=r["checked"], redone=r["redone"],
                           **err_row(r["acc"]))
                results["refine_k"].setdefault(str(k), {})[which] = row
                print(f"  refine_k {k:g}: {ms:.4f} ms, checked "
                      f"{row['checked']:.3e}, redone {row['redone']:.3e}, "
                      f"error median {row['err_median']:.2e} max "
                      f"{row['err_max']:.2e}", flush=True)
        del ref
    if not args.no_busy:
        results["busy"] = b = busy_share()
        print(f"Plummer drive through K8, {b['steps']} steps: wall "
              f"{b['wall_ms']:.1f} ms, device {b['device_ms']:.1f} ms, busy "
              f"{b['busy']:.3f}; top {b['top'][:4]}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
