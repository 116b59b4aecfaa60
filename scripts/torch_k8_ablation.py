"""Where K8's time goes, on one GPU: the kernel against variants of itself.

    python scripts/torch_k8_ablation.py [--reps 5] [--refine-k K ...] [--out PATH]

Each variant is a copy of ``nbody_torch/forces/csrc/pp_gram.cu`` with one
change, built with nvcc into ``output/k8_ablation/`` (git-ignored) and
loaded with ctypes beside the port's own library.  Every copy also counts
the warp tiles whose pairs it takes from their separations (some pair
below lambda, or the warp's own targets).  Variants:

* ``kernel``: the source as it is;
* ``rsqrtf``: rsqrtf in place of the one-instruction rsqrt (its denormal
  guard adds three instructions a pair);
* ``4 blocks/SM``: ``__launch_bounds__(128, 4)`` (128 registers);
* ``unroll 4``: the branch-free group loop unrolled 4 deep, not 16;
* ``no redo``: only the warp's own tile from its separations, so the Gram
  form keeps every pair below lambda (its errors show what the threshold
  buys);
* ``no rsqrt``: a multiply in place of rsqrt (wrong: time only);
* ``no mma``: FP32 stand-ins in place of the two TF32 products (wrong:
  time only).

Then the kernel itself at each threshold ``--refine-k`` (lambda_i =
max(eps^2, k |xic_i|^2)).  Inputs: the JAX package's bench conditions
(``scripts/exp_mxu.py``: N = 2^18 uniform in a 500 box, eps
0.03 * 500 / 64, default_rng(7)) and the Plummer drive's ICs
(``plummer(262144, seed=0)``, eps 0.05).  Times are CUDA events around
``--reps`` launches after a warm-up; errors are per-particle relative
force errors against K7's float64 form.  Last, a ``torch.profiler``
window over 25 Plummer steps through K8 gives the device's busy share.
Prints one line per variant and threshold, and writes all of it as JSON
to ``--out`` (default ``output/k8_ablation.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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
COUNTER = """
__device__ unsigned long long k8_redone;
extern "C" int k8_redone_count(unsigned long long* host, int reset) {
  unsigned long long zero = 0;
  return reset ? cudaMemcpyToSymbol(k8_redone, &zero, sizeof(zero))
               : cudaMemcpyFromSymbol(host, k8_redone, sizeof(zero));
}
"""
REDO = "      // rare: the tile's Gram sums are dropped, and every pair of it is\n"
VARIANTS = {
    "kernel": [],
    "rsqrtf": [('asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
                "r = rsqrtf(x);")],
    "4 blocks/SM": [("__launch_bounds__(kThreads, 3)",
                     "__launch_bounds__(kThreads, 4)")],
    "unroll 4": [("#pragma unroll\n    for (int q = 0; q < kGroups; ++q) {\n"
                  "      float r2[kRowBlocks][4];\n      gram(",
                  "#pragma unroll 4\n    for (int q = 0; q < kGroups; ++q) {\n"
                  "      float r2[kRowBlocks][4];\n      gram(")],
    "no redo": [("if (__any_sync(0xffffffffu, low) || (j0 <= wt0",
                 "if ((j0 <= wt0")],
    "no rsqrt": [("const float inv = rsqrt_ftz(r2[rb][e]);",
                  "const float inv = r2[rb][e] * 1e-3f;")],
    "no mma": [("    mma_tf32(d, a2[rb], bf.z, bf.w);\n"
                "    mma_tf32(d, a1[rb], bf.x, bf.y);\n",
                "    for (int e = 0; e < 4; ++e)\n"
                "      d[e] = 1e6f + fabsf(__uint_as_float(bf.x ^ a1[rb][e]));\n")],
}


def variant_source(changes) -> str:
    src = open(os.path.join(_kernels.SOURCE_DIR, "pp_gram.cu")).read()
    for old, new in changes + [("}  // namespace\n", "}  // namespace\n" + COUNTER),
                               ("namespace {\n", "__device__ unsigned long long "
                                "k8_redone;\nnamespace {\n"),
                               (REDO, "      if (lane == 0) atomicAdd(&k8_redone, "
                                "1ull);\n" + REDO)]:
        if src.count(old) != 1:
            raise RuntimeError(f"the patch does not apply: {old!r}")
        src = src.replace(old, new)
    # the counter is declared once, before the namespace
    return src.replace(COUNTER, COUNTER.replace(
        "__device__ unsigned long long k8_redone;\n", ""))


def build(name: str, changes) -> tuple[ctypes.CDLL, str]:
    tag = name.replace(" ", "_").replace("/", "")
    cu = os.path.join(BUILD, f"{tag}.cu")
    so = os.path.join(BUILD, f"{tag}.so")
    with open(cu, "w") as f:
        f.write(variant_source(changes))
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so, cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    regs = [line.split(":", 1)[1].strip() for line in proc.stderr.splitlines()
            if "registers" in line][-1:]
    lib = ctypes.CDLL(so)
    lib.pp_gram_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_double, ctypes.c_double,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.pp_gram_f32.restype = ctypes.c_int
    lib.k8_redone_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib, regs[0] if regs else ""


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


def run(lib, pos, mass, eps, reps: int, refine_k: float = mx.REFINE_K) -> dict:
    perm, pos_s, mass_s, ctr = mx._sorted_tiles(pos, mass, 256, 1024, True, 6)
    pos4 = torch.cat([pos_s, mass_s[:, None]], dim=1)
    out = torch.empty_like(pos4)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.pp_gram_f32(pos4.data_ptr(), ctr.data_ptr(), pos4.shape[0],
                              256, eps * eps, refine_k, out.data_ptr(),
                              stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")

    count = ctypes.c_ulonglong(0)
    lib.k8_redone_count(None, 1)
    launch()
    torch.cuda.synchronize()
    lib.k8_redone_count(ctypes.byref(count), 0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    npad = pos4.shape[0]
    acc = torch.empty_like(out[:, :3])
    acc[perm] = out[:, :3]
    return dict(ms=start.elapsed_time(end) / reps,
                redone=count.value / ((npad // 32) * (npad // 128)), acc=acc)


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--refine-k", type=float, nargs="*",
                    default=[5e-3, 2.5e-3, 1.5e-3, 1e-3])
    ap.add_argument("--out", default=os.path.join(ROOT, "output",
                                                  "k8_ablation.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k8_ablation: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    os.makedirs(BUILD, exist_ok=True)
    from nbody_torch.forces.pallas_pp import allpairs_pallas

    data = {k: inputs(k) for k in ("bench", "plummer")}
    refs = {which: allpairs_pallas(p.double(), m.double(), e)[0]
            for which, (p, m, e) in data.items()}

    def measure(lib, refine_k: float) -> dict:
        row = {}
        for which, (p, m, e) in data.items():
            r = run(lib, p, m, e, args.reps, refine_k=refine_k)
            err = ((r["acc"].double() - refs[which]).norm(dim=1)
                   / refs[which].norm(dim=1))
            row[which] = dict(ms=r["ms"], redone=r["redone"],
                              err_median=float(err.median()),
                              err_max=float(err.max()),
                              above_1e_2=int((err > 1e-2).sum()))
        return row

    def line(row: dict) -> str:
        return "; ".join(
            f"{w} {v['ms']:.3f} ms, redone {v['redone']:.2e}, error median "
            f"{v['err_median']:.2e} max {v['err_max']:.2e} "
            f"({v['above_1e_2']} above 1e-2)" for w, v in row.items())

    results = {"card": card, "variants": {}, "refine_k": {}}
    for name, changes in VARIANTS.items():
        lib, regs = build(name, changes)
        row = measure(lib, mx.REFINE_K)
        results["variants"][name] = dict(registers=regs, **row)
        print(f"{name}: {line(row)}; {regs}", flush=True)
    lib, _ = build("kernel", [])
    for k in args.refine_k:
        results["refine_k"][k] = row = measure(lib, k)
        print(f"refine_k {k:g}: {line(row)}", flush=True)
    del refs
    results["busy"] = busy_share()
    b = results["busy"]
    print(f"Plummer drive through K8, {b['steps']} steps: wall "
          f"{b['wall_ms']:.1f} ms, device {b['device_ms']:.1f} ms, busy "
          f"{b['busy']:.3f}; top {b['top'][:4]}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
