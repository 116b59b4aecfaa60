"""The forms the PM transforms could take on the card, each timed for one
grid and for a batch of grids, with whether a grid's bits depend on the
batch it is transformed in.

    python scripts/torch_fft_forms.py [--sizes 32,64,128]
        [--batches 1,2,4,8] [--reps 50]

The forms (``x`` real (..., n, n, n), ``k`` its rfft layout):

- ``rfftn``: ``torch.fft.rfftn`` / ``irfftn`` over the last three
  dimensions, one grid with no batch axis (the route of the port's
  transforms before the batched tier);
- ``rfft3``: the same with a batch axis always (one grid a batch of one:
  ``x.reshape(-1, n, n, n)``), the fused 3-D plan of a batch;
- ``split``: ``torch.fft.rfft`` along the last dimension, then
  ``torch.fft.fftn`` over the other two (the inverse ``ifftn`` over the
  first two, then ``irfft``), a 1-D and a 2-D plan, each batched over
  the rows it does not transform.

For every form and size: whether grid b of a batch of B (each of
``--batches``) equals grid b alone, bit for bit, forward and inverse; the
largest error against the float64 transform over the largest
|coefficient| (forward) or |value| (inverse); and the time of one call
(CUDA events around ``--reps`` back-to-back calls, after a warm-up) for
one grid and for the largest batch.  Prints one line a form and size,
then the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

D3 = (-3, -2, -1)


def _fold(x):
    return x.reshape((-1,) + tuple(x.shape[-3:]))


FORMS = {
    "rfftn": (lambda x: torch.fft.rfftn(x, dim=D3),
              lambda k, n: torch.fft.irfftn(k, s=(n,) * 3, dim=D3)),
    "rfft3": (lambda x: torch.fft.rfftn(_fold(x), dim=D3).reshape(
        x.shape[:-1] + (x.shape[-1] // 2 + 1,)),
        lambda k, n: torch.fft.irfftn(_fold(k), s=(n,) * 3,
                                      dim=D3).reshape(k.shape[:-3]
                                                      + (n,) * 3)),
    "split": (lambda x: torch.fft.fftn(torch.fft.rfft(x, dim=-1),
                                       dim=(-3, -2)),
              lambda k, n: torch.fft.irfft(torch.fft.ifftn(k, dim=(-3, -2)),
                                           n=n, dim=-1)),
}


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
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
    ap.add_argument("--sizes", default="32,64,128")
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_fft_forms: needs a CUDA card")
    batches = [int(b) for b in args.batches.split(",")]
    top = max(batches)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (int(s) for s in args.sizes.split(",")):
        xs = torch.randn((top, n, n, n), device="cuda", generator=gen)
        ref_k = torch.fft.rfftn(xs.double(), dim=D3)
        ks = ref_k.to(torch.complex64)
        ref_r = torch.fft.irfftn(ks.to(torch.complex128), s=(n,) * 3, dim=D3)
        for name, (fwd, inv) in FORMS.items():
            alone_k = [fwd(xs[b]) for b in range(top)]
            alone_r = [inv(ks[b], n) for b in range(top)]
            same_k = same_r = True
            for B in batches:
                kb, rb = fwd(xs[:B]), inv(ks[:B], n)
                same_k &= all(torch.equal(kb[b], alone_k[b])
                              for b in range(B))
                same_r &= all(torch.equal(rb[b], alone_r[b])
                              for b in range(B))
            err_k = float((torch.stack(alone_k).to(torch.complex128)
                           - ref_k).abs().max() / ref_k.abs().max())
            err_r = float((torch.stack(alone_r).double() - ref_r).abs().max()
                          / ref_r.abs().max())
            x1, k1 = xs[0].clone(), ks[0].clone()
            t = dict(fwd1=time_ms(lambda: fwd(x1), args.reps),
                     inv1=time_ms(lambda: inv(k1, n), args.reps),
                     fwdB=time_ms(lambda: fwd(xs), args.reps),
                     invB=time_ms(lambda: inv(ks, n), args.reps))
            print(f"{n}^3 {name}: a grid alone equals it in batches of "
                  f"{args.batches}: forward {same_k}, inverse {same_r}; "
                  f"max error {err_k:.3e} / {err_r:.3e}; one grid forward "
                  f"{t['fwd1']:.4f} ms, inverse {t['inv1']:.4f} ms; {top} "
                  f"grids forward {t['fwdB']:.4f} ms, inverse "
                  f"{t['invB']:.4f} ms", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")


if __name__ == "__main__":
    main()
