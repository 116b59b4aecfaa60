"""All-pairs softened gravity in the Gram form: K8.

Counterpart of :mod:`nbody.forces.pallas_mxu`.  With per-tile centres c,

    r^2_ij + eps^2 = |xjc|^2 + (|xic|^2 + eps^2) - 2 xjc . xic

is one K=8 contraction of a target row [1, 1, 1, xic, |xic|^2 + eps^2, 0]
against a source column [xjc^2, -2 xjc, 1, 0], and the force is the
contraction of [m xjc, m] against w = (r^2 + eps^2)^(-3/2):
acc_i = sum_j m_j w_ij xjc - xic_i sum_j m_j w_ij.  Particles are
Morton-sorted so that each ``ti`` tile of targets is spatially compact and
centred on its own centroid, which bounds the Gram form's cancellation.

One addition to the JAX package's algebra: a pair whose Gram r^2 falls
below lambda_i = max(eps^2, REFINE_K |xic_i|^2) is taken from its
separation x_j - x_i instead, and its force m_j w_ij (x_j - x_i) is summed
apart from the Gram sums (the kernel does so for the whole 32 x 128 tile
of pairs such a pair lies in).  In float32 the Gram r^2 errs by a few ulp
of (|xic| + |xjc|)^2, and the epilogue subtracts xic sum m w from sum m w xjc,
so a pair much closer together than to its tile centre can carry a
relative error of several percent: without the threshold, K8 puts a
particle's force 1.5e-2 off at N = 2^18 uniform in a 500 box on an H100
(scripts/torch_k8_ablation.py, "no redo").  Every pair
left to the Gram form has r^2 + eps^2 >= REFINE_K |xic|^2, which bounds
its relative r^2 error at ~1.1e-3 and its share of the cancellation at
~21 times its own force.  The threshold also subsumes the JAX kernel's clamp
at eps^2: no Gram r^2 below eps^2 reaches rsqrt.

A CUDA tensor launches K8 (``forces/csrc/pp_gram.cu``: r^2 on the tensor
cores in the 3xTF32 split, the weights and the force sums in registers;
a vote on the boxes of each warp's targets and each source tile,
:func:`k8_unsafe_tiles`, spares the per-pair threshold test on the warp
tiles it clears) or raises; a CPU tensor takes the plain version,
:func:`gram_allpairs_plain`.  The Morton codes, the sort, the padding,
the centroids and the scatter back are torch ops around the one launch.
Periodic minimum images are not supported (the wrap depends on the pair,
which has no bilinear form); :mod:`nbody_torch.forces.pallas_pp` (K7)
takes a box.
"""

from __future__ import annotations

import torch

#: targets x sources of the plain version materialized at once, at most
_PLAIN_PAIRS = 1 << 24
#: lambda_i = max(eps^2, REFINE_K |xic_i|^2): pairs with a Gram r^2 below
#: it are taken from their separation.  8 x 6 x 2^-24 / REFINE_K bounds
#: the relative r^2 error of every pair left to the Gram form at ~1.1e-3
#: (float32).  A larger REFINE_K takes more pairs from their separations,
#: more slowly; scripts/torch_k8_ablation.py sweeps it on the card
REFINE_K = 2.5e-3
#: targets a block of the CUDA kernel owns: ``ti`` and ``tj`` must be
#: multiples of it on the card
_CUDA_BLOCK = 128


def _morton_spread(x):
    """Spread the low 10 bits of x so consecutive bits are 3 apart."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def morton_codes(pos, bits: int = 6):
    """Morton (Z-order) codes, int32, of positions on a 2^bits^3 grid
    spanning their bounding box.  Sorting by these makes contiguous index
    ranges spatially compact."""
    lo = pos.min(dim=0).values
    hi = pos.max(dim=0).values
    n_side = 1 << bits
    q = ((pos - lo) / torch.clamp(hi - lo, min=1e-30) * n_side).to(
        torch.int32).clamp(0, n_side - 1)
    return (_morton_spread(q[:, 0])
            | (_morton_spread(q[:, 1]) << 1)
            | (_morton_spread(q[:, 2]) << 2))


def _sorted_tiles(pos, mass, ti: int, tj: int, sort: bool, bits: int):
    """Sort, pad and centre: (perm or None, pos_s (npad, 3), mass_s
    (npad,), ctr (npad // ti, 3)).  Padding is parked on the last real
    particle with mass 0; centroids are over real particles only."""
    n = pos.shape[0]
    perm = None
    if sort:
        perm = torch.argsort(morton_codes(pos, bits=bits), stable=True)
        pos, mass = pos[perm], mass[perm]
    block = max(ti, tj)
    npad = -(-n // block) * block
    if npad > n:
        pos = torch.cat([pos, pos[-1:].expand(npad - n, 3)])
        mass = torch.cat([mass, mass.new_zeros(npad - n)])
    valid = (torch.arange(npad, device=pos.device) < n).to(pos.dtype)
    vt = valid.view(-1, ti)
    cnt = torch.clamp(vt.sum(dim=1), min=1.0)
    ctr = (pos.view(-1, ti, 3) * vt[:, :, None]).sum(dim=1) / cnt[:, None]
    return perm, pos.contiguous(), mass.contiguous(), ctr.contiguous()


def _unsort(perm, acc_s, phi_s):
    if perm is None:
        return acc_s, phi_s
    acc = torch.empty_like(acc_s)
    phi = torch.empty_like(phi_s)
    acc[perm] = acc_s
    phi[perm] = phi_s
    return acc, phi


def _gram_operands(xic, xjc, eps2: float):
    """The K=8 Gram operands: (a (Ni, 8), b (Nj, 8)) with a @ b.T =
    r^2 + eps^2 for targets xic against sources xjc (both centred)."""
    one_i = xic.new_ones((xic.shape[0], 1))
    one_j = xjc.new_ones((xjc.shape[0], 1))
    a = torch.cat([one_i.expand(-1, 3), xic,
                   (xic * xic).sum(dim=1, keepdim=True) + eps2,
                   torch.zeros_like(one_i)], dim=1)
    b = torch.cat([xjc * xjc, -2.0 * xjc, one_j, torch.zeros_like(one_j)],
                  dim=1)
    return a, b


def gram_allpairs_plain(pos, mass, eps: float, G: float = 1.0, *,
                        ti: int = 256, tj: int = 1024, sort: bool = True,
                        bits: int = 6):
    """Plain PyTorch version of K8: the Gram algebra of
    :func:`allpairs_pallas_mxu` in the input's dtype, chunked over the
    targets of each ``ti`` tile so that at most ``_PLAIN_PAIRS`` pairs are
    materialized at once.  Returns (acc (N, 3), phi (N,))."""
    n = pos.shape[0]
    perm, pos_s, mass_s, ctr = _sorted_tiles(pos, mass, ti, tj, sort, bits)
    npad = pos_s.shape[0]
    eps2 = float(eps) ** 2
    xic = pos_s - ctr.repeat_interleave(ti, dim=0)
    lam = torch.clamp(REFINE_K * (xic * xic).sum(dim=1), min=eps2)
    out = pos_s.new_empty((npad, 4))
    rows = max(1, min(ti, _PLAIN_PAIRS // npad))
    for t in range(npad // ti):
        xjc = pos_s - ctr[t]
        src = torch.cat([mass_s[:, None] * xjc, mass_s[:, None]], dim=1)
        for r0 in range(t * ti, (t + 1) * ti, rows):
            r1 = min(r0 + rows, (t + 1) * ti)
            xi = xic[r0:r1]
            a, b = _gram_operands(xi, xjc, eps2)
            r2 = a @ b.T
            # pairs below lambda_i: r^2 and the force from the separation
            ri, cj = torch.nonzero(r2 < lam[r0:r1, None], as_tuple=True)
            d = pos_s[cj] - pos_s[r0 + ri]
            r2_d = (d * d).sum(dim=1) + eps2
            r2[ri, cj] = r2_d
            inv = torch.rsqrt(r2)
            w = inv * inv * inv
            w[ri, cj] = 0.0
            w_d = mass_s[cj] * torch.rsqrt(r2_d) ** 3
            # the self pair (equal sorted indices) contributes nothing
            w_d[cj == r0 + ri] = 0.0
            own = torch.arange(r1 - r0, device=pos.device)
            w[own, own + r0] = 0.0
            inv[own, own + r0] = 0.0
            sums = w @ src
            near = torch.zeros_like(xi).index_add_(0, ri, w_d[:, None] * d)
            out[r0:r1, :3] = sums[:, :3] - xi * sums[:, 3:] + near
            out[r0:r1, 3] = inv @ mass_s
    return _unsort(perm, G * out[:n, :3], -G * out[:n, 3])


#: the CUDA kernel's warp tile: targets a warp and sources a shared tile
K8_WARP_TARGETS = 32
K8_TILE = 128
#: the kernel's bound on the float32 error of a Gram r^2, as a share of
#: (|xic| + |xjc|)^2 + eps^2 (``csrc/pp_gram.cu`` kGramSlack)
K8_GRAM_SLACK = 2.0**-14


def k8_unsafe_tiles(pos_s, ctr, ti: int, eps: float,
                    refine_k: float = REFINE_K):
    """K8's vote, warp tile by warp tile, in float32 as the kernel takes
    it (``unsafe_vote``): (npad // K8_WARP_TARGETS, npad // K8_TILE) bool,
    False where the boxes rule out a pair of the tile whose Gram r^2
    falls below its target's lambda_i, so the warp adds the tile's Gram
    sums with no per-pair test; True where they cannot: the least r^2 +
    eps^2 that the boxes of the tile's sources and of the warp's targets
    (both centred on the targets' centroid) allow, less K8_GRAM_SLACK
    ((Rt + Rs)^2 + eps^2), falls below the warp's largest lambda_i (Rt
    and Rs bound |xic| and |xjc|).  The kernel runs the per-pair test on
    those tiles, and takes the tile of a warp's own targets (``own``: the
    tile of index warp * K8_WARP_TARGETS // K8_TILE) from its separations
    in any case.  ``pos_s`` (npad, 3) and ``ctr`` as
    :func:`_sorted_tiles` gives them."""
    f32 = torch.float32
    pos = pos_s.to(f32)
    c = ctr.to(f32).repeat_interleave(ti, dim=0)
    xic = pos - c
    q = xic[:, 2] * xic[:, 2] + (xic[:, 1] * xic[:, 1]
                                 + xic[:, 0] * xic[:, 0])
    wq = q.view(-1, K8_WARP_TARGETS).amax(1)
    eps2 = torch.tensor(float(eps) ** 2, dtype=f32)
    lam = torch.clamp(torch.tensor(refine_k, dtype=f32) * wq, min=eps2)
    rt = torch.sqrt(wq)
    tlo = xic.view(-1, K8_WARP_TARGETS, 3).amin(1)
    thi = xic.view(-1, K8_WARP_TARGETS, 3).amax(1)
    lo = pos.view(-1, K8_TILE, 3).amin(1)
    hi = pos.view(-1, K8_TILE, 3).amax(1)
    # each warp's centroid against each tile's box
    wc = c[::K8_WARP_TARGETS][:, None, :]
    slo, shi = lo[None] - wc, hi[None] - wc
    gap = torch.clamp(torch.maximum(slo - thi[:, None], tlo[:, None] - shi),
                      min=0.0)
    gap2 = (gap * gap).sum(-1)
    far = torch.maximum(slo.abs(), shi.abs())
    span = rt[:, None] + torch.sqrt((far * far).sum(-1))
    slack = K8_GRAM_SLACK * (span * span + eps2)
    return gap2 * (1.0 - 2.0**-20) + (eps2 - slack) < lam[:, None]


def _launch(pos4, ctr, ti: int, eps: float):
    """One K8 call (counted in ``allpairs_pallas_mxu.launches``; the
    library's two launches: the source tiles' boxes, then the sums) on the
    sorted, padded particles pos4 (npad, 4) [x, y, z, m] with their
    centroids ctr (npad // ti, 3): its (npad, 4) output [ax, ay, az, pot]
    without G."""
    from nbody_torch._kernels import load_library

    lib = load_library()
    out = torch.empty_like(pos4)
    boxes = pos4.new_empty(pos4.shape[0] // 16)
    with torch.cuda.device(pos4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pp_gram_f32(
            pos4.data_ptr(), ctr.data_ptr(), pos4.shape[0], ti,
            float(eps) ** 2, REFINE_K, boxes.data_ptr(), out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"allpairs_pallas_mxu: CUDA launch failed "
                           f"(error {err})")
    allpairs_pallas_mxu.launches += 1
    return out


def allpairs_pallas_mxu(pos, mass, eps: float, G: float = 1.0, *,
                        ti: int = 256, tj: int = 1024, sort: bool = True,
                        bits: int = 6):
    """All-pairs softened gravity in the Gram form: one K8 launch.

    Args:
      pos: (N, 3) positions (open boundary: no periodic images).
      mass: (N,) masses.
      eps: Plummer softening, must be > 0.
      G: gravitational constant.
      ti, tj: the centring tile (targets sharing one centroid) and the
        padding block (N is padded to a multiple of max(ti, tj)); on the
        card both must be multiples of 128.
      sort: Morton-sort the particles first so that each ti tile is
        spatially compact (bounds the Gram form's cancellation).
      bits: Morton grid depth (2^bits cells per axis).

    Returns:
      acc: (N, 3) accelerations.
      phi: (N,) potential per unit mass (self-term removed), so
        E_pot = 0.5 * sum(mass * phi).

    A CUDA tensor launches K8 (float32, contiguous) or raises; a CPU
    tensor takes :func:`gram_allpairs_plain`.
    ``allpairs_pallas_mxu.launches`` counts kernel launches.
    """
    if eps <= 0:
        raise ValueError("allpairs_pallas_mxu requires eps > 0")
    if pos.device.type == "cpu":
        return gram_allpairs_plain(pos, mass, eps, G, ti=ti, tj=tj,
                                   sort=sort, bits=bits)
    name = "allpairs_pallas_mxu"
    if pos.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {pos.device}")
    if pos.dtype != torch.float32 or mass.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{pos.dtype}/{mass.dtype}")
    n = pos.shape[0]
    if pos.ndim != 2 or pos.shape != (n, 3) or not pos.is_contiguous():
        raise ValueError(f"{name}: positions must be contiguous (N, 3), got "
                         f"{tuple(pos.shape)}")
    if mass.shape != (n,) or not mass.is_contiguous():
        raise ValueError(f"{name}: masses {tuple(mass.shape)}, expected "
                         f"contiguous ({n},)")
    if mass.device != pos.device:
        raise ValueError(f"{name}: tensors on different devices")
    if n == 0 or ti % _CUDA_BLOCK or tj % _CUDA_BLOCK:
        raise ValueError(f"{name}: N > 0 and ti, tj multiples of "
                         f"{_CUDA_BLOCK} on the card, got N={n}, ti={ti}, "
                         f"tj={tj}")
    perm, pos_s, mass_s, ctr = _sorted_tiles(pos, mass, ti, tj, sort, bits)
    out = _launch(torch.cat([pos_s, mass_s[:, None]], dim=1), ctr, ti, eps)
    return _unsort(perm, G * out[:n, :3], -G * out[:n, 3])


allpairs_pallas_mxu.launches = 0
