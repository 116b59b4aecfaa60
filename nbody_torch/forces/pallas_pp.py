"""All-pairs softened gravity: K7, the PP solver's and the Newtonian
systems' force.

Counterpart of :mod:`nbody.forces.pallas_pp`.  The pair sum is K7, a CUDA
kernel (``forces/csrc/pp_allpairs.cu``) for targets against sources,
float32 or float64, with optional minimum images.  :func:`block_acc_pallas`
launches it and returns its raw sums; :func:`allpairs_pallas` is the same
launch with the targets as the sources, plus G and the self-term.  A CUDA
tensor launches the kernel or raises; a CPU tensor takes the plain version
(:func:`pp_block_plain`).  Where the target blocks alone make fewer than
:data:`WAVES` waves on the card, the launch cuts the sources into slices
(:func:`launch_geometry`) whose partial sums are added in a fixed order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nbody_torch.forces.allpairs import _pair_terms

#: targets per chunk of the plain version: at most this many pairs are
#: materialized at once
_PLAIN_PAIRS = 1 << 24


def pp_block_plain(pos_i, pos_j, mass_j, eps: float, box: float = 0.0):
    """Plain PyTorch version of K7: (acc_raw (Ni, 3), pot_raw (Ni,)), the
    same sums, chunked over targets."""
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    acc = pos_i.new_empty((ni, 3))
    pot = pos_i.new_empty((ni,))
    step = max(1, _PLAIN_PAIRS // max(nj, 1))
    for i0 in range(0, ni, step):
        acc[i0:i0 + step], pot[i0:i0 + step] = _pair_terms(
            pos_i[i0:i0 + step], pos_j, mass_j, float(eps) ** 2, box=box)
    return acc, pot


class Geometry(NamedTuple):
    """One K7 launch: ``target_blocks`` x ``slices`` blocks of ``threads``
    threads, each thread ``targets_per_thread`` targets; slice s holds the
    sources [s slice_sources, min(nj, (s + 1) slice_sources)).  ``sms``
    and ``blocks_per_sm`` are the card's, as the kernel library reports
    them."""

    threads: int
    targets_per_thread: int
    target_blocks: int
    slices: int
    slice_sources: int
    sms: int
    blocks_per_sm: int


#: the waves of blocks a launch is cut into, where its target blocks are
#: fewer and its sources allow: smaller blocks leave an SM idle for less
#: time behind the last block of a wave (scripts/torch_k7_ablation.py's
#: ``S x2`` and ``S /2``; PERF.md §5)
WAVES = 8


def launch_geometry(ni: int, nj: int, sms: int, blocks_per_sm: int,
                    targets_per_thread: int = 4,
                    threads: int = 128) -> Geometry:
    """K7's launch shape for ``ni`` targets against ``nj`` sources on a
    card of ``sms`` SMs holding ``blocks_per_sm`` blocks each.

    A block takes ``threads * targets_per_thread`` targets; a source tile
    is ``threads`` sources.  Where the target blocks make fewer than
    :data:`WAVES` waves of the card's resident slots, the sources are cut
    into slices of whole tiles, as many as make that many waves or one a
    tile, whichever is fewer, and then evened out over the tiles.  No
    slice is empty unless there are no sources; no targets take one
    slice."""
    target_blocks = -(-ni // (threads * targets_per_thread))
    tiles = max(1, -(-nj // threads))
    want = (-(-WAVES * sms * blocks_per_sm // target_blocks)
            if target_blocks else 1)
    per = -(-tiles // min(want, tiles))
    return Geometry(threads, targets_per_thread, target_blocks,
                    -(-tiles // per), per * threads, sms, blocks_per_sm)


@functools.lru_cache(maxsize=None)
def _card_shape(lib, device: int, f64: bool, periodic: bool) -> tuple:
    """(threads, targets a thread, resident blocks per SM, SMs) of the
    kernel in ``lib`` on card ``device``."""
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = lib.pp_allpairs_info(int(f64), int(periodic), info)
    if err != 0 or info[2] < 1:
        raise RuntimeError(f"pp_allpairs_info failed (error {err}, "
                           f"{list(info)})")
    return tuple(info)


def card_geometry(pos_i, pos_j, box: float = 0.0, lib=None) -> Geometry:
    """The launch shape K7 takes for targets ``pos_i`` against sources
    ``pos_j`` (CUDA tensors) on their card."""
    if lib is None:
        from nbody_torch._kernels import load_library

        lib = load_library()
    threads, per_thread, blocks, sms = _card_shape(
        lib, pos_i.device.index, pos_i.dtype == torch.float64, box > 0)
    return launch_geometry(pos_i.shape[0], pos_j.shape[0], sms, blocks,
                           per_thread, threads)


def _check(name: str, pos, n: int, what: str) -> None:
    if pos.ndim != 2 or pos.shape != (n, 3) or not pos.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous (N, 3), got "
                         f"{tuple(pos.shape)}")


def _launch(pos_i, pos_j, mass_j, eps: float, box: float):
    """One K7 launch on the card: its (Ni, 4) output [ax, ay, az, pot]."""
    name = "block_acc_pallas"
    if pos_i.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {pos_i.device}")
    dtype = pos_i.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the CUDA kernel takes float32 or float64, "
                        f"got {dtype}")
    if pos_j.dtype != dtype or mass_j.dtype != dtype:
        raise TypeError(f"{name}: mixed dtypes {dtype}/{pos_j.dtype}/"
                        f"{mass_j.dtype}")
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    _check(name, pos_i, ni, "targets")
    _check(name, pos_j, nj, "sources")
    if mass_j.shape != (nj,) or not mass_j.is_contiguous():
        raise ValueError(f"{name}: masses {tuple(mass_j.shape)}, expected "
                         f"contiguous ({nj},)")
    if pos_j.device != pos_i.device or mass_j.device != pos_i.device:
        raise ValueError(f"{name}: tensors on different devices")
    if box < 0:
        raise ValueError(f"{name}: box must be >= 0, got {box}")
    from nbody_torch._kernels import load_library

    lib = load_library()
    return _run(lib, card_geometry(pos_i, pos_j, box, lib), pos_i, pos_j,
                mass_j, eps, box)


def _run(lib, geo: Geometry, pos_i, pos_j, mass_j, eps: float, box: float):
    """K7 from the kernel library ``lib`` in the launch shape ``geo``, on
    tensors :func:`_launch` has checked: the (Ni, 4) output."""
    ni, nj, dtype = pos_i.shape[0], pos_j.shape[0], pos_i.dtype
    fn = lib.pp_allpairs_f32 if dtype == torch.float32 else lib.pp_allpairs_f64
    out = torch.empty((ni, 4), device=pos_i.device, dtype=dtype)
    part = (torch.empty((geo.slices, ni, 4), device=pos_i.device, dtype=dtype)
            if geo.slices > 1 else None)
    with torch.cuda.device(pos_i.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(pos_i.data_ptr(), ni, pos_j.data_ptr(), mass_j.data_ptr(),
                 nj, float(eps) ** 2, float(box), geo.slice_sources,
                 geo.slices, None if part is None else part.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"block_acc_pallas: CUDA launch failed (error "
                           f"{err})")
    return out


def block_acc_pallas(pos_i, pos_j, mass_j, eps: float, *, box: float = 0.0):
    """Raw cross-block accumulation: targets i against sources (j, m_j).

    Returns (acc_raw (Ni,3), pot_raw (Ni,)) WITHOUT the G factor and
    WITHOUT self-term removal: acc_raw = sum_j m_j d / (r^2+eps^2)^1.5,
    pot_raw = sum_j m_j / sqrt(r^2+eps^2); ``box > 0`` takes minimum
    images.  A CUDA tensor launches K7 (float32 or float64, contiguous) or
    raises; a CPU tensor takes :func:`pp_block_plain`.
    ``block_acc_pallas.launches`` counts kernel launches, those made for
    :func:`allpairs_pallas` included."""
    if pos_i.device.type == "cpu":
        return pp_block_plain(pos_i, pos_j, mass_j, eps, box)
    out = _launch(pos_i, pos_j, mass_j, eps, box)
    block_acc_pallas.launches += 1
    return out[:, :3], out[:, 3]


block_acc_pallas.launches = 0


def allpairs_pallas(pos, mass, eps: float, G: float = 1.0, *,
                    box: float = 0.0):
    """All-pairs softened gravity: one K7 launch (:func:`block_acc_pallas`
    with the particles as both targets and sources).

    Args:
      pos: (N, 3) positions.
      mass: (N,) masses.
      eps: Plummer softening, must be > 0.
      G: gravitational constant.
      box: if > 0, apply periodic minimum-image separations (nearest image
        only, no Ewald sum: :func:`nbody_torch.forces.ewald.ewald_pp_acc`
        is the exact periodic force).

    Returns:
      acc: (N, 3) accelerations.
      phi: (N,) potential per unit mass (self-term removed), so
        E_pot = 0.5 * sum(mass * phi).

    ``allpairs_pallas.launches`` counts the launches its calls made.
    """
    if eps <= 0:
        raise ValueError("allpairs_pallas requires eps > 0 (self-pair handling)")
    acc, pot = block_acc_pallas(pos, pos, mass, eps, box=box)
    if pos.device.type != "cpu":
        allpairs_pallas.launches += 1
    eps2 = float(eps) ** 2
    return acc * G, -G * (pot - mass * (eps2**-0.5))


allpairs_pallas.launches = 0


def interactions_per_call(n: int) -> int:
    """Pairwise interactions one allpairs_pallas call evaluates: every
    ordered pair, self pairs included (the kernel pads nothing)."""
    return n * n
