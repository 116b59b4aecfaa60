"""Emulator datasets: creation, snapshot ETL, augmentation, the batch stream.

Counterpart of :mod:`nbody.emulator.data`, which rebuilds the reference's
``createData`` / ``createTestData`` (linear-theory delta(x) volumes over an
A_s band, resume by skip, optional noise), ``process_folder_by_id``
(snapshot -> CIC -> delta -> deconvolved ``.npy``), the label plumbing
and the flip / rot90 augmentation.  File names and layout are the
reference's (``Training & val data/delta_train_id-{i}.npy``,
``Test data/delta_test_id-{i}.npy``, the sidecar text files), so either
code base reads the other's datasets.

The volumes are realized on ``device`` (the card unless the caller asks
for the CPU), a batch of them at once (:func:`~nbody_torch.ic.gaussian.
gaussian_field`), each from its own generator seeded from
(``master_seed``, i): the JAX package splits one key, so the two packages
draw different fields from one seed, and a test feeds the JAX noise
(``noise=``).  The snapshot ETL is a function of a particle state,
:func:`state_to_delta`, which :func:`snapshots_to_delta` applies to each
HDF5 file and the pipeline's in-memory route to each member's final
state (the card's machine has no h5py).
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from nbody_torch.core.cosmology import Cosmology
from nbody_torch.driver.ensemble import TEST_DRAW_SEED, TRAIN_DRAW_SEED
from nbody_torch.ic.gaussian import GRFSpec, gaussian_field, member_generator
from nbody_torch.io.sidecars import (
    BoxParams,
    MaxMinParams,
    write_box_params,
    write_maxmin_params,
    write_param_table,
)

TRAIN_DIR = "Training & val data"
TEST_DIR = "Test data"


def delta_path(root: str, i: int, test: bool = False) -> str:
    """The layout's path of volume i (counted from 1) of a split."""
    sub = TEST_DIR if test else TRAIN_DIR
    stem = "delta_test_id-" if test else "delta_train_id-"
    return os.path.join(root, sub, f"{stem}{i}.npy")


# --------------------------------------------------------------------------
# Linear-theory dataset creation (a batch of volumes at once)
# --------------------------------------------------------------------------


def _realize_batch(spec: GRFSpec, power, amplitudes, generators, *,
                   noise=None, noise_frac: float = 0.0, device="cuda"):
    """(B, N, N, N) delta volumes: volume b at P(k) x amplitudes[b] from
    its generator (or noise[b]); noise_frac > 0 adds the reference's
    training noise N(0, noise_frac * max(delta)) per volume, drawn next
    from the volume's generator."""
    vols = gaussian_field(spec, power, amplitudes, generators, noise=noise,
                          device=device)
    if noise_frac > 0.0:
        sigma = noise_frac * vols.amax(dim=(1, 2, 3))
        extra = torch.stack([
            torch.randn((spec.nmesh,) * 3, generator=g, device=g.device,
                        dtype=torch.float64).to(device)
            for g in generators]).to(vols.dtype)
        vols = vols + sigma[:, None, None, None] * extra
    return vols


def create_linear_dataset(
    savepath: str,
    n_samples: int,
    z: float,
    box: float,
    nmesh: int,
    cosmo: Cosmology | None = None,
    A_s_min: float = 2.1e-9,
    A_s_max: float = 2.1e-9,
    n_s_min: float | None = None,
    n_s_max: float | None = None,
    omega_cdm_min: float | None = None,
    omega_cdm_max: float | None = None,
    val_size: float = 0.2,
    test: bool = False,
    noise_frac: float = 0.0,
    master_seed: int = 0,
    batch: int = 16,
    overwrite: bool = False,
    *,
    noise=None,
    device="cuda",
) -> np.ndarray:
    """Generate delta(x) volumes and sidecars in the reference's layout.

    Train/val parameter draws use the pinned seed 420, test draws 39 (the
    reference's); volume i's field comes from its own generator,
    seeded from (``master_seed``, i), so the parameter draws and the
    realizations are reproducible apart, and a resume draws the same
    field.  A volume already on disk is skipped unless ``overwrite``.
    With only A_s varying, ``batch`` volumes are realized at once (A_s
    a multiplier on one power spectrum, the growth folding in z); n_s or
    omega_cdm change the spectrum's shape, one volume at a time.
    ``noise`` (n_samples, N, N, N) replaces the generators' unit white
    noise.  Returns the (n_samples, 3) label array.
    """
    cosmo = cosmo or Cosmology()
    a = 1.0 / (1.0 + z)
    rng = np.random.default_rng(TEST_DRAW_SEED if test else TRAIN_DRAW_SEED)

    def draw(lo, hi, default):
        lo = default if lo is None else lo
        hi = default if hi is None else hi
        return (rng.uniform(lo, hi, n_samples) if hi != lo
                else np.full(n_samples, lo))

    A_s = draw(A_s_min, A_s_max, cosmo.A_s)
    n_s = draw(n_s_min, n_s_max, cosmo.n_s)
    omega_cdm = draw(omega_cdm_min, omega_cdm_max, cosmo.omega_cdm)
    labels = np.column_stack([A_s, n_s, omega_cdm])
    vary_shape = (n_s_max is not None and n_s_max != n_s_min) or (
        omega_cdm_max is not None and omega_cdm_max != omega_cdm_min)

    os.makedirs(os.path.join(savepath, TEST_DIR if test else TRAIN_DIR),
                exist_ok=True)
    spec = GRFSpec(nmesh=nmesh, box=box)
    paths = [delta_path(savepath, i + 1, test) for i in range(n_samples)]
    todo = [i for i in range(n_samples)
            if overwrite or not os.path.exists(paths[i])]

    def realize(c: Cosmology, idx: list, amps):
        vols = _realize_batch(
            spec, lambda k: c.linear_power(k, a=1.0), amps,
            [member_generator(master_seed, i) for i in idx],
            noise=None if noise is None else np.asarray(noise)[idx],
            noise_frac=noise_frac, device=device)
        for v, i in zip(vols.cpu().numpy().astype(np.float32), idx):
            np.save(paths[i], v)

    if not vary_shape:
        # constant-but-overridden shape parameters still enter the cosmology
        cosmo = dataclasses.replace(cosmo, n_s=float(n_s[0]),
                                    omega_cdm=float(omega_cdm[0]))
        amps = A_s / cosmo.A_s * float(cosmo.growth_D(a)) ** 2
        for lo in range(0, len(todo), batch):
            idx = todo[lo:lo + batch]
            realize(cosmo, idx, amps[idx])
    else:
        for i in todo:
            ci = dataclasses.replace(cosmo, A_s=float(A_s[i]),
                                     n_s=float(n_s[i]),
                                     omega_cdm=float(omega_cdm[i]))
            realize(ci, [i], [float(ci.growth_D(a)) ** 2])

    write_box_params(os.path.join(savepath, "BoxParams.txt"),
                     BoxParams(z, box, nmesh))
    write_maxmin_params(
        os.path.join(savepath, "MaxMinParams.txt"),
        MaxMinParams(float(A_s.min()), float(A_s.max()),
                     float(n_s.min()), float(n_s.max()),
                     float(omega_cdm.min()), float(omega_cdm.max()),
                     n_samples))
    if test:
        write_param_table(os.path.join(savepath, "TestParams.txt"), labels)
    else:
        n_train = int(n_samples * (1.0 - val_size))
        write_param_table(os.path.join(savepath, "TrainingParams.txt"),
                          labels[:n_train])
        write_param_table(os.path.join(savepath, "ValParams.txt"),
                          labels[n_train:])
    return labels


# --------------------------------------------------------------------------
# Particle state -> delta ETL
# --------------------------------------------------------------------------


def state_to_delta(pos, box: float, nmesh: int, deconvolve: bool = True):
    """The overdensity of particle positions (n, 3), or of B members'
    (B, n, 3), on an nmesh^3 grid: the CIC deposit of the counts, delta =
    rho / rho_mean - 1, and with ``deconvolve`` the CIC window divided
    out once (p = 1, as the reference's ETL does)."""
    from nbody_torch.mesh.cic import cic_deposit, deconvolve as deconvolve_k
    from nbody_torch.mesh.grids import irfft3, rfft3

    grid = cic_deposit(pos, box, nmesh)
    delta = grid / (pos.shape[-2] / nmesh**3) - 1.0
    if deconvolve:
        delta = irfft3(deconvolve_k(rfft3(delta), nmesh, box, p=1), nmesh)
    return delta


def save_delta(root: str, i: int, delta, test: bool = False) -> str:
    """Save a delta grid as volume i (from 1) of a split: an (N, N, N, 1)
    float32 ``.npy`` (the channel dim the reference's ETL adds)."""
    path = delta_path(root, i, test)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, delta.detach().cpu().numpy().astype(np.float32)[..., None])
    return path


def snapshots_to_delta(
    ensemble_root: str,
    out_dir: str,
    nmesh: int,
    a: float = 1.0,
    deconvolve: bool = True,
    test: bool = False,
    overwrite: bool = False,
    *,
    device="cuda",
) -> list:
    """Walk an ensemble's id-dirs and convert each final snapshot
    (``snapshot_a={a:.2f}.hdf5``) to a delta volume
    (:func:`state_to_delta` on ``device``, :func:`save_delta`), as the
    reference's ``process_folder_by_id``.  Needs h5py."""
    from nbody_torch.io.snapshot import read_snapshot

    os.makedirs(os.path.join(out_dir, TEST_DIR if test else TRAIN_DIR),
                exist_ok=True)
    id_dirs = sorted(
        d for d in os.listdir(ensemble_root)
        if d.startswith("id") and os.path.isdir(os.path.join(ensemble_root, d)))
    written = []
    for j, d in enumerate(id_dirs):
        out = delta_path(out_dir, j + 1, test)
        written.append(out)
        if not overwrite and os.path.exists(out):
            continue
        state, meta = read_snapshot(
            os.path.join(ensemble_root, d, "snapshots",
                         f"snapshot_a={a:.2f}.hdf5"), device=device)
        save_delta(out_dir, j + 1,
                   state_to_delta(state.pos, meta.boxsize, nmesh,
                                  deconvolve=deconvolve), test)
    return written


# --------------------------------------------------------------------------
# Augmentation on the batch's device
# --------------------------------------------------------------------------

# the 12 (plane, k) rot90 cases over axes (0,1), (1,2), (0,2) of the volume
_PLANES = ((0, 1), (1, 2), (0, 2))


def _augment_one(v, flips, case: int):
    """One volume (N, N, N, ...) flipped on each axis whose flag is set,
    then rotated by rot90 case ``case`` (0-11): the JAX package's
    per-sample transform."""
    for ax in range(3):
        if flips[ax]:
            v = torch.flip(v, (ax,))
    return torch.rot90(v, case % 4, _PLANES[case // 4])


@functools.lru_cache(maxsize=4)
def _augment_table(n: int, device: torch.device):
    """(96, n^3): for each of the 12 x 8 (case, flips) transforms, the
    flat source index of every output voxel (the transform applied to
    the voxel indices)."""
    idx = torch.arange(n**3).reshape(n, n, n)
    return torch.stack([
        _augment_one(idx, ((c >> 2) & 1, (c >> 1) & 1, c & 1), c // 8)
        .reshape(-1) for c in range(96)]).to(device)


def augment_cases(X, flips, cases):
    """Each volume of X (B, N, N, N) or (B, N, N, N, C) through its
    transform (flips (B, 3) bool, cases (B,) in 0-11): one gather on X's
    device."""
    B, n = X.shape[0], X.shape[1]
    c = X.shape[4] if X.ndim == 5 else 1
    combo = (cases * 8 + flips[:, 0] * 4 + flips[:, 1] * 2
             + flips[:, 2]).to(torch.int64)
    idx = _augment_table(n, X.device)[combo]
    out = torch.gather(X.reshape(B, n**3, c), 1,
                       idx[..., None].expand(B, n**3, c))
    return out.reshape(X.shape)


def augment_batch(X, generator: torch.Generator):
    """Random flips on the three axes (each at 50%) and one of the 12
    rot90 cases per sample, drawn from ``generator`` on X's device, the
    role of the reference's host-numpy ``random_flip_3d`` /
    ``random_rotate90_3d``."""
    B = X.shape[0]
    flips = torch.rand((B, 3), generator=generator, device=X.device) < 0.5
    cases = torch.randint(0, 12, (B,), generator=generator, device=X.device)
    return augment_cases(X, flips, cases)


# --------------------------------------------------------------------------
# Labels and the batch stream
# --------------------------------------------------------------------------


def vary_flags_from_maxmin(mm) -> tuple:
    """Which of (A_s, n_s, omega_cdm) vary, the reference's
    ``get_variable_params``."""
    return (mm.A_s_min != mm.A_s_max, mm.n_s_min != mm.n_s_max,
            mm.omega_cdm_min != mm.omega_cdm_max)


@dataclasses.dataclass
class DeltaDataset:
    """A split of delta volumes and max-normalised labels, held in host
    memory (a 200-sample 32^3 float32 set is 26 MB); ``fit`` uploads it
    to the card once.  ``from_directory`` reads the reference's layout.
    """

    X: np.ndarray  # (M, N, N, N) float32
    y: np.ndarray  # (M, P) labels normalised by per-param maxima
    maxima: np.ndarray  # (P,) the normalisers (subset of maxima with vary flag)
    vary_flags: tuple = (True, False, False)

    def __len__(self) -> int:
        return len(self.X)

    @property
    def dim(self) -> int:
        return self.X.shape[1]

    @classmethod
    def from_directory(cls, path: str, split: str = "train") -> "DeltaDataset":
        """Load a split ('train' | 'val' | 'test') from the reference
        layout (delta_*_id-{i}.npy, *Params.txt, MaxMinParams.txt)
        through the native loader."""
        from nbody_torch.io.sidecars import read_maxmin_params, read_param_table
        from nbody_torch.native import read_volumes

        mm = read_maxmin_params(os.path.join(path, "MaxMinParams.txt"))
        flags = vary_flags_from_maxmin(mm)
        if not any(flags):
            flags = (True, False, False)
        table = {"train": "TrainingParams.txt", "val": "ValParams.txt",
                 "test": "TestParams.txt"}[split]
        labels3 = read_param_table(os.path.join(path, table))
        # val ids continue after the train ids (the reference's
        # make_partition_and_labels)
        offset = (len(read_param_table(os.path.join(
            path, "TrainingParams.txt"))) if split == "val" else 0)
        paths = [delta_path(path, offset + i + 1, split == "test")
                 for i in range(len(labels3))]
        shape = np.load(paths[0], mmap_mode="r").shape
        X = read_volumes(paths, shape)
        if X.ndim == 5:  # (M, N, N, N, 1): the ETL's channel dim
            X = X[..., 0]
        maxima_all = mm.maxima()
        if split == "test":
            # test labels stay 3-wide, as in the reference
            y, maxima = labels3 / maxima_all[None, :], maxima_all
        else:
            keep = [j for j, f in enumerate(flags) if f]
            y = labels3[:, keep] / maxima_all[keep][None, :]
            maxima = maxima_all[keep]
        return cls(X=X, y=np.asarray(y, np.float32), maxima=maxima,
                   vary_flags=flags)

    def batches(self, batch_size: int,
                generator: torch.Generator | None = None,
                shuffle: bool = True, augment: bool = False,
                drop_remainder: bool = True, seed: int = 0, device="cuda"):
        """Yield (X, y) tensor batches of one epoch on ``device``: the
        order from ``np.random.default_rng(seed).shuffle``, augmentation
        on the device from ``generator`` (default: seeded from
        ``seed``)."""
        m = len(self)
        order = np.arange(m)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        if augment and generator is None:
            generator = torch.Generator(device).manual_seed(seed)
        stop = m - (m % batch_size) if drop_remainder else m
        for lo in range(0, stop, batch_size):
            idx = order[lo:lo + batch_size]
            X = torch.as_tensor(self.X[idx], device=device)
            if augment:
                X = augment_batch(X, generator)
            yield X, torch.as_tensor(self.y[idx], device=device)
