"""Simulation checkpoints: the layout of :mod:`nbody.io.checkpoint`.

A checkpoint is a lossless ``.npz`` of the ParticleState (pos, vel, mass,
time) plus a JSON ``extra`` header, written atomically (tmp + rename), so
files written by either package load in both.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nbody_torch.core.types import ParticleState

CHECKPOINT_NAME = "checkpoint.npz"


def save_checkpoint(path: str, state: ParticleState,
                    extra: dict | None = None) -> str:
    """Atomically write ``state`` (+ a JSON-serialisable ``extra`` dict)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(
            f,
            pos=state.pos.detach().cpu().numpy(),
            vel=state.vel.detach().cpu().numpy(),
            mass=state.mass.detach().cpu().numpy(),
            time=state.time.detach().cpu().numpy(),
            extra=json.dumps(extra or {}),
        )
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, *, device=None, dtype=None):
    """-> (ParticleState, extra dict).  ``dtype=None`` keeps the stored
    dtype (bit-exact resume)."""
    with np.load(path, allow_pickle=False) as z:
        state = ParticleState.create(z["pos"], z["vel"], z["mass"], z["time"],
                                     device=device, dtype=dtype)
        extra = json.loads(str(z["extra"]))
    return state, extra


def latest_checkpoint(workdir: str) -> str | None:
    """The autosave checkpoint in a run directory, if any."""
    p = os.path.join(workdir, "autosave", CHECKPOINT_NAME)
    return p if os.path.exists(p) else None
