"""Density-projection rendering of particle states.

Counterpart of :mod:`nbody.analysis.render`: the projection is a CIC
deposit onto a 2D grid, done on the tensor's own device through the
fixed-point :func:`~nbody_torch.mesh.cic.scatter_sum` (so an image
repeats bit for bit); only the final image crosses to the host.  Works
from live states or CONCEPT snapshot files (which need h5py).
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_torch.mesh.cic import scatter_sum


def density_projection(pos, box: float, res: int = 512, axis: int = 2,
                       weights=None):
    """(res, res) surface-density image: CIC deposit of the particles
    ``pos`` (n, 3), a tensor on any device, projected along ``axis``."""
    pos = torch.as_tensor(pos)
    dims = [d for d in range(3) if d != axis]
    xy = torch.remainder(pos[:, dims], box) * (res / box)
    i0 = torch.floor(xy)
    f = xy - i0
    i0 = i0.to(torch.int64)
    w0 = (torch.ones(pos.shape[0], dtype=pos.dtype, device=pos.device)
          if weights is None else torch.as_tensor(weights, dtype=pos.dtype,
                                                  device=pos.device))
    lins, ws = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            ws.append((f[:, 0] if dx else 1 - f[:, 0])
                      * (f[:, 1] if dy else 1 - f[:, 1]) * w0)
            lins.append(torch.remainder(i0[:, 0] + dx, res) * res
                        + torch.remainder(i0[:, 1] + dy, res))
    img = scatter_sum(res * res, torch.cat(lins), torch.cat(ws))
    return img.reshape(res, res)


def save_density_image(pos, box: float, path: str, res: int = 512,
                       axis: int = 2, cmap: str = "inferno"):
    """Render a log-scaled surface-density PNG from particle positions."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = density_projection(pos, box, res=res, axis=axis).cpu().numpy()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.log10(img + 1e-2).T, origin="lower", cmap=cmap,
              extent=[0, box, 0, box])
    ax.set(xlabel="Mpc", ylabel="Mpc")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return img


def render_snapshot(snapshot_path: str, out_path: str, res: int = 512,
                    axis: int = 2, *, device=None):
    """CONCEPT HDF5 snapshot -> density PNG (the projection on
    ``device``; default the CPU)."""
    from nbody_torch.io.snapshot import read_snapshot

    state, meta = read_snapshot(snapshot_path, device=device)
    return save_density_image(state.pos, meta.boxsize, out_path, res=res,
                              axis=axis)
