"""Emulator: 3D-CNN cosmological parameter inference with uncertainty.

Counterpart of :mod:`nbody.emulator`: a delta(x) volume -> (A_s, n_s,
omega_cdm) regression with three uncertainty modes (MC dropout,
heteroscedastic NLL, variational Bayes), and the dataset creation, ETL
and augmentation that feed it, in PyTorch on the card.
"""

from nbody_torch.emulator.data import (
    DeltaDataset,
    augment_batch,
    create_linear_dataset,
    snapshots_to_delta,
)
from nbody_torch.emulator.model import (
    CosmoCNN,
    abs_percent_deviation,
    chi_squared,
    gaussian_nll,
    mse_loss,
    sigma_coverage,
)
from nbody_torch.emulator.train import TrainResult, evaluate_uq, fit

__all__ = [
    "DeltaDataset",
    "augment_batch",
    "create_linear_dataset",
    "snapshots_to_delta",
    "CosmoCNN",
    "gaussian_nll",
    "mse_loss",
    "sigma_coverage",
    "abs_percent_deviation",
    "chi_squared",
    "TrainResult",
    "evaluate_uq",
    "fit",
]
