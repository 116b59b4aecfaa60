"""I/O: CONCEPT-format interop (HDF5 snapshots, powerspec text, sidecars,
checkpoints); counterpart of :mod:`nbody.io`.  The snapshot functions
import h5py when they are called."""

from nbody_torch.io.powerspec import (
    PowerSpecTable,
    read_powerspec,
    write_powerspec,
)
from nbody_torch.io.sidecars import (
    BoxParams,
    MaxMinParams,
    read_box_params,
    read_maxmin_params,
    read_param_table,
    write_box_params,
    write_maxmin_params,
    write_param_table,
)
from nbody_torch.io.snapshot import SnapshotMeta, read_snapshot, write_snapshot

__all__ = [
    "SnapshotMeta",
    "read_snapshot",
    "write_snapshot",
    "PowerSpecTable",
    "read_powerspec",
    "write_powerspec",
    "BoxParams",
    "MaxMinParams",
    "read_box_params",
    "read_maxmin_params",
    "read_param_table",
    "write_box_params",
    "write_maxmin_params",
    "write_param_table",
]
