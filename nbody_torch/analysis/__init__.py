"""Analysis: solver comparisons, accuracy metrics, runtime parsing,
density images (counterpart of :mod:`nbody.analysis`)."""

from nbody_torch.analysis.compare import (
    compare_solver_spectra,
    ensemble_scatter,
    lpt_comparison,
    mean_relative_error,
    nyquist_k,
    parse_runtime,
    relative_error,
    resolution_study,
)
from nbody_torch.analysis.render import (
    density_projection,
    render_snapshot,
    save_density_image,
)

__all__ = [
    "compare_solver_spectra",
    "lpt_comparison",
    "mean_relative_error",
    "nyquist_k",
    "parse_runtime",
    "relative_error",
    "resolution_study",
    "ensemble_scatter",
    "density_projection",
    "render_snapshot",
    "save_density_image",
]
