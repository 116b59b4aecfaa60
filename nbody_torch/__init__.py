"""nbody_torch — the nbody engine ported to PyTorch and CUDA.

A second package beside the JAX one (``nbody``), with its module layout
and public names: ``nbody_torch/forces/p3m.py`` stands opposite
``nbody/forces/p3m.py``.  It imports torch and numpy, never JAX.  Plain
tensor code is PyTorch; each Pallas kernel of the JAX package on a ported
path is a hand-written CUDA kernel for Hopper (``sm_90a``) under
``forces/csrc/``, built at first use by :mod:`nbody_torch._kernels`.
A kernel's wrapper launches it on a CUDA tensor (or raises) and takes the
kernel's plain PyTorch version on a CPU tensor.
"""

__version__ = "0.1.0"
