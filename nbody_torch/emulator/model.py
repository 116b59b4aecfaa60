"""3D-CNN emulator models, losses and metrics.

Counterpart of :mod:`nbody.emulator.model`: the reference's Keras/TFP model
functions (``make_model``: Conv3D(32, 3^3, relu, VALID) + MaxPool(2^3)
blocks, global average pool or flatten, a Dense(64) stack, dropout and a
head of width n_out, doubled for the heteroscedastic NLL; and
``make_bayesian_model``: mean-field Gaussian conv and dense layers with a
unit-normal prior), the losses ``mse_loss`` / ``gaussian_nll`` with the
softplus sigma, and the metrics.

The volume runs as NCDHW inside the model (cuDNN's layout); its input is
(B, N, N, N) or (B, N, N, N, 1) as in the JAX package.  Parameters start
as flax starts them (``lecun_normal``: a normal truncated at 2 sigma with
variance 1 / fan_in, fan_in = 27 C_in for a convolution; biases 0; the
variational rho at -5), so a run from a seed is the same model.  The
convolutions and dense products are cuDNN's and cuBLAS's, as the JAX
package's go through XLA and not through a Pallas kernel.

Precision: ``compute_dtype`` "auto" and "f32" run in full float32 (the
JAX rule gives float32 everywhere but on the TPU), with cuDNN held to
deterministic algorithms, no TF32 and no autotuning
(:func:`deterministic_cudnn`, entered in the forward here and around the
backward in :func:`~nbody_torch.emulator.train.fit`; no global flag is
set), so a fit repeats its bits; "bf16" runs the stack under
``torch.autocast`` in bfloat16 with a float32 head.

Randomness comes from an explicit ``torch.Generator``: with one, dropout
is on and a variational model samples its weights (the kernel's
epsilon, then the bias's, layer after layer); without one, dropout is
off, and a variational model raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

#: flax's lecun_normal draws a standard normal truncated at +-2 and
#: divides its std by this (the std of that truncated normal)
TRUNC_STD = 0.87962566103423978
RHO_INIT = -5.0  # softplus(-5) ~ 6.7e-3 initial posterior std


def deterministic_cudnn():
    """cuDNN held to deterministic algorithms, no TF32, no autotuning,
    for the span of the ``with`` block."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def softplus(x):
    """log(1 + e^x) as jax.nn.softplus computes it (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def lecun_normal_(param: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Fill ``param`` as flax's ``lecun_normal`` does, drawn on the CPU
    from ``generator`` (so a seed gives one model on every device)."""
    std = float(np.sqrt(1.0 / fan_in)) / TRUNC_STD
    w = torch.empty(param.shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    with torch.no_grad():
        param.copy_(w)


def dropout(x, rate: float, generator: torch.Generator | None):
    """Flax's dropout: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate); off without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _kl_std_normal(mu, sigma):
    """KL( N(mu, sigma^2) || N(0, 1) ), summed over all weights."""
    return torch.sum(0.5 * (mu**2 + sigma**2 - 1.0) - torch.log(sigma))


class _Variational(nn.Module):
    """Mean-field Gaussian kernel and bias (unit-normal prior)."""

    def __init__(self, kernel_shape: tuple, features: int, fan_in: int):
        super().__init__()
        self.fan_in = fan_in
        self.kernel_mu = nn.Parameter(torch.zeros(kernel_shape))
        self.kernel_rho = nn.Parameter(torch.full(kernel_shape, RHO_INIT))
        self.bias_mu = nn.Parameter(torch.zeros(features))
        self.bias_rho = nn.Parameter(torch.full((features,), RHO_INIT))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel_mu, self.fan_in, generator)
        with torch.no_grad():
            self.bias_mu.zero_()
            self.kernel_rho.fill_(RHO_INIT)
            self.bias_rho.fill_(RHO_INIT)

    def sample(self, generator: torch.Generator | None):
        """(kernel, bias, KL): one draw of the weights."""
        if generator is None:
            raise ValueError("a variational layer samples its weights from "
                             "a generator")
        out, kl = [], 0.0
        for mu, rho in ((self.kernel_mu, self.kernel_rho),
                        (self.bias_mu, self.bias_rho)):
            sigma = softplus(rho) + 1e-6
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
            out.append(mu + sigma * eps)
            kl = kl + _kl_std_normal(mu, sigma)
        return out[0], out[1], kl


class Conv3DVariational(_Variational):
    """Mean-field Gaussian 3D convolution, VALID padding (the role of
    ``tfpl.Convolution3DReparameterization``); kernel (O, I, 3, 3, 3)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3):
        super().__init__((features, in_channels) + (kernel_size,) * 3,
                         features, in_channels * kernel_size**3)

    def forward(self, x, generator: torch.Generator | None):
        """(y, KL) for x (B, C, D, H, W)."""
        w, b, kl = self.sample(generator)
        return F.conv3d(x, w.to(x.dtype), b.to(x.dtype)), kl


class DenseVariational(_Variational):
    """Mean-field Gaussian dense layer (the role of
    ``tfpl.DenseVariational``); kernel (out, in)."""

    def __init__(self, in_features: int, features: int):
        super().__init__((features, in_features), features, in_features)

    def forward(self, x, generator: torch.Generator | None):
        """(y, KL) for x (B, in)."""
        w, b, kl = self.sample(generator)
        return F.linear(x, w.to(x.dtype), b.to(x.dtype)), kl


def max_conv_blocks(n: int) -> int:
    """How many Conv3D(3^3, VALID) + MaxPool(2^3) blocks an n^3 volume
    supports before the spatial size hits zero."""
    blocks = 0
    while (n - 2) // 2 >= 1:
        n = (n - 2) // 2
        blocks += 1
    return blocks


def _pooled_side(n: int, n_conv: int) -> int:
    for _ in range(n_conv):
        n = (n - 2) // 2
    return n


class CosmoCNN(nn.Module):
    """delta(x) volume -> cosmological parameter regression.

    The reference's ``make_model`` topology and defaults (epochs 1000,
    batch 16, lr 4e-3, dropout 0.2).  ``heteroscedastic`` doubles the
    head to (mu, raw sigma) for the NLL loss; ``variational`` swaps the
    conv and dense layers for their mean-field Gaussian forms.  ``dim``,
    the volume's side, sizes the first dense layer when ``global_pool``
    is off (the flatten is channel-last, as in the JAX package, so a
    converted kernel lines up).  The initial parameters are drawn from
    seed 0 (:meth:`reset_parameters`; ``fit`` draws them again from its
    own seed).

    ``forward(x, generator=None)`` returns (pred, KL): pred (B, width)
    in float32 (float64 for a float64 model, the tests' reference), KL
    the summed divergence of a variational model's sampled weights (0
    otherwise).
    """

    def __init__(self, n_out: int = 1, n_conv: int = 2, n_dense: int = 1,
                 filters: int = 32, dense_units: int = 64,
                 dropout_rate: float = 0.2, full_dropout: bool = False,
                 global_pool: bool = True, heteroscedastic: bool = False,
                 variational: bool = False, compute_dtype: str = "auto",
                 dim: int | None = None):
        super().__init__()
        if compute_dtype not in ("auto", "f32", "bf16"):
            raise ValueError(f"compute_dtype {compute_dtype!r} is not "
                             f"'auto', 'f32' or 'bf16'")
        if dim is not None and max_conv_blocks(dim) < n_conv:
            raise ValueError(self._collapse(dim, n_conv))
        if not global_pool and dim is None:
            raise ValueError("global_pool=False sizes its first dense layer "
                             "from the volume: pass dim")
        self.n_out, self.n_conv, self.n_dense = n_out, n_conv, n_dense
        self.dropout_rate, self.full_dropout = dropout_rate, full_dropout
        self.global_pool = global_pool
        self.heteroscedastic, self.variational = heteroscedastic, variational
        self.compute_dtype, self.dim = compute_dtype, dim
        # skip_init: the parameters are drawn below, not from torch's
        # global generator
        conv = Conv3DVariational if variational else (
            lambda c_in, c_out: nn.utils.skip_init(nn.Conv3d, c_in, c_out, 3))
        dense = DenseVariational if variational else (
            lambda n_in, n_out: nn.utils.skip_init(nn.Linear, n_in, n_out))
        self.convs = nn.ModuleList(
            conv(1 if i == 0 else filters, filters) for i in range(n_conv))
        width = filters if global_pool else (
            filters * _pooled_side(dim, n_conv) ** 3)
        self.denses = nn.ModuleList()
        for _ in range(n_dense):
            self.denses.append(dense(width, dense_units))
            width = dense_units
        self.head = dense(width, 2 * n_out if heteroscedastic else n_out)
        self.reset_parameters(torch.Generator().manual_seed(0))

    @staticmethod
    def _collapse(n: int, n_conv: int) -> str:
        return (f"n_conv={n_conv} collapses a {n}^3 volume to zero size "
                f"(VALID conv + 2x pool); max is {max_conv_blocks(n)}")

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initialisation, layer after layer from ``generator``."""
        for layer in [*self.convs, *self.denses, self.head]:
            if self.variational:
                layer.reset_parameters(generator)
                continue
            fan_in = layer.weight[0].numel()
            lecun_normal_(layer.weight, fan_in, generator)
            with torch.no_grad():
                layer.bias.zero_()

    def _layer(self, layer, x, generator):
        if self.variational:
            return layer(x, generator)
        return layer(x), 0.0

    def forward(self, x, generator: torch.Generator | None = None):
        if x.ndim == 5:
            x = x[..., 0]
        x = x[:, None]  # (B, N, N, N) -> NCDHW
        if max_conv_blocks(x.shape[2]) < self.n_conv:
            raise ValueError(self._collapse(x.shape[2], self.n_conv))
        kl = torch.zeros((), dtype=torch.float32, device=x.device)
        with deterministic_cudnn(), torch.autocast(
                x.device.type, dtype=torch.bfloat16,
                enabled=self.compute_dtype == "bf16"):
            for conv in self.convs:
                x, k = self._layer(conv, x, generator)
                kl = kl + k
                x = F.max_pool3d(F.relu(x), 2)
                if self.full_dropout:
                    x = dropout(x, self.dropout_rate, generator)
            if self.global_pool:
                x = x.mean(dim=(2, 3, 4))
            else:  # channel-last, as the JAX package flattens NDHWC
                x = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
            for dense in self.denses:
                x, k = self._layer(dense, x, generator)
                kl = kl + k
                x = F.relu(x)
            x = dropout(x, self.dropout_rate, generator)
            x, k = self._layer(self.head, x, generator)
        # float32 out of the bf16 stack; a float64 model stays float64
        return x.to(torch.promote_types(x.dtype, torch.float32)), kl + k

    def split_prediction(self, pred):
        """(mu, sigma) for heteroscedastic heads; (mu, None) otherwise.
        sigma = softplus(raw) + 1e-6, the reference's parametrisation."""
        if not self.heteroscedastic:
            return pred, None
        return (pred[..., : self.n_out],
                softplus(pred[..., self.n_out:]) + 1e-6)


# --------------------------------------------------------------------------
# Losses
# --------------------------------------------------------------------------


def mse_loss(pred, y):
    """The reference's ``loss_mse``."""
    return torch.mean((pred - y) ** 2)


def gaussian_nll(pred, y):
    """Heteroscedastic Gaussian NLL with the softplus sigma, the
    reference's ``loss_nlll``; ``pred`` is (B, 2P): mu | raw."""
    p = y.shape[-1]
    mu = pred[..., :p]
    sigma = softplus(pred[..., p:]) + 1e-6
    return torch.mean(0.5 * ((y - mu) / sigma) ** 2 + torch.log(sigma))


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------


def chi_squared(y_true, y_pred, sigma):
    """The reference's ``chi_squared_calc``."""
    return torch.sum(((y_true - y_pred) / sigma) ** 2)


def sigma_coverage(y_true, y_pred, sigma):
    """Fraction of truths within 1/2/3 predicted sigma (calibrated UQ
    gives ~(0.683, 0.954, 0.997)), the reference's
    ``sigma_coverage_calc``."""
    err = torch.abs(y_true - y_pred)
    return torch.stack([torch.mean((err <= n * sigma).to(torch.float32))
                        for n in (1, 2, 3)])


def abs_percent_deviation(y_true, y_pred):
    """The reference's ``abs_percent_deviation_calc``."""
    return 100.0 * torch.mean(torch.abs((y_pred - y_true) / y_true))
