"""Sampling from the WaveNet output distributions (counterpart of the samplers of
`tacotron2_tpu/models/wavenet/distributions.py` and of the draws in
`models/wavenet/model.py:269-284`). The losses belong to training and are not ported.

Every sampler takes its noise as a tensor, in the layout `ops/wavenet_ar.make_noise`
uses, or draws it from a `torch.Generator` on the device of the params.
"""

from typing import Optional

import torch
from torch import Tensor

# uniform draws stay inside [U_LO, 1 - U_LO], as the JAX samplers' minval / maxval
U_LO = 1e-5


def _uniform(shape, generator: torch.Generator, device) -> Tensor:
    return U_LO + (1.0 - 2 * U_LO) * torch.rand(shape, generator=generator, device=device)


def gumbel_noise(shape, generator: torch.Generator, device) -> Tensor:
    return -torch.log(-torch.log(_uniform(shape, generator, device)))


def logistic_noise(shape, generator: torch.Generator, device) -> Tensor:
    u = _uniform(shape, generator, device)
    return torch.log(u) - torch.log(1.0 - u)


def sample_from_gaussian(y: Tensor, log_scale_min_gauss: float = -16.118095650958319,
                         noise: Optional[Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> Tensor:
    """Gaussian params y (..., 2) -> a sample (...) clipped to [-1, 1]; `noise` (...)
    is standard normal."""
    mean = y[..., 0]
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=y.device)
    log_scale = torch.clamp(y[..., 1], min=log_scale_min_gauss)
    return torch.clamp(mean + torch.exp(log_scale) * noise, -1.0, 1.0)


def sample_from_discretized_mix_logistic(y: Tensor, log_scale_min: float = -32.23619130191664,
                                         noise: Optional[Tensor] = None,
                                         generator: Optional[torch.Generator] = None
                                         ) -> Tensor:
    """Mixture-of-logistics params y (..., 3*nr) -> a sample (...) clipped to [-1, 1]:
    the mixture of largest logit + Gumbel noise (the first on ties), then its mean +
    exp(max(log_scale, log_scale_min)) * logistic noise. `noise` (..., nr+1) holds the
    logistic noise in column 0 and the Gumbel noise in columns 1..nr."""
    nr = y.shape[-1] // 3
    if noise is None:
        noise = torch.cat([logistic_noise(y.shape[:-1] + (1,), generator, y.device),
                           gumbel_noise(y.shape[:-1] + (nr,), generator, y.device)], -1)
    arg = (y[..., :nr] + noise[..., 1:1 + nr]).argmax(-1, keepdim=True)
    mean = y[..., nr:2 * nr].gather(-1, arg)[..., 0]
    log_scale = torch.clamp(y[..., 2 * nr:3 * nr].gather(-1, arg)[..., 0], min=log_scale_min)
    return torch.clamp(mean + torch.exp(log_scale) * noise[..., 0], -1.0, 1.0)


def sample_from_categorical(y: Tensor, noise: Optional[Tensor] = None,
                            generator: Optional[torch.Generator] = None) -> Tensor:
    """Logits y (..., Q) -> class ids (...) int64 by Gumbel-max (the first on ties);
    `noise` (..., Q) is Gumbel noise."""
    if noise is None:
        noise = gumbel_noise(y.shape, generator, y.device)
    return (y + noise).argmax(-1)
