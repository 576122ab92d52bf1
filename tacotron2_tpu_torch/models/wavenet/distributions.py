"""The WaveNet output distributions (counterpart of
`tacotron2_tpu/models/wavenet/distributions.py` and of the draws in
`models/wavenet/model.py:269-284`): the three training losses (discretized mixture of
logistics, Gaussian with or without the CDF trick, masked softmax cross-entropy), each
the mean NLL over the positions a mask keeps, and the samplers. Under data parallelism
each loss takes the data group: its denominator is the count over every rank's rows, so
that the ranks' losses sum to the mean over the global batch.

Every sampler takes its noise as a tensor, in the layout `ops/wavenet_ar.make_noise`
uses, or draws it from a `torch.Generator` on the device of the params.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor

from ...parallel.collectives import global_sum

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


def _reduce(nll: Tensor, mask: Optional[Tensor], group=None) -> Tensor:
    """Mean over all positions, or over those `mask` (0/1) keeps (at least one); with a
    data `group`, this rank's sum over the count of the whole group's."""
    if mask is None:
        if group is None:
            return nll.mean()
        return nll.sum() / global_sum(torch.tensor(float(nll.numel()), device=nll.device),
                                      group)
    m = mask.to(nll.dtype)
    return (nll * m).sum() / torch.clamp(global_sum(m.sum(), group), min=1.0)


def discretized_mix_logistic_loss(y_hat: Tensor, y: Tensor, num_classes: int = 65536,
                                  log_scale_min: float = -32.23619130191664,
                                  mask: Optional[Tensor] = None, group=None) -> Tensor:
    """NLL of y (B, T) in [-1, 1] under a discretized mixture of logistics y_hat
    (B, T, 3*nr) = [logits | means | log-scales] (`distributions.py:30-69`): the
    probability of y's bin, cdf(y + half bin) - cdf(y - half bin); at the edges y <
    -0.999 and y > 0.999 the tail below or above; where that difference is at most 1e-5
    the density at the bin's middle times the bin width. Scalar."""
    nr = y_hat.shape[-1] // 3
    logit_probs = y_hat[..., :nr]
    means = y_hat[..., nr:2 * nr]
    log_scales = torch.clamp(y_hat[..., 2 * nr:3 * nr], min=log_scale_min)
    yb = y[..., None]
    centered = yb - means
    inv_stdv = torch.exp(-log_scales)
    plus_in = inv_stdv * (centered + 1.0 / (num_classes - 1))
    min_in = inv_stdv * (centered - 1.0 / (num_classes - 1))
    log_cdf_plus = plus_in - F.softplus(plus_in)          # y == -1 edge
    log_one_minus_cdf_min = -F.softplus(min_in)           # y == +1 edge
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    mid_in = inv_stdv * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * F.softplus(mid_in)
    inner = torch.where(cdf_delta > 1e-5, torch.log(torch.clamp(cdf_delta, min=1e-12)),
                        log_pdf_mid - math.log((num_classes - 1) / 2))
    log_probs = torch.where(yb < -0.999, log_cdf_plus,
                            torch.where(yb > 0.999, log_one_minus_cdf_min, inner))
    log_probs = log_probs + torch.log_softmax(logit_probs, -1)
    return _reduce(-torch.logsumexp(log_probs, -1), mask, group)


def _normal_cdf(x: Tensor) -> Tensor:
    """The standard normal CDF as `jax.scipy.special.ndtr` computes it: through erf
    within one deviation of the mean and through erfc in the tails, where 0.5 * (1 +
    erf) would round a left tail below 3e-8 to zero and the bin probability with it."""
    w = x * math.sqrt(0.5)
    z = torch.abs(w)
    tail = 0.5 * torch.erfc(z)
    return torch.where(z < math.sqrt(0.5), 0.5 + 0.5 * torch.erf(w),
                       torch.where(w > 0, 1.0 - tail, tail))


def gaussian_mle_loss(y_hat: Tensor, y: Tensor, num_classes: int,
                      log_scale_min_gauss: float = -16.118095650958319,
                      use_cdf: bool = False, mask: Optional[Tensor] = None,
                      group=None) -> Tensor:
    """Gaussian maximum-likelihood loss (`distributions.py:91-107`); y_hat (B, T, 2) =
    [mean | log-scale], y (B, T). With `use_cdf` the log-probability of y's bin,
    floored at 1e-12, in place of the log-density."""
    mean = y_hat[..., 0]
    log_scale = torch.clamp(y_hat[..., 1], min=log_scale_min_gauss)
    if use_cdf:
        scale = torch.exp(log_scale)
        half_bin = 1.0 / (num_classes - 1)
        cdf_plus = _normal_cdf((y + half_bin - mean) / scale)
        cdf_min = _normal_cdf((y - half_bin - mean) / scale)
        log_prob = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    else:
        log_prob = -0.5 * (math.log(2.0 * math.pi) + 2.0 * log_scale
                           + torch.square(y - mean) * torch.exp(-2.0 * log_scale))
    return _reduce(-log_prob, mask, group)


def masked_cross_entropy_loss(y_hat: Tensor, y: Tensor, mask: Optional[Tensor] = None,
                              group=None) -> Tensor:
    """Softmax cross-entropy (`distributions.py:119-124`); y_hat (B, T, Q) logits, y
    (B, T) class ids."""
    logp = torch.log_softmax(y_hat, -1)
    return _reduce(-logp.gather(-1, y[..., None].long())[..., 0], mask, group)
