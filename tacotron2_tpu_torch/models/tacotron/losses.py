"""Tacotron losses (counterpart of `tacotron2_tpu/models/tacotron/losses.py`): masked or
unmasked mel MSE before and after the post-net, the weighted stop-token cross-entropy,
the linear L1 with the band under 2 kHz counted twice, and the L2 regularization over
the weights that the JAX package's name filter keeps.

The filter works on flax parameter paths. The port's parameters are named otherwise, so
each is judged by its flax path (`flax_names.flax_name`, the table `convert` lays flax
trees out by).

Under data parallelism the losses take the data group: every denominator (a masked
count, the number of nonzero stop-token terms, an unmasked mean's element count) is the
sum over the group's ranks, and each rank adds 1/N of the L2 term, so that the ranks'
totals sum to the loss of the global batch and their gradients to its gradient."""

from typing import Dict, Iterable, List, Tuple

import torch
from torch import Tensor, nn

from ...parallel.collectives import global_sum, group_size
from .flax_names import flax_name
from .modules import length_mask


def weighted_ce(targets: Tensor, logits: Tensor, pos_weight: float) -> Tensor:
    """tf.nn.weighted_cross_entropy_with_logits, elementwise."""
    log_weight = 1.0 + (pos_weight - 1.0) * targets
    return ((1.0 - targets) * logits
            + log_weight * (torch.log1p(torch.exp(-torch.abs(logits))) + torch.relu(-logits)))


def n_priority(hp) -> int:
    """Linear-spectrogram bins under 2 kHz, counted twice by the linear loss."""
    return int(2000 / (hp.sample_rate * 0.5) * hp.num_freq)


def masked_mse(targets: Tensor, outputs: Tensor, lengths: Tensor, group=None) -> Tensor:
    mask = length_mask(lengths, targets.shape[1], targets.device)[..., None]
    se = torch.square(targets - outputs) * mask
    return torch.sum(se) / (global_sum(torch.sum(mask), group) * targets.shape[-1])


def masked_sigmoid_ce(targets: Tensor, logits: Tensor, lengths: Tensor, hp,
                      group=None) -> Tensor:
    """Mean over the nonzero terms of the masked weighted cross-entropy."""
    mask = length_mask(lengths, targets.shape[1], targets.device)
    losses = weighted_ce(targets, logits, hp.cross_entropy_pos_weight) * mask
    count = global_sum(torch.count_nonzero(losses).float(), group)
    return torch.sum(losses) / torch.clamp(count, min=1.0)


def masked_linear_loss(targets: Tensor, outputs: Tensor, lengths: Tensor, hp,
                       group=None) -> Tensor:
    mask = length_mask(lengths, targets.shape[1], targets.device)[..., None]
    mask_full = mask * torch.ones_like(targets)
    l1 = torch.abs(targets - outputs) * mask_full
    denom = global_sum(torch.sum(mask_full), group)
    return 0.5 * torch.sum(l1) / denom + 0.5 * torch.sum(l1[:, :, :n_priority(hp)]) / denom


def _mean(x: Tensor, group=None) -> Tensor:
    """The mean of x, or with a data `group` this rank's sum over the group's count."""
    if group is None:
        return torch.mean(x)
    return torch.sum(x) / global_sum(torch.tensor(float(x.numel()), device=x.device), group)


def counts_for_l2(flax_path: str) -> bool:
    """The JAX package's filter (`losses.py:51-68`): every weight but biases, the
    projections, the embedding and the LSTM and GRU weights. BatchNorm scales count."""
    name = flax_path.lower()
    return not ('bias' in name or '_projection' in name or 'inputs_embedding' in name
                or 'lstm' in name or 'gru' in name)


def l2_parameters(model: nn.Module) -> List[Tensor]:
    """The parameters of a port Tacotron that the L2 term sums over."""
    return [p for n, p in model.named_parameters() if counts_for_l2(flax_name(n))]


def l2_regularization(params: Iterable[Tensor], hp) -> Tensor:
    """reg_weight * sum of 0.5 * ||w||^2 over `params` (`l2_parameters`), reg_weight
    scaled by 1 / (2 * max_abs_value) (symmetric) or 1 / max_abs_value under
    tacotron_scale_regularization."""
    if hp.tacotron_scale_regularization:
        scaler = (1.0 / (2 * hp.max_abs_value) if hp.symmetric_mels
                  else 1.0 / hp.max_abs_value)
        reg_weight = hp.tacotron_reg_weight * scaler
    else:
        reg_weight = hp.tacotron_reg_weight
    total = sum(0.5 * torch.sum(torch.square(p.float())) for p in params)
    return total * reg_weight


def compute_losses(outputs: Dict[str, Tensor], batch: Dict[str, Tensor],
                   l2_params: Iterable[Tensor], hp, group=None
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Total loss = before + after + stop + reg (+ linear), and each term
    (`losses.py:71-107`). The unmasked stop loss weighs positives by 1, not by
    cross_entropy_pos_weight; only the masked one uses it. With a data `group` the
    terms are this rank's shares of the global batch's (see the module's docstring)."""
    mel_t = batch['mel_targets']
    with_linear = hp.predict_linear and 'linear_outputs' in outputs
    zero = torch.zeros((), device=mel_t.device)
    if hp.mask_decoder:
        lengths = batch['targets_lengths']
        before = masked_mse(mel_t, outputs['decoder_output'], lengths, group)
        after = masked_mse(mel_t, outputs['mel_outputs'], lengths, group)
        stop = masked_sigmoid_ce(batch['stop_token_targets'],
                                 outputs['stop_token_prediction'], lengths, hp, group)
        linear = (masked_linear_loss(batch['linear_targets'], outputs['linear_outputs'],
                                     lengths, hp, group) if with_linear else zero)
    else:
        before = _mean(torch.square(mel_t - outputs['decoder_output']), group)
        after = _mean(torch.square(mel_t - outputs['mel_outputs']), group)
        stop = _mean(weighted_ce(batch['stop_token_targets'],
                                 outputs['stop_token_prediction'], 1.0), group)
        if with_linear:
            l1 = torch.abs(batch['linear_targets'] - outputs['linear_outputs'])
            linear = 0.5 * _mean(l1, group) + 0.5 * _mean(l1[:, :, :n_priority(hp)], group)
        else:
            linear = zero
    reg = l2_regularization(l2_params, hp)
    if group is not None:
        reg = reg / group_size(group)
    total = before + after + stop + reg + linear
    return total, dict(before_loss=before, after_loss=after, stop_token_loss=stop,
                       regularization_loss=reg, linear_loss=linear, loss=total)
