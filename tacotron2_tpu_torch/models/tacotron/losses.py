"""Tacotron losses (counterpart of `tacotron2_tpu/models/tacotron/losses.py`): masked or
unmasked mel MSE before and after the post-net, the weighted stop-token cross-entropy,
the linear L1 with the band under 2 kHz counted twice, and the L2 regularization over
the weights that the JAX package's name filter keeps.

The filter works on flax parameter paths. The port's parameters are named otherwise, so
each is judged by its flax path (`flax_names.flax_name`, the table `convert` lays flax
trees out by)."""

from typing import Dict, Iterable, List, Tuple

import torch
from torch import Tensor, nn

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


def masked_mse(targets: Tensor, outputs: Tensor, lengths: Tensor) -> Tensor:
    mask = length_mask(lengths, targets.shape[1], targets.device)[..., None]
    se = torch.square(targets - outputs) * mask
    return torch.sum(se) / (torch.sum(mask) * targets.shape[-1])


def masked_sigmoid_ce(targets: Tensor, logits: Tensor, lengths: Tensor, hp) -> Tensor:
    """Mean over the nonzero terms of the masked weighted cross-entropy."""
    mask = length_mask(lengths, targets.shape[1], targets.device)
    losses = weighted_ce(targets, logits, hp.cross_entropy_pos_weight) * mask
    return torch.sum(losses) / torch.clamp(torch.count_nonzero(losses).float(), min=1.0)


def masked_linear_loss(targets: Tensor, outputs: Tensor, lengths: Tensor, hp) -> Tensor:
    mask = length_mask(lengths, targets.shape[1], targets.device)[..., None]
    mask_full = mask * torch.ones_like(targets)
    l1 = torch.abs(targets - outputs) * mask_full
    denom = torch.sum(mask_full)
    return 0.5 * torch.sum(l1) / denom + 0.5 * torch.sum(l1[:, :, :n_priority(hp)]) / denom


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
                   l2_params: Iterable[Tensor], hp) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Total loss = before + after + stop + reg (+ linear), and each term
    (`losses.py:71-107`). The unmasked stop loss weighs positives by 1, not by
    cross_entropy_pos_weight; only the masked one uses it."""
    mel_t = batch['mel_targets']
    with_linear = hp.predict_linear and 'linear_outputs' in outputs
    zero = torch.zeros((), device=mel_t.device)
    if hp.mask_decoder:
        lengths = batch['targets_lengths']
        before = masked_mse(mel_t, outputs['decoder_output'], lengths)
        after = masked_mse(mel_t, outputs['mel_outputs'], lengths)
        stop = masked_sigmoid_ce(batch['stop_token_targets'],
                                 outputs['stop_token_prediction'], lengths, hp)
        linear = (masked_linear_loss(batch['linear_targets'], outputs['linear_outputs'],
                                     lengths, hp) if with_linear else zero)
    else:
        before = torch.mean(torch.square(mel_t - outputs['decoder_output']))
        after = torch.mean(torch.square(mel_t - outputs['mel_outputs']))
        stop = torch.mean(weighted_ce(batch['stop_token_targets'],
                                      outputs['stop_token_prediction'], 1.0))
        if with_linear:
            l1 = torch.abs(batch['linear_targets'] - outputs['linear_outputs'])
            linear = 0.5 * torch.mean(l1) + 0.5 * torch.mean(l1[:, :, :n_priority(hp)])
        else:
            linear = zero
    reg = l2_regularization(l2_params, hp)
    total = before + after + stop + reg + linear
    return total, dict(before_loss=before, after_loss=after, stop_token_loss=stop,
                       regularization_loss=reg, linear_loss=linear, loss=total)
