"""Data-dependent weight-norm initialization (Salimans & Kingma; counterpart of
`tacotron2_tpu/training/weight_norm_init.py:24-91`).

On a fresh run, for each weight-normalized conv in the network's order (the upsampler's
first: they feed every conv1x1c), run the network on one real batch, measure the conv
output's mean and population standard deviation for each channel, and set g' = g *
init_scale / (std + 1e-8) and b' = (b - mean) * init_scale / (std + 1e-8), so that every
conv starts with zero-mean activations of deviation init_scale. One forward pass a
conv, each with the convs before it already initialized; a forward hook captures the
conv's output.
"""

from typing import Dict, List

import torch
from torch import Tensor, nn

from ..models.wavenet.model import WaveNet
from ..models.wavenet.modules import is_weight_normalized
from ..ops.mulaw import is_mulaw_quantize


def conv_order(model: WaveNet) -> List[nn.Module]:
    """The convs in the order they are initialized (`weight_norm_init.py:24-40`)."""
    convs: List[nn.Module] = list(model.upsample.convs) if model.upsample is not None else []
    convs.append(model.first_conv)
    for blk in model.residual_layers:
        convs.append(blk.conv)
        if blk.conv1x1c is not None:
            convs.append(blk.conv1x1c)
        if blk.conv1x1g is not None:
            convs.append(blk.conv1x1g)
        convs += [blk.conv1x1_out, blk.conv1x1_skip]
    return convs + [model.skip_conv1, model.skip_conv2]


@torch.no_grad()
def data_dependent_init(model: WaveNet, batch: Dict[str, Tensor], hp) -> WaveNet:
    """Initialize g and the bias of every weight-normalized conv of `model` in place
    from one batch (tensors on the model's device). No-op unless
    hp.wavenet_weight_normalization. Returns `model`."""
    if not hp.wavenet_weight_normalization:
        return model
    y = batch['audio']
    x = y if is_mulaw_quantize(hp.input_type) else model.encode_input(y)
    upsample_convs = set(model.upsample.convs) if model.upsample is not None else set()
    for conv in conv_order(model):
        if not is_weight_normalized(conv):
            continue
        captured = []
        handle = conv.register_forward_hook(lambda m, args, out: captured.append(out))
        try:
            model(x, batch.get('mel_conditions'), batch.get('speaker_ids'))
        finally:
            handle.remove()
        out: Tensor = captured[0].float()
        if conv in upsample_convs:  # (B, C, H, W), and a 2D layer cut to its SAME region
            out = model.upsample.crop(out).movedim(1, -1)
        flat = out.reshape(-1, out.shape[-1])
        mean = flat.mean(0)
        scale = hp.wavenet_init_scale / (flat.std(0, unbiased=False) + 1e-8)
        conv.parametrizations.weight[0].g.mul_(scale)
        conv.bias.copy_((conv.bias - mean) * scale)
    return model
