"""WaveNet vocoder (counterpart of `tacotron2_tpu/models/wavenet/model.py`).

The teacher-forced forward pass runs the whole utterance in parallel; autoregressive
generation runs on packed weights in `ops/wavenet_ar.py`. Covered: raw scalar input,
local conditioning with the SubPixel or 2D upsampler (ReLU), no global
conditioning.
"""

import math
from typing import Optional

import torch
from torch import Tensor, nn

from .modules import Conv1x1, ResidualConv1DGLU, UpsampleNetwork


class WaveNet(nn.Module):
    def __init__(self, hp):
        super().__init__()
        if hp.layers % hp.stacks != 0:
            raise ValueError('layers must be a multiple of stacks')
        if hp.input_type != 'raw':
            raise NotImplementedError(f'input_type={hp.input_type!r}: raw input only')
        if hp.gin_channels > 0:
            raise NotImplementedError('global conditioning is not ported yet')
        if hp.cin_channels > 0 and (hp.upsample_type not in ('SubPixel', '2D')
                                    or hp.upsample_activation != 'Relu'):
            raise NotImplementedError(
                f'upsample_type={hp.upsample_type!r}, upsample_activation='
                f'{hp.upsample_activation!r}: the SubPixel and 2D upsamplers with ReLU '
                'only')
        self.hp = hp
        lps = hp.layers // hp.stacks
        self.first_conv = Conv1x1(1, hp.residual_channels, hp.use_bias)
        self.residual_layers = nn.ModuleList(
            ResidualConv1DGLU(hp.residual_channels, hp.gate_channels, hp.kernel_size,
                              hp.skip_out_channels, hp.cin_channels, 2 ** (i % lps),
                              hp.use_bias, hp.residual_legacy)
            for i in range(hp.layers))
        self.skip_conv1 = Conv1x1(hp.skip_out_channels, hp.skip_out_channels, hp.use_bias)
        self.skip_conv2 = Conv1x1(hp.skip_out_channels, hp.out_channels, hp.use_bias)
        self.upsample = (UpsampleNetwork(hp.upsample_scales, hp.freq_axis_kernel_size,
                                         hp.upsample_type)
                         if hp.cin_channels > 0 else None)

    def upsample_conditioning(self, c: Tensor) -> Tensor:
        """mel (B, Tc, cin) -> (B, Tc*hop, cin)."""
        return self.upsample(c)

    def forward(self, x: Tensor, c: Optional[Tensor] = None,
                c_is_upsampled: bool = False) -> Tensor:
        """Teacher-forced parallel pass.

        Args:
            x: (B, T, 1) network input (the audio, one step behind its target).
            c: (B, Tc, cin) mel conditioning, or (B, T, cin) if c_is_upsampled.
        Returns: (B, T, out_channels) distribution params.
        """
        if c is not None and self.upsample is not None:
            if not c_is_upsampled:
                c = self.upsample(c)
            if c.shape[1] != x.shape[1]:
                raise ValueError(f'upsampled c length {c.shape[1]} != audio {x.shape[1]}')
        h = self.first_conv(x)
        skips = None
        for layer in self.residual_layers:
            h, s = layer(h, c)
            if skips is None:
                skips = s  # the first skip enters unscaled
            else:
                skips = skips + s
                if self.hp.legacy:
                    skips = skips * math.sqrt(0.5)
        out = torch.relu(skips)
        out = torch.relu(self.skip_conv1(out))
        return self.skip_conv2(out)
