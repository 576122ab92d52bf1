"""WaveNet building blocks, (B, T, C) channels-last at every public boundary
(counterpart of `tacotron2_tpu/models/wavenet/modules.py`).

Inference only: weight normalization is folded into plain weights by `convert.py`, and
the upsampler covers the SubPixel variant (the default) and the 2D transpose-conv
variant (the paper profile).
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn


class Conv1x1(nn.Linear):
    """Pointwise conv == a dense layer over the channel axis of (B, T, C)."""


class CausalConv1D(nn.Conv1d):
    """Left-padded dilated conv over (B, T, C); weight (out, in, kernel_size)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, dilation=dilation,
                         bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        pad = (self.kernel_size[0] - 1) * self.dilation[0]
        y = super().forward(F.pad(x.transpose(1, 2), (pad, 0)))
        return y.transpose(1, 2)


class ResidualConv1DGLU(nn.Module):
    """Dilated causal conv + GLU + conditioning 1x1s (local `conv1x1c`, global
    `conv1x1g`) + residual/skip 1x1s."""

    def __init__(self, residual_channels: int, gate_channels: int, kernel_size: int,
                 skip_out_channels: int, cin_channels: int = -1, dilation: int = 1,
                 bias: bool = True, residual_legacy: bool = True, gin_channels: int = -1):
        super().__init__()
        self.residual_legacy = residual_legacy
        self.conv = CausalConv1D(residual_channels, gate_channels, kernel_size,
                                 dilation, bias)
        self.conv1x1c = (Conv1x1(cin_channels, gate_channels, bias)
                         if cin_channels > 0 else None)
        self.conv1x1g = (Conv1x1(gin_channels, gate_channels, bias)
                         if gin_channels > 0 else None)
        half = gate_channels // 2
        self.conv1x1_out = Conv1x1(half, residual_channels, bias)
        self.conv1x1_skip = Conv1x1(half, skip_out_channels, bias)

    def _outputs(self, conv_out: Tensor, c_proj: Optional[Tensor], g_proj: Optional[Tensor],
                 residual: Tensor) -> Tuple[Tensor, Tensor]:
        """GLU of the conv output plus the projected conditionings, then the residual
        and skip 1x1s."""
        a, b = conv_out.chunk(2, dim=-1)
        for proj in (c_proj, g_proj):
            if proj is not None:
                pa, pb = proj.chunk(2, dim=-1)
                a, b = a + pa, b + pb
        gated = torch.tanh(a) * torch.sigmoid(b)
        s = self.conv1x1_skip(gated)
        out = self.conv1x1_out(gated) + residual
        if self.residual_legacy:
            out = out * math.sqrt(0.5)
        return out, s

    def forward(self, x: Tensor, c: Optional[Tensor], g: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        """x (B, T, R); c (B, T, cin) or None; g (B, T, gin) or None. Returns
        (x_out (B, T, R), skip (B, T, S))."""
        return self._outputs(self.conv(x), self.conv1x1c(c) if c is not None else None,
                             self.conv1x1g(g) if g is not None else None, x)

    def incremental_step(self, taps: Tensor, c_proj: Optional[Tensor],
                         g_proj: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        """One sample. taps (B, k, R) = the layer's inputs at t-(k-1)d, ..., t-d, t;
        c_proj and g_proj (B, G) are the conditionings already projected. Returns
        (x_out (B, R), skip (B, S))."""
        conv_out = torch.einsum('bki,oik->bo', taps, self.conv.weight)
        if self.conv.bias is not None:
            conv_out = conv_out + self.conv.bias
        return self._outputs(conv_out, c_proj, g_proj, taps[:, -1])


class Embedding(nn.Embedding):
    """Speaker embedding table (n_speakers, gin_channels), N(0, std) at init."""

    def __init__(self, num_embeddings: int, embedding_dim: int, std: float = 0.1):
        super().__init__(num_embeddings, embedding_dim)
        nn.init.normal_(self.weight, 0.0, std)


class UpsampleNetwork(nn.Module):
    """mel (B, Tc, cin) -> (B, Tc*hop, cin), SubPixel or 2D variant.

    The mel is an image with H = mel bins and W = time, one channel. A SubPixel layer
    is a SAME conv (freq_axis_kernel_size, 3) from 1 to s channels, then the periodic
    shuffle (B, H, W, s) -> (B, H, W*s). A 2D layer is a transpose conv
    (freq_axis_kernel_size, s) with stride (1, s) from 1 channel to 1. A ReLU follows
    every layer, the last included (`modules.py:357-397` of the JAX package).

    The 2D layer reproduces `jax.lax.conv_transpose(..., 'SAME')` with
    `transpose_kernel=False`: a correlation of the stride-dilated input with the
    kernel as it is, padded by lax's rule, (fk-1)/2 on each side in frequency for an
    odd fk and s-1 in time. torch's ConvTranspose2d correlates with the kernel flipped
    on both axes, so `convert.py` stores the flax kernel flipped, and the layer runs
    unpadded and crops the frequency axis to lax's padding."""

    def __init__(self, upsample_scales: Sequence[int], freq_axis_kernel_size: int = 3,
                 upsample_type: str = 'SubPixel'):
        super().__init__()
        if upsample_type not in ('SubPixel', '2D'):
            raise NotImplementedError(f'upsample_type={upsample_type!r}: SubPixel and 2D '
                                      'only')
        self.upsample_type = upsample_type
        self.scales = tuple(upsample_scales)
        fk = freq_axis_kernel_size
        if upsample_type == '2D':
            self.convs = nn.ModuleList(nn.ConvTranspose2d(1, 1, (fk, s), stride=(1, s))
                                       for s in self.scales)
        else:
            self.convs = nn.ModuleList(nn.Conv2d(1, s, (fk, 3), padding='same')
                                       for s in self.scales)
        # lax's SAME transpose padding in frequency (stride 1) is ceil((fk-1)/2) before
        # and floor((fk-1)/2) after; the unpadded ConvTranspose2d pads fk-1 on each
        # side, so the rest is cropped
        self._crop = ((fk - 1) // 2, fk // 2)

    def forward(self, c: Tensor) -> Tensor:
        B = c.shape[0]
        x = c.transpose(1, 2)[:, None]                     # (B, 1, H, W)
        for conv, s in zip(self.convs, self.scales):
            y = conv(x)
            if self.upsample_type == '2D':                 # (B, 1, H + fk - 1, W*s)
                x = torch.relu(y[:, :, self._crop[0]:y.shape[2] - self._crop[1]])
            else:                                          # (B, s, H, W)
                _, _, H, W = y.shape
                x = torch.relu(y.permute(0, 2, 3, 1).reshape(B, 1, H, W * s))
        return x[:, 0].transpose(1, 2)                     # (B, T*hop, cin)
