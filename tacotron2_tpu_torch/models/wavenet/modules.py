"""WaveNet building blocks, (B, T, C) channels-last at every public boundary
(counterpart of `tacotron2_tpu/models/wavenet/modules.py`).

Weight normalization (`weight_normalization=True`) makes every conv's weight the
parametrization g * v / sqrt(sum(v^2) + 1e-8), the sum over every axis but the output
one, with g and v both trained (`modules.py:25-32`): `module.weight` is then the
effective weight wherever it is read (the forward pass, `ops/wavenet_ar.pack_params`),
`module.parametrizations.weight.original` is v and `module.parametrizations.weight[0].g`
is g. Inference checkpoints may instead carry the folded weight (`convert.py`). The
upsampler covers the JAX package's five variants: NearestNeighbor, 1D, 2D, Resize and
SubPixel (the default; 2D is the paper profile's), with a ReLU, leaky ReLU or no
activation.

The parallel path's forwards take the compute dtype (`models/precision.py`): each conv
casts its input, weight and bias to it, as the flax modules do.
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn
from torch.nn.utils import parametrize

from ..precision import cast_forward, sigmoid, weak


class WeightNorm(nn.Module):
    """The parametrization weight = g * v / sqrt(sum(v^2) + 1e-8), one g for each output
    channel (axis `out_dim` of v), the sum over every other axis. The 1e-8 inside the
    root is the JAX package's (`modules.py:31`); `torch.nn.utils.parametrizations.
    weight_norm` has none, so this is written out."""

    def __init__(self, features: int, out_dim: int = 0):
        super().__init__()
        self.out_dim = out_dim
        self.g = nn.Parameter(torch.ones(features))

    def forward(self, v: Tensor) -> Tensor:
        dims = [d for d in range(v.dim()) if d != self.out_dim]
        shape = [1] * v.dim()
        shape[self.out_dim] = -1
        norm = torch.sqrt(v.square().sum(dims, keepdim=True) + 1e-8)
        return self.g.view(shape) * v / norm


def weight_normalize(module: nn.Module, out_dim: int = 0) -> nn.Module:
    """Register WeightNorm on `module.weight` (v keeps the weight's current value, g
    starts at 1, as the flax modules' `wn_g`). Returns `module`."""
    parametrize.register_parametrization(
        module, 'weight', WeightNorm(module.weight.shape[out_dim], out_dim), unsafe=True)
    return module


def is_weight_normalized(module: nn.Module) -> bool:
    return parametrize.is_parametrized(module, 'weight')


class Conv1x1(nn.Linear):
    """Pointwise conv == a dense layer over the channel axis of (B, T, C). Class ids
    (an integer tensor) in place of their one-hot rows select the weight's columns:
    one_hot(ids) @ W.T adds zeros to one term, so the lookup is the same arithmetic
    without the (B, T, Q) one-hot tensor."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 weight_normalization: bool = False):
        super().__init__(in_features, out_features, bias)
        if weight_normalization:
            weight_normalize(self)

    def forward(self, x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
        if x.is_floating_point():
            return cast_forward(self, x, dtype)
        y = F.embedding(x, self.weight.t().to(dtype))
        return y + self.bias.to(dtype) if self.bias is not None else y


class CausalConv1D(nn.Conv1d):
    """Left-padded dilated conv over (B, T, C); weight (out, in, kernel_size)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dilation: int = 1, bias: bool = True, weight_normalization: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, dilation=dilation,
                         bias=bias)
        if weight_normalization:
            weight_normalize(self)

    def forward(self, x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
        pad = (self.kernel_size[0] - 1) * self.dilation[0]
        y = cast_forward(self, F.pad(x.transpose(1, 2).to(dtype), (pad, 0)), dtype)
        return y.transpose(1, 2)


class ResidualConv1DGLU(nn.Module):
    """Dilated causal conv + GLU + conditioning 1x1s (local `conv1x1c`, global
    `conv1x1g`) + residual/skip 1x1s; in training, dropout on the layer's input
    (`modules.py:178-190`)."""

    def __init__(self, residual_channels: int, gate_channels: int, kernel_size: int,
                 skip_out_channels: int, cin_channels: int = -1, dilation: int = 1,
                 bias: bool = True, residual_legacy: bool = True, gin_channels: int = -1,
                 dropout: float = 0.05, weight_normalization: bool = False):
        super().__init__()
        self.residual_legacy = residual_legacy
        self.dropout = dropout
        wn = weight_normalization
        self.conv = CausalConv1D(residual_channels, gate_channels, kernel_size,
                                 dilation, bias, wn)
        self.conv1x1c = (Conv1x1(cin_channels, gate_channels, bias, wn)
                         if cin_channels > 0 else None)
        self.conv1x1g = (Conv1x1(gin_channels, gate_channels, bias, wn)
                         if gin_channels > 0 else None)
        half = gate_channels // 2
        self.conv1x1_out = Conv1x1(half, residual_channels, bias, wn)
        self.conv1x1_skip = Conv1x1(half, skip_out_channels, bias, wn)

    def dropout_mask(self, shape, generator: torch.Generator) -> Tensor:
        """A keep mask (bool) drawn as the JAX module draws it: 16 random bits an
        element, kept where they fall below round(keep * 65536), at most 65535, so the
        keep probability is a multiple of 1/65536."""
        threshold = min(65535, round((1.0 - self.dropout) * 65536.0))
        bits = torch.randint(0, 65536, tuple(shape), generator=generator,
                             device=generator.device)
        return bits < threshold

    def _outputs(self, conv_out: Tensor, c_proj: Optional[Tensor], g_proj: Optional[Tensor],
                 residual: Tensor, dtype: torch.dtype = torch.float32
                 ) -> Tuple[Tensor, Tensor]:
        """GLU of the conv output plus the projected conditionings, then the residual
        and skip 1x1s."""
        a, b = conv_out.chunk(2, dim=-1)
        for proj in (c_proj, g_proj):
            if proj is not None:
                pa, pb = proj.chunk(2, dim=-1)
                a, b = a + pa, b + pb
        gated = torch.tanh(a) * sigmoid(b)
        s = self._project(self.conv1x1_skip, gated, dtype)
        out = self._project(self.conv1x1_out, gated, dtype) + residual
        if self.residual_legacy:
            out = out * weak(math.sqrt(0.5), out.dtype)
        return out, s

    def forward(self, x: Tensor, c: Optional[Tensor], g: Optional[Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                mask: Optional[Tensor] = None, dtype: torch.dtype = torch.float32
                ) -> Tuple[Tensor, Tensor]:
        """x (B, T, R); c (B, T, cin) or None; g (B, T, gin) or None. With `train` and
        dropout > 0 the conv's input (not the residual) keeps the elements of `mask`
        (bool, x's shape; drawn from `generator` when None), scaled by 1 / keep, the
        nominal keep probability as in the JAX module (`modules.py:187`). Every conv
        runs in `dtype`. Returns (x_out (B, T, R), skip (B, T, S))."""
        residual = x
        x = self._dropout(x, train, generator, mask)
        return self._outputs(self.conv(x, dtype),
                             self.conv1x1c(c, dtype) if c is not None else None,
                             self.conv1x1g(g, dtype) if g is not None else None, residual,
                             dtype)

    def _project(self, conv: 'Conv1x1', gated: Tensor, dtype: torch.dtype) -> Tensor:
        """The skip or residual 1x1 of the gated activations."""
        return conv(gated, dtype)

    def _dropout(self, x: Tensor, train: bool, generator: Optional[torch.Generator],
                 mask: Optional[Tensor]) -> Tensor:
        if not (train and self.dropout > 0):
            return x
        if mask is None:
            if generator is None:
                raise ValueError('dropout in training needs a generator or a mask')
            mask = self.dropout_mask(x.shape, generator)
        return torch.where(mask, x / weak(1.0 - self.dropout, x.dtype),
                           torch.zeros((), device=x.device, dtype=x.dtype))

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


class _Cast:
    """A torch conv whose forward takes the compute dtype (a module call, so that the
    weight-norm init's hooks see it)."""

    def forward(self, x: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
        return cast_forward(self, x, dtype)


class Conv2d(_Cast, nn.Conv2d):
    pass


class ConvTranspose1d(_Cast, nn.ConvTranspose1d):
    pass


class ConvTranspose2d(_Cast, nn.ConvTranspose2d):
    pass


UPSAMPLE_TYPES = ('NearestNeighbor', '1D', '2D', 'Resize', 'SubPixel')
UPSAMPLE_ACTIVATIONS = ('Relu', 'LeakyRelu', None)


class UpsampleNetwork(nn.Module):
    """mel (B, Tc, cin) -> (B, Tc*hop, cin), one layer a scale s of upsample_scales, the
    activation after each (`modules.py:310-397` of the JAX package):

      - NearestNeighbor: each frame repeated hop times; no layer, no activation.
      - 1D: a transpose conv over time of kernel s and stride s, cin channels to cin.
      - 2D, Resize and SubPixel see the mel as an image, H = mel bins, W = time, one
        channel. 2D: a transpose conv (freq_axis_kernel_size, s) of stride (1, s).
        Resize: each column repeated s times, then a SAME conv (freq_axis_kernel_size,
        s). SubPixel: a SAME conv (freq_axis_kernel_size, 3) from 1 to s channels, then
        the periodic shuffle (B, H, W, s) -> (B, H, W*s).

    lax's SAME pads an even kernel (k-1)//2 before and k//2 after, as torch's 'same'
    does. The transpose convs reproduce `jax.lax.conv_transpose(..., 'SAME')` with
    `transpose_kernel=False`: a correlation of the stride-dilated input with the kernel
    as it is. torch's transpose conv correlates with the kernel flipped, so `convert.py`
    stores the flax kernel flipped. Kernel s and stride s need no padding; the 2D layer
    pads (fk-1)/2 on each side in frequency for an odd fk and s-1 in time, so it runs
    unpadded and crops the frequency axis to lax's padding."""

    def __init__(self, upsample_scales: Sequence[int], freq_axis_kernel_size: int = 3,
                 upsample_type: str = 'SubPixel', activation: Optional[str] = 'Relu',
                 leaky_alpha: float = 0.4, cin_channels: int = 80,
                 weight_normalization: bool = False):
        super().__init__()
        if upsample_type not in UPSAMPLE_TYPES:
            raise ValueError(f'unknown upsample_type {upsample_type!r}')
        if activation not in UPSAMPLE_ACTIVATIONS:
            raise ValueError(f'unknown upsample_activation {activation!r}')
        self.upsample_type = upsample_type
        self.activation = activation
        self.leaky_alpha = leaky_alpha
        self.scales = tuple(upsample_scales)
        fk = freq_axis_kernel_size
        layer = {'NearestNeighbor': None,
                 '1D': lambda s: ConvTranspose1d(cin_channels, cin_channels, s, stride=s),
                 '2D': lambda s: ConvTranspose2d(1, 1, (fk, s), stride=(1, s)),
                 'Resize': lambda s: Conv2d(1, 1, (fk, s), padding='same'),
                 'SubPixel': lambda s: Conv2d(1, s, (fk, 3), padding='same')}[upsample_type]
        self.convs = nn.ModuleList(layer(s) for s in self.scales) if layer else nn.ModuleList()
        if weight_normalization:  # a transpose conv's weight is (in, out, ...)
            for conv in self.convs:
                weight_normalize(conv, out_dim=1 if upsample_type in ('1D', '2D') else 0)
        # lax's SAME transpose padding in frequency (stride 1) is ceil((fk-1)/2) before
        # and floor((fk-1)/2) after; the unpadded ConvTranspose2d pads fk-1 on each
        # side, so the rest is cropped
        self._crop = ((fk - 1) // 2, fk // 2)

    def crop(self, y: Tensor) -> Tensor:
        """A 2D layer's output cut to lax's SAME padding; any other layer's as it is."""
        if self.upsample_type != '2D':
            return y
        return y[:, :, self._crop[0]:y.shape[2] - self._crop[1]]

    def _act(self, x: Tensor) -> Tensor:
        if self.activation == 'Relu':
            return torch.relu(x)
        if self.activation == 'LeakyRelu':
            return F.leaky_relu(x, weak(self.leaky_alpha, x.dtype))
        return x

    def forward(self, c: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
        """c (B, Tc, cin) -> (B, Tc*hop, cin), in `dtype` but for NearestNeighbor, which
        returns c's own dtype."""
        if self.upsample_type == 'NearestNeighbor':
            return c.repeat_interleave(math.prod(self.scales), dim=1)
        if self.upsample_type == '1D':
            x = c.transpose(1, 2)                          # (B, cin, T)
            for conv in self.convs:
                x = self._act(conv(x, dtype))
            return x.transpose(1, 2)
        B = c.shape[0]
        x = c.transpose(1, 2)[:, None]                     # (B, 1, H, W)
        for conv, s in zip(self.convs, self.scales):
            if self.upsample_type == 'Resize':
                x = conv(x.repeat_interleave(s, dim=3), dtype)
            elif self.upsample_type == '2D':               # (B, 1, H + fk - 1, W*s)
                x = self.crop(conv(x, dtype))
            else:                                          # (B, s, H, W)
                y = conv(x, dtype)
                _, _, H, W = y.shape
                x = y.permute(0, 2, 3, 1).reshape(B, 1, H, W * s)
            x = self._act(x)
        return x[:, 0].transpose(1, 2)                     # (B, T*hop, cin)
