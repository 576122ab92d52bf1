"""WaveNet vocoder (counterpart of `tacotron2_tpu/models/wavenet/model.py`).

The teacher-forced forward pass runs the whole utterance in parallel, for evaluation
or, with `train=True`, with dropout for training; `compute_wavenet_loss` scores it
against the audio one step ahead. Autoregressive
generation runs on packed weights in `ops/wavenet_ar.py` (the kernel and its plain
version); `incremental` here is the sample-by-sample loop over the unpacked f32
modules, which shares no packing with the kernel: its oracle, and the path for what
the kernel does not take (teacher forcing, no local conditioning). Covered: raw,
mu-law and mu-law-quantized (one-hot) input, local conditioning with each of the five
upsamplers and their activations, global conditioning on speaker ids or embeddings.
The teacher-forced pass runs in the compute dtype it is given (`models/precision.py`):
each conv in it, the output float32 (`model.py:135`).
"""

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...ops.mulaw import is_mulaw_quantize, is_scalar_input
from ..precision import weak
from . import distributions as dist
from .modules import Conv1x1, Embedding, ResidualConv1DGLU, UpsampleNetwork


class WaveNet(nn.Module):
    """`block` builds each residual layer (a ResidualConv1DGLU; the tensor-parallel
    step passes its own, `parallel/tensor_parallel.py`)."""

    def __init__(self, hp, block: Callable[..., ResidualConv1DGLU] = ResidualConv1DGLU):
        super().__init__()
        if hp.layers % hp.stacks != 0:
            raise ValueError('layers must be a multiple of stacks')
        self.hp = hp
        lps = hp.layers // hp.stacks
        in_channels = 1 if is_scalar_input(hp.input_type) else hp.quantize_channels
        wn = hp.wavenet_weight_normalization
        self.first_conv = Conv1x1(in_channels, hp.residual_channels, hp.use_bias, wn)
        self.residual_layers = nn.ModuleList(
            block(hp.residual_channels, hp.gate_channels, hp.kernel_size,
                              hp.skip_out_channels, hp.cin_channels, 2 ** (i % lps),
                              hp.use_bias, hp.residual_legacy, hp.gin_channels,
                              hp.wavenet_dropout, wn)
            for i in range(hp.layers))
        self.skip_conv1 = Conv1x1(hp.skip_out_channels, hp.skip_out_channels, hp.use_bias, wn)
        self.skip_conv2 = Conv1x1(hp.skip_out_channels, hp.out_channels, hp.use_bias, wn)
        self.gc_embedding = (Embedding(hp.n_speakers, hp.gin_channels, 0.1)
                             if hp.gin_channels > 0 and hp.use_speaker_embedding else None)
        self.upsample = (UpsampleNetwork(hp.upsample_scales, hp.freq_axis_kernel_size,
                                         hp.upsample_type, hp.upsample_activation,
                                         hp.leaky_alpha, hp.cin_channels, wn)
                         if hp.cin_channels > 0 else None)

    def embed_global(self, g: Optional[Tensor]) -> Optional[Tensor]:
        """Speaker ids (B,) -> embeddings (B, gin); embeddings pass through when the
        model has no table; None without global conditioning."""
        if g is None or self.hp.gin_channels <= 0:
            return None
        if self.gc_embedding is not None:
            return self.gc_embedding(g.long())
        return g

    def upsample_conditioning(self, c: Tensor) -> Tensor:
        """mel (B, Tc, cin) -> (B, Tc*hop, cin)."""
        return self.upsample(c)

    def encode_input(self, y: Tensor) -> Tensor:
        """Audio (B, T), raw or mu-law floats or class ids -> network input
        (B, T, in_channels): the scalar, or the one-hot of quantize_channels classes."""
        if is_scalar_input(self.hp.input_type):
            return y[..., None].float()
        return F.one_hot(y.long(), self.hp.quantize_channels).float()

    def _skip_sum(self, skips: Optional[Tensor], s: Tensor) -> Tensor:
        if skips is None:
            return s  # the first skip enters unscaled
        skips = skips + s
        return skips * weak(math.sqrt(0.5), skips.dtype) if self.hp.legacy else skips

    def _head(self, skips: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
        return self.skip_conv2(torch.relu(self.skip_conv1(torch.relu(skips), dtype)),
                               dtype).float()

    def forward(self, x: Tensor, c: Optional[Tensor] = None, g: Optional[Tensor] = None,
                c_is_upsampled: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Sequence[Tensor]] = None,
                dtype: torch.dtype = torch.float32) -> Tensor:
        """Teacher-forced parallel pass.

        Args:
            x: (B, T, in_channels) network input (`encode_input` of the audio, one
                step behind its target); for one-hot input also the (B, T) class ids
                themselves (an integer tensor), which the first conv looks up without
                building the (B, T, Q) one-hot tensor.
            c: (B, Tc, cin) mel conditioning, or (B, T, cin) if c_is_upsampled.
            g: (B,) speaker ids or (B, gin) embeddings.
            train: apply dropout to every layer's input (hp.wavenet_dropout), the keep
                masks drawn from `generator` (on x's device) or given as
                `dropout_masks`, one bool (B, T, R) tensor a layer.
            dtype: the compute dtype of every conv, the upsampler's included.
        Returns: (B, T, out_channels) distribution params, float32.
        """
        B, T = x.shape[0], x.shape[1]
        if c is not None and self.upsample is not None:
            if not c_is_upsampled:
                c = self.upsample(c, dtype)
            if c.shape[1] != T:
                raise ValueError(f'upsampled c length {c.shape[1]} != audio {T}')
        g_emb = self.embed_global(g)
        g_seq = g_emb[:, None, :].expand(B, T, -1) if g_emb is not None else None
        h = self.first_conv(x, dtype)
        skips = None
        for i, layer in enumerate(self.residual_layers):
            h, s = layer(h, c, g_seq, train, generator,
                         dropout_masks[i] if dropout_masks is not None else None, dtype)
            skips = self._skip_sum(skips, s)
        return self._head(skips, dtype)

    @torch.no_grad()
    def incremental(self, c: Optional[Tensor] = None, g: Optional[Tensor] = None,
                    synthesis_length: Optional[int] = None,
                    initial_input: Optional[Tensor] = None,
                    targets: Optional[Tensor] = None, noise: Optional[Tensor] = None,
                    generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """Autoregressive generation, one sample at a time over the f32 modules
        (counterpart of `incremental`, `model.py:138-292`).

        Args:
            c: (B, Tc, cin) mel conditioning; the synthesis length is Tc * hop.
            g: (B,) speaker ids or (B, gin) embeddings.
            synthesis_length: required when c is None.
            initial_input: optional (B,) first input (default: silence, 0.0, or class
                quantize_channels // 2 for one-hot input).
            targets: optional (B, T) audio or class ids fed back in place of the samples
                (teacher forcing).
            noise: optional sampling noise, (B, T) standard normal for the Gaussian
                head, (B, T, nr+1) for MoL, (B, T, Q) Gumbel for the categorical (the
                layouts of `ops/wavenet_ar.make_noise`); drawn from `generator` per
                step when None.
        Returns: dict with 'audio' (B, T), floats in [-1, 1] or int64 class ids, and
            'params' (B, T, out_channels).
        """
        hp = self.hp
        dev = self.first_conv.weight.device
        if c is not None and self.upsample is not None:
            c_up = self.upsample(c)
            B, T = c_up.shape[0], c_up.shape[1]
        else:
            c_up = None
            if synthesis_length is None:
                raise ValueError('synthesis_length is required without conditioning')
            T = synthesis_length
            B = (g.shape[0] if g is not None else
                 targets.shape[0] if targets is not None else 1)
        quantized = is_mulaw_quantize(hp.input_type)
        g_emb = self.embed_global(g)
        # global conditioning is time-invariant: projected once for the utterance
        g_projs = [layer.conv1x1g(g_emb) if g_emb is not None else None
                   for layer in self.residual_layers]
        k, R = hp.kernel_size, hp.residual_channels
        lps = hp.layers // hp.stacks
        dils = [2 ** (i % lps) for i in range(hp.layers)]
        buffers = [torch.zeros(B, (k - 1) * d, R, device=dev) for d in dils]
        if initial_input is not None:
            prev = initial_input
        elif quantized:
            prev = torch.full((B,), hp.quantize_channels // 2, dtype=torch.long, device=dev)
        else:
            prev = torch.zeros(B, device=dev)
        audio = torch.empty(B, T, dtype=torch.long if quantized else torch.float32,
                            device=dev)
        params = torch.empty(B, T, hp.out_channels, device=dev)
        for t in range(T):
            h = self.first_conv(self.encode_input(prev[:, None])[:, 0])
            skips = None
            for li, (layer, buf, d) in enumerate(zip(self.residual_layers, buffers, dils)):
                # ring buffer: tap x(t-m) lives at slot (t - m) mod size; slots not
                # written yet hold the zero init, the causal left padding
                size = (k - 1) * d
                past = [buf[:, (t + size - (k - 1 - j) * d) % size] for j in range(k - 1)]
                taps = torch.stack(past + [h], dim=1)
                if k > 1:
                    buf[:, t % size] = h  # slot of x(t-size), read just above
                c_proj = layer.conv1x1c(c_up[:, t]) if c_up is not None else None
                h, s = layer.incremental_step(taps, c_proj, g_projs[li])
                skips = self._skip_sum(skips, s)
            params_t = self._head(skips)
            noise_t = noise[:, t] if noise is not None else None
            if quantized:
                sample = dist.sample_from_categorical(params_t, noise_t, generator)
            elif hp.out_channels == 2:
                sample = dist.sample_from_gaussian(params_t, hp.log_scale_min_gauss,
                                                   noise_t, generator)
            else:
                sample = dist.sample_from_discretized_mix_logistic(
                    params_t, hp.log_scale_min, noise_t, generator)
            if targets is not None:
                sample = targets[:, t].to(sample.dtype)
            audio[:, t] = sample
            params[:, t] = params_t
            prev = sample
        return dict(audio=audio, params=params)


def compute_wavenet_loss(hp, y_hat: Tensor, y: Tensor, mask: Optional[Tensor],
                         group=None) -> Tensor:
    """One-sample-shifted NLL (counterpart of `compute_wavenet_loss`,
    `model.py:295-308`): the prediction at t scores target t+1. y_hat (B, T, out); y
    (B, T) audio or class ids; mask (B, T), shifted with the targets. With a data
    `group`, the mean's denominator counts every rank's rows."""
    y_hat_s, y_s = y_hat[:, :-1], y[:, 1:]
    mask_s = mask[:, 1:] if mask is not None else None
    if is_mulaw_quantize(hp.input_type):
        return dist.masked_cross_entropy_loss(y_hat_s, y_s, mask_s, group)
    if hp.out_channels == 2:
        return dist.gaussian_mle_loss(y_hat_s, y_s, hp.quantize_channels,
                                      hp.log_scale_min_gauss, hp.cdf_loss, mask_s, group)
    return dist.discretized_mix_logistic_loss(y_hat_s, y_s, hp.quantize_channels,
                                              hp.log_scale_min, mask_s, group)
