"""Tacotron-2 spectrogram prediction (counterpart of
`tacotron2_tpu/models/tacotron/model.py`).

inputs (B, T_in) -> embedding -> encoder convs -> BiZoneoutLSTM -> memory mask and
attention keys -> decoder -> clip -> postnet + projection -> clip (-> CBHG -> linear
projection -> clip, with predict_linear).

`forward` is synthesis: the free-running decoder, no gradient, linear outputs only on
request (the eval and live modes of a model with the CBHG).
`teacher_forced` is the branch of training, evaluation and GTA (`model.py:176-254,
301-337`): the decoder reads the target frames with the step's coins, and every
random draw (dropout and zoneout keep-masks, prenet masks, coins) comes in through
`noise`, which `draw_noise` makes from a torch.Generator or a test builds from another
package's draws. `teacher_forced` runs in the compute dtype it is given
(`models/precision.py`): float32 in, float32 out, the casting points flax's.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import Tensor, nn

from ...ops import decoder_vjp, fused_decoder as fd
from ...text import VOCAB_SIZE
from ..precision import cast_forward
from .attention import LocationSensitiveAttention
from .modules import (CBHG, BiZoneoutLSTM, EncoderConvolutions, Postnet, Prenet,
                      ZoneoutLSTMCell, length_mask)


def output_range(hp) -> Tuple[float, float]:
    """T2_output_range (model.py:29-33)."""
    if hp.symmetric_mels:
        return (-hp.max_abs_value, hp.max_abs_value)
    return (0.0, hp.max_abs_value)


def _clip_outputs(x: Tensor, hp) -> Tensor:
    lo, hi = output_range(hp)
    return torch.clamp(x, lo - hp.lower_bound_decay, hi)


class DecoderCell(nn.Module):
    """The decoder's weights: prenet (len(hp.prenet_layers) layers), hp.decoder_layers
    zoneout LSTMs `lstm_1`, `lstm_2`, ... (flax's names), attention, frame and stop
    projections. The step itself is `ops/fused_decoder._step`."""

    def __init__(self, hp, encoder_dim: int):
        super().__init__()
        if hp.decoder_layers < 1 or not hp.prenet_layers:
            raise ValueError('the decoder needs a prenet layer and an LSTM')
        U = hp.decoder_lstm_units
        self.num_mels = hp.num_mels
        self.stop_at_any = hp.stop_at_any
        self.prenet = Prenet(hp.num_mels, tuple(hp.prenet_layers))
        z = hp.tacotron_zoneout_rate
        self.depth = hp.decoder_layers
        for i in range(self.depth):
            self.add_module(f'lstm_{i + 1}', ZoneoutLSTMCell(
                hp.prenet_layers[-1] + encoder_dim if i == 0 else U, U, z, z))
        self.attention = LocationSensitiveAttention(
            U, hp.attention_dim, hp.attention_filters, hp.attention_kernel[0],
            hp.cumulative_weights, hp.smoothing)
        self.frame_projection = nn.Linear(U + encoder_dim, hp.num_mels * hp.outputs_per_step)
        self.stop_projection = nn.Linear(U + encoder_dim, hp.outputs_per_step)

    @property
    def lstms(self):
        return [getattr(self, f'lstm_{i + 1}') for i in range(self.depth)]


class Tacotron(nn.Module):
    def __init__(self, hp):
        super().__init__()
        self.hp = hp
        enc_dim = 2 * hp.encoder_lstm_units
        drop = hp.tacotron_dropout_rate
        self.inputs_embedding = nn.Embedding(VOCAB_SIZE, hp.embedding_dim)
        self.encoder_convolutions = EncoderConvolutions(
            hp.embedding_dim, hp.enc_conv_num_layers, hp.enc_conv_kernel_size[0],
            hp.enc_conv_channels, hp.batch_norm_position, drop)
        self.encoder_lstm = BiZoneoutLSTM(hp.enc_conv_channels, hp.encoder_lstm_units,
                                          hp.tacotron_zoneout_rate)
        self.attention_memory_layer = nn.Linear(enc_dim, hp.attention_dim, bias=False)
        self.decoder = DecoderCell(hp, enc_dim)
        self.postnet_convolutions = Postnet(hp.num_mels, hp.postnet_num_layers,
                                            hp.postnet_kernel_size[0], hp.postnet_channels,
                                            hp.batch_norm_position, drop)
        self.postnet_projection = nn.Linear(hp.postnet_channels, hp.num_mels)
        self.cbhg_postnet = self.cbhg_linear_specs_projection = None
        if hp.predict_linear:
            self.cbhg_postnet = CBHG(
                hp.num_mels, hp.cbhg_kernels, hp.cbhg_conv_channels, hp.cbhg_pool_size,
                (hp.cbhg_projection, hp.num_mels), hp.cbhg_projection_kernel_size,
                hp.cbhg_highwaynet_layers, hp.cbhg_highway_units, hp.cbhg_rnn_units,
                hp.batch_norm_position)
            self.cbhg_linear_specs_projection = nn.Linear(2 * hp.cbhg_rnn_units,
                                                          hp.num_freq)

    def _encode(self, inputs: Tensor, input_lengths: Tensor, train: bool = False,
                noise: Optional[Dict] = None, dtype: torch.dtype = torch.float32):
        """(keys, values, attention mask) of the encoder's memory: the keys in `dtype`,
        the values float32."""
        hp = self.hp
        noise = noise or {}
        T_in = inputs.shape[1]
        embedded = self.inputs_embedding(inputs.long()).to(dtype)
        enc = self.encoder_convolutions(embedded, train, noise.get('encoder_convolutions'),
                                        dtype)
        encoder_outputs = self.encoder_lstm(enc, input_lengths, noise.get('encoder_lstm'),
                                            dtype)
        memory_mask = length_mask(input_lengths, T_in, inputs.device)
        if hp.mask_encoder:
            values = encoder_outputs * memory_mask[..., None]
            attn_mask = memory_mask
        else:
            values = encoder_outputs
            attn_mask = None
        return cast_forward(self.attention_memory_layer, values, dtype), values, attn_mask

    def _postnet(self, frames: Tensor, train: bool = False, keeps=None,
                 dtype: torch.dtype = torch.float32) -> Tuple[Tensor, Tensor]:
        """(decoder_output, mel_outputs) (B, T*r, M) of the decoder's (T, B, M*r)
        frames: clipped, and the post-net's residual added (and clipped); float32."""
        hp = self.hp
        T_steps, B = frames.shape[0], frames.shape[1]
        decoder_output = frames.transpose(0, 1).reshape(
            B, T_steps * hp.outputs_per_step, hp.num_mels)
        if hp.clip_outputs:
            decoder_output = _clip_outputs(decoder_output, hp)
        residual = self.postnet_convolutions(decoder_output.to(dtype), train, keeps, dtype)
        mel_outputs = decoder_output + cast_forward(self.postnet_projection, residual,
                                                    dtype).float()
        if hp.clip_outputs:
            mel_outputs = _clip_outputs(mel_outputs, hp)
        return decoder_output, mel_outputs

    def _linear(self, mel_outputs: Tensor, train: bool = False,
                dtype: torch.dtype = torch.float32) -> Tensor:
        """(B, T, num_freq) linear spectrogram of the CBHG post-net over the mels."""
        linear_outputs = cast_forward(
            self.cbhg_linear_specs_projection,
            self.cbhg_postnet(mel_outputs.to(dtype), None, train, dtype), dtype).float()
        if self.hp.clip_outputs:
            linear_outputs = _clip_outputs(linear_outputs, self.hp)
        return linear_outputs

    @torch.no_grad()
    def forward(self, inputs: Tensor, input_lengths: Tensor,
                max_iters: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Tuple[Tensor, Tensor]] = None,
                predict_linear: bool = False) -> Dict[str, Tensor]:
        """Free-running synthesis.

        Args:
            inputs: (B, T_in) int character ids.
            input_lengths: (B,) int.
            max_iters: decoder steps (default hp.max_iters).
            generator: draws the prenet dropout masks.
            masks: optional explicit prenet masks, one a layer, see
                fused_decoder.synthesis_scan.
            predict_linear: also run the CBHG post-net (the model must hold it).
        Returns: dict with decoder_output and mel_outputs (B, T*r, num_mels),
            stop_token_prediction (B, T*r), alignments (B, T_in, T), stop_finished (B,),
            and linear_outputs (B, T*r, num_freq) with predict_linear.
        """
        hp = self.hp
        B = inputs.shape[0]
        r = hp.outputs_per_step
        if max_iters is None:
            max_iters = hp.max_iters
        keys, values, attn_mask = self._encode(inputs, input_lengths)
        chunk = max(1, min(hp.decoder_chunk_size, max_iters))
        constraint = ((hp.synthesis_constraint_type, hp.attention_win_size)
                      if hp.synthesis_constraint else None)
        frames, stop_logits, alignments, finished = fd.synthesis_scan(
            self.decoder, keys, values, attn_mask, max_iters, chunk,
            hp.tacotron_dropout_rate, generator, constraint, masks)
        T_steps = frames.shape[0]
        decoder_output, mel_outputs = self._postnet(frames)
        out = dict(decoder_output=decoder_output, mel_outputs=mel_outputs,
                   stop_token_prediction=stop_logits.transpose(0, 1).reshape(B, T_steps * r),
                   alignments=alignments.permute(1, 2, 0), stop_finished=finished)
        if predict_linear:
            out['linear_outputs'] = self._linear(mel_outputs)
        return out

    def draw_noise(self, B: int, T_in: int, T_mel: int, generator: torch.Generator,
                   deterministic: bool, device) -> Dict:
        """Every random draw of one teacher-forced pass over a batch of B rows, T_in
        characters and T_mel target frames, from `generator` (on `device`), in a fixed
        order. `teacher_forced` reads:
          coins (T,) uniform, T = T_mel / r; m1, m2, ... (T, B, units) the prenet masks
          of layers 1, 2, ..., scaled by 1/keep; and unless `deterministic`:
          encoder_convolutions and postnet_convolutions, one bool dropout keep-mask
          (B, T, C) a block; encoder_lstm, the four (T_in, B, U) bool zoneout keep-masks
          (forward c, h, backward c, h); zo, the decoder's (T, B, U) bool keep-gates, c
          and h of each LSTM in turn.
        Dropout and zoneout at rate 0 draw nothing."""
        hp = self.hp
        T = T_mel // hp.outputs_per_step
        keep = 1.0 - hp.tacotron_dropout_rate
        zkeep = 1.0 - hp.tacotron_zoneout_rate

        def bern(p, *shape):
            return torch.rand(shape, generator=generator, device=device) < p

        noise = dict(coins=torch.rand(T, generator=generator, device=device))
        for i, units in enumerate(hp.prenet_layers):
            noise[f'm{i + 1}'] = fd.prenet_masks((T, B, units), keep, generator, device)
        if deterministic:
            return noise
        if keep < 1.0:
            noise['encoder_convolutions'] = [bern(keep, B, T_in, hp.enc_conv_channels)
                                             for _ in range(hp.enc_conv_num_layers)]
            noise['postnet_convolutions'] = [bern(keep, B, T_mel, hp.postnet_channels)
                                             for _ in range(hp.postnet_num_layers)]
        if zkeep < 1.0:
            noise['encoder_lstm'] = [bern(zkeep, T_in, B, hp.encoder_lstm_units)
                                     for _ in range(4)]
            noise['zo'] = [bern(zkeep, T, B, hp.decoder_lstm_units)
                           for _ in range(2 * hp.decoder_layers)]
        return noise

    def teacher_forced(self, inputs: Tensor, input_lengths: Tensor, mel_targets: Tensor,
                       noise: Dict, deterministic: bool = True,
                       teacher_forcing_ratio: Optional[float] = None,
                       predict_linear: Optional[bool] = None,
                       dtype: torch.dtype = torch.float32) -> Dict[str, Tensor]:
        """The network over a batch with its targets (`model.py:176-254, 301-337`).

        Args:
            inputs: (B, T_in) int character ids; input_lengths: (B,) int.
            mel_targets: (B, T_mel, num_mels), T_mel a multiple of r. The decoder's
                input at step t is the last frame of target group t - 1 (a zero GO
                frame at t = 0) where coins[t] < teacher_forcing_ratio (default
                hp.tacotron_teacher_forcing_ratio), else its own last frame.
            noise: the draws, as `draw_noise` makes them.
            deterministic: zoneout's expectation, BatchNorm over running statistics and
                no encoder or post-net dropout; the prenet's dropout stays on.
            predict_linear: override hp.predict_linear.
            dtype: the compute dtype.
        The decoder is `ops/decoder_vjp.fused_decoder_scan`, with its hand-written
        backward, where the JAX model runs its fused decoder (`use_fused`, `model.py:
        213-248`: hp.fused_decoder at 2 prenet layers and 2 LSTMs); elsewhere (the JAX
        model's `nn.scan` decoder) `ops/fused_decoder.decoder_scan` under autograd, each
        step recomputed in the backward with hp.remat_decoder (`model.py:199-205`).
        Returns: dict with decoder_output and mel_outputs (B, T_mel, num_mels),
            stop_token_prediction (B, T_mel), alignments (B, T_in, T), stop_finished
            (B,), and linear_outputs (B, T_mel, num_freq) with predict_linear.
        """
        hp = self.hp
        B = inputs.shape[0]
        r = hp.outputs_per_step
        train = not deterministic
        if predict_linear is None:
            predict_linear = hp.predict_linear
        if mel_targets.shape[1] % r:
            raise ValueError(f'mel targets of {mel_targets.shape[1]} frames: not a '
                             f'multiple of outputs_per_step={r}')
        T_steps = mel_targets.shape[1] // r
        keys, values, attn_mask = self._encode(inputs, input_lengths, train, noise, dtype)
        strided = mel_targets[:, r - 1::r, :].float()
        teacher = torch.cat([torch.zeros_like(strided[:, :1]), strided[:, :-1]],
                            dim=1).transpose(0, 1)
        if teacher_forcing_ratio is None:
            teacher_forcing_ratio = hp.tacotron_teacher_forcing_ratio
        use_teacher = (noise['coins'] < teacher_forcing_ratio).float()
        masks = [noise[f'm{i + 1}'] for i in range(len(hp.prenet_layers))]
        zo = noise.get('zo') if train else None
        if hp.fused_decoder and decoder_vjp.supports(hp):  # the JAX model's use_fused
            frames, stop_logits, alignments = decoder_vjp.fused_decoder_scan(
                self.decoder, keys, values, attn_mask, teacher, use_teacher, masks, zo, dtype)
        else:
            frames, stop_logits, alignments = fd.decoder_scan(
                self.decoder, keys, values, attn_mask, teacher, use_teacher, masks, zo, dtype,
                remat=hp.remat_decoder)
        with torch.no_grad():  # stop tracking, outside the gradient
            hit = torch.sigmoid(stop_logits) > 0.5
            hit = hit.any(dim=-1) if hp.stop_at_any else hit.all(dim=-1)
        decoder_output, mel_outputs = self._postnet(
            frames, train, noise.get('postnet_convolutions'), dtype)
        out = dict(decoder_output=decoder_output, mel_outputs=mel_outputs,
                   stop_token_prediction=stop_logits.transpose(0, 1).reshape(B, T_steps * r),
                   alignments=alignments.permute(1, 2, 0), stop_finished=hit.any(dim=0))
        if predict_linear:
            out['linear_outputs'] = self._linear(mel_outputs, train, dtype)
        return out
