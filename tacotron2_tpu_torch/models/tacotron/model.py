"""Tacotron-2 spectrogram prediction, synthesis path (counterpart of the synthesis
branch of `tacotron2_tpu/models/tacotron/model.py`).

inputs (B, T_in) -> embedding -> encoder convs -> BiZoneoutLSTM -> memory mask and
attention keys -> free-running fused decoder -> clip -> postnet + projection -> clip.
The CBHG linear post-net (predict_linear) is not ported yet.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import Tensor, nn

from ...ops import fused_decoder as fd
from ...text import VOCAB_SIZE
from .attention import LocationSensitiveAttention
from .modules import BiZoneoutLSTM, EncoderConvolutions, Postnet, Prenet, ZoneoutLSTMCell


def output_range(hp) -> Tuple[float, float]:
    """T2_output_range (model.py:29-33)."""
    if hp.symmetric_mels:
        return (-hp.max_abs_value, hp.max_abs_value)
    return (0.0, hp.max_abs_value)


def _clip_outputs(x: Tensor, hp) -> Tensor:
    lo, hi = output_range(hp)
    return torch.clamp(x, lo - hp.lower_bound_decay, hi)


class DecoderCell(nn.Module):
    """The decoder's weights: prenet, two zoneout LSTMs, attention, frame and stop
    projections. The step itself is `ops/fused_decoder._step_synth`."""

    def __init__(self, hp, encoder_dim: int):
        super().__init__()
        if len(tuple(hp.prenet_layers)) != 2 or hp.decoder_layers != 2:
            raise NotImplementedError('the decoder covers 2 prenet layers and 2 LSTMs')
        U = hp.decoder_lstm_units
        self.num_mels = hp.num_mels
        self.stop_at_any = hp.stop_at_any
        self.prenet = Prenet(hp.num_mels, tuple(hp.prenet_layers))
        z = hp.tacotron_zoneout_rate
        self.lstm_1 = ZoneoutLSTMCell(hp.prenet_layers[-1] + encoder_dim, U, z, z)
        self.lstm_2 = ZoneoutLSTMCell(U, U, z, z)
        self.attention = LocationSensitiveAttention(
            U, hp.attention_dim, hp.attention_filters, hp.attention_kernel[0],
            hp.cumulative_weights, hp.smoothing)
        self.frame_projection = nn.Linear(U + encoder_dim, hp.num_mels * hp.outputs_per_step)
        self.stop_projection = nn.Linear(U + encoder_dim, hp.outputs_per_step)


class Tacotron(nn.Module):
    def __init__(self, hp):
        super().__init__()
        self.hp = hp
        enc_dim = 2 * hp.encoder_lstm_units
        self.inputs_embedding = nn.Embedding(VOCAB_SIZE, hp.embedding_dim)
        self.encoder_convolutions = EncoderConvolutions(
            hp.embedding_dim, hp.enc_conv_num_layers, hp.enc_conv_kernel_size[0],
            hp.enc_conv_channels, hp.batch_norm_position)
        self.encoder_lstm = BiZoneoutLSTM(hp.enc_conv_channels, hp.encoder_lstm_units,
                                          hp.tacotron_zoneout_rate)
        self.attention_memory_layer = nn.Linear(enc_dim, hp.attention_dim, bias=False)
        self.decoder = DecoderCell(hp, enc_dim)
        self.postnet_convolutions = Postnet(hp.num_mels, hp.postnet_num_layers,
                                            hp.postnet_kernel_size[0], hp.postnet_channels,
                                            hp.batch_norm_position)
        self.postnet_projection = nn.Linear(hp.postnet_channels, hp.num_mels)

    @torch.no_grad()
    def forward(self, inputs: Tensor, input_lengths: Tensor,
                max_iters: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Tuple[Tensor, Tensor]] = None) -> Dict[str, Tensor]:
        """Free-running synthesis.

        Args:
            inputs: (B, T_in) int character ids.
            input_lengths: (B,) int.
            max_iters: decoder steps (default hp.max_iters).
            generator: draws the prenet dropout masks.
            masks: optional explicit prenet masks, see fused_decoder.synthesis_scan.
        Returns: dict with decoder_output and mel_outputs (B, T*r, num_mels),
            stop_token_prediction (B, T*r), alignments (B, T_in, T), stop_finished (B,).
        """
        hp = self.hp
        B, T_in = inputs.shape
        r = hp.outputs_per_step
        if max_iters is None:
            max_iters = hp.max_iters
        embedded = self.inputs_embedding(inputs.long())
        enc = self.encoder_convolutions(embedded)
        encoder_outputs = self.encoder_lstm(enc, input_lengths)

        memory_mask = (torch.arange(T_in, device=inputs.device)[None, :]
                       < input_lengths.to(inputs.device)[:, None]).float()
        if hp.mask_encoder:
            values = encoder_outputs * memory_mask[..., None]
            attn_mask = memory_mask
        else:
            values = encoder_outputs
            attn_mask = None
        keys = self.attention_memory_layer(values)

        chunk = max(1, min(hp.decoder_chunk_size, max_iters))
        constraint = ((hp.synthesis_constraint_type, hp.attention_win_size)
                      if hp.synthesis_constraint else None)
        frames, stop_logits, alignments, finished = fd.synthesis_scan(
            self.decoder, keys, values, attn_mask, max_iters, chunk,
            hp.tacotron_dropout_rate, generator, constraint, masks)
        T_steps = frames.shape[0]

        # (T_steps, B, M*r) -> (B, T_steps*r, M)
        decoder_output = frames.transpose(0, 1).reshape(B, T_steps * r, hp.num_mels)
        stop_token_prediction = stop_logits.transpose(0, 1).reshape(B, T_steps * r)
        alignments = alignments.permute(1, 2, 0)
        if hp.clip_outputs:
            decoder_output = _clip_outputs(decoder_output, hp)
        residual = self.postnet_convolutions(decoder_output)
        mel_outputs = decoder_output + self.postnet_projection(residual)
        if hp.clip_outputs:
            mel_outputs = _clip_outputs(mel_outputs, hp)
        return dict(decoder_output=decoder_output, mel_outputs=mel_outputs,
                    stop_token_prediction=stop_token_prediction, alignments=alignments,
                    stop_finished=finished)
