"""The Tacotron decoder over time (counterpart of `tacotron2_tpu/ops/fused_decoder.py`).

Each step (`_step`): prenet (dropout on) -> LSTM x2 (zoneout) -> location-sensitive
attention -> frame and stop projections.

`synthesis_scan` runs free: the model's own last frame is fed back, zoneout takes its
expectation, steps run in chunks of `chunk`, and decoding stops before a chunk once
every sequence's stop token has fired. Stop logits of unvisited steps read 1e3
("already stopped").

`decoder_scan` is the teacher-forced decoder of training, evaluation and GTA: the
contract of the JAX `decoder_scan` (`fused_decoder.py:424-443`) with its forward
(`_step_fwd`, `_forward`). Its backward is autograd over the step loop; the JAX
package's hand-written VJP (residuals saved, the weight gradients as a few large
matmuls after the reverse loop) is not ported.
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from ..models.tacotron.attention import constraint_mask


def _initial_carry(cell, keys: Tensor, values: Tensor):
    """(c1, h1, c2, h2, context, attention state, previous alignment argmax) at zero."""
    B, T_in, dev = keys.shape[0], keys.shape[1], keys.device
    zeros = torch.zeros(B, cell.lstm_1.units, device=dev)
    return (zeros, zeros, zeros, zeros, torch.zeros(B, values.shape[-1], device=dev),
            torch.zeros(B, T_in, device=dev), torch.zeros(B, dtype=torch.long, device=dev))


def _step(cell, keys: Tensor, values: Tensor, mask: Optional[Tensor], carry,
          dec_in: Tensor, m1: Tensor, m2: Tensor,
          keeps: Optional[Sequence[Tensor]] = None,
          constraint: Optional[Tuple[str, int]] = None):
    """One decoder step (`fused_decoder.py:341-380, 658-720`) of the model's DecoderCell
    `cell`, which holds the weights: the prenet on the input frame `dec_in` (B,
    num_mels) with its dropout masks m1, m2 pre-scaled by 1/keep; the two LSTMs under
    zoneout, its expectation where `keeps` is None, else the step's four bool keep-gates
    of c1, h1, c2, h2; the attention, its mask narrowed by the synthesis-time
    `constraint` (None, or (constraint_type, win_size)); the frame and stop projections.
    Returns (carry, frames (B, M*r), stop logits (B, r), alignments (B, T_in))."""
    c1, h1, c2, h2, ctx, state, max_att = carry
    kc1, kh1, kc2, kh2 = (None,) * 4 if keeps is None else keeps
    p2 = cell.prenet(dec_in, (m1, m2))
    (c1, h1), x1 = cell.lstm_1((c1, h1), torch.cat([p2, ctx], dim=-1), kc1, kh1)
    (c2, h2), x2 = cell.lstm_2((c2, h2), x1, kc2, kh2)

    att_mask = mask
    if constraint is not None:
        win = constraint_mask(max_att, keys.shape[1], *constraint)
        att_mask = win if mask is None else mask * win
    ctx, align, state, max_att = cell.attention(x2, state, max_att, keys, values, att_mask)

    proj_in = torch.cat([x2, ctx], dim=-1)
    return ((c1, h1, c2, h2, ctx, state, max_att), cell.frame_projection(proj_in),
            cell.stop_projection(proj_in), align)


def decoder_scan(cell, keys: Tensor, values: Tensor, mask: Optional[Tensor],
                 teacher: Tensor, use_teacher: Tensor, m1: Tensor, m2: Tensor,
                 zo: Optional[Sequence[Tensor]]) -> Tuple[Tensor, Tensor, Tensor]:
    """Teacher-forced decoder over T steps, differentiable by autograd.

    Args:
        cell: the model's DecoderCell (its weights and zoneout rates).
        keys: (B, T_in, D) memory projection; values: (B, T_in, M_enc) encoder outputs;
            mask: (B, T_in) float memory mask or None.
        teacher: (T, B, num_mels) teacher frames (the GO frame first).
        use_teacher: (T,) float 0/1: step t reads teacher[t] where 1, else the last
            frame the decoder predicted.
        m1, m2: (T, B, prenet units) prenet dropout masks, pre-scaled by 1/keep.
        zo: None (zoneout's expectation) or the four (T, B, U) bool keep-gates of
            training, c1, h1, c2, h2 (a state takes its new value where its gate holds,
            else keeps the old one: `fused_decoder.py:352-373`).
    Returns: (frames (T, B, M*r), stops (T, B, r), alignments (T, B, T_in)).
    """
    carry = _initial_carry(cell, keys, values)
    prev = torch.zeros(keys.shape[0], cell.num_mels, device=keys.device)
    gates = None if zo is None else [g.bool() for g in zo]
    frames, stops, aligns = [], [], []
    for t in range(teacher.shape[0]):
        dec_in = torch.where(use_teacher[t] > 0, teacher[t], prev)
        carry, f, st, align = _step(cell, keys, values, mask, carry, dec_in, m1[t], m2[t],
                                    None if gates is None else [g[t] for g in gates])
        frames.append(f)
        stops.append(st)
        aligns.append(align)
        prev = f[:, -cell.num_mels:]
    return torch.stack(frames), torch.stack(stops), torch.stack(aligns)


def prenet_masks(shape: Sequence[int], keep: float, generator: Optional[torch.Generator],
                 device) -> Tensor:
    """Dropout keep-mask scaled by 1/keep, or ones when keep == 1."""
    if keep >= 1.0:
        return torch.ones(*shape, device=device)
    probs = torch.full(tuple(shape), keep, device=device)
    return torch.bernoulli(probs, generator=generator) / keep


@torch.no_grad()
def synthesis_scan(cell, keys: Tensor, values: Tensor, mask: Optional[Tensor],
                   max_iters: int, chunk: int, dropout_rate: float,
                   generator: Optional[torch.Generator] = None,
                   constraint: Optional[Tuple[str, int]] = None,
                   masks: Optional[Tuple[Tensor, Tensor]] = None):
    """Chunked free-running decode with early exit (fused_decoder.py:723-787).

    The prenet masks are drawn from `generator` one chunk at a time, so only decoded
    chunks draw them; or they come in through `masks` = (m1 (T, B, prenet1),
    m2 (T, B, prenet2)), pre-scaled by 1/keep, covering T = ceil(max_iters/chunk)*chunk
    steps.

    Args:
        keys: (B, T_in, D) memory projection; values: (B, T_in, M_enc); mask: (B, T_in).
        constraint: None, or (constraint_type, win_size) for the synthesis-time window.
    Returns: (frames (T, B, M*r), stops (T, B, r), aligns (T, B, T_in), finished (B,)).
    """
    B, T_in = keys.shape[0], keys.shape[1]
    dev = keys.device
    n_chunks = -(-max_iters // chunk)
    T_steps = n_chunks * chunk
    keep = 1.0 - dropout_rate
    p1, p2 = (layer.out_features for layer in cell.prenet.layers)
    carry = _initial_carry(cell, keys, values)
    prev = torch.zeros(B, cell.num_mels, device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    frames = torch.zeros(T_steps, B, cell.frame_projection.out_features, device=dev)
    stops = torch.full((T_steps, B, cell.stop_projection.out_features), 1e3, device=dev)
    aligns = torch.zeros(T_steps, B, T_in, device=dev)
    for i in range(n_chunks):
        if bool(finished.all()):
            break
        sl = slice(i * chunk, (i + 1) * chunk)
        if masks is not None:
            m1, m2 = masks[0][sl].to(dev), masks[1][sl].to(dev)
        else:
            m1 = prenet_masks((chunk, B, p1), keep, generator, dev)
            m2 = prenet_masks((chunk, B, p2), keep, generator, dev)
        for s in range(chunk):
            carry, f, st, a = _step(cell, keys, values, mask, carry, prev, m1[s], m2[s],
                                    constraint=constraint)
            hit = torch.sigmoid(st) > 0.5
            finished = finished | (hit.any(dim=-1) if cell.stop_at_any else hit.all(dim=-1))
            prev = f[:, -cell.num_mels:]
            frames[i * chunk + s] = f
            stops[i * chunk + s] = st
            aligns[i * chunk + s] = a
    return frames, stops, aligns, finished
