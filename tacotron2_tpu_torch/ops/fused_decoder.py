"""Free-running Tacotron decoder (counterpart of the synthesis half of
`tacotron2_tpu/ops/fused_decoder.py`: `_step_synth` and `synthesis_scan`).

Each step: prenet (dropout on) -> LSTM x2 (zoneout expectation) -> location-sensitive
attention -> frame and stop projections, with the model's own last frame fed back.
Steps run in chunks of `chunk`; decoding stops before a chunk once every sequence's
stop token has fired. Stop logits of unvisited steps read 1e3 ("already stopped").
"""

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from ..models.tacotron.attention import constraint_mask


def _step_synth(cell, keys: Tensor, values: Tensor, mask: Optional[Tensor],
                constraint: Optional[Tuple[str, int]], carry, m1: Tensor, m2: Tensor):
    """One free-running decoder step (fused_decoder.py:658-720). `cell` is the
    model's DecoderCell, which holds the weights."""
    c1, h1, c2, h2, ctx, state, prev, max_att, finished = carry
    p2 = cell.prenet(prev, (m1, m2))
    (c1, h1), x1 = cell.lstm_1((c1, h1), torch.cat([p2, ctx], dim=-1))
    (c2, h2), x2 = cell.lstm_2((c2, h2), x1)

    att_mask = mask
    if constraint is not None:
        win = constraint_mask(max_att, keys.shape[1], *constraint)
        att_mask = win if mask is None else mask * win
    ctx, align, state, max_att = cell.attention(x2, state, max_att, keys, values, att_mask)

    proj_in = torch.cat([x2, ctx], dim=-1)
    frames = cell.frame_projection(proj_in)
    stops = cell.stop_projection(proj_in)
    hit = torch.sigmoid(stops) > 0.5
    hit = hit.any(dim=-1) if cell.stop_at_any else hit.all(dim=-1)
    carry = (c1, h1, c2, h2, ctx, state, frames[:, -cell.num_mels:], max_att,
             finished | hit)
    return carry, (frames, stops, align)


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
    U = cell.lstm_1.units
    p1, p2 = (layer.out_features for layer in cell.prenet.layers)
    zeros = torch.zeros(B, U, device=dev)
    carry = (zeros, zeros, zeros, zeros, torch.zeros(B, values.shape[-1], device=dev),
             torch.zeros(B, T_in, device=dev), torch.zeros(B, cell.num_mels, device=dev),
             torch.zeros(B, dtype=torch.long, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev))
    frames = torch.zeros(T_steps, B, cell.frame_projection.out_features, device=dev)
    stops = torch.full((T_steps, B, cell.stop_projection.out_features), 1e3, device=dev)
    aligns = torch.zeros(T_steps, B, T_in, device=dev)
    for i in range(n_chunks):
        if bool(carry[-1].all()):
            break
        sl = slice(i * chunk, (i + 1) * chunk)
        if masks is not None:
            m1, m2 = masks[0][sl].to(dev), masks[1][sl].to(dev)
        else:
            m1 = prenet_masks((chunk, B, p1), keep, generator, dev)
            m2 = prenet_masks((chunk, B, p2), keep, generator, dev)
        for s in range(chunk):
            carry, (f, st, a) = _step_synth(cell, keys, values, mask, constraint, carry,
                                            m1[s], m2[s])
            frames[i * chunk + s] = f
            stops[i * chunk + s] = st
            aligns[i * chunk + s] = a
    return frames, stops, aligns, carry[-1]
