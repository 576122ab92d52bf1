"""The Tacotron decoder over time (counterpart of `tacotron2_tpu/ops/fused_decoder.py`
and of the `nn.scan` / `nn.while_loop` decoder of `tacotron2_tpu/models/tacotron/model.py`).

Each step (`_step`): prenet (dropout on) -> decoder_layers zoneout LSTMs -> location-
sensitive attention -> frame and stop projections, at any prenet and LSTM depth.

`synthesis_scan` runs free: the model's own last frame is fed back, zoneout takes its
expectation, steps run in chunks of `chunk`, and decoding stops before a chunk once
every sequence's stop token has fired. Stop logits of unvisited steps read 1e3
("already stopped").

`decoder_scan` is the teacher-forced decoder under autograd: the contract of the JAX
`decoder_scan` (`fused_decoder.py:424-443`) with its forward (`_step_fwd`, `_forward`),
at any prenet and LSTM depth. The model runs it where the JAX model runs its `nn.scan`
decoder (fused_decoder off, or another depth than 2 prenet layers and 2 LSTMs); where
the JAX model runs its fused decoder, the port runs `ops/decoder_vjp.fused_decoder_scan`,
the JAX package's hand-written VJP (residuals saved, one reverse loop, the weight
gradients as a few large matmuls after it) with the step's hand-written kernels. With
`remat` each step is recomputed in the backward (`torch.utils.checkpoint`) instead of
keeping its activations, as `remat_decoder` has `nn.remat` do to the JAX scan cell: less
memory, the same values.

In a reduced compute `dtype` the casting points are the JAX fused decoder's
(`fused_decoder.py:500-562`): the LSTM states and the context carry in `dtype`, the
alignment state, the fed-back frame and the step's outputs in float32; the cell's
weights cast once a scan (`precast`), as that decoder's `_weights` casts them; and where that
decoder folds the location conv into the location layer (`_augment_loc_weights`: a
batch of at most 96 and a folded matrix within its 8 MiB budget), the port folds it
too, once a scan, so that the rounding is the same. At float32 it keeps the conv.
"""

import functools
from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from ..models.precision import cast_forward, precast
from ..models.tacotron.attention import constraint_mask

LOC_MAT_BYTES = 8 * 1024 * 1024  # the JAX fused decoder's budget for the folded matrix


def _location(cell, B: int, T_in: int, dtype: torch.dtype):
    """The folded location conv where the JAX fused decoder folds it in `dtype`, else
    None; its values rounded to `dtype` and held in float32, so that the steps' gradients
    of it sum in float32. With the conv in its place the bf16 decoder's gradients leave
    the bound of tests/test_torch_compute_dtype.py::test_bf16_decoder_scan_matches_jax
    (1.01e-2 of 1e-2, 5.7e-3 with the fold)."""
    D = cell.attention.v_a.shape[1]
    itemsize = torch.finfo(dtype).bits // 8
    if dtype == torch.float32 or B > 96 or T_in * T_in * D * itemsize > LOC_MAT_BYTES:
        return None
    return tuple(t.float() for t in cell.attention.folded_location(T_in, dtype))


def _initial_carry(cell, keys: Tensor, values: Tensor, dtype: torch.dtype = torch.float32):
    """((c, h) of each LSTM, context, attention state, previous alignment argmax) at
    zero."""
    B, T_in, dev = keys.shape[0], keys.shape[1], keys.device
    lstm = tuple(l.initial_state(B, dev, dtype) for l in cell.lstms)
    return (lstm, torch.zeros(B, values.shape[-1], device=dev, dtype=dtype),
            torch.zeros(B, T_in, device=dev), torch.zeros(B, dtype=torch.long, device=dev))


def _step(cell, keys: Tensor, values: Tensor, mask: Optional[Tensor], carry,
          dec_in: Tensor, masks: Sequence[Tensor],
          keeps: Optional[Sequence[Tensor]] = None,
          constraint: Optional[Tuple[str, int]] = None,
          dtype: torch.dtype = torch.float32, location=None):
    """One decoder step (`fused_decoder.py:341-380, 658-720`) of the model's DecoderCell
    `cell`, which holds the weights: the prenet on the input frame `dec_in` (B,
    num_mels) with its dropout masks, one a layer, pre-scaled by 1/keep; the LSTMs
    under zoneout, its expectation where `keeps` is None, else the step's keep-gates, c
    and h of each LSTM in turn; the attention, its mask narrowed by the synthesis-time
    `constraint` (None, or (constraint_type, win_size)), its location conv folded
    where `location` gives it (`_location`); the frame and stop projections.
    Returns (carry, frames (B, M*r), stop logits (B, r), alignments (B, T_in)), the
    outputs float32."""
    lstm, ctx, state, max_att = carry
    x = torch.cat([cell.prenet(dec_in, masks, dtype), ctx], dim=-1)
    new_lstm = []
    for i, (layer, hc) in enumerate(zip(cell.lstms, lstm, strict=True)):
        kc, kh = (None, None) if keeps is None else keeps[2 * i:2 * i + 2]
        hc, x = layer(hc, x, kc, kh, dtype)
        new_lstm.append(hc)

    att_mask = mask
    if constraint is not None:
        win = constraint_mask(max_att, keys.shape[1], *constraint)
        att_mask = win if mask is None else mask * win
    ctx, align, state, max_att = cell.attention(x, state, max_att, keys, values, att_mask,
                                                dtype, location)
    ctx = ctx.to(dtype)
    proj_in = torch.cat([x, ctx], dim=-1)
    return ((tuple(new_lstm), ctx, state, max_att),
            cast_forward(cell.frame_projection, proj_in, dtype).float(),
            cast_forward(cell.stop_projection, proj_in, dtype).float(), align)


def decoder_scan(cell, keys: Tensor, values: Tensor, mask: Optional[Tensor],
                 teacher: Tensor, use_teacher: Tensor, masks: Sequence[Tensor],
                 zo: Optional[Sequence[Tensor]], dtype: torch.dtype = torch.float32,
                 remat: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Teacher-forced decoder over T steps, differentiable by autograd.

    Args:
        cell: the model's DecoderCell (its weights and zoneout rates).
        keys: (B, T_in, D) memory projection; values: (B, T_in, M_enc) encoder outputs;
            mask: (B, T_in) float memory mask or None.
        teacher: (T, B, num_mels) teacher frames (the GO frame first).
        use_teacher: (T,) float 0/1: step t reads teacher[t] where 1, else the last
            frame the decoder predicted.
        masks: the prenet dropout masks, one (T, B, units) a prenet layer, pre-scaled
            by 1/keep.
        zo: None (zoneout's expectation) or the keep-gates of training, two (T, B, U)
            bool tensors an LSTM, c then h (a state takes its new value where its gate
            holds, else keeps the old one: `fused_decoder.py:352-373`).
        dtype: the compute dtype.
        remat: recompute each step in the backward instead of keeping its activations.
    Returns: (frames (T, B, M*r), stops (T, B, r), alignments (T, B, T_in)), float32.
    """
    carry = _initial_carry(cell, keys, values, dtype)
    prev = torch.zeros(keys.shape[0], cell.num_mels, device=keys.device)
    gates = None if zo is None else [g.bool() for g in zo]
    # the steps read the keys only in the f32 energy sum: held in f32 (the same values),
    # their gradient sums over the steps in f32, as the JAX fused backward's dkeys does
    keys = keys.float()
    step = functools.partial(_step, cell, keys, values, mask,
                             location=_location(cell, keys.shape[0], keys.shape[1], dtype))
    if remat and torch.is_grad_enabled():  # the step draws nothing: no RNG state to keep
        step = functools.partial(checkpoint, step, use_reentrant=False,
                                 preserve_rng_state=False)
    frames, stops, aligns = [], [], []
    with precast(cell, dtype):
        for t in range(teacher.shape[0]):
            dec_in = torch.where(use_teacher[t] > 0, teacher[t], prev)
            carry, f, st, align = step(carry, dec_in, [m[t] for m in masks],
                                       None if gates is None else [g[t] for g in gates],
                                       dtype=dtype)
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
                   masks: Optional[Sequence[Tensor]] = None):
    """Chunked free-running decode with early exit (fused_decoder.py:723-787).

    The prenet masks are drawn from `generator` one chunk at a time, layer after layer,
    so only decoded chunks draw them; or they come in through `masks`, one (T, B,
    units) tensor a prenet layer, pre-scaled by 1/keep, covering T =
    ceil(max_iters/chunk)*chunk steps.

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
    units = [layer.out_features for layer in cell.prenet.layers]
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
            chunk_masks = [m[sl].to(dev) for m in masks]
        else:
            chunk_masks = [prenet_masks((chunk, B, u), keep, generator, dev) for u in units]
        for s in range(chunk):
            carry, f, st, a = _step(cell, keys, values, mask, carry, prev,
                                    [m[s] for m in chunk_masks], constraint=constraint)
            hit = torch.sigmoid(st) > 0.5
            finished = finished | (hit.any(dim=-1) if cell.stop_at_any else hit.all(dim=-1))
            prev = f[:, -cell.num_mels:]
            frames[i * chunk + s] = f
            stops[i * chunk + s] = st
            aligns[i * chunk + s] = a
    return frames, stops, aligns, finished
