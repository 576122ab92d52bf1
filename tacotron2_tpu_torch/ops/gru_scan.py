"""The CBHG's bidirectional GRU recurrence with a hand-written backward: the counterpart of the
JAX CBHG's `jax.lax.scan` over flax's GRUCell and of its autodiff
(`tacotron2_tpu/models/tacotron/modules.py:278-317`, `run`).

`gru_scan` takes, for each of one or two directions, the hoisted input projection ip
(B, T, 3H), W_hh (3H, H) and b_hn (H,), all in the recurrence's dtype, the (B, T) mask and,
where a direction is reversed, the lengths within which it reads its row backwards (the
reversed sequence of `modules.reverse_sequences`, by index). It returns both directions'
outputs side by side, (B, T, D H). With a gradient to take it runs `GRUScan`, a
`torch.autograd.Function`: its forward saves the residuals r, z, n, hn = W_hn h + b_hn and the
state before each step, hp, in the recurrence's dtype at each step's sequence position; its
backward walks the steps in reverse from them in float32 and gives dip and the hidden gate
gradients dg (float32); dW_hh is then one product dg^T hp over the B T rows and db_hn one sum,
both in float32 (in bf16 rounded once to the parameter's dtype, as `precision.precast` sums a
loop's weight gradient). Without one it runs the forward alone, saving nothing.

Both recurrences are hand-written kernels for Hopper (`csrc/gru_loop/gru_loop.cu`, built into
a library of their own by `_build.load_gru_loop_library`, float32 and bf16): `gru_fwd_loop`
runs all T steps of every direction in one launch, one CTA a (direction, row) with its W_hh
resident in shared memory, and `gru_bwd_loop` the reverse recurrence likewise. Where
`gru_loop_applies` (H = GRU_LOOP_UNITS on the card, float32 or bf16) the Function launches
them; elsewhere it runs their plain versions, `_gru_fwd_loop_plain` (the port's GRU loop as it
stood, step by step: `_gru_step_loop`) and `_gru_bwd_loop_plain` (`_gru_step_loop_bwd`), by
that predicate alone. Each wrapper launches its kernel on CUDA tensors (a failed build or
launch raises; there is no fallback), counts the launch in LAUNCHES, and runs its plain version
on CPU tensors.
"""

import collections
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ..models.precision import sigmoid
from ._loop_launch import check, launch, order as _order, refuse

# launches of each hand-written kernel, counted by its wrapper where it launches it
LAUNCHES: Dict[str, int] = collections.Counter()
KERNELS = ('gru_fwd_loop', 'gru_bwd_loop')

GRU_LOOP_UNITS = 128      # the kernels' one width (csrc/gru_loop/gru_loop.cu: H)
GRU_LOOP_MAX_DIRS = 2     # directions of one launch (MAX_DIRS)
RESIDUALS = ('r', 'z', 'n', 'hn', 'hp')   # the planes of a direction's residuals (Res)
# the entries' pointers in the order of the C enums FwdPtr and BwdPtr
_FWD_PTRS = ('ip0', 'ip1', 'w0', 'w1', 'b0', 'b1', 'mask', 'lengths', 'out', 'res0', 'res1')
_BWD_PTRS = ('dout', 'res0', 'res1', 'w0', 'w1', 'mask', 'lengths', 'dip0', 'dip1', 'dg0',
             'dg1')


def gru_loop_applies(H: int, dtype: torch.dtype, device) -> bool:
    """Whether the GRU's recurrence runs on the kernels: H = GRU_LOOP_UNITS units (the CBHG's
    default cbhg_rnn_units, whose W_hh fits one CTA's shared memory) in float32 or bf16 on
    the card. Elsewhere `GRUScan` runs the kernels' plain versions."""
    return (torch.device(device).type == 'cuda' and H == GRU_LOOP_UNITS
            and dtype in (torch.float32, torch.bfloat16))


def _library():
    from ._build import load_gru_loop_library
    return load_gru_loop_library()


library = _library  # the build whose kernels launch (chip_smoke.py plants faulty ones)
_refuse = functools.partial(refuse, 'GRU loop')
_check = functools.partial(check, 'GRU loop')


# ---------------------------------------------------------------- the plain versions

def _gru_step_loop(ip: Tensor, w: Tensor, b_hn: Tensor, mask: Tensor, save: bool = False):
    """One direction of the GRU step by step (the port's loop as it stood, op for op) over
    ip (B, T, 3H) in step order, W_hh `w` (3H, H) and b_hn in the recurrence's dtype and
    the (B, T) mask: r = sigmoid(ip_r + hh_r), z = sigmoid(ip_z + hh_z),
    n = tanh(ip_n + r (hh_n + b_hn)), h' = (1 - z) n + z h with hh = h W_hh^T; the state
    keeps h where the mask is not > 0, and the output is h times the mask. Returns (the
    outputs (B, T, H), with `save` the residuals (N_RES, B, T, H) of RESIDUALS in step order,
    else None)."""
    B, T, G = ip.shape
    H = G // 3
    Kh = w.t()
    h = torch.zeros(B, H, device=ip.device, dtype=w.dtype)
    mask = mask.to(w.dtype)
    outs, res = [], []
    for t in range(T):
        ip_t, hh = ip[:, t], h @ Kh
        r = sigmoid(ip_t[:, :H] + hh[:, :H])
        z = sigmoid(ip_t[:, H:2 * H] + hh[:, H:2 * H])
        hn = hh[:, 2 * H:] + b_hn
        n = torch.tanh(ip_t[:, 2 * H:] + r * hn)
        new_h = (1.0 - z) * n + z * h
        if save:
            res.append(torch.stack([r, z, n, hn, h]))
        m = mask[:, t, None]
        h = torch.where(m > 0, new_h, h)
        outs.append(h * m)
    return torch.stack(outs, dim=1), (torch.stack(res, dim=2) if save else None)


def _gru_step_loop_bwd(dout: Tensor, res: Tensor, w: Tensor, mask: Tensor):
    """The reverse recurrence of one direction in step order, as gru_bwd_loop computes it:
    from the output's gradient dout (B, T, H), `_gru_step_loop`'s residuals res, W_hh `w`
    (3H, H) and the mask, in float32 (the residuals widened). A step: g = dh + dout m; where
    m > 0 the step's h' takes it (dhp = g), else the state before it; dn = dhp (1 - z),
    dz = dhp (hp - n), da_n = dn (1 - n^2), da_z = dz z (1 - z), da_r = da_n hn r (1 - r);
    dh = dhp z (or g) + dg W_hh. Returns (dip = (da_r, da_z, da_n) (B, T, 3H) in res's
    dtype, dg = (da_r, da_z, da_n r) (B, T, 3H) float32)."""
    r, z, n, hn, hp = res.float().unbind(0)
    dout, mask, W = dout.float(), mask.float(), w.float()
    T = dout.shape[1]
    dh = torch.zeros_like(dout[:, 0])
    dips, dgs = [None] * T, [None] * T
    for t in reversed(range(T)):
        on = mask[:, t, None] > 0
        g = dh + dout[:, t] * mask[:, t, None]
        zero = torch.zeros_like(g)
        dhp = torch.where(on, g, zero)
        rt, zt, nt = r[:, t], z[:, t], n[:, t]
        dn = dhp * (1.0 - zt)
        dz = dhp * (hp[:, t] - nt)
        direct = torch.where(on, zero, g) + dhp * zt
        dan = dn * (1.0 - nt * nt)
        dhn = dan * rt
        daz = dz * (zt * (1.0 - zt))
        dar = (dan * hn[:, t]) * (rt * (1.0 - rt))
        dgs[t] = torch.cat([dar, daz, dhn], dim=-1)
        dips[t] = torch.cat([dar, daz, dan], dim=-1)
        dh = direct + dgs[t] @ W
    return torch.stack(dips, dim=1).to(res.dtype), torch.stack(dgs, dim=1)


def _planes(res: Tensor, lengths: Optional[Tensor], rev: bool) -> Tensor:
    return torch.stack([_order(x, lengths, rev) for x in res.unbind(0)])


def _gru_fwd_loop_plain(ips, ws, bs, mask, lengths, reverse, save: bool):
    """gru_fwd_loop's plain version: `_gru_step_loop` a direction, reversed directions read
    and written through `_order`."""
    outs, res = [], []
    for ip, w, b, rev in zip(ips, ws, bs, reverse, strict=True):
        out, R = _gru_step_loop(_order(ip, lengths, rev), w, b, mask, save)
        outs.append(_order(out, lengths, rev))
        res.append(None if R is None else _planes(R, lengths, rev))
    return torch.cat(outs, dim=-1), (res if save else None)


def _gru_bwd_loop_plain(dout, res, ws, mask, lengths, reverse):
    """gru_bwd_loop's plain version: `_gru_step_loop_bwd` a direction."""
    H = ws[0].shape[1]
    dips, dgs = [], []
    for d, (R, w, rev) in enumerate(zip(res, ws, reverse, strict=True)):
        dip, dg = _gru_step_loop_bwd(_order(dout[..., d * H:(d + 1) * H], lengths, rev),
                                     _planes(R, lengths, rev), w, mask)
        dips.append(_order(dip, lengths, rev))
        dgs.append(_order(dg, lengths, rev))
    return dips, dgs


# ---------------------------------------------------------------- the kernels' launches

def _prepared(B: int, T: int, dt: torch.dtype, dev, ws, mask, lengths, reverse):
    """The operands every launch takes checked against the build (GRU_LOOP_UNITS units, 1
    to GRU_LOOP_MAX_DIRS directions, float32 or bf16, B >= 1 and T >= 1, one device) and
    made contiguous: each W_hh on a 16-byte boundary, the mask float32, the lengths int32.
    Returns (ws, mask, lengths, the entry's ints (B, T, D, rev0, rev1, bf16))."""
    D, H = len(ws), GRU_LOOP_UNITS
    if not 1 <= D <= GRU_LOOP_MAX_DIRS or len(reverse) != D:
        _refuse(f'{D} directions with {len(reverse)} reverse flags (built for 1 to '
                f'{GRU_LOOP_MAX_DIRS})')
    if dt not in (torch.float32, torch.bfloat16) or B < 1 or T < 1:
        _refuse(f'B={B}, T={T} in {dt} (built for float32 or bf16, B >= 1, T >= 1)')
    _check('W_hh', ws, (3 * H, H), dt, dev)
    if mask.shape != (B, T) or mask.device != dev:
        _refuse(f'a mask of shape {tuple(mask.shape)} on {mask.device}, where {(B, T)} on '
                f'{dev} is due')
    if any(reverse) and (lengths is None or lengths.shape != (B,)):
        _refuse('a reversed direction without the (B,) lengths')
    ws = [w.contiguous() for w in ws]
    rev = [int(bool(r)) for r in reverse] + [0] * (GRU_LOOP_MAX_DIRS - D)
    return ([w if w.data_ptr() % 16 == 0 else w.clone() for w in ws], mask.float().contiguous(),
            None if lengths is None else lengths.to(dev, torch.int32).contiguous(),
            (B, T, D, *rev, int(dt == torch.bfloat16)))


def gru_fwd_loop(ips: Sequence[Tensor], ws: Sequence[Tensor], bs: Sequence[Tensor],
                 mask: Tensor, lengths: Optional[Tensor], reverse: Sequence[bool],
                 save: bool) -> Tuple[Tensor, Optional[List[Tensor]]]:
    """The forward recurrence of every direction: ip (B, T, 3H), W_hh (3H, H) and b_hn (H,) a
    direction in the recurrence's dtype, the (B, T) mask, the (B,) lengths (needed where a
    direction is `reverse`d). Returns (the outputs (B, T, D H), with `save` the residuals of
    each direction (N_RES, B, T, H) at the sequence positions, else None). On CUDA tensors one
    launch of csrc/gru_loop/gru_loop.cu (GRU_LOOP_UNITS units, float32 or bf16), counted in
    LAUNCHES as gru_fwd_loop; anything else raises. On CPU tensors the plain version."""
    if not ips[0].is_cuda:
        return _gru_fwd_loop_plain(ips, ws, bs, mask, lengths, reverse, save)
    B, T, G = ips[0].shape
    H, dt, dev = GRU_LOOP_UNITS, ips[0].dtype, ips[0].device
    _check('ip', ips, (B, T, 3 * H), dt, dev)
    _check('b_hn', bs, (H,), dt, dev)
    ws, mask, lengths, ints = _prepared(B, T, dt, dev, ws, mask, lengths, reverse)
    D = len(ips)
    out = ips[0].new_empty(B, T, D * H)
    res = [ips[0].new_empty(len(RESIDUALS), B, T, H) for _ in range(D)] if save else None
    t = dict(mask=mask, lengths=lengths, out=out)
    for d in range(D):
        t.update({f'ip{d}': ips[d].contiguous(), f'w{d}': ws[d], f'b{d}': bs[d].contiguous(),
                  f'res{d}': res[d] if save else None})
    launch(library(), LAUNCHES, 'gru_fwd_loop', t, _FWD_PTRS, ints, ips[0].device)
    return out, res


def gru_bwd_loop(dout: Tensor, res: Sequence[Tensor], ws: Sequence[Tensor], mask: Tensor,
                 lengths: Optional[Tensor], reverse: Sequence[bool]):
    """The reverse recurrence of every direction from the outputs' gradient dout (B, T, D H)
    and gru_fwd_loop's residuals, W_hh, the mask and the lengths as it had them. Returns
    (dip (B, T, 3H) a direction in the recurrence's dtype, dg (B, T, 3H) a direction in
    float32). On CUDA tensors one launch of csrc/gru_loop/gru_loop.cu, counted in LAUNCHES as
    gru_bwd_loop; anything else raises. On CPU tensors the plain version."""
    if not dout.is_cuda:
        return _gru_bwd_loop_plain(dout, res, ws, mask, lengths, reverse)
    D, H = len(res), GRU_LOOP_UNITS
    B, T = dout.shape[:2]
    dt, dev = res[0].dtype, res[0].device
    _check('residuals', res, (len(RESIDUALS), B, T, H), dt, dev)
    _check('dout', [dout], (B, T, D * H), dt, dev)
    ws, mask, lengths, ints = _prepared(B, T, dt, dev, ws, mask, lengths, reverse)
    t = dict(dout=dout.contiguous(), mask=mask, lengths=lengths)
    dips = [torch.empty(B, T, 3 * H, device=dev, dtype=dt) for _ in range(D)]
    dgs = [torch.empty(B, T, 3 * H, device=dev, dtype=torch.float32) for _ in range(D)]
    for d in range(D):
        t.update({f'res{d}': res[d].contiguous(), f'w{d}': ws[d], f'dip{d}': dips[d],
                  f'dg{d}': dgs[d]})
    launch(library(), LAUNCHES, 'gru_bwd_loop', t, _BWD_PTRS, ints, dev)
    return dips, dgs


# ---------------------------------------------------------------- the Function

def _fwd(ips, ws, bs, mask, lengths, reverse, save):
    if gru_loop_applies(ws[0].shape[1], ips[0].dtype, ips[0].device):
        return gru_fwd_loop(ips, ws, bs, mask, lengths, reverse, save)
    return _gru_fwd_loop_plain(ips, ws, bs, mask, lengths, reverse, save)


def _bwd(dout, res, ws, mask, lengths, reverse):
    if gru_loop_applies(ws[0].shape[1], res[0].dtype, res[0].device):
        return gru_bwd_loop(dout, res, ws, mask, lengths, reverse)
    return _gru_bwd_loop_plain(dout, res, ws, mask, lengths, reverse)


def weight_grads(dg: Tensor, res: Tensor) -> Tuple[Tensor, Tensor]:
    """(dW_hh (3H, H), db_hn (H,)) of one direction in float32 from its hidden gate
    gradients dg (B, T, 3H) and its residuals: one product dg^T hp and one sum over the
    B T rows."""
    G, H = dg.shape[-1], res.shape[-1]
    dg = dg.reshape(-1, G)
    return dg.t() @ res[-1].reshape(-1, H).float(), dg[:, 2 * H:].sum(0)


class GRUScan(torch.autograd.Function):
    """The GRU's recurrence of one or two directions with its hand-written backward:
    `GRUScan.apply(mask, lengths, reverse, ip0, w0, b0[, ip1, w1, b1])` (gru_scan's
    operands). The mask and the lengths get no gradient."""

    @staticmethod
    def forward(ctx, mask, lengths, reverse, *operands):
        ips, ws, bs = operands[0::3], operands[1::3], operands[2::3]
        out, res = _fwd(ips, ws, bs, mask, lengths, reverse, True)
        ctx.reverse = reverse
        ctx.save_for_backward(mask, lengths, *ws, *res)
        return out

    @staticmethod
    def backward(ctx, dout):
        mask, lengths, *saved = ctx.saved_tensors
        D = len(ctx.reverse)
        ws, res = saved[:D], saved[D:]
        dips, dgs = _bwd(dout.contiguous(), res, ws, mask, lengths, ctx.reverse)
        grads = []
        for dip, dg, w, R in zip(dips, dgs, ws, res, strict=True):
            dw, db = weight_grads(dg, R)
            grads += [dip, dw.to(w.dtype), db.to(w.dtype)]
        return (None, None, None, *grads)


def gru_scan(ips: Sequence[Tensor], ws: Sequence[Tensor], bs: Sequence[Tensor], mask: Tensor,
             lengths: Optional[Tensor], reverse: Sequence[bool]) -> Tensor:
    """The GRU of each direction (ip (B, T, 3H), W_hh (3H, H) and b_hn (H,) in the
    recurrence's dtype; `reverse`d ones over each row's first lengths[b] steps backwards)
    over the (B, T) mask: (B, T, D H), the directions side by side. Through `GRUScan` where a
    gradient is to be taken, else the forward alone, saving nothing."""
    operands = [x for trio in zip(ips, ws, bs, strict=True) for x in trio]
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        return GRUScan.apply(mask, lengths, tuple(reverse), *operands)
    return _fwd(ips, ws, bs, mask, lengths, reverse, False)[0]
