"""The encoder's bidirectional zoneout-LSTM recurrence with a hand-written backward: the
counterpart of the JAX `BiZoneoutLSTM`'s `jax.lax.scan` and of its autodiff
(`tacotron2_tpu/models/tacotron/modules.py:136-206`, `run`).

`lstm_scan` takes, for each of one or two directions, the hoisted input half of the gate
product xp (B, T, 4U) in the direction's step order (a reversed direction's is the input half
of its reversed sequence, as the JAX scan hoists it) and W_hh (U, 4U), the hidden half of
the gate kernel (z = xp + h W_hh, the gates ordered i, g, f, o), both in the compute dtype,
the (B,) lengths, zoneout's keep-masks of training (c and h, each (T, B, U) bool and indexed
by the direction's own scan step) or None for its expectation, the rates (zoneout_cell,
zoneout_output) and whether the direction is reversed (its steps run backwards within each
row's length, its output written where each step's input was). The state, and so the step,
runs in the recurrence's dtype (the encoder's input's, float32 in the model: BatchNorm's
output). It returns both directions' outputs h_new * mask side by side at the sequence
positions, (B, T, D U).

With a gradient to take it runs `LSTMScan`, a `torch.autograd.Function`: its forward saves
the residuals of RESIDUALS at each step (sigma(i), tanh(g), sigma(f + 1), sigma(o), the state
c before the step, tanh(c_new) and the state h before it) in the recurrence's dtype; its
backward walks the steps in reverse from them in float32 and gives the gate gradients dz
(B, T, 4U, float32, step order), which are xp's gradient (rounded once to xp's dtype), and
dW_hh in float32, rounded once to W_hh's dtype (as autograd's cast rounds the step loop's
float32 sum): after the kernel one product h_prev^T dz over the B T rows, in the plain
version summed step by step as autograd summed it. Without one it runs the forward alone,
saving nothing.

Both recurrences are hand-written kernels for Hopper (`csrc/lstm_loop/lstm_loop.cu`, built
into a library of their own by `_build.load_lstm_loop_library`): `lstm_fwd_loop` runs all T
steps of every direction in one launch, one cluster of LSTM_LOOP_CLUSTER CTAs a (direction,
group of rows) with W_hh split by units over the cluster's shared memory and h exchanged
through distributed shared memory, and `lstm_bwd_loop` the reverse recurrence likewise.
Where `lstm_loop_applies` (U = LSTM_LOOP_UNITS on the card, a float32 recurrence, W_hh in
float32 or bf16) the Function launches them; elsewhere it runs their plain versions,
`_lstm_fwd_loop_plain` (the port's step loop as it stood, op for op: `_lstm_step_loop`) and
`_lstm_bwd_loop_plain` (`_lstm_step_loop_bwd`), by that predicate alone. Each wrapper
launches its kernel on CUDA tensors (a failed build or launch raises; there is no
fallback), counts the launch in LAUNCHES, and runs its plain version on CPU tensors.
"""

import collections
import ctypes
import functools
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ..models.precision import sigmoid
from ._loop_launch import check, launch, order as _order, refuse

# launches of each hand-written kernel, counted by its wrapper where it launches it
LAUNCHES: Dict[str, int] = collections.Counter()
KERNELS = ('lstm_fwd_loop', 'lstm_bwd_loop')

LSTM_LOOP_UNITS = 256       # the kernels' one width (csrc/lstm_loop/lstm_loop.cu: U)
LSTM_LOOP_MAX_DIRS = 2      # directions of one launch (MAX_DIRS)
LSTM_LOOP_CLUSTER = 8       # CTAs of a cluster, each holding U / 8 units' gate columns (N)
LSTM_LOOP_ROWS = (1, 2, 4, 8)   # the rows a cluster may run, one instantiation each (ROWS)
# the planes of a direction's residuals (Res): sigma(i), tanh(g), sigma(f + 1), sigma(o),
# c before the step, tanh(c_new), h before the step
RESIDUALS = ('si', 'tg', 'sf', 'so', 'c', 'tc', 'h')
# the entries' pointers in the order of the C enums FwdPtr and BwdPtr
_FWD_PTRS = ('xp0', 'xp1', 'w0', 'w1', 'lengths', 'kc0', 'kh0', 'kc1', 'kh1', 'out', 'res0',
             'res1')
_BWD_PTRS = ('dout', 'res0', 'res1', 'w0', 'w1', 'lengths', 'kc0', 'kh0', 'kc1', 'kh1', 'dz0',
             'dz1')


def lstm_loop_applies(U: int, dtype: torch.dtype, w_dtype: torch.dtype, device) -> bool:
    """Whether the encoder LSTM's recurrence runs on the kernels: U = LSTM_LOOP_UNITS units
    (encoder_lstm_units at the default hparams and the paper profile), a float32 recurrence
    `dtype` (the state's), W_hh and xp in `w_dtype` float32 or bf16, on the card. Elsewhere
    `LSTMScan` runs the kernels' plain versions."""
    return (torch.device(device).type == 'cuda' and U == LSTM_LOOP_UNITS
            and dtype == torch.float32 and w_dtype in (torch.float32, torch.bfloat16))


def _library():
    from ._build import load_lstm_loop_library
    return load_lstm_loop_library()


library = _library  # the build whose kernels launch (chip_smoke.py plants faulty ones)
_refuse = functools.partial(refuse, 'LSTM loop')
_check = functools.partial(check, 'LSTM loop')


# ---------------------------------------------------------------- the plain versions

def _zoneout(new: Tensor, old: Tensor, rate: float, keep: Optional[Tensor]) -> Tensor:
    from ..models.tacotron.modules import zoneout
    return zoneout(new, old, rate, keep)


def _lstm_step_loop(xp: Tensor, w: Tensor, mask: Tensor, keeps, zc: float, zh: float,
                    dtype: torch.dtype, save: bool = False):
    """One direction of the zoneout LSTM step by step (the port's loop as it stood, op for
    op) over xp (B, T, 4U) in step order, W_hh `w` (U, 4U), the (B, T) mask, the keep-masks
    (kc, kh) (T, B, U) of the steps or None, the rates zc, zh, the state in `dtype`:
    z = xp_t + h W_hh (W_hh in `dtype`), c_new = sigma(f + 1) c + sigma(i) tanh(g),
    h_new = sigma(o) tanh(c_new), c and h zoned out (`modules.zoneout`) and held where the
    mask is not > 0; the output is h_new times the mask. Returns (the outputs (B, T, U),
    with `save` the residuals (N_RES, B, T, U) of RESIDUALS in step order, else None)."""
    B, T, G = xp.shape
    Kh = w.to(dtype)
    c = h = torch.zeros(B, G // 4, device=xp.device, dtype=dtype)
    outs, res = [], []
    for t in range(T):
        i, g, f, o = (xp[:, t] + h @ Kh).chunk(4, dim=-1)
        sf, si, tg = sigmoid(f + 1.0), sigmoid(i), torch.tanh(g)
        c_new = sf * c + si * tg
        so = sigmoid(o)
        tc = torch.tanh(c_new)
        h_new = so * tc
        if save:
            res.append(torch.stack([si, tg, sf, so, c, tc, h]))
        kc, kh = (None, None) if keeps is None else (keeps[0][t], keeps[1][t])
        m = mask[:, t, None] > 0
        c = torch.where(m, _zoneout(c_new, c, zc, kc), c)
        h = torch.where(m, _zoneout(h_new, h, zh, kh), h)
        outs.append(h_new * mask[:, t, None])
    return torch.stack(outs, dim=1), (torch.stack(res, dim=2) if save else None)


def _lstm_step_loop_bwd(dout: Tensor, res: Tensor, w: Tensor, mask: Tensor, keeps,
                        zc: float, zh: float) -> Tuple[Tensor, Tensor]:
    """The reverse recurrence of one direction in step order, as lstm_bwd_loop computes it,
    op for op as autograd computes it through `_lstm_step_loop` on the CPU (so that this
    plain version is bit for bit the gradient of the loop it replaced): from the output's
    gradient dout (B, T, U), `_lstm_step_loop`'s residuals res, W_hh `w` (U, 4U), the mask
    and the keep-masks or None, the residuals widened to float32. A step from the carried
    gradients dc, dh of the state after it: where the step is on (mask > 0) zoneout passes
    dc to c_new where kc holds (or (1 - zc) dc) and the rest to the state before it (zc dc),
    likewise dh; off, all of it passes to the state before. dh_new = dout m + dh_z,
    dc_new = dc_z + tanh'(dh_new sigma(o)), and dz = (sigma'(dc_new tanh(g)),
    tanh'(dc_new sigma(i)), sigma'(dc_new c), sigma'(dh_new tanh(c_new))) with autograd's
    sigmoid_backward ((g (1 - y)) y) and tanh_backward (g (1 - y^2), 1 - y^2 one fused
    multiply-add); dc <- dc_direct + dc_new sigma(f + 1), dh <- dh_direct + dz W_hh^T.
    Returns (dz (B, T, 4U), dW_hh (U, 4U) summed step by step from the last, as autograd
    sums it over the loop), float32."""
    si, tg, sf, so, cp, tc, hp = res.float().unbind(0)
    dout, mask, W = dout.float(), mask.float(), w.float()
    sig_bwd, tanh_bwd = torch.ops.aten.sigmoid_backward, torch.ops.aten.tanh_backward
    T = dout.shape[1]
    dc = dh = torch.zeros_like(dout[:, 0])
    dzs, dW = [None] * T, None
    for t in reversed(range(T)):
        on = mask[:, t, None] > 0
        zero = torch.zeros_like(dc)
        gc, gh = torch.where(on, dc, zero), torch.where(on, dh, zero)
        if keeps is None:
            dcz, dcd = gc * (1.0 - zc), torch.where(on, zero, dc) + gc * zc
            dhz, dhd = gh * (1.0 - zh), torch.where(on, zero, dh) + gh * zh
        else:
            kc, kh = keeps[0][t], keeps[1][t]
            dcz = torch.where(kc, gc, zero)
            dcd = torch.where(on, zero, dc) + torch.where(kc, zero, gc)
            dhz = torch.where(kh, gh, zero)
            dhd = torch.where(on, zero, dh) + torch.where(kh, zero, gh)
        dhn = dout[:, t] * mask[:, t, None] + dhz
        dcn = dcz + tanh_bwd(dhn * so[:, t], tc[:, t])
        dzs[t] = torch.cat([sig_bwd(dcn * tg[:, t], si[:, t]), tanh_bwd(dcn * si[:, t], tg[:, t]),
                            sig_bwd(dcn * cp[:, t], sf[:, t]), sig_bwd(dhn * tc[:, t], so[:, t])],
                           dim=-1)
        g = hp[:, t].t().mm(dzs[t])
        dW = g if dW is None else dW + g
        dc = dcd + dcn * sf[:, t]
        dh = dhd + dzs[t].mm(W.t())
    return torch.stack(dzs, dim=1), dW


def _mask(lengths: Tensor, T: int, device) -> Tensor:
    from ..models.tacotron.modules import length_mask
    return length_mask(lengths, T, device)


def _lstm_fwd_loop_plain(xps, ws, lengths, keeps, rates, reverse, dtype, save: bool):
    """lstm_fwd_loop's plain version: `_lstm_step_loop` a direction over its xp in step
    order, a reversed direction's output written back to the sequence positions through
    `_order`; its residuals stay in step order."""
    T = xps[0].shape[1]
    mask = _mask(lengths, T, xps[0].device)
    outs, res = [], []
    for d, (xp, w, (zc, zh), rev) in enumerate(zip(xps, ws, rates, reverse, strict=True)):
        out, R = _lstm_step_loop(xp, w, mask, None if keeps is None else keeps[d], zc, zh,
                                 dtype, save)
        outs.append(_order(out, lengths, rev))
        res.append(R)
    return torch.cat(outs, dim=-1), (res if save else None)


def _lstm_bwd_loop_plain(dout, res, ws, lengths, keeps, rates, reverse):
    """lstm_bwd_loop's plain version: `_lstm_step_loop_bwd` a direction, a reversed
    direction's output gradient read from the sequence positions through `_order`.
    Returns ([dz (B, T, 4U) a direction in step order], [dW_hh a direction])."""
    U = ws[0].shape[0]
    mask = _mask(lengths, dout.shape[1], dout.device)
    dzs, dws = [], []
    for d, (R, w, (zc, zh), rev) in enumerate(zip(res, ws, rates, reverse, strict=True)):
        dz, dw = _lstm_step_loop_bwd(_order(dout[..., d * U:(d + 1) * U], lengths, rev), R, w,
                                     mask, None if keeps is None else keeps[d], zc, zh)
        dzs.append(dz)
        dws.append(dw)
    return dzs, dws


# ---------------------------------------------------------------- the kernels' launches

def _bits(x: float) -> int:
    """The float32 nearest x as the int of its bits (the C entry reads it back)."""
    return struct.unpack('<i', struct.pack('<f', x))[0]


_OCCUPANCY: Dict[Tuple, int] = {}


def occupancy(rows: int, bf16: bool, forward: bool) -> int:
    """Clusters of LSTM_LOOP_CLUSTER CTAs of the kernel (`forward` or reverse, W_hh in bf16
    or float32, `rows` rows a cluster) that the card keeps resident at once, from
    cudaOccupancyMaxActiveClusters (t2_lstm_loop_occupancy), once a build and shape."""
    lib = library()
    key = (id(lib), rows, bool(bf16), bool(forward))
    if key not in _OCCUPANCY:
        fn = lib.t2_lstm_loop_occupancy
        fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_int], ctypes.c_int
        n = fn(rows, int(bf16), int(forward))
        if n < 0:
            raise RuntimeError(f'the LSTM loop occupancy query failed: CUDA error {-n}')
        _OCCUPANCY[key] = n
    return _OCCUPANCY[key]


def rows_per_cluster(B: int, D: int, bf16: bool, forward: bool) -> int:
    """The rows each cluster runs: the fewest of LSTM_LOOP_ROWS (the least work a step)
    at which every cluster of the launch, D ceil(B / rows), is resident in one wave; the
    most where none is."""
    for rows in LSTM_LOOP_ROWS:
        if D * -(-B // rows) <= occupancy(rows, bf16, forward):
            return rows
    return LSTM_LOOP_ROWS[-1]


def _prepared(B: int, T: int, dt: torch.dtype, dev, ws, lengths, keeps, rates, reverse,
              forward: bool):
    """The operands every launch takes checked against the build (LSTM_LOOP_UNITS units, 1
    to LSTM_LOOP_MAX_DIRS directions, W_hh in float32 or bf16, B >= 1 and T >= 1, one
    device) and made contiguous: each W_hh on a 16-byte boundary, the lengths int32 on the
    device, the keep-masks (T, B, U) bool as uint8. Returns (tensors, the entry's ints)."""
    D, U = len(ws), LSTM_LOOP_UNITS
    if not 1 <= D <= LSTM_LOOP_MAX_DIRS or len(reverse) != D or len(rates) != D:
        _refuse(f'{D} directions with {len(reverse)} reverse flags and {len(rates)} rate '
                f'pairs (built for 1 to {LSTM_LOOP_MAX_DIRS})')
    if dt not in (torch.float32, torch.bfloat16) or B < 1 or T < 1:
        _refuse(f'B={B}, T={T} in {dt} (built for float32 or bf16, B >= 1, T >= 1)')
    _check('W_hh', ws, (U, 4 * U), dt, dev)
    if lengths.shape != (B,):
        _refuse(f'lengths of shape {tuple(lengths.shape)}, where {(B,)} is due')
    t = {'lengths': lengths.to(dev, torch.int32).contiguous()}
    for d, w in enumerate(ws):
        w = w.contiguous()
        t[f'w{d}'] = w if w.data_ptr() % 16 == 0 else w.clone()
    if keeps is not None:
        if len(keeps) != D:
            _refuse(f'keep-masks for {len(keeps)} directions of {D}')
        for d, pair in enumerate(keeps):
            _check('keep-mask', pair, (T, B, U), torch.bool, dev)
            t[f'kc{d}'], t[f'kh{d}'] = (k.contiguous().view(torch.uint8) for k in pair)
    rows = rows_per_cluster(B, D, dt == torch.bfloat16, forward)
    rev = [int(bool(r)) for r in reverse] + [0] * (LSTM_LOOP_MAX_DIRS - D)
    rate_bits = []
    for zc, zh in list(rates) + [(0.0, 0.0)] * (LSTM_LOOP_MAX_DIRS - D):
        rate_bits += [_bits(1.0 - zc), _bits(zc), _bits(1.0 - zh), _bits(zh)]
    return t, (B, T, D, *rev, int(dt == torch.bfloat16), rows, *rate_bits)


def lstm_fwd_loop(xps: Sequence[Tensor], ws: Sequence[Tensor], lengths: Tensor, keeps,
                  rates, reverse: Sequence[bool], dtype: torch.dtype,
                  save: bool) -> Tuple[Tensor, Optional[List[Tensor]]]:
    """The forward recurrence of every direction: xp (B, T, 4U) and W_hh (U, 4U) a
    direction in the compute dtype, the (B,) lengths, the keep-masks ((kc, kh) (T, B, U)
    bool a direction) or None, the rates (zc, zh) a direction, the reversed flags and the
    state's dtype. Returns (the outputs (B, T, D U) at the sequence positions, with `save`
    the residuals of each direction (N_RES, B, T, U) in its step order, else None). On CUDA
    tensors
    one launch of csrc/lstm_loop/lstm_loop.cu (LSTM_LOOP_UNITS units, a float32 state, W_hh
    in float32 or bf16), counted in LAUNCHES as lstm_fwd_loop; anything else raises. On CPU
    tensors the plain version."""
    if not xps[0].is_cuda:
        return _lstm_fwd_loop_plain(xps, ws, lengths, keeps, rates, reverse, dtype, save)
    B, T, _ = xps[0].shape
    U, dt, dev = LSTM_LOOP_UNITS, xps[0].dtype, xps[0].device
    if dtype != torch.float32:
        _refuse(f'a state in {dtype} (built for float32)')
    _check('xp', xps, (B, T, 4 * U), dt, dev)
    t, ints = _prepared(B, T, dt, dev, ws, lengths, keeps, rates, reverse, True)
    D = len(xps)
    out = torch.empty(B, T, D * U, device=dev, dtype=torch.float32)
    res = ([torch.empty(len(RESIDUALS), B, T, U, device=dev, dtype=torch.float32)
            for _ in range(D)] if save else None)
    t['out'] = out
    for d in range(D):
        t[f'xp{d}'] = xps[d].contiguous()
        t[f'res{d}'] = res[d] if save else None
    launch(library(), LAUNCHES, 'lstm_fwd_loop', t, _FWD_PTRS, ints, dev)
    return out, res


def lstm_bwd_loop(dout: Tensor, res: Sequence[Tensor], ws: Sequence[Tensor], lengths: Tensor,
                  keeps, rates, reverse: Sequence[bool]) -> Tuple[List[Tensor], List[Tensor]]:
    """The reverse recurrence of every direction from the outputs' gradient dout
    (B, T, D U) and lstm_fwd_loop's residuals, W_hh, the lengths, keep-masks and rates as it
    had them. Returns ([dz (B, T, 4U) a direction in float32 in its step order], [dW_hh
    (U, 4U) a direction in float32]). On CUDA tensors one launch of
    csrc/lstm_loop/lstm_loop.cu, counted in LAUNCHES as lstm_bwd_loop (anything else
    raises), then dW_hh one product a direction (`weight_grad`). On CPU tensors the plain
    version."""
    if not dout.is_cuda:
        return _lstm_bwd_loop_plain(dout, res, ws, lengths, keeps, rates, reverse)
    D, U = len(res), LSTM_LOOP_UNITS
    B, T = dout.shape[:2]
    dt, dev = ws[0].dtype, dout.device
    _check('residuals', res, (len(RESIDUALS), B, T, U), torch.float32, dev)
    _check('dout', [dout], (B, T, D * U), torch.float32, dev)
    t, ints = _prepared(B, T, dt, dev, ws, lengths, keeps, rates, reverse, False)
    dzs = [torch.empty(B, T, 4 * U, device=dev, dtype=torch.float32) for _ in range(D)]
    t['dout'] = dout.contiguous()
    for d in range(D):
        t[f'res{d}'], t[f'dz{d}'] = res[d].contiguous(), dzs[d]
    launch(library(), LAUNCHES, 'lstm_bwd_loop', t, _BWD_PTRS, ints, dev)
    return dzs, [weight_grad(dz, R) for dz, R in zip(dzs, res)]


# ---------------------------------------------------------------- the Function

def _applies(ws, dtype, device) -> bool:
    return lstm_loop_applies(ws[0].shape[0], dtype, ws[0].dtype, device)


def _fwd(xps, ws, lengths, keeps, rates, reverse, dtype, save):
    if _applies(ws, dtype, xps[0].device):
        return lstm_fwd_loop(xps, ws, lengths, keeps, rates, reverse, dtype, save)
    return _lstm_fwd_loop_plain(xps, ws, lengths, keeps, rates, reverse, dtype, save)


def _bwd(dout, res, ws, lengths, keeps, rates, reverse):
    if _applies(ws, res[0].dtype, dout.device):
        return lstm_bwd_loop(dout, res, ws, lengths, keeps, rates, reverse)
    return _lstm_bwd_loop_plain(dout, res, ws, lengths, keeps, rates, reverse)


def weight_grad(dz: Tensor, res: Tensor) -> Tensor:
    """dW_hh (U, 4U) of one direction in float32 from its gate gradients dz (B, T, 4U) and
    its residuals: one product h_prev^T dz over the B T rows."""
    U = res.shape[-1]
    return res[-1].reshape(-1, U).float().t() @ dz.reshape(-1, 4 * U)


class LSTMScan(torch.autograd.Function):
    """The zoneout LSTM's recurrence of one or two directions with its hand-written
    backward: `LSTMScan.apply(lengths, keeps, rates, reverse, dtype, xp0, w0[, xp1, w1])`
    (lstm_scan's operands). The lengths and keep-masks get no gradient."""

    @staticmethod
    def forward(ctx, lengths, keeps, rates, reverse, dtype, *operands):
        xps, ws = operands[0::2], operands[1::2]
        out, res = _fwd(xps, ws, lengths, keeps, rates, reverse, dtype, True)
        ctx.meta = (keeps, rates, reverse, [x.dtype for x in xps])
        ctx.save_for_backward(lengths, *ws, *res)
        return out

    @staticmethod
    def backward(ctx, dout):
        keeps, rates, reverse, xp_dtypes = ctx.meta
        lengths, *saved = ctx.saved_tensors
        D = len(reverse)
        ws, res = saved[:D], saved[D:]
        dzs, dws = _bwd(dout.contiguous(), res, ws, lengths, keeps, rates, reverse)
        grads = []
        for dz, dw, w, dt in zip(dzs, dws, ws, xp_dtypes, strict=True):
            grads += [dz.to(dt), dw.to(w.dtype)]
        return (None, None, None, None, None, *grads)


def lstm_scan(xps: Sequence[Tensor], ws: Sequence[Tensor], lengths: Tensor, keeps, rates,
              reverse: Sequence[bool], dtype: torch.dtype) -> Tensor:
    """The zoneout LSTM of each direction (xp (B, T, 4U) in its step order and W_hh
    (U, 4U) in the compute dtype; `reverse`d ones over each row's first lengths[b] steps
    backwards, written back to the sequence positions), the keep-masks
    ((kc, kh) a direction, indexed by its own steps) or None, the rates (zc, zh) a
    direction, the state in `dtype`: (B, T, D U), the directions side by side. Through
    `LSTMScan` where a gradient is to be taken, else the forward alone, saving nothing."""
    operands = [x for pair in zip(xps, ws, strict=True) for x in pair]
    keeps = None if keeps is None else tuple(tuple(k) for k in keeps)
    rates, reverse = tuple(tuple(r) for r in rates), tuple(reverse)
    if torch.is_grad_enabled() and any(x.requires_grad for x in operands):
        return LSTMScan.apply(lengths, keeps, rates, reverse, dtype, *operands)
    return _fwd(xps, ws, lengths, keeps, rates, reverse, dtype, False)[0]
