"""The teacher-forced Tacotron decoder with a hand-written backward: the counterpart of
the custom VJP of `tacotron2_tpu/ops/fused_decoder.py` (`decoder_scan`, `_fwd_rule`,
`_bwd_rule`, `:423-643`), for training, evaluation and GTA at the reference's decoder (2
prenet layers, 2 LSTMs: `supports`).

`fused_decoder_scan` takes the contract of `ops/fused_decoder.decoder_scan`. With a
gradient to take it runs `FusedDecoderScan`, a `torch.autograd.Function`:
  - forward (`_forward`): the steps' recurrence, saving what the JAX forward saves
    (`:379-384`): r1, r2, z1, z2, x1, x2, the zoned c and h of both LSTMs, the context and
    the previous alignment state, and the query projection; residuals in the compute
    dtype, the state in float32. Where `loop_applies` (every step on its teacher
    frame, LOOP_WIDTHS, LOOP_FILTERS location filters of at most LOOP_MAX_KERNEL taps, at
    most LOOP_MAX_BATCH rows, and either bf16 on the folded location tier or float32 on
    the conv tier: the trainers' forward and eval on the card at the default hparams, GTA,
    and training at compute_dtype=float32) the prenet runs once over the steps,
    `decoder_fwd_loop` runs all T steps' recurrence in one launch and the frame and stop
    projection runs once over the T * B rows after it; elsewhere (scheduled sampling, bf16
    off the folded tier, other widths) `_step_loop` runs a step at a time (`_step_fwd`).
    This is a dispatch on the configuration: each side is whole where it runs;
  - backward (`_backward`): one reverse loop that carries only dh and dc of each LSTM,
    the context's gradient, the fed-back frame's and the alignment state's, and emits the
    gates' gradients dz1, dz2, dpq, the prenet's, the total context gradient and the
    location features' gradient; dkeys, the energy's dva and dba, and the location
    layer's gradient sum in float32 in place. Where `loop_applies` (where the forward ran
    its loop) the projections' gradient runs
    once over the steps, `decoder_bwd_loop` runs all T reverse steps in one launch and the
    prenet's gradient runs once over the T * B rows after it; elsewhere `_step_loop_bwd`
    runs a step at a time. Both run the step `_reverse_step`. Every large
    weight gradient is then one product over the T * B rows (`:578-614`), as are the
    location conv's kernel and bias gradients (one product where the per-step JAX
    accumulators sum the same terms: `_loc_acc` and `_loc_acc_finalize` on the folded
    tier, `_loc_kernel_grad` on the conv tier) and dvalues.
Without a gradient (`torch.no_grad()`: GTA, `run_eval`, the trainer's eval) it runs the
forward alone, saving nothing. The Function's inputs are the cell's float32 master
parameters, cast once a call (`_weights`), and each gradient returns in its parameter's
dtype; the mask, the coins, the dropout masks and the keep-gates get none.

The step's elementwise stages and row reductions are four hand-written kernels for Hopper
(`csrc/decoder/decoder_step.cu`, built into a library of their own by
`_build.load_decoder_library`): `lstm_cell_fwd`, `lstm_cell_bwd`, `attention_fwd` and
`attention_bwd`; around them the products stay library products, as JAX leaves them to
XLA. The forward loop is a persistent kernel in each dtype: bf16
(`csrc/decoder_loop/decoder_loop.cu`, `_build.load_decoder_loop_library`) and float32
with the location conv inside it (`csrc/decoder_loop_f32/decoder_loop_f32.cu`,
`_build.load_decoder_loop_f32_library`), both behind `decoder_fwd_loop`, the step's
products on the tensor cores (the float32 ones as 3xTF32), lstm_cell_fwd's and
attention_fwd's math in the same launch; the reverse loop too: bf16
(`csrc/decoder_bwd_loop/decoder_bwd_loop.cu`, `_build.load_decoder_bwd_loop_library`) and
float32 with the location conv and its transpose inside it
(`csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu`,
`_build.load_decoder_bwd_loop_f32_library`), both behind `decoder_bwd_loop`, with
lstm_cell_bwd's and attention_bwd's math. Each wrapper launches
its kernel on CUDA tensors (a failed build or launch raises; there is no fallback) and
counts the launch in LAUNCHES; on CPU tensors it runs the kernel's plain PyTorch version
beside it, which the CPU tests hold against the JAX package.

In a reduced compute dtype the casting points are the JAX fused decoder's, as
`ops/fused_decoder.decoder_scan` keeps them (`models/precision.py`); a product whose
result is in that dtype runs in it (float32 accumulation, rounded once), one whose result
is float32 (`preferred_element_type=f32` in JAX) runs in float32 on the rounded values.
The location conv is folded into the location layer where `fused_decoder._location` folds
it (bf16, a batch of at most 96, within LOC_MAT_BYTES); elsewhere, f32 included, the conv
stays (the JAX package's banded `_loc_matrix` at float32 is not ported).
"""

import collections
import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..models.precision import sigmoid, weak
from ..models.tacotron.attention import NEG_INF
from ..models.tacotron.modules import lstm_gates, zoneout
from . import fused_decoder as fd

# launches of each hand-written kernel, counted by its wrapper where it launches it
LAUNCHES: Dict[str, int] = collections.Counter()
KERNELS = ('lstm_cell_fwd', 'lstm_cell_bwd', 'attention_fwd', 'attention_bwd',
           'decoder_fwd_loop', 'decoder_fwd_loop_f32', 'decoder_bwd_loop',
           'decoder_bwd_loop_f32')

# the cell's parameters in the Function's order, with the short names of `_weights`
PARAMS = (('p1_w', 'prenet.layers.0.weight'), ('p1_b', 'prenet.layers.0.bias'),
          ('p2_w', 'prenet.layers.1.weight'), ('p2_b', 'prenet.layers.1.bias'),
          ('g1_w', 'lstm_1.gates.weight'), ('g1_b', 'lstm_1.gates.bias'),
          ('g2_w', 'lstm_2.gates.weight'), ('g2_b', 'lstm_2.gates.bias'),
          ('q_w', 'attention.query_layer.weight'),
          ('loc_w', 'attention.location_convolution.weight'),
          ('loc_b', 'attention.location_convolution.bias'),
          ('l_w', 'attention.location_layer.weight'),
          ('v_a', 'attention.v_a'), ('b_a', 'attention.b_a'),
          ('f_w', 'frame_projection.weight'), ('f_b', 'frame_projection.bias'),
          ('s_w', 'stop_projection.weight'), ('s_b', 'stop_projection.bias'))


def supports(hp) -> bool:
    """The decoder this module covers (`fused_decoder.py:78-81`): 2 prenet layers and 2
    decoder LSTMs, the reference's."""
    return len(tuple(hp.prenet_layers)) == 2 and hp.decoder_layers == 2


@dataclasses.dataclass(frozen=True)
class Config:
    num_mels: int
    units: int
    cumulate: bool
    smoothing: bool
    rates: Tuple[float, float, float, float]  # zoneout of c1, h1, c2, h2
    dtype: torch.dtype


def _config(cell, dtype: torch.dtype) -> Config:
    l1, l2 = cell.lstms
    return Config(cell.num_mels, l1.units, cell.attention.cumulate, cell.attention.smoothing,
                  (l1.zoneout_cell, l1.zoneout_output, l2.zoneout_cell, l2.zoneout_output),
                  dtype)


def _weights(cfg: Config, cell, params: Sequence[Tensor], B: int, T_in: int) -> Dict:
    """The parameters by short name, cast once to the compute dtype but v_a and b_a
    (float32, `fused_decoder.py:96-119`); fs_w and fs_b, the frame and stop projections
    stacked into one product; loc_w_t (K, F), the location kernel flipped for its
    transpose; and on the folded tier loc_n (in the dtype and in float32) and pl_b
    (float32), `fused_decoder._location`'s."""
    dt = cfg.dtype
    W = {k: p.detach() if k in ('v_a', 'b_a') else p.detach().to(dt)
         for (k, _), p in zip(PARAMS, params, strict=True)}
    W['v_a'] = W['v_a'][0]
    W['fs_w'] = torch.cat([W['f_w'], W['s_w']])
    W['fs_b'] = torch.cat([W['f_b'], W['s_b']])
    W['loc_w_t'] = W['loc_w'][:, 0].flip(-1).t()
    loc = fd._location(cell, B, T_in, dt)
    if loc is not None:
        W['loc_n32'], W['pl_b'] = loc
        W['loc_n'] = loc[0].to(dt)
    return W


def _dense(x: Tensor, w: Tensor, b: Optional[Tensor], dt: torch.dtype) -> Tensor:
    """x @ w.T + b as flax's Dense computes it in `dt` (`models/precision.cast_forward`):
    at float32 one product with the bias; in a reduced dtype the product rounded to it,
    then the rounded bias added."""
    if dt == torch.float32:
        return F.linear(x, w, b)
    y = x.to(dt) @ w.t()
    return y if b is None else y + b


# ---------------------------------------------------------------- the kernels' launches

def _library():
    from ._build import load_decoder_library
    return load_decoder_library()


def _loop_library():
    from ._build import load_decoder_loop_library
    return load_decoder_loop_library()


def _loop_f32_library():
    from ._build import load_decoder_loop_f32_library
    return load_decoder_loop_f32_library()


def _bwd_loop_library():
    from ._build import load_decoder_bwd_loop_library
    return load_decoder_bwd_loop_library()


def _bwd_loop_f32_library():
    from ._build import load_decoder_bwd_loop_f32_library
    return load_decoder_bwd_loop_f32_library()


library = _library  # the build whose kernels launch (chip_smoke.py plants faulty ones)
loop_library = _loop_library  # ... and the forward loop's
loop_f32_library = _loop_f32_library  # ... and the float32 forward loop's
bwd_loop_library = _bwd_loop_library  # ... and the reverse loop's
bwd_loop_f32_library = _bwd_loop_f32_library  # ... and the float32 reverse loop's

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ARGTYPES = {
    't2_lstm_cell_fwd': [_P] * 5 + [_F] * 4 + [_P] * 3 + [_I] * 3 + [_P],
    't2_lstm_cell_bwd': [_P, _P, _P, _L] + [_P] * 5 + [_F, _F] + [_P] * 3 + [_I] * 3 + [_P],
    't2_attention_fwd': [_P] * 11 + [_I] * 6 + [_P],
    't2_attention_bwd': [_P] * 15 + [_I] * 5 + [_P],
}


def _launch(name: str, ref: Tensor, *args) -> None:
    """Launch the C entry t2_<name> with `args` (tensors as their device pointers, None
    as null) on the current stream of `ref`'s device; count it; raise on an error."""
    fn = getattr(library(), f't2_{name}')
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[f't2_{name}']
        fn.restype = ctypes.c_int
    args = [a.data_ptr() if isinstance(a, Tensor) else a for a in args]
    err = fn(*args, torch.cuda.current_stream(ref.get_device()).cuda_stream)
    if err:
        raise RuntimeError(f'the {name} kernel did not launch: CUDA error {err}')
    LAUNCHES[name] += 1


def _refuse(what: str) -> None:
    raise ValueError(f'the decoder kernels do not take {what}')


def _check(dt: torch.dtype, *pairs) -> None:
    """Each (tensor or None, dtype or None for `dt`, shape) is None or contiguous on the
    device of the first, of that dtype and shape (the message formed only on a refusal:
    the check runs at every launch)."""
    dev = pairs[0][0].get_device()
    for t, want, shape in pairs:
        if t is not None and not (t.get_device() == dev and t.is_contiguous()
                                  and t.dtype == (want or dt) and t.shape == shape):
            _refuse(f'a {t.dtype} tensor of shape {tuple(t.shape)} on device '
                    f'{t.get_device()}, contiguous {t.is_contiguous()}, where a '
                    f'{want or dt} tensor of shape {tuple(shape)} on device {dev}, '
                    'contiguous, is due')


def _bf16(dt: torch.dtype) -> int:
    if dt not in (torch.float32, torch.bfloat16):
        _refuse(f'the compute dtype {dt}')
    return int(dt == torch.bfloat16)


# ---------------------------------------------------------------- the LSTM cell

_lstm_fwd = lstm_gates  # `fused_decoder.py:122-127`: (c_new, h_new) of the gates z


def _mix(rate: float, dt: torch.dtype) -> Tuple[float, float]:
    """(a, b) of zoneout's expectation a * new + b * old, as `modules.zoneout` forms it."""
    if dt == torch.float32:
        return 1.0 - rate, rate
    k = weak(1.0 - rate, dt)
    return k, 1.0 - k


def _lstm_cell_fwd_plain(z, c_prev, h_prev, keep_c, keep_h, rate_c, rate_h):
    c_new, h_new = _lstm_fwd(z, c_prev)
    return (zoneout(c_new, c_prev, rate_c, keep_c), zoneout(h_new, h_prev, rate_h, keep_h),
            h_new)


def lstm_cell_fwd(z: Tensor, c_prev: Tensor, h_prev: Tensor, keep_c: Optional[Tensor],
                  keep_h: Optional[Tensor], rate_c: float, rate_h: float):
    """The LSTM cell's gates and zoneout (`fused_decoder.py:122-127, 356-364`): z (B, 4U)
    the pre-activations i, g, f, o and c_prev, h_prev (B, U), all in the compute dtype;
    keep_c, keep_h the bool (B, U) keep-gates of training, or None: zoneout's expectation
    at rate_c, rate_h. Returns (c, h) after zoneout and h_new, the step's output."""
    if not z.is_cuda:
        return _lstm_cell_fwd_plain(z, c_prev, h_prev, keep_c, keep_h, rate_c, rate_h)
    dt, (B, U) = z.dtype, c_prev.shape
    bf16 = _bf16(dt)
    _check(dt, (z, None, (B, 4 * U)), (c_prev, None, (B, U)), (h_prev, None, (B, U)),
           (keep_c, torch.bool, (B, U)), (keep_h, torch.bool, (B, U)))
    out = [torch.empty_like(c_prev) for _ in range(3)]
    _launch('lstm_cell_fwd', z, z, c_prev, h_prev, keep_c, keep_h, *_mix(rate_c, dt),
            *_mix(rate_h, dt), *out, B, U, bf16)
    return tuple(out)


def _lstm_bwd(z, c_prev, dh_new, dc_post, a_c):
    """Backward through the gates and the cell's zoneout mix (`fused_decoder.py:130-150`):
    (dz, the gradient of c_prev through the gates)."""
    i, g, f, o = z.chunk(4, dim=-1)
    si, tg, sf, so = sigmoid(i), torch.tanh(g), sigmoid(f + 1.0), sigmoid(o)
    c_new = sf * c_prev + si * tg
    tc = torch.tanh(c_new)
    dc_new = dh_new * so * (1.0 - tc * tc) + a_c * dc_post
    do = dh_new * tc * so * (1.0 - so)
    df = dc_new * c_prev * sf * (1.0 - sf)
    di = dc_new * tg * si * (1.0 - si)
    dg = dc_new * si * (1.0 - tg * tg)
    return torch.cat([di, dg, df, do], dim=-1), dc_new * sf


def _lstm_cell_bwd_plain(z, c_prev, dha, dhb, dh, dc, keep_c, keep_h, a_c, a_h):
    ac = a_c if keep_c is None else keep_c.float()
    ah = a_h if keep_h is None else keep_h.float()
    dh_new = (dha if dhb is None else dha + dhb) + ah * dh
    dz, dc_gates = _lstm_bwd(z, c_prev, dh_new, dc, ac)
    return dz.to(z.dtype), dc_gates + (1.0 - ac) * dc, (1.0 - ah) * dh


def lstm_cell_bwd(z: Tensor, c_prev: Tensor, dha: Tensor, dhb: Optional[Tensor], dh: Tensor,
                  dc: Tensor, keep_c: Optional[Tensor], keep_h: Optional[Tensor],
                  a_c: float, a_h: float):
    """The LSTM cell's backward with its zoneout bypasses (`fused_decoder.py:130-150,
    520-539`): the gradient of the step's output h_new is dha (+ dhb), in the compute
    dtype (dha a (B, U) slice of a wider product), plus ah * dh, dh and dc (B, U) float32
    the carried gradients of the zoned h and c; ac, ah the keep-gates as 0/1 where given,
    else a_c, a_h (JAX's expectation keep 1 - z, rounded to the dtype). Returns (dz (B, 4U)
    in the dtype, dc_prev = the gates' part + (1 - ac) dc, the h bypass (1 - ah) dh), the
    last two float32."""
    if not z.is_cuda:
        return _lstm_cell_bwd_plain(z, c_prev, dha, dhb, dh, dc, keep_c, keep_h, a_c, a_h)
    dt, (B, U) = z.dtype, c_prev.shape
    bf16 = _bf16(dt)
    if not (dha.shape == (B, U) and dha.stride(1) == 1 and dha.dtype == dt
            and dha.get_device() == z.get_device()):
        _refuse('dha of another shape, dtype or layout')
    f32 = torch.float32
    _check(dt, (z, None, (B, 4 * U)), (c_prev, None, (B, U)), (dhb, None, (B, U)),
           (dh, f32, (B, U)), (dc, f32, (B, U)), (keep_c, torch.bool, (B, U)),
           (keep_h, torch.bool, (B, U)))
    dz = torch.empty_like(z)
    dc_next, bypass = torch.empty_like(dc), torch.empty_like(dh)
    _launch('lstm_cell_bwd', z, z, c_prev, dha, dha.stride(0), dhb, dh, dc, keep_c, keep_h,
            a_c, a_h, dz, dc_next, bypass, B, U, bf16)
    return dz, dc_next, bypass


# ---------------------------------------------------------------- the attention

def _energy_arg(keys, pq, pl, pl_b, b_a):
    """u = keys + pq + pl + b_a (B, T_in, D) in float32, the terms widened before they meet
    (`attention.py`: XLA forms this sum in float32 from bf16 terms)."""
    loc = pl.float() if pl_b is None else pl.float() + pl_b
    return keys.float() + pq.float()[:, None, :] + loc + b_a


def _energies(keys, pq, pl, pl_b, b_a, v_a, mask):
    u = _energy_arg(keys, pq, pl, pl_b, b_a)
    tanh_u = torch.tanh(u)
    e = torch.sum(v_a * tanh_u, dim=2)
    if mask is not None:
        e = torch.where(mask > 0, e, torch.full_like(e, NEG_INF))
    return e, tanh_u


def _att_align(keys, pq, pl, pl_b, b_a, v_a, mask, smoothing):
    """The alignments (B, T_in) f32 of the query projection pq (B, D) against the keys
    (B, T_in, D) with the location projection pl (+ pl_b) (`fused_decoder.py:215-228`)."""
    e, _ = _energies(keys, pq, pl, pl_b, b_a, v_a, mask)
    if smoothing:
        sig = torch.sigmoid(e)
        return sig / sig.sum(dim=-1, keepdim=True)
    return F.softmax(e, dim=-1)


def _attention_fwd_plain(keys, pq, pl, pl_b, b_a, v_a, mask, state, smoothing, cumulate):
    align = _att_align(keys, pq, pl, pl_b, b_a, v_a, mask, smoothing)
    return align, align + state if cumulate else align, align.to(keys.dtype).float()


def attention_fwd(keys: Tensor, pq: Tensor, pl: Tensor, pl_b: Optional[Tensor], b_a: Tensor,
                  v_a: Tensor, mask: Optional[Tensor], state: Tensor, smoothing: bool,
                  cumulate: bool):
    """The attention's energy and normalisation and the new state (`fused_decoder.py:
    215-228, 367-368`): keys, pl (B, T_in, D) and pq (B, D) in the compute dtype, pl_b
    (D,) float32 or None, b_a, v_a (D,) float32, mask (B, T_in) float or None, state (B,
    T_in) float32. Returns (the alignments, the new state, the alignments rounded to the
    dtype for the context product), float32."""
    if not keys.is_cuda:
        return _attention_fwd_plain(keys, pq, pl, pl_b, b_a, v_a, mask, state, smoothing,
                                    cumulate)
    dt, (B, T_in, D) = keys.dtype, keys.shape
    bf16 = _bf16(dt)
    f32 = torch.float32
    if T_in > 6144:
        _refuse(f'{T_in} input steps (the row lives in 48 KB of shared memory)')
    _check(dt, (keys, None, (B, T_in, D)), (pq, None, (B, D)), (pl, None, (B, T_in, D)),
           (pl_b, f32, (D,)), (b_a, f32, (D,)), (v_a, f32, (D,)), (mask, f32, (B, T_in)),
           (state, f32, (B, T_in)))
    align, new_state = torch.empty_like(state), torch.empty_like(state)
    align_r = torch.empty_like(state) if bf16 else None
    _launch('attention_fwd', keys, keys, pq, pl, pl_b, b_a, v_a, mask, state, align,
            new_state, align_r, B, T_in, D, int(smoothing), int(cumulate), bf16)
    return align, new_state, align if align_r is None else align_r


def _attention_bwd_plain(keys, pq, pl, pl_b, b_a, v_a, mask, dalign, ga, dstate, smoothing,
                         dkeys_acc, dva_acc, dba_acc):
    e, tanh_u = _energies(keys, pq, pl, pl_b, b_a, v_a, mask)
    dal = dalign + ga
    if dstate is not None:
        dal = dal + dstate
    if smoothing:
        sig = torch.sigmoid(e)
        ssum = sig.sum(dim=-1, keepdim=True)
        align = sig / ssum
        dsig = (dal - torch.sum(dal * align, dim=-1, keepdim=True)) / ssum
        de = dsig * sig * (1.0 - sig)
    else:
        align = F.softmax(e, dim=-1)
        de = (dal - torch.sum(dal * align, dim=-1, keepdim=True)) * align
    if mask is not None:
        de = torch.where(mask > 0, de, torch.zeros_like(de))
    du = (de[:, :, None] * v_a) * (1.0 - tanh_u * tanh_u)
    dkeys_acc += du
    dva_acc += torch.sum(de[:, :, None] * tanh_u, dim=1)
    dpq = torch.sum(du, dim=1)
    dba_acc += dpq
    return du.to(keys.dtype), dpq.to(keys.dtype)


def attention_bwd(keys: Tensor, pq: Tensor, pl: Tensor, pl_b: Optional[Tensor], b_a: Tensor,
                  v_a: Tensor, mask: Optional[Tensor], dalign: Tensor, ga: Tensor,
                  dstate: Optional[Tensor], smoothing: bool, dkeys_acc: Tensor,
                  dva_acc: Tensor, dba_acc: Tensor):
    """The attention's backward through its normalisation and energy (`fused_decoder.py:
    275-301`), the energies recomputed: the alignments' gradient is dalign + ga (+ dstate,
    cumulating), float32 (B, T_in); the inputs are attention_fwd's. Adds du (B, T_in, D)
    to dkeys_acc and each row's sums of de * tanh(u) and du over the input steps to
    dva_acc and dba_acc (B, D), all float32, in place. Returns (du, dpq = sum_t du (B, D)),
    in the dtype."""
    if not keys.is_cuda:
        return _attention_bwd_plain(keys, pq, pl, pl_b, b_a, v_a, mask, dalign, ga, dstate,
                                    smoothing, dkeys_acc, dva_acc, dba_acc)
    dt, (B, T_in, D) = keys.dtype, keys.shape
    bf16 = _bf16(dt)
    f32 = torch.float32
    if T_in > 6144:
        _refuse(f'{T_in} input steps (the row lives in 48 KB of shared memory)')
    _check(dt, (keys, None, (B, T_in, D)), (pq, None, (B, D)), (pl, None, (B, T_in, D)),
           (pl_b, f32, (D,)), (b_a, f32, (D,)), (v_a, f32, (D,)), (mask, f32, (B, T_in)),
           (dalign, f32, (B, T_in)), (ga, f32, (B, T_in)), (dstate, f32, (B, T_in)),
           (dkeys_acc, f32, (B, T_in, D)), (dva_acc, f32, (B, D)), (dba_acc, f32, (B, D)))
    du, dpq = torch.empty_like(keys), torch.empty_like(pq)
    _launch('attention_bwd', keys, keys, pq, pl, pl_b, b_a, v_a, mask, dalign, ga, dstate,
            dkeys_acc, dva_acc, dba_acc, du, dpq, B, T_in, D, int(smoothing), bf16)
    return du, dpq


# ---------------------------------------------------------------- the location path

def _loc_features(cfg: Config, W, state: Tensor) -> Tensor:
    """The location features f (B, T_in, F) of the alignment state in the compute dtype
    (`fused_decoder.py:195-203`): the SAME conv on the rounded state, as a product of its
    K taps a position and the kernel, rounded, plus the rounded bias (`precision.
    cast_forward`'s rounding). A conv call of cuDNN cost some 100-400 us of host time a
    call on the card's host, the loop's largest."""
    K = W['loc_w'].shape[-1]
    pad_lo = (K - 1) // 2
    taps = F.pad(state.to(cfg.dtype), (pad_lo, K - 1 - pad_lo)).unfold(1, state.shape[1], 1)
    return _dense(taps.transpose(1, 2), W['loc_w'][:, 0], W['loc_b'], cfg.dtype)


def _loc_pl(cfg: Config, W, state: Tensor):
    """(pl (B, T_in, D) in the compute dtype, pl_b): the location layer's projection of the
    state's features (`fused_decoder.py:206-212`), on the folded tier state @ loc_n with
    pl_b (D,) float32 to add in float32, else (on the conv tier) with pl_b None."""
    if 'loc_n' in W:
        B, T_in = state.shape
        return (state.to(cfg.dtype) @ W['loc_n']).view(B, T_in, -1), W['pl_b']
    return _dense(_loc_features(cfg, W, state), W['l_w'], None, cfg.dtype), None


def _loc_conv_t(W, df: Tensor) -> Tensor:
    """The location conv's transpose: the state's gradient (B, T_in) from the features'
    df (B, T_in, F), in df's dtype (`fused_decoder.py:316-323`): the correlation with the
    flipped kernel, padded as the forward's SAME padding mirrored (even kernels too), as
    a product of each position's K taps of df and the kernel."""
    K = W['loc_w'].shape[-1]
    pad_lo = (K - 1) // 2
    taps = F.pad(df, (0, 0, K - 1 - pad_lo, pad_lo)).unfold(1, df.shape[1], 1)
    return torch.einsum('bkfs,kf->bs', taps, W['loc_w_t'])


def _att_bwd(cfg: Config, W, keys, mask, pq, state_prev, dalign, ga, dstate, acc,
             attention=attention_bwd):
    """One step of the attention's backward (`fused_decoder.py:257-338`) on the state the
    step read: `attention` (attention_bwd, or its plain version), then the location path.
    dkeys, dva, dba and the location layer's gradient `dl` (D, F) sum into the float32
    accumulators `acc` in place. Returns (dpq (B, D) in the dtype, this step's gradient of
    the state (B, T_in) float32, the location features' gradient df (B * T_in, F) in the
    dtype, from which the location conv's kernel and bias gradients are formed after the
    loop)."""
    B, T_in = state_prev.shape
    state = state_prev.to(cfg.dtype)  # the location path reads the state rounded
    f = _loc_features(cfg, W, state)
    pl, pl_b = (_loc_pl(cfg, W, state) if 'loc_n' in W
                else (_dense(f, W['l_w'], None, cfg.dtype), None))
    du, dpq = attention(keys, pq, pl, pl_b, W['b_a'], W['v_a'], mask, dalign, ga, dstate,
                        cfg.smoothing, acc['dkeys'], acc['dva'], acc['dba'])
    du = du.view(B * T_in, -1)
    du32 = du.float()
    acc['dl'].addmm_(du32.t(), f.reshape(B * T_in, -1).float())
    df = du @ W['l_w']
    if 'loc_n' in W:
        dstate_c = du32.view(B, -1) @ W['loc_n32'].t()
    else:
        dstate_c = _loc_conv_t(W, df.view(B, T_in, -1)).float()
    return dpq, dstate_c, df


def _loc_acc(states: Tensor, dfs: Tensor) -> Tensor:
    """The folded tier's dense gradient (T_in, T_in * F) of the banded location matrix,
    summed over all N = T * B rows: states (N, T_in) the rounded states, dfs (N, T_in, F)
    the features' gradients (`fused_decoder.py:324-327`, each step's term at once)."""
    return states.float().t() @ dfs.float().reshape(dfs.shape[0], -1)


def _loc_acc_finalize(K: int, loc_acc: Tensor) -> Tensor:
    """The location kernel's gradient (F, 1, K) from `_loc_acc`'s dense matrix: its band
    diagonals, dloc_k[f, k] = sum_j dloc_m[j + k - pad_lo, j, f] (`fused_decoder.py:
    240-254`)."""
    T_in = loc_acc.shape[0]
    n_f = loc_acc.shape[1] // T_in
    pad_lo = (K - 1) // 2
    s_pad = F.pad(loc_acc.view(T_in, T_in, n_f), (0, 0, 0, 0, pad_lo, K - 1 - pad_lo))
    flat = s_pad.reshape(-1, n_f)
    j = torch.arange(T_in, device=loc_acc.device)
    idx = (j[None, :] + torch.arange(K, device=loc_acc.device)[:, None]) * T_in + j[None, :]
    return flat[idx].sum(1).t()[:, None, :]


def _loc_kernel_grad(K: int, states: Tensor, dfs: Tensor) -> Tensor:
    """The conv tier's location kernel gradient (F, 1, K), summed over all N = T * B rows:
    dloc_k[f, k] = sum_{n, j} state_pad[n, j + k] df[n, j, f] (`fused_decoder.py:328-337`),
    one (K, N * T_in) x (N * T_in, F) product of the padded states' taps and the
    gradients (a conv over N channels ran 18 ms at B=32 x 128 steps on an H100)."""
    N, T_in = states.shape
    pad_lo = (K - 1) // 2
    taps = F.pad(states.float(), (pad_lo, K - 1 - pad_lo)).unfold(1, T_in, 1)  # (N, K, T_in)
    return (taps.transpose(0, 1).reshape(K, -1)
            @ dfs.float().reshape(N * T_in, -1)).t()[:, None, :]


# ---------------------------------------------------------------- forward and backward

def _prenet(W, x: Tensor, m1: Tensor, m2: Tensor, dt: torch.dtype):
    """(r1, r2, p2): the prenet's two ReLU layers on the frames x (..., M) and its output
    after the dropout masks, in the compute dtype (`fused_decoder.py:349-353`)."""
    r1 = torch.relu(_dense(x, W['p1_w'], W['p1_b'], dt))
    r2 = torch.relu(_dense(r1 * m1, W['p2_w'], W['p2_b'], dt))
    return r1, r2, r2 * m2


def _recurrence(cfg: Config, W, keys, values, mask, carry, p2, gates, lstm, attention):
    """One step's recurrence from the prenet's output p2 (B, P) on (`fused_decoder.py:
    355-380`): the two LSTM cells through `lstm` (lstm_cell_fwd or its plain version) with
    the step's keep-gates `gates`, the query and location projections, the attention
    through `attention` (attention_fwd or its plain version) and the context; carry (c1,
    h1, c2, h2, ctx, state). Returns (the carry, the alignments float32, the step's
    residuals but r1 and r2)."""
    c1, h1, c2, h2, ctx, state = carry
    dt = cfg.dtype
    z1 = _dense(torch.cat([p2, ctx, h1], dim=-1), W['g1_w'], W['g1_b'], dt)
    c1p, h1p, x1 = lstm(z1, c1, h1, gates[0], gates[1], cfg.rates[0], cfg.rates[1])
    z2 = _dense(torch.cat([x1, h2], dim=-1), W['g2_w'], W['g2_b'], dt)
    c2p, h2p, x2 = lstm(z2, c2, h2, gates[2], gates[3], cfg.rates[2], cfg.rates[3])
    pq = _dense(x2, W['q_w'], None, dt)
    pl, pl_b = _loc_pl(cfg, W, state)
    align, new_state, align_r = attention(keys, pq, pl, pl_b, W['b_a'], W['v_a'], mask, state,
                                          cfg.smoothing, cfg.cumulate)
    ctx_new = torch.bmm(align_r[:, None, :], values)[:, 0].to(dt)
    residuals = dict(z1=z1, z2=z2, x1=x1, x2=x2, c1p=c1p, h1p=h1p, c2p=c2p, h2p=h2p,
                     ctx=ctx_new, state=state, pq=pq)
    return (c1p, h1p, c2p, h2p, ctx_new, new_state), align, residuals


def _step_fwd(cfg: Config, W, keys, values, mask, carry, xs):
    """One step (`fused_decoder.py:341-385`); `xs` holds the step's prenet (r1, r2, p2) where
    it read its teacher frame (`_step_loop` runs those steps' prenets at once), else None,
    the step's dropout masks and its keep-gates. Returns (the carry, (the stacked frame
    and stop logits (B, M*r + r), the alignments) float32, the residuals)."""
    *rec, prev = carry
    pre, m1_t, m2_t, gates = xs
    dt = cfg.dtype
    r1, r2, p2 = _prenet(W, prev, m1_t, m2_t, dt) if pre is None else pre
    rec, align, residuals = _recurrence(cfg, W, keys, values, mask, rec, p2, gates,
                                        lstm_cell_fwd, attention_fwd)
    fs = _dense(torch.cat([residuals['x2'], residuals['ctx']], dim=-1), W['fs_w'], W['fs_b'],
                dt).float()
    fr = W['f_w'].shape[0]
    residuals.update(r1=r1, r2=r2)
    return (*rec, fs[:, fr - cfg.num_mels:fr]), (fs, align), residuals


def _step_loop(cfg: Config, W, keys, values, mask, teacher, use_teacher, masks, zo,
               save: bool):
    """The forward loop a step at a time (`fused_decoder.py:388-416`), its cells and
    attention through lstm_cell_fwd and attention_fwd. Returns ((frames (T, B, M*r),
    stops (T, B, r), alignments (T, B, T_in)) float32, the residuals stacked over the steps
    by name, or None without `save`)."""
    dt = cfg.dtype
    T, B = teacher.shape[0], teacher.shape[1]
    T_in, dev = keys.shape[1], keys.device
    zero = torch.zeros(B, cfg.units, device=dev, dtype=dt)
    carry = (zero, zero, zero, zero, torch.zeros(B, values.shape[-1], device=dev, dtype=dt),
             torch.zeros(B, T_in, device=dev), torch.zeros(B, cfg.num_mels, device=dev))
    use = (use_teacher > 0).tolist()
    m1, m2 = (m.to(dt) for m in masks)
    # the prenet of every step that reads its teacher frame, at once
    pre = _prenet(W, teacher, m1, m2, dt) if any(use) else None
    gates = [None] * 4 if zo is None else [g.bool() for g in zo]
    outs, aligns = [], []
    res = collections.defaultdict(list)
    for t in range(T):
        xs = (tuple(p[t] for p in pre) if use[t] else None, m1[t], m2[t],
              [None if g is None else g[t] for g in gates])
        carry, (fs, align), r = _step_fwd(cfg, W, keys, values, mask, carry, xs)
        outs.append(fs)
        aligns.append(align)
        if save:
            for k, v in r.items():
                res[k].append(v)
    fs = torch.stack(outs)
    fr = W['f_w'].shape[0]
    out = (fs[..., :fr].contiguous(), fs[..., fr:].contiguous(), torch.stack(aligns))
    return out, ({k: torch.stack(v) for k, v in res.items()} if save else None)


# ---------------------------------------------------------------- the forward loop kernel

# the widths the four loops (csrc/decoder_loop, decoder_loop_f32, decoder_bwd_loop and
# decoder_bwd_loop_f32) are built for (U, the prenet's output, the encoder's E, the
# attention's D: the default hparams' and the paper profile's), and the largest batch and
# number of input steps they take (the warps' partials of 32 rows fill their shared memory
# beside the resident weights; a thread an input step in the forward's softmax, two input
# steps a CTA in the reverse loops: the bf16 loops' 192, the float32 loops' 256, a
# corpus's longest line of about 190 characters padded to 16)
LOOP_WIDTHS = (1024, 256, 512, 128)
LOOP_MAX_BATCH = 32
LOOP_MAX_T_IN = 192
LOOP_F32_MAX_T_IN = 256
# the location conv's filters that the reverse loops and the float32 forward loop are built
# for (the default hparams' and the paper profile's; the bf16 reverse loop forms the
# location features and their gradient, which the bf16 forward folds away, and the float32
# loops form them and the conv's transpose), and the conv's widest kernel that they take
# (its taps staged in shared memory; the defaults' is 31)
LOOP_FILTERS = 32
LOOP_MAX_KERNEL = 64
# the C entry's pointers, in the order of decoder_loop.cu's `Ptr`
_LOOP_INPUTS = ('p2', 'keys', 'values', 'mask', 'g1_w', 'g1_b', 'g2_w', 'g2_b', 'q_w',
                'loc_nt', 'pl_b', 'v_a', 'b_a', 'keep_c1', 'keep_h1', 'keep_c2', 'keep_h2')
_LOOP_OUTPUTS = ('aligns', 'x2', 'ctx')
_LOOP_RESIDUALS = ('z1', 'z2', 'x1', 'c1p', 'h1p', 'c2p', 'h2p', 'state', 'pq')
_LOOP_SCRATCH = ('h1c', 'h2c', 'x1b', 'pqb', 'eb', 'stb', 'bar')
_LOOP_PROFILE = ('prof',)
# ... and of decoder_loop_f32.cu's `Ptr` (each 'P_' and the name in capitals): the location
# conv's kernel and bias and the location layer in place of loc_nt and pl_b
_F32_INPUTS = ('p2', 'keys', 'values', 'mask', 'g1_w', 'g1_b', 'g2_w', 'g2_b', 'q_w', 'loc_w',
               'loc_b', 'l_w', 'v_a', 'b_a', 'keep_c1', 'keep_h1', 'keep_c2', 'keep_h2')


def _loc_nt(W, T_in: int, D: int) -> Tuple[int, Tensor]:
    """(TP, loc_nt): the loops' loc_n transposed, each input step's D columns a block of
    rows over the T_in steps it reads, those padded with zeros to TP, whole k-pairs of 32."""
    TP = -(-T_in // 32) * 32
    loc_nt = W['loc_n'].new_zeros(T_in, D, TP)
    loc_nt[..., :T_in] = W['loc_n'].view(T_in, T_in, D).permute(1, 2, 0)
    return TP, loc_nt


def _keep(cfg: Config):
    """JAX's zoneout expectation keeps 1 - rate of c1, h1, c2, h2, rounded to the dtype."""
    return [weak(1.0 - rate, cfg.dtype) for rate in cfg.rates]


def loop_applies(cfg: Config, W, keys: Tensor, values: Tensor, use_teacher: Tensor) -> bool:
    """Where both loops run, all T steps in one launch each way (`decoder_fwd_loop`,
    `decoder_bwd_loop`; the reverse loop reads the residuals of the forward loop of its
    dtype), and not the step loops (`_step_loop`, `_step_loop_bwd`): LOOP_WIDTHS,
    LOOP_FILTERS and a location kernel of at most LOOP_MAX_KERNEL taps, a batch of at most
    LOOP_MAX_BATCH, every step on its teacher frame (the default constant teacher forcing
    at ratio 1, GTA, eval), and either the compute dtype bf16 (the trainers' on the card)
    with the location conv folded into loc_n (`fused_decoder._location`: a batch of at
    most 96 and loc_n within LOC_MAT_BYTES, T_in <= 181 at D=128) and at most
    LOOP_MAX_T_IN input steps (the bf16 loops), or float32 on the conv location tier with
    at most LOOP_F32_MAX_T_IN input steps (the float32 loops, the location conv and its
    transpose inside them: GTA, the trainers' float32 forward, backward and eval). Which
    device runs them is the wrappers' to say, as for every kernel: on CUDA tensors the
    kernels, on CPU ones their plain versions."""
    B, T_in, D = keys.shape
    if cfg.dtype == torch.float32:
        tier = 'loc_n' not in W and T_in <= LOOP_F32_MAX_T_IN
    else:
        tier = cfg.dtype == torch.bfloat16 and 'loc_n' in W and T_in <= LOOP_MAX_T_IN
    return (tier and 1 <= B <= LOOP_MAX_BATCH
            and (cfg.units, W['p2_w'].shape[0], values.shape[-1], D) == LOOP_WIDTHS
            and W['l_w'].shape[1] == LOOP_FILTERS and W['loc_w'].shape[-1] <= LOOP_MAX_KERNEL
            and bool((use_teacher > 0).all()))


def _loop_dims(cfg: Config, W, keys: Tensor, values: Tensor, B: int, max_t_in: int,
               what: str) -> Tuple[int, int, int, int]:
    """(T_in, D, n_f, K) of a call of a loop that forms the location features (the
    reverse loops and the float32 forward, `what`): refuses, with the numbers, other
    widths than LOOP_WIDTHS, other than LOOP_FILTERS filters or more than LOOP_MAX_KERNEL
    taps, other than 1 to LOOP_MAX_BATCH rows or more than `max_t_in` input steps."""
    T_in, D = keys.shape[1], keys.shape[2]
    U, E, n_p = cfg.units, values.shape[-1], W['p2_w'].shape[0]
    n_f, K = W['loc_w'].shape[0], W['loc_w'].shape[-1]
    if ((U, n_p, E, D) != LOOP_WIDTHS or n_f != LOOP_FILTERS or K > LOOP_MAX_KERNEL
            or not 1 <= B <= LOOP_MAX_BATCH or T_in > max_t_in):
        _refuse(f'the widths (U, P, E, D) {(U, n_p, E, D)}, {n_f} location filters of {K} taps '
                f'at B={B}, T_in={T_in} in its {what} (built for {LOOP_WIDTHS}, '
                f'{LOOP_FILTERS} filters of at most {LOOP_MAX_KERNEL} taps, B <= '
                f'{LOOP_MAX_BATCH}, T_in <= {max_t_in})')
    return T_in, D, n_f, K


def _decoder_fwd_loop_plain(cfg: Config, W, keys, values, mask, p2, gates, save: bool):
    """`decoder_fwd_loop`'s plain version: the step loop from the prenet's output on, its
    cells and attention through their plain versions."""
    dt = cfg.dtype
    T, B = p2.shape[0], p2.shape[1]
    T_in, dev = keys.shape[1], keys.device
    zero = torch.zeros(B, cfg.units, device=dev, dtype=dt)
    carry = (zero, zero, zero, zero, torch.zeros(B, values.shape[-1], device=dev, dtype=dt),
             torch.zeros(B, T_in, device=dev))
    aligns, res = [], collections.defaultdict(list)
    for t in range(T):
        carry, align, r = _recurrence(cfg, W, keys, values, mask, carry, p2[t],
                                      [None if g is None else g[t] for g in gates],
                                      _lstm_cell_fwd_plain, _attention_fwd_plain)
        aligns.append(align)
        for k in (r if save else ('x2', 'ctx')):
            res[k].append(r[k])
    R = {k: torch.stack(v) for k, v in res.items()}
    return torch.stack(aligns), R['x2'], R['ctx'], R if save else None


def _launch_loop(entry, name: str, tensors: Dict, names: Sequence[str], ints: Sequence[int],
                 floats: Sequence[float], dev) -> None:
    """Launch a persistent loop's C entry `entry` with the device pointers of `tensors` in
    the order of `names` (null where absent), `ints` and `floats`, on the current stream of
    `dev`; count it in LAUNCHES[name]. Raises where the card keeps fewer CTAs resident than
    the grid barrier needs, with both numbers, and where the launch failed."""
    ptrs = (ctypes.c_void_p * len(names))(
        *(None if tensors.get(k) is None else tensors[k].data_ptr() for k in names))
    info = (ctypes.c_int * 2)()
    if entry.argtypes is None:
        entry.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
                          ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
                          ctypes.c_void_p]
        entry.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = entry(ptrs, (ctypes.c_int * len(ints))(*ints),
                    (ctypes.c_float * len(floats))(*floats), info,
                    torch.cuda.current_stream(dev).cuda_stream)
    if info[1]:
        raise RuntimeError(f'the {name} kernel needs {info[1]} CTAs resident at once (its grid '
                           f'barrier waits for all of them); this card keeps {info[0]}')
    if err:
        raise RuntimeError(f'the {name} kernel did not launch: CUDA error {err}')
    LAUNCHES[name] += 1


def decoder_fwd_loop(cfg: Config, W, keys: Tensor, values: Tensor, mask: Optional[Tensor],
                     p2: Tensor, gates: Sequence[Optional[Tensor]], save: bool,
                     profile: Optional[Tensor] = None):
    """The teacher-forced forward recurrence of all T steps (`fused_decoder.py:341-416`)
    from the prenet's output p2 (T, B, P) in the compute dtype: keys (B, T_in, D) in it,
    values (B, T_in, E) and the mask (B, T_in) float32 or None, gates the four (T, B, U)
    bool keep-gates c1, h1, c2, h2 or None (zoneout's expectation), W `_weights`'. Returns
    (the alignments (T, B, T_in) float32, x2 (T, B, U) and the contexts (T, B, E) in the
    dtype, the residuals by name but r1 and r2, or None without `save`). On CUDA tensors
    one launch: in bf16 of csrc/decoder_loop/decoder_loop.cu (the folded tier, LOOP_WIDTHS,
    at most LOOP_MAX_BATCH rows and LOOP_MAX_T_IN input steps), counted in LAUNCHES as
    decoder_fwd_loop; in float32 of csrc/decoder_loop_f32/decoder_loop_f32.cu (the conv
    tier, LOOP_WIDTHS, LOOP_FILTERS filters of at most LOOP_MAX_KERNEL taps, at most
    LOOP_MAX_BATCH rows and LOOP_F32_MAX_T_IN input steps), counted as
    decoder_fwd_loop_f32; anything else raises. On CPU tensors its plain version.
    `profile`: the (128, 10) int64 stage times that a build of either source with
    -DT2_PROFILE writes (`probes/loop_split.py`)."""
    if not keys.is_cuda:
        return _decoder_fwd_loop_plain(cfg, W, keys, values, mask, p2, gates, save)
    if cfg.dtype == torch.float32:
        return _decoder_fwd_loop_f32(cfg, W, keys, values, mask, p2, gates, save, profile)
    T, B, n_p = p2.shape
    T_in, D = keys.shape[1], keys.shape[2]
    U, E = cfg.units, values.shape[-1]
    bf, f32 = torch.bfloat16, torch.float32
    if cfg.dtype != bf or 'loc_n' not in W:
        _refuse('a forward loop in another dtype than bf16 or f32, or in bf16 off the folded '
                'location tier')
    if (U, n_p, E, D) != LOOP_WIDTHS or not 1 <= B <= LOOP_MAX_BATCH or T_in > LOOP_MAX_T_IN:
        _refuse(f'the widths (U, P, E, D) {(U, n_p, E, D)} at B={B}, T_in={T_in} in its forward '
                f'loop (built for {LOOP_WIDTHS}, B <= {LOOP_MAX_BATCH}, T_in <= '
                f'{LOOP_MAX_T_IN})')
    _check(bf, (p2, None, (T, B, n_p)), (keys, None, (B, T_in, D)),
           (values, f32, (B, T_in, E)), (mask, f32, (B, T_in)),
           (W['g1_w'], None, (4 * U, n_p + E + U)), (W['g1_b'], None, (4 * U,)),
           (W['g2_w'], None, (4 * U, 2 * U)), (W['g2_b'], None, (4 * U,)),
           (W['q_w'], None, (D, U)), (W['loc_n'], None, (T_in, T_in * D)),
           (W['pl_b'], f32, (D,)), (W['v_a'], f32, (D,)), (W['b_a'], f32, (D,)),
           *((g, torch.bool, (T, B, U)) for g in gates))
    dev = keys.device
    TP, loc_nt = _loc_nt(W, T_in, D)
    inputs = dict(p2=p2, keys=keys, values=values, mask=mask, loc_nt=loc_nt,
                  **{k: W[k] for k in ('g1_w', 'g1_b', 'g2_w', 'g2_b', 'q_w', 'pl_b', 'v_a',
                                       'b_a')},
                  **dict(zip(_LOOP_INPUTS[-4:], gates, strict=True)))
    empty = lambda *shape, dtype=bf: torch.empty(*shape, device=dev, dtype=dtype)
    out = dict(aligns=empty(T, B, T_in, dtype=f32), x2=empty(T, B, U), ctx=empty(T, B, E))
    res = (dict(z1=empty(T, B, 4 * U), z2=empty(T, B, 4 * U),
                **{k: empty(T, B, U) for k in ('x1', 'c1p', 'h1p', 'c2p', 'h2p')},
                state=empty(T, B, T_in, dtype=f32), pq=empty(T, B, D)) if save else {})
    scratch = dict(h1c=empty(2, B, U), h2c=empty(2, B, U), x1b=empty(B, U), pqb=empty(B, D),
                   eb=empty(B, T_in, dtype=f32),
                   stb=torch.zeros(2, B, TP, device=dev),             # slot 1: the zero state
                   bar=torch.zeros(1, device=dev, dtype=torch.int32))  # the grid barrier
    _launch_loop(loop_library().t2_decoder_fwd_loop, 'decoder_fwd_loop',
                 {**inputs, **out, **res, **scratch, 'prof': profile},
                 _LOOP_INPUTS + _LOOP_OUTPUTS + _LOOP_RESIDUALS + _LOOP_SCRATCH + _LOOP_PROFILE,
                 (T, B, T_in, int(cfg.smoothing), int(cfg.cumulate)),
                 [x for rate in cfg.rates for x in _mix(rate, bf)], dev)
    R = dict(res, x2=out['x2'], ctx=out['ctx']) if save else None
    return out['aligns'], out['x2'], out['ctx'], R


def _decoder_fwd_loop_f32(cfg: Config, W, keys, values, mask, p2, gates, save: bool,
                          profile: Optional[Tensor]):
    """`decoder_fwd_loop` on CUDA tensors in float32: one launch of
    csrc/decoder_loop_f32/decoder_loop_f32.cu, the location conv inside it."""
    T, B, n_p = p2.shape
    U, E = cfg.units, values.shape[-1]
    if 'loc_n' in W:
        _refuse('a float32 forward loop on the folded location tier')
    T_in, D, n_f, K = _loop_dims(cfg, W, keys, values, B, LOOP_F32_MAX_T_IN,
                                 'float32 forward loop')
    # a data-parallel rank's rows are slices of the batch
    p2, keys, values = p2.contiguous(), keys.contiguous(), values.contiguous()
    mask = None if mask is None else mask.contiguous()
    gates = [None if g is None else g.contiguous() for g in gates]
    f32 = torch.float32
    _check(f32, (p2, None, (T, B, n_p)), (keys, None, (B, T_in, D)),
           (values, None, (B, T_in, E)), (mask, None, (B, T_in)),
           (W['g1_w'], None, (4 * U, n_p + E + U)), (W['g1_b'], None, (4 * U,)),
           (W['g2_w'], None, (4 * U, 2 * U)), (W['g2_b'], None, (4 * U,)),
           (W['q_w'], None, (D, U)), (W['loc_w'], None, (n_f, 1, K)),
           (W['loc_b'], None, (n_f,)), (W['l_w'], None, (D, n_f)), (W['v_a'], None, (D,)),
           (W['b_a'], None, (D,)), *((g, torch.bool, (T, B, U)) for g in gates))
    dev = keys.device
    inputs = dict(p2=p2, keys=keys, values=values, mask=mask,
                  **{k: W[k] for k in _F32_INPUTS[4:-4]},
                  **dict(zip(_F32_INPUTS[-4:], gates, strict=True)))
    empty = lambda *shape: torch.empty(*shape, device=dev)
    out = dict(aligns=empty(T, B, T_in), x2=empty(T, B, U), ctx=empty(T, B, E))
    res = (dict(z1=empty(T, B, 4 * U), z2=empty(T, B, 4 * U),
                **{k: empty(T, B, U) for k in ('x1', 'c1p', 'h1p', 'c2p', 'h2p')},
                state=empty(T, B, T_in), pq=empty(T, B, D)) if save else {})
    scratch = dict(h1c=empty(2, B, U), h2c=empty(2, B, U), x1b=empty(B, U),
                   pqb=empty(U // 8 // (D // 8), B, D),  # pq's sums by K-chunk
                   eb=empty(B, T_in),
                   stb=torch.zeros(2, B, T_in, device=dev),           # slot 1: the zero state
                   bar=torch.zeros(1, device=dev, dtype=torch.int32))  # the grid barrier
    _launch_loop(loop_f32_library().t2_decoder_fwd_loop_f32, 'decoder_fwd_loop_f32',
                 {**inputs, **out, **res, **scratch, 'prof': profile},
                 _F32_INPUTS + _LOOP_OUTPUTS + _LOOP_RESIDUALS + _LOOP_SCRATCH + _LOOP_PROFILE,
                 (T, B, T_in, K, int(cfg.smoothing), int(cfg.cumulate)),
                 [x for rate in cfg.rates for x in _mix(rate, f32)], dev)
    R = dict(res, x2=out['x2'], ctx=out['ctx']) if save else None
    return out['aligns'], out['x2'], out['ctx'], R


def _forward(cfg: Config, W, keys, values, mask, teacher, use_teacher, masks, zo, save: bool):
    """The forward (`fused_decoder.py:388-416`): where `loop_applies`, the prenet over
    every step at once, `decoder_fwd_loop`, and the frame and stop projection over the
    T * B rows (no step feeds its frame back); elsewhere `_step_loop`. Returns ((frames
    (T, B, M*r), stops (T, B, r), alignments (T, B, T_in)) float32, the residuals stacked
    over the steps by name, or None without `save`)."""
    if not loop_applies(cfg, W, keys, values, use_teacher):
        return _step_loop(cfg, W, keys, values, mask, teacher, use_teacher, masks, zo, save)
    dt = cfg.dtype
    m1, m2 = (m.to(dt) for m in masks)
    r1, r2, p2 = _prenet(W, teacher, m1, m2, dt)
    gates = [None] * 4 if zo is None else [g.bool() for g in zo]
    aligns, x2, ctx, R = decoder_fwd_loop(cfg, W, keys, values, mask, p2, gates, save)
    fs = _dense(torch.cat([x2, ctx], dim=-1), W['fs_w'], W['fs_b'], dt).float()
    fr = W['f_w'].shape[0]
    if save:
        R.update(r1=r1, r2=r2)
    return (fs[..., :fr].contiguous(), fs[..., fr:].contiguous(), aligns), R


def _shift1(x: Tensor) -> Tensor:
    """x[t] -> x[t - 1] along axis 0, zeros at t = 0."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _wgrad(dout: Tensor, inp: Tensor) -> Tensor:
    """The weight gradient (out, in) float32 of a product over all steps: dout (T, B,
    out), inp (T, B, in), one product over the T * B rows in float32 on their values."""
    return (dout.reshape(-1, dout.shape[-1]).float().t()
            @ inp.reshape(-1, inp.shape[-1]).float())


def _reverse_step(cfg: Config, W, keys, values, mask, R, t: int, dproj, ga, carry, acc,
                  gates, keep, lstm, attention, g1):
    """One step t of the reverse recurrence (`fused_decoder.py:494-571`), as `_recurrence`
    serves the forward: from the frame and stop projections' gradient dproj (B, U + E) in
    the compute dtype and the alignments' ga (B, T_in) float32 on, the context's total
    gradient and the alignments', the attention's backward (`_att_bwd` through
    `attention`: attention_bwd or its plain version), both LSTM cells' backward through
    `lstm` (lstm_cell_bwd or its plain version) with the step's keep-gates `gates`, else
    zoneout's expectation `keep` (JAX's 1 - rate, rounded to the dtype), and the first
    LSTM's input gradient din1 = dz1 @ g1, g1 that LSTM's weight whole or from its context
    columns on. carry: (dh1, dc1, dh2, dc2, dctx, dstate) float32, the gradients carried
    from step t + 1; acc the float32 accumulators of `_att_bwd`. Returns (the carry, the
    step's dz1, dz2, dpq, dctx_total and df by name, din1's columns before the context's:
    the prenet's gradient, none where g1 starts at the context)."""
    dt, U = cfg.dtype, cfg.units
    M_enc = values.shape[-1]
    dh1, dc1, dh2, dc2, dctx, dstate = carry
    dctx_total = (dproj[:, U:].float() + dctx).to(dt)
    dalign = torch.bmm(values, dctx_total.float()[:, :, None])[..., 0]
    # the new state's gradient reaches the alignments whether or not they cumulate
    # (where they do not, the JAX package's `_bwd_rule` drops it: `:512-514`)
    dpq, dstate_c, df = _att_bwd(cfg, W, keys, mask, R['pq'][t], R['state'][t], dalign, ga,
                                 dstate, acc, attention)
    dstate = dstate + dstate_c if cfg.cumulate else dstate_c
    zero_u = torch.zeros_like(R['c2p'][0])
    dz2, dc2, bypass2 = lstm(R['z2'][t], R['c2p'][t - 1] if t else zero_u, dproj[:, :U],
                             dpq @ W['q_w'], dh2, dc2, gates[2], gates[3], keep[2], keep[3])
    din2 = dz2 @ W['g2_w']                                               # (B, U + U)
    dh2 = din2[:, U:] + bypass2
    dz1, dc1, bypass1 = lstm(R['z1'][t], R['c1p'][t - 1] if t else zero_u, din2[:, :U], None,
                             dh1, dc1, gates[0], gates[1], keep[0], keep[1])
    din1 = dz1 @ g1                                                      # (B, [P2 +] M_enc + U)
    n_pre = din1.shape[-1] - M_enc - U
    dctx = din1[:, n_pre:n_pre + M_enc].float()
    dh1 = din1[:, n_pre + M_enc:] + bypass1
    emits = dict(dz1=dz1, dz2=dz2, dpq=dpq, dctx_total=dctx_total, df=df)
    return (dh1, dc1, dh2, dc2, dctx, dstate), emits, din1[:, :n_pre]


def _zero_carry(B: int, U: int, M_enc: int, T_in: int, dev) -> Tuple[Tensor, ...]:
    """The reverse recurrence's carry at the last step: every gradient zero, float32."""
    zeros = lambda *s: torch.zeros(*s, device=dev)
    return (*(zeros(B, U) for _ in range(4)), zeros(B, M_enc), zeros(B, T_in))


def _accumulators(W, B: int, T_in: int, D: int, dev) -> Dict[str, Tensor]:
    """The float32 accumulators of `_att_bwd` at zero: dkeys, dva, dba and dl."""
    zeros = lambda *s: torch.zeros(*s, device=dev)
    return dict(dkeys=zeros(B, T_in, D), dva=zeros(B, D), dba=zeros(B, D),
                dl=zeros(*W['l_w'].shape))


def _step_loop_bwd(cfg: Config, W, keys, values, mask, R, dfs, dfs_dt, g_aligns, use, gates,
                   relu1, relu2):
    """The reverse loop a step at a time (`fused_decoder.py:494-571`), its cells and
    attention through lstm_cell_bwd and attention_bwd: each step's dproj from the frames'
    and stops' gradients dfs (T, B, M*r + r) float32 and dfs_dt (them in the dtype), the
    fed-back frame's gradient added into both in place where step t + 1 read its own.
    Returns (the emits stacked over the steps by name, dp2 among them; the accumulators)."""
    T, (B, T_in, D) = dfs.shape[0], keys.shape
    M, fr = cfg.num_mels, W['f_w'].shape[0]
    acc = _accumulators(W, B, T_in, D, keys.device)
    carry = _zero_carry(B, cfg.units, values.shape[-1], T_in, keys.device)
    keep = _keep(cfg)
    dprev = None  # the gradient of the frame step t + 1 read back, where it did
    emits = collections.defaultdict(list)
    for t in reversed(range(T)):
        if dprev is not None:
            dfs[t, :, fr - M:fr] += dprev
            if dfs_dt is not dfs:
                dfs_dt[t] = dfs[t]
        dproj = dfs_dt[t] @ W['fs_w']                                    # (B, U + M_enc)
        carry, e, dp2 = _reverse_step(cfg, W, keys, values, mask, R, t, dproj, g_aligns[t],
                                      carry, acc, [None if g is None else g[t] for g in gates],
                                      keep, lstm_cell_bwd, attention_bwd, W['g1_w'])
        # the prenet's backward: in the loop where the step read its own last frame (its
        # gradient goes on to step t - 1), after it for the steps that read their teacher
        # frame (`fused_decoder.py:541-547`)
        dprev = None if use[t] else ((dp2 * relu2[t]) @ W['p2_w'] * relu1[t]) @ W['p1_w']
        for k, v in dict(e, dp2=dp2).items():
            emits[k].append(v)
    return {k: torch.stack(v[::-1]) for k, v in emits.items()}, acc


# ---------------------------------------------------------------- the reverse loop kernel

# the C entry's pointers, in the order of decoder_bwd_loop.cu's `Ptr`
_BWD_INPUTS = ('keys', 'values', 'mask', 'dproj', 'ga', 'z1', 'z2', 'c1p', 'c2p', 'state', 'pq',
               'g1_w', 'g2_w', 'q_w', 'loc_nt', 'loc_n', 'pl_b', 'v_a', 'b_a', 'loc_w', 'loc_b',
               'l_w', 'keep_c1', 'keep_h1', 'keep_c2', 'keep_h2')
_BWD_OUTPUTS = ('dz1', 'dz2', 'dpq', 'dctx_total', 'df', 'dkeys', 'dva', 'dba', 'dl')
_BWD_SCRATCH = ('dctx', 'dstate', 'dalign', 'eb', 'dus', 'dsp', 'dpqb', 'g1c', 'dvap', 'dlp',
                'bar')
_BWD_PROFILE = ('prof',)
# ... and of decoder_bwd_loop_f32.cu's `Ptr` (its outputs `_BWD_OUTPUTS`): the location
# conv's kernel and bias and the location layer in place of loc_nt, loc_n and pl_b; the
# CTAs' streamed weight columns as fragments (g2x, g1h, g1c) in place of g1c
_BWD_F32_INPUTS = ('keys', 'values', 'mask', 'dproj', 'ga', 'z1', 'z2', 'c1p', 'c2p', 'state',
                   'pq', 'g1_w', 'g2_w', 'q_w', 'loc_w', 'loc_b', 'l_w', 'v_a', 'b_a',
                   'keep_c1', 'keep_h1', 'keep_c2', 'keep_h2')
_BWD_F32_SCRATCH = ('dctx', 'dstate', 'dalign', 'eb', 'dus', 'g2x', 'g1h', 'g1c', 'dvap', 'dlp',
                    'bar')


def _decoder_bwd_loop_plain(cfg: Config, W, keys, values, mask, R, dproj, g_aligns, gates):
    """`decoder_bwd_loop`'s plain version: the reverse recurrence a step at a time through
    `_reverse_step` with the cells' and the attention's plain versions, din1 from the
    context's columns on."""
    T, (B, T_in, D) = dproj.shape[0], keys.shape
    P2 = W['p2_w'].shape[0]
    acc = _accumulators(W, B, T_in, D, keys.device)
    carry = _zero_carry(B, cfg.units, values.shape[-1], T_in, keys.device)
    keep = _keep(cfg)
    g1 = W['g1_w'][:, P2:]
    emits = collections.defaultdict(list)
    for t in reversed(range(T)):
        carry, e, _ = _reverse_step(cfg, W, keys, values, mask, R, t, dproj[t], g_aligns[t],
                                    carry, acc, [None if g is None else g[t] for g in gates],
                                    keep, _lstm_cell_bwd_plain, _attention_bwd_plain, g1)
        for k, v in e.items():
            emits[k].append(v)
    E = {k: torch.stack(v[::-1]) for k, v in emits.items()}
    return (E['dz1'], E['dz2'], E['dpq'], E['dctx_total'], E['df'], acc['dkeys'], acc['dva'],
            acc['dba'], acc['dl'])


def decoder_bwd_loop(cfg: Config, W, keys: Tensor, values: Tensor, mask: Optional[Tensor],
                     R, dproj: Tensor, g_aligns: Tensor, gates: Sequence[Optional[Tensor]],
                     profile: Optional[Tensor] = None):
    """The teacher-forced reverse recurrence of all T steps (`fused_decoder.py:494-571`)
    where `loop_applies`: from the frame and stop projections' gradient dproj (T, B,
    U + E) in the compute dtype (no step feeds its frame back, so it is one product over
    the T * B rows) and the alignments' g_aligns (T, B, T_in) float32, over the forward's
    residuals R, keys (B, T_in, D) in the dtype, values (B, T_in, E) and the mask (B,
    T_in) float32 or None, gates the four (T, B, U) bool keep-gates c1, h1, c2, h2 or None
    (zoneout's expectation), W `_weights`'. Returns (dz1, dz2 (T, B, 4U), dpq (T, B, D),
    dctx_total (T, B, E), df (T, B * T_in, F), all in the dtype; the float32 accumulators
    dkeys (B, T_in, D), dva, dba (B, D) and dl (D, F)). On CUDA tensors one launch: in bf16
    of csrc/decoder_bwd_loop/decoder_bwd_loop.cu (the folded tier, LOOP_WIDTHS,
    LOOP_FILTERS, at most LOOP_MAX_BATCH rows and LOOP_MAX_T_IN input steps), counted in
    LAUNCHES as decoder_bwd_loop; in float32 of
    csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu (the conv tier, LOOP_WIDTHS,
    LOOP_FILTERS filters of at most LOOP_MAX_KERNEL taps, at most LOOP_MAX_BATCH rows and
    LOOP_F32_MAX_T_IN input steps), counted as decoder_bwd_loop_f32; anything else raises.
    On CPU tensors its plain version. `profile`: the (128, 12) int64 stage times that a
    build of either source with -DT2_PROFILE writes (`probes/loop_split.py`)."""
    if not keys.is_cuda:
        return _decoder_bwd_loop_plain(cfg, W, keys, values, mask, R, dproj, g_aligns, gates)
    if cfg.dtype == torch.float32:
        return _decoder_bwd_loop_f32(cfg, W, keys, values, mask, R, dproj, g_aligns, gates,
                                     profile)
    T, B = dproj.shape[:2]
    U, E, n_p = cfg.units, values.shape[-1], W['p2_w'].shape[0]
    bf, f32 = torch.bfloat16, torch.float32
    if cfg.dtype != bf or 'loc_n' not in W:
        _refuse('a reverse loop in another dtype than bf16 or f32, or in bf16 off the folded '
                'location tier')
    T_in, D, n_f, K = _loop_dims(cfg, W, keys, values, B, LOOP_MAX_T_IN, 'reverse loop')
    _check(bf, (keys, None, (B, T_in, D)), (values, f32, (B, T_in, E)), (mask, f32, (B, T_in)),
           (dproj, None, (T, B, U + E)), (g_aligns, f32, (T, B, T_in)),
           *((R[k], None, (T, B, 4 * U)) for k in ('z1', 'z2')),
           *((R[k], None, (T, B, U)) for k in ('c1p', 'c2p')),
           (R['state'], f32, (T, B, T_in)), (R['pq'], None, (T, B, D)),
           (W['g1_w'], None, (4 * U, n_p + E + U)), (W['g2_w'], None, (4 * U, 2 * U)),
           (W['q_w'], None, (D, U)), (W['loc_n'], None, (T_in, T_in * D)),
           (W['pl_b'], f32, (D,)), (W['v_a'], f32, (D,)), (W['b_a'], f32, (D,)),
           (W['loc_w'], None, (n_f, 1, K)), (W['loc_b'], None, (n_f,)),
           (W['l_w'], None, (D, n_f)), *((g, torch.bool, (T, B, U)) for g in gates))
    dev = keys.device
    TP, loc_nt = _loc_nt(W, T_in, D)
    inputs = dict(keys=keys, values=values, mask=mask, dproj=dproj, ga=g_aligns, loc_nt=loc_nt,
                  **{k: R[k] for k in ('z1', 'z2', 'c1p', 'c2p', 'state', 'pq')},
                  **{k: W[k] for k in ('g1_w', 'g2_w', 'q_w', 'loc_n', 'pl_b', 'v_a', 'b_a',
                                       'loc_w', 'loc_b', 'l_w')},
                  **dict(zip(_BWD_INPUTS[-4:], gates, strict=True)))
    empty = lambda *shape, dtype=bf: torch.empty(*shape, device=dev, dtype=dtype)
    zeros = lambda *shape: torch.zeros(*shape, device=dev)
    G = U // 8  # the kernel's CTAs
    out = dict(dz1=empty(T, B, 4 * U), dz2=empty(T, B, 4 * U), dpq=empty(T, B, D),
               dctx_total=empty(T, B, E), df=empty(T, B * T_in, n_f),
               dkeys=zeros(B, T_in, D), dva=empty(B, D, dtype=f32), dba=empty(B, D, dtype=f32),
               dl=empty(D, n_f, dtype=f32))
    scratch = dict(dctx=zeros(B, E), dstate=zeros(B, TP),                # the carried ones
                   dalign=empty(B, T_in, dtype=f32), eb=empty(B, T_in, dtype=f32),
                   dus=empty(B, T_in, D, dtype=f32), dsp=empty(T_in, B, TP, dtype=f32),
                   dpqb=empty(B, D), g1c=empty(G, 4 * U * 4), dvap=empty(G, B, D, dtype=f32),
                   dlp=empty(G, D, n_f, dtype=f32),
                   bar=torch.zeros(1, device=dev, dtype=torch.int32))  # the grid barrier
    _launch_loop(bwd_loop_library().t2_decoder_bwd_loop, 'decoder_bwd_loop',
                 {**inputs, **out, **scratch, 'prof': profile},
                 _BWD_INPUTS + _BWD_OUTPUTS + _BWD_SCRATCH + _BWD_PROFILE,
                 (T, B, T_in, K, int(cfg.smoothing), int(cfg.cumulate)), _keep(cfg), dev)
    return tuple(out[k] for k in _BWD_OUTPUTS)


def _decoder_bwd_loop_f32(cfg: Config, W, keys, values, mask, R, dproj, g_aligns, gates,
                          profile: Optional[Tensor]):
    """`decoder_bwd_loop` on CUDA tensors in float32: one launch of
    csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu, the location conv and its transpose
    inside it."""
    T, B = dproj.shape[:2]
    U, E, n_p = cfg.units, values.shape[-1], W['p2_w'].shape[0]
    if 'loc_n' in W:
        _refuse('a float32 reverse loop on the folded location tier')
    T_in, D, n_f, K = _loop_dims(cfg, W, keys, values, B, LOOP_F32_MAX_T_IN,
                                 'float32 reverse loop')
    # a data-parallel rank's rows are slices of the batch (`fused_decoder_scan` passes the
    # caller's float32 keys and values themselves)
    keys, values, dproj, g_aligns = (x.contiguous() for x in (keys, values, dproj, g_aligns))
    mask = None if mask is None else mask.contiguous()
    gates = [None if g is None else g.contiguous() for g in gates]
    res = {k: R[k].contiguous() for k in ('z1', 'z2', 'c1p', 'c2p', 'state', 'pq')}
    f32 = torch.float32
    _check(f32, (keys, None, (B, T_in, D)), (values, None, (B, T_in, E)), (mask, None, (B, T_in)),
           (dproj, None, (T, B, U + E)), (g_aligns, None, (T, B, T_in)),
           *((res[k], None, (T, B, 4 * U)) for k in ('z1', 'z2')),
           *((res[k], None, (T, B, U)) for k in ('c1p', 'c2p')),
           (res['state'], None, (T, B, T_in)), (res['pq'], None, (T, B, D)),
           (W['g1_w'], None, (4 * U, n_p + E + U)), (W['g2_w'], None, (4 * U, 2 * U)),
           (W['q_w'], None, (D, U)), (W['loc_w'], None, (n_f, 1, K)),
           (W['loc_b'], None, (n_f,)), (W['l_w'], None, (D, n_f)), (W['v_a'], None, (D,)),
           (W['b_a'], None, (D,)), *((g, torch.bool, (T, B, U)) for g in gates))
    dev = keys.device
    inputs = dict(keys=keys, values=values, mask=mask, dproj=dproj, ga=g_aligns, **res,
                  **{k: W[k] for k in _BWD_F32_INPUTS[11:-4]},
                  **dict(zip(_BWD_F32_INPUTS[-4:], gates, strict=True)))
    empty = lambda *shape: torch.empty(*shape, device=dev)
    zeros = lambda *shape: torch.zeros(*shape, device=dev)
    G, KQ = U // 8, 4 * U // 16  # the kernel's CTAs, the gates' k-quads
    out = dict(dz1=empty(T, B, 4 * U), dz2=empty(T, B, 4 * U), dpq=empty(T, B, D),
               dctx_total=empty(T, B, E), df=empty(T, B * T_in, n_f), dkeys=zeros(B, T_in, D),
               dva=empty(B, D), dba=empty(B, D), dl=empty(D, n_f))
    scratch = dict(dctx=zeros(B, E), dstate=zeros(B, T_in),              # the carried ones
                   dalign=empty(B, T_in), eb=empty(B, T_in), dus=empty(B, T_in, D),
                   g2x=empty(G, KQ * 32 * 4), g1h=empty(G, KQ * 32 * 4), g1c=empty(G, KQ * 16 * 4),
                   dvap=empty(G, B, D), dlp=empty(G, 2, D, n_f),
                   bar=torch.zeros(1, device=dev, dtype=torch.int32))  # the grid barrier
    _launch_loop(bwd_loop_f32_library().t2_decoder_bwd_loop_f32, 'decoder_bwd_loop_f32',
                 {**inputs, **out, **scratch, 'prof': profile},
                 _BWD_F32_INPUTS + _BWD_OUTPUTS + _BWD_F32_SCRATCH + _BWD_PROFILE,
                 (T, B, T_in, K, int(cfg.smoothing), int(cfg.cumulate)), _keep(cfg), dev)
    return tuple(out[k] for k in _BWD_OUTPUTS)


def _backward(cfg: Config, W, keys, values, mask, teacher, use_teacher, masks, zo, frames,
              aligns, R, g_frames, g_stops, g_aligns):
    """The hand-written backward (`fused_decoder.py:468-640`): where `loop_applies`
    (the forward ran `decoder_fwd_loop` of the dtype) the frame and stop projections'
    gradient once over the T * B rows, `decoder_bwd_loop`, and the prenet's gradient once
    over them after it; elsewhere `_step_loop_bwd`. Returns ({short name: the parameter's gradient,
    float32}, dkeys, dvalues, dteacher)."""
    dt = cfg.dtype
    T, B = teacher.shape[0], teacher.shape[1]
    M = cfg.num_mels
    T_in = keys.shape[1]
    P2 = W['p2_w'].shape[0]
    fr = W['f_w'].shape[0]
    dev = keys.device
    use_b = use_teacher > 0
    m1, m2 = (m.to(dt) for m in masks)
    relu1, relu2 = m1 * (R['r1'] > 0), m2 * (R['r2'] > 0)  # the prenet's dropout-relu gates
    gates = [None] * 4 if zo is None else [g.bool() for g in zo]
    # the frames' and stops' gradients side by side, and rounded to the dtype for their
    # product; the fed-back frame's gradient added in place where a step read its own
    dfs = torch.cat([g_frames, g_stops], dim=-1)
    dfs_dt = dfs.to(dt)
    if loop_applies(cfg, W, keys, values, use_teacher):
        names = ('dz1', 'dz2', 'dpq', 'dctx_total', 'df', 'dkeys', 'dva', 'dba', 'dl')
        out = dict(zip(names, decoder_bwd_loop(cfg, W, keys, values, mask, R,
                                               dfs_dt @ W['fs_w'], g_aligns, gates)))
        acc = {k: out.pop(k) for k in names[5:]}
        E = dict(out, dp2=out['dz1'] @ W['g1_w'][:, :P2])
    else:
        E, acc = _step_loop_bwd(cfg, W, keys, values, mask, R, dfs, dfs_dt, g_aligns,
                                use_b.tolist(), gates, relu1, relu2)
    E['dp2pre'] = E['dp2'] * relu2
    E['dp1pre'] = (E['dp2pre'] @ W['p2_w']) * relu1
    ddec = E['dp1pre'] @ W['p1_w']                                       # (T, B, M)

    # the deferred weight gradients: one product each over the T * B rows
    in1 = torch.cat([R['r2'] * m2, _shift1(R['ctx']), _shift1(R['h1p'])], dim=-1)
    in2 = torch.cat([R['x1'], _shift1(R['h2p'])], dim=-1)
    proj = torch.cat([R['x2'], R['ctx']], dim=-1)
    dec_in = torch.where(use_b[:, None, None], teacher, _shift1(frames[..., -M:]))
    dfs_w, dfs_b = _wgrad(dfs_dt, proj), dfs.sum((0, 1))
    states = R['state'].to(dt).reshape(T * B, T_in)
    dfeat = E['df'].reshape(T * B, T_in, -1)
    K = W['loc_w'].shape[-1]
    g = dict(p1_w=_wgrad(E['dp1pre'], dec_in.to(dt)), p1_b=E['dp1pre'].float().sum((0, 1)),
             p2_w=_wgrad(E['dp2pre'], R['r1'] * m1), p2_b=E['dp2pre'].float().sum((0, 1)),
             g1_w=_wgrad(E['dz1'], in1), g1_b=E['dz1'].float().sum((0, 1)),
             g2_w=_wgrad(E['dz2'], in2), g2_b=E['dz2'].float().sum((0, 1)),
             q_w=_wgrad(E['dpq'], R['x2']),
             loc_w=(_loc_acc_finalize(K, _loc_acc(states, dfeat)) if 'loc_n' in W
                    else _loc_kernel_grad(K, states, dfeat)),
             loc_b=dfeat.float().sum((0, 1)), l_w=acc['dl'],
             v_a=acc['dva'].sum(0, keepdim=True), b_a=acc['dba'].sum(0),
             f_w=dfs_w[:fr], f_b=dfs_b[:fr], s_w=dfs_w[fr:], s_b=dfs_b[fr:])
    dvalues = torch.bmm(aligns.to(dt).float().permute(1, 2, 0),
                        E['dctx_total'].float().transpose(0, 1))
    dteacher = torch.where(use_b[:, None, None], ddec.float(), torch.zeros((), device=dev))
    return g, acc['dkeys'], dvalues, dteacher


class FusedDecoderScan(torch.autograd.Function):
    """The teacher-forced decoder with its hand-written backward (`_forward`, `_backward`):
    `apply(cfg, cell, keys, values, mask, teacher, use_teacher, m1, m2, zc1, zh1, zc2, zh2,
    *params)`, the keep-gates None for zoneout's expectation, params the cell's in PARAMS'
    order. Returns (frames, stops, alignments)."""

    @staticmethod
    def forward(ctx, cfg, cell, keys, values, mask, teacher, use_teacher, m1, m2, zc1, zh1,
                zc2, zh2, *params):
        zo = None if zc1 is None else (zc1, zh1, zc2, zh2)
        W = _weights(cfg, cell, params, keys.shape[0], keys.shape[1])
        (frames, stops, aligns), R = _forward(cfg, W, keys, values, mask, teacher,
                                              use_teacher, (m1, m2), zo, save=True)
        ctx.cfg, ctx.W, ctx.R, ctx.has_zo = cfg, W, R, zo is not None
        ctx.save_for_backward(keys, values, mask, teacher, use_teacher, m1, m2, *(zo or ()),
                              frames, aligns, *params)
        return frames, stops, aligns

    @staticmethod
    def backward(ctx, g_frames, g_stops, g_aligns):
        saved = list(ctx.saved_tensors)
        keys, values, mask, teacher, use_teacher, m1, m2 = saved[:7]
        n_zo = 4 if ctx.has_zo else 0
        zo = saved[7:7 + n_zo] or None
        frames, aligns = saved[7 + n_zo:9 + n_zo]
        params = saved[9 + n_zo:]
        g, dkeys, dvalues, dteacher = _backward(
            ctx.cfg, ctx.W, keys, values, mask, teacher, use_teacher, (m1, m2), zo, frames,
            aligns, ctx.R, g_frames.float(), g_stops.float(), g_aligns.float().contiguous())
        ctx.R = ctx.W = None
        dparams = [g[k].to(p.dtype) for (k, _), p in zip(PARAMS, params, strict=True)]
        return (None, None, dkeys.to(keys.dtype), dvalues.to(values.dtype), None, dteacher,
                None, None, None, None, None, None, None, *dparams)


def fused_decoder_scan(cell, keys: Tensor, values: Tensor, mask: Optional[Tensor],
                       teacher: Tensor, use_teacher: Tensor, masks: Sequence[Tensor],
                       zo: Optional[Sequence[Tensor]], dtype: torch.dtype = torch.float32
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The teacher-forced decoder of the model's DecoderCell `cell` (2 prenet layers, 2
    LSTMs) over T steps, with the arguments and outputs of `fused_decoder.decoder_scan`
    (masks: the two prenet layers' (T, B, units) dropout masks scaled by 1/keep; zo: None
    or the four (T, B, U) bool keep-gates c1, h1, c2, h2), differentiable through
    `FusedDecoderScan` where a gradient is to be taken, else the forward alone, which keeps
    no residuals."""
    cfg = _config(cell, dtype)
    params = [cell.get_parameter(name) for _, name in PARAMS]
    keys, values = keys.to(dtype), values.float()
    zo = [None] * 4 if zo is None else list(zo)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (keys, values, teacher, *params)):
        return FusedDecoderScan.apply(cfg, cell, keys, values, mask, teacher, use_teacher,
                                      *masks, *zo, *params)
    with torch.no_grad():
        W = _weights(cfg, cell, params, keys.shape[0], keys.shape[1])
        return _forward(cfg, W, keys, values, mask, teacher, use_teacher, masks,
                        None if zo[0] is None else zo, save=False)[0]
