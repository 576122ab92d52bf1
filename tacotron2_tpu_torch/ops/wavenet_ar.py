"""WaveNet autoregressive generation: packed weights, noise, the plain PyTorch version
and the wrapper of the hand-written Hopper kernel (`csrc/wavenet_ar.cu`).

Counterpart of `tacotron2_tpu/ops/pallas/wavenet_ar.py` for these variants: scalar
input (raw or mu-law) with a Gaussian head (`out_channels == 2`) or a mixture of nr
logistics (MoL, `out_channels == 3*nr`: the paper profile's 30); one-hot input
(`mulaw-quantize`) with a categorical head over `out_channels == quantize_channels`
classes, up to MAX_CLASSES; the fused critical path (`wavenet_fused_ar=True`: layer
l-1's residual 1x1 folded into layer l's current-tap conv, one serial matmul + GLU per
layer) or the plain chain (two serial matmuls per layer); local conditioning, with or
without a global conditioning bias `g_cond` (`pack_global`); a fresh call or a
streamed continuation (`state_in` / `return_state`). Anything else raises: the
big-vocab categorical (more than MAX_CLASSES classes, noise drawn inside the kernel)
and the in-kernel evaluation NLL are not ported.

Noise. The Gaussian head takes (B, T) standard-normal noise. The MoL head takes
(B, T, nr+1): column 0 logistic noise for the sample, columns 1..nr Gumbel noise for
the choice of mixture. The categorical head takes (B, T, Q) Gumbel noise, one value a
class (`make_noise`). Its audio is class ids (int64); `ops/mulaw.inv_mulaw_quantize`
decodes them.

`generate_ar` dispatches on the device of its input: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs `generate_ar_reference`.

Streaming state. `(rings, h, t_base)`: `rings` (B, ring_floats) f32 holds every
layer's ring buffer, layer l's `win = (k-1)*dilation` slots of R floats at float
offset `ring_layout(hp)[l][0]`; `h` (B, R) f32 is the first-conv output that feeds
the next step; `t_base` is the absolute step of the chunk's first sample. Local step
t of a chunk writes slot `(t_base + t) mod win`, so chunk boundaries need not be
multiples of anything: two state-carried calls give exactly the audio of one.
"""

import collections
import ctypes
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..models.wavenet.model import WaveNet
from ..utils import round_up
from .mulaw import is_mulaw_quantize

SQRT_HALF = float(math.sqrt(0.5))
# most classes of the categorical head: its noise and params are (B, T, Q) tensors, and
# the kernel gives each class a thread of its 1024
MAX_CLASSES = 1024

# kernel launches made by generate_ar (the plain version never counts), in all and by
# instantiation (`variant`)
LAUNCHES = 0
LAUNCHES_BY_VARIANT: Dict[str, int] = collections.Counter()

# name -> (dtype, shape) of each packed weight, as pack_params made them, by sizes
_PACKED_LAYOUTS: Dict[Tuple[int, ...], Dict[str, Tuple[torch.dtype, Tuple[int, ...]]]] = {}


def _layout_key(hp) -> Tuple[int, ...]:
    return (hp.layers, hp.residual_channels, hp.gate_channels, hp.skip_out_channels,
            hp.kernel_size, hp.cin_channels, hp.out_channels, int(is_categorical(hp)),
            int(hp.wavenet_fused_ar))


def check_supported(hp) -> None:
    """Raise unless `hp` is a configuration the port's AR path covers."""
    problems = []
    if is_categorical(hp):
        if hp.out_channels != hp.quantize_channels:
            problems.append(f'out_channels={hp.out_channels} != quantize_channels='
                            f'{hp.quantize_channels} (one logit a class)')
        if hp.out_channels > MAX_CLASSES:
            problems.append(f'big-vocab categorical (out_channels={hp.out_channels} > '
                            f'{MAX_CLASSES}: the variant that draws its noise inside '
                            'the kernel is not ported)')
    elif hp.out_channels != 2 and (hp.out_channels < 3 or hp.out_channels % 3):
        problems.append(f'out_channels={hp.out_channels} (Gaussian, 2, or MoL, a '
                        'multiple of 3)')
    if hp.cin_channels <= 0:
        problems.append('no local conditioning (cin_channels <= 0)')
    if hp.kernel_size < 2:
        problems.append('kernel_size < 2 (no ring buffers)')
    if problems:
        raise NotImplementedError('WaveNet AR generation does not cover: '
                                  + ', '.join(problems))


def is_categorical(hp) -> bool:
    """Whether input and output are classes (mulaw-quantize): one-hot input through a
    (Q, R) first conv, a head of Q logits, class ids as audio."""
    return is_mulaw_quantize(hp.input_type)


def is_mol(hp) -> bool:
    """Whether the head is the mixture of logistics (scalar input, out_channels =
    3*nr), not the Gaussian (2) or the categorical."""
    return not is_categorical(hp) and hp.out_channels != 2


def variant(hp, has_g: bool = False) -> str:
    """Name of the kernel instantiation that runs `hp`: head-chain, '+g' with a global
    conditioning bias."""
    head = 'categorical' if is_categorical(hp) else 'mol' if is_mol(hp) else 'gaussian'
    return f"{head}-{'fused' if hp.wavenet_fused_ar else 'plain'}{'+g' if has_g else ''}"


def noise_shape(hp, B: int, T: int) -> Tuple[int, ...]:
    """(B, T) for the Gaussian head, (B, T, nr+1) for MoL, (B, T, Q) for the
    categorical."""
    if is_categorical(hp):
        return (B, T, hp.out_channels)
    return (B, T, hp.out_channels // 3 + 1) if is_mol(hp) else (B, T)


def dilations(hp) -> List[int]:
    lps = hp.layers // hp.stacks
    return [2 ** (i % lps) for i in range(hp.layers)]


def ring_floats(hp) -> int:
    """f32 ring-buffer slots per sequence: sum over layers of (k-1)*dilation*R."""
    return (hp.kernel_size - 1) * hp.residual_channels * sum(dilations(hp))


def ring_layout(hp) -> List[Tuple[int, int]]:
    """(float offset, slots) of each layer's ring in a sequence's row of `rings`, in
    layer order (the kernel's `ring_off` and `win`, `csrc/wavenet_ar.cu`)."""
    out, off = [], 0
    for d in dilations(hp):
        win = (hp.kernel_size - 1) * d
        out.append((off, win))
        off += win * hp.residual_channels
    return out


def rounds_conditioning(B: int) -> bool:
    """Whether the TPU kernel rounds the conditioning row to bf16 at batch B: it keeps
    a bf16 per-chunk slab only while its padded batch max(8, round_up(B, 8)) is at
    most 16 rows (`wavenet_ar.py:211, 292-301`), and an f32 row past that (`:310-315`)."""
    return max(8, round_up(B, 8)) <= 16


def _bias(layer, features: int) -> Tensor:
    if layer.bias is not None:
        return layer.bias.detach().float()
    return torch.zeros(features, device=layer.weight.device)


@torch.no_grad()
def pack_params(model: WaveNet, hp) -> Dict[str, Tensor]:
    """Extract and pre-transform the WaveNet weights for AR generation
    (counterpart of `pack_params`, `wavenet_ar.py:99-165`).

    Layouts follow the JAX packing, (in, out): `w_tap` (L, k*R, G) with the taps
    oldest first and the current tap last, `w_os` (L, G/2, R+S) residual and skip
    1x1s side by side, `w_fused` (L, G/2, G) the fold rho * W_out[l-1] @ W_cur[l]
    (zero for layer 0), `w_cond` (cin, L*G) every layer's conditioning 1x1. Weights
    are bf16 and biases f32, except the first conv (`first_w` (1, R), or (Q, R) for
    one-hot input) and the last head layer (`w_s2` (S, out_channels): 2, 30 or Q
    columns), which stay f32 as in the JAX packing up to MAX_CLASSES. `w_cond` keeps
    cin rows (no lane padding). With wavenet_fused_ar=False there is no fold, and
    `w_fused` and `b_fused` are left out (the JAX packing ships stubs there)."""
    check_supported(hp)
    L, R, G = hp.layers, hp.residual_channels, hp.gate_channels
    S, k = hp.skip_out_channels, hp.kernel_size
    past = (k - 1) * R
    w = {}
    fc = model.first_conv
    w['first_w'] = fc.weight.detach().float().t().contiguous()        # (1 or Q, R)
    w['first_b'] = _bias(fc, R)

    w_tap, b_tap, w_os, b_os, w_c, b_c = [], [], [], [], [], []
    for blk in model.residual_layers:
        # Conv1d weight (G, R, k) -> (k, R, G) -> (k*R, G)
        w_tap.append(blk.conv.weight.detach().float().permute(2, 1, 0).reshape(k * R, G))
        b_tap.append(_bias(blk.conv, G))
        w_os.append(torch.cat([blk.conv1x1_out.weight.detach().float().t(),
                               blk.conv1x1_skip.weight.detach().float().t()], dim=1))
        b_os.append(torch.cat([_bias(blk.conv1x1_out, R), _bias(blk.conv1x1_skip, S)]))
        w_c.append(blk.conv1x1c.weight.detach().float().t())           # (cin, G)
        b_c.append(_bias(blk.conv1x1c, G))
    w['w_tap'] = torch.stack(w_tap).bfloat16().contiguous()
    w['b_tap'] = torch.stack(b_tap).contiguous()
    w['w_os'] = torch.stack(w_os).bfloat16().contiguous()
    w['b_os'] = torch.stack(b_os).contiguous()

    # fused critical path (wavenet_ar.py:131-151): computed from the f32 weights
    if hp.wavenet_fused_ar:
        rho = SQRT_HALF if hp.residual_legacy else 1.0
        w_fused = [torch.zeros(G // 2, G, device=fc.weight.device)]
        b_fused = [torch.zeros(G, device=fc.weight.device)]
        for i in range(1, L):
            w_cur = w_tap[i][past:]                                    # (R, G)
            w_fused.append(rho * (w_os[i - 1][:, :R] @ w_cur))
            b_fused.append(rho * (b_os[i - 1][:R] @ w_cur))
        w['w_fused'] = torch.stack(w_fused).bfloat16().contiguous()
        w['b_fused'] = torch.stack(b_fused).contiguous()

    w['w_cond'] = torch.stack(w_c, dim=1).reshape(hp.cin_channels, L * G) \
        .bfloat16().contiguous()
    w['b_cond'] = torch.cat(b_c).contiguous()
    w['w_s1'] = model.skip_conv1.weight.detach().float().t().bfloat16().contiguous()
    w['b_s1'] = _bias(model.skip_conv1, S)
    w['w_s2'] = model.skip_conv2.weight.detach().float().t().contiguous()  # (S, out) f32
    w['b_s2'] = _bias(model.skip_conv2, hp.out_channels)
    _PACKED_LAYOUTS[_layout_key(hp)] = {n: (t.dtype, tuple(t.shape)) for n, t in w.items()}
    return w


@torch.no_grad()
def pack_global(model: WaveNet, hp, g_emb: Tensor) -> Tensor:
    """Project the speaker embeddings g_emb (B, gin) through every layer's conv1x1g
    into one (B, L*G) f32 conditioning bias, constant over time (counterpart of
    `pack_global`, `wavenet_ar.py:168-179`): an f32 product, outside the kernel there
    too."""
    w_g = torch.stack([blk.conv1x1g.weight.detach().float().t()
                       for blk in model.residual_layers], dim=1)       # (gin, L, G)
    b_g = torch.cat([_bias(blk.conv1x1g, hp.gate_channels) for blk in model.residual_layers])
    return (g_emb.float() @ w_g.reshape(hp.gin_channels, -1) + b_g).contiguous()


def make_noise(hp, generator: torch.Generator, B: int, T: int,
               device: Optional[torch.device] = None) -> Tensor:
    """Sampling noise drawn from `generator` (counterpart of `make_noise`,
    `wavenet_ar.py:715-733`): standard-normal (B, T) for the Gaussian head; for MoL
    (B, T, nr+1), column 0 logistic noise log u - log(1-u) and columns 1..nr Gumbel
    noise -log(-log u), u uniform in [1e-5, 1-1e-5]; for the categorical head (B, T, Q)
    Gumbel noise, u uniform in [1e-9, 1 - 2**-24]. The JAX package asks for u up to
    1 - 1e-9 there, which is 1.0 in f32 and would give an infinite Gumbel value: the
    upper end is the largest f32 below 1 instead."""
    dev = generator.device
    if is_categorical(hp):
        u = torch.rand(B, T, hp.out_channels, generator=generator, device=dev)
        eps = -torch.log(-torch.log(u.clamp_(1e-9, 1.0 - 2.0 ** -24)))
    elif not is_mol(hp):
        eps = torch.randn(B, T, generator=generator, device=dev)
    else:
        lo, hi = 1e-5, 1.0 - 1e-5
        u = lo + (hi - lo) * torch.rand(B, T, 1, generator=generator, device=dev)
        gu = lo + (hi - lo) * torch.rand(B, T, hp.out_channels // 3, generator=generator,
                                         device=dev)
        eps = torch.cat([torch.log(u) - torch.log(1.0 - u), -torch.log(-torch.log(gu))], -1)
    return eps.to(device) if device is not None else eps


def mol_sample(params: Tensor, noise: Tensor, hp) -> Tensor:
    """The MoL head's draw from its params (..., 3*nr) and noise (..., nr+1)
    (`wavenet_ar.py:455-464`): the mixture of largest logit + Gumbel noise, ties
    averaged (each tied mixture weighs 1/count, not argmax's first index), then
    clip(mean + exp(max(log_scale, log_scale_min)) * logistic noise, -1, 1)."""
    nr = hp.out_channels // 3
    logits = params[..., :nr] + noise[..., 1:1 + nr]
    onehot = (logits >= logits.max(-1, keepdim=True).values).float()
    onehot = onehot / onehot.sum(-1, keepdim=True)
    mean = (params[..., nr:2 * nr] * onehot).sum(-1)
    logs = torch.clamp((params[..., 2 * nr:3 * nr] * onehot).sum(-1), min=hp.log_scale_min)
    return torch.clamp(mean + torch.exp(logs) * noise[..., 0], -1.0, 1.0)


def sample(params: Tensor, noise: Tensor, hp) -> Tensor:
    """The head's draw from its params: `mol_sample` for MoL; for the Gaussian, params
    (..., 2) and noise (...), clip(mean + exp(max(log_scale, log_scale_min_gauss)) *
    eps, -1, 1), each head with its own floor (`wavenet_ar.py:207`); for the
    categorical, logits and Gumbel noise (..., Q), the class id (int64) of the largest
    logit + noise, the first on ties (`wavenet_ar.py:444`)."""
    if is_categorical(hp):
        return (params + noise).argmax(-1)
    if is_mol(hp):
        return mol_sample(params, noise, hp)
    logs = torch.clamp(params[..., 1], min=hp.log_scale_min_gauss)
    return torch.clamp(params[..., 0] + torch.exp(logs) * noise, -1.0, 1.0)


def _glu(z: Tensor, half: int) -> Tensor:
    # the TPU kernel's sigmoid form: 0.5 + 0.5*tanh(x/2)
    return torch.tanh(z[:, :half]) * (0.5 + 0.5 * torch.tanh(0.5 * z[:, half:]))


def _bf(x: Tensor) -> Tensor:
    """Round to bf16 and back: the places the TPU kernel casts a matmul operand."""
    return x.bfloat16().float()


def _check_state(state_in, hp, B: int, device) -> int:
    """Check a streaming state against the call's batch and device; returns t_base."""
    rings, h, t_base = state_in
    _check_tensor('state rings', rings, torch.float32, (B, ring_floats(hp)), device)
    _check_tensor('state h', h, torch.float32, (B, hp.residual_channels), device)
    t_base = int(t_base)
    if not 0 <= t_base < 2 ** 62:
        raise ValueError(f'state t_base must be in [0, 2**62), got {t_base}')
    return t_base


@torch.no_grad()
def generate_ar_reference(weights: Dict[str, Tensor], c_up: Tensor, noise: Tensor, hp,
                          targets: Optional[Tensor] = None, return_params: bool = True,
                          state_in: Optional[Tuple[Tensor, Tensor, int]] = None,
                          return_state: bool = False, g_cond: Optional[Tensor] = None):
    """Plain PyTorch AR generation with the kernel's arithmetic.

    Mirrors the step of `wavenet_ar.py:303-465` on the packed weights, the fused
    chain or the plain one (`:342-361`): bf16-rounded matmul operands, f32 products
    and sums, the same order of operations. `targets` (B, T), when given, replaces
    each sample fed back (teacher forcing, as `models/wavenet/model.py:285-286`), so
    per-step params can be compared on an identical history.

    The categorical head starts from the f32 first-conv row of class Q // 2
    (`:262-265`) and feeds back bf16(one-hot) @ bf16(first_w) + first_b (`:441-448`),
    the one-hot of every class that ties the largest logit + noise divided by their
    count; the class id emitted is the first of them.

    Args:
        weights: `pack_params` output.
        c_up: (B, T, cin) upsampled conditioning, already rescaled to [0, 1].
        noise: (B, T) for the Gaussian head, (B, T, nr+1) for MoL, (B, T, Q) for the
            categorical (`make_noise`).
        g_cond: (B, L*G) global conditioning bias (`pack_global`) or None; it joins
            the conditioning row before that row is rounded to bf16, where it is
            (`:296-301`, `:312-315`).
        state_in: a state a previous call returned (see the module docstring), to
            continue from; None starts fresh (zero rings, h = first_b, t_base 0). The
            state is consumed: its rings are updated in place and returned.
        return_state: also return the state after the last step.
    Returns: (audio (B, T), params (B, T, out_channels) or None[, state]); audio
        holds the fed-back samples, floats or int64 class ids.
    """
    B, T, _ = c_up.shape
    L, R, G = hp.layers, hp.residual_channels, hp.gate_channels
    S, k = hp.skip_out_channels, hp.kernel_size
    half, past = G // 2, (k - 1) * R
    rho = SQRT_HALF if hp.residual_legacy else 1.0
    dev = c_up.device
    W = {name: t.to(dev).float() for name, t in weights.items()}
    dils = dilations(hp)
    layout = ring_layout(hp)
    wins = [win for _, win in layout]
    categorical = is_categorical(hp)
    if categorical:
        Q = hp.out_channels
        first_wb = _bf(W['first_w'])
    if state_in is None:
        rings = torch.zeros(B, ring_floats(hp), device=dev)
        h = W['first_b'].expand(B, R)
        if categorical:  # silence is class Q // 2; its row is read in f32
            h = W['first_w'][Q // 2] + h
        t_base = 0
    else:
        t_base = _check_state(state_in, hp, B, dev)
        rings, h = state_in[0], state_in[1]
    bufs = [rings[:, off:off + win * R].view(B, win, R) for off, win in layout]
    bases = [t_base % win for win in wins]  # absolute slots, without a growing int
    round_cond = rounds_conditioning(B)
    audio = torch.empty(B, T, device=dev, dtype=torch.long if categorical else None)
    params = torch.empty(B, T, hp.out_channels, device=dev) if return_params else None
    c_up = c_up.float()

    def read_taps(li, t):
        # tap x(t-m) lives at slot (t_base + t - m) mod win (wavenet_ar.py:317-326)
        return [bufs[li][:, (bases[li] + t + wins[li] - (k - 1 - j) * dils[li]) % wins[li]]
                for j in range(k - 1)]

    def plain_chain(h, cond, t):
        """The layer stack as two serial matmuls per layer (wavenet_ar.py:342-361);
        returns the skip sum."""
        skips = torch.zeros(B, S, device=dev)
        for li in range(L):
            tap_cat = _bf(torch.cat(read_taps(li, t) + [h], dim=1))
            # the layer's input overwrites the oldest slot, its taps read (and copied)
            bufs[li][:, (bases[li] + t) % wins[li]] = h
            z = tap_cat @ W['w_tap'][li] + W['b_tap'][li]
            z = z + cond[:, li * G:(li + 1) * G]
            y = _bf(_glu(z, half)) @ W['w_os'][li] + W['b_os'][li]
            h = (y[:, :R] + h) * rho
            skips = skips + y[:, R:]
            if hp.legacy and li > 0:  # the first skip enters unscaled
                skips = skips * SQRT_HALF
        return skips

    def fused_chain(h, cond, t):
        """The layer stack with one serial matmul per layer (wavenet_ar.py:362-408);
        returns the skip sum."""
        skips = torch.zeros(B, S, device=dev)
        consts = []
        for li in range(L):
            p = W['b_tap'][li] + W['b_fused'][li] + cond[:, li * G:(li + 1) * G]
            consts.append(p + _bf(torch.cat(read_taps(li, t), dim=1)) @ W['w_tap'][li, :past])
        z = _glu(_bf(h) @ W['w_tap'][0, past:] + consts[0], half)
        h_prev = h
        hs = [h]
        for li in range(1, L):
            zb = _bf(z)
            b_term = zb @ W['w_fused'][li]
            a_term = _bf(h_prev) @ W['w_tap'][li, past:]
            if hp.residual_legacy:
                a_term = a_term * SQRT_HALF
            y = zb @ W['w_os'][li - 1] + W['b_os'][li - 1]
            h_cur = (h_prev + y[:, :R]) * rho
            skips = skips + y[:, R:]
            if hp.legacy and li - 1 > 0:
                skips = skips * SQRT_HALF
            z = _glu(b_term + a_term + consts[li], half)
            hs.append(h_cur)
            h_prev = h_cur
        y = _bf(z) @ W['w_os'][L - 1] + W['b_os'][L - 1]
        skips = skips + y[:, R:]
        if hp.legacy and L > 1:
            skips = skips * SQRT_HALF
        for li in range(L):  # overwrite the oldest slot, after every read
            bufs[li][:, (bases[li] + t) % wins[li]] = hs[li]
        return skips

    layer_stack = fused_chain if hp.wavenet_fused_ar else plain_chain
    for t in range(T):
        cond = _bf(c_up[:, t]) @ W['w_cond'] + W['b_cond']
        if g_cond is not None:
            cond = cond + g_cond
        if round_cond:  # the TPU kernel's bf16 conditioning slab (wavenet_ar.py:292-301)
            cond = _bf(cond)
        skips = layer_stack(h, cond, t)
        o = torch.relu(skips)
        o = torch.relu(_bf(o) @ W['w_s1'] + W['b_s1'])
        params_t = o @ W['w_s2'] + W['b_s2']
        x = sample(params_t, noise[:, t], hp)
        if targets is not None:
            x = targets[:, t].to(x.dtype)
        audio[:, t] = x
        if params is not None:
            params[:, t] = params_t
        if categorical:
            if targets is not None:
                onehot = F.one_hot(x, Q).float()
            else:  # every class that ties the maximum, 1/count each
                scores = params_t + noise[:, t]
                onehot = (scores >= scores.max(-1, keepdim=True).values).float()
                onehot = onehot / onehot.sum(-1, keepdim=True)
            h = _bf(onehot) @ first_wb + W['first_b']
        else:
            h = x[:, None] * W['first_w'][0] + W['first_b']
    if return_state:
        return audio, params, (rings, h.contiguous(), t_base + T)
    return audio, params


# the packed weights in the order of the kernel's pointer arguments (w_fused and
# b_fused are null pointers for the plain chain, which packs none)
KERNEL_WEIGHTS = ('first_w', 'first_b', 'w_tap', 'b_tap', 'w_os', 'b_os', 'w_fused',
                  'b_fused', 'w_cond', 'b_cond', 'w_s1', 'b_s1', 'w_s2', 'b_s2')


def packed_layout(hp) -> Dict[str, Tuple[torch.dtype, Tuple[int, ...]]]:
    """name -> (dtype, shape) of what `pack_params` returned for the sizes of `hp`,
    as it recorded them; raises if nothing was packed at these sizes."""
    layout = _PACKED_LAYOUTS.get(_layout_key(hp))
    if layout is None:
        raise ValueError('no weights were packed at these sizes: call pack_params first')
    return layout


def _kernel_fn(library: Optional[ctypes.CDLL] = None):
    """The kernel's C entry, of the port's library unless another build of the same
    source is given; its head and fused arguments pick the instantiation."""
    from ._build import load_library
    fn = (library or load_library()).wavenet_ar
    fn.argtypes = ([ctypes.c_void_p] * 22 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 15
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_tensor(name: str, t: Tensor, dtype, shape, device, align: int = 0) -> None:
    """Raise unless `t` has this device, dtype and shape, is contiguous, and (with
    `align`) starts on an `align`-byte boundary: the kernel reads the packed bf16
    weight rows as 16-byte vectors, and everything else one float at a time, so a
    chunk of c_up or noise may start anywhere."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {tuple(shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    if align and t.data_ptr() % align:
        raise ValueError(f'{name} must start on a {align}-byte boundary')


def generate_ar(weights: Dict[str, Tensor], c_up: Tensor, noise: Tensor, hp,
                return_params: bool = True,
                state_in: Optional[Tuple[Tensor, Tensor, int]] = None,
                return_state: bool = False, g_cond: Optional[Tensor] = None):
    """AR generation (counterpart of `generate_ar`, `wavenet_ar.py:515-712`).

    On a CUDA tensor this launches the hand-written kernel once for all T steps; on a
    CPU tensor it runs `generate_ar_reference`. The kernel's limits: one block of 1024
    threads per sequence; R a multiple of 8; G, R+S and S multiples of 8 whose
    eighths divide 1024; at most MAX_CLASSES classes; f32 `c_up` (B, T, cin), `noise`
    (`noise_shape`: (B, T) Gaussian, (B, T, nr+1) MoL, (B, T, Q) categorical) and
    `g_cond` ((B, L*G) from `pack_global`, or None), contiguous.

    state_in / return_state: streaming, as in `generate_ar_reference`. The state
    passed in is consumed: the kernel updates its rings in place (no copy) and
    returns that tensor in the new state. Any T may be streamed; the TPU kernel's
    `T % 128 == 0` rule guarded its slab padding, which this kernel does not have.

    Returns: (audio (B, T), params (B, T, out_channels) or None[, state]); the
        categorical head's audio is int64 class ids (the kernel writes them as floats).
    """
    global LAUNCHES
    check_supported(hp)
    if c_up.device.type == 'cpu':
        return generate_ar_reference(weights, c_up, noise, hp, return_params=return_params,
                                     state_in=state_in, return_state=return_state,
                                     g_cond=g_cond)
    if c_up.device.type != 'cuda':
        raise ValueError(f'generate_ar runs on CPU or CUDA tensors, not {c_up.device}')
    device = c_up.device
    if c_up.dim() != 3:
        raise ValueError(f'c_up must be (B, T, cin), got {tuple(c_up.shape)}')
    B, T, cin = c_up.shape
    if cin != hp.cin_channels:
        raise ValueError(f'c_up has {cin} channels, hp.cin_channels={hp.cin_channels}')
    _check_tensor('c_up', c_up, torch.float32, (B, T, cin), device)
    _check_tensor('noise', noise, torch.float32, noise_shape(hp, B, T), device)
    layout = packed_layout(hp)
    if set(weights) != set(layout):
        raise ValueError(f'weights hold {sorted(weights)}, pack_params gives {sorted(layout)}')
    for name in layout:
        _check_tensor(name, weights[name], *layout[name], device, align=16)
    if g_cond is not None:
        _check_tensor('g_cond', g_cond, torch.float32, (B, hp.layers * hp.gate_channels),
                      device)
    n_ring = ring_floats(hp)
    if state_in is None:  # fresh: the kernel zeroes the rings and starts from first_b
        rings, h_in, t_base = torch.empty(B, n_ring, device=device), None, 0
    else:
        t_base = _check_state(state_in, hp, B, device)
        rings, h_in = state_in[0], state_in[1]

    fn = _kernel_fn()
    audio = torch.empty(B, T, device=device)
    params = torch.empty(B, T, hp.out_channels, device=device) if return_params else None
    h_out = torch.empty(B, hp.residual_channels, device=device) if return_state else None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(c_up.data_ptr(), noise.data_ptr(),
                 *[weights[name].data_ptr() if name in weights else None
                   for name in KERNEL_WEIGHTS],
                 g_cond.data_ptr() if g_cond is not None else None,
                 rings.data_ptr(), h_in.data_ptr() if h_in is not None else None,
                 h_out.data_ptr() if h_out is not None else None, audio.data_ptr(),
                 params.data_ptr() if params is not None else None,
                 n_ring, t_base, B, T, cin, hp.layers, hp.layers // hp.stacks,
                 hp.residual_channels, hp.gate_channels, hp.skip_out_channels,
                 hp.kernel_size, hp.out_channels,
                 2 if is_categorical(hp) else 1 if is_mol(hp) else 0,
                 int(hp.wavenet_fused_ar), int(hp.legacy), int(hp.residual_legacy),
                 int(rounds_conditioning(B)),
                 float(hp.log_scale_min if is_mol(hp) else hp.log_scale_min_gauss), stream)
    if err != 0:
        raise RuntimeError(f'wavenet_ar launch failed: CUDA error {err}')
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant(hp, g_cond is not None)] += 1
    if is_categorical(hp):
        audio = audio.long()
    if return_state:
        return audio, params, (rings, h_out, t_base + T)
    return audio, params
