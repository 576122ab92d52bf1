"""WaveNet autoregressive generation: packed weights, noise, the plain PyTorch version
and the wrapper of the hand-written Hopper kernel (`csrc/wavenet_ar.cu`).

Counterpart of `tacotron2_tpu/ops/pallas/wavenet_ar.py` for these variants: scalar
input (raw or mu-law) with a Gaussian head (`out_channels == 2`) or a mixture of nr
logistics (MoL, `out_channels == 3*nr`: the paper profile's 30); one-hot input
(`mulaw-quantize`) with a categorical head over `out_channels == quantize_channels`
classes, up to MAX_CLASSES, the big-vocab variant past SMALL_VOCAB (`is_big_vocab`); the
in-kernel natural-eval NLL of both categorical heads (`y_eval`); the fused critical path (`wavenet_fused_ar=True`: layer
l-1's residual 1x1 folded into layer l's current-tap conv, one serial matmul + GLU per
layer) or the plain chain (two serial matmuls per layer); local conditioning, with or
without a global conditioning bias `g_cond` (`pack_global`); a fresh call or a
streamed continuation (`state_in` / `return_state`). Anything else raises.

Noise. The Gaussian head takes (B, T) standard-normal noise. The MoL head takes
(B, T, nr+1): column 0 logistic noise for the sample, columns 1..nr Gumbel noise for
the choice of mixture. The categorical head takes (B, T, Q) Gumbel noise, one value a
class (`make_noise`). Its audio is class ids (int64); `ops/mulaw.inv_mulaw_quantize`
decodes them. The big-vocab head (more than SMALL_VOCAB classes) takes no noise tensor,
which would be (B, T, 65536): it draws its Gumbel noise from `seed`, one value for each
(sequence, absolute step, class) by Philox4x32-10 (`philox_gumbel`, the same bits in
the kernel and in the plain version), or none with `greedy`. Its first conv and last
head layer are packed in bf16, and it returns no params: `y_eval` asks for the per-step
NLL of given class ids instead.

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
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..models.wavenet.model import WaveNet
from ..utils import round_up
from .mulaw import is_mulaw_quantize

SQRT_HALF = float(math.sqrt(0.5))
GRAPH_WARMUP = 2  # steps of generate_ar_reference run eagerly before its graph's capture
# most classes of the small categorical head: its noise and params are (B, T, Q)
# tensors, and the kernel gives each class a thread of its 1024; past that the big-vocab
# head, up to MAX_CLASSES (16-bit audio)
SMALL_VOCAB = 1024
MAX_CLASSES = 65536

# kernel launches made by generate_ar (the plain version never counts), in all, by
# instantiation (`variant`) and by layout (N CTAs a cluster, P sequences a cluster)
LAUNCHES = 0
LAUNCHES_BY_VARIANT: Dict[str, int] = collections.Counter()
LAUNCHES_BY_LAYOUT: Dict[Tuple[int, int], int] = collections.Counter()
# the cluster sizes the kernel takes, largest first (`cluster_size`)
CLUSTER_SIZES = (16, 8, 4, 2, 1)
# the occupancy table's key of clusters of 2 CTAs that run two sequences each
PAIRS = 'pairs'

# name -> (dtype, shape) of each packed weight, as pack_params made them, by sizes
_PACKED_LAYOUTS: Dict[Tuple[int, ...], Dict[str, Tuple[torch.dtype, Tuple[int, ...]]]] = {}


def _layout_key(hp) -> Tuple[int, ...]:
    return (hp.layers, hp.residual_channels, hp.gate_channels, hp.skip_out_channels,
            hp.kernel_size, hp.cin_channels, hp.out_channels, int(is_categorical(hp)),
            int(is_big_vocab(hp)), int(hp.wavenet_fused_ar))


def check_supported(hp) -> None:
    """Raise unless `hp` is a configuration the port's AR path covers."""
    problems = []
    if is_categorical(hp):
        if hp.out_channels != hp.quantize_channels:
            problems.append(f'out_channels={hp.out_channels} != quantize_channels='
                            f'{hp.quantize_channels} (one logit a class)')
        if hp.out_channels > MAX_CLASSES:
            problems.append(f'out_channels={hp.out_channels} > {MAX_CLASSES} classes')
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


def is_big_vocab(hp) -> bool:
    """Whether the categorical head has too many classes to take pre-sampled noise and
    to return params (counterpart of `is_big_vocab`, `wavenet_ar.py:67-69`)."""
    return is_categorical(hp) and hp.out_channels > SMALL_VOCAB


def is_mol(hp) -> bool:
    """Whether the head is the mixture of logistics (scalar input, out_channels =
    3*nr), not the Gaussian (2) or the categorical."""
    return not is_categorical(hp) and hp.out_channels != 2


def variant(hp, has_g: bool = False, nll: bool = False) -> str:
    """Name of the kernel instantiation that runs `hp`: head-chain, '+g' with a global
    conditioning bias, '+nll' with the in-kernel NLL."""
    head = ('categorical_big' if is_big_vocab(hp) else 'categorical' if is_categorical(hp)
            else 'mol' if is_mol(hp) else 'gaussian')
    return (f"{head}-{'fused' if hp.wavenet_fused_ar else 'plain'}{'+g' if has_g else ''}"
            f"{'+nll' if nll else ''}")


def noise_shape(hp, B: int, T: int) -> Tuple[int, ...]:
    """(B, T) for the Gaussian head, (B, T, nr+1) for MoL, (B, T, Q) for the
    categorical, (B, T, 1) for the big-vocab head (a placeholder: it reads no noise)."""
    if is_big_vocab(hp):
        return (B, T, 1)
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
    columns), which stay f32 as in the JAX packing up to SMALL_VOCAB classes; past that
    both are bf16 (`wavenet_ar.py:107-110, 163`) and `w_s2` is (S, round_up(Q, 8)), its
    columns zero-padded so that every row starts on a 16-byte boundary. The weights are
    the modules' effective ones: a weight-normalized module's `.weight` is g * v / ||v||.
    `w_cond` keeps cin rows (no lane padding). With wavenet_fused_ar=False there is no fold, and
    `w_fused` and `b_fused` are left out (the JAX packing ships stubs there).
    What is already f32 and contiguous (the biases of the first conv and the head) is
    the model's own tensor, not a copy: pack again after the model's weights change."""
    check_supported(hp)
    L, R, G = hp.layers, hp.residual_channels, hp.gate_channels
    S, k = hp.skip_out_channels, hp.kernel_size
    past = (k - 1) * R
    w = {}
    fc = model.first_conv
    big = is_big_vocab(hp)
    w['first_w'] = fc.weight.detach().float().t().contiguous()        # (1 or Q, R)
    if big:
        w['first_w'] = w['first_w'].bfloat16()
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
    if big:
        pad = round_up(hp.out_channels, 8) - hp.out_channels
        w['w_s2'] = F.pad(w['w_s2'], (0, pad)).bfloat16().contiguous()
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
    upper end is the largest f32 below 1 instead. The big-vocab head reads no noise:
    a (B, T, 1) placeholder of zeros (`wavenet_ar.py:718-720`); give `generate_ar` a seed
    (`draw_seed`)."""
    dev = generator.device
    if is_big_vocab(hp):
        eps = torch.zeros(B, T, 1, device=dev)
    elif is_categorical(hp):
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


def draw_seed(generator: torch.Generator) -> int:
    """A seed in [0, 2**63) for the big-vocab head's noise, drawn from `generator`."""
    return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                             device=generator.device).item())


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)  # Philox4x32's multipliers
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)  # ... and the key's increments (Weyl sequence)
_U32 = 0xFFFFFFFF


def _mul_hi_lo(m: int, x: Tensor) -> Tuple[Tensor, Tensor]:
    """(high, low) 32 bits of the product of the 32-bit constant m and the 32-bit
    values x (int64 tensors): through 16-bit halves of x, so that nothing passes 2**63."""
    lo16, hi16 = (x & 0xFFFF) * m, (x >> 16) * m
    return (hi16 + (lo16 >> 16)) >> 16, (((hi16 & 0xFFFF) << 16) + (lo16 & _U32)) & _U32


def philox4x32_10(counter: Sequence[Tensor], key: Sequence[int]) -> List[Tensor]:
    """Philox4x32 with 10 rounds (Salmon et al., "Parallel random numbers: as easy as
    1, 2, 3", 2011) in integer tensor ops: `counter` four int64 tensors of 32-bit values
    that broadcast together, `key` two 32-bit ints; returns the four output words as
    int64 tensors. The kernel (`csrc/wavenet_ar.cu`) holds the same function."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(_PHILOX_M[0], c0)
        hi1, lo1 = _mul_hi_lo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
    return [c0, c1, c2, c3]


def gumbel_from_bits(bits: Tensor) -> Tensor:
    """32 random bits (int64 tensor) -> Gumbel noise in f32, by the TPU kernel's
    transform (`wavenet_ar.py:433-440`): the top 23 bits as the mantissa of a float in
    [1, 2), minus 1, is u in [0, 1); then -log(-log(u + 1e-9) + 1e-9), finite at both
    ends (-3.03 at u = 0, 15.9 at the largest u)."""
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return -torch.log(-torch.log(u + 1e-9) + 1e-9)


def philox_bits(seed: int, B: int, t_abs, Q: int, device) -> Tensor:
    """The random bits of `philox_gumbel`, (B, Q) int64 tensor of 32-bit values; t_abs
    an int or an int64 tensor of one element on `device`."""
    n4 = -(-Q // 4)
    t_abs = torch.as_tensor(t_abs, dtype=torch.int64, device=device).reshape(1, 1)
    counter = (torch.arange(n4, device=device)[None, :], t_abs & _U32, (t_abs >> 32) & _U32,
               torch.arange(B, device=device)[:, None])
    words = philox4x32_10(counter, (seed & _U32, (seed >> 32) & _U32))
    bits = torch.stack([w.expand(B, n4) for w in words], dim=-1).reshape(B, 4 * n4)
    return bits[:, :Q]


def philox_gumbel(seed: int, B: int, t_abs, Q: int, device) -> Tensor:
    """The big-vocab head's Gumbel noise of absolute step t_abs, (B, Q) f32: for
    sequence b and class c, word c % 4 of Philox4x32-10 with the 64-bit `seed` as its
    key and (c // 4, t_abs low and high 32 bits, b) as its counter. A function of
    (seed, sequence, absolute step, class) alone, so a state-carried stream that keeps
    its seed draws the noise of one call."""
    return gumbel_from_bits(philox_bits(seed, B, t_abs, Q, device))


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


@functools.cache
def _graph_stream(index: int) -> 'torch.cuda.Stream':
    """The side stream of device `index` on which generate_ar_reference captures its
    graphs: one a process, since each stream that runs a cuBLAS call keeps a workspace
    of its own until the process ends."""
    return torch.cuda.Stream(index)


@torch.no_grad()
def generate_ar_reference(weights: Dict[str, Tensor], c_up: Tensor, noise: Tensor, hp,
                          targets: Optional[Tensor] = None, return_params: bool = True,
                          state_in: Optional[Tuple[Tensor, Tensor, int]] = None,
                          return_state: bool = False, g_cond: Optional[Tensor] = None,
                          seed: Optional[int] = None, greedy: bool = False,
                          y_eval: Optional[Tensor] = None, return_drawn: bool = False,
                          graph: Optional[bool] = None):
    """Plain PyTorch AR generation with the kernel's arithmetic.

    Mirrors the step of `wavenet_ar.py:303-465` on the packed weights, the fused
    chain or the plain one (`:342-361`): bf16-rounded matmul operands, f32 products
    and sums, the same order of operations. `targets` (B, T), when given, replaces
    each sample fed back (teacher forcing, as `models/wavenet/model.py:285-286`), so
    per-step params can be compared on an identical history.

    The categorical head starts from the f32 first-conv row of class Q // 2
    (`:262-265`) and feeds back bf16(one-hot) @ bf16(first_w) + first_b (`:441-448`),
    the one-hot of every class that ties the largest logit + noise divided by their
    count; the class id emitted is the first of them. The big-vocab head reads both
    rows from its bf16 first_w, rounds the head's input to bf16 before the bf16 w_s2
    (`:414`), and adds `philox_gumbel(seed, ...)` of the absolute step, or nothing with
    `greedy`; it returns no params. With `y_eval` (B, T) class ids, either categorical
    head returns, in place of the params, the per-step NLL logsumexp(logits) -
    logits[y_eval] of its un-noised logits (`:470-481`), (B, T) f32.

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
        return_drawn: with `targets`, return as audio what the head drew at each step
            (the targets are still what is fed back): how a head that returns no
            params is compared on an identical history.
        graph: capture one step in a CUDA graph after the first GRAPH_WARMUP and replay
            it for the rest (the same kernels, without the host's few microseconds a
            kernel); None does so on a CUDA device. The step reads its index from the
            device, so nothing of it is baked into the graph.
    Returns: (audio (B, T), params (B, T, out_channels) or nll (B, T) or None
        [, state]); audio holds the fed-back samples, floats or int64 class ids.
    """
    _check_call(hp, return_params, seed, greedy, y_eval)
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
    categorical, big = is_categorical(hp), is_big_vocab(hp)
    if categorical:
        Q = hp.out_channels
        first_wb = _bf(W['first_w'])
        W['w_s2'] = W['w_s2'][:, :Q]  # the big-vocab packing pads the columns
    nll = torch.empty(B, T, device=dev) if y_eval is not None else None
    if state_in is None:
        rings = torch.zeros(B, ring_floats(hp), device=dev)
        h = W['first_b'].expand(B, R)
        if categorical:  # silence is class Q // 2; its row is read in f32 (big: bf16)
            h = W['first_w'][Q // 2] + h
        t_base = 0
    else:
        t_base = _check_state(state_in, hp, B, dev)
        rings, h = state_in[0], state_in[1]
    h = h.contiguous().clone()  # the layer stack's input, updated in place at each step
    bufs = [rings[:, off:off + win * R].view(B, win, R) for off, win in layout]
    # the step t lives on the device, so that a step reads and writes where t says
    # without the host: tap x(t-m) of layer li lives at slot (t_base + t - m) mod win
    # (wavenet_ar.py:317-326), its input goes to slot (t_base + t) mod win
    t_dev = torch.zeros((), dtype=torch.int64, device=dev)
    tap_slots = [torch.tensor([t_base % win + win - (k - 1 - j) * d for j in range(k - 1)],
                              device=dev) for win, d in zip(wins, dils)]
    write_slots = [torch.tensor([t_base % win], device=dev) for win in wins]
    round_cond = rounds_conditioning(B)
    audio = torch.empty(B, T, device=dev, dtype=torch.long if categorical else None)
    params = torch.empty(B, T, hp.out_channels, device=dev) if return_params else None
    c_up = c_up.float()

    def read_taps(li):
        """Layer li's k - 1 past taps, oldest first, side by side: (B, (k - 1) * R)."""
        return bufs[li].index_select(1, (tap_slots[li] + t_dev) % wins[li]).reshape(B, past)

    def write_ring(li, x):
        # the layer's input overwrites the oldest slot, after its taps are read
        bufs[li].index_copy_(1, (write_slots[li] + t_dev) % wins[li], x[:, None])

    def plain_chain(h, cond):
        """The layer stack as two serial matmuls per layer (wavenet_ar.py:342-361);
        returns the skip sum."""
        skips = torch.zeros(B, S, device=dev)
        for li in range(L):
            tap_cat = _bf(torch.cat([read_taps(li), h], dim=1))
            write_ring(li, h)
            z = tap_cat @ W['w_tap'][li] + W['b_tap'][li]
            z = z + cond[:, li * G:(li + 1) * G]
            y = _bf(_glu(z, half)) @ W['w_os'][li] + W['b_os'][li]
            h = (y[:, :R] + h) * rho
            skips = skips + y[:, R:]
            if hp.legacy and li > 0:  # the first skip enters unscaled
                skips = skips * SQRT_HALF
        return skips

    def fused_chain(h, cond):
        """The layer stack with one serial matmul per layer (wavenet_ar.py:362-408);
        returns the skip sum."""
        skips = torch.zeros(B, S, device=dev)
        consts = []
        for li in range(L):
            p = W['b_tap'][li] + W['b_fused'][li] + cond[:, li * G:(li + 1) * G]
            consts.append(p + _bf(read_taps(li)) @ W['w_tap'][li, :past])
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
            write_ring(li, hs[li])
        return skips

    layer_stack = fused_chain if hp.wavenet_fused_ar else plain_chain

    def step():
        """Step t_dev: reads the inputs at t, writes the outputs at t, the rings and h,
        and moves t_dev on by one."""
        t1 = t_dev.view(1)
        cond = _bf(c_up.index_select(1, t1)[:, 0]) @ W['w_cond'] + W['b_cond']
        if g_cond is not None:
            cond = cond + g_cond
        if round_cond:  # the TPU kernel's bf16 conditioning slab (wavenet_ar.py:292-301)
            cond = _bf(cond)
        skips = layer_stack(h, cond)
        o = torch.relu(skips)
        o = torch.relu(_bf(o) @ W['w_s1'] + W['b_s1'])
        params_t = (_bf(o) if big else o) @ W['w_s2'] + W['b_s2']
        if big:
            noise_t = 0.0 if greedy else philox_gumbel(seed, B, t_base + t_dev, Q, dev)
            x = (params_t + noise_t).argmax(-1)
        else:
            noise_t = noise.index_select(1, t1)[:, 0]
            x = sample(params_t, noise_t, hp)
        if nll is not None:
            y_t = y_eval.index_select(1, t1).long()
            nll.index_copy_(1, t1, (torch.logsumexp(params_t, -1)
                                    - params_t.gather(-1, y_t)[:, 0])[:, None])
        drawn = x
        if targets is not None:
            x = targets.index_select(1, t1)[:, 0].to(x.dtype)
        audio.index_copy_(1, t1, (drawn if return_drawn else x)[:, None])
        if params is not None:
            params.index_copy_(1, t1, params_t[:, None])
        if categorical:
            if targets is not None:
                onehot = F.one_hot(x, Q).float()
            else:  # every class that ties the maximum, 1/count each
                scores = params_t + noise_t
                onehot = (scores >= scores.max(-1, keepdim=True).values).float()
                onehot = onehot / onehot.sum(-1, keepdim=True)
            h.copy_(_bf(onehot) @ first_wb + W['first_b'])
        else:
            h.copy_(x[:, None] * W['first_w'][0] + W['first_b'])
        t_dev.add_(1)

    if graph is None:
        graph = dev.type == 'cuda'
    elif graph and dev.type != 'cuda':
        raise ValueError(f'a CUDA graph needs CUDA tensors, not tensors on {dev}')
    if graph and T > GRAPH_WARMUP:
        # the first steps run as they are, on a side stream (which readies the libraries'
        # handles there), the next one is captured and replayed for the rest: the same
        # kernels in the same order, launched without the host's time a kernel
        side, main = _graph_stream(dev.index), torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                step()
        main.wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side, capture_error_mode='thread_local'):
            step()
        for _ in range(T - GRAPH_WARMUP):
            g.replay()
    else:
        for _ in range(T):
            step()
    second = nll if nll is not None else params
    if return_state:
        return audio, second, (rings, h, t_base + T)
    return audio, second


def _check_call(hp, return_params: bool, seed: Optional[int], greedy: bool,
                y_eval: Optional[Tensor]) -> None:
    """The rules of `generate_ar`'s options (the asserts of `wavenet_ar.py:559-574`)."""
    if y_eval is not None:
        if not is_categorical(hp):
            raise ValueError('y_eval (the in-kernel NLL) is for the categorical head')
        if return_params:
            raise ValueError('y_eval replaces the params: pass return_params=False')
    if is_big_vocab(hp):
        if return_params:
            raise ValueError('the big-vocab categorical head returns no params (a '
                             '(B, T, Q) tensor): pass return_params=False, and y_eval '
                             'for the NLL')
        if not greedy and seed is None:
            raise ValueError('the big-vocab categorical head ignores `noise` and draws '
                             'its own from a seed: pass seed, or greedy=True')
        if seed is not None and not 0 <= int(seed) < 2 ** 64:
            raise ValueError(f'seed must be in [0, 2**64), got {seed}')
    elif greedy:
        raise ValueError('greedy=True is for the big-vocab categorical head only')


def _check_y_eval(y_eval: Tensor, hp, B: int, T: int, device) -> Tensor:
    """y_eval as the kernel reads it: (B, T) int32 class ids in [0, Q), contiguous."""
    if y_eval.device != device:
        raise ValueError(f'y_eval is on {y_eval.device}, expected {device}')
    if tuple(y_eval.shape) != (B, T) or y_eval.is_floating_point():
        raise ValueError(f'y_eval must be (B, T) = {(B, T)} class ids, got '
                         f'{tuple(y_eval.shape)} {y_eval.dtype}')
    lo, hi = int(y_eval.min()), int(y_eval.max())
    if lo < 0 or hi >= hp.out_channels:
        raise ValueError(f'y_eval holds class ids in [{lo}, {hi}], outside '
                         f'[0, {hp.out_channels})')
    return y_eval.to(torch.int32).contiguous()


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
    fn.argtypes = ([ctypes.c_void_p] * 24 + [ctypes.c_longlong] * 2 + [ctypes.c_ulonglong]
                   + [ctypes.c_int] * 19 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def cluster_size(B: int, occupancy: Dict[int, int]) -> int:
    """The CTAs that run each of B sequences: the largest N in CLUSTER_SIZES of which
    the card keeps at least B clusters resident at once (`occupancy`: N -> clusters,
    0 where N does not split the widths or the shared memory does not fit), so that
    every sequence of the batch runs at once on N SMs; else 1, one SM a sequence,
    the layout of a large batch (clusters of one need not be resident together)."""
    for n in CLUSTER_SIZES:
        if occupancy.get(n, 0) >= B:
            return n
    return 1


def cluster_layout(B: int, occupancy: Dict, fused: bool) -> Tuple[int, int]:
    """(N, P): the CTAs a cluster and the sequences a cluster for B sequences. Where
    `cluster_size` would run one SM a sequence (N = 1) on the fused chain, two sequences
    share each cluster of two (N = 2, P = 2: each CTA half the columns of both, each
    weight loaded once for both), if the card keeps ceil(B/2) such clusters resident
    (`occupancy[PAIRS]`, asked at their shared-memory size; 0 where the kernel admits
    none: off its SMALL layout, the defaults' widths with any head but the big one);
    else (cluster_size(B), 1). The fused chain only: there two sequences were measured
    faster than one SM a sequence (an H100 SXM at 700 W, B=132, `probes/ar_split.py`
    beside the one-sequence build: Gaussian 187.2 against 208.7 µs a step, MoL 190.2
    against 218.3, categorical with the NLL 191.1 against 213.8), on the plain chain
    slower (195.9 against 192.0); a forced `sequences=2` runs either chain."""
    n = cluster_size(B, occupancy)
    if n == 1 and fused and occupancy.get(PAIRS, 0) >= -(-B // 2):
        return 2, 2
    return n, 1


@functools.cache
def occupancy_table(hp_key: Tuple[int, ...], head: int, fused: bool, nll: bool,
                    device_index: int) -> Dict[int, int]:
    """N -> clusters of N CTAs that the card keeps resident for this instantiation at
    these widths (`hp_key`: cin, L, R, G, S, k), asked of the kernel's library
    (cudaOccupancyMaxActiveClusters); 0 where N does not split the widths. Under PAIRS,
    clusters of 2 CTAs that run two sequences each (0 where the kernel admits none)."""
    from ._build import load_library
    fn = load_library().wavenet_ar_occupancy
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        fn(*hp_key, head, int(fused), int(nll), ctypes.addressof(occ))
    return {**{1 << i: int(occ[i]) for i in range(5)}, PAIRS: int(occ[5])}


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
                return_state: bool = False, g_cond: Optional[Tensor] = None,
                seed: Optional[int] = None, greedy: bool = False,
                y_eval: Optional[Tensor] = None, cluster: Optional[int] = None,
                sequences: Optional[int] = None):
    """AR generation (counterpart of `generate_ar`, `wavenet_ar.py:515-712`).

    On a CUDA tensor this launches the hand-written kernel once for all T steps; on a
    CPU tensor it runs `generate_ar_reference`. The kernel runs P sequences on each
    cluster of N CTAs, (N, P) = `cluster_layout(B, occupancy_table(...), fused)`
    unless `cluster` forces N, one of CLUSTER_SIZES (then P = 1; raising if the card
    keeps no such cluster resident or N does not split G/2, R and S), or `sequences`
    forces P: 1 (with N as `cluster_size` gives it, or `cluster`), or 2 (N = 2; raising
    where the widths, the head or the card do not admit two sequences a cluster). The
    outputs do not depend on N or P (bit for bit). Its limits: R, G and S
    multiples of 8; at most MAX_CLASSES classes; f32 `c_up` (B, T, cin), `noise`
    (`noise_shape`: (B, T) Gaussian, (B, T, nr+1) MoL, (B, T, Q) categorical, the
    (B, T, 1) placeholder for the big-vocab head) and `g_cond` ((B, L*G) from
    `pack_global`, or None), contiguous. Any batch size (the TPU kernel's cap of 8 at
    big vocab was its VMEM budget).

    seed / greedy (big-vocab head only, one of them required): the 64-bit key of the
    in-kernel noise (`philox_gumbel`; keep it over the chunks of a stream), or arg-max
    without noise. y_eval: (B, T) class ids in [0, Q) (checked: a synchronisation) for a
    categorical head with return_params=False; the second output is then the per-step
    NLL (B, T). The rules of `wavenet_ar.py:559-574` raise ValueError here.

    state_in / return_state: streaming, as in `generate_ar_reference`. The state
    passed in is consumed: the kernel updates its rings in place (no copy) and
    returns that tensor in the new state. Any T may be streamed; the TPU kernel's
    `T % 128 == 0` rule guarded its slab padding, which this kernel does not have.

    Returns: (audio (B, T), params (B, T, out_channels) or nll (B, T) or None
        [, state]); the categorical heads' audio is int64 class ids (the kernel writes
        them as floats).
    """
    global LAUNCHES
    check_supported(hp)
    _check_call(hp, return_params, seed, greedy, y_eval)
    if y_eval is not None:
        y_eval = _check_y_eval(y_eval, hp, c_up.shape[0], c_up.shape[1], c_up.device)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f'cluster must be one of {CLUSTER_SIZES}, got {cluster}')
    if sequences not in (None, 1, 2) or (sequences == 2 and cluster not in (None, 2)):
        raise ValueError(f'sequences must be 1, or 2 on a cluster of 2 CTAs, got '
                         f'sequences={sequences}, cluster={cluster}')
    if c_up.device.type == 'cpu':
        return generate_ar_reference(weights, c_up, noise, hp, return_params=return_params,
                                     state_in=state_in, return_state=return_state,
                                     g_cond=g_cond, seed=seed, greedy=greedy, y_eval=y_eval)
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

    big = is_big_vocab(hp)
    head = 3 if big else 2 if is_categorical(hp) else 1 if is_mol(hp) else 0
    occupancy = occupancy_table(
        (cin, hp.layers, hp.residual_channels, hp.gate_channels, hp.skip_out_channels,
         hp.kernel_size), head, bool(hp.wavenet_fused_ar), y_eval is not None,
        device.index if device.index is not None else torch.cuda.current_device())
    if sequences == 2:
        if occupancy[PAIRS] == 0:
            raise ValueError('two sequences a cluster are not admitted here (the large '
                             f'batch\'s layout only): clusters resident {occupancy}')
        cluster = 2
    elif cluster is None and sequences is None:
        cluster, sequences = cluster_layout(B, occupancy, bool(hp.wavenet_fused_ar))
    elif cluster is None:
        cluster = cluster_size(B, occupancy)
    elif occupancy[cluster] == 0:
        raise ValueError(f'a cluster of {cluster} CTAs is not admitted here: clusters '
                         f'resident by size {occupancy}')
    sequences = sequences or 1
    fn = _kernel_fn()
    audio = torch.empty(B, T, device=device)
    params = torch.empty(B, T, hp.out_channels, device=device) if return_params else None
    h_out = torch.empty(B, hp.residual_channels, device=device) if return_state else None
    nll = torch.empty(B, T, device=device) if y_eval is not None else None
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(c_up.data_ptr(), noise.data_ptr(),
                 *[weights[name].data_ptr() if name in weights else None
                   for name in KERNEL_WEIGHTS],
                 g_cond.data_ptr() if g_cond is not None else None,
                 rings.data_ptr(), h_in.data_ptr() if h_in is not None else None,
                 h_out.data_ptr() if h_out is not None else None, audio.data_ptr(),
                 params.data_ptr() if params is not None else None,
                 y_eval.data_ptr() if y_eval is not None else None,
                 nll.data_ptr() if nll is not None else None,
                 n_ring, t_base, int(seed or 0), B, T, cin, hp.layers,
                 hp.layers // hp.stacks,
                 hp.residual_channels, hp.gate_channels, hp.skip_out_channels,
                 hp.kernel_size, hp.out_channels, head,
                 int(hp.wavenet_fused_ar), int(hp.legacy), int(hp.residual_legacy),
                 int(rounds_conditioning(B)),
                 weights['w_s2'].shape[1] if big else 0, int(greedy), cluster, sequences,
                 float(hp.log_scale_min if is_mol(hp) else hp.log_scale_min_gauss), stream)
    if err != 0:
        raise RuntimeError(f'wavenet_ar launch failed: CUDA error {err} (B={B}, a cluster '
                           f'of {cluster} CTAs, {sequences} sequence(s) a cluster; '
                           f'clusters resident {occupancy})')
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant(hp, g_cond is not None, nll is not None)] += 1
    LAUNCHES_BY_LAYOUT[cluster, sequences] += 1
    if is_categorical(hp):
        audio = audio.long()
    second = nll if nll is not None else params
    if return_state:
        return audio, second, (rings, h_out, t_base + T)
    return audio, second
