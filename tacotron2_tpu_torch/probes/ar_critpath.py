"""B9: the WaveNet AR layer stack's step alone, two chains and four GLU forms, on the H100.

Counterpart of `scripts/dev_pallas_ar_critpath.py:35-205` (`build`, its
`pl.pallas_call` at :197): L=20 layers (dilation 2**(i % 10)), R=128, G=256, S=128,
kernel width K=3, B=8 rows, T=2,048 steps, weights ~N(0, 0.05) in bf16 and a f32
conditioning row, one f32 ring buffer (2d, B, R) a layer starting at zero, `prev`
starting at 0.01. No conditioning upsampler, no head, no feedback conv: what is left of
the AR kernel's step is its layer stack, so this times that share of it.

Variants (the step bodies, `:98-120` and `:127-175`; the GLU forms, `:45-87`):
    base            per layer [taps | h] @ w_tap -> GLU -> @ w_os: two dependent
                    matmuls a layer
    fused           one matmul a layer on the dependency chain: the past taps'
                    products up front, then z_{l-1} @ w_fused + h_{l-2} @ w_cur
    fused_bf16glu   ... the GLU's transcendentals in bf16
    fused_tanhsig   ... sigmoid(y) as 0.5 + 0.5 tanh(y / 2)
    fused_tanhfold  ... tanh of the whole gate vector, with no y / 2 (the probe's weights
                    are not pre-scaled): t[:H] * (0.5 + 0.5 t[H:])
    fused_tf_bf16o  ... that tanh rounded to bf16 and combined in bf16
`base` and `fused` draw their weights alike but use different ones, so they compute
different functions: compare each with its own plain version, never with each other.
The activations that feed a matmul are rounded to bf16 (f32 accumulation), as there.
The output is `prev` after T steps, (B, R) f32, of order 1e-6 to 1e-5: judge it relative
to its own largest value.

    python -m tacotron2_tpu_torch.probes.ar_critpath [--device cpu] [--variants base,fused]
"""

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import Tensor

from ..ops.wavenet_ar import _check_tensor as check_tensor
from . import best_ms, bound_ms, cuda_device, device_of, entry, launch, parser

DIMS = dict(L=20, R=128, G=256, S=128, K=3, B=8)
T = 2048
VARIANTS = ('base', 'fused', 'fused_bf16glu', 'fused_tanhsig', 'fused_tanhfold',
            'fused_tf_bf16o')
GLU = {'base': 0, 'fused': 0, 'fused_bf16glu': 1, 'fused_tanhsig': 2, 'fused_tanhfold': 3,
       'fused_tf_bf16o': 4}  # the kernel's template argument
WEIGHTS = ('w_tap', 'w_os', 'w_fused', 'w_cur', 'w_out', 'w_skip')
REPS = 5
PLAIN_STEPS = 64  # the plain version runs 8-15 ms a step on the card: timed over these
LAUNCHES = 0  # kernel launches, counted where the wrapper launches
bf16, f32 = torch.bfloat16, torch.float32
# the kernel's layout (csrc/probes/ar_critpath.cu): 8 batch rows a cluster (the mma's n),
# R/8 CTAs a cluster, each owning 16 output columns (one M-tile) of every product
ROWS = 8
# the fields of a phase record of `schedule`, in the kernel's order (its enum Field)
RECORD = ('gate_layer', 'gate_z_tiles', 'gate_h_tiles', 'os_layer', 'os_last',
          'consts_layer', 'consts_next_step', 'ring_layer', 'hb_send', 'tile_off',
          'tile_count')
# (row, column) of the A fragment of mma.sync.m16n8k16 that element e of lane l holds:
# row l // 4 + A_ROW[e], column 2 (l % 4) + A_COL[e]
A_ROW = (0, 0, 8, 8, 0, 0, 8, 8)
A_COL = (0, 1, 0, 1, 8, 9, 8, 9)


def dilations(L: int) -> List[int]:
    return [2 ** (i % (L // 2)) for i in range(L)]


def make_inputs(seed: int = 0, L: int = DIMS['L'], R: int = DIMS['R'], G: int = DIMS['G'],
                S: int = DIMS['S'], K: int = DIMS['K'], B: int = DIMS['B'],
                device='cpu') -> Dict[str, Tensor]:
    """The script's draws (`:187-196`), in its order, from np.random.default_rng(seed):
    the six weights ~N(0, 0.05) in bf16, then cond (B, L*G) f32."""
    rng = np.random.default_rng(seed)
    half = G // 2
    shapes = dict(w_tap=(L, K * R, G), w_os=(L, half, R + S), w_fused=(L, half, G),
                  w_cur=(L, R, G), w_out=(L, half, R), w_skip=(L, half, S))
    out = {name: torch.from_numpy(rng.normal(0, 0.05, shapes[name])).to(bf16)
           for name in WEIGHTS}
    out['cond'] = torch.from_numpy(rng.normal(0, 0.05, (B, L * G)).astype(np.float32))
    return {k: v.to(device) for k, v in out.items()}


def dims_of(inputs: Dict[str, Tensor]) -> Dict[str, int]:
    L, KR, G = inputs['w_tap'].shape
    R = inputs['w_cur'].shape[1]
    return dict(L=L, R=R, G=G, S=inputs['w_skip'].shape[2], K=KR // R,
                B=inputs['cond'].shape[0])


def _mm(a: Tensor, w: Tensor) -> Tensor:
    """bf16(a) @ w with f32 accumulation (`jnp.dot(..., preferred_element_type=f32)`)."""
    return a.to(bf16).to(f32) @ w.to(f32)


def _sigmoid(x: Tensor) -> Tensor:
    return 1.0 / (1.0 + torch.exp(-x))  # the script's `one / (one + exp(-x))`, in x's type


def glu(z: Tensor, variant: str) -> Tensor:
    """The GLU form of `variant` on gates z (B, G) f32 (`:45-87`)."""
    half = z.shape[1] // 2
    if variant in ('base', 'fused'):
        return torch.tanh(z[:, :half]) * _sigmoid(z[:, half:])
    if variant == 'fused_bf16glu':
        zb = z.to(bf16)
        return torch.tanh(zb[:, :half]) * _sigmoid(zb[:, half:])
    if variant == 'fused_tanhsig':
        return torch.tanh(z[:, :half]) * (0.5 + 0.5 * torch.tanh(0.5 * z[:, half:]))
    if variant == 'fused_tanhfold':
        t = torch.tanh(z)
        return t[:, :half] * (0.5 + 0.5 * t[:, half:])
    if variant == 'fused_tf_bf16o':
        t = torch.tanh(z).to(bf16)
        return t[:, :half] * (0.5 + 0.5 * t[:, half:])
    raise ValueError(f'unknown variant {variant!r}; one of {VARIANTS}')


def plain(variant: str, inputs: Dict[str, Tensor], steps: int = T) -> Tensor:
    """The plain PyTorch version: `prev` (B, R) f32 after `steps` steps."""
    if variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r}; one of {VARIANTS}')
    d = dims_of(inputs)
    L, R, G, S, K, B = (d[k] for k in ('L', 'R', 'G', 'S', 'K', 'B'))
    w, cond, dev = inputs, inputs['cond'], inputs['cond'].device
    dils = dilations(L)
    wins = [(K - 1) * dl for dl in dils]
    bufs = [torch.zeros(win, B, R, device=dev) for win in wins]
    prev = torch.full((B, R), 0.01, device=dev)

    def taps(li, t):  # the K-1 past taps of layer li at step t (copies: read before written)
        win = wins[li]
        return [bufs[li][(t + win - (K - 1 - j) * dils[li]) % win].clone()
                for j in range(K - 1)]

    for t in range(steps):
        skips = torch.zeros(B, S, device=dev)
        if variant == 'base':
            h = prev
            for li in range(L):
                tap_cat = torch.cat(taps(li, t) + [h], dim=1)
                bufs[li][t % wins[li]] = h
                z = _mm(tap_cat, w['w_tap'][li]) + cond[:, li * G:(li + 1) * G]
                y = _mm(glu(z, variant), w['w_os'][li])
                h = h + y[:, :R]
                skips = skips + y[:, R:]
        else:
            h0 = prev
            consts = [_mm(torch.cat(taps(li, t), dim=1), w['w_tap'][li][:(K - 1) * R])
                      + cond[:, li * G:(li + 1) * G] for li in range(L)]
            z = glu(_mm(h0, w['w_cur'][0]) + consts[0], variant)
            h_prev, h_regs = h0, [h0]
            for li in range(1, L):
                zb = z.to(bf16)
                b_term = _mm(zb, w['w_fused'][li])
                a_term = _mm(h_prev, w['w_cur'][li])
                dh = _mm(zb, w['w_out'][li - 1])
                skips = skips + _mm(zb, w['w_skip'][li - 1])
                h_cur = h_prev + dh
                z = glu(b_term + a_term + consts[li], variant)
                h_prev = h_cur
                h_regs.append(h_cur)
            zb = z.to(bf16)
            skips = skips + _mm(zb, w['w_skip'][L - 1])
            h = h_prev + _mm(zb, w['w_out'][L - 1])
            for li in range(L):
                bufs[li][t % wins[li]] = h_regs[li]
        prev = h * 1e-4 + skips[:, :R] * 1e-6
    return prev


def schedule(chain: str, L: int) -> List[Dict[str, int]]:
    """The phases of a step of the kernel, each ended by one cluster barrier, as records
    of RECORD (but the tile fields, `pack`'s): `fused` L+1 phases (phase p: the gates of
    layer p, from z_{p-1} (p >= 1) and h_{p-1}; the residual and skip of layer p-1 (p >=
    1), the last one turning h and the skip sum into `prev`; h_p into ring p and every
    CTA; the consts of the next phase's gates: layer p+1, or layer 0 of the next step),
    `base` 2L (phase 2l: the gates of layer l from h_l, h_l into ring l; phase 2l+1: the
    residual and skip of layer l, h_{l+1} into every CTA, the consts of layer l+1 or of
    the next step's layer 0). A phase's gates read what the phase before exchanged and
    start from the consts computed in it."""
    def rec(**kw):
        r = dict(gate_layer=-1, gate_z_tiles=0, gate_h_tiles=0, os_layer=-1, os_last=0,
                 consts_layer=-1, consts_next_step=0, ring_layer=-1, hb_send=0)
        r.update(kw)
        return r
    if chain == 'fused':
        out = []
        for p in range(L + 1):
            r = rec(hb_send=1)
            if p < L:
                r.update(gate_layer=p, gate_z_tiles=int(p > 0), gate_h_tiles=1, ring_layer=p)
            if p > 0:
                r.update(os_layer=p - 1, os_last=int(p == L))
            if p + 1 < L:
                r.update(consts_layer=p + 1)
            elif p == L:
                r.update(consts_layer=0, consts_next_step=1)
            out.append(r)
        return out
    out = []
    for l in range(L):
        out.append(rec(gate_layer=l, gate_h_tiles=1, ring_layer=l))
        out.append(rec(os_layer=l, os_last=int(l == L - 1), hb_send=1,
                       consts_layer=(l + 1) % L, consts_next_step=int(l == L - 1)))
    return out


def fragment_index(kt: int = 1):
    """(k, m) of each bf16 of `kt` k-tiles' A fragments, shaped (kt, 32 lanes, 8): element
    e of lane l of k-tile i holds A[m][16 i + k'] at m = l // 4 + A_ROW[e],
    k' = 2 (l % 4) + A_COL[e]."""
    lane = torch.arange(32)[None, :, None]
    m = lane // 4 + torch.tensor(A_ROW)[None, None, :]
    k = 16 * torch.arange(kt)[:, None, None] + 2 * (lane % 4) + torch.tensor(A_COL)
    return torch.broadcast_tensors(k, m)


def owned_columns(r: int, width: int) -> Tensor:
    """The 16 output columns of CTA r, M-tile row m: 8r + m (m < 8), else width + 8r +
    m - 8 (the gates' sigmoid half, width G/2; w_os's skip part, width R)."""
    m = torch.arange(16)
    return torch.where(m < 8, 8 * r + m, width + 8 * r + m - 8)


def a_tiles(w: Tensor, rows: slice, r: int, width: int) -> Tensor:
    """The A tiles of CTA r for the product of rows `rows` of w (K, N): A[m][k] =
    w[rows][k, owned_columns(r, width)[m]], fragment-ordered, (k-tiles, 32, 8)."""
    sub = w[rows][:, owned_columns(r, width).to(w.device)]
    k, m = fragment_index(sub.shape[0] // 16)
    return sub[k.to(w.device), m.to(w.device)]


def _phase_mats(chain: str, inputs: Dict[str, Tensor], rec: Dict[str, int], K: int, R: int):
    """The weight row blocks a phase reads, in the kernel's order: (matrix, rows, width of
    the columns' first half) for the gates (z part, then h part), the residual and skip,
    the past taps of the consts."""
    out = []
    gl, ol, cl = rec['gate_layer'], rec['os_layer'], rec['consts_layer']
    if gl >= 0:
        if rec['gate_z_tiles']:
            out.append((inputs['w_fused'][gl], slice(None), 'G'))
        out.append((inputs['w_cur'][gl] if chain == 'fused'
                    else inputs['w_tap'][gl][(K - 1) * R:], slice(None), 'G'))
    if ol >= 0:
        w = (torch.cat([inputs['w_out'][ol], inputs['w_skip'][ol]], dim=1)
             if chain == 'fused' else inputs['w_os'][ol])
        out.append((w, slice(None), 'R'))
    if cl >= 0:
        out.append((inputs['w_tap'][cl], slice(0, (K - 1) * R), 'G'))
    return out


_PACKED: Dict[tuple, tuple] = {}


def pack(variant: str, inputs: Dict[str, Tensor]):
    """The kernel's inputs that `inputs` give: (tiles (C, total, 32, 8) bf16, table (PH,
    11) int32, slot_tiles): for each CTA r of a cluster of C = R/8, every phase's A
    tiles (`a_tiles`, its 16 columns) in `schedule` order, the phases one after another,
    and the table with each phase's first tile and count; slot_tiles the largest block.
    Made once per inputs (cached by the weights' storage and versions)."""
    chain = 'base' if variant == 'base' else 'fused'
    d = dims_of(inputs)
    L, R, G, K = d['L'], d['R'], d['G'], d['K']
    key = (chain, d['B'], *((inputs[n].data_ptr(), inputs[n]._version, inputs[n].device)
                            for n in WEIGHTS))
    if key in _PACKED:
        return _PACKED[key]
    half, C = G // 2, R // 8
    recs = schedule(chain, L)
    per_cta, table, off = [[] for _ in range(C)], [], 0
    for rec in recs:
        count = 0
        for w, rows, width in _phase_mats(chain, inputs, rec, K, R):
            for r in range(C):
                per_cta[r].append(a_tiles(w, rows, r, half if width == 'G' else R))
            count += per_cta[0][-1].shape[0]
        rec = dict(rec, gate_z_tiles=rec['gate_z_tiles'] * half // 16,
                   gate_h_tiles=rec['gate_h_tiles'] * R // 16, tile_off=off, tile_count=count)
        table.append([rec[f] for f in RECORD])
        off += count
    tiles = torch.stack([torch.cat(t) for t in per_cta]).contiguous()
    table_t = torch.tensor(table, dtype=torch.int32, device=tiles.device)
    out = (tiles, table_t, max(row[RECORD.index('tile_count')] for row in table))
    _PACKED.clear()  # one packing kept: the inputs being timed
    _PACKED[key] = out
    return out


def check_sizes(d: Dict[str, int]) -> None:
    """Raise unless the kernel takes these sizes: R = S = G/2 = 8 C for a cluster of C
    in 2 .. 16 CTAs, L even and at least 4, K >= 2."""
    L, R, G, S, K = (d[k] for k in ('L', 'R', 'G', 'S', 'K'))
    if not (R == S == G // 2 and G % 2 == 0 and R % 8 == 0 and 2 <= R // 8 <= 16
            and L % 2 == 0 and L >= 4 and K >= 2 and (K - 1) * R % 32 == 0):
        raise ValueError(f'the kernel does not take these sizes: {d} (it takes R = S = '
                         'G/2 = 8 C, C = 2 .. 16 CTAs a cluster, L even and >= 4, K >= 2)')


def kernel(variant: str, inputs: Dict[str, Tensor], steps: int = T, library=None) -> Tensor:
    """The kernel (`csrc/probes/ar_critpath.cu`) on CUDA tensors: `prev` (B, R) f32 after
    `steps` steps, one launch (the weights packed once per inputs, `pack`). `library`:
    another build of the same source (a planted fault), else the probes' library."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r}; one of {VARIANTS}')
    device = cuda_device(inputs['cond'])
    d = dims_of(inputs)
    L, R, G, S, K, B = (d[k] for k in ('L', 'R', 'G', 'S', 'K', 'B'))
    half = G // 2
    shapes = dict(w_tap=(L, K * R, G), w_os=(L, half, R + S), w_fused=(L, half, G),
                  w_cur=(L, R, G), w_out=(L, half, R), w_skip=(L, half, S))
    for name, shape in shapes.items():
        check_tensor(name, inputs[name], bf16, shape, device)
    check_tensor('cond', inputs['cond'], f32, (B, L * G), device)
    check_sizes(d)
    tiles, table, slot_tiles = pack(variant, inputs)
    ring_slots = sum((K - 1) * dl for dl in dilations(L))
    rings = torch.empty(B, ring_slots * R, device=device)
    out = torch.empty(B, R, device=device)
    launch('ar_critpath', entry('probe_ar_critpath', 17, library),
           [tiles, table, inputs['cond'], rings, out, L, R, G, S, K, B, steps,
            int(variant != 'base'), GLU[variant], table.shape[0], tiles.shape[1],
            slot_tiles], device)
    LAUNCHES += 1
    return out


def bound(variant: str, dims: Dict[str, int], steps: int = T):
    """(ms, by) of one launch of `steps` steps: the weights the chain reads, cond and the
    output once, against every matmul's bf16 multiply-adds a row and step (base: the
    taps and h by w_tap, the GLU by w_os; fused: the past taps by w_tap's first (K-1)R
    rows, h by w_cur, z by w_fused (but layer 0's), w_out and w_skip) and the GLU's
    elementwise work as 8 f32 operations a gate."""
    d = dict(DIMS, **dims)
    L, R, G, S, K, B = (d[k] for k in ('L', 'R', 'G', 'S', 'K', 'B'))
    half = G // 2
    if variant == 'base':
        w_elems = L * (K * R * G + half * (R + S))
    else:
        w_elems = L * ((K - 1) * R * G + R * G + half * (R + S)) + (L - 1) * half * G
    flops_bf16 = 2.0 * B * steps * w_elems
    nbytes = 2 * w_elems + 4 * B * L * G + 4 * B * R
    return bound_ms(nbytes, flops_bf16=flops_bf16, flops_f32=8.0 * B * steps * L * G)


def main(argv: Optional[list] = None) -> Dict:
    args = parser('B9: the AR layer stack\'s step (scripts/dev_pallas_ar_critpath.py)',
                  VARIANTS, T, str(DIMS['B'])).parse_args(argv)
    device = device_of(args)
    inputs = make_inputs(B=int(args.batch), device=device)
    variants = args.variants.split(',')
    out = {}
    if device.type == 'cuda':
        print(f'{torch.cuda.get_device_name(0)}; B={args.batch}, T={args.steps}')
    for v in variants:
        if device.type == 'cpu':
            t0 = time.perf_counter()
            prev = plain(v, inputs, args.steps)
            print(f'{v:16s}: plain version on the CPU, {args.steps} steps in '
                  f'{time.perf_counter() - t0:.2f} s (host clock); max |prev| '
                  f'{prev.abs().max().item():.4e}')
            continue
        b_ms, by = bound(v, dims_of(inputs), args.steps)
        k_ms = best_ms(lambda: kernel(v, inputs, args.steps), REPS)
        p_steps = min(args.steps, PLAIN_STEPS)
        p_ms = best_ms(lambda: plain(v, inputs, p_steps), 1)
        out[v] = dict(us_step=1e3 * k_ms / args.steps, plain_us_step=1e3 * p_ms / p_steps,
                      bound_us_step=1e3 * b_ms / args.steps, bound_by=by)
        print(f'{v:16s}: {out[v]["us_step"]:8.3f} us/step   ({k_ms:.2f} ms / {args.steps} '
              f'steps); bound {out[v]["bound_us_step"]:.4f} us/step ({by}); plain version '
              f'{out[v]["plain_us_step"]:.1f} us/step over {p_steps} steps')
    if device.type == 'cuda' and 'base' in out:
        print('speedup over base: ' + '   '.join(
            f'{v}: {out["base"]["us_step"] / out[v]["us_step"]:.2f}x'
            for v in variants if v != 'base' and v in out))
    return out


if __name__ == '__main__':
    main()
