"""B11: the Tacotron decoder step's pieces in a 512-step loop, on the H100.

Counterpart of `scripts/dev_pallas_microbench.py:21-113` (`build`, its `pl.pallas_call`
at :99): B=32 rows, U=1,024 LSTM units, T_in=128 encoder steps, E=512, attention
depth D=128, F=32 location filters of width K=31, IN1 = 256 + E + U = 1,792,
IN2 = 2U; T=512 steps inside one launch, as on the TPU.

A step (`:41-84`): two LSTMs, x0 = [zeros(B, 256), ctx, h1] and [h1', h2], gates i, g, f,
o with +1 on the forget gate, z rounded to bf16 after the f32 product and the cell math
in bf16; then, by variant:
    lstm      nothing more (from the probe's zero state a fixed point at zero: run it
              from a seeded nonzero state, `start`, to see anything)
    attlite   pq = h2 @ qk; e = bf16(pq) @ keys.reshape(-1, T_in)[:D] (the first D rows
              of the flattened keys, all of sequence 0: the probe's own shortcut);
              softmax; ctx = bf16(sum align * values)
    att       pq = h2 @ qk; location features 0.01 * sum_{j<31} state[:, 49+j : 49+j+T_in]
              in all F columns, @ lk; e = sum_D tanh(keys + pq + pl); masked softmax;
              state[:, 64:64+T_in] += align; ctx = bf16(sum align * values)
The output is h2 as (B, U) f32; `plain` and `kernel` also return the final state.
`graph` replays the plain version's step captured in a CUDA graph: the yardstick of a
decoder that runs its eager step as a graph (`graph_us_step`), not used by any entry point.

    python -m tacotron2_tpu_torch.probes.microbench [--device cpu] [--variants att]
"""

import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import Tensor

from ..ops.wavenet_ar import _check_tensor as check_tensor
from . import best_ms, bound_ms, cuda_device, device_of, entry, launch, parser

DIMS = dict(B=32, U=1024, T_in=128, E=512, D=128, F=32, K=31)
T = 512
VARIANTS = ('lstm', 'attlite', 'att')
KERNEL_UNITS = (256, 512, 1024)  # U the kernel takes (csrc/probes/microbench.cu)
REPS = 4
LAUNCHES = 0  # kernel launches, counted where the wrapper launches
bf16, f32 = torch.bfloat16, torch.float32


def make_inputs(seed: int = 0, B: int = DIMS['B'], U: int = DIMS['U'],
                device='cpu') -> Dict[str, Tensor]:
    """The script's draws (`:88-94`), in its order, from np.random.default_rng(seed):
    g1 (IN1, 4U), g2 (IN2, 4U) ~N(0, 0.02) and qk (U, D), lk (F, D), keys (B, T_in, D)
    ~N(0, 0.1) in bf16; values (B, T_in, E) ~N(0, 0.1) f32; the mask of ones."""
    d = dict(DIMS, B=B, U=U)
    D, E, T_in = d['D'], d['E'], d['T_in']
    rng = np.random.default_rng(seed)

    def draw(std, shape, dtype=bf16):
        return torch.from_numpy(rng.normal(0, std, shape)).to(dtype)

    out = dict(g1=draw(0.02, (256 + E + U, 4 * U)), g2=draw(0.02, (2 * U, 4 * U)),
               qk=draw(0.1, (U, D)), lk=draw(0.1, (d['F'], D)),
               keys=draw(0.1, (B, T_in, D)), values=draw(0.1, (B, T_in, E), f32),
               mask=torch.ones(B, T_in))
    return {k: v.to(device) for k, v in out.items()}


def zero_state(B: int, U: int, E: int, T_in: int, device) -> Dict[str, Tensor]:
    """The probe's start: every state zero."""
    s = {k: torch.zeros(B, U, dtype=bf16, device=device) for k in ('c1', 'h1', 'c2', 'h2')}
    s['ctx'] = torch.zeros(B, E, dtype=bf16, device=device)
    s['state'] = torch.zeros(B, T_in + 128, device=device)
    return s


def random_state(inputs: Dict[str, Tensor], seed: int = 1) -> Dict[str, Tensor]:
    """A seeded nonzero start (numpy, on the inputs' device): c ~N(0, 1), h ~U(-0.9, 0.9),
    ctx ~N(0, 0.1), state ~U(0, 0.05)."""
    B, T_in, E = inputs['values'].shape
    U = inputs['qk'].shape[0]
    rng = np.random.default_rng(seed)
    dev = inputs['values'].device
    s = {}
    for k in ('c1', 'h1', 'c2', 'h2'):
        a = rng.normal(0, 1, (B, U)) if k[0] == 'c' else rng.uniform(-0.9, 0.9, (B, U))
        s[k] = torch.from_numpy(a).to(bf16).to(dev)
    s['ctx'] = torch.from_numpy(rng.normal(0, 0.1, (B, E))).to(bf16).to(dev)
    s['state'] = torch.from_numpy(rng.uniform(0, 0.05, (B, T_in + 128)).astype(np.float32)).to(dev)
    return s


def _sigmoid(x: Tensor) -> Tensor:
    return 1.0 / (1.0 + torch.exp(-x))  # the script's `one / (one + exp(-x))`, in bf16


def _lstm(x: Tensor, g: Tensor, c: Tensor):
    """One LSTM cell (`:46-53`): (c', h') in bf16."""
    z = (x.to(f32) @ g.to(f32)).to(bf16)
    i, gg, fz, o = torch.chunk(z, 4, dim=-1)
    cn = _sigmoid(fz + 1.0) * c + _sigmoid(i) * torch.tanh(gg)
    return cn, _sigmoid(o) * torch.tanh(cn)


def _step(variant: str, w: Dict[str, Tensor], s: Dict[str, Tensor], zeros: Tensor) -> None:
    """One step of the plain version on the state s: its entries replaced, the
    accumulated alignments `state` updated in place."""
    B, T_in, E = w['values'].shape
    U, D = w['qk'].shape
    dev = w['values'].device
    s['c1'], s['h1'] = _lstm(torch.cat([zeros, s['ctx'], s['h1']], -1), w['g1'], s['c1'])
    s['c2'], s['h2'] = _lstm(torch.cat([s['h1'], s['h2']], -1), w['g2'], s['c2'])
    if variant != 'lstm':
        pq = s['h2'].to(f32) @ w['qk'].to(f32)
    if variant == 'att':
        st = s['state']
        fc = torch.zeros(B, T_in, device=dev)
        for j in range(DIMS['K']):
            off = 64 - 15 + j
            fc = fc + st[:, off:off + T_in] * 0.01
        fconv = fc.to(bf16)[:, :, None].expand(B, T_in, w['lk'].shape[0])
        pl = (fconv.reshape(B * T_in, -1).to(f32) @ w['lk'].to(f32)).reshape(B, T_in, D)
        u = w['keys'].to(f32) + pq[:, None, :] + pl
        e = torch.tanh(u).sum(-1)
        e = torch.where(w['mask'] > 0, e, torch.full_like(e, -1e9))
        ex = torch.exp(e - e.max(-1, keepdim=True).values)
        align = ex / ex.sum(-1, keepdim=True)
        st[:, 64:64 + T_in] = st[:, 64:64 + T_in] + align
    elif variant == 'attlite':
        m = w['keys'].reshape(-1, T_in)[:D]
        e = pq.to(bf16).to(f32) @ m.to(f32)
        ex = torch.exp(e - e.max(-1, keepdim=True).values)
        align = ex / ex.sum(-1, keepdim=True)
    if variant != 'lstm':
        s['ctx'] = (align[:, :, None] * w['values']).sum(1).to(bf16)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r}; one of {VARIANTS}')


def plain(variant: str, inputs: Dict[str, Tensor], steps: int = T,
          start: Optional[Dict[str, Tensor]] = None):
    """The plain PyTorch version from the probe's zero state, or from `start`:
    (h2 (B, U) f32, the final state)."""
    _check_variant(variant)
    w = inputs
    B, T_in, E = w['values'].shape
    U = w['qk'].shape[0]
    dev = w['values'].device
    s = {k: v.clone() for k, v in (start or zero_state(B, U, E, T_in, dev)).items()}
    zeros = torch.zeros(B, 256, dtype=bf16, device=dev)
    for _ in range(steps):
        _step(variant, w, s, zeros)
    return s['h2'].to(f32), s


def graph(variant: str, inputs: Dict[str, Tensor], steps: int = T,
          start: Optional[Dict[str, Tensor]] = None, reps: int = REPS):
    """The plain version's step captured once in a CUDA graph (torch.cuda.graphs) and
    replayed `steps` times from the zero state or `start`, the way a decoder would run its
    eager step as a graph: (h2 (B, U) f32, the final state, the best of `reps` runs in ms,
    CUDA events). No entry point runs it: it is the yardstick of the hand-written kernel
    (`graph_us_step`)."""
    _check_variant(variant)
    w = inputs
    device = cuda_device(w['values'])
    B, T_in, E = w['values'].shape
    U = w['qk'].shape[0]
    s0 = start or zero_state(B, U, E, T_in, device)
    static = {k: v.clone() for k, v in s0.items()}
    zeros = torch.zeros(B, 256, dtype=bf16, device=device)

    def step():
        s = dict(static)
        _step(variant, w, s, zeros)
        for k, v in s.items():
            if v is not static[k]:
                static[k].copy_(v)

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graph asks
        step()
    torch.cuda.current_stream(device).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()

    def run():
        for k, v in s0.items():
            static[k].copy_(v)
        for _ in range(steps):
            g.replay()

    ms = best_ms(run, reps)
    run()
    return static['h2'].to(f32), {k: v.clone() for k, v in static.items()}, ms


def kernel(variant: str, inputs: Dict[str, Tensor], steps: int = T,
           start: Optional[Dict[str, Tensor]] = None, library=None):
    """The kernel (`csrc/probes/microbench.cu`) on CUDA tensors, one launch of `steps`
    steps from the zero state or `start`: (h2 (B, U) f32, the final state) as `plain`.
    `library`: another build of the same source (a planted fault), else the probes'
    library. Raises if the grid (U/16 clusters of 2 CTAs) cannot be co-resident."""
    global LAUNCHES
    _check_variant(variant)
    w = inputs
    device = cuda_device(w['values'])
    B, T_in, E = w['values'].shape
    U, D = w['qk'].shape
    F = w['lk'].shape[0]
    if (B, T_in, E, D, F) != (32, 128, 512, 128, 32) or U not in KERNEL_UNITS:
        raise ValueError(f'the kernel takes the probe\'s sizes {DIMS} but U, one of '
                         f'{KERNEL_UNITS}; got B={B}, U={U}, T_in={T_in}, E={E}, D={D}, F={F}')
    for name, dtype, shape in (('g1', bf16, (256 + E + U, 4 * U)), ('g2', bf16, (2 * U, 4 * U)),
                               ('qk', bf16, (U, D)), ('lk', bf16, (F, D)),
                               ('keys', bf16, (B, T_in, D)), ('values', f32, (B, T_in, E)),
                               ('mask', f32, (B, T_in))):
        check_tensor(name, w[name], dtype, shape, device)
    s0 = start or zero_state(B, U, E, T_in, device)
    c1, c2, ctx = s0['c1'].clone(), s0['c2'].clone(), s0['ctx'].clone()
    state = s0['state'].clone()
    h1 = torch.stack([s0['h1'], s0['h1']]).contiguous()  # double-buffered: [t % 2] is h_t
    h2 = torch.stack([s0['h2'], s0['h2']]).contiguous()
    for name, t, dtype, shape in (('c1', c1, bf16, (B, U)), ('c2', c2, bf16, (B, U)),
                                  ('ctx', ctx, bf16, (B, E)),
                                  ('state', state, f32, (B, T_in + 128)),
                                  ('h1', h1, bf16, (2, B, U)), ('h2', h2, bf16, (2, B, U))):
        check_tensor(name, t, dtype, shape, device)
    out = torch.empty(B, U, device=device)
    # scratch: g1's streamed B fragments (each CTA's slice, written by the kernel), the
    # clusters' pq partials, the grid barrier's arrival count
    w1s = torch.empty(U // 8, 8 + U // 32, 8 * 32 * 8, dtype=torch.uint8, device=device)
    pqs = torch.empty(U // 16, B, D, device=device)
    bar = torch.zeros(1, dtype=torch.int32, device=device)
    info = torch.zeros(2, dtype=torch.int32)  # clusters resident, needed: filled when too few
    fn = entry('probe_microbench', 21, library)
    try:
        launch('microbench', fn, [w['g1'], w['g2'], w['qk'], w['lk'], w['keys'], w['values'],
                                  w['mask'], c1, h1, c2, h2, ctx, state, out, w1s, pqs, bar,
                                  U, steps, VARIANTS.index(variant), info], device)
    except RuntimeError as e:
        if info[0] or info[1]:
            raise RuntimeError(f'{e}: the card keeps {int(info[0])} clusters of 2 resident, '
                               f'the grid needs {int(info[1])}') from None
        raise
    LAUNCHES += 1
    final = dict(c1=c1, h1=h1[steps % 2], c2=c2, h2=h2[steps % 2], ctx=ctx, state=state)
    return out, final


def bound(variant: str, dims: Dict[str, int], steps: int = T):
    """(ms, by) of one launch: the inputs read once (g1, g2, qk, lk, keys, values, mask)
    and h2 written once, against the bf16 multiply-adds of a step (the two LSTMs' gate
    products; pq; for att the location features by lk, for attlite e by the keys) and
    its f32 work (att: keys + pq + pl, tanh and the sum, 4 operations a (t, d); the
    context, 2 a (t, e); the cells' bf16 elementwise math, 24 operations a unit)."""
    d = dict(DIMS, **dims)
    B, U, T_in, E, D, F = (d[k] for k in ('B', 'U', 'T_in', 'E', 'D', 'F'))
    IN1, IN2 = 256 + E + U, 2 * U
    macs = IN1 * 4 * U + IN2 * 4 * U
    f32_ops = 2 * 24 * U
    if variant != 'lstm':
        macs += U * D + (T_in * F * D if variant == 'att' else D * T_in)
        f32_ops += 2 * T_in * E + (4 * T_in * D if variant == 'att' else 0)
    nbytes = (2 * ((IN1 + IN2) * 4 * U + U * D + F * D + B * T_in * D)
              + 4 * (B * T_in * E + B * T_in + B * U))
    return bound_ms(nbytes, flops_bf16=2.0 * steps * B * macs, flops_f32=1.0 * steps * B * f32_ops)


def main(argv: Optional[list] = None) -> Dict:
    args = parser('B11: the decoder step\'s pieces in a loop '
                  '(scripts/dev_pallas_microbench.py)', VARIANTS, T,
                  str(DIMS['B'])).parse_args(argv)
    device = device_of(args)
    inputs = make_inputs(B=int(args.batch), device=device)
    out = {}
    if device.type == 'cuda':
        print(f'{torch.cuda.get_device_name(0)}; B={args.batch}, T={args.steps}')
    for v in args.variants.split(','):
        if device.type == 'cpu':
            t0 = time.perf_counter()
            h2, _ = plain(v, inputs, args.steps)
            print(f'{v}: plain version on the CPU, {args.steps} steps in '
                  f'{time.perf_counter() - t0:.2f} s (host clock); max |h2| '
                  f'{h2.abs().max().item():.4e}')
            continue
        b_ms, by = bound(v, dict(B=int(args.batch)), args.steps)
        k_ms = best_ms(lambda: kernel(v, inputs, args.steps), REPS)
        p_steps = args.steps
        p_ms = best_ms(lambda: plain(v, inputs, p_steps), 1)
        g_ms = graph(v, inputs, args.steps)[2]
        out[v] = dict(us_step=1e3 * k_ms / args.steps, plain_us_step=1e3 * p_ms / p_steps,
                      graph_us_step=1e3 * g_ms / args.steps,
                      bound_us_step=1e3 * b_ms / args.steps, bound_by=by)
        print(f'{v}: {k_ms:.2f} ms total, {out[v]["us_step"]:.2f} us/step; bound '
              f'{out[v]["bound_us_step"]:.3f} us/step ({by}); plain version '
              f'{out[v]["plain_us_step"]:.2f} us/step over {p_steps} steps, its step as a '
              f'CUDA graph {out[v]["graph_us_step"]:.2f} us/step')
    return out


if __name__ == '__main__':
    main()
