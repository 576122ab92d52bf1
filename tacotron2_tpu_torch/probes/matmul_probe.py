"""B10: the Tacotron decoder's LSTM gate matmul in a 512-step loop, on the H100.

Counterpart of `scripts/dev_pallas_matmul_probe.py:21-81` (`build`, its `pl.pallas_call`
at :72): x (B=32, IN1=1,792) bf16 starting at 0.01 and w (IN1, 4U) bf16 ~N(0, 0.01) with
U=1,024, the shapes of the first decoder LSTM's gates; T=512 steps, all inside one launch
as on the TPU. Columns U..IN1 of x stay at 0.01 throughout.

Variants (`:33-61`):
    indep     out[:, :U] += (x @ w)[:, :U], x fixed: no dependency between steps
    dep_f32   x[:, :U] = bf16(tanh((x @ w)[:, :U])): each step needs the last
    dep_bf16  the product rounded to bf16, tanh in bf16
    dep_T     dep_f32 with the weights transposed in memory, wt (4U, IN1)
    ksplit    dep_f32 with the contraction in 2 partial sums
    k4split   ... in 4
    nsplit    x[:, :U] = bf16(tanh(za[:, :U] * zb[:, :U])), za = x @ w[:, :2U],
              zb = x @ w[:, 2U:]
The output is x[:, :U] padded to (B, 4U) f32 (for `indep`, out, which this port starts
at zero: the TPU kernel never initialises it). The whole (B, 4U) product is computed
every step, as on the TPU, and the last step's is a second output, so that a kernel
which skipped the unused three quarters could not pass its check.

    python -m tacotron2_tpu_torch.probes.matmul_probe [--device cpu] [--variants dep_f32]
"""

import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import Tensor

from ..ops.wavenet_ar import _check_tensor as check_tensor
from . import best_ms, bound_ms, cuda_device, device_of, entry, launch, parser

DIMS = dict(B=32, U=1024, IN1=1792)
T = 512
VARIANTS = ('indep', 'dep_f32', 'dep_bf16', 'dep_T', 'ksplit', 'k4split', 'nsplit')
REPS = 4
LAUNCHES = 0  # kernel launches, counted where the wrapper launches
bf16, f32 = torch.bfloat16, torch.float32


def make_inputs(seed: int = 0, U: int = DIMS['U'], IN1: int = DIMS['IN1'],
                device='cpu') -> Dict[str, Tensor]:
    """The script's draws (`:64-65`): w ~N(0, 0.01) (IN1, 4U) in bf16 from
    np.random.default_rng(seed), and its transpose wt."""
    w = torch.from_numpy(np.random.default_rng(seed).normal(0, 0.01, (IN1, 4 * U))).to(bf16)
    return dict(w=w.to(device), wt=w.t().contiguous().to(device))


def _mm(a: Tensor, w: Tensor) -> Tensor:
    return a.to(f32) @ w.to(f32)  # bf16 operands, f32 accumulation


def plain(variant: str, inputs: Dict[str, Tensor], steps: int = T, B: int = DIMS['B']):
    """The plain PyTorch version: (the probe's output (B, 4U) f32, the last step's whole
    product (B, 4U) f32)."""
    if variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r}; one of {VARIANTS}')
    w, wt = inputs['w'], inputs['wt']
    IN1, U = w.shape[0], w.shape[1] // 4
    x = torch.full((B, IN1), 0.01, dtype=bf16, device=w.device)
    out = torch.zeros(B, 4 * U, device=w.device)
    z = None
    for _ in range(steps):
        if variant == 'indep':
            z = _mm(x, w)
            out[:, :U] += z[:, :U]
            continue
        if variant == 'ksplit':
            h = IN1 // 2
            z = _mm(x[:, :h], w[:h]) + _mm(x[:, h:], w[h:])
        elif variant == 'k4split':
            qs = IN1 // 4
            z = sum(_mm(x[:, i * qs:(i + 1) * qs], w[i * qs:(i + 1) * qs]) for i in range(4))
        elif variant == 'dep_bf16':
            z = _mm(x, w).to(bf16)
        elif variant == 'dep_T':
            z = (wt.to(f32) @ x.to(f32).t()).t()
        else:  # dep_f32, nsplit
            z = _mm(x, w)
        if variant == 'nsplit':
            x[:, :U] = torch.tanh(z[:, :U] * z[:, 2 * U:3 * U]).to(bf16)
        else:
            x[:, :U] = torch.tanh(z[:, :U]).to(bf16)
    if variant != 'indep':
        out[:, :U] = x[:, :U].to(f32)
    return out, z.to(f32)


def kernel(variant: str, inputs: Dict[str, Tensor], steps: int = T, B: int = DIMS['B'],
           library=None):
    """The kernel (`csrc/probes/matmul_probe.cu`) on CUDA tensors, one cooperative launch
    of `steps` steps: (output, last product) as `plain`. `library`: another build of the
    same source (a planted fault), else the probes' library. Raises if the grid (U/8
    blocks) cannot be co-resident on the card."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r}; one of {VARIANTS}')
    w, wt = inputs['w'], inputs['wt']
    device = cuda_device(w)
    IN1, U = w.shape[0], w.shape[1] // 4
    check_tensor('w', w, bf16, (IN1, 4 * U), device)
    check_tensor('wt', wt, bf16, (4 * U, IN1), device)
    if B != 32 or U % 8 or IN1 % 64 or IN1 < U or steps < 1:
        raise ValueError(f'the kernel takes B=32, U a multiple of 8 and IN1 >= U a '
                         f'multiple of 64; got B={B}, U={U}, IN1={IN1}, steps={steps}')
    xs = torch.empty(2, B, IN1, dtype=bf16, device=device)
    out = torch.empty(B, 4 * U, device=device)
    prod = torch.empty(B, 4 * U, device=device)
    info = torch.zeros(2, dtype=torch.int32)  # blocks per SM, SMs: filled when too few
    fn = entry('probe_matmul', 10, library)
    try:
        launch('matmul_probe', fn, [w, wt, xs, out, prod, U, IN1, steps,
                                    VARIANTS.index(variant), info], device)
    except RuntimeError as e:
        if info[0] or info[1]:
            raise RuntimeError(f'{e}: {U // 8} blocks cannot be co-resident: '
                               f'{int(info[0])} a SM x {int(info[1])} SMs') from None
        raise
    LAUNCHES += 1
    return out, prod


def bound(variant: str, dims: Dict[str, int], steps: int = T):
    """(ms, by) of one launch: the weights (w, or wt for dep_T) read once and the two
    outputs written once, against the product's bf16 multiply-adds, B x IN1 x 4U a
    step, and the update's tanh (or the add) as 8 f32 operations an element of x[:, :U]."""
    d = dict(DIMS, **dims)
    B, U, IN1 = d['B'], d['U'], d['IN1']
    nbytes = 2 * IN1 * 4 * U + 2 * 4 * B * 4 * U
    return bound_ms(nbytes, flops_bf16=2.0 * steps * B * IN1 * 4 * U,
                    flops_f32=8.0 * steps * B * U)


def library_ms(inputs: Dict[str, Tensor], steps: int, B: int = DIMS['B'],
               reps: int = REPS) -> float:
    """Best of `reps` loops of `steps` calls of torch.matmul on the same (B x IN1) x
    (IN1 x 4U) bf16 product, in ms a loop: the library's time for the probe's work."""
    w = inputs['w']
    x = torch.full((B, w.shape[0]), 0.01, dtype=bf16, device=w.device)

    def loop():
        for _ in range(steps):
            torch.matmul(x, w)

    return best_ms(loop, reps)


def main(argv: Optional[list] = None) -> Dict:
    args = parser('B10: the decoder LSTM gate matmul in a loop '
                  '(scripts/dev_pallas_matmul_probe.py)', VARIANTS, T,
                  str(DIMS['B'])).parse_args(argv)
    device = device_of(args)
    inputs = make_inputs(device=device)
    B = int(args.batch)
    out = {}
    if device.type == 'cuda':
        lib = library_ms(inputs, args.steps, B)
        print(f'{torch.cuda.get_device_name(0)}; B={B}, T={args.steps}; library: '
              f'torch.matmul of the same bf16 product {1e3 * lib / args.steps:.2f} us/step')
        out['library_us_step'] = 1e3 * lib / args.steps
    for v in args.variants.split(','):
        if device.type == 'cpu':
            t0 = time.perf_counter()
            res, _ = plain(v, inputs, args.steps, B)
            print(f'{v}: plain version on the CPU, {args.steps} steps in '
                  f'{time.perf_counter() - t0:.2f} s (host clock); max |out| '
                  f'{res.abs().max().item():.4e}')
            continue
        b_ms, by = bound(v, dict(B=B), args.steps)
        k_ms = best_ms(lambda: kernel(v, inputs, args.steps, B), REPS)
        p_steps = args.steps
        p_ms = best_ms(lambda: plain(v, inputs, p_steps, B), 1)
        out[v] = dict(us_step=1e3 * k_ms / args.steps, plain_us_step=1e3 * p_ms / p_steps,
                      bound_us_step=1e3 * b_ms / args.steps, bound_by=by)
        print(f'{v}: {out[v]["us_step"]:.2f} us/matmul-step; bound '
              f'{out[v]["bound_us_step"]:.3f} us/step ({by}); plain version '
              f'{out[v]["plain_us_step"]:.2f} us/step over {p_steps} steps')
    return out


if __name__ == '__main__':
    main()
