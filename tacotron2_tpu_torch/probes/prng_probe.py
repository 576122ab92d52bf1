"""B12: random bits drawn inside a kernel, Gumbel noise and a wide arg-max, on the H100.

Counterpart of `scripts/dev_prng_probe.py:14-44` (the module-level kernel `fn`, whose
`pl.pallas_call` is at :32): B rows of Q = 65,536 scores, zeros with 12.0 planted at one
class a row. Each element's 32 random bits become u = ((bits >> 9) | 0x3F800000) as a
float, minus 1, and the noise g = -log(-log(u + 1e-9) + 1e-9); the kernel adds g to the
scores and takes each row's arg-max (the first id on a tie, as `jnp.argmax`). Outputs:
the ids as (B, 1) f32, and (1, 8) f32 stats: the mean, max and min of g over B x Q, then
five zeros.

The TPU draws its bits with `pltpu.prng_random_bits`. Here they are Philox4x32-10 with
the AR kernel's big-vocab keying (`ops.wavenet_ar.philox_bits` at step 0: key = the
seed, counter = (class / 4, 0, 0, row)), written into `csrc/probes/prng_probe.cu`; so
the plain version is `argmax(scores + philox_gumbel(seed, B, 0, Q))` and the stats. The
big head of the AR kernel draws and reduces the same way at every step: this probe times
its noise and arg-max alone, without the 16.8 MB of head weights.

    python -m tacotron2_tpu_torch.probes.prng_probe [--device cpu] [--batch 8,1,2]
"""

import ctypes
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..ops.wavenet_ar import _check_tensor as check_tensor
from ..ops.wavenet_ar import gumbel_from_bits, philox_bits
from . import best_ms, bind, bound_ms, cuda_device, device_of, entry, parser

B, Q, SEED = 8, 65536, 1234
PLANTED = (7, 130, 1024, 9999, 65535, 0, 32768, 50000)  # the script's clear winners
VARIANTS = ('gumbel_argmax',)
REPS = 5
CALLS = 100  # launches back to back a timed run, from one host call (`launcher`)
LAUNCHES = 0  # kernel launches, counted where the wrapper launches


def make_inputs(seed: int = 0, B: int = B, Q: int = Q, random_scores: bool = False,
                device='cpu') -> Dict:
    """The script's scores (12.0 at PLANTED[b % 8] of row b, else 0) and its PRNG seed
    1234; with `random_scores`, scores ~N(0, 1) from np.random.default_rng(seed)."""
    if random_scores:
        scores = np.random.default_rng(seed).normal(0, 1, (B, Q)).astype(np.float32)
    else:
        scores = np.zeros((B, Q), np.float32)
        scores[np.arange(B), [PLANTED[b % len(PLANTED)] % Q for b in range(B)]] = 12.0
    return dict(scores=torch.from_numpy(scores).to(device), seed=SEED)


def from_bits(scores: Tensor, bits: Tensor):
    """The script's lines 20-27 on given 32-bit values `bits` (B, Q) (int64 tensor):
    (ids (B, 1) f32, stats (1, 8) f32)."""
    g = gumbel_from_bits(bits)
    ids = torch.argmax(scores + g, dim=1, keepdim=True).to(torch.float32)
    stats = torch.zeros(1, 8, device=scores.device)
    stats[0, 0], stats[0, 1], stats[0, 2] = g.mean(), g.max(), g.min()
    return ids, stats


def plain(variant: str, inputs: Dict, steps: int = 1):
    """The plain PyTorch version: (ids, stats) of the probe on Philox bits."""
    if variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r}; one of {VARIANTS}')
    scores = inputs['scores']
    Bn, Qn = scores.shape
    return from_bits(scores, philox_bits(inputs['seed'], Bn, 0, Qn, scores.device))


def _bind(variant: str, inputs: Dict, library, launches: int):
    """(go, ids, stats): the kernel's entry bound to its outputs, scratch and arrival
    counter, allocated here once; go() launches it `launches` times and counts nothing."""
    if variant not in VARIANTS:
        raise ValueError(f'unknown variant {variant!r}; one of {VARIANTS}')
    scores = inputs['scores']
    device = cuda_device(scores)
    Bn, Qn = scores.shape
    check_tensor('scores', scores, torch.float32, (Bn, Qn), device)
    ids = torch.empty(Bn, 1, device=device)
    stats = torch.empty(1, 8, device=device)
    partial = torch.empty(Bn, 3, dtype=torch.float64, device=device)
    arrived = torch.zeros(1, dtype=torch.int32, device=device)  # each launch leaves it 0
    seed = inputs['seed']
    go = bind('prng_probe', entry('probe_prng', 10, library),
              [scores, ids, stats, partial, arrived, Bn, Qn, seed & 0xFFFFFFFF,
               (seed >> 32) & 0xFFFFFFFF, launches], device)
    return go, ids, stats


def launcher(variant: str, inputs: Dict, library=None,
             launches: int = 1) -> Callable[[], Tuple[Tensor, Tensor]]:
    """The kernel (`csrc/probes/prng_probe.cu`) on CUDA tensors, as a callable that
    launches it `launches` times back to back from one host call and returns (ids,
    stats). The outputs, the scratch and the arrival counter are allocated, and the
    entry resolved, here, once: calls time the card, not the host's set-up. `library`:
    another build of the same source (a planted fault), else the probes'."""
    go, ids, stats = _bind(variant, inputs, library, launches)

    def run():
        global LAUNCHES
        go()
        LAUNCHES += launches
        return ids, stats
    return run


def cluster_of(B: int, library=None) -> int:
    """The CTAs a row that the kernel takes at batch B (16, or 8 where the card keeps
    fewer than B clusters of 16 resident)."""
    if library is None:
        from ..ops._build import load_probe_library
        library = load_probe_library()
    fn = library.probe_prng_cluster
    fn.argtypes = [ctypes.c_longlong]
    fn.restype = ctypes.c_int
    return int(fn(B))


def kernel(variant: str, inputs: Dict, steps: int = 1, library=None):
    """One launch of the kernel on CUDA tensors (`launcher`): (ids, stats)."""
    return launcher(variant, inputs, library)()


def call_ms(variant: str, inputs: Dict, reps: int = REPS) -> float:
    """ms a call: the best of `reps` runs of CALLS launches back to back from one host
    call, between two CUDA events, over CALLS."""
    return best_ms(launcher(variant, inputs, launches=CALLS), reps) / CALLS


def graph_call_ms(variant: str, inputs: Dict, reps: int = REPS) -> float:
    """ms a call with the host's launch calls out of the timing: CALLS launches captured
    once in a CUDA graph (outputs, scratch and counter allocated in it; the CTAs a row
    chosen before, so that the capture makes no other CUDA call), the graph replayed
    between two CUDA events; the best of `reps` replays over CALLS."""
    cluster_of(inputs['scores'].shape[0])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _bind(variant, inputs, None, CALLS)[0]()  # captured: nothing runs, nothing counts

    def replay():
        global LAUNCHES
        graph.replay()
        LAUNCHES += CALLS
    return best_ms(replay, reps) / CALLS


def bound(variant: str, dims: Dict, steps: int = 1):
    """(ms, by) of one call at dims B, Q: the scores read once and the outputs written
    once, against a quarter of a Philox4x32-10 block and two logarithms a class counted
    as 32 f32 operations (chip_smoke.ar_bound's convention), plus the add and the compare."""
    n = dims.get('B', B) * dims.get('Q', Q)
    return bound_ms(4 * n + 4 * dims.get('B', B) + 32, flops_f32=34 * n)


def main(argv: Optional[list] = None) -> Dict:
    args = parser('B12: in-kernel Philox noise + arg-max over Q classes '
                  '(scripts/dev_prng_probe.py)', VARIANTS, 1, '8,1,2').parse_args(argv)
    device = device_of(args)
    out = {}
    for b in [int(x) for x in args.batch.split(',')]:
        inputs = make_inputs(B=b, device=device)
        if device.type == 'cpu':
            t0 = time.perf_counter()
            ids, stats = plain(VARIANTS[0], inputs)
            print(f'B={b} plain version on the CPU in {time.perf_counter() - t0:.3f} s '
                  '(host clock)')
        else:
            ms, by = bound(VARIANTS[0], dict(B=b, Q=Q))
            print(f'B={b}: bound {ms * 1e3:.3f} us ({by}); {torch.cuda.get_device_name(0)}')
            ids, stats = kernel(VARIANTS[0], inputs)
            k_ms = call_ms(VARIANTS[0], inputs)
            g_ms = graph_call_ms(VARIANTS[0], inputs)
            p_ms = best_ms(lambda: plain(VARIANTS[0], inputs), REPS)
            print(f'gumbel_argmax B={b}: {k_ms * 1e3:.3f} us/call ({CALLS} back to back, '
                  f'{cluster_of(b)} CTAs a row), {g_ms * 1e3:.3f} replayed as a CUDA graph   '
                  f'plain version {p_ms * 1e3:.3f} us/call')
            out[b] = dict(ms=k_ms, graph_ms=g_ms, plain_ms=p_ms, bound_ms=ms, bound_by=by,
                          cluster=cluster_of(b))
        print('ids:', ids.cpu().numpy().ravel().astype(int))
        print('gumbel mean/max/min:', stats.cpu().numpy().ravel()[:3], '(expect mean~0.577)')
    return out


if __name__ == '__main__':
    main()
