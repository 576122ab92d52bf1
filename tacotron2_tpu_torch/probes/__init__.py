"""The H100 counterparts of the JAX package's four measurement probes.

Each probe of `scripts/` builds one Pallas TPU kernel and times it; no entry point of
the system runs them. Here each is a module with the same inputs, a kernel written by
hand in CUDA C++ for Hopper (`csrc/probes/*.cu`, built into a library of its own by
`ops._build.load_probe_library`), and a plain PyTorch version beside it:

    prng_probe   (B12)  scripts/dev_prng_probe.py            Philox noise + arg-max
    ar_critpath  (B9)   scripts/dev_pallas_ar_critpath.py    the AR layer stack's step
    matmul_probe (B10)  scripts/dev_pallas_matmul_probe.py   the decoder's gate matmul
    microbench   (B11)  scripts/dev_pallas_microbench.py     the decoder step's pieces

Every module holds `make_inputs(seed=0, **dims)` (the script's draws: the same numpy
generator, order, shapes and bf16 rounding), `plain(variant, inputs, steps)`,
`kernel(variant, inputs, steps)` (CUDA tensors only), `bound(variant, dims, steps)` and
`main()`, run as `python -m tacotron2_tpu_torch.probes.<name>` (on the card by default;
`--device cpu` runs the plain version, there is no silent fallback).

`ar_split` is no counterpart: it times builds of the port's own AR kernel
(`csrc/wavenet_ar.cu`) and reads the split of its step by phase.

This module holds what they share: the card's peaks for the bounds, the launch of a C
entry point, CUDA-event timing and the command line.
"""

import argparse
import ctypes
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import Tensor

# the card's peaks (H100 SXM data sheet, dense, at 700 W), as chip_smoke.ar_bound
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_ms(nbytes: float, flops_bf16: float = 0.0, flops_f32: float = 0.0
             ) -> Tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the larger of `nbytes` over the HBM rate and the
    operations over the peak rate of their type (bf16 on the tensor cores, f32 off them)."""
    ops_s = flops_bf16 / PEAK_BF16_FLOPS + flops_f32 / PEAK_F32_FLOPS
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1000 * max(ops_s, bytes_s), 'operations' if ops_s >= bytes_s else 'bytes'


def entry(name: str, n_args: int, library: Optional[ctypes.CDLL] = None):
    """The C entry `name` of the probes' library (or of another build of a probe's
    source): `n_args` pointer or 64-bit arguments, then the stream; returns a CUDA error
    code. Every argument goes as a 64-bit value (ctypes would cut an untyped int)."""
    if library is None:
        from ..ops._build import load_probe_library
        library = load_probe_library()
    fn = getattr(library, name)
    fn.argtypes = [ctypes.c_void_p] * n_args + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bind(name: str, fn, args: Sequence, device: torch.device) -> Callable[[], None]:
    """The launch of the C entry `fn` with `args` (tensors as their data pointers, ints as
    they are) on torch's current stream of `device`, as a callable that raises with the
    CUDA error if the launch failed. The pointers and the stream are resolved here, once,
    so that calls back to back cost the host little more than the ctypes call."""
    vals = [a.data_ptr() if isinstance(a, Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream

    def run() -> None:
        with torch.cuda.device(device):
            err = fn(*vals, stream)
        if err != 0:
            raise RuntimeError(f'{name} launch failed: CUDA error {err}')
    return run


def launch(name: str, fn, args: Sequence, device: torch.device) -> None:
    """Call the C entry `fn` with `args` on torch's current stream of `device` (`bind`)."""
    bind(name, fn, args, device)()


def cuda_device(t: Tensor) -> torch.device:
    """The CUDA device of `t`; raise for any other (the kernels take CUDA tensors only)."""
    if t.device.type != 'cuda':
        raise ValueError(f'the probe kernels run on CUDA tensors, not {t.device}')
    return t.device


def best_ms(fn: Callable[[], object], reps: int, calls: int = 1) -> float:
    """Best of `reps` runs of `calls` back-to-back fn() between two CUDA events (after one
    warm-up call), in milliseconds a call."""
    fn()
    best = float('inf')
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def parser(description: str, variants: Sequence[str], steps: int,
           batch: str) -> argparse.ArgumentParser:
    """The probes' common command line."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument('--device', default='cuda',
                   help='cuda (default): time the kernel, and the plain version beside it; '
                        'cpu: run the plain version alone')
    p.add_argument('--variants', default=','.join(variants),
                   help=f'comma-separated, of {", ".join(variants)}')
    p.add_argument('--steps', type=int, default=steps, help=f'steps a launch (default {steps})')
    p.add_argument('--batch', default=batch, help=f'batch size(s) (default {batch})')
    return p


def device_of(args) -> torch.device:
    """--device as a torch device; cuda without a card raises."""
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda, but torch finds no CUDA device (pass --device '
                           'cpu to run the plain PyTorch version)')
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
