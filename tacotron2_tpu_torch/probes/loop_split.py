"""Where the decoder loops' steps go, on the card: the split of a step inside
`decoder_fwd_loop` in bf16 (csrc/decoder_loop/decoder_loop.cu, `--loop fwd`) and in float32
(csrc/decoder_loop_f32/decoder_loop_f32.cu, `--loop f32`) and inside `decoder_bwd_loop` in
bf16 (csrc/decoder_bwd_loop/decoder_bwd_loop.cu, `--loop bwd`) and in float32
(csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu, `--loop bwd_f32`).

Not a counterpart of a TPU kernel: a timing probe of the port's own loops. The variant
`profile` is a loop's source built with -DT2_PROFILE into a library of its own, whose
thread 0 of every CTA adds up the %globaltimer nanoseconds of each of the step's stages
(the forward's five, the reverse loops' six: each source's STAGES): its work, from the
release of the barrier before it to its arrival at its own, and its wait there. `base` is
the port's own build; `--source NAME=PATH` adds a variant NAME built from another copy of
the source of the one loop that `--loop` names, such as a parent checkout's, to time two
versions in one run (a name may repeat in `--variants`: each is timed in turn). Every
variant runs on the same seeded inputs at the default widths (a decoder cell with seeded
random weights, B rows x --steps steps, --t_in input steps, training's keep-gates; the
forward saves the residuals as the train step saves them, with --lean none, as eval saves
none; the reverse loops run on their dtype's forward loop's residuals and seeded
gradients) and its outputs are held to the port's build, bit for bit for `profile` (the
macro changes no sum). `--registers` prints each source's registers, stack and spills (`nvcc -Xptxas -v`)
instead:

    python -m tacotron2_tpu_torch.probes.loop_split [--loop fwd,bwd,f32,bwd_f32]
        [--variants base,profile]
        [--batch 32,1] [--steps 512] [--t_in 100] [--lean] [--source NAME=PATH ...]
        [--registers]
"""

import argparse
import concurrent.futures
import ctypes
import os
import re
import subprocess
import tempfile
from typing import Dict, Optional

import torch

from . import best_ms

VARIANTS = {'base': (), 'profile': ('T2_PROFILE',)}
# each loop's source file, its library's loader, the wrapper's library attribute and the
# names of its step's stages
LOOPS = {
    'fwd': dict(dir='DECODER_LOOP_DIR', file='decoder_loop.cu',
                load='load_decoder_loop_library', attr='loop_library',
                stages=('lstm 1', 'lstm 2', 'pq', 'energies', 'softmax and context')),
    'f32': dict(dir='DECODER_LOOP_F32_DIR', file='decoder_loop_f32.cu',
                load='load_decoder_loop_f32_library', attr='loop_f32_library',
                stages=('lstm 1', 'lstm 2', 'pq', 'energies', 'softmax and context')),
    'bwd': dict(dir='DECODER_BWD_LOOP_DIR', file='decoder_bwd_loop.cu',
                load='load_decoder_bwd_loop_library', attr='bwd_loop_library',
                stages=('dalign and energies', 'normalisation and location', 'sums', 'lstm 2',
                        'din2 and lstm 1', 'din1')),
    'bwd_f32': dict(dir='DECODER_BWD_LOOP_F32_DIR', file='decoder_bwd_loop_f32.cu',
                    load='load_decoder_bwd_loop_f32_library', attr='bwd_loop_f32_library',
                    stages=('dalign and energies', 'normalisation and location',
                            'sums and conv transpose', 'lstm 2', 'din2 and lstm 1', 'din1'))}


def _source(loop: str = 'fwd') -> str:
    from ..ops import _build
    return os.path.join(getattr(_build, LOOPS[loop]['dir']), LOOPS[loop]['file'])


def build(variants, tmp: str, sources: Dict[str, str], loop: str = 'fwd'
          ) -> Dict[str, ctypes.CDLL]:
    """The library of each variant of `loop` (the port's own for `base`; those of `sources`
    built from the file each names), built at once."""
    from ..ops import _build

    def one(name):
        macros = VARIANTS.get(name, ())
        if not macros and name not in sources:
            return name, getattr(_build, LOOPS[loop]['load'])()
        lib = os.path.join(tmp, f'lib{loop}_{name}.so')
        _build.compile_library([sources.get(name, _source(loop))], lib, defines=macros,
                               flags=_build.DECODER_FLAGS)
        return name, ctypes.CDLL(lib)

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants))


def registers(sources: Dict[str, str], loops=('fwd',)) -> Dict[str, str]:
    """{variant: 'R registers, ... spill loads'} of the port's source of each loop (`base`,
    `bwd base`) and of `sources`, each kernel of a source (a build for each number of
    m-tiles, `MT=1`, `MT=2`) in turn."""
    from ..ops import _build

    def one(item):
        name, path = item
        with tempfile.TemporaryDirectory(prefix='t2_ptxas_') as tmp:
            res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *_build.DECODER_FLAGS,
                                  '-Xptxas', '-v', '-o', os.path.join(tmp, 'lib.so'), path],
                                 capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc failed on {path}:\n{res.stderr[-3000:]}')
        lines = []
        for entry in (res.stdout + res.stderr).split('Compiling entry function')[1:]:
            mt = re.search(r'ILi(\d+)E', entry.split('\n')[0])
            regs = re.search(r'Used (\d+) registers.*', entry)
            frame = re.search(r'\d+ bytes stack frame.*', entry)
            lines.append((f'MT={mt.group(1)}: ' if mt else '')
                         + f'{regs.group(0) if regs else "?"}; {frame.group(0) if frame else "?"}')
        return name, ' / '.join(lines) or '?'

    paths = {('base' if loop == 'fwd' else f'{loop} base'): _source(loop) for loop in loops}
    paths.update(sources)
    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        table = dict(pool.map(one, paths.items()))
    for name, line in table.items():
        print(f'{name}: {line}', flush=True)
    return table


def inputs(B: int, T: int, T_in: int, seed: int = 3, dtype: torch.dtype = torch.bfloat16):
    """decoder_fwd_loop's arguments in `dtype` at the default widths on seeded values,
    keep-gates at 0.9, the prenet's output of dropout-masked ReLUs."""
    from ..config import default_hparams
    from ..models.tacotron.model import DecoderCell
    from ..ops import decoder_vjp as dv

    hp = default_hparams()
    torch.manual_seed(seed)
    cell = DecoderCell(hp, 2 * hp.encoder_lstm_units).cuda()
    bf = dtype
    cfg = dv._config(cell, bf)
    W = dv._weights(cfg, cell, [cell.get_parameter(n) for _, n in dv.PARAMS], B, T_in)
    g = torch.Generator('cuda').manual_seed(seed)
    U, n_p, E, D = dv.LOOP_WIDTHS
    keys = torch.randn(B, T_in, D, device='cuda', generator=g).to(bf)
    values = torch.randn(B, T_in, E, device='cuda', generator=g) * 0.5
    keep = torch.rand(T, B, n_p, device='cuda', generator=g) < 0.5
    p2 = (torch.relu(torch.randn(T, B, n_p, device='cuda', generator=g)) * 2 * keep).to(bf)
    gates = [torch.rand(T, B, U, device='cuda', generator=g) < 0.9 for _ in range(4)]
    return cfg, W, keys, values, None, p2, gates


def bwd_inputs(B: int, T: int, T_in: int, seed: int = 3, dtype: torch.dtype = torch.bfloat16):
    """decoder_bwd_loop's arguments in `dtype`: the residuals of the forward loop of the
    dtype (the port's build) on `inputs`', seeded gradients of the projections and the
    alignments."""
    from ..ops import decoder_vjp as dv

    cfg, W, keys, values, mask, p2, gates = inputs(B, T, T_in, seed, dtype)
    with torch.no_grad():
        R = dv.decoder_fwd_loop(cfg, W, keys, values, mask, p2, gates, True)[3]
    g = torch.Generator('cuda').manual_seed(seed + 1)
    U, _, E, _ = dv.LOOP_WIDTHS
    dproj = (torch.randn(T, B, U + E, device='cuda', generator=g) * 0.1).to(dtype)
    g_aligns = torch.randn(T, B, T_in, device='cuda', generator=g)
    return cfg, W, keys, values, mask, R, dproj, g_aligns, gates


def run(library, args, save: bool, profile=None, loop: str = 'fwd'):
    """One launch of `library`'s kernel through decoder_fwd_loop (or decoder_bwd_loop)."""
    from ..ops import decoder_vjp as dv

    attr = LOOPS[loop]['attr']
    saved = getattr(dv, attr)
    setattr(dv, attr, lambda: library)
    try:
        if loop in ('fwd', 'f32'):
            return dv.decoder_fwd_loop(*args, save, profile=profile)
        return dv.decoder_bwd_loop(*args, profile=profile)
    finally:
        setattr(dv, attr, saved)


def main(argv: Optional[list] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--loop', default='fwd,bwd',
                   help='of fwd, bwd, f32 and bwd_f32, comma-separated')
    p.add_argument('--variants', default=','.join(VARIANTS),
                   help=f'comma-separated, of {", ".join(VARIANTS)} or a --source name')
    p.add_argument('--batch', default='32,1', help='batch size(s), comma-separated')
    p.add_argument('--steps', type=int, default=512)
    p.add_argument('--t_in', type=int, default=100)
    p.add_argument('--lean', action='store_true', help='save no residuals (the forward)')
    p.add_argument('--source', action='append', default=[], metavar='NAME=PATH',
                   help='a variant NAME built from the kernel source at PATH (of the one '
                        'loop that --loop names)')
    p.add_argument('--registers', action='store_true',
                   help="print each source's registers and spills (nvcc -Xptxas -v)")
    args = p.parse_args(argv)
    loops = args.loop.split(',')
    sources = dict(item.split('=', 1) for item in args.source)
    if sources and len(loops) != 1:
        raise ValueError('--source names a copy of one loop\'s source: give one --loop')
    if args.registers:
        return registers(sources, loops)
    if not torch.cuda.is_available():
        raise RuntimeError('loop_split times the kernel on a CUDA card; torch finds none')
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = args.variants.split(',')
    with tempfile.TemporaryDirectory(prefix='t2_loop_split_') as tmp:
        libs = {loop: build(sorted(set(variants) | {'base'}), tmp, sources, loop)
                for loop in loops}
    save, T = not args.lean, args.steps
    results = {}
    for loop in loops:
        stages = LOOPS[loop]['stages']
        n = len(stages)
        for B in (int(b) for b in args.batch.split(',')):
            dtype = torch.float32 if loop in ('f32', 'bwd_f32') else torch.bfloat16
            bwd = loop in ('bwd', 'bwd_f32')
            largs = (bwd_inputs(B, T, args.t_in, dtype=dtype) if bwd else
                     inputs(B, T, args.t_in, dtype=dtype))
            outs = slice(0, 3) if not bwd else slice(None)
            ref = run(libs[loop]['base'], largs, save, loop=loop)
            for i, name in enumerate(variants):
                prof = (torch.zeros(128, 2 * n, dtype=torch.int64, device='cuda')
                        if name == 'profile' else None)
                out = run(libs[loop][name], largs, save, prof, loop)
                same = all(torch.equal(a, b) for a, b in zip(out[outs], ref[outs]))
                err = max(float((a.double() - b.double()).abs().max()) for a, b in
                          zip(out[outs], ref[outs]))
                if name == 'profile' and not same:
                    raise RuntimeError(f'the profile build changed the {loop} loop\'s outputs')
                ms = best_ms(lambda: run(libs[loop][name], largs, save, loop=loop), reps=3)
                what = (f'residuals {save}' if not bwd else 'reverse loop')
                line = (f'{loop} {name} B={B} T={T} T_in={args.t_in} {what}: {ms:.3f} ms, '
                        f'{1e3 * ms / T:.2f} us a step; outputs against base: '
                        + ('bit for bit' if same else f'max abs {err:.3e}'))
                r = dict(ms=ms, us_step=1e3 * ms / T, bit_identical=same, max_abs_err=err)
                if prof is not None:
                    us = prof.double().cpu() / 1e3 / T  # (CTA, slot) us a step
                    split = {s: dict(work=float(us[:, k].mean()),
                                     work_max=float(us[:, k].max()),
                                     wait=float(us[:, n + k].mean()),
                                     wait_max=float(us[:, n + k].max()))
                             for k, s in enumerate(stages)}
                    r['split'] = split
                    line += ('; us a step, work / wait (mean over the CTAs, the largest): '
                             + '; '.join(f'{s} {v["work"]:.2f} ({v["work_max"]:.2f}) / '
                                         f'{v["wait"]:.2f} ({v["wait_max"]:.2f})'
                                         for s, v in split.items()))
                print(line, flush=True)
                results[f'{loop} {name} B={B} #{i}'] = r
    return results


if __name__ == '__main__':
    main()
