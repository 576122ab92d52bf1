"""Where the AR kernel's step goes, on the card: the split of a step inside the kernel.

Not a counterpart of a TPU kernel: a timing probe of the port's own AR kernel. The
variant `profile` is the kernel's source built with -DT2_PROFILE into a library of its
own (`ops._build.compile_library`), which adds up, in thread 0 of the first CTA, the
%globaltimer nanoseconds of each phase of the step (the slots of `SLOTS`, in the order
the step runs them; the layer phases summed over the layers), read out after the
launch; `base` is the port's own build; `--source NAME=PATH` adds a variant NAME built
from another copy of the kernel's source, such as a parent checkout's, to time two
versions in one run (a name may repeat in `--variants`: each is timed in turn). All are
launched through `generate_ar` on seeded random weights at full width, timed side by
side, and each variant's outputs are held to the port's own build (bit for bit: the
profile macro changes no sum). A config names a head and chain at the defaults' widths
(`default` the Gaussian head on the fused chain), or the paper profile (`paper`); the
categorical heads in NLL_CONFIGS run with the in-kernel NLL of class ids 0.
`--registers` prints instead each template instantiation's registers, stack and spills
(`nvcc -Xptxas -v`) of the port's source and of each --source, side by side:

    python -m tacotron2_tpu_torch.probes.ar_split [--variants base,profile]
        [--configs default,paper,big] [--batch 2] [--steps 1100] [--cluster N]
        [--sequences P] [--source NAME=PATH ...] [--registers]
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

# variant -> the macros it is built with
VARIANTS = {'base': (), 'profile': ('T2_PROFILE',)}
# the profile's slots (csrc/wavenet_ar.cu ProfSlot), in the order a step runs them
SLOTS = ('stage', 'cond', 'taps', 'gate0', 'layer_work', 'arrive', 'wait', 'matvec',
         'head_skip', 'head_s1', 'sample', 'feedback')
CATEGORICAL = "input_type='mulaw-quantize',quantize_channels=256,out_channels=256"
CONFIGS = {'default': '', 'paper': None, 'plain': 'wavenet_fused_ar=False',
           'mol': 'out_channels=30', 'categorical': CATEGORICAL,
           'categorical_nll': CATEGORICAL,
           'big': "input_type='mulaw-quantize',quantize_channels=65536,out_channels=65536"}
NLL_CONFIGS = ('categorical_nll', 'big')  # the big head always runs with it here


def build(variants, tmp: str, sources: Optional[Dict[str, str]] = None
          ) -> Dict[str, ctypes.CDLL]:
    """The library of each variant (the port's own for `base`; those of `sources`
    built from the source file each names), built at once."""
    from ..ops import _build

    sources = sources or {}

    def one(name):
        macros = VARIANTS.get(name, ())
        if not macros and name not in sources:
            return name, _build.load_library()
        lib = os.path.join(tmp, f'libar_{name}.so')
        src = sources.get(name, os.path.join(_build.CSRC_DIR, 'wavenet_ar.cu'))
        _build.compile_library([src], lib, defines=macros)
        return name, ctypes.CDLL(lib)

    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants))


def model(config: str, seed: int = 1):
    """(hp, packed weights, WaveNet on the card) of a profile with seeded weights."""
    from ..config import default_hparams, paper_hparams
    from ..models.wavenet.model import WaveNet
    from ..ops import wavenet_ar
    from ..utils import randomize_weights

    hp = paper_hparams() if CONFIGS[config] is None else default_hparams()
    if CONFIGS[config]:
        hp.parse(CONFIGS[config])
    net = randomize_weights(WaveNet(hp), torch.Generator().manual_seed(seed)).cuda().eval()
    return hp, wavenet_ar.pack_params(net, hp), net


def registers(sources: Dict[str, str]) -> Dict[str, Dict[tuple, str]]:
    """{variant: {(head, chain, nll, small): 'R regs, S bytes stack, X spill stores, Y
    spill loads'}} of the port's source (`base`) and of each of `sources`, from
    `nvcc -Xptxas -v` (the head and chain enums of csrc/wavenet_ar.cu), printed side by
    side."""
    from ..ops import _build

    paths = {'base': os.path.join(_build.CSRC_DIR, 'wavenet_ar.cu'), **sources}

    def one(item):
        name, path = item
        with tempfile.TemporaryDirectory(prefix='t2_ptxas_') as tmp:
            res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-Xptxas', '-v', '-o',
                                  os.path.join(tmp, 'lib.so'), path],
                                 capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f'nvcc failed on {path}:\n{res.stderr[-3000:]}')
        out, kernel, props = {}, None, ''
        for line in (res.stdout + res.stderr).splitlines():
            m = re.search(r'Function properties for \S*wavenet_ar_kernel'
                          r'ILi(\d)ELi(\d)ELb(\d)ELb(\d)E', line)
            if m:
                kernel = tuple(int(g) for g in m.groups())
                continue
            if kernel and 'stack frame' in line:
                props = line.strip()
            m = re.search(r'Used (\d+) registers', line)
            if kernel and m:
                out[kernel] = f'{m.group(1)} regs, {props}'
                kernel = None
        return name, out

    with concurrent.futures.ThreadPoolExecutor(len(paths)) as pool:
        table = dict(pool.map(one, paths.items()))
    for key in sorted(table['base']):
        print(f'head {key[0]} chain {key[1]} nll {key[2]} small {key[3]}: ' + ' | '.join(
            f'{name} {table[name].get(key, "-")}' for name in table), flush=True)
    return table


def run(library, hp, weights, c_up, noise, cluster: Optional[int], nll: bool = False,
        sequences: Optional[int] = None):
    """One launch of `library`'s kernel through generate_ar (no params; with `nll`, a
    categorical head with the NLL of class ids 0; the big head sampled from seed 5)."""
    from ..ops import wavenet_ar

    kernel_fn = wavenet_ar._kernel_fn
    wavenet_ar._kernel_fn = lambda: kernel_fn(library)
    try:
        kw = dict(seed=5) if wavenet_ar.is_big_vocab(hp) else {}
        if sequences:
            kw['sequences'] = sequences
        if nll:
            kw['y_eval'] = torch.zeros(c_up.shape[:2], dtype=torch.long, device=c_up.device)
        return wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False,
                                      cluster=cluster, **kw)
    finally:
        wavenet_ar._kernel_fn = kernel_fn


def profile_split(library, T: int, L: int) -> Dict[str, float]:
    """The profile build's slots after one launch of T steps, in us a step."""
    fn = library.wavenet_ar_profile
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * len(SLOTS))()
    if fn(ctypes.addressof(out)) != 0:
        raise RuntimeError('reading the profile slots failed')
    return {name: out[i] / 1000.0 / T for i, name in enumerate(SLOTS)}


def main(argv: Optional[list] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--variants', default=','.join(VARIANTS),
                   help=f'comma-separated, of {", ".join(VARIANTS)} or a --source name')
    p.add_argument('--configs', default=','.join(CONFIGS))
    p.add_argument('--batch', default='2', help='batch size(s), comma-separated')
    p.add_argument('--steps', type=int, default=1100)
    p.add_argument('--cluster', type=int, default=None, help='force a cluster size')
    p.add_argument('--sequences', type=int, default=None,
                   help='force the sequences a cluster (1, or 2 on a cluster of 2)')
    p.add_argument('--source', action='append', default=[], metavar='NAME=PATH',
                   help='a variant NAME built from the kernel source at PATH')
    p.add_argument('--registers', action='store_true',
                   help="print each instantiation's registers and spills (nvcc -Xptxas -v)")
    args = p.parse_args(argv)
    sources = dict(item.split('=', 1) for item in args.source)
    if args.registers:
        return registers(sources)
    if not torch.cuda.is_available():
        raise RuntimeError('ar_split times the kernel on a CUDA card; torch finds none')
    from ..ops import wavenet_ar

    torch.backends.cuda.matmul.allow_tf32 = False
    variants = args.variants.split(',')
    with tempfile.TemporaryDirectory(prefix='t2_ar_split_') as tmp:
        libs = build(sorted(set(variants) | {'base'}), tmp, sources)
    results = {}
    gen = torch.Generator('cuda').manual_seed(2)
    for config in args.configs.split(','):
        hp, weights, net = model(config)
        nll = config in NLL_CONFIGS
        for B in (int(b) for b in args.batch.split(',')):
            T = args.steps
            mel = torch.rand(B, -(-T // hp.get_hop_size()), hp.num_mels, generator=gen,
                             device='cuda')
            with torch.no_grad():
                c_up = net.upsample_conditioning(mel)[:, :T].contiguous()
            noise = wavenet_ar.make_noise(hp, gen, B, T)
            ref = run(libs['base'], hp, weights, c_up, noise, args.cluster, nll,
                      sequences=args.sequences)[0]
            for i, name in enumerate(variants):
                lib = libs[name]
                kw = dict(sequences=args.sequences)
                wavenet_ar.LAUNCHES_BY_LAYOUT.clear()
                out = run(lib, hp, weights, c_up, noise, args.cluster, nll, **kw)[0]
                (layout,) = wavenet_ar.LAUNCHES_BY_LAYOUT
                same = torch.equal(out, ref)
                if name == 'profile':
                    profile_split(lib, T, hp.layers)  # zero the slots
                    run(lib, hp, weights, c_up, noise, args.cluster, nll, **kw)
                    torch.cuda.synchronize()
                    split = profile_split(lib, T, hp.layers)
                else:
                    split = None
                ms = best_ms(lambda: run(lib, hp, weights, c_up, noise, args.cluster, nll,
                                         **kw), 2)
                key = f'{config} B={B} {name}'
                if variants[:i].count(name):
                    key += f' ({variants[:i].count(name) + 1})'
                results[key] = dict(us_step=1000 * ms / T, same_as_base=same, split=split,
                                    layout=layout)
                print(f'{key}: {1000 * ms / T:.2f} us/step (N, P) = {layout}, ids/audio as '
                      f'the port\'s build: {same}' + ('; split us/step: ' + ', '.join(
                          f'{k} {v:.2f}' for k, v in split.items())
                          + f' (sum {sum(split.values()):.2f})' if split else ''), flush=True)
    print(torch.cuda.get_device_name(0))
    return results


if __name__ == '__main__':
    main()
