"""Where the AR kernel's step goes, on the card: the split of a step inside the kernel.

Not a counterpart of a TPU kernel: a timing probe of the port's own AR kernel. The
variant `profile` is the kernel's source built with -DT2_PROFILE into a library of its
own (`ops._build.compile_library`), which adds up, in thread 0 of the first CTA, the
%globaltimer nanoseconds of each phase of the step (the slots of `SLOTS`, in the order
the step runs them; the layer phases summed over the layers), read out after the
launch; `base` is the port's own build. Both are launched through `generate_ar` on
seeded random weights at full width, timed side by side, and the profile build's
outputs are held to the port's own (bit for bit: the macro changes no sum):

    python -m tacotron2_tpu_torch.probes.ar_split [--variants base,profile]
        [--configs default,paper,big] [--batch 2] [--steps 1100] [--cluster N]
"""

import argparse
import concurrent.futures
import ctypes
import os
import tempfile
from typing import Dict, Optional

import torch

from . import best_ms

# variant -> the macros it is built with
VARIANTS = {'base': (), 'profile': ('T2_PROFILE',)}
# the profile's slots (csrc/wavenet_ar.cu ProfSlot), in the order a step runs them
SLOTS = ('stage', 'cond', 'taps', 'gate0', 'layer_work', 'arrive', 'wait', 'matvec',
         'head_skip', 'head_s1', 'sample', 'feedback')
CONFIGS = {'default': '', 'paper': None,
           'big': "input_type='mulaw-quantize',quantize_channels=65536,out_channels=65536"}


def build(variants, tmp: str) -> Dict[str, ctypes.CDLL]:
    """The library of each variant (the port's own for `base`), built at once."""
    from ..ops import _build

    def one(name):
        macros = VARIANTS[name]
        if not macros:
            return name, _build.load_library()
        lib = os.path.join(tmp, f'libar_{name}.so')
        _build.compile_library([os.path.join(_build.CSRC_DIR, 'wavenet_ar.cu')], lib,
                               defines=macros)
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


def run(library, hp, weights, c_up, noise, cluster: Optional[int]):
    """One launch of `library`'s kernel through generate_ar (no params; the big head
    sampled with the NLL of class ids 0)."""
    from ..ops import wavenet_ar

    kernel_fn = wavenet_ar._kernel_fn
    wavenet_ar._kernel_fn = lambda: kernel_fn(library)
    try:
        kw = {}
        if wavenet_ar.is_big_vocab(hp):
            kw = dict(seed=5, y_eval=torch.zeros(c_up.shape[:2], dtype=torch.long,
                                                 device=c_up.device))
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
                   help=f'comma-separated, of {", ".join(VARIANTS)}')
    p.add_argument('--configs', default=','.join(CONFIGS))
    p.add_argument('--batch', default='2', help='batch size(s), comma-separated')
    p.add_argument('--steps', type=int, default=1100)
    p.add_argument('--cluster', type=int, default=None, help='force a cluster size')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('ar_split times the kernel on a CUDA card; torch finds none')
    from ..ops import wavenet_ar

    torch.backends.cuda.matmul.allow_tf32 = False
    variants = args.variants.split(',')
    with tempfile.TemporaryDirectory(prefix='t2_ar_split_') as tmp:
        libs = build(sorted(set(variants) | {'base'}), tmp)
    results = {}
    gen = torch.Generator('cuda').manual_seed(2)
    for config in args.configs.split(','):
        hp, weights, net = model(config)
        for B in (int(b) for b in args.batch.split(',')):
            T = args.steps
            mel = torch.rand(B, -(-T // hp.get_hop_size()), hp.num_mels, generator=gen,
                             device='cuda')
            with torch.no_grad():
                c_up = net.upsample_conditioning(mel)[:, :T].contiguous()
            noise = wavenet_ar.make_noise(hp, gen, B, T)
            ref = run(libs['base'], hp, weights, c_up, noise, args.cluster)[0]
            for name in variants:
                lib = libs[name]
                out = run(lib, hp, weights, c_up, noise, args.cluster)[0]
                same = torch.equal(out, ref)
                if name == 'profile':
                    profile_split(lib, T, hp.layers)  # zero the slots
                    run(lib, hp, weights, c_up, noise, args.cluster)
                    torch.cuda.synchronize()
                    split = profile_split(lib, T, hp.layers)
                else:
                    split = None
                ms = best_ms(lambda: run(lib, hp, weights, c_up, noise, args.cluster), 2)
                key = f'{config} B={B} {name}'
                results[key] = dict(us_step=1000 * ms / T, same_as_base=same, split=split,
                                    clusters=dict(wavenet_ar.LAUNCHES_BY_CLUSTER))
                print(f'{key}: {1000 * ms / T:.2f} us/step, ids/audio as the port\'s build: '
                      f'{same}' + ('; split us/step: ' + ', '.join(
                          f'{k} {v:.2f}' for k, v in split.items())
                          + f' (sum {sum(split.values()):.2f})' if split else ''), flush=True)
    print(f'{torch.cuda.get_device_name(0)}; launches by cluster size '
          f'{dict(wavenet_ar.LAUNCHES_BY_CLUSTER)}')
    return results


if __name__ == '__main__':
    main()
