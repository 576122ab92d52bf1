#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive the main path.

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):
  1. torch, CUDA and the card (nvidia-smi name and power limit);
  2. build the hand-written kernels from tacotron2_tpu_torch/csrc;
  3. the WaveNet AR kernel against its plain PyTorch version at the default width, on
     a WaveNet whose seeded random weights give params of order 1: the kernel runs
     free with its params, the plain version runs on the same CUDA tensors
     teacher-forced on the kernel's audio, and the params agree to max abs
     KERNEL_TOL; at B=8 over 10 mel frames, at the batch path's shape (B=2, 128
     frames, 35,200 steps, through the real conditioning preparation and upsampler;
     here the plain version runs in the three state-carried chunks of one served
     request, SERVE_BOUNDS), and at B=20 over 10 frames (the default WaveNet batch,
     whose conditioning row stays f32); before that, five planted faults (packed weights as a kernel with
     one bug would read them) must each miss the plain version by more than
     KERNEL_TOL;
  4. the Tacotron half on the card against the same model on the CPU (explicit prenet
     masks, 16 steps, max abs 1e-3 with TF32 off);
  5. the main path, text -> mel -> wav, at full width with the same WaveNet through
     `python -m tacotron2_tpu_torch.synthesize`: two sentences of sentences.txt,
     stop tokens suppressed, max_iters=128; every wav has 128*hop samples, all
     finite, and the AR kernel launched;
  6. the AR kernel's state carry at full width, twice: B=2 in three chunks at odd
     ends (STATE_BOUNDS) over the real upsampler's conditioning, and the service's
     own shape, B=1 in the chunks of one served request (SERVE_BOUNDS) over sequence 0
     of phase 3's B=2 run. Each is bit-identical to one fresh call (the second to
     that run's row 0, audio and params), its params and its state after chunk 1 are
     within KERNEL_TOL of the plain version run in the same chunks and
     teacher-forced, and two planted state faults (t_base reset to 0, chunk 2
     started fresh) each miss the plain version by more than KERNEL_TOL;
  7. the service, `tacotron2_tpu_torch.serve.build_server`, at full width with the
     same WaveNet (stop tokens suppressed, max_iters=128: 35,200 samples a request):
     a GET wav, a POST f32 with a seed, two pcm16 at once and one request of
     scripts/measure_ttfa.py; exact byte counts, finite f32 samples, /healthz, and
     three AR launches per request (chunks of 4,352 + 16,512 + 14,336 samples).
Then a JSON line of the kernels, the card's nvidia-smi line, and the result line.
"""

import http.client
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# kernel vs plain version on weights whose params span about 1: on an H100 the two
# differ by 2.0e-3 (B=8, 2,750 steps) and 2.3e-3 (B=2, 35,200 steps), where bf16
# rounding of an activation flips with the f32 sum order; the planted faults miss by
# 4.4e-2 and more. The bound sits between, about 4x from each.
KERNEL_TOL = 1e-2
TACOTRON_TOL = 1e-3  # f32 on both devices, TF32 off; only sum order differs
MAX_ITERS = 128
MAIN_BATCH = 2      # sentences, and so sequences per AR launch, on the main path
WAVENET_BATCH = 20  # hp.wavenet_synthesis_batch_size: past 16, the conditioning row is f32
# phase 6's chunk ends at B=2: the ring windows are powers of two from 2 to 1,024
# slots, so only an odd t_base leaves t_base mod win nonzero in every layer, and a
# dropped t_base visible in every ring
STATE_BOUNDS = (1153, 2179, 2560)
SERVE_CHUNKS = [4352, 16512, 14336]  # streaming.py:115-117's rounding of 0.20 s, 0.75 s
# one served request's chunk ends (its 35,200 samples are phase 3's B=2 length). These
# t_base are multiples of 128, so a dropped one shows only in the 512- and 1,024-slot
# rings at 4,352 (and in the 256-slot rings too at 20,864)
SERVE_BOUNDS = tuple(int(b) for b in np.cumsum(SERVE_CHUNKS))
FAULT_STEPS = 256  # steps of chunk 2 run from each planted state fault


def phase(n, msg):
    print(f'[{n}] {msg}', flush=True)


def fail(msg):
    print(f'FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn):
    """(result, milliseconds) of fn() between two CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _conditioning(model, hp, B, frames, gen):
    """c_up (B, frames*hop, cin) from random mels in [lo, hi] through the main path's
    own preparation (clip, pad, rescale) and the model's upsampler."""
    from tacotron2_tpu_torch.inference.wavenet_synthesizer import prepare_conditions

    hi = hp.max_abs_value
    lo = -hi if hp.symmetric_mels else 0.0
    mels = torch.rand(B, frames, hp.num_mels, generator=gen, device=gen.device)
    mels = lo + (hi - lo) * mels
    with torch.no_grad():
        return model.upsample_conditioning(prepare_conditions(list(mels), hp)).contiguous()


def _clone_state(state):
    return state[0].clone(), state[1].clone(), state[2]


def _state_err(a, b):
    return max((a[0] - b[0]).abs().max().item(), (a[1] - b[1]).abs().max().item())


def run_chunked(run, weights, c_up, noise, hp, bounds, targets=None):
    """`run` (generate_ar or generate_ar_reference) over c_up and noise in
    state-carried chunks ending at `bounds`, the last at T; `targets` teacher-forces.
    Returns the audio, the params and a copy of the state after chunk 1 (a state is
    consumed in place by the next chunk)."""
    outs, state, after1 = [], None, None
    for lo, hi in zip((0,) + tuple(bounds[:-1]), bounds):
        kw = {} if targets is None else dict(targets=targets[:, lo:hi])
        out = run(weights, c_up[:, lo:hi].contiguous(), noise[:, lo:hi].contiguous(), hp,
                  state_in=state, return_state=hi < bounds[-1], **kw)
        outs.append(out[:2])
        if hi < bounds[-1]:
            state = out[2]
            if after1 is None:
                after1 = _clone_state(state)
    return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1), after1


def kernel_vs_plain(weights, model, hp, B, frames, gen, bounds=None):
    """The kernel free-running with its params, the plain version on the same CUDA
    tensors teacher-forced on the kernel's audio, in one call or, with `bounds`, in
    state-carried chunks ending there (the last at T); both timed with CUDA events.
    Returns the readings, and the inputs and outputs for phase 6."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    c_up = _conditioning(model, hp, B, frames, gen)
    T = c_up.shape[1]
    if bounds is not None and bounds[-1] != T:
        fail(f'chunk ends {bounds} do not end at T={T}')
    noise = wavenet_ar.make_noise(hp, gen, B, T)
    (audio, params), kernel_ms = cuda_ms(
        lambda: wavenet_ar.generate_ar(weights, c_up, noise, hp))
    if bounds is None:
        (_, ref_params), plain_ms = cuda_ms(lambda: wavenet_ar.generate_ar_reference(
            weights, c_up, noise, hp, targets=audio))
        ref_after1, how = None, ''
    else:
        (_, ref_params, ref_after1), plain_ms = cuda_ms(lambda: run_chunked(
            wavenet_ar.generate_ar_reference, weights, c_up, noise, hp, bounds,
            targets=audio))
        how = f' (plain version in chunks ending at {list(bounds)})'
    err = (params - ref_params).abs().max().item()
    span = (ref_params.max() - ref_params.min()).item()
    phase(3, f'wavenet_ar B={B} T={T}{how}: max_abs_err={err:.3e} (tol {KERNEL_TOL}, '
             f'params span {span:.3f}), kernel {1000 * kernel_ms / T:.1f} us/step, plain '
             f'{1000 * plain_ms / T:.1f} us/step, audio in [{audio.min().item():.3f}, '
             f'{audio.max().item():.3f}]')
    if not (torch.isfinite(audio).all() and torch.isfinite(params).all()) \
            or audio.abs().max().item() > 1.0:
        fail('kernel audio is not finite or leaves [-1, 1]')
    if not err <= KERNEL_TOL:
        fail(f'kernel params differ from the plain version by {err}')
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, c_up=c_up, noise=noise,
                audio=audio, params=params, ref_params=ref_params, ref_after1=ref_after1)


def planted_faults(hp):
    """Packed weights as a kernel with one bug would use them: each must take the
    kernel's params beyond KERNEL_TOL of the plain version's on the true weights."""
    from tacotron2_tpu_torch.ops.wavenet_ar import SQRT_HALF

    R, k = hp.residual_channels, hp.kernel_size
    past = (k - 1) * R

    def swap_taps(w):  # each past tap read from the other tap's ring slot
        L, _, G = w.shape
        taps = w[:, :past].reshape(L, k - 1, R, G).flip(1).reshape(L, past, G)
        return torch.cat([taps, w[:, past:]], dim=1).contiguous()

    def last_skip_scaled(w):  # the last layer's skip scaled once too often
        w = w.clone()
        w[-1, :, R:] *= SQRT_HALF
        return w

    return {'b_cond dropped': ('b_cond', torch.zeros_like),
            'conditioning dropped': ('w_cond', torch.zeros_like),
            'w_fused term dropped': ('w_fused', torch.zeros_like),
            'past ring taps swapped': ('w_tap', swap_taps),
            'last skip scaled twice': ('w_os', last_skip_scaled)}


def check_faults(weights, model, hp, gen):
    from tacotron2_tpu_torch.ops import wavenet_ar

    B, frames = 8, 1
    c_up = _conditioning(model, hp, B, frames, gen)
    noise = wavenet_ar.make_noise(hp, gen, B, c_up.shape[1])
    errs = {}
    for fault, (name, plant) in planted_faults(hp).items():
        audio, params = wavenet_ar.generate_ar({**weights, name: plant(weights[name])},
                                               c_up, noise, hp)
        _, ref = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, targets=audio)
        errs[fault] = (params - ref).abs().max().item()
    phase(3, f'planted faults, B={B} T={c_up.shape[1]}: max_abs_err '
             + ', '.join(f'{f} {e:.3e}' for f, e in errs.items()) + f' (each must exceed '
             f'tol {KERNEL_TOL})')
    missed = [f for f, e in errs.items() if not e > KERNEL_TOL]
    if missed:
        fail(f'the kernel check passes planted faults: {missed}')


def state_faults(weights, c2, n2, hp, k_after1, r_after1):
    """Chunk 2's first steps (c2, n2) on the kernel from two planted faults of its
    state after chunk 1 (t_base reset to 0; a fresh start, rings zeroed and h =
    first_b), each against the plain version from its own state after chunk 1,
    teacher-forced on the faulty audio: the params error of each."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    errs = {}
    for fault, state in (('t_base reset to 0', (*_clone_state(k_after1)[:2], 0)),
                         ('chunk 2 started fresh', None)):
        a, p = wavenet_ar.generate_ar(weights, c2, n2, hp, state_in=state)
        _, rp = wavenet_ar.generate_ar_reference(weights, c2, n2, hp, targets=a,
                                                 state_in=_clone_state(r_after1))
        errs[fault] = (p - rp).abs().max().item()
    return errs


def _judge_carry(n, what, r, bounds):
    """Print and check one state-carry reading (see check_state_carry)."""
    T = bounds[-1]
    phase(n, f'{what}, chunks ending at {list(bounds)}: bit-identical to one call: '
             f'{r["bit_identical"]}; chunked params max_abs_err={r["max_abs_err"]:.3e}, '
             f'state after chunk 1 max_abs_err={r["state_err"]:.3e}, t_base {r["t_base"]} '
             f'(tol {KERNEL_TOL}); planted state faults over {FAULT_STEPS} steps of chunk '
             f'2: ' + ', '.join(f'{f} {e:.3e}' for f, e in r['faults'].items())
             + f' (each must exceed tol); kernel {1000 * r["ms"] / T:.1f} us/step'
             + (f', plain {1000 * r["plain_ms"] / T:.1f} us/step' if r['plain_ms'] else ''))
    if not r['bit_identical']:
        fail(f'{what}: chunked kernel output differs from one call')
    if not (r['max_abs_err'] <= KERNEL_TOL and r['state_err'] <= KERNEL_TOL) \
            or r['t_base'] != (bounds[0], bounds[0]):
        fail(f'{what}: the streamed kernel differs from the plain version')
    if not (torch.isfinite(r['audio']).all() and r['audio'].abs().max().item() <= 1.0):
        fail(f'{what}: streamed kernel audio is not finite or leaves [-1, 1]')
    missed = [f for f, e in r['faults'].items() if not e > KERNEL_TOL]
    if missed:
        fail(f'{what}: the state carry check passes planted faults: {missed}')


def state_carry(weights, c_up, noise, hp, bounds):
    """The kernel in state-carried chunks ending at `bounds` against one fresh kernel
    call and against the plain version run in the same chunks, teacher-forced on the
    kernel's audio; then the two planted state faults over the first FAULT_STEPS steps
    of chunk 2. Returns the readings that _judge_carry checks."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    T = bounds[-1]
    c_up, noise = c_up[:, :T].contiguous(), noise[:, :T].contiguous()
    full, _ = wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False)
    (audio, params, k_after1), kernel_ms = cuda_ms(lambda: run_chunked(
        wavenet_ar.generate_ar, weights, c_up, noise, hp, bounds))
    (_, ref_params, r_after1), plain_ms = cuda_ms(lambda: run_chunked(
        wavenet_ar.generate_ar_reference, weights, c_up, noise, hp, bounds,
        targets=audio))
    lo, hi = bounds[0], min(bounds[0] + FAULT_STEPS, bounds[1])
    return dict(bit_identical=torch.equal(audio, full),
                max_abs_err=(params - ref_params).abs().max().item(),
                state_err=_state_err(k_after1, r_after1), t_base=(k_after1[2], r_after1[2]),
                faults=state_faults(weights, c_up[:, lo:hi].contiguous(),
                                    noise[:, lo:hi].contiguous(), hp, k_after1, r_after1),
                ms=kernel_ms, plain_ms=plain_ms, audio=audio)


def check_state_carry(weights, model, hp, gen, served):
    """Phase 6: the kernel in state-carried chunks against one fresh kernel call and
    against the plain version run in the same chunks, teacher-forced on the kernel's
    audio; then two planted state faults on chunk 2. First at B=2 over the real
    upsampler's conditioning at STATE_BOUNDS, then at the service's shape: B=1 at
    SERVE_BOUNDS over sequence 0 of `served`, phase 3's B=2 run, whose plain version
    already ran in those chunks."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    launches0 = wavenet_ar.LAUNCHES
    frames = -(-STATE_BOUNDS[-1] // hp.get_hop_size())
    c_up = _conditioning(model, hp, MAIN_BATCH, frames, gen)
    noise = wavenet_ar.make_noise(hp, gen, MAIN_BATCH, c_up.shape[1])
    small = state_carry(weights, c_up, noise, hp, STATE_BOUNDS)
    _judge_carry(6, f'state carry, B={MAIN_BATCH}', small, STATE_BOUNDS)

    c_up, noise = served['c_up'][:1].contiguous(), served['noise'][:1].contiguous()
    r_after1 = tuple(x[:1].contiguous() for x in served['ref_after1'][:2]) \
        + (served['ref_after1'][2],)
    (audio, params, k_after1), kernel_ms = cuda_ms(lambda: run_chunked(
        wavenet_ar.generate_ar, weights, c_up, noise, hp, SERVE_BOUNDS))
    lo, hi = SERVE_BOUNDS[0], SERVE_BOUNDS[0] + FAULT_STEPS
    service_shape = dict(
        bit_identical=torch.equal(audio, served['audio'][:1])
        and torch.equal(params, served['params'][:1]),
        max_abs_err=(params - served['ref_params'][:1]).abs().max().item(),
        state_err=_state_err(k_after1, r_after1), t_base=(k_after1[2], r_after1[2]),
        faults=state_faults(weights, c_up[:, lo:hi].contiguous(),
                            noise[:, lo:hi].contiguous(), hp, k_after1, r_after1),
        ms=kernel_ms, plain_ms=None, audio=audio)
    _judge_carry(6, 'state carry at the service\'s shape, B=1 (sequence 0 of phase 3\'s '
                    'B=2 run)', service_shape, SERVE_BOUNDS)
    launches = wavenet_ar.LAUNCHES - launches0
    phase(6, f'{launches} kernel launches')
    return dict(max_abs_err=max(small['max_abs_err'], service_shape['max_abs_err']),
                ms=small['ms'], plain_ms=small['plain_ms'], served_ms=service_shape['ms'],
                launches=launches)


def check_tacotron(hp):
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron

    torch.manual_seed(2)
    model = Tacotron(hp).eval()
    gen = torch.Generator().manual_seed(3)
    B, T_in, steps = 2, 48, 16
    inputs = torch.randint(2, 60, (B, T_in), generator=gen)
    lengths = torch.tensor([T_in, T_in - 9])
    keep = 1.0 - hp.tacotron_dropout_rate
    masks = tuple(torch.bernoulli(torch.full((steps, B, n), keep), generator=gen) / keep
                  for n in hp.prenet_layers)
    ref = model(inputs, lengths, max_iters=steps, masks=masks)['mel_outputs']
    got = model.cuda()(inputs.cuda(), lengths.cuda(), max_iters=steps,
                       masks=tuple(m.cuda() for m in masks))['mel_outputs']
    err = (got.cpu() - ref).abs().max().item()
    phase(4, f'tacotron cuda vs cpu, B={B} T_in={T_in} {steps} steps: max_abs_err={err:.3e} '
             f'(tol {TACOTRON_TOL})')
    if not err <= TACOTRON_TOL:
        fail(f'tacotron on the card differs from the CPU by {err}')


def main_path(hp_overrides, hp, wavenet_state):
    from tacotron2_tpu_torch import convert, synthesize
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.utils import suppress_stop_tokens

    with open(os.path.join(REPO, 'sentences.txt'), encoding='utf-8') as f:
        sentences = [line.strip() for line in f if line.strip()][:MAIN_BATCH]
    with tempfile.TemporaryDirectory(prefix='t2torch_smoke_') as tmp:
        torch.manual_seed(4)
        taco_path = os.path.join(tmp, 'tacotron.pt')
        wave_path = os.path.join(tmp, 'wavenet.pt')
        convert.save_checkpoint(taco_path, 'tacotron',
                                suppress_stop_tokens(Tacotron(hp).state_dict()))
        convert.save_checkpoint(wave_path, 'wavenet', wavenet_state)
        text_list = os.path.join(tmp, 'texts.txt')
        with open(text_list, 'w', encoding='utf-8') as f:
            f.write('\n'.join(sentences) + '\n')
        wavenet_ar.LAUNCHES = 0
        stats = synthesize.main(['--tacotron_checkpoint', taco_path,
                                 '--wavenet_checkpoint', wave_path,
                                 '--hparams', hp_overrides, '--text_list', text_list,
                                 '--output_dir', os.path.join(tmp, 'out'),
                                 '--device', 'cuda'])
        launches = wavenet_ar.LAUNCHES
        n_rows = len(open(os.path.join(tmp, 'out', 'map.txt'), encoding='utf-8')
                     .read().splitlines())
    want_len = MAX_ITERS * hp.outputs_per_step * hp.get_hop_size()
    lens = [len(w) for w in stats['wavs']]
    phase(5, f'main path: {len(lens)} wavs of {lens} samples, AR kernel launches={launches}; '
             f'{stats["decoded_frames"] / stats["tacotron_seconds"]:.1f} mel frames/s, '
             f'{stats["ar_samples"] / stats["wavenet_seconds"]:.0f} AR samples/s, '
             f'wall RTF {stats["seconds"] / stats["audio_seconds"]:.3f} '
             f'({stats["seconds"]:.2f} s for {stats["audio_seconds"]:.2f} s of audio)')
    if n_rows != len(sentences) or lens != [want_len] * len(sentences):
        fail(f'expected {len(sentences)} wavs of {want_len} samples, got {lens}')
    if not all(bool(torch.isfinite(torch.from_numpy(w)).all()) for w in stats['wavs']):
        fail('non-finite samples in the synthesized audio')
    if launches <= 0:
        fail('the main path never launched the AR kernel')
    return launches


def fetch(address, method, path, body=None, header_bytes=0):
    """One request: (status, body bytes, seconds to the first audio byte past
    `header_bytes`, seconds to the end)."""
    conn = http.client.HTTPConnection(*address, timeout=600)
    t0 = time.perf_counter()
    conn.request(method, path, body=body,
                 headers={'Content-Type': 'application/json'} if body else {})
    resp = conn.getresponse()
    data, first = b'', None
    while True:
        piece = resp.read1(65536)
        if not piece:
            break
        data += piece
        if first is None and len(data) > header_bytes:
            first = time.perf_counter() - t0
    wall = time.perf_counter() - t0
    conn.close()
    return resp.status, data, first, wall


def service(hp_overrides, hp, wavenet_state):
    """Phase 7: the streaming service through serve.build_server on the card."""
    from tacotron2_tpu_torch import convert, serve
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.utils import suppress_stop_tokens

    spec = importlib.util.spec_from_file_location(
        'measure_ttfa', os.path.join(REPO, 'scripts', 'measure_ttfa.py'))
    ttfa_client = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ttfa_client)
    n = MAX_ITERS * hp.outputs_per_step * hp.get_hop_size()
    text = 'The quick brown fox jumps over the lazy dog.'
    chunks = []  # (steps, kernel ms) of every AR launch the service makes, in order
    generate_ar = wavenet_ar.generate_ar

    def timed(weights, c_up, noise, hp, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = generate_ar(weights, c_up, noise, hp, **kw)
        end.record()
        end.synchronize()
        chunks.append((c_up.shape[1], start.elapsed_time(end)))
        return out

    with tempfile.TemporaryDirectory(prefix='t2torch_serve_') as tmp:
        torch.manual_seed(5)
        taco_path = os.path.join(tmp, 'tacotron.pt')
        wave_path = os.path.join(tmp, 'wavenet.pt')
        convert.save_checkpoint(taco_path, 'tacotron',
                                suppress_stop_tokens(Tacotron(hp).state_dict()))
        convert.save_checkpoint(wave_path, 'wavenet', wavenet_state)
        wavenet_ar.generate_ar = timed
        try:
            t0 = time.perf_counter()
            server = serve.build_server(['--taco_checkpoint', taco_path, '--wave_checkpoint',
                                         wave_path, '--device', 'cuda', '--port', '0',
                                         '--warmup_buckets', '1', '--hparams', hp_overrides])
            startup = time.perf_counter() - t0
            chunks.clear()
            wavenet_ar.LAUNCHES = 0
            server.start()
            try:
                addr = server.address
                results = {}
                results['GET wav'] = fetch(addr, 'GET', f'/tts?text={text.replace(" ", "+")}',
                                           header_bytes=44)
                results['POST f32 seed=7'] = fetch(addr, 'POST', '/tts', body=json.dumps(
                    dict(text=text, seed=7, format='f32')))
                threads = [threading.Thread(target=lambda i=i: results.__setitem__(
                    f'GET pcm16 #{i} (concurrent)',
                    fetch(addr, 'GET', f'/tts?text=Request+number+{i}.&format=pcm16')))
                    for i in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                client = ttfa_client.one_request(text, *addr)
                health = json.loads(fetch(addr, 'GET', '/healthz')[1])
            finally:
                server.close()
            launches = wavenet_ar.LAUNCHES
        finally:
            wavenet_ar.generate_ar = generate_ar

    want = {'GET wav': 44 + 2 * n, 'POST f32 seed=7': 4 * n,
            'GET pcm16 #0 (concurrent)': 2 * n, 'GET pcm16 #1 (concurrent)': 2 * n}
    phase(7, f'service up in {startup:.1f} s (load + 1 warmup stream); {len(results)} + 1 '
             f'requests of {n} samples each; {launches} AR kernel launches; /healthz {health}')
    for name, (status, data, first, wall) in results.items():
        phase(7, f'{name}: status {status}, {len(data)} bytes (want {want.get(name)}), '
                 f'first audio {first:.3f} s, wall {wall:.3f} s')
    phase(7, f'scripts/measure_ttfa.py: first audio {client["ttfa_first_audio_s"]} s, wall '
             f'{client["total_wall_s"]} s, {client["audio_seconds"]} s of audio, '
             f'{client["n_chunks"]} chunks')
    streams = [chunks[i:i + 3] for i in range(0, len(chunks), 3)]
    for i, stream in enumerate(streams):
        phase(7, f'stream {i}: AR chunks ' + ', '.join(
            f'{steps} steps at {1000 * ms / steps:.1f} us/step' for steps, ms in stream))
    bad = [name for name, (status, data, _, _) in results.items()
           if status != 200 or len(data) != want[name]]
    if bad or len(results) != 4:
        fail(f'service requests failed or returned the wrong byte counts: {bad}')
    f32 = np.frombuffer(results['POST f32 seed=7'][1], np.float32)
    if not np.isfinite(f32).all():
        fail('non-finite samples in the f32 response')
    if client['audio_seconds'] != round(n / hp.sample_rate, 3) \
            or not client['ttfa_first_audio_s'] <= client['total_wall_s']:
        fail(f'scripts/measure_ttfa.py read a wrong stream: {client}')
    if health['served'] < 4:
        fail(f'/healthz counts {health["served"]} served requests')
    if launches != 3 * 5 or [[s for s, _ in st] for st in streams] != [SERVE_CHUNKS] * 5:
        fail(f'expected 3 AR launches of {SERVE_CHUNKS} steps per request, got {launches}: '
             f'{[[s for s, _ in st] for st in streams]}')
    return launches


def main():
    if not torch.cuda.is_available():
        fail('torch finds no CUDA device')
    from tacotron2_tpu.config import default_hparams
    from tacotron2_tpu_torch.models.wavenet.model import WaveNet
    from tacotron2_tpu_torch.ops import _build, wavenet_ar
    from tacotron2_tpu_torch.utils import randomize_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase(1, f'torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, '
             f'{torch.cuda.device_count()} device(s); nvidia-smi: {smi}')

    t0 = time.perf_counter()
    _build.load_library()
    phase(2, f'built and loaded the CUDA kernels in {time.perf_counter() - t0:.1f} s')

    # one WaveNet with seeded random weights of order 1 for the kernel checks and the
    # main path; the checks run at the main path's batch and length too
    overrides = f'max_iters={MAX_ITERS},tacotron_synthesis_batch_size={MAIN_BATCH}'
    hp = default_hparams()
    hp.parse(overrides)
    wavenet = randomize_weights(WaveNet(hp), torch.Generator().manual_seed(1))
    wavenet_state = {k: v.clone() for k, v in wavenet.state_dict().items()}
    model = wavenet.cuda().eval()
    weights = wavenet_ar.pack_params(model, hp)
    gen = torch.Generator('cuda').manual_seed(2)
    check_faults(weights, model, hp, gen)
    kernel_vs_plain(weights, model, hp, 8, 10, gen)
    frames = MAX_ITERS * hp.outputs_per_step
    kernel = kernel_vs_plain(weights, model, hp, MAIN_BATCH, frames, gen, SERVE_BOUNDS)
    wide = kernel_vs_plain(weights, model, hp, WAVENET_BATCH, 10, gen)
    check_tacotron(hp)
    launches_batch = main_path(overrides, hp, wavenet_state)
    streamed = check_state_carry(weights, model, hp, gen, kernel)
    launches_serve = service(f'max_iters={MAX_ITERS}', hp, wavenet_state)

    # launches: the two main paths' runs, each counted from 0 (the batch CLI, phase 5,
    # and the service, phase 7); the checks' launches are listed apart
    print(json.dumps({'kernels': [dict(
        name='wavenet_ar_gaussian', route='cuda',
        source='tacotron2_tpu_torch/csrc/wavenet_ar.cu',
        replaces='tacotron2_tpu/ops/pallas/wavenet_ar.py:684',
        variants=['fresh', 'streamed'],
        launches=launches_batch + launches_serve,
        launches_by_path={'synthesize': launches_batch, 'serve': launches_serve,
                          'state_carry_check': streamed['launches']},
        max_abs_err=max(kernel['max_abs_err'], wide['max_abs_err'],
                        streamed['max_abs_err']),
        ms=kernel['ms'], plain_ms=kernel['plain_ms'],
        b20_ms=wide['ms'], b20_plain_ms=wide['plain_ms'],
        streamed_ms=streamed['ms'], streamed_plain_ms=streamed['plain_ms'],
        streamed_b1_ms=streamed['served_ms'])]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
