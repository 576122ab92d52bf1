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
     here the plain version, at 6 to 10 ms a step, follows the kernel over the first
     PLAIN_STEPS steps only, in the state-carried chunks of one served request,
     SERVE_BOUNDS, and a second kernel launch over those steps, bit-identical to the
     start of the first, is the one timed beside it), and at B=20 over 10 frames (the
     default WaveNet batch, whose conditioning row stays f32); before that, five
     planted faults (packed weights as a kernel with one bug would read them) must
     each miss the plain version by more than KERNEL_TOL;
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
     that run's row 0, audio and params), its params (as far as the plain version
     went) and its state after chunk 1 are
     within KERNEL_TOL of the plain version run in the same chunks and
     teacher-forced, and two planted state faults (t_base reset to 0, chunk 2
     started fresh) each miss the plain version by more than KERNEL_TOL;
  7. the service, `tacotron2_tpu_torch.serve.build_server`, at full width with the
     same WaveNet (stop tokens suppressed, max_iters=128: 35,200 samples a request):
     a GET wav, a POST f32 with a seed, two pcm16 at once and one request of
     scripts/measure_ttfa.py; exact byte counts, finite f32 samples, /healthz, and
     three AR launches per request (chunks of 4,352 + 16,512 + 14,336 samples);
  8. the paper profile (`config.paper_hparams()`: MoL-10 head, 24 layers in 4 stacks at
     R=256, G=512, S=256, the 2D upsampler, no legacy scalings) at full width on a
     WaveNet with seeded random weights whose head is quieted (quiet_mol_head) so that
     few samples clip: four planted MoL faults, each of which must miss (params beyond
     MOL_KERNEL_TOL or samples beyond SAMPLE_TOL of the MoL draw from the kernel's own
     params); the kernel against the plain version as in phase 3 at the paper batch
     path's shape (B=2, 8,800 steps; the plain version in the paper service's chunks,
     PAPER_SERVE_BOUNDS), its samples against the draw from its own params, at most
     MAX_CLIPPED of them at +-1, with the mixtures chosen differently counted; the
     state carry as in phase 6 at the paper service's shape (B=1 over row 0 of that
     run in its chunks; every ring window divides 4,352, so a reset t_base is no fault
     there and only the fresh start is planted) and at B=1 in chunks ending at odd
     PAPER_STATE_BOUNDS; then
     `synthesize --paper_profile` with two sentences and one request through
     `serve.build_server --paper_profile`, both at max_iters=PAPER_MAX_ITERS (8,800
     samples a sentence), with AR us/step from CUDA events, wall RTF, time to first
     audio and the launch counts;
  9. the standalone vocoder (`synthesize --model WaveNet`) at the full default width, on
     WaveNets with seeded random weights, and the three kernel variants it runs: global
     conditioning (a speaker's bias row g_cond), the categorical head over 256 classes,
     and the plain chain. Each of gaussian-plain, categorical-fused and gaussian-fused
     with g_cond at B=20 (f32 conditioning row) against its plain version as in phase
     6: B sequences over 1,100 steps in state-carried chunks ending at odd
     VOCODER_BOUNDS, bit-identical to one call, params and carried state within
     KERNEL_TOL, samples held to the draw from the kernel's own params (class ids
     exactly), two planted state faults. The two instantiations that the entry point
     launches, gaussian-fused with g_cond at B=2 (bf16 row) and categorical-plain, are
     held the same way further down, at the entry point's shape and on its inputs. Then
     seven planted faults, each of which its check must see miss (vocoder_faults): four
     through the kernel's inputs, three as builds of a copy of the kernel's source with
     one line changed (KERNEL_MUTANTS, compiled beside the kernel in phase 2); four of
     them move the params less than the kernel's own bf16 flips do over many steps, and
     are held by the first steps of a fresh call at B=16, where no history has built up
     (first_steps_err, FIRST_STEPS_TOL). A forced tie of two classes. Then the entry
     point: seeded mels as `mel-*.npy` with a `map.txt`, vocoded by
     `python -m tacotron2_tpu_torch.synthesize --model WaveNet --speaker_id 1,3` on a
     five-speaker WaveNet (again with 3,3: the first wav changes, the second does not)
     and by a mu-law-quantized WaveNet with the plain chain; wavs, map.txt, class ids
     and launches checked. The conditioning, noise and g_cond that each of these two
     launches was given (B=2, 8,800 steps) then go through the same check as above, in
     chunks ending at VOCODER_CLI_BOUNDS: the kernel's audio must be the entry
     point's, bit for bit, and its params within KERNEL_TOL of the plain version's
     over all 8,800 steps.
Then a JSON line of the kernels (with each kernel's bound: the larger of its bytes over
the HBM rate and its operations over the peak rate of their type, for the run timed),
the card's nvidia-smi line, and the result line.
"""

import concurrent.futures
import contextlib
import ctypes
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
# how far the plain version follows phase 3's B=2 launch of 35,200 steps (48 of its 128
# mel frames): at 6 to 10 ms a step the whole length takes 4 to 6 minutes of the run
PLAIN_STEPS = 13200
FAULT_STEPS = 256  # steps of chunk 2 run from each planted state fault
# the paper profile (phase 8)
PAPER_MAX_ITERS = 32  # the paper entry points: 8,800 samples a sentence
# the chunk ends of one served paper request (8,800 samples: the first chunk as at the
# default profile, the rest in one); the MoL checks run the plain version in these
PAPER_SERVE_BOUNDS = (SERVE_CHUNKS[0], 8800)
# the ring windows at 4 stacks of 6 layers are 2 to 64 slots, and each divides 4,352,
# where a reset t_base changes nothing; odd chunk ends leave t_base mod win nonzero in
# every ring (over the first 1,100 steps of the run above)
PAPER_STATE_BOUNDS = (377, 731, 1100)
# the seeded random head draws 68% of its samples at +-1, where a wrong mean or scale
# that keeps the sign passes; halving the means and lowering the log-scales by 3 puts
# them near 0.05 and the means within +-0.8, and the check fails past MAX_CLIPPED
MOL_MEAN_SCALE = 0.5
MOL_LOG_SCALE_SHIFT = -3.0
MAX_CLIPPED = 0.2
MOL_NO_FAULT = 'none (log-scales lowered by 9)'  # mol_fault_errors' run of the true kernel
# MoL kernel vs plain version at the paper width, on weights whose params span about
# 11: 2.0e-2 to 2.7e-2 in params and 3.3e-2 to 4.2e-2 in a carried state on an H100
# (bf16 flips of activations, about 2.5e-3 per unit of span, as the Gaussian's 2e-3),
# over 1,100 and 8,800 steps alike; the planted faults that change the params miss by
# 2.3 and more. The bound sits 2.4x above the readings and 20x below the faults.
MOL_KERNEL_TOL = 1e-1
SAMPLE_TOL = 1e-5  # kernel samples against the head's draw from the kernel's own params
# the standalone vocoder (phase 9): 32 frames a mel (8,800 samples), two mels
VOCODER_FRAMES = 32
VOCODER_BOUNDS = PAPER_STATE_BOUNDS  # odd chunk ends: t_base mod win nonzero in every ring
VOCODER_CLI_BOUNDS = VOCODER_BOUNDS[:2] + (VOCODER_FRAMES * 275,)  # the entry point's length
CATEGORICAL = "input_type='mulaw-quantize',quantize_channels=256,out_channels=256"
SPEAKERS = 'gin_channels=16,n_speakers=5'
# one-line changes of csrc/wavenet_ar.cu, each a fault that no input of the true kernel
# reproduces: name -> (the line as it stands, the line with the fault)
KERNEL_MUTANTS = {
    'g_cond added after the bf16 rounding': (
        '        if (a.g_cond != nullptr) v += a.g_cond[(size_t)b * LG + g * COLS + q];\n'
        '        cond[g * COLS + q] = a.round_cond ? bf16r(v) : v;\n',
        '        cond[g * COLS + q] = (a.round_cond ? bf16r(v) : v) + (a.g_cond != nullptr\n'
        '            ? a.g_cond[(size_t)b * LG + g * COLS + q] : 0.f);\n'),
    'feedback from the f32 first_w row': (
        '          acc = bf16r(a.first_w[(size_t)id * R + r]);\n',
        '          acc = a.first_w[(size_t)id * R + r];\n'),
    'plain chain ring written with the layer\'s output': (
        '            ring[ring_off[li] + slot * R + c] = hc;\n'
        '            hb[c] = bf16r(hc);\n',
        '            if (li > 0)\n'
        '              ring[ring_off[li - 1] + ((base[li - 1] + t) % win[li - 1]) * R + c] = hc;\n'
        '            hb[c] = bf16r(hc);\n')}
# the first steps of a fresh call at B=16 (the largest batch whose conditioning row is
# rounded to bf16): no rounding flip has a history yet, so in most sequences the kernel
# and its plain version differ by the f32 sum order alone. Over 2 steps on an H100 10 or
# 11 of the 16 sequences read 7.5e-9 to 1.2e-7 and the others, where a rounding flips at
# once, 1.5e-5 to 9.0e-4; the faults this check is for move the params by 6.7e-5 (the
# first skip scaled; 9.0e-5 on another draw of the inputs) to 5.2e-4. The reading is the lower quartile over the sequences of
# each one's max abs params error, which sets the flipped sequences aside; its bound
# sits 22x above the true kernel's largest reading (8.9e-8) and 33x below the smallest
# fault's
FIRST_STEPS = 2
FIRST_STEPS_BATCH = 16
FIRST_STEPS_TOL = 2e-6
# the card's peaks (H100 SXM data sheet, dense, at 700 W): the bound of a launch
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


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


@contextlib.contextmanager
def ar_timer(calls=None):
    """Time every AR launch made inside the block with CUDA events: yields the list
    of (steps, kernel ms), one entry a launch, in order; each launch's c_up, noise,
    g_cond and audio are appended as a dict to `calls` when that is a list."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    chunks, generate_ar = [], wavenet_ar.generate_ar

    def timed(weights, c_up, noise, hp, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = generate_ar(weights, c_up, noise, hp, **kw)
        end.record()
        end.synchronize()
        chunks.append((c_up.shape[1], start.elapsed_time(end)))
        if calls is not None:
            calls.append(dict(c_up=c_up, noise=noise, g_cond=kw.get('g_cond'), audio=out[0]))
        return out

    wavenet_ar.generate_ar = timed
    try:
        yield chunks
    finally:
        wavenet_ar.generate_ar = generate_ar


def ar_bound(hp, weights, B, T, return_params=True, has_g=False):
    """(bound ms, 'operations' or 'bytes') of one fresh AR launch over B sequences of
    T steps: the larger of its bytes over the HBM rate (each input read once: c_up,
    noise ((B, T, Q) for the categorical head), the packed weights, g_cond with
    `has_g`; each output written once: audio, params) and its operations over the peak
    rate of their type (per sequence-step the bf16 multiply-adds of every matvec the
    kernel runs: the conditioning row, each layer's taps and current input, the
    residual/skip 1x1s but the last layer's residual, the fused 1x1s but layer 0's
    (none in the plain chain), the head's first 1x1; in f32 the head's last 1x1, S by
    out_channels, and the first conv: one row of R, which for the categorical head is
    the row of the class drawn)."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    L, R, G, S = hp.layers, hp.residual_channels, hp.gate_channels, hp.skip_out_channels
    k, cin, half = hp.kernel_size, hp.cin_channels, hp.gate_channels // 2
    macs_bf16 = (cin * L * G + L * k * R * G + (L - 1) * half * (R + S) + half * S + S * S
                 + ((L - 1) * half * G if hp.wavenet_fused_ar else 0))
    macs_f32 = S * hp.out_channels + R
    ops_s = 2 * B * T * (macs_bf16 / PEAK_BF16_FLOPS + macs_f32 / PEAK_F32_FLOPS)
    n_noise = int(np.prod(wavenet_ar.noise_shape(hp, B, T)))
    n_out = B * T * (1 + (hp.out_channels if return_params else 0))
    nbytes = (sum(w.numel() * w.element_size() for w in weights.values())
              + 4 * (B * T * cin + n_noise + n_out + (B * L * G if has_g else 0)))
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1000 * max(ops_s, bytes_s), 'operations' if ops_s >= bytes_s else 'bytes'


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


def run_chunked(run, weights, c_up, noise, hp, bounds, targets=None, g_cond=None):
    """`run` (generate_ar or generate_ar_reference) over c_up and noise in
    state-carried chunks ending at `bounds`, the last at T; `targets` teacher-forces.
    Returns the audio, the params and a copy of the state after chunk 1 (a state is
    consumed in place by the next chunk)."""
    outs, state, after1 = [], None, None
    for lo, hi in zip((0,) + tuple(bounds[:-1]), bounds):
        kw = dict(g_cond=g_cond) if targets is None \
            else dict(g_cond=g_cond, targets=targets[:, lo:hi])
        out = run(weights, c_up[:, lo:hi].contiguous(), noise[:, lo:hi].contiguous(), hp,
                  state_in=state, return_state=hi < bounds[-1], **kw)
        outs.append(out[:2])
        if hi < bounds[-1]:
            state = out[2]
            if after1 is None:
                after1 = _clone_state(state)
    return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1), after1


def kernel_vs_plain(weights, model, hp, B, frames, gen, bounds=None, n=3, tol=KERNEL_TOL,
                    plain_steps=None):
    """The kernel free-running with its params, the plain version on the same CUDA
    tensors teacher-forced on the kernel's audio, in one call or, with `bounds`, in
    state-carried chunks ending there (the last at T); both timed with CUDA events.
    With `plain_steps` the plain version follows the first plain_steps steps only (in
    the chunks of `bounds` that fit), and the kernel time returned is that of a second
    launch over those steps, which must repeat the start of the first bit for bit.
    Returns the readings, and the inputs and outputs for row0_carry."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    what = 'wavenet_ar MoL' if wavenet_ar.is_mol(hp) else 'wavenet_ar'
    c_up = _conditioning(model, hp, B, frames, gen)
    T = c_up.shape[1]
    if bounds is not None and bounds[-1] != T:
        fail(f'chunk ends {bounds} do not end at T={T}')
    noise = wavenet_ar.make_noise(hp, gen, B, T)
    (audio, params), kernel_ms = cuda_ms(
        lambda: wavenet_ar.generate_ar(weights, c_up, noise, hp))
    full_ms, steps = kernel_ms, T
    if plain_steps is not None:
        steps = plain_steps
        bounds = tuple(b for b in bounds if b < steps) + (steps,)
        (head, head_params), kernel_ms = cuda_ms(lambda: wavenet_ar.generate_ar(
            weights, c_up[:, :steps].contiguous(), noise[:, :steps].contiguous(), hp))
        if not (torch.equal(head, audio[:, :steps])
                and torch.equal(head_params, params[:, :steps])):
            fail(f'{what}: a launch over the first {steps} steps differs from the start '
                 f'of the launch over {T}')
    if bounds is None:
        (_, ref_params), plain_ms = cuda_ms(lambda: wavenet_ar.generate_ar_reference(
            weights, c_up, noise, hp, targets=audio))
        ref_after1, how = None, ''
    else:
        (_, ref_params, ref_after1), plain_ms = cuda_ms(lambda: run_chunked(
            wavenet_ar.generate_ar_reference, weights, c_up[:, :steps], noise[:, :steps],
            hp, bounds, targets=audio[:, :steps]))
        how = f' (plain version in chunks ending at {list(bounds)})'
    err = (params[:, :steps] - ref_params).abs().max().item()
    span = (ref_params.max() - ref_params.min()).item()
    phase(n, f'{what} B={B} T={T}{how}: max_abs_err={err:.3e} (tol {tol}, '
             f'params span {span:.3f}), kernel {1000 * full_ms / T:.1f} us/step, plain '
             f'{1000 * plain_ms / steps:.1f} us/step, audio in [{audio.min().item():.3f}, '
             f'{audio.max().item():.3f}]')
    if not (torch.isfinite(audio).all() and torch.isfinite(params).all()) \
            or audio.abs().max().item() > 1.0:
        fail(f'{what} audio is not finite or leaves [-1, 1]')
    if not err <= tol:
        fail(f'{what} params differ from the plain version by {err}')
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, steps=steps,
                full_ms=full_ms, c_up=c_up, noise=noise, audio=audio, params=params,
                ref_params=ref_params, ref_after1=ref_after1)


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


def state_faults(weights, c2, n2, hp, k_after1, r_after1, g_cond=None):
    """Chunk 2's first steps (c2, n2) on the kernel from two planted faults of its
    state after chunk 1 (t_base reset to 0; a fresh start, rings zeroed and h =
    first_b), each against the plain version from its own state after chunk 1,
    teacher-forced on the faulty audio: the params error of each. Where every ring's
    window divides t_base, a reset t_base indexes every ring as the true one does: that
    fault is no fault there, and its error is None."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    errs = {}
    if not any(k_after1[2] % win for _, win in wavenet_ar.ring_layout(hp)):
        errs['t_base reset to 0'] = None
    for fault, state in (('t_base reset to 0', (*_clone_state(k_after1)[:2], 0)),
                         ('chunk 2 started fresh', None)):
        if fault in errs:
            continue
        a, p = wavenet_ar.generate_ar(weights, c2, n2, hp, state_in=state, g_cond=g_cond)
        _, rp = wavenet_ar.generate_ar_reference(weights, c2, n2, hp, targets=a,
                                                 state_in=_clone_state(r_after1),
                                                 g_cond=g_cond)
        errs[fault] = (p - rp).abs().max().item()
    return errs


def _audio_ok(audio, hp):
    """Finite samples in [-1, 1], or class ids in [0, Q) for the categorical head."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    if wavenet_ar.is_categorical(hp):
        return bool(audio.min().item() >= 0 and audio.max().item() < hp.out_channels)
    return bool(torch.isfinite(audio).all() and audio.abs().max().item() <= 1.0)


def _judge_carry(n, what, r, bounds, tol=KERNEL_TOL):
    """Print and check one state-carry reading (see check_state_carry)."""
    T = bounds[-1]
    phase(n, f'{what}, chunks ending at {list(bounds)}: bit-identical to one call: '
             f'{r["bit_identical"]}; chunked params max_abs_err={r["max_abs_err"]:.3e}, '
             f'state after chunk 1 max_abs_err={r["state_err"]:.3e}, t_base {r["t_base"]} '
             f'(tol {tol}); planted state faults over {FAULT_STEPS} steps of chunk '
             f'2: ' + ', '.join(f'{f} {e:.3e}' if e is not None else
                                f'{f} not planted (every ring window divides t_base)'
                                for f, e in r['faults'].items())
             + f' (each must exceed tol); kernel {1000 * r["ms"] / T:.1f} us/step'
             + (f', plain {1000 * r["plain_ms"] / T:.1f} us/step' if r['plain_ms'] else ''))
    if not r['bit_identical']:
        fail(f'{what}: chunked kernel output differs from one call')
    if not (r['max_abs_err'] <= tol and r['state_err'] <= tol) \
            or r['t_base'] != (bounds[0], bounds[0]):
        fail(f'{what}: the streamed kernel differs from the plain version')
    if not r['audio_ok']:
        fail(f'{what}: streamed kernel audio is not finite or leaves its range')
    missed = [f for f, e in r['faults'].items() if e is not None and not e > tol]
    if missed:
        fail(f'{what}: the state carry check passes planted faults: {missed}')


def state_carry(weights, c_up, noise, hp, bounds, g_cond=None):
    """The kernel in state-carried chunks ending at `bounds` against one fresh kernel
    call and against the plain version run in the same chunks, teacher-forced on the
    kernel's audio; then the two planted state faults over the first FAULT_STEPS steps
    of chunk 2. Returns the readings that _judge_carry checks."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    T = bounds[-1]
    c_up, noise = c_up[:, :T].contiguous(), noise[:, :T].contiguous()
    full, _ = wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False,
                                     g_cond=g_cond)
    (audio, params, k_after1), kernel_ms = cuda_ms(lambda: run_chunked(
        wavenet_ar.generate_ar, weights, c_up, noise, hp, bounds, g_cond=g_cond))
    (_, ref_params, r_after1), plain_ms = cuda_ms(lambda: run_chunked(
        wavenet_ar.generate_ar_reference, weights, c_up, noise, hp, bounds,
        targets=audio, g_cond=g_cond))
    lo, hi = bounds[0], min(bounds[0] + FAULT_STEPS, bounds[1])
    return dict(bit_identical=torch.equal(audio, full),
                max_abs_err=(params - ref_params).abs().max().item(),
                state_err=_state_err(k_after1, r_after1), t_base=(k_after1[2], r_after1[2]),
                faults=state_faults(weights, c_up[:, lo:hi].contiguous(),
                                    noise[:, lo:hi].contiguous(), hp, k_after1, r_after1,
                                    g_cond),
                ms=kernel_ms, plain_ms=plain_ms, audio=audio, audio_ok=_audio_ok(audio, hp),
                params=params, ref_params=ref_params, noise=noise)


def row0_carry(weights, hp, served, bounds):
    """The service's shape: the kernel at B=1 in state-carried chunks ending at
    `bounds` over sequence 0 of `served`, a kernel_vs_plain run whose plain version ran
    in those chunks; against that run's row 0 (audio and params bit-identical) and its
    plain version as far as that went, then the two planted state faults on chunk 2.
    Returns the readings that _judge_carry checks."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    c_up, noise = served['c_up'][:1].contiguous(), served['noise'][:1].contiguous()
    r_after1 = tuple(x[:1].contiguous() for x in served['ref_after1'][:2]) \
        + (served['ref_after1'][2],)
    (audio, params, k_after1), kernel_ms = cuda_ms(lambda: run_chunked(
        wavenet_ar.generate_ar, weights, c_up, noise, hp, bounds))
    lo, hi = bounds[0], bounds[0] + FAULT_STEPS
    return dict(
        bit_identical=torch.equal(audio, served['audio'][:1])
        and torch.equal(params, served['params'][:1]),
        max_abs_err=(params[:, :served['steps']]
                     - served['ref_params'][:1]).abs().max().item(),
        state_err=_state_err(k_after1, r_after1), t_base=(k_after1[2], r_after1[2]),
        faults=state_faults(weights, c_up[:, lo:hi].contiguous(),
                            noise[:, lo:hi].contiguous(), hp, k_after1, r_after1),
        ms=kernel_ms, plain_ms=None, audio=audio, audio_ok=_audio_ok(audio, hp))


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

    service_shape = row0_carry(weights, hp, served, SERVE_BOUNDS)
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


def main_path(hp_overrides, hp, wavenet_state, n=5, paper=False):
    """Phase 5 (and 8 with `paper`): `python -m tacotron2_tpu_torch.synthesize` on two
    sentences of sentences.txt with a stop-suppressed Tacotron and `wavenet_state`;
    every wav hp.max_iters * r * hop samples, finite, and the AR kernel launched.
    Returns the launches and the AR kernel's us/step (CUDA events)."""
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
        with ar_timer() as chunks:
            wavenet_ar.LAUNCHES = 0
            stats = synthesize.main((['--paper_profile'] if paper else [])
                                    + ['--tacotron_checkpoint', taco_path,
                                       '--wavenet_checkpoint', wave_path,
                                       '--hparams', hp_overrides, '--text_list', text_list,
                                       '--output_dir', os.path.join(tmp, 'out'),
                                       '--device', 'cuda'])
            launches = wavenet_ar.LAUNCHES
        n_rows = len(open(os.path.join(tmp, 'out', 'map.txt'), encoding='utf-8')
                     .read().splitlines())
    want_len = hp.max_iters * hp.outputs_per_step * hp.get_hop_size()
    lens = [len(w) for w in stats['wavs']]
    us_step = 1000 * sum(ms for _, ms in chunks) / sum(steps for steps, _ in chunks)
    what = 'synthesize --paper_profile' if paper else 'main path'
    phase(n, f'{what}: {len(lens)} wavs of {lens} samples, AR kernel launches={launches} '
             f'at {us_step:.1f} us/step; '
             f'{stats["decoded_frames"] / stats["tacotron_seconds"]:.1f} mel frames/s, '
             f'{stats["ar_samples"] / stats["wavenet_seconds"]:.0f} AR samples/s, '
             f'wall RTF {stats["seconds"] / stats["audio_seconds"]:.3f} '
             f'({stats["seconds"]:.2f} s for {stats["audio_seconds"]:.2f} s of audio)')
    if n_rows != len(sentences) or lens != [want_len] * len(sentences):
        fail(f'expected {len(sentences)} wavs of {want_len} samples, got {lens}')
    if not all(bool(torch.isfinite(torch.from_numpy(w)).all()) for w in stats['wavs']):
        fail('non-finite samples in the synthesized audio')
    if launches <= 0:
        fail(f'{what} never launched the AR kernel')
    return launches, us_step


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

    with tempfile.TemporaryDirectory(prefix='t2torch_serve_') as tmp:
        torch.manual_seed(5)
        taco_path = os.path.join(tmp, 'tacotron.pt')
        wave_path = os.path.join(tmp, 'wavenet.pt')
        convert.save_checkpoint(taco_path, 'tacotron',
                                suppress_stop_tokens(Tacotron(hp).state_dict()))
        convert.save_checkpoint(wave_path, 'wavenet', wavenet_state)
        # (steps, kernel ms) of every AR launch the service makes, in order
        with ar_timer() as chunks:
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


def _mixtures(params, noise, nr):
    """The mixture each step draws from: the largest logit + Gumbel (first on ties)."""
    return (params[..., :nr] + noise[..., 1:1 + nr]).argmax(-1)


def quiet_mol_head(model, hp):
    """Scale the MoL head's means by MOL_MEAN_SCALE and shift its log-scales by
    MOL_LOG_SCALE_SHIFT in place, so that few samples clip at +-1 and a wrong mean or
    scale in the kernel's draw shows in the samples. Returns `model`."""
    nr = hp.out_channels // 3
    head = model.skip_conv2
    with torch.no_grad():
        head.weight[nr:2 * nr] *= MOL_MEAN_SCALE
        head.bias[nr:2 * nr] *= MOL_MEAN_SCALE
        head.bias[2 * nr:] += MOL_LOG_SCALE_SHIFT
    return model


def mol_vs_plain(weights, model, hp, gen):
    """Phase 8: the MoL kernel against its plain version (kernel_vs_plain) at the
    paper batch path's shape, B=2 over PAPER_MAX_ITERS frames, the plain version in
    the paper service's chunks (PAPER_SERVE_BOUNDS); then the kernel's samples against
    the MoL draw from its own params (SAMPLE_TOL), the share of them clipped at +-1
    (at most MAX_CLIPPED), and the steps whose mixture differs from the plain
    version's on the same history."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    nr = hp.out_channels // 3
    frames = PAPER_MAX_ITERS * hp.outputs_per_step
    mol = kernel_vs_plain(weights, model, hp, MAIN_BATCH, frames, gen, PAPER_SERVE_BOUNDS,
                          n=8, tol=MOL_KERNEL_TOL)
    audio, params, noise = mol['audio'], mol['params'], mol['noise']
    draw_err = (audio - wavenet_ar.mol_sample(params, noise, hp)).abs().max().item()
    switched = int((_mixtures(params, noise, nr)
                    != _mixtures(mol['ref_params'], noise, nr)).sum())
    clipped = (audio.abs() >= 1).float().mean().item()
    phase(8, f'MoL samples vs the draw from the kernel\'s params {draw_err:.3e} (tol '
             f'{SAMPLE_TOL}); {clipped:.4f} of them clipped (at most {MAX_CLIPPED}), audio '
             f'std {audio.std().item():.3f}; mixtures chosen differently from the plain '
             f'version on the same history: {switched} of {audio.numel()} steps')
    if not draw_err <= SAMPLE_TOL:
        fail(f'the MoL kernel\'s samples are not its draw: {draw_err}')
    if not clipped <= MAX_CLIPPED:
        fail(f'{clipped} of the MoL samples clip: the check cannot see the draw')
    return mol


def mol_planted_faults(hp):
    """Kernel inputs as a MoL kernel with one bug would use them: fault -> (plant,
    low) where plant(weights, noise, hp) gives the kernel's weights, noise and hp, and
    `low` asks for weights whose log-scales are lowered by 9, below
    log_scale_min_gauss (-7.0), where it and log_scale_min (-32.2) floor differently."""
    nr = hp.out_channels // 3

    def gumbel_as_logistic(w, noise, hp):
        noise = noise.clone()
        noise[..., 0] = noise[..., 1]
        return w, noise, hp

    def means_from_logits(w, noise, hp):
        s2, b2 = w['w_s2'].clone(), w['b_s2'].clone()
        s2[:, nr:2 * nr], b2[nr:2 * nr] = s2[:, :nr], b2[:nr]
        return {**w, 'w_s2': s2, 'b_s2': b2}, noise, hp

    return {'logistic noise from a Gumbel column': (gumbel_as_logistic, False),
            'means read from the logit slice': (means_from_logits, False),
            'log_scale_min_gauss as the floor': (
                lambda w, n, hp: (w, n, hp.replace(log_scale_min=hp.log_scale_min_gauss)),
                True),
            'legacy skip scaling on': (lambda w, n, hp: (w, n, hp.replace(legacy=True)),
                                       False)}


def mol_fault_errors(weights, c_up, noise, hp):
    """(params, samples) max abs error of the kernel against the plain version for
    each planted MoL fault and for none: the params against the plain version's on
    the true inputs, teacher-forced on the kernel's audio; the samples against the
    MoL draw from the kernel's own params and the true noise. 'none' runs on the low
    log-scale weights of mol_planted_faults, which the floor fault needs too."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    nr = hp.out_channels // 3
    b2 = weights['b_s2'].clone()
    b2[2 * nr:] -= 9.0
    low = {**weights, 'b_s2': b2}
    errs = {}
    plants = {MOL_NO_FAULT: (lambda w, n, hp: (w, n, hp), True),
              **mol_planted_faults(hp)}
    for fault, (plant, use_low) in plants.items():
        w = low if use_low else weights
        kw, kn, khp = plant(w, noise, hp)
        audio, params = wavenet_ar.generate_ar(kw, c_up, kn, khp)
        _, ref = wavenet_ar.generate_ar_reference(w, c_up, noise, hp, targets=audio)
        errs[fault] = ((params - ref).abs().max().item(),
                       (audio - wavenet_ar.mol_sample(params, noise, hp)).abs().max().item())
    return errs


def check_mol_faults(weights, model, hp, gen):
    """Phase 8: each planted MoL fault must take the kernel's params beyond
    MOL_KERNEL_TOL or its samples beyond SAMPLE_TOL (mol_fault_errors); the true
    kernel on the low log-scale weights passes both."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    c_up = _conditioning(model, hp, MAIN_BATCH, 1, gen)
    noise = wavenet_ar.make_noise(hp, gen, MAIN_BATCH, c_up.shape[1])
    errs = mol_fault_errors(weights, c_up, noise, hp)
    phase(8, f'planted MoL faults, B={MAIN_BATCH} T={c_up.shape[1]}: (params, samples) '
             'max_abs_err ' + ', '.join(f'{f} ({p:.3e}, {d:.3e})' for f, (p, d) in errs.items())
             + f' (each fault must exceed tol {MOL_KERNEL_TOL} or {SAMPLE_TOL})')
    clean = errs.pop(MOL_NO_FAULT)
    if not (clean[0] <= MOL_KERNEL_TOL and clean[1] <= SAMPLE_TOL):
        fail(f'the MoL kernel differs from the plain version at low log-scales: {clean}')
    missed = [f for f, (p, d) in errs.items() if not (p > MOL_KERNEL_TOL or d > SAMPLE_TOL)]
    if missed:
        fail(f'the MoL kernel check passes planted faults: {missed}')


def paper_service(hp_overrides, hp, wavenet_state):
    """Phase 8: one request through `serve.build_server --paper_profile` (with its
    warmup stream): f32 bytes of one stream, finite, in two AR launches."""
    from tacotron2_tpu_torch import convert, serve
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.utils import suppress_stop_tokens

    n = hp.max_iters * hp.outputs_per_step * hp.get_hop_size()
    with tempfile.TemporaryDirectory(prefix='t2torch_paper_serve_') as tmp:
        torch.manual_seed(6)
        taco_path = os.path.join(tmp, 'tacotron.pt')
        wave_path = os.path.join(tmp, 'wavenet.pt')
        convert.save_checkpoint(taco_path, 'tacotron',
                                suppress_stop_tokens(Tacotron(hp).state_dict()))
        convert.save_checkpoint(wave_path, 'wavenet', wavenet_state)
        with ar_timer() as chunks:
            t0 = time.perf_counter()
            server = serve.build_server(['--paper_profile', '--taco_checkpoint', taco_path,
                                         '--wave_checkpoint', wave_path, '--device', 'cuda',
                                         '--port', '0', '--hparams', hp_overrides])
            startup = time.perf_counter() - t0
            chunks.clear()
            wavenet_ar.LAUNCHES = 0
            server.start()
            try:
                status, data, first, wall = fetch(
                    server.address, 'GET', '/tts?text=The+paper+profile,+served.&format=f32')
            finally:
                server.close()
            launches = wavenet_ar.LAUNCHES
    audio_s = n / hp.sample_rate
    us_step = 1000 * sum(ms for _, ms in chunks) / sum(steps for steps, _ in chunks)
    phase(8, f'serve --paper_profile: up in {startup:.1f} s (load + 1 warmup stream); one '
             f'request: status {status}, {len(data)} bytes (want {4 * n}), first audio '
             f'{first:.3f} s, wall {wall:.3f} s for {audio_s:.3f} s of audio (stream RTF '
             f'{wall / audio_s:.2f}); {launches} AR launches: ' + ', '.join(
                 f'{steps} steps at {1000 * ms / steps:.1f} us/step' for steps, ms in chunks))
    if status != 200 or len(data) != 4 * n:
        fail('the --paper_profile service request failed or returned the wrong bytes')
    if not np.isfinite(np.frombuffer(data, np.float32)).all():
        fail('non-finite samples from the --paper_profile service')
    want = [PAPER_SERVE_BOUNDS[0], n - PAPER_SERVE_BOUNDS[0]]
    if launches != 2 or [steps for steps, _ in chunks] != want:
        fail(f'expected 2 AR launches of {want} steps, got {launches}: '
             f'{[steps for steps, _ in chunks]}')
    return launches, us_step


def paper_profile(gen):
    """Phase 8: the paper profile at full width (see the module docstring)."""
    from tacotron2_tpu_torch.config import paper_hparams
    from tacotron2_tpu_torch.models.wavenet.model import WaveNet
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.utils import randomize_weights

    overrides = f'max_iters={PAPER_MAX_ITERS},tacotron_synthesis_batch_size={MAIN_BATCH}'
    hp = paper_hparams()
    hp.parse(overrides)
    wavenet = quiet_mol_head(randomize_weights(WaveNet(hp), torch.Generator().manual_seed(1)),
                             hp)
    wavenet_state = {k: v.clone() for k, v in wavenet.state_dict().items()}
    model = wavenet.cuda().eval()
    weights = wavenet_ar.pack_params(model, hp)
    check_mol_faults(weights, model, hp, gen)
    mol = mol_vs_plain(weights, model, hp, gen)
    launches0 = wavenet_ar.LAUNCHES
    served_carry = row0_carry(weights, hp, mol, PAPER_SERVE_BOUNDS)
    _judge_carry(8, 'MoL state carry at the service\'s shape, B=1 (sequence 0 of the B=2 '
                    'run)', served_carry, PAPER_SERVE_BOUNDS, tol=MOL_KERNEL_TOL)
    odd = state_carry(weights, mol['c_up'][:1], mol['noise'][:1], hp, PAPER_STATE_BOUNDS)
    _judge_carry(8, 'MoL state carry, B=1', odd, PAPER_STATE_BOUNDS, tol=MOL_KERNEL_TOL)
    carry_launches = wavenet_ar.LAUNCHES - launches0
    batch, batch_us = main_path(overrides, hp, wavenet_state, n=8, paper=True)
    served, served_us = paper_service(f'max_iters={PAPER_MAX_ITERS}', hp, wavenet_state)
    bound_ms, bound_by = ar_bound(hp, weights, MAIN_BATCH, PAPER_SERVE_BOUNDS[-1])
    return dict(max_abs_err=max(mol['max_abs_err'], served_carry['max_abs_err'],
                                odd['max_abs_err']),
                ms=mol['ms'], plain_ms=mol['plain_ms'], bound_ms=bound_ms, bound_by=bound_by,
                batch_launches=batch, serve_launches=served, carry_launches=carry_launches,
                batch_us_step=batch_us, serve_us_step=served_us, streamed_b1_ms=served_carry['ms'])

def mutated_source(fault):
    """The text of csrc/wavenet_ar.cu with the one change of KERNEL_MUTANTS[fault]."""
    from tacotron2_tpu_torch.ops import _build

    old, new = KERNEL_MUTANTS[fault]
    with open(os.path.join(_build.CSRC_DIR, 'wavenet_ar.cu'), encoding='utf-8') as f:
        text = f.read()
    if text.count(old) != 1:
        raise ValueError(f'the line that {fault!r} changes stands {text.count(old)} times '
                         'in csrc/wavenet_ar.cu: bring KERNEL_MUTANTS up to date')
    return text.replace(old, new)


def build_kernels(tmp):
    """Phase 2: nvcc builds the port's library and, beside it, one library for each of
    KERNEL_MUTANTS from a changed copy of the source under `tmp`, all at once. Returns
    fault -> its loaded library."""
    from tacotron2_tpu_torch.ops import _build

    def mutant(item):
        i, fault = item
        src = os.path.join(tmp, f'mutant{i}', 'wavenet_ar.cu')
        os.makedirs(os.path.dirname(src))
        with open(src, 'w', encoding='utf-8') as f:
            f.write(mutated_source(fault))
        lib = os.path.join(tmp, f'mutant{i}', 'libmutant.so')
        _build.compile_library([src], lib)
        return fault, ctypes.CDLL(lib)

    with concurrent.futures.ThreadPoolExecutor(1 + len(KERNEL_MUTANTS)) as pool:
        main_build = pool.submit(_build.load_library)
        mutants = dict(pool.map(mutant, enumerate(KERNEL_MUTANTS)))
        main_build.result()
    return mutants


@contextlib.contextmanager
def kernel_library(library):
    """Launch the kernel of another build of its source (a mutant) inside the block;
    None leaves the port's own."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    kernel_fn = wavenet_ar._kernel_fn
    if library is not None:
        wavenet_ar._kernel_fn = lambda: kernel_fn(library)
    try:
        yield
    finally:
        wavenet_ar._kernel_fn = kernel_fn


def params_err(weights, c_up, noise, hp, g_cond=None, plant=None, library=None):
    """Max abs params error, a sequence, of the kernel (of `library`, on the inputs
    `plant` makes of the true ones: a dict of generate_ar's weights / g_cond / state_in)
    against the plain version on the true inputs, teacher-forced on the kernel's
    audio: (B,)."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    kw = dict(weights=weights, g_cond=g_cond, state_in=None)
    kw.update(plant or {})
    with kernel_library(library):
        audio, params = wavenet_ar.generate_ar(kw['weights'], c_up, noise, hp,
                                               state_in=kw['state_in'], g_cond=kw['g_cond'])
    _, ref = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, targets=audio,
                                              g_cond=g_cond)
    return (params - ref).abs().flatten(1).max(1).values


def first_steps_err(weights, c_up, noise, hp, g_cond=None, plant=None, library=None):
    """The first-steps reading (see FIRST_STEPS_TOL): the lower quartile over the
    sequences of params_err over the first FIRST_STEPS steps of a fresh call."""
    err = params_err(weights, c_up[:, :FIRST_STEPS].contiguous(),
                     noise[:, :FIRST_STEPS].contiguous(), hp, g_cond, plant, library)
    return torch.quantile(err, 0.25).item()


def vocoder_model(extra, seed=1):
    """(hp, WaveNet on the card, packed weights, state_dict on the CPU) of the default
    WaveNet with the hparams `extra` on top and seeded random weights of order 1."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.models.wavenet.model import WaveNet
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.utils import randomize_weights

    hp = default_hparams()
    hp.parse(extra)
    wavenet = randomize_weights(WaveNet(hp), torch.Generator().manual_seed(seed))
    state = {k: v.clone() for k, v in wavenet.state_dict().items()}
    model = wavenet.cuda().eval()
    return hp, model, wavenet_ar.pack_params(model, hp), state


def speaker_rows(model, hp, speakers):
    """g_cond (B, L*G) of the speaker ids `speakers`."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    g = torch.tensor(speakers, dtype=torch.long, device='cuda')
    return wavenet_ar.pack_global(model, hp, model.embed_global(g))


def variant_vs_plain(hp, weights, c_up, noise, g_cond, bounds, what=''):
    """Phase 9: one instantiation against its plain version as phase 6 holds the main
    one (state_carry in chunks ending at `bounds`, with its two planted state faults),
    and its samples against the draw from its own params: class ids exactly, floats
    within SAMPLE_TOL. Returns state_carry's readings."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    what = f'{wavenet_ar.variant(hp, g_cond is not None)}, B={c_up.shape[0]}{what}'
    r = state_carry(weights, c_up, noise, hp, bounds, g_cond)
    _judge_carry(9, what, r, bounds)
    drawn = wavenet_ar.sample(r['params'], r['noise'], hp)
    span = (r['ref_params'].max() - r['ref_params'].min()).item()
    if wavenet_ar.is_categorical(hp):
        wrong = int((drawn != r['audio']).sum())
        other = int((wavenet_ar.sample(r['ref_params'], r['noise'], hp) != r['audio']).sum())
        phase(9, f'{what}: params span {span:.3f}; class ids that are not the first arg-max '
                 f'of the kernel\'s params + noise: {wrong} of {drawn.numel()} (must be 0); '
                 f'{r["audio"].unique().numel()} distinct ids; the plain version draws '
                 f'another id at {other} steps on the same history')
        if wrong:
            fail(f'{what}: the kernel\'s class ids are not the arg-max of its own scores')
    else:
        draw_err = (drawn - r['audio']).abs().max().item()
        phase(9, f'{what}: params span {span:.3f}; samples vs the draw from the kernel\'s '
                 f'params {draw_err:.3e} (tol {SAMPLE_TOL})')
        if not draw_err <= SAMPLE_TOL:
            fail(f'{what}: the kernel\'s samples are not its draw: {draw_err}')
    return r


def vocoder_faults(models, mutants, gen):
    """Phase 9: the seven planted faults, each with the check that must see it miss,
    and that check's reading on the true kernel. `models`: name -> vocoder_model."""
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.ops.wavenet_ar import SQRT_HALF

    def inputs(name, B, frames=1):
        hp, model, weights, _ = models[name]
        c_up = _conditioning(model, hp, B, frames, gen)
        return hp, model, weights, c_up, wavenet_ar.make_noise(hp, gen, B, c_up.shape[1])

    readings = {}  # fault -> (reading, bound, the true kernel's reading)

    # global conditioning, B=2 over one frame: KERNEL_TOL on the params
    hp, model, weights, c_up, noise = inputs('speakers', MAIN_BATCH)
    g_cond = speaker_rows(model, hp, [1, 3])
    true = params_err(weights, c_up, noise, hp, g_cond).max().item()
    for fault, g in (('g_cond dropped', None),
                     ('g_cond of the other speaker', g_cond.flip(0).contiguous())):
        readings[fault] = (params_err(weights, c_up, noise, hp, g_cond,
                                      plant=dict(g_cond=g)).max().item(), KERNEL_TOL, true)
    # ... and the order of the bias and the rounding: the first steps at B=16
    NB = FIRST_STEPS_BATCH
    hp, model, weights, c_up, noise = inputs('speakers', NB)
    g_cond = speaker_rows(model, hp, [i % hp.n_speakers for i in range(NB)])
    fault = 'g_cond added after the bf16 rounding'
    readings[fault] = (first_steps_err(weights, c_up, noise, hp, g_cond,
                                       library=mutants[fault]),
                       FIRST_STEPS_TOL, first_steps_err(weights, c_up, noise, hp, g_cond))

    # the categorical head's start row and feedback row: the first steps at B=16
    hp, model, weights, c_up, noise = inputs('categorical', NB)
    true = first_steps_err(weights, c_up, noise, hp)
    start = (torch.zeros(NB, wavenet_ar.ring_floats(hp), device='cuda'),
             (weights['first_w'][0] + weights['first_b']).expand(NB, -1).contiguous(), 0)
    readings['start from class 0, not Q//2'] = (
        first_steps_err(weights, c_up, noise, hp, plant=dict(state_in=start)),
        FIRST_STEPS_TOL, true)
    fault = 'feedback from the f32 first_w row'
    readings[fault] = (first_steps_err(weights, c_up, noise, hp, library=mutants[fault]),
                       FIRST_STEPS_TOL, true)

    # the plain chain: its ring over one frame at B=2; the first skip, which the legacy
    # scaling of the 19 later layers shrinks to 1.4e-3 of itself, over the first steps
    hp, model, weights, c_up, noise = inputs('plain', MAIN_BATCH)
    fault = 'plain chain ring written with the layer\'s output'
    readings[fault] = (params_err(weights, c_up, noise, hp, library=mutants[fault]).max().item(),
                       KERNEL_TOL, params_err(weights, c_up, noise, hp).max().item())
    hp, model, weights, c_up, noise = inputs('plain', NB)
    R = hp.residual_channels
    w_os, b_os = weights['w_os'].clone(), weights['b_os'].clone()
    w_os[0, :, R:] *= SQRT_HALF
    b_os[0, R:] *= SQRT_HALF
    readings['first skip scaled'] = (
        first_steps_err(weights, c_up, noise, hp,
                        plant=dict(weights={**weights, 'w_os': w_os, 'b_os': b_os})),
        FIRST_STEPS_TOL, first_steps_err(weights, c_up, noise, hp))

    phase(9, 'planted faults (reading, its bound, the true kernel\'s reading): '
             + ', '.join(f'{f} ({e:.3e}, {tol}, {t:.3e})' for f, (e, tol, t) in readings.items())
             + '; each fault must exceed its bound and the true kernel stay within it')
    missed = [f for f, (e, tol, _) in readings.items() if not e > tol]
    wrong = [f for f, (_, tol, t) in readings.items() if not t <= tol]
    if missed:
        fail(f'the vocoder kernel checks pass planted faults: {missed}')
    if wrong:
        fail(f'the true kernel misses the bound of the checks for: {wrong}')
    return readings


def categorical_tie(hp, model, weights, gen):
    """Phase 9: two classes tied at every step (zero logit weights and equal biases for
    classes 3 and 7, equal noise far above the rest): the kernel emits the lower id and
    feeds back bf16(1/2) of each class's bf16 first-conv row, as the plain version."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    lo, hi = 3, 7
    w = dict(weights, w_s2=weights['w_s2'].clone(), b_s2=weights['b_s2'].clone())
    w['w_s2'][:, [lo, hi]] = 0.0
    w['b_s2'][[lo, hi]] = 0.3
    c_up = _conditioning(model, hp, MAIN_BATCH, 1, gen)
    noise = wavenet_ar.make_noise(hp, gen, MAIN_BATCH, c_up.shape[1])
    noise[..., [lo, hi]] = 50.0
    ids, params, state = wavenet_ar.generate_ar(w, c_up, noise, hp, return_state=True)
    _, ref_params, ref_state = wavenet_ar.generate_ar_reference(w, c_up, noise, hp,
                                                                return_state=True)
    rows = w['first_w'][[lo, hi]].bfloat16().float()
    want_h = 0.5 * rows[0] + 0.5 * rows[1] + w['first_b']
    h_err = (state[1] - want_h).abs().max().item()
    err = (params - ref_params).abs().max().item()
    s_err = _state_err(state, ref_state)
    first_only = (state[1] - (rows[0] + w['first_b'])).abs().max().item()
    phase(9, f'forced tie of classes {lo} and {hi}, B={MAIN_BATCH} T={c_up.shape[1]}: ids all '
             f'{lo}: {bool((ids == lo).all())}; next-step h vs the mean of the two bf16 rows '
             f'{h_err:.3e} (tol 1e-6; the first row alone is {first_only:.3e} away); free-'
             f'running params vs the plain version {err:.3e}, state {s_err:.3e} (tol '
             f'{KERNEL_TOL})')
    if not (ids == lo).all() or not h_err <= 1e-6 or not first_only > 1e-3:
        fail('the categorical kernel does not average tied classes')
    if not (err <= KERNEL_TOL and s_err <= KERNEL_TOL):
        fail(f'the tied categorical kernel differs from the plain version by {err}, {s_err}')


def vocoder_cli(extra, hp, wavenet_state, speaker_id=None):
    """Phase 9: `python -m tacotron2_tpu_torch.synthesize --model WaveNet` over two seeded
    mels of VOCODER_FRAMES frames written as mel-*.npy with a map.txt. Checks the wavs on
    disk, the map.txt rows and the launches. Returns the run's stats with launches,
    us_step and, under 'ar_call', the AR launch's inputs (c_up, noise, g_cond) and
    audio."""
    from scipy.io import wavfile

    from tacotron2_tpu_torch import convert, synthesize
    from tacotron2_tpu_torch.ops import wavenet_ar

    rng = np.random.default_rng(9)
    n = VOCODER_FRAMES * hp.get_hop_size()
    with tempfile.TemporaryDirectory(prefix='t2torch_vocoder_') as tmp:
        wave_path = os.path.join(tmp, 'wavenet.pt')
        convert.save_checkpoint(wave_path, 'wavenet', wavenet_state)
        mels_dir = os.path.join(tmp, 'mels')
        os.makedirs(mels_dir)
        texts = ['the first mel', 'the second mel']
        with open(os.path.join(mels_dir, 'map.txt'), 'w', encoding='utf-8') as f:
            for i, text in enumerate(texts):
                mel = rng.uniform(-hp.max_abs_value, hp.max_abs_value,
                                  (VOCODER_FRAMES, hp.num_mels)).astype(np.float32)
                np.save(os.path.join(mels_dir, f'mel-{i}.npy'), mel)
                f.write(f'{text}|mel-{i}.npy\n')
        calls = []
        with ar_timer(calls) as chunks:
            wavenet_ar.LAUNCHES = 0
            wavenet_ar.LAUNCHES_BY_VARIANT.clear()
            stats = synthesize.main(
                ['--model', 'WaveNet', '--wavenet_checkpoint', wave_path, '--mels_dir',
                 mels_dir, '--base_dir', tmp, '--hparams', extra, '--device', 'cuda']
                + (['--speaker_id', speaker_id] if speaker_id else []))
            launches, by_variant = wavenet_ar.LAUNCHES, dict(wavenet_ar.LAUNCHES_BY_VARIANT)
        out = os.path.join(tmp, 'wavenet_output')
        with open(os.path.join(out, 'map.txt'), encoding='utf-8') as f:
            rows = [line.rstrip('\n').split('|') for line in f]
        want_rows = [[text, os.path.join(mels_dir, f'mel-{i}.npy'),
                      os.path.join(out, 'wavs', f'wav-{i}.wav')] for i, text in enumerate(texts)]
        on_disk = [wavfile.read(row[2])[1] for row in want_rows]
    us_step = 1000 * sum(ms for _, ms in chunks) / sum(steps for steps, _ in chunks)
    what = f'synthesize --model WaveNet ({extra}' \
        + (f', --speaker_id {speaker_id})' if speaker_id else ')')
    phase(9, f'{what}: {len(stats["wavs"])} wavs of {[len(w) for w in stats["wavs"]]} samples, '
             f'AR kernel launches {by_variant} at {us_step:.1f} us/step; '
             f'{stats["ar_samples"] / stats["seconds"]:.0f} AR samples/s of wall, wall RTF '
             f'{stats["seconds"] / stats["audio_seconds"]:.3f} ({stats["seconds"]:.2f} s for '
             f'{stats["audio_seconds"]:.2f} s of audio)')
    if rows != want_rows:
        fail(f'{what}: map.txt holds {rows}, expected {want_rows}')
    if [len(w) for w in stats['wavs']] != [n, n] or [len(w) for w in on_disk] != [n, n]:
        fail(f'{what}: expected two wavs of {n} samples')
    if not all(np.isfinite(w).all() and np.abs(w).max() <= 1.0 for w in stats['wavs']):
        fail(f'{what}: the audio is not finite or leaves [-1, 1]')
    has_g = speaker_id is not None and hp.gin_channels > 0
    if launches != 1 or by_variant != {wavenet_ar.variant(hp, has_g): 1}:
        fail(f'{what}: expected one launch of {wavenet_ar.variant(hp, has_g)}, got {by_variant}')
    if not _audio_ok(calls[0]['audio'], hp):
        fail(f'{what}: the AR launch\'s audio leaves its range')
    if has_g != (calls[0]['g_cond'] is not None):
        fail(f'{what}: --speaker_id and the launch\'s g_cond do not go together')
    return dict(stats, launches=launches, us_step=us_step, ar_call=calls[0])


def standalone_vocoder(mutants, gen):
    """Phase 9: the standalone vocoder and its kernel variants (see the module
    docstring). Returns the readings for the kernels line."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    models = {'plain': vocoder_model('wavenet_fused_ar=False'),
              'categorical': vocoder_model(CATEGORICAL),
              'categorical-plain': vocoder_model(CATEGORICAL + ',wavenet_fused_ar=False'),
              'speakers': vocoder_model(SPEAKERS)}
    launches0 = wavenet_ar.LAUNCHES
    runs = {}
    for name, B, speakers in (('plain', MAIN_BATCH, None), ('categorical', MAIN_BATCH, None),
                              ('speakers', WAVENET_BATCH,
                               [i % 5 for i in range(WAVENET_BATCH)])):
        hp, model, weights, _ = models[name]
        c_up = _conditioning(model, hp, B, -(-VOCODER_BOUNDS[-1] // hp.get_hop_size()), gen)
        noise = wavenet_ar.make_noise(hp, gen, B, c_up.shape[1])
        g_cond = speaker_rows(model, hp, speakers) if speakers is not None else None
        key = f'{wavenet_ar.variant(hp, speakers is not None)}, B={B}'
        runs[key] = variant_vs_plain(hp, weights, c_up, noise, g_cond, VOCODER_BOUNDS)
    faults = vocoder_faults(models, mutants, gen)
    hp, model, weights, _ = models['categorical']
    categorical_tie(hp, model, weights, gen)
    check_launches = wavenet_ar.LAUNCHES - launches0

    hp, model_g, weights_g, state = models['speakers']
    one_three = vocoder_cli(SPEAKERS, hp, state, '1,3')
    three_three = vocoder_cli(SPEAKERS, hp, state, '3,3')
    moved = np.abs(one_three['wavs'][0] - three_three['wavs'][0]).max()
    same = np.array_equal(one_three['wavs'][1], three_three['wavs'][1])
    phase(9, f'--speaker_id 1,3 against 3,3 on the same mels and noise: the first wav moves '
             f'by {moved:.3f}, the second is identical: {same}')
    if not moved > 1e-2 or not same:
        fail('--speaker_id does not reach the kernel sequence by sequence')
    quantized = CATEGORICAL + ',wavenet_fused_ar=False'
    hp_q, _, weights_q, state_q = models['categorical-plain']
    cat = vocoder_cli(quantized, hp_q, state_q)
    ids = cat['ar_call']['audio']
    phase(9, f'the mu-law-quantized run drew {ids.unique().numel()} distinct class ids in '
             f'[{ids.min().item()}, {ids.max().item()}]')

    # the two entry-point launches against the plain version, on the inputs they had
    launches1 = wavenet_ar.LAUNCHES
    g_cond = one_three['ar_call']['g_cond']
    if not torch.equal(g_cond, speaker_rows(model_g, hp, [1, 3])):
        fail('--speaker_id 1,3 did not give the launch the bias rows of speakers 1 and 3')
    for (hp_v, weights_v), run in (((hp, weights_g), one_three), ((hp_q, weights_q), cat)):
        call = run['ar_call']
        key = f'{wavenet_ar.variant(hp_v, call["g_cond"] is not None)}, B={MAIN_BATCH}'
        runs[key] = r = variant_vs_plain(hp_v, weights_v, call['c_up'], call['noise'],
                                         call['g_cond'], VOCODER_CLI_BOUNDS,
                                         ' on the entry point\'s inputs')
        if not torch.equal(r['audio'], call['audio']):
            fail(f'{key}: the check\'s launch does not repeat the entry point\'s audio')
    check_launches += wavenet_ar.LAUNCHES - launches1

    T = VOCODER_FRAMES * hp.get_hop_size()
    bounds = {'gaussian-fused+g': ar_bound(hp, weights_g, MAIN_BATCH, T, False, has_g=True),
              'categorical-plain': ar_bound(hp_q, weights_q, MAIN_BATCH, T, False)}
    phase(9, 'bounds of the two entry-point launches (B=2, 8,800 steps, no params): '
             + ', '.join(f'{v} {ms:.3f} ms by {by}' for v, (ms, by) in bounds.items()))
    return dict(
        max_abs_err={k: r['max_abs_err'] for k, r in runs.items()},
        state_err={k: r['state_err'] for k, r in runs.items()},
        steps={k: r['audio'].shape[1] for k, r in runs.items()},
        us_step={k: 1000 * r['ms'] / r['audio'].shape[1] for k, r in runs.items()},
        plain_us_step={k: 1000 * r['plain_ms'] / r['audio'].shape[1]
                       for k, r in runs.items()},
        faults={f: e for f, (e, _, _) in faults.items()},
        check_launches=check_launches,
        speakers_launches=one_three['launches'] + three_three['launches'],
        categorical_launches=cat['launches'],
        speakers_us_step=one_three['us_step'], categorical_us_step=cat['us_step'],
        bound_ms={v: ms for v, (ms, _) in bounds.items()},
        bound_by={v: by for v, (_, by) in bounds.items()})


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail('torch finds no CUDA device')
    from tacotron2_tpu_torch.config import default_hparams
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
    with tempfile.TemporaryDirectory(prefix='t2torch_mutants_') as tmp:
        mutants = build_kernels(tmp)
    phase(2, f'built and loaded the CUDA kernels, and {len(mutants)} copies with one planted '
             f'fault each, in {time.perf_counter() - t0:.1f} s')

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
    kernel = kernel_vs_plain(weights, model, hp, MAIN_BATCH, frames, gen, SERVE_BOUNDS,
                             plain_steps=PLAIN_STEPS)
    wide = kernel_vs_plain(weights, model, hp, WAVENET_BATCH, 10, gen)
    check_tacotron(hp)
    launches_batch, batch_us = main_path(overrides, hp, wavenet_state)
    streamed = check_state_carry(weights, model, hp, gen, kernel)
    launches_serve = service(f'max_iters={MAX_ITERS}', hp, wavenet_state)
    t8 = time.perf_counter()
    paper = paper_profile(gen)
    phase(8, f'phase 8 took {time.perf_counter() - t8:.1f} s; the whole run so far '
             f'{time.perf_counter() - t_start:.1f} s')
    t9 = time.perf_counter()
    vocoder = standalone_vocoder(mutants, gen)
    phase(9, f'phase 9 took {time.perf_counter() - t9:.1f} s; the whole run '
             f'{time.perf_counter() - t_start:.1f} s')
    bound_ms, bound_by = ar_bound(hp, weights, MAIN_BATCH, kernel['steps'])

    # launches: the main paths' runs, each counted from 0 (the batch CLI, phase 5, and
    # the service, phase 7, at the default profile; both again with --paper_profile,
    # phase 8; the standalone vocoder on a five-speaker and on a mu-law-quantized WaveNet,
    # phase 9); the checks' launches are listed apart. max_abs_err, ms, plain_ms and
    # bound_ms are the default profile's (the times and the bound those of B=2 over the
    # PLAIN_STEPS steps that the plain version followed, phase 3; full_ms the batch
    # path's whole launch of full_steps steps); the mol_ keys are the paper width's (the
    # times its B=2 run over 8,800 steps, phase 8); the vocoder_ keys are phase 9's, by
    # instantiation and batch (errors and us/step over vocoder_steps steps: the two that
    # the entry point launches at its own 8,800; the bounds are those of the two
    # entry-point launches).
    # No single PyTorch call computes the AR loop: library_ms is null.
    print(json.dumps({'kernels': [dict(
        name='wavenet_ar', route='cuda',
        source='tacotron2_tpu_torch/csrc/wavenet_ar.cu',
        replaces='tacotron2_tpu/ops/pallas/wavenet_ar.py:684',
        variants=['gaussian-fresh', 'gaussian-streamed', 'mol-fresh', 'mol-streamed',
                  'gaussian-plain', 'categorical-fused', 'categorical-plain',
                  'gaussian-fused+g'],
        launches=launches_batch + launches_serve + paper['batch_launches']
        + paper['serve_launches'] + vocoder['speakers_launches']
        + vocoder['categorical_launches'],
        launches_by_path={'synthesize': launches_batch, 'serve': launches_serve,
                          'synthesize --paper_profile': paper['batch_launches'],
                          'serve --paper_profile': paper['serve_launches'],
                          'synthesize --model WaveNet --speaker_id':
                              vocoder['speakers_launches'],
                          'synthesize --model WaveNet (mulaw-quantize, plain chain)':
                              vocoder['categorical_launches'],
                          'vocoder_checks': vocoder['check_launches'],
                          'state_carry_check': streamed['launches'],
                          'mol_state_carry_check': paper['carry_launches']},
        max_abs_err=max(kernel['max_abs_err'], wide['max_abs_err'],
                        streamed['max_abs_err']),
        ms=kernel['ms'], plain_ms=kernel['plain_ms'], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, steps=kernel['steps'], full_ms=kernel['full_ms'],
        full_steps=frames * hp.get_hop_size(),
        b20_ms=wide['ms'], b20_plain_ms=wide['plain_ms'],
        streamed_ms=streamed['ms'], streamed_plain_ms=streamed['plain_ms'],
        streamed_b1_ms=streamed['served_ms'], synthesize_us_step=batch_us,
        mol_max_abs_err=paper['max_abs_err'], mol_ms=paper['ms'],
        mol_plain_ms=paper['plain_ms'], mol_bound_ms=paper['bound_ms'],
        mol_bound_by=paper['bound_by'], mol_streamed_b1_ms=paper['streamed_b1_ms'],
        paper_synthesize_us_step=paper['batch_us_step'],
        paper_serve_us_step=paper['serve_us_step'],
        vocoder_max_abs_err=vocoder['max_abs_err'], vocoder_state_err=vocoder['state_err'],
        vocoder_steps=vocoder['steps'],
        vocoder_us_step=vocoder['us_step'], vocoder_plain_us_step=vocoder['plain_us_step'],
        vocoder_fault_readings=vocoder['faults'],
        vocoder_speakers_us_step=vocoder['speakers_us_step'],
        vocoder_categorical_us_step=vocoder['categorical_us_step'],
        vocoder_bound_ms=vocoder['bound_ms'], vocoder_bound_by=vocoder['bound_by'])]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
