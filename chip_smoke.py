#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive the main path.

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):
  1. torch, CUDA and the card (nvidia-smi name and power limit);
  2. build the hand-written kernels from tacotron2_tpu_torch/csrc (the probes' from
     csrc/probes into a library of their own), with the planted-fault copies;
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
     each miss the plain version by more than KERNEL_TOL; the kernel forced onto every
     cluster size (1, 2, 4, 8 and 16 CTAs a sequence) at B=2 over CLUSTER_STEPS steps,
     bit-identical across N in audio, params and carried state, within KERNEL_TOL of
     one run of the plain version, and within FIRST_STEPS_TOL over the first steps at
     B=16 at each N; three planted faults of the cluster layout (CLUSTER_MUTANTS: a
     CTA's slice of z shared at the next rank's offset, the rings written by rank 0
     alone, each of which must miss KERNEL_TOL on the cluster that B=2 gets; and, in
     the large batch's own instantiation, a cluster of one halving what it shares into
     its own shared memory, which must miss it on a cluster of one, FAULT_CLUSTER, and
     the second of two sequences on a cluster of two reading the first's taps, which
     must miss it there, FAULT_SEQUENCES); two sequences a cluster of two (P = 2, the
     large batch's layout) against one (P = 1) at B=132 and 131 over CLUSTER_STEPS
     steps, bit for bit in audio, params and carried state; and the kernel's us/step
     over SWEEP_BATCHES with the layout (N CTAs a cluster, P sequences a cluster) each
     batch gets, B=66, 98, 131 and 132 among them (phase 8 repeats the sweep at the
     paper width);
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
     path's shape (B=2, 8,800 steps; the plain version over all of them, in the paper
     service's chunks, PAPER_SERVE_BOUNDS), its samples against the
     draw from its own params, at most MAX_CLIPPED of them at +-1, with the mixtures
     chosen differently counted; the
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
     launches was given (B=2, 8,800 steps) then go to the kernel once more, whose audio
     must be the entry point's, bit for bit, over all 8,800 steps, and through the same
     check as above over the first 2,200 of them, in chunks ending at
     VOCODER_CLI_BOUNDS: bit-identical again, and the params within KERNEL_TOL of the
     plain version's.
 10. WaveNet training (`python -m tacotron2_tpu_torch.train --model WaveNet`) and the AR
     kernel's last two variants, which its natural eval launches: the big-vocab
     categorical head (1,025 to 65,536 classes: bf16 first conv and last head layer,
     Gumbel noise drawn inside the kernel by Philox4x32-10, or greedy; no params) and
     the in-kernel NLL of given class ids (`y_eval`, both categorical heads). At the
     full default width and Q = 65,536, fused chain, B=2 over 1,100 steps, greedy and
     sampled, each with y_eval: one launch against state-carried chunks ending at odd
     BIG_BOUNDS (ids and NLL bit-identical), and against the plain version in the same
     chunks, teacher-forced on the kernel's ids: the ids it draws (at most
     MAX_IDS_OFF of the steps may differ: near-ties of the two largest of 65,536
     scores), the NLL (NLL_TOL: there are no params, so the NLL is the check of the
     logits) and the carried state (KERNEL_TOL). Shorter runs for the plain chain, for
     g_cond and for Q = BIG_RAGGED_Q, which no power of two divides. The NLL flag on the
     small head (Q = 256) against log_softmax of the params a second launch returns on
     the same noise, and against `cross_entropy` on them, the one library call that
     computes the NLL alone. The in-kernel noise: with the logits forced flat the ids
     are uniform over the classes (chi-square over coarse and fine bins), differ between
     seeds and between sequences, and are the arg-max of `philox_gumbel`, whose values
     have the Gumbel mean and deviation. Seven planted faults, each of which its check
     must see miss (big_vocab_faults): four as builds of a changed copy of the kernel's
     source (BIG_VOCAB_MUTANTS), three through the kernel's inputs, among them a forced
     tie of two classes. Then the trainer at the default hparams (batch 8, crops of
     11,000 samples, a corpus made from a seed): 6 steps with an eval at 4 and a
     checkpoint at 6, the same again from the same seed, a rerun that restores and goes
     on to 8; losses, the eval's launch (gaussian-fused, with params), the sidecar's
     records, and the loss of step 7 against an in-process train_step from the
     checkpoint. Then the trainer on a Q = 65,536 model with weight normalization at the
     full model width, batch and crop cut (BIG_TRAIN) so that the (B, T, Q) logits
     fit: its eval launches categorical_big-fused with the NLL flag once. Each trainer's
     eval launch is then held against the plain version at its own shape and on the
     inputs it had (the EMA weights it packed, the loader's conditioning, its noise or
     seed, the batch's class ids as y_eval): a further launch must repeat its outputs
     bit for bit over all its steps (B=1 over 11,000 at the defaults, over 2,750 at
     Q = 65,536), and the plain version follows in state-carried chunks at odd ends,
     the Gaussian one over the first TRAIN_EVAL_BOUNDS[-1] steps, the big-vocab one
     over all of them.
 11. the probes, the counterparts of the JAX package's four measurement scripts
     (tacotron2_tpu_torch/probes/, kernels in csrc/probes/, built in phase 2 into a
     library of their own with one planted-fault copy each, PROBE_MUTANTS), each
     kernel against its plain version at full width on the same CUDA tensors: B12
     (prng_probe) at B=8, Q=65,536, ids exact and Gumbel stats within GUMBEL_STATS_TOL,
     the mean within GUMBEL_MEAN_TOL of 0.5772, on random scores at most one row off
     and only at a near-tie (TIE_GAP), a forced tie of two classes; B9 (ar_critpath)
     all six variants; B10 (matmul_probe) all seven, with the last step's whole product;
     B11 (microbench) all three, `lstm` from a seeded nonzero state, the accumulated
     alignments too, and beside each the plain version's step captured in a CUDA graph
     (the yardstick `graph_ms`); over PROBE_STEPS steps, relative to the plain version's
     largest value (PROBE_TOL); each planted fault must miss its check (B11 has two: the
     accumulation dropped, and a k-tile of its tensor-core product). No entry point runs a
     probe: their launches on the main paths are 0. The probes' full readings come from
     `python -m tacotron2_tpu_torch.probes.<name>`, not from this run.
Then a JSON line of the kernels (with each kernel's bound: the larger of its bytes over
the HBM rate and its operations over the peak rate of their type, for the run timed),
the card's nvidia-smi line, and the result line.
"""

import collections
import concurrent.futures
import contextlib
import ctypes
import http.client
import importlib.util
import io
import json
import os
import re
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
# how far the plain version follows phase 3's B=2 launch of 35,200 steps (32 of its 128
# mel frames: the first served chunk and 4,448 steps of the second, which wrap the
# largest ring, 1,024 slots, four times from the carried state): its 5 to 19 ms a step
# are host time, which doubles from one machine to another, and the whole length would
# take 3 to 11 minutes of the run. Phase 8's follows its launch's whole 8,800 steps
PLAIN_STEPS = 8800
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
# how far the plain version follows each of the entry point's launches of 8,800 steps
VOCODER_CLI_BOUNDS = VOCODER_BOUNDS[:2] + (VOCODER_FRAMES * 275 // 4,)
CATEGORICAL = "input_type='mulaw-quantize',quantize_channels=256,out_channels=256"
SPEAKERS = 'gin_channels=16,n_speakers=5'
VOCODER_SPEAKERS_PATH = 'synthesize --model WaveNet --speaker_id'
VOCODER_CATEGORICAL_PATH = 'synthesize --model WaveNet (mulaw-quantize, plain chain)'
# one-line changes of csrc/wavenet_ar.cu, each a fault that no input of the true kernel
# reproduces: name -> (the line as it stands, the line with the fault)
KERNEL_MUTANTS = {
    'g_cond added after the bf16 rounding': (
        '          if (a.g_cond != nullptr) v += a.g_cond[(size_t)b * LG + g];\n'
        '          v = a.round_cond ? bf16r(v) : v;\n',
        '          v = (a.round_cond ? bf16r(v) : v) + (a.g_cond != nullptr\n'
        '              ? a.g_cond[(size_t)b * LG + g] : 0.f);\n'),
    'feedback from the f32 first_w row': (
        '          acc = bf16r(a.first_w[(size_t)id * R + r]);\n',
        '          acc = a.first_w[(size_t)id * R + r];\n'),
    'plain chain ring written with the layer\'s output': (
        '        write_ring(ring + ring_off[li], h, (base[li] + t) % win[li], R, r0, RN);  '
        '// layer li\'s input\n',
        '        if (li > 0) write_ring(ring + ring_off[li - 1], h, (base[li - 1] + t) % '
        'win[li - 1], R, r0, RN);\n')}
# changes of csrc/wavenet_ar.cu for phase 10's faults (as KERNEL_MUTANTS)
BIG_VOCAB_MUTANTS = {
    'NLL from the noised scores': (
        '                lse_merge(lm, ls, lg[i], 1.f);\n'
        '                if (c == y) sample_s[3] = lg[i];\n',
        '                lse_merge(lm, ls, sc[i], 1.f);\n'
        '                if (c == y) sample_s[3] = sc[i];\n'),
    'log-sum-exp without the maximum taken out': (
        '  const float mm = fmaxf(m, m2);\n',
        '  const float mm = 0.f;\n'),
    'head input not rounded to bf16': (
        '      share<SMALL>(cluster, P, s0 + s, HEAD == CATEGORICAL_BIG ? bf16r(v) : v, N);\n',
        '      share<SMALL>(cluster, P, s0 + s, v, N);  // (left in f32)\n'),
    'classes past the last multiple of 1,024 left out': (
        '        if (g < ngrp) {  // the ragged last groups too\n',
        '        if (g < Q / 1024 * 128) {\n')}
ALL_MUTANTS = {**KERNEL_MUTANTS, **BIG_VOCAB_MUTANTS}
# changes of csrc/wavenet_ar.cu that only one cluster layout shows (phase 3): at the main
# path's B=2, where the cluster is 16 CTAs, a CTA's slice of z shared at the next rank's
# offset, and the rings written by rank 0 alone (its residual columns only); on a cluster
# of one (FAULT_CLUSTER), in the large batch's own instantiation (SMALL), what a CTA
# shares into its own shared memory halved; on a cluster of two that runs two sequences
# (FAULT_SEQUENCES), the second sequence's taps read from the first's ring
CLUSTER_MUTANTS = {
    'a peer\'s slice written at the wrong rank\'s offset': (
        '  share<SMALL>(cluster, zb, n0 + c, bf16r(tanhf(za) * (0.5f + 0.5f * tanhf(0.5f * zg))), '
        'N);\n',
        '  share<SMALL>(cluster, zb, (n0 + hN) % (hN * N) + c,\n'
        '               bf16r(tanhf(za) * (0.5f + 0.5f * tanhf(0.5f * zg))), N);\n'),
    'the ring slice written by rank 0 only': (
        '  for (int c = threadIdx.x; c < RN; c += nt()) ring[slot * R + r0 + c] = h[r0 + c];\n',
        '  for (int c = threadIdx.x; c < (r0 == 0 ? RN : 0); c += nt())\n'
        '    ring[slot * R + r0 + c] = h[r0 + c];\n'),
    'a cluster of one halves what it shares (N = 1)': (
        '      local[idx] = v;\n',
        '      local[idx] = 0.5f * v;\n'),
    'the second sequence reads the first\'s taps (P = 2)': (
        '      const float* src = ring + q * RF + ring_off[l] + ((base[l] + t + w - m) % w) * '
        'R;\n',
        '      const float* src = ring + 0 * RF + ring_off[l] + ((base[l] + t + w - m) % w) * '
        'R;\n')}
FAULT_CLUSTER = {'a cluster of one halves what it shares (N = 1)': 1,
                 'the second sequence reads the first\'s taps (P = 2)': 2}
FAULT_SEQUENCES = {'the second sequence reads the first\'s taps (P = 2)': 2}
# phase 10: the big-vocab head and the in-kernel NLL
BIG_VOCAB = "input_type='mulaw-quantize',quantize_channels=65536,out_channels=65536"
BIG_RAGGED_Q = 50001  # odd: the last group of 8 classes and the last 1,024 are ragged
BIG_BOUNDS = PAPER_STATE_BOUNDS        # odd chunk ends over 1,100 steps
BIG_SHORT_BOUNDS = (77, 150, 275)      # ... and over one frame, for the shorter runs
# kernel vs plain version in the NLL of seeded class ids, whose logits span about 1.5 and
# pass one more bf16 rounding (the head's input) than the small head's params: on an H100
# 1.2e-3 to 1.7e-3 over 200 to 400 steps; the faults that change it miss by 5e-2 and more
NLL_TOL = 1e-2
# share of the steps at which the plain version, on the kernel's history, may draw
# another id than the kernel: a near-tie of the two largest of 65,536 scores flips with
# a logit error of 1e-3. On an H100 no sampled id of 2,200 differs (the Gumbel noise
# spreads the two largest scores) and 15 greedy ones do, 0.7%: a frame's 275 steps share
# their conditioning, so a greedy run sits on a few classes (27 distinct ids) whose
# logits stay close
MAX_IDS_OFF = 0.03
# ... and on the inputs of the Q = 65,536 trainer's own eval launch, whose weights are
# not the seeded ones but weight-normalized, data-dependently initialized and four steps
# trained: every conv's output has unit variance there, the NLL of the batch's ids spans
# 5.9 to 6.2 over the 2,750 steps and the carried state 9.0, and kernel and plain version
# differ by more for each unit of that span: on an H100 3.1e-2, 3.7e-2 and 4.6e-2 in the
# NLL in three runs (4.9e-3 to 7.9e-3 a unit; two trainer runs differ in the last places
# of their weights) and 2.5e-2 in the state (2.8e-3 a unit). The bounds are a unit of
# span: 2.5x and 3.5x above these readings, and the NLL's below the 3.3e-2 a unit by which
# the smallest NLL fault misses on the seeded weights
EVAL_NLL_TOL_PER_SPAN = 2e-2
EVAL_STATE_TOL_PER_SPAN = KERNEL_TOL
SMALL_NLL_TOL = 1e-5  # the small head's NLL against log_softmax of the same logits
# the big-vocab trainer run: batch and crop cut from the defaults' 8 x 11,000 so that
# the (B, T, Q) logits fit (1.4 GB in f32; with their gradient, the log-softmax and the
# loss's temporaries several times that), the model's widths and depth as they are
BIG_TRAIN = 'wavenet_batch_size=2,max_time_steps=2750'
TRAIN_PATH = 'train --model WaveNet (natural eval)'
BIG_TRAIN_PATH = 'train --model WaveNet (Q=65536, natural eval)'
# the main paths of the kernels line's wavenet_ar entry, at the default width and at the
# paper width (its big-vocab entry's is BIG_TRAIN_PATH)
AR_PATHS = ('synthesize', 'serve', TRAIN_PATH, VOCODER_SPEAKERS_PATH, VOCODER_CATEGORICAL_PATH)
PAPER_PATHS = ('synthesize --paper_profile', 'serve --paper_profile')
TRAIN_UTTERANCES = 24  # 16 to train on and one test batch of 8
# how far the plain version follows the default trainer's eval launch of 11,000 steps
# (the kernel repeats all of them), in chunks at odd ends
TRAIN_EVAL_BOUNDS = VOCODER_CLI_BOUNDS
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


# the AR kernel's launches on each main path by layout, {path: {(N, P): launches}}, the
# counts set to 0 just before each run of a path (reset_counts) and read just after it
# (read_counts); the checks' launches are not in them
LAYOUTS_BY_PATH = collections.defaultdict(collections.Counter)


def reset_counts():
    """Sets the AR kernel's launch counts to 0, just before a run of a main path."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    wavenet_ar.LAUNCHES = 0
    wavenet_ar.LAUNCHES_BY_VARIANT.clear()
    wavenet_ar.LAUNCHES_BY_LAYOUT.clear()


def read_counts(path):
    """The AR launches since reset_counts, read just after a run of the main path
    `path`: adds them by layout to LAYOUTS_BY_PATH[path] (path None: a check's run,
    counted nowhere); returns their number."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    if path is not None:
        LAYOUTS_BY_PATH[path].update(wavenet_ar.LAUNCHES_BY_LAYOUT)
    return wavenet_ar.LAUNCHES


def cluster_counts(path):
    """{N: launches} of the main path `path`: its launches by layout, summed over P."""
    out = collections.Counter()
    for (n, _), c in LAYOUTS_BY_PATH[path].items():
        out[n] += c
    return dict(out)


def path_clusters(*paths):
    """The cluster sizes the runs of `paths` launched the AR kernel on, in order."""
    return sorted({n for p in paths for n, _ in LAYOUTS_BY_PATH[p]})


def layout_counts(path):
    """{'N,P': launches} of the main path `path` (JSON keys)."""
    return {f'{n},{p}': c for (n, p), c in sorted(LAYOUTS_BY_PATH[path].items())}


@contextlib.contextmanager
def ar_timer(calls=None):
    """Time every AR launch made inside the block with CUDA events: yields the list
    of (steps, kernel ms), one entry a launch, in order; each launch's inputs (a copy
    of the weights, hp, c_up, noise, g_cond, and under 'kw' every keyword it was given: seed, y_eval,
    return_params) and outputs (audio, and 'second': the params, the NLL or None) are
    appended as a dict to `calls` when that is a list."""
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
            # a copy of the weights: packed f32 ones may be the model's own tensors,
            # which a trainer goes on updating in place
            calls.append(dict(weights={k: w.clone() for k, w in weights.items()}, hp=hp,
                              c_up=c_up, noise=noise,
                              g_cond=kw.get('g_cond'), kw=kw, audio=out[0], second=out[1]))
        return out

    wavenet_ar.generate_ar = timed
    try:
        yield chunks
    finally:
        wavenet_ar.generate_ar = generate_ar


def ar_bound(hp, weights, B, T, return_params=True, has_g=False, nll=False, greedy=False):
    """(bound ms, 'operations' or 'bytes') of one fresh AR launch over B sequences of
    T steps: the larger of its bytes over the HBM rate (each input read once: c_up,
    noise ((B, T, Q) for the categorical head, none for the big-vocab one), the packed
    weights, g_cond with `has_g`, y_eval with `nll`; each output written once: audio,
    params, the NLL) and its operations over the peak
    rate of their type (per sequence-step the bf16 multiply-adds of every matvec the
    kernel runs: the conditioning row, each layer's taps and current input, the
    residual/skip 1x1s but the last layer's residual, the fused 1x1s but layer 0's
    (none in the plain chain), the head's first 1x1; in f32 the head's last 1x1, S by
    out_channels, and the first conv: one row of R, which for the categorical head is
    the row of the class drawn. The big-vocab head's last 1x1 is bf16, and unless
    `greedy` each of its Q classes takes a quarter of a Philox4x32-10 block and two
    logarithms, counted as 32 f32 operations; the NLL one exponential a class)."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    L, R, G, S = hp.layers, hp.residual_channels, hp.gate_channels, hp.skip_out_channels
    k, cin, half = hp.kernel_size, hp.cin_channels, hp.gate_channels // 2
    macs_bf16 = (cin * L * G + L * k * R * G + (L - 1) * half * (R + S) + half * S + S * S
                 + ((L - 1) * half * G if hp.wavenet_fused_ar else 0))
    macs_f32 = S * hp.out_channels + R
    other_f32 = 0
    if wavenet_ar.is_big_vocab(hp):
        macs_bf16, macs_f32 = macs_bf16 + S * hp.out_channels, R
        other_f32 = 0 if greedy else 32 * hp.out_channels
    other_f32 += hp.out_channels if nll else 0
    ops_s = B * T * (2 * macs_bf16 / PEAK_BF16_FLOPS
                     + (2 * macs_f32 + other_f32) / PEAK_F32_FLOPS)
    n_noise = 0 if wavenet_ar.is_big_vocab(hp) \
        else int(np.prod(wavenet_ar.noise_shape(hp, B, T)))
    n_out = B * T * (1 + (hp.out_channels if return_params else 0) + (1 if nll else 0))
    nbytes = (sum(w.numel() * w.element_size() for w in weights.values())
              + 4 * (B * T * cin + n_noise + n_out + (B * L * G if has_g else 0)
                     + (B * T if nll else 0)))
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


# phase 3's check of every cluster size: B=2 over this many steps (4 mel frames)
CLUSTER_STEPS = 1100
# the batch sweep of the AR kernel's time, with the cluster size each batch gets (phase 3
# at the default width, phase 8 at the paper width), over this many steps a launch
SWEEP_BATCHES = (1, 2, 8, 20, 66, 98, 131, 132)
# phase 3's check of two sequences a cluster against one: these batches (even, and odd:
# the last cluster runs one sequence) over CLUSTER_STEPS steps
PAIR_BATCHES = (132, 131)
SWEEP_STEPS = 1100


def occupancy(hp, B=MAIN_BATCH, nll=False):
    """(the occupancy table of the instantiation that runs `hp`, the N that B gets)."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    head = 3 if wavenet_ar.is_big_vocab(hp) else 2 if wavenet_ar.is_categorical(hp) \
        else 1 if wavenet_ar.is_mol(hp) else 0
    table = wavenet_ar.occupancy_table(
        (hp.cin_channels, hp.layers, hp.residual_channels, hp.gate_channels,
         hp.skip_out_channels, hp.kernel_size), head, bool(hp.wavenet_fused_ar), nll,
        torch.cuda.current_device())
    return table, wavenet_ar.cluster_size(B, table)


def cluster_sweep(weights, model, hp, gen):
    """Phase 3: the kernel forced onto every cluster size at the main path's B=2 over
    CLUSTER_STEPS steps: audio, params and carried state bit-identical across N, the
    params within KERNEL_TOL of one run of the plain version (teacher-forced on the
    N = 16 audio), and the first-steps reading (FIRST_STEPS_TOL) at each N."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    table, auto = occupancy(hp)
    missing = [n for n in wavenet_ar.CLUSTER_SIZES if table[n] == 0]
    if missing:
        fail(f'clusters of {missing} CTAs are not admitted at the default width: {table}')
    c_up = _conditioning(model, hp, MAIN_BATCH, CLUSTER_STEPS // hp.get_hop_size(), gen)
    noise = wavenet_ar.make_noise(hp, gen, MAIN_BATCH, c_up.shape[1])
    runs = {}
    for n in wavenet_ar.CLUSTER_SIZES:
        out, ms = cuda_ms(lambda: wavenet_ar.generate_ar(weights, c_up, noise, hp,
                                                         return_state=True, cluster=n))
        runs[n] = (*out, ms)
    audio, params, state, _ = runs[16]
    same = {n: torch.equal(a, audio) and torch.equal(p, params) and torch.equal(st[0], state[0])
            and torch.equal(st[1], state[1]) for n, (a, p, st, _) in runs.items()}
    (_, ref_params), plain_ms = cuda_ms(lambda: wavenet_ar.generate_ar_reference(
        weights, c_up, noise, hp, targets=audio))
    err = (params - ref_params).abs().max().item()
    NB = FIRST_STEPS_BATCH
    c16 = _conditioning(model, hp, NB, 1, gen)
    n16 = wavenet_ar.make_noise(hp, gen, NB, c16.shape[1])
    first = {n: first_steps_err(weights, c16, n16, hp, cluster=n)
             for n in wavenet_ar.CLUSTER_SIZES}
    T = c_up.shape[1]
    us = {n: 1000 * r[3] / T for n, r in runs.items()}
    phase(3, f'every cluster size, B={MAIN_BATCH} T={T} (clusters resident by size {table}; '
             f'B={MAIN_BATCH} gets {auto}): bit-identical to N=16 (audio, params, state): '
             f'{same}; params max_abs_err={err:.3e} against one plain run (tol {KERNEL_TOL}); '
             'first-steps reading at B=16 by N: '
             + ', '.join(f'{n}: {e:.3e}' for n, e in first.items())
             + f' (tol {FIRST_STEPS_TOL}); us/step by N: '
             + ', '.join(f'{n}: {u:.1f}' for n, u in us.items())
             + f'; plain {1000 * plain_ms / T:.1f} us/step')
    if not all(same.values()):
        fail(f'the kernel\'s outputs depend on the cluster size: {same}')
    if not err <= KERNEL_TOL:
        fail(f'the kernel differs from the plain version by {err}')
    wrong = [n for n, e in first.items() if not e <= FIRST_STEPS_TOL]
    if wrong:
        fail(f'the first-steps reading misses its bound at N = {wrong}: {first}')
    return dict(occupancy=table, max_abs_err=err, us_step_by_cluster=us,
                first_steps_by_cluster=first, steps=T, plain_ms=plain_ms)


def cluster_faults(weights, model, hp, gen, mutants):
    """Phase 3: the planted faults of the cluster layout (CLUSTER_MUTANTS), each a build
    of a changed copy of the kernel's source, at the main path's B=2 over one frame on the
    cluster that B=2 gets, or on the one FAULT_CLUSTER names (with FAULT_SEQUENCES
    sequences a cluster): each must miss KERNEL_TOL."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    _, auto = occupancy(hp)
    if auto == 1:
        fail('B=2 gets no cluster of more than one CTA: the cluster faults cannot show')
    c_up = _conditioning(model, hp, MAIN_BATCH, 1, gen)
    noise = wavenet_ar.make_noise(hp, gen, MAIN_BATCH, c_up.shape[1])
    layouts = sorted({(auto, 1)} | {(FAULT_CLUSTER[f], FAULT_SEQUENCES.get(f, 1))
                                    for f in FAULT_CLUSTER})
    true = {f'{n},{p}': params_err(weights, c_up, noise, hp, cluster=n,
                                   sequences=p).max().item() for n, p in layouts}
    seen = {f: params_err(weights, c_up, noise, hp, library=mutants[f],
                          cluster=FAULT_CLUSTER.get(f, auto),
                          sequences=FAULT_SEQUENCES.get(f, 1)).max().item()
            for f in CLUSTER_MUTANTS}
    phase(3, f'planted cluster faults, B={MAIN_BATCH} T={c_up.shape[1]} on clusters of '
             f'{auto} (or as FAULT_CLUSTER says): max_abs_err '
             + ', '.join(f'{f} {e:.3e}' for f, e in seen.items())
             + f' (each must exceed tol {KERNEL_TOL}; the true kernel by (N, P) '
             + ', '.join(f'{n}: {e:.3e}' for n, e in true.items()) + ')')
    missed = [f for f, e in seen.items() if not e > KERNEL_TOL]
    if missed or not max(true.values()) <= KERNEL_TOL:
        fail(f'the cluster checks pass planted faults {missed}, or the true kernel misses '
             f'({true})')
    return seen


def batch_sweep(weights, model, hp, gen, n):
    """Phase n: the kernel's us/step over SWEEP_STEPS steps at each of SWEEP_BATCHES,
    with the layout each batch's launch ran on (CUDA events, no params)."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    out = {}
    frames = -(-SWEEP_STEPS // hp.get_hop_size())
    for B in SWEEP_BATCHES:
        c_up = _conditioning(model, hp, B, frames, gen)[:, :SWEEP_STEPS].contiguous()
        noise = wavenet_ar.make_noise(hp, gen, B, SWEEP_STEPS)
        wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False)  # warm
        wavenet_ar.LAUNCHES_BY_LAYOUT.clear()
        _, ms = cuda_ms(lambda: wavenet_ar.generate_ar(weights, c_up, noise, hp,
                                                       return_params=False))
        ((n_launched, p_launched),) = wavenet_ar.LAUNCHES_BY_LAYOUT  # this launch's layout
        out[B] = dict(us_step=1000 * ms / SWEEP_STEPS, cluster=n_launched,
                      sequences=p_launched)
    phase(n, f'batch sweep over {SWEEP_STEPS} steps, us/step (N CTAs, P sequences a '
             'cluster): ' + ', '.join(f'B={B} {r["us_step"]:.1f} ({r["cluster"]}, '
                                     f'{r["sequences"]})' for B, r in out.items()))
    return out


def pair_check(weights, model, hp, gen):
    """Phase 3: two sequences a cluster of two (P = 2) against one a cluster (P = 1, the
    cluster size the batch then gets) at each of PAIR_BATCHES over CLUSTER_STEPS steps:
    audio, params and carried state bit for bit, and the layout of the automatic choice."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    out = {}
    frames = -(-CLUSTER_STEPS // hp.get_hop_size())
    for B in PAIR_BATCHES:
        c_up = _conditioning(model, hp, B, frames, gen)[:, :CLUSTER_STEPS].contiguous()
        noise = wavenet_ar.make_noise(hp, gen, B, CLUSTER_STEPS)
        runs, layouts = {}, {}
        for p in (None, 1, 2):
            wavenet_ar.LAUNCHES_BY_LAYOUT.clear()
            runs[p] = wavenet_ar.generate_ar(weights, c_up, noise, hp, return_state=True,
                                             sequences=p)
            (layouts[p],) = wavenet_ar.LAUNCHES_BY_LAYOUT
        (a1, p1, s1), (a2, p2, s2) = runs[1], runs[2]
        same = (torch.equal(a1, a2) and torch.equal(p1, p2) and torch.equal(s1[0], s2[0])
                and torch.equal(s1[1], s2[1]) and torch.equal(runs[None][1], p2))
        out[B] = dict(same=same, auto=layouts[None], one=layouts[1], two=layouts[2])
    phase(3, f'two sequences a cluster against one, over {CLUSTER_STEPS} steps: ' + ', '.join(
        f'B={B} (N, P) {r["two"]} vs {r["one"]}: bit-identical {r["same"]} (the automatic '
        f'choice {r["auto"]})' for B, r in out.items()))
    bad = {B: r for B, r in out.items() if not r['same'] or r['auto'] != (2, 2)
           or r['two'] != (2, 2) or r['one'][1] != 1}
    if bad:
        fail(f'two sequences a cluster differ from one, or the layout is not (2, 2): {bad}')
    return {B: dict(r, auto=list(r['auto']), one=list(r['one']), two=list(r['two']))
            for B, r in out.items()}


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
             f'(tol {tol}); '
             + (f'planted state faults over {FAULT_STEPS} steps of chunk 2: '
                + ', '.join(f'{f} {e:.3e}' if e is not None else
                            f'{f} not planted (every ring window divides t_base)'
                            for f, e in r['faults'].items())
                + ' (each must exceed tol); ' if r['faults'] else '')
             + f'kernel {1000 * r["ms"] / T:.1f} us/step'
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


def state_carry(weights, c_up, noise, hp, bounds, g_cond=None, plant=True):
    """The kernel in state-carried chunks ending at `bounds` against one fresh kernel
    call and against the plain version run in the same chunks, teacher-forced on the
    kernel's audio; then, with `plant`, the two planted state faults over the first
    FAULT_STEPS steps of chunk 2. Returns the readings that _judge_carry checks."""
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
                                    g_cond) if plant else {},
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
        what = 'synthesize --paper_profile' if paper else 'synthesize'
        with ar_timer() as chunks:
            reset_counts()
            stats = synthesize.main((['--paper_profile'] if paper else [])
                                    + ['--tacotron_checkpoint', taco_path,
                                       '--wavenet_checkpoint', wave_path,
                                       '--hparams', hp_overrides, '--text_list', text_list,
                                       '--output_dir', os.path.join(tmp, 'out'),
                                       '--device', 'cuda'])
            launches = read_counts(what)
        n_rows = len(open(os.path.join(tmp, 'out', 'map.txt'), encoding='utf-8')
                     .read().splitlines())
    want_len = hp.max_iters * hp.outputs_per_step * hp.get_hop_size()
    lens = [len(w) for w in stats['wavs']]
    us_step = 1000 * sum(ms for _, ms in chunks) / sum(steps for steps, _ in chunks)
    phase(n, f'{what}: {len(lens)} wavs of {lens} samples, AR kernel launches={launches} '
             f'(by cluster size {cluster_counts(what)}) at {us_step:.1f} us/step; '
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
            reset_counts()
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
            launches = read_counts('serve')

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
    steps = mol['steps']
    switched = int((_mixtures(params[:, :steps], noise[:, :steps], nr)
                    != _mixtures(mol['ref_params'], noise[:, :steps], nr)).sum())
    clipped = (audio.abs() >= 1).float().mean().item()
    phase(8, f'MoL samples vs the draw from the kernel\'s params {draw_err:.3e} (tol '
             f'{SAMPLE_TOL}); {clipped:.4f} of them clipped (at most {MAX_CLIPPED}), audio '
             f'std {audio.std().item():.3f}; mixtures chosen differently from the plain '
             f'version on the same history: {switched} of {MAIN_BATCH * steps} steps')
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
            reset_counts()
            server.start()
            try:
                status, data, first, wall = fetch(
                    server.address, 'GET', '/tts?text=The+paper+profile,+served.&format=f32')
            finally:
                server.close()
            launches = read_counts('serve --paper_profile')
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
    sweep = batch_sweep(weights, model, hp, gen, 8)
    bound_ms, bound_by = ar_bound(hp, weights, MAIN_BATCH, mol['steps'])
    return dict(max_abs_err=max(mol['max_abs_err'], served_carry['max_abs_err'],
                                odd['max_abs_err']),
                ms=mol['ms'], plain_ms=mol['plain_ms'], bound_ms=bound_ms, bound_by=bound_by,
                steps=mol['steps'], full_ms=mol['full_ms'],
                batch_launches=batch, serve_launches=served, carry_launches=carry_launches,
                batch_us_step=batch_us, serve_us_step=served_us, streamed_b1_ms=served_carry['ms'],
                sweep=sweep)

def mutated_source(fault):
    """The text of csrc/wavenet_ar.cu with the one change of ALL_MUTANTS[fault] (or of
    CLUSTER_MUTANTS[fault])."""
    from tacotron2_tpu_torch.ops import _build

    old, new = {**ALL_MUTANTS, **CLUSTER_MUTANTS}[fault]
    with open(os.path.join(_build.CSRC_DIR, 'wavenet_ar.cu'), encoding='utf-8') as f:
        text = f.read()
    if text.count(old) != 1:
        raise ValueError(f'the line that {fault!r} changes stands {text.count(old)} times '
                         'in csrc/wavenet_ar.cu: bring ALL_MUTANTS and CLUSTER_MUTANTS up '
                         'to date')
    return text.replace(old, new)


def build_kernels(tmp):
    """Phase 2: nvcc builds the port's library, the probes' library and, beside them, one
    library for each of ALL_MUTANTS, CLUSTER_MUTANTS and PROBE_MUTANTS from a changed
    copy of its source
    under `tmp`, all at once (one nvcc a library). Returns fault -> its loaded library."""
    from tacotron2_tpu_torch.ops import _build

    def mutant(item):
        i, fault = item
        name, text = (mutated_probe_source(fault) if fault in PROBE_MUTANTS
                      else ('wavenet_ar.cu', mutated_source(fault)))
        src = os.path.join(tmp, f'mutant{i}', name)
        os.makedirs(os.path.dirname(src))
        with open(src, 'w', encoding='utf-8') as f:
            f.write(text)
        lib = os.path.join(tmp, f'mutant{i}', 'libmutant.so')
        _build.compile_library([src], lib)
        return fault, ctypes.CDLL(lib)

    faults = list(ALL_MUTANTS) + list(CLUSTER_MUTANTS) + list(PROBE_MUTANTS)
    with concurrent.futures.ThreadPoolExecutor(2 + len(faults)) as pool:
        builds = [pool.submit(_build.load_library), pool.submit(_build.load_probe_library)]
        mutants = dict(pool.map(mutant, enumerate(faults)))
        for b in builds:
            b.result()
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


def params_err(weights, c_up, noise, hp, g_cond=None, plant=None, library=None,
               cluster=None, sequences=None):
    """Max abs params error, a sequence, of the kernel (of `library`, on the inputs
    `plant` makes of the true ones: a dict of generate_ar's weights / g_cond / state_in;
    on clusters of `cluster` CTAs running `sequences` sequences each, else the wrapper's
    choice) against the plain version on the true inputs, teacher-forced on the
    kernel's audio: (B,)."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    kw = dict(weights=weights, g_cond=g_cond, state_in=None)
    kw.update(plant or {})
    with kernel_library(library):
        audio, params = wavenet_ar.generate_ar(kw['weights'], c_up, noise, hp,
                                               state_in=kw['state_in'], g_cond=kw['g_cond'],
                                               cluster=cluster, sequences=sequences)
    _, ref = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, targets=audio,
                                              g_cond=g_cond)
    return (params - ref).abs().flatten(1).max(1).values


def first_steps_err(weights, c_up, noise, hp, g_cond=None, plant=None, library=None,
                    cluster=None):
    """The first-steps reading (see FIRST_STEPS_TOL): the lower quartile over the
    sequences of params_err over the first FIRST_STEPS steps of a fresh call."""
    err = params_err(weights, c_up[:, :FIRST_STEPS].contiguous(),
                     noise[:, :FIRST_STEPS].contiguous(), hp, g_cond, plant, library,
                     cluster)
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


def variant_vs_plain(hp, weights, c_up, noise, g_cond, bounds, what='', n=9, plant=True):
    """Phases 9 and 10: one instantiation against its plain version as phase 6 holds
    the main one (state_carry in chunks ending at `bounds`, with its two planted state
    faults unless `plant` is off), and its samples against the draw from its own
    params: class ids exactly, floats within SAMPLE_TOL. Returns state_carry's
    readings, and under 'span' that of the plain version's params."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    what = f'{wavenet_ar.variant(hp, g_cond is not None)}, B={c_up.shape[0]}{what}'
    r = state_carry(weights, c_up, noise, hp, bounds, g_cond, plant)
    _judge_carry(n, what, r, bounds)
    drawn = wavenet_ar.sample(r['params'], r['noise'], hp)
    span = (r['ref_params'].max() - r['ref_params'].min()).item()
    if wavenet_ar.is_categorical(hp):
        wrong = int((drawn != r['audio']).sum())
        other = int((wavenet_ar.sample(r['ref_params'], r['noise'], hp) != r['audio']).sum())
        phase(n, f'{what}: params span {span:.3f}; class ids that are not the first arg-max '
                 f'of the kernel\'s params + noise: {wrong} of {drawn.numel()} (must be 0); '
                 f'{r["audio"].unique().numel()} distinct ids; the plain version draws '
                 f'another id at {other} steps on the same history')
        if wrong:
            fail(f'{what}: the kernel\'s class ids are not the arg-max of its own scores')
    else:
        draw_err = (drawn - r['audio']).abs().max().item()
        phase(n, f'{what}: params span {span:.3f}; samples vs the draw from the kernel\'s '
                 f'params {draw_err:.3e} (tol {SAMPLE_TOL})')
        if not draw_err <= SAMPLE_TOL:
            fail(f'{what}: the kernel\'s samples are not its draw: {draw_err}')
    r['span'] = span
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


def vocoder_cli(extra, hp, wavenet_state, speaker_id=None, path=None):
    """Phase 9: `python -m tacotron2_tpu_torch.synthesize --model WaveNet` over two seeded
    mels of VOCODER_FRAMES frames written as mel-*.npy with a map.txt, a run of the main
    path `path` (read_counts; without one, counted nowhere). Checks the wavs on disk, the
    map.txt rows and the launches. Returns the run's stats with launches,
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
            reset_counts()
            stats = synthesize.main(
                ['--model', 'WaveNet', '--wavenet_checkpoint', wave_path, '--mels_dir',
                 mels_dir, '--base_dir', tmp, '--hparams', extra, '--device', 'cuda']
                + (['--speaker_id', speaker_id] if speaker_id else []))
            by_variant = dict(wavenet_ar.LAUNCHES_BY_VARIANT)
            launches = read_counts(path)
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
    one_three = vocoder_cli(SPEAKERS, hp, state, '1,3', VOCODER_SPEAKERS_PATH)
    three_three = vocoder_cli(SPEAKERS, hp, state, '3,3', VOCODER_SPEAKERS_PATH)
    moved = np.abs(one_three['wavs'][0] - three_three['wavs'][0]).max()
    same = np.array_equal(one_three['wavs'][1], three_three['wavs'][1])
    phase(9, f'--speaker_id 1,3 against 3,3 on the same mels and noise: the first wav moves '
             f'by {moved:.3f}, the second is identical: {same}')
    if not moved > 1e-2 or not same:
        fail('--speaker_id does not reach the kernel sequence by sequence')
    quantized = CATEGORICAL + ',wavenet_fused_ar=False'
    hp_q, _, weights_q, state_q = models['categorical-plain']
    cat = vocoder_cli(quantized, hp_q, state_q, path=VOCODER_CATEGORICAL_PATH)
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
        again, _ = wavenet_ar.generate_ar(weights_v, call['c_up'], call['noise'], hp_v,
                                          return_params=False, g_cond=call['g_cond'])
        if not torch.equal(again, call['audio']) \
                or not torch.equal(r['audio'], call['audio'][:, :VOCODER_CLI_BOUNDS[-1]]):
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


# --- phase 10: the big-vocab head, the in-kernel NLL and the trainer --------------------

def big_vocab_model(Q, extra='', seed=1):
    """vocoder_model with a categorical head over Q classes. The first conv's rows are
    scaled to the deviation they have at Q = 256 (seeded weights of variance 1 / fan_in
    shrink with Q, and the class fed back would then hardly move the next step)."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    hp, model, _, state = vocoder_model(
        f"input_type='mulaw-quantize',quantize_channels={Q},out_channels={Q}"
        + (',' + extra if extra else ''), seed)
    with torch.no_grad():
        model.first_conv.weight *= (Q / 256) ** 0.5
    return hp, model, wavenet_ar.pack_params(model, hp), state


def _nan_is_inf(x):
    return x if x == x else float('inf')


def run_chunked_big(run, weights, c_up, y, hp, bounds, g_cond=None, targets=None, **kw):
    """`run` (generate_ar or generate_ar_reference) on a big-vocab model with y_eval in
    state-carried chunks ending at `bounds`; `targets` teacher-forces the plain version,
    which then returns the ids it drew. Returns ids, NLL and a copy of the state after
    chunk 1."""
    noise = torch.zeros(c_up.shape[0], c_up.shape[1], 1, device=c_up.device)
    outs, state, after1 = [], None, None
    for lo, hi in zip((0,) + tuple(bounds[:-1]), bounds):
        more = dict(kw) if targets is None \
            else dict(kw, targets=targets[:, lo:hi], return_drawn=True)
        out = run(weights, c_up[:, lo:hi].contiguous(), noise[:, lo:hi].contiguous(), hp,
                  return_params=False, y_eval=y[:, lo:hi].contiguous(), g_cond=g_cond,
                  state_in=state, return_state=hi < bounds[-1], **more)
        outs.append(out[:2])
        if hi < bounds[-1]:
            state = out[2]
            if after1 is None:
                after1 = _clone_state(state)
    return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1), after1


def big_vocab_vs_plain(hp, weights, c_up, y, bounds, g_cond=None, seed=None, library=None):
    """One big-vocab launch (of `library`) with y_eval, greedy or sampled with `seed`,
    against the same in state-carried chunks ending at `bounds` and against the plain
    version in those chunks, teacher-forced on the kernel's ids. Returns the readings
    that _judge_big checks."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    kw = dict(greedy=True) if seed is None else dict(seed=seed)
    T = bounds[-1]
    c_up, y = c_up[:, :T].contiguous(), y[:, :T].contiguous()
    noise = torch.zeros(c_up.shape[0], T, 1, device='cuda')
    with kernel_library(library):
        (ids, nll), ms = cuda_ms(lambda: wavenet_ar.generate_ar(
            weights, c_up, noise, hp, return_params=False, y_eval=y, g_cond=g_cond, **kw))
        c_ids, c_nll, k_after1 = run_chunked_big(wavenet_ar.generate_ar, weights, c_up, y,
                                                 hp, bounds, g_cond, **kw)
    (r_ids, r_nll, r_after1), plain_ms = cuda_ms(lambda: run_chunked_big(
        wavenet_ar.generate_ar_reference, weights, c_up, y, hp, bounds,
        g_cond, targets=ids, **kw))
    return dict(bit_identical=torch.equal(c_ids, ids) and torch.equal(c_nll, nll),
                nll_err=_nan_is_inf((nll - r_nll).abs().max().item()),
                ids_off=int((ids != r_ids).sum()), steps=ids.numel(),
                distinct=ids.unique().numel(), nll_mean=nll.mean().item(),
                state_err=_state_err(k_after1, r_after1), t_base=(k_after1[2], r_after1[2]),
                nll_span=(r_nll.max() - r_nll.min()).item(),
                state_span=max((x.max() - x.min()).item() for x in r_after1[:2]),
                audio_ok=_audio_ok(ids, hp), ms=ms, plain_ms=plain_ms, ids=ids, nll=nll)


def _judge_big(what, r, bounds, nll_tol=NLL_TOL, state_tol=KERNEL_TOL):
    T = bounds[-1]
    phase(10, f'{what}, chunks ending at {list(bounds)}: bit-identical to one call: '
              f'{r["bit_identical"]}; NLL max_abs_err={r["nll_err"]:.3e} (tol {nll_tol:.3g}; mean '
              f'NLL {r["nll_mean"]:.3f}, span {r["nll_span"]:.3f}), ids the plain version '
              f'draws otherwise on the same '
              f'history: {r["ids_off"]} of {r["steps"]} (at most {MAX_IDS_OFF:.0%}), '
              f'{r["distinct"]} distinct ids, state after chunk 1 max_abs_err='
              f'{r["state_err"]:.3e} (tol {state_tol:.3g}; the state spans '
              f'{r["state_span"]:.3f}); kernel {1000 * r["ms"] / T:.1f} '
              f'us/step, plain {1000 * r["plain_ms"] / T:.1f} us/step')
    if not r['bit_identical']:
        fail(f'{what}: chunked kernel output differs from one call')
    if not (r['nll_err'] <= nll_tol and r['state_err'] <= state_tol) \
            or r['t_base'] != (bounds[0], bounds[0]):
        fail(f'{what}: the kernel differs from the plain version')
    if not r['ids_off'] <= MAX_IDS_OFF * r['steps'] or not r['audio_ok']:
        fail(f'{what}: the kernel\'s class ids differ from the plain version\'s')


def big_vocab_inputs(hp, model, B, frames, gen):
    """c_up through the model's upsampler and seeded class ids to score."""
    c_up = _conditioning(model, hp, B, frames, gen)
    y = torch.randint(0, hp.out_channels, c_up.shape[:2], generator=gen, device='cuda')
    return c_up, y


def small_head_nll(gen):
    """Phase 10: the NLL flag on the small categorical head (Q = 256) at the default
    width, B=2 over 1,100 steps with sampling on: against -log_softmax of the params a
    second launch returns on the same noise (ids equal, NLL within SMALL_NLL_TOL) and
    against `torch.nn.functional.cross_entropy` on those params, which is timed as the
    library call that computes the NLL alone; the plain version with y_eval beside it."""
    import torch.nn.functional as F

    from tacotron2_tpu_torch.ops import wavenet_ar

    hp, model, weights, _ = vocoder_model(CATEGORICAL)
    c_up, y = big_vocab_inputs(hp, model, MAIN_BATCH, 4, gen)
    noise = wavenet_ar.make_noise(hp, gen, MAIN_BATCH, c_up.shape[1])
    T, Q = c_up.shape[1], hp.out_channels
    name = wavenet_ar.variant(hp, nll=True)
    launches0 = wavenet_ar.LAUNCHES_BY_VARIANT[name]
    (ids, nll), ms = cuda_ms(lambda: wavenet_ar.generate_ar(
        weights, c_up, noise, hp, return_params=False, y_eval=y))
    (ids2, params), params_ms = cuda_ms(lambda: wavenet_ar.generate_ar(weights, c_up, noise, hp))
    want = -torch.log_softmax(params, -1).gather(-1, y[..., None])[..., 0]
    F.cross_entropy(params.view(-1, Q), y.view(-1), reduction='none')  # warm up
    ce, library_ms = cuda_ms(lambda: F.cross_entropy(params.view(-1, Q), y.view(-1),
                                                     reduction='none'))
    (_, r_nll), plain_ms = cuda_ms(lambda: wavenet_ar.generate_ar_reference(
        weights, c_up, noise, hp, return_params=False, y_eval=y, targets=ids))
    err = (nll - want).abs().max().item()
    ce_err = (nll - ce.view(MAIN_BATCH, T)).abs().max().item()
    plain_err = (nll - r_nll).abs().max().item()
    bound_ms, bound_by = ar_bound(hp, weights, MAIN_BATCH, T, False, nll=True)
    phase(10, f'NLL flag on the small head (categorical-fused+nll, Q={Q}, B={MAIN_BATCH} '
              f'T={T}): ids equal to a launch with params: {torch.equal(ids, ids2)}; NLL vs '
              f'-log_softmax of that launch\'s params {err:.3e}, vs cross_entropy on them '
              f'{ce_err:.3e} (tol {SMALL_NLL_TOL}), vs the plain version {plain_err:.3e} (tol '
              f'{NLL_TOL}); kernel {1000 * ms / T:.1f} us/step with the NLL, '
              f'{1000 * params_ms / T:.1f} with params; cross_entropy on the materialised '
              f'({MAIN_BATCH}, {T}, {Q}) logits {library_ms:.3f} ms; plain '
              f'{1000 * plain_ms / T:.1f} us/step')
    if not torch.equal(ids, ids2) or not (err <= SMALL_NLL_TOL and ce_err <= SMALL_NLL_TOL):
        fail('the small head\'s in-kernel NLL is not -log_softmax of its logits')
    if not plain_err <= NLL_TOL:
        fail(f'the small head\'s NLL differs from the plain version by {plain_err}')
    return dict(max_abs_err=max(err, ce_err), ms=ms, plain_ms=plain_ms, steps=T,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                plain_err=plain_err, with_params_ms=params_ms,
                check_launches=wavenet_ar.LAUNCHES_BY_VARIANT[name] - launches0)


def _chi_square(ids, bins):
    counts = torch.bincount(ids.flatten(), minlength=bins).double()
    want = ids.numel() / bins
    return ((counts - want) ** 2 / want).sum().item()


def big_vocab_noise(hp, weights, gen):
    """Phase 10: the in-kernel noise. With the head's logits forced flat (zero w_s2 and
    b_s2) the id of a step is the arg-max of its Q Gumbel values alone: over B=8 x 2,048
    steps the ids are uniform (chi-square over 64 coarse bins, id // (Q / 64), and 64
    fine ones, id % 64: 63 degrees of freedom, mean 63, deviation 11.2; the run fails
    past 119, five deviations), equal between two seeds or two sequences no more often
    than chance (one position in Q; at Q = 65,536 at most 3 of them), and over the first
    16 steps the arg-max of `philox_gumbel`, the plain version's noise, whose values
    there (8.4 M at Q = 65,536) have the Gumbel mean 0.5772 and deviation 1.2825."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    B, T, Q, steps = 8, 2048, hp.out_channels, 16
    flat = dict(weights, w_s2=torch.zeros_like(weights['w_s2']),
                b_s2=torch.zeros_like(weights['b_s2']))
    c_up = torch.rand(B, T, hp.cin_channels, generator=gen, device='cuda')
    noise = torch.zeros(B, T, 1, device='cuda')
    seeds = (11, 12 + 2 ** 40)
    ids = [wavenet_ar.generate_ar(flat, c_up, noise, hp, return_params=False, seed=s)[0]
           for s in seeds]
    coarse = [_chi_square(i // (Q // 64), 64) for i in ids]
    fine = [_chi_square(i % 64, 64) for i in ids]
    same_seed = int((ids[0] == ids[1]).sum())
    same_seq = int((ids[0][0] == ids[0][1]).sum())
    gumbel = torch.stack([wavenet_ar.philox_gumbel(seeds[0], B, t, Q, 'cuda')
                          for t in range(steps)], 1)                     # (B, steps, Q)
    off = int((gumbel.argmax(-1) != ids[0][:, :steps]).sum())
    mean, std, n = gumbel.mean().item(), gumbel.std().item(), gumbel.numel()
    se = 1.2825 / n ** 0.5
    std_tol = max(0.005, 5 * se)  # the deviation's own standard error is about 1.05 se

    def chance(positions):  # equal ids by chance: the mean, five deviations, and 3
        return positions / Q + 5 * (positions / Q) ** 0.5 + 3
    phase(10, f'in-kernel noise, flat logits, B={B} T={T} Q={Q}: chi-square of the ids over '
              f'64 coarse bins {coarse[0]:.1f} and {coarse[1]:.1f}, over 64 fine bins '
              f'{fine[0]:.1f} and {fine[1]:.1f} (63 degrees of freedom; at most 119); equal '
              f'ids between the two seeds {same_seed} of {ids[0].numel()} (at most '
              f'{chance(ids[0].numel()):.1f}), between sequences 0 and 1 {same_seq} of {T} (at '
              f'most {chance(T):.1f}); ids that are not the arg-max of philox_gumbel over the '
              f'first {steps} steps: {off} of {B * steps}; its {n} values: mean {mean:.5f} '
              f'(0.57722 +- {4 * se:.5f}), deviation {std:.4f} (1.2825 +- {std_tol:.4f})')
    if max(coarse + fine) > 119:
        fail('the big-vocab head\'s ids are not uniform under flat logits')
    if same_seed > chance(ids[0].numel()) or same_seq > chance(T):
        fail('the in-kernel noise repeats between seeds or sequences')
    if off:
        fail('the kernel\'s noise is not philox_gumbel\'s')
    if not (abs(mean - 0.57722) <= 4 * se and abs(std - 1.2825) <= std_tol):
        fail('philox_gumbel does not draw Gumbel noise')
    return flat


def first_steps_nll_err(weights, c_up, y, hp, seed, plant=None, library=None):
    """The first-steps reading for the big-vocab head (see FIRST_STEPS_TOL): the lower
    quartile over the sequences of each one's max abs NLL error over the first
    FIRST_STEPS steps of a fresh sampled call (of `library`, from the state `plant`
    gives it) against the plain version on the true inputs and the kernel's ids."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    c_up, y = c_up[:, :FIRST_STEPS].contiguous(), y[:, :FIRST_STEPS].contiguous()
    noise = torch.zeros(c_up.shape[0], FIRST_STEPS, 1, device='cuda')
    with kernel_library(library):
        ids, nll = wavenet_ar.generate_ar(weights, c_up, noise, hp, return_params=False,
                                          y_eval=y, seed=seed, state_in=plant)
    _, ref = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, return_params=False,
                                              y_eval=y, seed=seed, targets=ids)
    return torch.quantile((nll - ref).abs().max(1).values, 0.25).item()


def big_vocab_tie(hp, weights, c_up):
    """Two classes of 65,536 tied far above the rest at every step (greedy): the kernel
    emits the lower id and feeds back bf16(1/2) of each class's bf16 first-conv row, as
    the plain version. Returns (h error, how far the first row alone is)."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    lo, hi = 3, 40007
    w = dict(weights, w_s2=weights['w_s2'].clone(), b_s2=weights['b_s2'].clone())
    w['w_s2'][:, [lo, hi]] = 0.0
    w['b_s2'][[lo, hi]] = 50.0
    c_up = c_up[:MAIN_BATCH, :20].contiguous()
    noise = torch.zeros(MAIN_BATCH, 20, 1, device='cuda')
    ids, _, state = wavenet_ar.generate_ar(w, c_up, noise, hp, return_params=False,
                                           greedy=True, return_state=True)
    r_ids, _, r_state = wavenet_ar.generate_ar_reference(w, c_up, noise, hp,
                                                         return_params=False, greedy=True,
                                                         return_state=True)
    rows = w['first_w'][[lo, hi]].float()
    h_err = (state[1] - (0.5 * rows[0] + 0.5 * rows[1] + w['first_b'])).abs().max().item()
    first_only = (state[1] - (rows[0] + w['first_b'])).abs().max().item()
    s_err = _state_err(state, r_state)
    phase(10, f'forced tie of classes {lo} and {hi} of {hp.out_channels}, B={MAIN_BATCH} T=20: '
              f'ids all {lo}: {bool((ids == lo).all())}; next-step h vs the mean of the two '
              f'bf16 rows {h_err:.3e} (tol 1e-6; the first row alone is {first_only:.3e} '
              f'away); free-running state vs the plain version {s_err:.3e} (tol {KERNEL_TOL})')
    if not ((ids == lo).all() and torch.equal(ids, r_ids)) or not h_err <= 1e-6 \
            or not first_only > 1e-3:
        fail('the big-vocab kernel does not average tied classes')
    if not s_err <= KERNEL_TOL:
        fail(f'the tied big-vocab kernel differs from the plain version by {s_err}')
    return h_err, first_only


def big_vocab_faults(big, ragged, flat, mutants, gen):
    """Phase 10: the planted faults of the big-vocab head and the NLL, each with the
    check that must see it miss and that check's reading on the true kernel. `big` and
    `ragged`: big_vocab_model at Q = 65,536 and BIG_RAGGED_Q; `flat`: the first's
    weights with flat logits."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    hp, model, weights, _ = big
    Q, R = hp.out_channels, hp.residual_channels
    readings = {}  # fault -> (reading, bound, the true kernel's reading)

    # the NLL over one frame at B=2, sampled: NLL_TOL
    c_up, y = big_vocab_inputs(hp, model, MAIN_BATCH, 1, gen)

    def nll_err(library=None, weights=weights, hp=hp, c_up=c_up, y=y):
        return big_vocab_vs_plain(hp, weights, c_up, y, BIG_SHORT_BOUNDS, seed=5,
                                  library=library)['nll_err']

    true = nll_err()
    fault = 'NLL from the noised scores'
    readings[fault] = (nll_err(mutants[fault]), NLL_TOL, true)
    # logits near 100, where exp overflows unless the maximum is taken out first
    high = dict(weights, b_s2=weights['b_s2'] + 100.0)
    fault = 'log-sum-exp without the maximum taken out'
    readings[fault] = (nll_err(mutants[fault], high), NLL_TOL, nll_err(None, high))
    # a Q that 1,024 does not divide, every fourth id scored in the ragged tail
    hp_r, model_r, weights_r, _ = ragged
    c_r, y_r = big_vocab_inputs(hp_r, model_r, MAIN_BATCH, 1, gen)
    tail = hp_r.out_channels // 1024 * 1024
    y_r[:, ::4] = torch.randint(tail, hp_r.out_channels, y_r[:, ::4].shape, generator=gen,
                                device='cuda')
    fault = 'classes past the last multiple of 1,024 left out'
    readings[fault] = (nll_err(mutants[fault], weights_r, hp=hp_r, c_up=c_r, y=y_r), NLL_TOL,
                       nll_err(None, weights_r, hp=hp_r, c_up=c_r, y=y_r))

    # the bf16 roundings: the first steps at B=16
    NB = FIRST_STEPS_BATCH
    c16, y16 = big_vocab_inputs(hp, model, NB, 1, gen)
    true = first_steps_nll_err(weights, c16, y16, hp, 5)
    fault = 'head input not rounded to bf16'
    readings[fault] = (first_steps_nll_err(weights, c16, y16, hp, 5, library=mutants[fault]),
                       FIRST_STEPS_TOL, true)
    f32_row = model.first_conv.weight.detach().float()[:, Q // 2] + weights['first_b']
    start = (torch.zeros(NB, wavenet_ar.ring_floats(hp), device='cuda'),
             f32_row.expand(NB, -1).contiguous(), 0)
    readings['start row read from an f32 first_w'] = (
        first_steps_nll_err(weights, c16, y16, hp, 5, plant=start), FIRST_STEPS_TOL, true)

    # the noise counter without t_base: under flat logits the ids are the noise alone,
    # so chunk 2 from a state whose t_base is reset to 0 repeats chunk 1's ids
    n = 64
    c_f = torch.rand(MAIN_BATCH, 2 * n, hp.cin_channels, generator=gen, device='cuda')
    noise = torch.zeros(MAIN_BATCH, 2 * n, 1, device='cuda')
    whole, _ = wavenet_ar.generate_ar(flat, c_f, noise, hp, return_params=False, seed=5)
    first, _, state = wavenet_ar.generate_ar(flat, c_f[:, :n].contiguous(),
                                             noise[:, :n].contiguous(), hp,
                                             return_params=False, seed=5, return_state=True)
    second = {}
    for name, st in (('true', _clone_state(state)), ('reset', (*_clone_state(state)[:2], 0))):
        second[name], _ = wavenet_ar.generate_ar(flat, c_f[:, n:].contiguous(),
                                                 noise[:, n:].contiguous(), hp,
                                                 return_params=False, seed=5, state_in=st)
    readings['noise counter without t_base'] = (
        (second['reset'] != whole[:, n:]).float().mean().item(), 0.5,
        (second['true'] != whole[:, n:]).float().mean().item())
    repeats = torch.equal(second['reset'], first)

    phase(10, 'planted faults (reading, its bound, the true kernel\'s reading): '
              + ', '.join(f'{f} ({e:.3e}, {tol}, {t:.3e})' for f, (e, tol, t) in readings.items())
              + f'; each fault must exceed its bound and the true kernel stay within it; '
              f'with t_base reset chunk 2 repeats chunk 1\'s ids: {repeats}')
    missed = [f for f, (e, tol, _) in readings.items() if not e > tol]
    wrong = [f for f, (_, tol, t) in readings.items() if not t <= tol]
    if missed:
        fail(f'the big-vocab kernel checks pass planted faults: {missed}')
    if wrong:
        fail(f'the true kernel misses the bound of the checks for: {wrong}')
    if not repeats:
        fail('a reset t_base does not repeat the noise of chunk 1')
    h_err, first_only = big_vocab_tie(hp, weights, c_up)
    readings['only the first of two tied classes fed back'] = (first_only, 1e-6, h_err)
    return readings


def big_vocab_head(mutants, gen):
    """Phase 10, the kernel half (see the module docstring). Returns the readings for
    the kernels line."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    launches0 = wavenet_ar.LAUNCHES
    big = big_vocab_model(65536)
    hp, model, weights, _ = big
    c_up, y = big_vocab_inputs(hp, model, MAIN_BATCH, 4, gen)
    runs = {}
    for how, seed in (('greedy', None), ('sampled', 1234567890123)):
        key = f'{wavenet_ar.variant(hp, nll=True)}, {how}, B={MAIN_BATCH}'
        runs[key] = r = big_vocab_vs_plain(hp, weights, c_up, y, BIG_BOUNDS, seed=seed)
        _judge_big(key, r, BIG_BOUNDS)
    sampled = r
    other, _ = wavenet_ar.generate_ar(weights, c_up, torch.zeros(MAIN_BATCH, c_up.shape[1], 1,
                                                                 device='cuda'),
                                      hp, return_params=False, seed=7)
    moved = (other != sampled['ids']).float().mean().item()
    phase(10, f'another seed draws other ids at {moved:.3f} of the steps (at least 0.9)')
    if not moved >= 0.9:
        fail('the seed does not reach the big-vocab head\'s noise')

    ragged = big_vocab_model(BIG_RAGGED_Q, seed=3)
    for name, (hp_v, model_v, weights_v, _), speakers in (
            ('plain chain', big_vocab_model(65536, 'wavenet_fused_ar=False', seed=2), None),
            ('g_cond', big_vocab_model(65536, SPEAKERS, seed=4), [1, 3]),
            (f'Q={BIG_RAGGED_Q}', ragged, None)):
        c_v, y_v = big_vocab_inputs(hp_v, model_v, MAIN_BATCH, 1, gen)
        g_cond = speaker_rows(model_v, hp_v, speakers) if speakers else None
        key = f'{wavenet_ar.variant(hp_v, g_cond is not None, True)}, sampled, {name}, ' \
              f'B={MAIN_BATCH}'
        runs[key] = r = big_vocab_vs_plain(hp_v, weights_v, c_v, y_v, BIG_SHORT_BOUNDS, g_cond,
                                           seed=99)
        _judge_big(key, r, BIG_SHORT_BOUNDS)

    # what the NLL flag and the noise cost: the sampled run's launch again, each way
    noise = torch.zeros(MAIN_BATCH, BIG_BOUNDS[-1], 1, device='cuda')
    c_t, y_t = c_up[:, :BIG_BOUNDS[-1]].contiguous(), y[:, :BIG_BOUNDS[-1]].contiguous()
    us = {}
    for name, kw in (('sampled', dict(seed=5)), ('sampled+nll', dict(seed=5, y_eval=y_t)),
                     ('greedy', dict(greedy=True)), ('greedy+nll', dict(greedy=True, y_eval=y_t))):
        _, ms = cuda_ms(lambda: wavenet_ar.generate_ar(weights, c_t, noise, hp,
                                                       return_params=False, **kw))
        us[name] = 1000 * ms / BIG_BOUNDS[-1]
    phase(10, 'categorical_big-fused, B=2 over 1,100 steps, us/step: '
              + ', '.join(f'{k} {v:.1f}' for k, v in us.items()))

    small = small_head_nll(gen)
    flat = big_vocab_noise(hp, weights, gen)
    faults = big_vocab_faults(big, ragged, flat, mutants, gen)
    bound_ms, bound_by = ar_bound(hp, weights, MAIN_BATCH, BIG_BOUNDS[-1], False, nll=True)
    return dict(runs=runs, sampled=sampled, small=small, us_step=us,
                faults={f: e if np.isfinite(e) else 'inf' for f, (e, _, _) in faults.items()},
                bound_ms=bound_ms, bound_by=bound_by, weights=weights, hp=hp,
                check_launches=wavenet_ar.LAUNCHES - launches0)


STEP_LINE = re.compile(r'Step\s+(\d+) \[([0-9.]+) sec/step, loss=([0-9.]+|nan|inf)')


def make_corpus(root, hp, n, seed):
    """A corpus in the preprocessing layout, made from `seed`: n utterances of 1 to 2 s
    (80 to 160 mel frames of hop 275) as audio/audio-i.npy (two gliding tones and noise;
    class ids for a mu-law-quantized model), mels/mel-i.npy (uniform in the mel range)
    and a train.txt that names them. Returns the path of train.txt."""
    from tacotron2_tpu_torch.ops.mulaw import is_mulaw_quantize, mulaw_quantize

    rng = np.random.default_rng(seed)
    hop = hp.get_hop_size()
    os.makedirs(os.path.join(root, 'audio'))
    os.makedirs(os.path.join(root, 'mels'))
    rows = []
    for i in range(n):
        frames = int(rng.integers(80, 161))
        t = np.arange(frames * hop) / hp.sample_rate
        wav = (0.4 * np.sin(2 * np.pi * (180 + 40 * i) * t * (1 + 0.2 * np.sin(3 * t)))
               + 0.2 * np.sin(2 * np.pi * (900 + 70 * i) * t)
               + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        if is_mulaw_quantize(hp.input_type):
            wav = mulaw_quantize(wav, hp.quantize_channels)
        np.save(os.path.join(root, 'audio', f'audio-{i}.npy'), wav)
        np.save(os.path.join(root, 'mels', f'mel-{i}.npy'),
                rng.uniform(-hp.max_abs_value, hp.max_abs_value,
                            (frames, hp.num_mels)).astype(np.float32))
        rows.append(f'audio-{i}.npy|mel-{i}.npy|_|<no_g>|{len(wav)}|{frames}')
    path = os.path.join(root, 'train.txt')
    with open(path, 'w', encoding='utf-8') as f:
        f.write('\n'.join(rows) + '\n')
    return path


def run_trainer(root, meta, name, hparams, steps, eval_interval, checkpoint_interval,
                restore=True, path=None):
    """`python -m tacotron2_tpu_torch.train --model WaveNet` on the card, its console
    output captured. Returns the output, its (step, sec/step, loss) lines, the AR
    launches by instantiation and each one's inputs and outputs (ar_timer's `calls`),
    the wall seconds, the peak device memory and the checkpoint directory. A run of the
    main path `path` (read_counts), or without one a check's run, counted nowhere."""
    from tacotron2_tpu_torch import train
    from tacotron2_tpu_torch.ops import wavenet_ar

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out, calls = io.StringIO(), []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), ar_timer(calls):
        save_dir = train.main(
            ['--model', 'WaveNet', '--wavenet_input', meta, '--base_dir', root, '--name', name,
             '--wavenet_train_steps', str(steps), '--eval_interval', str(eval_interval),
             '--checkpoint_interval', str(checkpoint_interval), '--summary_interval', '2',
             '--restore', str(restore), '--hparams', hparams, '--device', 'cuda'])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    read_counts(path)
    text = out.getvalue()
    lines = {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
             for m in STEP_LINE.finditer(text)}
    return dict(out=text, steps=lines, launches=dict(wavenet_ar.LAUNCHES_BY_VARIANT),
                calls=calls, seconds=seconds, peak_bytes=torch.cuda.max_memory_allocated(),
                save_dir=save_dir)


def _check_history(what, save_dir, steps):
    """The eval-history sidecar holds one finite record for each of `steps`."""
    from tacotron2_tpu_torch.training import checkpoint_select

    history = checkpoint_select.load_eval_history(save_dir)
    if [r['step'] for r in history] != list(steps):
        fail(f'{what}: the sidecar holds records of {[r["step"] for r in history]}, '
             f'expected {list(steps)}')
    for r in history:
        if not {'natural_loss', 'teacher_forced_loss', 'gen_samples_per_sec'} <= set(r) \
                or not all(np.isfinite(v) for v in r.values()):
            fail(f'{what}: an eval record lacks a metric or is not finite: {r}')
    return history


def eval_launch_vs_plain(call):
    """Phase 10: the default trainer's eval launch (gaussian-fused with params, B=1 over
    the crop of hp.max_time_steps samples) against the plain version on the inputs it
    had, the EMA weights it packed among them: a further launch over all its steps must
    repeat its audio and params bit for bit, and over the first TRAIN_EVAL_BOUNDS[-1] of
    them the kernel goes through variant_vs_plain (chunked bit-identical, params and
    carried state within KERNEL_TOL, the samples its own draw; no state fault is
    planted: a few steps from their initial values these weights' params span too
    little for a fault to pass KERNEL_TOL). Returns the readings."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    hp, weights, c_up, noise = call['hp'], call['weights'], call['c_up'], call['noise']
    B, T = c_up.shape[:2]
    if (B, T) != (1, hp.max_time_steps) or call['g_cond'] is not None \
            or not call['kw'].get('return_params') or call['second'] is None:
        fail(f'the default trainer\'s eval launch was B={B}, T={T}, {call["kw"]}')
    (audio, params), ms = cuda_ms(lambda: wavenet_ar.generate_ar(weights, c_up, noise, hp))
    if not (torch.equal(audio, call['audio']) and torch.equal(params, call['second'])):
        fail('a launch on the trainer\'s eval inputs does not repeat its audio and params')
    steps = TRAIN_EVAL_BOUNDS[-1]
    r = variant_vs_plain(hp, weights, c_up, noise, None, TRAIN_EVAL_BOUNDS,
                         f' on the inputs of the trainer\'s eval launch (the first {steps} '
                         f'of its {T} steps; all {T} repeat bit for bit at '
                         f'{1000 * ms / T:.1f} us/step)', n=10, plant=False)
    if not (torch.equal(r['audio'], call['audio'][:, :steps])
            and torch.equal(r['params'], call['second'][:, :steps])):
        fail('the check\'s chunked launch does not repeat the start of the trainer\'s')
    return dict(max_abs_err=r['max_abs_err'], state_err=r['state_err'], steps=steps,
                span=r['span'], full_steps=T, full_us_step=1000 * ms / T,
                plain_us_step=1000 * r['plain_ms'] / steps)


def big_eval_launch_vs_plain(calls):
    """Phase 10: the Q = 65,536 trainer's eval launches (categorical_big-fused with the
    NLL flag, sampled, B=1 over the crop's steps, y_eval the batch's own class ids)
    against the plain version on the inputs they had, the EMA weights and the seed
    among them: a further launch on each one's inputs must repeat its ids and NLL bit
    for bit, and the last one goes through big_vocab_vs_plain over all its steps
    (chunked bit-identical; the plain version in those chunks, teacher-forced on the
    kernel's ids: ids, NLL, carried state; the bounds of the NLL and the state grow
    with the span of each, see EVAL_NLL_TOL_PER_SPAN). Returns the readings, with the
    bound of that launch."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    for i, call in enumerate(calls):
        hp, c_up, kw = call['hp'], call['c_up'], call['kw']
        B, T = c_up.shape[:2]
        if (B, T) != (1, hp.max_time_steps) or kw.get('seed') is None \
                or kw.get('y_eval') is None or call['g_cond'] is not None:
            fail(f'the big-vocab trainer\'s eval launch {i} was B={B}, T={T}, {sorted(kw)}')
        ids, nll = wavenet_ar.generate_ar(call['weights'], c_up, call['noise'], hp, **kw)
        if not (torch.equal(ids, call['audio']) and torch.equal(nll, call['second'])):
            fail(f'a launch on the inputs of the big-vocab trainer\'s eval launch {i} does '
                 'not repeat its ids and NLL')
    bounds = BIG_BOUNDS[:2] + (T,)
    what = f'{wavenet_ar.variant(hp, nll=True)}, sampled, B=1, on the inputs of the ' \
           'trainer\'s last eval launch'
    r = big_vocab_vs_plain(hp, call['weights'], c_up, kw['y_eval'], bounds, seed=kw['seed'])
    if not (torch.equal(r['ids'], call['audio']) and torch.equal(r['nll'], call['second'])):
        fail(f'{what}: the check\'s launch does not repeat the trainer\'s ids and NLL')
    _judge_big(what, r, bounds, EVAL_NLL_TOL_PER_SPAN * max(1.0, r['nll_span']),
               EVAL_STATE_TOL_PER_SPAN * max(1.0, r['state_span']))
    bound_ms, bound_by = ar_bound(hp, call['weights'], B, T, False, nll=True)
    phase(10, f'{what}: bound {bound_ms:.3f} ms by {bound_by}')
    return dict(nll_err=r['nll_err'], ids_off=r['ids_off'], state_err=r['state_err'],
                nll_span=r['nll_span'], state_span=r['state_span'], steps=T, ms=r['ms'], plain_ms=r['plain_ms'], bound_ms=bound_ms,
                bound_by=bound_by, distinct=r['distinct'], nll_mean=r['nll_mean'])


def trainer_default(tmp):
    """Phase 10: the trainer at the default hparams and full width (see the module
    docstring). Returns the readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.data.wavenet_loader import WaveNetDataset
    from tacotron2_tpu_torch.training import checkpoint_select
    from tacotron2_tpu_torch.training import wavenet_trainer as wt
    from tacotron2_tpu_torch.training.checkpointing import CheckpointManager

    extra = 'wavenet_natural_eval=True,wavenet_ema_decay=0.5'
    hp = default_hparams()
    hp.parse(extra)
    root = os.path.join(tmp, 'default')
    os.makedirs(root)
    meta = make_corpus(root, hp, TRAIN_UTTERANCES, seed=10)
    first = run_trainer(root, meta, 'a', extra, 6, 4, 6, restore=False, path=TRAIN_PATH)
    again = run_trainer(root, meta, 'b', extra, 6, 4, 6, restore=False)
    losses = [first['steps'][i][1] for i in range(1, 7)]
    losses_again = [again['steps'][i][1] for i in range(1, 7)]
    drift = max(abs(a - b) for a, b in zip(losses, losses_again))
    gib = first['peak_bytes'] / 2 ** 30
    history = _check_history('train (defaults)', first['save_dir'], [4])
    rec = history[0]
    phase(10, f'train --model WaveNet, default hparams (batch {hp.wavenet_batch_size} x '
              f'{hp.max_time_steps} samples, {TRAIN_UTTERANCES} utterances): 6 steps in '
              f'{first["seconds"]:.1f} s of wall with one eval and one checkpoint; losses '
              f'{losses}; the same run again from the same seed differs by at most '
              f'{drift:.2e} (losses logged to 5 places); steps 3 to 6 '
              f'{np.mean([first["steps"][i][0] for i in range(3, 7)]):.3f} sec/step; peak '
              f'device memory {gib:.2f} GiB; the eval at step 4: AR launches '
              f'{first["launches"]}, {rec["gen_samples_per_sec"]:.0f} samples/s, natural loss '
              f'{rec["natural_loss"]:.4f}, teacher-forced loss {rec["teacher_forced_loss"]:.4f}, '
              f'ar_conditioning_r {rec.get("ar_conditioning_r")}')
    if not all(np.isfinite(l) for l in losses) or sorted(first['steps']) != list(range(1, 7)):
        fail(f'the trainer\'s losses are not finite or a step is missing: {first["steps"]}')
    if not drift <= 1e-3:
        fail(f'two runs from the same seed differ by {drift} in a loss')
    if first['launches'] != {'gaussian-fused': 1}:
        fail(f'the eval should launch gaussian-fused once, got {first["launches"]}')
    if 'Eval (natural) loss' not in first['out'] or '(in-kernel)' in first['out']:
        fail('the default trainer\'s eval did not score the launch\'s params')
    if 'ar_conditioning_r' not in rec:  # 40 frames of a time-varying mel: never skipped
        fail('the eval did not record the conditioning correlation')
    if CheckpointManager(first['save_dir']).all_steps() != [6]:
        fail('the trainer did not write its checkpoint at step 6')
    eval_launch = eval_launch_vs_plain(first['calls'][0])

    # a record past the checkpoint, as a run that died after an eval would leave it
    checkpoint_select.append_eval_record(first['save_dir'],
                                         dict(step=7, teacher_forced_loss=0.0))
    resumed = run_trainer(root, meta, 'a', extra, 8, 4, 6, path=TRAIN_PATH)
    history = _check_history('train (resumed)', first['save_dir'], [4, 8])
    # step 7 in process: the checkpoint of step 6, the first batch of a fresh iterator,
    # dropout masks from a generator seeded as the trainer seeds it
    state = wt.create_train_state(hp, 'cuda')
    state.load_state_dict(CheckpointManager(first['save_dir']).restore(6))
    dataset = WaveNetDataset(meta, hp, base_dir=root)
    batch = wt.to_device(next(dataset.train_batches(seed=hp.wavenet_data_random_state)), 'cuda')
    generator = torch.Generator('cuda').manual_seed(hp.wavenet_random_seed)
    loss7 = wt.train_step(state, batch, hp, generator)['loss'].item()
    logged7 = resumed['steps'][7][1]
    phase(10, f'resumed from step 6 to 8 in {resumed["seconds"]:.1f} s: restored: '
              f'{"Restored WaveNet checkpoint at step 6" in resumed["out"]}, dropped the '
              f'planted record of step 7: '
              f'{"Dropped 1 eval records past the restored step" in resumed["out"]}; sidecar '
              f'steps {[r["step"] for r in history]}; AR launches {resumed["launches"]}; step '
              f'7 logged loss {logged7:.5f}, an in-process train_step from the checkpoint on '
              f'the same batch {loss7:.5f}')
    if 'Restored WaveNet checkpoint at step 6' not in resumed['out'] \
            or 'Dropped 1 eval records past the restored step' not in resumed['out'] \
            or sorted(resumed['steps']) != [7, 8]:
        fail('the rerun did not restore step 6, drop the later record and step to 8')
    if resumed['launches'] != {'gaussian-fused': 1}:
        fail(f'the resumed run\'s eval should launch gaussian-fused once: {resumed["launches"]}')
    if not abs(loss7 - logged7) <= 1e-4:
        fail(f'step 7 of the resumed run logged {logged7}, an in-process step gives {loss7}')
    if CheckpointManager(first['save_dir']).all_steps() != [6, 8]:
        fail('the resumed run did not write its checkpoint at step 8')
    return dict(launches=first['launches']['gaussian-fused']
                + resumed['launches']['gaussian-fused'],
                sec_step=float(np.mean([first['steps'][i][0] for i in range(3, 7)])),
                peak_gib=gib, eval_samples_s=rec['gen_samples_per_sec'], losses=losses,
                rerun_drift=drift, eval_launch=eval_launch)


def trainer_big_vocab(tmp):
    """Phase 10: the trainer on a Q = 65,536 model with weight normalization (see the
    module docstring). Returns the readings."""
    from tacotron2_tpu_torch.config import default_hparams

    extra = (f'{BIG_VOCAB},{BIG_TRAIN},wavenet_weight_normalization=True,'
             'wavenet_natural_eval=True,wavenet_ema_decay=0.5')
    hp = default_hparams()
    hp.parse(extra)
    root = os.path.join(tmp, 'big')
    os.makedirs(root)
    meta = make_corpus(root, hp, 8, seed=11)
    run = run_trainer(root, meta, 'q', extra, 4, 2, 4, restore=False, path=BIG_TRAIN_PATH)
    history = _check_history('train (Q=65,536)', run['save_dir'], [2, 4])
    losses = [run['steps'][i][1] for i in sorted(run['steps'])]
    gib = run['peak_bytes'] / 2 ** 30
    phase(10, f'train --model WaveNet on a Q={hp.out_channels} model with weight '
              f'normalization, cut to {BIG_TRAIN} (the defaults\' 8 x 11,000 samples would '
              f'need 23 GB for the f32 logits alone; widths and depth as they are): 4 steps '
              f'in {run["seconds"]:.1f} s of wall with two evals; losses {losses}; steps 3 to 4 '
              f'{np.mean([run["steps"][i][0] for i in (3, 4)]):.3f} sec/step; peak device '
              f'memory {gib:.2f} GiB; AR launches {run["launches"]}; evals: ' + '; '.join(
                  f'step {r["step"]} natural loss {r["natural_loss"]:.4f} (in-kernel), '
                  f'teacher-forced {r["teacher_forced_loss"]:.4f}, '
                  f'{r["gen_samples_per_sec"]:.0f} samples/s' for r in history))
    if not all(np.isfinite(l) for l in losses) or sorted(run['steps']) != [1, 2, 3, 4]:
        fail(f'the big-vocab trainer\'s losses are not finite or a step is missing: {losses}')
    if run['launches'] != {'categorical_big-fused+nll': 2}:
        fail(f'each eval should launch categorical_big-fused+nll once, got {run["launches"]}')
    if run['out'].count('(in-kernel)') != 2 \
            or 'Running weight-norm data-dependent initialization' not in run['out']:
        fail('the big-vocab trainer did not run the data-dependent init or score in the kernel')
    eval_launch = big_eval_launch_vs_plain(run['calls'])
    return dict(launches=run['launches']['categorical_big-fused+nll'],
                sec_step=float(np.mean([run['steps'][i][0] for i in (3, 4)])), peak_gib=gib,
                eval_samples_s=history[-1]['gen_samples_per_sec'], losses=losses,
                eval_launch=eval_launch)


def training_slice(mutants, gen):
    """Phase 10 (see the module docstring). Returns the readings for the kernels line."""
    head = big_vocab_head(mutants, gen)
    with tempfile.TemporaryDirectory(prefix='t2torch_train_') as tmp:
        default = trainer_default(tmp)
        big = trainer_big_vocab(tmp)
    return dict(head=head, default=default, big=big)


# --- phase 11: the probes (B12, B9, B10, B11) ---------------------------------------------

# changes of csrc/probes/*.cu, one planted fault a probe kernel, each built beside the
# probes' library in phase 2: file, the line as it stands there once, the line changed
PROBE_MUTANTS = {
    'prng_probe: the last id taken on a tie': (
        'prng_probe.cu', '  return v > bv || (v == bv && id < bid);\n',
        '  return v > bv || (v == bv && id > bid);\n'),
    'ar_critpath: a tap slot off by one': (
        'ar_critpath.cu', '  return (t + win - m) % win;\n',
        '  return (t + win - m + 1) % win;\n'),
    'matmul_probe: the dependency dropped': (
        'matmul_probe.cu', '        xn[(size_t)r * IN1 + c] = __float2bfloat16(v);\n',
        '        xn[(size_t)r * IN1 + c] = xc[(size_t)r * IN1 + c];\n'),
    'microbench: the alignment not accumulated into the state': (
        'microbench.cu',
        '      if (a.variant == ATT && tid < TPC) st[64 + t0 + tid] = st[64 + t0 + tid] + '
        'AL[t0 + tid];\n',
        '      if (a.variant == ATT && tid < TPC) st[64 + t0 + tid] = st[64 + t0 + tid];\n'),
    'microbench: the last k-tile of the ctx rows dropped': (
        'microbench.cu', '    mma_tiles(d1, X, LDX, 0, W1C, CK, mt, q, lane);\n',
        '    mma_tiles(d1, X, LDX, 0, W1C, CK - 1, mt, q, lane);\n')}
# steps a launch of each probe here (the CLIs run the scripts' 2,048 / 512 / 512)
PROBE_STEPS = {'ar_critpath': 64, 'matmul_probe': 16, 'microbench': 16}
# kernel against plain version, max abs error over the plain version's max |value|:
# B9's output is of order 1e-5 and B11's 1e-2, so an absolute bound would pass zeros.
# The bf16 roundings of the kernel and of torch's ops agree but where an f32 sum in
# another order lands on the other side of a bf16 step (3.9e-3 of a value)
PROBE_TOL = {'ar_critpath': 1e-2, 'matmul_probe': 1e-2, 'microbench': 2e-2}
# B10's whole f32 product of a first step (a bf16 step for dep_bf16, whose product is
# bf16); after 16 steps x may differ by a bf16 step, and the product by PROBE_TOL
PRODUCT_TOL = 1e-5
STATE_TOL = 1e-5    # B11's accumulated alignments (sums of f32 softmaxes)
GUMBEL_STATS_TOL = 1e-5
EULER_GAMMA = 0.5772156649  # the Gumbel mean
GUMBEL_MEAN_TOL = 0.01
# B12 on random scores: a row's id may differ only where its top two scores are this close
TIE_GAP = 1e-6
PROBE_REPS = 5
PROBE_REPLACES = {'prng_probe': 'scripts/dev_prng_probe.py:32',
                  'ar_critpath': 'scripts/dev_pallas_ar_critpath.py:197',
                  'matmul_probe': 'scripts/dev_pallas_matmul_probe.py:72',
                  'microbench': 'scripts/dev_pallas_microbench.py:99'}


def mutated_probe_source(fault):
    """(file name, text) of csrc/probes/<file> with the one change of PROBE_MUTANTS[fault]."""
    from tacotron2_tpu_torch.ops import _build

    name, old, new = PROBE_MUTANTS[fault]
    with open(os.path.join(_build.PROBES_DIR, name), encoding='utf-8') as f:
        text = f.read()
    if text.count(old) != 1:
        raise ValueError(f'the line that {fault!r} changes stands {text.count(old)} times '
                         f'in csrc/probes/{name}: bring PROBE_MUTANTS up to date')
    return name, text.replace(old, new)


def rel_err(got, want):
    """max |got - want| over max |want|; fails where want is all zeros."""
    want = want.double()
    scale = want.abs().max().item()
    if scale == 0:
        fail('a probe\'s plain output is all zeros: its check would pass a kernel that does '
             'nothing')
    return (got.double() - want).abs().max().item() / scale


def probe_prng(mutants):
    """Phase 11, B12: ids and Gumbel stats against the plain version at B=8, Q=65,536 on
    the planted scores and on random ones, the Gumbel mean, the forced tie and its fault,
    times at B = 8, 1, 2."""
    from tacotron2_tpu_torch.probes import best_ms, prng_probe as m

    dev, v = torch.device('cuda'), m.VARIANTS[0]
    inp = m.make_inputs(device=dev)
    (ids, stats), (pids, pstats) = [x.clone() for x in m.kernel(v, inp)], m.plain(v, inp)
    again = m.kernel(v, inp)
    twice = torch.equal(ids, again[0]) and torch.equal(stats, again[1])
    stats_err = (stats - pstats).abs().max().item()
    mean = stats[0, 0].item()
    if not torch.equal(ids, pids) or stats_err > GUMBEL_STATS_TOL \
            or abs(mean - EULER_GAMMA) > GUMBEL_MEAN_TOL or not twice:
        fail(f'prng_probe: ids {ids.ravel().tolist()} against {pids.ravel().tolist()}, stats '
             f'{stats_err:.3e} off (tol {GUMBEL_STATS_TOL}), Gumbel mean {mean:.5f}, the '
             f'same bits twice: {twice}')
    rnd = m.make_inputs(seed=1, random_scores=True, device=dev)
    rids, _ = m.kernel(v, rnd)
    prids, _ = m.plain(v, rnd)
    noised = rnd['scores'] + m.gumbel_from_bits(m.philox_bits(rnd['seed'], m.B, 0, m.Q, dev))
    top2 = noised.topk(2, dim=1).values
    off = (rids != prids).ravel().nonzero().ravel().tolist()
    if len(off) > 1 or any(top2[r, 0] - top2[r, 1] > TIE_GAP for r in off):
        fail(f'prng_probe on random scores: rows {off} differ (gaps '
             f'{[float(top2[r, 0] - top2[r, 1]) for r in off]})')
    # a forced tie: classes 5 and 9 at 1e30 in every row (the noise does not move them)
    tie = dict(inp, scores=torch.zeros_like(inp['scores']))
    tie['scores'][:, [5, 9]] = 1e30
    tie_ids, _ = m.kernel(v, tie)
    fault = 'prng_probe: the last id taken on a tie'
    fault_ids, _ = m.kernel(v, tie, library=mutants[fault])
    if not (tie_ids == 5).all() or torch.equal(fault_ids, m.plain(v, tie)[0]):
        fail(f'prng_probe tie: ids {tie_ids.ravel().tolist()}, the fault {fault!r} gave '
             f'{fault_ids.ravel().tolist()}')
    times = {}
    for b in (8, 1, 2):
        bi = m.make_inputs(B=b, device=dev)
        if b != 8 and not torch.equal(m.kernel(v, bi)[0], m.plain(v, bi)[0]):
            fail(f'prng_probe at B={b}: the ids are not the plain version\'s')
        times[b] = dict(ms=m.call_ms(v, bi, PROBE_REPS),
                        graph_ms=m.graph_call_ms(v, bi, PROBE_REPS),
                        plain_ms=best_ms(lambda: m.plain(v, bi), PROBE_REPS),
                        bound_ms=m.bound(v, dict(B=b))[0], cluster=m.cluster_of(b))
    bound_ms, bound_by = m.bound(v, dict(B=m.B))
    phase(11, f'prng_probe (B12), B=8, Q={m.Q}: ids exact, stats {stats_err:.3e} (tol '
              f'{GUMBEL_STATS_TOL}), Gumbel mean {mean:.5f}; random scores: rows {off} differ; '
              f'the same bits twice; forced tie: ids 5, the fault {fault!r} ids '
              f'{fault_ids.ravel().tolist()[:2]}; '
              'us a call (kernel / as a CUDA graph / plain / bound): ' + ', '.join(
                  f'B={b} {1e3 * t["ms"]:.2f} / {1e3 * t["graph_ms"]:.2f} / '
                  f'{1e3 * t["plain_ms"]:.1f} / '
                  f'{1e3 * t["bound_ms"]:.3f} ({t["cluster"]} CTAs a row)'
                  for b, t in times.items()))
    return dict(max_abs_err=stats_err, ms=times[8]['ms'], graph_ms=times[8]['graph_ms'],
                plain_ms=times[8]['plain_ms'],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, by_batch=times,
                random_rows_off=off, fault_ids=fault_ids.ravel().tolist())


def _kernel_ms(m, v, inputs, steps, **kw):
    """One launch of `steps` steps of probe `m`'s kernel, the best of PROBE_REPS after a
    warm-up, in ms (CUDA events)."""
    from tacotron2_tpu_torch.probes import best_ms

    return best_ms(lambda: m.kernel(v, inputs, steps, **kw), PROBE_REPS)


def _probe_line(name, tag, steps, tol, rows, fault, seen):
    phase(11, f'{name} ({tag}), {steps} steps, error / tol {tol} (relative to the plain '
              'version\'s max |value|), us/step kernel / plain / bound: ' + '; '.join(
                  f'{v} {r["err"]:.3e} {1e3 * r["ms"] / steps:.2f} / '
                  f'{1e3 * r["plain_ms"] / steps:.1f} / {1e3 * r["bound_ms"] / steps:.4f}'
                  for v, r in rows.items()) + f'; the fault {fault!r}: {seen}')


def _probe_entry(rows, name, steps, library_ms=None):
    """The kernels-line readings of a probe of several variants: the first variant's times
    and bound at the top, every variant's under `variants`."""
    first = rows[next(iter(rows))]
    return dict(max_abs_err=max(r['abs_err'] for r in rows.values()),
                max_rel_err=max(r['err'] for r in rows.values()), ms=first['ms'],
                plain_ms=first['plain_ms'], bound_ms=first['bound_ms'],
                bound_by=first['bound_by'], library_ms=library_ms, steps=steps,
                variants=rows)


def probe_critpath(mutants):
    """Phase 11, B9: the six variants against the plain version at full width over
    PROBE_STEPS steps (every ring up to 64 slots wraps), and the tap-slot fault on both
    chains."""
    from tacotron2_tpu_torch.probes import ar_critpath as m

    name, steps = 'ar_critpath', PROBE_STEPS['ar_critpath']
    inp = m.make_inputs(device=torch.device('cuda'))
    rows = {}
    for v in m.VARIANTS:
        got = m.kernel(v, inp, steps).clone()
        twice = torch.equal(got, m.kernel(v, inp, steps))
        want, plain_ms = cuda_ms(lambda: m.plain(v, inp, steps))
        err = rel_err(got, want)
        if err > PROBE_TOL[name] or not twice:
            fail(f'{name} {v}: {err:.3e} beyond {PROBE_TOL[name]}, or not the same bits '
                 f'twice ({twice})')
        ms = _kernel_ms(m, v, inp, steps)
        bound_ms, bound_by = m.bound(v, m.dims_of(inp), steps)
        rows[v] = dict(err=err, abs_err=(got - want).abs().max().item(), ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    fault = 'ar_critpath: a tap slot off by one'
    seen = {v: rel_err(m.kernel(v, inp, steps, library=mutants[fault]), m.plain(v, inp, steps))
            for v in ('base', 'fused')}
    if min(seen.values()) <= PROBE_TOL[name]:
        fail(f'{name}: the fault {fault!r} was not seen: {seen}')
    _probe_line(name, 'B9', steps, PROBE_TOL[name], rows, fault,
                {v: f'{e:.3e}' for v, e in seen.items()})
    return dict(_probe_entry(rows, name, steps), fault_readings=seen)


def probe_matmul(mutants):
    """Phase 11, B10: the seven variants against the plain version at full width over
    PROBE_STEPS steps, the output and the last step's whole product, the library's
    torch.matmul of the same product, and the fault that drops the dependency."""
    from tacotron2_tpu_torch.probes import matmul_probe as m

    name, steps = 'matmul_probe', PROBE_STEPS['matmul_probe']
    inp = m.make_inputs(device=torch.device('cuda'))
    rows = {}
    for v in m.VARIANTS:
        (got, prod), ((want, want_prod), plain_ms) = (m.kernel(v, inp, steps),
                                                      cuda_ms(lambda: m.plain(v, inp, steps)))
        err, prod_err = rel_err(got, want), rel_err(prod, want_prod)
        # the whole product of step 1, before x can differ by a bf16 step
        first_err = rel_err(m.kernel(v, inp, 1)[1], m.plain(v, inp, 1)[1])
        first_tol = PROBE_TOL[name] if v == 'dep_bf16' else PRODUCT_TOL
        if err > PROBE_TOL[name] or prod_err > PROBE_TOL[name] or first_err > first_tol:
            fail(f'{name} {v}: output {err:.3e}, last product {prod_err:.3e} (tol '
                 f'{PROBE_TOL[name]}), first product {first_err:.3e} (tol {first_tol})')
        ms = _kernel_ms(m, v, inp, steps)
        bound_ms, bound_by = m.bound(v, {}, steps)
        rows[v] = dict(err=err, product_err=prod_err, first_product_err=first_err,
                       abs_err=(got - want).abs().max().item(),
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
    fault = 'matmul_probe: the dependency dropped'
    seen = rel_err(m.kernel('dep_f32', inp, steps, library=mutants[fault])[0],
                   m.plain('dep_f32', inp, steps)[0])
    if seen <= PROBE_TOL[name]:
        fail(f'{name}: the fault {fault!r} was not seen: {seen:.3e}')
    library_ms = m.library_ms(inp, steps, reps=PROBE_REPS)
    _probe_line(name, 'B10', steps, PROBE_TOL[name], rows, fault, f'{seen:.3e} on dep_f32')
    phase(11, f'{name}: library, torch.matmul of the same bf16 product, '
              f'{1e3 * library_ms / steps:.2f} us/step')
    return dict(_probe_entry(rows, name, steps, library_ms), fault_readings={'dep_f32': seen})


def probe_microbench(mutants):
    """Phase 11, B11: the three variants against the plain version at full width over
    PROBE_STEPS steps, `lstm` from a seeded nonzero state (from zeros it stays at zero):
    h2, both cells and for `att` the accumulated alignments; the plain version's step as a
    CUDA graph beside them (`graph_ms`, held to the plain version too); then the faults
    that drop the accumulation and a k-tile of the tensor-core product."""
    from tacotron2_tpu_torch.probes import microbench as m

    name, steps = 'microbench', PROBE_STEPS['microbench']
    inp = m.make_inputs(device=torch.device('cuda'))
    rows = {}
    for v in m.VARIANTS:
        start = m.random_state(inp) if v == 'lstm' else None
        (got, fin), ((want, pfin), plain_ms) = (
            m.kernel(v, inp, steps, start=start),
            cuda_ms(lambda: m.plain(v, inp, steps, start=start)))
        err = rel_err(got, want)
        cells = max(rel_err(fin[k].float(), pfin[k].float()) for k in ('c1', 'c2'))
        state = rel_err(fin['state'], pfin['state']) if v == 'att' else 0.0
        if err > PROBE_TOL[name] or cells > PROBE_TOL[name] or state > STATE_TOL:
            fail(f'{name} {v}: h2 {err:.3e}, cells {cells:.3e} (tol {PROBE_TOL[name]}), '
                 f'state {state:.3e} (tol {STATE_TOL})')
        ms = _kernel_ms(m, v, inp, steps, start=start)
        graph_h2, _, graph_ms = m.graph(v, inp, steps, start=start, reps=PROBE_REPS)
        graph_err = rel_err(graph_h2, want)
        if graph_err > PROBE_TOL[name]:
            fail(f'{name} {v}: the plain step as a CUDA graph differs by {graph_err:.3e}')
        bound_ms, bound_by = m.bound(v, {}, steps)
        rows[v] = dict(err=err, cells_err=cells, state_err=state,
                       abs_err=(got - want).abs().max().item(), ms=ms, plain_ms=plain_ms,
                       graph_ms=graph_ms, graph_us_step=1e3 * graph_ms / steps,
                       graph_err=graph_err,
                       bound_ms=bound_ms, bound_by=bound_by)
    fault = 'microbench: the alignment not accumulated into the state'
    _, fin = m.kernel('att', inp, steps, library=mutants[fault])
    seen = rel_err(fin['state'], m.plain('att', inp, steps)[1]['state'])
    if seen <= STATE_TOL:
        fail(f'{name}: the fault {fault!r} was not seen: {seen:.3e}')
    k_fault = 'microbench: the last k-tile of the ctx rows dropped'
    start = m.random_state(inp)
    k_seen = rel_err(m.kernel('lstm', inp, steps, start=start, library=mutants[k_fault])[0],
                     m.plain('lstm', inp, steps, start=start)[0])
    if k_seen <= PROBE_TOL[name]:
        fail(f'{name}: the fault {k_fault!r} was not seen: {k_seen:.3e}')
    _probe_line(name, 'B11', steps, PROBE_TOL[name], rows, fault,
                f'state {seen:.3e} on att (tol {STATE_TOL}); the fault {k_fault!r}: h2 '
                f'{k_seen:.3e} on lstm (tol {PROBE_TOL[name]})')
    phase(11, f'{name}: the plain step as a CUDA graph, us/step: ' + ', '.join(
        f'{v} {1e3 * r["graph_ms"] / steps:.2f}' for v, r in rows.items()))
    return dict(_probe_entry(rows, name, steps), graph_ms=rows['lstm']['graph_ms'],
                graph_us_step=rows['lstm']['graph_us_step'],
                fault_readings={'att': seen, 'lstm': k_seen})


def probes(mutants):
    """Phase 11 (see the module docstring). Returns the readings for the kernels line."""
    return dict(prng_probe=probe_prng(mutants), ar_critpath=probe_critpath(mutants),
                matmul_probe=probe_matmul(mutants), microbench=probe_microbench(mutants))


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail('torch finds no CUDA device')
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.models.wavenet.model import WaveNet
    from tacotron2_tpu_torch.ops import _build, wavenet_ar
    from tacotron2_tpu_torch.probes import ar_critpath, matmul_probe, microbench, prng_probe
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
    phase(2, f'built and loaded the CUDA kernels and the probes\' kernels, and '
             f'{len(mutants)} copies with one planted fault each, in '
             f'{time.perf_counter() - t0:.1f} s')
    probe_modules = {'prng_probe': prng_probe, 'ar_critpath': ar_critpath,
                     'matmul_probe': matmul_probe, 'microbench': microbench}
    for module in probe_modules.values():
        module.LAUNCHES = 0  # no main path launches a probe: read after phase 10

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
    clusters = cluster_sweep(weights, model, hp, gen)
    cluster_seen = cluster_faults(weights, model, hp, gen, mutants)
    pairs = pair_check(weights, model, hp, gen)
    sweep = batch_sweep(weights, model, hp, gen, 3)
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
    t10 = time.perf_counter()
    training = training_slice(mutants, gen)
    phase(10, f'phase 10 took {time.perf_counter() - t10:.1f} s; the whole run '
              f'{time.perf_counter() - t_start:.1f} s')
    probe_launches = {k: module.LAUNCHES for k, module in probe_modules.items()}
    t11 = time.perf_counter()
    probe_readings = probes(mutants)
    phase(11, f'phase 11 took {time.perf_counter() - t11:.1f} s; the whole run '
              f'{time.perf_counter() - t_start:.1f} s')
    bound_ms, bound_by = ar_bound(hp, weights, MAIN_BATCH, kernel['steps'])
    head, small = training['head'], training['head']['small']
    big_runs, sampled = head['runs'], head['sampled']
    big_eval = training['big']['eval_launch']
    source = 'tacotron2_tpu_torch/csrc/wavenet_ar.cu'
    replaces = 'tacotron2_tpu/ops/pallas/wavenet_ar.py:684'

    # launches: the main paths' runs, each counted from 0 (the batch CLI, phase 5, and
    # the service, phase 7, at the default profile; both again with --paper_profile,
    # phase 8; the standalone vocoder on a five-speaker and on a mu-law-quantized WaveNet,
    # phase 9); the checks' launches are listed apart; launches_by_cluster counts each
    # main path's launches by the cluster size they ran on, and cluster (mol_cluster at
    # the paper width) lists those sizes. max_abs_err, ms, plain_ms and
    # bound_ms are the default profile's (the times and the bound those of B=2 over the
    # PLAIN_STEPS steps that the plain version followed, phase 3; full_ms the batch
    # path's whole launch of full_steps steps); the mol_ keys are the paper width's (the
    # times and the bound those of its B=2 run over the mol_steps steps that the plain
    # version followed, mol_full_ms its whole launch of 8,800, phase 8); the vocoder_ keys
    # are phase 9's, by
    # instantiation and batch (errors and us/step over vocoder_steps steps: the two that
    # the entry point launches over the first 2,200 of its 8,800; the bounds are those of
    # the two entry-point launches).
    # the train_eval_ keys are the default trainer's eval launch against the plain
    # version on its own inputs (phase 10).
    # No single PyTorch call computes the AR loop: library_ms is null. The second entry
    # is the big-vocab head with the NLL flag (the instantiation the Q = 65,536 trainer's
    # eval launches): max_abs_err is its NLL's against the plain version (it returns no
    # params), and it, the times and the bound are those of the trainer's last eval
    # launch run again on its own inputs (B=1 over the crop's 2,750 steps); the b2_ keys
    # and the dicts by run are phase 10's runs on seeded inputs at B=2. No entry point
    # launches the NLL flag on the small head, so it has no entry of its own: its check
    # (against log_softmax of a second launch's params) is under the small_head_ keys
    # here, with small_head_nll_library_ms, `cross_entropy` on those materialised
    # params: the one library call that computes the NLL alone, not the loop.
    print(json.dumps({'kernels': [dict(
        name='wavenet_ar', route='cuda', source=source, replaces=replaces,
        variants=['gaussian-fresh', 'gaussian-streamed', 'mol-fresh', 'mol-streamed',
                  'gaussian-plain', 'categorical-fused', 'categorical-plain',
                  'gaussian-fused+g'],
        launches=launches_batch + launches_serve + paper['batch_launches']
        + paper['serve_launches'] + vocoder['speakers_launches']
        + vocoder['categorical_launches'] + training['default']['launches'],
        launches_by_path={'synthesize': launches_batch, 'serve': launches_serve,
                          TRAIN_PATH: training['default']['launches'],
                          'synthesize --paper_profile': paper['batch_launches'],
                          'serve --paper_profile': paper['serve_launches'],
                          VOCODER_SPEAKERS_PATH: vocoder['speakers_launches'],
                          VOCODER_CATEGORICAL_PATH: vocoder['categorical_launches'],
                          'vocoder_checks': vocoder['check_launches'],
                          'state_carry_check': streamed['launches'],
                          'mol_state_carry_check': paper['carry_launches']},
        max_abs_err=max(kernel['max_abs_err'], wide['max_abs_err'],
                        streamed['max_abs_err'],
                        training['default']['eval_launch']['max_abs_err']),
        ms=kernel['ms'], plain_ms=kernel['plain_ms'], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, steps=kernel['steps'], full_ms=kernel['full_ms'],
        full_steps=frames * hp.get_hop_size(),
        cluster=path_clusters(*AR_PATHS), mol_cluster=path_clusters(*PAPER_PATHS),
        occupancy=clusters['occupancy'],
        launches_by_cluster={p: cluster_counts(p) for p in AR_PATHS + PAPER_PATHS},
        launches_by_layout={p: layout_counts(p) for p in AR_PATHS + PAPER_PATHS},
        pair_check=pairs,
        cluster_check_max_abs_err=clusters['max_abs_err'],
        cluster_check_us_step=clusters['us_step_by_cluster'],
        cluster_check_first_steps=clusters['first_steps_by_cluster'],
        cluster_fault_readings=cluster_seen,
        batch_sweep=sweep, mol_batch_sweep=paper['sweep'],
        b20_ms=wide['ms'], b20_plain_ms=wide['plain_ms'],
        streamed_ms=streamed['ms'], streamed_plain_ms=streamed['plain_ms'],
        streamed_b1_ms=streamed['served_ms'], synthesize_us_step=batch_us,
        mol_max_abs_err=paper['max_abs_err'], mol_ms=paper['ms'],
        mol_plain_ms=paper['plain_ms'], mol_bound_ms=paper['bound_ms'],
        mol_bound_by=paper['bound_by'], mol_steps=paper['steps'],
        mol_full_ms=paper['full_ms'], mol_streamed_b1_ms=paper['streamed_b1_ms'],
        paper_synthesize_us_step=paper['batch_us_step'],
        paper_serve_us_step=paper['serve_us_step'],
        vocoder_max_abs_err=vocoder['max_abs_err'], vocoder_state_err=vocoder['state_err'],
        vocoder_steps=vocoder['steps'],
        vocoder_us_step=vocoder['us_step'], vocoder_plain_us_step=vocoder['plain_us_step'],
        vocoder_fault_readings=vocoder['faults'],
        vocoder_speakers_us_step=vocoder['speakers_us_step'],
        vocoder_categorical_us_step=vocoder['categorical_us_step'],
        vocoder_bound_ms=vocoder['bound_ms'], vocoder_bound_by=vocoder['bound_by'],
        train_sec_step=training['default']['sec_step'],
        train_peak_gib=training['default']['peak_gib'],
        train_eval_samples_s=training['default']['eval_samples_s'],
        train_rerun_loss_drift=training['default']['rerun_drift'],
        **{f'train_eval_{k}': v for k, v in training['default']['eval_launch'].items()}),
        dict(
        name='wavenet_ar[categorical_big-fused+nll]', route='cuda', source=source,
        replaces=replaces, launches=training['big']['launches'],
        launches_by_path={BIG_TRAIN_PATH: training['big']['launches'],
                          'big_vocab_checks': head['check_launches'],
                          'small_head_nll_checks': small['check_launches']},
        max_abs_err=big_eval['nll_err'], ms=big_eval['ms'], plain_ms=big_eval['plain_ms'],
        bound_ms=big_eval['bound_ms'], bound_by=big_eval['bound_by'], library_ms=None,
        steps=big_eval['steps'], cluster=path_clusters(BIG_TRAIN_PATH),
        launches_by_cluster={BIG_TRAIN_PATH: cluster_counts(BIG_TRAIN_PATH)},
        launches_by_layout={BIG_TRAIN_PATH: layout_counts(BIG_TRAIN_PATH)},
        ids_off_on_eval_inputs=big_eval['ids_off'],
        state_err_on_eval_inputs=big_eval['state_err'],
        nll_span_on_eval_inputs=big_eval['nll_span'],
        state_span_on_eval_inputs=big_eval['state_span'],
        b2_ms=sampled['ms'], b2_plain_ms=sampled['plain_ms'], b2_bound_ms=head['bound_ms'],
        b2_bound_by=head['bound_by'], b2_steps=BIG_BOUNDS[-1],
        nll_err={k: r['nll_err'] for k, r in big_runs.items()},
        ids_off={k: r['ids_off'] for k, r in big_runs.items()},
        state_err={k: r['state_err'] for k, r in big_runs.items()},
        run_steps={k: r['steps'] for k, r in big_runs.items()},
        us_step=head['us_step'], fault_readings=head['faults'],
        train_sec_step=training['big']['sec_step'], train_peak_gib=training['big']['peak_gib'],
        train_eval_samples_s=training['big']['eval_samples_s'],
        small_head_max_abs_err=small['max_abs_err'], small_head_ms=small['ms'],
        small_head_plain_ms=small['plain_ms'], small_head_bound_ms=small['bound_ms'],
        small_head_bound_by=small['bound_by'],
        small_head_nll_library_ms=small['library_ms'], small_head_steps=small['steps'],
        small_head_plain_max_abs_err=small['plain_err'],
        small_head_with_params_ms=small['with_params_ms'])] + [
        # the probes (phase 11): no entry point runs them, so no main path launches
        # them (launches, counted from 0 over phases 3-10); check_launches are phase 11's
        dict(name=name, route='cuda', source=f'tacotron2_tpu_torch/csrc/probes/{name}.cu',
             replaces=PROBE_REPLACES[name], launches=probe_launches[name],
             check_launches=probe_modules[name].LAUNCHES, **probe_readings[name])
        for name in probe_modules]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
