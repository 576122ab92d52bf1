#!/usr/bin/env python
"""Smoke run of the PyTorch port on one CUDA card: build, check, drive the main path.

    python3 chip_smoke.py

Phases (one line each; any failure exits nonzero):
  1. torch, CUDA and the card (nvidia-smi name and power limit);
  2. build the hand-written kernels from tacotron2_tpu_torch/csrc (the probes' from
     csrc/probes, the decoder step's from csrc/decoder, the decoder's forward and
     reverse loops' from csrc/decoder_loop and csrc/decoder_bwd_loop, the CBHG's GRU
     loops' from csrc/gru_loop and the encoder LSTM's loops' from csrc/lstm_loop into
     libraries of their own), with the planted-fault copies:
     the AR kernel's library first, the rest beside phase 3, all done before phase 4;
  3. the WaveNet AR kernel against its plain PyTorch version at the default width, on
     a WaveNet whose seeded random weights give params of order 1: the kernel runs
     free with its params, the plain version runs on the same CUDA tensors
     teacher-forced on the kernel's audio, and the params agree to max abs
     KERNEL_TOL; at B=8 over CHECK_FRAMES (10) mel frames, at the batch path's shape
     (B=2, 128 frames, 35,200 steps, through the real conditioning preparation and upsampler;
     here the plain version, its step replayed as a CUDA graph at 1.1 to 2.3 ms, follows
     the kernel over the first PLAIN_STEPS (8,800) steps only, in the state-carried
     chunks of one served request, SERVE_BOUNDS, and a second kernel launch over those
     steps, bit-identical to the start of the first, is the one timed beside it), and at
     B=20 over CHECK_FRAMES (the
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
     finite, and the AR kernel launched; then the encoder LSTM's ms inside one Tacotron
     synthesis of the two sentences (CUDA events around `encoder_lstm`) through the step
     loop and through lstm_fwd_loop, beside the Tacotron stage's (encoder_lstm_reading);
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
     three AR launches per request (chunks of 4,352 + 16,512 + 14,336 samples); then
     the encoder LSTM's reading of phase 5 at B=1;
  8. the paper profile (`config.paper_hparams()`: MoL-10 head, 24 layers in 4 stacks at
     R=256, G=512, S=256, the 2D upsampler, no legacy scalings) at full width on a
     WaveNet with seeded random weights whose head is quieted (quiet_mol_head) so that
     few samples clip: four planted MoL faults, each of which must miss (params beyond
     MOL_KERNEL_TOL or samples beyond SAMPLE_TOL of the MoL draw from the kernel's own
     params); the kernel against the plain version as in phase 3 at the paper batch
     path's shape (B=2, 8,800 steps; the plain version over the first
     PAPER_PLAIN_STEPS, all 8,800, in the paper service's chunks, PAPER_SERVE_BOUNDS, a
     second launch over those steps bit-identical to the first), its samples against the
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
     check as above over all of them too, in chunks ending at VOCODER_CLI_BOUNDS:
     bit-identical again, and the params within KERNEL_TOL of the plain version's (the
     reading over the first CUT_STEPS printed beside the whole one's).
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
     Q = 65,536), and the plain version follows in state-carried chunks at odd ends
     over all of them (the Gaussian one's chunks TRAIN_EVAL_BOUNDS, the reading over the
     first CUT_STEPS printed beside the whole one's). The trainers step in bf16, the
     card's default compute dtype (`training/common.resolve_compute_dtype`), the
     in-process step 7 as well; their eval launches run in f32.
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
 12. Tacotron training (`python -m tacotron2_tpu_torch.train --model Tacotron`) at the
     default hparams and full width (batch 32, outputs_per_step 1, the CBHG linear
     post-net), overriding only tacotron_test_size=None and tacotron_test_batches=1: a
     corpus of TACO_UTTERANCES utterances of 1-2 s made from a seed (mels and linear
     spectrograms of gliding tones by the port's ops/audio, texts from sentences.txt);
     6 steps with an eval at 4 (its Griffin-Lim wavs from mel and linear, on the
     device, finite) and a checkpoint at 6, all in bf16 (the card's default compute
     dtype), a rerun that restores and goes on to 8, whose step-7 loss must be an
     in-process train_step's (bf16 too) from the step-6 checkpoint; the
     log's step times (each from the start of a step to the start of the next, or to the
     read of its loss) must add up to no more than the run's wall; then, with the
     compute dtype pinned to f32: five more steps on the corpus, each between two
     synchronizes; one train step on the card against the
     same step on the CPU at full width and TACO_CPU_BATCH rows (the same state, batch,
     masks and coins; TACO_STEP_TOL, TACO_GRAD_TOL, TACO_PARAM_TOL, TACO_SMALL_GRAD; the
     card's step must launch the float32 reverse loop, decoder_bwd_loop_f32, the
     CBHG's GRU loops, gru_fwd_loop and gru_bwd_loop, and the encoder LSTM's,
     lstm_fwd_loop and lstm_bwd_loop);
     and steps at B=32 x TIMED_FRAMES frames: three between synchronizes (sec/step), peak
     device memory, and three split at module boundaries by CUDA events that hooks
     record inside the real step (`StepMarks`: the decoder's, the encoder LSTM's and the
     CBHG GRUs' forward and backward, those on the CBHG's BiGRU, which runs both
     directions), each reading the median of three with its range.
     With TACO_UTTERANCES / 2 utterances to train on and bucket_group_batches=64, the
     feeder's bucketing (the JAX one's) fills each batch of 32 with copies of one
     utterance. The card-vs-CPU step is followed by a second step on each device from its
     own state (Adam's moments now differ): the two devices' parameter displacements over
     both steps within TACO_PARAM2_TOL in relative L2. Then `train --model
     Tacotron` again in float32 at teacher forcing 0.5 (TACO_F32_SCHEDULED, 2 steps at
     B=8, no eval): its steps on their own last frame keep the step loop. The trainer's
     steps, eval and in-process steps run the fused decoder (`ops/decoder_vjp.py`): its
     kernels' launches in the two trainer runs are counted for TACO_PATH, those of the
     float32 run for TACO_F32_SCHEDULED_PATH, those of the timed f32 steps for
     TACO_F32_TIMED_PATH (phase 16 reads them), and so are the GRU loops' (phase 17); the
     timed steps' f32 decoder backward is
     printed beside its reading with the step loop's backward (F32_FWD_LOOP_TIMED).
 13. The Tacotron-2 pipeline at the default hparams and full width, through the port's
     entry points: PIPE_UTTERANCES wavs of 1-2 s made from a seed in the LJSpeech layout
     through `python -m tacotron2_tpu_torch.preprocess` (every row's audio exactly its
     mel frames x hop) and `python -m tacotron2_tpu_torch.wavenet_preprocess` (its
     validate_alignment on its own output); `python -m tacotron2_tpu_torch.train --model
     Tacotron-2` with 2 steps of each trainer and an eval at step 2 (PIPE_OVERRIDES: the
     test split and the natural eval alone): state_log `1|1|1|<map>`, a GTA mel for every
     train.txt row of its target's frame count inside the output range, the WaveNet
     trained on the GTA map with one natural eval; a rerun that returns at once; one GTA
     batch on the card against the CPU in f32 (PIPE_GTA_TOL); the eval launch, recorded by
     ar_timer, against the plain version on its own inputs over PIPE_EVAL_BOUNDS with
     PIPE_FAULTS planted (PIPE_EVAL_TOL_PER_SPAN); then the JAX command lines with run
     names only (`synthesize --model Tacotron --mode eval`, `--mode live` on one line of
     stdin, `--model WaveNet --mels_dir tacotron_output/eval`, `--model Tacotron-2`) at
     max_iters=PIPE_CLI_MAX_ITERS, stop tokens suppressed, their AR launches counted by
     path. Each step's wall seconds, the phase's and the whole run's. Both trainers step
     in bf16. The decoder kernels' and the GRU loops' launches of the pipeline's run are
     counted, its GTA synthesis's apart (PIPE_GTA_PATH) from the rest of its Tacotron phase
     (PIPE_TACO_PATH), and the GRU loops' of the Tacotron command lines (TACO_EVAL_CLI_PATH,
     TACO_LIVE_CLI_PATH).
 14. The JAX package's remaining configurations. bf16 training: one Tacotron
     train step at B=32 x TIMED_FRAMES and one WaveNet step at BF16_WAVENET_BATCH (8 x
     11,000), each in bf16 and in f32 on the card from the same seeded state, batch and
     draws (losses BF16_LOSS_TOL, gradients BF16_GRAD_TOL, all finite); a Tacotron bf16
     step whose decoder sums its weights' gradients over the steps in bf16
     (precast_fault) must miss BF16_GRAD_TOL; each step again on a batch cut for the
     CPU (BF16_TACO_CUT, BF16_WAVENET_CUT): each module of BF16_MODULES in the card's
     bf16 step (the Tacotron's with fused_decoder off, so that the decoder's modules
     run their forward) run again on the CPU in bf16 on the inputs it had, within
     BF16_MODULE_TOL of the card's output, printed beside the module's bf16-f32 gap, and
     a copy of the step with one module left in f32 (BF16_FAULTS) must miss that bound;
     the whole cut step on both devices is printed, not bound; the Tacotron's bf16
     sec/step, peak memory and StepMarks split (phase 12 reads the f32 ones; its GRU
     loops' launches counted for TACO_BF16_TIMED_PATH), the
     WaveNet's in both dtypes. The upsamplers: `synthesize --model WaveNet` on seeded mels with each of
     UPSAMPLERS (NearestNeighbor, 1D, Resize, 2D with LeakyRelu); the UPSAMPLER_FULL
     run's launch held to the plain version on its own inputs over its first
     UPSAMPLER_BOUNDS[-1] steps in state-carried chunks with the two planted state
     faults, the others' over UPSAMPLER_SHORT_BOUNDS[-1] steps in chunks (KERNEL_TOL);
     each upsampler's output on the card to its CPU output (UPSAMPLER_TOL). Depth 3
     (DEPTH3): one GTA batch card vs CPU (PIPE_GTA_TOL), one f32 train step card vs CPU
     at phase 12's tolerances, and one step at DEPTH3_REMAT with and without
     remat_decoder: the gradients within REMAT_TOL, beside the same step run twice;
     peak memory of each. The seconds of each part.
 15. Scale-out over torch.distributed (`tacotron2_tpu_torch/parallel/`), on the
     one card, its children started at once, each loading the library phase 2 built (a
     child that starts a build fails): a one-rank NCCL child on cuda:0, where the
     data-parallel WaveNet step at the default width (8 x 11,000, f32, TF32 off) is
     bit-identical to train_step without a mesh and generate_data_parallel at B=2 x
     8,800 to generate; a two-rank gloo job on cuda:0 (gloo because NCCL refuses two
     ranks on one card): (a) the data-parallel WaveNet and (b) Tacotron (B=32 at the
     default width, cut to SCALE_TACO_FRAMES = 128 frames) over SCALE_STEPS steps with
     ragged lengths against this process's one-process steps (SCALE_LOSS_TOL,
     SCALE_NORM_TOL on every step; the state after the first step at phase 12's
     card-vs-CPU bounds), (c) tensor parallelism over a model axis of 2 (128 of the 256
     gate channels a rank), one step on SCALE_TP_ROWS rows (SCALE_TP_LOSS_TOL, the
     state as (a) and (b)), (d) generate_data_parallel, one row
     a rank, each rank's launch bit-identical to this process's B=2 launch of that row
     where both run on one (N, P) layout, else within KERNEL_TOL, (e) two planted faults
     that must show: the normalizers counted per rank, the gathered rows swapped; and
     `python -m torch.distributed.run --standalone --nproc_per_node 2` of this script's
     `--rank-cli` (train.main, its AR launches counted) as `train --model WaveNet
     --dist_backend gloo --device cuda:0` on phase 10's corpus (the same seed): 2 steps,
     one checkpoint and rank 0's natural eval (one launch of 11,000 steps); rank 0's
     step-1 loss within SCALE_CLI_LOSS_TOL of phase 10's, only rank 0 writes. Two ranks
     time-slice one card: nothing here is a scaling measurement.
 16. The fused Tacotron decoder with its hand-written backward (`ops/decoder_vjp.py`,
     `FusedDecoderScan`), which the Tacotron trainer, the pipeline's Tacotron phase and
     GTA run at the default hparams. Each of the step's four kernels (csrc/decoder/
     decoder_step.cu: lstm_cell_fwd, lstm_cell_bwd, attention_fwd, attention_bwd) against
     its plain PyTorch version on the same CUDA tensors at the trainer's widths
     (DECODER_WIDTHS: B=32, U=1,024, D=128, T_in=100), in f32 and bf16, the LSTM cell with
     keep-gates and with zoneout's expectation, a ragged mask (DECODER_TOL, a bound a
     kernel and dtype, relative to the plain output's largest entry), each with its
     planted faults (DECODER_MUTANTS, built in phase 2; the LSTM cell's bf16 sigmoid
     rounded once among them) that must miss it; each kernel's and plain version's time
     (CUDA graphs) and its bound. fused_decoder_scan on the card against the autograd
     loop `ops/fused_decoder.decoder_scan` on the card, TF32 off, B=32 x FUSED_FRAMES
     frames with dropout and zoneout gates, in f32 at teacher forcing 1 and 0.5 and in
     bf16 at 0.5: the outputs and the gradients (relative L2) within FUSED_TOL, in bf16
     with a planted fault (the deferred weight gradients summed step by step in bf16,
     precast_fault) that must miss it; both decoders' ms a step, and the fused one's
     device busy time under torch.profiler. Phase 12's (f32) and phase 14's (bf16)
     timed steps at B=32 x TIMED_FRAMES and their StepMarks split beside the autograd
     decoder loop's (AUTOGRAD_TIMED) and the fused decoder's step loop's
     (STEP_LOOP_TIMED), and phase 13's GTA seconds an utterance beside the step loop's.
     The forward loop (csrc/decoder_loop/decoder_loop.cu, `decoder_fwd_loop`: all steps
     of the bf16 teacher-forced forward
     in one launch) against its plain version on the same CUDA tensors at the default
     width over LOOP_STEPS (512) steps, B=32 with keep-gates, B=32 with zoneout's
     expectation and a ragged mask, and B=1: the alignments, x2, the contexts and every
     residual over the first LOOP_FIRST_STEPS steps and over all (LOOP_TOL), six planted
     faults (LOOP_MUTANTS, built in phase 2) that must miss it, the launch without
     residuals bit for bit the one with them; the B=32 launch's ms beside its plain
     version's, the step loop's over the same steps and its bound. The reverse loop
     (csrc/decoder_bwd_loop/decoder_bwd_loop.cu, `decoder_bwd_loop`: all steps of the bf16
     teacher-forced backward in one launch) against its plain version on the same CUDA
     tensors in the same three cases, after the forward loop with its residuals and on
     seeded cotangents: dz1, dz2, dpq, dctx_total and df over the loop's first
     BWD_LOOP_FIRST_STEPS steps and over all, and the accumulators (BWD_LOOP_TOL), six
     planted faults (BWD_LOOP_MUTANTS, built in phase 2) that must miss it, two launches
     bit for bit; the B=32 launch's ms beside its plain version's, the step loop's whole
     backward over the same steps and its bound. The float32 forward loop
     (csrc/decoder_loop_f32/decoder_loop_f32.cu, `decoder_fwd_loop` at float32, counted as
     decoder_fwd_loop_f32: the products as 3xTF32, the location conv inside) against its
     plain version on the same CUDA tensors over LOOP_STEPS steps (F32_LOOP_CASES: B=32 and
     B=1 at T_in=100 with keep-gates and with zoneout's expectation, and B=32 at T_in=200
     with a ragged mask, past the bf16 fold): every output and residual over the first
     LOOP_FIRST_STEPS steps and over all (F32_LOOP_TOL), two launches bit for bit, six
     planted faults (F32_LOOP_MUTANTS, built in phase 2) that must miss it; the B=32
     launch's ms beside its plain version's, the f32 step loop's forward over the same
     steps and its bound, and the B=1 launch without residuals (GTA's). The float32
     reverse loop (csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu, `decoder_bwd_loop` at
     float32, counted as decoder_bwd_loop_f32: the gate products as 3xTF32, the location
     conv and its transpose inside) against its plain version on the same CUDA tensors
     over LOOP_STEPS steps after the float32 forward loop with its residuals, on seeded
     cotangents (F32_BWD_LOOP_CASES: B=32 with keep-gates and with zoneout's expectation
     and B=1 at T_in=100, B=32 at T_in=200 with a ragged mask): dz1, dz2, dpq, dctx_total
     and df over the loop's first BWD_LOOP_FIRST_STEPS steps and over all, and the
     accumulators (F32_BWD_LOOP_TOL), two launches bit for bit, six planted faults
     (F32_BWD_LOOP_MUTANTS, built in phase 2) that must miss it F32_BWD_FAULT_FACTOR times
     over; the B=32 and B=1 launches' ms and bounds, at B=32 beside its plain version's,
     the f32 step loop's whole backward and the kernel's over the same steps.
     fused_decoder_scan in bf16 and in f32 at teacher forcing 1 against autograd's, both
     directions through the loops of its dtype. Every kernel launched on a main path
     (ALL_DECODER_PATHS): on the bf16 ones (BF16_DECODER_PATHS: the trainer and the
     pipeline's Tacotron phase) decoder_fwd_loop and decoder_bwd_loop and none of the four
     step kernels; on the f32 ones (F32_DECODER_PATHS: GTA, whose model computes in f32 as
     the JAX synthesizer's does, and phase 12's timed f32 steps) decoder_fwd_loop_f32 and
     none of the step kernels, and, where they train, decoder_bwd_loop_f32; on the float32
     trainer at teacher forcing 0.5 (TACO_F32_SCHEDULED_PATH) all four step kernels.
 17. The CBHG's bidirectional GRU recurrence (`ops/gru_scan.py`, `GRUScan`), which the
     Tacotron trainer, its eval, the pipeline's Tacotron phase and `synthesize --model
     Tacotron` (eval, live) run at the default hparams. Its two kernels (csrc/gru_loop/
     gru_loop.cu: gru_fwd_loop, all steps of both directions in one launch, and
     gru_bwd_loop, their reverse recurrence) against their plain versions on the same CUDA
     tensors at the default width (H = 128, input 128) over GRU_STEPS (512) steps, in f32
     (TF32 off) and bf16, each of GRU_CASES (B=32 at lengths None as the model calls it,
     B=1, B=32 with a ragged mask, B=32 with W_hh = 0): the output and every residual, dip
     and dg over each direction's first GRU_FIRST_STEPS steps and over all, and dW_hh and
     db_hn formed from them (GRU_TOL; GRU_ZERO_TOL with W_hh = 0), two launches bit for bit,
     seven planted faults (GRU_MUTANTS, each a build with one macro set, built in phase 2)
     that must miss a bound GRU_FAULT_FACTOR times over; at B=32 and B=1 each kernel's ms
     (the forward with and without residuals) beside its bound and its plain version's, and
     at B=32 the CBHG's GRU module (BiGRU) forward and backward beside cuDNN's bidirectional
     GRU on the same input (nn.GRU with b_hh = (0, 0, b_hn), held to the plain output in
     f32 first), the library yardstick. Phase 12's (f32) and phase 14's (bf16) timed steps'
     GRU parts (StepMarks) beside the step loop's (GRU_STEP_LOOP_TIMED). Every main path
     that trains (GRU_TRAIN_PATHS) launched both kernels, the synthesizer's
     (GRU_SYNTH_PATHS) gru_fwd_loop alone.
 18. The encoder's bidirectional zoneout-LSTM recurrence (`ops/lstm_scan.py`, `LSTMScan`),
     which every path that encodes text runs. Its two kernels (csrc/lstm_loop/
     lstm_loop.cu: lstm_fwd_loop, all steps of both directions in one launch, a cluster of
     8 CTAs a (direction, group of rows) with W_hh split over their shared memory and h
     exchanged through distributed shared memory, and lstm_bwd_loop, their reverse
     recurrence) against their plain versions on the same CUDA tensors at the default
     widths (C = 512, U = 256), at compute dtype f32 (TF32 off) and bf16, each of
     LSTM_CASES (B=32 x LSTM_T_IN = 192, the feeder's largest padded text, and B=1 x 112, in
     the training form with keep-masks at rate 0.1 and in the synthesis form, ragged
     lengths, W_hh = 0): the output and every residual, and dz over each direction's first
     LSTM_FIRST_STEPS steps and over all, and dW_hh formed from it (LSTM_TOL; LSTM_ZERO_TOL
     with W_hh = 0), two launches bit for bit (and the launch without residuals the one
     with them), ten planted faults (LSTM_MUTANTS, each a build with one macro set, built in
     phase 2) that must miss a bound LSTM_FAULT_FACTOR times over; each kernel's ms (the
     forward with and without residuals) at B=32 x 192, B=32 x 112 and B=1 x 112 beside its
     bound and its plain version's, and at B=32 x 192 the encoder LSTM module forward and
     backward beside cuDNN's bidirectional LSTM at zoneout 0 on the same input (nn.LSTM, the
     gates reordered and the forget bias folded in, held to the plain output at zoneout 0
     in f32 first), the library yardstick. Phase 12's (f32) and phase 14's (bf16) timed
     steps' encoder LSTM parts (StepMarks) beside the step loop's (LSTM_STEP_LOOP_TIMED).
     Every main path that trains (LSTM_TRAIN_PATHS) launched both kernels, every other path
     that encodes text (LSTM_SYNTH_PATHS: synthesize and serve at both profiles, GTA, the
     Tacotron eval and live command lines and `synthesize --model Tacotron-2`)
     lstm_fwd_loop alone.
Then a JSON line of the kernels (with each kernel's bound: the larger of its bytes over
the HBM rate and its operations over the peak rate of their type, for the run timed),
the card's nvidia-smi line, and the result line.
"""

import atexit
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
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()  # the run's clock, which every phase line ends with
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
# how far the plain version follows phase 3's B=2 launch of 35,200 steps: the first
# served chunk, whose state after it phase 6 reads, and 4,448 steps of the second from
# the carried state, which wrap the largest ring (1,024 slots). Phase 8's follows all
# PAPER_PLAIN_STEPS of its launch. Run eagerly, the plain version's 5 to 19 ms a step
# were host time, and the spans were once cut to 4,608 steps to keep the run inside
# its 1,200 s; its step replayed as a CUDA graph takes 1.1 to 2.3 ms, all device time
# (H100 80GB HBM3, 700 W), and the spans are as they were before the cuts
PLAIN_STEPS = 8800
PAPER_PLAIN_STEPS = 8800
# phase 3's checks at B=8 and B=20: 2,750 steps, which wrap the largest ring (1,024
# slots) twice (4 frames, 1,100 steps, while the plain version ran eagerly)
CHECK_FRAMES = 10
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
# how far the plain version follows each of the entry point's launches of 8,800 steps: all
# of them, in chunks at odd ends (2,200 until the whole run's length left too little
# margin of its 1,200 s, then 1,100 until the plain version ran as a CUDA graph); the
# reading over the first CUT_STEPS is printed beside the whole one's
CUT_STEPS = 1100
VOCODER_CLI_BOUNDS = (*VOCODER_BOUNDS, 8800)  # VOCODER_FRAMES frames of 275 samples
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
# the heads (bits over csrc/wavenet_ar.cu's Head: Gaussian 1, MoL 2, categorical 4, big
# categorical 8) whose instantiations each planted-fault copy of the AR kernel builds
# (T2_HEADS): those its check launches; a launch of another head would fail the run
MUTANT_HEADS = {'g_cond added after the bf16 rounding': 1,
                'feedback from the f32 first_w row': 4,
                'plain chain ring written with the layer\'s output': 1,
                **{fault: 8 for fault in BIG_VOCAB_MUTANTS},
                **{fault: 1 for fault in CLUSTER_MUTANTS}}
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
TRAIN_DEFAULT_EXTRA = 'wavenet_natural_eval=True,wavenet_ema_decay=0.5'
# how far the plain version follows the default trainer's eval launch of 11,000 steps
# (the kernel repeats all of them): all of them, in chunks at odd ends (the first
# CUT_STEPS until the plain version ran as a CUDA graph)
TRAIN_EVAL_BOUNDS = (*VOCODER_BOUNDS, 11000)
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
    print(f'[{n}] {msg} [at {time.perf_counter() - T_START:.1f} s]', flush=True)


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
    return _layout_keys(LAYOUTS_BY_PATH[path])


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
             f'{r["bit_identical"]}; chunked params max_abs_err={r["max_abs_err"]:.3e}'
             + (f' (over the first {CUT_STEPS} steps {r["cut_err"]:.3e})'
                if T > CUT_STEPS and 'cut_err' in r else '') + f', '
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
    cut = min(T, CUT_STEPS)
    return dict(bit_identical=torch.equal(audio, full),
                max_abs_err=(params - ref_params).abs().max().item(),
                cut_err=(params[:, :cut] - ref_params[:, :cut]).abs().max().item(),
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
            reset_decoder_counts()
            stats = synthesize.main((['--paper_profile'] if paper else [])
                                    + ['--tacotron_checkpoint', taco_path,
                                       '--wavenet_checkpoint', wave_path,
                                       '--hparams', hp_overrides, '--text_list', text_list,
                                       '--output_dir', os.path.join(tmp, 'out'),
                                       '--device', 'cuda'])
            launches = read_counts(what)
            read_decoder_counts(what)
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
            reset_decoder_counts()
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
            read_decoder_counts('serve')

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
                          n=8, tol=MOL_KERNEL_TOL, plain_steps=PAPER_PLAIN_STEPS)
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
            reset_decoder_counts()
            server.start()
            try:
                status, data, first, wall = fetch(
                    server.address, 'GET', '/tts?text=The+paper+profile,+served.&format=f32')
            finally:
                server.close()
            launches = read_counts('serve --paper_profile')
            read_decoder_counts('serve --paper_profile')
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


class Builds:
    """Phase 2's builds under way: `[fault]` waits for the library of that planted-fault
    copy and returns it, loaded; `wait()` waits for every build, raising the first
    failure, and returns the run's clock when the last one ended."""

    def __init__(self, pool, libraries, mutants):
        self._pool, self._libraries, self._mutants = pool, libraries, mutants
        self.done_at = None

    def __getitem__(self, fault):
        return self._mutants[fault].result()[0]

    def __len__(self):
        return len(self._mutants)

    def wait(self):
        ends = [f.result() for f in self._libraries]
        ends += [f.result()[1] for f in self._mutants.values()]
        self._pool.shutdown()
        self.done_at = max(ends)
        return self.done_at


def build_kernels(tmp):
    """Phase 2: nvcc builds the port's library first, alone, and loads it; then, in the
    background, one nvcc a library and one fewer at a time than the host has cores, the
    decoder step's library, the decoder's bf16 and float32 forward loops' and its bf16 and
    float32 reverse loops' libraries, the probes' library and one library for each of
    ALL_MUTANTS, CLUSTER_MUTANTS, PROBE_MUTANTS, DECODER_MUTANTS, LOOP_MUTANTS,
    F32_LOOP_MUTANTS, BWD_LOOP_MUTANTS and F32_BWD_LOOP_MUTANTS from a changed copy of its
    source (an AR kernel's copy with the instantiations of MUTANT_HEADS alone), and the
    CBHG's GRU loops' and the encoder LSTM's loops' libraries and one build of each one's
    source for each of GRU_MUTANTS and LSTM_MUTANTS with that fault's macro set, under
    `tmp`, which must outlive the builds.
    Phase 3 needs the first library alone and runs beside the others (its readings are
    device times); the run waits for them all before phase 4, whose entry points are
    timed on the host's clock. Returns the Builds."""
    from tacotron2_tpu_torch.ops import _build

    def clock():
        return time.perf_counter() - T_START

    def mutant(item):
        i, fault = item
        defines, flags = (), ()
        if fault in PROBE_MUTANTS:
            name, text = mutated_probe_source(fault)
        elif fault in DECODER_MUTANTS:
            name, text = 'decoder_step.cu', mutated_decoder_source(fault)
            flags = _build.DECODER_FLAGS
        elif fault in LOOP_MUTANTS:
            name, text = 'decoder_loop.cu', mutated_loop_source(fault)
            flags = _build.DECODER_FLAGS
        elif fault in F32_LOOP_MUTANTS:
            name, text = 'decoder_loop_f32.cu', mutated_loop_f32_source(fault)
            flags = _build.DECODER_FLAGS
        elif fault in BWD_LOOP_MUTANTS:
            name, text = 'decoder_bwd_loop.cu', mutated_bwd_loop_source(fault)
            flags = _build.DECODER_FLAGS
        elif fault in F32_BWD_LOOP_MUTANTS:
            name, text = 'decoder_bwd_loop_f32.cu', mutated_bwd_loop_f32_source(fault)
            flags = _build.DECODER_FLAGS
        elif fault in GRU_MUTANTS or fault in LSTM_MUTANTS:  # the source, one macro set
            src_dir, macro = ((_build.GRU_LOOP_DIR, GRU_MUTANTS[fault]) if fault in GRU_MUTANTS
                              else (_build.LSTM_LOOP_DIR, LSTM_MUTANTS[fault]))
            lib = os.path.join(tmp, f'mutant{i}', 'libmutant.so')
            _build.compile_library(_build._sources(src_dir), lib, (macro,),
                                   _build.DECODER_FLAGS)
            return ctypes.CDLL(lib), clock()
        else:
            name, text = 'wavenet_ar.cu', mutated_source(fault)
            defines = (f'T2_HEADS={MUTANT_HEADS[fault]}',)
        src = os.path.join(tmp, f'mutant{i}', name)
        os.makedirs(os.path.dirname(src))
        with open(src, 'w', encoding='utf-8') as f:
            f.write(text)
        lib = os.path.join(tmp, f'mutant{i}', 'libmutant.so')
        _build.compile_library([src], lib, defines, flags)
        return ctypes.CDLL(lib), clock()

    def library(load):
        load()
        return clock()

    # the kernels' library alone (its nvcc splits the device code over every core; with
    # the other builds beside it, it took as long as all of them together), then as many
    # builds at a time as leave phase 3 a core, in the order the run needs them
    _build.load_library()
    pool = concurrent.futures.ThreadPoolExecutor(max(1, (os.cpu_count() or 2) - 1))
    libraries = [pool.submit(library, load) for load in (
        _build.load_decoder_library, _build.load_decoder_loop_library,
        _build.load_decoder_loop_f32_library, _build.load_decoder_bwd_loop_library,
        _build.load_decoder_bwd_loop_f32_library, _build.load_gru_loop_library,
        _build.load_lstm_loop_library)]
    faults = list(CLUSTER_MUTANTS) + list(ALL_MUTANTS)
    mutants = {fault: pool.submit(mutant, (i, fault)) for i, fault in enumerate(faults)}
    libraries.append(pool.submit(library, _build.load_probe_library))
    for fault in (list(PROBE_MUTANTS) + list(DECODER_MUTANTS) + list(LOOP_MUTANTS)
                  + list(F32_LOOP_MUTANTS) + list(BWD_LOOP_MUTANTS)
                  + list(F32_BWD_LOOP_MUTANTS) + list(GRU_MUTANTS) + list(LSTM_MUTANTS)):
        mutants[fault] = pool.submit(mutant, (len(mutants), fault))
    return Builds(pool, libraries, mutants)


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


def vocoder_cli(extra, hp, wavenet_state, speaker_id=None, path=None, n=9):
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
    phase(n, f'{what}: {len(stats["wavs"])} wavs of {[len(w) for w in stats["wavs"]]} samples, '
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


def logged_step_times(steps, first):
    """Each step's own time from a trainer's log lines, {step: (the running average of
    the step times, loss)}, of a run whose first step is `first`: n times the average
    after its n-th step less n - 1 times the one before. The log prints the average to
    three places, so a step's time is within 0.0005 (2n - 1) s."""
    times = {}
    for step in sorted(steps):
        n = step - first + 1
        if n == 1:
            times[step] = steps[step][0]
        elif step - 1 in steps:
            times[step] = n * steps[step][0] - (n - 1) * steps[step - 1][0]
    return times


def fmt_times(times, steps):
    """'median M sec/step (min-max)' of times[s] over `steps`, and each."""
    ts = [times[s] for s in steps]
    return (f'median {np.median(ts):.3f} sec/step ({min(ts):.3f}-{max(ts):.3f}; '
            + ', '.join(f'{t:.3f}' for t in ts) + ')')


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
    from tacotron2_tpu_torch.training.common import to_device

    extra = TRAIN_DEFAULT_EXTRA
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
              f'{drift:.2e} (losses logged to 5 places); steps 3 to 6 (each from the log) '
              f'{fmt_times(logged_step_times(first["steps"], 1), range(3, 7))}; peak '
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
    batch = to_device(next(dataset.train_batches(seed=hp.wavenet_data_random_state)), 'cuda')
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
                sec_step=float(np.median([logged_step_times(first['steps'], 1)[i]
                                          for i in range(3, 7)])),
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
              f'{fmt_times(logged_step_times(run["steps"], 1), (3, 4))}; peak device '
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
                sec_step=float(np.median([logged_step_times(run['steps'], 1)[i]
                                          for i in (3, 4)])), peak_gib=gib,
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


# --- phase 12: Tacotron training -----------------------------------------------------

TACO_UTTERANCES = 64   # 32 to train on and one test batch of 32
TACO_OVERRIDES = 'tacotron_test_size=None,tacotron_test_batches=1'
TACO_PATH = 'train --model Tacotron'
# a float32 trainer at teacher forcing 0.5, 2 steps at B=8: the main path whose decoder
# still runs the step loop (a step on its own last frame)
TACO_F32_SCHEDULED = (',compute_dtype=float32,tacotron_teacher_forcing_ratio=0.5,'
                      'tacotron_batch_size=8')
TACO_F32_SCHEDULED_PATH = 'train --model Tacotron, float32, teacher forcing 0.5'
F32_SCHEDULED_STEPS = 2
TACO_CPU_BATCH = 4     # the card-vs-CPU step: full width, the batch cut
TIMED_FRAMES = 512     # the timed step: B=32 x 512 mel frames, a typical LJSpeech utterance
TIMED_CHARS = 100      # ... and its characters
# the card's step against the CPU's on the same state, batch and draws (f32, TF32 off),
# read on an H100 80GB HBM3 at 700 W over three of the corpus's batches cut to 4 rows:
# the loss within 7.5e-8 and the grad norm 4.5e-7 relative: TACO_STEP_TOL. The
# gradients (Adam's first moment over 1 - beta1 after the first step) 1.1e-5 to 1.3e-4
# apart in relative L2 norm: a 128-step recurrence and BatchNorm's near-cancelling sums
# carry the devices' rounding apart: TACO_GRAD_TOL. A parameter after the first Adam
# step moves by lr * g / (|g| + eps), about lr for every entry whose gradient is not
# near zero; where |g| is a few eps, rounding moves it by up to 2 lr: the parameters are
# held to TACO_PARAM_TOL (2.5 lr) at most, and every entry more than TACO_PARAM_CLOSE
# apart must have a gradient under TACO_SMALL_GRAD (144 to 43,058 such entries of
# 29,015,826 a batch, each with |g| at most 7.1e-6)
TACO_STEP_TOL = 1e-5
TACO_GRAD_TOL = 5e-4
TACO_PARAM_TOL = 2.5e-3
TACO_PARAM_CLOSE = 1e-5
TACO_SMALL_GRAD = 1e-4
# the second step, each device from its own state after the first (Adam's moments differ):
# the two devices' parameter displacements over both steps, apart in relative L2. Read on
# an H100 80GB HBM3 at 700 W in three runs: 1.16e-4 to 3.14e-4 at the default depth (the
# fused decoder, its float32 forward loop on the card) and 1.52e-3 at depth 3 (the
# autograd decoder, phase 14). A bound on single entries cannot hold: where a parameter's
# two gradients nearly cancel in Adam's first moment, its second update follows the
# devices' rounding (5.3e-4 apart at depth 3, the learning rate 1e-3, among entries whose
# gradient is 1e-4 or more at both steps; 9.7e-7 to 1.2e-6 at the default depth). The
# bound sits 3.3x above the largest reading
TACO_PARAM2_TOL = 5e-3


def make_taco_corpus(root, hp, n, seed):
    """A Tacotron corpus in the preprocessing layout, made from `seed`: n utterances of
    1 to 2 s (two gliding tones and noise) with mels/mel-i.npy and linear/linear-i.npy
    from the port's ops/audio (frames x num_mels, frames x num_freq), texts from
    sentences.txt, and a train.txt of audio|mel|linear|samples|frames|text rows.
    Returns the path of train.txt."""
    from tacotron2_tpu_torch.ops import audio

    rng = np.random.default_rng(seed)
    with open(os.path.join(REPO, 'sentences.txt'), encoding='utf-8') as f:
        texts = [line.strip() for line in f if line.strip()]
    for d in ('mels', 'linear'):
        os.makedirs(os.path.join(root, d))
    rows = []
    for i in range(n):
        t = np.arange(int(rng.uniform(1.0, 2.0) * hp.sample_rate)) / hp.sample_rate
        wav = (0.4 * np.sin(2 * np.pi * (180 + 20 * i) * t * (1 + 0.2 * np.sin(3 * t)))
               + 0.2 * np.sin(2 * np.pi * (900 + 35 * i) * t)
               + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        mel = audio.melspectrogram(wav, hp).astype(np.float32).T
        linear = audio.linearspectrogram(wav, hp).astype(np.float32).T
        np.save(os.path.join(root, 'mels', f'mel-{i}.npy'), mel)
        np.save(os.path.join(root, 'linear', f'linear-{i}.npy'), linear)
        rows.append(f'audio-{i}.npy|mel-{i}.npy|linear-{i}.npy|{len(wav)}|{len(mel)}|'
                    f'{texts[i % len(texts)]}')
    path = os.path.join(root, 'train.txt')
    with open(path, 'w', encoding='utf-8') as f:
        f.write('\n'.join(rows) + '\n')
    return path


def run_taco_trainer(root, name, steps, eval_interval, checkpoint_interval, restore=True,
                     extra='', path=TACO_PATH):
    """`python -m tacotron2_tpu_torch.train --model Tacotron` on the card at the default
    hparams (but TACO_OVERRIDES and `extra`), its console output captured, its decoder
    kernel launches counted for `path`. Returns the output, its (step, sec/step, loss)
    lines, the wall seconds, the peak device memory and the checkpoint directory."""
    from tacotron2_tpu_torch import train

    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    reset_decoder_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        save_dir = train.main(
            ['--model', 'Tacotron', '--tacotron_input', 'train.txt', '--base_dir', root,
             '--name', name, '--tacotron_train_steps', str(steps), '--eval_interval',
             str(eval_interval), '--checkpoint_interval', str(checkpoint_interval),
             '--summary_interval', '2', '--restore', str(restore), '--hparams',
             TACO_OVERRIDES + extra, '--device', 'cuda'])
    torch.cuda.synchronize()
    read_decoder_counts(path)
    text = out.getvalue()
    lines = {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
             for m in STEP_LINE.finditer(text)}
    return dict(out=text, steps=lines, seconds=time.perf_counter() - t0,
                peak_bytes=torch.cuda.max_memory_allocated(), save_dir=save_dir)


def taco_f32_scheduled(root):
    """`train --model Tacotron` in float32 at teacher forcing 0.5 (TACO_F32_SCHEDULED):
    F32_SCHEDULED_STEPS steps at B=8 on phase 12's corpus, no eval, its decoder kernel
    launches counted for TACO_F32_SCHEDULED_PATH. Steps that read their own last frame
    keep the step loop (lstm_cell_fwd and attention_fwd, with their reverse kernels): the
    main path that still runs them. Returns the readings."""
    run = run_taco_trainer(root, 'f32s', F32_SCHEDULED_STEPS, 100, 100, restore=False,
                           extra=TACO_F32_SCHEDULED, path=TACO_F32_SCHEDULED_PATH)
    losses = [run['steps'].get(i, (0, float('nan')))[1]
              for i in range(1, F32_SCHEDULED_STEPS + 1)]
    phase(12, f'{TACO_F32_SCHEDULED_PATH} ({TACO_F32_SCHEDULED}): {F32_SCHEDULED_STEPS} steps in '
              f'{run["seconds"]:.1f} s of wall, losses {losses}')
    if not all(np.isfinite(l) for l in losses):
        fail(f'the float32 trainer at teacher forcing 0.5 gave losses of {losses}')
    return dict(seconds=run['seconds'], losses=losses)


def _wav_ok(path):
    from scipy.io import wavfile

    _, w = wavfile.read(path)
    return len(w) > 0 and bool(np.isfinite(np.asarray(w, np.float64)).all())


def taco_cpu_vs_card(hp, batch, n=12, what=''):
    """One f32 train step (compute_dtype pinned: the card's default is bf16) at full
    width on the card and on the CPU from the same fresh state, on the first
    TACO_CPU_BATCH rows of `batch` with the same draws (made on the CPU and copied), and
    the float32 reverse loop's launches in the card's step. Returns the readings."""
    from tacotron2_tpu_torch.ops import decoder_vjp as dv
    from tacotron2_tpu_torch.ops import gru_scan, lstm_scan
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    small = {k: v[:TACO_CPU_BATCH] for k, v in batch.items()}
    states = {d: tt.create_train_state(hp, d, seed=3) for d in ('cpu', 'cuda')}
    B, T_in = small['inputs'].shape
    noise = states['cpu'].model.draw_noise(B, T_in, small['mel_targets'].shape[1],
                                           torch.Generator().manual_seed(4), False, 'cpu')

    def on(device, x):
        if isinstance(x, list):
            return [on(device, y) for y in x]
        return x.to(device)

    start = [p.detach().clone() for p in states['cpu'].model.parameters()]
    metrics, secs, bwd_loops, grus, lstms = {}, {}, {}, {}, {}
    for d, state in states.items():
        t0 = time.perf_counter()
        before = dv.LAUNCHES['decoder_bwd_loop_f32']
        before_gru = collections.Counter(gru_scan.LAUNCHES)
        before_lstm = collections.Counter(lstm_scan.LAUNCHES)
        m = tt.train_step(state, {k: v.to(d) for k, v in small.items()}, hp,
                          noise={k: on(d, v) for k, v in noise.items()}, dtype=torch.float32)
        metrics[d] = {k: float(m[k]) for k in ('loss', 'grad_norm')}
        secs[d] = time.perf_counter() - t0
        bwd_loops[d] = dv.LAUNCHES['decoder_bwd_loop_f32'] - before
        grus[d] = dict(collections.Counter(gru_scan.LAUNCHES) - before_gru)
        lstms[d] = dict(collections.Counter(lstm_scan.LAUNCHES) - before_lstm)
    loss_err = abs(metrics['cuda']['loss'] - metrics['cpu']['loss']) / abs(metrics['cpu']['loss'])
    norm_err = abs(metrics['cuda']['grad_norm'] - metrics['cpu']['grad_norm']) \
        / metrics['cpu']['grad_norm']
    b1 = hp.tacotron_adam_beta1
    worst, off, off_large, total, g_err2, g_norm2 = 0.0, 0, 0, 0, 0.0, 0.0
    for a, b, ma, mb in zip(states['cpu'].model.parameters(), states['cuda'].model.parameters(),
                            states['cpu'].exp_avg, states['cuda'].exp_avg):
        g = ma / (1 - b1)
        g_err2 += float(((ma - mb.cpu()).double() / (1 - b1)).square().sum())
        g_norm2 += float(g.double().square().sum())
        diff = (a.detach() - b.detach().cpu()).abs()
        worst = max(worst, float(diff.max()))
        far = diff > TACO_PARAM_CLOSE
        off += int(far.sum())
        off_large += int((far & (g.abs() >= TACO_SMALL_GRAD)).sum())
        total += diff.numel()
    grad_err = (g_err2 / g_norm2) ** 0.5
    phase(n, f'one f32 train step at full width{what}, B={B} (T_in={T_in}, '
              f'{small["mel_targets"].shape[1]} frames), card vs CPU from the same state and '
              f'draws: loss {metrics["cuda"]["loss"]:.6f} vs {metrics["cpu"]["loss"]:.6f} '
              f'(rel err {loss_err:.2e}, tol {TACO_STEP_TOL}), grad norm rel err '
              f'{norm_err:.2e}; the gradients {grad_err:.2e} apart in relative L2 norm (tol '
              f'{TACO_GRAD_TOL}); parameters after the step: max abs err {worst:.2e} (tol '
              f'{TACO_PARAM_TOL}), {off} of {total} entries off by more than '
              f'{TACO_PARAM_CLOSE}, {off_large} of them with a gradient of {TACO_SMALL_GRAD} '
              f'or more (tol 0); {secs["cuda"]:.2f} s on the card, {secs["cpu"]:.2f} s on the '
              f'CPU; the card\'s step launched decoder_bwd_loop_f32 {bwd_loops["cuda"]} time(s), '
              f'the GRU loops {grus["cuda"]}')
    if not (loss_err <= TACO_STEP_TOL and norm_err <= TACO_STEP_TOL and grad_err <= TACO_GRAD_TOL
            and worst <= TACO_PARAM_TOL and off_large == 0):
        fail('the card\'s Tacotron train step disagrees with the CPU\'s')
    second = taco_second_step(states, start, small, noise, hp, n, what)
    return dict(loss_rel_err=loss_err, grad_norm_rel_err=norm_err, grad_rel_err=grad_err,
                param_max_abs_err=worst, params_off=off, card_s=secs['cuda'], cpu_s=secs['cpu'],
                bwd_loop_launches=bwd_loops['cuda'], gru_launches=grus['cuda'],
                lstm_launches=lstms['cuda'], second_step=second)


def taco_second_step(states, start, batch, noise, hp, n=12, what=''):
    """The second f32 train step of taco_cpu_vs_card, each device from its own state after
    the first (Adam's moments now differ between them), on the same batch and draws: the
    loss, and the parameters after it: the two devices' displacements over both steps from
    `start` (the fresh state's parameters) within TACO_PARAM2_TOL of each other in relative
    L2; beside it the largest difference of all, and of the entries whose gradient is
    TACO_SMALL_GRAD or more at both steps. Returns the readings."""
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    b1 = hp.tacotron_adam_beta1
    m1 = [m.detach().clone() for m in states['cpu'].exp_avg]
    losses = {}
    t0 = time.perf_counter()
    for d, state in states.items():
        m = tt.train_step(state, {k: v.to(d) for k, v in batch.items()}, hp,
                          noise={k: [y.to(d) for y in v] if isinstance(v, list) else v.to(d)
                                 for k, v in noise.items()}, dtype=torch.float32)
        losses[d] = float(m['loss'])
    worst = worst_set = 0.0
    n_set, diff2, move2 = 0, 0.0, 0.0
    for a, b, m2, m1_, p0 in zip(states['cpu'].model.parameters(),
                                  states['cuda'].model.parameters(), states['cpu'].exp_avg, m1,
                                  start):
        g1, g2 = m1_ / (1 - b1), (m2 - b1 * m1_) / (1 - b1)
        diff = (a.detach() - b.detach().cpu()).abs()
        worst = max(worst, float(diff.max()))
        settled = (g1.abs() >= TACO_SMALL_GRAD) & (g2.abs() >= TACO_SMALL_GRAD)
        n_set += int(settled.sum())
        if settled.any():
            worst_set = max(worst_set, float(diff[settled].max()))
        diff2 += float(diff.double().square().sum())
        move2 += float((a.detach() - p0).double().square().sum())
    loss_err = abs(losses['cuda'] - losses['cpu']) / abs(losses['cpu'])
    rel = (diff2 / move2) ** 0.5
    phase(n, f'the second f32 train step{what}, each device from its own state after the '
              f'first: loss {losses["cuda"]:.6f} vs {losses["cpu"]:.6f} (rel err '
              f'{loss_err:.2e}); the parameters\' displacements over both steps {rel:.2e} '
              f'apart in relative L2 (tol {TACO_PARAM2_TOL}); max abs err {worst:.2e} of all, '
              f'{worst_set:.2e} where the gradient is {TACO_SMALL_GRAD} or more at both steps '
              f'({n_set} entries); {time.perf_counter() - t0:.1f} s on both devices')
    if not rel <= TACO_PARAM2_TOL:
        fail('the card\'s second Tacotron train step disagrees with the CPU\'s')
    return dict(loss_rel_err=loss_err, settled_entries=n_set, settled_max_abs_err=worst_set,
                param_max_abs_err=worst, displacement_rel_l2=rel)


# the modules whose boundaries StepMarks marks inside the real train step: each one's
# forward start and end, and the start and end of its backward (the gradient of its
# outputs ready, then that of its inputs)
MARKED = ('encoder_convolutions', 'encoder_lstm', 'postnet_convolutions', 'cbhg_postnet',
          'cbhg_postnet.bigru')


class StepMarks:
    """Marks at module boundaries inside a Tacotron train step, from forward hooks and
    full backward hooks on MARKED: a CUDA event on the card, the host clock on the CPU.
    `mark` adds one by name; `offsets` gives each in ms after the mark 'start'."""

    def __init__(self, model, device):
        self.cuda = torch.device(device).type == 'cuda'
        self.marks = {}
        self.handles = []
        for path in MARKED:
            m, name = model.get_submodule(path), path.rpartition('.')[2]
            self.handles += [
                m.register_forward_pre_hook(lambda *a, n=name: self.mark(n + '.fwd_pre')),
                m.register_forward_hook(lambda *a, n=name: self.mark(n + '.fwd')),
                m.register_full_backward_pre_hook(lambda *a, n=name: self.mark(n + '.bwd_pre')),
                m.register_full_backward_hook(lambda *a, n=name: self.mark(n + '.bwd'))]

    def mark(self, name):
        if self.cuda:
            self.marks[name] = torch.cuda.Event(enable_timing=True)
            self.marks[name].record()
        else:
            self.marks[name] = time.perf_counter()

    def offsets(self):
        if self.cuda:
            torch.cuda.synchronize()
            return {k: self.marks['start'].elapsed_time(e) for k, e in self.marks.items()}
        return {k: (t - self.marks['start']) * 1e3 for k, t in self.marks.items()}

    def remove(self):
        for h in self.handles:
            h.remove()


def step_segments(o):
    """A train step's ms by part from StepMarks offsets `o` of one step, the parts in
    the order they run and tiling the step from 'start' to 'end'. 'losses' is the loss
    terms' forward and backward; the decoder's forward holds the memory layer, its
    backward all of the decoder's step loop. Raises if the marks are not in that order."""
    gru = [o['bigru.fwd_pre'], o['bigru.fwd'], o['bigru.bwd_pre'], o['bigru.bwd']]
    order = [('fwd: embedding, encoder convs', o['encoder_lstm.fwd_pre']),
             ('fwd: encoder LSTM', o['encoder_lstm.fwd']),
             ('fwd: decoder', o['postnet_convolutions.fwd_pre']),
             ('fwd: post-net', o['cbhg_postnet.fwd_pre']),
             ('fwd: CBHG bank to highways', gru[0]),
             ('fwd: CBHG GRUs', gru[1]),
             ('fwd: CBHG rest', o['cbhg_postnet.fwd']),
             ('losses', o['cbhg_postnet.bwd_pre']),
             ('bwd: CBHG rest', gru[2]),
             ('bwd: CBHG GRUs', gru[3]),
             ('bwd: CBHG bank to highways', o['cbhg_postnet.bwd']),
             ('bwd: post-net', o['postnet_convolutions.bwd']),
             ('bwd: decoder', o['encoder_lstm.bwd_pre']),
             ('bwd: encoder LSTM', o['encoder_lstm.bwd']),
             ('bwd: encoder convs', o['encoder_convolutions.bwd']),
             ('embedding grad, clip, Adam', o['end'])]
    seg, t = {}, 0.0
    for name, end in order:
        if end < t:
            raise ValueError(f'the step\'s marks are out of order at {name!r}: {o}')
        seg[name], t = end - t, end
    return seg


def taco_timed_batch(hp, B, T, chars):
    """A seeded Tacotron batch on the card: B rows of `chars` characters and T frames."""
    g = torch.Generator('cuda').manual_seed(5)
    batch = dict(
        inputs=torch.randint(2, 60, (B, chars), device='cuda', generator=g),
        input_lengths=torch.full((B,), chars, device='cuda'),
        mel_targets=torch.rand(B, T, hp.num_mels, device='cuda', generator=g) * 8 - 4,
        stop_token_targets=torch.zeros(B, T, device='cuda'),
        targets_lengths=torch.full((B,), T, device='cuda'),
        linear_targets=torch.rand(B, T, hp.num_freq, device='cuda', generator=g) * 8 - 4)
    batch['stop_token_targets'][:, -1] = 1.0
    return batch


def taco_timed_step(hp, reps=3, dtype=torch.float32, n=12):
    """A train step in `dtype` at B=32 x TIMED_FRAMES mel frames (TIMED_CHARS
    characters), after one untimed step: `reps` steps each between two synchronizes
    (sec/step), then `reps` steps split by StepMarks into their parts
    (CUDA events on the real step), and the peak device memory. Returns the readings:
    each the median of the reps, with its range."""
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    B, T = hp.tacotron_batch_size, TIMED_FRAMES
    batch = taco_timed_batch(hp, B, T, TIMED_CHARS)
    g = torch.Generator('cuda').manual_seed(6)
    state = tt.create_train_state(hp, 'cuda')
    tt.train_step(state, batch, hp, g, dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(tt.train_step(state, batch, hp, g, dtype=dtype)['loss'].item())
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = dict(sec_step=float(np.median(secs)), sec_step_range=(min(secs), max(secs)),
                 peak_gib=peak)
    if not all(np.isfinite(x) for x in losses):
        fail(f'the timed Tacotron steps gave losses of {losses}')
    phase(n, f'timed train step in {dtype}, B={B} x {T} frames ({TIMED_CHARS} characters, '
             f'default hparams), {reps} steps each: median {np.median(secs):.3f} sec/step '
             f'({min(secs):.3f}-{max(secs):.3f}; losses {[round(x, 4) for x in losses]}); '
             f'peak device memory {peak:.2f} GiB')

    marks = StepMarks(state.model, 'cuda')
    parts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        marks.marks.clear()
        marks.mark('start')
        tt.train_step(state, batch, hp, g, dtype=dtype)
        marks.mark('end')
        parts.append(step_segments(marks.offsets()))
    marks.remove()
    med = {k: float(np.median([p[k] for p in parts])) for k in parts[0]}
    rng = {k: (min(p[k] for p in parts), max(p[k] for p in parts)) for k in parts[0]}
    step_ms = [sum(p.values()) for p in parts]
    fwd = [sum(v for k, v in p.items() if k.startswith('fwd')) for p in parts]
    bwd = [sum(v for k, v in p.items() if k.startswith('bwd')) for p in parts]
    share = [p['bwd: decoder'] / b for p, b in zip(parts, bwd)]
    phase(n, f'the same step split at module boundaries (CUDA events from hooks on the '
              f'real step; ms, median of {reps} (range)): step {np.median(step_ms):.1f} '
              f'({min(step_ms):.1f}-{max(step_ms):.1f}), forward {np.median(fwd):.1f} '
              f'({min(fwd):.1f}-{max(fwd):.1f}), backward {np.median(bwd):.1f} '
              f'({min(bwd):.1f}-{max(bwd):.1f}); the decoder\'s backward '
              f'{np.median(share):.0%} of the backward ({min(share):.0%}-{max(share):.0%}); '
              + '; '.join(f'{k} {med[k]:.1f} ({rng[k][0]:.1f}-{rng[k][1]:.1f})' for k in med))
    return dict(timed, step_ms=float(np.median(step_ms)), fwd_ms=float(np.median(fwd)),
                bwd_ms=float(np.median(bwd)), decoder_bwd_share=float(np.median(share)),
                parts=med, part_ranges=rng)


def tacotron_training():
    """Phase 12 (see the module docstring). Returns the readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.data.loader import TacotronDataset
    from tacotron2_tpu_torch.training import tacotron_trainer as tt
    from tacotron2_tpu_torch.training.checkpointing import CheckpointManager
    from tacotron2_tpu_torch.training.common import step_seed, to_device

    hp = default_hparams()
    hp.parse(TACO_OVERRIDES)
    with tempfile.TemporaryDirectory(prefix='t2torch_taco_') as root:
        t0 = time.perf_counter()
        meta = make_taco_corpus(root, hp, TACO_UTTERANCES, seed=12)
        with open(meta, encoding='utf-8') as f:
            frames = [int(line.split('|')[4]) for line in f]
        phase(12, f'corpus of {TACO_UTTERANCES} utterances ({min(frames)} to {max(frames)} '
                  f'frames) in {time.perf_counter() - t0:.1f} s')
        first = run_taco_trainer(root, 'a', 6, 4, 6, restore=False)
        log_dir = os.path.join(root, 'logs-a')
        losses = [first['steps'].get(i, (0, float('nan')))[1] for i in range(1, 7)]
        evals = re.findall(r'Eval losses: (.*)', first['out'])
        wavs = ['eval-dir/wavs/step-4-eval-wave-from-mel.wav',
                'eval-dir/wavs/step-4-eval-wave-from-linear.wav', 'wavs/step-6-wave-from-mel.wav']
        wav_ok = {w: os.path.isfile(os.path.join(log_dir, w))
                  and _wav_ok(os.path.join(log_dir, w)) for w in wavs}
        gib = first['peak_bytes'] / 2 ** 30
        logged = logged_step_times(first['steps'], 1)
        phase(12, f'train --model Tacotron, default hparams (batch {hp.tacotron_batch_size}, '
                  f'{TACO_UTTERANCES} utterances of 1-2 s, one test batch): 6 steps in '
                  f'{first["seconds"]:.1f} s of wall with one eval and one checkpoint; losses '
                  f'{losses}; the log\'s step times {sum(logged.values()):.3f} s in all, '
                  f'steps 3 to 6 {fmt_times(logged, range(3, 7))}; peak device memory '
                  f'{gib:.2f} GiB; eval at step 4: {evals}; wavs finite: {wav_ok}')
        if not sum(logged.values()) <= first['seconds']:
            fail('the Tacotron trainer\'s logged step times add up to more than its wall')
        if not all(np.isfinite(l) for l in losses) or sorted(first['steps']) != list(range(1, 7)):
            fail(f'the Tacotron trainer\'s losses are not finite or a step is missing: '
                 f'{first["steps"]}')
        if len(evals) != 1 or not all(wav_ok.values()):
            fail('the Tacotron trainer did not evaluate once or its wavs are not finite')
        if CheckpointManager(first['save_dir']).all_steps() != [6]:
            fail('the Tacotron trainer did not write its checkpoint at step 6')
        if not os.path.isfile(os.path.join(log_dir, 'mel-spectrograms',
                                           'mel-prediction-step-6.npy')):
            fail('the Tacotron trainer did not save the mel of step 6')

        resumed = run_taco_trainer(root, 'a', 8, 4, 6)
        state = tt.create_train_state(hp, 'cuda')
        state.load_state_dict(CheckpointManager(first['save_dir']).restore(6))
        dataset = TacotronDataset(meta, hp, base_dir=root)
        batch = to_device(next(dataset.train_batches(seed=hp.tacotron_data_random_state)),
                          'cuda')
        gen = torch.Generator('cuda').manual_seed(step_seed(hp.tacotron_random_seed, 6))
        loss7 = tt.train_step(state, batch, hp, gen)['loss'].item()
        logged7 = resumed['steps'].get(7, (0, float('nan')))[1]
        phase(12, f'resumed from step 6 to 8 in {resumed["seconds"]:.1f} s: restored: '
                  f'{"Loading checkpoint at step 6" in resumed["out"]}; step 7 logged loss '
                  f'{logged7:.5f}, an in-process train_step from the checkpoint on the same '
                  f'batch {loss7:.5f}')
        if 'Loading checkpoint at step 6' not in resumed['out'] \
                or sorted(resumed['steps']) != [7, 8]:
            fail('the Tacotron rerun did not restore step 6 and step to 8')
        if not abs(loss7 - logged7) <= 1e-4:
            fail(f'step 7 of the resumed Tacotron run logged {logged7}, an in-process step '
                 f'gives {loss7}')
        if CheckpointManager(first['save_dir']).all_steps() != [6, 8]:
            fail('the resumed Tacotron run did not write its checkpoint at step 8')
        synced = taco_synced_steps(state, dataset, hp)
        cpu = taco_cpu_vs_card(hp, batch)
        if not cpu['bwd_loop_launches']:
            fail('the card\'s f32 Tacotron train step did not run its decoder backward '
                 'through decoder_bwd_loop_f32')
        if not all(cpu['gru_launches'].get(k) for k in ('gru_fwd_loop', 'gru_bwd_loop')):
            fail('the card\'s f32 Tacotron train step did not run the CBHG\'s GRUs through '
                 'gru_fwd_loop and gru_bwd_loop')
        if not all(cpu['lstm_launches'].get(k) for k in ('lstm_fwd_loop', 'lstm_bwd_loop')):
            fail('the card\'s f32 Tacotron train step did not run the encoder LSTM through '
                 'lstm_fwd_loop and lstm_bwd_loop')
        scheduled = taco_f32_scheduled(root)
    reset_decoder_counts()
    timed = taco_timed_step(hp)
    read_decoder_counts(TACO_F32_TIMED_PATH)
    lo, hi = F32_FWD_LOOP_TIMED['bwd']
    phase(12, f'the f32 decoder backward (StepMarks) {timed["parts"]["bwd: decoder"]:.1f} ms '
              f'({timed["part_ranges"]["bwd: decoder"][0]:.1f}-'
              f'{timed["part_ranges"]["bwd: decoder"][1]:.1f}) through decoder_bwd_loop_f32, '
              f'{DECODER_LAUNCHES_BY_PATH[TACO_F32_TIMED_PATH]["decoder_bwd_loop_f32"]} '
              f'launches; with the step loop\'s backward (lstm_cell_bwd, attention_bwd) it read '
              f'{lo}-{hi} ms')
    return dict(sec_step=float(np.median(list(synced.values()))), peak_gib=gib,
                losses=losses, loss7=loss7, logged7=logged7, cpu_vs_card=cpu, timed=timed,
                scheduled=scheduled)


def taco_synced_steps(state, dataset, hp, n=5):
    """n train steps of `state` on the corpus's batches (1-2 s utterances, B=32), each
    between two synchronizes. Returns {frames of the batch: seconds} in step order."""
    from tacotron2_tpu_torch.training import tacotron_trainer as tt
    from tacotron2_tpu_torch.training.common import to_device

    batches = dataset.train_batches(seed=hp.tacotron_data_random_state + 1)
    gen = torch.Generator('cuda').manual_seed(7)
    secs, frames = [], []
    for _ in range(n):
        batch = to_device(next(batches), 'cuda')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tt.train_step(state, batch, hp, gen, dtype=torch.float32)['loss'].item()
        secs.append(time.perf_counter() - t0)
        frames.append(batch['mel_targets'].shape[1])
    phase(12, f'{n} more f32 train steps on the corpus\'s batches (B={hp.tacotron_batch_size}, '
              f'{frames} frames), each between two synchronizes: median '
              f'{np.median(secs):.3f} sec/step ({min(secs):.3f}-{max(secs):.3f}; '
              + ', '.join(f'{t:.3f}' for t in secs) + ')')
    return dict(zip(range(n), secs))


# --- phase 13: the Tacotron-2 pipeline ----------------------------------------------

PIPE_UTTERANCES = 64   # 32 to train the Tacotron on and its one test batch of 32
# the eval settings of both trainers: phase 12's Tacotron test split, and the WaveNet's
# autoregressive natural eval on the EMA weights (off by default), which launches the
# AR kernel; EMA decay 0.5 so that the eval's weights are the trained ones after 2 steps
PIPE_OVERRIDES = TACO_OVERRIDES + ',wavenet_natural_eval=True,wavenet_ema_decay=0.5'
PIPE_PATH = 'train --model Tacotron-2 (natural eval)'
PIPE_WAVENET_PATH = 'synthesize --model WaveNet --name'
PIPE_TACOTRON2_PATH = 'synthesize --model Tacotron-2 --name'
PIPE_PATHS = (PIPE_PATH, PIPE_WAVENET_PATH, PIPE_TACOTRON2_PATH)
# the eval launch against the plain version over its first PIPE_EVAL_BOUNDS[-1] steps,
# in state-carried chunks at odd ends: all of the launch's hp.max_time_steps = 11,000
# (run eagerly, the plain version took 5-19 ms a step of host time, and the check
# followed the first CUT_STEPS until it ran as a CUDA graph)
PIPE_EVAL_BOUNDS = (377, 731, CUT_STEPS, 11000)
# a WaveNet two steps from its initial weights gives params that span less than the
# seeded weights' (about 1) that KERNEL_TOL was read on: the eval launch's params are
# held to PIPE_EVAL_TOL_PER_SPAN of their span, the same share, and each planted fault
# (weights as a kernel with one bug would read them, over the first PIPE_FAULT_STEPS
# steps) must move them further than that. Read on an H100 80GB HBM3 at 700 W: span
# 0.621, the kernel 1.1e-3 from the plain version (tol 6.2e-3), the faults 0.413 and
# 1.9e-2
PIPE_EVAL_TOL_PER_SPAN = KERNEL_TOL
PIPE_FAULTS = ('conditioning dropped', 'past ring taps swapped')
PIPE_FAULT_STEPS = 275
PIPE_SENTENCES = ('Scientists at the CERN laboratory say they have discovered a new '
                  'particle.', 'He reads books.')
PIPE_CLI_MAX_ITERS = 128
# one GTA batch on the card against the CPU on the same weights, targets and prenet
# masks (f32, TF32 off), read on an H100 80GB HBM3 at 700 W: the mels (span 8.1, 192
# frames, a 192-step recurrence) 4.3e-6 apart at most; bounded at about 25x that
PIPE_GTA_TOL = 1e-4


def make_ljspeech(base, hp, n, seed):
    """`base/LJSpeech-1.1/{metadata.csv,wavs/*.wav}` made from `seed`: n utterances of
    1 to 2 s, int16 at hp.sample_rate (two gliding tones and noise, as
    make_taco_corpus makes them), `name|text|text` rows with texts from sentences.txt."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    with open(os.path.join(REPO, 'sentences.txt'), encoding='utf-8') as f:
        texts = [line.strip() for line in f if line.strip()]
    root = os.path.join(base, 'LJSpeech-1.1')
    os.makedirs(os.path.join(root, 'wavs'))
    rows = []
    for i in range(n):
        t = np.arange(int(rng.uniform(1.0, 2.0) * hp.sample_rate)) / hp.sample_rate
        wav = (0.4 * np.sin(2 * np.pi * (180 + 20 * i) * t * (1 + 0.2 * np.sin(3 * t)))
               + 0.2 * np.sin(2 * np.pi * (900 + 35 * i) * t)
               + 0.02 * rng.standard_normal(len(t)))
        wavfile.write(os.path.join(root, 'wavs', f'LJ-{i:04d}.wav'), hp.sample_rate,
                      (wav * 32767 / max(1.0, np.abs(wav).max())).astype(np.int16))
        text = texts[i % len(texts)]
        rows.append(f'LJ-{i:04d}|{text}|{text}')
    with open(os.path.join(root, 'metadata.csv'), 'w', encoding='utf-8') as f:
        f.write('\n'.join(rows) + '\n')


def run_module(module, args, cwd):
    """`python -m <module> <args>` from `cwd` with the repo on the path; fails with its
    output unless it exits 0. Returns (stdout, seconds)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH', ''))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, '-m', module, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f'python -m {module} exited {res.returncode}:\n{res.stdout[-3000:]}\n'
             f'{res.stderr[-3000:]}')
    return res.stdout, time.perf_counter() - t0


def pipe_preprocess(base, hp):
    """Step 1: the corpus through `python -m tacotron2_tpu_torch.preprocess` and
    `python -m tacotron2_tpu_torch.wavenet_preprocess` (whose validate_alignment checks
    its own output). Returns the train.txt rows and the seconds."""
    t0 = time.perf_counter()
    make_ljspeech(base, hp, PIPE_UTTERANCES, seed=13)
    made = time.perf_counter() - t0
    out, secs = run_module('tacotron2_tpu_torch.preprocess', ['--base_dir', base], base)
    with open(os.path.join(base, 'training_data', 'train.txt'), encoding='utf-8') as f:
        rows = [line.rstrip('\n').split('|') for line in f]
    hop = hp.get_hop_size()
    bad = [r[0] for r in rows if len(np.load(os.path.join(base, 'training_data', 'audio', r[0])))
           != int(r[4]) * hop or int(r[3]) != int(r[4]) * hop]
    wn_out, wn_secs = run_module(
        'tacotron2_tpu_torch.wavenet_preprocess',
        ['--base_dir', base, '--input_dir', 'LJSpeech-1.1/wavs', '--output', 'wavenet_data'],
        base)
    frames = [int(r[4]) for r in rows]
    phase(13, f'corpus of {PIPE_UTTERANCES} wavs of 1-2 s made in {made:.1f} s; '
              f'python -m tacotron2_tpu_torch.preprocess: {len(rows)} rows ({min(frames)} to '
              f'{max(frames)} frames) in {secs:.1f} s ({out.strip().splitlines()[0]}); audio '
              f'of frames x hop samples in every row: {not bad}; python -m '
              f'tacotron2_tpu_torch.wavenet_preprocess in {wn_secs:.1f} s: '
              f'{wn_out.strip().splitlines()[-1]}')
    if len(rows) != PIPE_UTTERANCES or bad:
        fail(f'preprocessing wrote {len(rows)} rows, misaligned: {bad}')
    if f'alignment validated for {PIPE_UTTERANCES} examples' not in wn_out:
        fail('wavenet_preprocess did not validate its alignment')
    return rows, made + secs + wn_secs


def run_pipeline_cli(base, calls=None, path=None):
    """`python -m tacotron2_tpu_torch.train --model Tacotron-2` on the card: 2 steps of
    each trainer with an eval at step 2, console captured, the AR launches recorded by
    ar_timer into `calls` and counted for `path`, and with a `path` the decoder kernels'
    launches of its GTA synthesis counted for PIPE_GTA_PATH, the rest for PIPE_TACO_PATH.
    Returns (output, seconds)."""
    from tacotron2_tpu_torch import train
    from tacotron2_tpu_torch.inference import tacotron_synthesizer
    from tacotron2_tpu_torch.ops import decoder_vjp, gru_scan, lstm_scan

    reset_counts()
    reset_decoder_counts()
    gta, gta_gru, gta_lstm = collections.Counter(), collections.Counter(), collections.Counter()
    synthesize = tacotron_synthesizer.tacotron_synthesize

    def counted(*args, **kwargs):
        before = collections.Counter(decoder_vjp.LAUNCHES)
        before_gru = collections.Counter(gru_scan.LAUNCHES)
        before_lstm = collections.Counter(lstm_scan.LAUNCHES)
        try:
            return synthesize(*args, **kwargs)
        finally:
            gta.update(collections.Counter(decoder_vjp.LAUNCHES) - before)
            gta_gru.update(collections.Counter(gru_scan.LAUNCHES) - before_gru)
            gta_lstm.update(collections.Counter(lstm_scan.LAUNCHES) - before_lstm)

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), ar_timer(calls), \
            _patched(tacotron_synthesizer, 'tacotron_synthesize', counted):
        train.main(['--model', 'Tacotron-2', '--base_dir', base, '--name', 'pipe',
                    '--tacotron_train_steps', '2', '--wavenet_train_steps', '2',
                    '--eval_interval', '2', '--checkpoint_interval', '2',
                    '--summary_interval', '1', '--hparams', PIPE_OVERRIDES,
                    '--device', 'cuda'])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    read_counts(path)
    if path is not None:
        DECODER_LAUNCHES_BY_PATH[PIPE_GTA_PATH].update(gta)
        DECODER_LAUNCHES_BY_PATH[PIPE_TACO_PATH].update(
            collections.Counter(decoder_vjp.LAUNCHES) - gta)
        GRU_LAUNCHES_BY_PATH[PIPE_GTA_PATH].update(gta_gru)
        GRU_LAUNCHES_BY_PATH[PIPE_TACO_PATH].update(
            collections.Counter(gru_scan.LAUNCHES) - gta_gru)
        LSTM_LAUNCHES_BY_PATH[PIPE_GTA_PATH].update(gta_lstm)
        LSTM_LAUNCHES_BY_PATH[PIPE_TACO_PATH].update(
            collections.Counter(lstm_scan.LAUNCHES) - gta_lstm)
    return out.getvalue(), seconds


def pipe_gta_cpu_vs_card(base, hp, row):
    """One GTA batch (the pipeline's: tacotron_synthesis_batch_size rows) on the card
    against the CPU, the trained checkpoint on both, the same targets and prenet masks
    (drawn on the CPU and copied). Returns the readings."""
    from tacotron2_tpu_torch.convert import load_tacotron
    from tacotron2_tpu_torch.inference.tacotron_synthesizer import Synthesizer

    ckpt = os.path.join(base, 'logs-pipe', 'taco_pretrained')
    synths = {d: Synthesizer(load_tacotron(ckpt, hp).to(d), hp, d, gta=True)
              for d in ('cpu', 'cuda')}
    _, inputs, lengths = synths['cpu']._prepare_text_batch([row[5]])
    targets, _ = synths['cpu'].gta_targets(
        [os.path.join(base, 'training_data', 'mels', row[1])] * len(inputs))
    B, T_in = inputs.shape
    noise = synths['cpu']._model.draw_noise(B, T_in, targets.shape[1],
                                            torch.Generator().manual_seed(hp.tacotron_random_seed),
                                            True, 'cpu')
    mels, secs = {}, {}
    for d, s in synths.items():
        t0 = time.perf_counter()
        with torch.no_grad():
            out = s._model.teacher_forced(
                torch.from_numpy(inputs).to(d), torch.from_numpy(lengths).to(d),
                torch.from_numpy(targets).to(d), {k: v.to(d) for k, v in noise.items()},
                deterministic=True, teacher_forcing_ratio=1.0, predict_linear=False,
                dtype=torch.float32)
        mels[d] = out['mel_outputs'].cpu()
        secs[d] = time.perf_counter() - t0
    err = (mels['cuda'] - mels['cpu']).abs().max().item()
    span = (mels['cpu'].max() - mels['cpu'].min()).item()
    phase(13, f'one GTA batch, card vs CPU (B={B}, T_in={T_in}, {targets.shape[1]} frames, '
              f'the trained checkpoint, the same targets and prenet masks, TF32 off): mel '
              f'max abs err {err:.3e} (tol {PIPE_GTA_TOL}, mels span {span:.3f}); '
              f'{secs["cuda"]:.3f} s on the card, {secs["cpu"]:.3f} s on the CPU')
    if not err <= PIPE_GTA_TOL:
        fail('the card\'s GTA batch disagrees with the CPU\'s')
    return dict(max_abs_err=err, span=span, card_s=secs['cuda'], cpu_s=secs['cpu'])


def pipe_eval_vs_plain(call):
    """Step 3: the pipeline's eval launch (gaussian-fused with params, B=1 over
    hp.max_time_steps) on the inputs it had: a further launch repeats its audio and
    params bit for bit; over its first PIPE_EVAL_BOUNDS[-1] steps, in state-carried
    chunks, the kernel against the plain version teacher-forced on the kernel's audio
    (params within PIPE_EVAL_TOL_PER_SPAN of their span, the carried state within
    KERNEL_TOL, as phase 10 holds it); and PIPE_FAULTS planted in the weights over the
    first PIPE_FAULT_STEPS steps, each of which the check must see. Returns the
    readings."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    hp, weights, c_up, noise = call['hp'], call['weights'], call['c_up'], call['noise']
    B, T = c_up.shape[:2]
    if (B, T) != (1, hp.max_time_steps) or call['g_cond'] is not None \
            or not call['kw'].get('return_params') or call['second'] is None:
        fail(f'the pipeline\'s eval launch was B={B}, T={T}, {call["kw"]}')
    (audio, params), ms = cuda_ms(lambda: wavenet_ar.generate_ar(weights, c_up, noise, hp))
    if not (torch.equal(audio, call['audio']) and torch.equal(params, call['second'])):
        fail('a launch on the pipeline\'s eval inputs does not repeat its audio and params')
    steps = PIPE_EVAL_BOUNDS[-1]
    r = state_carry(weights, c_up, noise, hp, PIPE_EVAL_BOUNDS, plant=False)
    if not (torch.equal(r['audio'], audio[:, :steps])
            and torch.equal(r['params'], params[:, :steps])):
        fail('the check\'s chunked launch does not repeat the start of the pipeline\'s')
    span = (r['ref_params'].max() - r['ref_params'].min()).item()
    tol = PIPE_EVAL_TOL_PER_SPAN * span
    faults = {}
    for fault in PIPE_FAULTS:
        name, plant = planted_faults(hp)[fault]
        faults[fault] = params_err(
            weights, c_up[:, :PIPE_FAULT_STEPS].contiguous(),
            noise[:, :PIPE_FAULT_STEPS].contiguous(), hp,
            plant=dict(weights={**weights, name: plant(weights[name])})).max().item()
    what = f'{wavenet_ar.variant(hp)}, B=1, on the inputs of the pipeline\'s eval launch'
    phase(13, f'{what} (all {T} steps repeat bit for bit at {1000 * ms / T:.1f} us/step), '
              f'the first {steps} in chunks ending at {list(PIPE_EVAL_BOUNDS)}: bit-identical '
              f'to one call: {r["bit_identical"]}; params max_abs_err={r["max_abs_err"]:.3e} '
              f'(params span {span:.4f}, tol {PIPE_EVAL_TOL_PER_SPAN} of it = {tol:.3e}); '
              f'state after chunk 1 {r["state_err"]:.3e} (tol {KERNEL_TOL}); planted faults '
              f'over {PIPE_FAULT_STEPS} steps: '
              + ', '.join(f'{f} {e:.3e}' for f, e in faults.items())
              + f' (each must exceed {tol:.3e}); kernel {1000 * r["ms"] / steps:.1f} us/step '
              f'chunked, plain {1000 * r["plain_ms"] / steps:.1f} us/step')
    if not (r['bit_identical'] and r['audio_ok']):
        fail(f'{what}: chunked kernel output differs from one call or leaves its range')
    if not (r['max_abs_err'] <= tol and r['state_err'] <= KERNEL_TOL):
        fail(f'{what}: the kernel differs from the plain version')
    missed = [f for f, e in faults.items() if not e > tol]
    if missed:
        fail(f'{what}: the check passes planted faults: {missed}')
    bound_ms, bound_by = ar_bound(hp, weights, B, T)
    return dict(max_abs_err=r['max_abs_err'], state_err=r['state_err'], span=span, tol=tol,
                steps=steps, full_steps=T, ms=ms, full_us_step=1000 * ms / T,
                plain_ms=r['plain_ms'], plain_us_step=1000 * r['plain_ms'] / steps,
                faults=faults, bound_ms=bound_ms, bound_by=bound_by)


def cli_run(base, argv, path=None):
    """`python -m tacotron2_tpu_torch.synthesize <argv>` on the card in process, its
    AR launches counted for `path`. Returns (what main returns, launches, seconds)."""
    from tacotron2_tpu_torch import synthesize

    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = synthesize.main(argv + ['--base_dir', base, '--device', 'cuda'])
    torch.cuda.synchronize()
    return out, read_counts(path), time.perf_counter() - t0


def pipe_cli(base, hp):
    """Step 4: the JAX command lines with run names only, on a run `cli` that holds the
    pipeline's checkpoints, its Tacotron's stop tokens suppressed (random weights two
    steps trained: the decode must run max_iters steps). Returns the readings."""
    from tacotron2_tpu_torch.training.checkpointing import CheckpointManager
    from tacotron2_tpu_torch.utils import suppress_stop_tokens

    src = CheckpointManager(os.path.join(base, 'logs-pipe', 'taco_pretrained'))
    state = src.restore()
    state['model'] = suppress_stop_tokens(state['model'])
    CheckpointManager(os.path.join(base, 'logs-cli', 'taco_pretrained')).save(state['step'], state)
    wave = CheckpointManager(os.path.join(base, 'logs-pipe', 'wave_pretrained'))
    CheckpointManager(os.path.join(base, 'logs-cli', 'wave_pretrained')).save(
        wave.latest_step(), wave.restore())
    texts = os.path.join(base, 'sentences.txt')
    with open(texts, 'w', encoding='utf-8') as f:
        f.write('\n'.join(PIPE_SENTENCES) + '\n')
    common = ['--name', 'cli', '--text_list', texts, '--hparams',
              f'max_iters={PIPE_CLI_MAX_ITERS},tacotron_synthesis_batch_size=2']
    reset_decoder_counts()
    eval_dir, taco_launches, taco_s = cli_run(
        base, ['--model', 'Tacotron', '--mode', 'eval'] + common)
    read_decoder_counts(TACO_EVAL_CLI_PATH)
    reset_decoder_counts()
    with _patched(sys, 'stdin', io.StringIO(PIPE_SENTENCES[1] + '\n')):
        _, live_launches, live_s = cli_run(
            base, ['--model', 'Tacotron', '--mode', 'live'] + common[:2] + common[4:])
    read_decoder_counts(TACO_LIVE_CLI_PATH)
    live_wav = os.path.join(base, 'live_out', 'wavs', 'wav-live_0-mel.wav')
    with open(os.path.join(eval_dir, 'map.txt'), encoding='utf-8') as f:
        rows = [line.rstrip('\n').split('|') for line in f]
    mels = [np.load(r[1]) for r in rows]
    wav_dir = os.path.join(base, 'tacotron_output', 'logs-eval', 'wavs')
    wavs = sorted(os.listdir(wav_dir))
    frames = PIPE_CLI_MAX_ITERS * hp.outputs_per_step
    lo, hi = -hp.max_abs_value, hp.max_abs_value
    ok = ([r[0] for r in rows] == list(PIPE_SENTENCES)
          and all(m.shape == (frames, hp.num_mels) and np.isfinite(m).all()
                  and m.min() >= lo and m.max() <= hi for m in mels)
          and wavs == sorted(f'wav-batch_0_sentence_{j}-{k}.wav' for j in range(2)
                             for k in ('mel', 'linear'))
          and all(_wav_ok(os.path.join(wav_dir, w)) for w in wavs))
    vocoded, wave_launches, wave_s = cli_run(
        base, ['--model', 'WaveNet', '--name', 'cli', '--mels_dir', 'tacotron_output/eval'],
        PIPE_WAVENET_PATH)
    hop = hp.get_hop_size()
    ok_wave = ([len(w) for w in vocoded['wavs']] == [frames * hop] * 2
               and all(np.isfinite(w).all() and np.abs(w).max() <= 1.0 for w in vocoded['wavs']))
    reset_decoder_counts()
    e2e, e2e_launches, e2e_s = cli_run(
        base, ['--model', 'Tacotron-2', '--output_dir', os.path.join(base, 'e2e')] + common,
        PIPE_TACOTRON2_PATH)
    read_decoder_counts(PIPE_TACOTRON2_PATH)
    ok_e2e = [len(w) for w in e2e['wavs']] == [frames * hop] * 2 \
        and all(np.isfinite(w).all() for w in e2e['wavs'])
    ok_live = os.path.isfile(live_wav) and _wav_ok(live_wav)
    phase(13, f'synthesize --model Tacotron --mode eval --name cli ({len(rows)} sentences, '
              f'max_iters={PIPE_CLI_MAX_ITERS}): {len(mels)} mels of {frames} frames, map.txt, '
              f'{len(wavs)} Griffin-Lim wavs in {taco_s:.1f} s, AR launches {taco_launches}; '
              f'--mode live on one line of stdin: {live_wav} in {live_s:.1f} s, finite: '
              f'{ok_live}; '
              f'--model WaveNet --mels_dir tacotron_output/eval: {len(vocoded["wavs"])} wavs '
              f'in {wave_s:.1f} s, AR launches {wave_launches}; --model Tacotron-2: '
              f'{len(e2e["wavs"])} wavs in {e2e_s:.1f} s, AR launches {e2e_launches}; '
              f'outputs as expected: {ok}, {ok_wave}, {ok_e2e}')
    if not (ok and ok_wave and ok_e2e and ok_live):
        fail('a run-name command line wrote the wrong outputs')
    if (taco_launches, live_launches, wave_launches, e2e_launches) != (0, 0, 1, 1):
        fail('the run-name command lines should launch the AR kernel 0, 0, 1 and 1 times')
    return dict(wavenet_launches=wave_launches, tacotron2_launches=e2e_launches,
                seconds=taco_s + live_s + wave_s + e2e_s, taco_s=taco_s, live_s=live_s,
                wave_s=wave_s, e2e_s=e2e_s)


def tacotron2_pipeline(t_start):
    """Phase 13 (see the module docstring). Returns the readings."""
    from tacotron2_tpu_torch import train
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.ops import wavenet_ar

    hp = default_hparams()
    hp.parse(PIPE_OVERRIDES)
    t13 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='t2torch_pipe_') as base:
        rows, pre_s = pipe_preprocess(base, hp)
        calls = []
        out, pipe_s = run_pipeline_cli(base, calls, PIPE_PATH)
        launches = dict(wavenet_ar.LAUNCHES_BY_VARIANT)
        state_file = os.path.join(base, 'logs-pipe', 'state_log')
        gta_map = os.path.join(base, 'tacotron_output', 'gta', 'map.txt')
        with open(state_file, encoding='utf-8') as f:
            state = f.read()
        with open(gta_map, encoding='utf-8') as f:
            gta_rows = [line.rstrip('\n').split('|') for line in f]
        lo, hi = -hp.max_abs_value, hp.max_abs_value
        bad = []
        for row, g in zip(rows, gta_rows):
            mel = np.load(g[2])
            if mel.shape != (int(row[4]), hp.num_mels) or not np.isfinite(mel).all() \
                    or mel.min() < lo or mel.max() > hi:
                bad.append(g[2])
        gta_lines = re.findall(r'Synthesized batch \d+/\d+ in ([0-9.]+) sec', out)
        gta_s = sum(float(x) for x in gta_lines)
        phase(13, f'python -m tacotron2_tpu_torch.train --model Tacotron-2 (default hparams, '
                  f'{PIPE_OVERRIDES}; 2 steps of each trainer, an eval at step 2) in '
                  f'{pipe_s:.1f} s: state_log {state!r}; GTA map rows {len(gta_rows)} for '
                  f'{len(rows)} train.txt rows, each mel of its target\'s frame count and in '
                  f'[{lo}, {hi}]: {not bad}; GTA {gta_s:.1f} s for {len(gta_lines)} batches of '
                  f'{hp.tacotron_synthesis_batch_size} ({gta_s / max(1, len(gta_rows)):.3f} s '
                  f'an utterance); AR launches {launches}')
        if state != f'1|1|1|{gta_map}' or len(gta_rows) != len(rows) or bad \
                or [g[1] for g in gta_rows] != [os.path.join(base, 'training_data', 'mels', r[1])
                                                for r in rows]:
            fail(f'the pipeline\'s state_log or GTA map is wrong: {state!r}, {bad}')
        if f'Loading training data from: {gta_map}' not in out \
                or 'Eval (natural) loss' not in out or launches != {'gaussian-fused': 1}:
            fail('the WaveNet phase did not train on the GTA map or launch one natural eval')
        again, again_s = run_pipeline_cli(base)
        phase(13, f'rerun in {again_s:.2f} s: '
                  f'{"nothing to do" in again and "# Phase" not in again}')
        if 'nothing to do' not in again or '# Phase' in again:
            fail('a rerun of the finished pipeline did not return at once')
        gta = pipe_gta_cpu_vs_card(base, hp, rows[0])
        t_eval = time.perf_counter()
        eval_launch = pipe_eval_vs_plain(calls[0])
        eval_s = time.perf_counter() - t_eval
        cli = pipe_cli(base, hp)
    total = time.perf_counter() - t13
    phase(13, f'steps, wall seconds: preprocessing {pre_s:.1f}, the pipeline {pipe_s:.1f} (GTA '
              f'{gta_s:.1f}), its rerun {again_s:.2f}, the eval launch vs plain {eval_s:.1f}, the '
              f'run-name command lines {cli["seconds"]:.1f}; phase 13 took {total:.1f} s; the '
              f'whole run {time.perf_counter() - t_start:.1f} s')
    return dict(launches=launches['gaussian-fused'], eval_launch=eval_launch, gta=gta, cli=cli,
                seconds=total, pipe_s=pipe_s, gta_s_per_utterance=gta_s / len(gta_rows),
                pre_s=pre_s)


# --- phase 14: bf16 training, the remaining upsamplers, any decoder depth ---------------

# the card's bf16 train step against the port's own bf16 step on the CPU: the batch cut
# so that the CPU's eager bf16 step fits the time (full width, depth and vocabulary)
BF16_TACO_CUT = (4, 16, 30)        # rows, mel frames, characters
BF16_WAVENET_CUT = (1, 2750)       # rows, samples
BF16_WAVENET_BATCH = (8, 11000)    # the trainer's default batch and crop
# bf16 against f32 on the card, the same state, batch and draws: the losses within
# BF16_LOSS_TOL relative and the gradients (Adam's first moment) within BF16_GRAD_TOL in
# relative L2 norm. The card's bf16 step against the port's bf16 on the CPU, the check
# with teeth, module by module: each module of BF16_MODULES, run on the CPU in bf16 on
# the inputs it had in the card's step, must give the card's output within
# BF16_MODULE_TOL in relative L2, where that module's own bf16-f32 gap is printed
# beside it (BF16_EVAL_FORM: in eval form); a copy of the step with one module left in
# f32 (BF16_FAULTS) must miss it.
# The whole step cannot be the check: read on an H100 80GB HBM3 at 700 W, the two
# devices' bf16 outputs of the cut step are 1.8e-2 (Tacotron) and
# 7.8e-3 (WaveNet) apart where the bf16-f32 gap is 2.4e-2 and 9.6e-3: each bf16 product
# rounds differently in 1e-4 of its elements on the two devices (a reduction order of
# its own), and every later layer's rounding carries a flip further, until the two
# differ as much as any two bf16 runs. Those whole-step readings are printed.
# The bf16 backward is held by BF16_GRAD_TOL: the sound step reads 2.35e-2 against f32
# (Tacotron; WaveNet 3.7e-3), and a decoder whose weights, cast once a scan, sum their
# steps' gradients in bf16 read 1.07e-1 (an H100 80GB HBM3 at 700 W); the bound sits
# about 2x from each, and that fault is planted (precast_fault)
BF16_LOSS_TOL = 2e-2
BF16_GRAD_TOL = 5e-2
BF16_MODULE_TOL = 1e-3
BF16_MODULES = {'tacotron': ('encoder_convolutions.convs.0', 'encoder_lstm', 'decoder.prenet',
                             'decoder.lstm_1', 'decoder.lstm_2', 'decoder.attention',
                             'postnet_convolutions.convs.0', 'postnet_convolutions.convs.4',
                             'cbhg_postnet.bank.3', 'cbhg_postnet.proj1',
                             'cbhg_postnet.highways.0'),
                'wavenet': ('upsample', 'first_conv', 'residual_layers.0',
                            'residual_layers.10', 'residual_layers.19', 'skip_conv1',
                            'skip_conv2')}
# The modules are single layers: within a stack of layers the flips compound from the
# second layer on (each output sums thousands of inputs, a few of them flipped), as they
# do over the whole step (read on whole stacks in eval form on an H100 80GB HBM3 at
# 700 W: the encoder convs 1.2e-3, the post-net 2.4e-3, the CBHG 4.1e-3, where their
# bf16-f32 gaps are 4.6e-3 to 7.7e-3). The conv blocks, whose BatchNorm runs over the batch in training,
# are compared in their eval form, over running statistics: over the cut batch's 64-120
# samples a channel the ReLU leaves nearly dead has a variance near zero, and dividing
# by it carries one flipped rounding as far as bf16 itself goes
BF16_EVAL_FORM = ('encoder_convolutions.convs.0', 'postnet_convolutions.convs.0',
                  'postnet_convolutions.convs.4', 'cbhg_postnet.bank.3', 'cbhg_postnet.proj1')
BF16_FAULTS = {'tacotron': 'the decoder\'s LSTM gate products left in f32',
               'wavenet': 'the 1x1 convs left in f32'}
# each new upsampler through the AR kernel by `synthesize --model WaveNet`, the launch
# held to the plain version in state-carried chunks (KERNEL_TOL): UPSAMPLER_FULL's over
# its first UPSAMPLER_BOUNDS[-1] steps with the two planted state faults, the others'
# over UPSAMPLER_SHORT_BOUNDS[-1] (each launch runs the same instantiation, and the
# plain version's 6-11 ms a step of host time, run eagerly, set phase 14's length: 63.8 s
# and 204.5 s for four upsamplers over 1,100 steps each, in two runs on an H100 80GB HBM3
# at 700 W);
# the upsampler's output on the card to its CPU output
UPSAMPLERS = {'NearestNeighbor': "upsample_type='NearestNeighbor'",
              '1D': "upsample_type='1D'",
              'Resize': "upsample_type='Resize'",
              '2D, LeakyRelu': "upsample_type='2D',upsample_activation='LeakyRelu'"}
UPSAMPLER_FULL = 'Resize'
UPSAMPLER_BOUNDS = VOCODER_BOUNDS
UPSAMPLER_SHORT_BOUNDS = (131, 253, 377)
UPSAMPLER_TOL = 1e-4               # the upsampler's card output against its CPU output
UPSAMPLER_PATHS = tuple(f'synthesize --model WaveNet ({k})' for k in UPSAMPLERS)
DEPTH3 = 'prenet_layers=[256,256,256],decoder_layers=3'
DEPTH3_GTA = (2, 128, 60)          # the GTA batch: rows, mel frames, characters
DEPTH3_STEP = (4, 128, 60)         # the card-vs-CPU f32 step: rows, frames, characters
DEPTH3_REMAT = (32, 64, 60)        # the remat step: rows, frames, characters
# remat against no remat on the card: the gradients within REMAT_TOL in relative L2, f32
# rounding (on the CPU they are bit-identical, tests/test_torch_decoder_depth.py; the
# card's backward is not run-to-run bit-identical: on an H100 80GB HBM3 at 700 W 6.8e-7
# in relative L2 with remat, and 6.8e-7 without it run twice)
REMAT_TOL = 1e-6


def _grads(state, beta1):
    """The gradients of a state one step old, from Adam's first moment."""
    return torch.cat([m.flatten().double().cpu() for m in state.exp_avg]) / (1 - beta1)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _on(device, x):
    if isinstance(x, (list, tuple)):
        return [_on(device, y) for y in x]
    return x.to(device)


def _move(x, device):
    """Every tensor in x (nested lists, tuples, dicts) detached and copied to `device`."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, (list, tuple)):
        return type(x)(_move(y, device) for y in x)
    if isinstance(x, dict):
        return {k: _move(v, device) for k, v in x.items()}
    return x


def _floats(x):
    """The float tensors of a module's output, flattened, in order."""
    if isinstance(x, torch.Tensor):
        return [x.double().flatten()] if x.is_floating_point() else []
    return [t for y in (x if isinstance(x, (list, tuple)) else []) for t in _floats(y)]


@contextlib.contextmanager
def module_calls(model, names):
    """Record the inputs and output of the last call of each module `names` of `model`
    (on the CPU, detached): {name: (args, kwargs, output)}."""
    rec, handles = {}, []
    for name in names:
        handles.append(model.get_submodule(name).register_forward_hook(
            lambda m, args, kwargs, out, name=name: rec.__setitem__(
                name, (_move(args, 'cpu'), _move(kwargs, 'cpu'), _move(out, 'cpu'))),
            with_kwargs=True))
    try:
        yield rec
    finally:
        for h in handles:
            h.remove()


def _fresh_model(kind, hp, device):
    """The seeded fresh model of a bf16 step (taco_bf16_step, wavenet_bf16_step) on
    `device`."""
    from tacotron2_tpu_torch.training import tacotron_trainer as tt
    from tacotron2_tpu_torch.training import wavenet_trainer as wt

    if kind == 'tacotron':
        return tt.create_train_state(hp, device, seed=3).model
    return wt.create_train_state(hp, device, seed=4).model


def replay_on_cpu(models, rec):
    """{name: relative L2 of the CPU's bf16 output against the card's} of each module of
    `rec` (module_calls' record of a step on the card) run on the CPU in bf16 on its
    recorded inputs (every dtype argument set to bf16), in `models`, the seeded fresh
    model (_fresh_model) on the CPU and on the card. A module of BF16_EVAL_FORM is
    compared in its eval form (`train` off: BatchNorm over running statistics) on both
    devices, the card's run again in the recorded dtype."""
    cpu, card = models
    errs = {}
    with torch.no_grad():
        for name, (args, kwargs, out) in rec.items():
            if name in BF16_EVAL_FORM:
                args = tuple(False if a is True else a for a in args)
                out = _move(card.get_submodule(name)(*_move(args, 'cuda'),
                                                     **_move(kwargs, 'cuda')), 'cpu')
            bf16 = tuple(torch.bfloat16 if isinstance(a, torch.dtype) else a for a in args)
            kw = {k: torch.bfloat16 if isinstance(v, torch.dtype) else v
                  for k, v in kwargs.items()}
            got = cpu.get_submodule(name)(*bf16, **kw)
            errs[name] = _rel(torch.cat(_floats(got)), torch.cat(_floats(out)))
    return errs


@contextlib.contextmanager
def bf16_fault(model_kind):
    """BF16_FAULTS[model_kind] planted: the module runs in f32 where flax casts to
    bf16."""
    from tacotron2_tpu_torch.models.tacotron.modules import ZoneoutLSTMCell
    from tacotron2_tpu_torch.models.wavenet.modules import Conv1x1

    cls = ZoneoutLSTMCell if model_kind == 'tacotron' else Conv1x1
    forward = cls.forward
    if model_kind == 'tacotron':
        cls.forward = lambda self, state, x, kc=None, kh=None, dtype=None: forward(
            self, state, x, kc, kh, torch.float32)
    else:
        cls.forward = lambda self, x, dtype=None: forward(self, x, torch.float32)
    try:
        yield
    finally:
        cls.forward = forward


@contextlib.contextmanager
def precast_fault():
    """The decoder's weight gradients summed over the steps in bf16, where the port sums
    them in f32. The autograd decoder (`ops/fused_decoder.decoder_scan`): its weights cast
    once a scan (`models/precision.precast`) held in bf16 itself, each step's use widened
    again, so that autograd rounds each step's gradient of a weight to bf16 and sums the
    steps in bf16. The fused decoder (`ops/decoder_vjp`, the default's): each deferred
    weight gradient formed step by step, each step's product rounded to bf16 and the steps
    summed in bf16."""
    from tacotron2_tpu_torch.models import precision
    from tacotron2_tpu_torch.ops import decoder_vjp, fused_decoder

    sound, apply = fused_decoder.precast, precision._apply

    @contextlib.contextmanager
    def bf16_sum(module, dtype):
        with sound(module, dtype):
            for m in module.modules():
                if hasattr(m, '_precast'):
                    m._precast = (dtype, m.weight.to(dtype),
                                  None if m.bias is None else m.bias.to(dtype))
            yield

    def wgrad_steps(dout, inp):
        acc = torch.zeros(dout.shape[-1], inp.shape[-1], device=dout.device,
                          dtype=torch.bfloat16)
        for t in range(dout.shape[0]):
            acc += (dout[t].float().t() @ inp[t].float()).to(torch.bfloat16)
        return acc.float()

    wgrad = decoder_vjp._wgrad
    fused_decoder.precast, decoder_vjp._wgrad = bf16_sum, wgrad_steps
    precision._apply = lambda module, x, w, b: apply(
        module, x, w.to(x.dtype), None if b is None else b.to(x.dtype))
    try:
        yield
    finally:
        fused_decoder.precast, precision._apply = sound, apply
        decoder_vjp._wgrad = wgrad


def taco_bf16_step(hp, batch, device, dtype, noise, fault=False, step=True, rec=None,
                   grad_fault=False):
    """One Tacotron pass in `dtype` on `device` from the seeded fresh state, on `batch`
    with the draws `noise` (made on the CPU): (metrics, gradients) of a train step, or
    with `step` off the training pass's outputs (mels before and after the post-net,
    linear outputs, stop logits, alignments) flattened into one tensor. With `rec` (a
    dict) the step records BF16_MODULES' calls into it; `fault` plants
    BF16_FAULTS['tacotron'], `grad_fault` precast_fault."""
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    state = tt.create_train_state(hp, device, seed=3)
    batch = {k: v.to(device) for k, v in batch.items()}
    noise = {k: _on(device, v) for k, v in noise.items()}
    calls = (module_calls(state.model, BF16_MODULES['tacotron']) if rec is not None
             else contextlib.nullcontext({}))
    with bf16_fault('tacotron') if fault else contextlib.nullcontext(), \
            precast_fault() if grad_fault else contextlib.nullcontext(), calls as got:
        if not step:
            with torch.no_grad():
                out = state.model.teacher_forced(
                    batch['inputs'], batch['input_lengths'], batch['mel_targets'], noise,
                    deterministic=False, dtype=dtype)
            return torch.cat([out[k].flatten().double().cpu() for k in sorted(out)
                              if k != 'stop_finished'])
        m = tt.train_step(state, batch, hp, noise=noise, dtype=dtype)
    if rec is not None:
        rec.update(got)
    return {k: float(m[k]) for k in ('loss', 'grad_norm')}, _grads(state, hp.tacotron_adam_beta1)


def wavenet_bf16_step(hp, batch, device, dtype, masks, fault=False, step=True, rec=None):
    """One WaveNet pass in `dtype` on `device` from the seeded fresh state, on `batch`
    with the dropout masks `masks`: (metrics, gradients) of a train step, or with `step`
    off the training pass's output params. With `rec` (a dict) the step records
    BF16_MODULES' calls into it."""
    from tacotron2_tpu_torch.training import wavenet_trainer as wt

    state = wt.create_train_state(hp, device, seed=4)
    batch = {k: v.to(device) for k, v in batch.items()}
    calls = (module_calls(state.model, BF16_MODULES['wavenet']) if rec is not None
             else contextlib.nullcontext({}))
    with bf16_fault('wavenet') if fault else contextlib.nullcontext(), calls as got:
        if not step:
            with torch.no_grad():
                return wt._forward_loss(state.model, batch, hp, train=True,
                                        dropout_masks=_on(device, masks),
                                        dtype=dtype)[1].flatten().double().cpu()
        m = wt.train_step(state, batch, hp, dropout_masks=_on(device, masks), dtype=dtype)
    if rec is not None:
        rec.update(got)
    return {k: float(m[k]) for k in ('loss', 'grad_norm')}, _grads(state, hp.wavenet_adam_beta1)


def _judge_bf16(what, m, full, cut, outs, modules):
    """Phase 14's checks of one model's bf16 step (see BF16_LOSS_TOL). `full`: {'bf16',
    'f32': (metrics, gradients)} on the card, and for the Tacotron 'grad_fault', the
    bf16 step under precast_fault; `cut`: the same on the cut batch and 'cpu', the
    CPU's bf16; `outs`: the cut batch's forward outputs, {'bf16', 'f32', 'cpu'};
    `modules`: {'bf16', 'f32', 'fault': {module: the CPU's bf16 replay of the card's
    call against its output}}."""
    gap = _rel(full['bf16'][1], full['f32'][1])
    grad_fault = (_rel(full['grad_fault'][1], full['f32'][1]) if 'grad_fault' in full
                  else None)
    loss_gap = abs(full['bf16'][0]['loss'] - full['f32'][0]['loss']) / abs(full['f32'][0]['loss'])
    cut_gap = _rel(cut['bf16'][1], cut['f32'][1])
    device_grad = _rel(cut['bf16'][1], cut['cpu'][1])
    device_loss = abs(cut['bf16'][0]['loss'] - cut['cpu'][0]['loss']) / abs(cut['cpu'][0]['loss'])
    out_gap = _rel(outs['bf16'], outs['f32'])
    device_out = _rel(outs['bf16'], outs['cpu'])
    worst = max(modules['bf16'].values())
    fault = max(modules['fault'].values())
    finite = all(torch.isfinite(g).all() and np.isfinite(list(mm.values())).all()
                 for mm, g in list(full.values()) + list(cut.values())) \
        and all(torch.isfinite(o).all() for o in outs.values())
    phase(14, f'{what}: bf16 vs f32 on the card ({m}): loss rel {loss_gap:.2e} (tol '
              f'{BF16_LOSS_TOL}), gradients {gap:.2e} apart in relative L2 (tol '
              f'{BF16_GRAD_TOL}'
              + (f'; the decoder\'s weight gradients summed in bf16, planted: '
                 f'{grad_fault:.2e}, must exceed it' if grad_fault is not None else '')
              + f'); each module\'s bf16 call of the card\'s cut step run on '
              f'the CPU in bf16, against the card\'s output (tol {BF16_MODULE_TOL}; beside '
              f'it the module\'s f32 call replayed in bf16, its bf16-f32 gap): '
              + ', '.join(f'{k} {v:.1e} ({modules["f32"][k]:.1e})'
                          for k, v in modules['bf16'].items())
              + f'; planted fault ({BF16_FAULTS[what.split()[0]]}): '
              + ', '.join(f'{k} {v:.1e}' for k, v in modules['fault'].items())
              + f' (the worst must exceed the tol); the whole cut step, the card\'s bf16 '
              f'against the CPU\'s: outputs {device_out:.2e} (bf16-f32 gap {out_gap:.2e}), '
              f'gradients {device_grad:.2e} (gap {cut_gap:.2e}), loss rel {device_loss:.2e}; '
              f'all finite: {finite}')
    if not (finite and loss_gap <= BF16_LOSS_TOL and gap <= BF16_GRAD_TOL
            and worst <= BF16_MODULE_TOL):
        fail(f'{what}: the bf16 step disagrees')
    if not fault > BF16_MODULE_TOL:
        fail(f'{what}: the card-vs-CPU bf16 check does not see a module left in f32')
    if grad_fault is not None and not grad_fault > BF16_GRAD_TOL:
        fail(f'{what}: the bf16-f32 gradient check does not see gradients summed in bf16')
    return dict(loss_gap=loss_gap, grad_gap=gap, grad_fault_gap=grad_fault, cut_grad_gap=cut_gap,
                device_grad_err=device_grad, device_loss_err=device_loss, out_gap=out_gap,
                device_out_err=device_out, module_err=modules['bf16'],
                module_gap=modules['f32'], fault_module_err=modules['fault'])


def taco_bf16():
    """Phase 14: the Tacotron train step in bf16 (see the module docstring). Returns the
    readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron

    hp = default_hparams()
    hp.parse(TACO_OVERRIDES)
    draw = Tacotron(hp)

    def noise_for(batch):
        B, T_in = batch['inputs'].shape
        return draw.draw_noise(B, T_in, batch['mel_targets'].shape[1],
                               torch.Generator().manual_seed(8), False, 'cpu')

    full_batch = taco_timed_batch(hp, hp.tacotron_batch_size, TIMED_FRAMES, TIMED_CHARS)
    noise = noise_for(full_batch)
    full = {name: taco_bf16_step(hp, full_batch, 'cuda', dt, noise)
            for name, dt in (('bf16', torch.bfloat16), ('f32', torch.float32))}
    full['grad_fault'] = taco_bf16_step(hp, full_batch, 'cuda', torch.bfloat16, noise,
                                        grad_fault=True)
    B, T, chars = BF16_TACO_CUT
    cut_batch = {k: v.cpu() for k, v in taco_timed_batch(hp, B, T, chars).items()}
    noise = noise_for(cut_batch)
    runs = (('bf16', 'cuda', torch.bfloat16), ('f32', 'cuda', torch.float32),
            ('cpu', 'cpu', torch.bfloat16))
    cut = {name: taco_bf16_step(hp, cut_batch, d, dt, noise) for name, d, dt in runs}
    outs = {name: taco_bf16_step(hp, cut_batch, d, dt, noise, step=False)
            for name, d, dt in runs}
    modules = {}
    fresh = tuple(_fresh_model('tacotron', hp, d) for d in ('cpu', 'cuda'))
    # the decoder's modules run their forward only in the autograd decoder (the fused
    # decoder's step is phase 16's kernels on the cell's weights): the replay's steps run it
    unfused = hp.replace(fused_decoder=False)
    for name, dt, fault in (('bf16', torch.bfloat16, False), ('f32', torch.float32, False),
                            ('fault', torch.bfloat16, True)):
        rec = {}
        taco_bf16_step(unfused, cut_batch, 'cuda', dt, noise, fault=fault, rec=rec)
        modules[name] = replay_on_cpu(fresh, rec)
    r = _judge_bf16('tacotron train step', f'B={hp.tacotron_batch_size} x {TIMED_FRAMES} '
                    f'frames; cut for the CPU to B={B} x {T}', full, cut, outs, modules)
    reset_decoder_counts()
    r['timed'] = taco_timed_step(hp, dtype=torch.bfloat16, n=14)
    read_decoder_counts(TACO_BF16_TIMED_PATH)
    return r


def wavenet_timed_steps(hp, batch, masks, dtype, reps=3):
    """(median sec/step between two synchronizes, peak GiB) of `reps` WaveNet train steps
    in `dtype` after one untimed step."""
    from tacotron2_tpu_torch.training import wavenet_trainer as wt

    state = wt.create_train_state(hp, 'cuda', seed=4)
    wt.train_step(state, batch, hp, dropout_masks=masks, dtype=dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wt.train_step(state, batch, hp, dropout_masks=masks, dtype=dtype)['loss'].item()
        secs.append(time.perf_counter() - t0)
    return float(np.median(secs)), (min(secs), max(secs)), \
        torch.cuda.max_memory_allocated() / 2 ** 30


def wavenet_bf16():
    """Phase 14: the WaveNet train step in bf16 (see the module docstring). Returns the
    readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.models.wavenet.model import WaveNet

    hp = default_hparams()
    draw = WaveNet(hp)
    gen = torch.Generator().manual_seed(9)

    def batch_for(B, T):
        frames = T // hp.get_hop_size()
        batch = dict(audio=(torch.rand(B, T, generator=gen) * 1.6 - 0.8),
                     input_lengths=torch.full((B,), T),
                     mel_conditions=torch.rand(B, frames, hp.num_mels, generator=gen)
                     * 2 * hp.max_abs_value - hp.max_abs_value)
        masks = [layer.dropout_mask((B, T, hp.residual_channels), gen)
                 for layer in draw.residual_layers]
        return batch, masks

    full_batch, full_masks = batch_for(*BF16_WAVENET_BATCH)
    full = {name: wavenet_bf16_step(hp, full_batch, 'cuda', dt, full_masks)
            for name, dt in (('bf16', torch.bfloat16), ('f32', torch.float32))}
    cut_batch, cut_masks = batch_for(*BF16_WAVENET_CUT)
    runs = (('bf16', 'cuda', torch.bfloat16), ('f32', 'cuda', torch.float32),
            ('cpu', 'cpu', torch.bfloat16))
    cut = {name: wavenet_bf16_step(hp, cut_batch, d, dt, cut_masks) for name, d, dt in runs}
    outs = {name: wavenet_bf16_step(hp, cut_batch, d, dt, cut_masks, step=False)
            for name, d, dt in runs}
    modules = {}
    fresh = tuple(_fresh_model('wavenet', hp, d) for d in ('cpu', 'cuda'))
    for name, dt, fault in (('bf16', torch.bfloat16, False), ('f32', torch.float32, False),
                            ('fault', torch.bfloat16, True)):
        rec = {}
        wavenet_bf16_step(hp, cut_batch, 'cuda', dt, cut_masks, fault=fault, rec=rec)
        modules[name] = replay_on_cpu(fresh, rec)
    B, T = BF16_WAVENET_BATCH
    r = _judge_bf16('wavenet train step', f'B={B} x {T} samples; cut for the CPU to '
                    f'B={BF16_WAVENET_CUT[0]} x {BF16_WAVENET_CUT[1]}', full, cut, outs, modules)
    batch = {k: v.cuda() for k, v in full_batch.items()}
    masks = _on('cuda', full_masks)
    for name, dt in (('bf16', torch.bfloat16), ('f32', torch.float32)):
        sec, rng, gib = wavenet_timed_steps(hp, batch, masks, dt)
        r[f'{name}_sec_step'], r[f'{name}_sec_step_range'], r[f'{name}_peak_gib'] = sec, rng, gib
    phase(14, f'wavenet train step at B={B} x {T}, 3 steps between synchronizes: bf16 '
              f'{r["bf16_sec_step"]:.3f} sec/step ({r["bf16_sec_step_range"][0]:.3f}-'
              f'{r["bf16_sec_step_range"][1]:.3f}), peak {r["bf16_peak_gib"]:.2f} GiB; f32 '
              f'{r["f32_sec_step"]:.3f} ({r["f32_sec_step_range"][0]:.3f}-'
              f'{r["f32_sec_step_range"][1]:.3f}), peak {r["f32_peak_gib"]:.2f} GiB')
    return r


def upsampler_through_kernel(name, extra, gen):
    """Phase 14: `synthesize --model WaveNet` on a WaveNet with the upsampler `extra`
    (vocoder_cli), its launch held to the plain version on its own inputs in
    state-carried chunks (UPSAMPLER_FULL's over UPSAMPLER_BOUNDS with the planted state
    faults, the others' over UPSAMPLER_SHORT_BOUNDS), and the upsampler's card output
    to its CPU output. Returns the readings."""
    from tacotron2_tpu_torch.ops import wavenet_ar

    t0 = time.perf_counter()
    full = name == UPSAMPLER_FULL
    bounds = UPSAMPLER_BOUNDS if full else UPSAMPLER_SHORT_BOUNDS
    hp, model, weights, state = vocoder_model(extra)
    path = f'synthesize --model WaveNet ({name})'
    run = vocoder_cli(extra, hp, state, path=path, n=14)
    call = run['ar_call']
    r = variant_vs_plain(hp, weights, call['c_up'], call['noise'], None, bounds,
                         f' on the inputs of {path}', n=14, plant=full)
    if not torch.equal(r['audio'], call['audio'][:, :bounds[-1]]):
        fail(f'{path}: the check\'s launch does not repeat the entry point\'s audio')
    mel = torch.rand(MAIN_BATCH, VOCODER_FRAMES, hp.num_mels, generator=gen, device='cuda')
    with torch.no_grad():
        card = model.upsample_conditioning(mel)
        cpu = model.cpu().upsample_conditioning(mel.cpu())
    model.cuda()
    up_err = (card.cpu() - cpu).abs().max().item()
    seconds = time.perf_counter() - t0
    phase(14, f'{path}: the upsampler on the card vs the CPU, (B={MAIN_BATCH}, '
              f'{VOCODER_FRAMES}, {hp.num_mels}) -> {tuple(card.shape)}: max abs err '
              f'{up_err:.2e} (tol {UPSAMPLER_TOL}); {seconds:.1f} s with its checks')
    if not up_err <= UPSAMPLER_TOL:
        fail(f'{path}: the upsampler\'s card output disagrees with the CPU\'s')
    return dict(launches=run['launches'], us_step=run['us_step'], max_abs_err=r['max_abs_err'],
                state_err=r['state_err'], ms=r['ms'], plain_ms=r['plain_ms'],
                steps=bounds[-1], upsampler_err=up_err, seconds=seconds,
                launch_of=wavenet_ar.variant(hp))


def depth3():
    """Phase 14: the decoder at depth 3 (see the module docstring). Returns the
    readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    hp = default_hparams()
    hp.parse(f'{TACO_OVERRIDES},{DEPTH3}')
    out = {}
    # one GTA batch, card vs CPU, as phase 13 holds it
    state = tt.create_train_state(hp, 'cpu', seed=3)
    B, T, chars = DEPTH3_GTA
    batch = {k: v.cpu() for k, v in taco_timed_batch(hp, B, T, chars).items()}
    noise = state.model.draw_noise(B, chars, T, torch.Generator().manual_seed(10), True, 'cpu')
    mels = {}
    for d in ('cpu', 'cuda'):
        model = state.model.to(d).eval()
        with torch.no_grad():
            mels[d] = model.teacher_forced(
                batch['inputs'].to(d), batch['input_lengths'].to(d),
                batch['mel_targets'].to(d), {k: _on(d, v) for k, v in noise.items()},
                deterministic=True, teacher_forcing_ratio=1.0, predict_linear=False,
                dtype=torch.float32)['mel_outputs'].cpu()
    out['gta_err'] = (mels['cuda'] - mels['cpu']).abs().max().item()
    phase(14, f'depth 3 ({DEPTH3}): one GTA batch card vs CPU (B={B}, {T} frames, f32): mel '
              f'max abs err {out["gta_err"]:.2e} (tol {PIPE_GTA_TOL})')
    if not out['gta_err'] <= PIPE_GTA_TOL:
        fail('depth 3: the card\'s GTA batch disagrees with the CPU\'s')
    # one f32 train step, card vs CPU, at phase 12's tolerances
    B, T, chars = DEPTH3_STEP
    step_batch = {k: v.cpu() for k, v in taco_timed_batch(hp, B, T, chars).items()}
    out['cpu_vs_card'] = taco_cpu_vs_card(hp, step_batch, n=14, what=f' at depth 3')
    # remat_decoder: the same gradients, and peak memory with and without it
    B, T, chars = DEPTH3_REMAT
    batch = taco_timed_batch(hp, B, T, chars)
    noise = state.model.draw_noise(B, chars, T, torch.Generator().manual_seed(11), False, 'cpu')
    runs = []
    for remat in (False, False, True):
        h = hp.replace(remat_decoder=remat)
        s = tt.create_train_state(h, 'cuda', seed=3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = tt.train_step(s, batch, h, noise={k: _on('cuda', v) for k, v in noise.items()},
                             dtype=torch.float32)['loss'].item()
        runs.append((loss, _grads(s, hp.tacotron_adam_beta1), time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated() / 2 ** 30))
    again = _rel(runs[1][1], runs[0][1])
    err = _rel(runs[2][1], runs[0][1])
    out.update(remat_grad_err=err, rerun_grad_err=again, peak_gib=runs[0][3],
               remat_peak_gib=runs[2][3], sec=runs[0][2], remat_sec=runs[2][2])
    phase(14, f'depth 3, one f32 train step at B={B} x {T} frames ({chars} characters) with '
              f'and without remat_decoder: loss {runs[0][0]:.6f} / {runs[2][0]:.6f}, the '
              f'gradients {err:.2e} apart in relative L2 (tol {REMAT_TOL}; the same step run '
              f'twice without it: {again:.2e}); peak device memory {runs[0][3]:.2f} / '
              f'{runs[2][3]:.2f} GiB, {runs[0][2]:.2f} / {runs[2][2]:.2f} s')
    if not err <= REMAT_TOL:
        fail('remat_decoder changes the gradients')
    return out


def remaining_configurations(gen):
    """Phase 14 (see the module docstring). Returns the readings."""
    t0 = time.perf_counter()
    out = dict(tacotron=taco_bf16())
    t_wavenet = time.perf_counter()
    out['wavenet'] = wavenet_bf16()
    t1 = time.perf_counter()
    out['upsamplers'] = {name: upsampler_through_kernel(name, extra, gen)
                         for name, extra in UPSAMPLERS.items()}
    t2 = time.perf_counter()
    out['depth3'] = depth3()
    t3 = time.perf_counter()
    out['seconds'] = {k: round(v, 1) for k, v in dict(
        bf16=t1 - t0, bf16_tacotron=t_wavenet - t0, bf16_wavenet=t1 - t_wavenet,
        upsamplers=t2 - t1, depth3=t3 - t2, total=t3 - t0).items()}
    return out


# --- phase 15: scale-out over torch.distributed ------------------------------------------

SCALE_SEED = 15
SCALE_STEPS = 2
# the data-parallel WaveNet batch: the default 8 x 11,000 samples, the lengths ragged, so
# that the two ranks' valid counts differ (39,050 and 25,850 samples), and the rows'
# loudness falling from the first to the last, so that their mean losses differ
SCALE_WAVENET_LENGTHS = (11000, 10175, 9350, 8525, 7700, 6875, 6050, 5225)
# the data-parallel Tacotron: B=32 at the default width, cut to 128 mel frames (512 in
# phase 12) and 60 characters
SCALE_TACO_BATCH, SCALE_TACO_FRAMES, SCALE_TACO_CHARS = 32, 128, 60
SCALE_GEN_FRAMES = 32      # generate_data_parallel: B=2 x 8,800 samples, one row a rank
SCALE_TP_ROWS = 2          # the tensor-parallel step: 2 x 11,000 samples at the full width
# the data-parallel steps against the one-process steps on one card, f32, TF32 off,
# deterministic convolutions: only the order of the sums differs (each rank's rows, then
# the all-reduce). Every step's loss terms 1e-5 and grad norm 1e-4 relative. The state
# after the first step as phase 12 holds the card against the CPU (TACO_GRAD_TOL on the
# gradients, TACO_PARAM_TOL and TACO_SMALL_GRAD on the parameters): an entry whose
# gradient is near zero (a Tacotron bias BatchNorm follows has a gradient of rounding
# alone) moves by up to lr whatever its sign, so from the second step on the two runs'
# gradients differ by more than their sums' order (2.4e-3 in relative L2 after two
# Tacotron steps on an H100); BatchNorm's statistics 1e-4 of their largest magnitude
SCALE_LOSS_TOL = 1e-5
SCALE_NORM_TOL = 1e-4
SCALE_PARAM_TOL = 1e-4
# tensor parallelism against the one-process step: the loss and grad norm as
# tests/test_model_parallel.py:60-64 holds the loss; the state after the step as (a)
# and (b) hold theirs (that file's atol of 1e-5 on the parameters read 1.8e-5 at B=2 x
# 11,000 on an H100: Adam's first step moves an entry whose gradient is near eps by
# lr * g / (|g| + eps), which the split sums' rounding moves)
SCALE_TP_LOSS_TOL = 1e-4
# the CLI's step-1 loss under two ranks against phase 10's one-process step 1 (bf16, the
# batch split over two ranks; phase 10 logs its loss to 5 places): phase 10's own bound
# for two runs of one seed
SCALE_CLI_LOSS_TOL = 1e-3
SCALE_PG_TIMEOUT = 120     # a collective's wait for a lost rank, seconds
SCALE_JOB_TIMEOUT = 240    # every child of the phase must exit within this
SCALE_GEN_PATH = 'generate_data_parallel'
SCALE_CLI_PATH = 'train --model WaveNet (2 ranks, gloo)'
SCALE_PATHS = (SCALE_GEN_PATH, SCALE_CLI_PATH)


def scale_hp(extra=''):
    from tacotron2_tpu_torch.config import default_hparams

    hp = default_hparams()
    hp.parse(extra)
    return hp


def scale_wavenet_batch(hp):
    """The seeded data-parallel WaveNet batch on the card (SCALE_WAVENET_LENGTHS)."""
    g = torch.Generator('cuda').manual_seed(SCALE_SEED)
    B, T = len(SCALE_WAVENET_LENGTHS), hp.max_time_steps
    # loud rows first, quiet ones last: the two ranks' mean losses differ
    amplitude = torch.linspace(0.8, 0.05, B, device='cuda')[:, None]
    return dict(audio=(torch.rand(B, T, device='cuda', generator=g) * 2 - 1) * amplitude,
                input_lengths=torch.tensor(SCALE_WAVENET_LENGTHS, device='cuda'),
                mel_conditions=torch.rand(B, T // hp.get_hop_size(), hp.num_mels,
                                          device='cuda', generator=g))


def scale_tp_batch(hp):
    """The tensor-parallel step's batch: the first SCALE_TP_ROWS rows of the
    data-parallel WaveNet batch (each rank runs the whole batch, and its activations
    cross the model group in every layer)."""
    return {k: v[:SCALE_TP_ROWS] for k, v in scale_wavenet_batch(hp).items()}


def scale_taco_batch(hp):
    """taco_timed_batch at SCALE_TACO_* with ragged character and frame counts."""
    batch = taco_timed_batch(hp, SCALE_TACO_BATCH, SCALE_TACO_FRAMES, SCALE_TACO_CHARS)
    n = torch.arange(SCALE_TACO_BATCH, device='cuda')
    batch['input_lengths'] = SCALE_TACO_CHARS - n
    batch['targets_lengths'] = SCALE_TACO_FRAMES - 2 * n
    chars = torch.arange(SCALE_TACO_CHARS, device='cuda')
    batch['inputs'] = torch.where(chars[None] < batch['input_lengths'][:, None],
                                  batch['inputs'], 0)
    steps = torch.arange(SCALE_TACO_FRAMES, device='cuda')
    batch['stop_token_targets'] = (steps[None] >= batch['targets_lengths'][:, None] - 1).float()
    return batch


def scale_generator(step):
    from tacotron2_tpu_torch.training.common import step_seed

    return torch.Generator('cuda').manual_seed(step_seed(SCALE_SEED, step))


def scale_vocoder(hp):
    """Phase 3's WaveNet (seeded weights of order 1) and SCALE_GEN_FRAMES of seeded
    conditioning for two rows."""
    from tacotron2_tpu_torch.models.wavenet.model import WaveNet
    from tacotron2_tpu_torch.utils import randomize_weights

    model = randomize_weights(WaveNet(hp), torch.Generator().manual_seed(1)).cuda().eval()
    c = torch.rand(2, SCALE_GEN_FRAMES, hp.num_mels, device='cuda',
                   generator=torch.Generator('cuda').manual_seed(SCALE_SEED + 1))
    return model, c


def scale_steps(trainer, state, batch, hp, mesh=None):
    """SCALE_STEPS f32 steps of `trainer` (tacotron_trainer or wavenet_trainer) from
    `state` on `batch`, the draws from scale_generator: each step's metrics, the state
    after the first (the model's state_dict and Adam's first moments: the gradients of
    one step from one state) and, under a mesh, whether every rank holds the same
    parameters after the last."""
    import torch.distributed as dist

    metrics = []
    for i in range(SCALE_STEPS):
        metrics.append(_metric_floats(trainer.train_step(
            state, batch, hp, scale_generator(i), dtype=torch.float32, mesh=mesh)))
        if i == 0:
            step1 = dict(model=_cpu_state(state.model.state_dict()),
                         exp_avg=[m.detach().cpu() for m in state.exp_avg])
    out = dict(metrics=metrics, step1=step1)
    if mesh is not None:
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        lead = flat.clone()
        dist.broadcast(lead, 0)
        out['ranks_agree'] = torch.equal(flat, lead)
    return out


def _cpu_state(state):
    return {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


def _metric_floats(m):
    return {k: float(v) for k, v in m.items()}


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _forbid_builds():
    """A phase 15 child loads the kernels phase 2 built: a build there fails it."""
    from tacotron2_tpu_torch.ops import _build

    def refuse(*args, **kwargs):
        raise RuntimeError('a phase 15 child started a kernel build: it must load the '
                           'library phase 2 built')
    _build.compile_library = refuse


def nccl_one_rank():
    """Phase 15's one-rank NCCL child on cuda:0: the data-parallel WaveNet step at the
    default width against `train_step` without a mesh, and generate_data_parallel at
    B=2 x 8,800 against `generate`, each bit for bit."""
    from tacotron2_tpu_torch.inference import wavenet_synthesizer as ws
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.parallel import mesh as mesh_lib
    from tacotron2_tpu_torch.training import wavenet_trainer as wt

    hp = scale_hp()
    mesh = mesh_lib.make_mesh(hp, 'cuda:0')
    batch = scale_wavenet_batch(hp)
    plain, dp = (wt.create_train_state(hp, 'cuda', seed=SCALE_SEED) for _ in range(2))
    m_plain = wt.train_step(plain, batch, hp, scale_generator(0), dtype=torch.float32)
    m_dp = wt.train_step(dp, mesh_lib.shard_batch(batch, mesh), hp, scale_generator(0),
                         dtype=torch.float32, mesh=mesh)
    a, b = plain.state_dict(), dp.state_dict()
    differ = [f'{part}.{k}' for part in ('model', 'ema_model') for k in a[part]
              if not torch.equal(a[part][k], b[part][k])]
    differ += [f'{part}[{i}]' for part in ('exp_avg', 'exp_avg_sq')
               for i, (x, y) in enumerate(zip(a[part], b[part])) if not torch.equal(x, y)]
    model, c = scale_vocoder(hp)
    reset_counts()
    out = ws.generate_data_parallel(model, hp, c, mesh, seed=SCALE_SEED)
    torch.cuda.synchronize()
    launches, layouts = wavenet_ar.LAUNCHES, dict(wavenet_ar.LAUNCHES_BY_LAYOUT)
    ref = ws.generate(model, hp, torch.Generator('cuda').manual_seed(ws.shard_seed(SCALE_SEED, 0)),
                      c, return_params=True)
    return dict(step_metrics=(_metric_floats(m_plain), _metric_floats(m_dp)),
                step_differ=differ,
                gen_identical=torch.equal(out['audio'], ref['audio'])
                and torch.equal(out['params'], ref['params']),
                gen_launches=launches, gen_layouts=layouts)


def gloo_two_ranks():
    """Phase 15's two-rank gloo job on cuda:0 (see the module docstring): its readings,
    rank by rank."""
    import torch.distributed as dist

    from tacotron2_tpu_torch.inference import wavenet_synthesizer as ws
    from tacotron2_tpu_torch.models.wavenet import distributions
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.parallel import collectives, mesh as mesh_lib, tensor_parallel
    from tacotron2_tpu_torch.training import tacotron_trainer as tt
    from tacotron2_tpu_torch.training import wavenet_trainer as wt

    rank, out = dist.get_rank(), {}
    hp = scale_hp()
    mesh = mesh_lib.make_mesh(hp, 'cuda:0')
    # (a) the data-parallel WaveNet
    t0 = time.perf_counter()
    batch = mesh_lib.shard_batch(scale_wavenet_batch(hp), mesh)
    out['wavenet'] = scale_steps(wt, wt.create_train_state(hp, 'cuda', seed=SCALE_SEED), batch,
                                 hp, mesh)
    # (e) the normalizers counted per rank, one step
    state = wt.create_train_state(hp, 'cuda', seed=SCALE_SEED)
    with _patched(distributions, 'global_sum',
                  lambda t, group: t.detach().clone() * dist.get_world_size(group)):
        out['wavenet_averaged'] = _metric_floats(wt.train_step(
            state, batch, hp, scale_generator(0), dtype=torch.float32, mesh=mesh))
    out['wavenet_s'] = time.perf_counter() - t0
    # (b) the data-parallel Tacotron
    t0 = time.perf_counter()
    out['tacotron'] = scale_steps(tt, tt.create_train_state(hp, 'cuda', seed=SCALE_SEED),
                                  mesh_lib.shard_batch(scale_taco_batch(hp), mesh), hp, mesh)
    out['tacotron_s'] = time.perf_counter() - t0
    # (c) tensor parallelism over a model axis of 2, one step
    t0 = time.perf_counter()
    tp_hp = scale_hp('mesh_model_axis=2,mesh_data_axis=1')
    tp_mesh = mesh_lib.make_mesh(tp_hp, 'cuda:0')
    tp_state = tensor_parallel.shard_wavenet_state(
        wt.create_train_state(tp_hp, 'cuda', seed=SCALE_SEED), tp_hp, tp_mesh)
    m = wt.make_tp_train_step(tp_hp, tp_mesh)(tp_state, scale_tp_batch(tp_hp),
                                               scale_generator(0))
    names = [n for n, _ in tp_state.model.named_parameters()]
    out['tp'] = dict(metrics=_metric_floats(m),
                     gates=tuple(tp_state.model.residual_layers[0].conv.weight.shape),
                     step1=dict(model=_cpu_state(tensor_parallel.gather_state_dict(
                         tp_state.model, tp_hp, tp_mesh)), exp_avg=list(_cpu_state(
                             tensor_parallel.gather_tensors(dict(zip(names, tp_state.exp_avg)),
                                                            tp_hp, tp_mesh)).values())))
    out['tp_s'] = time.perf_counter() - t0
    del tp_state
    # (d) generate_data_parallel, one row a rank, its launches counted
    model, c = scale_vocoder(hp)
    reset_counts()
    gen = ws.generate_data_parallel(model, hp, c, mesh, seed=SCALE_SEED)
    torch.cuda.synchronize()
    out['generate'] = dict(audio=gen['audio'].cpu(), params=gen['params'].cpu(),
                           launches=wavenet_ar.LAUNCHES,
                           layouts=dict(wavenet_ar.LAUNCHES_BY_LAYOUT))

    # (e) the gathered rows in swapped order
    gather = collectives.gather_rows

    def swapped(local, rows, total, group):
        return gather(local, slice(total - rows.stop, total - rows.start), total, group)
    with _patched(collectives, 'gather_rows', swapped):
        out['generate_swapped'] = ws.generate_data_parallel(model, hp, c, mesh,
                                                            seed=SCALE_SEED)['audio'].cpu()
    out['rank'] = rank
    return out


def rank_job(job, out_dir):
    """A child of phase 15: `python3 chip_smoke.py --rank-job nccl1|gloo2 <dir>`, with
    RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set. Saves its readings to
    <dir>/<job>-rank<r>.pt."""
    import torch.distributed as dist

    from tacotron2_tpu_torch.parallel import distributed

    _forbid_builds()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    distributed.maybe_initialize({'nccl1': 'nccl', 'gloo2': 'gloo'}[job], SCALE_PG_TIMEOUT,
                                 'cuda:0')
    results = {'nccl1': nccl_one_rank, 'gloo2': gloo_two_ranks}[job]()
    torch.save(results, os.path.join(out_dir, f'{job}-rank{dist.get_rank()}.pt'))
    dist.destroy_process_group()


def rank_cli(out_dir, argv):
    """A rank of phase 15's command line under torchrun: `train.main(argv)`, its AR
    launches counted from 0, each step's loss as the loop reads it and every checkpoint
    this rank writes saved to <dir>/cli-rank<r>.pt."""
    from tacotron2_tpu_torch import train
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.parallel import distributed
    from tacotron2_tpu_torch.training import common
    from tacotron2_tpu_torch.training.checkpointing import CheckpointManager

    _forbid_builds()
    losses, saves = [], []
    resolve, save = common.StepLog._resolve, CheckpointManager.save

    def record_loss(self, step, metrics, start, end):
        losses.append((step, float(metrics['loss'])))
        return resolve(self, step, metrics, start, end)

    def record_save(self, step, state):
        saves.append(step)
        return save(self, step, state)

    common.StepLog._resolve, CheckpointManager.save = record_loss, record_save
    reset_counts()
    train.main(argv)
    torch.cuda.synchronize()
    torch.save(dict(losses=losses, saves=saves, lead=distributed.is_lead(),
                    launches=wavenet_ar.LAUNCHES, layouts=dict(wavenet_ar.LAUNCHES_BY_LAYOUT)),
               os.path.join(out_dir, f'cli-rank{int(os.environ["RANK"])}.pt'))


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _start_ranks(argv_of, world, out_dir, name):
    """`world` children of this script, one a rank (torchrun's environment, gloo's or
    nccl's rendezvous on a free localhost port), their output in <dir>/<name>-<r>.log."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR='127.0.0.1',
                   MASTER_PORT=str(port), PYTHONPATH=REPO)
        log = open(os.path.join(out_dir, f'{name}-{rank}.log'), 'w')
        procs.append((subprocess.Popen(argv_of(rank), env=env, cwd=REPO, stdout=log,
                                       stderr=subprocess.STDOUT), log, f'{name}-{rank}'))
    return procs


def _join(procs, out_dir, deadline, t_start):
    """Wait for every child until `deadline` (perf_counter), kill what is left, and fail
    with the tail of each log where a child did not exit 0. Returns {child: seconds from
    `t_start` to the wait's end}, the waits in turn."""
    bad, done = [], {}
    for proc, log, name in procs:
        try:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        done[name] = round(time.perf_counter() - t_start, 1)
        log.close()
        if proc.returncode != 0:
            with open(os.path.join(out_dir, f'{name}.log')) as f:
                bad.append(f'--- {name} (exit {proc.returncode}):\n{f.read()[-4000:]}')
    if bad:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        fail('phase 15: a child failed or hung:\n' + '\n'.join(bad))
    return done


def _step1_gap(want, got, names, b1):
    """Two states after one step from one state (`scale_steps`' step1), read as phase 12
    reads the card against the CPU (taco_cpu_vs_card): the gradients (first moments over
    1 - b1) apart in relative L2 norm, the parameters' largest gap, the entries more than
    TACO_PARAM_CLOSE apart and those of them whose gradient is TACO_SMALL_GRAD or more;
    and every buffer's (BatchNorm's statistics) largest gap as a share of
    SCALE_PARAM_TOL of its largest magnitude."""
    g_err2 = g_norm2 = worst = stats = 0.0
    off = off_large = 0
    for name, ma, mb in zip(names, want['exp_avg'], got['exp_avg'], strict=True):
        g = ma.double() / (1 - b1)
        g_err2 += float(((ma.double() - mb.double()) / (1 - b1)).square().sum())
        g_norm2 += float(g.square().sum())
        diff = (want['model'][name].double() - got['model'][name].double()).abs()
        worst = max(worst, float(diff.max()))
        far = diff > TACO_PARAM_CLOSE
        off += int(far.sum())
        off_large += int((far & (g.abs() >= TACO_SMALL_GRAD)).sum())
    for k, w in want['model'].items():
        if k not in names and w.is_floating_point():
            gap = float((w.double() - got['model'][k].double()).abs().max())
            stats = max(stats, gap / (SCALE_PARAM_TOL * max(float(w.abs().max()), 1e-6)))
    return dict(grad_rel_l2=(g_err2 / g_norm2) ** 0.5, param_max_abs=worst, params_off=off,
                params_off_large=off_large, buffers_share_of_bound=stats)


def _layout_keys(counts):
    """{(N, P): launches} -> {'N,P': launches} (JSON keys)."""
    return {f'{n},{p}': c for (n, p), c in sorted(counts.items())}


def _metric_gap(want, got, keys):
    return max(abs(w[k] - g[k]) / max(abs(w[k]), 1e-12) for w, g in zip(want, got) for k in keys)


def scale_out(phase10_loss, phase10_extra):
    """Phase 15 (see the module docstring): the one-rank NCCL child, the two-rank gloo
    job and `python -m torch.distributed.run --nproc_per_node 2 ... train --model
    WaveNet` on phase 10's corpus, all started at once; meanwhile this process computes
    the one-process references. Returns the readings."""
    from tacotron2_tpu_torch.inference import wavenet_synthesizer as ws
    from tacotron2_tpu_torch.models.wavenet.model import WaveNet
    from tacotron2_tpu_torch.ops import wavenet_ar
    from tacotron2_tpu_torch.training import tacotron_trainer as tt
    from tacotron2_tpu_torch.training import wavenet_trainer as wt

    t_start = time.perf_counter()
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(prefix='t2torch_scale_') as tmp:
        corpus = os.path.join(tmp, 'corpus')
        os.makedirs(corpus)
        meta = make_corpus(corpus, scale_hp(phase10_extra), TRAIN_UTTERANCES, seed=10)
        procs = _start_ranks(lambda r: [sys.executable, me, '--rank-job', 'nccl1', tmp], 1,
                             tmp, 'nccl1')
        procs += _start_ranks(lambda r: [sys.executable, me, '--rank-job', 'gloo2', tmp], 2,
                              tmp, 'gloo2')
        cli = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
               '--nproc_per_node', '2', me, '--rank-cli', tmp, '--model', 'WaveNet',
               '--wavenet_input', meta, '--base_dir', corpus, '--name', 'ranks',
               '--wavenet_train_steps', str(SCALE_STEPS), '--eval_interval', str(SCALE_STEPS),
               '--checkpoint_interval', str(SCALE_STEPS), '--summary_interval', '1',
               '--hparams', phase10_extra, '--dist_backend', 'gloo', '--device', 'cuda:0']
        log = open(os.path.join(tmp, 'cli-0.log'), 'w')
        procs.append((subprocess.Popen(cli, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                                       stdout=log, stderr=subprocess.STDOUT), log, 'cli-0'))
        deadline = time.perf_counter() + SCALE_JOB_TIMEOUT
        try:
            # the one-process references, while the children run, with the children's
            # deterministic convolutions
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            hp = scale_hp()
            wave = scale_steps(wt, wt.create_train_state(hp, 'cuda', seed=SCALE_SEED),
                               scale_wavenet_batch(hp), hp)
            names = [n for n, _ in WaveNet(hp).named_parameters()]
            taco = scale_steps(tt, tt.create_train_state(hp, 'cuda', seed=SCALE_SEED),
                               scale_taco_batch(hp), hp)
            taco_names = [n for n, _ in tt.Tacotron(hp).named_parameters()]
            tp_state = wt.create_train_state(hp, 'cuda', seed=SCALE_SEED)
            tp_ref = _metric_floats(wt.train_step(tp_state, scale_tp_batch(hp), hp,
                                                  scale_generator(0), dtype=torch.float32))
            tp_ref_step1 = dict(model=_cpu_state(tp_state.model.state_dict()),
                                exp_avg=[m.detach().cpu() for m in tp_state.exp_avg])
            del tp_state
            torch.backends.cudnn.deterministic = deterministic
            model, c = scale_vocoder(hp)
            T = c.shape[1] * hp.get_hop_size()
            noise = torch.cat([wavenet_ar.make_noise(
                hp, torch.Generator('cuda').manual_seed(ws.shard_seed(SCALE_SEED, i)), 1, T)
                for i in range(2)])
            reset_counts()
            gen_ref = ws.generate(model, hp, torch.Generator('cuda'), c, return_params=True,
                                  noise=noise)
            torch.cuda.synchronize()
            ref_layouts = dict(wavenet_ar.LAUNCHES_BY_LAYOUT)
            read_counts(None)
        finally:
            children_s = _join(procs, tmp, deadline, t_start)
        nccl1 = torch.load(os.path.join(tmp, 'nccl1-rank0.pt'), weights_only=False)
        gloo = [torch.load(os.path.join(tmp, f'gloo2-rank{r}.pt'), weights_only=False)
                for r in range(2)]
        clis = [torch.load(os.path.join(tmp, f'cli-rank{r}.pt'), weights_only=False)
                for r in range(2)]
        log_dir = os.path.join(corpus, 'logs-ranks')
        ckpts = sorted(os.listdir(os.path.join(log_dir, 'wave_pretrained')))
        with open(os.path.join(log_dir, 'Terminal_train_log'), encoding='utf-8') as f:
            cli_log = f.read()

    # the one-rank NCCL child: bit for bit
    (mp, md), differ = nccl1['step_metrics'], nccl1['step_differ']
    phase(15, f'one rank (nccl, cuda:0): the data-parallel WaveNet step (B=8 x '
              f'{hp.max_time_steps}, f32) against train_step without a mesh: loss {md["loss"]!r} '
              f'vs {mp["loss"]!r}, grad norm {md["grad_norm"]!r} vs {mp["grad_norm"]!r}, '
              f'{len(differ)} tensors differ; generate_data_parallel at B=2 x {T} against '
              f'generate: bit-identical {nccl1["gen_identical"]}, AR launches '
              f'{nccl1["gen_launches"]} on {nccl1["gen_layouts"]}')
    if mp != md or differ or not nccl1['gen_identical']:
        fail(f'phase 15: the one-rank data-parallel runs are not bit-identical: {differ[:5]}')
    # (a), (b): the two ranks against the one-process steps
    readings = {}
    taco_keys = ('loss', 'before_loss', 'after_loss', 'stop_token_loss', 'linear_loss',
                 'regularization_loss')
    for what, ref, keys, pnames, b1 in (
            ('wavenet', wave, ('loss',), names, hp.wavenet_adam_beta1),
            ('tacotron', taco, taco_keys, taco_names, hp.tacotron_adam_beta1)):
        loss_gap = max(_metric_gap(ref['metrics'], g[what]['metrics'], keys) for g in gloo)
        norm_gap = max(_metric_gap(ref['metrics'], g[what]['metrics'], ('grad_norm',))
                       for g in gloo)
        same = all(g[what]['ranks_agree'] for g in gloo)
        gaps = _step1_gap(ref['step1'], gloo[0][what]['step1'], pnames, b1)
        readings[what] = dict(loss_rel=loss_gap, grad_norm_rel=norm_gap, ranks_agree=same,
                              seconds=gloo[0][f'{what}_s'], **gaps)
        phase(15, f'two ranks (gloo, cuda:0), {what}, {SCALE_STEPS} steps against the '
                  f'one-process steps: loss terms {loss_gap:.2e} relative (tol '
                  f'{SCALE_LOSS_TOL}), grad norm {norm_gap:.2e} (tol {SCALE_NORM_TOL}); after '
                  f'step 1 the gradients {gaps["grad_rel_l2"]:.2e} apart in relative L2 (tol '
                  f'{TACO_GRAD_TOL}), parameters {gaps["param_max_abs"]:.2e} (tol '
                  f'{TACO_PARAM_TOL}), {gaps["params_off"]} entries off by more than '
                  f'{TACO_PARAM_CLOSE}, {gaps["params_off_large"]} of them with a gradient of '
                  f'{TACO_SMALL_GRAD} or more (tol 0), buffers at '
                  f'{gaps["buffers_share_of_bound"]:.3f} of their bound; the ranks hold the same '
                  f'parameters after step {SCALE_STEPS}: {same}; {gloo[0][f"{what}_s"]:.1f} s')
        if not (loss_gap <= SCALE_LOSS_TOL and norm_gap <= SCALE_NORM_TOL
                and gaps['grad_rel_l2'] <= TACO_GRAD_TOL
                and gaps['param_max_abs'] <= TACO_PARAM_TOL and gaps['params_off_large'] == 0
                and gaps['buffers_share_of_bound'] <= 1.0 and same):
            fail(f'phase 15: the data-parallel {what} is not the one-process step')
    averaged = _metric_gap(wave['metrics'][:1], [gloo[0]['wavenet_averaged']], ('loss',))
    # (c) tensor parallelism
    tp = gloo[0]['tp']
    tp_loss = max(abs(tp['metrics'][k] - tp_ref[k]) / abs(tp_ref[k])
                  for k in ('loss', 'grad_norm'))
    tp_gaps = _step1_gap(tp_ref_step1, tp['step1'], names, hp.wavenet_adam_beta1)
    readings['tp'] = dict(loss_rel=tp_loss, gates=tp['gates'], seconds=gloo[0]['tp_s'],
                          **tp_gaps)
    phase(15, f'tensor parallelism over a model axis of 2 (each rank {tp["gates"][0]} of '
              f'{hp.gate_channels} gate channels), B={SCALE_TP_ROWS} x {hp.max_time_steps}, one '
              f'step against the one-process step: loss and grad norm {tp_loss:.2e} relative '
              f'(tol {SCALE_TP_LOSS_TOL}); the gathered gradients {tp_gaps["grad_rel_l2"]:.2e} '
              f'apart in relative L2 (tol {TACO_GRAD_TOL}), parameters '
              f'{tp_gaps["param_max_abs"]:.2e} (tol {TACO_PARAM_TOL}), '
              f'{tp_gaps["params_off"]} entries off by more than {TACO_PARAM_CLOSE}, '
              f'{tp_gaps["params_off_large"]} of them with a gradient of {TACO_SMALL_GRAD} or '
              f'more (tol 0); {gloo[0]["tp_s"]:.1f} s')
    if not (tp_loss <= SCALE_TP_LOSS_TOL and tp_gaps['grad_rel_l2'] <= TACO_GRAD_TOL
            and tp_gaps['param_max_abs'] <= TACO_PARAM_TOL and tp_gaps['params_off_large'] == 0
            and tp['gates'][0] == hp.gate_channels // 2):
        fail('phase 15: the tensor-parallel step is not the one-process step')
    # (d) generate_data_parallel, each rank's row against this process's launch of it
    gen_err, gen_identical = 0.0, True
    for g in gloo:
        r = g['rank']
        same_layout = g['generate']['layouts'] == ref_layouts
        for k in ('audio', 'params'):
            got, want = g['generate'][k][r], gen_ref[k][r].cpu()
            gen_identical &= torch.equal(got, want)
            gen_err = max(gen_err, float((got.double() - want.double()).abs().max()))
            if same_layout and not torch.equal(got, want):
                fail(f'phase 15: rank {r}\'s row differs from the same launch layout\'s')
        if not same_layout and gen_err > KERNEL_TOL:
            fail(f'phase 15: rank {r}\'s row misses KERNEL_TOL: {gen_err}')
    swapped = max(float((g['generate_swapped'] - gen_ref['audio'].cpu()).abs().max())
                  for g in gloo)
    readings['generate'] = dict(max_abs_err=gen_err, identical=gen_identical,
                                layouts=[_layout_keys(g['generate']['layouts']) for g in gloo],
                                reference_layouts=_layout_keys(ref_layouts))
    phase(15, f'generate_data_parallel at B=2 x {T}, one row a rank: each rank\'s launch on '
              f'{gloo[0]["generate"]["layouts"]}, this process\'s B=2 launch on {ref_layouts}: '
              f'rows bit-identical {gen_identical} (max abs err {gen_err:.2e})')
    # (e) planted faults
    readings['faults'] = dict(averaged_normalizers_loss_rel=averaged, swapped_rows_abs=swapped)
    phase(15, f'planted faults: normalizers counted per rank: loss off by {averaged:.2e} '
              f'relative (must pass {SCALE_LOSS_TOL}); gathered rows in swapped order: audio off '
              f'by {swapped:.3f} (must pass {KERNEL_TOL})')
    if not (averaged > SCALE_LOSS_TOL and swapped > KERNEL_TOL):
        fail('phase 15: a planted fault did not show')
    # the command line under torchrun
    step1 = dict(clis[0]['losses']).get(1)
    cli_gap = None if phase10_loss is None or step1 is None else abs(step1 - phase10_loss)
    readings['cli'] = dict(step1_loss=step1, phase10_step1_loss=phase10_loss, gap=cli_gap,
                           launches=[c['launches'] for c in clis], saves=[c['saves'] for c in clis])
    phase(15, f'torch.distributed.run --nproc_per_node 2 -m tacotron2_tpu_torch.train --model '
              f'WaveNet --dist_backend gloo --device cuda:0: {SCALE_STEPS} steps, rank 0\'s losses '
              f'{clis[0]["losses"]}, step 1 against phase 10\'s {phase10_loss} (tol '
              f'{SCALE_CLI_LOSS_TOL}); checkpoints written by rank: '
              f'{[c["saves"] for c in clis]}, on disk {ckpts}; AR launches by rank (the natural '
              f'eval on rank 0) {[c["launches"] for c in clis]} on {clis[0]["layouts"]}')
    if not ([c['lead'] for c in clis] == [True, False]
            and [c['saves'] for c in clis] == [[SCALE_STEPS], []]
            and ckpts == [f'ckpt-{SCALE_STEPS}.pt'] and clis[1]['launches'] == 0
            and clis[0]['launches'] == 1 and cli_log.count('Starting new WaveNet training!') == 1
            and 'Data-parallel over 2 ranks' in cli_log
            and [s for s, _ in clis[0]['losses']] == list(range(1, SCALE_STEPS + 1))
            and (cli_gap is None or cli_gap <= SCALE_CLI_LOSS_TOL)):
        fail('phase 15: the command line under two ranks did not run as one rank would')
    for counts in [nccl1['gen_layouts']] + [g['generate']['layouts'] for g in gloo]:
        LAYOUTS_BY_PATH[SCALE_GEN_PATH].update(counts)
    LAYOUTS_BY_PATH[SCALE_CLI_PATH].update(clis[0]['layouts'])
    seconds = time.perf_counter() - t_start
    phase(15, f'phase 15 took {seconds:.1f} s, its children done at {children_s} s (two ranks '
              f'time-slice one card: no reading here is a scaling measurement)')
    return dict(readings, seconds=seconds, children_s=children_s,
                gen_launches=nccl1['gen_launches'] + sum(g['generate']['launches'] for g in gloo),
                cli_launches=clis[0]['launches'])


# --- phase 16: the fused decoder's hand-written backward and its four kernels -----------

DECODER_SOURCE = 'tacotron2_tpu_torch/csrc/decoder/decoder_step.cu'
DECODER_REPLACES = {
    'lstm_cell_fwd': 'tacotron2_tpu/ops/fused_decoder.py:122-127,356-364',
    'lstm_cell_bwd': 'tacotron2_tpu/ops/fused_decoder.py:130-150,522-539',
    'attention_fwd': 'tacotron2_tpu/ops/fused_decoder.py:215-228,367-368',
    'attention_bwd': 'tacotron2_tpu/ops/fused_decoder.py:275-301'}
PIPE_TACO_PATH = 'train --model Tacotron-2 (Tacotron phase)'
PIPE_GTA_PATH = 'train --model Tacotron-2 (GTA)'
TACO_F32_TIMED_PATH = 'timed Tacotron train steps, float32 (phase 12)'
DECODER_PATHS = (TACO_PATH, PIPE_TACO_PATH, PIPE_GTA_PATH)
# the main paths whose decoder runs in bf16 (the trainers' compute dtype on the card), where
# decoder_fwd_loop is their forward and lstm_cell_fwd and attention_fwd launch no more; and
# those in f32, whose forward is decoder_fwd_loop_f32: GTA (the synthesizer's model
# computes in float32, as the JAX one's `Tacotron(hparams)` does) and phase 12's timed f32
# steps; the float32 trainer at teacher forcing 0.5 keeps the step loop
BF16_DECODER_PATHS = (TACO_PATH, PIPE_TACO_PATH)
F32_DECODER_PATHS = (PIPE_GTA_PATH, TACO_F32_TIMED_PATH)
ALL_DECODER_PATHS = DECODER_PATHS + (TACO_F32_TIMED_PATH, TACO_F32_SCHEDULED_PATH)
DECODER_WIDTHS = (32, 1024, 128, 100)  # B, U, D, T_in: the default trainer's, 100 characters
# each kernel against its plain version on the same CUDA tensors: the largest error of
# its outputs relative to the plain output's largest entry, a bound a kernel and dtype.
# Read on an H100 80GB HBM3 at 700 W: the LSTM cell 0 in both dtypes (the same
# operations, rounded at the same places), so its bound 1e-6 catches one bf16 step
# rounded where the plain version does not round; the attention 4.6e-7 / 5.4e-7 in f32
# (only the order of its sums differs), 3.8e-7 / 4.8e-4 in bf16 (attention_bwd: a du
# that the two round from slightly different f32 sums lands one bf16 step apart); the
# planted faults 0.10 to 0.75, the bf16 sigmoid rounded once 9.5e-3. The attention's
# bounds sit 10-20x above its readings
DECODER_TOL = {
    'lstm_cell_fwd': {torch.float32: 1e-6, torch.bfloat16: 1e-6},
    'lstm_cell_bwd': {torch.float32: 1e-6, torch.bfloat16: 1e-6},
    'attention_fwd': {torch.float32: 1e-5, torch.bfloat16: 1e-5},
    'attention_bwd': {torch.float32: 1e-5, torch.bfloat16: 5e-3}}
# planted faults: each a build of a copy of csrc/decoder/decoder_step.cu with one line
# changed, built in phase 2, {fault: (the kernels it must show in, the dtypes it must
# show in, the line, its change)}; each must miss DECODER_TOL there. The bf16 sigmoid
# rounded once (not step by step, as models/precision.sigmoid and JAX's bf16 round it)
# changes nothing in f32, where sig<float> stands alone
F32_BF16 = (torch.float32, torch.bfloat16)
DECODER_MUTANTS = {
    'lstm_cell_fwd: the forget bias dropped': (
        ('lstm_cell_fwd',), F32_BF16, 'sf = sig<T>(rd<T>(f + 1.0f));', 'sf = sig<T>(f);'),
    'lstm_cell_bwd: the cell bypass (1 - a) dc dropped': (
        ('lstm_cell_bwd',), F32_BF16, 'dc_next[idx] = dcn * gt.sf + (1.0f - ac) * dcv;',
        'dc_next[idx] = dcn * gt.sf;'),
    'lstm cell: the bf16 sigmoid rounded once': (
        ('lstm_cell_fwd', 'lstm_cell_bwd'), (torch.bfloat16,),
        'return rd<__nv_bfloat16>(1.0f / rd<__nv_bfloat16>(rd<__nv_bfloat16>(expf(-x)) + 1.0f));',
        'return rd<__nv_bfloat16>(1.0f / (expf(-x) + 1.0f));'),
    'attention_fwd: the mask ignored': (
        ('attention_fwd',), F32_BF16,
        'if (lane == 0) e[t] = (mask && !(mask[(long)b * T_in + t] > 0.0f)) ? NEG_INF : s;',
        'if (lane == 0) e[t] = s;'),
    'attention_bwd: the dkeys accumulate skipped': (
        ('attention_bwd',), F32_BF16, 'dkeys_acc[row + d] += g;', ';')}
FUSED_FRAMES = 128  # fused_decoder_scan against autograd's decoder_scan: B=32 x 128 frames
# the timed step at B=32 x 512 with the autograd decoder loop, before the fused decoder
# ran there (H100 80GB HBM3, 700 W): sec/step, peak GiB, the decoder's forward and
# backward ms (StepMarks)
AUTOGRAD_TIMED = {'float32': dict(sec_step=2.649, peak_gib=4.89, fwd=663.0, bwd=987.0),
              'bfloat16': dict(sec_step=3.551, peak_gib=4.52, fwd=863.0, bwd=1317.0)}
# the same step with the fused decoder's step loop, lstm_cell_fwd and attention_fwd a step
# (H100 80GB HBM3, 700 W), and its GTA seconds an utterance (phase 13)
STEP_LOOP_TIMED = {'float32': dict(sec_step=2.048, peak_gib=4.64, fwd=260.7, bwd=384.0),
              'bfloat16': dict(sec_step=2.153, peak_gib=3.27, fwd=268.5, bwd=415.9)}
STEP_LOOP_GTA_S = 0.099
# the f32 timed step with the step loops in both directions, the last before the float32
# forward loop (H100 80GB HBM3, 700 W): sec/step, the decoder's forward and backward ms
# (StepMarks), and GTA's seconds an utterance
F32_STEP_LOOPS_TIMED = dict(sec_step=1.953, fwd=263.3, bwd=373.4, gta_s=0.176)
# the f32 timed step with the float32 forward loop and the step loop's backward, the last
# before the float32 reverse loop (four runs, H100 80GB HBM3, 700 W): the ranges of its
# sec/step and of its decoder backward's ms (StepMarks)
F32_FWD_LOOP_TIMED = dict(sec_step=(1.493, 1.885), bwd=(396.1, 521.2))
F32_PEAK_OPS = 67e12  # f32 outside the tensor cores: the elementwise kernels' ops
# the fused decoder against autograd's on the card, {dtype: (the outputs' max abs error,
# the gradients' relative L2)}. f32, read 2.1e-7 to 3.3e-7 and 6.4e-7 to 7.0e-7 at
# teacher forcing 1 and 0.5 (H100 80GB HBM3, 700 W; an earlier version of the backward
# read 7.1e-5 at 0.5, where the fed-back frames carry two sum orders apart over 128
# steps): TACO_GRAD_TOL holds them. bf16 at 1 and 0.5: the outputs 3.9e-3, the
# gradients 7.6e-3 and 8.2e-3 (two bf16 recurrences that round a few sums apart drift
# apart over the steps), the planted bf16 sum of the deferred weight gradients
# (precast_fault) 1.56e-2: the bound sits between, 1.3x above the sound reading and
# 1.4x below the fault's
FUSED_TOL = {torch.float32: (1e-5, TACO_GRAD_TOL), torch.bfloat16: (1e-2, 1.1e-2)}
# the decoder kernels' launches on each main path, {path: {kernel: launches}}, the counts
# set to 0 just before each run of a path (reset_decoder_counts) and read just after it
DECODER_LAUNCHES_BY_PATH = collections.defaultdict(collections.Counter)


# the CBHG's GRU kernels' and the encoder LSTM's kernels' launches on each main path,
# {path: {kernel: launches}}, set and read with the decoder's
GRU_LAUNCHES_BY_PATH = collections.defaultdict(collections.Counter)
LSTM_LAUNCHES_BY_PATH = collections.defaultdict(collections.Counter)


def reset_decoder_counts():
    """Sets the decoder kernels', the GRU kernels' and the encoder LSTM kernels' launch
    counts to 0, just before a run of a main path."""
    from tacotron2_tpu_torch.ops import decoder_vjp, gru_scan, lstm_scan

    decoder_vjp.LAUNCHES.clear()
    gru_scan.LAUNCHES.clear()
    lstm_scan.LAUNCHES.clear()


def read_decoder_counts(path):
    """Adds the decoder kernels', the GRU kernels' and the encoder LSTM kernels' launches
    since reset_decoder_counts to DECODER_LAUNCHES_BY_PATH[path], GRU_LAUNCHES_BY_PATH[path]
    and LSTM_LAUNCHES_BY_PATH[path], just after a run of the main path `path`."""
    from tacotron2_tpu_torch.ops import decoder_vjp, gru_scan, lstm_scan

    DECODER_LAUNCHES_BY_PATH[path].update(decoder_vjp.LAUNCHES)
    GRU_LAUNCHES_BY_PATH[path].update(gru_scan.LAUNCHES)
    LSTM_LAUNCHES_BY_PATH[path].update(lstm_scan.LAUNCHES)


def mutated_decoder_source(fault):
    """The text of csrc/decoder/decoder_step.cu with DECODER_MUTANTS[fault]'s change."""
    from tacotron2_tpu_torch.ops import _build

    *_, old, new = DECODER_MUTANTS[fault]
    with open(os.path.join(_build.DECODER_DIR, 'decoder_step.cu'), encoding='utf-8') as f:
        text = f.read()
    if text.count(old) != 1:
        raise ValueError(f'the line that {fault!r} changes stands {text.count(old)} times in '
                         'csrc/decoder/decoder_step.cu: bring DECODER_MUTANTS up to date')
    return text.replace(old, new)


def graph_ms(fn, n=50):
    """ms of one fn() on the card: n calls captured in a CUDA graph, replayed between two
    CUDA events (the host's launch costs out of the reading)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    _, ms = cuda_ms(graph.replay)
    return ms / n


def decoder_cases(dt, gen):
    """{kernel: (its wrapper, its plain version, its variants' inputs (each a function that
    returns a fresh copy of the in-place accumulators), the outputs of a call from its
    result and inputs, its bytes (each input read once, each output written once, the
    first variant's), its f32 operations)} at DECODER_WIDTHS in `dt`, on seeded inputs of
    the trainer's magnitudes: the LSTM cell with training's keep-gates (0.9) and with
    zoneout's expectation, a ragged mask (50 to 100 input steps), the folded location
    tier's pl_b in bf16 (the trainer's default at B=32), none at f32."""
    from tacotron2_tpu_torch.ops import decoder_vjp as dv
    from tacotron2_tpu_torch.models.precision import weak

    B, U, D, T_in = DECODER_WIDTHS
    s = torch.finfo(dt).bits // 8

    def rn(*shape, scale=1.0, dtype=dt):
        return (torch.randn(*shape, device='cuda', generator=gen) * scale).to(dtype)

    keep = [torch.rand(B, U, device='cuda', generator=gen) < 0.9 for _ in range(2)]
    z, c, h = rn(B, 4 * U), rn(B, U, scale=0.5), rn(B, U, scale=0.5)
    wide = rn(B, U + 512)            # dx2 is a slice of the projections' gradient
    dhb = rn(B, U, scale=0.1)
    dh, dc = rn(B, U, dtype=torch.float32), rn(B, U, dtype=torch.float32)
    a = weak(0.9, dt)
    lengths = torch.linspace(T_in // 2, T_in, B, device='cuda').long()
    mask = (torch.arange(T_in, device='cuda')[None] < lengths[:, None]).float()
    keys, pq, pl = rn(B, T_in, D), rn(B, D), rn(B, T_in, D, scale=0.5)
    pl_b = rn(D, scale=0.1, dtype=torch.float32) if dt == torch.bfloat16 else None
    b_a, v_a = rn(D, scale=0.1, dtype=torch.float32), rn(D, scale=0.3, dtype=torch.float32)
    state = torch.rand(B, T_in, device='cuda', generator=gen) * 2
    dal, ga, dst = (rn(B, T_in, dtype=torch.float32) for _ in range(3))
    accs = (rn(B, T_in, D, dtype=torch.float32), rn(B, D, dtype=torch.float32),
            rn(B, D, dtype=torch.float32))
    n_bu, n_att = B * U, B * T_in * D
    n_vec = D * 4 * (2 + (pl_b is not None))  # b_a, v_a and pl_b, read by every row
    listed = lambda r, args: list(r)
    return {
        'lstm_cell_fwd': (dv.lstm_cell_fwd, dv._lstm_cell_fwd_plain,
                          (lambda: (z, c, h, *keep, 0.1, 0.1),
                           lambda: (z, c, h, None, None, 0.1, 0.1)), listed,
                          n_bu * (4 * s + 2 * s + 2 + 3 * s), n_bu * 40),
        'lstm_cell_bwd': (dv.lstm_cell_bwd, dv._lstm_cell_bwd_plain,
                          (lambda: (z, c, wide[:, :U], dhb, dh, dc, *keep, a, a),
                           lambda: (z, c, wide[:, :U], None, dh, dc, None, None, a, a)),
                          listed, n_bu * (4 * s + 3 * s + 8 + 2 + 4 * s + 8), n_bu * 70),
        'attention_fwd': (dv.attention_fwd, dv._attention_fwd_plain,
                          (lambda: (keys, pq, pl, pl_b, b_a, v_a, mask, state, False, True),),
                          listed,
                          2 * n_att * s + B * D * s + n_vec
                          + B * T_in * 4 * (2 + 2 + (s == 2)),
                          n_att * 8),
        # the accumulators updated in place are outputs too
        'attention_bwd': (dv.attention_bwd, dv._attention_bwd_plain,
                          (lambda: (keys, pq, pl, pl_b, b_a, v_a, mask, dal, ga, dst, False,
                                    *(x.clone() for x in accs)),),
                          lambda r, args: [*r, *args[-3:]],
                          2 * n_att * s + n_vec + B * T_in * 4 * 4 + n_att * (8 + s)
                          + B * D * (2 * s + 16), n_att * 20)}


def _rel_err(got, want):
    return max(float((g.double() - w.double()).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want, strict=True))


def decoder_kernel_checks(decoder_mutants):
    """Each of the four decoder kernels against its plain version on the card at the
    trainer's widths, in f32 and bf16, with its planted faults. Returns {kernel: readings}."""
    from tacotron2_tpu_torch.ops import decoder_vjp as dv

    out = collections.defaultdict(dict)
    for dt in F32_BF16:
        gen = torch.Generator('cuda').manual_seed(16)
        for name, case in decoder_cases(dt, gen).items():
            kernel, plain, variants, outputs, n_bytes, n_ops = case
            tol = DECODER_TOL[name][dt]
            faults = [f for f, m in DECODER_MUTANTS.items() if name in m[0] and dt in m[1]]
            err = abs_err = 0.0
            seen = dict.fromkeys(faults, 0.0)
            for inputs in variants:  # training's keep-gates, then zoneout's expectation
                args, args_p = inputs(), inputs()
                got, want = outputs(kernel(*args), args), outputs(plain(*args_p), args_p)
                err = max(err, _rel_err(got, want))
                abs_err = max(abs_err, *(float((g.double() - w.double()).abs().max())
                                         for g, w in zip(got, want)))
                for fault in faults:
                    with _patched(dv, 'library', lambda lib=decoder_mutants[fault]: lib):
                        args = inputs()
                        seen[fault] = max(seen[fault],
                                          _rel_err(outputs(kernel(*args), args), want))
            args, args_p = variants[0](), variants[0]()
            ms, plain_ms = graph_ms(lambda: kernel(*args)), graph_ms(lambda: plain(*args_p))
            byte_ms, op_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_PEAK_OPS * 1e3
            key = str(dt).split('.')[-1]
            out[name][key] = dict(rel_err=err, max_abs_err=abs_err, tol=tol, ms=ms,
                                  plain_ms=plain_ms, bound_ms=max(byte_ms, op_ms),
                                  bound_by='bytes' if byte_ms >= op_ms else 'operations',
                                  faults=seen)
            phase(16, f'{name} {key} B={DECODER_WIDTHS[0]} U={DECODER_WIDTHS[1]} '
                      f'D={DECODER_WIDTHS[2]} T_in={DECODER_WIDTHS[3]}: kernel vs plain rel '
                      f'err {err:.2e} (max abs {abs_err:.2e}; tol {tol}); planted faults, '
                      f'each must exceed it: '
                      + '; '.join(f'{f} {v:.2e}' for f, v in seen.items())
                      + f'; kernel {1e3 * ms:.2f} us, plain version {1e3 * plain_ms:.2f} us '
                      f'(CUDA graphs), bound {1e3 * max(byte_ms, op_ms):.3f} us by '
                      f'{"bytes" if byte_ms >= op_ms else "operations"}')
            if not err <= tol:
                fail(f'the {name} kernel disagrees with its plain version in {key}')
            for fault, v in seen.items():
                if not v > tol:
                    fail(f'the {name} check does not see its planted fault ({fault}) in {key}')
    return dict(out)


def fused_vs_autograd(ratio=0.5, dtype=torch.float32):
    """fused_decoder_scan on the card against ops/fused_decoder.decoder_scan under autograd
    on the card, both in `dtype` (TF32 off), at the default width, B=32 x FUSED_FRAMES
    frames, 100 characters, keys and values from the model's encoder, the model's dropout
    masks and zoneout keep-gates, teacher forcing at `ratio`: the outputs' largest error
    and the gradient of a seeded projection of them with respect to every decoder weight,
    the keys, the values and the teacher frames in relative L2, all of them together as
    phase 12 holds a step's (each tensor's printed), within FUSED_TOL[dtype]. In bf16 the
    fused decoder again under precast_fault (its deferred weight gradients summed step by
    step in bf16), whose gradients must miss that bound. Then the fused decoder's forward
    and backward once more under torch.profiler: the device's busy time beside the
    wall. Returns the readings."""
    from torch.profiler import ProfilerActivity, profile

    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.ops import decoder_vjp as dv
    from tacotron2_tpu_torch.ops import fused_decoder as fd
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    hp = default_hparams()
    hp.parse(TACO_OVERRIDES)
    model = tt.create_train_state(hp, 'cuda', seed=16).model
    B, T = hp.tacotron_batch_size, FUSED_FRAMES
    batch = taco_timed_batch(hp, B, T, TIMED_CHARS)
    gen = torch.Generator('cuda').manual_seed(17)
    noise = model.draw_noise(B, TIMED_CHARS, T, gen, False, 'cuda')
    with torch.no_grad():
        keys, values, mask = model._encode(batch['inputs'], batch['input_lengths'],
                                           dtype=dtype)
    strided = batch['mel_targets'][:, hp.outputs_per_step - 1::hp.outputs_per_step]
    teacher = torch.cat([torch.zeros_like(strided[:, :1]), strided[:, :-1]], 1).transpose(0, 1)
    use = (noise['coins'] < ratio).float()
    steps = teacher.shape[0]
    cot = [torch.randn(steps, B, n, device='cuda', generator=gen)
           for n in (hp.num_mels * hp.outputs_per_step, hp.outputs_per_step, TIMED_CHARS)]

    def run(fn, reps=2):  # the last run is timed
        for _ in range(reps):
            model.zero_grad()
            k, v, tch = (x.detach().clone().requires_grad_() for x in (keys, values, teacher))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = fn(model.decoder, k, v, mask, tch, use, [noise['m1'], noise['m2']],
                      noise['zo'], dtype)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            sum(torch.sum(o.float() * c) for o, c in zip(outs, cot)).backward()
            torch.cuda.synchronize()
            secs = [t1 - t0, time.perf_counter() - t1]
        grads = {n: p.grad.detach().clone() for n, p in model.decoder.named_parameters()}
        grads.update(keys=k.grad, values=v.grad, teacher=tch.grad)
        return outs, grads, secs

    def gaps(of, gf):
        out_err = max(float((a.float() - f.float()).detach().abs().max())
                      for a, f in zip(oa, of))
        rel = {n: float((gf[n].double() - ga[n].double()).norm() / ga[n].double().norm())
               for n in ga}
        whole = (sum(float((gf[n].double() - ga[n].double()).square().sum()) for n in ga)
                 / sum(float(ga[n].double().square().sum()) for n in ga)) ** 0.5
        return out_err, rel, whole

    oa, ga, sa = run(fd.decoder_scan)
    of, gf, sf = run(dv.fused_decoder_scan)
    out_err, rel, whole = gaps(of, gf)
    out_tol, grad_tol = FUSED_TOL[dtype]
    fault = None
    if dtype == torch.bfloat16:
        with precast_fault():
            fault = gaps(*run(dv.fused_decoder_scan, reps=1)[:2])[2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(dv.fused_decoder_scan, reps=1)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    ms = {k: 1e3 * s / steps for k, s in (('autograd_fwd', sa[0]), ('autograd_bwd', sa[1]),
                                          ('fused_fwd', sf[0]), ('fused_bwd', sf[1]))}
    key = str(dtype).split('.')[-1]
    phase(16, f'fused_decoder_scan vs autograd decoder_scan on the card, {key} (TF32 off), '
              f'B={B} x {steps} steps, T_in={TIMED_CHARS}, dropout and zoneout gates, '
              f'teacher forcing at {ratio}: outputs max abs err {out_err:.2e} (tol '
              f'{out_tol}); the gradients (every decoder weight, keys, values, teacher '
              f'frames) {whole:.2e} apart in relative L2 (tol {grad_tol}), each tensor: '
              + ', '.join(f'{n} {r:.1e}' for n, r in rel.items())
              + ('' if fault is None else f'; planted fault (the fused decoder\'s weight '
                 f'gradients summed step by step in bf16) {fault:.2e}, must exceed it')
              + f'; ms a step, host clock between synchronizes: autograd forward '
              f'{ms["autograd_fwd"]:.3f}, backward {ms["autograd_bwd"]:.3f}; fused forward '
              f'{ms["fused_fwd"]:.3f}, backward {ms["fused_bwd"]:.3f}; the fused forward and '
              f'backward under torch.profiler: wall {wall_ms:.1f} ms, the device busy '
              f'{busy_ms:.1f} ms ({busy_ms / wall_ms:.0%})')
    if not (whole <= grad_tol and out_err <= out_tol):
        fail(f'the fused decoder\'s outputs or gradients disagree with autograd\'s in {key}')
    if fault is not None and not fault > grad_tol:
        fail('the fused decoder check in bf16 does not see its planted fault')
    return dict(out_max_abs_err=out_err, grad_rel_l2=whole, grad_rel_l2_by_tensor=rel,
                worst=max(rel, key=rel.get), fault_grad_rel_l2=fault, ms_per_step=ms,
                profiled_wall_ms=wall_ms, device_busy_ms=busy_ms)


# --- phase 16: the decoder's forward recurrence as one persistent kernel -----------------

LOOP_SOURCE = 'tacotron2_tpu_torch/csrc/decoder_loop/decoder_loop.cu'
LOOP_REPLACES = ('tacotron2_tpu/ops/fused_decoder.py:122-127,356-364 (lstm_cell_fwd), '
                 ':215-228,367-368 (attention_fwd), :341-416 (_step_fwd, _forward)')
LOOP_STEPS = TIMED_FRAMES  # r = 1: the timed batch's 512 decoder steps
# the error over the first steps (a planted state fault shows from step 2 on, where the
# state first holds two alignments), and over all of them
LOOP_FIRST_STEPS = 3
# the kernel against its plain version on the same CUDA tensors, {span: bound}: the
# largest error of the alignments, x2, the contexts and every residual, relative to the
# plain tensor's largest entry over the span. Read on an H100 80GB HBM3 at 700 W: the
# first three steps 1.2e-3 to 5.9e-3 (a gate that the two round from f32 sums in another
# order lands one bf16 step apart: 2**-8 of the value), all 512 steps 1.7e-2 to 2.4e-2
# (two bf16 recurrences that round a few sums apart drift apart over the steps); the
# planted faults 0.34 to 0.72 over the first steps (the saved state's 0.50 there alone),
# 0.83 to 1.14 over all. The bounds sit 1.7x and 2.1x above the sound readings
LOOP_TOL = {'first': 1e-2, 'all': 5e-2}
# (B, keep-gates, a ragged mask) of each check: the trainer's batch with training's
# keep-gates, then with zoneout's expectation and 50 to 100 input steps; one row
LOOP_CASES = {'B=32, keep-gates': (32, True, False),
              'B=32, expectation, ragged mask': (32, False, True),
              'B=1, expectation': (1, False, False)}
# planted faults: each a build of a copy of csrc/decoder_loop/decoder_loop.cu with one line
# changed, built in phase 2, {fault: (the line, its change)}; each must miss LOOP_TOL
LOOP_MUTANTS = {
    'the forget bias dropped': ('const float sf = sig(rd(z[2] + 1.0f));',
                                'const float sf = sig(z[2]);'),
    'h1\'s keep-gate ignored': ('const uint8_t* keep_h1 = a.keep[1];',
                                'const uint8_t* keep_h1 = nullptr;'),
    'pl_b not added': ('const float pl = rd(acc[n][2 * h + e]) + a.pl_b[dd];',
                       'const float pl = rd(acc[n][2 * h + e]);'),
    'the mask ignored': ('if (a.mask && !(a.mask[(size_t)tid * T_in + j] > 0.0f)) e = NEG_INF;',
                         ';'),
    'the state not cumulated': ('const float nw = a.cumulate ? al + old : al;',
                                'const float nw = al;'),
    'the saved state written after its update': ('if (a.state) a.state[o] = old;',
                                                 'if (a.state) a.state[o] = nw;')}
LOOP_NAMES = ('aligns', 'x2', 'ctx', 'z1', 'z2', 'x1', 'c1p', 'h1p', 'c2p', 'h2p', 'state', 'pq')


def mutated_loop_source(fault):
    """The text of csrc/decoder_loop/decoder_loop.cu with LOOP_MUTANTS[fault]'s change."""
    from tacotron2_tpu_torch.ops import _build

    old, new = LOOP_MUTANTS[fault]
    with open(os.path.join(_build.DECODER_LOOP_DIR, 'decoder_loop.cu'), encoding='utf-8') as f:
        text = f.read()
    if text.count(old) != 1:
        raise ValueError(f'the line that {fault!r} changes stands {text.count(old)} times in '
                         'csrc/decoder_loop/decoder_loop.cu: bring LOOP_MUTANTS up to date')
    return text.replace(old, new)


def loop_case(model, hp, B, gates, ragged, dtype=torch.bfloat16, T_in=TIMED_CHARS):
    """The forward loop's inputs at the default width, B rows x LOOP_STEPS steps and T_in
    characters in `dtype`: keys, values and mask from the model's encoder on a seeded
    batch (with `ragged`, T_in / 2 to T_in characters), the prenet's output on its teacher
    frames with the model's dropout masks, training's keep-gates (0.9) where `gates`,
    else zoneout's expectation. Returns the arguments of decoder_fwd_loop and of the whole
    forward (`_forward`, `_step_loop`)."""
    from tacotron2_tpu_torch.ops import decoder_vjp as dv

    dt, T = dtype, LOOP_STEPS
    cell = model.decoder
    cfg = dv._config(cell, dt)
    W = dv._weights(cfg, cell, [cell.get_parameter(n) for _, n in dv.PARAMS], B, T_in)
    batch = taco_timed_batch(hp, B, T, T_in)
    lengths = (torch.linspace(T_in // 2, T_in, B, device='cuda').long() if ragged
               else batch['input_lengths'])
    gen = torch.Generator('cuda').manual_seed(18 + B)
    noise = model.draw_noise(B, T_in, T, gen, not gates, 'cuda')
    with torch.no_grad():
        keys, values, mask = model._encode(batch['inputs'], lengths, dtype=dt)
    mel = batch['mel_targets']
    teacher = torch.cat([torch.zeros_like(mel[:, :1]), mel[:, :-1]], 1).transpose(0, 1)
    masks = [noise['m1'], noise['m2']]
    zo = noise['zo'] if gates else None
    keys, values = keys.to(dt).contiguous(), values.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    p2 = dv._prenet(W, teacher, *(m.to(dt) for m in masks), dt)[2]
    gate_list = [None] * 4 if zo is None else [g.bool() for g in zo]
    return dict(loop=(cfg, W, keys, values, mask, p2, gate_list),
                forward=(cfg, W, keys, values, mask, teacher, torch.ones(T, device='cuda'),
                         masks, zo))


def _span_errs(got, want, steps):
    """{name: the largest error over the first `steps` steps relative to the plain
    tensor's largest entry there}."""
    out = {}
    for name in LOOP_NAMES:
        g, w = got[name][:steps].double(), want[name][:steps].double()
        out[name] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return out


def _loop_outputs(result):
    aligns, x2, ctx, R = result
    return dict(R, aligns=aligns, x2=x2, ctx=ctx)


def loop_bound(B, T, T_in, save=True, gates=True):
    """(ms, 'bytes' or 'operations') of the least time an H100 takes for the forward loop
    of B rows over T steps at LOOP_WIDTHS: its products' operations over the bf16 tensor
    cores' peak (decoder_loop.cu's note), or its bytes (each input read once: p2, keys,
    values, the mask, the weights, loc_n and, with `gates`, the keep-gates; each output
    written once: the alignments, x2, the contexts and, with `save`, the residuals) over
    the HBM rate."""
    from tacotron2_tpu_torch import probes
    from tacotron2_tpu_torch.ops import decoder_vjp as dv

    U, n_p, E, D = dv.LOOP_WIDTHS
    ops = 2 * T * (B * (n_p + E + U + 2 * U) * 4 * U + B * U * D + B * T_in * T_in * D
                   + B * T_in * E)
    weights = (2 * (4 * U * (n_p + E + U) + 4 * U * 2 * U + 8 * U + D * U + T_in * T_in * D)
               + 12 * D)
    inputs = (2 * T * B * n_p + 2 * B * T_in * D + 4 * B * T_in * E + 4 * B * T_in + weights
              + (4 * T * B * U if gates else 0))
    outputs = T * B * (4 * T_in + 2 * U + 2 * E)
    if save:
        outputs += T * B * (2 * 8 * U + 2 * 5 * U + 4 * T_in + 2 * D)
    return probes.bound_ms(inputs + outputs, flops_bf16=ops)


def loop_kernel_checks(loop_mutants):
    """decoder_fwd_loop against its plain version on the same CUDA tensors at the default
    width over LOOP_STEPS steps, each of LOOP_CASES: the alignments, x2, the contexts and
    every residual, over the first LOOP_FIRST_STEPS steps and over all of them, within
    LOOP_TOL; each of LOOP_MUTANTS (`loop_mutants`: fault -> its library) must miss it in
    one span of one case. At B=1 the launch without residuals must give the launch's
    outputs bit for bit. Then the B=32 launch timed (CUDA events, the median of 3), its
    plain version, the step loop (`_step_loop`: lstm_cell_fwd, attention_fwd and the
    library products, the prenet and the projections included) and the kernel's whole
    forward (`_forward`, the same) over the same steps. Returns the readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.ops import decoder_vjp as dv
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    hp = default_hparams()
    hp.parse(TACO_OVERRIDES)
    model = tt.create_train_state(hp, 'cuda', seed=15).model
    # the location conv's bias starts at 0; a trained one's is not, and pl_b carries it
    bias = model.decoder.attention.location_convolution.bias
    with torch.no_grad():
        bias.copy_(torch.randn(bias.shape, device='cuda',
                               generator=torch.Generator('cuda').manual_seed(15)) * 0.5)
    readings, seen = {}, dict.fromkeys(LOOP_MUTANTS, 0.0)
    launches0 = dv.LAUNCHES['decoder_fwd_loop']
    for what, (B, gates, ragged) in LOOP_CASES.items():
        case = loop_case(model, hp, B, gates, ragged)
        with torch.no_grad():
            want = _loop_outputs(dv._decoder_fwd_loop_plain(*case['loop'], True))
            got = _loop_outputs(dv.decoder_fwd_loop(*case['loop'], True))
            torch.cuda.synchronize()
            spans = {'first': _span_errs(got, want, LOOP_FIRST_STEPS),
                     'all': _span_errs(got, want, LOOP_STEPS)}
            r = dict(first=max(spans['first'].values()), all=max(spans['all'].values()),
                     worst_first=max(spans['first'], key=spans['first'].get),
                     worst_all=max(spans['all'], key=spans['all'].get),
                     max_abs_err=max(float((got[n].double() - want[n].double()).abs().max())
                                     for n in LOOP_NAMES), by_tensor=spans['all'])
            if B == 1:
                lean = dv.decoder_fwd_loop(*case['loop'], False)
                r['without_residuals_bit_identical'] = all(
                    torch.equal(a, got[n]) for a, n in zip(lean[:3], ('aligns', 'x2', 'ctx')))
                if not r['without_residuals_bit_identical']:
                    fail('the forward loop without residuals differs from the launch with them')
            for fault, lib in loop_mutants.items():
                with _patched(dv, 'loop_library', lambda lib=lib: lib):
                    bad = _loop_outputs(dv.decoder_fwd_loop(*case['loop'], True))
                e = max(max(_span_errs(bad, want, LOOP_FIRST_STEPS).values()) / LOOP_TOL['first'],
                        max(_span_errs(bad, want, LOOP_STEPS).values()) / LOOP_TOL['all'])
                seen[fault] = max(seen[fault], e)
            if B == 32 and gates:
                args = case['loop']
                ms = sorted(cuda_ms(lambda: dv.decoder_fwd_loop(*args, True))[1]
                            for _ in range(3))[1]
                plain_ms = cuda_ms(lambda: dv._decoder_fwd_loop_plain(*args, True))[1]
                step_loop_ms = sorted(cuda_ms(lambda: dv._step_loop(*case['forward'], True))[1]
                                      for _ in range(2))[0]
                forward_ms = sorted(cuda_ms(lambda: dv._forward(*case['forward'], True))[1]
                                    for _ in range(3))[1]
                bound_ms, bound_by = loop_bound(B, LOOP_STEPS, TIMED_CHARS)
                r.update(ms=ms, plain_ms=plain_ms, step_loop_ms=step_loop_ms,
                         forward_ms=forward_ms, bound_ms=bound_ms, bound_by=bound_by)
            if B == 1:
                args = case['loop']
                r['ms_without_residuals'] = sorted(
                    cuda_ms(lambda: dv.decoder_fwd_loop(*args, False))[1] for _ in range(3))[1]
                r['bound_ms'], r['bound_by'] = loop_bound(B, LOOP_STEPS, TIMED_CHARS, False,
                                                          gates)
        readings[what] = r
        phase(16, f'decoder_fwd_loop {what}, {LOOP_STEPS} steps, T_in={TIMED_CHARS} '
                  f'(bf16): kernel vs plain, relative to the plain tensor\'s largest entry, '
                  f'first {LOOP_FIRST_STEPS} steps {r["first"]:.2e} ({r["worst_first"]}; tol '
                  f'{LOOP_TOL["first"]}), all steps {r["all"]:.2e} ({r["worst_all"]}; tol '
                  f'{LOOP_TOL["all"]}); max abs {r["max_abs_err"]:.2e}; by tensor over all '
                  'steps: ' + ', '.join(f'{n} {v:.1e}' for n, v in spans['all'].items())
                  + ('' if 'ms' not in r else
                     f'; the launch {r["ms"]:.2f} ms ({1e3 * r["ms"] / LOOP_STEPS:.1f} us a '
                     f'step), its plain version {r["plain_ms"]:.1f} ms, the step loop '
                     f'(lstm_cell_fwd, attention_fwd, cuBLAS; the prenet and projections '
                     f'in) {r["step_loop_ms"]:.1f} ms, the kernel\'s whole forward (the same) '
                     f'{r["forward_ms"]:.2f} ms; bound {r["bound_ms"]:.3f} ms by '
                     f'{r["bound_by"]}')
                  + ('' if 'ms_without_residuals' not in r else
                     f'; the launch without residuals {r["ms_without_residuals"]:.2f} ms '
                     f'({1e3 * r["ms_without_residuals"] / LOOP_STEPS:.1f} us a step), bit '
                     f'for bit the outputs of the one with them; bound {r["bound_ms"]:.3f} ms '
                     f'by {r["bound_by"]}'))
        if not (r['first'] <= LOOP_TOL['first'] and r['all'] <= LOOP_TOL['all']):
            fail(f'the decoder_fwd_loop kernel disagrees with its plain version ({what})')
    phase(16, 'decoder_fwd_loop planted faults, the largest of their errors over a bound '
              '(each must exceed 1): ' + '; '.join(f'{f} {v:.2f}' for f, v in seen.items()))
    for fault, v in seen.items():
        if not v > 1:
            fail(f'the decoder_fwd_loop check does not see its planted fault ({fault})')
    return dict(cases=readings, faults=seen,
                check_launches=dv.LAUNCHES['decoder_fwd_loop'] - launches0)


# --- phase 16: the decoder's float32 forward recurrence as one persistent kernel ---------

F32_LOOP_SOURCE = 'tacotron2_tpu_torch/csrc/decoder_loop_f32/decoder_loop_f32.cu'
F32_LOOP_REPLACES = ('tacotron2_tpu/ops/fused_decoder.py:122-127,356-364 (lstm_cell_fwd), '
                     ':195-228,367-368 (attention_fwd with the location conv), :341-416 '
                     '(_step_fwd, _forward), at float32')
# (B, keep-gates, a ragged mask, T_in) of each check: the trainer's batch and GTA's one
# row, each with training's keep-gates and with zoneout's expectation, at 100 characters;
# and 200 characters with a ragged mask, past the bf16 fold's 181, which only the conv
# tier takes
F32_LOOP_CASES = {'B=32, keep-gates': (32, True, False, 100),
                  'B=32, expectation': (32, False, False, 100),
                  'B=1, keep-gates': (1, True, False, 100),
                  'B=1, expectation': (1, False, False, 100),
                  'B=32, T_in=200, keep-gates, ragged mask': (32, True, True, 200)}
# the kernel against its plain version on the same CUDA tensors, {span: bound}, as LOOP_TOL.
# Read on an H100 80GB HBM3 at 700 W: the first three steps 4.3e-7 to 1.7e-6 (the gate
# products as 3xTF32 against cuBLAS's f32 sums), all 512 steps 3.6e-6 to 5.8e-6 (the
# alignments: an energy a few ulps apart moves the softmax, and the recurrence carries it);
# with the six products of a k-quad summed through the accumulator over a whole K-slice,
# 3.8e-6 and 7.1e-6 (the tensor cores' sum truncates); the planted faults read 944x to
# 8,369x bounds of 1e-4 / 1e-3. The bounds sit about 6x above the sound readings
F32_LOOP_TOL = {'first': 1e-5, 'all': 3e-5}
# planted faults: each a build of a copy of csrc/decoder_loop_f32/decoder_loop_f32.cu with one
# line changed, built in phase 2, {fault: (the line, its change)}; each must miss
# F32_LOOP_TOL in one span of one case
F32_LOOP_MUTANTS = {
    'f32 loop: the forget bias dropped': ('const float sf = sig(z[2] + 1.0f);',
                                          'const float sf = sig(z[2]);'),
    'f32 loop: the zoneout mix of h swapped': (
        'h = kh >= 0 ? (kh ? hn : h) : mh[0] * hn + mh[1] * h;',
        'h = kh >= 0 ? (kh ? hn : h) : mh[1] * hn + mh[0] * h;'),
    'f32 loop: the mask ignored': (
        'if (a.mask && !(a.mask[(size_t)tid * T_in + j] > 0.0f)) e = NEG_INF;', ';'),
    'f32 loop: a conv tap off by one': ('const int r = i / K, k = i % K, s = j + k - pad_lo;',
                                        'const int r = i / K, k = i % K, s = j + k - pad_lo + 1;'),
    'f32 loop: the state not cumulated': ('const float nw = a.cumulate ? al + old : al;',
                                          'const float nw = al;'),
    'f32 loop: a streamed k-quad of g2 skipped': (
        'segment<MT, true, true>(d, x1, U, B, 0, KQ_U, warp, lane, streamed);',
        'segment<MT, true, true>(d, x1, U, B, 0, KQ_U - 1, warp, lane, streamed);')}


def mutated_loop_f32_source(fault):
    """The text of csrc/decoder_loop_f32/decoder_loop_f32.cu with F32_LOOP_MUTANTS[fault]'s
    change."""
    from tacotron2_tpu_torch.ops import _build

    old, new = F32_LOOP_MUTANTS[fault]
    path = os.path.join(_build.DECODER_LOOP_F32_DIR, 'decoder_loop_f32.cu')
    with open(path, encoding='utf-8') as f:
        text = f.read()
    if text.count(old) != 1:
        raise ValueError(f'the line that {fault!r} changes stands {text.count(old)} times in '
                         'csrc/decoder_loop_f32/decoder_loop_f32.cu: bring F32_LOOP_MUTANTS up '
                         'to date')
    return text.replace(old, new)


TF32_PEAK_OPS = 495e12  # TF32 on the tensor cores, dense (the 3xTF32 products' type)
# the timed cases: the trainer's (with residuals) and GTA's (one row, without them)
F32_LOOP_TIMED = ('B=32, keep-gates', 'B=1, expectation')


def _f32_bound(nbytes, mma_ops, core_ops):
    """(ms, 'bytes' or 'operations', the operations' ms on the f32 CUDA cores) of the least
    time an H100 takes to move `nbytes` and do, at float32 accuracy, `mma_ops` of products
    and `core_ops` of other operations: the larger of the bytes over the HBM rate and the
    operations at their fastest, the products three times over on the TF32 tensor cores
    (3xTF32, as the loops run them; 165 TFLOP/s of f32 products) and the rest on the f32
    CUDA cores. Beside it, the same operations all on the f32 CUDA cores."""
    from tacotron2_tpu_torch import probes

    bytes_ms = 1e3 * nbytes / probes.HBM_BYTES_PER_S
    ops_ms = 1e3 * (3 * mma_ops / TF32_PEAK_OPS + core_ops / F32_PEAK_OPS)
    core_ms = 1e3 * (mma_ops + core_ops) / F32_PEAK_OPS
    return max(bytes_ms, ops_ms), 'operations' if ops_ms >= bytes_ms else 'bytes', core_ms


def loop_f32_bound(B, T, T_in, K, save=True, gates=True):
    """(ms, 'bytes' or 'operations', the operations' ms on the f32 CUDA cores) of the least
    time an H100 takes for the float32 forward loop of B rows over T steps at LOOP_WIDTHS
    and LOOP_FILTERS with a location conv of K taps (`_f32_bound`): its products'
    operations (the gates and pq as 3xTF32; the location features and their projection
    and the context on the CUDA cores; decoder_loop_f32.cu's note), or its bytes (each
    input read once: p2, keys, values, the mask, the weights and, with `gates`, the
    keep-gates; each output written once: the alignments, x2, the contexts and, with
    `save`, the residuals) over the HBM rate."""
    from tacotron2_tpu_torch.ops import decoder_vjp as dv

    U, n_p, E, D = dv.LOOP_WIDTHS
    n_f = dv.LOOP_FILTERS
    mma_ops = 2 * T * B * ((n_p + E + U + 2 * U) * 4 * U + U * D)
    core_ops = 2 * T * B * T_in * (K * n_f + n_f * D + E)
    weights = 4 * (4 * U * (n_p + E + U + 2 * U) + 8 * U + D * U + n_f * K + n_f + D * n_f
                   + 2 * D)
    inputs = (4 * T * B * n_p + 4 * B * T_in * (D + E + 1) + weights
              + (4 * T * B * U if gates else 0))
    outputs = 4 * T * B * (T_in + U + E)
    if save:
        outputs += 4 * T * B * (8 * U + 5 * U + T_in + D)
    return _f32_bound(inputs + outputs, mma_ops, core_ops)


def loop_f32_kernel_checks(f32_mutants):
    """decoder_fwd_loop in float32 (csrc/decoder_loop_f32/decoder_loop_f32.cu) against its
    plain version on the same CUDA tensors at the default width over LOOP_STEPS steps,
    each of F32_LOOP_CASES: the alignments, x2, the contexts and every residual, over the
    first LOOP_FIRST_STEPS steps and over all of them, within F32_LOOP_TOL; a second
    launch bit for bit the first; each of F32_LOOP_MUTANTS (`f32_mutants`: fault -> its
    library) must miss the bound in one span of one case. Then F32_LOOP_TIMED's launches
    timed (CUDA events, the median of 3; GTA's without residuals, as it runs), at B=32
    beside the plain version, the float32 step loop's forward (`_step_loop`:
    lstm_cell_fwd, attention_fwd, the library products and the location conv; the prenet
    and the projections in) and the kernel's whole forward (`_forward`, the same) over the
    same steps. Returns the readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.ops import decoder_vjp as dv
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    hp = default_hparams()
    hp.parse(TACO_OVERRIDES)
    model = tt.create_train_state(hp, 'cuda', seed=15).model
    conv = model.decoder.attention.location_convolution
    with torch.no_grad():  # a trained location conv's bias is not 0 (as loop_kernel_checks)
        conv.bias.copy_(torch.randn(conv.bias.shape, device='cuda',
                                    generator=torch.Generator('cuda').manual_seed(15)) * 0.5)
    K = conv.weight.shape[-1]
    t0 = time.perf_counter()
    readings, seen = {}, dict.fromkeys(F32_LOOP_MUTANTS, 0.0)
    launches0 = dv.LAUNCHES['decoder_fwd_loop_f32']
    for what, (B, gates, ragged, T_in) in F32_LOOP_CASES.items():
        case = loop_case(model, hp, B, gates, ragged, torch.float32, T_in)
        args = case['loop']
        with torch.no_grad():
            want = _loop_outputs(dv._decoder_fwd_loop_plain(*args, True))
            got = _loop_outputs(dv.decoder_fwd_loop(*args, True))
            again = _loop_outputs(dv.decoder_fwd_loop(*args, True))
            torch.cuda.synchronize()
            spans = {'first': _span_errs(got, want, LOOP_FIRST_STEPS),
                     'all': _span_errs(got, want, LOOP_STEPS)}
            r = dict(first=max(spans['first'].values()), all=max(spans['all'].values()),
                     worst_first=max(spans['first'], key=spans['first'].get),
                     worst_all=max(spans['all'], key=spans['all'].get),
                     max_abs_err=max(float((got[n].double() - want[n].double()).abs().max())
                                     for n in LOOP_NAMES), by_tensor=spans['all'],
                     bit_identical=all(torch.equal(again[n], got[n]) for n in LOOP_NAMES))
            if not r['bit_identical']:
                fail(f'two launches of the float32 decoder_fwd_loop differ ({what})')
            for fault, lib in f32_mutants.items():
                with _patched(dv, 'loop_f32_library', lambda lib=lib: lib):
                    bad = _loop_outputs(dv.decoder_fwd_loop(*args, True))
                e = max(max(_span_errs(bad, want, LOOP_FIRST_STEPS).values())
                        / F32_LOOP_TOL['first'],
                        max(_span_errs(bad, want, LOOP_STEPS).values()) / F32_LOOP_TOL['all'])
                seen[fault] = max(seen[fault], e)
            if what in F32_LOOP_TIMED:
                save = B > 1  # GTA (one row) runs without residuals, training with them
                r['ms'] = sorted(cuda_ms(lambda: dv.decoder_fwd_loop(*args, save))[1]
                                 for _ in range(3))[1]
                r['bound_ms'], r['bound_by'], r['f32_core_bound_ms'] = loop_f32_bound(
                    B, LOOP_STEPS, T_in, K, save, gates)
            if what == F32_LOOP_TIMED[0]:
                r['plain_ms'] = cuda_ms(lambda: dv._decoder_fwd_loop_plain(*args, True))[1]
                r['step_loop_ms'] = sorted(cuda_ms(lambda: dv._step_loop(*case['forward'], True))[1]
                                           for _ in range(2))[0]
                r['forward_ms'] = sorted(cuda_ms(lambda: dv._forward(*case['forward'], True))[1]
                                         for _ in range(3))[1]
        readings[what] = r
        phase(16, f'decoder_fwd_loop_f32 {what}, {LOOP_STEPS} steps, T_in={T_in} (f32): kernel '
                  f'vs plain, relative to the plain tensor\'s largest entry, first '
                  f'{LOOP_FIRST_STEPS} steps {r["first"]:.2e} ({r["worst_first"]}; tol '
                  f'{F32_LOOP_TOL["first"]}), all steps {r["all"]:.2e} ({r["worst_all"]}; tol '
                  f'{F32_LOOP_TOL["all"]}); max abs {r["max_abs_err"]:.2e}; a second launch bit '
                  'for bit the first; by tensor over all steps: '
                  + ', '.join(f'{n} {v:.1e}' for n, v in spans['all'].items())
                  + ('' if 'ms' not in r else
                     f'; the launch{"" if B > 1 else " without residuals"} {r["ms"]:.2f} ms '
                     f'({1e3 * r["ms"] / LOOP_STEPS:.1f} us a step), bound {r["bound_ms"]:.3f} '
                     f'ms by {r["bound_by"]} ({r["f32_core_bound_ms"]:.3f} ms on the f32 CUDA cores)')
                  + ('' if 'plain_ms' not in r else
                     f'; its plain version {r["plain_ms"]:.1f} ms, the f32 step loop\'s forward '
                     f'(lstm_cell_fwd, attention_fwd, cuBLAS, the conv; the prenet and '
                     f'projections in) {r["step_loop_ms"]:.1f} ms, the kernel\'s whole forward '
                     f'(the same) {r["forward_ms"]:.2f} ms'))
        if not (r['first'] <= F32_LOOP_TOL['first'] and r['all'] <= F32_LOOP_TOL['all']):
            fail(f'the float32 decoder_fwd_loop kernel disagrees with its plain version ({what})')
    seconds = time.perf_counter() - t0
    phase(16, 'decoder_fwd_loop_f32 planted faults, the largest of their errors over a bound '
              '(each must exceed 1): ' + '; '.join(f'{f} {v:.2f}' for f, v in seen.items())
              + f'; the float32 loop\'s checks took {seconds:.1f} s')
    for fault, v in seen.items():
        if not v > 1:
            fail(f'the float32 decoder_fwd_loop check does not see its planted fault ({fault})')
    return dict(cases=readings, faults=seen, seconds=seconds,
                check_launches=dv.LAUNCHES['decoder_fwd_loop_f32'] - launches0)


# --- phase 16: the decoder's reverse recurrence as one persistent kernel -----------------

BWD_LOOP_SOURCE = 'tacotron2_tpu_torch/csrc/decoder_bwd_loop/decoder_bwd_loop.cu'
BWD_LOOP_REPLACES = ('tacotron2_tpu/ops/fused_decoder.py:130-150 (lstm_cell_bwd), :257-338 '
                     '(attention_bwd), :494-571 (_bwd_rule\'s step_bwd and its reverse scan)')
# the error over the loop's first steps (the last three in time: a planted carry fault shows
# from its second step on), and over all of them
BWD_LOOP_FIRST_STEPS = 3
# the kernel against its plain version on the same CUDA tensors, {span: bound}: the
# largest error of dz1, dz2, dpq, dctx_total and df over the span and (over all steps) of
# the accumulators dkeys, dva, dba and dl, relative to the plain tensor's largest entry
# there. Read on an H100 80GB HBM3 at 700 W: the first three steps 4.6e-5 to 1.9e-3 (a
# value that the two round from f32 sums in another order lands one bf16 step apart), all
# 512 steps and the accumulators 5.5e-3 to 6.5e-3; the planted faults 2.1 to 41 times
# bounds twice these. The bounds sit 2.6x and 3.1x above the sound readings
BWD_LOOP_TOL = {'first': 5e-3, 'all': 2e-2}
BWD_LOOP_STEP_NAMES = ('dz1', 'dz2', 'dpq', 'dctx_total', 'df')
BWD_LOOP_NAMES = BWD_LOOP_STEP_NAMES + ('dkeys', 'dva', 'dba', 'dl')
# planted faults: each a build of a copy of csrc/decoder_bwd_loop/decoder_bwd_loop.cu with one
# line changed, built in phase 2, {fault: (the line, its change)}; each must miss
# BWD_LOOP_TOL in one span of one case
BWD_LOOP_MUTANTS = {
    'the cell bypass (1 - a) dc dropped': ('dc = dcn * sf + (1.0f - ac) * dc;',
                                           'dc = dcn * sf;'),
    'dpq @ q_w dropped': ('const float ds = rd(dha + DHB[crow * 8 + ci]);',
                          'const float ds = dha;'),
    'the state\'s gradient not carried': (
        'a.dstate[i] = a.cumulate ? __ldcg(a.dstate + i) + v : v;', 'a.dstate[i] = v;'),
    'the context\'s gradient not carried': (
        'if (ci < EPC) a.dctx[(size_t)crow * E + EPC * cta + ci] = column(RED, crow, 8 + ci);',
        ';'),
    'the location features\' bias dropped': ('v = rd(rd(s) + ldf(a.loc_b + c));', 'v = rd(s);'),
    'the dkeys sum skipped': ('a.dkeys[o] = sum[n][c] + g;', ';')}


def mutated_bwd_loop_source(fault):
    """The text of csrc/decoder_bwd_loop/decoder_bwd_loop.cu with BWD_LOOP_MUTANTS[fault]'s
    change."""
    from tacotron2_tpu_torch.ops import _build

    old, new = BWD_LOOP_MUTANTS[fault]
    path = os.path.join(_build.DECODER_BWD_LOOP_DIR, 'decoder_bwd_loop.cu')
    with open(path, encoding='utf-8') as f:
        text = f.read()
    if text.count(old) != 1:
        raise ValueError(f'the line that {fault!r} changes stands {text.count(old)} times in '
                         'csrc/decoder_bwd_loop/decoder_bwd_loop.cu: bring BWD_LOOP_MUTANTS up '
                         'to date')
    return text.replace(old, new)


def bwd_loop_case(model, hp, B, gates, ragged, dtype=torch.bfloat16, T_in=TIMED_CHARS):
    """The reverse loop's inputs after the forward of `loop_case(model, hp, B, gates,
    ragged, dtype, T_in)` with its residuals (through decoder_fwd_loop of the dtype, on the
    card), and seeded cotangents of the frames, stops and alignments. Returns the arguments
    of decoder_bwd_loop and of the whole backward (`_backward`)."""
    from tacotron2_tpu_torch.ops import decoder_vjp as dv

    case = loop_case(model, hp, B, gates, ragged, dtype, T_in)
    cfg, W = case['forward'][:2]
    with torch.no_grad():
        (frames, stops, aligns), R = dv._forward(*case['forward'], True)
    gen = torch.Generator('cuda').manual_seed(40 + B)
    g_frames, g_stops, g_aligns = (torch.randn(x.shape, device='cuda', generator=gen)
                                   for x in (frames, stops, aligns))
    dproj = torch.cat([g_frames, g_stops], -1).to(dtype) @ W['fs_w']
    cfg, W, keys, values, mask, _, gate_list = case['loop']
    return dict(loop=(cfg, W, keys, values, mask, R, dproj, g_aligns, gate_list),
                backward=(*case['forward'], frames, aligns, R, g_frames, g_stops, g_aligns))


def _bwd_outputs(result):
    return dict(zip(BWD_LOOP_NAMES, result, strict=True))


def _bwd_span_errs(got, want, steps):
    """{name: the largest error over the loop's first `steps` steps (the last in time) of
    each per-step output, and, over all steps, of each accumulator, relative to the plain
    tensor's largest entry there}."""
    out = {}
    for name in BWD_LOOP_STEP_NAMES:
        g, w = got[name][-steps:].double(), want[name][-steps:].double()
        out[name] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    if steps == LOOP_STEPS:
        for name in BWD_LOOP_NAMES[len(BWD_LOOP_STEP_NAMES):]:
            g, w = got[name].double(), want[name].double()
            out[name] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
    return out


def bwd_loop_bound(B, T, T_in, K, gates=True):
    """(ms, 'bytes' or 'operations') of the least time an H100 takes for the reverse loop
    of B rows over T steps at LOOP_WIDTHS and LOOP_FILTERS with a location conv of width
    K: its products' operations over the bf16 tensor cores' peak and its f32 ones (dalign,
    the location features) over the f32 peak (decoder_bwd_loop.cu's note), or its bytes
    (each input read once: keys, values, the mask, dproj, the alignments' gradient, the
    residuals it reads, the weights' columns it reads, loc_n and, with `gates`, the
    keep-gates; each output written once: dz1, dz2, dpq, dctx_total, df and the
    accumulators) over the HBM rate."""
    from tacotron2_tpu_torch import probes
    from tacotron2_tpu_torch.ops import decoder_vjp as dv

    U, n_p, E, D = dv.LOOP_WIDTHS
    n_f = dv.LOOP_FILTERS
    ops = 2 * T * B * (4 * U * 2 * U + 4 * U * (U + E) + 2 * T_in * T_in * D
                       + 2 * T_in * D * n_f + D * U)
    ops_f32 = 2 * T * B * T_in * (E + n_f * K)
    weights = 2 * (4 * U * (E + U) + 4 * U * 2 * U + D * U + T_in * T_in * D + n_f * K + n_f
                   + D * n_f) + 12 * D
    inputs = (2 * B * T_in * D + 4 * B * T_in * E + 4 * B * T_in + weights
              + T * B * (2 * (U + E) + 4 * T_in + 2 * 2 * 4 * U + 2 * 2 * U + 4 * T_in + 2 * D)
              + (4 * T * B * U if gates else 0))
    outputs = (T * B * (2 * 2 * 4 * U + 2 * D + 2 * E + 2 * T_in * n_f) + 4 * B * T_in * D
               + 8 * B * D + 4 * D * n_f)
    return probes.bound_ms(inputs + outputs, flops_bf16=ops, flops_f32=ops_f32)


def bwd_loop_kernel_checks(bwd_mutants):
    """decoder_bwd_loop against its plain version on the same CUDA tensors at the default
    width over LOOP_STEPS steps, each of LOOP_CASES (the forward loop's inputs, its
    residuals from decoder_fwd_loop, seeded cotangents): dz1, dz2, dpq, dctx_total and df
    over the loop's first BWD_LOOP_FIRST_STEPS steps and over all of them, and the
    accumulators, within BWD_LOOP_TOL; each of BWD_LOOP_MUTANTS (`bwd_mutants`: fault ->
    its library) must miss it in one span of one case. At B=32 with keep-gates a second
    launch must give the first's outputs bit for bit; that launch is timed (CUDA events,
    the median of 3) beside its plain version, the step loop's whole backward
    (`_backward` through `_step_loop_bwd`: lstm_cell_bwd, attention_bwd and the library
    products, the deferred weight gradients in) and the kernel's (`_backward`, the same)
    over the same steps, and its bound. Returns the readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.ops import decoder_vjp as dv
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    hp = default_hparams()
    hp.parse(TACO_OVERRIDES)
    model = tt.create_train_state(hp, 'cuda', seed=15).model
    bias = model.decoder.attention.location_convolution.bias  # as loop_kernel_checks
    with torch.no_grad():
        bias.copy_(torch.randn(bias.shape, device='cuda',
                               generator=torch.Generator('cuda').manual_seed(15)) * 0.5)
    K = model.decoder.attention.location_convolution.weight.shape[-1]
    t0 = time.perf_counter()
    readings, seen = {}, dict.fromkeys(BWD_LOOP_MUTANTS, 0.0)
    launches0 = dv.LAUNCHES['decoder_bwd_loop']
    for what, (B, gates, ragged) in LOOP_CASES.items():
        case = bwd_loop_case(model, hp, B, gates, ragged)
        with torch.no_grad():
            want = _bwd_outputs(dv._decoder_bwd_loop_plain(*case['loop']))
            got = _bwd_outputs(dv.decoder_bwd_loop(*case['loop']))
            torch.cuda.synchronize()
            spans = {'first': _bwd_span_errs(got, want, BWD_LOOP_FIRST_STEPS),
                     'all': _bwd_span_errs(got, want, LOOP_STEPS)}
            r = dict(first=max(spans['first'].values()), all=max(spans['all'].values()),
                     worst_first=max(spans['first'], key=spans['first'].get),
                     worst_all=max(spans['all'], key=spans['all'].get),
                     max_abs_err=max(float((got[n].double() - want[n].double()).abs().max())
                                     for n in BWD_LOOP_NAMES), by_tensor=spans['all'])
            for fault, lib in bwd_mutants.items():
                with _patched(dv, 'bwd_loop_library', lambda lib=lib: lib):
                    bad = _bwd_outputs(dv.decoder_bwd_loop(*case['loop']))
                e = max(max(_bwd_span_errs(bad, want, BWD_LOOP_FIRST_STEPS).values())
                        / BWD_LOOP_TOL['first'],
                        max(_bwd_span_errs(bad, want, LOOP_STEPS).values()) / BWD_LOOP_TOL['all'])
                seen[fault] = max(seen[fault], e)
            if B == 32 and gates:
                args = case['loop']
                again = _bwd_outputs(dv.decoder_bwd_loop(*args))
                r['bit_identical'] = all(torch.equal(again[n], got[n]) for n in BWD_LOOP_NAMES)
                if not r['bit_identical']:
                    fail('two launches of decoder_bwd_loop on the same inputs differ')
                ms = sorted(cuda_ms(lambda: dv.decoder_bwd_loop(*args))[1] for _ in range(3))[1]
                plain_ms = cuda_ms(lambda: dv._decoder_bwd_loop_plain(*args))[1]
                with _patched(dv, 'loop_applies', lambda *a: False):
                    step_loop_ms = sorted(cuda_ms(lambda: dv._backward(*case['backward']))[1]
                                          for _ in range(2))[0]
                backward_ms = sorted(cuda_ms(lambda: dv._backward(*case['backward']))[1]
                                     for _ in range(3))[1]
                bound_ms, bound_by = bwd_loop_bound(B, LOOP_STEPS, TIMED_CHARS, K)
                r.update(ms=ms, plain_ms=plain_ms, step_loop_ms=step_loop_ms,
                         backward_ms=backward_ms, bound_ms=bound_ms, bound_by=bound_by)
            if B == 1:
                args = case['loop']
                r['ms'] = sorted(cuda_ms(lambda: dv.decoder_bwd_loop(*args))[1] for _ in range(3))[1]
                r['bound_ms'], r['bound_by'] = bwd_loop_bound(B, LOOP_STEPS, TIMED_CHARS, K, gates)
        readings[what] = r
        phase(16, f'decoder_bwd_loop {what}, {LOOP_STEPS} steps, T_in={TIMED_CHARS} (bf16): '
                  f'kernel vs plain, relative to the plain tensor\'s largest entry, the loop\'s '
                  f'first {BWD_LOOP_FIRST_STEPS} steps {r["first"]:.2e} ({r["worst_first"]}; '
                  f'tol {BWD_LOOP_TOL["first"]}), all steps and the accumulators '
                  f'{r["all"]:.2e} ({r["worst_all"]}; tol {BWD_LOOP_TOL["all"]}); max abs '
                  f'{r["max_abs_err"]:.2e}; by tensor over all steps: '
                  + ', '.join(f'{n} {v:.1e}' for n, v in spans['all'].items())
                  + ('' if 'step_loop_ms' not in r else
                     f'; a second launch bit for bit the first; its plain version '
                     f'{r["plain_ms"]:.1f} ms, the step loop\'s whole backward (lstm_cell_bwd, '
                     f'attention_bwd, cuBLAS; the deferred weight gradients in) '
                     f'{r["step_loop_ms"]:.1f} ms, the kernel\'s whole backward (the same) '
                     f'{r["backward_ms"]:.2f} ms')
                  + ('' if 'ms' not in r else
                     f'; the launch {r["ms"]:.2f} ms ({1e3 * r["ms"] / LOOP_STEPS:.1f} us a '
                     f'step), bound {r["bound_ms"]:.3f} ms by {r["bound_by"]}'))
        if not (r['first'] <= BWD_LOOP_TOL['first'] and r['all'] <= BWD_LOOP_TOL['all']):
            fail(f'the decoder_bwd_loop kernel disagrees with its plain version ({what})')
    phase(16, 'decoder_bwd_loop planted faults, the largest of their errors over a bound '
              '(each must exceed 1): ' + '; '.join(f'{f} {v:.2f}' for f, v in seen.items())
              + f'; the reverse loop\'s checks took {time.perf_counter() - t0:.1f} s')
    for fault, v in seen.items():
        if not v > 1:
            fail(f'the decoder_bwd_loop check does not see its planted fault ({fault})')
    return dict(cases=readings, faults=seen,
                check_launches=dv.LAUNCHES['decoder_bwd_loop'] - launches0)


# --- phase 16: the decoder's float32 reverse recurrence as one persistent kernel ---------

F32_BWD_LOOP_SOURCE = 'tacotron2_tpu_torch/csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu'
F32_BWD_LOOP_REPLACES = ('tacotron2_tpu/ops/fused_decoder.py:130-150 (lstm_cell_bwd), :257-338 '
                         '(attention_bwd with the conv transpose), :494-571 (_bwd_rule\'s '
                         'step_bwd and its reverse scan), at float32')
# (B, keep-gates, a ragged mask, T_in) of each check: the trainer's batch with training's
# keep-gates and with zoneout's expectation, one row, and 200 characters with a ragged
# mask (past the bf16 fold's 181, which only the conv tier takes)
F32_BWD_LOOP_CASES = {'B=32, keep-gates': (32, True, False, 100),
                      'B=32, expectation': (32, False, False, 100),
                      'B=1, expectation': (1, False, False, 100),
                      'B=32, T_in=200, keep-gates, ragged mask': (32, True, True, 200)}
# the kernel against its plain version on the same CUDA tensors, {span: bound}, as
# BWD_LOOP_TOL: the largest error of dz1, dz2, dpq, dctx_total and df over the loop's first
# BWD_LOOP_FIRST_STEPS steps and over all of them and of the accumulators, relative to the
# plain tensor's largest entry there. Read on an H100 80GB HBM3 at 700 W: the first three
# steps 4.1e-7 to 1.2e-6 (dpq, df: the gate products as 3xTF32 and the attention's sums
# in another order than cuBLAS's and the plain version's), all 512 steps and the
# accumulators 2.2e-6 to 8.1e-6 (dl, summed over 512 x B x T_in terms); the planted
# faults 8.7x (a 3xTF32 term dropped) to 36,721x bounds of 2e-5 / 1e-4. The bounds sit
# 8.6x and 6.1x above the sound readings
F32_BWD_LOOP_TOL = {'first': 1e-5, 'all': 5e-5}
# a planted fault must miss F32_BWD_LOOP_TOL by this factor in one span of one case
F32_BWD_FAULT_FACTOR = 10
# planted faults: each a build of a copy of csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu
# with one line changed, built in phase 2, {fault: (the line, its change)}
F32_BWD_LOOP_MUTANTS = {
    'f32 reverse loop: the conv transpose\'s flip dropped': (
        'const float4 x = DFW[(i - k + K - 1) * (F / 4) + q];',
        'const float4 x = DFW[(i + k) * (F / 4) + q];'),
    'f32 reverse loop: the state\'s gradient not carried': (
        'a.dstate[o] = a.cumulate ? __ldcg(a.dstate + o) + acc : acc;', 'a.dstate[o] = acc;'),
    'f32 reverse loop: a 3xTF32 term dropped': ('mma(d, al[k], bh[2 * k], bh[2 * k + 1]);', ';'),
    'f32 reverse loop: the mask ignored in the energies': (
        'if (a.mask && !(a.mask[(size_t)tid * T_in + j] > 0.0f)) e = NEG_INF;', ';'),
    'f32 reverse loop: the context\'s gradient not carried': (
        'if (ci < EPC) a.dctx[(size_t)crow * E + EPC * cta + ci] = column(RED, crow, 8 + ci);',
        ';'),
    'f32 reverse loop: the cell bypass (1 - a) dc dropped': (
        'dc = dcn * sf + (1.0f - ac) * dc;', 'dc = dcn * sf;')}


def mutated_bwd_loop_f32_source(fault):
    """The text of csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu with
    F32_BWD_LOOP_MUTANTS[fault]'s change."""
    from tacotron2_tpu_torch.ops import _build

    old, new = F32_BWD_LOOP_MUTANTS[fault]
    path = os.path.join(_build.DECODER_BWD_LOOP_F32_DIR, 'decoder_bwd_loop_f32.cu')
    with open(path, encoding='utf-8') as f:
        text = f.read()
    if text.count(old) != 1:
        raise ValueError(f'the line that {fault!r} changes stands {text.count(old)} times in '
                         'csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu: bring '
                         'F32_BWD_LOOP_MUTANTS up to date')
    return text.replace(old, new)


def bwd_loop_f32_bound(B, T, T_in, K, gates=True):
    """(ms, 'bytes' or 'operations', the operations' ms on the f32 CUDA cores) of the least
    time an H100 takes for the float32 reverse loop of B rows over T steps at LOOP_WIDTHS
    and LOOP_FILTERS with a location conv of K taps, as loop_f32_bound reckons the
    forward's: its products' operations (the gate gradients' din2 and din1 and dpq @ q_w
    as 3xTF32; dalign, the location features, their projection and its gradient, dl and
    the conv's transpose on the CUDA cores; decoder_bwd_loop_f32.cu's note), or its bytes
    (each input read once: keys, values, the mask, dproj, the alignments' gradient, the
    residuals it reads, the weights' columns it reads and, with `gates`, the keep-gates;
    each output written once: dz1, dz2, dpq, dctx_total, df and the accumulators) over the
    HBM rate."""
    from tacotron2_tpu_torch.ops import decoder_vjp as dv

    U, n_p, E, D = dv.LOOP_WIDTHS
    n_f = dv.LOOP_FILTERS
    mma_ops = 2 * T * B * (4 * U * 2 * U + 4 * U * (E + U) + D * U)
    core_ops = 2 * T * B * T_in * (E + 2 * K * n_f + 3 * n_f * D)
    weights = 4 * (4 * U * (2 * U + E + U) + D * U + n_f * K + n_f + D * n_f + 2 * D)
    inputs = (4 * B * T_in * (D + E + 1) + weights
              + 4 * T * B * ((U + E) + 2 * T_in + 2 * 4 * U + 2 * U + D)
              + (4 * T * B * U if gates else 0))
    outputs = (4 * T * B * (2 * 4 * U + D + E + T_in * n_f) + 4 * B * T_in * D + 8 * B * D
               + 4 * D * n_f)
    return _f32_bound(inputs + outputs, mma_ops, core_ops)


def bwd_loop_f32_kernel_checks(f32_bwd_mutants):
    """decoder_bwd_loop in float32 (csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu)
    against its plain version on the same CUDA tensors at the default width over
    LOOP_STEPS steps, each of F32_BWD_LOOP_CASES (the float32 forward loop's inputs, its
    residuals from decoder_fwd_loop, seeded cotangents): dz1, dz2, dpq, dctx_total and df
    over the loop's first BWD_LOOP_FIRST_STEPS steps and over all of them, and the
    accumulators, within F32_BWD_LOOP_TOL; a second launch bit for bit the first; each of
    F32_BWD_LOOP_MUTANTS (`f32_bwd_mutants`: fault -> its library) must miss the bound by
    F32_BWD_FAULT_FACTOR in one span of one case. The B=32 launch with keep-gates timed
    (CUDA events, the median of 3) beside its plain version, the float32 step loop's whole
    backward (`_backward` through `_step_loop_bwd`: lstm_cell_bwd, attention_bwd, the
    library products and the conv's transpose; the deferred weight gradients in) and the
    kernel's (`_backward`, the same) over the same steps, and its bound; the B=1 launch
    timed with its bound. Returns the readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.ops import decoder_vjp as dv
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    hp = default_hparams()
    hp.parse(TACO_OVERRIDES)
    model = tt.create_train_state(hp, 'cuda', seed=15).model
    conv = model.decoder.attention.location_convolution
    with torch.no_grad():  # a trained location conv's bias is not 0 (as loop_kernel_checks)
        conv.bias.copy_(torch.randn(conv.bias.shape, device='cuda',
                                    generator=torch.Generator('cuda').manual_seed(15)) * 0.5)
    K = conv.weight.shape[-1]
    t0 = time.perf_counter()
    readings, seen = {}, dict.fromkeys(F32_BWD_LOOP_MUTANTS, 0.0)
    launches0 = dv.LAUNCHES['decoder_bwd_loop_f32']
    for what, (B, gates, ragged, T_in) in F32_BWD_LOOP_CASES.items():
        case = bwd_loop_case(model, hp, B, gates, ragged, torch.float32, T_in)
        args = case['loop']
        with torch.no_grad():
            want = _bwd_outputs(dv._decoder_bwd_loop_plain(*args))
            got = _bwd_outputs(dv.decoder_bwd_loop(*args))
            again = _bwd_outputs(dv.decoder_bwd_loop(*args))
            torch.cuda.synchronize()
            spans = {'first': _bwd_span_errs(got, want, BWD_LOOP_FIRST_STEPS),
                     'all': _bwd_span_errs(got, want, LOOP_STEPS)}
            r = dict(first=max(spans['first'].values()), all=max(spans['all'].values()),
                     worst_first=max(spans['first'], key=spans['first'].get),
                     worst_all=max(spans['all'], key=spans['all'].get),
                     max_abs_err=max(float((got[n].double() - want[n].double()).abs().max())
                                     for n in BWD_LOOP_NAMES), by_tensor=spans['all'],
                     bit_identical=all(torch.equal(again[n], got[n]) for n in BWD_LOOP_NAMES))
            if not r['bit_identical']:
                fail(f'two launches of the float32 decoder_bwd_loop differ ({what})')
            for fault, lib in f32_bwd_mutants.items():
                with _patched(dv, 'bwd_loop_f32_library', lambda lib=lib: lib):
                    bad = _bwd_outputs(dv.decoder_bwd_loop(*args))
                e = max(max(_bwd_span_errs(bad, want, BWD_LOOP_FIRST_STEPS).values())
                        / F32_BWD_LOOP_TOL['first'],
                        max(_bwd_span_errs(bad, want, LOOP_STEPS).values())
                        / F32_BWD_LOOP_TOL['all'])
                seen[fault] = max(seen[fault], e)
            if what in ('B=32, keep-gates', 'B=1, expectation'):
                r['ms'] = sorted(cuda_ms(lambda: dv.decoder_bwd_loop(*args))[1]
                                 for _ in range(3))[1]
                r['bound_ms'], r['bound_by'], r['f32_core_bound_ms'] = bwd_loop_f32_bound(
                    B, LOOP_STEPS, T_in, K, gates)
            if what == 'B=32, keep-gates':
                r['plain_ms'] = cuda_ms(lambda: dv._decoder_bwd_loop_plain(*args))[1]
                with _patched(dv, 'loop_applies', lambda *a: False):
                    r['step_loop_ms'] = sorted(cuda_ms(lambda: dv._backward(*case['backward']))[1]
                                               for _ in range(2))[0]
                r['backward_ms'] = sorted(cuda_ms(lambda: dv._backward(*case['backward']))[1]
                                          for _ in range(3))[1]
        readings[what] = r
        phase(16, f'decoder_bwd_loop_f32 {what}, {LOOP_STEPS} steps, T_in={T_in} (f32): kernel '
                  f'vs plain, relative to the plain tensor\'s largest entry, the loop\'s first '
                  f'{BWD_LOOP_FIRST_STEPS} steps {r["first"]:.2e} ({r["worst_first"]}; tol '
                  f'{F32_BWD_LOOP_TOL["first"]}), all steps and the accumulators '
                  f'{r["all"]:.2e} ({r["worst_all"]}; tol {F32_BWD_LOOP_TOL["all"]}); max abs '
                  f'{r["max_abs_err"]:.2e}; a second launch bit for bit the first; by tensor '
                  'over all steps: ' + ', '.join(f'{n} {v:.1e}' for n, v in spans['all'].items())
                  + ('' if 'ms' not in r else
                     f'; the launch {r["ms"]:.2f} ms ({1e3 * r["ms"] / LOOP_STEPS:.1f} us a '
                     f'step), bound {r["bound_ms"]:.3f} ms by {r["bound_by"]} '
                     f'({r["f32_core_bound_ms"]:.3f} ms on the f32 CUDA cores)')
                  + ('' if 'plain_ms' not in r else
                     f'; its plain version {r["plain_ms"]:.1f} ms, the f32 step loop\'s whole '
                     f'backward (lstm_cell_bwd, attention_bwd, cuBLAS, the conv\'s transpose; '
                     f'the deferred weight gradients in) {r["step_loop_ms"]:.1f} ms, the '
                     f'kernel\'s whole backward (the same) {r["backward_ms"]:.2f} ms'))
        if not (r['first'] <= F32_BWD_LOOP_TOL['first'] and r['all'] <= F32_BWD_LOOP_TOL['all']):
            fail(f'the float32 decoder_bwd_loop kernel disagrees with its plain version ({what})')
    seconds = time.perf_counter() - t0
    phase(16, 'decoder_bwd_loop_f32 planted faults, the largest of their errors over a bound '
              f'(each must exceed {F32_BWD_FAULT_FACTOR}): '
              + '; '.join(f'{f} {v:.2f}' for f, v in seen.items())
              + f'; the float32 reverse loop\'s checks took {seconds:.1f} s')
    for fault, v in seen.items():
        if not v > F32_BWD_FAULT_FACTOR:
            fail(f'the float32 decoder_bwd_loop check does not see its planted fault ({fault}) '
                 f'{F32_BWD_FAULT_FACTOR} times over its bound')
    return dict(cases=readings, faults=seen, seconds=seconds,
                check_launches=dv.LAUNCHES['decoder_bwd_loop_f32'] - launches0)


def timed_beside_autograd(timed, gta_s):
    """Phase 12's (f32) and phase 14's (bf16) timed steps at B=32 x TIMED_FRAMES beside
    the autograd decoder loop's and the step loop's, and phase 13's GTA seconds an
    utterance beside the step loop's; the step's parts must still tile it (step_segments
    raised otherwise)."""
    for key, t in timed.items():
        was, loop = AUTOGRAD_TIMED[key], STEP_LOOP_TIMED[key]
        if key == 'float32':
            last = F32_STEP_LOOPS_TIMED
            phase(16, f'timed step float32 with both float32 loops: {t["sec_step"]:.3f} '
                      f'sec/step, the decoder forward {t["parts"]["fwd: decoder"]:.1f} ms, '
                      f'backward {t["parts"]["bwd: decoder"]:.1f} ms (with the float32 forward '
                      f'loop and the step loop\'s backward: '
                      f'{"-".join(map(str, F32_FWD_LOOP_TIMED["sec_step"]))} s, the backward '
                      f'{"-".join(map(str, F32_FWD_LOOP_TIMED["bwd"]))} ms; with the step '
                      f'loops in both directions: '
                      f'{last["sec_step"]} s, {last["fwd"]} and {last["bwd"]} ms)')
        phase(16, f'timed step {key}, B=32 x {TIMED_FRAMES} frames: {t["sec_step"]:.3f} '
                  f'sec/step ({t["sec_step_range"][0]:.3f}-{t["sec_step_range"][1]:.3f}; autograd '
                  f'{was["sec_step"]}, step loop {loop["sec_step"]}), peak {t["peak_gib"]:.2f} '
                  f'GiB (autograd {was["peak_gib"]}, step loop {loop["peak_gib"]}); the decoder '
                  f'forward {t["parts"]["fwd: decoder"]:.1f} ms (autograd {was["fwd"]}, step '
                  f'loop {loop["fwd"]}), backward {t["parts"]["bwd: decoder"]:.1f} ms (autograd '
                  f'{was["bwd"]}, step loop {loop["bwd"]}), {t["decoder_bwd_share"]:.0%} of the '
                  f'backward; the step {t["step_ms"]:.1f} ms by its parts, which tile it')
    phase(16, f'GTA (phase 13, f32, B=1): {gta_s:.3f} s an utterance (the step loop '
              f'{STEP_LOOP_GTA_S}-{F32_STEP_LOOPS_TIMED["gta_s"]})')


def decoder_slice(mutants, timed, gta_s):
    """Phase 16 (see the module docstring). Returns the readings."""
    from tacotron2_tpu_torch.ops import decoder_vjp as dv

    t0 = time.perf_counter()
    kernels = decoder_kernel_checks({f: mutants[f] for f in DECODER_MUTANTS})
    loop = loop_kernel_checks({f: mutants[f] for f in LOOP_MUTANTS})
    loop_f32 = loop_f32_kernel_checks({f: mutants[f] for f in F32_LOOP_MUTANTS})
    bwd_loop = bwd_loop_kernel_checks({f: mutants[f] for f in BWD_LOOP_MUTANTS})
    bwd_loop_f32 = bwd_loop_f32_kernel_checks({f: mutants[f] for f in F32_BWD_LOOP_MUTANTS})
    fused = {}
    for ratio, dtype, loops in ((1.0, torch.float32, ('decoder_fwd_loop_f32',
                                                      'decoder_bwd_loop_f32')),
                                (0.5, torch.float32, ()),
                                (1.0, torch.bfloat16, ('decoder_fwd_loop', 'decoder_bwd_loop')),
                                (0.5, torch.bfloat16, ())):
        before = collections.Counter(dv.LAUNCHES)
        fused[f'{str(dtype).split(".")[-1]} {ratio}'] = fused_vs_autograd(ratio, dtype)
        ran = collections.Counter(dv.LAUNCHES) - before
        if not all(ran[name] for name in loops):
            fail(f'the fused decoder in {dtype} at teacher forcing 1 did not run {loops}')
        if ratio == 1.0 and dtype == torch.float32 and (ran['lstm_cell_bwd']
                                                        or ran['attention_bwd']):
            fail('the fused decoder in float32 at teacher forcing 1 ran the step loop\'s backward')
    timed_beside_autograd(timed, gta_s)
    launches = {p: dict(DECODER_LAUNCHES_BY_PATH[p]) for p in ALL_DECODER_PATHS}
    phase(16, f'decoder kernel launches on the main paths: {launches}; phase 16 took '
              f'{time.perf_counter() - t0:.1f} s')
    for name in dv.KERNELS:
        if not sum(DECODER_LAUNCHES_BY_PATH[p][name] for p in ALL_DECODER_PATHS):
            fail(f'no main path launched the {name} kernel')
    for p in BF16_DECODER_PATHS:
        by = DECODER_LAUNCHES_BY_PATH[p]
        if not by['decoder_fwd_loop'] or by['lstm_cell_fwd'] or by['attention_fwd']:
            fail(f'{p} (bf16) did not run its forward through decoder_fwd_loop alone')
        if not by['decoder_bwd_loop'] or by['lstm_cell_bwd'] or by['attention_bwd']:
            fail(f'{p} (bf16) did not run its backward through decoder_bwd_loop alone')
    for p in F32_DECODER_PATHS:
        by = DECODER_LAUNCHES_BY_PATH[p]
        if (not by['decoder_fwd_loop_f32'] or by['lstm_cell_fwd'] or by['attention_fwd']
                or by['decoder_fwd_loop']):
            fail(f'{p} (f32) did not run its forward through decoder_fwd_loop_f32 alone')
        if by['decoder_bwd_loop'] or by['lstm_cell_bwd'] or by['attention_bwd']:
            fail(f'{p} (f32) ran a backward kernel other than decoder_bwd_loop_f32')
    by = DECODER_LAUNCHES_BY_PATH[TACO_F32_TIMED_PATH]  # the f32 path that trains (GTA does not)
    if not by['decoder_bwd_loop_f32']:
        fail(f'{TACO_F32_TIMED_PATH} did not run its backward through decoder_bwd_loop_f32')
    by = DECODER_LAUNCHES_BY_PATH[TACO_F32_SCHEDULED_PATH]
    if not all(by[k] for k in ('lstm_cell_fwd', 'attention_fwd', 'lstm_cell_bwd', 'attention_bwd')):
        fail(f'{TACO_F32_SCHEDULED_PATH} did not run the step loop\'s four kernels')
    return dict(kernels=kernels, loop=loop, loop_f32=loop_f32, bwd_loop=bwd_loop,
                bwd_loop_f32=bwd_loop_f32, fused=fused, launches=launches)


def decoder_entries(decoder):
    """The kernels line's entries of the four decoder kernels: launches from the main
    paths' runs (phases 12 and 13), the rest from phase 16 in bf16 (the trainers' compute
    dtype on the card), the f32 readings beside them."""
    out = []
    by = decoder['launches']
    for name in ('lstm_cell_fwd', 'lstm_cell_bwd', 'attention_fwd', 'attention_bwd'):
        k = decoder['kernels'][name]
        bf, f = k['bfloat16'], k['float32']
        out.append(dict(
            name=name, route='cuda', source=DECODER_SOURCE, replaces=DECODER_REPLACES[name],
            launches=sum(by[p].get(name, 0) for p in ALL_DECODER_PATHS),
            launches_by_path={p: by[p].get(name, 0) for p in ALL_DECODER_PATHS},
            max_abs_err=max(bf['max_abs_err'], f['max_abs_err']), ms=bf['ms'],
            plain_ms=bf['plain_ms'], bound_ms=bf['bound_ms'], bound_by=bf['bound_by'],
            library_ms=None, dtype='bfloat16', widths=dict(zip(('B', 'U', 'D', 'T_in'),
                                                               DECODER_WIDTHS)),
            rel_err=bf['rel_err'], tol=bf['tol'], fault_rel_err=bf['faults'],
            f32_ms=f['ms'], f32_plain_ms=f['plain_ms'], f32_bound_ms=f['bound_ms'],
            f32_rel_err=f['rel_err'], f32_tol=f['tol'], f32_fault_rel_err=f['faults']))
    # the forward loop: ms the B=32 x LOOP_STEPS launch with residuals (the train step's),
    # plain_ms its plain version, step_loop_ms the step loop over the same steps
    loop = decoder['loop']['cases']
    b32, b1 = loop['B=32, keep-gates'], loop['B=1, expectation']
    out.append(dict(
        name='decoder_fwd_loop', route='cuda', source=LOOP_SOURCE, replaces=LOOP_REPLACES,
        launches=sum(by[p].get('decoder_fwd_loop', 0) for p in ALL_DECODER_PATHS),
        launches_by_path={p: by[p].get('decoder_fwd_loop', 0) for p in ALL_DECODER_PATHS},
        check_launches=decoder['loop']['check_launches'],
        max_abs_err=max(r['max_abs_err'] for r in loop.values()), ms=b32['ms'],
        plain_ms=b32['plain_ms'], step_loop_ms=b32['step_loop_ms'],
        forward_ms=b32['forward_ms'], bound_ms=b32['bound_ms'], bound_by=b32['bound_by'],
        library_ms=None, dtype='bfloat16', steps=LOOP_STEPS,
        widths=dict(zip(('B', 'U', 'D', 'T_in'), DECODER_WIDTHS)),
        rel_err={k: dict(first=r['first'], all=r['all']) for k, r in loop.items()},
        tol=LOOP_TOL, fault_err_over_tol=decoder['loop']['faults'],
        b1_ms_without_residuals=b1['ms_without_residuals'], b1_bound_ms=b1['bound_ms'],
        b1_bound_by=b1['bound_by']))
    # the float32 forward loop: ms the B=32 x LOOP_STEPS launch with residuals (the f32
    # train step's), plain_ms its plain version, step_loop_ms the f32 step loop over the
    # same steps; b1_ms GTA's launch (one row, no residuals)
    f32 = decoder['loop_f32']['cases']
    b32, b1 = f32['B=32, keep-gates'], f32['B=1, expectation']
    out.append(dict(
        name='decoder_fwd_loop_f32', route='cuda', source=F32_LOOP_SOURCE,
        replaces=F32_LOOP_REPLACES,
        launches=sum(by[p].get('decoder_fwd_loop_f32', 0) for p in ALL_DECODER_PATHS),
        launches_by_path={p: by[p].get('decoder_fwd_loop_f32', 0) for p in ALL_DECODER_PATHS},
        check_launches=decoder['loop_f32']['check_launches'],
        max_abs_err=max(r['max_abs_err'] for r in f32.values()), ms=b32['ms'],
        plain_ms=b32['plain_ms'], step_loop_ms=b32['step_loop_ms'],
        forward_ms=b32['forward_ms'], bound_ms=b32['bound_ms'], bound_by=b32['bound_by'],
        f32_core_bound_ms=b32['f32_core_bound_ms'], library_ms=None, dtype='float32',
        steps=LOOP_STEPS, widths=dict(zip(('B', 'U', 'D', 'T_in'), DECODER_WIDTHS)),
        rel_err={k: dict(first=r['first'], all=r['all']) for k, r in f32.items()},
        tol=F32_LOOP_TOL, fault_err_over_tol=decoder['loop_f32']['faults'],
        bit_identical=all(r['bit_identical'] for r in f32.values()),
        b1_ms_without_residuals=b1['ms'], b1_bound_ms=b1['bound_ms'],
        b1_bound_by=b1['bound_by'], b1_f32_core_bound_ms=b1['f32_core_bound_ms']))
    # the reverse loop: ms the B=32 x LOOP_STEPS launch, plain_ms its plain version,
    # step_loop_ms the step loop's whole backward over the same steps
    bwd = decoder['bwd_loop']['cases']
    b32, b1 = bwd['B=32, keep-gates'], bwd['B=1, expectation']
    out.append(dict(
        name='decoder_bwd_loop', route='cuda', source=BWD_LOOP_SOURCE,
        replaces=BWD_LOOP_REPLACES,
        launches=sum(by[p].get('decoder_bwd_loop', 0) for p in ALL_DECODER_PATHS),
        launches_by_path={p: by[p].get('decoder_bwd_loop', 0) for p in ALL_DECODER_PATHS},
        check_launches=decoder['bwd_loop']['check_launches'],
        max_abs_err=max(r['max_abs_err'] for r in bwd.values()), ms=b32['ms'],
        plain_ms=b32['plain_ms'], step_loop_ms=b32['step_loop_ms'],
        backward_ms=b32['backward_ms'], bound_ms=b32['bound_ms'], bound_by=b32['bound_by'],
        library_ms=None, dtype='bfloat16', steps=LOOP_STEPS,
        widths=dict(zip(('B', 'U', 'D', 'T_in'), DECODER_WIDTHS)),
        rel_err={k: dict(first=r['first'], all=r['all']) for k, r in bwd.items()},
        tol=BWD_LOOP_TOL, fault_err_over_tol=decoder['bwd_loop']['faults'],
        bit_identical=b32['bit_identical'], b1_ms=b1['ms'], b1_bound_ms=b1['bound_ms'],
        b1_bound_by=b1['bound_by']))
    # the float32 reverse loop: ms the B=32 x LOOP_STEPS launch (the f32 train step's),
    # plain_ms its plain version, step_loop_ms the f32 step loop's whole backward over the
    # same steps
    f32b = decoder['bwd_loop_f32']['cases']
    b32, b1 = f32b['B=32, keep-gates'], f32b['B=1, expectation']
    out.append(dict(
        name='decoder_bwd_loop_f32', route='cuda', source=F32_BWD_LOOP_SOURCE,
        replaces=F32_BWD_LOOP_REPLACES,
        launches=sum(by[p].get('decoder_bwd_loop_f32', 0) for p in ALL_DECODER_PATHS),
        launches_by_path={p: by[p].get('decoder_bwd_loop_f32', 0) for p in ALL_DECODER_PATHS},
        check_launches=decoder['bwd_loop_f32']['check_launches'],
        max_abs_err=max(r['max_abs_err'] for r in f32b.values()), ms=b32['ms'],
        plain_ms=b32['plain_ms'], step_loop_ms=b32['step_loop_ms'],
        backward_ms=b32['backward_ms'], bound_ms=b32['bound_ms'], bound_by=b32['bound_by'],
        f32_core_bound_ms=b32['f32_core_bound_ms'], library_ms=None, dtype='float32',
        steps=LOOP_STEPS, widths=dict(zip(('B', 'U', 'D', 'T_in'), DECODER_WIDTHS)),
        rel_err={k: dict(first=r['first'], all=r['all']) for k, r in f32b.items()},
        tol=F32_BWD_LOOP_TOL, fault_err_over_tol=decoder['bwd_loop_f32']['faults'],
        bit_identical=all(r['bit_identical'] for r in f32b.values()), b1_ms=b1['ms'],
        b1_bound_ms=b1['bound_ms'], b1_bound_by=b1['bound_by'],
        b1_f32_core_bound_ms=b1['f32_core_bound_ms']))
    return out



# --- phase 17: the CBHG's bidirectional GRU recurrence as persistent kernels -------------

GRU_SOURCE = 'tacotron2_tpu_torch/csrc/gru_loop/gru_loop.cu'
GRU_REPLACES = {
    'gru_fwd_loop': 'tacotron2_tpu/models/tacotron/modules.py:278-317 (the CBHG\'s '
                    'jax.lax.scan over flax\'s GRUCell, `run`: an XLA loop, no Pallas kernel)',
    'gru_bwd_loop': 'tacotron2_tpu/models/tacotron/modules.py:278-317 (XLA\'s reverse scan '
                    'of that scan\'s autodiff, no Pallas kernel)'}
GRU_STEPS = TIMED_FRAMES   # the timed batch's 512 mel frames: the CBHG's steps
GRU_FIRST_STEPS = 3
# (B, a ragged mask, W_hh = 0) of each check: the trainer's batch at lengths None (as the
# model calls the CBHG), one row, a ragged mask (the mask and the in-kernel reversal), and
# the trainer's batch with W_hh = 0: the step's elementwise math alone, where no product's
# sum order parts the two and each op rounds at the same place on both, so that its bound
# catches one bf16 op rounded where the plain version does not round it
GRU_CASES = {'B=32': (32, False, False), 'B=1': (1, False, False),
             'B=32, ragged mask': (32, True, False), 'B=32, W_hh = 0': (32, False, True)}
# each kernel against its plain version on the same CUDA tensors, {kernel: {dtype: {span:
# bound}}}: the largest error of its outputs (gru_fwd_loop: the output and the residuals;
# gru_bwd_loop: dip and dg, and dW_hh and db_hn formed from them) over each direction's first
# GRU_FIRST_STEPS steps (the reverse kernel's first, the last in step order) and over all of
# them, relative to the plain tensor's largest entry there; the W_hh = 0 case's bound is
# GRU_ZERO_TOL. Read on an H100 80GB HBM3 at 700 W: f32 0 at B=32 (cuBLAS sums h W_hh^T in
# the kernel's order there) and at most 2.2e-7 / 5.7e-7 (the forward at B=1), 1.8e-7 /
# 4.2e-7 (the reverse, dW_hh); bf16 forward 3.9e-4 over the first steps, 2.2e-2 over all
# (a gate that the two round from f32 sums in another order lands one bf16 step apart, and
# two bf16 recurrences drift apart over 512 steps), reverse 1.1e-6 and 1.6e-3 (dip rounded
# once from float32 sums in another order); W_hh = 0 reads 0 in both dtypes; the planted
# faults 1.8e4 to 1.8e6 times a bound. The f32 bounds sit about 9x above the readings, bf16's
# first steps at one bf16 step of the largest value (2**-8 = 3.9e-3), its forward over all
# steps at the ceiling, 2.2x, its reverse 6x
GRU_TOL = {'gru_fwd_loop': {torch.float32: {'first': 2e-6, 'all': 5e-6},
                            torch.bfloat16: {'first': 4e-3, 'all': 5e-2}},
           'gru_bwd_loop': {torch.float32: {'first': 2e-6, 'all': 5e-6},
                            torch.bfloat16: {'first': 4e-3, 'all': 1e-2}}}
GRU_ZERO_TOL = 1e-6
# a planted fault must miss its case's bound by this factor in one span of one case
GRU_FAULT_FACTOR = 10
# planted faults: a build of csrc/gru_loop/gru_loop.cu with one macro set, built in phase 2,
# {fault: the macro}
GRU_MUTANTS = {
    'gru_fwd_loop: b_hn added outside r (the reset before the product)': 'GRU_FAULT_RESET_BEFORE',
    'gru_fwd_loop: z and 1 - z swapped': 'GRU_FAULT_Z_SWAPPED',
    'gru_fwd_loop: the padding mask ignored': 'GRU_FAULT_MASK_IGNORED',
    'gru_fwd_loop: the reversed direction read over the whole row': 'GRU_FAULT_WHOLE_ROW_REVERSED',
    'gru_fwd_loop: the bf16 sigmoid rounded once': 'GRU_FAULT_SIGMOID_ROUNDED_ONCE',
    'gru_bwd_loop: the dh z carry dropped': 'GRU_FAULT_CARRY_DROPPED',
    'gru_bwd_loop: the padding mask ignored': 'GRU_FAULT_BWD_MASK_IGNORED'}
# the CBHG's GRUs in the timed B=32 x 512 steps while they ran as a step loop (StepMarks,
# H100 80GB HBM3, 700 W; PERF.md): f32 forward and backward ms, bf16 both together
GRU_STEP_LOOP_TIMED = {'float32': dict(fwd=219.0, bwd=523.0),
                       'bfloat16': dict(fwd=None, bwd=None, both=1480.0)}
TACO_BF16_TIMED_PATH = 'timed Tacotron train steps, bf16 (phase 14)'
TACO_EVAL_CLI_PATH = 'synthesize --model Tacotron --mode eval --name'
TACO_LIVE_CLI_PATH = 'synthesize --model Tacotron --mode live --name'
# the main paths that run the CBHG and so its GRUs: those that train launch both kernels,
# the synthesizer's the forward alone
GRU_TRAIN_PATHS = (TACO_PATH, TACO_F32_SCHEDULED_PATH, TACO_F32_TIMED_PATH,
                   TACO_BF16_TIMED_PATH, PIPE_TACO_PATH)
GRU_SYNTH_PATHS = (TACO_EVAL_CLI_PATH, TACO_LIVE_CLI_PATH)
GRU_PATHS = GRU_TRAIN_PATHS + GRU_SYNTH_PATHS


def gru_case(cbhg, B, ragged, zero_w, dtype, seed=23):
    """The operands of a GRU check on the card: the seeded CBHG's two GRUs (a b_hn of order
    0.5: a trained one is not 0) on a seeded (B, GRU_STEPS, C) input in `dtype`, through
    their own casts (`GRU.operands`), W_hh zeroed with `zero_w`, the lengths (each row's
    own from GRU_STEPS / 4 up where `ragged`, row 0 whole), the mask, and a seeded
    cotangent of the output."""
    from tacotron2_tpu_torch.models.tacotron.modules import length_mask

    g = torch.Generator('cuda').manual_seed(seed)
    T, H = GRU_STEPS, cbhg.gru_fw.units
    y = torch.randn(B, T, cbhg.gru_fw.input.in_features, device='cuda', generator=g).to(dtype)
    lengths = torch.full((B,), T, device='cuda')
    if ragged:
        lengths = torch.randint(T // 4, T + 1, (B,), device='cuda', generator=g)
        lengths[0] = T
    with torch.no_grad():
        ips, ws, bs = (list(x) for x in zip(*(gru.operands(y, dtype)
                                              for gru in (cbhg.gru_fw, cbhg.gru_bw))))
    if zero_w:
        ws = [torch.zeros_like(w) for w in ws]
    return dict(y=y, ips=ips, ws=ws, bs=bs, lengths=lengths,
                mask=length_mask(lengths, T, 'cuda'), reverse=(False, True),
                dout=torch.randn(B, T, 2 * H, device='cuda', generator=g).to(dtype))


def _gru_span_err(got, want, first, from_end=False):
    """The largest error of `got` against `want` (B, T, ...) in step order over the first
    (or with `from_end` the last) GRU_FIRST_STEPS steps, or all steps, relative to want's
    largest entry there (absolute where that is 0)."""
    if first:
        sl = slice(-GRU_FIRST_STEPS, None) if from_end else slice(0, GRU_FIRST_STEPS)
        got, want = got[:, sl], want[:, sl]
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    return err / scale if scale > 0 else err


def _gru_fwd_errs(case, got, want):
    """{span: {tensor: error}} of gru_fwd_loop's output and residuals against the plain
    version's, each direction in its own step order."""
    from tacotron2_tpu_torch.ops import gru_scan as gs

    H, out = case['ws'][0].shape[1], {'first': {}, 'all': {}}
    for d, rev in enumerate(case['reverse']):
        pairs = {f'out{d}': (got[0][..., d * H:(d + 1) * H], want[0][..., d * H:(d + 1) * H])}
        for i, name in enumerate(gs.RESIDUALS):
            pairs[f'{name}{d}'] = (got[1][d][i], want[1][d][i])
        for name, (g, w) in pairs.items():
            g, w = (gs._order(x, case['lengths'], rev) for x in (g, w))
            for span in out:
                out[span][name] = _gru_span_err(g, w, span == 'first')
    return out


def _gru_bwd_errs(case, got, want, res):
    """{span: {tensor: error}} of gru_bwd_loop's dip and dg against the plain version's,
    each direction in its own step order (the reverse kernel's first steps the last ones),
    and of dW_hh and db_hn formed from them as GRUScan forms them (over all)."""
    from tacotron2_tpu_torch.ops import gru_scan as gs

    H, out = case['ws'][0].shape[1], {'first': {}, 'all': {}}
    for d, rev in enumerate(case['reverse']):
        for name, g, w in ((f'dip{d}', got[0][d], want[0][d]), (f'dg{d}', got[1][d], want[1][d])):
            g, w = (gs._order(x, case['lengths'], rev) for x in (g, w))
            for span in out:
                out[span][name] = _gru_span_err(g, w, span == 'first', from_end=True)
    for d, R in enumerate(res):
        g, w = gs.weight_grads(got[1][d], R), gs.weight_grads(want[1][d], R)
        out['all'][f'dW_hh{d}'] = _gru_span_err(g[0][None], w[0][None], False)
        out['all'][f'db_hn{d}'] = _gru_span_err(g[1][None, None], w[1][None, None], False)
    return out


def gru_bound(B, T, dtype, forward, save=True):
    """(ms, 'bytes' or 'operations') of the least time an H100 takes for a launch of both
    directions over B rows and T steps: its products, 2 B T 3H H operations a direction
    (forward h W_hh^T, reverse dg W_hh) at the peak rate of the inputs' type (f32 on the
    CUDA cores, bf16 on the tensor cores), or its bytes over the HBM rate: forward ip, W_hh,
    b_hn and the mask read, the output and (with `save`) the residuals written; reverse the
    output's gradient, the residuals, W_hh and the mask read, dip and dg written."""
    from tacotron2_tpu_torch.ops import gru_scan as gs

    H, s, n_res = gs.GRU_LOOP_UNITS, (4 if dtype == torch.float32 else 2), len(gs.RESIDUALS)
    ops = 2 * 2 * B * T * 3 * H * H
    if forward:
        nbytes = (2 * (B * T * 3 * H + 3 * H * H + H) * s + 4 * B * T + B * T * 2 * H * s
                  + (2 * n_res * B * T * H * s if save else 0))
    else:
        nbytes = (B * T * 2 * H * s + 2 * n_res * B * T * H * s + 2 * 3 * H * H * s + 4 * B * T
                  + 2 * B * T * 3 * H * (s + 4))
    ops_ms = 1e3 * ops / (PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return max(ops_ms, bytes_ms), 'operations' if ops_ms >= bytes_ms else 'bytes'


def _median_ms(fn, reps=3):
    return sorted(cuda_ms(fn)[1] for _ in range(reps))[reps // 2]


def cudnn_gru(cbhg, case, want):
    """The library's yardstick: cuDNN's bidirectional GRU (nn.GRU) on the case's input y
    with the CBHG's GRUs' weights (b_ih the input bias, b_hh = (0, 0, b_hn): PyTorch's GRU
    is then flax's GRUCell), held to the plain output `want` of the same input, then timed
    (the median of 3): its forward with a gradient to take, and its backward to the input
    and the weights from the case's cotangent. Returns the readings."""
    dt, y = case['y'].dtype, case['y']
    H = cbhg.gru_fw.units
    gru = torch.nn.GRU(y.shape[-1], H, batch_first=True, bidirectional=True).to('cuda', dt)
    with torch.no_grad():
        for sfx, g in (('', cbhg.gru_fw), ('_reverse', cbhg.gru_bw)):
            getattr(gru, f'weight_ih_l0{sfx}').copy_(g.input.weight)
            getattr(gru, f'bias_ih_l0{sfx}').copy_(g.input.bias)
            getattr(gru, f'weight_hh_l0{sfx}').copy_(g.hidden.weight)
            getattr(gru, f'bias_hh_l0{sfx}').copy_(torch.cat([torch.zeros(2 * H, device='cuda'),
                                                              g.bias_hn.detach()]))
    gru.flatten_parameters()
    x = y.detach().requires_grad_()
    out = gru(x)[0]
    err = float((out.detach().double() - want.double()).abs().max())
    leaves = [x] + list(gru.parameters())
    fwd_ms = _median_ms(lambda: gru(x)[0])
    bwd_ms = _median_ms(lambda: torch.autograd.grad(out, leaves, case['dout'],
                                                    retain_graph=True))
    return dict(max_abs_err=err, fwd_ms=fwd_ms, bwd_ms=bwd_ms)


def gru_kernel_checks(mutants):
    """gru_fwd_loop and gru_bwd_loop (csrc/gru_loop/gru_loop.cu) against their plain versions
    on the same CUDA tensors at the default width (H = 128, input 128) over GRU_STEPS steps,
    each of GRU_CASES in f32 (TF32 off) and bf16 (the forward on the case's operands, the
    reverse on the plain forward's residuals and the case's cotangent): the spans of
    _gru_fwd_errs and _gru_bwd_errs within GRU_TOL (GRU_ZERO_TOL with W_hh = 0); a second
    launch of each bit for bit the first; each of GRU_MUTANTS (`mutants`: fault -> its
    library) must miss its case's bound by GRU_FAULT_FACTOR in one span of one case. At B=32
    and B=1 each kernel timed (CUDA events, the median of 3: the forward with the residuals,
    as training launches it, and without, as inference does) with its bound and its plain
    version's time; at B=32 the CBHG's whole GRU module (BiGRU: the input projections and
    the Function) forward and backward, and cuDNN's bidirectional GRU on the same input
    (cudnn_gru), first held to the plain output in f32. Returns the readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.ops import gru_scan as gs
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    hp = default_hparams()
    hp.parse(TACO_OVERRIDES)
    cbhg = tt.create_train_state(hp, 'cuda', seed=19).model.cbhg_postnet
    with torch.no_grad():
        g = torch.Generator('cuda').manual_seed(19)
        for gru in (cbhg.gru_fw, cbhg.gru_bw):
            gru.bias_hn.copy_(torch.randn(gru.units, device='cuda', generator=g) * 0.5)
    t0 = time.perf_counter()
    launches0 = collections.Counter(gs.LAUNCHES)
    readings, seen = {}, dict.fromkeys(GRU_MUTANTS, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        for what, (B, ragged, zero_w) in GRU_CASES.items():
            case = gru_case(cbhg, B, ragged, zero_w, dtype)
            tols = {k: {'first': GRU_ZERO_TOL, 'all': GRU_ZERO_TOL} if zero_w else t[dtype]
                    for k, t in GRU_TOL.items()}
            args = (case['ips'], case['ws'], case['bs'], case['mask'], case['lengths'],
                    case['reverse'])
            bargs = (case['ws'], case['mask'], case['lengths'], case['reverse'])
            with torch.no_grad():
                want = gs._gru_fwd_loop_plain(*args, True)
                got = gs.gru_fwd_loop(*args, True)
                again = gs.gru_fwd_loop(*args, True)
                bwant = gs._gru_bwd_loop_plain(case['dout'], want[1], *bargs)
                bgot = gs.gru_bwd_loop(case['dout'], want[1], *bargs)
                bagain = gs.gru_bwd_loop(case['dout'], want[1], *bargs)
                torch.cuda.synchronize()
                errs = {'gru_fwd_loop': _gru_fwd_errs(case, got, want),
                        'gru_bwd_loop': _gru_bwd_errs(case, bgot, bwant, want[1])}
                abs_errs = {'gru_fwd_loop': float((got[0].float() - want[0].float()).abs().max()),
                            'gru_bwd_loop': max(float((a.float() - b.float()).abs().max())
                                                for a, b in zip(bgot[0], bwant[0]))}
                same = (torch.equal(got[0], again[0])
                        and all(torch.equal(a, b) for a, b in zip(got[1], again[1]))
                        and all(torch.equal(a, b) for x, y in zip(bgot, bagain)
                                for a, b in zip(x, y)))
                if not same:
                    fail(f'two launches of a GRU loop kernel differ ({dname}, {what})')
                for fault, lib in mutants.items():
                    with _patched(gs, 'library', lambda lib=lib: lib):
                        bad = {'gru_fwd_loop': _gru_fwd_errs(case, gs.gru_fwd_loop(*args, True),
                                                             want),
                               'gru_bwd_loop': _gru_bwd_errs(
                                   case, gs.gru_bwd_loop(case['dout'], want[1], *bargs),
                                   bwant, want[1])}
                    seen[fault] = max(seen[fault], *(max(e[span].values()) / tols[k][span]
                                                     for k, e in bad.items() for span in e))
            for kernel, e in errs.items():
                tol = tols[kernel]
                r = dict(first=max(e['first'].values()), all=max(e['all'].values()),
                         worst_first=max(e['first'], key=e['first'].get),
                         worst_all=max(e['all'], key=e['all'].get), tol=tol, by_tensor=e['all'],
                         max_abs_err=abs_errs[kernel])
                readings[(kernel, dname, what)] = r
                phase(17, f'{kernel} {dname} {what}, {GRU_STEPS} steps: kernel vs plain, '
                          f'relative to the plain tensor\'s largest entry, the first '
                          f'{GRU_FIRST_STEPS} steps {r["first"]:.2e} ({r["worst_first"]}; tol '
                          f'{tol["first"]}), all {r["all"]:.2e} ({r["worst_all"]}; tol '
                          f'{tol["all"]}); a second launch bit for bit the first; by tensor '
                          'over all steps: '
                          + ', '.join(f'{n} {v:.1e}' for n, v in e['all'].items()))
                if not (r['first'] <= tol['first'] and r['all'] <= tol['all']):
                    fail(f'the {kernel} kernel disagrees with its plain version ({dname}, {what})')
            if what not in ('B=32', 'B=1'):
                continue
            t = readings[('timing', dname, what)] = {}
            with torch.no_grad():
                t['fwd_ms'] = _median_ms(lambda: gs.gru_fwd_loop(*args, True))
                t['fwd_ms_without_residuals'] = _median_ms(lambda: gs.gru_fwd_loop(*args, False))
                t['bwd_ms'] = _median_ms(lambda: gs.gru_bwd_loop(case['dout'], want[1], *bargs))
                t['fwd_plain_ms'] = cuda_ms(lambda: gs._gru_fwd_loop_plain(*args, True))[1]
                t['bwd_plain_ms'] = cuda_ms(
                    lambda: gs._gru_bwd_loop_plain(case['dout'], want[1], *bargs))[1]
            t['fwd_bound_ms'], t['fwd_bound_by'] = gru_bound(B, GRU_STEPS, dtype, True)
            t['fwd_bound_ms_without_residuals'], _ = gru_bound(B, GRU_STEPS, dtype, True, False)
            t['bwd_bound_ms'], t['bwd_bound_by'] = gru_bound(B, GRU_STEPS, dtype, False)
            if what == 'B=32':
                y = case['y'].detach().requires_grad_()
                out = cbhg.bigru(y, case['mask'], case['lengths'], dtype)
                leaves = [y] + [p for g in (cbhg.gru_fw, cbhg.gru_bw) for p in g.parameters()]
                t['module_fwd_ms'] = _median_ms(
                    lambda: cbhg.bigru(y, case['mask'], case['lengths'], dtype))
                t['module_bwd_ms'] = _median_ms(lambda: torch.autograd.grad(
                    out, leaves, case['dout'], retain_graph=True))
                t['cudnn'] = cudnn_gru(cbhg, case, want[0])
                if dtype == torch.float32 and not t['cudnn']['max_abs_err'] <= TACOTRON_TOL:
                    fail(f'cuDNN\'s GRU does not compute the CBHG\'s GRU: max abs err '
                         f'{t["cudnn"]["max_abs_err"]:.2e} from the plain version')
            phase(17, f'{dname} {what} x {GRU_STEPS} steps, both directions: gru_fwd_loop '
                      f'{t["fwd_ms"]:.3f} ms ({1e3 * t["fwd_ms"] / GRU_STEPS:.2f} us a step; '
                      f'without residuals {t["fwd_ms_without_residuals"]:.3f} ms), bound '
                      f'{t["fwd_bound_ms"]:.4f} ms by {t["fwd_bound_by"]}, its plain version '
                      f'{t["fwd_plain_ms"]:.1f} ms; gru_bwd_loop {t["bwd_ms"]:.3f} ms '
                      f'({1e3 * t["bwd_ms"] / GRU_STEPS:.2f} us a step), bound '
                      f'{t["bwd_bound_ms"]:.4f} ms by {t["bwd_bound_by"]}, its plain version '
                      f'{t["bwd_plain_ms"]:.1f} ms'
                      + ('' if 'cudnn' not in t else
                         f'; the CBHG\'s GRU module (input projections, the kernels, dW_hh) '
                         f'forward {t["module_fwd_ms"]:.3f} ms, backward {t["module_bwd_ms"]:.3f} '
                         f'ms; cuDNN\'s bidirectional GRU (nn.GRU, b_hh = (0, 0, b_hn), its '
                         f'input projection inside) forward {t["cudnn"]["fwd_ms"]:.3f} ms, '
                         f'backward {t["cudnn"]["bwd_ms"]:.3f} ms, max abs err from the plain '
                         f'output {t["cudnn"]["max_abs_err"]:.2e}'))
    seconds = time.perf_counter() - t0
    phase(17, 'GRU loop planted faults, the largest of their errors over their case\'s bound '
              f'(each must exceed {GRU_FAULT_FACTOR}): '
              + '; '.join(f'{f} {v:.1f}' for f, v in seen.items())
              + f'; the GRU loops\' checks took {seconds:.1f} s')
    for fault, v in seen.items():
        if not v > GRU_FAULT_FACTOR:
            fail(f'the GRU loop checks do not see the planted fault ({fault}) '
                 f'{GRU_FAULT_FACTOR} times over a bound')
    return dict(readings=readings, faults=seen, seconds=seconds,
                check_launches=dict(collections.Counter(gs.LAUNCHES) - launches0))


def gru_slice(mutants, timed):
    """Phase 17 (see the module docstring): the kernel checks, then the timed steps' GRU
    parts (phases 12 and 14, StepMarks) beside the step loop's, and the GRU kernels'
    launches on the main paths. Returns the readings."""
    from tacotron2_tpu_torch.ops import gru_scan as gs

    t0 = time.perf_counter()
    checks = gru_kernel_checks({f: mutants[f] for f in GRU_MUTANTS})
    for key, t in timed.items():
        was = GRU_STEP_LOOP_TIMED[key]
        before = (f'{was["fwd"]} + {was["bwd"]} ms' if was['fwd'] is not None
                  else f'{was["both"]} ms in all')
        phase(17, f'timed step {key}, B=32 x {TIMED_FRAMES} frames: the CBHG\'s GRUs (StepMarks) '
                  f'forward {t["parts"]["fwd: CBHG GRUs"]:.1f} ms, backward '
                  f'{t["parts"]["bwd: CBHG GRUs"]:.1f} ms (the step loop: {before}); the step '
                  f'{t["step_ms"]:.1f} ms by its parts, {t["sec_step"]:.3f} sec/step')
    launches = {p: dict(GRU_LAUNCHES_BY_PATH[p]) for p in GRU_PATHS}
    phase(17, f'GRU kernel launches on the main paths: {launches}; phase 17 took '
              f'{time.perf_counter() - t0:.1f} s')
    for p in GRU_TRAIN_PATHS:
        if not all(GRU_LAUNCHES_BY_PATH[p][k] for k in gs.KERNELS):
            fail(f'{p} did not run the CBHG\'s GRUs through {gs.KERNELS}')
    for p in GRU_SYNTH_PATHS:
        by = GRU_LAUNCHES_BY_PATH[p]
        if not by['gru_fwd_loop'] or by['gru_bwd_loop']:
            fail(f'{p} did not run the CBHG\'s GRUs through gru_fwd_loop alone')
    return dict(checks=checks, launches=launches)


def gru_entries(gru):
    """The kernels line's entries of the two GRU loops: launches from the main paths' runs,
    the rest from phase 17 at B=32 x GRU_STEPS in bf16 (the trainers' compute dtype on the
    card), the f32 and B=1 readings beside them; library_ms cuDNN's bidirectional GRU
    (forward, or backward) on the same input, its input projection inside."""
    out = []
    r = gru['checks']['readings']
    for name, key in (('gru_fwd_loop', 'fwd'), ('gru_bwd_loop', 'bwd')):
        by = {p: gru['launches'][p].get(name, 0) for p in GRU_PATHS}
        entry = dict(name=name, route='cuda', source=GRU_SOURCE, replaces=GRU_REPLACES[name],
                     launches=sum(by.values()), launches_by_path=by,
                     check_launches=gru['checks']['check_launches'].get(name, 0),
                     max_abs_err=max(v['max_abs_err'] for k, v in r.items() if k[0] == name),
                     dtype='bfloat16', steps=GRU_STEPS,
                     fault_err_over_tol=gru['checks']['faults'])
        for dname in ('bfloat16', 'float32'):
            pre = '' if dname == 'bfloat16' else 'f32_'
            t32, t1 = r[('timing', dname, 'B=32')], r[('timing', dname, 'B=1')]
            entry.update({
                f'{pre}ms': t32[f'{key}_ms'], f'{pre}plain_ms': t32[f'{key}_plain_ms'],
                f'{pre}bound_ms': t32[f'{key}_bound_ms'], f'{pre}bound_by': t32[f'{key}_bound_by'],
                f'{pre}library_ms': t32['cudnn'][f'{key}_ms'],
                f'{pre}module_ms': t32[f'module_{key}_ms'],
                f'{pre}b1_ms': t1[f'{key}_ms'], f'{pre}b1_bound_ms': t1[f'{key}_bound_ms'],
                f'{pre}rel_err': {what: dict(first=r[(name, dname, what)]['first'],
                                             all=r[(name, dname, what)]['all'])
                                  for what in GRU_CASES},
                f'{pre}tol': {what: r[(name, dname, what)]['tol'] for what in GRU_CASES}})
            if key == 'fwd':
                entry[f'{pre}ms_without_residuals'] = t32['fwd_ms_without_residuals']
        out.append(entry)
    return out


# --- phase 18: the encoder's bidirectional zoneout-LSTM recurrence on clusters -----------

LSTM_SOURCE = 'tacotron2_tpu_torch/csrc/lstm_loop/lstm_loop.cu'
# planted faults: a build of csrc/lstm_loop/lstm_loop.cu with one macro set, built in phase 2,
# {fault: the macro}
LSTM_MUTANTS = {
    'lstm_fwd_loop: the +1 forget bias dropped': 'LSTM_FAULT_FORGET_BIAS_DROPPED',
    'lstm_fwd_loop: gates f and i swapped': 'LSTM_FAULT_GATES_SWAPPED',
    'lstm_fwd_loop: the c and h keep-masks swapped': 'LSTM_FAULT_KEEPS_SWAPPED',
    'lstm_fwd_loop: the reversed direction\'s keep-masks read at the sequence position':
        'LSTM_FAULT_KEEPS_AT_POSITION',
    'lstm_fwd_loop: the padding hold ignored': 'LSTM_FAULT_HOLD_IGNORED',
    'lstm_fwd_loop: the zoned h written as the output': 'LSTM_FAULT_ZONED_OUTPUT',
    'lstm_fwd_loop: a peer\'s h read from the other buffer (the step before last)':
        'LSTM_FAULT_STALE_PEER',
    'lstm_bwd_loop: the dc sigma(f + 1) carry dropped': 'LSTM_FAULT_CARRY_DROPPED',
    'lstm_bwd_loop: the c and h keep-masks swapped': 'LSTM_FAULT_BWD_KEEPS_SWAPPED',
    'lstm_bwd_loop: the last partial of dh W_hh^T dropped': 'LSTM_FAULT_BWD_SLOT_DROPPED'}
LSTM_REPLACES = {
    'lstm_fwd_loop': 'tacotron2_tpu/models/tacotron/modules.py:136-206 (the encoder\'s '
                     'jax.lax.scan over its zoneout LSTM step, `run`: an XLA loop, no Pallas '
                     'kernel)',
    'lstm_bwd_loop': 'tacotron2_tpu/models/tacotron/modules.py:136-206 (XLA\'s reverse scan '
                     'of that scan\'s autodiff, no Pallas kernel)'}
LSTM_T_IN = 192        # the feeder's largest padded text: the encoder's steps at B=32
LSTM_B1_T_IN = 112     # a served sentence's text
LSTM_TIMED_T_IN = 112  # the timed step's text (about 100 characters), timed alone
LSTM_RATE = 0.1        # tacotron_zoneout_rate: the keep-masks' rate and the mix's z
# (B, T_in, training form, a ragged `lengths`, W_hh = 0) of each check, in f32 and bf16:
# the trainer's batch at the feeder's largest text in both forms, ragged in each (the hold
# and the in-kernel reversal), one served sentence, and W_hh = 0, where only the
# elementwise math is left, so that each op must round as the plain version's does
LSTM_CASES = {'B=32, training': (32, LSTM_T_IN, True, False, False),
              'B=32, training, ragged': (32, LSTM_T_IN, True, True, False),
              'B=32, synthesis, ragged': (32, LSTM_T_IN, False, True, False),
              'B=1, training': (1, LSTM_B1_T_IN, True, False, False),
              'B=1, synthesis': (1, LSTM_B1_T_IN, False, False, False),
              'B=32, W_hh = 0, training, ragged': (32, LSTM_T_IN, True, True, True),
              'B=32, W_hh = 0, synthesis': (32, LSTM_T_IN, False, False, True)}
LSTM_FIRST_STEPS = GRU_FIRST_STEPS
# each kernel against its plain version on the same CUDA tensors, {kernel: {span: bound}}
# in both dtypes (the recurrence is float32 in both; bf16 only stores xp and W_hh): the
# largest error of its outputs (lstm_fwd_loop: the output and the residuals; lstm_bwd_loop:
# dz) over each direction's first LSTM_FIRST_STEPS steps (the reverse kernel's first, the
# last in step order) and over all, relative to the plain tensor's largest entry there,
# and lstm_bwd_loop's dW_hh ('dW': the kernel path's one product against the plain
# version's sum step by step); with W_hh = 0 the first two bounds are LSTM_ZERO_TOL. Read
# on an H100 80GB HBM3 at 700 W: the forward at most 2.0e-7 over the first steps
# and 4.5e-7 over all (the product's f32 sums in another order than cuBLAS's), dz 1.5e-7
# and 1.9e-7, dW_hh 6.9e-7, W_hh = 0 reads 0 in the forward and dz (every elementwise op
# rounds where the plain version's does), in both dtypes; the planted faults 1.8e4 to
# 1.8e6 times a bound. The bounds sit 10x, 11x, 13x, 26x and 7x above the readings
LSTM_TOL = {'lstm_fwd_loop': {'first': 2e-6, 'all': 5e-6},
            'lstm_bwd_loop': {'first': 2e-6, 'all': 5e-6, 'dW': 5e-6}}
LSTM_ZERO_TOL = 1e-6
# a planted fault must miss its case's bound by this factor in one span of one case
LSTM_FAULT_FACTOR = 10
# the encoder LSTM in the timed B=32 x 512 steps while it ran as a step loop (StepMarks
# parts "fwd: encoder LSTM" and "bwd: encoder LSTM", ms; H100 80GB HBM3, 700 W; PERF.md
# section 5)
LSTM_STEP_LOOP_TIMED = {'float32': dict(fwd=71.4, bwd=117.4),
                        'bfloat16': dict(fwd=68.2, bwd=127.5)}
# the main paths that encode text: those that train launch both kernels, the others (the
# synthesis of the CLIs and the service, GTA) lstm_fwd_loop alone
LSTM_TRAIN_PATHS = (TACO_PATH, TACO_F32_SCHEDULED_PATH, TACO_F32_TIMED_PATH,
                    TACO_BF16_TIMED_PATH, PIPE_TACO_PATH)
LSTM_SYNTH_PATHS = ('synthesize', 'serve', 'synthesize --paper_profile',
                    'serve --paper_profile', PIPE_GTA_PATH, TACO_EVAL_CLI_PATH,
                    TACO_LIVE_CLI_PATH, PIPE_TACOTRON2_PATH)
LSTM_PATHS = LSTM_TRAIN_PATHS + LSTM_SYNTH_PATHS


def encoder_lstm_reading(hp, B, n):
    """Phases 5 (B=2) and 7 (B=1): one free-running Tacotron synthesis of B sentences on the
    card at `hp` (a seeded, stop-suppressed model, the CLIs' Synthesizer), its encoder LSTM
    timed by CUDA events from hooks around `encoder_lstm` and the whole Tacotron stage
    around the call, through the step loop (`lstm_loop_applies` false: the path before the
    kernel) and through lstm_fwd_loop, after one untimed run. Returns the readings."""
    from tacotron2_tpu_torch.inference.tacotron_synthesizer import Synthesizer
    from tacotron2_tpu_torch.models.tacotron.model import Tacotron
    from tacotron2_tpu_torch.ops import lstm_scan
    from tacotron2_tpu_torch.utils import suppress_stop_tokens

    hp = hp.replace(tacotron_synthesis_batch_size=B)
    torch.manual_seed(8)
    model = Tacotron(hp)
    model.load_state_dict(suppress_stop_tokens(model.state_dict()))
    synth = Synthesizer(model.cuda(), hp, 'cuda')
    with open(os.path.join(REPO, 'sentences.txt'), encoding='utf-8') as f:
        texts = [line.strip() for line in f if line.strip()][:B]
    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()
    hooks = [model.encoder_lstm.register_forward_pre_hook(lambda *a: mark('pre')),
             model.encoder_lstm.register_forward_hook(lambda *a: mark('post'))]
    out = {}
    try:
        for route in ('warm-up', 'step loop', 'lstm_fwd_loop'):
            loop = route == 'step loop'
            with torch.no_grad(), _patched(lstm_scan, 'lstm_loop_applies',
                                           (lambda *a: False) if loop
                                           else lstm_scan.lstm_loop_applies):
                before = lstm_scan.LAUNCHES['lstm_fwd_loop']
                _, stage_ms = cuda_ms(lambda: synth.synthesize(
                    texts, torch.Generator('cuda').manual_seed(9)))
                launched = lstm_scan.LAUNCHES['lstm_fwd_loop'] - before
            if launched != (0 if loop else 1):
                fail(f'the {route} synthesis launched lstm_fwd_loop {launched} times')
            out[route] = dict(encoder_lstm_ms=marks['pre'].elapsed_time(marks['post']),
                              tacotron_ms=stage_ms)
    finally:
        for h in hooks:
            h.remove()
    del out['warm-up']
    phase(n, f'the encoder LSTM inside one Tacotron synthesis at B={B} (max_iters='
             f'{hp.max_iters}, CUDA events): ' + '; '.join(
                 f'{route} {r["encoder_lstm_ms"]:.2f} ms of the Tacotron stage\'s '
                 f'{r["tacotron_ms"]:.1f} ms ({100 * r["encoder_lstm_ms"] / r["tacotron_ms"]:.1f}%)'
                 for route, r in out.items()))
    return out


def lstm_case(rnn, B, T, train, ragged, zero_w, dtype, seed=29):
    """The operands of an LSTM check on the card: the seeded encoder LSTM's two cells (the
    trainer's initial weights, biases of order 0.3) on a seeded (B, T, C) float32 input
    through their own casts (`BiZoneoutLSTM.operands`, compute dtype `dtype`; the backward
    cell's over each row's reversed sequence, as the module hoists it), W_hh zeroed
    with `zero_w`, the lengths (each row's own from T / 4 up where `ragged`, row 0 whole),
    seeded keep-masks at LSTM_RATE with `train`, and a seeded cotangent of the output."""
    from tacotron2_tpu_torch.models.tacotron.modules import reverse_sequences

    g = torch.Generator('cuda').manual_seed(seed)
    U = rnn.fw.units
    x = torch.randn(B, T, rnn.fw.gates.in_features - U, device='cuda', generator=g)
    lengths = torch.full((B,), T, device='cuda')
    if ragged:
        lengths = torch.randint(T // 4, T + 1, (B,), device='cuda', generator=g)
        lengths[0] = T
    with torch.no_grad():
        xps, ws = (list(v) for v in zip(*(
            rnn.operands(cell, seq, dtype)
            for cell, seq in ((rnn.fw, x), (rnn.bw, reverse_sequences(x, lengths))))))
    if zero_w:
        ws = [torch.zeros_like(w) for w in ws]
    keeps = None
    if train:
        keeps = [tuple(torch.rand(T, B, U, device='cuda', generator=g) >= LSTM_RATE
                       for _ in range(2)) for _ in range(2)]
    return dict(x=x, xps=xps, ws=ws, lengths=lengths, keeps=keeps,
                rates=[(cell.zoneout_cell, cell.zoneout_output) for cell in (rnn.fw, rnn.bw)],
                reverse=(False, True),
                dout=torch.randn(B, T, 2 * U, device='cuda', generator=g))


def _lstm_fwd_errs(case, got, want):
    """{span: {tensor: error}} of lstm_fwd_loop's output and residuals against the plain
    version's, each direction in its own step order (the residuals are in it already)."""
    from tacotron2_tpu_torch.ops import lstm_scan as ls

    U, out = case['ws'][0].shape[0], {'first': {}, 'all': {}}
    for d, rev in enumerate(case['reverse']):
        pairs = {f'out{d}': tuple(ls._order(x[0][..., d * U:(d + 1) * U], case['lengths'], rev)
                                  for x in (got, want))}
        for i, name in enumerate(ls.RESIDUALS):
            pairs[f'{name}{d}'] = (got[1][d][i], want[1][d][i])
        for name, (g, w) in pairs.items():
            for span in out:
                out[span][name] = _gru_span_err(g, w, span == 'first')
    return out


def _lstm_bwd_errs(got, want):
    """{span: {tensor: error}} of lstm_bwd_loop's dz against the plain version's, each
    direction in its own step order (the reverse kernel's first steps the last ones), and
    of dW_hh ('dW'): the kernel's one product after the launch against the plain version's
    sum step by step."""
    out = {'first': {}, 'all': {}, 'dW': {}}
    for d, (g, w) in enumerate(zip(got[0], want[0])):
        for span in ('first', 'all'):
            out[span][f'dz{d}'] = _gru_span_err(g, w, span == 'first', from_end=True)
        out['dW'][f'dW_hh{d}'] = _gru_span_err(got[1][d][None], want[1][d][None], False)
    return out


# operations a unit, row and step of a direction outside the gate product, counted low: forward
# the four sums with xp, f + 1, three sigmoids and two tanh (one each), the state (3), h (1),
# zoneout (6), the hold (2) and the mask (1); reverse the hold and zoneout (8), dh_new (2),
# dc_new (4), the four gate gradients (15) and the carries (3)
LSTM_CORE_OPS = {'fwd': 23, 'bwd': 32}


def lstm_bound(B, T, dtype, forward, save=True):
    """(ms, 'bytes' or 'operations', the operations' ms on the f32 CUDA cores) of the least
    time an H100 takes for a launch of both directions over B rows and T steps (`_f32_bound`):
    its operations, the products 2 B T 4U U a direction (forward h W_hh, reverse dz W_hh^T;
    float32-accurate, the state is float32) as 3xTF32 on the tensor cores and LSTM_CORE_OPS
    on the f32 CUDA cores, or its bytes over the HBM rate: forward xp and W_hh (in `dtype`),
    the lengths and (training) the four keep-masks read, the output and (with `save`) the
    residuals written; reverse the output's gradient, the residuals (all but h), W_hh, the
    lengths and the keep-masks read, dz written."""
    from tacotron2_tpu_torch.ops import lstm_scan as ls

    U, s, n_res = ls.LSTM_LOOP_UNITS, (4 if dtype == torch.float32 else 2), len(ls.RESIDUALS)
    mma_ops = 2 * 2 * B * T * 4 * U * U
    core_ops = 2 * B * T * U * LSTM_CORE_OPS['fwd' if forward else 'bwd']
    keeps = 4 * T * B * U
    if forward:
        nbytes = (2 * (B * T * 4 * U + U * 4 * U) * s + 4 * B + keeps + B * T * 2 * U * 4
                  + (2 * n_res * B * T * U * 4 if save else 0))
    else:
        nbytes = (B * T * 2 * U * 4 + 2 * (n_res - 1) * B * T * U * 4 + 2 * U * 4 * U * s
                  + 4 * B + keeps + 2 * B * T * 4 * U * 4)
    return _f32_bound(nbytes, mma_ops, core_ops)


def cudnn_lstm(rnn, case, want):
    """The library's yardstick at zoneout 0: cuDNN's bidirectional LSTM (nn.LSTM) on the
    case's input x (full lengths) with the encoder cells' weights, the gates reordered from
    (i, g, f, o) to torch's (i, f, g, o) and the +1 forget bias folded into b_f (b_hh = 0),
    in the case's compute dtype; in f32 first held to the plain version's output at zoneout 0
    (`want`), then timed (the median of 3): its forward with a gradient to take, and its
    backward to the input and the weights from the case's cotangent. Returns the readings."""
    dt, x = case['xps'][0].dtype, case['x']
    U = rnn.fw.units
    C = x.shape[-1]
    order = torch.cat([torch.arange(0, U), torch.arange(2 * U, 3 * U), torch.arange(U, 2 * U),
                       torch.arange(3 * U, 4 * U)]).to(x.device)
    lstm = torch.nn.LSTM(C, U, batch_first=True, bidirectional=True).to('cuda', dt)
    with torch.no_grad():
        for sfx, cell in (('', rnn.fw), ('_reverse', rnn.bw)):
            w, b = cell.gates.weight[order], cell.gates.bias[order].clone()
            b[U:2 * U] += 1.0
            getattr(lstm, f'weight_ih_l0{sfx}').copy_(w[:, :C])
            getattr(lstm, f'weight_hh_l0{sfx}').copy_(w[:, C:])
            getattr(lstm, f'bias_ih_l0{sfx}').copy_(b)
            getattr(lstm, f'bias_hh_l0{sfx}').zero_()
    lstm.flatten_parameters()
    xi = x.to(dt).detach().requires_grad_()
    out = lstm(xi)[0]
    err = None if want is None else float((out.detach().double() - want.double()).abs().max())
    leaves = [xi] + list(lstm.parameters())
    fwd_ms = _median_ms(lambda: lstm(xi)[0])
    bwd_ms = _median_ms(lambda: torch.autograd.grad(out, leaves, case['dout'].to(dt),
                                                    retain_graph=True))
    return dict(max_abs_err=err, fwd_ms=fwd_ms, bwd_ms=bwd_ms)


def lstm_kernel_checks(mutants):
    """lstm_fwd_loop and lstm_bwd_loop (csrc/lstm_loop/lstm_loop.cu) against their plain
    versions on the same CUDA tensors at the default widths (C = 512, U = 256), each of
    LSTM_CASES at compute dtype f32 (TF32 off) and bf16 (the forward on the case's
    operands, the reverse on the plain forward's residuals and the case's cotangent): the
    spans of _lstm_fwd_errs and _lstm_bwd_errs within LSTM_TOL (LSTM_ZERO_TOL with W_hh = 0);
    a second launch of each bit for bit the first; each of LSTM_MUTANTS (`mutants`: fault ->
    its library) must miss its case's bound by LSTM_FAULT_FACTOR in one span of one case.
    Each kernel timed (CUDA events, the median of 3: the forward with the residuals, as
    training launches it, and without, as synthesis does) at B=32 x LSTM_T_IN, B=32 x
    LSTM_TIMED_T_IN and B=1 x LSTM_B1_T_IN in the training form, with its bound and its plain
    version's time; at B=32 x LSTM_T_IN the whole module (BiZoneoutLSTM: the hoisted
    products, the Function, dW_hh) forward and backward, and cuDNN's bidirectional LSTM at
    zoneout 0 on the same input (cudnn_lstm), first held to the plain output at zoneout 0 in
    f32. Returns the readings."""
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.ops import lstm_scan as ls
    from tacotron2_tpu_torch.training import tacotron_trainer as tt

    hp = default_hparams()
    hp.parse(TACO_OVERRIDES)
    rnn = tt.create_train_state(hp, 'cuda', seed=29).model.encoder_lstm
    with torch.no_grad():
        g = torch.Generator('cuda').manual_seed(29)
        for cell in (rnn.fw, rnn.bw):
            cell.gates.bias.copy_(torch.randn(cell.gates.bias.shape, device='cuda',
                                              generator=g) * 0.3)
    t0 = time.perf_counter()
    launches0 = collections.Counter(ls.LAUNCHES)
    readings, seen = {}, dict.fromkeys(LSTM_MUTANTS, 0.0)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split('.')[-1]
        for what, (B, T, train, ragged, zero_w) in LSTM_CASES.items():
            case = lstm_case(rnn, B, T, train, ragged, zero_w, dtype)
            tols = {k: {**t, 'first': LSTM_ZERO_TOL, 'all': LSTM_ZERO_TOL} if zero_w else t
                    for k, t in LSTM_TOL.items()}
            args = (case['xps'], case['ws'], case['lengths'], case['keeps'], case['rates'],
                    case['reverse'], torch.float32)
            bargs = (case['ws'], case['lengths'], case['keeps'], case['rates'], case['reverse'])
            with torch.no_grad():
                want = ls._lstm_fwd_loop_plain(*args, True)
                got = ls.lstm_fwd_loop(*args, True)
                again = ls.lstm_fwd_loop(*args, True)
                bare = ls.lstm_fwd_loop(*args, False)
                bwant = ls._lstm_bwd_loop_plain(case['dout'], want[1], *bargs)
                bgot = ls.lstm_bwd_loop(case['dout'], want[1], *bargs)
                bagain = ls.lstm_bwd_loop(case['dout'], want[1], *bargs)
                torch.cuda.synchronize()
                errs = {'lstm_fwd_loop': _lstm_fwd_errs(case, got, want),
                        'lstm_bwd_loop': _lstm_bwd_errs(bgot, bwant)}
                abs_errs = {'lstm_fwd_loop': float((got[0] - want[0]).abs().max()),
                            'lstm_bwd_loop': max(float((a - b).abs().max())
                                                 for a, b in zip(bgot[0], bwant[0]))}
                same = (torch.equal(got[0], again[0]) and torch.equal(got[0], bare[0])
                        and all(torch.equal(a, b) for a, b in zip(got[1], again[1]))
                        and all(torch.equal(a, b) for x, y in zip(bgot, bagain)
                                for a, b in zip(x, y)))
                if not same:
                    fail(f'two launches of an LSTM loop kernel differ ({dname}, {what})')
                for fault, lib in mutants.items():
                    with _patched(ls, 'library', lambda lib=lib: lib):
                        bad = {'lstm_fwd_loop': _lstm_fwd_errs(case, ls.lstm_fwd_loop(*args, True),
                                                               want),
                               'lstm_bwd_loop': _lstm_bwd_errs(
                                   ls.lstm_bwd_loop(case['dout'], want[1], *bargs), bwant)}
                    seen[fault] = max(seen[fault], *(max(e[span].values()) / tols[k][span]
                                                     for k, e in bad.items() for span in e))
            for kernel, e in errs.items():
                tol = tols[kernel]
                r = dict({span: max(v.values()) for span, v in e.items()},
                         worst_first=max(e['first'], key=e['first'].get),
                         worst_all=max(e['all'], key=e['all'].get), tol=tol,
                         by_tensor={**e['all'], **e.get('dW', {})},
                         max_abs_err=abs_errs[kernel],
                         rows=ls.rows_per_cluster(B, 2, dtype == torch.bfloat16,
                                                  kernel == 'lstm_fwd_loop'))
                readings[(kernel, dname, what)] = r
                phase(18, f'{kernel} {dname} {what}, {T} steps on clusters of '
                          f'{ls.LSTM_LOOP_CLUSTER} CTAs, {r["rows"]} rows a cluster: kernel vs '
                          f'plain, relative to the plain tensor\'s largest entry, the first '
                          f'{LSTM_FIRST_STEPS} steps {r["first"]:.2e} ({r["worst_first"]}; tol '
                          f'{tol["first"]}), all {r["all"]:.2e} ({r["worst_all"]}; tol '
                          f'{tol["all"]})'
                          + (f', dW_hh {r["dW"]:.2e} (tol {tol["dW"]})' if 'dW' in r else '')
                          + '; a second launch bit for bit the first; by tensor over all steps: '
                          + ', '.join(f'{n} {v:.1e}' for n, v in r['by_tensor'].items()))
                if not all(r[span] <= tol[span] for span in e):
                    fail(f'the {kernel} kernel disagrees with its plain version ({dname}, {what})')
        timed_cases = {'B=32': (32, LSTM_T_IN), 'B=32, short': (32, LSTM_TIMED_T_IN),
                       'B=1': (1, LSTM_B1_T_IN)}
        for what, (B, T) in timed_cases.items():
            case = lstm_case(rnn, B, T, True, False, False, dtype)
            args = (case['xps'], case['ws'], case['lengths'], case['keeps'], case['rates'],
                    case['reverse'], torch.float32)
            bargs = (case['ws'], case['lengths'], case['keeps'], case['rates'], case['reverse'])
            t = readings[('timing', dname, what)] = dict(steps=T)
            with torch.no_grad():
                res = ls.lstm_fwd_loop(*args, True)[1]
                t['fwd_ms'] = _median_ms(lambda: ls.lstm_fwd_loop(*args, True))
                t['fwd_ms_without_residuals'] = _median_ms(lambda: ls.lstm_fwd_loop(*args, False))
                t['bwd_ms'] = _median_ms(lambda: ls.lstm_bwd_loop(case['dout'], res, *bargs))
                if what != 'B=32, short':
                    plain, t['fwd_plain_ms'] = cuda_ms(lambda: ls._lstm_fwd_loop_plain(*args, True))
                    t['bwd_plain_ms'] = cuda_ms(
                        lambda: ls._lstm_bwd_loop_plain(case['dout'], plain[1], *bargs))[1]
            t['fwd_bound_ms'], t['fwd_bound_by'], t['fwd_f32_core_bound_ms'] = lstm_bound(
                B, T, dtype, True)
            t['fwd_bound_ms_without_residuals'] = lstm_bound(B, T, dtype, True, False)[0]
            t['bwd_bound_ms'], t['bwd_bound_by'], t['bwd_f32_core_bound_ms'] = lstm_bound(
                B, T, dtype, False)
            if what == 'B=32':
                x = case['x'].detach().requires_grad_()
                out = rnn(x, case['lengths'], [k for pair in case['keeps'] for k in pair], dtype)
                leaves = [x] + list(rnn.parameters())
                t['module_fwd_ms'] = _median_ms(lambda: rnn(
                    x, case['lengths'], [k for pair in case['keeps'] for k in pair], dtype))
                t['module_bwd_ms'] = _median_ms(lambda: torch.autograd.grad(
                    out, leaves, case['dout'], retain_graph=True))
                want0 = None
                if dtype == torch.float32:
                    with torch.no_grad():
                        want0 = ls._lstm_fwd_loop_plain(
                            case['xps'], case['ws'], case['lengths'], None,
                            [(0.0, 0.0)] * 2, case['reverse'], torch.float32, False)[0]
                t['cudnn'] = cudnn_lstm(rnn, case, want0)
                if want0 is not None and not t['cudnn']['max_abs_err'] <= TACOTRON_TOL:
                    fail(f'cuDNN\'s LSTM does not compute the encoder LSTM at zoneout 0: max abs '
                         f'err {t["cudnn"]["max_abs_err"]:.2e} from the plain version')
            phase(18, f'{dname} B={B} x {T} steps, both directions: lstm_fwd_loop '
                      f'{t["fwd_ms"]:.3f} ms ({1e3 * t["fwd_ms"] / T:.2f} us a step; without '
                      f'residuals {t["fwd_ms_without_residuals"]:.3f} ms), bound '
                      f'{t["fwd_bound_ms"]:.4f} ms by {t["fwd_bound_by"]} '
                      f'({t["fwd_f32_core_bound_ms"]:.4f} ms on the f32 CUDA cores); '
                      f'lstm_bwd_loop {t["bwd_ms"]:.3f} ms ({1e3 * t["bwd_ms"] / T:.2f} us a '
                      f'step), bound {t["bwd_bound_ms"]:.4f} ms by {t["bwd_bound_by"]} '
                      f'({t["bwd_f32_core_bound_ms"]:.4f} ms on the f32 CUDA cores)'
                      + ('' if 'fwd_plain_ms' not in t else
                         f'; the plain versions {t["fwd_plain_ms"]:.1f} + '
                         f'{t["bwd_plain_ms"]:.1f} ms')
                      + ('' if 'cudnn' not in t else
                         f'; the encoder LSTM module (the hoisted products, the kernels, dW_hh) '
                         f'forward {t["module_fwd_ms"]:.3f} ms, backward {t["module_bwd_ms"]:.3f} '
                         f'ms; cuDNN\'s bidirectional LSTM at zoneout 0 (nn.LSTM, its input '
                         f'product inside) forward {t["cudnn"]["fwd_ms"]:.3f} ms, backward '
                         f'{t["cudnn"]["bwd_ms"]:.3f} ms'
                         + ('' if t['cudnn']['max_abs_err'] is None else
                            f', max abs err from the plain output at zoneout 0 '
                            f'{t["cudnn"]["max_abs_err"]:.2e}')))
    seconds = time.perf_counter() - t0
    phase(18, 'LSTM loop planted faults, the largest of their errors over their case\'s bound '
              f'(each must exceed {LSTM_FAULT_FACTOR}): '
              + '; '.join(f'{f} {v:.1f}' for f, v in seen.items())
              + f'; the LSTM loops\' checks took {seconds:.1f} s')
    for fault, v in seen.items():
        if not v > LSTM_FAULT_FACTOR:
            fail(f'the LSTM loop checks do not see the planted fault ({fault}) '
                 f'{LSTM_FAULT_FACTOR} times over a bound')
    return dict(readings=readings, faults=seen, seconds=seconds,
                occupancy={f'{"bf16" if bf else "f32"} {"fwd" if fw else "bwd"} R={r}':
                           ls.occupancy(r, bf, fw) for bf in (False, True)
                           for fw in (True, False) for r in ls.LSTM_LOOP_ROWS},
                check_launches=dict(collections.Counter(ls.LAUNCHES) - launches0))


def lstm_slice(mutants, timed, main_readings):
    """Phase 18 (see the module docstring): the kernel checks, then the timed steps' encoder
    LSTM parts (phases 12 and 14, StepMarks) beside the step loop's, the main path's
    readings of phases 5 and 7, and the LSTM kernels' launches on the main paths. Returns
    the readings."""
    from tacotron2_tpu_torch.ops import lstm_scan as ls

    t0 = time.perf_counter()
    checks = lstm_kernel_checks({f: mutants[f] for f in LSTM_MUTANTS})
    steps = {}
    for key, t in timed.items():
        was = LSTM_STEP_LOOP_TIMED[key]
        steps[key] = dict(fwd=t['parts']['fwd: encoder LSTM'], bwd=t['parts']['bwd: encoder LSTM'],
                          step_ms=t['step_ms'], sec_step=t['sec_step'])
        phase(18, f'timed step {key}, B=32 x {TIMED_FRAMES} frames ({TIMED_CHARS} characters): '
                  f'the encoder LSTM (StepMarks) forward {steps[key]["fwd"]:.1f} ms, backward '
                  f'{steps[key]["bwd"]:.1f} ms (the step loop: {was["fwd"]} + {was["bwd"]} ms); '
                  f'the step {t["step_ms"]:.1f} ms by its parts, {t["sec_step"]:.3f} sec/step')
    launches = {p: dict(LSTM_LAUNCHES_BY_PATH[p]) for p in LSTM_PATHS}
    seconds = time.perf_counter() - t0
    phase(18, f'LSTM kernel launches on the main paths: {launches}; occupancy (clusters of '
              f'{ls.LSTM_LOOP_CLUSTER} resident) {checks["occupancy"]}; phase 18 took '
              f'{seconds:.1f} s')
    for p in LSTM_TRAIN_PATHS:
        if not all(LSTM_LAUNCHES_BY_PATH[p][k] for k in ls.KERNELS):
            fail(f'{p} did not run the encoder LSTM through {ls.KERNELS}')
    for p in LSTM_SYNTH_PATHS:
        by = LSTM_LAUNCHES_BY_PATH[p]
        if not by['lstm_fwd_loop'] or by['lstm_bwd_loop']:
            fail(f'{p} did not run the encoder LSTM through lstm_fwd_loop alone')
    return dict(checks=checks, launches=launches, steps=steps, main=main_readings,
                seconds=seconds)


def lstm_entries(lstm):
    """The kernels line's entries of the two LSTM loops: launches from the main paths' runs,
    the rest from phase 18 at B=32 x LSTM_T_IN in bf16 (the trainers' compute dtype on the
    card; the recurrence is float32 in both), the f32, B=32 x LSTM_TIMED_T_IN and B=1
    readings beside them; library_ms cuDNN's bidirectional LSTM at zoneout 0 (forward, or
    backward) on the same input, its input product inside."""
    out = []
    r = lstm['checks']['readings']
    for name, key in (('lstm_fwd_loop', 'fwd'), ('lstm_bwd_loop', 'bwd')):
        by = {p: lstm['launches'][p].get(name, 0) for p in LSTM_PATHS}
        entry = dict(name=name, route='cuda', source=LSTM_SOURCE, replaces=LSTM_REPLACES[name],
                     launches=sum(by.values()), launches_by_path=by,
                     check_launches=lstm['checks']['check_launches'].get(name, 0),
                     max_abs_err=max(v['max_abs_err'] for k, v in r.items() if k[0] == name),
                     dtype='bfloat16', steps=LSTM_T_IN,
                     fault_err_over_tol=lstm['checks']['faults'],
                     occupancy=lstm['checks']['occupancy'],
                     timed_step_ms={k: v[key] for k, v in lstm['steps'].items()})
        if key == 'fwd':
            entry['main_path'] = lstm['main']
        for dname in ('bfloat16', 'float32'):
            pre = '' if dname == 'bfloat16' else 'f32_'
            t32, t1 = r[('timing', dname, 'B=32')], r[('timing', dname, 'B=1')]
            t112 = r[('timing', dname, 'B=32, short')]
            entry.update({
                f'{pre}ms': t32[f'{key}_ms'], f'{pre}plain_ms': t32[f'{key}_plain_ms'],
                f'{pre}bound_ms': t32[f'{key}_bound_ms'], f'{pre}bound_by': t32[f'{key}_bound_by'],
                f'{pre}f32_core_bound_ms': t32[f'{key}_f32_core_bound_ms'],
                f'{pre}library_ms': t32['cudnn'][f'{key}_ms'],
                f'{pre}module_ms': t32[f'module_{key}_ms'],
                f'{pre}t{LSTM_TIMED_T_IN}_ms': t112[f'{key}_ms'],
                f'{pre}t{LSTM_TIMED_T_IN}_bound_ms': t112[f'{key}_bound_ms'],
                f'{pre}b1_ms': t1[f'{key}_ms'], f'{pre}b1_bound_ms': t1[f'{key}_bound_ms'],
                f'{pre}b1_plain_ms': t1[f'{key}_plain_ms'],
                f'{pre}rel_err': {what: {span: r[(name, dname, what)][span]
                                         for span in r[(name, dname, what)]['tol']}
                                  for what in LSTM_CASES},
                f'{pre}tol': {what: r[(name, dname, what)]['tol'] for what in LSTM_CASES}})
            if key == 'fwd':
                entry[f'{pre}ms_without_residuals'] = t32['fwd_ms_without_residuals']
        out.append(entry)
    return out


def main():
    t_start = T_START
    if not torch.cuda.is_available():
        fail('torch finds no CUDA device')
    from tacotron2_tpu_torch.config import default_hparams
    from tacotron2_tpu_torch.models.wavenet.model import WaveNet
    from tacotron2_tpu_torch.ops import _build, wavenet_ar
    from tacotron2_tpu_torch.probes import ar_critpath, matmul_probe, microbench, prng_probe
    from tacotron2_tpu_torch.utils import randomize_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    phase(1, f'torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, '
             f'{torch.cuda.device_count()} device(s); nvidia-smi: {smi}')

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='t2torch_mutants_')
    atexit.register(shutil.rmtree, tmp, True)
    mutants = build_kernels(tmp)
    phase(2, f'built and loaded the AR kernel\'s library in {time.perf_counter() - t0:.1f} s; '
             f'the probes\', the decoder step\'s, the four decoder loops\', the GRU loops\' and '
             f'the LSTM loops\' libraries and '
             f'{len(mutants)} copies with one planted fault each build beside phase 3')
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
    kernel_vs_plain(weights, model, hp, 8, CHECK_FRAMES, gen)
    frames = MAX_ITERS * hp.outputs_per_step
    kernel = kernel_vs_plain(weights, model, hp, MAIN_BATCH, frames, gen, SERVE_BOUNDS,
                             plain_steps=PLAIN_STEPS)
    wide = kernel_vs_plain(weights, model, hp, WAVENET_BATCH, CHECK_FRAMES, gen)
    t_wait = time.perf_counter()
    mutants.wait()
    phase(2, f'every build done at {mutants.done_at:.1f} s of the run; phase 3 waited '
             f'{time.perf_counter() - t_wait:.1f} s for them at its end')
    shutil.rmtree(tmp, ignore_errors=True)
    check_tacotron(hp)
    launches_batch, batch_us = main_path(overrides, hp, wavenet_state)
    encoder_reading = {'synthesize, B=2': encoder_lstm_reading(hp, MAIN_BATCH, 5)}
    streamed = check_state_carry(weights, model, hp, gen, kernel)
    launches_serve = service(f'max_iters={MAX_ITERS}', hp, wavenet_state)
    encoder_reading['serve, B=1'] = encoder_lstm_reading(hp, 1, 7)
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
    t12 = time.perf_counter()
    taco = tacotron_training()
    phase(12, f'phase 12 took {time.perf_counter() - t12:.1f} s; the whole run '
              f'{time.perf_counter() - t_start:.1f} s')
    pipeline = tacotron2_pipeline(t_start)
    pipe_eval, pipe_cli_runs = pipeline['eval_launch'], pipeline['cli']
    t14 = time.perf_counter()
    remaining = remaining_configurations(gen)
    ups = remaining['upsamplers']
    phase(14, f'phase 14 took {time.perf_counter() - t14:.1f} s ({remaining["seconds"]}); '
              f'the whole run {time.perf_counter() - t_start:.1f} s')
    scale = scale_out(training['default']['losses'][0], TRAIN_DEFAULT_EXTRA)
    phase(15, f'the whole run {time.perf_counter() - t_start:.1f} s')
    decoder = decoder_slice(mutants, {'float32': taco['timed'],
                                      'bfloat16': remaining['tacotron']['timed']},
                            pipeline['gta_s_per_utterance'])
    phase(16, f'the whole run {time.perf_counter() - t_start:.1f} s')
    gru = gru_slice(mutants, {'float32': taco['timed'],
                              'bfloat16': remaining['tacotron']['timed']})
    phase(17, f'the whole run {time.perf_counter() - t_start:.1f} s')
    lstm = lstm_slice(mutants, {'float32': taco['timed'],
                                'bfloat16': remaining['tacotron']['timed']}, encoder_reading)
    phase(18, f'the whole run {time.perf_counter() - t_start:.1f} s')
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
    # the entry point launches over the first 1,100 of its 8,800; the bounds are those of
    # the two entry-point launches).
    # the train_eval_ keys are the default trainer's eval launch against the plain
    # version on its own inputs (phase 10), the pipeline_eval_ keys the Tacotron-2
    # pipeline's (phase 13: its WaveNet trained on GTA mels; its bound that of the whole
    # launch); the pipeline's run-name command lines launch it too (phase 13).
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
        + vocoder['categorical_launches'] + training['default']['launches']
        + pipeline['launches'] + pipe_cli_runs['wavenet_launches']
        + pipe_cli_runs['tacotron2_launches'] + sum(u['launches'] for u in ups.values())
        + scale['gen_launches'] + scale['cli_launches'],
        launches_by_path={'synthesize': launches_batch, 'serve': launches_serve,
                          TRAIN_PATH: training['default']['launches'],
                          PIPE_PATH: pipeline['launches'],
                          PIPE_WAVENET_PATH: pipe_cli_runs['wavenet_launches'],
                          PIPE_TACOTRON2_PATH: pipe_cli_runs['tacotron2_launches'],
                          'synthesize --paper_profile': paper['batch_launches'],
                          'serve --paper_profile': paper['serve_launches'],
                          VOCODER_SPEAKERS_PATH: vocoder['speakers_launches'],
                          VOCODER_CATEGORICAL_PATH: vocoder['categorical_launches'],
                          'vocoder_checks': vocoder['check_launches'],
                          'state_carry_check': streamed['launches'],
                          'mol_state_carry_check': paper['carry_launches'],
                          **{p: u['launches'] for p, u in zip(UPSAMPLER_PATHS, ups.values())},
                          SCALE_GEN_PATH: scale['gen_launches'],
                          SCALE_CLI_PATH: scale['cli_launches']},
        max_abs_err=max(kernel['max_abs_err'], wide['max_abs_err'],
                        streamed['max_abs_err'],
                        training['default']['eval_launch']['max_abs_err'],
                        pipe_eval['max_abs_err'], *(u['max_abs_err'] for u in ups.values())),
        ms=kernel['ms'], plain_ms=kernel['plain_ms'], bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, steps=kernel['steps'], full_ms=kernel['full_ms'],
        full_steps=frames * hp.get_hop_size(),
        cluster=path_clusters(*AR_PATHS), mol_cluster=path_clusters(*PAPER_PATHS),
        occupancy=clusters['occupancy'],
        launches_by_cluster={p: cluster_counts(p) for p in AR_PATHS + PAPER_PATHS + PIPE_PATHS
                             + SCALE_PATHS},
        launches_by_layout={p: layout_counts(p) for p in AR_PATHS + PAPER_PATHS + PIPE_PATHS
                            + SCALE_PATHS},
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
        **{f'train_eval_{k}': v for k, v in training['default']['eval_launch'].items()},
        **{f'pipeline_eval_{k}': v for k, v in pipe_eval.items()},
        pipeline_gta_cpu_vs_card=pipeline['gta'],
        pipeline_gta_s_per_utterance=pipeline['gta_s_per_utterance'],
        upsamplers={k: {n: u[n] for n in ('launch_of', 'max_abs_err', 'state_err', 'steps',
                                          'us_step', 'upsampler_err')}
                    for k, u in ups.items()},
        upsampler_ms={k: u['ms'] for k, u in ups.items()},
        upsampler_plain_ms={k: u['plain_ms'] for k, u in ups.items()},
        scale_out={k: v for k, v in scale.items() if k not in ('gen_launches', 'cli_launches')}),
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
        for name in probe_modules] + decoder_entries(decoder) + gru_entries(gru)
        + lstm_entries(lstm)}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--rank-job']:      # a child of phase 15
        rank_job(*sys.argv[2:4])
    elif sys.argv[1:2] == ['--rank-cli']:    # a rank of phase 15's command line
        rank_cli(sys.argv[2], sys.argv[3:])
    else:
        main()
