"""WaveNet training loop (counterpart of `tacotron2_tpu/training/wavenet_train.py`).

Restore-or-create with the EMA weights in the checkpoint, the weight-norm
data-dependent init on a fresh run, rolling sec/step and loss windows, the
loss-explosion abort, summary / eval / checkpoint intervals, the teacher-forced eval
over the whole test split, the autoregressive natural eval on the EMA weights (through
the hand-written AR kernel on a CUDA device) with its record in the eval-history
sidecar, and the teacher-forced pred / real wavs. Not ported: the waveplots (the port
has no plot module), TensorBoard summaries, the speaker-embedding projector, the
profiler trace, the multi-process batch shard and the Slack webhook.

The loss of a step is read one step late, after the next step is dispatched, as the JAX
loop does (`wavenet_train.py:272-317`): the read then waits for a step that has long
finished while the device works on the next. It is read at once where an interval
(summary, eval, checkpoint, the last step) needs it. Nothing else in the step loop
reads a device value.
"""

import os
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Hparams, hparams_debug_string
from ..data.loader import Prefetcher
from ..data.wavenet_loader import WaveNetDataset
from ..inference import wavenet_synthesizer
from ..infolog import log
from ..models.wavenet import distributions as dist_mod
from ..ops import audio, wavenet_ar
from ..ops.mcd import mel_centroids
from ..ops.mulaw import inv_mulaw, inv_mulaw_quantize, is_mulaw, is_mulaw_quantize
from ..utils import ValueWindow
from . import checkpoint_select, weight_norm_init
from . import wavenet_trainer as wt
from .checkpointing import CheckpointManager


def _to_waveform(y: np.ndarray, hp: Hparams) -> np.ndarray:
    """Model-domain audio -> float waveform."""
    if is_mulaw_quantize(hp.input_type):
        return inv_mulaw_quantize(y, hp.quantize_channels)
    if is_mulaw(hp.input_type):
        return inv_mulaw(y, hp.quantize_channels)
    return y


def save_log(step: int, batch: Dict[str, torch.Tensor], y_hat: torch.Tensor, hp: Hparams,
             wav_dir: str) -> None:
    """Teacher-forced prediction against its target for the batch's first row, as
    `step-{step}-pred.wav` and `-real.wav` (`wavenet_train.py:56-75`, without the
    waveplot): the displayed prediction is the distribution's mode (arg-max class, the
    Gaussian mean, the mean of the most probable mixture)."""
    params = y_hat[0].float().cpu().numpy()
    target = batch['audio'][0].cpu().numpy()
    L = int(batch['input_lengths'][0])
    if is_mulaw_quantize(hp.input_type):
        pred = params.argmax(axis=-1)
    elif hp.out_channels == 2:
        pred = params[:, 0]
    else:
        nr = hp.out_channels // 3
        k = params[:, :nr].argmax(axis=-1)
        pred = np.take_along_axis(params[:, nr:2 * nr], k[:, None], axis=1)[:, 0]
    audio.save_wav(_to_waveform(pred[:L], hp),
                   os.path.join(wav_dir, f'step-{step}-pred.wav'), hp.sample_rate)
    audio.save_wav(_to_waveform(target[:L], hp),
                   os.path.join(wav_dir, f'step-{step}-real.wav'), hp.sample_rate)


def ar_conditioning_r(pred_wav: np.ndarray, cond: np.ndarray, hp: Hparams) -> Optional[float]:
    """Correlation between the spectral-centroid track of the generated audio's own
    mel and the conditioning mel's (`wavenet_train.py:155-181`): a free-running model
    can stop following its conditioning while the teacher-forced loss stays healthy.
    `cond` is the (frames, num_mels) conditioning as the model saw it, in [0, 1] where
    normalize_for_wavenet. None (with a logged reason) on fewer than 8 frames or a flat
    track."""
    w = audio.preemphasis(pred_wav, hp.preemphasis, hp.preemphasize)
    if hp.rescale:
        w = w / max(float(np.abs(w).max()), 1e-9) * hp.rescaling_max
    gen_mel = audio.melspectrogram(np.asarray(w, np.float32), hp).T
    lo, hi = ((-hp.max_abs_value, hp.max_abs_value) if hp.symmetric_mels
              else (0.0, hp.max_abs_value))
    cond_mel = cond * (hi - lo) + lo if hp.normalize_for_wavenet else cond
    T = min(len(gen_mel), len(cond_mel))
    cen_g, _ = mel_centroids(gen_mel[:T], hp)
    cen_c, _ = mel_centroids(cond_mel[:T], hp)
    if T >= 8 and np.std(cen_g) > 1e-6 and np.std(cen_c) > 1e-6:
        return float(np.corrcoef(cen_g, cen_c)[0, 1])
    log('AR conditioning metric skipped: {} frames, centroid std (gen {:.2g}, cond '
        '{:.2g}): needs >=8 frames and a time-varying conditioning trajectory'.format(
            T, float(np.std(cen_g)), float(np.std(cen_c))))
    return None


def eval_step(ema_model, batch: Dict[str, torch.Tensor], hp: Hparams, eval_wav_dir: str,
              step: int) -> Dict[str, float]:
    """Full autoregressive generation on the batch's first utterance with the EMA
    weights (`wavenet_train.py:78-190`), the noise seeded with the step. With
    hp.wavenet_natural_eval the generation is scored against the ground truth,
    unshifted (the params of step t predict sample t): from the params the AR launch
    returns, or, for a big-vocab categorical model, whose (1, T, Q) params are never
    built, from the per-step NLL the launch computes in place (`y_eval`). Returns the
    metrics for the eval-history sidecar."""
    metrics = {}
    device = batch['audio'].device
    c = batch.get('mel_conditions')
    g = batch.get('speaker_ids')
    L = int(batch['input_lengths'][0])
    c1 = c[:1] if c is not None else None
    g1 = g[:1] if g is not None else None
    generator = torch.Generator(device).manual_seed(step)
    in_kernel_nll = (hp.wavenet_natural_eval and c1 is not None
                     and wavenet_ar.is_big_vocab(hp))
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    start = time.time()
    if in_kernel_nll:
        out = wavenet_synthesizer.generate(ema_model, hp, generator, c1, g1,
                                           return_params=False, y_eval=batch['audio'][:1])
    else:
        out = wavenet_synthesizer.generate(
            ema_model, hp, generator, c1, g1,
            synthesis_length=None if c1 is not None else L,
            return_params=hp.wavenet_natural_eval)
    audio_out = out['audio'][0].cpu().numpy()  # waits for the launch
    elapsed = time.time() - start
    metrics['gen_samples_per_sec'] = len(audio_out) / max(elapsed, 1e-6)
    log('Eval generation: {} samples in {:.3f} sec ({:.1f} samples/sec)'.format(
        len(audio_out), elapsed, metrics['gen_samples_per_sec']))

    if hp.wavenet_natural_eval and 'nll' in out:
        m = (torch.arange(out['nll'].shape[1], device=device)[None, :] < L).float()
        nat = float(torch.sum(out['nll'] * m) / torch.clamp(torch.sum(m), min=1.0))
        metrics['natural_loss'] = nat
        log('Eval (natural) loss: {:.5f} (in-kernel)'.format(nat))
    elif hp.wavenet_natural_eval:
        y = batch['audio'][:1, :out['params'].shape[1]]
        m = (torch.arange(y.shape[1], device=device)[None, :] < L).float()
        if is_mulaw_quantize(hp.input_type):
            nat = dist_mod.masked_cross_entropy_loss(out['params'], y, m)
        elif hp.out_channels == 2:
            nat = dist_mod.gaussian_mle_loss(out['params'], y, hp.quantize_channels,
                                             hp.log_scale_min_gauss, hp.cdf_loss, m)
        else:
            nat = dist_mod.discretized_mix_logistic_loss(out['params'], y,
                                                         hp.quantize_channels,
                                                         hp.log_scale_min, m)
        metrics['natural_loss'] = float(nat)
        log('Eval (natural) loss: {:.5f}'.format(float(nat)))

    pred_wav = _to_waveform(audio_out[:L], hp)
    target_wav = _to_waveform(batch['audio'][0, :L].cpu().numpy(), hp)
    if c1 is not None:
        try:
            r = ar_conditioning_r(pred_wav, c1[0].float().cpu().numpy(), hp)
            if r is not None:
                metrics['ar_conditioning_r'] = r
                log('Eval AR conditioning centroid-r: {:.4f}'.format(r))
        except Exception as e:  # observability must never kill training
            log('AR conditioning metric skipped: {}'.format(e))
    audio.save_wav(pred_wav, os.path.join(eval_wav_dir, f'step-{step}-pred.wav'),
                   hp.sample_rate)
    audio.save_wav(target_wav, os.path.join(eval_wav_dir, f'step-{step}-real.wav'),
                   hp.sample_rate)
    return metrics


def train(log_dir: str, args, hparams: Hparams, input_path: str, device) -> str:
    """Train the WaveNet of `hparams` on the metadata file `input_path` up to
    args.wavenet_train_steps on `device`; returns the checkpoint directory."""
    hp = hparams
    device = torch.device(device)
    save_dir = os.path.join(log_dir, 'wave_pretrained')
    wav_dir = os.path.join(log_dir, 'wavs')
    eval_wav_dir = os.path.join(log_dir, 'eval-dir', 'wavs')
    for d in (save_dir, wav_dir, eval_wav_dir):
        os.makedirs(d, exist_ok=True)

    log('Checkpoint_path: {}'.format(save_dir))
    log('Loading training data from: {}'.format(input_path))
    log(hparams_debug_string(hp))

    np.random.seed(hp.wavenet_random_seed)
    dataset = WaveNetDataset(input_path, hp, base_dir=args.base_dir)
    log('{} train examples, {} test steps'.format(len(dataset), dataset.test_steps))

    # Short-run EMA guard: with decay d over N steps the EMA still holds d**N of the
    # random init, and AR eval and synthesis run on the EMA weights.
    ema_horizon = args.wavenet_train_steps * (1.0 - hp.wavenet_ema_decay)
    if ema_horizon < 5.0:
        suggested = max(0.5, 1.0 - 10.0 / max(args.wavenet_train_steps, 1))
        log('WARNING: wavenet_ema_decay={} leaves the EMA shadow init-dominated '
            'after {} steps (init fraction ~{:.0%}). AR eval / synthesis uses EMA '
            'weights; for short runs pass wavenet_ema_decay<={:.4g}.'.format(
                hp.wavenet_ema_decay, args.wavenet_train_steps,
                hp.wavenet_ema_decay ** max(args.wavenet_train_steps, 1), suggested))

    state = wt.create_train_state(hp, device)
    n_params = sum(p.numel() for p in state.model.parameters())
    log('WaveNet Parameters: {:.3f} Million.'.format(n_params / 1e6))

    ckpt = CheckpointManager(save_dir, max_to_keep=20)
    if args.restore and ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore())
        log('Restored WaveNet checkpoint at step {}'.format(state.step))
        dropped = checkpoint_select.truncate_eval_history(save_dir, state.step)
        if dropped:
            log('Dropped {} eval records past the restored step'.format(dropped))
    else:
        log('Starting new WaveNet training!')
        # a fresh run's records start at step 0: none of an earlier run may win `best`
        dropped = checkpoint_select.truncate_eval_history(save_dir, 0)
        if dropped:
            log('Dropped {} eval records of an earlier run'.format(dropped))
        if hp.wavenet_weight_normalization:
            log('Running weight-norm data-dependent initialization..')
            example = next(dataset.train_batches(seed=hp.wavenet_data_random_state,
                                                 group_batches=2))
            weight_norm_init.data_dependent_init(state.model, wt.to_device(example, device),
                                                 hp)
            state = wt.state_from_model(state.model)

    time_window, loss_window = ValueWindow(100), ValueWindow(100)
    batches = Prefetcher(dataset.train_batches(seed=hp.wavenet_data_random_state), depth=8)
    test_batches = [wt.to_device(b, device) for b in dataset.test_batches()]
    generator = torch.Generator(device)  # reseeded each step by (seed, step)

    step = state.step
    pending = None  # (step, metrics, start time) of the step whose loss is not read yet

    def resolve(p):
        p_step, p_metrics, p_start = p
        loss = float(p_metrics['loss'])
        time_window.append(time.time() - p_start)
        loss_window.append(loss)
        log('Step {:7d} [{:.3f} sec/step, loss={:.5f}, avg_loss={:.5f}]'.format(
            p_step, time_window.average, loss, loss_window.average), end='\r')
        if np.isnan(loss) or loss > 100.0:
            log('Loss exploded to {:.5f} at step {}'.format(loss, p_step))
            raise RuntimeError('Loss exploded')

    try:
        while step < args.wavenet_train_steps:
            start = time.time()
            batch = wt.to_device(next(batches), device)
            generator.manual_seed(wt.step_seed(hp.wavenet_random_seed, state.step))
            metrics = wt.train_step(state, batch, hp, generator)
            step = state.step
            if pending is not None:
                resolve(pending)
            pending = (step, metrics, start)
            if (step % args.summary_interval == 0
                    or (test_batches and step % args.eval_interval == 0)
                    or step % args.checkpoint_interval == 0
                    or step == args.wavenet_train_steps):
                resolve(pending)
                pending = None

            if step % args.summary_interval == 0:
                log('\nStep {}: loss={:.5f}, grad_norm={:.5f}, learning_rate={:.3e}'.format(
                    step, float(metrics['loss']), float(metrics['grad_norm']),
                    metrics['learning_rate']))

            if step % args.eval_interval == 0 and test_batches:
                log('\nEvaluating at step {}'.format(step))
                tf_losses = [float(wt.eval_teacher_forced_step(state, tb, hp)['loss'])
                             for tb in test_batches]
                eval_loss = float(np.mean(tf_losses))
                log('Eval (teacher-forced) loss: {:.5f} over {} batches'.format(
                    eval_loss, len(tf_losses)))
                # rotate through the split so successive evals score other utterances
                tb = test_batches[(step // args.eval_interval) % len(test_batches)]
                em = eval_step(state.ema_model, tb, hp, eval_wav_dir, step)
                checkpoint_select.append_eval_record(
                    save_dir, dict(step=step, teacher_forced_loss=eval_loss, **em))

            if step % args.checkpoint_interval == 0 or step == args.wavenet_train_steps:
                log('\nSaving checkpoint at step {}'.format(step))
                ckpt.save(step, state.state_dict())
                m = wt.eval_teacher_forced_step(state, batch, hp)
                save_log(step, batch, m['y_hat'], hp, wav_dir)

        if pending is not None:
            resolve(pending)
        log('WaveNet training complete after {} global steps!'.format(
            args.wavenet_train_steps))
        return save_dir
    except Exception as e:
        log('Exiting due to exception: {}'.format(e))
        traceback.print_exc()
        raise
    finally:
        batches.close()
