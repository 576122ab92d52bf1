"""Tacotron training loop (counterpart of `tacotron2_tpu/training/tacotron_train.py`).

The `logs-<name>/` layout (taco_pretrained/, plots/, wavs/, mel-spectrograms/,
eval-dir/), CharacterEmbeddings.tsv, restore-or-create, rolling sec/step and loss
windows of 100, the loss-explosion abort (NaN or above 100), the summary, eval and
checkpoint intervals (and a checkpoint at step 300 and at the last step), the eval
losses averaged over the test batches, and the artifacts of sample 0: from each eval
the Griffin-Lim wavs from the predicted mel and linear spectrograms, from each
checkpoint the predicted mel as .npy and its Griffin-Lim wav (on the device with
hp.GL_on_GPU, `ops/dsp.py`). Not ported: the alignment and spectrogram plots,
TensorBoard summaries, the embedding projector, the profiler trace and the Slack
webhook.

Under a process group (`parallel/distributed.py`) the loop runs data-parallel over
every rank, as the JAX loop runs over its mesh with a lead host
(`tacotron_train.py:118-144, 176, 251-257`): the state is broadcast from rank 0 at
start, each rank reads its rows of every train batch (the loader's process_shard) and
of every eval batch, the steps and the eval losses are the global batch's, and only
rank 0 writes checkpoints, wavs, mels and the log.

A step's dropout and zoneout masks and teacher-forcing coins come from a generator
seeded by (tacotron_random_seed, step), so a resumed run draws the masks of an
uninterrupted one; every eval draws its prenet masks and coins from the generator
seeded with tacotron_random_seed alone, as the JAX loop hands each eval its root key.
The loss of a step is read one step late, after the next step is dispatched, except
where an interval needs it at once (`common.StepLog`, which also says what a step's
logged time covers). Train and eval steps run in `common.resolve_compute_dtype`'s dtype:
bfloat16 on the card at the default hparams, float32 on the CPU.
"""

import importlib.util
import os
import time
import traceback
from typing import Dict

import numpy as np
import torch

from ..config import Hparams, hparams_debug_string
from ..data.loader import Prefetcher, TacotronDataset
from ..infolog import log
from ..ops import audio, dsp
from ..parallel import distributed, mesh as mesh_lib
from ..text import sequence_to_text, symbols
from . import tacotron_trainer as tt
from .checkpointing import CheckpointManager
from .common import StepLog, resolve_compute_dtype, step_seed, to_device

EVAL_LOSSES = ('loss', 'before_loss', 'after_loss', 'stop_token_loss', 'linear_loss')


def add_embedding_tsv(log_dir: str) -> str:
    """Character embedding metadata for a projector (`tacotron_train.py:43-52`)."""
    path = os.path.join(log_dir, 'CharacterEmbeddings.tsv')
    if not os.path.isfile(path):
        with open(path, 'w', encoding='utf-8') as f:
            for symbol in symbols:
                f.write('{}\n'.format('\\s' if symbol == ' ' else symbol))
    return path


def run_eval(state, test_batches, hp: Hparams, step: int, eval_wav_dir: str,
             generator: torch.Generator, mesh=None) -> Dict[str, float]:
    """The eval losses averaged over the test batches, and the wavs of sample 0 of the
    last batch (`tacotron_train.py:241-296`). Under a `mesh` every rank runs it on its
    rows of each batch (the losses the global batch's); rank 0 writes the wavs."""
    log('\nRunning evaluation at step {}'.format(step))
    sums = {k: 0.0 for k in EVAL_LOSSES}
    for tb in test_batches:
        generator.manual_seed(hp.tacotron_random_seed)
        m = tt.eval_step(state, tb, hp, generator, mesh=mesh)
        for k in EVAL_LOSSES:
            sums[k] += float(m[k])
    avgs = {k: v / len(test_batches) for k, v in sums.items()}
    log('Eval losses: ' + ', '.join(f'{k}={v:.5f}' for k, v in avgs.items()))
    if not distributed.is_lead():
        return avgs
    mel_len = int(tb['targets_lengths'][0])
    audio.save_wav(dsp.gl_invert(m['mel_outputs'][0][:mel_len], hp),
                   os.path.join(eval_wav_dir, f'step-{step}-eval-wave-from-mel.wav'),
                   sr=hp.sample_rate)
    if 'linear_outputs' in m:
        audio.save_wav(dsp.gl_invert(m['linear_outputs'][0][:mel_len], hp, linear=True),
                       os.path.join(eval_wav_dir, f'step-{step}-eval-wave-from-linear.wav'),
                       sr=hp.sample_rate)
    return avgs


def save_checkpoint_artifacts(state, ckpt: CheckpointManager, batch, hp: Hparams, step: int,
                              wav_dir: str, mel_dir: str, generator: torch.Generator,
                              mesh=None):
    """The checkpoint, then the eval pass over the last train batch: sample 0's
    predicted mel as .npy and its Griffin-Lim wav (`tacotron_train.py:299-329`). Under
    a `mesh` every rank runs the pass on its rows; rank 0 writes."""
    log('\nSaving checkpoint + artifacts at step {}'.format(step))
    lead = distributed.is_lead()
    if lead:
        ckpt.save(step, state.state_dict())
    generator.manual_seed(hp.tacotron_random_seed)
    m = tt.eval_step(state, batch, hp, generator, mesh=mesh)
    if not lead:
        return
    mel_len = int(batch['targets_lengths'][0])
    mel_pred = m['mel_outputs'][0][:mel_len]
    np.save(os.path.join(mel_dir, f'mel-prediction-step-{step}.npy'),
            mel_pred.cpu().numpy(), allow_pickle=False)
    audio.save_wav(dsp.gl_invert(mel_pred, hp),
                   os.path.join(wav_dir, f'step-{step}-wave-from-mel.wav'), sr=hp.sample_rate)
    log('Input at step {}: {}'.format(step, sequence_to_text(batch['inputs'][0].tolist())))


def train(log_dir: str, args, hparams: Hparams, device) -> str:
    """Train the Tacotron of `hparams` on <base_dir>/<tacotron_input> up to
    args.tacotron_train_steps on `device`; returns the checkpoint directory."""
    hp = hparams
    device = torch.device(device)
    mesh = mesh_lib.make_mesh(hp, device) if distributed.process_shard() else None
    lead = distributed.is_lead()
    save_dir = os.path.join(log_dir, 'taco_pretrained')
    plot_dir = os.path.join(log_dir, 'plots')
    wav_dir = os.path.join(log_dir, 'wavs')
    mel_dir = os.path.join(log_dir, 'mel-spectrograms')
    eval_dir = os.path.join(log_dir, 'eval-dir')
    eval_wav_dir = os.path.join(eval_dir, 'wavs')
    for d in (save_dir, plot_dir, wav_dir, mel_dir, eval_dir,
              os.path.join(eval_dir, 'plots'), eval_wav_dir):
        os.makedirs(d, exist_ok=True)

    input_path = os.path.join(args.base_dir, args.tacotron_input)
    log('Checkpoint path: {}'.format(save_dir))
    log('Loading training data from: {}'.format(input_path))
    log('Using model: {}'.format(args.model))
    log(hparams_debug_string(hp))
    log('Plots skipped: the port writes no alignment or spectrogram plots{}'.format(
        '' if importlib.util.find_spec('matplotlib') else ' (and matplotlib is missing)'))
    np.random.seed(hp.tacotron_random_seed)

    # scheduled sampling is a fine-tune of a converged model: decaying the ratio early
    # in a run destroys free-running content while the teacher-forced loss looks fine
    if (hp.tacotron_teacher_forcing_mode == 'scheduled'
            and hp.tacotron_teacher_forcing_start_decay < 0.5 * args.tacotron_train_steps):
        log('WARNING: tacotron_teacher_forcing_start_decay={} is early in the '
            '{}-step budget. Scheduled sampling applied before the tfr=1.0 model '
            'converges DESTROYS free-run content while teacher-forced output stays '
            'deceptively fine. Decay only once eval loss has plateaued and free-run '
            'synthesis is already coherent.'.format(
                hp.tacotron_teacher_forcing_start_decay, args.tacotron_train_steps))

    dataset = TacotronDataset(input_path, hp, base_dir=os.path.dirname(input_path))
    log('Loaded metadata for {} examples ({:.2f} hours)'.format(len(dataset), dataset.hours))
    if lead:
        add_embedding_tsv(log_dir)

    state = tt.create_train_state(hp, device)
    log('Tacotron Parameters: {:.3f} Million.'.format(
        sum(p.numel() for p in state.model.parameters()) / 1e6))
    dtype = resolve_compute_dtype(hp, device)
    log('Compute dtype: {}'.format(dtype))
    if dtype != torch.float32:  # bf16 products accumulate in f32, as XLA's do
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    ckpt = CheckpointManager(save_dir, max_to_keep=20)
    if args.restore and ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore())
        log('Loading checkpoint at step {}'.format(state.step))
    else:
        log('Starting new training!')
    shard = None
    if mesh is not None:  # every rank from rank 0's fresh or restored state
        log('Data-parallel over {} ranks (mesh {}x{})'.format(
            mesh.layout.size, mesh.data_size, mesh.model_size))
        state.step = mesh_lib.broadcast_int(state.step, device)
        mesh_lib.replicate(list(state.model.state_dict().values()) + state.exp_avg
                           + state.exp_avg_sq)
        shard = (mesh.data_index, mesh.data_size)

    batches = Prefetcher(dataset.train_batches(seed=hp.tacotron_data_random_state,
                                               process_shard=shard), depth=8)
    test_batches = [to_device(mesh_lib.local_batch_slice(b, *shard) if shard else b, device)
                    for b in dataset.test_batches()]
    log(f'{len(test_batches)} eval batches prepared')
    generator = torch.Generator(device)  # reseeded each step by (seed, step)
    eval_generator = torch.Generator(device)

    step = state.step
    batch = None
    step_log = StepLog()

    try:
        while step < args.tacotron_train_steps:
            start = time.time()
            batch = to_device(next(batches), device)
            generator.manual_seed(step_seed(hp.tacotron_random_seed, state.step))
            metrics = tt.train_step(state, batch, hp, generator, mesh=mesh)
            step = state.step
            step_log.add(step, metrics, start)
            checkpoint_now = (step % args.checkpoint_interval == 0
                              or step in (300, args.tacotron_train_steps))
            if (step % args.summary_interval == 0 or checkpoint_now
                    or (test_batches and step % args.eval_interval == 0)):
                step_log.flush()

            if step % args.summary_interval == 0:
                log('\nStep {}: '.format(step) + ', '.join(
                    '{}={:.5f}'.format(k, float(metrics[k])) for k in (
                        'loss', 'before_loss', 'after_loss', 'stop_token_loss',
                        'regularization_loss', 'linear_loss', 'grad_norm'))
                    + ', learning_rate={:.3e}, teacher_forcing_ratio={:.3f}'.format(
                        metrics['learning_rate'], metrics['teacher_forcing_ratio']))

            if step % args.eval_interval == 0 and test_batches:
                run_eval(state, test_batches, hp, step, eval_wav_dir, eval_generator, mesh)

            if checkpoint_now:
                save_checkpoint_artifacts(state, ckpt, batch, hp, step, wav_dir, mel_dir,
                                          eval_generator, mesh)

        step_log.flush()
        log('Tacotron training complete after {} global steps!'.format(
            args.tacotron_train_steps))
        return save_dir
    except Exception as e:
        log('Exiting due to exception: {}'.format(e))
        traceback.print_exc()
        raise
    finally:
        batches.close()
