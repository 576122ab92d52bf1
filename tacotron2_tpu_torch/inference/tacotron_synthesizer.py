"""Tacotron batch inference (counterpart of `tacotron2_tpu/inference/tacotron_synthesizer.py`).

Modes:
  - eval: text sentences -> mels (+ linear), Griffin-Lim wavs, eval/map.txt
  - synthesis (GTA or natural): the whole train.txt -> mel npys + gta/map.txt, the
    bridge that feeds WaveNet training
  - live: REPL synthesis with immediate Griffin-Lim playback artifacts

`Synthesizer.synthesize` is the free-running decode that leaves the mel on the device
(the in-memory Tacotron-2 path and streaming); `Synthesizer.synthesize_batch` is the
JAX `Synthesizer.synthesize`: a batch to mel files, teacher-forced on the target mels
(GTA) or free-running. Each batch draws its prenet masks from a generator seeded with
hp.tacotron_random_seed, as the JAX one takes PRNGKey(tacotron_random_seed) for each
batch, so a rerun writes the same mels. No alignment or spectrogram plots: the port has
no plot module (its machine lacks matplotlib).
"""

import os
import shutil
import subprocess
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from ..convert import load_tacotron
from ..infolog import log
from ..models.tacotron.model import Tacotron, output_range
from ..ops import audio, dsp
from ..text import text_to_sequence
from ..utils import round_up


class Synthesizer:
    def __init__(self, model: Tacotron, hp, device, gta: bool = False):
        self._model = model.eval()
        self._hp = hp
        self._device = torch.device(device)
        self.gta = gta
        self._cleaners = [c.strip() for c in hp.cleaners.split(',')]
        self._pad_value = -hp.max_abs_value if hp.symmetric_mels else 0.0

    def _prepare_text_batch(self, texts: Sequence[str]) -> Tuple[List[str], np.ndarray,
                                                                 np.ndarray]:
        """Pad the batch to the synthesis batch size by repeating the last text, and
        round T_in up to pad_text_multiple (tacotron_synthesizer.py:87-100)."""
        hp = self._hp
        bs = hp.tacotron_synthesis_batch_size
        texts = list(texts)
        if len(texts) < bs:
            texts = texts + [texts[-1]] * (bs - len(texts))
        seqs = [np.asarray(text_to_sequence(t, self._cleaners), np.int64) for t in texts]
        input_lengths = np.asarray([len(s) for s in seqs], np.int64)
        T_in = round_up(int(input_lengths.max()), hp.pad_text_multiple)
        inputs = np.stack([np.pad(s, (0, T_in - len(s))) for s in seqs])
        return texts, inputs, input_lengths

    def _tensors(self, inputs: np.ndarray, input_lengths: np.ndarray) -> Tuple[Tensor, Tensor]:
        return (torch.from_numpy(inputs).to(self._device),
                torch.from_numpy(input_lengths).to(self._device))

    def synthesize(self, texts: Sequence[str], generator: torch.Generator
                   ) -> Tuple[Tensor, List[int], int]:
        """Free-running decode of a batch.

        Returns (mel, lengths, decoded_frames): mel is the (len(texts), T, num_mels)
        output clipped to [lo, hi] and left on the device, padded to the decode
        length; lengths are the per-text frame counts from the stop tokens;
        decoded_frames counts every frame the decoder computed, padding rows included."""
        hp = self._hp
        n_real = len(texts)
        _, inputs, input_lengths = self._prepare_text_batch(texts)
        out = self._model(*self._tensors(inputs, input_lengths), max_iters=hp.max_iters,
                          generator=generator)
        stop_logits = out['stop_token_prediction'].cpu().numpy()
        lengths = self._get_output_lengths(stop_logits)
        lo, hi = output_range(hp)
        mel = torch.clamp(out['mel_outputs'][:n_real], lo, hi)
        return mel, lengths[:n_real], int(np.prod(stop_logits.shape))

    def gta_targets(self, mel_filenames: Sequence[str]) -> Tuple[np.ndarray, List[int]]:
        """The target mels of a GTA batch, padded with the pad value to
        round_up(round_up(max_len, r), round_up(pad_mel_multiple, r)) frames
        (tacotron_synthesizer.py:137-145), and their lengths."""
        hp = self._hp
        r = hp.outputs_per_step
        mels = [np.load(f) for f in mel_filenames]
        target_lengths = [len(m) for m in mels]
        T_out = round_up(round_up(max(target_lengths), r), round_up(hp.pad_mel_multiple, r))
        mel_targets = np.stack([
            np.pad(m, [(0, T_out - len(m)), (0, 0)], constant_values=self._pad_value)
            for m in mels]).astype(np.float32)
        return mel_targets, target_lengths

    @torch.no_grad()
    def synthesize_batch(self, texts: Sequence[str], basenames: Sequence[str],
                         out_dir: Optional[str], log_dir: Optional[str],
                         mel_filenames: Optional[Sequence[str]],
                         generator: torch.Generator) -> List[Union[str, np.ndarray]]:
        """Synthesize a batch (tacotron_synthesizer.py:127-200): GTA on the target mels
        of `mel_filenames` (teacher forcing ratio 1, deterministic, no linear; the
        output lengths the targets'), or free-running with the lengths from the stop
        tokens. Each mel is clipped to the output range and written to
        `out_dir/mel-<basename>.npy` (or returned where out_dir is None); with
        `log_dir`, its Griffin-Lim wav goes to `log_dir/wavs/wav-<basename>-mel.wav`,
        and the linear one's to `-linear.wav` where the model predicts linear
        spectrograms. `generator` is reseeded with hp.tacotron_random_seed first.
        Returns the mel paths (or arrays), one for each text."""
        hp = self._hp
        generator.manual_seed(hp.tacotron_random_seed)
        n_real = len(texts)
        texts, inputs, input_lengths = self._prepare_text_batch(texts)
        x, x_lengths = self._tensors(inputs, input_lengths)
        if self.gta:
            # the padding rows repeat the last target too
            mel_filenames = list(mel_filenames) + [mel_filenames[-1]] * (len(texts) - n_real)
            mel_targets, out_lengths = self.gta_targets(mel_filenames)
            B, T_in = inputs.shape
            noise = self._model.draw_noise(B, T_in, mel_targets.shape[1], generator, True,
                                           self._device)
            out = self._model.teacher_forced(
                x, x_lengths, torch.from_numpy(mel_targets).to(self._device), noise,
                deterministic=True, teacher_forcing_ratio=1.0, predict_linear=False)
        else:
            out = self._model(x, x_lengths, max_iters=hp.max_iters, generator=generator,
                              predict_linear=self._model.hp.predict_linear)
            out_lengths = self._get_output_lengths(out['stop_token_prediction'].cpu().numpy())

        # clip to the model's output range (reference synthesizer.py:160)
        lo, hi = output_range(hp)
        mels_out = torch.clamp(out['mel_outputs'], lo, hi)
        mels_host = mels_out.cpu().numpy()
        linears = out.get('linear_outputs')

        saved = []
        for i, basename in enumerate(basenames[:n_real]):  # drop the padding rows
            L = int(out_lengths[i])
            mel = mels_host[i][:L]
            if out_dir is not None:
                mel_path = os.path.join(out_dir, 'mel-{}.npy'.format(basename))
                np.save(mel_path, mel, allow_pickle=False)
                saved.append(mel_path)
            else:
                saved.append(mel)
            if log_dir is not None:
                audio.save_wav(dsp.gl_invert(mels_out[i][:L], hp), os.path.join(
                    log_dir, 'wavs/wav-{}-mel.wav'.format(basename)), sr=hp.sample_rate)
                if linears is not None:
                    lin = torch.clamp(linears[i][:L], lo, hi)
                    audio.save_wav(dsp.gl_invert(lin, hp, linear=True), os.path.join(
                        log_dir, 'wavs/wav-{}-linear.wav'.format(basename)),
                        sr=hp.sample_rate)
        return saved

    def _get_output_lengths(self, stop_logits: np.ndarray) -> List[int]:
        """First frame whose stop probability exceeds 0.5, floored at 4*r frames
        (tacotron_synthesizer.py:216-225)."""
        with np.errstate(over='ignore'):  # suppressed stops: exp(-logit) -> inf, p -> 0
            probs = 1.0 / (1.0 + np.exp(-stop_logits))
        lengths = []
        for row in probs:
            idx = np.where(row > 0.5)[0]
            n = int(idx[0]) + 1 if len(idx) else len(row)
            lengths.append(max(n, 4 * self._hp.outputs_per_step))
        return lengths


def load_synthesizer(checkpoint: str, hparams, device, gta: bool = False,
                     step=None) -> Synthesizer:
    """The Synthesizer of the Tacotron that `convert.load_tacotron` finds at
    `checkpoint` (a trainer's `taco_pretrained` directory or a converted file), on
    `device`."""
    log('Constructing model: Tacotron')
    return Synthesizer(load_tacotron(checkpoint, hparams, step).to(device), hparams,
                       device, gta=gta)


def run_eval(args, checkpoint_dir, output_dir, hparams, sentences, device):
    """Sentences -> `output_dir/eval/mel-batch_{i}_sentence_{j}.npy`, `eval/map.txt`
    rows `text|mel_path`, and Griffin-Lim wavs under `output_dir/logs-eval/wavs/`
    (tacotron_synthesizer.py:228-249). Returns the eval directory."""
    eval_dir = os.path.join(output_dir, 'eval')
    log_dir = os.path.join(output_dir, 'logs-eval')
    os.makedirs(eval_dir, exist_ok=True)
    os.makedirs(os.path.join(log_dir, 'wavs'), exist_ok=True)
    os.makedirs(os.path.join(log_dir, 'plots'), exist_ok=True)

    synth = load_synthesizer(checkpoint_dir, hparams, device,
                             step=getattr(args, 'tacotron_checkpoint_step', None))
    generator = torch.Generator(torch.device(device))
    bs = hparams.tacotron_synthesis_batch_size
    log('Starting Synthesis (plots skipped: the port writes no plots)')
    with open(os.path.join(eval_dir, 'map.txt'), 'w', encoding='utf-8') as f:
        for i in range(0, len(sentences), bs):
            start = time.time()
            batch = list(sentences[i:i + bs])
            basenames = ['batch_{}_sentence_{}'.format(i // bs, j) for j in range(len(batch))]
            mel_paths = synth.synthesize_batch(batch, basenames, eval_dir, log_dir, None,
                                               generator)
            for text, path in zip(batch, mel_paths):
                f.write('{}|{}\n'.format(text, path))
            log('Synthesized batch {} in {:.3f} sec'.format(i // bs, time.time() - start))
    log('synthesized mel spectrograms at {}'.format(eval_dir))
    return eval_dir


def run_synthesis(args, checkpoint_dir, output_dir, hparams, device):
    """GTA (or natural, --GTA False) synthesis over the whole training set ->
    `output_dir/gta/` (or `natural/`) mels and a `map.txt` of
    `wav_path|mel_fn|out_path|<no_g>|text` rows (tacotron_synthesizer.py:252-291).
    Returns the path of that map.txt."""
    gta = args.GTA == 'True'
    synth_dir = os.path.join(output_dir, 'gta' if gta else 'natural')
    os.makedirs(synth_dir, exist_ok=True)

    input_dir = args.input_dir if os.path.isabs(args.input_dir) else \
        os.path.join(getattr(args, 'base_dir', ''), args.input_dir)
    metadata_filename = os.path.join(input_dir, 'train.txt')
    with open(metadata_filename, encoding='utf-8') as f:
        metadata = [line.strip().split('|') for line in f]
    frame_shift_ms = hparams.get_hop_size() / hparams.sample_rate
    hours = sum(int(x[4]) for x in metadata) * frame_shift_ms / 3600
    log('Loaded metadata for {} examples ({:.2f} hours)'.format(len(metadata), hours))

    synth = load_synthesizer(checkpoint_dir, hparams, device, gta=gta,
                             step=getattr(args, 'tacotron_checkpoint_step', None))
    generator = torch.Generator(torch.device(device))
    bs = hparams.tacotron_synthesis_batch_size
    mel_dir = os.path.join(input_dir, 'mels')
    wav_dir = os.path.join(input_dir, 'audio')

    with open(os.path.join(synth_dir, 'map.txt'), 'w', encoding='utf-8') as f:
        for i in range(0, len(metadata), bs):
            start = time.time()
            rows = metadata[i:i + bs]
            texts = [m[5] for m in rows]
            mel_filenames = [os.path.join(mel_dir, m[1]) for m in rows]
            wav_paths = [os.path.join(wav_dir, m[0]) for m in rows]
            basenames = [os.path.basename(m).replace('.npy', '').replace('mel-', '')
                         for m in mel_filenames]
            out_paths = synth.synthesize_batch(texts, basenames, synth_dir, None,
                                               mel_filenames, generator)
            for wav_path, mel_fn, out_path, text in zip(wav_paths, mel_filenames,
                                                        out_paths, texts):
                f.write('{}|{}|{}|{}|{}\n'.format(wav_path, mel_fn, out_path, '<no_g>', text))
            log('Synthesized batch {}/{} in {:.3f} sec'.format(
                i // bs + 1, (len(metadata) + bs - 1) // bs, time.time() - start))
    log('synthesized mel spectrograms at {}'.format(synth_dir))
    return os.path.join(synth_dir, 'map.txt')


def play_audio(wav_path: str) -> bool:
    """Best-effort playback of a wav file through the OS audio stack
    (tacotron_synthesizer.py:294-323): the `sounddevice` package, else a common CLI
    player. Returns True if something played; the caller then only reports the path."""
    try:
        import sounddevice as sd
        from scipy.io import wavfile
        sr, data = wavfile.read(wav_path)
        if data.dtype.kind == 'i':
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        sd.play(data, sr, blocking=True)
        return True
    except Exception:  # any failure of the optional player means: try the next one
        pass
    for player in (['aplay', wav_path], ['afplay', wav_path],
                   ['ffplay', '-nodisp', '-autoexit', '-loglevel', 'quiet', wav_path]):
        if shutil.which(player[0]):
            try:
                subprocess.run(player, check=True, timeout=120,
                               stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                return True
            except (OSError, subprocess.SubprocessError):
                continue
    return False


def run_live(args, checkpoint_dir, hparams, device):
    """Interactive REPL synthesis (tacotron_synthesizer.py:326-346): each line of
    stdin -> `<base_dir>/live_out/wavs/wav-live_{i}-mel.wav` by Griffin-Lim, played
    where a player is found; EOF ends the session."""
    synth = load_synthesizer(checkpoint_dir, hparams, device,
                             step=getattr(args, 'tacotron_checkpoint_step', None))
    generator = torch.Generator(torch.device(device))
    out_dir = os.path.join(args.base_dir, 'live_out')
    os.makedirs(os.path.join(out_dir, 'wavs'), exist_ok=True)
    os.makedirs(os.path.join(out_dir, 'plots'), exist_ok=True)
    log('Live synthesis — enter text, ctrl-D to exit')
    i = 0
    try:
        while True:
            text = input('> ')
            if not text.strip():
                continue
            synth.synthesize_batch([text], [f'live_{i}'], None, out_dir, None, generator)
            wav_path = '{}/wavs/wav-live_{}-mel.wav'.format(out_dir, i)
            log('wrote {}'.format(wav_path))
            if not play_audio(wav_path):
                log('(no audio device/player available — wav saved only)')
            i += 1
    except EOFError:
        log('live session done')


def tacotron_synthesize(args, hparams, checkpoint, sentences=None, device='cuda'):
    """args.mode eval, synthesis or live into `<base_dir>/tacotron_<output_dir>`
    (tacotron_synthesizer.py:349-356). Returns the eval directory, the synthesis
    map.txt, or None after a live session."""
    output_dir = os.path.join(getattr(args, 'base_dir', ''), 'tacotron_' + args.output_dir)
    if args.mode == 'eval':
        return run_eval(args, checkpoint, output_dir, hparams, sentences, device)
    if args.mode == 'synthesis':
        return run_synthesis(args, checkpoint, output_dir, hparams, device)
    return run_live(args, checkpoint, hparams, device)
