"""GTA, eval and live synthesis parity: the port's `inference/tacotron_synthesizer.py`
(`run_synthesis`, `run_eval`, `run_live`) and `synthesize --model Tacotron` against the
JAX package's, fp32 on the CPU at the TINY widths of test_torch_tacotron.py with the
corpus hparams of test_torch_tacotron_train.py.

A seeded flax Tacotron (every leaf seeded numpy noise) is saved as a JAX checkpoint
(orbax) and, converted (`convert.tacotron_train_state_from_jax`), as the port's trainer
checkpoint; both synthesizers then run over the same corpus. The prenet masks are
shared: GTA's by patching the port's `Tacotron.draw_noise` to return the draws a jitted
JAX teacher-forced pass makes with the synthesizer's key (the `recorder` of
test_torch_tacotron_train.py), the free-running decoder's by regenerating the masks
`fd.synthesis_scan` draws from the key the JAX model hands it. Tolerances are stated in
each test.
"""

import argparse
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import synthesize as jsynthesize_cli
from tacotron2_tpu.config import default_hparams as jdefault_hparams
from tacotron2_tpu.inference import tacotron_synthesizer as jts
from tacotron2_tpu.models.tacotron.model import Tacotron as JTacotron
from tacotron2_tpu.ops import fused_decoder as jfd
from tacotron2_tpu.training import tacotron_trainer as jtt
from tacotron2_tpu.training.checkpointing import CheckpointManager as JCheckpointManager
from tacotron2_tpu.utils import runtime as jruntime
from tacotron2_tpu_torch import convert, synthesize
from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.inference import tacotron_synthesizer as ts
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.ops import audio
from tacotron2_tpu_torch.training.checkpointing import CheckpointManager

from test_torch_tacotron import TINY, jax_prenet_masks, push_stop_bias, randomize
from test_torch_tacotron_train import (CORPUS_HP, _as_numpy_state, _corpus, port_noise,
                                       recorder, recording)

assert recorder  # a fixture of this module too: it shares the JAX draws

HP = TINY + CORPUS_HP + ',tacotron_synthesis_batch_size=2'
SEED_STEP = 3
# GTA mels, port against JAX on the same weights, targets and prenet masks: read 1.8e-7
# at most over the cases below (mels clipped to +-4): the same f32 ops in another
# order. Held to 2e-5 of the largest magnitude, as the train tests hold theirs
GTA_TOL = 2e-5 * 4
# the free-running eval mels over 8 decoder steps (read 1.2e-7): the decoder feeds its
# own frames back, so rounding compounds; test_torch_tacotron.py holds the scan to 1e-4
NATURAL_TOL = 1e-4
# Griffin-Lim on the device's path (torch, GL_on_GPU) against the JAX package's
# (dsp_jax) of those mels: relative L2 distance of the int16 wavs, read 1.9e-5 to
# 5.1e-5 (mel and linear); near-zero bins take their phase from rounding, so
# test_torch_tacotron_train.py bounds the inversion alone at 3 iterations by 5e-3
GL_TOL = 5e-3


def _hps(extra=''):
    """(the JAX package's hparams, the port's) of HP + extra."""
    j, t = jdefault_hparams(), default_hparams()
    j.parse(HP + extra)
    t.parse(HP + extra)
    return j, t


def _checkpoints(root, jhp, hp, stop_push=0.0, seed=0):
    """A seeded flax Tacotron of `jhp` saved as the JAX package's checkpoint
    (`root/jax/taco_pretrained`) and as the port's (`root/port/taco_pretrained`), the
    stop projection's bias pushed by `stop_push`. Returns (the two directories, the
    flax variables)."""
    dummy = dict(inputs=np.zeros((1, 8), np.int32), input_lengths=np.ones((1,), np.int32),
                 mel_targets=np.zeros((1, jhp.outputs_per_step, jhp.num_mels), np.float32))
    template = jtt.create_train_state(jhp, jax.random.PRNGKey(0), dummy)
    v = randomize({'params': template.params, 'batch_stats': template.batch_stats},
                  np.random.default_rng(seed))
    v['params'] = push_stop_bias(v['params'], stop_push)
    state = jtt.TrainState(step=jnp.full((), SEED_STEP, jnp.int32), params=v['params'],
                           batch_stats=v['batch_stats'],
                           opt_state=jtt.make_optimizer(jhp).init(v['params']))
    jdir = os.path.join(root, 'jax', 'taco_pretrained')
    JCheckpointManager(jdir).save(SEED_STEP, state)
    pdir = os.path.join(root, 'port', 'taco_pretrained')
    port = convert.tacotron_train_state_from_jax(_as_numpy_state(state), hp)
    CheckpointManager(pdir).save(SEED_STEP, port.state_dict())
    return jdir, pdir, v


@pytest.fixture()
def jax_gta_draws(recorder, monkeypatch):
    """Patches the port's Tacotron.draw_noise so that each GTA batch gets the draws of a
    jitted JAX teacher-forced pass (ratio 1, deterministic, no linear) of its shape
    with the synthesizer's key, PRNGKey(tacotron_random_seed): yields a function that
    installs them for (jhp, variables) and returns the list of shapes drawn for."""
    seen = []

    def install(jhp, variables):
        model = JTacotron(jhp)
        variables = jax.tree_util.tree_map(jnp.asarray, variables)

        def fn(x, lengths, mel, rng):
            return model.apply(variables, x, lengths, mel_targets=mel, deterministic=True,
                               teacher_forcing_ratio=jnp.float32(1.0), predict_linear=False,
                               rngs={'dropout': rng, 'teacher': jax.random.fold_in(rng, 7)})
        run = recording(recorder, fn)

        def draw_noise(self, B, T_in, T_mel, generator, deterministic, device):
            assert deterministic and generator.initial_seed() == jhp.tacotron_random_seed
            _, draws = run(jnp.zeros((B, T_in), jnp.int32), jnp.full((B,), T_in, jnp.int32),
                           jnp.zeros((B, T_mel, jhp.num_mels), jnp.float32),
                           jax.random.PRNGKey(jhp.tacotron_random_seed))
            seen.append((B, T_in, T_mel))
            return port_noise(jhp, draws, train=False)

        monkeypatch.setattr(Tacotron, 'draw_noise', draw_noise)
        return seen
    return install


def _rows(path, root):
    with open(path, encoding='utf-8') as f:
        return [line.rstrip('\n').replace(root, '<out>') for line in f]


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize('r,predict_linear', [(2, True), (2, False), (1, False)])
def test_gta_synthesis_matches_jax(tmp_path, jax_gta_draws, r, predict_linear):
    """`run_synthesis` (--GTA True) of the port and of the JAX package over a corpus of
    5 utterances (6-29 frames, batches of 2, the last padded with its own copy) from
    the same checkpoint (a Tacotron with or without the CBHG: GTA predicts no linear),
    the port given the JAX prenet masks: the map.txt rows equal (wav_path|mel|gta
    mel|<no_g>|text) but for the output directory, and each GTA mel has its target's
    frame count, the same values within GTA_TOL and the output range."""
    jhp, hp = _hps(f',outputs_per_step={r},predict_linear={predict_linear}')
    root = str(tmp_path)
    meta = _corpus(os.path.join(root, 'data'), hp, n=5)
    jdir, pdir, v = _checkpoints(root, jhp, hp)
    seen = jax_gta_draws(jhp, v)
    args = argparse.Namespace(GTA='True', input_dir=os.path.dirname(meta), base_dir='')
    want_map = jts.run_synthesis(args, jdir, os.path.join(root, 'jax_out'), jhp)
    got_map = ts.run_synthesis(args, pdir, os.path.join(root, 'port_out'), hp, 'cpu')
    assert got_map == os.path.join(root, 'port_out', 'gta', 'map.txt')
    assert _rows(got_map, os.path.join(root, 'port_out')) == \
        _rows(want_map, os.path.join(root, 'jax_out'))
    assert len(seen) == 3 and all(b == 2 for b, _, _ in seen)
    assert {t % 16 for _, _, t in seen} == {0}  # round_up(pad_mel_multiple, r) = 16
    lo, hi = -hp.max_abs_value, hp.max_abs_value
    with open(meta, encoding='utf-8') as f:
        frames = {row.split('|')[1]: int(row.split('|')[4]) for row in f}
    worst = 0.0
    for row in _rows(got_map, os.path.join(root, 'port_out')):
        gt_mel, gta = row.split('|')[1:3]
        want = np.load(gta.replace('<out>', os.path.join(root, 'jax_out')))
        got = np.load(gta.replace('<out>', os.path.join(root, 'port_out')))
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (frames[os.path.basename(gt_mel)], hp.num_mels)
        assert got.min() >= lo and got.max() <= hi
        worst = max(worst, _max_abs(want, got))
    assert worst <= GTA_TOL, worst


def test_gta_padding_and_natural_lengths(tmp_path):
    """The GTA targets are padded with -max_abs_value (0 without symmetric_mels) to
    round_up(round_up(max_len, r), round_up(pad_mel_multiple, r)) frames, at r = 1, 2
    and 3; `run_synthesis --GTA False` writes `natural/` and takes each mel's length
    from the stop tokens: max_iters * r frames where they never fire, the 4r floor
    where they fire at once; a rerun writes the same mels (one seed a batch)."""
    from tacotron2_tpu.utils import round_up as jround_up
    jhp, hp = _hps()
    root = str(tmp_path)
    meta = _corpus(os.path.join(root, 'data'), hp, n=3)
    files = [os.path.join(root, 'data', 'mels', f'mel-{i}.npy') for i in range(3)]
    lens = [len(np.load(f)) for f in files]
    for r in (1, 2, 3):
        for symmetric in (True, False):
            h = hp.replace(outputs_per_step=r, symmetric_mels=symmetric)
            synth = ts.Synthesizer(Tacotron(h), h, 'cpu', gta=True)
            targets, got_lens = synth.gta_targets(files)
            T = jround_up(jround_up(max(lens), r), jround_up(h.pad_mel_multiple, r))
            assert got_lens == lens and targets.shape == (3, T, h.num_mels)
            pad = -h.max_abs_value if symmetric else 0.0
            for row, n in zip(targets, lens):
                assert (row[n:] == pad).all() and np.array_equal(row[:n], np.load(files[lens.index(n)]))
    args = argparse.Namespace(GTA='False', input_dir=os.path.dirname(meta), base_dir='')
    for push, want in ((-100.0, hp.max_iters * hp.outputs_per_step),
                       (100.0, 4 * hp.outputs_per_step)):
        _, pdir, _ = _checkpoints(os.path.join(root, str(push)), jhp, hp, stop_push=push)
        out = os.path.join(root, 'out', str(push))
        path = ts.run_synthesis(args, pdir, out, hp, 'cpu')
        assert path == os.path.join(out, 'natural', 'map.txt')
        with open(path, encoding='utf-8') as f:
            mels = [row.split('|')[2] for row in f]
        assert [np.load(m).shape for m in mels] == [(want, hp.num_mels)] * 3
        first = [np.load(m) for m in mels]
        ts.run_synthesis(args, pdir, out, hp, 'cpu')
        assert all(np.array_equal(a, np.load(m)) for a, m in zip(first, mels))


def _jax_dropout_key(jhp, variables, max_iters):
    """The key the JAX model hands fd.synthesis_scan for a free-running decode from
    PRNGKey(tacotron_random_seed) (the synthesizer's rngs), from an un-jitted apply."""
    seen, scan = {}, jfd.synthesis_scan

    def recording_scan(*args):
        seen['rng'] = args[8]
        return scan(*args)

    jfd.synthesis_scan = recording_scan
    try:
        rng = jax.random.PRNGKey(jhp.tacotron_random_seed)
        JTacotron(jhp).apply(jax.tree_util.tree_map(jnp.asarray, variables),
                             jnp.ones((2, 16), jnp.int32), jnp.full((2,), 16),
                             max_iters=max_iters, deterministic=True, predict_linear=False,
                             rngs={'dropout': rng, 'teacher': jax.random.fold_in(rng, 7)})
    finally:
        jfd.synthesis_scan = scan
    return seen['rng']


def _with_jax_masks(monkeypatch, jhp, variables):
    """The port's free-running decode gets the prenet masks the JAX one draws."""
    key = _jax_dropout_key(jhp, variables, 1)
    chunk = min(jhp.decoder_chunk_size, jhp.max_iters)
    forward = Tacotron.forward

    def with_masks(self, inputs, input_lengths, max_iters=None, generator=None, masks=None,
                   predict_linear=False):
        masks = jax_prenet_masks(jhp, key, inputs.shape[0], -(-max_iters // chunk), chunk)
        return forward(self, inputs, input_lengths, max_iters, generator, masks,
                       predict_linear)

    monkeypatch.setattr(Tacotron, 'forward', with_masks)


def _wav(path):
    return wavfile.read(path)[1].astype(np.float64)


SENTENCES = ['Hello world.', 'He reads books.', 'Yes.']


@pytest.mark.parametrize('predict_linear', [True, False])
def test_run_eval_matches_jax(tmp_path, monkeypatch, predict_linear):
    """`run_eval` over three sentences (batches of 2, stop tokens suppressed: 8 decoder
    steps each) from the same checkpoint with the same masks: the mels
    (`eval/mel-batch_{i}_sentence_{j}.npy`) within NATURAL_TOL of the JAX ones and
    `eval/map.txt` equal but for the directory. Griffin-Lim wavs in
    `logs-eval/wavs/`: with GL_on_GPU (the default, torch ops on the mel's device)
    within GL_TOL of the JAX package's (dsp_jax), the linear one too where the model
    predicts linear spectrograms; without it, equal to `ops/audio.inv_mel_spectrogram`
    of the written mel."""
    jhp, hp = _hps(f',predict_linear={predict_linear}')
    root = str(tmp_path)
    jdir, pdir, v = _checkpoints(root, jhp, hp, stop_push=-100.0)
    _with_jax_masks(monkeypatch, jhp, v)
    args = argparse.Namespace()
    want_dir = jts.run_eval(args, jdir, os.path.join(root, 'jax_out'), jhp, SENTENCES)
    got_dir = ts.run_eval(args, pdir, os.path.join(root, 'port_out'), hp, SENTENCES, 'cpu')
    rows = _rows(os.path.join(got_dir, 'map.txt'), os.path.join(root, 'port_out'))
    assert rows == _rows(os.path.join(want_dir, 'map.txt'), os.path.join(root, 'jax_out'))
    assert [r.split('|')[0] for r in rows] == SENTENCES
    names = ['batch_0_sentence_0', 'batch_0_sentence_1', 'batch_1_sentence_0']
    for name in names:
        want = np.load(os.path.join(want_dir, f'mel-{name}.npy'))
        got = np.load(os.path.join(got_dir, f'mel-{name}.npy'))
        assert got.shape == want.shape == (hp.max_iters * hp.outputs_per_step, hp.num_mels)
        assert _max_abs(want, got) <= NATURAL_TOL
        kinds = ('mel', 'linear') if predict_linear else ('mel',)
        assert sorted(os.listdir(os.path.join(root, 'port_out', 'logs-eval', 'wavs'))) == \
            sorted(os.listdir(os.path.join(root, 'jax_out', 'logs-eval', 'wavs')))
        for kind in kinds:
            w = _wav(os.path.join(root, 'jax_out', 'logs-eval', 'wavs', f'wav-{name}-{kind}.wav'))
            g = _wav(os.path.join(root, 'port_out', 'logs-eval', 'wavs', f'wav-{name}-{kind}.wav'))
            assert g.shape == w.shape and np.linalg.norm(g - w) <= GL_TOL * np.linalg.norm(w)
    host = hp.replace(GL_on_GPU=False)
    out = os.path.join(root, 'host_out')
    ts.run_eval(args, pdir, out, host, SENTENCES[:1], 'cpu')
    mel = np.load(os.path.join(out, 'eval', 'mel-batch_0_sentence_0.npy'))
    ref = os.path.join(root, 'ref.wav')
    audio.save_wav(audio.inv_mel_spectrogram(mel.T, host), ref, sr=hp.sample_rate)
    assert np.array_equal(_wav(os.path.join(out, 'logs-eval', 'wavs',
                                            'wav-batch_0_sentence_0-mel.wav')), _wav(ref))


def test_run_live(tmp_path, monkeypatch):
    """`run_live` reads stdin: two lines, a blank one skipped between them, then EOF;
    it writes `<base_dir>/live_out/wavs/wav-live_{0,1}-mel.wav` (and `-linear.wav`: the
    model has the CBHG) and offers each mel one to the player."""
    jhp, hp = _hps()
    _, pdir, _ = _checkpoints(str(tmp_path), jhp, hp)
    played = []
    monkeypatch.setattr(ts, 'play_audio', lambda path: played.append(path) or False)
    monkeypatch.setattr('sys.stdin', io.StringIO('Hello there.\n\nGood night.\n'))
    ts.run_live(argparse.Namespace(base_dir=str(tmp_path)), pdir, hp, 'cpu')
    wavs = [str(tmp_path / 'live_out' / 'wavs' / f'wav-live_{i}-mel.wav') for i in (0, 1)]
    assert played == wavs
    assert hp.predict_linear and sorted(os.listdir(tmp_path / 'live_out' / 'wavs')) == [
        f'wav-live_{i}-{kind}.wav' for i in (0, 1) for kind in ('linear', 'mel')]
    assert all(len(_wav(w)) > 0 for w in wavs)


# ---------------------------------------------------------------- the CLI

CLI_LINES = {
    'name': ['--name', 'run1'],
    'split names': ['--model', 'Tacotron-2', '--tacotron_name', 't', '--wavenet_name', 'w'],
    'tacotron': ['--model', 'Tacotron', '--name', 'run1', '--mode', 'synthesis',
                 '--GTA', 'False', '--input_dir', 'data/'],
    'wavenet': ['--model', 'WaveNet', '--wavenet_name', 'w', '--mels_dir', 'm/'],
    'default names': ['--model', 'Tacotron', '--mode', 'live'],
    'checkpoint flag': ['--checkpoint', 'ignored/', '--name', 'run1', '--mode', 'stream'],
}


def _jax_checkpoints(monkeypatch, argv):
    """(tacotron, wavenet) checkpoint directories that `synthesize.py` resolves for
    `argv`, read from the calls it makes (its stages patched out)."""
    seen = {}

    def stage(name):
        def record(args, hparams, *paths):
            seen.update(mode=args.mode, paths=paths, name=name)
        return record

    monkeypatch.setattr(jruntime, 'setup_runtime', lambda *a, **k: None)
    monkeypatch.setattr(jts, 'tacotron_synthesize', stage('Tacotron'))
    import tacotron2_tpu.inference.wavenet_synthesizer as jws
    monkeypatch.setattr(jws, 'wavenet_synthesize', stage('WaveNet'))
    monkeypatch.setattr(jsynthesize_cli, 'synthesize', stage('Tacotron-2'))
    monkeypatch.setattr(jsynthesize_cli, 'stream_synthesize', stage('Tacotron-2'))
    monkeypatch.setattr('sys.argv', ['synthesize.py'] + argv)
    jsynthesize_cli.main()
    return seen


class _Stop(Exception):
    pass


@pytest.mark.parametrize('line', list(CLI_LINES))
def test_cli_resolves_checkpoints_by_run_name(tmp_path, monkeypatch, line):
    """The port's `synthesize` parses each JAX command line and finds the checkpoints
    where `synthesize.py` does: `<base_dir>/logs-<tacotron_name|name|model>/
    taco_pretrained` and `.../logs-<wavenet_name|name|model>/wave_pretrained`; an
    explicit --tacotron_checkpoint / --wavenet_checkpoint wins; where no checkpoint is
    there, a parse error names the path."""
    argv = CLI_LINES[line] + ['--base_dir', str(tmp_path)]
    want = _jax_checkpoints(monkeypatch, argv)
    want_paths = [p for p in want['paths'] if isinstance(p, str) and p.endswith('_pretrained')]
    resolve, seen = synthesize.resolve_checkpoints, {}

    def spy(args):
        seen['args'], seen['paths'] = args, resolve(args)
        raise _Stop

    monkeypatch.setattr(synthesize, 'resolve_checkpoints', spy)
    with pytest.raises(_Stop):
        synthesize.main(argv + ['--device', 'cpu'])
    assert [p for p in seen['paths'] if p is not None] == want_paths
    args = seen['args']
    args.tacotron_checkpoint, args.wavenet_checkpoint = 'a.pt', 'b.pt'
    assert resolve(args) == tuple(None if p is None else x
                                  for p, x in zip(seen['paths'], ('a.pt', 'b.pt')))
    monkeypatch.setattr(synthesize, 'resolve_checkpoints', resolve)
    with pytest.raises(SystemExit):
        synthesize.main(argv + ['--device', 'cpu'])


ERROR_LINES = {
    'live without Tacotron': ['--mode', 'live'],
    'stream without Tacotron-2': ['--model', 'WaveNet', '--mode', 'stream'],
    'bad --GTA': ['--GTA', 'yes'],
    'bad --model': ['--model', 'Tacotron2'],
    'bad --mode': ['--mode', 'batch'],
}


@pytest.mark.parametrize('line', list(ERROR_LINES))
def test_cli_refuses_as_jax_does(monkeypatch, line):
    """The JAX CLI's checks (synthesize.py:121-131): the same ValueError and text, before
    any device check or load."""
    argv = ERROR_LINES[line]
    monkeypatch.setattr(jruntime, 'setup_runtime', lambda *a, **k: None)
    monkeypatch.setattr('sys.argv', ['synthesize.py'] + argv)
    with pytest.raises(ValueError) as want:
        jsynthesize_cli.main()
    with pytest.raises(ValueError) as got:
        synthesize.main(argv)
    assert str(got.value) == str(want.value)
