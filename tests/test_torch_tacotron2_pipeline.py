"""The Tacotron-2 pipeline on the port, on the CPU at tiny widths: wavs made from a seed
-> `python -m tacotron2_tpu_torch.preprocess` -> `train --model Tacotron-2` (Tacotron,
GTA synthesis, WaveNet on the GTA map) -> `synthesize` with run names only, and the
`state_log` against the JAX `train.py`'s.
"""

import contextlib
import io
import os

import numpy as np
import pytest
from scipy.io import wavfile

import train as jtrain_cli
from tacotron2_tpu_torch import preprocess, synthesize, train
from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.training.checkpointing import CheckpointManager

from test_torch_tacotron import TINY

# TINY Tacotron, tiny WaveNet (WN_TINY of test_train_loops.py at hop 64), one batch of 2
HP = TINY + (',hop_size=64,win_size=128,n_fft=128,num_freq=65,upsample_scales=[8,8],'
             'tacotron_batch_size=2,tacotron_test_size=None,tacotron_test_batches=1,'
             'bucket_group_batches=2,pad_mel_multiple=16,griffin_lim_iters=3,max_iters=8,'
             'tacotron_synthesis_batch_size=2,layers=4,stacks=2,residual_channels=8,'
             'gate_channels=16,skip_out_channels=8,max_time_steps=256,wavenet_batch_size=2,'
             'wavenet_test_size=None,wavenet_test_batches=1,wavenet_natural_eval=True,'
             'wavenet_ema_decay=0.5')
N_UTTERANCES = 6


def make_ljspeech(base, n=N_UTTERANCES, sr=22050):
    """`base/LJSpeech-1.1/{metadata.csv,wavs/}`: n tones with noise of 0.2-0.45 s."""
    root = os.path.join(base, 'LJSpeech-1.1')
    os.makedirs(os.path.join(root, 'wavs'))
    rng, rows = np.random.default_rng(0), []
    for i in range(n):
        t = np.arange(int(sr * (0.2 + 0.05 * i))) / sr
        wav = 0.5 * np.sin(2 * np.pi * (200 + 60 * i) * t) + 0.01 * rng.standard_normal(len(t))
        wavfile.write(os.path.join(root, 'wavs', f'UT-{i}.wav'), sr,
                      (wav * 32767).astype(np.int16))
        rows.append(f'UT-{i}|t {i}|Test sentence number {i}.')
    with open(os.path.join(root, 'metadata.csv'), 'w', encoding='utf-8') as f:
        f.write('\n'.join(rows) + '\n')


def _train(base, *extra):
    """`train --model Tacotron-2 --device cpu`, two steps of each model; (the state_log
    path it returns, its console output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = train.main(['--base_dir', base, '--name', 'run', '--hparams', HP,
                            '--device', 'cpu', '--tacotron_train_steps', '2',
                            '--wavenet_train_steps', '2', '--eval_interval', '2',
                            '--checkpoint_interval', '2', '--summary_interval', '1', *extra])
    return state, out.getvalue()


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The corpus preprocessed by the port's CLI, then the whole pipeline once."""
    base = str(tmp_path_factory.mktemp('pipeline'))
    make_ljspeech(base)
    rows = preprocess.main(['--base_dir', base, '--hparams', HP, '--n_jobs', '2'])
    state, out = _train(base)
    return dict(base=base, rows=rows, state=state, out=out)


def _read(path):
    with open(path, 'rb') as f:
        return f.read()


def test_pipeline_runs_three_phases(run, tmp_path):
    """Phases 1-3 in order: a Tacotron checkpoint, GTA mels of every train.txt row
    (each of its target's frame count) with `tacotron_output/gta/map.txt`, and a
    WaveNet trained on that map (its natural eval included); `state_log` holds the
    bytes the JAX `train.write_state` writes for the same flags and map."""
    base, out = run['base'], run['out']
    log_dir = os.path.join(base, 'logs-run')
    gta_map = os.path.join(base, 'tacotron_output', 'gta', 'map.txt')
    assert run['state'] == os.path.join(log_dir, 'state_log')
    want = str(tmp_path / 'state_log')
    jtrain_cli.write_state(want, [True, True, True], gta_map)
    assert _read(run['state']) == _read(want) == f'1|1|1|{gta_map}'.encode()
    banners = [out.index(f'# Phase {i}/3') for i in (1, 2, 3)]
    assert banners == sorted(banners) and 'Pipeline complete' in out
    assert CheckpointManager(os.path.join(log_dir, 'taco_pretrained')).all_steps() == [2]
    assert CheckpointManager(os.path.join(log_dir, 'wave_pretrained')).all_steps() == [2]
    assert f'Loading training data from: {gta_map}' in out
    assert 'Eval (natural) loss' in out
    with open(gta_map, encoding='utf-8') as f:
        rows = [line.rstrip('\n').split('|') for line in f]
    assert len(rows) == len(run['rows']) == N_UTTERANCES
    hp = default_hparams()
    hp.parse(HP)
    for (audio_f, mel_f, _, samples, frames, text), row in zip(run['rows'], rows):
        assert row[0] == os.path.join(base, 'training_data', 'audio', audio_f)
        assert row[1] == os.path.join(base, 'training_data', 'mels', mel_f)
        assert row[3:] == ['<no_g>', text]
        gta = np.load(row[2])
        assert gta.shape == (frames, hp.num_mels) and samples == frames * hp.get_hop_size()
        assert np.abs(gta).max() <= hp.max_abs_value and np.isfinite(gta).all()


def test_rerun_resumes_at_the_first_unfinished_phase(run):
    """With phase 1 done (a state_log `1|0|0|` as either package writes it) a rerun
    skips Tacotron training and starts at GTA, then the WaveNet phase restores its
    checkpoint; with all three done a rerun trains nothing; the flags of `train.py`
    the port ignores (--profile_step, --slack_url, --tf_log_level) and its synthesis
    flags parse."""
    base = run['base']
    jtrain_cli.write_state(run['state'], [True, False, False], '')
    state, out = _train(base)
    assert '# Phase 1/3' not in out and '# Phase 2/3' in out and '# Phase 3/3' in out
    assert 'Restored WaveNet checkpoint at step 2' in out
    assert _read(state) == _read(run['state']) and train.read_state(state)[0] == [True] * 3
    _, out = _train(base, '--GTA', 'True', '--input_dir', 'training_data', '--mode',
                    'synthesis', '--output_dir', 'output', '--profile_step', '5',
                    '--slack_url', 'http://localhost:1/hook', '--tf_log_level', '2',
                    '--embedding_interval', '10')
    assert 'nothing to do' in out and '# Phase' not in out


@pytest.mark.parametrize('flags,path', [([True, True, True], '/a/gta/map.txt'),
                                        ([True, False, False], ''),
                                        ([True, True, False], 'rel/gta/map.txt')])
def test_state_log_matches_jax(tmp_path, flags, path):
    """`write_state` writes the JAX `train.write_state`'s bytes (`<t>|<g>|<w>|<map>`, no
    newline), and each package's `read_state` reads the other's file."""
    ours, theirs = str(tmp_path / 'ours'), str(tmp_path / 'theirs')
    train.write_state(ours, flags, path)
    jtrain_cli.write_state(theirs, flags, path)
    assert _read(ours) == _read(theirs)
    assert train.read_state(theirs) == jtrain_cli.read_state(ours) == (flags, path)
    assert train.read_state(str(tmp_path / 'absent')) == ([False] * 3, '')


def test_synthesize_by_run_name(run):
    """The JAX command lines on the pipeline's run, no explicit checkpoint:
    `--model Tacotron --mode eval` writes `tacotron_output/eval/` (mels, map.txt) and
    Griffin-Lim wavs; `--model WaveNet --mels_dir tacotron_output/eval` vocodes them;
    `--model=Tacotron-2` (the `=` form) vocodes in memory into --output_dir; `--model
    Tacotron --mode synthesis --GTA False` writes the natural mels of train.txt."""
    base = run['base']
    common = ['--name', 'run', '--base_dir', base, '--hparams', HP, '--device', 'cpu']
    texts = os.path.join(base, 'texts.txt')
    with open(texts, 'w', encoding='utf-8') as f:
        f.write('Hello world.\nHe reads books.\nYes.\n')
    eval_dir = synthesize.main(['--model', 'Tacotron', '--mode', 'eval', '--text_list', texts,
                                '--checkpoint', 'pretrained/'] + common)
    assert eval_dir == os.path.join(base, 'tacotron_output', 'eval')
    with open(os.path.join(eval_dir, 'map.txt'), encoding='utf-8') as f:
        rows = [line.rstrip('\n').split('|') for line in f]
    assert [r[0] for r in rows] == ['Hello world.', 'He reads books.', 'Yes.']
    assert all(os.path.isfile(r[1]) for r in rows)
    wavs = sorted(os.listdir(os.path.join(base, 'tacotron_output', 'logs-eval', 'wavs')))
    assert wavs == sorted(f'wav-batch_{i // 2}_sentence_{i % 2}-{k}.wav' for i in range(3)
                          for k in ('mel', 'linear'))
    stats = synthesize.main(['--model', 'WaveNet', '--mels_dir', 'tacotron_output/eval']
                            + common)
    hop = 64
    assert [len(w) for w in stats['wavs']] == [len(np.load(r[1])) * hop for r in rows]
    assert stats['output_dir'] == os.path.join(base, 'wavenet_output')
    stats = synthesize.main(['--model=Tacotron-2', '--text_list', texts, '--output_dir',
                             os.path.join(base, 'e2e')] + common)
    assert len(stats['wav_paths']) == 3 and all(os.path.isfile(p) for p in stats['wav_paths'])
    natural = synthesize.main(['--model', 'Tacotron', '--mode', 'synthesis', '--GTA', 'False',
                               '--input_dir', 'training_data'] + common)
    assert natural == os.path.join(base, 'tacotron_output', 'natural', 'map.txt')
    with open(natural, encoding='utf-8') as f:
        assert len(f.readlines()) == N_UTTERANCES
