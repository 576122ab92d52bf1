"""The port's slice end to end on the CPU (text -> mel -> wav through
`python -m tacotron2_tpu_torch.synthesize`), its glue against the JAX synthesizers,
and the rule that the port imports no JAX.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.inference import tacotron_synthesizer as jtaco_synth
from tacotron2_tpu.inference import wavenet_synthesizer as jwave_synth
from tacotron2_tpu_torch import convert, synthesize
from tacotron2_tpu_torch.inference.tacotron_synthesizer import Synthesizer
from tacotron2_tpu_torch.inference.wavenet_synthesizer import prepare_conditions
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.ops import wavenet_ar
from tacotron2_tpu_torch.utils import round_up, suppress_stop_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("embedding_dim=32,enc_conv_channels=32,enc_conv_num_layers=1,encoder_lstm_units=16,"
        "attention_dim=16,attention_filters=8,attention_kernel=[7],prenet_layers=[16,16],"
        "decoder_lstm_units=32,postnet_channels=32,postnet_num_layers=2,outputs_per_step=2,"
        "layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,"
        "upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,num_freq=129,"
        "max_iters=8,tacotron_synthesis_batch_size=2,wavenet_synthesis_batch_size=2")


def tiny_hp():
    hp = default_hparams()
    hp.parse(TINY)
    return hp


def test_synthesize_cli_on_cpu(tmp_path):
    """Three sentences (a full batch and a padded one) through the CLI: one wav of
    frames * hop samples per sentence, and map.txt rows text|wav."""
    hp = tiny_hp()
    torch.manual_seed(0)
    taco_path, wave_path = str(tmp_path / 'taco.pt'), str(tmp_path / 'wavenet.pt')
    # stop tokens suppressed: every sentence decodes exactly max_iters steps
    convert.save_checkpoint(taco_path, 'tacotron',
                            suppress_stop_tokens(Tacotron(hp).state_dict()))
    convert.save_checkpoint(wave_path, 'wavenet', WaveNet(hp).state_dict())
    texts = ['Hello world.', 'The big brown fox.', 'He reads books.']
    text_list = tmp_path / 'texts.txt'
    text_list.write_text('\n'.join(texts) + '\n', encoding='utf-8')
    out_dir = tmp_path / 'out'
    stats = synthesize.main(['--tacotron_checkpoint', taco_path,
                             '--wavenet_checkpoint', wave_path, '--hparams', TINY,
                             '--text_list', str(text_list), '--output_dir', str(out_dir),
                             '--device', 'cpu'])
    frames = hp.max_iters * hp.outputs_per_step
    rows = (out_dir / 'map.txt').read_text(encoding='utf-8').splitlines()
    assert [r.split('|')[0] for r in rows] == texts
    for row, wav in zip(rows, stats['wavs']):
        sr, data = wavfile.read(row.split('|')[1])
        assert sr == hp.sample_rate and data.dtype == np.int16
        assert len(data) == len(wav) == frames * hp.get_hop_size()
        assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0
    assert stats['decoded_frames'] == 2 * 2 * frames  # two batches of two rows
    assert stats['ar_samples'] == 3 * frames * hp.get_hop_size()


def test_blank_lines_are_sentences_as_in_jax(tmp_path):
    """A text list with a blank line in the middle: the port's get_sentences keeps the
    empty sentence as the JAX CLI's does (`synthesize.py:23-28`), so the wavs'
    `wav-batch_i_sentence_j` names and the map.txt rows follow the JAX list; the empty
    sentence, whose ids are the EOS alone, goes through the Tacotron-2 path."""
    from tacotron2_tpu.text import text_to_sequence as j_text_to_sequence
    from tacotron2_tpu_torch.text import text_to_sequence

    spec = importlib.util.spec_from_file_location('jax_synthesize_cli',
                                                  os.path.join(REPO, 'synthesize.py'))
    jsynth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jsynth)
    hp = tiny_hp()
    torch.manual_seed(0)
    taco_path, wave_path = str(tmp_path / 'taco.pt'), str(tmp_path / 'wavenet.pt')
    convert.save_checkpoint(taco_path, 'tacotron',
                            suppress_stop_tokens(Tacotron(hp).state_dict()))
    convert.save_checkpoint(wave_path, 'wavenet', WaveNet(hp).state_dict())
    text_list = tmp_path / 'texts.txt'
    text_list.write_text('Hello world.\n\nHe reads books.\n', encoding='utf-8')
    want = jsynth.get_sentences(types.SimpleNamespace(text_list=str(text_list)), hp)
    assert want == ['Hello world.', '', 'He reads books.']
    assert synthesize.get_sentences(str(text_list), hp) == want
    assert text_to_sequence('', ['english_cleaners']) == \
        j_text_to_sequence('', ['english_cleaners']) and \
        len(text_to_sequence('', ['english_cleaners'])) == 1
    out_dir = tmp_path / 'out'
    stats = synthesize.main(['--tacotron_checkpoint', taco_path,
                             '--wavenet_checkpoint', wave_path, '--hparams', TINY,
                             '--text_list', str(text_list), '--output_dir', str(out_dir),
                             '--device', 'cpu'])
    bs = hp.tacotron_synthesis_batch_size
    rows = (out_dir / 'map.txt').read_text(encoding='utf-8').splitlines()
    assert rows == [f'{text}|{out_dir / f"wav-batch_{n // bs}_sentence_{n % bs}.wav"}'
                    for n, text in enumerate(want)]
    frames = hp.max_iters * hp.outputs_per_step
    assert [len(w) for w in stats['wavs']] == [frames * hp.get_hop_size()] * 3
    assert all(np.isfinite(w).all() for w in stats['wavs'])


def test_wavenet_batches_follow_run_synthesis(tmp_path, monkeypatch):
    """Every sentence is decoded first, then the mels are vocoded in batches of
    wavenet_synthesis_batch_size in sentence order, as run_synthesis groups them
    (wavenet_synthesizer.py:189-200): five sentences with Tacotron batches of 2 and
    WaveNet batches of 3 make AR calls of B=3 and B=2, not one per Tacotron batch."""
    hp = tiny_hp()
    hp.parse('max_iters=2,tacotron_synthesis_batch_size=2,wavenet_synthesis_batch_size=3')
    torch.manual_seed(0)
    calls = []
    generate_ar = wavenet_ar.generate_ar

    def recording(weights, c_up, noise, hp, **kw):
        calls.append(int(c_up.shape[0]))
        return generate_ar(weights, c_up, noise, hp, **kw)

    monkeypatch.setattr(wavenet_ar, 'generate_ar', recording)
    texts = ['One.', 'Two two.', 'Three.', 'Four four four.', 'Five.']
    stats = synthesize.synthesize(hp, texts, Tacotron(hp), WaveNet(hp), str(tmp_path), 'cpu')
    assert calls == [3, 2]
    assert [os.path.basename(p) for p in stats['wav_paths']] == [
        f'wav-batch_{n // 2}_sentence_{n % 2}.wav' for n in range(5)]
    rows = (tmp_path / 'map.txt').read_text(encoding='utf-8').splitlines()
    assert rows == [f'{t}|{p}' for t, p in zip(texts, stats['wav_paths'])]
    frames = [len(w) // hp.get_hop_size() for w in stats['wavs']]
    assert stats['ar_samples'] == (3 * max(frames[:3]) + 2 * max(frames[3:])) \
        * hp.get_hop_size()
    assert stats['decoded_frames'] == 3 * 2 * hp.max_iters * hp.outputs_per_step


def test_cli_has_no_silent_cpu_choice(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is usable')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        synthesize.main(['--tacotron_checkpoint', 'x', '--wavenet_checkpoint', 'y'])


def test_text_batch_and_lengths_match_jax():
    """Batch padding by repeating the last text, T_in rounded up to pad_text_multiple,
    and output lengths from the first stop (with the 4*r floor), as the JAX
    synthesizer does."""
    hp = tiny_hp()
    texts = ['Hi.', 'A somewhat longer sentence, with a comma.']
    jself = types.SimpleNamespace(_hp=hp, _cleaners=['english_cleaners'])
    synth = Synthesizer(Tacotron(hp), hp, 'cpu')
    for batch in (texts, texts[:1]):
        want = jtaco_synth.Synthesizer._prepare_text_batch(jself, batch)
        got = synth._prepare_text_batch(batch)
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[2]) and np.array_equal(got[2], want[3])
    stops = np.random.default_rng(0).normal(0, 3, (3, 20)).astype(np.float32)
    stops[2] = -10.0  # never stops: full length
    stops[1, :2] = -10.0
    stops[1, 2] = 10.0  # stops at frame 3, below the 4*r floor
    want = jtaco_synth.Synthesizer._get_output_lengths(jself, stops)
    assert synth._get_output_lengths(stops) == want
    assert want[1] == 4 * hp.outputs_per_step and want[2] == 20


def test_prepare_conditions_matches_jax():
    """Clip to [lo, hi], pad with lo to the longest mel, rescale to [0, 1]."""
    hp = tiny_hp()
    rng = np.random.default_rng(1)
    mels = [rng.uniform(-6, 6, (n, hp.num_mels)).astype(np.float32) for n in (5, 9)]
    want = jwave_synth.Synthesizer._prepare_conditions(types.SimpleNamespace(_hp=hp), mels)
    got = prepare_conditions([torch.from_numpy(m) for m in mels], hp)
    assert got.shape == (2, 9, hp.num_mels)
    assert np.abs(want - got.numpy()).max() <= 1e-6


def test_utils():
    assert [round_up(x, 16) for x in (1, 16, 17)] == [16, 16, 32]
    sd = {'decoder.stop_projection.bias': torch.zeros(2), 'x': torch.ones(1)}
    out = suppress_stop_tokens(sd)
    assert torch.equal(out['decoder.stop_projection.bias'], torch.full((2,), -100.0))
    assert torch.equal(sd['decoder.stop_projection.bias'], torch.zeros(2))


GUARD = """
import importlib, importlib.util, json, pkgutil, sys
for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'orbax.checkpoint', 'sklearn',
             'sklearn.model_selection'):
    sys.modules[name] = None  # any import of these now raises ImportError
import tacotron2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tacotron2_tpu_torch.__path__,
                                               'tacotron2_tpu_torch.')]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')
spec.loader.exec_module(importlib.util.module_from_spec(spec))
jax_pkg = sorted(m for m in sys.modules
                 if m == 'tacotron2_tpu' or m.startswith('tacotron2_tpu.'))
print(json.dumps([names, jax_pkg]))
"""


def test_port_imports_no_jax():
    """Every module of the port, the streaming service and the trainer among them, and
    chip_smoke.py import with jax, flax, optax, orbax and scikit-learn unavailable, and
    load no module of the JAX package: neither `tacotron2_tpu` nor any `tacotron2_tpu.*`
    (the port keeps its own copies of config, text and the DSP helpers)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-c', GUARD], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    names, loaded = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(names) >= 50
    assert {'tacotron2_tpu_torch.inference.streaming', 'tacotron2_tpu_torch.inference.server',
            'tacotron2_tpu_torch.serve', 'tacotron2_tpu_torch.synthesize',
            'tacotron2_tpu_torch.config', 'tacotron2_tpu_torch.text.frontend',
            'tacotron2_tpu_torch.ops.mulaw', 'tacotron2_tpu_torch.models.wavenet.distributions',
            'tacotron2_tpu_torch.inference.wavenet_synthesizer',
            'tacotron2_tpu_torch.train', 'tacotron2_tpu_torch.training.wavenet_train',
            'tacotron2_tpu_torch.training.tacotron_train',
            'tacotron2_tpu_torch.training.tacotron_trainer',
            'tacotron2_tpu_torch.models.tacotron.losses', 'tacotron2_tpu_torch.ops.dsp',
            'tacotron2_tpu_torch.models.tacotron.flax_names',
            'tacotron2_tpu_torch.training.common',
            'tacotron2_tpu_torch.training.wavenet_trainer',
            'tacotron2_tpu_torch.training.weight_norm_init',
            'tacotron2_tpu_torch.training.checkpointing',
            'tacotron2_tpu_torch.training.checkpoint_select',
            'tacotron2_tpu_torch.training.schedules',
            'tacotron2_tpu_torch.data.wavenet_loader', 'tacotron2_tpu_torch.data.loader',
            'tacotron2_tpu_torch.ops.audio', 'tacotron2_tpu_torch.ops.stft_common',
            'tacotron2_tpu_torch.ops.mcd', 'tacotron2_tpu_torch.infolog',
            'tacotron2_tpu_torch.probes', 'tacotron2_tpu_torch.probes.prng_probe',
            'tacotron2_tpu_torch.probes.ar_critpath', 'tacotron2_tpu_torch.probes.matmul_probe',
            'tacotron2_tpu_torch.probes.microbench', 'tacotron2_tpu_torch.preprocess',
            'tacotron2_tpu_torch.wavenet_preprocess', 'tacotron2_tpu_torch.data.preprocessor',
            'tacotron2_tpu_torch.data.corpora', 'tacotron2_tpu_torch.models.precision',
            'tacotron2_tpu_torch.models.wavenet.modules',
            'tacotron2_tpu_torch.ops.fused_decoder', 'tacotron2_tpu_torch.ops.decoder_vjp',
            'tacotron2_tpu_torch.ops._build'} <= set(names)
    assert loaded == []
    # imports inside functions too (chip_smoke.py imports in its phases)
    paths = [os.path.join(REPO, 'chip_smoke.py')] + [
        os.path.join(d, f) for d, _, files in os.walk(os.path.join(REPO, 'tacotron2_tpu_torch'))
        for f in files if f.endswith('.py')]
    for path in paths:
        with open(path, encoding='utf-8') as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ''] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split('.')[0] not in ('tacotron2_tpu', 'jax', 'flax', 'optax',
                                                 'orbax', 'sklearn'), (path, mod)
