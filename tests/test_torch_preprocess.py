"""Preprocessing parity: the port's `data/preprocessor.py`, `data/corpora.py` and its two
CLIs (`tacotron2_tpu_torch.preprocess`, `.wavenet_preprocess`) against the JAX package's
and the top-level `preprocess.py` / `wavenet_preprocess.py`, on wavs made from a seed.

Both sides are host numpy with the same audio chain, so the artifacts must be
identical: the metadata rows equal, every `.npy` `np.array_equal` with the same dtype
and shape, and `train.txt` / `map.txt` equal byte for byte.
"""

import argparse
import os

import numpy as np
import pytest

import preprocess as jpreprocess_cli
import wavenet_preprocess as jwavenet_preprocess_cli
from tacotron2_tpu.config import default_hparams as jdefault_hparams
from tacotron2_tpu.config import paper_hparams as jpaper_hparams
from tacotron2_tpu.data import corpora as jcorpora
from tacotron2_tpu.data import preprocessor as jpreprocessor
from tacotron2_tpu_torch import preprocess, wavenet_preprocess
from tacotron2_tpu_torch.config import default_hparams, paper_hparams
from tacotron2_tpu_torch.data import corpora, preprocessor

from test_preprocess import make_corpus

PROFILES = {
    'default': '',
    'paper': None,  # paper_hparams(): preemphasize=False, trim_top_db=45, fmin=75
    'mulaw-quantize': "input_type='mulaw-quantize',quantize_channels=256,out_channels=256",
}


def _hparams(profile):
    """(the JAX package's hparams, the port's) of `profile`."""
    if profile == 'paper':
        return jpaper_hparams(), paper_hparams()
    j, t = jdefault_hparams(), default_hparams()
    j.parse(PROFILES[profile])
    t.parse(PROFILES[profile])
    return j, t


def _dirs(root, names):
    dirs = [os.path.join(root, n) for n in names]
    for d in dirs:
        os.makedirs(d)
    return dirs


def _same_npys(a_dir, b_dir):
    """Every .npy of a_dir equals b_dir's of the same name (values, dtype, shape)."""
    names = sorted(os.listdir(a_dir))
    assert names and names == sorted(os.listdir(b_dir))
    for name in names:
        a, b = np.load(os.path.join(a_dir, name)), np.load(os.path.join(b_dir, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    return names


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp('LJmini')), n=4)


@pytest.mark.parametrize('profile', list(PROFILES))
def test_build_from_path_matches_jax(tmp_path, corpus, profile):
    """`build_from_path` on the same wavs: the rows (audio, mel, linear, samples,
    frames, text) equal and every audio / mel / linear npy identical; the audio is
    mel frames x hop samples (int16 class ids under mulaw-quantize, float32 otherwise)
    and the mels are (frames, num_mels)."""
    jhp, hp = _hparams(profile)
    want = jpreprocessor.build_from_path(jhp, [corpus], *_dirs(
        str(tmp_path / 'jax'), ('mels', 'linear', 'audio')), n_jobs=2)
    mel_dir, lin_dir, wav_dir = _dirs(str(tmp_path / 'port'), ('mels', 'linear', 'audio'))
    got = preprocessor.build_from_path(hp, [corpus], mel_dir, lin_dir, wav_dir, n_jobs=2)
    assert got == want and len(got) == 4
    for d in ('mels', 'linear', 'audio'):
        _same_npys(str(tmp_path / 'jax' / d), str(tmp_path / 'port' / d))
    for audio_f, mel_f, _, samples, frames, _ in got:
        wav = np.load(os.path.join(wav_dir, audio_f))
        assert len(wav) == samples == frames * hp.get_hop_size()
        assert wav.dtype == (np.int16 if profile == 'mulaw-quantize' else np.float32)
        assert np.load(os.path.join(mel_dir, mel_f)).shape == (frames, hp.num_mels)


@pytest.mark.parametrize('profile', list(PROFILES))
def test_build_from_path_wavenet_matches_jax(tmp_path, corpus, profile):
    """`build_from_path_wavenet` on the same wav directory: rows (audio, mel, mel,
    <no_g>, samples, frames) equal and every npy identical."""
    jhp, hp = _hparams(profile)
    wavs = os.path.join(corpus, 'wavs')
    want = jpreprocessor.build_from_path_wavenet(
        jhp, wavs, *_dirs(str(tmp_path / 'jax'), ('mels', 'audio')), n_jobs=2)
    got = preprocessor.build_from_path_wavenet(
        hp, wavs, *_dirs(str(tmp_path / 'port'), ('mels', 'audio')), n_jobs=2)
    assert got == want and len(got) == 4 and all(r[3] == '<no_g>' for r in got)
    for d in ('mels', 'audio'):
        _same_npys(str(tmp_path / 'jax' / d), str(tmp_path / 'port' / d))


MAILABS_CASES = {
    'one book': ('M-AILABS', 'en_US', 'female', 'mary_ann', False, 'northandsouth'),
    'merged books': ('M-AILABS', 'en_US', 'female', 'mary_ann', True, 'northandsouth'),
    'LJSpeech': ('LJSpeech-1.1', 'xx_XX', 'nobody', 'nobody', False, 'none'),
    'unknown dataset': ('VCTK', 'en_US', 'female', 'mary_ann', False, 'northandsouth'),
    'bad language': ('M-AILABS', 'xx_XX', 'female', 'mary_ann', False, 'northandsouth'),
    'bad voice': ('M-AILABS', 'en_US', 'robot', 'mary_ann', False, 'northandsouth'),
    'bad reader': ('M-AILABS', 'en_US', 'female', 'nobody', False, 'northandsouth'),
    'bad book': ('M-AILABS', 'en_US', 'female', 'mary_ann', False, 'moby_dick'),
}


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except ValueError as e:
        return 'ValueError', str(e)
    return 'ok', sorted(out)


@pytest.mark.parametrize('case', list(MAILABS_CASES))
def test_norm_data_matches_jax(tmp_path, case):
    """`corpora.norm_data` on an M-AILABS tree of two books: the same folders, or the
    same ValueError with the same text."""
    for book in ('northandsouth', 'bleak_house'):
        (tmp_path / 'en_US' / 'by_book' / 'female' / 'mary_ann' / book).mkdir(parents=True)
    args = (str(tmp_path),) + MAILABS_CASES[case]
    want, got = _outcome(jcorpora.norm_data, *args), _outcome(corpora.norm_data, *args)
    assert got == want
    assert (got[0] == 'ok') == (case in ('one book', 'merged books', 'LJSpeech'))


def test_preprocess_cli_matches_jax(tmp_path, capsys):
    """`python -m tacotron2_tpu_torch.preprocess` (its `main`, paper profile with an
    override on top) against the top-level `preprocess.run_preprocess` on the same
    LJSpeech-1.1 tree: train.txt byte for byte, the printed corpus stats equal, every
    npy identical."""
    make_corpus(str(tmp_path / 'LJSpeech-1.1'), n=3)
    jhp = jpaper_hparams()
    jhp.parse('rescaling_max=0.9')
    args = argparse.Namespace(base_dir=str(tmp_path), dataset='LJSpeech-1.1',
                              language='en_US', voice='female', reader='mary_ann',
                              merge_books='False', book='northandsouth',
                              output='jax_data', n_jobs=2)
    jpreprocess_cli.run_preprocess(args, jhp)
    want_out = capsys.readouterr().out
    rows = preprocess.main(['--base_dir', str(tmp_path), '--paper_profile', '--hparams',
                            'rescaling_max=0.9', '--output', 'port_data', '--n_jobs', '2'])
    assert capsys.readouterr().out == want_out
    assert len(rows) == 3
    with open(tmp_path / 'jax_data' / 'train.txt', 'rb') as a, \
            open(tmp_path / 'port_data' / 'train.txt', 'rb') as b:
        assert a.read() == b.read()
    for d in ('mels', 'linear', 'audio'):
        _same_npys(str(tmp_path / 'jax_data' / d), str(tmp_path / 'port_data' / d))
    with pytest.raises(ValueError, match='merge_books'):
        preprocess.main(['--base_dir', str(tmp_path), '--merge_books', 'yes'])


def test_wavenet_preprocess_cli_matches_jax(tmp_path, capsys):
    """`python -m tacotron2_tpu_torch.wavenet_preprocess` against the top-level
    `wavenet_preprocess.write_metadata` / `validate_alignment` on the same wavs:
    map.txt byte for byte, the printed lines equal; `validate_alignment` raises on an
    audio file one sample short, as the JAX one does."""
    make_corpus(str(tmp_path), n=3)
    jhp = jdefault_hparams()
    out = str(tmp_path / 'jax_out')
    mel_dir, wav_dir = _dirs(out, ('mels', 'audio'))
    meta = jpreprocessor.build_from_path_wavenet(jhp, str(tmp_path / 'wavs'), mel_dir,
                                                 wav_dir, n_jobs=2)
    jwavenet_preprocess_cli.write_metadata(meta, out, jhp)
    jwavenet_preprocess_cli.validate_alignment(meta, out, jhp)
    want_out = capsys.readouterr().out
    rows = wavenet_preprocess.main(['--base_dir', str(tmp_path), '--output', 'port_out',
                                    '--n_jobs', '2'])
    assert capsys.readouterr().out == want_out and rows == meta
    with open(os.path.join(out, 'map.txt'), 'rb') as a, \
            open(tmp_path / 'port_out' / 'map.txt', 'rb') as b:
        assert a.read() == b.read()
    _same_npys(wav_dir, str(tmp_path / 'port_out' / 'audio'))
    port_out = str(tmp_path / 'port_out')
    for d in (out, port_out):
        path = os.path.join(d, 'audio', rows[0][0])
        np.save(path, np.load(path)[:-1])
    for validate, d, h in ((jwavenet_preprocess_cli.validate_alignment, out, jhp),
                           (wavenet_preprocess.validate_alignment, port_out, default_hparams())):
        with pytest.raises(AssertionError, match='1 misaligned examples'):
            validate(rows, d, h)
