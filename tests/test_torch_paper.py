"""The paper profile (`config.paper_hparams()`: MoL-10 WaveNet without the legacy
sqrt(1/2) scalings, the 2D transpose-conv upsampler ×(5·5·11), Tacotron with
clip_outputs and predict_linear off) through the PyTorch port against the JAX package,
on the CPU at tiny widths; and the port's own copies of `config` and `text` against
the originals.

Every WaveNet parameter is seeded numpy noise (`test_torch_wavenet.randomize`):
the upsampler's NN init is symmetric under the flip its conversion needs, so only
random weights can tell a right conversion from a wrong one. Tolerances: modules and
the teacher-forced forward pass fp32 max abs 1e-5; the MoL plain version against the
Pallas kernel in interpret mode as stated at each test (one bf16 rounding of an
activation can flip between the two, from the f32 sum order).
"""

import dataclasses
import http.client
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tacotron2_tpu import config as jconfig
from tacotron2_tpu import text as jtext
from tacotron2_tpu.inference import streaming as jstreaming
from tacotron2_tpu.inference import tacotron_synthesizer as jtaco_synth
from tacotron2_tpu.inference import wavenet_synthesizer as jwave_synth
from tacotron2_tpu.models.tacotron.model import Tacotron as JTacotron
from tacotron2_tpu.models.wavenet.model import WaveNet as JWaveNet
from tacotron2_tpu.ops import fused_decoder as jfd
from tacotron2_tpu.ops.pallas import wavenet_ar as jar
from tacotron2_tpu.training import wavenet_trainer as wt
from tacotron2_tpu_torch import config, convert, serve, synthesize, text
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.models.wavenet.modules import UpsampleNetwork
from tacotron2_tpu_torch.ops import fused_decoder as tfd
from tacotron2_tpu_torch.ops import wavenet_ar
from test_torch_tacotron import jax_prenet_masks, push_stop_bias
from test_torch_tacotron import randomize as randomize_taco
from test_torch_wavenet import randomize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the paper profile at tiny widths: 8 layers in its 4 stacks; out_channels=30, the
# 2D upsampler ×(5, 5, 11), hop 275 and the non-legacy scalings stay the paper's
WAVENET_TINY = 'layers=8,stacks=4,residual_channels=8,gate_channels=16,skip_out_channels=8'
TACO_TINY = (",embedding_dim=32,enc_conv_channels=32,enc_conv_num_layers=1,"
             "encoder_lstm_units=16,attention_dim=16,attention_filters=8,"
             "attention_kernel=[7],prenet_layers=[16,16],decoder_lstm_units=32,"
             "postnet_channels=32,postnet_num_layers=2,outputs_per_step=2")
TINY = WAVENET_TINY + TACO_TINY + ',max_iters=4,tacotron_synthesis_batch_size=2'
B = 2
FP32_TOL = 1e-5
NR = 10


def _hps(extra=''):
    """(JAX hparams, port hparams): paper_hparams() with the same override applied."""
    hj, hp = jconfig.paper_hparams(), config.paper_hparams()
    hj.parse(TINY + extra)
    hp.parse(TINY + extra)
    return hj, hp


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_tiny_profile_is_the_paper_path():
    _, hp = _hps()
    assert (hp.out_channels, hp.upsample_type, tuple(hp.upsample_scales)) == (30, '2D',
                                                                           (5, 5, 11))
    assert not (hp.legacy or hp.residual_legacy or hp.clip_outputs or hp.predict_linear)
    assert hp.get_hop_size() == 275 and hp.layers // hp.stacks == 2


# --- the port's copies of config and text -------------------------------------------

@pytest.mark.parametrize('profile', ['default_hparams', 'paper_hparams'])
def test_config_copy_matches_reference(profile):
    """Every field of both Hparams, in order, with its value; the same override string
    parses to the same values; the debug string, hop and window agree."""
    want, got = getattr(jconfig, profile)(), getattr(config, profile)()
    assert [(f.name, f.type) for f in dataclasses.fields(got)] == \
        [(f.name, f.type) for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    override = ("layers=8,upsample_scales=[5,5,11],log_scale_min=-9,speakers_path=None,"
                "cleaners='basic_cleaners',sentences=['A b.','C, d.'],legacy=False,"
                "hop_size=None,frame_shift_ms=12.5,win_size=None,NN_scaler=0.25")
    want.parse(override)
    got.parse(override)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert config.hparams_debug_string(got) == jconfig.hparams_debug_string(want)
    assert (got.get_hop_size(), got.get_win_size()) == (want.get_hop_size(),
                                                          want.get_win_size())
    for bad in ('nope=1', 'layers', "input_type='x'"):
        with pytest.raises(ValueError):
            getattr(jconfig, profile)().parse(bad)
        with pytest.raises(ValueError):
            getattr(config, profile)().parse(bad)


SPECIAL = ['I paid $3.50 for 2 apples on the 21st of May, 1999.',
           'Mr. Smith met Dr. Jones and Mrs. Lee at 10:30; St. Louis, Ft. Worth.',
           'It cost £12, then 1,000,000 and 0.05 and 2001, 1066 and 2,500th.',
           'Turn left on {HH AW1 S} Street.', '{AH0 B AW1 T} it',
           'Café naïve façade: ß, æ, ø, Þ!', '  Extra   spaces\tand\nnewlines  ',
           'Whatever [brackets] (and) "quotes" - dashes -- too?', '']


def test_text_frontend_copy_matches_reference():
    """The same ids for every line of sentences.txt and for numbers, currency,
    abbreviations and {ARPAbet} braces, under every cleaner; the same symbols."""
    with open(os.path.join(REPO, 'sentences.txt'), encoding='utf-8') as f:
        lines = [line.rstrip('\n') for line in f] + SPECIAL
    for cleaners in (['english_cleaners'], ['basic_cleaners'],
                     ['transliteration_cleaners']):
        for line in lines:
            ids = text.text_to_sequence(line, cleaners)
            assert ids == jtext.text_to_sequence(line, cleaners), (line, cleaners)
            assert text.sequence_to_text(ids) == jtext.sequence_to_text(ids)
    assert text.symbols == jtext.symbols
    assert (text.VOCAB_SIZE, text.PAD_ID, text.EOS_ID) == (jtext.VOCAB_SIZE, jtext.PAD_ID,
                                                           jtext.EOS_ID)


def _frontend(module, s):
    try:
        return module.text_to_sequence(s, ['english_cleaners'])
    except Exception as e:  # noqa: BLE001 - both must fail the same way, if at all
        return type(e).__name__


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.text(alphabet=st.one_of(st.sampled_from(list("abcXYZ 0123456789.,;:!?'\"-$£%{}()")),
                                  st.characters()), max_size=80))
def test_text_frontend_copy_matches_reference_on_drawn_text(s):
    assert _frontend(text, s) == _frontend(jtext, s)


# --- WaveNet: the 2D upsampler, the forward pass, the packing ------------------------

@pytest.fixture(scope='module')
def paper_wavenet():
    """(JAX hp, port hp, flax params, port model) with seeded random weights."""
    hj, hp = _hps()
    params = jax.eval_shape(JWaveNet(hj).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hj.get_hop_size(), 1)),
                            jnp.zeros((1, 1, 80)))['params']
    params = randomize(params, np.random.default_rng(0))
    # positive upsampler kernels and biases: with random signs the three ReLU layers
    # zero the whole conditioning (they do at this seed), and the flip still matters
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.abs(x) if 'upsample_network' in jax.tree_util.keystr(path) else x,
        params)
    model = WaveNet(hp)
    model.load_state_dict(convert.wavenet_state_dict(params))
    return hj, hp, params, model.eval()


def _upsampler(params, hp, flip):
    """A port UpsampleNetwork loaded from the flax convt2d kernels, flipped or not."""
    up = UpsampleNetwork(hp.upsample_scales, hp.freq_axis_kernel_size, '2D')
    sd = {}
    for i in range(len(hp.upsample_scales)):
        p = params['upsample_network'][f'convt2d_{i + 1}']
        k = np.asarray(p['kernel'], np.float32)
        k = k[::-1, ::-1] if flip else k
        sd[f'convs.{i}.weight'] = torch.from_numpy(k.transpose(2, 3, 0, 1).copy())
        sd[f'convs.{i}.bias'] = torch.tensor(np.asarray(p['bias'], np.float32))
    up.load_state_dict(sd)
    return up


def test_upsample_2d_matches_flax(paper_wavenet):
    """The 2D upsampler on random (not NN-init) weights against flax at 1e-5; without
    the kernel flip it misses. With the NN init (one centre row of equal values,
    symmetric under the flip) the unflipped kernel agrees too: a test on those
    weights could not see a missing flip."""
    hj, hp, params, model = paper_wavenet
    mel = np.random.default_rng(1).uniform(0, 1, (B, 3, 80)).astype(np.float32)
    want = JWaveNet(hj).apply({'params': params}, jnp.asarray(mel),
                              method=JWaveNet.upsample_conditioning)
    with torch.no_grad():
        got = model.upsample_conditioning(torch.from_numpy(mel))
        unflipped = _upsampler(params, hp, flip=False)(torch.from_numpy(mel))
    assert got.shape == (B, 3 * 275, 80) and got.min() > 0  # nothing zeroed
    assert _max_abs(want, got.numpy()) <= FP32_TOL
    assert _max_abs(want, unflipped.numpy()) > 0.1

    nn_params = JWaveNet(hj).init(jax.random.PRNGKey(0), jnp.zeros((1, 275, 1)),
                                  jnp.zeros((1, 1, 80)))['params']
    want = JWaveNet(hj).apply({'params': nn_params}, jnp.asarray(mel),
                              method=JWaveNet.upsample_conditioning)
    with torch.no_grad():
        nn_unflipped = _upsampler(nn_params, hp, flip=False)(torch.from_numpy(mel))
    assert _max_abs(want, nn_unflipped.numpy()) <= FP32_TOL


def test_forward_matches_flax(paper_wavenet):
    """The teacher-forced forward pass with the MoL-30 head and no legacy scaling."""
    hj, _, params, model = paper_wavenet
    rng = np.random.default_rng(2)
    mel = rng.uniform(0, 1, (B, 2, 80)).astype(np.float32)
    x = rng.uniform(-1, 1, (B, 550, 1)).astype(np.float32)
    want = JWaveNet(hj).apply({'params': params}, x, jnp.asarray(mel))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mel))
    assert got.shape == (B, 550, 30)
    assert _max_abs(want, got.numpy()) <= FP32_TOL


def test_pack_params_matches_jax(paper_wavenet):
    """The packing at out_channels=30: w_s2 (S, 30) and b_s2 stay f32."""
    hj, hp, params, model = paper_wavenet
    want = jax.device_get(jar.pack_params(params, hj))
    got = wavenet_ar.pack_params(model, hp)
    assert got['w_s2'].dtype == torch.float32 and tuple(got['w_s2'].shape) == (8, 30)
    for name, w in got.items():
        ref = np.asarray(want[name], np.float32)[:hp.cin_channels] if name == 'w_cond' \
            else np.asarray(want[name], np.float32)
        assert tuple(w.shape) == ref.shape, name
        tol = 1e-6 if w.dtype == torch.float32 else 1e-2 * max(1.0, np.abs(ref).max())
        assert _max_abs(w.float().numpy(), ref) <= tol, name


# --- the MoL head: plain version against the Pallas kernel ---------------------------

def test_make_noise_mol():
    """(B, T, nr+1): logistic noise in column 0, Gumbel in 1..nr, from u in
    [1e-5, 1-1e-5]; seeded; the same distributions as the JAX make_noise."""
    hj, hp = _hps()
    a = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(5), 4, 5000)
    b = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(5), 4, 5000)
    assert a.shape == (4, 5000, NR + 1) and a.dtype == torch.float32 and torch.equal(a, b)
    lim = float(np.log((1 - 1e-5) / 1e-5))
    assert a[..., 0].abs().max() <= lim + 1e-4
    assert a[..., 1:].min() >= -np.log(-np.log(1e-5)) - 1e-4
    assert a[..., 1:].max() <= -np.log(-np.log(1 - 1e-5)) + 1e-3
    j = np.asarray(jar.make_noise(hj, jax.random.PRNGKey(5), 4, 5000))
    assert j.shape == a.shape
    for col in (slice(0, 1), slice(1, None)):  # mean 0 and Euler's 0.5772; scale
        x, y = a[..., col].numpy(), j[..., col]
        assert abs(x.mean() - y.mean()) < 0.05 and abs(x.std() / y.std() - 1) < 0.03
    assert abs(a[..., 1:].mean().item() - 0.5772) < 0.03


@pytest.fixture(scope='module')
def pallas_runs(paper_wavenet):
    """Interpret-mode runs of the Pallas kernel over 2 frames (550 steps), for the
    mels of two seeds: at seed 1 one bf16 rounding flips between the kernel and the
    plain version (sequence 1, step 1); at seed 2 none does."""
    hj, hp, params, model = paper_wavenet
    runs = {}
    for seed in (1, 2):
        mel = np.random.default_rng(seed).uniform(0, 1, (B, 2, 80)).astype(np.float32)
        with torch.no_grad():
            c_up = model.upsample_conditioning(torch.from_numpy(mel)).numpy()
        noise = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(3), B,
                                      c_up.shape[1]).numpy()
        audio, dist = jar.generate_ar(jar.pack_params(params, hj), jnp.asarray(c_up),
                                      jnp.asarray(noise), hj, interpret=True)
        runs[seed] = c_up, noise, np.array(audio), np.array(dist)
    return runs


@pytest.mark.parametrize('seed', [1, 2])
def test_mol_reference_matches_pallas_interpret(paper_wavenet, pallas_runs, seed):
    """Teacher-forced on the Pallas audio, the plain version gives the kernel's
    per-step params (B, T, 30). Observed: at seed 2 every param within 2.4e-7; at
    seed 1 the same but for one bf16 flip of an activation (sequence 1, step 1),
    seen at that step and at the ring taps that read it later (7 steps): 0.63% of
    params beyond 1e-5, by up to 1.25e-2 (params span 9.2). Bounds from those
    readings: at most 1% of params beyond 1e-5, max 5e-2. The kernel's samples are
    the MoL draw from its params and the shared noise, and with targets the plain
    version feeds back exactly the kernel's audio."""
    _, hp, _, model = paper_wavenet
    c_up, noise, audio_j, params_j = pallas_runs[seed]
    weights = wavenet_ar.pack_params(model, hp)
    audio_t, params_t = wavenet_ar.generate_ar_reference(
        weights, torch.from_numpy(c_up), torch.from_numpy(noise), hp,
        targets=torch.from_numpy(audio_j))
    assert params_t.shape == params_j.shape == (B, c_up.shape[1], 30)
    err = np.abs(params_t.numpy() - params_j)
    assert np.mean(err > 1e-5) <= 0.01 and err.max() <= 5e-2, (np.mean(err > 1e-5),
                                                               err.max())
    drawn = wavenet_ar.mol_sample(torch.from_numpy(params_j), torch.from_numpy(noise), hp)
    assert _max_abs(drawn.numpy(), audio_j) <= 1e-6
    assert np.array_equal(audio_t.numpy(), audio_j)


def test_mol_free_running(paper_wavenet, pallas_runs):
    """Free-running over the first frame (275 steps) at seed 2, where no rounding
    flips, the plain version draws the Pallas kernel's audio from its own params:
    within 1e-6, in [-1, 1], and a deterministic function of the noise."""
    _, hp, _, model = paper_wavenet
    c_up, noise, audio_j, _ = pallas_runs[2]
    weights = wavenet_ar.pack_params(model, hp)
    c, n = torch.from_numpy(c_up[:, :275]), torch.from_numpy(noise[:, :275])
    audio, params = wavenet_ar.generate_ar_reference(weights, c, n, hp)
    assert _max_abs(audio.numpy(), audio_j[:, :275]) <= 1e-6
    assert torch.equal(wavenet_ar.mol_sample(params, n, hp), audio)
    assert torch.isfinite(audio).all() and audio.abs().max() <= 1.0
    again, none = wavenet_ar.generate_ar(weights, c, n, hp, return_params=False)
    assert none is None and torch.equal(again, audio)


def test_mol_tie_averages(paper_wavenet):
    """Logits tied by construction (zero logit weights, equal logit biases) and two
    equal Gumbel columns: the Pallas kernel and the plain version both draw from the
    average of the two mixtures' means and log-scales, not from argmax's first."""
    hj, hp, params, model = paper_wavenet
    rng = np.random.default_rng(4)
    mel = rng.uniform(0, 1, (B, 1, 80)).astype(np.float32)
    with torch.no_grad():
        c_up = model.upsample_conditioning(torch.from_numpy(mel)).numpy()
    T = c_up.shape[1]
    noise = np.concatenate([rng.logistic(size=(B, T, 1)),
                            np.full((B, T, NR), -2.0)], -1).astype(np.float32)
    noise[..., 1 + 3] = noise[..., 1 + 7] = 1.0  # mixtures 3 and 7 tie, every step

    def tie(w_s2, b_s2):
        w_s2, b_s2 = np.array(w_s2, np.float32), np.array(b_s2, np.float32)
        w_s2[:, :NR], b_s2[:NR] = 0.0, 0.3
        return w_s2, b_s2

    wj = dict(jar.pack_params(params, hj))
    wj['w_s2'], wj['b_s2'] = map(jnp.asarray, tie(wj['w_s2'], wj['b_s2']))
    audio_j, params_j = map(np.array, jar.generate_ar(wj, jnp.asarray(c_up),
                                                      jnp.asarray(noise), hj,
                                                      interpret=True))
    w = wavenet_ar.pack_params(model, hp)
    w['w_s2'], w['b_s2'] = map(torch.from_numpy, tie(w['w_s2'], w['b_s2']))
    audio_t, params_t = wavenet_ar.generate_ar_reference(
        w, torch.from_numpy(c_up), torch.from_numpy(noise), hp)
    assert np.all(params_j[..., :NR] == np.float32(0.3))
    p = params_t.numpy()
    mean = 0.5 * (p[..., NR + 3] + p[..., NR + 7])
    logs = np.maximum(0.5 * (p[..., 2 * NR + 3] + p[..., 2 * NR + 7]), hp.log_scale_min)
    want = np.clip(mean + np.exp(logs) * noise[..., 0], -1, 1)
    first = np.clip(p[..., NR + 3] + np.exp(np.maximum(p[..., 2 * NR + 3],
                                                       hp.log_scale_min))
                    * noise[..., 0], -1, 1)
    assert _max_abs(audio_t.numpy(), want) <= 1e-6
    assert _max_abs(audio_j, audio_t.numpy()) <= 1e-5
    assert _max_abs(params_j, p) <= 1e-5
    assert _max_abs(first, want) > 1e-2  # argmax's first index would draw elsewhere


# --- Tacotron at clip_outputs=False ---------------------------------------------------

@pytest.fixture(scope='module')
def paper_tacotron():
    """(JAX hp, port hp, flax variables with stop tokens suppressed, port model)."""
    hj, hp = _hps()
    rng = np.random.default_rng(6)
    k = jax.random.PRNGKey(0)
    inputs = jnp.zeros((B, 16), jnp.int32)
    init = partial(JTacotron(hj).init, max_iters=2, deterministic=True)
    variables = randomize_taco(jax.eval_shape(
        init, {'params': k, 'dropout': k, 'zoneout': k, 'teacher': k}, inputs,
        jnp.full((B,), 16, jnp.int32)), rng)
    variables = dict(variables, params=push_stop_bias(variables['params'], -100.0))
    model = Tacotron(hp)
    model.load_state_dict(convert.tacotron_state_dict(variables['params'],
                                                      variables['batch_stats']))
    return hj, hp, variables, model.eval()


def _dropout_key(hj, variables, inputs, lengths, rng, monkeypatch):
    """The prenet dropout key the JAX model hands its decoder, read from one eager
    apply with the synthesizer's rngs; and that apply's outputs."""
    seen = {}
    scan = jfd.synthesis_scan

    def recording(*args):
        seen['rng'] = args[8]
        return scan(*args)

    with monkeypatch.context() as m:
        m.setattr(jfd, 'synthesis_scan', recording)
        out = JTacotron(hj).apply(variables, jnp.asarray(inputs), jnp.asarray(lengths),
                                  max_iters=hj.max_iters, deterministic=True,
                                  rngs={'dropout': rng, 'teacher': jax.random.fold_in(rng, 7)})
    return seen['rng'], out


def test_tacotron_clip_outputs_false_matches_apply(paper_tacotron, monkeypatch):
    """The synthesis path at clip_outputs=False and predict_linear=False against
    Tacotron.apply over two 64-step decoder chunks, the same prenet masks: 1e-4. The
    postnet projection's bias is pushed by +5 so the mel leaves the clip range: the
    unclipped path is the one compared."""
    hj, hp, variables, _ = paper_tacotron
    hj, hp = hj.replace(max_iters=128), hp.replace(max_iters=128)
    params = jax.tree_util.tree_map(lambda x: x, variables['params'])
    params['postnet_projection']['bias'] = params['postnet_projection']['bias'] + 5.0
    variables = dict(variables, params=params)
    model = Tacotron(hp)
    model.load_state_dict(convert.tacotron_state_dict(params, variables['batch_stats']))
    inputs = np.random.default_rng(7).integers(2, 60, (B, 12)).astype(np.int32)
    lengths = np.asarray([12, 7], np.int32)
    inputs[1, 7:] = 0
    key, want = _dropout_key(hj, variables, inputs, lengths, jax.random.PRNGKey(3),
                             monkeypatch)
    masks = jax_prenet_masks(hj, key, B, 2, 64)
    got = model(torch.from_numpy(inputs), torch.from_numpy(lengths), max_iters=128,
                masks=masks)
    for name in ('decoder_output', 'mel_outputs', 'stop_token_prediction', 'alignments'):
        assert got[name].shape == want[name].shape, name
        assert _max_abs(want[name], got[name].numpy()) <= 1e-4, name
    assert 'linear_outputs' not in want
    mel = got['mel_outputs']
    assert mel.max() > hp.max_abs_value or mel.min() < -hp.max_abs_value - hp.lower_bound_decay


# --- the whole paper path -------------------------------------------------------------

def _noise_feed(noise):
    """take(B, n): the next n steps of `noise` (B rows), as make_noise would draw them."""
    pos = [0]

    def take(B, n):
        assert B == noise.shape[0], (B, noise.shape)
        out = noise[:, pos[0]:pos[0] + n]
        assert out.shape[1] == n
        pos[0] += n
        return out
    return take


def _patch_noise(monkeypatch, jax_noise, port_noise):
    """make_noise on both sides returns the next slices of the given arrays."""
    jtake, ptake = _noise_feed(jax_noise), _noise_feed(port_noise)
    monkeypatch.setattr(jar, 'make_noise', lambda hp, key, B, n: jnp.asarray(jtake(B, n)))
    monkeypatch.setattr(wavenet_ar, 'make_noise', lambda hp, gen, B, n, device=None:
                        torch.from_numpy(ptake(B, n)))


def _patch_masks(monkeypatch, masks, chunk):
    """The port's decoder draws, chunk after chunk, the JAX decoder's prenet masks;
    returns the list of those not drawn yet."""
    left = [m[i * chunk:(i + 1) * chunk] for i in range(len(masks[0]) // chunk)
            for m in masks]
    monkeypatch.setattr(tfd, 'prenet_masks', lambda shape, keep, gen, dev: left.pop(0))
    return left


@pytest.fixture(scope='module')
def paper_checkpoints(tmp_path_factory, paper_wavenet, paper_tacotron):
    tmp = tmp_path_factory.mktemp('paper_ckpt')
    _, _, wparams, _ = paper_wavenet
    _, _, tvars, _ = paper_tacotron
    taco, wave = str(tmp / 'taco.pt'), str(tmp / 'wavenet.pt')
    convert.save_checkpoint(taco, 'tacotron', convert.tacotron_state_dict(
        tvars['params'], tvars['batch_stats']))
    convert.save_checkpoint(wave, 'wavenet', convert.wavenet_state_dict(wparams))
    return taco, wave


def _jax_synthesizers(hj, tvars, wparams):
    """The JAX package's Tacotron and WaveNet synthesizers and its streaming
    synthesizer, loaded with the given weights instead of from checkpoints."""
    hj.freeze()
    taco = jtaco_synth.Synthesizer()
    taco._hp, taco.gta, taco._model = hj, False, JTacotron(hj)
    taco._cleaners = ['english_cleaners']
    taco._variables = tvars
    taco._pad_value = -hj.max_abs_value
    wave = jwave_synth.Synthesizer()
    wave._hp, wave._params = hj, wparams
    ss = jstreaming.StreamingSynthesizer.__new__(jstreaming.StreamingSynthesizer)
    ss._hp, ss._taco, ss._wn = hj, taco, wave
    return taco, wave, ss


TEXTS = ['The paper profile, twice.', 'He reads 2 books.']


def _record_port_ar(monkeypatch):
    """Wrap the port's generate_ar: each call's weights, c_up, noise and audio."""
    calls, generate_ar = [], wavenet_ar.generate_ar

    def recording(weights, c_up, noise, hp, **kw):
        out = generate_ar(weights, c_up, noise, hp, **kw)
        calls.append((weights, c_up, noise, out[0]))
        return out

    monkeypatch.setattr(wavenet_ar, 'generate_ar', recording)
    return calls


def _hold_audio(weights, c_up, noise, audio_j):
    """The JAX audio against the port: the port's plain version on the port's
    conditioning and noise, fed the JAX audio (teacher forcing), must draw the JAX
    sample at every step but those where a bf16 rounding flips between the two
    (with its ring taps). Free-running audio cannot be compared past the first flip:
    in the eval test below the two free runs part at steps 715 and 1,435. Observed:
    0.23-0.27% of steps differ; bound 2%. Returns the share of steps that differ."""
    _, hp = _hps()
    audio_j = torch.as_tensor(np.asarray(audio_j, np.float32))
    _, params = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp, targets=audio_j)
    err = (wavenet_ar.mol_sample(params, noise, hp) - audio_j).abs()
    share = (err > 1e-5).float().mean().item()
    assert share <= 0.02, share
    return share


def _dropout_masks(hj, tvars, texts, monkeypatch):
    """The prenet masks the JAX Tacotron synthesizer's decode of `texts` (padded to
    its batch and to pad_text_multiple, as _prepare_text_batch does) draws."""
    ids = [np.asarray(jtext.text_to_sequence(t, ['english_cleaners']), np.int32)
           for t in texts]
    T_in = -(-max(len(i) for i in ids) // hj.pad_text_multiple) * hj.pad_text_multiple
    inputs = np.stack([np.pad(i, (0, T_in - len(i))) for i in ids])
    key, _ = _dropout_key(hj, tvars, inputs, np.asarray([len(i) for i in ids], np.int32),
                          jax.random.PRNGKey(hj.tacotron_random_seed), monkeypatch)
    return jax_prenet_masks(hj, key, len(texts), 1, hj.max_iters)


@pytest.fixture()
def jax_side(paper_wavenet, paper_tacotron):
    hj, _, wparams, _ = paper_wavenet
    _, _, tvars, _ = paper_tacotron
    hj = hj.replace()
    return (hj, tvars, wparams) + _jax_synthesizers(hj, tvars, wparams)


def test_paper_eval_path_matches_jax(tmp_path, monkeypatch, jax_side, paper_checkpoints):
    """Text -> mel -> wav through `synthesize --paper_profile` on the CPU against the
    JAX package's Tacotron and WaveNet synthesizers (the WaveNet through its Pallas
    kernel in interpret mode) on the same converted weights, prenet masks and
    sampling noise: the AR conditioning within 1e-5 and the audio as _hold_audio
    states (observed: 12 of 4,400 steps, 0.27%)."""
    hj, tvars, wparams, taco_j, wave_j, _ = jax_side
    taco_pt, wave_pt = paper_checkpoints
    T = hj.max_iters * hj.outputs_per_step * hj.get_hop_size()
    masks = _dropout_masks(hj, tvars, TEXTS, monkeypatch)
    noise = wavenet_ar.make_noise(hj, torch.Generator().manual_seed(8), B, T).numpy()
    _patch_noise(monkeypatch, noise, noise)
    mels_j = taco_j.synthesize(TEXTS, ['a', 'b'], None, None, None)
    wavs_j = []
    monkeypatch.setattr(jwave_synth.audio, 'save_wavenet_wav',
                        lambda wav, *a, **k: wavs_j.append(np.asarray(wav)))
    monkeypatch.setattr(wt, 'generate', partial(wt.generate, use_pallas=True))
    wave_j.synthesize(mels_j, None, ['a', 'b'], str(tmp_path), None)
    c_up_j = JWaveNet(hj).apply({'params': wparams}, wave_j._prepare_conditions(mels_j),
                                method=JWaveNet.upsample_conditioning)

    masks_left = _patch_masks(monkeypatch, masks, hj.max_iters)
    calls = _record_port_ar(monkeypatch)
    texts = tmp_path / 'texts.txt'
    texts.write_text('\n'.join(TEXTS) + '\n', encoding='utf-8')
    stats = synthesize.main(['--paper_profile', '--tacotron_checkpoint', taco_pt,
                             '--wavenet_checkpoint', wave_pt, '--hparams', TINY,
                             '--text_list', str(texts), '--output_dir', str(tmp_path / 'o'),
                             '--device', 'cpu'])
    assert not masks_left and len(calls) == 1
    weights, c_up, noise_t, audio = calls[0]
    assert [len(w) for w in stats['wavs']] == [len(w) for w in wavs_j] == [T, T]
    assert np.array_equal(np.stack(stats['wavs']), audio.numpy())
    assert _max_abs(c_up.numpy(), c_up_j) <= FP32_TOL
    _hold_audio(weights, c_up, noise_t, np.stack(wavs_j))


def test_paper_served_stream_matches_jax(monkeypatch, jax_side, paper_checkpoints):
    """One served stream through `serve.build_server --paper_profile` (one GET, f32,
    chunks of 256 then 512 samples) on the CPU against the JAX package's
    StreamingSynthesizer on the same weights, prenet masks and noise: the same chunk
    lengths, the AR conditioning of every chunk within 1e-5, the served bytes the
    port's AR chunks, and the audio as _hold_audio states (observed: 5 of 2,200
    steps, 0.23%)."""
    hj, tvars, _, _, _, stream_j = jax_side
    taco_pt, wave_pt = paper_checkpoints
    T = hj.max_iters * hj.outputs_per_step * hj.get_hop_size()
    masks = _dropout_masks(hj, tvars, [TEXTS[0]] * B, monkeypatch)
    noise = wavenet_ar.make_noise(hj, torch.Generator().manual_seed(9), 1, T).numpy()
    _patch_noise(monkeypatch, noise, noise)
    jax_chunks, jax_ar = [], jar.generate_ar

    def recording(weights, c_up, noise, hp, **kw):
        jax_chunks.append(np.asarray(c_up))
        return jax_ar(weights, c_up, noise, hp, **kw)

    monkeypatch.setattr(jar, 'generate_ar', recording)
    sr = hj.sample_rate
    kw = dict(chunk_seconds=600 / sr, first_chunk_seconds=300 / sr)
    audio_j = np.concatenate([np.asarray(c) for c in stream_j.stream(TEXTS[0], seed=0, **kw)])
    assert [c.shape[1] for c in jax_chunks] == [256, 512, 512, 512, T - 1792]

    masks_left = _patch_masks(monkeypatch, masks, hj.max_iters)
    calls = _record_port_ar(monkeypatch)
    server = serve.build_server(['--paper_profile', '--taco_checkpoint', taco_pt,
                                 '--wave_checkpoint', wave_pt, '--device', 'cpu',
                                 '--hparams', TINY, '--port', '0', '--no-warmup',
                                 '--chunk_seconds', str(kw['chunk_seconds']),
                                 '--first_chunk_seconds', str(kw['first_chunk_seconds'])])
    server.start()
    try:
        conn = http.client.HTTPConnection(*server.address, timeout=120)
        conn.request('GET', '/tts?text=' + TEXTS[0].replace(' ', '+') + '&format=f32')
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
    finally:
        server.close()
    assert resp.status == 200 and not masks_left
    assert [c[1].shape[1] for c in calls] == [c.shape[1] for c in jax_chunks]
    for (_, c_up, _, _), c_up_j in zip(calls, jax_chunks):
        assert _max_abs(c_up.numpy(), c_up_j) <= FP32_TOL
    audio = torch.cat([c[3] for c in calls], 1)
    assert np.array_equal(np.frombuffer(data, np.float32), audio[0].numpy())
    assert len(data) == 4 * T
    _hold_audio(calls[0][0], torch.cat([c[1] for c in calls], 1),
                torch.cat([c[2] for c in calls], 1), audio_j[None])


@pytest.mark.parametrize('mode', ['synthesize-eval', 'synthesize-stream', 'serve'])
def test_paper_profile_on_both_clis(tmp_path, paper_checkpoints, mode):
    """`--paper_profile` starts from the paper hparams, --hparams on top: the paper
    checkpoints load and run (finite audio of max_iters * r * hop samples); without
    the flag the same command builds the default WaveNet and cannot load them."""
    taco_pt, wave_pt = paper_checkpoints
    n = 4 * 2 * 275
    if mode == 'serve':
        def run(flag):
            server = serve.build_server([*flag, '--taco_checkpoint', taco_pt,
                                         '--wave_checkpoint', wave_pt, '--device', 'cpu',
                                         '--hparams', TINY, '--port', '0',
                                         '--no-warmup']).start()
            try:
                conn = http.client.HTTPConnection(*server.address, timeout=120)
                conn.request('GET', '/tts?text=Hello+world.&format=f32')
                data = conn.getresponse().read()
                conn.close()
            finally:
                server.close()
            return [np.frombuffer(data, np.float32)]
    else:
        def run(flag):
            stats = synthesize.main([*flag, '--tacotron_checkpoint', taco_pt,
                                     '--wavenet_checkpoint', wave_pt, '--hparams', TINY,
                                     '--output_dir', str(tmp_path), '--device', 'cpu',
                                     '--mode', mode.split('-')[1],
                                     '--text_list', str(tmp_path / 't.txt')])
            return stats['wavs']
        (tmp_path / 't.txt').write_text('Hello world.\n', encoding='utf-8')
    wavs = run(['--paper_profile'])
    assert [len(w) for w in wavs] == [n]
    assert all(np.isfinite(w).all() and np.abs(w).max() <= 1.0 for w in wavs)
    with pytest.raises(RuntimeError, match='size mismatch'):
        run([])

