"""The standalone vocoder of the port (tacotron2_tpu_torch) against the JAX package:
global conditioning, the categorical (mulaw-quantize) head and the plain chain, from the
modules up to `synthesize --model WaveNet`.

Weights are seeded numpy noise on the flax tree, converted with
tacotron2_tpu_torch.convert; inputs and sampling noise are numpy arrays handed to both
sides. Tolerances: modules and the forward pass in f32 within 1e-5; the sample-by-sample
`incremental` within 1e-4 of the flax scan; the plain version of the AR kernel within
2e-2 of the Pallas kernel in interpret mode (the bound of tests/test_pallas_ar.py:64;
observed at most 1.2e-7 on these configs, both round the matmul operands to bf16 at the
same places).
"""

import os
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.inference import streaming as jstreaming
from tacotron2_tpu.inference import wavenet_synthesizer as jwave_synth
from tacotron2_tpu.models.wavenet import modules as jmod
from tacotron2_tpu.models.wavenet.model import WaveNet as JWaveNet
from tacotron2_tpu.ops import mulaw as jmulaw
from tacotron2_tpu.ops.pallas import wavenet_ar as jar
from tacotron2_tpu.training import wavenet_trainer as wt
from tacotron2_tpu_torch import convert, synthesize
from tacotron2_tpu_torch.inference import wavenet_synthesizer as wave_synth
from tacotron2_tpu_torch.inference.streaming import StreamingSynthesizer
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.wavenet import distributions as dist
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.ops import mulaw, wavenet_ar
import chip_smoke
from test_torch_paper import _patch_noise
from test_torch_wavenet import TINY, randomize

B, TC = 2, 8
FP32_TOL = 1e-5
INCREMENTAL_TOL = 1e-4
KERNEL_TOL = 2e-2
Q = 256
CAT = f",input_type='mulaw-quantize',quantize_channels={Q},out_channels={Q}"
GIN = ',gin_channels=16,n_speakers=4'
PLAIN = ',wavenet_fused_ar=False'
TACO_TINY = (",embedding_dim=32,enc_conv_channels=32,enc_conv_num_layers=1,"
             "encoder_lstm_units=16,attention_dim=16,attention_filters=8,"
             "attention_kernel=[7],prenet_layers=[16,16],decoder_lstm_units=32,"
             "postnet_channels=32,postnet_num_layers=2,outputs_per_step=2")
# the instantiations this slice adds, and B=17, where the conditioning row stays f32
VARIANTS = {'gaussian-plain': (PLAIN, B, None),
            'categorical-fused': (CAT, B, None),
            'categorical-plain': (CAT + PLAIN, B, None),
            'gaussian-fused+g': (GIN, B, [1, 3]),
            'gaussian-plain+g': (GIN + PLAIN, B, [1, 3]),
            'gaussian-fused+g-b17': (GIN, 17, [i % 4 for i in range(17)])}


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def make_pair(extra, seed=0):
    """(hp, flax params, port model) of the tiny WaveNet with `extra` hparams and the
    same seeded random weights on both sides."""
    hp = default_hparams()
    hp.parse(TINY + extra)
    in_channels = Q if wavenet_ar.is_categorical(hp) else 1
    args = [jnp.zeros((1, 32, in_channels)), jnp.zeros((1, 1, 80))]
    if hp.gin_channels > 0:
        args.append(jnp.zeros((1,), jnp.int32))
    params = jax.eval_shape(JWaveNet(hp).init, jax.random.PRNGKey(0), *args)['params']
    params = randomize(params, np.random.default_rng(seed))
    model = WaveNet(hp)
    model.load_state_dict(convert.wavenet_state_dict(params))
    return hp, params, model.eval()


@pytest.fixture(scope='module')
def pairs():
    cache = {}

    def get(extra):
        if extra not in cache:
            cache[extra] = make_pair(extra)
        return cache[extra]
    return get


# --- (a) modules --------------------------------------------------------------------

@pytest.mark.parametrize('part', ['embedding', 'residual_block_g', 'onehot_first_conv',
                                  'forward_g', 'forward_categorical_g'])
def test_conditioned_modules_match_jax(pairs, part):
    """The speaker Embedding, a residual block with conv1x1g, the one-hot first conv of
    Q inputs, and the teacher-forced forward(x, c, g) with the speaker embedding
    broadcast over time, against flax in f32."""
    extra = GIN + (CAT if 'categorical' in part or 'onehot' in part else '')
    hp, params, model = pairs(extra)
    rng = np.random.default_rng(1)
    T = TC * hp.get_hop_size()
    R, G = hp.residual_channels, hp.gate_channels
    ids = np.asarray([1, 3], np.int32)
    with torch.no_grad():
        if part == 'embedding':
            want = jmod.Embedding(4, 16).apply({'params': params['gc_embedding']}, ids)
            got = model.gc_embedding(torch.from_numpy(ids).long())
            assert np.abs(np.asarray(want)).max() > 0.05
        elif part == 'residual_block_g':
            x = rng.normal(size=(B, T, R)).astype(np.float32)
            c = rng.uniform(0, 1, (B, T, 80)).astype(np.float32)
            g = rng.normal(size=(B, T, 16)).astype(np.float32)
            jblk = jmod.ResidualConv1DGLU(R, G, hp.kernel_size, hp.skip_out_channels, 80, 16,
                                          0.0, 2)
            want = jblk.apply({'params': params['residual_block_2']}, x, c, g)
            no_g = jblk.apply({'params': params['residual_block_2']}, x, c, None)
            got = model.residual_layers[1](*map(torch.from_numpy, (x, c, g)))
            assert _max_abs(want[1], got[1]) <= FP32_TOL
            assert _max_abs(want[0], no_g[0]) > 1e-2  # g reaches the gate
            want, got = want[0], got[0]
        elif part == 'onehot_first_conv':
            y = rng.integers(0, Q, (B, T)).astype(np.int32)
            x = JWaveNet(hp).apply({'params': params}, y, method=JWaveNet.encode_input)
            want = jmod.Conv1x1(Q, R).apply({'params': params['first_conv']}, x)
            enc = model.encode_input(torch.from_numpy(y))
            assert enc.shape == (B, T, Q) and np.array_equal(enc.numpy(), np.asarray(x))
            got = model.first_conv(enc)
        else:
            mel = rng.uniform(0, 1, (B, TC, 80)).astype(np.float32)
            if 'categorical' in part:
                x = np.eye(Q, dtype=np.float32)[rng.integers(0, Q, (B, T))]
            else:
                x = rng.uniform(-1, 1, (B, T, 1)).astype(np.float32)
            want = JWaveNet(hp).apply({'params': params}, x, jnp.asarray(mel), jnp.asarray(ids))
            got = model(torch.from_numpy(x), torch.from_numpy(mel), torch.from_numpy(ids))
            assert got.shape == (B, T, hp.out_channels)
            swapped = model(torch.from_numpy(x), torch.from_numpy(mel),
                            torch.from_numpy(ids[::-1].copy()))
            assert (got - swapped).abs().max() > 1e-3  # the speaker matters
    assert _max_abs(want, got.numpy()) <= FP32_TOL


# --- (b) the incremental oracle -----------------------------------------------------

@pytest.mark.parametrize('with_g', [False, True], ids=['no-g', 'g'])
@pytest.mark.parametrize('head', ['gaussian', 'mol', 'categorical'])
def test_incremental_matches_jax(pairs, head, with_g):
    """WaveNet.incremental over the unpacked f32 modules, teacher-forced on the same
    targets as the flax scan: per-step params within 1e-4, the targets handed back as
    audio, silence (0.0, or class Q//2) as the first input."""
    extra = {'gaussian': '', 'mol': ',out_channels=30', 'categorical': CAT}[head] \
        + (GIN if with_g else '')
    hp, params, model = pairs(extra)
    rng = np.random.default_rng(2)
    frames = 2
    T = frames * hp.get_hop_size()
    mel = rng.uniform(0, 1, (B, frames, 80)).astype(np.float32)
    g = np.asarray([2, 0], np.int32) if with_g else None
    targets = (rng.integers(0, Q, (B, T)).astype(np.int32) if head == 'categorical'
               else rng.uniform(-0.8, 0.8, (B, T)).astype(np.float32))
    want = JWaveNet(hp).apply({'params': params}, jax.random.PRNGKey(0), jnp.asarray(mel),
                              None if g is None else jnp.asarray(g), None, None,
                              jnp.asarray(targets), method=JWaveNet.incremental)
    got = model.incremental(torch.from_numpy(mel), None if g is None else torch.from_numpy(g),
                            targets=torch.from_numpy(targets),
                            generator=torch.Generator().manual_seed(0))
    assert got['params'].shape == (B, T, hp.out_channels)
    assert _max_abs(got['params'].numpy(), want['params']) <= INCREMENTAL_TOL
    assert np.array_equal(got['audio'].numpy(), targets)
    assert got['audio'].dtype == (torch.int64 if head == 'categorical' else torch.float32)


@pytest.mark.parametrize('head', ['gaussian', 'mol', 'categorical'])
def test_incremental_free_running_draws_from_its_params(pairs, head):
    """Free-running on given noise (the layouts of wavenet_ar.make_noise), every sample
    is the head's draw from that step's params; without conditioning the length is
    synthesis_length."""
    extra = {'gaussian': '', 'mol': ',out_channels=30', 'categorical': CAT}[head]
    hp, _, model = pairs(extra)
    mel = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (B, 1, 80))
                           .astype(np.float32))
    noise = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(4), B, 32)
    out = model.incremental(mel, noise=noise)
    if head == 'categorical':
        want = dist.sample_from_categorical(out['params'], noise)
        assert out['audio'].min() >= 0 and out['audio'].max() < Q
    elif head == 'mol':
        want = dist.sample_from_discretized_mix_logistic(out['params'], hp.log_scale_min, noise)
    else:
        want = dist.sample_from_gaussian(out['params'], hp.log_scale_min_gauss, noise)
    assert torch.equal(out['audio'], want)
    drawn = model.incremental(mel, generator=torch.Generator().manual_seed(5))
    again = model.incremental(mel, generator=torch.Generator().manual_seed(5))
    assert torch.equal(drawn['audio'], again['audio'])
    with pytest.raises(ValueError):
        model.incremental(None)


# --- (c), (d), (e) the packed-weight AR path ----------------------------------------

def _ar_inputs(hp, params, model, batch, speakers, frames=TC, seed=3):
    """c_up, noise (numpy), and g_cond on both sides for `speakers`."""
    rng = np.random.default_rng(seed)
    mel = rng.uniform(0, 1, (batch, frames, 80)).astype(np.float32)
    with torch.no_grad():
        c_up = model.upsample_conditioning(torch.from_numpy(mel)).numpy()
    noise = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(seed), batch,
                                  c_up.shape[1]).numpy()
    g_j = g_t = None
    if speakers is not None:
        g = np.asarray(speakers, np.int32)
        g_emb = JWaveNet(hp).apply({'params': params}, jnp.asarray(g),
                                   method=JWaveNet._embed_global)
        g_j = jar.pack_global(params, hp, g_emb)
        g_t = wavenet_ar.pack_global(model, hp, model.embed_global(torch.from_numpy(g)))
    return c_up, noise, g_j, g_t


def _jnoise(noise):
    return jnp.asarray(noise if noise.ndim == 3 else noise[..., None])


def test_pack_global_matches_jax(pairs):
    """The (B, L*G) f32 speaker bias, within 1e-6 of the JAX pack_global."""
    hp, params, model = pairs(GIN)
    _, _, g_j, g_t = _ar_inputs(hp, params, model, 3, [0, 3, 1])
    assert g_t.shape == (3, hp.layers * hp.gate_channels) and g_t.dtype == torch.float32
    assert _max_abs(g_t.numpy(), g_j) <= 1e-6
    assert _max_abs(g_t[0].numpy(), g_t[1].numpy()) > 1e-2


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_reference_matches_pallas_interpret(pairs, variant):
    """generate_ar_reference, teacher-forced on the Pallas kernel's audio, gives the
    kernel's per-step params within 2e-2 (observed: 3.0e-8 to 1.2e-7), for the plain
    chain, the categorical head on both chains, and g_cond at B=2 (added before the
    conditioning row's bf16 rounding) and at B=17 (added to the f32 row). The kernel's
    samples follow from its params and the shared noise; the categorical ids are the
    first arg-max exactly, and the plain version free-running draws the same ids."""
    extra, batch, speakers = VARIANTS[variant]
    hp, params, model = pairs(extra)
    assert jar.supports(hp)
    wavenet_ar.check_supported(hp)
    c_up, noise, g_j, g_t = _ar_inputs(hp, params, model, batch, speakers,
                                       frames=4 if batch > 2 else TC)
    audio_j, params_j = map(np.array, jar.generate_ar(
        jar.pack_params(params, hp), jnp.asarray(c_up), _jnoise(noise), hp, g_cond=g_j,
        interpret=True))
    weights = wavenet_ar.pack_params(model, hp)
    assert ('w_fused' in weights) == hp.wavenet_fused_ar
    t = torch.from_numpy
    audio_t, params_t = wavenet_ar.generate_ar_reference(
        weights, t(c_up), t(noise), hp, targets=t(audio_j), g_cond=g_t)
    assert params_t.shape == params_j.shape == (batch, c_up.shape[1], hp.out_channels)
    assert _max_abs(params_t.numpy(), params_j) <= KERNEL_TOL
    assert np.array_equal(audio_t.numpy(), audio_j)
    drawn = wavenet_ar.sample(t(params_j), t(noise), hp).numpy()
    if wavenet_ar.is_categorical(hp):
        assert audio_t.dtype == torch.int64 and np.array_equal(drawn, audio_j)
        free, _ = wavenet_ar.generate_ar(weights, t(c_up), t(noise), hp, return_params=False)
        assert np.array_equal(free.numpy(), audio_j)
        assert len(np.unique(audio_j)) > 20
    else:
        assert _max_abs(drawn, audio_j) <= 1e-5
    if speakers is not None:  # the bias matters: without it the params move
        _, no_g = wavenet_ar.generate_ar_reference(weights, t(c_up), t(noise), hp,
                                                   targets=t(audio_j))
        assert _max_abs(no_g.numpy(), params_j) > 1e-2


@pytest.mark.parametrize('variant', ['categorical-plain', 'gaussian-fused+g'])
def test_state_carry_matches_pallas(pairs, variant):
    """Two state-carried chunks (128 + 128 steps) of the new variants: the plain
    version's params of both chunks within 2e-2 of the Pallas kernel's (observed
    1.2e-7), its state after chunk 1 within 1e-5 of the converted JAX state, and its
    chunked run exactly its one call."""
    extra, batch, speakers = VARIANTS[variant]
    hp, params, model = pairs(extra)
    c_up, noise, g_j, g_t = _ar_inputs(hp, params, model, batch, speakers)
    wj = jar.pack_params(params, hp)
    jn = _jnoise(noise)
    a1, p1, st_j = jar.generate_ar(wj, jnp.asarray(c_up[:, :128]), jn[:, :128], hp,
                                   g_cond=g_j, interpret=True, return_state=True)
    a2, p2 = jar.generate_ar(wj, jnp.asarray(c_up[:, 128:]), jn[:, 128:], hp, g_cond=g_j,
                             interpret=True, state_in=st_j)
    a1, p1, a2, p2 = map(np.array, (a1, p1, a2, p2))
    w = wavenet_ar.pack_params(model, hp)
    t = torch.from_numpy
    _, q1, st = wavenet_ar.generate_ar_reference(
        w, t(c_up[:, :128]), t(noise[:, :128]), hp, targets=t(a1), return_state=True,
        g_cond=g_t)
    rings_j, h_j, t_j = convert.stream_state_from_jax(jax.device_get(st_j), hp, batch)
    assert t_j == st[2] == 128
    assert _max_abs(st[0].numpy(), rings_j.numpy()) <= 1e-5
    assert _max_abs(st[1].numpy(), h_j.numpy()) <= 1e-5
    _, q2 = wavenet_ar.generate_ar_reference(
        w, t(c_up[:, 128:]), t(noise[:, 128:]), hp, targets=t(a2), state_in=st, g_cond=g_t)
    assert _max_abs(q1.numpy(), p1) <= KERNEL_TOL and _max_abs(q2.numpy(), p2) <= KERNEL_TOL

    full, full_p = wavenet_ar.generate_ar_reference(w, t(c_up), t(noise), hp, g_cond=g_t)
    b1, r1, state = wavenet_ar.generate_ar(w, t(c_up[:, :77]), t(noise[:, :77]), hp,
                                           return_state=True, g_cond=g_t)
    b2, r2 = wavenet_ar.generate_ar(w, t(c_up[:, 77:]), t(noise[:, 77:]), hp, state_in=state,
                                    g_cond=g_t)
    assert torch.equal(torch.cat([b1, b2], 1), full)
    assert torch.equal(torch.cat([r1, r2], 1), full_p)


def test_categorical_tie_averages(pairs):
    """Two classes tied by construction (zero logit weights and equal biases for classes
    3 and 7, equal noise far above the rest): the Pallas kernel and the plain version
    both emit the lower id and feed back the mean of the two bf16-rounded first-conv
    rows, not the first row alone."""
    hp, params, model = pairs(CAT)
    c_up, noise, _, _ = _ar_inputs(hp, params, model, B, None, frames=4)
    noise[..., [3, 7]] = 50.0

    def tie(w_s2, b_s2):
        w_s2, b_s2 = np.array(w_s2, np.float32), np.array(b_s2, np.float32)
        w_s2[:, [3, 7]], b_s2[[3, 7]] = 0.0, 0.3
        return w_s2, b_s2

    wj = dict(jar.pack_params(params, hp))
    wj['w_s2'], wj['b_s2'] = map(jnp.asarray, tie(wj['w_s2'], wj['b_s2']))
    ids_j, params_j, st_j = jar.generate_ar(wj, jnp.asarray(c_up), jnp.asarray(noise), hp,
                                            interpret=True, return_state=True)
    w = wavenet_ar.pack_params(model, hp)
    w['w_s2'], w['b_s2'] = map(torch.from_numpy, tie(w['w_s2'], w['b_s2']))
    ids_t, params_t, st = wavenet_ar.generate_ar_reference(
        w, torch.from_numpy(c_up), torch.from_numpy(noise), hp, return_state=True)
    assert np.all(np.asarray(ids_j) == 3) and bool((ids_t == 3).all())
    assert _max_abs(params_t.numpy(), params_j) <= 1e-5
    rows = w['first_w'][[3, 7]].bfloat16().float()
    mean = 0.5 * rows[0] + 0.5 * rows[1] + w['first_b']
    assert _max_abs(st[1].numpy(), mean.expand(B, -1).numpy()) <= 1e-6
    assert _max_abs(st[1].numpy(), np.asarray(st_j[1])[:B]) <= 1e-6
    assert _max_abs(st[1][0].numpy(), (rows[0] + w['first_b']).numpy()) > 1e-3


def test_categorical_starts_from_silence_and_feeds_back_bf16_rows(pairs):
    """A fresh categorical call starts from the first-conv row of class Q//2 alone; every
    later step feeds the bf16-rounded row of the class it drew."""
    hp, params, model = pairs(CAT)
    c_up, noise, _, _ = _ar_inputs(hp, params, model, B, None, frames=1)
    w = wavenet_ar.pack_params(model, hp)
    t = torch.from_numpy
    ids, _, state = wavenet_ar.generate_ar_reference(w, t(c_up), t(noise), hp,
                                                     return_state=True)
    rows = w['first_w'].bfloat16().float()
    assert torch.equal(state[1], rows[ids[:, -1]] + w['first_b'])
    assert not torch.equal(rows, w['first_w'])

    def first_params(first_w):
        return wavenet_ar.generate_ar_reference(dict(w, first_w=first_w), t(c_up[:, :1]),
                                                t(noise[:, :1]), hp)[1]
    moved = w['first_w'].clone()
    moved[Q // 2] += 0.1
    elsewhere = w['first_w'].clone()
    elsewhere[:Q // 2] += 0.1
    elsewhere[Q // 2 + 1:] += 0.1
    assert (first_params(moved) - first_params(w['first_w'])).abs().max() > 1e-3
    assert torch.equal(first_params(elsewhere), first_params(w['first_w']))


def test_make_noise_categorical():
    """(B, T, Q) Gumbel noise: finite (the uniform draw stays below 1 in f32, where the
    JAX package's maxval 1 - 1e-9 rounds to 1.0), seeded, with the Gumbel mean and
    variance."""
    hp = default_hparams()
    hp.parse(TINY + CAT)
    a = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(5), 4, 500)
    b = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(5), 4, 500)
    assert a.shape == (4, 500, Q) and a.dtype == torch.float32 and torch.equal(a, b)
    assert torch.isfinite(a).all()
    assert abs(a.mean().item() - 0.5772) < 0.02 and abs(a.var().item() - np.pi ** 2 / 6) < 0.05
    assert np.float32(1.0 - 1e-9) == np.float32(1.0)  # why the upper end is 1 - 2**-24
    assert np.isfinite(-np.log(-np.log(np.float32(1.0 - 2.0 ** -24))))


@pytest.mark.parametrize('x', [np.linspace(-1, 1, 101).astype(np.float32)])
def test_mulaw_copy_matches_reference(x):
    """ops/mulaw.py on arrays and on tensors against the JAX package's on arrays."""
    for mu in (255, 256):
        assert _max_abs(mulaw.mulaw(x, mu), jmulaw.mulaw(x, mu)) <= 1e-6
        assert _max_abs(mulaw.mulaw(torch.from_numpy(x), mu).numpy(), jmulaw.mulaw(x, mu)) <= 1e-6
        q = jmulaw.mulaw_quantize(x, mu)
        # truncation at a class edge may differ by one class between f32 and f64
        assert np.abs(mulaw.mulaw_quantize(x, mu) - q).max() <= 1
        assert np.abs(mulaw.mulaw_quantize(torch.from_numpy(x), mu).numpy() - q).max() <= 1
        assert mulaw.mulaw_quantize(torch.from_numpy(x), mu).dtype == torch.int32
        assert _max_abs(mulaw.inv_mulaw_quantize(q, mu), jmulaw.inv_mulaw_quantize(q, mu)) <= 1e-6
        assert _max_abs(mulaw.inv_mulaw_quantize(torch.from_numpy(q), mu).numpy(),
                        jmulaw.inv_mulaw_quantize(q, mu)) <= 1e-6
        y = jmulaw.mulaw(x, mu)
        assert _max_abs(mulaw.inv_mulaw(torch.from_numpy(np.asarray(y, np.float32)), mu).numpy(),
                        jmulaw.inv_mulaw(y, mu)) <= 1e-6
    assert mulaw.mulaw_quantize(0.0, 256) == 128  # silence is class Q // 2
    for kind in ('raw', 'mulaw', 'mulaw-quantize'):
        for name in ('is_mulaw_quantize', 'is_mulaw', 'is_raw', 'is_scalar_input'):
            assert getattr(mulaw, name)(kind) == getattr(jmulaw, name)(kind)


def test_kernel_mutants_apply_to_the_source():
    """Each planted fault of chip_smoke.KERNEL_MUTANTS changes exactly one place of
    csrc/wavenet_ar.cu (the card's smoke run builds these copies beside the kernel)."""
    with open(os.path.join(os.path.dirname(wavenet_ar.__file__), '..', 'csrc',
                           'wavenet_ar.cu'), encoding='utf-8') as f:
        source = f.read()
    texts = {fault: chip_smoke.mutated_source(fault) for fault in chip_smoke.KERNEL_MUTANTS}
    assert len(texts) == 3 and len(set(texts.values())) == 3
    for fault, text in texts.items():
        old, new = chip_smoke.KERNEL_MUTANTS[fault]
        assert text != source and text.replace(new, old) == source, fault


# --- (f) the mels input -------------------------------------------------------------

def test_resolve_mels_input(tmp_path, monkeypatch):
    """A bare dir of mels, and the three map formats (eval, GTA, preprocessing), as the
    JAX resolve_mels_input reads them; a dir that holds a map.txt is read as a map."""
    d = tmp_path / 'eval'
    (d / 'mels').mkdir(parents=True)
    for name in ('mel-b.npy', 'mel-a.npy', 'notes.txt'):
        (d / name).write_bytes(b'')
    (d / 'mels' / 'mel-c.npy').write_bytes(b'')
    bare = wave_synth.resolve_mels_input(str(d))
    assert bare == jwave_synth.resolve_mels_input(str(d))
    assert bare == (['', ''], [str(d / 'mel-a.npy'), str(d / 'mel-b.npy')])
    maps = {'eval': 'hello|mel-a.npy\nworld|mel-c.npy\n',
            'gta': 'w.npy|gt.npy|mel-b.npy|<no_g>|some text\n',
            'preprocess': f'audio-1.npy|{d / "mel-a.npy"}|x|<no_g>|8800|32\n'}
    monkeypatch.chdir(tmp_path)  # no file of these names in the working directory
    for kind, text in maps.items():
        (d / 'map.txt').write_text(text, encoding='utf-8')
        for arg in (str(d), str(d / 'map.txt')):
            got = wave_synth.resolve_mels_input(arg)
            assert got == jwave_synth.resolve_mels_input(arg), kind
    assert got == ([''], [str(d / 'mel-a.npy')])
    (d / 'map.txt').write_text(maps['eval'], encoding='utf-8')
    assert wave_synth.resolve_mels_input(str(d)) == (
        ['hello', 'world'], [str(d / 'mel-a.npy'), str(d / 'mels' / 'mel-c.npy')])
    (d / 'map.txt').write_text('', encoding='utf-8')
    with pytest.raises(ValueError):
        wave_synth.resolve_mels_input(str(d))


def test_resolve_prefers_the_maps_directory(tmp_path, monkeypatch):
    """Stated divergence from the JAX package: a relative mel path in a map is looked
    for in the map's own directory before the working directory. The JAX
    resolve_mels_input (wavenet_synthesizer.py:151-159) returns a same-named file in
    the working directory, which shadows the map's mel; the port does not."""
    d = tmp_path / 'eval'
    d.mkdir()
    (d / 'mel-a.npy').write_bytes(b'')
    (d / 'map.txt').write_text('hello|mel-a.npy\n', encoding='utf-8')
    cwd = tmp_path / 'cwd'
    cwd.mkdir()
    (cwd / 'mel-a.npy').write_bytes(b'')
    (cwd / 'mel-z.npy').write_bytes(b'')
    monkeypatch.chdir(cwd)
    assert wave_synth.resolve_mels_input(str(d))[1] == [str(d / 'mel-a.npy')]
    assert jwave_synth.resolve_mels_input(str(d))[1] == ['mel-a.npy']  # the shadowing
    # a file that only the working directory has is still found there
    (d / 'map.txt').write_text('hello|mel-z.npy\n', encoding='utf-8')
    assert wave_synth.resolve_mels_input(str(d))[1] == ['mel-z.npy']


# --- (g) the path as a whole --------------------------------------------------------

def _record(monkeypatch, module):
    """Wrap module.generate_ar: (c_up, noise, g_cond, audio) of each call."""
    calls, generate_ar = [], module.generate_ar

    def recording(weights, c_up, noise, hp, **kw):
        out = generate_ar(weights, c_up, noise, hp, **kw)
        calls.append((c_up, noise, kw.get('g_cond'), out[0]))
        return out

    monkeypatch.setattr(module, 'generate_ar', recording)
    return calls


def _hold(hp, model, port_call, audio_j):
    """The JAX audio against the port: the port's plain version on the port's
    conditioning, noise and g_cond, teacher-forced on the JAX audio, must draw the JAX
    sample at every step but those where a bf16 rounding flips between the two.
    Observed: no such step on these configs; bound 2% (as tests/test_torch_paper.py)."""
    c_up, noise, g_cond, _ = port_call
    kind = np.int64 if wavenet_ar.is_categorical(hp) else np.float32
    audio_j = torch.from_numpy(np.array(audio_j, kind))
    _, params = wavenet_ar.generate_ar_reference(wavenet_ar.pack_params(model, hp), c_up, noise,
                                                 hp, targets=audio_j, g_cond=g_cond)
    drawn = wavenet_ar.sample(params, noise, hp)
    off = (drawn != audio_j) if kind is np.int64 else ((drawn - audio_j).abs() > 1e-5)
    assert off.float().mean().item() <= 0.02


def _write_mels(d, hp, frames, seed=6):
    rng = np.random.default_rng(seed)
    d.mkdir()
    files = []
    for i, n in enumerate(frames):
        path = d / f'mel-utt{i}.npy'
        np.save(path, rng.uniform(-hp.max_abs_value, hp.max_abs_value, (n, 80))
                .astype(np.float32))
        files.append(str(path))
    return files


@pytest.mark.parametrize('config', ['speakers', 'quantized-plain', 'mulaw'])
def test_run_synthesis_matches_jax(tmp_path, monkeypatch, pairs, config):
    """run_synthesis over a dir of three mels in batches of two, against the JAX
    Synthesizer.synthesize (its WaveNet through the Pallas kernel in interpret mode) on
    the same weights, speaker ids and sampling noise: the same batches, the AR
    conditioning within 1e-5, the audio as _hold states, the output decoded alike
    (inv_mulaw, inv_mulaw_quantize), wavs named wav-{basename}.wav and map.txt rows
    text|mel|wav."""
    extra = {'speakers': GIN, 'quantized-plain': CAT + PLAIN,
             'mulaw': ",input_type='mulaw'"}[config] + ',wavenet_synthesis_batch_size=2'
    hp, params, model = pairs(extra)
    hp.freeze()
    files = _write_mels(tmp_path / 'mels', hp, (3, 5, 4))
    speaker_id = '1,3,0' if config == 'speakers' else None
    hop = hp.get_hop_size()
    noise = [wavenet_ar.make_noise(hp, torch.Generator().manual_seed(8 + i), 2 if i == 0 else 1,
                                   (5 if i == 0 else 4) * hop).numpy() for i in range(2)]

    def feed(side):
        left = list(noise)
        if side == 'jax':
            return lambda hp, key, B, n: _jnoise(left.pop(0))
        return lambda hp, gen, B, n, device=None: torch.from_numpy(left.pop(0))

    wave_j = jwave_synth.Synthesizer()
    wave_j._hp, wave_j._params = hp, params
    wavs_j = []
    monkeypatch.setattr(jwave_synth.audio, 'save_wavenet_wav',
                        lambda wav, *a, **k: wavs_j.append(np.asarray(wav)))
    monkeypatch.setattr(jar, 'make_noise', feed('jax'))
    jax_audio, jax_generate = [], wt.generate

    def generate(*args, **kw):  # through the Pallas kernel; its raw audio kept
        out = jax_generate(*args, **kw, use_pallas=True)
        jax_audio.append(np.asarray(out['audio']))
        return out

    monkeypatch.setattr(wt, 'generate', generate)
    sids = [int(s) for s in speaker_id.split(',')] if speaker_id else None
    jax_calls = []
    for i in (0, 2):
        mels = [np.load(p) for p in files[i:i + 2]]
        part = sids[i:i + 2] if sids else None
        wave_j.synthesize(mels, part, ['a', 'b'][:len(mels)], str(tmp_path), None)
        c_up_j = JWaveNet(hp).apply({'params': params}, wave_j._prepare_conditions(mels),
                                    method=JWaveNet.upsample_conditioning)
        g_j = None
        if part is not None:
            g_j = jar.pack_global(params, hp, JWaveNet(hp).apply(
                {'params': params}, jnp.asarray(part, jnp.int32),
                method=JWaveNet._embed_global))
        jax_calls.append((c_up_j, None, g_j, jax_audio[-1]))

    monkeypatch.setattr(wavenet_ar, 'make_noise', feed('port'))
    calls = _record(monkeypatch, wavenet_ar)
    out = tmp_path / 'out'
    stats = wave_synth.run_synthesis(model, hp, str(out), str(tmp_path / 'mels'), speaker_id)
    assert [c[0].shape[:2] for c in calls] == [(2, 5 * hop), (1, 4 * hop)]
    assert [len(w) for w in stats['wavs']] == [len(w) for w in wavs_j] == [3 * hop, 5 * hop,
                                                                          4 * hop]
    for call, (c_up_j, _, g_j, audio_j) in zip(calls, jax_calls):
        assert _max_abs(call[0].numpy(), c_up_j) <= FP32_TOL
        assert (call[2] is None) == (g_j is None) == (config != 'speakers')
        if g_j is not None:
            assert _max_abs(call[2].numpy(), g_j) <= 1e-6
        _hold(hp, model, call, np.asarray(audio_j))
    # the decoded output: the port's own AR audio through the JAX package's decoder
    raw = [calls[0][3][0, :3 * hop], calls[0][3][1], calls[1][3][0]]
    decode = {'speakers': lambda y, q: y, 'mulaw': jmulaw.inv_mulaw,
              'quantized-plain': jmulaw.inv_mulaw_quantize}[config]
    for wav, y in zip(stats['wavs'], raw):
        assert _max_abs(wav, decode(y.numpy(), hp.quantize_channels)) <= 1e-6
        assert np.abs(wav).max() <= 1.0
    want_paths = [str(out / 'wavs' / f'wav-utt{i}.wav') for i in range(3)]
    assert stats['wav_paths'] == want_paths and all(os.path.isfile(p) for p in want_paths)
    rows = (out / 'map.txt').read_text(encoding='utf-8').splitlines()
    assert rows == [f'|{m}|{w}' for m, w in zip(files, want_paths)]
    assert stats['ar_samples'] == (2 * 5 + 4) * hop


def test_synth_debug_teacher_forces_through_incremental(tmp_path, monkeypatch, pairs):
    """hp.wavenet_synth_debug: both packages generate teacher-forced on
    hp.wavenet_debug_wavs (zero-padded or cut to the batch's length) through their
    sample-by-sample oracle, so the output is the decoded targets, trimmed per mel; the
    port takes WaveNet.incremental, not the packed-weight path."""
    hp, params, model = pairs(",input_type='mulaw'" + GIN)
    hop = hp.get_hop_size()
    rng = np.random.default_rng(7)
    debug = []
    for i, n in enumerate((2 * hop + 5, 5 * hop)):
        path = tmp_path / f'debug{i}.npy'
        np.save(path, rng.uniform(-0.9, 0.9, n).astype(np.float32))
        debug.append(str(path))
    hp = hp.replace(wavenet_synth_debug=True, wavenet_debug_wavs=tuple(debug))
    hp.freeze()
    mels = [rng.uniform(-4, 4, (n, 80)).astype(np.float32) for n in (3, 2)]
    wave_j = jwave_synth.Synthesizer()
    wave_j._hp, wave_j._params = hp, params
    wavs_j = []
    monkeypatch.setattr(jwave_synth.audio, 'save_wavenet_wav',
                        lambda wav, *a, **k: wavs_j.append(np.asarray(wav)))
    wave_j.synthesize(mels, [1, 2], ['a', 'b'], str(tmp_path), None)
    calls = _record(monkeypatch, wavenet_ar)
    got = wave_synth.Synthesizer(model, hp).synthesize(
        [torch.from_numpy(m) for m in mels], torch.Generator().manual_seed(0), [1, 2])
    assert not calls
    assert [len(w) for w in got] == [3 * hop, 2 * hop]
    for a, b in zip(got, wavs_j):
        assert _max_abs(a, b) <= 1e-6
    assert np.count_nonzero(got[0][2 * hop + 5:]) == 0  # past the debug wav: silence


def test_generate_dispatch(monkeypatch, pairs):
    """generate takes the packed-weight path when free-running with conditioning on a
    supported config, and WaveNet.incremental for teacher forcing and on request;
    speaker ids reach both. More classes than the kernel takes raise, from generate and
    from the Synthesizer, whatever the device: no plain version stands in for the
    big-vocab kernel."""
    hp, _, model = pairs(GIN)
    calls = _record(monkeypatch, wavenet_ar)
    c = torch.from_numpy(np.random.default_rng(8).uniform(0, 1, (B, 1, 80)).astype(np.float32))
    g = torch.tensor([1, 3])
    gen = torch.Generator().manual_seed(1)
    out = wave_synth.generate(model, hp, gen, c, g)
    assert len(calls) == 1 and calls[0][2] is not None
    assert out['audio'].shape == (B, 32) and out['params'].shape == (B, 32, 2)
    assert 'params' not in wave_synth.generate(model, hp, gen, c, g, return_params=False)
    oracle = wave_synth.generate(model, hp, gen, c, g, use_kernel=False)
    forced = wave_synth.generate(model, hp, gen, c, g, targets=out['audio'])
    assert len(calls) == 2 and oracle['audio'].shape == (B, 32)
    assert torch.equal(forced['audio'], out['audio'])
    # the oracle's f32 params on the AR path's audio: bf16 weights apart
    assert (forced['params'] - out['params']).abs().max() <= 5e-2
    no_g = wave_synth.generate(model, hp, gen, c, None, targets=out['audio'])
    assert (no_g['params'] - forced['params']).abs().max() > 1e-3

    big = default_hparams()
    big.parse(TINY + ",input_type='mulaw-quantize',quantize_channels=2048,out_channels=2048")
    big_model = WaveNet(big).eval()
    with pytest.raises(NotImplementedError, match='big-vocab'):
        wave_synth.generate(big_model, big, gen, c[:, :1], return_params=False)
    with pytest.raises(NotImplementedError, match='big-vocab'):
        wave_synth.Synthesizer(big_model, big)
    assert len(calls) == 2
    ids = wave_synth.generate(big_model, big, gen, c[:, :1], use_kernel=False)
    assert ids['audio'].dtype == torch.int64


@pytest.fixture(scope='module')
def vocoder_checkpoint(tmp_path_factory, pairs):
    tmp = tmp_path_factory.mktemp('vocoder_ckpt')
    paths = {}
    for name, extra in (('speakers', GIN), ('quantized', CAT + PLAIN)):
        _, params, _ = pairs(extra)
        paths[name] = str(tmp / f'{name}.pt')
        convert.save_checkpoint(paths[name], 'wavenet', convert.wavenet_state_dict(params))
    return paths


@pytest.mark.parametrize('config', ['speakers', 'quantized'])
def test_wavenet_cli_on_cpu(tmp_path, monkeypatch, vocoder_checkpoint, config):
    """`synthesize --model WaveNet --device cpu` over a mels dir with a map.txt: wavs
    under <base_dir>/wavenet_output/wavs, map.txt rows text|mel|wav, no Tacotron
    checkpoint needed; a relative --mels_dir is found under --base_dir; a --speaker_id
    count that is not the number of mels raises ValueError; --device cuda without a
    card raises."""
    extra = {'speakers': GIN, 'quantized': CAT + PLAIN}[config]
    hp = default_hparams()
    hp.parse(TINY + extra)
    files = _write_mels(tmp_path / 'mels', hp, (3, 2))
    (tmp_path / 'mels' / 'map.txt').write_text('one|mel-utt0.npy\ntwo|mel-utt1.npy\n',
                                                encoding='utf-8')
    monkeypatch.chdir(tmp_path / 'mels')  # so that the relative --mels_dir is not found here
    argv = ['--model', 'WaveNet', '--wavenet_checkpoint', vocoder_checkpoint[config],
            '--hparams', TINY + extra, '--mels_dir', 'mels', '--base_dir', str(tmp_path)]
    speakers = ['--speaker_id', '1,3'] if config == 'speakers' else []
    stats = synthesize.main(argv + speakers + ['--device', 'cpu'])
    hop = hp.get_hop_size()
    out = tmp_path / 'wavenet_output'
    assert stats['output_dir'] == str(out)
    assert [len(w) for w in stats['wavs']] == [3 * hop, 2 * hop]
    assert all(np.isfinite(w).all() and np.abs(w).max() <= 1.0 for w in stats['wavs'])
    wavs = [str(out / 'wavs' / f'wav-utt{i}.wav') for i in range(2)]
    assert all(os.path.isfile(w) for w in wavs)
    assert (out / 'map.txt').read_text(encoding='utf-8').splitlines() == [
        f'{t}|{m}|{w}' for t, m, w in zip(('one', 'two'), files, wavs)]
    if config == 'speakers':
        other = synthesize.main(argv + ['--speaker_id', '3,3', '--device', 'cpu'])
        assert np.abs(other['wavs'][0] - stats['wavs'][0]).max() > 1e-3
        assert np.array_equal(other['wavs'][1], stats['wavs'][1])
        with pytest.raises(ValueError, match='speaker_id'):
            synthesize.main(argv + ['--speaker_id', '1', '--device', 'cpu'])
    with pytest.raises(SystemExit):
        synthesize.main(argv + ['--mode', 'stream', '--device', 'cpu'])
    with pytest.raises(SystemExit):  # the default model needs a Tacotron checkpoint
        synthesize.main(['--wavenet_checkpoint', vocoder_checkpoint[config], '--device', 'cpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            synthesize.main(argv + speakers)


def test_speaker_id_reaches_the_tacotron2_eval_path(tmp_path, vocoder_checkpoint):
    """--speaker_id on the text -> wav path conditions the WaveNet stage, one id a
    sentence; another count raises."""
    hp = default_hparams()
    hp.parse(TINY + GIN + TACO_TINY + ',max_iters=4')
    torch.manual_seed(0)
    taco = str(tmp_path / 'taco.pt')
    convert.save_checkpoint(taco, 'tacotron', Tacotron(hp).state_dict())
    texts = tmp_path / 'texts.txt'
    texts.write_text('Hello world.\nHe reads books.\n', encoding='utf-8')
    argv = ['--tacotron_checkpoint', taco, '--wavenet_checkpoint',
            vocoder_checkpoint['speakers'], '--hparams', TINY + GIN + TACO_TINY + ',max_iters=4',
            '--text_list', str(texts), '--output_dir', str(tmp_path / 'o'), '--device', 'cpu']
    a = synthesize.main(argv + ['--speaker_id', '1,3'])
    b = synthesize.main(argv + ['--speaker_id', '2,3'])
    assert len(a['wavs']) == 2 and len(a['wavs'][0]) == len(b['wavs'][0])
    assert np.abs(a['wavs'][0] - b['wavs'][0]).max() > 1e-3
    assert np.array_equal(a['wavs'][1], b['wavs'][1])
    with pytest.raises(ValueError, match='speaker_id'):
        synthesize.main(argv + ['--speaker_id', '1,2,3'])


# --- (h) streaming ------------------------------------------------------------------

@pytest.mark.parametrize('config', ['speakers', 'quantized'])
def test_stream_from_mel_matches_jax(monkeypatch, pairs, config):
    """stream_from_mel(speaker_id=...) on a multi-speaker WaveNet, and a mulaw-quantize
    stream, against the JAX StreamingSynthesizer on the same weights and noise: the same
    chunk lengths, each chunk's AR conditioning within 1e-5 and g_cond within 1e-6, the
    JAX AR audio as _hold states, and the port's chunks are its AR audio decoded and
    de-emphasised with the filter state carried."""
    extra = {'speakers': GIN, 'quantized': CAT}[config]
    hp, params, model = pairs(extra + TACO_TINY)
    hp.freeze()
    hop = hp.get_hop_size()
    n_frames = 11
    T = n_frames * hop
    rng = np.random.default_rng(4)
    mel = rng.uniform(-hp.max_abs_value, hp.max_abs_value, (n_frames, 80)).astype(np.float32)
    noise = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(9), 1, T).numpy()
    _patch_noise(monkeypatch, _jnoise(noise), noise)
    wave_j = jwave_synth.Synthesizer()
    wave_j._hp, wave_j._params = hp, params
    jss = jstreaming.StreamingSynthesizer.__new__(jstreaming.StreamingSynthesizer)
    jss._hp, jss._wn = hp, wave_j
    kw = dict(seed=11, chunk_seconds=256 / hp.sample_rate,
              first_chunk_seconds=128 / hp.sample_rate,
              speaker_id=2 if config == 'speakers' else None)
    jax_calls = _record(monkeypatch, jar)
    want = list(jss.stream_from_mel(mel, **kw))
    torch.manual_seed(0)
    pss = StreamingSynthesizer(Tacotron(hp), model, hp, 'cpu')
    calls = _record(monkeypatch, wavenet_ar)
    got = list(pss.stream_from_mel(mel, **kw))
    assert [len(x) for x in got] == [len(x) for x in want] == [128, T - 128]
    for call, (c_up_j, _, g_j, _) in zip(calls, jax_calls):
        assert _max_abs(call[0].numpy(), c_up_j) <= FP32_TOL
        assert (g_j is not None) == (config == 'speakers')
        if g_j is not None:
            assert _max_abs(call[2].numpy(), g_j) <= 1e-6
    joined = (torch.cat([c[0] for c in calls], 1), torch.cat([c[1] for c in calls], 1),
              calls[0][2], None)
    _hold(hp, model, joined, np.concatenate([np.asarray(c[3]) for c in jax_calls], 1))
    raw = torch.cat([c[3] for c in calls], 1)[0].numpy()
    if config == 'quantized':
        assert raw.dtype == np.int64
        raw = jmulaw.inv_mulaw_quantize(raw, Q)
    one_shot = lfilter([1.0], [1.0, -hp.preemphasis], raw)
    assert hp.preemphasize and _max_abs(np.concatenate(got), one_shot) <= 1e-6
    if config == 'speakers':
        assert len(pss._vocoder._g_cache) == 1
        _patch_noise(monkeypatch, noise, noise)
        list(pss.stream_from_mel(mel, **kw))
        assert len(pss._vocoder._g_cache) == 1  # packed once per speaker
        _patch_noise(monkeypatch, noise, noise)
        other = np.concatenate(list(pss.stream_from_mel(mel, **dict(kw, speaker_id=0))))
        assert len(pss._vocoder._g_cache) == 2
        assert other.shape == (T,)
