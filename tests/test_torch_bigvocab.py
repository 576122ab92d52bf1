"""The big-vocab categorical head and the in-kernel NLL of the port's AR path against
the JAX package (`tacotron2_tpu/ops/pallas/wavenet_ar.py`: `is_big_vocab`, `y_eval`).

On the CPU the port runs the plain PyTorch versions (`generate_ar_reference`); the CUDA
kernel is held to them on the card (`chip_smoke.py` phase 10, `tests/test_torch_cuda.py`).
Here the plain versions are held to the Pallas kernel in interpret mode on the same
packed weights, at Q = 2,048 (big) and Q = 256 (small), T = 128, tiny widths, inputs
from numpy seeds. The Pallas kernel's own random bits exist only on a TPU, so the two
sides are compared greedily; the port's noise (Philox4x32-10) is held to its published
test vectors and to its distribution. Tolerances are stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.models.wavenet.model import WaveNet as JWaveNet
from tacotron2_tpu.ops.pallas import wavenet_ar as jar
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.inference import streaming, wavenet_synthesizer
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.ops import wavenet_ar

from test_torch_wavenet import TINY, randomize

B, T = 2, 128


def quantized(Q, extra=''):
    hp = default_hparams()
    hp.parse(TINY + f",input_type='mulaw-quantize',quantize_channels={Q},out_channels={Q}"
             + extra)
    return hp


def make_pair(Q, extra='', head_boost=1.0, seed=0):
    """(hp, flax params, port model, c_up (B, T, 80) numpy) on seeded random weights;
    `head_boost` scales the last head layer's kernel so that arg-max gaps dwarf
    rounding."""
    hp = quantized(Q, extra)
    rng = np.random.default_rng(seed)
    params = jax.eval_shape(JWaveNet(hp).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, Q)), jnp.zeros((1, 1, 80)))['params']
    params = randomize(params, rng)
    params['skip_conv2'] = dict(params['skip_conv2'],
                                kernel=params['skip_conv2']['kernel'] * head_boost)
    model = WaveNet(hp)
    model.load_state_dict(convert.wavenet_state_dict(params))
    # conditioning that changes at every step (an upsampled mel is constant over a
    # frame, and the greedy ids of random weights then settle on a few classes)
    c_up = rng.uniform(0.0, 1.0, (B, T, 80)).astype(np.float32)
    return hp, params, model.eval(), c_up


@pytest.fixture(scope='module')
def big():
    """Q = 2,048 with the head boosted 20x, the JAX kernel's greedy ids and in-kernel
    NLL of seeded targets (interpret mode), and the port's packed weights."""
    Q = 2048
    hp, params, model, c_up = make_pair(Q, head_boost=20.0)
    y = np.random.default_rng(5).integers(0, Q, (B, c_up.shape[1])).astype(np.int32)
    jw = jar.pack_params(params, hp)
    ids, nll = jar.generate_ar(jw, jnp.asarray(c_up), jnp.zeros((B, c_up.shape[1], 1)), hp,
                               interpret=True, return_params=False, greedy=True,
                               y_eval=jnp.asarray(y))
    return dict(hp=hp, params=params, model=model, c_up=torch.from_numpy(c_up.copy()),
                y=torch.from_numpy(y).long(), jw=jw, ids=np.asarray(ids),
                nll=np.asarray(nll), weights=wavenet_ar.pack_params(model, hp))


# ---------------------------------------------------------------- the noise

@pytest.mark.parametrize('counter,key,want', [
    ((0, 0, 0, 0), (0, 0), '6627e8d5 e169c58d bc57ac4c 9b00dbd8'),
    ((0xffffffff,) * 4, (0xffffffff,) * 2, '408f276d 41c83b0e a20bc7c6 6d5451fd'),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     'd16cfe09 94fdcceb 5001e420 24126ea1')])
def test_philox_known_answers(counter, key, want):
    """Philox4x32-10 against the known-answer vectors published with Random123
    (kat_vectors: zeros, all ones, digits of pi): exact."""
    out = wavenet_ar.philox4x32_10([torch.tensor([c]) for c in counter], key)
    assert ' '.join(f'{int(o):08x}' for o in out) == want


def test_gumbel_transform_range_and_moments():
    """The noise transform is finite at both ends of its 23-bit uniform (u = 0 gives
    -log(-log(1e-9) + 1e-9) = -3.031, the largest u 15.93), and 2 x 65,536 draws have
    the Gumbel mean 0.5772 and deviation 1.2825 within 4 standard errors."""
    ends = wavenet_ar.gumbel_from_bits(torch.tensor([0, 0xFFFFFFFF]))
    assert torch.isfinite(ends).all()
    assert abs(ends[0].item() + 3.0313) < 1e-3 and abs(ends[1].item() - 15.934) < 1e-2
    g = wavenet_ar.philox_gumbel(1234, 2, 7, 65536, 'cpu')
    assert g.shape == (2, 65536) and g.dtype == torch.float32
    n = g.numel()
    assert abs(g.mean().item() - 0.5772) < 4 * 1.2825 / n ** 0.5
    assert abs(g.std().item() - 1.2825) < 0.02


def test_philox_gumbel_is_a_function_of_seed_sequence_step_class():
    """Same (seed, step) twice: equal. Another seed, step (also past 2**32) or
    sequence: different. A class's value does not depend on how many classes are asked
    for (Q = 1,025 is a prefix of Q = 2,048)."""
    a = wavenet_ar.philox_gumbel(9, 3, 100, 2048, 'cpu')
    assert torch.equal(a, wavenet_ar.philox_gumbel(9, 3, 100, 2048, 'cpu'))
    assert not torch.equal(a, wavenet_ar.philox_gumbel(10, 3, 100, 2048, 'cpu'))
    assert not torch.equal(a, wavenet_ar.philox_gumbel(9 + 2 ** 32, 3, 100, 2048, 'cpu'))
    assert not torch.equal(a, wavenet_ar.philox_gumbel(9, 3, 101, 2048, 'cpu'))
    assert not torch.equal(a, wavenet_ar.philox_gumbel(9, 3, 100 + 2 ** 32, 2048, 'cpu'))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    assert torch.equal(a[:, :1025], wavenet_ar.philox_gumbel(9, 3, 100, 1025, 'cpu'))


def test_make_noise_and_draw_seed_big_vocab(big):
    """No (B, T, Q) noise is allocated for a big-vocab model: a (B, T, 1) placeholder of
    zeros, as the JAX make_noise; draw_seed is seeded by its generator."""
    hp = big['hp']
    noise = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(1), 3, 40)
    assert noise.shape == (3, 40, 1) == wavenet_ar.noise_shape(hp, 3, 40)
    assert not noise.any()
    assert tuple(jar.make_noise(hp, jax.random.PRNGKey(0), 3, 40).shape) == (3, 40, 1)
    s1 = wavenet_ar.draw_seed(torch.Generator().manual_seed(1))
    assert s1 == wavenet_ar.draw_seed(torch.Generator().manual_seed(1))
    assert s1 != wavenet_ar.draw_seed(torch.Generator().manual_seed(2)) and 0 <= s1 < 2 ** 63


# ---------------------------------------------------------------- packing

def test_pack_params_big_vocab_matches_jax(big):
    """bf16 first conv and last head layer, equal to the JAX packing bit for bit; w_s2's
    columns padded with zeros to a multiple of 8 (Q = 1,025 -> 1,032); the layout key
    tells the big packing from the small one."""
    w, jw, hp = big['weights'], big['jw'], big['hp']
    assert w['first_w'].dtype == w['w_s2'].dtype == torch.bfloat16
    assert w['b_s2'].dtype == w['first_b'].dtype == torch.float32
    for name in ('first_w', 'w_s2', 'w_tap', 'w_fused', 'w_s1'):
        assert np.array_equal(w[name].float().numpy(), np.asarray(jw[name], np.float32)), name
    hp2, _, model2, _ = make_pair(1025)
    w2 = wavenet_ar.pack_params(model2, hp2)
    assert w2['w_s2'].shape == (8, 1032) and not w2['w_s2'][:, 1025:].any()
    assert w2['first_w'].shape == (1025, 8)
    assert wavenet_ar.is_big_vocab(hp2) and not wavenet_ar.is_big_vocab(quantized(1024))
    assert wavenet_ar._layout_key(hp) != wavenet_ar._layout_key(quantized(1024))
    assert wavenet_ar.variant(hp) == 'categorical_big-fused'
    assert wavenet_ar.variant(hp, True, True) == 'categorical_big-fused+g+nll'


# ---------------------------------------------------------------- against Pallas

def test_big_vocab_greedy_ids_and_nll_match_pallas(big):
    """The plain version, teacher-forced on the Pallas kernel's greedy ids, draws the
    same id at >= 99% of the steps (the JAX package's own kernel-vs-scan test asks 93%
    of f32 against bf16; here both sides share the bf16 arithmetic and differ by sum
    order; read 100%, 17 distinct ids) and its NLL of the seeded targets is within 1e-3
    of the kernel's (the JAX package's bound for its in-kernel NLL; logits boosted 20x
    span about 40; read 1.9e-6)."""
    ids, nll = wavenet_ar.generate_ar_reference(
        big['weights'], big['c_up'], torch.zeros(B, 128, 1), big['hp'],
        targets=torch.from_numpy(big['ids']).long(), return_params=False, greedy=True,
        y_eval=big['y'], return_drawn=True)
    agree = float((ids.numpy() == big['ids']).mean())
    assert agree >= 0.99, agree
    # without return_drawn the targets themselves come back
    fed, _ = wavenet_ar.generate_ar_reference(
        big['weights'], big['c_up'][:, :8], torch.zeros(B, 8, 1), big['hp'],
        targets=torch.from_numpy(big['ids'][:, :8]).long() * 0 + 5, return_params=False,
        greedy=True)
    assert (fed == 5).all()
    assert len(np.unique(big['ids'])) > 10
    assert np.abs(nll.numpy() - big['nll']).max() <= 1e-3


def test_big_vocab_free_running_equals_pallas_unboosted():
    """At the natural scale of the logits (no boost) the free-running plain version
    reproduces the Pallas kernel's greedy ids exactly or all but (>= 97%: one flipped
    near-tie changes the history after it) and its NLL within 1e-3."""
    hp, params, model, c_up = make_pair(2048, seed=3)
    y = np.random.default_rng(6).integers(0, 2048, (B, 128)).astype(np.int32)
    ids_j, nll_j = jar.generate_ar(jar.pack_params(params, hp), jnp.asarray(c_up),
                                   jnp.zeros((B, 128, 1)), hp, interpret=True,
                                   return_params=False, greedy=True, y_eval=jnp.asarray(y))
    w = wavenet_ar.pack_params(model, hp)
    _, nll = wavenet_ar.generate_ar(w, torch.from_numpy(c_up), torch.zeros(B, 128, 1), hp,
                                    return_params=False, greedy=True,
                                    y_eval=torch.from_numpy(y).long())
    forced_nll = wavenet_ar.generate_ar_reference(
        w, torch.from_numpy(c_up), torch.zeros(B, 128, 1), hp, return_params=False,
        greedy=True, y_eval=torch.from_numpy(y).long(),
        targets=torch.from_numpy(np.asarray(ids_j)).long())[1]
    assert np.abs(forced_nll.numpy() - np.asarray(nll_j)).max() <= 1e-3
    ids, _ = wavenet_ar.generate_ar(w, torch.from_numpy(c_up), torch.zeros(B, 128, 1), hp,
                                    return_params=False, greedy=True)
    assert float((ids.numpy() == np.asarray(ids_j)).mean()) >= 0.97
    assert nll.shape == (B, 128) and torch.isfinite(nll).all()


def test_small_head_nll_matches_pallas():
    """B7 on the small head (Q = 256), sampling on: the same Gumbel noise through the
    Pallas kernel with y_eval and through the port's plain version gives the same ids
    and NLL within 1e-3 (the JAX package's own bound against its host cross-entropy)."""
    Q = 256
    hp, params, model, c_up = make_pair(Q, seed=1)
    rng = np.random.default_rng(7)
    noise = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(8), B, 128)
    y = rng.integers(0, Q, (B, 128)).astype(np.int32)
    ids_j, nll_j = jar.generate_ar(jar.pack_params(params, hp), jnp.asarray(c_up),
                                   jnp.asarray(noise.numpy()), hp, interpret=True,
                                   return_params=False, y_eval=jnp.asarray(y))
    w = wavenet_ar.pack_params(model, hp)
    ids, nll = wavenet_ar.generate_ar(w, torch.from_numpy(c_up), noise, hp,
                                      return_params=False, y_eval=torch.from_numpy(y))
    assert np.array_equal(ids.numpy(), np.asarray(ids_j))
    assert np.abs(nll.numpy() - np.asarray(nll_j)).max() <= 1e-3
    # ... and it is -log_softmax of the params a second call on the same noise returns
    ids2, params2 = wavenet_ar.generate_ar(w, torch.from_numpy(c_up), noise, hp)
    want = -torch.log_softmax(params2, -1).gather(-1, torch.from_numpy(y).long()[..., None])
    assert torch.equal(ids2, ids) and (nll - want[..., 0]).abs().max() <= 1e-5


def test_nll_vs_incremental_log_softmax(big):
    """The NLL of the packed-weight path against -log_softmax of the f32 oracle's
    (WaveNet.incremental) teacher-forced params on the same history: the weights differ
    by their bf16 rounding, so the bound is loose: 0.5 at the worst step and 0.06 on
    average, on logits that the head's 20x boost spreads over 41 (read 0.13 and 0.019;
    the JAX package allows its kernel 0.15 against its scan path without a boost)."""
    ids = torch.from_numpy(big['ids']).long()
    _, nll = wavenet_ar.generate_ar_reference(
        big['weights'], big['c_up'], torch.zeros(B, 128, 1), big['hp'], targets=ids,
        return_params=False, greedy=True, y_eval=big['y'])
    mel = big['c_up']  # already upsampled: feed the oracle the layers directly
    model = big['model']
    oracle = _teacher_forced_params(model, mel, ids)
    want = -torch.log_softmax(oracle, -1).gather(-1, big['y'][..., None])[..., 0]
    assert (nll - want).abs().max() <= 0.5
    assert (nll - want).abs().mean() <= 0.06


def _teacher_forced_params(model, c_up, ids):
    """The parallel forward pass on the history [Q//2, ids[:-1]]: its params at step t
    are what the AR loop computes at step t."""
    Q = model.hp.quantize_channels
    prev = torch.cat([torch.full((ids.shape[0], 1), Q // 2), ids[:, :-1]], 1)
    with torch.no_grad():
        return model(prev, c_up, c_is_upsampled=True)


# ---------------------------------------------------------------- the port's own rules

@pytest.mark.parametrize('kw', [dict(greedy=True), dict(seed=77)])
def test_chunked_equals_one_call_with_one_seed(big, kw):
    """State-carried chunks at odd ends that keep one seed are bit-identical to one
    call, ids and NLL: the noise is a function of the absolute step."""
    hp, w, c_up, y = big['hp'], big['weights'], big['c_up'], big['y']
    noise = torch.zeros(B, 128, 1)
    ids, nll = wavenet_ar.generate_ar(w, c_up, noise, hp, return_params=False, y_eval=y, **kw)
    outs, state = [], None
    for lo, hi in ((0, 37), (37, 91), (91, 128)):
        out = wavenet_ar.generate_ar(w, c_up[:, lo:hi].contiguous(), noise[:, lo:hi], hp,
                                     return_params=False, y_eval=y[:, lo:hi],
                                     state_in=state, return_state=True, **kw)
        outs.append(out[:2])
        state = out[2]
    assert state[2] == 128
    assert torch.equal(torch.cat([o[0] for o in outs], 1), ids)
    assert torch.equal(torch.cat([o[1] for o in outs], 1), nll)
    if 'seed' in kw:  # another seed draws other ids; sampling spreads over the classes
        other, _ = wavenet_ar.generate_ar(w, c_up, noise, hp, return_params=False, seed=78)
        assert not torch.equal(other, ids)


def test_forced_tie_of_two_classes(big):
    """Two classes tied far above the rest at every step (greedy): the lower id is
    emitted and bf16(1/2) of each class's bf16 first-conv row is fed back."""
    hp, c_up = big['hp'], big['c_up'][:, :16].contiguous()
    w = dict(big['weights'])
    w['w_s2'], w['b_s2'] = w['w_s2'].clone(), w['b_s2'].clone()
    lo, hi = 5, 1500
    w['w_s2'][:, [lo, hi]] = 0
    w['b_s2'][[lo, hi]] = 500.0
    ids, _, state = wavenet_ar.generate_ar(w, c_up, torch.zeros(B, 16, 1), hp,
                                           return_params=False, greedy=True,
                                           return_state=True)
    rows = w['first_w'][[lo, hi]].float()
    assert (ids == lo).all()
    assert torch.allclose(state[1], (0.5 * rows[0] + 0.5 * rows[1] + w['first_b']).expand(B, -1),
                          atol=1e-6)


@pytest.mark.parametrize('kw,match', [
    (dict(return_params=True, greedy=True), 'returns no params'),
    (dict(return_params=False), 'pass seed'),
    (dict(return_params=False, seed=2 ** 64), 'seed must be'),
    (dict(return_params=True, greedy=True, y_eval='y'), 'y_eval replaces'),
    (dict(return_params=False, greedy=True, y_eval='bad'), 'outside'),
    (dict(return_params=False, greedy=True, y_eval='short'), 'y_eval must be')])
def test_wrapper_rules_big_vocab(big, kw, match):
    """The JAX wrapper's asserts (`wavenet_ar.py:559-574`) are ValueErrors here; class
    ids out of range raise instead of reading out of bounds."""
    y = {'y': big['y'], 'bad': big['y'].clone().index_fill_(1, torch.tensor([3]), 2048),
         'short': big['y'][:, :100]}
    kw = dict(kw, y_eval=y[kw['y_eval']]) if 'y_eval' in kw else kw
    with pytest.raises(ValueError, match=match):
        wavenet_ar.generate_ar(big['weights'], big['c_up'], torch.zeros(B, 128, 1),
                               big['hp'], **kw)


def test_wrapper_rules_other_heads():
    """greedy is for the big-vocab head only; y_eval for the categorical heads only."""
    hp, _, model, c_up = make_pair(256)
    w = wavenet_ar.pack_params(model, hp)
    c_up = torch.from_numpy(c_up)
    noise = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(0), B, 128)
    with pytest.raises(ValueError, match='greedy'):
        wavenet_ar.generate_ar(w, c_up, noise, hp, greedy=True)
    ghp = default_hparams()
    ghp.parse(TINY)
    gw = wavenet_ar.pack_params(WaveNet(ghp), ghp)
    with pytest.raises(ValueError, match='categorical'):
        wavenet_ar.generate_ar(gw, c_up, torch.zeros(B, 128), ghp, return_params=False,
                               y_eval=torch.zeros(B, 128, dtype=torch.long))


def test_generate_scores_a_big_vocab_model_in_place(big):
    """`wavenet_synthesizer.generate(..., y_eval=...)`: the 'nll' of the generated
    length, the targets cut or padded with class 0; return_params=True raises; the
    Synthesizer vocodes a big-vocab model (seed drawn from its generator)."""
    hp, model = big['hp'], big['model']
    mel = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 2, 80))
                           .astype(np.float32))
    gen = torch.Generator().manual_seed(4)
    y = big['y'][:1, :40]
    out = wavenet_synthesizer.generate(model, hp, gen, mel, return_params=False, y_eval=y)
    assert out['audio'].shape == out['nll'].shape == (1, 64)
    assert out['audio'].dtype == torch.int64 and torch.isfinite(out['nll']).all()
    again = wavenet_synthesizer.generate(model, hp, torch.Generator().manual_seed(4), mel,
                                         return_params=False, y_eval=y)
    assert torch.equal(again['audio'], out['audio'])
    padded = wavenet_synthesizer.generate(model, hp, torch.Generator().manual_seed(4), mel,
                                          return_params=False,
                                          y_eval=torch.cat([y, torch.zeros(1, 24).long()], 1))
    assert torch.equal(out['nll'], padded['nll'])
    with pytest.raises(ValueError, match='no params'):
        wavenet_synthesizer.generate(model, hp, gen, mel)
    wavs = wavenet_synthesizer.Synthesizer(model, hp).synthesize(
        [torch.zeros(2, 80), torch.zeros(1, 80)], gen)
    assert [len(w) for w in wavs] == [64, 32] and all(np.abs(w).max() <= 1 for w in wavs)


def test_stream_vocoder_keeps_one_seed(big):
    """StreamVocoder draws one seed a stream and keeps it over the chunks, so the
    stream is one call with that seed, bit for bit."""
    hp, model = big['hp'], big['model']
    hp128 = hp.replace(upsample_scales=(8, 16), hop_size=128, win_size=512, n_fft=512,
                       num_freq=257)
    model128 = WaveNet(hp128).eval()
    mel = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (1, 3, 80))
                           .astype(np.float32))
    voc = streaming.StreamVocoder(model128, hp128)
    chunks = list(voc.stream(torch.Generator().manual_seed(5), mel, chunk_samples=128,
                             first_chunk_samples=128))
    assert [c.shape[1] for c in chunks] == [128, 128, 128]
    seed = wavenet_ar.draw_seed(torch.Generator().manual_seed(5))
    c_up = model128.upsample_conditioning(mel)
    whole, _ = wavenet_ar.generate_ar(wavenet_ar.pack_params(model128, hp128), c_up,
                                      torch.zeros(1, 384, 1), hp128, return_params=False,
                                      seed=seed)
    assert torch.equal(torch.cat(chunks, 1), whole)
