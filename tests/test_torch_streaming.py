"""Streaming parity: the port's AR state carry (ops/wavenet_ar.py state_in /
return_state) against the Pallas kernel in interpret mode, chunked against one call,
and the port's StreamingSynthesizer against the JAX one.

Tolerances: per-step params and carried state within 1e-6 of the Pallas kernel (both
round the matmul operands to bf16 at the same places; only the f32 sum order
differs, which can flip a bf16 rounding: see test_state_carry_matches_pallas); chunked against one call exactly (torch.equal: the same operations in the
same order); the streamed, de-emphasised audio within 1e-6 of lfilter over the
one-shot audio (float64 filter state carried between float32 chunks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from tacotron2_tpu.config import default_hparams, paper_hparams
from tacotron2_tpu.models.wavenet.model import WaveNet as JWaveNet
from tacotron2_tpu.ops.pallas import wavenet_ar as jar
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.inference.streaming import (CHUNK, StreamingSynthesizer,
                                                     StreamVocoder, stream_vocode)
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.ops import wavenet_ar
from test_streaming import TINY, _shell
from test_torch_wavenet import randomize

# as tests/test_streaming.py, and a one-stack variant whose dilations reach 128
# (ring windows up to 256 slots), so that t_base = 128 is not a multiple of every window;
# 'paper_mol' is the paper profile (MoL-30, 2D upsampler, hop 275, no legacy scalings)
# at tiny widths, one stack for the same reason
CONFIGS = {'tiny': TINY, 'one_stack': TINY + ',layers=8,stacks=1',
           'paper_mol': ('paper', 'layers=8,stacks=1,residual_channels=8,gate_channels=16,'
                                  'skip_out_channels=8')}
TACO_TINY = (",embedding_dim=32,enc_conv_channels=32,enc_conv_num_layers=1,"
             "encoder_lstm_units=16,attention_dim=16,attention_filters=8,"
             "attention_kernel=[7],prenet_layers=[16,16],decoder_lstm_units=32,"
             "postnet_channels=32,postnet_num_layers=2,outputs_per_step=2")
B = 2
TOL = 1e-6


def make_hp(name):
    cfg = CONFIGS[name]
    if isinstance(cfg, tuple):
        hp = paper_hparams()
        hp.parse(cfg[1])
    else:
        hp = default_hparams()
        hp.parse(cfg)
    return hp


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _wavenet(hp, seed=0):
    """(flax params, port model) with the same seeded random weights."""
    params = jax.eval_shape(JWaveNet(hp).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hp.get_hop_size(), 1)),
                            jnp.zeros((1, 1, 80)))['params']
    params = randomize(params, np.random.default_rng(seed))
    if hp.upsample_type == '2D':  # positive: random signs can zero all three ReLUs
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: np.abs(x) if 'upsample_network' in jax.tree_util.keystr(p) else x,
            params)
    model = WaveNet(hp)
    model.load_state_dict(convert.wavenet_state_dict(params))
    return params, model.eval()


def _inputs(model, frames, seed=1):
    """c_up and noise: (B, T) standard normal, or for MoL (B, T, nr+1) from
    make_noise with a generator seeded alike."""
    rng = np.random.default_rng(seed)
    mel = rng.uniform(0.0, 1.0, (B, frames, 80)).astype(np.float32)
    with torch.no_grad():
        c_up = model.upsample_conditioning(torch.from_numpy(mel)).numpy()
    if wavenet_ar.is_mol(model.hp):
        return c_up, wavenet_ar.make_noise(model.hp, torch.Generator().manual_seed(seed), B,
                                           c_up.shape[1]).numpy()
    return c_up, rng.standard_normal(c_up.shape[:2]).astype(np.float32)


def _agree(got, want, flips: bool) -> None:
    """Within TOL; with `flips`, up to 3.5% of entries may be off by at most 1e-3: one
    bf16 rounding flip from the f32 sum order, seen at its step and at the dilated
    ring taps that read it later (the readings, in test_state_carry_matches_pallas,
    reach 3.1% and 9.3e-4)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    if flips:
        assert np.mean(err > TOL) <= 0.035 and err.max() <= 1e-3, (np.mean(err > TOL),
                                                                   err.max())
    else:
        assert err.max() <= TOL, err.max()


@pytest.mark.parametrize('config', list(CONFIGS))
def test_state_carry_matches_pallas(config):
    """Chunk 1 (128 steps) with return_state, chunk 2 from state_in, on the Pallas
    kernel and on the port's plain version teacher-forced on the Pallas audio: params
    of both chunks, and the state after chunk 1 against convert.stream_state_from_jax
    of the JAX state, slot by slot, within 1e-6; a continuation from the converted
    JAX state matches too, within 1e-6.

    In the one-stack config one bf16 rounding flips between the two (sequence 1,
    step 18 of chunk 1): 3.1% of chunk 1's params and 2.5% of the ring floats are
    off, by up to 6.2e-4 and 9.3e-4 (all in the rings of the three widest layers), and
    the port's own continuation carries that (3.1%, 4.5e-4),
    so those three checks allow it (`_agree`); the continuation from the JAX state
    stays within 1e-6 (4.2e-7). A carry that drops t_base or the rings misses on
    every param of chunk 2, by up to 0.15 and 0.21.

    The paper config (MoL-30 head, (B, T, 11) noise) runs one frame, 275 steps:
    chunks of 128 and 147."""
    hp = make_hp(config)
    flips = config == 'one_stack'
    params, model = _wavenet(hp)
    c_up, noise = _inputs(model, max(1, 256 // hp.get_hop_size()))  # 256 or 275 steps
    jnoise = noise if noise.ndim == 3 else noise[..., None]
    wj = jar.pack_params(params, hp)
    c1, c2 = jnp.asarray(c_up[:, :128]), jnp.asarray(c_up[:, 128:])
    n1, n2 = jnp.asarray(jnoise[:, :128]), jnp.asarray(jnoise[:, 128:])
    a1, p1, st_j = jar.generate_ar(wj, c1, n1, hp, interpret=True, return_state=True)
    a2, p2 = jar.generate_ar(wj, c2, n2, hp, interpret=True, state_in=st_j)
    a1, p1, a2, p2 = map(np.array, (a1, p1, a2, p2))

    w = wavenet_ar.pack_params(model, hp)
    t = torch.from_numpy
    _, q1, st = wavenet_ar.generate_ar_reference(
        w, t(c_up[:, :128]), t(noise[:, :128]), hp, targets=t(a1), return_state=True)
    _agree(q1.numpy(), p1, flips)
    rings_j, h_j, t_j = convert.stream_state_from_jax(jax.device_get(st_j), hp, B)
    assert rings_j.shape == (B, wavenet_ar.ring_floats(hp)) and h_j.shape == (B, 8)
    assert t_j == st[2] == 128
    _agree(st[0].numpy(), rings_j.numpy(), flips)
    _agree(st[1].numpy(), h_j.numpy(), False)
    assert st[0].abs().max() > 0.1  # the rings hold the history, not zeros

    for state, may_flip in ((st, flips), ((rings_j, h_j, t_j), False)):
        _, q2 = wavenet_ar.generate_ar_reference(
            w, t(c_up[:, 128:]), t(noise[:, 128:]), hp, targets=t(a2), state_in=state)
        _agree(q2.numpy(), p2, may_flip)


def test_chunked_equals_one_call():
    """Three state-carried chunks through generate_ar (the CPU path) at boundaries
    that are not multiples of the ring windows give exactly one fresh call's audio
    and params over the same noise (counterpart of
    tests/test_pallas_ar.py:239-261); the state is consumed in place."""
    hp = make_hp('one_stack')
    _, model = _wavenet(hp)
    c_up, noise = _inputs(model, 8)
    c, n = torch.from_numpy(c_up), torch.from_numpy(noise)
    w = wavenet_ar.pack_params(model, hp)
    full_audio, full_params = wavenet_ar.generate_ar_reference(w, c, n, hp)
    audio, params, state = [], [], None
    for lo, hi in ((0, 77), (77, 177), (177, 256)):
        out = wavenet_ar.generate_ar(w, c[:, lo:hi], n[:, lo:hi], hp, state_in=state,
                                     return_state=hi < 256)
        if hi < 256:
            assert state is None or out[2][0] is state[0]  # rings updated in place
            state = out[2]
            assert state[2] == hi
        audio.append(out[0])
        params.append(out[1])
    assert torch.equal(torch.cat(audio, 1), full_audio)
    assert torch.equal(torch.cat(params, 1), full_params)


def test_state_is_checked():
    hp = make_hp('tiny')
    _, model = _wavenet(hp)
    c_up, noise = _inputs(model, 1)
    c, n = torch.from_numpy(c_up), torch.from_numpy(noise)
    w = wavenet_ar.pack_params(model, hp)
    _, _, (rings, h, t_base) = wavenet_ar.generate_ar(w, c, n, hp, return_state=True)
    for bad in ((rings[:1].contiguous(), h, t_base), (rings, h.double(), t_base),
                (rings, h, -1)):
        with pytest.raises((ValueError, TypeError)):
            wavenet_ar.generate_ar(w, c, n, hp, state_in=bad)


def _shells(seed=0):
    """The JAX StreamingSynthesizer shell of tests/test_streaming.py and the port's
    StreamingSynthesizer on the same WaveNet weights (and a tiny Tacotron)."""
    hp = default_hparams()
    hp.parse(TINY + TACO_TINY)
    hp.freeze()
    jss = _shell(hp)
    wavenet = WaveNet(hp)
    wavenet.load_state_dict(convert.wavenet_state_dict(jax.device_get(jss._wn._params)))
    torch.manual_seed(seed)
    return hp, jss, StreamingSynthesizer(Tacotron(hp), wavenet, hp, 'cpu')


def test_stream_from_mel_matches_jax():
    """Same chunk lengths as the JAX stream_from_mel on the same padded mel, n_frames
    and chunk settings (first 150/sr s -> 128 samples, then 300/sr s -> 256); the total
    is n_frames * hop; and the streamed audio is lfilter (inverse preemphasis) over one
    fresh call with the same noise, within 1e-6."""
    hp, jss, pss = _shells()
    hop = hp.get_hop_size()
    n_frames, bucket = 11, 12
    rng = np.random.default_rng(4)
    mel = rng.uniform(-hp.max_abs_value, hp.max_abs_value, (bucket, 80)).astype(np.float32)
    mel[n_frames:] = -hp.max_abs_value if hp.symmetric_mels else 0.0
    kw = dict(n_frames=n_frames, seed=11, chunk_seconds=300 / hp.sample_rate,
              first_chunk_seconds=150 / hp.sample_rate)
    want = [len(x) for x in jss.stream_from_mel(mel, **kw)]
    got = list(pss.stream_from_mel(mel, **kw))
    assert [len(x) for x in got] == want == [128, n_frames * hop - 128]
    assert all(x.dtype == np.float32 for x in got)

    from tacotron2_tpu_torch.inference.wavenet_synthesizer import prepare_conditions
    gen = torch.Generator().manual_seed(11)
    noise = torch.cat([wavenet_ar.make_noise(hp, gen, 1, 128),
                       wavenet_ar.make_noise(hp, gen, 1, 256)], dim=1)
    with torch.no_grad():
        c_up = pss._vocoder._model.upsample_conditioning(
            prepare_conditions([torch.from_numpy(mel)], hp))
    audio, _ = wavenet_ar.generate_ar_reference(pss._vocoder._weights, c_up, noise, hp)
    one_shot = lfilter([1.0], [1.0, -hp.preemphasis], audio[0, :n_frames * hop].numpy())
    assert hp.preemphasize
    assert _max_abs(np.concatenate(got), one_shot) <= TOL


def test_stream_vocoder_chunks():
    """StreamVocoder yields chunks of first, chunk, ..., ragged last, which together
    equal stream_vocode's; chunk sizes that are not multiples of CHUNK raise."""
    hp = make_hp('tiny')
    _, model = _wavenet(hp)
    c = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (B, 11, 80))
                         .astype(np.float32))
    voc = StreamVocoder(model, hp)
    chunks = list(voc.stream(torch.Generator().manual_seed(3), c, 2 * CHUNK, CHUNK))
    assert [tuple(x.shape) for x in chunks] == [(B, 128), (B, 11 * 32 - 128)]
    again = list(stream_vocode(model, hp, torch.Generator().manual_seed(3), c,
                               2 * CHUNK, CHUNK))
    assert all(torch.equal(a, b) for a, b in zip(chunks, again))
    with pytest.raises(ValueError):
        next(voc.stream(torch.Generator(), c, 100, CHUNK))
