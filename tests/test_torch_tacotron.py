"""Tacotron synthesis parity: the PyTorch port (tacotron2_tpu_torch) against the JAX
package, fp32 on the CPU.

Every parameter and batch_stats leaf of the flax model is overwritten with seeded numpy
noise (positive variances) and converted with tacotron2_tpu_torch.convert. The prenet
dropout masks of the free-running decoder are regenerated with the same jax.random
calls the JAX synthesis makes and handed to the port as numpy. Modules agree to max abs
<= 1e-5; the encoder, the decoder scan and the whole model to <= 1e-4.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.models.tacotron import attention as jatt
from tacotron2_tpu.models.tacotron import modules as jmod
from tacotron2_tpu.models.tacotron.model import Tacotron as JTacotron
from tacotron2_tpu.ops import fused_decoder as jfd
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.tacotron import modules as tmod
from tacotron2_tpu_torch.models.tacotron.attention import LocationSensitiveAttention
from tacotron2_tpu_torch.ops import fused_decoder as tfd
from tacotron2_tpu_torch.utils import suppress_stop_tokens

TINY = ("embedding_dim=32,enc_conv_channels=32,enc_conv_num_layers=1,encoder_lstm_units=16,"
        "attention_dim=16,attention_filters=8,attention_kernel=[7],prenet_layers=[16,16],"
        "decoder_lstm_units=32,postnet_channels=32,postnet_num_layers=2,"
        "cbhg_kernels=4,cbhg_conv_channels=16,cbhg_projection=16,cbhg_highway_units=16,"
        "cbhg_rnn_units=16,num_freq=65,outputs_per_step=2,decoder_scan_unroll=1")
B, T_IN = 2, 12
LENGTHS = np.asarray([12, 7], np.int32)  # ragged: the second row is padded
MAX_ITERS = 128                          # two 64-step decoder chunks
MODULE_TOL = 1e-5
SCAN_TOL = 1e-4


def randomize(tree, rng):
    """Replace every leaf (an array or a jax.ShapeDtypeStruct) with seeded noise:
    kernels ~ N(0, 1/fan_in), vectors ~ N(0, 0.1), BatchNorm variances in [0.5, 1.5]."""
    def leaf(path, x):
        shape = tuple(x.shape)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape).astype(np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def push_stop_bias(params, push):
    params = jax.tree_util.tree_map(lambda x: x, params)
    sp = params['decoder']['stop_projection']
    sp['bias'] = sp['bias'] + np.float32(push)
    return params


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.fixture(scope='module')
def taco():
    """(hp, flax variables, port model, inputs (B, T_IN) numpy) with random weights."""
    hp = default_hparams()
    hp.parse(TINY)
    rng = np.random.default_rng(0)
    inputs = rng.integers(2, 60, (B, T_IN)).astype(np.int32)
    inputs[1, LENGTHS[1]:] = 0
    k = jax.random.PRNGKey(0)
    init = partial(JTacotron(hp).init, max_iters=2, deterministic=True,
                   predict_linear=False)
    variables = randomize(jax.eval_shape(
        init, {'params': k, 'dropout': k, 'zoneout': k, 'teacher': k},
        jnp.asarray(inputs), jnp.asarray(LENGTHS)), rng)
    model = convert.tacotron_model(convert.tacotron_state_dict(variables['params'],
                                                               variables['batch_stats']), hp)
    return hp, variables, model.eval(), inputs


def test_zoneout_lstm_cell(taco):
    """Gate order i, g, f, o with the +1 forget bias; expectation-form zoneout; the
    output is h_new, not the zoned h."""
    hp, v, model, _ = taco
    rng = np.random.default_rng(1)
    U = hp.decoder_lstm_units
    x, c, h = (rng.normal(size=(B, U)).astype(np.float32) for _ in range(3))
    (jc, jh), jout = jmod.ZoneoutLSTMCell(U, 0.1, 0.1).apply(
        {'params': v['params']['decoder']['lstm_2']}, (c, h), x, True)
    with torch.no_grad():
        (tc, th), tout = model.decoder.lstm_2((torch.from_numpy(c), torch.from_numpy(h)),
                                              torch.from_numpy(x))
    for want, got in ((jc, tc), (jh, th), (jout, tout)):
        assert _max_abs(want, got.numpy()) <= MODULE_TOL
    assert _max_abs(tout.numpy(), th.numpy()) > 1e-3  # output is not the zoned h


def test_prenet_masks(taco):
    """Prenet with explicit masks: all-ones masks reproduce the flax prenet without
    dropout, and a mask multiplies each layer's ReLU output."""
    hp, v, model, _ = taco
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, hp.num_mels)).astype(np.float32)
    want = jmod.Prenet(tuple(hp.prenet_layers), 0.0).apply(
        {'params': v['params']['decoder']['prenet']}, x,
        rngs={'dropout': jax.random.PRNGKey(0)})  # rate 0: the key is never used
    ones = [torch.ones(B, n) for n in hp.prenet_layers]
    with torch.no_grad():
        got = model.decoder.prenet(torch.from_numpy(x), ones)
        assert _max_abs(want, got.numpy()) <= MODULE_TOL
        m2 = torch.from_numpy(rng.integers(0, 2, (B, hp.prenet_layers[1])).astype(np.float32))
        masked = model.decoder.prenet(torch.from_numpy(x), [ones[0], 2 * m2])
    assert torch.allclose(masked, got * 2 * m2)


@pytest.mark.parametrize('bnorm', ['after', 'before'])
def test_conv_block(bnorm):
    """conv -> activation -> BN ('after') or BN -> activation ('before'), BN eps 1e-3
    over running statistics."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T_IN, 6)).astype(np.float32)
    jblock = jmod.ConvBlock(5, 8, nn.relu, 0.5, bnorm)
    v = randomize(jax.eval_shape(partial(jblock.init, train=False),
                                 jax.random.PRNGKey(0), x), rng)
    want = jblock.apply(v, x, False)
    block = tmod.ConvBlock(6, 5, 8, 'relu', bnorm)
    block.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    with torch.no_grad():
        got = block(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    assert _max_abs(want, got.numpy()) <= MODULE_TOL


def test_encoder_ragged_lengths(taco):
    """Embedding -> encoder convs -> BiZoneoutLSTM with ragged lengths: the backward
    direction reverses only the valid region; padded steps output zero."""
    hp, v, model, inputs = taco
    p, s = v['params'], v['batch_stats']
    emb = np.asarray(p['inputs_embedding'])[inputs]
    enc = jmod.EncoderConvolutions(hp.enc_conv_num_layers, hp.enc_conv_kernel_size[0],
                                   hp.enc_conv_channels, 0.5, hp.batch_norm_position).apply(
        {'params': p['encoder_convolutions'], 'batch_stats': s['encoder_convolutions']},
        emb, False)
    want = jmod.BiZoneoutLSTM(hp.encoder_lstm_units, hp.tacotron_zoneout_rate).apply(
        {'params': p['encoder_lstm']}, enc, jnp.asarray(LENGTHS), True)
    with torch.no_grad():
        t_in = torch.from_numpy(inputs).long()
        t_enc = model.encoder_convolutions(model.inputs_embedding(t_in))
        got = model.encoder_lstm(t_enc, torch.from_numpy(LENGTHS))
    assert _max_abs(enc, t_enc.numpy()) <= MODULE_TOL
    assert _max_abs(want, got.numpy()) <= SCAN_TOL
    assert not got[1, LENGTHS[1]:].any()


def test_postnet(taco):
    hp, v, model, _ = taco
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 10, hp.num_mels)).astype(np.float32)
    want = jmod.Postnet(hp.postnet_num_layers, hp.postnet_kernel_size[0],
                        hp.postnet_channels, 0.5, hp.batch_norm_position).apply(
        {'params': v['params']['postnet_convolutions'],
         'batch_stats': v['batch_stats']['postnet_convolutions']}, x, False)
    with torch.no_grad():
        got = model.postnet_convolutions(torch.from_numpy(x))
    assert _max_abs(want, got.numpy()) <= MODULE_TOL


@pytest.mark.parametrize('variant', [None, 'window', 'monotonic', 'smoothing'])
def test_location_sensitive_attention(taco, variant):
    """One attention step: SAME location conv, NEG_INF masking of padded and
    out-of-window positions, f32 softmax, cumulative state, argmax; 'smoothing' is
    the sigmoid normalisation with a non-cumulative state."""
    hp, v, model, _ = taco
    rng = np.random.default_rng(5)
    D, U = hp.attention_dim, hp.decoder_lstm_units
    query = rng.normal(size=(B, U)).astype(np.float32)
    prev = rng.uniform(0, 1, (B, T_IN)).astype(np.float32)
    prev_max = np.asarray([3, 5], np.int32)
    keys = rng.normal(size=(B, T_IN, D)).astype(np.float32)
    values = rng.normal(size=(B, T_IN, 2 * hp.encoder_lstm_units)).astype(np.float32)
    mask = (np.arange(T_IN)[None] < LENGTHS[:, None]).astype(np.float32)
    constraint = variant if variant in ('window', 'monotonic') else None
    smooth = variant == 'smoothing'
    flags = (not smooth, smooth, constraint is not None, constraint or 'window', 5)
    jmodule = jatt.LocationSensitiveAttention(
        D, hp.attention_filters, hp.attention_kernel[0], *flags)
    want = jmodule.apply({'params': v['params']['decoder']['attention']},
                         query, prev, prev_max, keys, values, mask)
    att = LocationSensitiveAttention(U, D, hp.attention_filters, hp.attention_kernel[0],
                                     *flags)
    att.load_state_dict(model.decoder.attention.state_dict())
    with torch.no_grad():
        got = att(*(torch.from_numpy(a) for a in (query, prev, prev_max, keys, values,
                                                  mask)))
    for w, g in zip(want, got):
        assert _max_abs(w, g.numpy()) <= MODULE_TOL
    if constraint is not None:
        assert (got[1].numpy() > 0).sum(axis=1).max() <= 5  # window of 5 positions


def jax_prenet_masks(hp, dropout_rng, B, n_chunks, chunk):
    """The masks fd.synthesis_scan draws (fused_decoder.py:764-772), regenerated."""
    keep = 1.0 - hp.tacotron_dropout_rate
    m1, m2 = [], []
    for i in range(n_chunks):
        k1, k2 = jax.random.split(jax.random.fold_in(dropout_rng, i))
        m1.append(jax.random.bernoulli(k1, keep, (chunk, B, hp.prenet_layers[0]))
                  .astype(jnp.float32) / keep)
        m2.append(jax.random.bernoulli(k2, keep, (chunk, B, hp.prenet_layers[1]))
                  .astype(jnp.float32) / keep)
    return (torch.from_numpy(np.concatenate(m1)), torch.from_numpy(np.concatenate(m2)))


@pytest.mark.parametrize('case', ['run', 'stop', 'window'])
def test_synthesis_scan(taco, case):
    """The chunked free-running decoder with the regenerated prenet masks. 'run': stop
    tokens suppressed, both 64-step chunks decoded. 'stop': every stop token fires at
    step 1, the early exit skips chunk 2 and its stop logits read 1e3. 'window': the
    synthesis-time attention window."""
    hp, v, model, _ = taco
    rng = np.random.default_rng(6)
    D, M = hp.attention_dim, 2 * hp.encoder_lstm_units
    keys = rng.normal(size=(B, T_IN, D)).astype(np.float32)
    values = rng.normal(size=(B, T_IN, M)).astype(np.float32)
    mask = (np.arange(T_IN)[None] < LENGTHS[:, None]).astype(np.float32)
    params = push_stop_bias(v['params'], 100.0 if case == 'stop' else -100.0)
    constraint = ('window', 7) if case == 'window' else None
    dropout_rng = jax.random.PRNGKey(11)
    chunk = hp.decoder_chunk_size
    want = jfd.synthesis_scan(jfd.config_from_hp(hp, jnp.float32, True),
                              params['decoder'], keys, values, mask, MAX_ITERS, chunk,
                              hp.tacotron_dropout_rate, dropout_rng, constraint)
    port = convert.tacotron_model(convert.tacotron_state_dict(params, v['batch_stats']), hp)
    masks = jax_prenet_masks(hp, dropout_rng, B, MAX_ITERS // chunk, chunk)
    got = tfd.synthesis_scan(port.decoder, torch.from_numpy(keys),
                             torch.from_numpy(values), torch.from_numpy(mask), MAX_ITERS,
                             chunk, hp.tacotron_dropout_rate, None, constraint, masks)
    for w, g in zip(want[:3], got[:3]):
        assert _max_abs(w, g.numpy()) <= SCAN_TOL
    assert np.array_equal(np.asarray(want[3]), got[3].numpy())
    stops = got[1].numpy()
    if case == 'stop':
        assert (stops[chunk:] == 1e3).all() and not got[0][chunk:].any()
    else:
        assert (stops < 0).all()


def test_tacotron_matches_apply(taco, monkeypatch):
    """The whole synthesis path against Tacotron.apply(deterministic=True,
    predict_linear=False) over two decoder chunks, stop tokens suppressed."""
    hp, v, _, inputs = taco
    variables = dict(v, params=push_stop_bias(v['params'], -100.0))
    seen = {}
    jax_scan = jfd.synthesis_scan

    def recording_scan(*args):
        seen['rng'] = args[8]  # the dropout key the model hands the decoder
        return jax_scan(*args)

    monkeypatch.setattr(jfd, 'synthesis_scan', recording_scan)
    want = JTacotron(hp).apply(variables, jnp.asarray(inputs), jnp.asarray(LENGTHS),
                               max_iters=MAX_ITERS, deterministic=True,
                               predict_linear=False,
                               rngs={'dropout': jax.random.PRNGKey(3)})
    chunk = hp.decoder_chunk_size
    masks = jax_prenet_masks(hp, seen['rng'], B, MAX_ITERS // chunk, chunk)
    sd = suppress_stop_tokens(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    model = convert.tacotron_model(sd, hp)
    got = model.eval()(torch.from_numpy(inputs), torch.from_numpy(LENGTHS),
                       max_iters=MAX_ITERS, masks=masks)
    for key in ('decoder_output', 'mel_outputs', 'stop_token_prediction', 'alignments'):
        assert got[key].shape == want[key].shape, key
        assert _max_abs(want[key], got[key].numpy()) <= SCAN_TOL, key
    lo, hi = -hp.max_abs_value, hp.max_abs_value
    assert got['mel_outputs'].min() >= lo - hp.lower_bound_decay
    assert got['mel_outputs'].max() <= hi
    assert got['mel_outputs'].shape == (B, MAX_ITERS * hp.outputs_per_step, hp.num_mels)


def test_generator_masks_are_seeded(taco):
    """Without explicit masks the prenet dropout comes from the generator: the same
    seed gives the same mel, another seed another one."""
    hp, _, model, inputs = taco
    x, n = torch.from_numpy(inputs), torch.from_numpy(LENGTHS)

    def run(seed):
        return model(x, n, max_iters=8, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a['mel_outputs'], b['mel_outputs'])
    assert not torch.equal(a['mel_outputs'], c['mel_outputs'])
