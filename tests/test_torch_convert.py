"""tacotron2_tpu_torch.convert: flax numpy trees -> the port's state_dicts.

Checks each layout change on randomised trees (seeded numpy noise on every leaf), the
weight-norm fold through a whole forward pass (fp32, max abs <= 1e-5), and the
checkpoint files the CLI reads.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.models.tacotron.model import Tacotron as JTacotron
from tacotron2_tpu.models.wavenet.model import WaveNet as JWaveNet
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.wavenet.model import WaveNet

WAVENET_TINY = ("layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,"
                "upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,num_freq=129,"
                "cin_channels=80")
TACO_TINY = ("embedding_dim=32,enc_conv_channels=32,enc_conv_num_layers=1,"
             "encoder_lstm_units=16,attention_dim=16,attention_filters=8,attention_kernel=[7],"
             "prenet_layers=[16,16],decoder_lstm_units=32,postnet_channels=32,"
             "postnet_num_layers=2,cbhg_kernels=4,cbhg_conv_channels=16,cbhg_projection=16,"
             "cbhg_highway_units=16,cbhg_rnn_units=16,num_freq=65,outputs_per_step=2")


def randomize(tree, rng):
    """Every leaf (an array or a jax.ShapeDtypeStruct) to seeded noise: kernels
    ~ N(0, 1/fan_in), weight-norm gains in [0.5, 2], BatchNorm variances in [0.5, 1.5],
    other vectors ~ N(0, 0.1)."""
    def leaf(path, x):
        shape, name = tuple(x.shape), jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name.endswith("['wn_g']"):
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        if len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape).astype(np.float32)
        return rng.normal(0.0, 0.1, shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def wavenet_tree(extra='', seed=0):
    hp = default_hparams()
    hp.parse(WAVENET_TINY + extra)
    params = jax.eval_shape(JWaveNet(hp).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 1)), jnp.zeros((1, 1, 80)))['params']
    return hp, randomize(params, np.random.default_rng(seed))


@pytest.fixture(scope='module')
def taco_tree():
    hp = default_hparams()
    hp.parse(TACO_TINY)
    k = jax.random.PRNGKey(0)
    init = partial(JTacotron(hp).init, max_iters=2, deterministic=True,
                   predict_linear=True)  # with CBHG leaves
    v = jax.eval_shape(init, {'params': k, 'dropout': k, 'zoneout': k, 'teacher': k},
                       jnp.ones((1, 8), jnp.int32), jnp.asarray([8]))
    return hp, randomize(v, np.random.default_rng(1))


def test_wavenet_layouts():
    """Dense (in, out) -> (out, in); conv (k, in, out) -> (out, in, k); SubPixel HWIO
    (3, 3, 1, s) -> OIHW (s, 1, 3, 3)."""
    hp, p = wavenet_tree()
    sd = convert.wavenet_state_dict(p)
    blk = p['residual_block_3']
    assert np.array_equal(sd['skip_conv1.weight'].numpy(), p['skip_conv1']['kernel'].T)
    assert np.array_equal(sd['residual_layers.2.conv1x1c.weight'].numpy(),
                          blk['conv1x1c']['kernel'].T)
    k = blk['causal_conv']['kernel']                                   # (3, R, G)
    w = sd['residual_layers.2.conv.weight'].numpy()                    # (G, R, 3)
    assert w.shape == (hp.gate_channels, hp.residual_channels, hp.kernel_size)
    assert np.array_equal(w[5, 3, 0], k[0, 3, 5])
    up = p['upsample_network']['subpixel_conv_2']['kernel']            # (3, 3, 1, 8)
    u = sd['upsample.convs.1.weight'].numpy()                          # (8, 1, 3, 3)
    assert u.shape == (8, 1, 3, 3) and np.array_equal(u[6, 0, 2, 1], up[2, 1, 0, 6])
    assert set(sd) == set(WaveNet(hp).state_dict())


def test_weight_norm_is_folded(tmp_path):
    """With weight normalization every kernel becomes g * v / ||v|| (norm over all but
    the last axis): the plain port model (one built without weight normalization, as
    `convert.load_wavenet` builds it for a folded checkpoint even where the hparams say
    the model was trained with it) then reproduces the flax forward pass."""
    hp, p = wavenet_tree(',wavenet_weight_normalization=True', seed=2)
    assert 'wn_g' in p['residual_block_1']['causal_conv']
    sd = convert.wavenet_state_dict(p)
    assert not any('wn_g' in k for k in sd)
    path = str(tmp_path / 'folded.pt')
    convert.save_checkpoint(path, 'wavenet', sd)
    model = convert.load_wavenet(path, hp)
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 64, 1)).astype(np.float32)
    c = rng.uniform(0, 1, (2, 2, 80)).astype(np.float32)
    want = JWaveNet(hp).apply({'params': p}, x, jnp.asarray(c))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(c))
    assert np.abs(np.asarray(want) - got.numpy()).max() <= 1e-5


def test_no_bias_config():
    """use_bias=False: the converted dict has no bias entries and loads strictly."""
    hp, p = wavenet_tree(',use_bias=False')
    sd = convert.wavenet_state_dict(p)
    assert not any(k.endswith('.bias') and not k.startswith('upsample') for k in sd)
    WaveNet(hp).load_state_dict(sd)


def test_tacotron_layouts(taco_tree):
    """BatchNorm scale/bias + batch_stats go to weight/bias/running stats; LSTM gate
    kernels keep the i, g, f, o order; the CBHG leaves (predict_linear) go to the port's
    linear post-net, a GRU's three input and three hidden kernels side by side."""
    hp, v = taco_tree
    p, s = v['params'], v['batch_stats']
    assert 'cbhg_postnet' in p
    sd = convert.tacotron_state_dict(p, s)
    model = Tacotron(hp)
    model.load_state_dict(sd)  # strict: same keys and shapes
    bn = p['postnet_convolutions']['conv_2']['bn']
    stats = s['postnet_convolutions']['conv_2']['bn']
    pre = 'postnet_convolutions.convs.1.bn.'
    assert np.array_equal(sd[pre + 'weight'].numpy(), bn['scale'])
    assert np.array_equal(sd[pre + 'running_var'].numpy(), stats['var'])
    assert model.postnet_convolutions.convs[1].bn.eps == 1e-3
    gates = p['decoder']['lstm_1']['gates']['kernel']                  # (in, 4U)
    assert np.array_equal(sd['decoder.lstm_1.gates.weight'].numpy(), gates.T)
    loc = p['decoder']['attention']['location_convolution']['kernel']  # (K, 1, F)
    assert sd['decoder.attention.location_convolution.weight'].shape == (
        hp.attention_filters, 1, hp.attention_kernel[0])
    assert np.array_equal(sd['decoder.attention.location_convolution.weight'][:, 0].numpy(),
                          loc[:, 0].T)
    gru = p['cbhg_postnet']['gru_fw']
    H = hp.cbhg_rnn_units
    assert np.array_equal(sd['cbhg_postnet.gru_fw.input.weight'][H:2 * H].numpy(),
                          gru['iz']['kernel'].T)
    assert np.array_equal(sd['cbhg_postnet.gru_fw.hidden.weight'][2 * H:].numpy(),
                          gru['hn']['kernel'].T)
    assert np.array_equal(sd['cbhg_postnet.gru_fw.bias_hn'].numpy(), gru['hn']['bias'])


def test_checkpoint_round_trip(tmp_path, taco_tree):
    _, v = taco_tree
    sd = convert.tacotron_state_dict(v['params'], v['batch_stats'])
    path = str(tmp_path / 'taco.pt')
    convert.save_checkpoint(path, 'tacotron', sd)
    back = convert.load_checkpoint(path, 'tacotron')
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(ValueError):
        convert.load_checkpoint(path, 'wavenet')
