"""The WaveNet conditioning upsamplers: the port's five (NearestNeighbor, 1D, 2D, Resize,
SubPixel) with each activation (ReLU, leaky ReLU, none) and with and without weight
normalization against the flax UpsampleNetwork, fp32 on the CPU at the TINY widths of
test_torch_wavenet.py; the NN inits against flax's; and a tiny WaveNet with each new
upsampler through the AR path (the plain version) against the Pallas kernel in
interpret mode on the same noise.

Weights are seeded numpy noise converted by `convert.wavenet_state_dict` (unfolded, so
that a weight-normalized model keeps g and the direction apart). TINY's scales (4, 8)
are both even, where lax's SAME pads (k-1)//2 before and k//2 after; ODD_SCALES holds
the odd case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import default_hparams as jax_hparams
from tacotron2_tpu.models.wavenet.model import WaveNet as JWaveNet
from tacotron2_tpu.ops.pallas import wavenet_ar as jar
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.inference import wavenet_synthesizer
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.models.wavenet.modules import UPSAMPLE_ACTIVATIONS, UPSAMPLE_TYPES
from tacotron2_tpu_torch.ops import wavenet_ar
from tacotron2_tpu_torch.training import wavenet_trainer as wt

from test_torch_wavenet import TINY, randomize

FP32_TOL = 1e-5
B, TC = 2, 4
ODD_SCALES = ',upsample_scales=[3,5],hop_size=15'
ACTIVATIONS = {'Relu': ",upsample_activation='Relu'",
               'LeakyRelu': ",upsample_activation='LeakyRelu',leaky_alpha=0.3",
               'None': ',upsample_activation=None'}
CASES = [(t, a, wn, '') for t in UPSAMPLE_TYPES for a in ACTIVATIONS for wn in (False, True)]
CASES += [(t, 'LeakyRelu', True, ODD_SCALES) for t in ('1D', 'Resize')]


def make_hps(extra):
    """The same hparams for both packages."""
    hps = []
    for make in (jax_hparams, default_hparams):
        hp = make()
        hp.parse(TINY + extra)
        hps.append(hp)
    return hps


def _setup(extra, seed=0):
    """(JAX hp, port hp, seeded flax params, the port WaveNet holding them, mel)."""
    jhp, hp = make_hps(extra)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JWaveNet(jhp).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, jhp.get_hop_size(), 1)), jnp.zeros((1, 1, 80)))
    params = jax.tree_util.tree_map_with_path(  # weight-norm g around 1
        lambda p, x: x + 1.0 if jax.tree_util.keystr(p).endswith("['wn_g']") else x,
        randomize(shapes['params'], rng))
    model = WaveNet(hp)
    model.load_state_dict(convert.wavenet_state_dict(params, fold=False))
    # positive and negative values: the activations' negative side is read
    mel = rng.uniform(-1.0, 1.0, (B, TC, 80)).astype(np.float32)
    return jhp, hp, params, model.eval(), mel


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def test_the_port_takes_what_flax_takes():
    """Every upsample_type `Hparams.validate` accepts and every activation the flax
    UpsampleNetwork takes; anything else raises."""
    assert set(UPSAMPLE_TYPES) == {'1D', '2D', 'Resize', 'SubPixel', 'NearestNeighbor'}
    assert set(UPSAMPLE_ACTIVATIONS) == {'Relu', 'LeakyRelu', None}
    with pytest.raises(ValueError, match='upsample_type'):
        default_hparams().parse(TINY + ",upsample_type='3D'")
    hp = default_hparams()
    hp.parse(TINY + ",upsample_activation='Tanh'")
    with pytest.raises(ValueError, match='upsample_activation'):
        WaveNet(hp)


@pytest.mark.parametrize('kind,act,wn,scales', CASES)
def test_upsampler_matches_flax(kind, act, wn, scales):
    """upsample_conditioning, (B, TC, 80) -> (B, TC * hop, 80), within 1e-5 of flax's."""
    extra = (f",upsample_type='{kind}'" + ACTIVATIONS[act]
             + f',wavenet_weight_normalization={wn}' + scales)
    jhp, hp, params, model, mel = _setup(extra)
    want = JWaveNet(jhp).apply({'params': params}, jnp.asarray(mel),
                               method=JWaveNet.upsample_conditioning)
    with torch.no_grad():
        got = model.upsample_conditioning(torch.from_numpy(mel))
    assert got.shape == (B, TC * hp.get_hop_size(), 80) == want.shape
    assert _max_abs(want, got.numpy()) <= FP32_TOL
    if kind != 'NearestNeighbor' and act != 'None':
        assert float(got.min()) < 0 if act == 'LeakyRelu' else float(got.min()) == 0


@pytest.mark.parametrize('kind', ['1D', '2D', 'Resize', 'SubPixel'])
@pytest.mark.parametrize('scales', ['', ODD_SCALES])
def test_nn_init_matches_flax(kind, scales):
    """`init_parameters` with NN_init: the upsampler's kernels (and zero biases) equal
    the ones flax's init writes, exactly; a plain and a weight-normalized layer alike
    (weight norm starts the direction at that kernel and g at 1)."""
    for wn in (False, True):
        jhp, hp = make_hps(f",upsample_type='{kind}',wavenet_weight_normalization={wn}"
                           + scales)
        params = jax.jit(JWaveNet(jhp).init)(jax.random.PRNGKey(0),
                                             jnp.zeros((1, jhp.get_hop_size(), 1)),
                                             jnp.zeros((1, 1, 80)))['params']
        want = convert.wavenet_state_dict(jax.tree_util.tree_map(np.asarray, params),
                                          fold=False)
        model = wt.init_parameters(WaveNet(hp), hp, torch.Generator().manual_seed(0))
        got = model.state_dict()
        names = [n for n in want if n.startswith('upsample.')]
        assert len(names) == (3 if wn else 2) * len(hp.upsample_scales)
        for n in names:
            assert torch.equal(got[n], want[n]), n


# the new upsamplers through the AR path, each at its own activation
AR_CASES = {'NearestNeighbor': ",upsample_type='NearestNeighbor'",
            '1D': ",upsample_type='1D',upsample_activation=None",
            'Resize': ",upsample_type='Resize'",
            '2D-LeakyRelu': ",upsample_type='2D',upsample_activation='LeakyRelu'"}


@pytest.mark.parametrize('case', list(AR_CASES))
def test_generate_matches_pallas_interpret(case):
    """`wavenet_synthesizer.generate` (the upsampler, then the AR path's plain version
    on the CPU, free-running) against the JAX upsampler and `generate_ar` in interpret
    mode with the same noise, as tests/test_pallas_ar.py runs it: the conditioning
    within 1e-5 (read up to 2.4e-7), the params within 2e-2 (tests/test_pallas_ar.py:64's
    bound; read 3e-8) and the samples within 1e-4 (read 1.2e-7; each a clipped draw from
    its params, fed back)."""
    jhp, hp, params, model, mel = _setup(AR_CASES[case] + ',out_channels=2', seed=3)
    c = torch.from_numpy(mel)
    with torch.no_grad():
        got = wavenet_synthesizer.generate(model, hp, torch.Generator().manual_seed(5), c,
                                           return_params=True)
        c_up = model.upsample_conditioning(c)
    noise = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(5), *c_up.shape[:2])
    c_up_j = JWaveNet(jhp).apply({'params': params}, jnp.asarray(mel),
                                 method=JWaveNet.upsample_conditioning)
    assert _max_abs(c_up_j, c_up.numpy()) <= FP32_TOL
    audio_j, params_j = jar.generate_ar(jar.pack_params(params, jhp), c_up_j,
                                        jnp.asarray(noise.numpy()[..., None]), jhp,
                                        interpret=True)
    assert got['params'].shape == np.shape(params_j) == (B, TC * hp.get_hop_size(), 2)
    assert _max_abs(params_j, got['params'].numpy()) <= 2e-2
    assert _max_abs(audio_j, got['audio'].numpy()) <= 1e-4
