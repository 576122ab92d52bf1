"""WaveNet parity: the PyTorch port (tacotron2_tpu_torch) against the JAX package.

Every parameter of the flax model is overwritten with seeded numpy noise (zero biases
and identity-like inits hide transposes), converted with tacotron2_tpu_torch.convert,
and both sides get the same numpy inputs. Module and forward-pass checks are fp32 with
max abs <= 1e-5. The AR loop is held against the Pallas kernel run in interpret mode
on the same packed weights and noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.models.wavenet import modules as jmod
from tacotron2_tpu.models.wavenet.model import WaveNet as JWaveNet
from tacotron2_tpu.ops.pallas import wavenet_ar as jar
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.ops import wavenet_ar
from tacotron2_tpu_torch.utils import randomize_weights

TINY = ("layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,"
        "upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,num_freq=129,"
        "cin_channels=80")
B, TC = 2, 8
FP32_TOL = 1e-5


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


def make_hp(extra=''):
    hp = default_hparams()
    hp.parse(TINY + extra)
    return hp


@pytest.fixture(scope='module')
def wavenet_pair():
    """(hp, flax params, port model, mel (B, TC, 80) numpy) with random weights."""
    hp = make_hp()
    rng = np.random.default_rng(0)
    params = jax.eval_shape(JWaveNet(hp).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 1)), jnp.zeros((1, 1, 80)))['params']
    params = randomize(params, rng)
    model = WaveNet(hp)
    model.load_state_dict(convert.wavenet_state_dict(params))
    mel = rng.uniform(0.0, 1.0, (B, TC, 80)).astype(np.float32)
    return hp, params, model.eval(), mel


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize('part', ['first_conv', 'causal_conv', 'residual_block',
                                  'upsample', 'forward'])
def test_modules_match_jax(wavenet_pair, part):
    """Each module of the slice, and the teacher-forced forward pass (legacy sqrt(1/2)
    skip scaling, first skip unscaled), agree with flax in fp32."""
    hp, params, model, mel = wavenet_pair
    rng = np.random.default_rng(1)
    T = TC * hp.get_hop_size()
    R, G = hp.residual_channels, hp.gate_channels
    with torch.no_grad():
        if part == 'first_conv':
            x = rng.uniform(-1, 1, (B, T, 1)).astype(np.float32)
            want = jmod.Conv1x1(1, R).apply({'params': params['first_conv']}, x)
            got = model.first_conv(torch.from_numpy(x))
        elif part == 'causal_conv':
            x = rng.normal(size=(B, T, R)).astype(np.float32)
            blk = params['residual_block_2']  # dilation 2
            want = jmod.CausalConv1D(R, G, hp.kernel_size, 2).apply(
                {'params': blk['causal_conv']}, x)
            got = model.residual_layers[1].conv(torch.from_numpy(x))
        elif part == 'residual_block':
            x = rng.normal(size=(B, T, R)).astype(np.float32)
            c = rng.uniform(0, 1, (B, T, 80)).astype(np.float32)
            jblk = jmod.ResidualConv1DGLU(R, G, hp.kernel_size, hp.skip_out_channels,
                                          80, -1, 0.0, 2)
            want = jblk.apply({'params': params['residual_block_2']}, x, c, None)
            got = model.residual_layers[1](torch.from_numpy(x), torch.from_numpy(c))
            assert _max_abs(want[1], got[1]) <= FP32_TOL
            want, got = want[0], got[0]
        elif part == 'upsample':
            want = JWaveNet(hp).apply({'params': params}, jnp.asarray(mel),
                                      method=JWaveNet.upsample_conditioning)
            got = model.upsample_conditioning(torch.from_numpy(mel))
            assert got.shape == (B, T, 80)
        else:
            x = rng.uniform(-1, 1, (B, T, 1)).astype(np.float32)
            want = JWaveNet(hp).apply({'params': params}, x, jnp.asarray(mel))
            got = model(torch.from_numpy(x), torch.from_numpy(mel))
            assert got.shape == (B, T, 2)
    assert _max_abs(want, got.numpy()) <= FP32_TOL


def test_pack_params_matches_jax(wavenet_pair):
    """Same packed weights as the JAX pack_params: layouts, dtypes and the w_fused fold
    (layer 0 zero). The port's w_cond keeps cin rows (no TPU lane padding)."""
    hp, params, model, _ = wavenet_pair
    want = jax.device_get(jar.pack_params(params, hp))
    got = wavenet_ar.pack_params(model, hp)
    assert set(got) == set(want)
    for name, w in got.items():
        ref = np.asarray(want[name], np.float32)
        if name == 'w_cond':
            assert ref.shape[0] == 128 and w.shape[0] == hp.cin_channels
            ref = ref[:hp.cin_channels]
        assert w.dtype == (torch.bfloat16 if want[name].dtype == jnp.bfloat16
                           else torch.float32), name
        assert tuple(w.shape) == ref.shape, name
        # bf16 leaves may differ by one bf16 rounding step of the f32 sum order
        tol = 1e-6 if w.dtype == torch.float32 else 1e-2 * max(1.0, np.abs(ref).max())
        assert _max_abs(w.float().numpy(), ref) <= tol, name
    assert not got['w_fused'][0].float().any()


@pytest.fixture(scope='module')
def pallas_run(wavenet_pair):
    """One interpret-mode run of the Pallas kernel, shared by the AR tests."""
    hp, params, model, mel = wavenet_pair
    rng = np.random.default_rng(7)
    c_up = model.upsample_conditioning(torch.from_numpy(mel)).detach().numpy()
    noise = rng.standard_normal((B, c_up.shape[1])).astype(np.float32)
    weights = jar.pack_params(params, hp)
    audio, dist = jar.generate_ar(weights, jnp.asarray(c_up), jnp.asarray(noise[..., None]),
                                  hp, interpret=True)
    return c_up, noise, np.array(audio), np.array(dist)


def test_reference_matches_pallas_interpret(wavenet_pair, pallas_run):
    """generate_ar_reference, teacher-forced on the Pallas kernel's audio, gives the
    kernel's per-step params within 2e-2 (the bound of tests/test_pallas_ar.py:64).
    Observed on this config: 3e-8 (both round the matmul operands to bf16 at the same
    places; only the f32 summation order differs)."""
    hp, _, model, _ = wavenet_pair
    c_up, noise, audio_j, params_j = pallas_run
    weights = wavenet_ar.pack_params(model, hp)
    audio_t, params_t = wavenet_ar.generate_ar_reference(
        weights, torch.from_numpy(c_up), torch.from_numpy(noise), hp,
        targets=torch.from_numpy(audio_j))
    assert params_t.shape == params_j.shape == (B, c_up.shape[1], 2)
    assert _max_abs(params_t.numpy(), params_j) <= 2e-2
    # the samples the Pallas kernel drew follow from its params and the shared noise
    logs = np.maximum(params_j[..., 1], hp.log_scale_min_gauss)
    drawn = np.clip(params_j[..., 0] + np.exp(logs) * noise, -1, 1)
    assert _max_abs(drawn, audio_j) <= 1e-5
    assert np.array_equal(audio_t.numpy(), audio_j)


def test_reference_matches_pallas_f32_conditioning(wavenet_pair):
    """At B=17 the Pallas kernel pads the batch to 24 rows, past its 16-row bf16
    conditioning slab, and keeps the conditioning row in f32 (wavenet_ar.py:211,
    310-315); the plain version rounds that row to bf16 only where the kernel does.
    Teacher-forced on the Pallas audio, per-step params agree within 1e-6 except
    where the f32 row's sum order flips a later bf16 rounding: observed 10 of 4,352
    params beyond 1e-6 (two flips, each seen at the step and at its ring taps), max
    1.7e-4. Bounds set from that reading: at most 1% of params beyond 1e-6, max 5e-4.
    Rounding the row at every batch size, as the port once did, put 76% of params
    beyond 1e-6, max 1.4e-3 (PERF.md)."""
    hp, params, model, _ = wavenet_pair
    rng = np.random.default_rng(17)
    mel = rng.uniform(0.0, 1.0, (17, 4, 80)).astype(np.float32)
    c_up = model.upsample_conditioning(torch.from_numpy(mel)).detach().numpy()
    noise = rng.standard_normal(c_up.shape[:2]).astype(np.float32)
    audio_j, params_j = jar.generate_ar(jar.pack_params(params, hp), jnp.asarray(c_up),
                                        jnp.asarray(noise[..., None]), hp, interpret=True)
    audio_j, params_j = np.array(audio_j), np.array(params_j)
    _, params_t = wavenet_ar.generate_ar_reference(
        wavenet_ar.pack_params(model, hp), torch.from_numpy(c_up),
        torch.from_numpy(noise), hp, targets=torch.from_numpy(audio_j))
    assert params_t.shape == params_j.shape == (17, c_up.shape[1], 2)
    err = np.abs(params_t.numpy() - params_j)
    assert np.mean(err > 1e-6) <= 0.01 and err.max() <= 5e-4


def test_reference_free_running(wavenet_pair, pallas_run):
    """Free-running, the plain version draws its own samples from its own params:
    finite, in [-1, 1], and a deterministic function of the noise."""
    hp, _, model, _ = wavenet_pair
    c_up, noise, _, _ = pallas_run
    weights = wavenet_ar.pack_params(model, hp)
    c, n = torch.from_numpy(c_up[:, :96]), torch.from_numpy(noise[:, :96])
    audio, params = wavenet_ar.generate_ar_reference(weights, c, n, hp)
    logs = torch.clamp(params[..., 1], min=hp.log_scale_min_gauss)
    drawn = torch.clamp(params[..., 0] + torch.exp(logs) * n, -1, 1)
    assert torch.equal(drawn, audio)
    assert torch.isfinite(audio).all() and audio.abs().max() <= 1.0
    again, _ = wavenet_ar.generate_ar_reference(weights, c, n, hp, return_params=False)
    assert torch.equal(again, audio)


def test_generate_ar_dispatch_on_cpu(wavenet_pair):
    """On a CPU tensor the wrapper runs the plain version and launches nothing."""
    hp, _, model, mel = wavenet_pair
    weights = wavenet_ar.pack_params(model, hp)
    c_up = model.upsample_conditioning(torch.from_numpy(mel[:, :2]))
    noise = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(3), B, c_up.shape[1])
    before = wavenet_ar.LAUNCHES
    audio, params = wavenet_ar.generate_ar(weights, c_up, noise, hp)
    ref, ref_params = wavenet_ar.generate_ar_reference(weights, c_up, noise, hp)
    assert wavenet_ar.LAUNCHES == before
    assert torch.equal(audio, ref) and torch.equal(params, ref_params)
    with pytest.raises(ValueError):
        wavenet_ar.generate_ar(weights, c_up.to('meta'), noise.to('meta'), hp)


def test_packed_layout_is_what_pack_params_made(wavenet_pair):
    """The wrapper checks weights against the layout pack_params recorded, and there
    is none at sizes nothing was packed at."""
    hp, _, model, _ = wavenet_pair
    got = wavenet_ar.pack_params(model, hp)
    assert wavenet_ar.packed_layout(hp) == {
        n: (w.dtype, tuple(w.shape)) for n, w in got.items()}
    assert set(wavenet_ar.KERNEL_WEIGHTS) == set(got)
    with pytest.raises(ValueError):
        wavenet_ar.packed_layout(make_hp(',residual_channels=24,gate_channels=40'))


def test_randomize_weights_is_seeded_and_of_order_one():
    """Every float parameter and buffer is redrawn from the generator: weights with
    std 1/sqrt(fan_in), nonzero vectors, BatchNorm variances in [0.5, 1.5]."""
    def make(seed):
        torch.manual_seed(123)
        module = torch.nn.Sequential(torch.nn.Conv1d(64, 32, 3), torch.nn.BatchNorm1d(32))
        return randomize_weights(module, torch.Generator().manual_seed(seed))
    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a['0.weight'], c['0.weight'])
    assert abs(a['0.weight'].std().item() * (64 * 3) ** 0.5 - 1.0) < 0.05
    assert a['0.bias'].abs().min() > 0 and a['1.running_mean'].abs().min() > 0
    var = a['1.running_var']
    assert var.min() >= 0.5 and var.max() <= 1.5
    assert a['1.num_batches_tracked'].item() == 0


def test_make_noise_and_ring_sizes():
    hp = make_hp()
    a = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(5), 3, 40)
    b = wavenet_ar.make_noise(hp, torch.Generator().manual_seed(5), 3, 40)
    assert a.shape == (3, 40) and a.dtype == torch.float32 and torch.equal(a, b)
    assert wavenet_ar.dilations(hp) == [1, 2, 1, 2]
    assert wavenet_ar.ring_floats(hp) == 2 * 8 * (1 + 2 + 1 + 2)
    # default config: sum (k-1)*d*R over 20 layers in 2 stacks = 523,776 floats
    assert wavenet_ar.ring_floats(default_hparams()) == 523776


@pytest.mark.parametrize('extra', [
    ",input_type='mulaw-quantize',out_channels=65536",
    ",input_type='mulaw-quantize',quantize_channels=2048,out_channels=2048",
    ',cin_channels=-1', ',kernel_size=1'])
def test_unsupported_configs_raise(extra):
    """The big-vocab categorical (more than 1,024 classes: the variant that draws its
    noise inside the kernel), a model without local conditioning and kernel_size=1 (no
    ring buffers) raise, the first by its name; the MoL head (out_channels=30) is
    covered (tests/test_torch_paper.py)."""
    wavenet_ar.check_supported(make_hp(',out_channels=30'))
    hp = make_hp(extra)
    with pytest.raises(NotImplementedError, match='big-vocab' if 'quantize' in extra else None):
        wavenet_ar.check_supported(hp)


@pytest.mark.parametrize('extra,variant', [
    (',gin_channels=16', 'gaussian-fused'), (',wavenet_fused_ar=False', 'gaussian-plain'),
    (",input_type='mulaw'", 'gaussian-fused'),
    (",input_type='mulaw',out_channels=30,wavenet_fused_ar=False", 'mol-plain'),
    (",input_type='mulaw-quantize',quantize_channels=256,out_channels=256",
     'categorical-fused'),
    (",input_type='mulaw-quantize',quantize_channels=1024,out_channels=1024,"
     "wavenet_fused_ar=False", 'categorical-plain')])
def test_supported_configs(extra, variant):
    """Global conditioning, the plain chain, mu-law input and the categorical head up to
    1,024 classes are covered, each by the kernel instantiation named; the plain chain
    packs no w_fused."""
    hp = make_hp(extra)
    wavenet_ar.check_supported(hp)
    assert wavenet_ar.variant(hp) == variant
    assert wavenet_ar.variant(hp, has_g=True) == variant + '+g'
    weights = wavenet_ar.pack_params(WaveNet(hp), hp)
    assert ('w_fused' in weights) == ('b_fused' in weights) == hp.wavenet_fused_ar
    Q = hp.out_channels
    assert weights['first_w'].shape == ((Q, 8) if 'categorical' in variant else (1, 8))
    assert weights['w_s2'].shape == (8, Q) and weights['w_s2'].dtype == torch.float32
    assert wavenet_ar.packed_layout(hp) == {n: (w.dtype, tuple(w.shape))
                                            for n, w in weights.items()}
