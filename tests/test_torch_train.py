"""WaveNet training parity: the port's trainer (tacotron2_tpu_torch/training, data,
train.py) against the JAX package, module by module and as a whole train step.

Tiny sizes, inputs from numpy seeds, fp32 on the CPU. Every flax parameter is overwritten
with seeded noise and converted (`convert.wavenet_state_dict(fold=False)`,
`convert.wavenet_train_state_from_jax`), and both sides get the same batch. Dropout is
compared on a shared mask: the flax block's `jax.random.bits` is patched to return bits
made with numpy, and the port is given the mask those bits spell. Tolerances are stated
in each test.
"""

import copy
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_split

from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.data.wavenet_loader import WaveNetDataset as JDataset
from tacotron2_tpu.models.wavenet import distributions as jdist
from tacotron2_tpu.models.wavenet import modules as jmod
from tacotron2_tpu.models.wavenet.model import WaveNet as JWaveNet
from tacotron2_tpu.models.wavenet.model import compute_wavenet_loss as j_loss
from tacotron2_tpu.ops import audio as jaudio
from tacotron2_tpu.ops import mcd as jmcd
from tacotron2_tpu.ops import stft_common as jsc
from tacotron2_tpu.training import checkpoint_select as jselect
from tacotron2_tpu.training import schedules as jsched
from tacotron2_tpu.training import wavenet_trainer as jwt
from tacotron2_tpu.training import weight_norm_init as jwn
from tacotron2_tpu_torch import convert, train
from tacotron2_tpu_torch.data.loader import Prefetcher
from tacotron2_tpu_torch.data.wavenet_loader import WaveNetDataset, train_test_split
from tacotron2_tpu_torch.models.wavenet import distributions as dist
from tacotron2_tpu_torch.models.wavenet.model import WaveNet, compute_wavenet_loss
from tacotron2_tpu_torch.models.wavenet.modules import ResidualConv1DGLU
from tacotron2_tpu_torch.ops import audio, mcd, stft_common
from tacotron2_tpu_torch.training import checkpoint_select, schedules, weight_norm_init
from tacotron2_tpu_torch.training import wavenet_train
from tacotron2_tpu_torch.training import wavenet_trainer as wt
from tacotron2_tpu_torch.training.checkpointing import CheckpointManager
from tacotron2_tpu_torch.training.common import to_device
from tacotron2_tpu_torch.utils import ValueWindow

from test_torch_wavenet import TINY, randomize

FP32_TOL = 1e-5
B, TC, HOP = 2, 4, 32
T = TC * HOP
HEADS = {'gaussian': '', 'mol': ',out_channels=30',
         'categorical': ",input_type='mulaw-quantize',quantize_channels=64,out_channels=64"}
WN_G = ',wavenet_weight_normalization=True,gin_channels=8,n_speakers=3'


def make_hp(extra=''):
    hp = default_hparams()
    hp.parse(TINY + ',wavenet_batch_size=2,wavenet_dropout=0.0' + extra)
    return hp


def make_batch(hp, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    if hp.input_type == 'mulaw-quantize':
        y = rng.integers(0, hp.quantize_channels, (B, T)).astype(np.int32)
    else:
        y = (scale * rng.uniform(-1, 1, (B, T))).astype(np.float32)
    batch = dict(audio=y, input_lengths=np.array([T, T - 40], np.int32),
                 mel_conditions=rng.uniform(0, 1, (B, TC, 80)).astype(np.float32))
    if hp.gin_channels > 0:
        batch['speaker_ids'] = np.array([2, 0], np.int32)
    return batch


def flax_params(hp, seed=0):
    """Seeded random flax WaveNet params (weight-norm g around 1, not around 0)."""
    in_ch = hp.quantize_channels if hp.input_type == 'mulaw-quantize' else 1
    g = jnp.zeros((1,), jnp.int32) if hp.gin_channels > 0 else None
    shapes = jax.eval_shape(JWaveNet(hp).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HOP, in_ch)), jnp.zeros((1, 1, 80)), g)['params']
    params = randomize(shapes, np.random.default_rng(seed))
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x + 1.0 if jax.tree_util.keystr(path).endswith("['wn_g']") else x,
        params)


def port_batch(batch):
    return to_device(batch, 'cpu')


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize('upsample', ['SubPixel', '2D'])
def test_weight_norm_forward_matches_flax(upsample):
    """The teacher-forced pass of a weight-normalized model (every conv, the
    upsampler's too, g * v / sqrt(sum v^2 + 1e-8)) agrees with flax to 1e-5, and
    pack_params reads the effective weights: the folded inference model packs the same."""
    hp = make_hp(WN_G + f",upsample_type='{upsample}'")
    params = flax_params(hp)
    batch = make_batch(hp)
    model = WaveNet(hp)
    model.load_state_dict(convert.wavenet_state_dict(params, fold=False))
    assert any('parametrizations.weight.0.g' in k for k in model.state_dict())
    x = batch['audio'][..., None]
    want = JWaveNet(hp).apply({'params': params}, x, batch['mel_conditions'],
                              batch['speaker_ids'])
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(batch['mel_conditions']),
                    torch.from_numpy(batch['speaker_ids']))
    assert _max_abs(want, _np(got)) <= FP32_TOL
    folded = WaveNet(hp.replace(wavenet_weight_normalization=False))
    folded.load_state_dict(convert.wavenet_state_dict(params))
    from tacotron2_tpu_torch.ops import wavenet_ar
    a = wavenet_ar.pack_params(model, hp)
    b = wavenet_ar.pack_params(folded, hp)
    for name in a:
        err = _max_abs(_np(a[name].float()), _np(b[name].float()))
        if a[name].dtype == torch.bfloat16:
            # weights equal to 1e-7 packed in bf16: at most one bf16 step apart, rarely
            assert err <= 2e-2, name
            assert float((a[name].float() != b[name].float()).float().mean()) <= 0.01, name
        else:  # f32 biases, first conv, head: the folded product's last places
            assert err <= FP32_TOL, name


@pytest.mark.parametrize('rate', [0.05, 0.5])
def test_dropout_with_shared_mask_matches_flax(monkeypatch, rate):
    """The residual block in training: 16 random bits an element, kept below
    round(keep * 65536), the kept values divided by the nominal keep, the residual
    untouched. The same bits on both sides: 1e-5. The port's own draw keeps a share
    within 4 standard errors of keep."""
    hp = make_hp(f',wavenet_dropout={rate}')
    params = flax_params(hp)['residual_block_2']
    rng = np.random.default_rng(3)
    R, G, S = hp.residual_channels, hp.gate_channels, hp.skip_out_channels
    x = rng.normal(size=(B, T, R)).astype(np.float32)
    c = rng.uniform(0, 1, (B, T, 80)).astype(np.float32)
    bits = rng.integers(0, 65536, x.shape).astype(np.uint16)
    monkeypatch.setattr(jax.random, 'bits', lambda key, shape, dtype: jnp.asarray(bits))
    jblk = jmod.ResidualConv1DGLU(R, G, hp.kernel_size, S, 80, -1, rate, 2)
    want = jblk.apply({'params': params}, x, c, None, True,
                      rngs={'dropout': jax.random.PRNGKey(0)})
    blk = ResidualConv1DGLU(R, G, hp.kernel_size, S, 80, 2, dropout=rate)
    sd = {}
    convert._conv1d(sd, 'conv', params['causal_conv'])
    for name in ('conv1x1c', 'conv1x1_out', 'conv1x1_skip'):
        convert._dense(sd, name, params[name])
    blk.load_state_dict(sd)
    mask = torch.from_numpy(bits.astype(np.int64)) < min(65535, round((1 - rate) * 65536.0))
    with torch.no_grad():
        got = blk(torch.from_numpy(x), torch.from_numpy(c), train=True, mask=mask)
        off = blk(torch.from_numpy(x), torch.from_numpy(c), train=False)
    assert _max_abs(want[0], _np(got[0])) <= FP32_TOL
    assert _max_abs(want[1], _np(got[1])) <= FP32_TOL
    assert _max_abs(_np(off[0]), _np(got[0])) > 1e-2
    drawn = blk.dropout_mask((64, 256, 8), torch.Generator().manual_seed(0)).float()
    assert abs(drawn.mean().item() - (1 - rate)) < 4 * (rate * (1 - rate) / drawn.numel()) ** .5
    with pytest.raises(ValueError, match='generator'):
        blk(torch.from_numpy(x), torch.from_numpy(c), train=True)


def test_first_conv_lookup_is_the_one_hot_product():
    """Class ids through the first conv select its columns: equal to the one-hot
    product bit for bit (adding zeros changes nothing), with and without weight norm."""
    for wn in (False, True):
        hp = make_hp(HEADS['categorical'] + f',wavenet_weight_normalization={wn}')
        model = WaveNet(hp)
        ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (B, T)))
        with torch.no_grad():
            assert torch.equal(model.first_conv(ids), model.first_conv(model.encode_input(ids)))


# ---------------------------------------------------------------- losses

def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    y = rng.uniform(-1, 1, (B, T)).astype(np.float32)
    y[0, :4] = [-1.0, 1.0, -0.9995, 0.9995]        # the two edge branches
    mask = (np.arange(T)[None] < np.array([[T], [T - 30]])).astype(np.float32)
    return rng, y, mask


@pytest.mark.parametrize('masked', [True, False])
def test_mol_loss_and_gradient_match_jax(masked):
    """Discretized MoL loss on random params with the edge cases y = +-1 and a tiny
    cdf_delta (log-scales near their floor and far means, where the loss falls back to
    the mid-bin density): value 1e-5 relative, gradient 1e-5 of its largest entry."""
    rng, y, mask = _loss_inputs()
    p = rng.normal(0, 1, (B, T, 30)).astype(np.float32)
    p[..., 20:] = rng.uniform(-9, -2, (B, T, 10))
    p[1, :16, 20:] = -40.0                          # below log_scale_min: clamped
    p[1, 16:32, 10:20] += 3.0                       # far means: cdf_delta <= 1e-5
    m = mask if masked else None
    lsm = float(np.log(1e-14))
    want, grad = jax.value_and_grad(lambda q: jdist.discretized_mix_logistic_loss(
        q, y, 65536, lsm, m))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    got = dist.discretized_mix_logistic_loss(
        pt, torch.from_numpy(y), 65536, lsm, torch.from_numpy(m) if masked else None)
    got.backward()
    assert abs(float(want) - got.item()) <= 1e-5 * abs(float(want))
    assert _max_abs(grad, _np(pt.grad)) <= 1e-5 * float(np.abs(grad).max())


@pytest.mark.parametrize('use_cdf', [False, True])
def test_gaussian_loss_and_gradient_match_jax(use_cdf):
    """Gaussian MLE loss, with and without the CDF trick (bin probability floored at
    1e-12), log-scales clamped at log_scale_min_gauss: value and gradient to 1e-5
    relative (the CDF difference of two f32 erfs: 1e-4)."""
    rng, y, mask = _loss_inputs(1)
    p = rng.normal(0, 0.5, (B, T, 2)).astype(np.float32)
    p[..., 1] = rng.uniform(-9, -1, (B, T))
    p[1, :8, 1] = -30.0
    lsm = float(np.log(1e-7))
    want, grad = jax.value_and_grad(lambda q: jdist.gaussian_mle_loss(
        q, y, 65536, lsm, use_cdf, mask))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    got = dist.gaussian_mle_loss(pt, torch.from_numpy(y), 65536, lsm, use_cdf,
                                 torch.from_numpy(mask))
    got.backward()
    tol = 1e-4 if use_cdf else 1e-5
    assert abs(float(want) - got.item()) <= tol * abs(float(want))
    assert _max_abs(grad, _np(pt.grad)) <= tol * float(np.abs(grad).max())


def test_cross_entropy_and_shifted_loss_match_jax():
    """Masked softmax cross-entropy and its gradient (1e-5); compute_wavenet_loss
    scores prediction t against target t+1 with the mask shifted, for every head."""
    rng, _, mask = _loss_inputs(2)
    logits = rng.normal(0, 2, (B, T, 64)).astype(np.float32)
    ids = rng.integers(0, 64, (B, T)).astype(np.int32)
    want, grad = jax.value_and_grad(lambda q: jdist.masked_cross_entropy_loss(
        q, ids, mask))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = dist.masked_cross_entropy_loss(lt, torch.from_numpy(ids), torch.from_numpy(mask))
    got.backward()
    assert abs(float(want) - got.item()) <= 1e-5
    assert _max_abs(grad, _np(lt.grad)) <= 1e-5 * float(np.abs(grad).max())
    assert dist._reduce(torch.ones(2, 3), torch.zeros(2, 3)).item() == 0.0
    for head, extra in HEADS.items():
        hp = make_hp(extra)
        y_hat = rng.normal(0, 1, (B, T, hp.out_channels)).astype(np.float32)
        y = ids if head == 'categorical' else rng.uniform(-1, 1, (B, T)).astype(np.float32)
        want = float(j_loss(hp, jnp.asarray(y_hat), jnp.asarray(y), jnp.asarray(mask)))
        got = compute_wavenet_loss(hp, torch.from_numpy(y_hat), torch.from_numpy(y),
                                   torch.from_numpy(mask)).item()
        assert abs(want - got) <= 1e-5 * abs(want), head


# ---------------------------------------------------------------- schedule

@pytest.mark.parametrize('schedule', ['noam', 'exponential'])
def test_learning_rate_matches_jax(schedule):
    """Both schedules at steps 0, 1, the warmup step and 1e5: 1e-6 relative (float32)."""
    hp = make_hp(f",wavenet_lr_schedule='{schedule}'")
    for step in (0, 1, int(hp.wavenet_warmup), 100000):
        want = float(jsched.wavenet_learning_rate(hp, step))
        got = schedules.wavenet_learning_rate(hp, step)
        assert isinstance(got, float) and abs(want - got) <= 1e-6 * want, step


# ---------------------------------------------------------------- the train step

def _adam_state(opt_state):
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _as_numpy_state(state):
    adam = _adam_state(state.opt_state)
    to_np = partial(jax.tree_util.tree_map, np.asarray)
    return dict(step=int(state.step), params=to_np(state.params),
                ema_params=to_np(state.ema_params), mu=to_np(adam.mu), nu=to_np(adam.nu))


def _state_tensors(state):
    """name -> tensor of everything a train step changes."""
    out = {}
    for kind, model in (('param', state.model), ('ema', state.ema_model)):
        out.update({f'{kind}:{n}': p for n, p in model.named_parameters()})
    names = [n for n, _ in state.model.named_parameters()]
    out.update({f'mu:{n}': m for n, m in zip(names, state.exp_avg)})
    out.update({f'nu:{n}': m for n, m in zip(names, state.exp_avg_sq)})
    return out


TRAIN_CASES = {
    'gaussian': (HEADS['gaussian'], 1.0),
    'gaussian-wn-g': (HEADS['gaussian'] + WN_G, 1.0),
    # audio scaled 40x: a gradient passes 100 in norm and 5 in value, so both clips act
    'gaussian-clipped': (HEADS['gaussian'] + ",wavenet_lr_schedule='noam'", 40.0),
    'mol-wn-g': (HEADS['mol'] + WN_G + ',legacy=False,residual_legacy=False', 1.0),
    'categorical': (HEADS['categorical'], 1.0),
    'categorical-wn-g': (HEADS['categorical'] + WN_G, 1.0),
}


@pytest.mark.parametrize('case', list(TRAIN_CASES))
def test_train_steps_match_jax(case):
    """One and three train steps from a converted state on the same batch, dropout 0:
    loss, grad_norm, learning rate, and every parameter, EMA value and Adam moment
    against `wavenet_trainer.train_step`. The state converted is two steps old, so its
    step count and moments are not zero. Tolerance: 2e-5 relative on loss and
    grad_norm (f32 sum order), and for the tensors 2e-5 of each tensor's largest
    magnitude after one step, 1e-4 after three (Adam divides by sqrt(nu): an entry
    whose gradient is near zero amplifies a last-place difference; read 1e-7 to 3e-5)."""
    extra, scale = TRAIN_CASES[case]
    hp = make_hp(extra + ',wavenet_ema_decay=0.9')
    batch = make_batch(hp, scale=scale)
    params = flax_params(hp)
    if case.startswith('mol'):
        # wide mixtures (log-scales up by 6): every bin probability stays under 1e-5 and
        # the loss takes its mid-bin density branch. With log-scales around 0 the
        # probabilities sit at that threshold, where log(sigmoid(a) - sigmoid(b)) in f32
        # keeps two digits: the JAX step jitted and not jitted then differ by 3e-4 in
        # grad_norm, as far as either is from this step. The other branches are held
        # by test_mol_loss_and_gradient_match_jax.
        head = dict(params['skip_conv2'])
        head['bias'] = head['bias'] + np.r_[np.zeros(20), np.full(10, 6.0)].astype(np.float32)
        params = dict(params, skip_conv2=head)
    tx = jwt.make_optimizer(hp)
    jstate = jwt.WaveNetTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   ema_params=jax.tree_util.tree_map(jnp.copy, params),
                                   opt_state=tx.init(params))
    jstep = jax.jit(partial(jwt.train_step, hp=hp))
    key = jax.random.PRNGKey(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        jstate, _ = jstep(jstate, jbatch, key)
    state = convert.wavenet_train_state_from_jax(_as_numpy_state(jstate), hp)
    assert state.step == 2
    pbatch = port_batch(batch)
    # a weight-normalized first conv over one scalar input has a direction of one
    # number an output channel: g * v / |v| does not depend on its size, its gradient
    # is rounding noise (3e-6 and less), and its moments are held to 1e-7 absolute
    noise_grad = ('first_conv.parametrizations.weight.original'
                  if hp.wavenet_weight_normalization and hp.input_type != 'mulaw-quantize'
                  else None)
    for n_steps, tol in ((1, 2e-5), (3, 1e-4)):
        while state.step < 2 + n_steps:
            jstate, jm = jstep(jstate, jbatch, key)
            m = wt.train_step(state, pbatch, hp)
            assert abs(float(jm['loss']) - m['loss'].item()) <= 2e-5 * abs(float(jm['loss']))
            assert abs(float(jm['grad_norm']) - m['grad_norm'].item()) \
                <= 2e-5 * float(jm['grad_norm'])
            assert abs(float(jm['learning_rate']) - m['learning_rate']) \
                <= 1e-6 * float(jm['learning_rate'])
        want = _state_tensors(convert.wavenet_train_state_from_jax(_as_numpy_state(jstate), hp))
        got = _state_tensors(state)
        assert set(want) == set(got) and state.step == int(jstate.step)
        for name in want:
            bound = tol * max(float(want[name].abs().max()), 1e-6)
            if noise_grad and name.split(':')[0] in ('mu', 'nu') and name.endswith(noise_grad):
                bound = 1e-7
            assert _max_abs(_np(want[name]), _np(got[name])) <= bound, (name, n_steps)
    if case == 'gaussian-clipped':
        grads = jax.grad(lambda p: j_loss(hp, JWaveNet(hp).apply(
            {'params': p}, jbatch['audio'][..., None], jbatch['mel_conditions']),
            jbatch['audio'], jwt._batch_mask(jbatch)))(jstate.params)
        leaves = jax.tree_util.tree_leaves(grads)
        assert max(float(jnp.sqrt(jnp.sum(g * g))) for g in leaves) > 100.0
        assert max(float(jnp.abs(g).max()) for g in leaves) > 5.0
    # the EMA moved away from the parameters, and the moments are in use
    tensors = _state_tensors(state)
    assert any((tensors[k] - tensors[k.replace('param:', 'ema:')]).abs().max() > 1e-7
               for k in tensors if k.startswith('param:'))


def test_clip_gradients():
    """Norm to 100 with sqrt(sum + 1e-12), then values to +-5."""
    hp = make_hp()
    g = [torch.full((100,), 20.0), torch.tensor([300.0, 1.0]), torch.zeros(3)]
    out = wt.clip_gradients(g, hp)
    assert torch.allclose(out[0], torch.full((100,), 5.0))          # norm 200 -> 100: 10 -> 5
    assert torch.allclose(out[1], torch.tensor([5.0, 1.0 / 3.0000167]), rtol=1e-5)
    assert torch.equal(out[2], torch.zeros(3))


def test_train_step_with_dropout_is_seeded():
    """Two states stepped with generators seeded alike agree bit for bit; another seed
    gives another loss; eval runs without dropout on the live weights."""
    hp = make_hp(',wavenet_dropout=0.5')
    batch = port_batch(make_batch(hp))
    losses = []
    for seed in (0, 0, 1):
        state = wt.create_train_state(hp, 'cpu')
        gen = torch.Generator().manual_seed(seed)
        losses.append([wt.train_step(state, batch, hp, gen)['loss'].item() for _ in range(2)])
    assert losses[0] == losses[1] and losses[0] != losses[2]
    ev = wt.eval_teacher_forced_step(state, batch, hp)
    assert ev['y_hat'].shape == (B, T, 2) and not ev['y_hat'].requires_grad
    assert ev['loss'].item() == wt.eval_teacher_forced_step(state, batch, hp)['loss'].item()


def test_eval_teacher_forced_matches_jax():
    hp = make_hp(HEADS['mol'])
    params = flax_params(hp)
    batch = make_batch(hp)
    jstate = jwt.WaveNetTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   ema_params=params, opt_state=None)
    want = jwt.eval_teacher_forced_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                        hp)
    model = WaveNet(hp)
    model.load_state_dict(convert.wavenet_state_dict(params, fold=False))
    got = wt.eval_teacher_forced_step(wt.state_from_model(model), port_batch(batch), hp)
    assert abs(float(want['loss']) - got['loss'].item()) <= 1e-5 * abs(float(want['loss']))
    assert _max_abs(want['y_hat'], _np(got['y_hat'])) <= FP32_TOL


def test_init_parameters_follow_flax():
    """A fresh state: zero biases, g = 1, kernels with variance 1/fan_in cut at two
    deviations, and with NN_init upsampling kernels equal to flax's (a nearest-
    neighbour upsampling scaled by NN_scaler^(1/layers)), for SubPixel and 2D."""
    for upsample in ('SubPixel', '2D'):
        hp = make_hp(f",upsample_type='{upsample}',wavenet_weight_normalization=True")
        state = wt.create_train_state(hp, 'cpu')
        batch = make_batch(hp)
        jstate = jwt.create_train_state(hp, jax.random.PRNGKey(0), batch)
        want = convert.wavenet_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params),
                                          fold=False)
        got = state.model.state_dict()
        assert set(want) == set(got)
        for name in want:
            assert want[name].shape == got[name].shape, name
            if name.startswith('upsample') or name.endswith('.bias') or name.endswith('.g'):
                assert torch.equal(want[name], got[name]), name
        w = got['residual_layers.0.conv.parametrizations.weight.original']
        fan_in = w[0].numel()
        assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.15
        assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / fan_in ** 0.5 + 1e-6
        for p, e in zip(state.model.parameters(), state.ema_model.parameters()):
            assert torch.equal(p, e) and p.data_ptr() != e.data_ptr()
    again = wt.create_train_state(hp, 'cpu')
    assert all(torch.equal(a, b) for a, b in zip(again.model.parameters(),
                                                 state.model.parameters()))


@pytest.mark.parametrize('head,upsample', [('gaussian', 'SubPixel'), ('categorical', '2D')])
def test_data_dependent_init_matches_jax(head, upsample):
    """g' = g * init_scale / (std + 1e-8), b' = (b - mean) * scale, conv by conv in the
    network's order with the population deviation: every g and bias within 1e-4
    relative of the JAX init's (each conv's statistics pass through every conv before
    it), and afterwards each conv's output has mean 0 and deviation init_scale."""
    hp = make_hp(HEADS[head] + WN_G + f",upsample_type='{upsample}',wavenet_init_scale=0.7")
    params = flax_params(hp)
    batch = make_batch(hp)
    want = convert.wavenet_state_dict(
        jax.tree_util.tree_map(np.asarray, jwn.data_dependent_init(params, batch, hp)),
        fold=False)
    model = WaveNet(hp)
    model.load_state_dict(convert.wavenet_state_dict(params, fold=False))
    before = copy.deepcopy(model.state_dict())
    weight_norm_init.data_dependent_init(model, port_batch(batch), hp)
    got = model.state_dict()
    changed = 0
    for name in want:
        scale = max(float(want[name].abs().max()), 1e-3)
        assert _max_abs(_np(want[name]), _np(got[name])) <= 1e-4 * scale, name
        changed += int(not torch.equal(before[name], got[name]))
    n_convs = len(weight_norm_init.conv_order(model))
    assert changed == 2 * n_convs  # g and bias of every conv, nothing else
    outs = []
    handle = model.skip_conv1.register_forward_hook(lambda m, a, out: outs.append(out))
    pb = port_batch(batch)
    with torch.no_grad():
        model(pb['audio'] if head == 'categorical' else pb['audio'][..., None],
              pb['mel_conditions'], pb['speaker_ids'])
    handle.remove()
    flat = outs[0].reshape(-1, outs[0].shape[-1])
    assert flat.mean(0).abs().max() < 1e-4
    assert (flat.std(0, unbiased=False) - 0.7).abs().max() < 1e-4
    plain = WaveNet(make_hp())
    sd = copy.deepcopy(plain.state_dict())
    weight_norm_init.data_dependent_init(plain, port_batch(make_batch(make_hp())), make_hp())
    assert all(torch.equal(sd[k], v) for k, v in plain.state_dict().items())


# ---------------------------------------------------------------- data

@pytest.mark.parametrize('n,test_size,seed', [(37, 8, 1234), (37, 0.05, 1234), (100, 0.33, 7),
                                              (16, 8, 0), (9, 1, 3)])
def test_split_matches_sklearn(n, test_size, seed):
    """The numpy split gives sklearn's indices, in its order, for a count and a share."""
    idx = np.arange(n)
    want_train, want_test = sk_split(idx, test_size=test_size, random_state=seed)
    train_idx, test_idx = train_test_split(idx, test_size, seed)
    assert np.array_equal(train_idx, want_train) and np.array_equal(test_idx, want_test)
    with pytest.raises(ValueError):
        train_test_split(idx, n, seed)


def _corpus(root, hp, n=12, speakers=False):
    """A seeded corpus in the preprocessing layout: audio/ and mels/ .npy and train.txt."""
    rng = np.random.default_rng(0)
    hop = hp.get_hop_size()
    os.makedirs(os.path.join(root, 'audio'))
    os.makedirs(os.path.join(root, 'mels'))
    rows = []
    for i in range(n):
        frames = int(rng.integers(6, 14))
        t = np.arange(frames * hop)
        wav = (0.6 * np.sin(2 * np.pi * (3 + i) * t / 64.0) * np.hanning(len(t))).astype(np.float32)
        if hp.input_type == 'mulaw-quantize':
            from tacotron2_tpu.ops.mulaw import mulaw_quantize
            wav = mulaw_quantize(wav, hp.quantize_channels)
        np.save(os.path.join(root, 'audio', f'audio-{i}.npy'), wav)
        np.save(os.path.join(root, 'mels', f'mel-{i}.npy'),
                rng.uniform(-5, 5, (frames, 80)).astype(np.float32))
        g = str(i % 3) if speakers else '<no_g>'
        rows.append(f'audio-{i}.npy|mel-{i}.npy|_|{g}|{len(wav)}|{frames}')
    path = os.path.join(root, 'train.txt')
    with open(path, 'w', encoding='utf-8') as f:
        f.write('\n'.join(rows) + '\n')
    return path


@pytest.mark.parametrize('head,speakers', [('gaussian', False), ('categorical', True)])
def test_dataset_batches_match_jax(tmp_path, head, speakers):
    """The port's WaveNetDataset against the JAX loader, batch for batch over two
    groups of train batches and the test batches: the same split, crops (hop-aligned,
    max_time_steps=256), pad values (mulaw_quantize(0) for classes), mel clip and
    [0, 1] rescale; exact. The port's batches are f32 / int64."""
    extra = HEADS[head] + ',max_time_steps=256,wavenet_test_batches=2'
    extra += ',gin_channels=8,n_speakers=3' if speakers else ''
    hp = make_hp(extra)
    meta = _corpus(str(tmp_path), hp, speakers=speakers)
    jds = JDataset(meta, hp, base_dir=str(tmp_path))
    ds = WaveNetDataset(meta, hp, base_dir=str(tmp_path))
    assert len(ds) == len(jds) == 8 and ds.test_steps == jds.test_steps == 2
    jt, pt = jds.train_batches(seed=5, group_batches=2), ds.train_batches(seed=5, group_batches=2)
    pairs = [(next(jt), next(pt)) for _ in range(5)] + list(zip(jds.test_batches(),
                                                                ds.test_batches()))
    assert len(pairs) == 7
    for want, got in pairs:
        assert set(want) == set(got)
        for k in want:
            assert want[k].shape == got[k].shape and np.array_equal(want[k], got[k]), k
        assert got['audio'].shape == (2, 256)
        assert got['audio'].dtype == (np.int64 if head == 'categorical' else np.float32)
        assert got['mel_conditions'].dtype == np.float32
        assert got['mel_conditions'].min() >= 0 and got['mel_conditions'].max() <= 1
        assert got['input_lengths'].dtype == np.int64
    short = [g for _, g in pairs if g['input_lengths'].min() < 256]
    assert short, 'no padded row in the corpus'
    pad = 32 if head == 'categorical' else 0.0
    b = short[0]
    row = int(b['input_lengths'].argmin())
    assert (b['audio'][row, b['input_lengths'][row]:] == pad).all()


def test_prefetcher_yields_in_order_and_stops():
    p = Prefetcher(iter(range(20)), depth=3)
    assert list(p) == list(range(20))
    p.close()

    def boom():
        yield 1
        raise RuntimeError('reader failed')
    p = Prefetcher(boom(), depth=2)
    assert next(p) == 1
    with pytest.raises(RuntimeError, match='reader failed'):
        next(p)


# ---------------------------------------------------------------- DSP copies

def test_dsp_copies_match_golden_and_originals():
    """The port's audio / stft_common / mel_centroids copies: the golden wav -> mel and
    linear vectors (mean abs 1e-3, the repo's own bound) and the originals exactly."""
    hp = default_hparams()
    data = np.load(os.path.join(os.path.dirname(__file__), 'golden', 'dsp_golden.npz'))
    mel = audio.melspectrogram(data['wav'], hp)
    lin = audio.linearspectrogram(data['wav'], hp)
    assert float(np.mean(np.abs(mel - data['mel']))) < 1e-3
    assert float(np.mean(np.abs(lin - data['linear']))) < 1e-3
    assert np.array_equal(mel, jaudio.melspectrogram(data['wav'], hp))
    assert np.array_equal(lin, jaudio.linearspectrogram(data['wav'], hp))
    wav = data['wav'][:4000]
    assert np.array_equal(audio.preemphasis(wav, 0.97), jaudio.preemphasis(wav, 0.97))
    assert np.array_equal(audio.inv_preemphasis(wav, 0.97), jaudio.inv_preemphasis(wav, 0.97))
    assert np.array_equal(audio.trim_silence(wav, hp), jaudio.trim_silence(wav, hp))
    small = hp.replace(griffin_lim_iters=2)
    assert np.array_equal(audio.inv_mel_spectrogram(mel[:, :12], small),
                          jaudio.inv_mel_spectrogram(mel[:, :12], small))
    assert np.array_equal(stft_common.mel_filterbank(22050, 2048, 80, 55, 7600),
                          jsc.mel_filterbank(22050, 2048, 80, 55, 7600))
    assert np.array_equal(stft_common.padded_window(1100, 2048), jsc.padded_window(1100, 2048))
    for a, b in zip(mcd.mel_centroids(mel.T, hp), jmcd.mel_centroids(mel.T, hp)):
        assert np.array_equal(a, b)
    assert audio.librosa_pad_lr(wav, 2048, 275) == jaudio.librosa_pad_lr(wav, 2048, 275)


def test_ar_conditioning_r_follows_the_jax_eval():
    """The eval's conditioning correlation (`wavenet_train.py:155-181`) computed with
    the port's copies equals the same steps through the JAX package's modules; a flat
    conditioning track is skipped."""
    hp = default_hparams()
    rng = np.random.default_rng(0)
    t = np.arange(40 * 275)
    wav = 0.5 * np.sin(2 * np.pi * (300 + 200 * np.sin(t / 4000.0)) * t / 22050.0)
    cond = rng.uniform(0, 1, (40, 80)).astype(np.float32)
    got = wavenet_train.ar_conditioning_r(wav, cond, hp)
    w = jaudio.preemphasis(wav, hp.preemphasis, hp.preemphasize)
    w = w / max(float(np.abs(w).max()), 1e-9) * hp.rescaling_max
    gen_mel = jaudio.melspectrogram(np.asarray(w, np.float32), hp).T
    cond_mel = cond * (2 * hp.max_abs_value) - hp.max_abs_value
    n = min(len(gen_mel), len(cond_mel))
    want = float(np.corrcoef(jmcd.mel_centroids(gen_mel[:n], hp)[0],
                             jmcd.mel_centroids(cond_mel[:n], hp)[0])[0, 1])
    assert got == want and -1 <= got <= 1
    assert wavenet_train.ar_conditioning_r(wav, np.full((40, 80), 0.5, np.float32), hp) is None


# ---------------------------------------------------------------- checkpoints

def test_checkpoint_select_and_its_three_divergences(tmp_path):
    """The `best` rule as the JAX module's where that is sound, and the three stated
    divergences: a NaN record never wins (there it can), a tie picks the earlier step
    for a higher-is-better metric too (there the later), and a resumed run drops the
    records past the step it restored (there they stay)."""
    d = str(tmp_path / 'wave_pretrained')
    os.makedirs(d)
    assert checkpoint_select.eval_history_path(d) == jselect.eval_history_path(d)
    recs = [dict(step=10, teacher_forced_loss=3.0, natural_loss=2.0, ar_conditioning_r=0.5),
            dict(step=20, teacher_forced_loss=2.5, natural_loss=1.5, ar_conditioning_r=0.9),
            dict(step=30, teacher_forced_loss=2.0, natural_loss=1.0, ar_conditioning_r=0.4)]
    for r in recs:
        checkpoint_select.append_eval_record(d, dict(r, skipped=None))
    assert checkpoint_select.load_eval_history(d) == jselect.load_eval_history(d) == recs
    assert checkpoint_select.best_eval_step(recs) == jselect.best_eval_step(recs) \
        == (20, 'ar_conditioning_r', 0.9)
    no_r = [{k: v for k, v in r.items() if k != 'ar_conditioning_r'} for r in recs]
    assert checkpoint_select.best_eval_step(no_r) == jselect.best_eval_step(no_r) \
        == (30, 'natural_loss', 1.0)
    assert checkpoint_select.nearest_step(24, [10, 20, 30]) == 20
    assert checkpoint_select.nearest_step(25, [30, 20]) == 20  # a tie: the earlier
    assert checkpoint_select.resolve_best_checkpoint(d, [5, 25]) == \
        jselect.resolve_best_checkpoint(d, [5, 25])
    assert checkpoint_select.resolve_best_checkpoint(d, [5, 25])[0] == 25
    assert checkpoint_select.resolve_best_checkpoint(str(tmp_path / 'none'), [5]) is None
    # 1. NaN never wins
    nan = [dict(step=10, natural_loss=float('nan')), dict(step=20, natural_loss=1.5)]
    assert checkpoint_select.best_eval_step(nan) == (20, 'natural_loss', 1.5)
    assert jselect.best_eval_step(nan)[0] == 10          # the fault recorded against it
    all_nan = [dict(step=10, natural_loss=float('nan'), teacher_forced_loss=2.0)]
    assert checkpoint_select.best_eval_step(all_nan) == (10, 'teacher_forced_loss', 2.0)
    # 2. a tie picks the earlier step, for both directions
    tie = [dict(step=10, ar_conditioning_r=0.9), dict(step=20, ar_conditioning_r=0.9)]
    assert checkpoint_select.best_eval_step(tie)[0] == 10
    assert jselect.best_eval_step(tie)[0] == 20
    low = [dict(step=20, natural_loss=1.0), dict(step=10, natural_loss=1.0)]
    assert checkpoint_select.best_eval_step(low)[0] == jselect.best_eval_step(low)[0] == 10
    # 3. a resume at step 20 drops the record of step 30
    assert checkpoint_select.truncate_eval_history(d, 20) == 1
    assert [r['step'] for r in checkpoint_select.load_eval_history(d)] == [10, 20]
    assert checkpoint_select.truncate_eval_history(d, 20) == 0
    assert checkpoint_select.truncate_eval_history(str(tmp_path / 'none'), 5) == 0


def test_checkpoint_round_trip_and_pruning(tmp_path):
    """save / restore of the whole train state (parameters with weight norm apart, the
    EMA, both moments, the step): a restored state takes the same next step, bit for
    bit; max_to_keep prunes the oldest; latest_step and all_steps read the directory."""
    hp = make_hp(WN_G)
    batch = port_batch(make_batch(hp))
    state = wt.create_train_state(hp, 'cpu')
    for _ in range(2):
        wt.train_step(state, batch, hp)
    mgr = CheckpointManager(str(tmp_path / 'ckpt'), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.save(2, state.state_dict())
    loss = wt.train_step(state, batch, hp)['loss'].item()
    mgr.save(3, state.state_dict())
    fresh = wt.create_train_state(hp, 'cpu', seed=99)
    fresh.load_state_dict(CheckpointManager(str(tmp_path / 'ckpt')).restore(2))
    assert fresh.step == 2
    assert wt.train_step(fresh, batch, hp)['loss'].item() == loss
    for a, b in zip(_state_tensors(fresh).values(), _state_tensors(state).values()):
        assert torch.equal(a, b)
    mgr.save(7, state.state_dict())
    assert mgr.all_steps() == [3, 7] and mgr.latest_step() == 7
    assert sorted(os.listdir(str(tmp_path / 'ckpt'))) == ['ckpt-3.pt', 'ckpt-7.pt']


def test_value_window():
    w = ValueWindow(3)
    for x in (1.0, 2.0, 3.0, 4.0):
        w.append(x)
    assert w.count == 3 and w.sum == 9.0 and w.average == 3.0
    w.reset()
    assert w.average == 0.0


# ---------------------------------------------------------------- the CLI

VERIFY_TINY = ("layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,"
               "upsample_scales=[5,55],max_time_steps=2200,wavenet_batch_size=2,"
               "wavenet_test_batches=1,wavenet_natural_eval=True,wavenet_ema_decay=0.5")


@pytest.mark.parametrize('head', ['gaussian', 'categorical_big'])
def test_train_cli_on_cpu_with_resume(tmp_path, capsys, head):
    """`python -m tacotron2_tpu_torch.train --model WaveNet --device cpu` at the tiny
    WaveNet hparams: 4 steps with an eval at 2 and 4 and a checkpoint at 4, then a rerun
    to 6 that restores. Finite falling-or-steady losses, one sidecar record an eval with
    the natural loss (from the AR launch's params, or in place for a big-vocab model,
    which also trains with weight normalization and so runs the data-dependent init),
    wavs, checkpoints; the rerun says it restored, drops a planted record past step 4,
    and steps on to 6."""
    extra = '' if head == 'gaussian' else \
        (",input_type='mulaw-quantize',quantize_channels=2048,out_channels=2048,"
         'wavenet_weight_normalization=True')
    hp = default_hparams()
    hp.parse(VERIFY_TINY + extra)
    meta = _corpus(str(tmp_path), hp, n=8)
    base = ['--model', 'WaveNet', '--wavenet_input', meta, '--base_dir', str(tmp_path),
            '--name', 'run', '--eval_interval', '2', '--checkpoint_interval', '4',
            '--summary_interval', '2', '--device', 'cpu', '--hparams', VERIFY_TINY + extra]
    save_dir = train.main(base + ['--wavenet_train_steps', '4'])
    out = capsys.readouterr().out
    log_dir = os.path.join(str(tmp_path), 'logs-run')
    assert save_dir == os.path.join(log_dir, 'wave_pretrained')
    assert 'Starting new WaveNet training!' in out
    assert ('data-dependent initialization' in out) == (head == 'categorical_big')
    assert ('(in-kernel)' in out) == (head == 'categorical_big')
    assert os.listdir(save_dir) == ['ckpt-4.pt']
    history = checkpoint_select.load_eval_history(save_dir)
    assert [r['step'] for r in history] == [2, 4]
    for r in history:
        assert {'teacher_forced_loss', 'natural_loss', 'gen_samples_per_sec'} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
        assert 'ar_conditioning_r' in r or 'AR conditioning metric skipped' in out
    for name in ('wavs/step-4-pred.wav', 'wavs/step-4-real.wav',
                 'eval-dir/wavs/step-2-pred.wav', 'eval-dir/wavs/step-4-real.wav',
                 'Terminal_train_log'):
        assert os.path.getsize(os.path.join(log_dir, name)) > 0, name
    checkpoint_select.append_eval_record(save_dir, dict(step=5, teacher_forced_loss=0.0))
    train.main(base + ['--wavenet_train_steps', '6'])
    out = capsys.readouterr().out
    assert 'Restored WaveNet checkpoint at step 4' in out
    assert 'Dropped 1 eval records past the restored step' in out
    assert sorted(os.listdir(save_dir)) == ['ckpt-4.pt', 'ckpt-6.pt']
    assert [r['step'] for r in checkpoint_select.load_eval_history(save_dir)] == [2, 4, 6]
    state = CheckpointManager(save_dir).restore()
    assert state['step'] == 6 and len(state['exp_avg']) == len(state['exp_avg_sq'])
    with open(os.path.join(log_dir, 'Terminal_train_log'), encoding='utf-8') as f:
        assert 'Step       6' in f.read()


def test_resumed_run_draws_the_masks_of_its_steps(tmp_path, monkeypatch):
    """A step's dropout masks are keyed by (seed, step), as `fold_in(rng, state.step)`
    keys them in the JAX trainer: a run resumed at step 2 draws at step 3 the masks
    an uninterrupted run draws there (the generator's state as train_step gets it),
    and not those of step 1."""
    hp = default_hparams()
    hp.parse(VERIFY_TINY)
    meta = _corpus(str(tmp_path), hp, n=8)
    states = {}
    train_step = wavenet_train.wt.train_step

    def recording(state, batch, hp_, generator, **kw):
        states.setdefault(run, {})[state.step + 1] = generator.get_state()
        return train_step(state, batch, hp_, generator, **kw)

    monkeypatch.setattr(wavenet_train.wt, 'train_step', recording)

    def main(name, steps):
        train.main(['--model', 'WaveNet', '--wavenet_input', meta, '--base_dir',
                    str(tmp_path), '--name', name, '--wavenet_train_steps', str(steps),
                    '--eval_interval', '100', '--checkpoint_interval', '2',
                    '--summary_interval', '100', '--device', 'cpu', '--hparams', VERIFY_TINY])

    run = 'whole'
    main('whole', 3)
    run = 'resumed'
    main('resumed', 2)
    main('resumed', 3)
    assert sorted(states['whole']) == sorted(states['resumed']) == [1, 2, 3]
    for step in (1, 2, 3):
        assert torch.equal(states['whole'][step], states['resumed'][step]), step
    assert not torch.equal(states['whole'][3], states['whole'][1])


def test_fresh_start_drops_every_earlier_eval_record(tmp_path, capsys):
    """A fresh start (no checkpoint, or --restore False) truncates the eval-history
    sidecar at step 0: a stale record of an earlier run can no longer win `best`."""
    hp = default_hparams()
    hp.parse(VERIFY_TINY)
    meta = _corpus(str(tmp_path), hp, n=8)
    save_dir = os.path.join(str(tmp_path), 'logs-run', 'wave_pretrained')
    os.makedirs(save_dir)
    base = ['--model', 'WaveNet', '--wavenet_input', meta, '--base_dir', str(tmp_path),
            '--name', 'run', '--wavenet_train_steps', '1', '--eval_interval', '100',
            '--checkpoint_interval', '1', '--summary_interval', '100', '--device', 'cpu',
            '--hparams', VERIFY_TINY]
    for restore in ('True', 'False'):  # no checkpoint yet; then one that is ignored
        checkpoint_select.append_eval_record(save_dir, dict(step=1, ar_conditioning_r=0.99))
        train.main(base + ['--restore', restore])
        out = capsys.readouterr().out
        assert 'Starting new WaveNet training!' in out
        assert 'Dropped 1 eval records of an earlier run' in out
        assert checkpoint_select.load_eval_history(save_dir) == []
        assert checkpoint_select.resolve_best_checkpoint(save_dir, [1]) is None


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    """An unknown --model is refused by the parser; without a card and without --device
    cpu every model raises instead of falling back: each trainer and the 3-phase
    Tacotron-2 pipeline (ported: tests/test_torch_tacotron2_pipeline.py)."""
    with pytest.raises(SystemExit):
        train.main(['--model', 'Tacotron3', '--device', 'cpu', '--base_dir', str(tmp_path)])
    if not torch.cuda.is_available():
        for model in ('WaveNet', 'Tacotron', 'Tacotron-2'):
            with pytest.raises(RuntimeError, match='no CUDA device'):
                train.main(['--model', model, '--base_dir', str(tmp_path)])


def test_short_run_ema_warning(tmp_path, capsys):
    """The default EMA decay over a few steps logs the short-run warning with the
    suggested decay."""
    hp = default_hparams()
    hp.parse(VERIFY_TINY)
    meta = _corpus(str(tmp_path), hp, n=8)
    train.main(['--model', 'WaveNet', '--wavenet_input', meta, '--base_dir', str(tmp_path),
                '--wavenet_train_steps', '1', '--eval_interval', '100',
                '--checkpoint_interval', '100', '--summary_interval', '100', '--device', 'cpu',
                '--hparams', VERIFY_TINY.replace('wavenet_ema_decay=0.5',
                                                 'wavenet_ema_decay=0.9999')])
    out = capsys.readouterr().out
    assert 'WARNING: wavenet_ema_decay=0.9999' in out and 'wavenet_ema_decay<=0.5' in out
    assert json.dumps(checkpoint_select.load_eval_history(
        os.path.join(str(tmp_path), 'logs-WaveNet', 'wave_pretrained'))) == '[]'


def test_synthesize_from_the_trainers_checkpoints(tmp_path, capsys):
    """`--wavenet_checkpoint_step` on the entry points: a directory of the trainer's
    checkpoints gives the EMA weights of the latest step, of a step by number, or of
    `best`, the step `checkpoint_select.resolve_best_checkpoint` picks from the
    eval-history sidecar (the latest, with a message, where there is none); a step
    asked of a single file raises; `synthesize --model WaveNet` vocodes from it."""
    from tacotron2_tpu_torch import synthesize

    hp = default_hparams()
    hp.parse(VERIFY_TINY)
    meta = _corpus(str(tmp_path), hp, n=8)
    save_dir = train.main(['--model', 'WaveNet', '--wavenet_input', meta, '--base_dir',
                           str(tmp_path), '--name', 'run', '--wavenet_train_steps', '3',
                           '--eval_interval', '100', '--checkpoint_interval', '1',
                           '--summary_interval', '100', '--device', 'cpu',
                           '--hparams', VERIFY_TINY])
    assert CheckpointManager(save_dir).all_steps() == [1, 2, 3]
    ema = {s: CheckpointManager(save_dir).restore(s)['ema_model'] for s in (1, 2, 3)}
    assert not torch.equal(ema[1]['first_conv.weight'], ema[3]['first_conv.weight'])

    def same(model, step):
        return all(torch.equal(v, ema[step][k]) for k, v in model.state_dict().items())

    assert same(convert.load_wavenet(save_dir, hp), 3)
    assert same(convert.load_wavenet(save_dir, hp, 'latest'), 3)
    assert same(convert.load_wavenet(save_dir, hp, '2'), 2)
    capsys.readouterr()
    assert same(convert.load_wavenet(save_dir, hp, 'best'), 3)
    assert 'falling back to the latest' in capsys.readouterr().out
    for step, r in ((1, 0.2), (2, 0.9), (3, 0.5)):
        checkpoint_select.append_eval_record(save_dir, dict(step=step, ar_conditioning_r=r))
    assert same(convert.load_wavenet(save_dir, hp, 'best'), 2)
    assert 'Selected WaveNet checkpoint step 2 by natural eval' in capsys.readouterr().out
    single = str(tmp_path / 'single.pt')
    convert.save_checkpoint(single, 'wavenet', ema[1])
    assert same(convert.load_wavenet(single, hp), 1)
    with pytest.raises(ValueError, match='one file'):
        convert.load_wavenet(single, hp, 'best')
    with pytest.raises(FileNotFoundError):
        convert.load_wavenet(str(tmp_path / 'mels'), hp, 'best')
    mels = tmp_path / 'eval_mels'
    mels.mkdir()
    np.save(mels / 'mel-0.npy', np.random.default_rng(0).uniform(-4, 4, (2, 80))
            .astype(np.float32))
    stats = synthesize.main(['--model', 'WaveNet', '--wavenet_checkpoint', save_dir,
                             '--wavenet_checkpoint_step', 'best', '--mels_dir', str(mels),
                             '--base_dir', str(tmp_path), '--hparams', VERIFY_TINY,
                             '--device', 'cpu'])
    assert [len(w) for w in stats['wavs']] == [550]
    assert 'Loaded WaveNet checkpoint at step 2 (EMA weights)' in capsys.readouterr().out
