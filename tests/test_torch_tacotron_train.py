"""Tacotron training parity: the port's trainer (tacotron2_tpu_torch/training, the
teacher-forced model, its losses, the Tacotron feeder, Griffin-Lim on the device, the
CLI) against the JAX package, fp32 on the CPU at the TINY widths of
test_torch_tacotron.py.

Every flax parameter and batch statistic is overwritten with seeded numpy noise and
converted (`convert.tacotron_state_dict`, `convert.tacotron_train_state_from_jax`);
both sides get the same batch. The random draws are shared: the test patches
`jax.random.bernoulli`, `uniform` and `split` (here, never in the package) so that a
jitted JAX function hands back the draws it made, and gives the port the keep-masks and
coins they spell (`port_noise`). The encoder's zoneout masks are drawn inside a
`lax.scan`; they are regenerated from the step keys the scan was given. Tolerances are
stated in each test.
"""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from tacotron2_tpu.config import default_hparams, paper_hparams
from tacotron2_tpu.data.loader import TacotronDataset as JDataset
from tacotron2_tpu.models.tacotron import losses as jlosses
from tacotron2_tpu.models.tacotron import modules as jmod
from tacotron2_tpu.models.tacotron.model import Tacotron as JTacotron
from tacotron2_tpu.ops import dsp_jax
from tacotron2_tpu.ops import fused_decoder as jfd
from tacotron2_tpu.training import schedules as jsched
from tacotron2_tpu.training import tacotron_trainer as jtt
from tacotron2_tpu_torch import convert, synthesize, train
from tacotron2_tpu_torch.data.loader import TacotronDataset
from tacotron2_tpu_torch.models.tacotron import losses, modules as tmod
from tacotron2_tpu_torch.models.tacotron.flax_names import flax_name
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.ops import dsp
from tacotron2_tpu_torch.ops import fused_decoder as tfd
from tacotron2_tpu_torch.training import schedules
from tacotron2_tpu_torch.training import tacotron_trainer as tt
from tacotron2_tpu_torch.training.checkpointing import CheckpointManager

from test_torch_tacotron import TINY, randomize

B, T_IN, T_MEL = 2, 12, 16        # T_IN is neither 2 nor 4: it tells the encoder's splits
LENGTHS = np.asarray([12, 7], np.int32)
TARGET_LENGTHS = np.asarray([16, 11], np.int32)
ORIGINAL = dict(bernoulli=jax.random.bernoulli, uniform=jax.random.uniform,
                split=jax.random.split)


def make_hp(extra=''):
    hp = default_hparams()
    hp.parse(TINY + extra)
    return hp


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _np(t):
    return t.detach().cpu().numpy()


def _t(x):
    return torch.from_numpy(np.array(x))


def make_batch(hp, seed=0):
    rng = np.random.default_rng(seed)
    inputs = rng.integers(2, 60, (B, T_IN)).astype(np.int32)
    inputs[1, LENGTHS[1]:] = 0
    stop = np.zeros((B, T_MEL), np.float32)
    for b, n in enumerate(TARGET_LENGTHS):
        stop[b, n - 1:] = 1.0
    return dict(inputs=inputs, input_lengths=LENGTHS,
                mel_targets=rng.uniform(-4, 4, (B, T_MEL, hp.num_mels)).astype(np.float32),
                stop_token_targets=stop, targets_lengths=TARGET_LENGTHS,
                linear_targets=rng.uniform(-4, 4, (B, T_MEL, hp.num_freq)).astype(np.float32))


def flax_variables(hp, seed=0):
    k = jax.random.PRNGKey(0)
    batch = make_batch(hp)
    init = partial(JTacotron(hp).init, deterministic=False)
    shapes = jax.eval_shape(init, {'params': k, 'dropout': k, 'zoneout': k, 'teacher': k},
                            jnp.asarray(batch['inputs']), jnp.asarray(LENGTHS),
                            mel_targets=jnp.asarray(batch['mel_targets']))
    return randomize(shapes, np.random.default_rng(seed))


@pytest.fixture(scope='module')
def recorder():
    """While the module runs, jax.random.bernoulli, uniform and split hand each draw
    made outside a scan to `draws` (bernoulli of rank 3, every uniform, split into T_IN
    keys: the encoder's, per direction); a jitted function returns them."""
    draws = []

    def bernoulli(key, p=0.5, shape=None, *args, **kw):
        out = ORIGINAL['bernoulli'](key, p, shape, *args, **kw)
        if shape is not None and len(shape) == 3:
            draws.append(out)
        return out

    def uniform(key, shape=(), *args, **kw):
        out = ORIGINAL['uniform'](key, shape, *args, **kw)
        draws.append(out)
        return out

    def split(key, num=2):
        out = ORIGINAL['split'](key, num)
        if num == T_IN:
            draws.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, 'bernoulli', bernoulli)
        mp.setattr(jax.random, 'uniform', uniform)
        mp.setattr(jax.random, 'split', split)
        yield draws


def recording(draws, fn):
    """fn(*args) -> (fn's outputs, the draws its trace made), jitted."""
    def wrapped(*args):
        draws.clear()
        out = fn(*args)
        return out, list(draws)
    return jax.jit(wrapped)


def encoder_keeps(hp, keys):
    """The zoneout keep-masks (T_IN, B, U) the JAX encoder's scan draws from its step
    keys: per step, split in two, a bernoulli each for c and h (`modules.py:190-195`)."""
    keep = 1.0 - hp.tacotron_zoneout_rate
    c, h = [], []
    for key in np.asarray(keys):
        k1, k2 = ORIGINAL['split'](jnp.asarray(key))
        shape = (B, hp.encoder_lstm_units)
        c.append(np.asarray(ORIGINAL['bernoulli'](k1, keep, shape)))
        h.append(np.asarray(ORIGINAL['bernoulli'](k2, keep, shape)))
    return [_t(np.stack(c)), _t(np.stack(h))]


def port_noise(hp, draws, train):
    """The port's `noise` from the draws of a JAX teacher-forced pass, in their order:
    train: encoder conv keep-masks, the encoder's forward and backward step keys; then
    the coins, the prenet masks m1 and m2; train: the decoder's four zoneout gates and
    the post-net's keep-masks."""
    draws = [np.asarray(d) for d in draws]
    keep = 1.0 - hp.tacotron_dropout_rate
    noise = {}
    if train:
        L = hp.enc_conv_num_layers
        noise['encoder_convolutions'] = [_t(d) for d in draws[:L]]
        fw, bw = draws[L:L + 2]
        noise['encoder_lstm'] = encoder_keeps(hp, fw) + encoder_keeps(hp, bw)
        draws = draws[L + 2:]
    noise['coins'] = _t(draws[0])
    noise['m1'] = _t(draws[1].astype(np.float32) / np.float32(keep))
    noise['m2'] = _t(draws[2].astype(np.float32) / np.float32(keep))
    if train:
        noise['zo'] = [_t(d) for d in draws[3:7]]
        noise['postnet_convolutions'] = [_t(d) for d in draws[7:]]
        assert len(noise['postnet_convolutions']) == hp.postnet_num_layers
    return noise


def port_batch(batch):
    return {k: _t(v) for k, v in batch.items()}


# ---------------------------------------------------------------- schedules and losses

@pytest.mark.parametrize('mode', ['constant', 'scheduled', 'no_decay'])
def test_schedules_match_jax(mode):
    """The learning rate and the teacher-forcing ratio over a grid of steps around the
    decay points: 1e-6 relative (float32 on both sides)."""
    extra = {'constant': ',tacotron_teacher_forcing_ratio=0.7',
             'scheduled': ",tacotron_teacher_forcing_mode='scheduled',"
                          'tacotron_teacher_forcing_final_ratio=0.25',
             'no_decay': ',tacotron_decay_learning_rate=False,'
                         "tacotron_teacher_forcing_mode='scheduled',"
                         'tacotron_teacher_forcing_final_ratio=None,'
                         'tacotron_teacher_forcing_decay_alpha=0.5'}[mode]
    hp = make_hp(extra)
    for step in (0, 1, 9999, 10000, 10001, 25000, 40000, 49000, 50000, 58000, 100000, 10 ** 6):
        for jfn, fn in ((jsched.tacotron_learning_rate, schedules.tacotron_learning_rate),
                        (jsched.teacher_forcing_ratio, schedules.teacher_forcing_ratio)):
            want, got = float(jfn(hp, step)), fn(hp, step)
            assert isinstance(got, float)
            assert abs(want - got) <= 1e-6 * max(abs(want), 1e-6), (fn.__name__, step)


def _outputs(hp, seed):
    rng = np.random.default_rng(seed)
    return dict(decoder_output=rng.normal(0, 2, (B, T_MEL, hp.num_mels)),
                mel_outputs=rng.normal(0, 2, (B, T_MEL, hp.num_mels)),
                stop_token_prediction=rng.normal(0, 3, (B, T_MEL)),
                linear_outputs=rng.normal(0, 2, (B, T_MEL, hp.num_freq)))


@pytest.mark.parametrize('masked', [False, True])
def test_losses_and_gradients_match_jax(masked):
    """Each loss term and the gradient of the total with respect to every output, masked
    (cross_entropy_pos_weight 3, on the masked stop loss only) and unmasked (where the
    stop loss weighs positives by 1), with the L2 term of converted weights: the terms
    1e-6 relative, the gradients 1e-6 of their largest entry."""
    hp = make_hp(f',mask_decoder={masked},cross_entropy_pos_weight=3.0,'
                 'tacotron_scale_regularization=True,tacotron_reg_weight=1e-3')
    v = flax_variables(hp)
    batch = make_batch(hp)
    outs = {k: x.astype(np.float32) for k, x in _outputs(hp, 1).items()}
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def jloss(o):
        return jlosses.compute_losses(o, jb, v['params'], hp)

    (jtotal, jterms), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(x) for k, x in outs.items()})
    model = Tacotron(hp)
    model.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    touts = {k: _t(x).requires_grad_() for k, x in outs.items()}
    total, terms = losses.compute_losses(touts, port_batch(batch),
                                         losses.l2_parameters(model), hp)
    total.backward()
    for k, want in jterms.items():
        assert abs(float(want) - terms[k].item()) <= 1e-6 * max(abs(float(want)), 1e-6), k
    for k, t in touts.items():
        g = np.asarray(jgrad[k])
        assert _max_abs(g, _np(t.grad)) <= 1e-6 * float(np.abs(g).max()), k
    assert losses.n_priority(hp) == int(2000 / (hp.sample_rate * 0.5) * hp.num_freq)


def test_l2_set_and_value_match_jax():
    """The weights the L2 term sums: the set of flax paths the JAX filter keeps equals
    the flax names (`flax_name`) of the port parameters the port's filter keeps
    (BatchNorm scales, prenet, memory-layer, highway and query kernels in; biases,
    projections, the embedding, LSTM and GRU weights out); every port parameter's flax
    name is the leaf it was converted from (equal sums of squares); the value 1e-6
    relative."""
    hp = make_hp(',tacotron_reg_weight=1e-3')
    v = flax_variables(hp)
    leaves = {'/'.join(str(getattr(p, 'key', p)) for p in path): np.asarray(x)
              for path, x in jax.tree_util.tree_flatten_with_path(v['params'])[0]}
    want = {n for n in leaves if losses.counts_for_l2(n)}
    model = Tacotron(hp)
    model.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    got = {flax_name(n) for n, _ in model.named_parameters()
           if losses.counts_for_l2(flax_name(n))}
    assert want == got
    for must in ('encoder_convolutions/conv_1/bn/scale', 'attention_memory_layer/kernel',
                 'decoder/prenet/dense_1/kernel', 'cbhg_postnet/highway_1/T/kernel',
                 'decoder/attention/query_layer/kernel'):
        assert must in got
    for never in ('decoder/attention/attention_variable_projection',
                  'decoder/attention/attention_bias',
                  'cbhg_linear_specs_projection/kernel', 'inputs_embedding'):
        assert never in leaves and never not in got
    for n, p in model.named_parameters():
        parts = flax_name(n).split('/')
        if len(parts) > 1 and '+' in parts[-2]:   # a GRU's fused tensor: the leaves it joins
            srcs = [leaves['/'.join(parts[:-2] + [g, parts[-1]])] for g in parts[-2].split('+')]
        else:
            srcs = [leaves[flax_name(n)]]
        ss = float(torch.sum(p.detach().double() ** 2))
        assert abs(sum(float(np.sum(np.square(s.astype(np.float64)))) for s in srcs) - ss) \
            <= 1e-9 * ss, n
    want_v = float(jlosses.l2_regularization(v['params'], hp))
    got_v = losses.l2_regularization(losses.l2_parameters(model), hp).item()
    assert abs(want_v - got_v) <= 1e-6 * want_v


# ---------------------------------------------------------------- modules in training

@pytest.mark.parametrize('bnorm', ['after', 'before'])
def test_conv_block_train_mode(recorder, bnorm):
    """A conv block in training: BatchNorm over the batch's statistics (the biased
    variance, padded frames included) and dropout on the shared mask: output 1e-5; the
    running statistics after flax's update (0.99 old + 0.01 batch), 1e-6."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, T_IN, 6)).astype(np.float32)
    jblock = jmod.ConvBlock(5, 8, nn.relu, 0.5, bnorm)
    v = randomize(jax.eval_shape(partial(jblock.init, train=False),
                                 jax.random.PRNGKey(0), x), rng)
    run = recording(recorder, lambda vs, xs, k: jblock.apply(
        vs, xs, True, mutable=['batch_stats'], rngs={'dropout': k}))
    (want, mutated), draws = run(v, x, jax.random.PRNGKey(1))
    block = tmod.ConvBlock(6, 5, 8, 'relu', bnorm, 0.5)
    block.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    got = block(_t(x).transpose(1, 2), True, _t(draws[0])).transpose(1, 2)
    assert _max_abs(want, _np(got)) <= 1e-5
    stats = mutated['batch_stats']['bn']
    assert _max_abs(stats['mean'], _np(block.bn.running_mean)) <= 1e-6
    assert _max_abs(stats['var'], _np(block.bn.running_var)) <= 1e-6
    assert not np.allclose(stats['var'], v['batch_stats']['bn']['var'])
    assert (_np(got) == 0).mean() > 0.3  # the dropout acted


def test_bizoneout_lstm_train_mode(recorder):
    """The encoder RNN in training with ragged lengths: zoneout's training form (JAX's
    dropout of the difference, the port's select of new or old: equal but for rounding)
    with the masks the scan drew (regenerated from its step keys), padded steps
    frozen, the backward direction over the valid region only: 1e-5. The expectation
    form differs from it."""
    hp = make_hp()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, T_IN, hp.enc_conv_channels)).astype(np.float32)
    U = hp.encoder_lstm_units
    jrnn = jmod.BiZoneoutLSTM(U, 0.1)
    v = randomize(jax.eval_shape(partial(jrnn.init, deterministic=True), jax.random.PRNGKey(0),
                                 x, jnp.asarray(LENGTHS)), rng)
    run = recording(recorder, lambda vs, xs, k: jrnn.apply(
        vs, xs, jnp.asarray(LENGTHS), False, rngs={'zoneout': k}))
    want, draws = run(v, x, jax.random.PRNGKey(2))
    assert len(draws) == 2
    sd = {}
    for d in ('fw', 'bw'):
        convert._dense(sd, f'{d}.gates', v['params'][d]['gates'])
    rnn = tmod.BiZoneoutLSTM(hp.enc_conv_channels, U, 0.1)
    rnn.load_state_dict(sd)
    keeps = encoder_keeps(hp, draws[0]) + encoder_keeps(hp, draws[1])
    with torch.no_grad():
        got = rnn(_t(x), _t(LENGTHS), keeps)
        expect = rnn(_t(x), _t(LENGTHS))
    assert _max_abs(want, _np(got)) <= 1e-5
    assert not got[1, LENGTHS[1]:].any()
    assert _max_abs(_np(expect), _np(got)) > 1e-3


def test_highway_net():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, T_IN, 16)).astype(np.float32)
    jh = jmod.HighwayNet(16)
    v = randomize(jax.eval_shape(jh.init, jax.random.PRNGKey(0), x), rng)
    want = jh.apply(v, x)
    h = tmod.HighwayNet(16)
    sd = {}
    for gate in ('H', 'T'):
        convert._dense(sd, gate, v['params'][gate])
    h.load_state_dict(sd)
    with torch.no_grad():
        assert _max_abs(want, _np(h(_t(x)))) <= 1e-6
    fresh = tt.init_parameters(Tacotron(make_hp()), torch.Generator().manual_seed(0))
    assert torch.equal(fresh.cbhg_postnet.highways[0].T.bias, torch.full((16,), -1.0))


@pytest.mark.parametrize('train', [False, True])
def test_cbhg_ragged(train):
    """The CBHG post-net over ragged content (lengths 16 and 9): the bank of widths 1..4
    (an even width pads one more on the right, as flax's SAME), the max-pool of width
    2 with -inf on the right, projections, residual, highway_in and highways, the
    bidirectional GRU with flax's bias layout, padded steps frozen and the backward
    direction over the valid region: output 1e-5; in training the BatchNorm running
    statistics after the update, 1e-6."""
    hp = make_hp()
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, T_MEL, hp.num_mels)).astype(np.float32)
    lengths = jnp.asarray([16, 9], jnp.int32)
    jc = jmod.CBHG(hp.cbhg_kernels, hp.cbhg_conv_channels, hp.cbhg_pool_size,
                   (hp.cbhg_projection, hp.num_mels), hp.cbhg_projection_kernel_size,
                   hp.cbhg_highwaynet_layers, hp.cbhg_highway_units, hp.cbhg_rnn_units)
    v = randomize(jax.eval_shape(partial(jc.init, train=False), jax.random.PRNGKey(0), x,
                                 lengths), rng)
    want, mutated = jc.apply(v, x, lengths, train, mutable=['batch_stats'])
    cbhg = Tacotron(hp).cbhg_postnet
    cbhg.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    with torch.no_grad():
        got = cbhg(_t(x), _t(np.asarray(lengths)), train)
    assert _max_abs(want, _np(got)) <= 1e-5
    assert not got[1, 9:].any()
    if train:
        for k in ('bank_2', 'proj2'):
            stats = mutated['batch_stats'][k]['bn']
            mod = cbhg.bank[1] if k == 'bank_2' else cbhg.proj2
            assert _max_abs(stats['mean'], _np(mod.bn.running_mean)) <= 1e-6
            assert _max_abs(stats['var'], _np(mod.bn.running_var)) <= 1e-6


# ---------------------------------------------------------------- the decoder

DECODER_CASES = {'ratio1-expectation': (1.0, False), 'ratio0.5-gates': (0.5, True)}


@pytest.mark.parametrize('case', list(DECODER_CASES))
def test_decoder_scan_and_gradients_match_jax(case):
    """`decoder_scan` over 8 steps against the JAX `decoder_scan` (its custom VJP) and
    `decoder_scan_reference` (XLA autodiff), on shared teacher frames, coins, prenet
    masks and zoneout gates (None: the expectation): frames, stops and alignments
    1e-5 (read 6e-7); the gradient of a random projection of the three outputs with
    respect to every decoder weight, the keys, the values and the teacher frames, 2e-5
    of each gradient's largest entry (read: up to 2.1e-6)."""
    ratio, gates = DECODER_CASES[case]
    hp = make_hp()
    v = flax_variables(hp)
    params = v['params']['decoder']
    rng = np.random.default_rng(7)
    T, D, M = T_MEL // hp.outputs_per_step, hp.attention_dim, 2 * hp.encoder_lstm_units
    keep = 1.0 - hp.tacotron_dropout_rate
    f32 = np.float32
    keys = rng.normal(size=(B, T_IN, D)).astype(f32)
    values = rng.normal(size=(B, T_IN, M)).astype(f32)
    mask = (np.arange(T_IN)[None] < LENGTHS[:, None]).astype(f32)
    teacher = rng.uniform(-4, 4, (T, B, hp.num_mels)).astype(f32)
    use = (rng.uniform(size=T) < ratio).astype(f32)
    m1 = (rng.uniform(size=(T, B, hp.prenet_layers[0])) < keep).astype(f32) / f32(keep)
    m2 = (rng.uniform(size=(T, B, hp.prenet_layers[1])) < keep).astype(f32) / f32(keep)
    zo = (tuple(rng.uniform(size=(T, B, hp.decoder_lstm_units)) < 0.9 for _ in range(4))
          if gates else None)
    cot = [rng.normal(size=s).astype(f32)
           for s in ((T, B, hp.num_mels * hp.outputs_per_step), (T, B, hp.outputs_per_step),
                     (T, B, T_IN))]
    cfg = jfd.config_from_hp(hp, jnp.float32, not gates)

    def jax_run(fn):
        def loss(p, k, vals, tch):
            outs = fn(cfg, p, k, vals, mask, tch, use, m1, m2, zo)
            return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs
        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(
            params, keys, values, teacher)

    model = Tacotron(hp)
    model.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    tk, tv, tteach = (_t(a).requires_grad_() for a in (keys, values, teacher))
    outs = tfd.decoder_scan(model.decoder, tk, tv, _t(mask), tteach, _t(use),
                            [_t(m1), _t(m2)], None if zo is None else [_t(z) for z in zo])
    sum(torch.sum(o * _t(c)) for o, c in zip(outs, cot)).backward()
    grads = {'decoder.' + n: p.grad for n, p in model.decoder.named_parameters()}
    for fn in (jfd.decoder_scan, jfd.decoder_scan_reference):
        (_, want), (gp, gk, gv, gt) = jax_run(fn)
        for w, g in zip(want, outs):
            assert _max_abs(w, _np(g)) <= 1e-5, fn.__name__
        tree = jax.tree_util.tree_map(np.zeros_like, v['params'])
        tree['decoder'] = jax.tree_util.tree_map(np.asarray, gp)
        gsd = convert.tacotron_state_dict(tree, v['batch_stats'])
        for name, g in grads.items():
            w = _np(gsd[name])
            assert _max_abs(w, _np(g)) <= 2e-5 * float(np.abs(w).max()), (fn.__name__, name)
        for w, g in ((gk, tk.grad), (gv, tv.grad), (gt, tteach.grad)):
            w = np.asarray(w)
            assert _max_abs(w, _np(g)) <= 2e-5 * float(np.abs(w).max()), fn.__name__
    if ratio < 1:
        assert 0 < use.sum() < T and _np(tteach.grad)[use == 0].max() == 0


# ---------------------------------------------------------------- the model and its steps

@pytest.mark.parametrize('predict_linear', [False, True])
def test_teacher_forced_model_matches_jax(recorder, predict_linear):
    """The whole model in training (deterministic=False, ratio 0.5) with the JAX pass's
    draws: decoder_output, mel_outputs, stop logits, alignments, linear_outputs 1e-4;
    the BatchNorm running statistics after the pass 1e-5; stop_finished equal."""
    hp = make_hp()
    v = flax_variables(hp)
    batch = make_batch(hp)
    jm = JTacotron(hp)
    run = recording(recorder, lambda vs, k: jm.apply(
        vs, batch['inputs'], LENGTHS, mel_targets=batch['mel_targets'],
        deterministic=False, teacher_forcing_ratio=0.5, predict_linear=predict_linear,
        rngs={'dropout': k, 'zoneout': jax.random.fold_in(k, 1),
              'teacher': jax.random.fold_in(k, 2)}, mutable=['batch_stats']))
    (want, mutated), draws = run(v, jax.random.PRNGKey(3))
    model = Tacotron(hp)
    model.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    noise = port_noise(hp, draws, train=True)
    assert 0 < float((noise['coins'] < 0.5).sum()) < T_MEL // hp.outputs_per_step
    with torch.no_grad():
        got = model.teacher_forced(_t(batch['inputs']), _t(LENGTHS),
                                   _t(batch['mel_targets']), noise, deterministic=False,
                                   teacher_forcing_ratio=0.5, predict_linear=predict_linear)
    keys = ['decoder_output', 'mel_outputs', 'stop_token_prediction', 'alignments']
    assert ('linear_outputs' in got) == predict_linear == ('linear_outputs' in want)
    for k in keys + (['linear_outputs'] if predict_linear else []):
        assert got[k].shape == want[k].shape, k
        assert _max_abs(want[k], _np(got[k])) <= 1e-4, k
    assert np.array_equal(np.asarray(want['stop_finished']), _np(got['stop_finished']))
    sd = convert.tacotron_state_dict(v['params'], mutated['batch_stats'])
    state = model.state_dict()
    for name in sd:
        if name.endswith(('running_mean', 'running_var')) and name in state:
            assert _max_abs(_np(sd[name]), _np(state[name])) <= 1e-5, name


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
                batch_stats=to_np(state.batch_stats), mu=to_np(adam.mu), nu=to_np(adam.nu))


def _state_tensors(state):
    """name -> tensor of everything a train step changes."""
    out = {f'param:{n}': p for n, p in state.model.named_parameters()}
    out.update({f'stat:{n}': b for n, b in state.model.named_buffers()
                if n.endswith(('running_mean', 'running_var'))})
    names = [n for n, _ in state.model.named_parameters()]
    out.update({f'mu:{n}': m for n, m in zip(names, state.exp_avg)})
    out.update({f'nu:{n}': m for n, m in zip(names, state.exp_avg_sq)})
    return out


def noise_gradient_biases(model):
    """The conv biases that BatchNorm follows directly (bnorm 'before', or no
    activation between): the batch mean takes them out again, so their gradient is zero
    but for rounding."""
    return {f'{n}.conv.bias' for n, m in model.named_modules()
            if isinstance(m, tmod.ConvBlock) and (m.bnorm == 'before' or m.activation is None)}


TRAIN_EXTRA =',tacotron_teacher_forcing_ratio=0.5'
LOSS_TERMS = ('loss', 'before_loss', 'after_loss', 'stop_token_loss', 'regularization_loss',
              'linear_loss')


def _jax_steps(recorder, hp):
    """(hp, the converted batch, a fresh JAX train state, the jitted JAX train step that
    returns its draws)."""
    v = flax_variables(hp)
    batch = make_batch(hp)
    state = jtt.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                           batch_stats=v['batch_stats'],
                           opt_state=jtt.make_optimizer(hp).init(v['params']))
    step = recording(recorder, lambda s, b, k: jtt.train_step(s, b, k, hp))
    return hp, batch, state, step


@pytest.fixture(scope='module')
def jax_steps(recorder):
    """_jax_steps at TRAIN_EXTRA."""
    return _jax_steps(recorder, make_hp(TRAIN_EXTRA))


@pytest.fixture(scope='module')
def paper_jax_steps(recorder):
    """_jax_steps at the paper profile (`paper_hparams()`: no CBHG and no linear loss,
    no output clipping, tacotron_reg_weight 1e-7, its own decay constants) with the
    TINY widths and TRAIN_EXTRA on top."""
    hp = paper_hparams()
    hp.parse(TINY + TRAIN_EXTRA)
    return _jax_steps(recorder, hp)


# how far apart the two sides may leave a conv bias whose gradient is rounding alone
# (test_train_steps_match_jax), by profile
ZERO_GRAD_PARAM_TOL = {'default': 2e-5, 'paper': 2e-4}
# test_train_steps_match_jax's cases: (profile, start)
STEP_CASES = {'fresh': ('default', 'fresh'), 'mid-run': ('default', 'mid-run'),
              'paper-fresh': ('paper', 'fresh'), 'paper-mid-run': ('paper', 'mid-run')}


@pytest.mark.parametrize('start', list(STEP_CASES))
def test_train_steps_match_jax(request, start):
    """At the default profile (TRAIN_EXTRA) and at the paper profile: one and three train steps from a converted JAX train state on the same batch
    with the draws of each JAX step (teacher forcing at 0.5: the coins matter), from a
    fresh state (a gradient norm near 0.58: no clip) and from one two steps old
    (nonzero moments, a step count of 2, the mel targets three times as large: a norm
    past 1, so the clip acts): loss and each term and grad_norm 2e-5 relative, the
    learning rate and ratio exactly, and every parameter, Adam moment and BatchNorm
    running statistic within 5e-5 of its tensor's largest magnitude after one step
    and 1e-4 after three (read up to 3.7e-5: the moments of a conv bias whose
    BatchNorm follows a tanh, its gradient mostly cancelled; Adam divides by
    sqrt(nu), so an entry with a near-zero gradient amplifies a last-place
    difference). The conv biases BatchNorm follows directly have a zero gradient but
    for rounding (`noise_gradient_biases`): on both sides their first moments stay
    under 1e-8 (read 1.9e-9) and the biases within 2e-5 of each other (read 8e-6).
    The paper profile has no CBHG, so only the post-net's bias is of that kind; without
    output clipping its rounding-level gradient is larger (first moments read up to
    4.1e-9, the bias's gradient up to 4e-8), and Adam, with a second moment far below
    eps, moves it by about lr * g / eps = 4e-5 a step on each side: it is held to
    ZERO_GRAD_PARAM_TOL's 2e-4 (read 5.6e-5 after one step, 9.6e-5 after three)."""
    profile, start = STEP_CASES[start]
    hp, batch, jstate, jstep = request.getfixturevalue(
        'paper_jax_steps' if profile == 'paper' else 'jax_steps')
    key = jax.random.PRNGKey(7)
    if start == 'mid-run':
        batch = dict(batch, mel_targets=3 * batch['mel_targets'])
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    if start == 'mid-run':
        for _ in range(2):
            (jstate, _), _ = jstep(jstate, jbatch, key)
    state = convert.tacotron_train_state_from_jax(_as_numpy_state(jstate), hp)
    assert state.step == int(jstate.step)
    pbatch = port_batch(batch)
    first = int(jstate.step)
    norms = []
    zero_grad = noise_gradient_biases(state.model)
    assert zero_grad == ({'postnet_convolutions.convs.1.conv.bias'} if profile == 'paper' else
                         {'postnet_convolutions.convs.1.conv.bias', 'cbhg_postnet.proj2.conv.bias'})
    for n_steps, tol in ((1, 5e-5), (3, 1e-4)):
        while state.step < first + n_steps:
            (jstate, jm), draws = jstep(jstate, jbatch, key)
            m = tt.train_step(state, pbatch, hp, noise=port_noise(hp, draws, train=True))
            for k in LOSS_TERMS + ('grad_norm',):
                w = float(jm[k])
                assert abs(w - m[k].item()) <= 2e-5 * abs(w), (k, state.step)
            assert m['learning_rate'] == float(jm['learning_rate'])
            assert m['teacher_forcing_ratio'] == float(jm['teacher_forcing_ratio'])
            norms.append(float(jm['grad_norm']))
        want = _state_tensors(convert.tacotron_train_state_from_jax(_as_numpy_state(jstate), hp))
        got = _state_tensors(state)
        assert set(want) == set(got) and state.step == int(jstate.step)
        for name in want:
            err = _max_abs(_np(want[name]), _np(got[name]))
            kind, pname = name.split(':')
            if pname in zero_grad and kind == 'mu':
                assert max(float(want[name].abs().max()), float(got[name].abs().max())) <= 1e-8
            elif pname in zero_grad and kind == 'param':
                assert err <= ZERO_GRAD_PARAM_TOL[profile], name
            elif pname not in zero_grad:
                assert err <= tol * max(float(want[name].abs().max()), 1e-6), (name, n_steps)
    assert (max(norms) > 1.0) == (start == 'mid-run'), norms


def test_eval_step_matches_jax(jax_steps, recorder):
    """The eval step (no zoneout, no encoder or post-net dropout, BatchNorm over the
    running statistics, prenet dropout on, coins at the step's ratio): every loss term
    2e-5 relative and the outputs 1e-4; with tacotron_natural_eval the coins compare
    with 0 and the decoder reads its own frames."""
    hp, batch, jstate, _ = jax_steps
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    run = recording(recorder, lambda s, b, k: jtt.eval_step(s, b, k, hp))
    want, draws = run(jstate, jbatch, jax.random.PRNGKey(9))
    state = convert.tacotron_train_state_from_jax(_as_numpy_state(jstate), hp)
    before = {k: b.clone() for k, b in state.model.named_buffers()}
    got = tt.eval_step(state, port_batch(batch), hp, noise=port_noise(hp, draws, train=False))
    for k in LOSS_TERMS:
        assert abs(float(want[k]) - got[k].item()) <= 2e-5 * abs(float(want[k])), k
    for k in ('mel_outputs', 'alignments', 'stop_token_prediction', 'linear_outputs'):
        assert _max_abs(want[k], _np(got[k])) <= 1e-4, k
    assert all(torch.equal(b, before[k]) for k, b in state.model.named_buffers())
    natural = tt.eval_step(state, port_batch(batch), hp.replace(tacotron_natural_eval=True),
                           noise=port_noise(hp, draws, train=False))
    assert natural['loss'].item() != got['loss'].item()


def test_fine_tuning_freezes_the_encoder():
    """tacotron_fine_tuning: the embedding and the encoder take no update and keep zero
    moments; every other parameter moves."""
    hp = make_hp(',tacotron_fine_tuning=True')
    state = tt.create_train_state(hp, 'cpu', seed=1)
    before = {n: p.clone() for n, p in state.model.named_parameters()}
    tt.train_step(state, port_batch(make_batch(hp)), hp, torch.Generator().manual_seed(0))
    names = [n for n, _ in state.model.named_parameters()]
    for (n, p), mu in zip(state.model.named_parameters(), state.exp_avg):
        frozen = n.startswith(('inputs_embedding', 'encoder_'))
        assert frozen != tt.trainable(hp, n), n
        assert torch.equal(p, before[n]) == frozen, n
        assert (not mu.any()) == frozen, n
    assert any(n.startswith('encoder_lstm') for n in names)


def test_create_train_state_follows_flax():
    """A fresh state: the port's parameter set is the converted flax tree's; kernels of
    variance 1/fan_in cut at two deviations, zero biases but the highways' T (-1), the
    embedding's deviation 0.5, orthogonal GRU hidden blocks, BatchNorm 1/0/0/1; seeded."""
    hp = make_hp()
    v = flax_variables(hp)
    state = tt.create_train_state(hp, 'cpu')
    sd = state.model.state_dict()
    assert set(sd) == set(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    w = sd['decoder.lstm_1.gates.weight']
    fan_in = w.shape[1]
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.1
    assert w.abs().max().item() <= 2.0 / 0.87962566103423978 / fan_in ** 0.5 + 1e-6
    assert abs(sd['inputs_embedding.weight'].std().item() - 0.5) < 0.02
    hid = sd['cbhg_postnet.gru_fw.hidden.weight'].view(3, 16, 16)
    for blk in hid:
        assert torch.allclose(blk @ blk.T, torch.eye(16), atol=1e-5)
    for name, t in sd.items():
        if name.endswith('.bias') and '.T.' not in name:
            assert not t.any(), name
        if name.endswith('running_var') or name.endswith('bn.weight'):
            assert torch.equal(t, torch.ones_like(t)), name
    again = tt.create_train_state(hp, 'cpu')
    assert all(torch.equal(a, b) for a, b in zip(again.model.parameters(),
                                                 state.model.parameters()))


# ---------------------------------------------------------------- feeder and Griffin-Lim

CORPUS_HP = (',hop_size=32,win_size=128,n_fft=256,num_freq=129,upsample_scales=[4,8],'
             'tacotron_batch_size=2,'
             'tacotron_test_size=None,tacotron_test_batches=2,bucket_group_batches=2,'
             'pad_mel_multiple=16,griffin_lim_iters=3,max_iters=8')
TEXTS = ['Hello world.', 'The big brown fox jumps.', 'He reads books at night.', 'Yes.',
         'A short one', 'Printing, in the only sense with which we are at present concerned',
         'Dr. Smith paid $12 for 3 books.', 'Numbers like 1,024 and 1990 too.']


def _corpus(root, hp, n=14):
    """A seeded corpus in the preprocessing layout: mels/, linear/ and train.txt."""
    rng = np.random.default_rng(0)
    for d in ('mels', 'linear'):
        os.makedirs(os.path.join(root, d))
    rows = []
    for i in range(n):
        frames = int(rng.integers(6, 30))
        np.save(os.path.join(root, 'mels', f'mel-{i}.npy'),
                rng.uniform(-4, 4, (frames, hp.num_mels)).astype(np.float32))
        np.save(os.path.join(root, 'linear', f'linear-{i}.npy'),
                rng.uniform(-4, 4, (frames, hp.num_freq)).astype(np.float32))
        rows.append(f'audio-{i}.npy|mel-{i}.npy|linear-{i}.npy|{frames * hp.hop_size}|'
                    f'{frames}|{TEXTS[i % len(TEXTS)]}')
    path = os.path.join(root, 'train.txt')
    with open(path, 'w', encoding='utf-8') as f:
        f.write('\n'.join(rows) + '\n')
    return path


@pytest.mark.parametrize('extra', ['', ',tacotron_test_size=0.3,tacotron_test_batches=None,'
                                       'outputs_per_step=3,predict_linear=False'])
def test_dataset_batches_match_jax(tmp_path, extra):
    """The feeder batch for batch against the JAX `TacotronDataset`: the split, the
    bucketed train batches (two groups, so the permutation wraps) and the test batches
    equal, every array and dtype; pads: inputs 0, targets -max_abs_value, stop token 1
    from frame len-1 on."""
    hp = make_hp(CORPUS_HP + extra)
    meta = _corpus(str(tmp_path), hp)
    want = JDataset(meta, hp)
    got = TacotronDataset(meta, hp)
    assert len(want) == len(got) and want.test_steps == got.test_steps
    assert want.hours == got.hours
    jit, it = want.train_batches(seed=3), got.train_batches(seed=3)
    pairs = [(next(jit), next(it)) for _ in range(12)] + list(zip(want.test_batches(),
                                                                  got.test_batches()))
    for w, g in pairs:
        assert set(w) == set(g)
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k]), k
    b = pairs[0][1]
    n = int(b['targets_lengths'][0])
    assert (b['stop_token_targets'][0, n - 1:] == 1).all() and not b['stop_token_targets'][0, :n - 1].any()
    assert (b['mel_targets'][0, n:] == -hp.max_abs_value).all()
    assert b['mel_targets'].shape[1] % hp.outputs_per_step == 0


def test_griffin_lim_matches_jax():
    """Griffin-Lim on the device's path (torch ops; here the CPU) against the JAX
    package's on spectrograms of two tones: the STFT and its inverse 1e-6 of their
    largest magnitude (read 2e-7); inv_mel_spectrogram_jax / inv_linear_spectrogram_jax
    with no iteration (the all-ones phase alone) 1e-5 of the wav's largest magnitude
    (read 2.4e-6), and at 3 iterations 5e-3 of the wav's norm in L2 distance (read
    1.3e-3 from mel, 2.5e-4 from linear). Each iteration takes the phase of the STFT
    bin by bin, and where a bin's magnitude is near zero its phase is rounding: the
    port's own f32 and f64 runs differ by 1.2e-3 after 3 iterations."""
    from tacotron2_tpu_torch.ops import audio
    hp = make_hp(CORPUS_HP)
    y = np.random.default_rng(0).normal(size=2000).astype(np.float32)
    want = np.asarray(dsp_jax.stft(jnp.asarray(y), hp.n_fft, hp.hop_size, hp.win_size))
    got = _np(dsp.stft(_t(y), hp))
    assert _max_abs(want, got) <= 1e-6 * float(np.abs(want).max())
    back = np.asarray(dsp_jax.istft(jnp.asarray(want), hp.n_fft, hp.hop_size, hp.win_size))
    assert _max_abs(back, _np(dsp.istft(_t(want), hp))) <= 1e-6 * float(np.abs(back).max())
    t = np.arange(40 * hp.hop_size) / hp.sample_rate
    wav = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1500 * t)).astype(np.float32)
    for spec, jfn, fn in ((audio.melspectrogram(wav, hp), dsp_jax.inv_mel_spectrogram_jax,
                           dsp.inv_mel_spectrogram),
                          (audio.linearspectrogram(wav, hp), dsp_jax.inv_linear_spectrogram_jax,
                           dsp.inv_linear_spectrogram)):
        spec = spec.astype(np.float32)
        for iters in (0, 3):
            h = hp.replace(griffin_lim_iters=iters)
            want = np.asarray(jfn(jnp.asarray(spec), h))
            got = _np(fn(_t(spec), h))
            assert want.shape == got.shape == (len(wav),)
            if iters == 0:
                assert _max_abs(want, got) <= 1e-5 * float(np.abs(want).max())
            else:
                assert np.linalg.norm(want - got) <= 5e-3 * np.linalg.norm(want)


# ---------------------------------------------------------------- the CLI

def _train(tmp_path, meta, steps, extra=()):
    return train.main(['--model', 'Tacotron', '--tacotron_input', 'train.txt', '--base_dir',
                       str(tmp_path), '--name', 'run', '--tacotron_train_steps', str(steps),
                       '--eval_interval', '2', '--checkpoint_interval', '3',
                       '--summary_interval', '1', '--device', 'cpu', '--hparams',
                       TINY + CORPUS_HP, *extra])


def test_train_cli_on_cpu_with_resume(tmp_path, capsys):
    """`python -m tacotron2_tpu_torch.train --model Tacotron --device cpu` at the tiny
    widths: 3 steps with an eval at 2 and a checkpoint at 3, then a rerun to 5 that
    restores step 3, evaluates at 4 and checkpoints at 5 (the last step). Finite losses;
    the artifacts where the JAX loop writes them (taco_pretrained/ckpt-N.pt,
    mel-spectrograms/mel-prediction-step-N.npy, wavs/step-N-wave-from-mel.wav,
    eval-dir/wavs/step-N-eval-wave-from-{mel,linear}.wav, CharacterEmbeddings.tsv,
    Terminal_train_log); the restored state is the checkpoint's."""
    hp = make_hp(CORPUS_HP)
    meta = _corpus(str(tmp_path), hp)
    save_dir = _train(tmp_path, meta, 3)
    out = capsys.readouterr().out
    log_dir = os.path.join(str(tmp_path), 'logs-run')
    assert save_dir == os.path.join(log_dir, 'taco_pretrained')
    assert 'Starting new training!' in out and 'Eval losses: loss=' in out
    assert 'Plots skipped' in out
    assert os.listdir(save_dir) == ['ckpt-3.pt']
    for name in ('mel-spectrograms/mel-prediction-step-3.npy', 'wavs/step-3-wave-from-mel.wav',
                 'eval-dir/wavs/step-2-eval-wave-from-mel.wav',
                 'eval-dir/wavs/step-2-eval-wave-from-linear.wav',
                 'CharacterEmbeddings.tsv', 'Terminal_train_log'):
        assert os.path.getsize(os.path.join(log_dir, name)) > 0, name
    for d in ('plots', 'eval-dir/plots'):
        assert os.path.isdir(os.path.join(log_dir, d))
    mel = np.load(os.path.join(log_dir, 'mel-spectrograms/mel-prediction-step-3.npy'))
    assert mel.shape[1] == hp.num_mels and np.isfinite(mel).all()
    saved = CheckpointManager(save_dir).restore(3)
    _train(tmp_path, meta, 5)
    out = capsys.readouterr().out
    assert 'Loading checkpoint at step 3' in out
    assert sorted(os.listdir(save_dir)) == ['ckpt-3.pt', 'ckpt-5.pt']
    assert os.path.isfile(os.path.join(log_dir, 'eval-dir/wavs/step-4-eval-wave-from-linear.wav'))
    with open(os.path.join(log_dir, 'Terminal_train_log'), encoding='utf-8') as f:
        text = f.read()
    losses_ = [float(l.split('loss=')[1].split(',')[0]) for l in text.splitlines()
               if 'sec/step, loss=' in l]
    assert len(losses_) == 5 and all(np.isfinite(losses_))
    state = CheckpointManager(save_dir).restore(5)
    assert state['step'] == 5 and len(state['exp_avg']) == len(saved['exp_avg'])
    resumed = tt.create_train_state(hp, 'cpu', seed=99)
    resumed.load_state_dict(saved)
    assert all(torch.equal(resumed.model.state_dict()[k], v) for k, v in saved['model'].items())


SYNTH_HP = (',layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,'
            'tacotron_synthesis_batch_size=2,wavenet_synthesis_batch_size=2')


def test_synthesize_from_the_trainers_directory(tmp_path, capsys):
    """Two tiny train steps, then `synthesize --tacotron_checkpoint logs-run/taco_pretrained`
    (the latest step, and step 1 by number) with a WaveNet file: one wav a sentence;
    the loaded weights are those of the checkpoint."""
    hp = make_hp(CORPUS_HP + SYNTH_HP)
    meta = _corpus(str(tmp_path), hp)
    save_dir = train.main(['--model', 'Tacotron', '--tacotron_input', 'train.txt',
                           '--base_dir', str(tmp_path), '--name', 'run',
                           '--tacotron_train_steps', '2', '--eval_interval', '100',
                           '--checkpoint_interval', '1', '--summary_interval', '100',
                           '--device', 'cpu', '--hparams', TINY + CORPUS_HP])
    assert CheckpointManager(save_dir).all_steps() == [1, 2]
    taco = convert.load_tacotron(save_dir, hp)
    want = CheckpointManager(save_dir).restore(2)['model']
    assert all(torch.equal(v, want[k]) for k, v in taco.state_dict().items())
    one = convert.load_tacotron(save_dir, hp, '1')
    assert not torch.equal(one.state_dict()['decoder.lstm_1.gates.weight'],
                           want['decoder.lstm_1.gates.weight'])
    with pytest.raises(ValueError, match='one file'):
        single = str(tmp_path / 'taco.pt')
        convert.save_checkpoint(single, 'tacotron', want)
        convert.load_tacotron(single, hp, '1')
    wave = str(tmp_path / 'wavenet.pt')
    convert.save_checkpoint(wave, 'wavenet', WaveNet(hp).state_dict())
    texts = tmp_path / 'texts.txt'
    texts.write_text('Hello world.\nHe reads books.\n', encoding='utf-8')
    capsys.readouterr()
    stats = synthesize.main(['--tacotron_checkpoint', save_dir, '--tacotron_checkpoint_step',
                             'latest', '--wavenet_checkpoint', wave, '--text_list', str(texts),
                             '--output_dir', str(tmp_path / 'out'), '--device', 'cpu',
                             '--hparams', TINY + CORPUS_HP + SYNTH_HP])
    assert len(stats['wav_paths']) == 2 and all(os.path.getsize(p) > 0 for p in stats['wav_paths'])
    assert 'Loaded Tacotron checkpoint at step 2' in capsys.readouterr().out
