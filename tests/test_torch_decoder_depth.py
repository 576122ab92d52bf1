"""The Tacotron decoder at a depth other than the reference's two prenet layers and two
LSTMs, and `remat_decoder`: the port against the JAX package's `nn.scan` cell
(`model.py:40-110, 199-212`) and its `nn.while_loop` synthesis (`:296-299`), fp32 on the
CPU at the TINY widths of test_torch_tacotron.py with DEPTH3 on top.

The JAX `nn.scan` cell draws its prenet dropout and zoneout masks inside the scan with
`split_rngs` (`model.py:206-210`), where the patch of `jax.random` that
test_torch_tacotron_train.py shares draws through does not reach. So depth 3 is held
exactly where no draw is made: tacotron_dropout_rate 0 (no dropout anywhere), and
zoneout either at rate 0 in training (the state takes its new value) or at its
expectation (deterministic passes and synthesis). What the random forms do is the same
code at every depth (`ops/fused_decoder._step` loops over the layers), held at depth 2
by test_torch_tacotron_train.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.models.tacotron.model import Tacotron as JTacotron
from tacotron2_tpu.training import tacotron_trainer as jtt
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.tacotron.flax_names import flax_name, port_name
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.ops import decoder_vjp as dv
from tacotron2_tpu_torch.ops import fused_decoder as tfd
from tacotron2_tpu_torch.training import tacotron_trainer as tt

from test_torch_tacotron_train import (LENGTHS, LOSS_TERMS, _as_numpy_state, _max_abs, _np,
                                       _t, flax_variables, make_batch, make_hp, port_batch,
                                       ZERO_GRAD_PARAM_TOL, noise_gradient_biases, recorder,
                                       recording)

DEPTH3 = ',prenet_layers=[16,16,16],decoder_layers=3,tacotron_dropout_rate=0.0'
TRAIN3 = DEPTH3 + ',tacotron_zoneout_rate=0.0,tacotron_teacher_forcing_ratio=0.5'


def _pair(extra):
    """(hp, flax variables, the port Tacotron holding them)."""
    hp = make_hp(extra)
    v = flax_variables(hp)
    model = Tacotron(hp)
    model.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    return hp, v, model


def test_depth3_names_follow_flax():
    """The converted flax tree of a depth-3 model loads strictly: `lstm_3` and the third
    prenet `dense_3` land on the port's tensors of those names, both ways."""
    hp, v, model = _pair(DEPTH3)
    names = dict(model.named_parameters())
    assert 'decoder.lstm_3.gates.weight' in names and 'decoder.prenet.layers.2.weight' in names
    assert flax_name('decoder.lstm_3.gates.weight') == 'decoder/lstm_3/gates/kernel'
    assert port_name('decoder/prenet/dense_3/kernel') == 'decoder.prenet.layers.2.weight'
    assert len(model.decoder.lstms) == 3
    assert np.array_equal(_np(names['decoder.lstm_3.gates.weight']),
                          np.asarray(v['params']['decoder']['lstm_3']['gates']['kernel']).T)


@pytest.mark.parametrize('ratio', [1.0, 0.5])
def test_depth3_teacher_forced_matches_nn_scan(recorder, ratio):
    """The deterministic teacher-forced pass (zoneout's expectation, BatchNorm over the
    running statistics) at depth 3 against the JAX model, whose fused scan does not
    cover the depth and runs its nn.scan cell: every output 1e-4, as the depth-2 model
    is held (test_torch_tacotron_train.py), with the coins the JAX pass drew (its only
    draw here)."""
    hp, v, model = _pair(DEPTH3 + ',predict_linear=True')
    batch = make_batch(hp)
    key = jax.random.PRNGKey(4)
    run = recording(recorder, lambda vs: JTacotron(hp).apply(
        vs, batch['inputs'], LENGTHS, mel_targets=batch['mel_targets'], deterministic=True,
        teacher_forcing_ratio=ratio, rngs={'dropout': key, 'zoneout': key, 'teacher': key}))
    want, draws = run(v)
    assert len(draws) == 1
    T = batch['mel_targets'].shape[1] // hp.outputs_per_step
    coins = np.asarray(draws[0])
    noise = {'coins': _t(coins), **{f'm{i + 1}': torch.ones(T, len(LENGTHS), 16)
                                    for i in range(3)}}
    with torch.no_grad():
        got = model.teacher_forced(_t(batch['inputs']), _t(LENGTHS),
                                   _t(batch['mel_targets']), noise, teacher_forcing_ratio=ratio)
    assert (ratio == 1.0) == bool((coins < ratio).all())
    for k in ('decoder_output', 'mel_outputs', 'stop_token_prediction', 'alignments',
              'linear_outputs'):
        assert got[k].shape == want[k].shape, k
        assert _max_abs(want[k], _np(got[k])) <= 1e-4, k
    assert np.array_equal(np.asarray(want['stop_finished']), _np(got['stop_finished']))


def test_depth3_synthesis_matches_while_loop():
    """Free-running synthesis at depth 3 (no dropout, zoneout's expectation) against the
    JAX model's nn.while_loop over its nn.scan cell in chunks: 24 steps in chunks of 8,
    every output 1e-4 and the stop flags equal."""
    hp, v, model = _pair(DEPTH3 + ',decoder_chunk_size=8')
    batch = make_batch(hp)
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda vs: JTacotron(hp).apply(
        vs, batch['inputs'], LENGTHS, max_iters=24, deterministic=True,
        rngs={'dropout': key, 'zoneout': key}))(v)
    got = model(_t(batch['inputs']), _t(LENGTHS), max_iters=24)
    for k in ('decoder_output', 'mel_outputs', 'stop_token_prediction', 'alignments'):
        assert got[k].shape == want[k].shape, k
        assert _max_abs(want[k], _np(got[k])) <= 1e-4, k
    assert np.array_equal(np.asarray(want['stop_finished']), _np(got['stop_finished']))


def test_depth3_train_step_matches_jax(recorder):
    """One train step at depth 3 (no dropout, zoneout rate 0, teacher forcing at 0.5,
    BatchNorm over the batch) from a converted JAX state, with the coins the JAX step
    drew (its only draw here), with the bounds of the depth-2 step
    (test_torch_tacotron_train.py): every loss term and grad_norm 2e-5 relative; every
    parameter, Adam moment and BatchNorm statistic 1e-4 of its tensor's largest
    magnitude (read up to 6.7e-5, the first moment of the post-net's first conv bias,
    whose BatchNorm follows a tanh: its gradient mostly cancels); the conv biases BatchNorm follows directly, whose gradient is rounding
    alone (`noise_gradient_biases`), first moments under 1e-8 on both sides and the
    biases within 2e-4 (ZERO_GRAD_PARAM_TOL of the profile whose rounding-level gradient
    is larger: Adam, with a second moment far below eps, moves such a bias by about
    lr * g / eps on each side; read 2.3e-5 here)."""
    hp = make_hp(TRAIN3)
    v = flax_variables(hp)
    batch = make_batch(hp)
    jstate = jtt.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                            batch_stats=v['batch_stats'],
                            opt_state=jtt.make_optimizer(hp).init(v['params']))
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    (new, jm), draws = recording(recorder, partial(jtt.train_step, hp=hp))(jstate, jbatch, key)
    assert len(draws) == 1
    T = batch['mel_targets'].shape[1] // hp.outputs_per_step
    coins = np.asarray(draws[0])
    assert 0 < (coins < 0.5).sum() < T
    state = convert.tacotron_train_state_from_jax(_as_numpy_state(jstate), hp)
    noise = {'coins': _t(coins), **{f'm{i + 1}': torch.ones(T, len(LENGTHS), 16)
                                    for i in range(3)}}
    m = tt.train_step(state, port_batch(batch), hp, noise=noise)
    for k in LOSS_TERMS + ('grad_norm',):
        assert abs(float(jm[k]) - m[k].item()) <= 2e-5 * abs(float(jm[k])), k
    want = convert.tacotron_train_state_from_jax(_as_numpy_state(new), hp)
    zero_grad = noise_gradient_biases(state.model)
    assert zero_grad == {'postnet_convolutions.convs.1.conv.bias',
                         'cbhg_postnet.proj2.conv.bias'}
    for kind, mine, theirs in (('param', state.model.parameters(), want.model.parameters()),
                               ('mu', state.exp_avg, want.exp_avg),
                               ('nu', state.exp_avg_sq, want.exp_avg_sq)):
        for (name, _), a, b in zip(state.model.named_parameters(), mine, theirs, strict=True):
            a, b = a.detach(), b.detach()
            err = _max_abs(_np(b), _np(a))
            if name in zero_grad and kind == 'mu':
                assert max(float(a.abs().max()), float(b.abs().max())) <= 1e-8, name
            elif name in zero_grad and kind == 'param':
                assert err <= ZERO_GRAD_PARAM_TOL['paper'], name
            elif name not in zero_grad:
                assert err <= 1e-4 * max(float(b.abs().max()), 1e-6), (kind, name)
    for name, buf in state.model.named_buffers():
        if name.endswith(('running_mean', 'running_var')):
            w = dict(want.model.named_buffers())[name]
            assert _max_abs(_np(w), _np(buf)) <= 5e-5 * float(w.abs().max()), name


REMAT_CASES = {'depth3': TRAIN3 + ',tacotron_zoneout_rate=0.1,tacotron_dropout_rate=0.5',
               'depth2-unfused': ',fused_decoder=False,tacotron_teacher_forcing_ratio=0.5'}


@pytest.mark.parametrize('case', list(REMAT_CASES))
def test_remat_decoder_changes_no_gradient(case, monkeypatch):
    """remat_decoder recomputes each decoder step in the backward (torch.utils.checkpoint)
    where the JAX package applies nn.remat: training on the non-fused path, at depth 3
    and at depth 2 with fused_decoder off. The loss and every gradient (Adam's first
    moment) are those of the run without it, bit for bit, with dropout and zoneout on;
    at depth 2 with fused_decoder on, remat is not applied: the fused decoder with its
    hand-written backward (`ops/decoder_vjp.fused_decoder_scan`) runs there, as the JAX
    model's fused scan ignores remat, and `decoder_scan` does not."""
    seen = []
    scan, fused = tfd.decoder_scan, dv.fused_decoder_scan
    monkeypatch.setattr(tfd, 'decoder_scan',
                        lambda *a, **kw: seen.append(kw['remat']) or scan(*a, **kw))
    monkeypatch.setattr(dv, 'fused_decoder_scan',
                        lambda *a, **kw: seen.append('fused') or fused(*a, **kw))
    runs = []
    for remat in (False, True):
        hp = make_hp(REMAT_CASES[case] + f',remat_decoder={remat}')
        state = tt.create_train_state(hp, 'cpu', seed=2)
        m = tt.train_step(state, port_batch(make_batch(hp)), hp,
                          torch.Generator().manual_seed(3))
        runs.append((m['loss'].item(), [mu.clone() for mu in state.exp_avg]))
    assert seen == [False, True]
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1], strict=True))
    hp = make_hp(',remat_decoder=True')
    state = tt.create_train_state(hp, 'cpu', seed=2)
    tt.train_step(state, port_batch(make_batch(hp)), hp, torch.Generator().manual_seed(3))
    assert seen[2:] == ['fused']
