"""The trainers' compute dtype: the port's bf16 train steps against the JAX package's
`train_step(..., dtype=jnp.bfloat16)` on the CPU, at the TINY widths of
test_torch_tacotron_train.py and test_torch_train.py, from converted states with the
JAX step's draws shared (test_torch_tacotron_train.py's patch of `jax.random`).

Two bf16 computations of one step differ wherever they round differently, so each
bound below is stated with its reading and its reason. JAX on the CPU rounds at flax's
casting points, each op of a bf16 chain rounded, but XLA also keeps excess precision
where it fuses bf16 terms into an f32 consumer: the attention's energy sum, which the
port forms in f32 as well, and, in the forward direction of the encoder LSTM only, the
hoisted input half, which the port rounds as flax says in both directions. The
port's autograd differentiates its bf16 ops in bf16, the JAX fused decoder's
hand-written VJP rounds its residuals at its own places. The casting points are held
to be the same, not merely close, by the port's bf16 lying nearer to JAX's bf16 than
to JAX's f32 (the `nearer` checks): module by module, for the decoder's outputs and
gradients, for the whole Tacotron's outputs, and for the WaveNet step's gradients.
The whole Tacotron step's gradients are as far from JAX's bf16 (0.80% in relative L2)
as from its f32 (0.78%): there the two implementations' own roundings, summed over
the whole backward, are as large as the bf16-f32 gap.
"""

import os
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tacotron2_tpu.models.tacotron import modules as jmod
from tacotron2_tpu.models.tacotron.model import Tacotron as JTacotron
from tacotron2_tpu.ops import fused_decoder as jfd
from tacotron2_tpu.training import tacotron_trainer as jtt
from tacotron2_tpu.training import wavenet_trainer as jwt
from tacotron2_tpu_torch import convert, train
from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.ops import fused_decoder as tfd
from tacotron2_tpu_torch.training import common, tacotron_train, wavenet_train
from tacotron2_tpu_torch.training import tacotron_trainer as tt
from tacotron2_tpu_torch.training import wavenet_trainer as wt

import test_torch_tacotron_train as tac
import test_torch_train as wav
from test_torch_tacotron_train import recorder  # noqa: F401  (the fixture)

BF16 = jnp.bfloat16


def _rel(a, b, ref):
    """|a - b| / |ref| in the L2 norm, in float64."""
    a, b, ref = (np.asarray(x, np.float64) for x in (a, b, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


def nearer(port, jax_bf16, jax_f32):
    """(port's distance to JAX's bf16, to JAX's f32), relative to JAX's f32."""
    return _rel(port, jax_bf16, jax_f32), _rel(port, jax_f32, jax_f32)


# ---------------------------------------------------------------- the resolver

@pytest.mark.parametrize('device,compute,want', [
    ('cpu', 'bfloat16', torch.float32), ('cuda', 'bfloat16', torch.bfloat16),
    ('cuda:0', 'bfloat16', torch.bfloat16), ('cuda', 'float32', torch.float32),
    ('cpu', 'float32', torch.float32)])
def test_resolve_compute_dtype(device, compute, want):
    """bf16 on a CUDA device where hp.compute_dtype asks for it, f32 elsewhere, as
    `resolve_compute_dtype` counts 'gpu' an accelerator and keeps the CPU in f32. The
    device is only named: no card is needed."""
    hp = default_hparams()
    hp.parse(f'compute_dtype={compute}')
    assert common.resolve_compute_dtype(hp, device) == want
    assert common.resolve_compute_dtype(hp, torch.device(device)) == want


@pytest.mark.parametrize('model', ['Tacotron', 'WaveNet'])
def test_train_cli_runs_bf16_where_the_resolver_says(tmp_path, capsys, monkeypatch, model):
    """Each training loop runs its train and eval steps in the resolver's dtype: with
    the resolver stubbed to answer bf16, as it does on the card, 2 steps of the CLI on
    the CPU (an eval and a checkpoint at step 2) log the dtype, resolve it in every
    train and eval step, and end with finite losses and the checkpoint."""
    asked = []

    def bf16(hp, device):
        asked.append(torch.device(device).type)
        return torch.bfloat16

    for module in (tt, wt, tacotron_train, wavenet_train):
        monkeypatch.setattr(module, 'resolve_compute_dtype', bf16)
    if model == 'Tacotron':
        hp = tac.make_hp(tac.CORPUS_HP)
        tac._corpus(str(tmp_path), hp)
        argv = ['--tacotron_input', 'train.txt', '--tacotron_train_steps', '2',
                '--hparams', tac.TINY + tac.CORPUS_HP]
    else:
        hp = default_hparams()
        hp.parse(wav.VERIFY_TINY)
        argv = ['--wavenet_input', wav._corpus(str(tmp_path), hp, n=8),
                '--wavenet_train_steps', '2', '--hparams', wav.VERIFY_TINY]
    save_dir = train.main(['--model', model, '--base_dir', str(tmp_path), '--name', 'bf',
                           '--eval_interval', '2', '--checkpoint_interval', '2',
                           '--summary_interval', '1', '--device', 'cpu'] + argv)
    out = capsys.readouterr().out
    assert 'Compute dtype: torch.bfloat16' in out
    # the loop's line, 2 train steps, then the evals' and the checkpoint's steps
    assert asked[:3] == ['cpu'] * 3 and len(asked) >= 4
    losses = [float(x) for x in re.findall(r'loss=([0-9.]+|nan|inf)', out)]
    assert len(losses) >= 2 and np.isfinite(losses).all()
    assert any(f.endswith('2.pt') for f in os.listdir(save_dir))


# ---------------------------------------------------------------- Tacotron

@pytest.fixture(scope='module')
def taco():
    """(hp, flax variables, the port Tacotron holding them) at the TINY widths."""
    hp = tac.make_hp(tac.TRAIN_EXTRA)
    v = tac.flax_variables(hp)
    model = Tacotron(hp)
    model.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    return hp, v, model


MODULE_CASES = ('encoder_convolutions', 'postnet_convolutions', 'cbhg_postnet')


@pytest.mark.parametrize('part', MODULE_CASES)
def test_bf16_conv_modules_match_flax(taco, part):
    """The encoder convs, the post-net and the CBHG (eval) in bf16, each on the same bf16
    input: 1e-6 of the f32 output's norm from flax's bf16 (read 4.4e-8, 4.3e-8 and 0:
    the casting points and each op's rounding are the same; only a conv's f32 sum order
    is not), where the bf16-f32 gap reads 1.7e-3, 3.7e-4 and 6.3e-3."""
    hp, v, model = taco
    rng = np.random.default_rng(1)
    P, S = v['params'][part], v['batch_stats'][part]
    width = hp.embedding_dim if part == 'encoder_convolutions' else hp.num_mels
    x = rng.normal(size=(tac.B, 16, width)).astype(np.float32)
    make = {'encoder_convolutions': lambda dt: jmod.EncoderConvolutions(
                hp.enc_conv_num_layers, hp.enc_conv_kernel_size[0], hp.enc_conv_channels,
                0.5, 'after', dt),
            'postnet_convolutions': lambda dt: jmod.Postnet(
                hp.postnet_num_layers, hp.postnet_kernel_size[0], hp.postnet_channels, 0.5,
                'after', dt),
            'cbhg_postnet': lambda dt: jmod.CBHG(
                hp.cbhg_kernels, hp.cbhg_conv_channels, hp.cbhg_pool_size,
                (hp.cbhg_projection, hp.num_mels), hp.cbhg_projection_kernel_size,
                hp.cbhg_highwaynet_layers, hp.cbhg_highway_units, hp.cbhg_rnn_units,
                'after', dt)}[part]
    vs = {'params': P, 'batch_stats': S}
    want = make(BF16).apply(vs, jnp.asarray(x, BF16))
    f32 = make(jnp.float32).apply(vs, x)
    module = getattr(model, part)
    xb = torch.from_numpy(x).bfloat16()
    with torch.no_grad():
        got = (module(xb, None, False, torch.bfloat16) if part == 'cbhg_postnet'
               else module(xb, False, None, torch.bfloat16))
    assert got.dtype == (torch.bfloat16 if part == 'cbhg_postnet' else torch.float32)
    assert _rel(got.float().numpy(), want, f32) <= 1e-6
    assert _rel(want, f32, f32) >= 1e-4


def _decoder_inputs(hp, T=8, seed=2):
    rng = np.random.default_rng(seed)
    B, T_IN = tac.B, tac.T_IN
    f32 = np.float32
    return dict(
        keys=rng.normal(size=(B, T_IN, hp.attention_dim)).astype(f32),
        values=rng.normal(size=(B, T_IN, 2 * hp.encoder_lstm_units)).astype(f32),
        mask=(np.arange(T_IN)[None] < tac.LENGTHS[:, None]).astype(f32),
        teacher=rng.uniform(-4, 4, (T, B, hp.num_mels)).astype(f32),
        use=np.ones(T, f32),
        m1=2 * (rng.uniform(size=(T, B, hp.prenet_layers[0])) < 0.5).astype(f32),
        m2=2 * (rng.uniform(size=(T, B, hp.prenet_layers[1])) < 0.5).astype(f32),
        zo=tuple(rng.uniform(size=(T, B, hp.decoder_lstm_units)) < 0.9 for _ in range(4)),
        cot=[rng.normal(size=s).astype(f32) for s in (
            (T, B, hp.num_mels * hp.outputs_per_step), (T, B, hp.outputs_per_step),
            (T, B, T_IN))])


def test_bf16_decoder_scan_matches_jax(taco):
    """`decoder_scan` in bf16 over 8 teacher-forced steps (every step reads its teacher
    frame, as training does at the default ratio: where the decoder feeds its own frames
    back, the two implementations' roundings compound from step to step) with prenet
    masks and zoneout gates, against the JAX fused `decoder_scan` in bf16 (its forward,
    and its hand-written VJP for the gradient of a random projection of the outputs with
    respect to every decoder weight, the keys and the values): frames, stops,
    alignments and the gradients, each nearer to JAX's bf16 than to its f32 and within
    1e-2 of the f32 norm (read 5.1e-3, 3.0e-3, 3.6e-3 and 5.7e-3; to JAX's f32 6.0e-3,
    3.7e-3, 4.3e-3 and 9.3e-3)."""
    hp, v, model = taco
    d = _decoder_inputs(hp)
    P = v['params']['decoder']

    def jax_run(dt):
        cfg = jfd.config_from_hp(hp, dt, False)

        def loss(p, k, vals):
            outs = jfd.decoder_scan(cfg, p, k.astype(dt), vals, d['mask'], d['teacher'],
                                    d['use'], jnp.asarray(d['m1'], dt),
                                    jnp.asarray(d['m2'], dt), d['zo'])
            return sum(jnp.sum(o * c) for o, c in zip(outs, d['cot'])), outs
        (_, outs), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
            P, d['keys'], d['values'])
        tree = jax.tree_util.tree_map(np.zeros_like, v['params'])
        tree['decoder'] = jax.tree_util.tree_map(np.asarray, g[0])
        sd = convert.tacotron_state_dict(tree, v['batch_stats'])
        grads = [sd['decoder.' + n].numpy() for n, _ in model.decoder.named_parameters()]
        return outs, np.concatenate([x.ravel() for x in grads + [np.asarray(g[1], np.float32),
                                                                  np.asarray(g[2])]])

    (want, gw), (f32, gf) = jax_run(BF16), jax_run(jnp.float32)
    model.zero_grad()
    tk, tv = (torch.from_numpy(d[k]).requires_grad_() for k in ('keys', 'values'))
    outs = tfd.decoder_scan(model.decoder, tk.bfloat16(), tv, torch.from_numpy(d['mask']),
                            torch.from_numpy(d['teacher']), torch.from_numpy(d['use']),
                            [torch.from_numpy(d['m1']), torch.from_numpy(d['m2'])],
                            [torch.from_numpy(z) for z in d['zo']], torch.bfloat16)
    sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(outs, d['cot'])).backward()
    got_g = np.concatenate([p.grad.numpy().ravel() for _, p in model.decoder.named_parameters()]
                           + [tk.grad.numpy().ravel(), tv.grad.numpy().ravel()])
    model.zero_grad()
    for o, w, f in zip(outs, want, f32):
        assert o.dtype == torch.float32
        to_bf16, to_f32 = nearer(o.detach().numpy(), w, f)
        assert to_bf16 < to_f32 and to_bf16 <= 1e-2
    to_bf16, to_f32 = nearer(got_g, gw, gf)
    assert to_bf16 < to_f32 and to_bf16 <= 1e-2


def test_bf16_teacher_forced_model_is_nearer_jax_bf16(taco, recorder):
    """The whole model in training (ratio 0.5, the JAX pass's draws) in bf16: its mel
    outputs before and after the post-net and its linear outputs are nearer to the JAX
    model's bf16 outputs than to its f32 ones (read 3.0e-3 / 4.8e-3, 5.0e-3 / 5.7e-3,
    4.4e-3 / 4.7e-3 of the f32 norm), and every output is within 1e-2 of JAX's bf16
    (alignments and stop logits read 2.5e-3 and 2.8e-3: as far from JAX's bf16 as from
    its f32, through the encoder LSTM's forward direction, where XLA does not round the
    hoisted input half)."""
    hp, v, model = taco
    batch = tac.make_batch(hp)
    outs = {}
    for dt in (BF16, jnp.float32):
        run = tac.recording(recorder, lambda vs, k: JTacotron(hp, dtype=dt).apply(
            vs, batch['inputs'], tac.LENGTHS, mel_targets=batch['mel_targets'],
            deterministic=False, teacher_forcing_ratio=0.5,
            rngs={'dropout': k, 'zoneout': jax.random.fold_in(k, 1),
                  'teacher': jax.random.fold_in(k, 2)}, mutable=['batch_stats']))
        (outs[dt], _), draws = run(v, jax.random.PRNGKey(3))
    fresh = Tacotron(hp)
    fresh.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    with torch.no_grad():
        got = fresh.teacher_forced(tac._t(batch['inputs']), tac._t(tac.LENGTHS),
                                   tac._t(batch['mel_targets']),
                                   tac.port_noise(hp, draws, train=True), deterministic=False,
                                   teacher_forcing_ratio=0.5, dtype=torch.bfloat16)
    for k in ('decoder_output', 'mel_outputs', 'linear_outputs', 'alignments',
              'stop_token_prediction'):
        assert got[k].dtype == torch.float32, k
        to_bf16, to_f32 = nearer(got[k].numpy(), outs[BF16][k], outs[jnp.float32][k])
        assert to_bf16 <= 1e-2, k
        if k in ('decoder_output', 'mel_outputs', 'linear_outputs'):
            assert to_bf16 < to_f32, k


def test_bf16_train_step_matches_jax(recorder):
    """One Tacotron train step in bf16 from a converted JAX state, on the JAX bf16
    step's draws (the same as its f32 step's): every loss term within 1e-4 relative of
    JAX's bf16 (read up to 5.2e-5, the stop loss) and grad_norm 2e-3 (read 7.0e-4); the
    gradients (Adam's first moment) within 1.5e-2 of JAX's bf16 in relative L2 (read
    8.0e-3, the bf16-f32 gap 8.4e-3; see the module docstring for why this is not
    nearer); the port's f32 step stays 1e-6 from JAX's f32 (read 5.8e-7), and the
    parameters stay f32."""
    hp = tac.make_hp(tac.TRAIN_EXTRA)
    v = tac.flax_variables(hp)
    batch = tac.make_batch(hp)
    jstate = jtt.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                            batch_stats=v['batch_stats'],
                            opt_state=jtt.make_optimizer(hp).init(v['params']))
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
    key = jax.random.PRNGKey(7)
    want = {}
    for dt in (BF16, jnp.float32):
        (new, m), draws = tac.recording(recorder, lambda s, b, k: jtt.train_step(
            s, b, k, hp, dtype=dt))(jstate, jbatch, key)
        want[dt] = (convert.tacotron_train_state_from_jax(tac._as_numpy_state(new), hp),
                    {k: float(m[k]) for k in tac.LOSS_TERMS + ('grad_norm',)})
    noise = tac.port_noise(hp, draws, train=True)
    got = {}
    for dt in (torch.bfloat16, torch.float32):
        state = convert.tacotron_train_state_from_jax(tac._as_numpy_state(jstate), hp)
        m = tt.train_step(state, tac.port_batch(batch), hp, noise=noise, dtype=dt)
        got[dt] = (state, m)

    def grads(state):
        return torch.cat([m.flatten() for m in state.exp_avg]).numpy()

    state, m = got[torch.bfloat16]
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    for k in tac.LOSS_TERMS:
        w = want[BF16][1][k]
        assert abs(m[k].item() - w) <= 1e-4 * max(abs(w), 1e-6), k
    assert abs(m['grad_norm'].item() - want[BF16][1]['grad_norm']) \
        <= 2e-3 * want[BF16][1]['grad_norm']
    gf = grads(want[jnp.float32][0])
    assert _rel(grads(state), grads(want[BF16][0]), gf) <= 1.5e-2
    assert _rel(grads(got[torch.float32][0]), gf, gf) <= 1e-6


# ---------------------------------------------------------------- WaveNet

WAVENET_CASES = {'gaussian': wav.HEADS['gaussian'],
                 'gaussian-wn-g': wav.HEADS['gaussian'] + wav.WN_G,
                 'mol': wav.HEADS['mol'],
                 'categorical': wav.HEADS['categorical']}


@pytest.mark.parametrize('case', list(WAVENET_CASES))
def test_bf16_wavenet_train_step_is_nearer_jax_bf16(case):
    """One WaveNet train step in bf16 (dropout 0) from a converted JAX state against
    `jwt.train_step(..., dtype=jnp.bfloat16)`: the gradients (Adam's first moment)
    nearer to JAX's bf16 than to its f32 and within 3e-2 of the f32 norm (read 2.0e-3,
    4.8e-3, 4.5e-3 and 1.7e-2 where the bf16-f32 gap reads 5.4e-3, 9.7e-3, 7.5e-3 and
    9.6e-2), the loss within 1e-4 relative of JAX's bf16 (read up to 3.9e-5); the
    output of the head is float32."""
    hp = wav.make_hp(WAVENET_CASES[case] + ',wavenet_ema_decay=0.9')
    batch = wav.make_batch(hp)
    params = wav.flax_params(hp)
    tx = jwt.make_optimizer(hp)
    jstate = jwt.WaveNetTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                   ema_params=jax.tree_util.tree_map(jnp.copy, params),
                                   opt_state=tx.init(params))
    jbatch = {k: jnp.asarray(x) for k, x in batch.items()}

    def grads(state):
        return torch.cat([m.flatten() for m in state.exp_avg]).numpy()

    want = {}
    for dt in (BF16, jnp.float32):
        new, m = jax.jit(lambda s, b, k: jwt.train_step(s, b, k, hp, dtype=dt))(
            jstate, jbatch, jax.random.PRNGKey(0))
        want[dt] = (grads(convert.wavenet_train_state_from_jax(wav._as_numpy_state(new), hp)),
                    float(m['loss']))
    state = convert.wavenet_train_state_from_jax(wav._as_numpy_state(jstate), hp)
    m = wt.train_step(state, wav.port_batch(batch), hp, dtype=torch.bfloat16)
    to_bf16, to_f32 = nearer(grads(state), want[BF16][0], want[jnp.float32][0])
    assert to_bf16 < to_f32 and to_bf16 <= 3e-2
    assert abs(m['loss'].item() - want[BF16][1]) <= 1e-4 * abs(want[BF16][1])
    y_hat = wt.eval_teacher_forced_step(state, wav.port_batch(batch), hp,
                                        torch.bfloat16)['y_hat']
    assert y_hat.dtype == torch.float32
