"""The teacher-forced decoder with its hand-written backward (`ops/decoder_vjp.py`,
`FusedDecoderScan`) against the JAX package's fused decoder (`ops/fused_decoder.py`: its
custom VJP `decoder_scan` and `decoder_scan_reference`, XLA's autodiff of the same
forward), on the CPU at the TINY widths of test_torch_tacotron_train.py; the plain
versions of the four decoder kernels against the JAX functions they stand for; the
model's dispatch; and the forward without a gradient. Inputs and noise are made with
numpy from a seed and shared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.ops import fused_decoder as jfd
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.precision import weak
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.ops import decoder_vjp as dv
from tacotron2_tpu_torch.ops import fused_decoder as tfd

import test_torch_tacotron_train as tac
from test_torch_compute_dtype import _decoder_inputs, _rel
from test_torch_tacotron_train import B, LENGTHS, T_IN, _max_abs, _np, _t

F32 = np.float32


def _pair(extra=''):
    """(hp, flax variables, the port Tacotron holding them)."""
    hp = tac.make_hp(extra)
    v = tac.flax_variables(hp)
    model = Tacotron(hp)
    model.load_state_dict(convert.tacotron_state_dict(v['params'], v['batch_stats']))
    return hp, v, model


def _inputs(hp, ratio, gates, seed=7):
    """Seeded decoder inputs over 8 steps: keys, values, a ragged mask, teacher frames,
    coins at `ratio`, prenet masks at keep 0.5, the four keep-gates (None: zoneout's
    expectation) and a cotangent of each output."""
    rng = np.random.default_rng(seed)
    T = tac.T_MEL // hp.outputs_per_step
    D, M = hp.attention_dim, 2 * hp.encoder_lstm_units
    return dict(
        keys=rng.normal(size=(B, T_IN, D)).astype(F32),
        values=rng.normal(size=(B, T_IN, M)).astype(F32),
        mask=(np.arange(T_IN)[None] < LENGTHS[:, None]).astype(F32),
        teacher=rng.uniform(-4, 4, (T, B, hp.num_mels)).astype(F32),
        use=(rng.uniform(size=T) < ratio).astype(F32),
        m1=2 * (rng.uniform(size=(T, B, hp.prenet_layers[0])) < 0.5).astype(F32),
        m2=2 * (rng.uniform(size=(T, B, hp.prenet_layers[1])) < 0.5).astype(F32),
        zo=(tuple(rng.uniform(size=(T, B, hp.decoder_lstm_units)) < 0.9 for _ in range(4))
            if gates else None),
        cot=[rng.normal(size=s).astype(F32) for s in (
            (T, B, hp.num_mels * hp.outputs_per_step), (T, B, hp.outputs_per_step),
            (T, B, T_IN))])


def _jax_run(hp, v, d, fn, dt=jnp.float32):
    """The JAX decoder `fn` in `dt` on `d`: (outputs, the port-named gradients of every
    decoder parameter, dkeys, dvalues, dteacher) of a projection of its outputs."""
    cfg = jfd.config_from_hp(hp, dt, d['zo'] is None)

    def loss(p, k, vals, tch):
        outs = fn(cfg, p, k.astype(dt), vals, d['mask'], tch, d['use'],
                  jnp.asarray(d['m1'], dt), jnp.asarray(d['m2'], dt), d['zo'])
        return sum(jnp.sum(o * c) for o, c in zip(outs, d['cot'])), outs
    (_, outs), (gp, gk, gv, gt) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(v['params']['decoder'], d['keys'],
                                                    d['values'], d['teacher'])
    tree = jax.tree_util.tree_map(np.zeros_like, v['params'])
    tree['decoder'] = jax.tree_util.tree_map(np.asarray, gp)
    sd = convert.tacotron_state_dict(tree, v['batch_stats'])
    grads = {n: _np(t) for n, t in sd.items() if n.startswith('decoder.')}
    return [np.asarray(o) for o in outs], grads, [np.asarray(x, F32) for x in (gk, gv, gt)]


def _port_run(model, d, dt=torch.float32, fn=dv.fused_decoder_scan):
    """The port's decoder `fn` in `dt` on `d`: as `_jax_run`."""
    model.zero_grad()
    tk, tv, tt = (_t(d[k]).requires_grad_() for k in ('keys', 'values', 'teacher'))
    outs = fn(model.decoder, tk.to(dt), tv, _t(d['mask']), tt, _t(d['use']),
              [_t(d['m1']), _t(d['m2'])], None if d['zo'] is None else [_t(z) for z in d['zo']],
              dt)
    sum(torch.sum(o * _t(c)) for o, c in zip(outs, d['cot'])).backward()
    grads = {'decoder.' + n: _np(p.grad) for n, p in model.decoder.named_parameters()}
    return [_np(o) for o in outs], grads, [_np(x.grad) for x in (tk, tv, tt)]


def _within(want, got, tol_out=1e-5, tol_grad=2e-5):
    """Outputs within tol_out, each gradient within tol_grad of its largest entry."""
    for w, g in zip(want[0], got[0], strict=True):
        assert _max_abs(w, g) <= tol_out
    assert set(want[1]) == set(got[1])
    for name in want[1]:
        w = want[1][name]
        assert _max_abs(w, got[1][name]) <= tol_grad * float(np.abs(w).max()), name
    for w, g in zip(want[2], got[2], strict=True):
        assert _max_abs(w, g) <= tol_grad * float(np.abs(w).max())


# ---------------------------------------------------------------- the Function, f32

F32_CASES = {'ratio1-expectation': ('', 1.0, False), 'ratio0.5-gates': ('', 0.5, True),
             'smoothing': (',smoothing=True', 0.5, True),
             'no-cumulate': (',cumulative_weights=False', 0.5, True)}


@pytest.mark.parametrize('case', list(F32_CASES))
def test_fused_decoder_scan_matches_jax(case):
    """`fused_decoder_scan` over 8 steps with a ragged mask against the JAX custom VJP
    `decoder_scan` and XLA's autodiff `decoder_scan_reference`, at float32 (the port's
    conv tier against the JAX fold at B=2: the same sums): the frames, stops and
    alignments 1e-5, the gradient of a projection of the outputs with respect to every
    decoder weight, the keys, the values and the teacher frames 2e-5 of each one's
    largest entry; at ratio 1 with zoneout's expectation, at ratio 0.5 with keep-gates,
    with smoothing, and without cumulative weights. There the JAX custom VJP drops the
    new state's gradient from the alignments' (`_bwd_rule`, `:512-514`: it reads dkeys
    0.3 of their largest entry away from autodiff): the port follows autodiff, to which
    it is held, and the JAX custom VJP is shown to miss it. The port's autograd loop
    `ops/fused_decoder.decoder_scan` agrees at the same bounds."""
    extra, ratio, gates = F32_CASES[case]
    hp, v, model = _pair(extra)
    d = _inputs(hp, ratio, gates)
    got = _port_run(model, d)
    ref = _jax_run(hp, v, d, jfd.decoder_scan_reference)
    _within(ref, got)
    custom = _jax_run(hp, v, d, jfd.decoder_scan)
    if case == 'no-cumulate':
        assert _max_abs(custom[2][0], got[2][0]) > 1e-2 * float(np.abs(got[2][0]).max())
    else:
        _within(custom, got)
    _within(_port_run(model, d, fn=tfd.decoder_scan), got)
    if ratio < 1:
        assert 0 < d['use'].sum() < len(d['use']) and got[2][2][d['use'] == 0].max() == 0


# ---------------------------------------------------------------- the Function, bf16

@pytest.mark.parametrize('tier', ['folded', 'conv'])
def test_bf16_fused_decoder_scan_matches_jax(tier, monkeypatch):
    """`fused_decoder_scan` in bf16 over 8 steps (every step on its teacher frame, prenet
    masks and keep-gates: the inputs of test_torch_compute_dtype.py's
    test_bf16_decoder_scan_matches_jax) against the JAX custom VJP in bf16, on the folded
    location tier (B=2 under the default budget: both fold the conv into the location
    layer) and on the conv tier (LOC_MAT_BYTES 0 on both sides; above B=96 under the
    default budget JAX's banded `loc_m` tier rounds otherwise than the port's conv): each
    output and the gradients (every decoder weight, the keys and the values) nearer to
    JAX's bf16 than to its f32, and within 1e-2 of its f32 norm (folded: outputs read
    5.1e-3, 3.0e-3, 3.6e-3, where JAX's f32 is 6.0e-3, 3.7e-3, 4.3e-3 away; gradients
    5.2e-3 and 8.0e-3). The forward is the autograd loop's (`ops/fused_decoder.
    decoder_scan`), within 1e-3 of the f32 norm (read: equal to 3 significant digits of
    the distances; on other seeds bit for bit), so the outputs lie exactly as near JAX's
    bf16 as that loop's: on other seeds both read as far from JAX's bf16 as from its f32
    (seed 2 of `_inputs`: frames 8.0e-3 and 6.5e-3), XLA keeping excess precision where
    it fuses (test_torch_compute_dtype.py's docstring)."""
    if tier == 'conv':
        monkeypatch.setattr(jfd, 'LOC_MAT_BYTES', 0)
        monkeypatch.setattr(tfd, 'LOC_MAT_BYTES', 0)
    hp, v, model = _pair(tac.TRAIN_EXTRA)
    d = dict(_decoder_inputs(hp))
    d['zo'] = tuple(d['zo'])
    params = [model.decoder.get_parameter(n) for _, n in dv.PARAMS]
    W = dv._weights(dv._config(model.decoder, torch.bfloat16), model.decoder, params, B, T_IN)
    assert ('loc_n' in W) == (tier == 'folded')
    want = _jax_run(hp, v, d, jfd.decoder_scan, jnp.bfloat16)
    f32 = _jax_run(hp, v, d, jfd.decoder_scan)
    got = _port_run(model, d, torch.bfloat16)
    loop = _port_run(model, d, torch.bfloat16, fn=tfd.decoder_scan)

    def flat(run):
        return np.concatenate([run[1][n].ravel() for n in sorted(run[1])]
                              + [x.ravel() for x in run[2][:2]])
    for w, f, g, a in zip(want[0], f32[0], got[0], loop[0], strict=True):
        assert _rel(g, w, f) < _rel(g, f, f) and _rel(g, w, f) <= 1e-2
        assert _rel(g, a, f) <= 1e-3
    gw, gf, gg = flat(want), flat(f32), flat(got)
    assert _rel(gg, gw, gf) < _rel(gg, gf, gf) and _rel(gg, gw, gf) <= 1e-2


# ---------------------------------------------------------------- the kernels' plain versions

def _tiny(extra=''):
    hp, v, model = _pair(extra)
    cfg = dv._config(model.decoder, torch.float32)
    params = [model.decoder.get_parameter(n) for _, n in dv.PARAMS]
    W = dv._weights(cfg, model.decoder, params, B, T_IN)
    jcfg = jfd.config_from_hp(hp, jnp.float32, True)
    JW = jfd._weights(v['params']['decoder'], jcfg)   # the conv tier: nothing folded
    return hp, cfg, W, jcfg, JW


def _rel_max(want, got):
    want = np.asarray(want, np.float64)
    return _max_abs(want, got) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize('gates', [False, True])
def test_lstm_cell_plain_versions_match_jax(gates):
    """lstm_cell_fwd's and lstm_cell_bwd's plain versions (the CPU path) against the JAX
    `_lstm_fwd` with `_step_fwd`'s zoneout mix and `_lstm_bwd` with `_bwd_rule`'s
    bypasses, in f32 with keep-gates and with zoneout's expectation: 1e-6 of each
    output's largest entry."""
    rng = np.random.default_rng(3)
    U, rate = 32, 0.1
    z, c, h = (rng.normal(size=s).astype(F32) for s in ((B, 4 * U), (B, U), (B, U)))
    dha, dhb, dh, dc = (rng.normal(size=(B, U)).astype(F32) for _ in range(4))
    keeps = [rng.uniform(size=(B, U)) < 0.9 for _ in range(2)] if gates else [None, None]
    a = [np.float32(1 - rate) if k is None else k.astype(F32) for k in keeps]
    c_new, h_new = jfd._lstm_fwd(z, c)
    want = (a[0] * c_new + (1 - a[0]) * c, a[1] * h_new + (1 - a[1]) * h, h_new)
    got = dv.lstm_cell_fwd(_t(z), _t(c), _t(h), *[None if k is None else _t(k) for k in keeps],
                           rate, rate)
    for w, g in zip(want, got, strict=True):
        assert _rel_max(w, _np(g)) <= 1e-6
    dh_new = dha + dhb + a[1] * dh
    dz, dc_gates = jfd._lstm_bwd(z, c, dh_new, dc, a[0])
    want = (dz, dc_gates + (1 - a[0]) * dc, (1 - a[1]) * dh)
    keep = weak(1 - rate, torch.float32)
    got = dv.lstm_cell_bwd(_t(z), _t(c), _t(dha), _t(dhb), _t(dh), _t(dc),
                           *[None if k is None else _t(k) for k in keeps], keep, keep)
    for w, g in zip(want, got, strict=True):
        assert _rel_max(w, _np(g)) <= 1e-6


ATTENTION_CASES = {'softmax': (False, 7), 'smoothing': (True, 7), 'even-kernel': (False, 6)}


@pytest.mark.parametrize('case', list(ATTENTION_CASES))
def test_attention_plain_versions_match_jax(case):
    """attention_fwd's and attention_bwd's plain versions, with the location path of
    `_att_bwd` on the conv tier (the features and the conv's transpose as products of
    taps) and the location kernel's gradient of `_loc_kernel_grad` and of `_loc_acc`
    with `_loc_acc_finalize` (the folded tier's), against the JAX `_att_align` and
    `_att_bwd`, in f32 with a ragged mask, with softmax and with smoothing, and with an
    even kernel (SAME padding one step longer on the right): 1e-6 of each output's
    largest entry."""
    smoothing, K = ATTENTION_CASES[case]
    hp, cfg, W, jcfg, JW = _tiny(f',attention_kernel=[{K}]'
                                 + (',smoothing=True' if smoothing else ''))
    assert cfg.smoothing == jcfg.smoothing == smoothing
    rng = np.random.default_rng(5)
    D = hp.attention_dim
    keys = rng.normal(size=(B, T_IN, D)).astype(F32)
    pq = rng.normal(size=(B, D)).astype(F32)
    state = rng.uniform(0, 2, (B, T_IN)).astype(F32)
    mask = (np.arange(T_IN)[None] < LENGTHS[:, None]).astype(F32)
    dalign = rng.normal(size=(B, T_IN)).astype(F32)
    want = jfd._att_align(jcfg, JW, keys, mask, pq, state)
    pl, pl_b = dv._loc_pl(cfg, W, _t(state))
    align, new_state, _ = dv.attention_fwd(_t(keys), _t(pq), pl, pl_b, W['b_a'], W['v_a'],
                                           _t(mask), _t(state), smoothing, True)
    assert _rel_max(want, _np(align)) <= 1e-6
    assert _rel_max(np.asarray(want) + state, _np(new_state)) <= 1e-6

    (dpq, dstate, dkeys, dloc_k, dloc_b, dl_k, dva, dba) = jfd._att_bwd(
        jcfg, JW, keys, mask, pq, state, dalign)
    acc = dict(dkeys=torch.zeros(B, T_IN, D), dva=torch.zeros(B, D), dba=torch.zeros(B, D),
               dl=torch.zeros(*W['l_w'].shape))
    with torch.no_grad():
        got = dv._att_bwd(cfg, W, _t(keys), _t(mask), _t(pq), _t(state), _t(dalign),
                          torch.zeros(B, T_IN), torch.zeros(B, T_IN), acc)
    df = got[2].view(1 * B, T_IN, -1)
    K = W['loc_w'].shape[-1]
    for w, g in ((dpq, got[0]), (dstate, got[1]), (dkeys, acc['dkeys']),
                 (np.asarray(dl_k).T, acc['dl']), (np.asarray(dva)[0], acc['dva'].sum(0)),
                 (dba, acc['dba'].sum(0)), (dloc_b, df.sum((0, 1))),
                 (np.asarray(dloc_k).transpose(2, 1, 0), dv._loc_kernel_grad(K, _t(state), df)),
                 (np.asarray(dloc_k).transpose(2, 1, 0),
                  dv._loc_acc_finalize(K, dv._loc_acc(_t(state), df)))):
        assert _rel_max(w, _np(g)) <= 1e-6


def test_loc_acc_finalize_matches_jax():
    """`_loc_acc_finalize` against the JAX one on a seeded dense (T_in, T_in * F)
    accumulator, an odd and an even kernel: 1e-6 (the port's layout (F, 1, K), JAX's
    (K, 1, F))."""
    rng = np.random.default_rng(9)
    n_f = 8
    acc = rng.normal(size=(T_IN, T_IN * n_f)).astype(F32)
    for K in (7, 4):
        cfg = jfd.DecoderConfig(num_mels=4, r=1, prenet1=4, prenet2=4, units=4,
                                attention_dim=4, attention_filters=n_f, attention_kernel=K,
                                cumulate=True, smoothing=False, zoneout=0.1,
                                deterministic=True, stop_at_any=True)
        want = jfd._loc_acc_finalize(cfg, {'loc_m': 0, 'loc_k': np.zeros((K, 1, n_f))}, acc)
        got = dv._loc_acc_finalize(K, _t(acc))
        assert _rel_max(np.asarray(want).transpose(2, 1, 0), _np(got)) <= 1e-6


# ---------------------------------------------------------------- dispatch and no-grad

DISPATCH = {'default': '', 'unfused': ',fused_decoder=False',
            'depth3': ',prenet_layers=[16,16,16],decoder_layers=3',
            'one-prenet': ',prenet_layers=[16]'}


@pytest.mark.parametrize('case', list(DISPATCH))
def test_dispatch_follows_jax_use_fused(case, monkeypatch):
    """`teacher_forced` runs the Function exactly where the JAX model's `use_fused` holds
    (hp.fused_decoder and `fused_decoder.supports`), with a gradient and without one,
    and the autograd loop `ops/fused_decoder.decoder_scan` elsewhere."""
    hp = tac.make_hp(DISPATCH[case] + ',remat_decoder=True')
    fused = hp.fused_decoder and jfd.supports(hp)
    assert dv.supports(hp) == jfd.supports(hp)
    seen = []
    for mod, name in ((dv, 'fused_decoder_scan'), (tfd, 'decoder_scan')):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name, **kw:
                            seen.append(name) or fn(*a, **kw))
    model = Tacotron(hp)
    batch = tac.port_batch(tac.make_batch(hp))
    noise = model.draw_noise(B, T_IN, tac.T_MEL, torch.Generator().manual_seed(0), False,
                             'cpu')
    out = model.teacher_forced(batch['inputs'], batch['input_lengths'], batch['mel_targets'],
                               noise, deterministic=False)
    (out['mel_outputs'].sum() + out['stop_token_prediction'].sum()).backward()
    with torch.no_grad():
        model.teacher_forced(batch['inputs'], batch['input_lengths'], batch['mel_targets'],
                             noise, deterministic=True)
    assert seen == ['fused_decoder_scan' if fused else 'decoder_scan'] * 2
    assert all(p.grad is not None for p in model.decoder.parameters())


def test_no_grad_forward_keeps_no_residuals(monkeypatch):
    """Without a gradient (GTA, eval) the Function is not applied and the forward keeps no
    residuals; with one it keeps them, in the compute dtype but the float32 state, and
    the outputs' grad_fn is FusedDecoderScan's."""
    hp, v, model = _pair()
    d = _inputs(hp, 0.5, True)
    kept = []
    forward = dv._forward

    def spy(*a, **kw):
        out = forward(*a, **kw)
        kept.append(out[1])
        return out
    monkeypatch.setattr(dv, '_forward', spy)
    args = (model.decoder, _t(d['keys']), _t(d['values']), _t(d['mask']), _t(d['teacher']),
            _t(d['use']), [_t(d['m1']), _t(d['m2'])], [_t(z) for z in d['zo']])
    with torch.no_grad():
        outs = dv.fused_decoder_scan(*args, torch.bfloat16)
    assert kept == [None] and all(o.grad_fn is None for o in outs)
    outs = dv.fused_decoder_scan(*args, torch.bfloat16)
    res = kept[-1]
    assert 'FusedDecoderScan' in type(outs[0].grad_fn).__name__
    assert set(res) == {'r1', 'r2', 'z1', 'z2', 'x1', 'x2', 'c1p', 'h1p', 'c2p', 'h2p', 'ctx',
                        'state', 'pq'}
    assert all(r.dtype == (torch.float32 if k == 'state' else torch.bfloat16)
               and r.shape[0] == len(d['use']) for k, r in res.items())


def _decoder_mutant_cases():
    import chip_smoke
    return list(chip_smoke.DECODER_MUTANTS)


@pytest.mark.parametrize('fault', _decoder_mutant_cases())
def test_decoder_mutants_apply_to_the_source(fault):
    """Each planted fault of the decoder kernels (the smoke run's DECODER_MUTANTS, built on
    the card) changes exactly one place of csrc/decoder/decoder_step.cu, names only
    kernels the source defines, and is held in a dtype whose bound it must miss."""
    import os

    import chip_smoke
    from tacotron2_tpu_torch.ops import _build
    with open(os.path.join(_build.DECODER_DIR, 'decoder_step.cu'), encoding='utf-8') as f:
        source = f.read()
    kernels, dtypes, old, new = chip_smoke.DECODER_MUTANTS[fault]
    text = chip_smoke.mutated_decoder_source(fault)
    assert source.count(old) == 1 and text != source and text == source.replace(old, new)
    assert kernels and all(f'{k}_kernel(' in source for k in kernels)
    assert dtypes and all(chip_smoke.DECODER_TOL[k][dt] > 0 for k in kernels for dt in dtypes)
