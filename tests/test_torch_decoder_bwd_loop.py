"""The fused decoder's reverse recurrence as one launch (`ops/decoder_vjp.py`:
`decoder_bwd_loop`, its plain version `_decoder_bwd_loop_plain`, the step `_reverse_step`
that it shares with the step loop `_step_loop_bwd`; the kernel, csrc/decoder_bwd_loop/
decoder_bwd_loop.cu, runs only on the card) on the CPU at the TINY widths of
test_torch_tacotron_train.py: `_backward` through the loop against `_backward` through the
step loop, the Function with both loops against the JAX custom VJP (`fused_decoder.py:
494-571`, `_bwd_rule`), the dispatch of both loops at the default widths, and the smoke
run's planted faults and the wrapper's pointers against the source. Inputs are made with
numpy from a seed. The file adds about 27 s in one process (12 of them the imports).
"""

import collections
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tacotron2_tpu.ops import fused_decoder as jfd
from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.models.tacotron.model import DecoderCell
from tacotron2_tpu_torch.ops import _build
from tacotron2_tpu_torch.ops import decoder_vjp as dv

import test_torch_tacotron_train as tac
from test_torch_compute_dtype import _decoder_inputs, _rel
from test_torch_decoder_loop import LOOP_CASES
from test_torch_fused_decoder import _inputs, _jax_run, _pair, _port_run, _within
from test_torch_tacotron_train import B, T_IN, _t


def _grads(model, d, dt, loop, monkeypatch):
    """`_backward` on `d` in `dt` after the forward with residuals, the cotangents d's:
    through the reverse loop (the dispatch held to it: on CPU tensors `decoder_bwd_loop`
    runs its plain version) where `loop`, else the step loop. Returns ({name: tensor}:
    every parameter's gradient, dkeys, dvalues and dteacher)."""
    cell = model.decoder
    cfg = dv._config(cell, dt)
    params = [cell.get_parameter(n) for _, n in dv.PARAMS]
    W = dv._weights(cfg, cell, params, B, T_IN)
    monkeypatch.setattr(dv, 'loop_applies', lambda *a: loop)
    zo = None if d['zo'] is None else [_t(z) for z in d['zo']]
    args = (cfg, W, _t(d['keys']).to(dt), _t(d['values']), _t(d['mask']), _t(d['teacher']),
            _t(d['use']), [_t(d['m1']), _t(d['m2'])], zo)
    with torch.no_grad():
        (frames, _, aligns), R = dv._forward(*args, True)
        g_frames, g_stops, g_aligns = (_t(c) for c in d['cot'])
        g, dkeys, dvalues, dteacher = dv._backward(*args, frames, aligns, R, g_frames,
                                                   g_stops, g_aligns.contiguous())
    return dict(g, dkeys=dkeys, dvalues=dvalues, dteacher=dteacher)


@pytest.mark.parametrize('case', list(LOOP_CASES))
def test_bwd_loop_matches_step_loop(case, monkeypatch):
    """`_backward` through `decoder_bwd_loop` (dproj once over the T * B rows before the
    loop, the prenet's gradient once over them after it) against `_backward` through the
    step loop, after the same forward, over 8 teacher-forced steps with a ragged mask:
    every parameter's gradient, dkeys, dvalues and dteacher, in f32 (the conv location
    tier) and in bf16 (the folded one); with keep-gates, with zoneout's expectation, with
    smoothing, without cumulative weights. Both run the same step, `_reverse_step`, with
    the same plain arithmetic: bit for bit."""
    extra, dt, gates = LOOP_CASES[case]
    hp, _, model = _pair(extra)
    d = _inputs(hp, 1.0, gates)
    want = _grads(model, d, dt, False, monkeypatch)
    got = _grads(model, d, dt, True, monkeypatch)
    assert set(want) == set(got) == {k for k, _ in dv.PARAMS} | {'dkeys', 'dvalues', 'dteacher'}
    for k in want:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]), k


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_bwd_loop_matches_jax(dt, monkeypatch):
    """The Function with both loops dispatched (their plain versions, on CPU tensors)
    against the JAX custom VJP `decoder_scan` (`_bwd_rule`) over 8 teacher-forced steps
    with prenet masks and keep-gates. f32 (the conv tier, the default cumulative
    weights): the outputs within 1e-5 and every gradient within 2e-5 of its largest
    entry (`_within`, the bound of test_fused_decoder_scan_matches_jax), and the same of
    XLA's autodiff `decoder_scan_reference`. bf16 (the inputs of
    test_bf16_fused_decoder_scan_matches_jax, the folded tier on both sides): each output
    and the gradients (every decoder weight, the keys and the values) nearer to JAX's
    bf16 than to its f32, and within 1e-2 of its f32 norm (that test's bounds)."""
    monkeypatch.setattr(dv, 'loop_applies', lambda *a: True)
    launches = collections.Counter()
    for name in ('decoder_fwd_loop', 'decoder_bwd_loop'):
        def counted(*a, fn=getattr(dv, name), name=name, **k):
            launches[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(dv, name, counted)
    if dt == 'f32':
        hp, v, model = _pair()
        d = _inputs(hp, 1.0, True)
        got = _port_run(model, d)
        _within(_jax_run(hp, v, d, jfd.decoder_scan), got)
        _within(_jax_run(hp, v, d, jfd.decoder_scan_reference), got)
    else:
        hp, v, model = _pair(tac.TRAIN_EXTRA)
        d = dict(_decoder_inputs(hp))
        d['zo'] = tuple(d['zo'])
        want = _jax_run(hp, v, d, jfd.decoder_scan, jnp.bfloat16)
        f32 = _jax_run(hp, v, d, jfd.decoder_scan)
        got = _port_run(model, d, torch.bfloat16)

        def flat(run):
            return np.concatenate([run[1][n].ravel() for n in sorted(run[1])]
                                  + [x.ravel() for x in run[2][:2]])
        for w, f, g in zip(want[0], f32[0], got[0], strict=True):
            assert _rel(g, w, f) < _rel(g, f, f) and _rel(g, w, f) <= 1e-2
        gw, gf, gg = flat(want), flat(f32), flat(got)
        assert _rel(gg, gw, gf) < _rel(gg, gf, gf) and _rel(gg, gw, gf) <= 1e-2
    assert launches == {'decoder_fwd_loop': 1, 'decoder_bwd_loop': 1}


# the dispatch at the default widths, one train step's forward and backward over 2 steps
# at B=2 and 8 input steps: (compute dtype, every step on its teacher frame, an extra
# hparam) -> (whether the forward loop runs, whether the reverse loop runs)
DISPATCH = {'bf16': ('bfloat16', True, '', (True, True)),
            'f32': ('float32', True, '', (True, True)),
            'a step on its own frame': ('bfloat16', False, '', (False, False)),
            'other location filters': ('bfloat16', True, 'attention_filters=16', (False, False)),
            'a wider location kernel': ('bfloat16', True, 'attention_kernel=[65]', (False, False))}


@pytest.mark.parametrize('case', list(DISPATCH))
def test_bwd_loop_dispatch(case, monkeypatch):
    """The Function at the default widths runs `decoder_fwd_loop` and `decoder_bwd_loop`
    exactly where `loop_applies` holds, else `_step_loop` and `_step_loop_bwd`: bf16 and
    f32 with every step on its teacher frame run both loops (f32 the float32 ones); a step on its own frame, another
    number of location filters (LOOP_FILTERS) and a location kernel wider than
    LOOP_MAX_KERNEL run neither loop."""
    dtype, all_teacher, extra, want = DISPATCH[case]
    hp = default_hparams()
    if extra:
        hp.parse(extra)
    torch.manual_seed(0)
    cell = DecoderCell(hp, 2 * hp.encoder_lstm_units)
    calls = collections.Counter()
    for name in ('decoder_fwd_loop', 'decoder_bwd_loop', '_step_loop', '_step_loop_bwd'):
        def counted(*a, fn=getattr(dv, name), name=name, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(dv, name, counted)
    rng = np.random.default_rng(5)
    T, b, t_in, U = 2, 2, 8, hp.decoder_lstm_units
    keys = _t(rng.normal(size=(b, t_in, hp.attention_dim)).astype(np.float32))
    values = _t(rng.normal(size=(b, t_in, 2 * hp.encoder_lstm_units)).astype(np.float32))
    teacher = _t(rng.normal(size=(T, b, hp.num_mels)).astype(np.float32))
    use = torch.ones(T)
    if not all_teacher:
        use[1] = 0
    masks = [torch.ones(T, b, n) for n in hp.prenet_layers]
    zo = [torch.from_numpy(rng.uniform(size=(T, b, U)) < 0.9) for _ in range(4)]
    keys.requires_grad_()
    outs = dv.fused_decoder_scan(cell, keys, values, None, teacher, use, masks, zo,
                                 getattr(torch, dtype))
    sum(o.float().sum() for o in outs).backward()
    fwd, bwd = want
    assert calls == {'decoder_fwd_loop' if fwd else '_step_loop': 1,
                     'decoder_bwd_loop' if bwd else '_step_loop_bwd': 1}
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in cell.parameters())


@pytest.mark.parametrize('fault', list(chip_smoke.BWD_LOOP_MUTANTS))
def test_bwd_loop_mutants_apply_to_the_source(fault):
    """Each planted fault of the reverse loop (the smoke run's BWD_LOOP_MUTANTS, built on
    the card) changes exactly one place of csrc/decoder_bwd_loop/decoder_bwd_loop.cu."""
    path = os.path.join(_build.DECODER_BWD_LOOP_DIR, 'decoder_bwd_loop.cu')
    with open(path, encoding='utf-8') as f:
        source = f.read()
    old, new = chip_smoke.BWD_LOOP_MUTANTS[fault]
    text = chip_smoke.mutated_bwd_loop_source(fault)
    assert source.count(old) == 1 and text != source and text == source.replace(old, new)


def test_bwd_loop_pointers_follow_the_source():
    """The wrapper's pointer names, in order, are the C entry's `Ptr` enum."""
    path = os.path.join(_build.DECODER_BWD_LOOP_DIR, 'decoder_bwd_loop.cu')
    with open(path, encoding='utf-8') as f:
        source = f.read()
    enum = source[source.index('enum Ptr {') + len('enum Ptr {'):source.index('N_PTRS')]
    names = [n.strip() for n in enum.replace('\n', ' ').split(',') if n.strip()]
    py = dv._BWD_INPUTS + dv._BWD_OUTPUTS + dv._BWD_SCRATCH + dv._BWD_PROFILE
    assert len(names) == len(py)
    assert names == ['P_' + n.upper() for n in py]
