"""The fused decoder's float32 reverse recurrence as one launch (`ops/decoder_vjp.py`:
`decoder_bwd_loop` at float32, its plain version `_decoder_bwd_loop_plain` on the conv
location tier; the kernel, csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu, runs only on
the card) on the CPU at the TINY widths of test_torch_tacotron_train.py: the Function with
both loops against the JAX custom VJP (`fused_decoder.py:494-571`, `_bwd_rule`, and at an
input length past JAX's float32 fold its conv transpose, `:315-337`), against autograd
where that rule drops the state's gradient, the loop against the step loop `_step_loop_bwd`
on the same residuals, and the smoke run's planted faults, the wrapper's pointers and its
limits against the source. Inputs are made with numpy from a seed.
"""

import collections
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from tacotron2_tpu.ops import fused_decoder as jfd
from tacotron2_tpu_torch.ops import _build
from tacotron2_tpu_torch.ops import decoder_vjp as dv
from tacotron2_tpu_torch.ops import fused_decoder as tfd

from test_torch_decoder_loop_f32 import T_IN_CONV, _inputs_at
from test_torch_fused_decoder import _inputs, _jax_run, _pair, _port_run, _within
from test_torch_tacotron_train import B, T_IN, _t


def _source():
    with open(os.path.join(_build.DECODER_BWD_LOOP_F32_DIR, 'decoder_bwd_loop_f32.cu'),
              encoding='utf-8') as f:
        return f.read()


def _both_loops(monkeypatch):
    """Hold the dispatch to both loops (on CPU tensors each wrapper runs its plain version)
    and count the loops' calls and the step loops'."""
    monkeypatch.setattr(dv, 'loop_applies', lambda *a: True)
    calls = collections.Counter()
    for name in ('decoder_fwd_loop', 'decoder_bwd_loop', '_step_loop', '_step_loop_bwd'):
        def counted(*a, fn=getattr(dv, name), name=name, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(dv, name, counted)
    return calls


def _row(d, b):
    """The inputs `d` cut to batch row b: one row."""
    out = dict(d)
    for k in ('keys', 'values', 'mask'):
        out[k] = d[k][b:b + 1]
    for k in ('teacher', 'm1', 'm2'):
        out[k] = d[k][:, b:b + 1]
    out['zo'] = None if d['zo'] is None else tuple(z[:, b:b + 1] for z in d['zo'])
    out['cot'] = [c[:, b:b + 1] for c in d['cot']]
    return out


# (an extra hparam, keep-gates, input steps, one row)
JAX_CASES = {'gates': ('', True, T_IN, False),
             'expectation': ('', False, T_IN, False),
             'smoothing': (',smoothing=True', True, T_IN, False),
             'B1': ('', True, T_IN, True),
             'T_in528-conv': ('', True, T_IN_CONV, False)}


@pytest.mark.parametrize('case', list(JAX_CASES))
def test_f32_bwd_loop_matches_jax(case, monkeypatch):
    """`FusedDecoderScan` at float32 with both loops dispatched (their plain versions, on
    CPU tensors) against the JAX custom VJP `decoder_scan` over 8 teacher-forced steps with
    prenet masks and a ragged mask: the frames, stops and alignments within 1e-5 and the
    gradient of a projection of them with respect to every decoder weight, the keys, the
    values and the teacher frames within 2e-5 of each one's largest entry (`_within`, the
    bound of test_fused_decoder_scan_matches_jax); with keep-gates, with zoneout's
    expectation, with smoothing, at one row, and at 528 input steps, where the JAX side
    leaves its banded location matrices for the conv and its transpose."""
    extra, gates, t_in, one_row = JAX_CASES[case]
    hp, v, model = _pair(extra)
    d = _inputs(hp, 1.0, gates) if t_in == T_IN else _inputs_at(hp, t_in, gates)
    if one_row:
        d = _row(d, 1)  # the shorter row: its mask is ragged
    assert d['mask'] is not None and 0 < d['mask'].sum() < d['mask'].size
    calls = _both_loops(monkeypatch)
    got = _port_run(model, d)
    assert calls == {'decoder_fwd_loop': 1, 'decoder_bwd_loop': 1}
    _within(_jax_run(hp, v, d, jfd.decoder_scan), got)


def test_f32_bwd_loop_without_cumulative_weights_matches_autograd(monkeypatch):
    """Without cumulative weights the JAX custom VJP drops the new state's gradient from
    the alignments' (`_bwd_rule`, `:512-514`), which the port keeps: the Function with both
    loops dispatched is held to autograd over the port's step loop (`ops/fused_decoder.
    decoder_scan`) and to XLA's autodiff `decoder_scan_reference`, at the bounds of
    `_within`, and reads the custom VJP's keys gradient more than 1e-2 of its largest entry
    away."""
    hp, v, model = _pair(',cumulative_weights=False')
    d = _inputs(hp, 1.0, True)
    calls = _both_loops(monkeypatch)
    got = _port_run(model, d)
    assert calls == {'decoder_fwd_loop': 1, 'decoder_bwd_loop': 1}
    _within(_port_run(model, d, fn=tfd.decoder_scan), got)
    _within(_jax_run(hp, v, d, jfd.decoder_scan_reference), got)
    custom = _jax_run(hp, v, d, jfd.decoder_scan)
    assert np.abs(custom[2][0] - got[2][0]).max() > 1e-2 * float(np.abs(got[2][0]).max())


# (an extra hparam, keep-gates)
STEP_LOOP_CASES = {'gates': ('', True), 'expectation': ('', False),
                   'smoothing': (',smoothing=True', True),
                   'no-cumulate': (',cumulative_weights=False', True)}


@pytest.mark.parametrize('case', list(STEP_LOOP_CASES))
def test_f32_bwd_loop_matches_step_loop(case):
    """`decoder_bwd_loop` at float32 (its plain version, on CPU tensors) against the step
    loop `_step_loop_bwd` on the same residuals of the float32 forward loop (its plain
    version) over 8 teacher-forced steps with a ragged mask: dz1, dz2, dpq, the total
    context gradient and the location features' gradient of every step, and the
    accumulators dkeys, dva, dba and dl, within 1e-6 of each one's largest entry (din1
    formed from the context's columns on, not from the whole of g1); with keep-gates,
    with zoneout's expectation, with smoothing, without cumulative weights."""
    extra, gates = STEP_LOOP_CASES[case]
    hp, _, model = _pair(extra)
    d = _inputs(hp, 1.0, gates)
    cell = model.decoder
    cfg = dv._config(cell, torch.float32)
    W = dv._weights(cfg, cell, [cell.get_parameter(n) for _, n in dv.PARAMS], B, T_IN)
    keys, values, mask = _t(d['keys']), _t(d['values']), _t(d['mask'])
    teacher, use = _t(d['teacher']), _t(d['use'])
    masks = [_t(d['m1']), _t(d['m2'])]
    zo = None if d['zo'] is None else [_t(z) for z in d['zo']]
    gate_list = [None] * 4 if zo is None else [z.bool() for z in zo]
    with torch.no_grad():
        p2 = dv._prenet(W, teacher, *masks, torch.float32)[2]
        R = dv.decoder_fwd_loop(cfg, W, keys, values, mask, p2, gate_list, True)[3]
        g_frames, g_stops, g_aligns = (_t(c) for c in d['cot'])
        dfs = torch.cat([g_frames, g_stops], -1)
        loop = dv.decoder_bwd_loop(cfg, W, keys, values, mask, R, dfs @ W['fs_w'], g_aligns,
                                   gate_list)
        relu = [torch.ones_like(m) for m in masks]  # no step feeds its prenet back
        E, acc = dv._step_loop_bwd(cfg, W, keys, values, mask, R, dfs.clone(), dfs.clone(),
                                   g_aligns, [True] * len(use), gate_list, *relu)
    want = [E[k] for k in ('dz1', 'dz2', 'dpq', 'dctx_total', 'df')]
    want += [acc[k] for k in ('dkeys', 'dva', 'dba', 'dl')]
    assert len(loop) == len(want) == 9
    for name, g, w in zip(dv._BWD_OUTPUTS, loop, want, strict=True):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape, name
        scale = float(w.abs().max())
        assert scale > 0 and float((g - w).abs().max()) <= 1e-6 * scale, name


def test_f32_bwd_loop_pointers_follow_the_source():
    """The wrapper's pointer names, in order, are the C entry's `Ptr` enum."""
    source = _source()
    enum = source[source.index('enum Ptr {') + len('enum Ptr {'):source.index('N_PTRS')]
    names = [n.strip() for n in enum.replace('\n', ' ').split(',') if n.strip()]
    py = dv._BWD_F32_INPUTS + dv._BWD_OUTPUTS + dv._BWD_F32_SCRATCH + dv._BWD_PROFILE
    assert len(names) == len(py)
    assert names == ['P_' + n.upper() for n in py]


def test_f32_bwd_loop_limits_follow_the_source():
    """The limits the wrapper and the dispatch check are those the kernel is built for:
    the widths, the location filters, the widest location kernel, the batch and the input
    steps (the float32 forward loop's, so that every float32 batch that runs that loop runs
    this one too)."""
    source = _source()

    def const(name):
        return int(re.search(rf'\b{name} = (\d+)', source).group(1))
    assert tuple(const(n) for n in ('U', 'P', 'E', 'D')) == dv.LOOP_WIDTHS
    assert const('F') == dv.LOOP_FILTERS and const('MAX_K') == dv.LOOP_MAX_KERNEL
    assert const('MAX_B') == dv.LOOP_MAX_BATCH
    assert const('MAX_T_IN') == dv.LOOP_F32_MAX_T_IN


@pytest.mark.parametrize('fault', list(chip_smoke.F32_BWD_LOOP_MUTANTS))
def test_f32_bwd_loop_mutants_apply_to_the_source(fault):
    """Each planted fault of the float32 reverse loop (the smoke run's F32_BWD_LOOP_MUTANTS,
    built on the card) changes exactly one place of
    csrc/decoder_bwd_loop_f32/decoder_bwd_loop_f32.cu."""
    source = _source()
    old, new = chip_smoke.F32_BWD_LOOP_MUTANTS[fault]
    text = chip_smoke.mutated_bwd_loop_f32_source(fault)
    assert source.count(old) == 1 and text != source and text == source.replace(old, new)
