"""The fused decoder's forward recurrence as one launch (`ops/decoder_vjp.py`:
`decoder_fwd_loop`, its plain version `_decoder_fwd_loop_plain`, the dispatch
`loop_applies`; the kernel, csrc/decoder_loop/decoder_loop.cu, runs only on the card)
on the CPU at the TINY widths of test_torch_tacotron_train.py: the forward through the
loop against the step loop `_step_loop`, against the JAX forward's residuals
(`fused_decoder.py:388-416`, through `_fwd_rule`), the dispatch case by case, and the
smoke run's planted faults against the source. Inputs are made with numpy from a seed.
"""

import os

import jax
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
from test_torch_fused_decoder import _inputs, _pair
from test_torch_tacotron_train import B, T_IN, _np, _t

F32 = np.float32
RESIDUALS = ('r1', 'r2', 'z1', 'z2', 'x1', 'x2', 'c1p', 'h1p', 'c2p', 'h2p', 'ctx', 'state',
             'pq')


def _port_forward(model, d, dt, loop, monkeypatch):
    """The port's forward on `d` in `dt` with residuals: through the forward loop (the
    dispatch held to it: on CPU tensors `decoder_fwd_loop` runs its plain version) where
    `loop`, else the step loop. Returns (outputs, residuals)."""
    cell = model.decoder
    cfg = dv._config(cell, dt)
    W = dv._weights(cfg, cell, [cell.get_parameter(n) for _, n in dv.PARAMS], B, T_IN)
    args = (cfg, W, _t(d['keys']).to(dt), _t(d['values']), _t(d['mask']), _t(d['teacher']),
            _t(d['use']), [_t(d['m1']), _t(d['m2'])],
            None if d['zo'] is None else [_t(z) for z in d['zo']], True)
    with torch.no_grad():
        if not loop:
            return dv._step_loop(*args)
        monkeypatch.setattr(dv, 'loop_applies', lambda *a: True)
        return dv._forward(*args)


LOOP_CASES = {'f32-gates': ('', torch.float32, True),
              'f32-expectation': ('', torch.float32, False),
              'f32-smoothing': (',smoothing=True', torch.float32, True),
              'f32-no-cumulate': (',cumulative_weights=False', torch.float32, True),
              'bf16-gates': ('', torch.bfloat16, True),
              'bf16-expectation': ('', torch.bfloat16, False),
              'bf16-smoothing-no-cumulate': (',smoothing=True,cumulative_weights=False',
                                             torch.bfloat16, True)}


@pytest.mark.parametrize('case', list(LOOP_CASES))
def test_loop_matches_step_loop(case, monkeypatch):
    """The forward through `decoder_fwd_loop` (the prenet once over the steps, the loop,
    the frame and stop projection over the T * B rows after it) against the step loop
    over 8 teacher-forced steps with a ragged mask: the alignments and every residual bit
    for bit, in f32 (the conv location tier) and in bf16 (the folded one, which B=2
    selects); with keep-gates, with zoneout's expectation, with smoothing, without
    cumulative weights. The frames and stops formed after the loop: bf16 bit for bit
    (within the 1e-3 that test_bf16_fused_decoder_scan_matches_jax allows the forward),
    f32 within 1e-6 of their largest entry (read 4.2e-7: the CPU's one product over the
    T * B rows sums in another order than its product over each step's B rows)."""
    extra, dt, gates = LOOP_CASES[case]
    hp, _, model = _pair(extra)
    d = _inputs(hp, 1.0, gates)
    assert d['use'].all()
    (f0, s0, a0), r0 = _port_forward(model, d, dt, False, monkeypatch)
    (f1, s1, a1), r1 = _port_forward(model, d, dt, True, monkeypatch)
    assert set(r0) == set(r1) == set(RESIDUALS)
    assert torch.equal(a0, a1)
    for k in RESIDUALS:
        assert r0[k].dtype == r1[k].dtype and torch.equal(r0[k], r1[k]), k
    for want, got in ((f0, f1), (s0, s1)):
        if dt == torch.bfloat16:
            assert _rel(_np(got), _np(want), _np(want)) <= 1e-3
        assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_plain_loop_matches_step_loop_directly():
    """`_decoder_fwd_loop_plain` on the prenet's output with and without residuals: the
    same alignments, x2 and contexts, and None for the residuals without them."""
    hp, _, model = _pair()
    d = _inputs(hp, 1.0, True)
    cell = model.decoder
    cfg = dv._config(cell, torch.bfloat16)
    W = dv._weights(cfg, cell, [cell.get_parameter(n) for _, n in dv.PARAMS], B, T_IN)
    bf = torch.bfloat16
    with torch.no_grad():
        p2 = dv._prenet(W, _t(d['teacher']), _t(d['m1']).to(bf), _t(d['m2']).to(bf), bf)[2]
        args = (cfg, W, _t(d['keys']).to(bf), _t(d['values']), _t(d['mask']), p2,
                [_t(z) for z in d['zo']])
        full = dv.decoder_fwd_loop(*args, True)
        lean = dv.decoder_fwd_loop(*args, False)
    assert lean[3] is None and set(full[3]) == set(RESIDUALS) - {'r1', 'r2'}
    for a, b in zip(full[:3], lean[:3]):
        assert torch.equal(a, b)
    assert torch.equal(full[1], full[3]['x2']) and torch.equal(full[2], full[3]['ctx'])


JAX_RESIDUALS = ('r1', 'r2', 'z1', 'z2', 'x1', 'x2', 'c1p', 'h1p', 'c2p', 'h2p', 'ctx', 'state')


def _jax_forward(hp, v, d, dt):
    """The JAX fused decoder's forward residuals (`_fwd_rule`) and alignments in `dt`."""
    cfg = jfd.config_from_hp(hp, dt, d['zo'] is None)
    out, res = jax.jit(jfd._fwd_rule, static_argnums=0)(
        cfg, v['params']['decoder'], jnp.asarray(d['keys'], dt), d['values'], d['mask'],
        d['teacher'], d['use'], jnp.asarray(d['m1'], dt), jnp.asarray(d['m2'], dt), d['zo'])
    return (dict(zip(JAX_RESIDUALS, (np.asarray(r, F32) for r in res[-1]), strict=True)),
            np.asarray(out[2]))


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_loop_matches_jax_forward(dt, monkeypatch):
    """The forward through the loop against the JAX forward (`_forward` through
    `_fwd_rule`) over 8 teacher-forced steps with prenet masks and keep-gates: in f32
    every residual and the alignments within 1e-5 of each one's largest entry (the bound
    of test_fused_decoder_scan_matches_jax); in bf16 (the inputs of
    test_bf16_fused_decoder_scan_matches_jax, the folded tier on both sides) each within
    1e-2 of the L2 norm of JAX's f32 one (that test's bound)."""
    hp, v, model = _pair(tac.TRAIN_EXTRA)
    if dt == 'f32':
        d = _inputs(hp, 1.0, True)
        (_, _, aligns), R = _port_forward(model, d, torch.float32, True, monkeypatch)
        want, want_aligns = _jax_forward(hp, v, d, jnp.float32)
        for k in JAX_RESIDUALS:
            w = want[k]
            assert np.abs(_np(R[k].float()) - w).max() <= 1e-5 * np.abs(w).max(), k
        assert np.abs(_np(aligns) - want_aligns).max() <= 1e-5 * np.abs(want_aligns).max()
        return
    d = dict(_decoder_inputs(hp))
    d['zo'] = tuple(d['zo'])
    (_, _, aligns), R = _port_forward(model, d, torch.bfloat16, True, monkeypatch)
    want, want_aligns = _jax_forward(hp, v, d, jnp.bfloat16)
    f32, f32_aligns = _jax_forward(hp, v, d, jnp.float32)
    for k in JAX_RESIDUALS:
        assert _rel(_np(R[k].float()), want[k], f32[k]) <= 1e-2, k
    assert _rel(_np(aligns), want_aligns, f32_aligns) <= 1e-2


# the dispatch at the default widths: (compute dtype, B, T_in, every step on its teacher
# frame, an extra hparam) -> whether the forward loop runs (float32: the float32 loop, on
# the conv tier)
DISPATCH = {'bf16-B32': ('bfloat16', 32, 100, True, '', True),
            'bf16-B1': ('bfloat16', 1, 100, True, '', True),
            'bf16-T_in181': ('bfloat16', 32, 181, True, '', True),
            'f32': ('float32', 32, 100, True, '', True),
            'B33': ('bfloat16', 33, 100, True, '', False),
            'B97-unfolded': ('bfloat16', 97, 100, True, '', False),
            'T_in182-unfolded': ('bfloat16', 32, 182, True, '', False),
            'a step on its own frame': ('bfloat16', 32, 100, False, '', False),
            'another width': ('bfloat16', 32, 100, True, 'attention_dim=64', False)}


@pytest.fixture(scope='module')
def cells():
    """The decoder cell at the default widths and at one narrower attention, seeded."""
    out = {}
    for extra in ('', 'attention_dim=64'):
        hp = default_hparams()
        if extra:
            hp.parse(extra)
        torch.manual_seed(0)
        out[extra] = (hp, DecoderCell(hp, 2 * hp.encoder_lstm_units))
    return out


@pytest.mark.parametrize('case', list(DISPATCH))
def test_fwd_loop_dispatch(case, cells):
    """`loop_applies` case by case: bf16 on the folded tier with every step on its
    teacher frame at LOOP_WIDTHS and B <= 32 takes the forward loop (T_in 181, the fold's
    largest at D=128, too), and so does f32 there (the float32 loop, on the conv tier);
    B=33 (folded, above the kernels' 32 rows), B=97 and T_in=182 in bf16 (not folded), a
    step on its own frame and another attention width do not."""
    dtype, b, t_in, all_teacher, extra, want = DISPATCH[case]
    hp, cell = cells[extra]
    dt = getattr(torch, dtype)
    cfg = dv._config(cell, dt)
    W = dv._weights(cfg, cell, [cell.get_parameter(n) for _, n in dv.PARAMS], b, t_in)
    assert ('loc_n' in W) == (dt == torch.bfloat16 and b <= 96 and t_in <= 181)
    keys = torch.zeros(b, t_in, hp.attention_dim, dtype=dt)
    values = torch.zeros(b, t_in, 2 * hp.encoder_lstm_units)
    use = torch.ones(8)
    if not all_teacher:
        use[3] = 0
    assert dv.loop_applies(cfg, W, keys, values, use) is want


@pytest.mark.parametrize('fault', list(chip_smoke.LOOP_MUTANTS))
def test_loop_mutants_apply_to_the_source(fault):
    """Each planted fault of the forward loop (the smoke run's LOOP_MUTANTS, built on the
    card) changes exactly one place of csrc/decoder_loop/decoder_loop.cu."""
    with open(os.path.join(_build.DECODER_LOOP_DIR, 'decoder_loop.cu'), encoding='utf-8') as f:
        source = f.read()
    old, new = chip_smoke.LOOP_MUTANTS[fault]
    text = chip_smoke.mutated_loop_source(fault)
    assert source.count(old) == 1 and text != source and text == source.replace(old, new)


def test_loop_pointers_follow_the_source():
    """The wrapper's pointer names, in order, are the C entry's `Ptr` enum."""
    with open(os.path.join(_build.DECODER_LOOP_DIR, 'decoder_loop.cu'), encoding='utf-8') as f:
        source = f.read()
    enum = source[source.index('enum Ptr {') + len('enum Ptr {'):source.index('N_PTRS')]
    names = [n.strip() for n in enum.replace('\n', ' ').split(',') if n.strip()]
    py = (dv._LOOP_INPUTS + dv._LOOP_OUTPUTS + dv._LOOP_RESIDUALS + dv._LOOP_SCRATCH
          + dv._LOOP_PROFILE)
    assert len(names) == len(py)
    c_of = {'g1_w': 'G1', 'g1_b': 'G1B', 'g2_w': 'G2', 'g2_b': 'G2B', 'q_w': 'QW',
            'loc_nt': 'LOCNT', 'pl_b': 'PLB', 'v_a': 'VA', 'b_a': 'BA'}
    assert names == ['P_' + c_of.get(n, n.upper()) for n in py]
