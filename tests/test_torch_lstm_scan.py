"""The encoder's bidirectional zoneout-LSTM recurrence (`ops/lstm_scan.py`: `LSTMScan`, its
plain versions `_lstm_step_loop` and `_lstm_step_loop_bwd`; the kernels, csrc/lstm_loop/
lstm_loop.cu, run only on the card) on the CPU at small widths (U = 16, C = 32, B = 3, T = 9,
ragged lengths): the module against the JAX `BiZoneoutLSTM` and its VJP in f32 and at compute
dtype bf16, the training form against autograd through the loop it replaced, the plain loop
against that loop bit for bit, the dispatch, the parameter names and the checkpoint round
trip, and the source's limits, pointers and planted faults against the wrapper and the smoke
run. Inputs are made with numpy from a seed; each test states its tolerance.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tacotron2_tpu.config import default_hparams
from tacotron2_tpu.models.tacotron import modules as jmod
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.models.tacotron import modules as tmod
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.ops import _build
from tacotron2_tpu_torch.ops import lstm_scan as ls

from test_torch_tacotron import TINY, randomize

U, C, B, T = 16, 32, 3, 9
LENGTHS = np.asarray([9, 6, 2], np.int32)
ZONEOUT = 0.1


def _source():
    with open(os.path.join(_build.LSTM_LOOP_DIR, 'lstm_loop.cu'), encoding='utf-8') as f:
        return f.read()


def _rel(a, b):
    """The largest error of a against b, relative to b's largest entry."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _module(rng, zoneout=ZONEOUT):
    """A BiZoneoutLSTM (C -> U a direction) with seeded weights: kernels N(0, 1/fan_in), the
    biases N(0, 0.3)."""
    rnn = tmod.BiZoneoutLSTM(C, U, zoneout)
    with torch.no_grad():
        for cell in (rnn.fw, rnn.bw):
            cell.gates.weight.copy_(torch.from_numpy(
                rng.normal(0, (C + U) ** -0.5, (4 * U, C + U)).astype(np.float32)))
            cell.gates.bias.copy_(torch.from_numpy(rng.normal(0, 0.3, 4 * U).astype(np.float32)))
    return rnn


def _keeps(rng, rate=ZONEOUT):
    """The four (T, B, U) bool keep-masks of training, forward c and h, backward c and h."""
    return [torch.from_numpy(rng.uniform(size=(T, B, U)) >= rate) for _ in range(4)]


def _pre_run(cell, seq, mask, keeps, dtype):
    """The port's `BiZoneoutLSTM._run` before it went through ops/lstm_scan, kept here to hold
    `_lstm_step_loop` and `LSTMScan` to it."""
    Bn, Tn, Cn = seq.shape
    K = cell.gates.weight.t().to(dtype)
    xp = seq.to(dtype) @ K[:Cn] + cell.gates.bias.to(dtype)
    Kh = K[Cn:].to(seq.dtype)
    zc, zh = cell.zoneout_cell, cell.zoneout_output
    c, h = cell.initial_state(Bn, seq.device, seq.dtype)
    outs = []
    for t in range(Tn):
        c_new, h_new = tmod.lstm_gates(xp[:, t] + h @ Kh, c)
        kc, kh = (None, None) if keeps is None else (keeps[0][t], keeps[1][t])
        m = mask[:, t, None] > 0
        c = torch.where(m, tmod.zoneout(c_new, c, zc, kc), c)
        h = torch.where(m, tmod.zoneout(h_new, h, zh, kh), h)
        outs.append(h_new * mask[:, t, None])
    return torch.stack(outs, dim=1)


def _pre_forward(rnn, x, lengths, keeps, dtype):
    """The port's BiZoneoutLSTM.forward before it went through ops/lstm_scan."""
    mask = tmod.length_mask(lengths, x.shape[1], x.device)
    fw_keeps, bw_keeps = (None, None) if keeps is None else (keeps[:2], keeps[2:])
    fw = _pre_run(rnn.fw, x, mask, fw_keeps, dtype)
    bw = tmod.reverse_sequences(_pre_run(rnn.bw, tmod.reverse_sequences(x, lengths), mask,
                                         bw_keeps, dtype), lengths)
    return torch.cat([fw, bw], dim=-1)


# (forward, gradients) bounds against JAX, relative to each tensor's largest entry. f32 read
# 1.9e-7 and 7.5e-7 (the same function, f32 sums in another order); bf16 read 1.9e-7 and
# 1.1e-2, the latter in the bias's and W_hh's gradients, bf16 values rounded from f32 sums
# in another order (JAX's scan rounds each step's W_hh gradient to bf16): one or two bf16
# steps (2**-7 = 7.8e-3) of the largest entry
JAX_TOL = {torch.float32: (1e-6, 5e-6), torch.bfloat16: (1e-2, 2e-2)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_module_matches_jax_bizoneout_lstm(dtype):
    """BiZoneoutLSTM (through LSTMScan on its plain versions) against the JAX BiZoneoutLSTM in
    its deterministic form (zoneout's expectation) with ragged lengths, the JAX parameters
    carried across by convert.py: the output, and the gradients of a seeded projection of it
    through jax.vjp with respect to the parameters and x, within JAX_TOL; padding zero."""
    rng = np.random.default_rng(20)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jrnn = jmod.BiZoneoutLSTM(U, ZONEOUT, jdt)
    lengths = jnp.asarray(LENGTHS)
    v = randomize(jax.eval_shape(jrnn.init, jax.random.PRNGKey(0), x, lengths), rng)
    out, vjp = jax.vjp(lambda p, xs: jrnn.apply({'params': p}, xs, lengths), v['params'],
                       jnp.asarray(x))
    cot = rng.normal(size=out.shape).astype(np.float32)
    jp, jx = vjp(jnp.asarray(cot))

    rnn = tmod.BiZoneoutLSTM(C, U, ZONEOUT)
    rnn.load_state_dict(convert.tacotron_state_dict(v['params'], {}))
    tx = torch.from_numpy(x).requires_grad_()
    got = rnn(tx, torch.from_numpy(LENGTHS), None, dtype)
    f_tol, g_tol = JAX_TOL[dtype]
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), np.asarray(out, np.float32)) <= f_tol
    for b, n in enumerate(LENGTHS):
        assert not got[b, n:].any()
    (got * torch.from_numpy(cot)).sum().backward()
    assert _rel(tx.grad.numpy(), np.asarray(jx, np.float32)) <= g_tol
    for d in ('fw', 'bw'):
        cell, j = getattr(rnn, d), jp[d]['gates']
        assert _rel(cell.gates.weight.grad.numpy(), np.asarray(j['kernel'], np.float32).T) <= g_tol
        assert _rel(cell.gates.bias.grad.numpy(), np.asarray(j['bias'], np.float32)) <= g_tol


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('train', [True, False])
def test_function_matches_autograd_through_the_loop_it_replaced(train, dtype):
    """BiZoneoutLSTM through LSTMScan, with seeded keep-masks (each direction's indexed by its
    own scan step) or zoneout's expectation, against autograd through the port's loop as it
    stood (`_pre_forward`), at compute dtype f32 and bf16 with ragged lengths: the output and
    the gradients of x and of each gate kernel and bias bit for bit (the plain reverse
    recurrence does autograd's arithmetic in autograd's order, and the backward direction's
    input half sums its rows in the reversed sequence's order, as before)."""
    rng = np.random.default_rng(21)
    rnn = _module(rng)
    keeps = _keeps(rng) if train else None
    x = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    lengths = torch.from_numpy(LENGTHS)
    cot = torch.from_numpy(rng.normal(size=(B, T, 2 * U)).astype(np.float32))
    leaves = [x.requires_grad_()] + list(rnn.parameters())
    got = rnn(x, lengths, keeps, dtype)
    want = _pre_forward(rnn, x, lengths, keeps, dtype)
    assert torch.equal(got, want)
    g1 = torch.autograd.grad((got * cot).sum(), leaves)
    g2 = torch.autograd.grad((want * cot).sum(), leaves)
    for a, b in zip(g1, g2, strict=True):
        assert torch.equal(a, b)


def test_training_form_differs_by_direction_step():
    """The reversed direction reads its keep-masks at its own scan step: the module's output
    with the backward masks reversed within the lengths (as if read at the sequence
    position) differs from it beyond 1e-3 (read 0.66); read by step it equals the loop as
    it stood."""
    rng = np.random.default_rng(22)
    rnn = _module(rng)
    keeps = _keeps(rng)
    x = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    lengths = torch.from_numpy(LENGTHS)
    at_pos = [tmod.reverse_sequences(k.transpose(0, 1), lengths).transpose(0, 1)
              for k in keeps[2:]]
    with torch.no_grad():
        got = rnn(x, lengths, keeps)
        moved = rnn(x, lengths, keeps[:2] + at_pos)
    assert torch.equal(got, _pre_forward(rnn, x, lengths, keeps, torch.float32))
    assert _rel(moved[..., U:].numpy(), got[..., U:].numpy()) > 1e-3


@pytest.mark.parametrize('train', [True, False])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_step_loop_is_the_loop_it_replaced(dtype, train):
    """`_lstm_step_loop` bit for bit the port's `_run` as it stood (`_pre_run`), both
    directions (the reversed on each row's reversed sequence), with and without keep-masks,
    at compute dtype bf16 and f32; the residuals are those of the same steps."""
    rng = np.random.default_rng(23)
    rnn = _module(rng)
    keeps = _keeps(rng) if train else None
    x = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    lengths = torch.from_numpy(LENGTHS)
    mask = tmod.length_mask(lengths, T, 'cpu')
    with torch.no_grad():
        seqs = (x, tmod.reverse_sequences(x, lengths))
        for d, (cell, seq) in enumerate(zip((rnn.fw, rnn.bw), seqs)):
            xp, w = tmod.BiZoneoutLSTM.operands(cell, seq, dtype)
            k = None if keeps is None else keeps[2 * d:2 * d + 2]
            got, res = ls._lstm_step_loop(xp, w, mask, k, ZONEOUT, ZONEOUT, torch.float32, True)
            assert torch.equal(got, _pre_run(cell, seq, mask, k, dtype))
            assert res.shape == (len(ls.RESIDUALS), B, T, U) and res.dtype == torch.float32
            assert torch.equal(res[ls.RESIDUALS.index('h'), :, 0], torch.zeros(B, U))


@pytest.mark.parametrize('train', [True, False])
def test_step_loop_bwd_matches_autograd(train):
    """`_lstm_step_loop_bwd` on `_lstm_step_loop`'s residuals against autograd through
    `_lstm_step_loop` (f32, ragged mask, a seeded cotangent, keep-masks or zoneout's
    expectation, rates 0.1 and 0.2): dz (xp's gradient) and its dW_hh bit for bit; dW_hh as
    the kernel path forms it after the launch (`weight_grad`, one product over the B T rows)
    within 1e-6 of autograd's largest entry (read 1.2e-7: the same terms summed in another
    order)."""
    rng = np.random.default_rng(24)
    xp = torch.from_numpy(rng.normal(size=(B, T, 4 * U)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.normal(0, U ** -0.5, (U, 4 * U)).astype(np.float32)).requires_grad_()
    mask = tmod.length_mask(torch.from_numpy(LENGTHS), T, 'cpu')
    keeps = _keeps(rng)[:2] if train else None
    out, res = ls._lstm_step_loop(xp, w, mask, keeps, 0.1, 0.2, torch.float32, save=True)
    cot = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    want = torch.autograd.grad((out * cot).sum(), (xp, w))
    dz, dw = ls._lstm_step_loop_bwd(cot, res.detach(), w.detach(), mask, keeps, 0.1, 0.2)
    assert torch.equal(dz, want[0]) and torch.equal(dw, want[1])
    assert _rel(ls.weight_grad(dz, res.detach()).numpy(), want[1].numpy()) <= 1e-6


def test_no_grad_forward_saves_nothing(monkeypatch):
    """Without a gradient to take, lstm_scan runs the forward alone without residuals; with
    one, through LSTMScan with them. On CPU tensors both run the plain version."""
    rng = np.random.default_rng(25)
    rnn = _module(rng)
    x = torch.from_numpy(rng.normal(size=(B, T, C)).astype(np.float32))
    saves = []
    plain = ls._lstm_fwd_loop_plain

    def counted(*a):
        saves.append(a[-1])
        return plain(*a)
    monkeypatch.setattr(ls, '_lstm_fwd_loop_plain', counted)
    with torch.no_grad():
        rnn(x, torch.from_numpy(LENGTHS))
    rnn(x, torch.from_numpy(LENGTHS))
    assert saves == [False, True] and not ls.LAUNCHES


def test_lstm_loop_applies():
    """The kernels take the default and paper encoder_lstm_units (256) with a float32 state
    and W_hh in f32 or bf16, on the card only; another width, a bf16 state, an f16 W_hh or the
    CPU take the plain versions."""
    U0 = default_hparams().encoder_lstm_units
    assert U0 == ls.LSTM_LOOP_UNITS == 256
    f32, bf16 = torch.float32, torch.bfloat16
    for wdt in (f32, bf16):
        assert ls.lstm_loop_applies(U0, f32, wdt, 'cuda')
        assert ls.lstm_loop_applies(U0, f32, wdt, torch.device('cuda', 0))
        assert not ls.lstm_loop_applies(U0, f32, wdt, 'cpu')
        assert not ls.lstm_loop_applies(128, f32, wdt, 'cuda')
        assert not ls.lstm_loop_applies(U, f32, wdt, 'cuda')
        assert not ls.lstm_loop_applies(U0, bf16, wdt, 'cuda')
    assert not ls.lstm_loop_applies(U0, f32, torch.float16, 'cuda')


def test_wrapper_refuses_what_the_build_does_not_take(monkeypatch):
    """The launch's checks name the numbers: another width, a third direction, a W_hh in
    another dtype than due, keep-masks of another shape; what it takes becomes the entry's
    ints (the rates as float32 bits) with the rows the occupancy allows."""
    clusters = {1: 4, 2: 9, 4: 16, 8: 16}
    monkeypatch.setattr(ls, 'occupancy', lambda rows, bf16, forward: clusters[rows])
    U0, dev = ls.LSTM_LOOP_UNITS, torch.device('cpu')
    w, lengths = torch.zeros(U0, 4 * U0), torch.tensor([5, 3])
    two = ((0.1, 0.1), (0.1, 0.1))
    with pytest.raises(ValueError, match=r'\(256, 1024\)'):
        ls._prepared(2, 5, torch.float32, dev, [torch.zeros(64, 256)], lengths, None,
                     two[:1], (False,), True)
    with pytest.raises(ValueError, match='3 directions'):
        ls._prepared(2, 5, torch.float32, dev, [w] * 3, lengths, None, two + two[:1],
                     (False,) * 3, True)
    with pytest.raises(ValueError, match='bfloat16'):
        ls._prepared(2, 5, torch.bfloat16, dev, [w] * 2, lengths, None, two, (False, True),
                     True)
    keeps = [(torch.ones(5, 2, 8, dtype=torch.bool),) * 2] * 2
    with pytest.raises(ValueError, match=r'\(5, 2, 256\)'):
        ls._prepared(2, 5, torch.float32, dev, [w] * 2, lengths, keeps, two, (False, True),
                     True)
    with pytest.raises(ValueError, match='lengths'):
        ls._prepared(2, 5, torch.float32, dev, [w] * 2, torch.tensor([5]), None, two,
                     (False, True), True)
    t, ints = ls._prepared(2, 5, torch.bfloat16, dev, [w.bfloat16()] * 2, lengths, None,
                           ((0.1, 0.2), (0.0, 0.5)), (False, True), True)
    assert ints[:7] == (2, 5, 2, 0, 1, 1, 1) and t['lengths'].dtype == torch.int32
    rates = np.asarray(ints[7:], np.int32).view(np.float32)
    assert rates.tolist() == np.float32([0.9, 0.1, 0.8, 0.2, 1.0, 0.0, 0.5, 0.5]).tolist()
    assert ls.rows_per_cluster(32, 2, False, True) == 4
    assert ls.rows_per_cluster(3, 2, False, True) == 2
    assert ls.rows_per_cluster(256, 2, True, False) == 8


def test_parameter_names_and_checkpoint_round_trip(tmp_path):
    """The encoder LSTM keeps its parameter names (a checkpoint of the port from before the
    Function loads, and convert.py carries flax's weights across unchanged): a JAX Tacotron's
    encoder_lstm converts onto encoder_lstm.{fw,bw}.gates.*, a checkpoint of it saves and
    loads bit for bit, and the loaded module's output is the converted one's."""
    hp = default_hparams()
    hp.parse(TINY)
    taco = Tacotron(hp)
    keys = [k for k in taco.state_dict() if k.startswith('encoder_lstm')]
    assert keys == [f'encoder_lstm.{d}.gates.{p}' for d in ('fw', 'bw')
                    for p in ('weight', 'bias')]
    rng = np.random.default_rng(26)
    Cn, Un = hp.enc_conv_channels, hp.encoder_lstm_units
    x = rng.normal(size=(2, 7, Cn)).astype(np.float32)
    jrnn = jmod.BiZoneoutLSTM(Un, hp.tacotron_zoneout_rate)
    v = randomize(jax.eval_shape(jrnn.init, jax.random.PRNGKey(0), x,
                                 jnp.asarray([7, 4])), rng)
    sd = {f'encoder_lstm.{k}': t for k, t in convert.tacotron_state_dict(v['params'], {}).items()}
    assert sorted(sd) == sorted(keys)
    path = str(tmp_path / 'taco.pt')
    convert.save_checkpoint(path, 'tacotron', {**taco.state_dict(), **sd})
    back = convert.load_checkpoint(path, 'tacotron')
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    taco.load_state_dict(back)
    want = jrnn.apply(v, x, jnp.asarray([7, 4]))
    with torch.no_grad():
        got = taco.encoder_lstm(torch.from_numpy(x), torch.tensor([7, 4]))
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-6


def test_limits_and_pointers_follow_the_source():
    """The wrapper's width, cluster, rows, directions, residual planes, entry names and
    pointer names, in order, are the source's."""
    source = _source()

    def const(name):
        return int(re.search(rf'\bconstexpr int {name} = (\w+)', source).group(1))

    def enum(name):
        body = source[source.index(f'enum {name} {{') + len(f'enum {name} {{'):]
        return [n.strip() for n in body[:body.index('}')].replace('\n', ' ').split(',')]
    assert const('U') == ls.LSTM_LOOP_UNITS and const('N') == ls.LSTM_LOOP_CLUSTER
    assert const('MAX_DIRS') == ls.LSTM_LOOP_MAX_DIRS
    assert const('MAX_ROWS') == ls.LSTM_LOOP_ROWS[-1]
    assert [int(r) for r in re.findall(r'case (\d+): return launch_rows', source)] \
        == list(ls.LSTM_LOOP_ROWS[:-1])
    assert enum('FwdPtr') == ['FWD_' + n.upper() for n in ls._FWD_PTRS] + ['N_FWD_PTRS']
    assert enum('BwdPtr') == ['BWD_' + n.upper() for n in ls._BWD_PTRS] + ['N_BWD_PTRS']
    assert enum('Res') == ['R_' + n.upper() for n in ls.RESIDUALS] + ['N_RES']
    assert re.findall(r'extern "C" int t2_(\w+)\(', source) == [*ls.KERNELS, 'lstm_loop_occupancy']


@pytest.mark.parametrize('fault', list(chip_smoke.LSTM_MUTANTS))
def test_lstm_mutants_apply_to_the_source(fault):
    """Each planted fault of the smoke run (LSTM_MUTANTS, built on the card with its macro
    set) names a macro that guards code in csrc/lstm_loop/lstm_loop.cu and is listed in its
    note."""
    macro = chip_smoke.LSTM_MUTANTS[fault]
    source = _source()
    assert re.search(rf'^#if(n?def)? {macro}$', source, re.M), macro
    assert source.count(macro) >= 2
