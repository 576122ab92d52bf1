"""The port's four probes (`tacotron2_tpu_torch/probes/`) against the JAX package's probe
scripts, on the CPU.

The scripts cannot be imported: each calls `setup_runtime()` at import (which would
switch this worker's JAX PRNG for the JAX tests that share it), and three run their
benchmark loop at module level. So `load_script` reads a script with `ast`: it keeps the
imports, the function definitions and the module-level assignments that call nothing the
script defines, executes them one by one with the named constants overridden as they
are assigned (so that DILS, IN1 and the like follow), and gives the script a `pl` whose
`pallas_call` runs in interpret mode. Every variant's plain version then runs on the
port's `make_inputs` at the same cut sizes as the JAX probe on its own draws, so the
parity checks also hold `make_inputs` to the scripts' draws.

Tolerances, relative to the largest |value| of the JAX output (asserted nonzero: B9's
output is of order 1e-5 and B11's 1e-3, so an absolute bound would pass zeros):
  B9  (ar_critpath) REL_B9 = 5e-3: observed 1.4e-7 to 2.0e-7, and 7.8e-4 for
      fused_tanhfold, where one bf16 rounding of a gate lands on the other side (one bf16
      step is 3.9e-3 of a value; the output sums many of them scaled by 1e-4);
  B10 (matmul_probe) exact but `indep`, whose f32 sums differ in the last place
      (REL_B10 = 1e-6, observed 3.0e-7): the dependent variants round each step to bf16;
  B11 (microbench) REL_B11 = 1e-2, observed 4.7e-3 (attlite) and 2.0e-3 (att): XLA may
      keep f32 inside a fused bf16 elementwise chain where torch rounds after each op, so
      an element may sit one bf16 step (3.9e-3 of it) apart;
  B12 (prng_probe) exact ids, stats within 1e-6.
"""

import ast
import functools
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tacotron2_tpu_torch.probes import ar_critpath, matmul_probe, microbench, prng_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, 'scripts')
REL_B9, REL_B10, REL_B11 = 5e-3, 1e-6, 1e-2
B9_CUT = dict(L=4, T=9)  # T above the largest ring window (4): every ring wraps
B10_STEPS = B11_STEPS = 3
ZERO_MEMORY = pltpu.InterpretParams(uninitialized_memory='zero')


def load_script(name, interpret, **overrides):
    """The namespace of scripts/<name> as the module docstring says: imports, functions
    and the assignments that call nothing the script defines, with `overrides` applied
    to the constants as they are assigned; `pl.pallas_call` runs with `interpret`."""
    path = os.path.join(SCRIPTS, name)
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read())
    shim = types.ModuleType('pallas_interpret')
    shim.__dict__.update(pl.__dict__)
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=interpret)
    ns, defined = {'__name__': 'probe_script'}, set()
    for node in tree.body:
        keep = isinstance(node, (ast.Import, ast.FunctionDef)) or (
            isinstance(node, ast.ImportFrom) and not node.module.startswith('tacotron2_tpu'))
        if isinstance(node, ast.Assign):
            called = {c.func.id for c in ast.walk(node.value)
                      if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)}
            keep = not called & defined
        if keep:
            exec(compile(ast.Module([node], []), path, 'exec'), ns)
            ns['pl'] = shim
        if isinstance(node, (ast.Assign, ast.FunctionDef)):
            names = [n.id for n in ast.walk(node) if isinstance(n, ast.Name)
                     and isinstance(n.ctx, ast.Store)] if isinstance(node, ast.Assign) \
                else [node.name]
            defined.update(names)
            for n in names:
                if n in overrides:
                    ns[n] = overrides[n]
    return ns


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert scale > 0, 'the reference is all zeros: the check would pass a kernel that does nothing'
    return np.abs(port - ref).max() / scale


class Ref:
    """A stand-in for a Pallas ref outside a kernel: [:] reads and writes the array."""

    def __init__(self, value):
        self.value = jnp.asarray(value)

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, v):
        self.value = self.value.at[idx].set(v)


# ---------------------------------------------------------------- B12: prng_probe

def test_prng_probe_zero_bits_match_the_jax_probe():
    """The JAX probe in TPU interpret mode draws all-zero bits (its Gumbel mean, max
    and min are all -3.0312572; a seed changes nothing), so its ids are the planted
    winners: the port's transform and arg-max on zero bits give the same ids and stats."""
    ns = load_script('dev_prng_probe.py', pltpu.InterpretParams())
    ids, stats = ns['fn'](jnp.asarray([prng_probe.SEED], jnp.int32), jnp.asarray(ns['scores']))
    inputs = prng_probe.make_inputs()
    np.testing.assert_array_equal(inputs['scores'].numpy(), ns['scores'])
    p_ids, p_stats = prng_probe.from_bits(inputs['scores'],
                                          torch.zeros(prng_probe.B, prng_probe.Q,
                                                      dtype=torch.int64))
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(p_stats.numpy(), np.asarray(stats), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ids).ravel(), prng_probe.PLANTED)


def test_prng_probe_random_bits_match_the_script_lines():
    """On random bits the port's transform and arg-max equal the script's lines 20-27
    run eagerly on the same bits (its kernel function with refs as arrays and the TPU
    PRNG replaced by the given bits); the plain version's Philox bits give a Gumbel mean
    near 0.5772 (the planted 12.0 need not win: the largest of 65,536 draws is about 11
    and may reach 16)."""
    rng = np.random.default_rng(3)
    B, Q = prng_probe.B, prng_probe.Q
    bits = rng.integers(0, 2 ** 32, (B, Q), dtype=np.uint64)
    scores = rng.normal(0, 1, (B, Q)).astype(np.float32)
    ns = load_script('dev_prng_probe.py', True)
    ns['pltpu'] = types.SimpleNamespace(
        prng_seed=lambda seed: None,
        prng_random_bits=lambda shape: jnp.asarray(bits.astype(np.uint32).view(np.int32)),
        bitcast=lambda x, ty: jax.lax.bitcast_convert_type(x, ty))
    ids, stats = Ref(np.zeros((B, 1), np.float32)), Ref(np.zeros((1, 8), np.float32))
    ns['kernel'](Ref([0]), Ref(scores), ids, stats)
    p_ids, p_stats = prng_probe.from_bits(torch.from_numpy(scores),
                                          torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(ids.value))
    np.testing.assert_allclose(p_stats.numpy(), np.asarray(stats.value), rtol=0, atol=1e-5)
    ids, stats = prng_probe.plain('gumbel_argmax', prng_probe.make_inputs())
    assert ids.shape == (prng_probe.B, 1) and stats.shape == (1, 8) and not stats[0, 3:].any()
    assert abs(stats[0, 0].item() - 0.5772) < 0.01 and stats[0, 1] > 10 and stats[0, 2] < -2


def _cta_best(v, lo, hi):
    """(largest score, lowest class) of classes [lo, hi) of one row, as a CTA keeps it."""
    if lo >= hi:
        return -np.inf, 2 ** 31 - 1
    i = lo + int(np.argmax(v[lo:hi]))
    return v[i], i


@pytest.mark.parametrize('Q', [prng_probe.Q, 1001])
@pytest.mark.parametrize('C', [1, 2, 8, 16])
def test_prng_probe_partition_and_rank_merge_give_the_argmax(C, Q):
    """B12's cluster of C CTAs a row (`csrc/probes/prng_probe.cu`): CTA r takes Philox
    groups [r n4 / C, (r+1) n4 / C) of n4 = ceil(Q/4), so each class falls to one CTA;
    each keeps its best (score, lowest class), merged at rank 0 in rank order by
    `better` (a larger score, or the same at a lower class): the arg-max of the plain
    version's scores + noise, for every C; a forced tie across the boundary of CTA 0 and
    CTA 1 gives the first class, as jnp.argmax. The stats, per CTA, then in rank order
    and over rows, stay within GUMBEL_STATS_TOL of the plain version's."""
    import chip_smoke
    from tacotron2_tpu_torch.ops.wavenet_ar import gumbel_from_bits, philox_bits

    inp = prng_probe.make_inputs(seed=3, B=2, Q=Q, random_scores=True)
    g = gumbel_from_bits(philox_bits(inp['seed'], 2, 0, Q, torch.device('cpu'))).numpy()
    v = inp['scores'].numpy() + g
    n4 = -(-Q // 4)
    bounds = [(min(4 * (r * n4 // C), Q), min(4 * ((r + 1) * n4 // C), Q)) for r in range(C)]
    owned = np.zeros(Q, np.int64)
    for lo, hi in bounds:
        owned[lo:hi] += 1
    assert (owned == 1).all()

    def merged(row):
        bv, bid = -np.inf, 2 ** 31 - 1
        for lo, hi in bounds:  # rank order
            cv, cid = _cta_best(row, lo, hi)
            if cv > bv or (cv == bv and cid < bid):
                bv, bid = cv, cid
        return bid
    want_ids, want_stats = prng_probe.plain('gumbel_argmax', inp)
    for b in range(2):
        assert merged(v[b]) == int(want_ids[b, 0]) == int(np.argmax(v[b]))
    if C > 1:
        tie = v[0].copy()
        edge = bounds[0][1]
        tie[[edge - 1, edge]] = tie.max() + 1.0
        assert merged(tie) == edge - 1 == int(np.argmax(tie))
    sums = [sum(float(np.float32(g[b, lo:hi].sum(dtype=np.float32))) for lo, hi in bounds)
            for b in range(2)]
    assert abs(sum(sums) / (2 * Q) - want_stats[0, 0].item()) <= chip_smoke.GUMBEL_STATS_TOL


# ---------------------------------------------------------------- B9: ar_critpath

@pytest.mark.parametrize('variant', ar_critpath.VARIANTS)
def test_ar_critpath_matches_the_jax_probe(variant):
    """Each step body and GLU form at L=4, T=9 (every ring buffer wraps), full widths."""
    ns = load_script('dev_pallas_ar_critpath.py', True, **B9_CUT)
    ref = np.asarray(ns['build'](variant)())
    port = ar_critpath.plain(variant, ar_critpath.make_inputs(L=B9_CUT['L']), B9_CUT['T'])
    assert _rel(port.numpy(), ref) < REL_B9


def test_ar_critpath_inputs_are_the_scripts_draws():
    """make_inputs draws as the script does: its first weight, w_tap, against the
    script's own expression (f64 normal draws rounded to bf16 by JAX)."""
    w_tap = ar_critpath.make_inputs(L=2)['w_tap']
    want = jnp.asarray(np.random.default_rng(0).normal(0, 0.05, (2, 3 * 128, 256)),
                       jnp.bfloat16)
    np.testing.assert_array_equal(w_tap.float().numpy(), np.asarray(want, np.float32))


def _simulate_critpath(variant, inputs, steps, loads_first=True):
    """A model of `csrc/probes/ar_critpath.cu` on the CPU: one cluster of R/8 CTAs over
    the 8 batch rows, walking `schedule`'s table as the kernel does, each CTA's products
    from the packed A tiles (unpacked by `fragment_index`) on its 16 columns: the gates
    from the phase before's exchanged z and h, starting from the consts computed in it;
    the residual and skip into h and the skip sum; h into its ring and every CTA; the
    next consts from the taps staged two phases before into four buffers. The loads of
    a phase run before its ring writes, or after them (`loads_first`): the two orders
    agree only where no phase reads a ring slot that it also writes."""
    m = ar_critpath
    tiles, table, _ = m.pack(variant, inputs)
    d = m.dims_of(inputs)
    L, R, G, K, B = d['L'], d['R'], d['G'], d['K'], d['B']
    half, C, PH, n = G // 2, R // 8, table.shape[0], m.ROWS
    recs = [dict(zip(m.RECORD, row)) for row in table.tolist()]
    dils = m.dilations(L)
    wins = [(K - 1) * dl for dl in dils]
    offs = [sum(wins[:l]) for l in range(L)]
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    cond = torch.zeros(n, L * G)
    cond[:B] = inputs['cond']
    rings = torch.zeros(n, sum(wins) * R)
    xz, xh = torch.zeros(2, n, half), torch.zeros(2, n, R)
    taps = torch.zeros(4, n, (K - 1) * R)
    h, sk = torch.full((n, R), 0.01), torch.zeros(n, R)
    xh[1] = bf(h)

    def cond_of(r, l):  # (16, n) the owned columns' conditioning of layer l
        return cond[:, l * G + m.owned_columns(r, half)].T

    def a_mat(r, off, count):  # the CTA's A (16, 16 count) from its fragments
        k, mm = m.fragment_index(count)
        a = torch.zeros(16, 16 * count)
        a[mm, k] = tiles[r, off:off + count].float()
        return a

    cst = [cond_of(r, 0) for r in range(C)]
    for t in range(steps):
        for p in range(PH):
            g, rec = t * PH + p, recs[p]
            zin, hin = xz[(g + 1) % 2].clone(), xh[(g + 1) % 2].clone()

            def loads():
                q, tq = (p + 2) % PH, t + (p + 2) // PH
                lay, ts = recs[q]['consts_layer'], tq + recs[q]['consts_next_step']
                if lay >= 0:
                    for j in range(K - 1):
                        slot = (ts + wins[lay] - (K - 1 - j) * dils[lay]) % wins[lay]
                        taps[(g + 2) % 4, :, j * R:(j + 1) * R] = \
                            rings[:, (offs[lay] + slot) * R:(offs[lay] + slot + 1) * R]
            if loads_first:
                loads()
            new_cst = list(cst)
            for r in range(C):
                off, gl = rec['tile_off'], rec['gate_layer']
                gate = rec['gate_z_tiles'] + rec['gate_h_tiles'] if gl >= 0 else 0
                cols = slice(8 * r, 8 * r + 8)
                if gl >= 0:
                    x = torch.cat(([zin.T] if rec['gate_z_tiles'] else []) + [hin.T])
                    z = cst[r] + a_mat(r, off, gate) @ x
                    xz[g % 2][:, cols] = bf(m.glu(torch.cat([z[:8].T, z[8:].T], 1), variant))
                if rec['os_layer'] >= 0:
                    y = a_mat(r, off + gate, half // 16) @ zin.T
                    h[:, cols] += y[:8].T
                    sk[:, cols] += y[8:].T
                    if rec['os_last']:
                        h[:, cols] = h[:, cols] * 1e-4 + sk[:, cols] * 1e-6
                        sk[:, cols] = 0
                if rec['ring_layer'] >= 0:
                    lay = rec['ring_layer']
                    at = (offs[lay] + t % wins[lay]) * R
                    rings[:, at + 8 * r:at + 8 * r + 8] = h[:, cols]
                if rec['hb_send']:
                    xh[g % 2][:, cols] = bf(h[:, cols])
                if rec['consts_layer'] >= 0:
                    past = a_mat(r, off + gate + (half // 16 if rec['os_layer'] >= 0 else 0),
                                 (K - 1) * R // 16)
                    new_cst[r] = cond_of(r, rec['consts_layer']) + past @ bf(taps[g % 4]).T
            cst = new_cst
            if not loads_first:
                loads()
    return h[:B]


@pytest.mark.parametrize('variant', ['base', 'fused', 'fused_tanhfold'])
def test_ar_critpath_kernel_schedule_computes_the_plain_version(variant):
    """The kernel's dataflow (`_simulate_critpath`: the phase table, the packed tiles, the
    exchange parities, the four tap buffers two phases ahead) computes the plain
    version's `prev` at L=4, T=9 (every ring wraps), B=2, within REL_B9 (the sums run in
    another order); and no phase's loads race its ring writes."""
    inputs = ar_critpath.make_inputs(L=4, B=2)
    want = ar_critpath.plain(variant, inputs, 9)
    got = _simulate_critpath(variant, inputs, 9)
    assert _rel(got.numpy(), want.numpy()) < REL_B9
    assert torch.equal(got, _simulate_critpath(variant, inputs, 9, loads_first=False))


def test_ar_critpath_kernel_raises_on_sizes_it_does_not_take():
    d = dict(ar_critpath.DIMS)
    ar_critpath.check_sizes(dict(d, L=4))
    for bad in (dict(L=2), dict(L=5), dict(S=64), dict(R=256, G=512, S=256), dict(G=512)):
        with pytest.raises(ValueError, match='does not take these sizes'):
            ar_critpath.check_sizes(dict(d, **bad))


# ---------------------------------------------------------------- B10: matmul_probe

@pytest.mark.parametrize('variant', matmul_probe.VARIANTS)
def test_matmul_probe_matches_the_jax_probe(variant):
    """Each variant at full width over 3 steps, the JAX probe's uninitialised memory
    zeroed (see the test of `indep` below)."""
    ns = load_script('dev_pallas_matmul_probe.py', ZERO_MEMORY, T=B10_STEPS)
    ref = np.asarray(ns['build'](variant)())
    port, prod = matmul_probe.plain(variant, matmul_probe.make_inputs(), B10_STEPS)
    assert _rel(port.numpy(), ref) <= REL_B10
    assert prod.shape == (32, 4096) and np.isfinite(prod.numpy()).all()


def test_matmul_probe_indep_starts_from_zero():
    """`indep` adds into an output it never initialises: in plain interpret mode that is
    NaN; with uninitialised memory zeroed it is T * (x @ w)[:, :U], which the port, which
    zero-initialises, returns."""
    ns = load_script('dev_pallas_matmul_probe.py', True, T=2)
    assert np.isnan(np.asarray(ns['build']('indep')())).any()
    inputs = matmul_probe.make_inputs()
    port, prod = matmul_probe.plain('indep', inputs, 2)
    x = torch.full((32, 1792), 0.01, dtype=torch.bfloat16).float()
    want = 2 * (x @ inputs['w'].float())[:, :1024]
    torch.testing.assert_close(port[:, :1024], want, rtol=1e-6, atol=0)
    assert not port[:, 1024:].any()
    torch.testing.assert_close(prod, x @ inputs['w'].float(), rtol=0, atol=0)


# ---------------------------------------------------------------- B11: microbench

@pytest.mark.parametrize('variant', microbench.VARIANTS)
def test_microbench_matches_the_jax_probe(variant):
    """Each variant at full width over 3 steps. From the zero state `lstm` stays at zero
    (checked here; the next test holds it from a nonzero state), while `att` and
    `attlite` cover the LSTMs too, since ctx is nonzero after step 1."""
    ns = load_script('dev_pallas_microbench.py', ZERO_MEMORY, T=B11_STEPS)
    ref = np.asarray(ns['build'](variant)())
    port, _ = microbench.plain(variant, microbench.make_inputs(), B11_STEPS)
    if variant == 'lstm':
        assert not ref.any() and not port.any()
    else:
        assert _rel(port.numpy(), ref) < REL_B11


def test_microbench_lstm_from_a_nonzero_state():
    """The script's LSTM lines (`:42-53` of its step, run eagerly with refs as arrays)
    from a seeded nonzero state against the port's plain `lstm` over 3 steps: h2, and
    both cells."""
    ns = load_script('dev_pallas_microbench.py', True)
    build = next(n for n in ast.parse(open(os.path.join(SCRIPTS, 'dev_pallas_microbench.py'),
                                           encoding='utf-8').read()).body
                 if isinstance(n, ast.FunctionDef) and n.name == 'build')
    step = next(n for n in ast.walk(build) if isinstance(n, ast.FunctionDef) and n.name == 'step')
    lines = [s for s in step.body[:next(i for i, s in enumerate(step.body)
                                        if isinstance(s, ast.If))]]
    code = compile(ast.Module(lines, []), 'dev_pallas_microbench.py', 'exec')
    inputs = microbench.make_inputs()
    start = microbench.random_state(inputs)
    refs = {f'{k}_s': Ref(np.asarray(v.float().numpy(), np.float32).astype(jnp.bfloat16))
            for k, v in start.items() if k != 'state'}
    refs.update(g1_k=Ref(inputs['g1'].float().numpy().astype(jnp.bfloat16)),
                g2_k=Ref(inputs['g2'].float().numpy().astype(jnp.bfloat16)))
    for _ in range(B11_STEPS):
        exec(code, dict(ns), dict(refs))
    h2, final = microbench.plain('lstm', inputs, B11_STEPS, start=start)
    assert _rel(h2.numpy(), np.asarray(refs['h2_s'].value, np.float32)) < REL_B11
    for k in ('c1', 'c2', 'h1'):
        assert _rel(final[k].float().numpy(), np.asarray(refs[f'{k}_s'].value, np.float32)) \
            < REL_B11, k


# ---------------------------------------------------------------- the entry points

def test_probe_entry_points_run_plain_on_the_cpu_and_raise_without_a_card():
    """`python -m tacotron2_tpu_torch.probes.<name> --device cpu` runs the plain version
    and prints the script's lines; without --device cpu and without a card the probe
    raises (no silent fallback)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, '-m', 'tacotron2_tpu_torch.probes.prng_probe',
                          '--device', 'cpu', '--batch', '2'], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'ids: [  7 130]' in res.stdout and 'gumbel mean/max/min:' in res.stdout
    out = ar_critpath.main(['--device', 'cpu', '--variants', 'base', '--steps', '2'])
    assert out == {}
    if not torch.cuda.is_available():
        for mod in (prng_probe, ar_critpath, matmul_probe, microbench):
            with pytest.raises(RuntimeError, match='no CUDA device'):
                mod.main(['--steps', '1'])
    with pytest.raises(ValueError, match='CUDA tensors'):
        ar_critpath.kernel('base', ar_critpath.make_inputs(L=2), 1)


@pytest.mark.parametrize('fault', ['prng_probe: the last id taken on a tie',
                                   'ar_critpath: a tap slot off by one',
                                   'matmul_probe: the dependency dropped',
                                   'microbench: the alignment not accumulated into the state',
                                   'microbench: the last k-tile of the ctx rows dropped'])
def test_probe_mutants_apply_to_the_sources(fault):
    """Each planted fault of chip_smoke.PROBE_MUTANTS changes exactly one line of its
    probe's source (the card's smoke run builds these copies beside the probes)."""
    import chip_smoke
    from tacotron2_tpu_torch.ops import _build

    name, old, new = chip_smoke.PROBE_MUTANTS[fault]
    assert name.split('.')[0] == fault.split(':')[0]
    with open(os.path.join(_build.PROBES_DIR, name), encoding='utf-8') as f:
        source = f.read()
    got_name, text = chip_smoke.mutated_probe_source(fault)
    assert got_name == name and text != source and text.replace(new, old) == source
