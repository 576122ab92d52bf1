"""Scale-out parity: the port's `parallel/` over torch.distributed (gloo, on the CPU)
against the JAX package's `parallel/` (GSPMD over the 8 virtual CPU devices of
conftest.py) and against the port's own one-process steps.

The ranks of a job are fresh interpreters (`tests/torch_parallel_worker.py`, started
with torchrun's environment; never a fork of this process, which holds JAX's threads),
one job for each world size, started once for the module and read by the tests. Each
job has a join timeout and its process group a timeout, so that a hang fails the
tests instead of eating the suite's time. The jobs run while this process computes the
JAX side.

What is held, at tiny widths:
  - the grid of ranks (`mesh_layout`) is JAX `make_mesh`'s device grid, and the
    sharding specs are `_spec_for_wavenet_param`'s;
  - the loaders' shards are the JAX loaders' `process_shard` rows;
  - data parallelism at 2 ranks with ragged lengths (the ranks' valid counts differ):
    the Tacotron and the WaveNet steps equal the one-process step on the global batch
    and JAX's `make_jitted_steps` over a 2-device data mesh;
  - tensor parallelism on (data 2, model 2) equals JAX's `make_tp_train_step`;
  - `generate_data_parallel` at 4 ranks equals JAX's on JAX's per-shard noise;
  - `train --model Tacotron` on 2 ranks logs the losses of a one-rank run, and only
    rank 0 writes; `train --model Tacotron-2` on 2 ranks runs its three phases, GTA on
    rank 0 alone;
  - three planted faults miss their bounds: per-rank averaged normalizers, BatchNorm
    over each rank's rows alone, and a contiguous split of the GLU's gate channels;
  - a failed start raises.
"""

import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tacotron2_tpu.config import default_hparams as jax_default_hparams
from tacotron2_tpu.data.loader import TacotronDataset as JTacotronDataset
from tacotron2_tpu.data.wavenet_loader import WaveNetDataset as JWaveNetDataset
from tacotron2_tpu.ops.pallas import wavenet_ar as jar
from tacotron2_tpu.parallel import mesh as jmesh
from tacotron2_tpu.parallel.sharding_rules import (_spec_for_wavenet_param,
                                                   shard_wavenet_state as jshard_state,
                                                   wavenet_param_shardings)
from tacotron2_tpu.training import tacotron_trainer as jtt
from tacotron2_tpu.training import wavenet_trainer as jwt
from tacotron2_tpu_torch import convert
from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.data.loader import TacotronDataset
from tacotron2_tpu_torch.data.wavenet_loader import WaveNetDataset
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.parallel import distributed, mesh as mesh_lib, sharding_rules
from tacotron2_tpu_torch.training import tacotron_trainer as tt
from tacotron2_tpu_torch.training import wavenet_trainer as wt

from test_torch_tacotron import TINY as TACO_TINY
from test_torch_tacotron_train import (CORPUS_HP, TRAIN_EXTRA, _corpus, flax_variables,
                                       noise_gradient_biases, port_noise, recorder)
from test_torch_tacotron_train import _as_numpy_state as taco_numpy_state
from test_torch_tacotron_train import make_batch as taco_batch
from test_torch_tacotron2_pipeline import HP as PIPE_HP
from test_torch_tacotron2_pipeline import make_ljspeech
from test_torch_train import _as_numpy_state as wavenet_numpy_state
from test_torch_train import flax_params
from test_torch_train import make_batch as wavenet_batch
from test_torch_vocoder import KERNEL_TOL
from test_torch_wavenet import TINY as WAVENET_TINY

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'torch_parallel_worker.py')
JOB_TIMEOUT_S = 240      # a job's ranks must all exit within this
PG_TIMEOUT_S = 60        # a collective's wait for a lost rank
STEPS = 2
SEED = 11
# the port's data-parallel step against its one-process step: 2e-5 of each tensor's
# largest magnitude, as test_torch_tacotron_train.py holds its gradients (only the sum
# order of the batch differs)
DP_TOL = 2e-5
# against JAX after two steps: test_torch_tacotron_train.py's and test_torch_train.py's
# bounds of a train step (loss 2e-5 relative; tensors 1e-4 of their largest magnitude
# after more than one step)
JAX_LOSS_RTOL = 2e-5
JAX_STATE_TOL = 1e-4
# Adam's moments against the one-process step's: test_torch_tacotron_train.py's bound
# after more than one step (a conv bias whose BatchNorm follows a tanh has its gradient
# mostly cancelled, so its moments carry the batch sum's rounding; read 2.6e-5 here)
MOMENT_TOL = 1e-4
# tensor parallelism against JAX's make_tp_train_step: tests/test_model_parallel.py:60-64
TP_LOSS_RTOL = 1e-4
TP_PARAM_ATOL = 1e-5
TACO_TERMS = ('loss', 'before_loss', 'after_loss', 'stop_token_loss', 'regularization_loss',
              'linear_loss', 'grad_norm')
# the masked losses: their denominators are where the ranks' valid counts differ
TACO_HP = TACO_TINY + TRAIN_EXTRA + ',mask_decoder=True'
WAVENET_HP = WAVENET_TINY + ',wavenet_batch_size=2,wavenet_dropout=0.0,wavenet_ema_decay=0.9'
# the grid of the tensor-parallel step, and its batch: 4 rows of ragged lengths
TP_HP = ("layers=4,stacks=2,residual_channels=16,gate_channels=32,skip_out_channels=16,"
         "upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,num_freq=129,"
         "wavenet_batch_size=4,wavenet_dropout=0.0,mesh_model_axis=2,mesh_data_axis=2")
TP_LENGTHS = (192, 150, 110, 70)
# the audio scaled as test_torch_train.py's 'gaussian-clipped' case scales it: a
# gradient passes 100 in norm and 5 in value, so both clips act
TP_CLIP_SCALE = 40.0
# generate_data_parallel: the configuration of tests/test_model_parallel.py:80-97
GEN_HP = ("layers=4,stacks=2,residual_channels=8,gate_channels=16,skip_out_channels=8,"
          "upsample_scales=[4,8],hop_size=32,win_size=128,n_fft=256,"
          "mesh_model_axis=1,mesh_data_axis=4")
GEN_B, GEN_TC = 4, 4
LOOP_STEPS = 4


def make_hp(overrides, jax_side=False):
    hp = (jax_default_hparams if jax_side else default_hparams)()
    hp.parse(overrides)
    return hp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _np(t):
    return t.detach().cpu().numpy()


class Job:
    """`world` ranks of torch_parallel_worker.py on one spec, started at once."""

    def __init__(self, root, world, spec):
        self.out = os.path.join(root, f'job{world}')
        os.makedirs(self.out)
        spec_path = os.path.join(self.out, 'spec.pt')
        torch.save(dict(spec, timeout_s=PG_TIMEOUT_S), spec_path)
        port = _free_port()
        tests_dir = os.path.dirname(WORKER)
        repo = os.path.dirname(tests_dir)
        self.procs = []
        for rank in range(world):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                       OMP_NUM_THREADS='1', PYTHONPATH=os.pathsep.join([repo, tests_dir]))
            log = open(os.path.join(self.out, f'rank{rank}.log'), 'w')
            self.procs.append((subprocess.Popen([sys.executable, WORKER, spec_path, self.out],
                                                env=env, cwd=root, stdout=log,
                                                stderr=subprocess.STDOUT), log))
        self.started = time.time()
        self._results = None

    def results(self):
        """Every rank's saved results, in rank order; fails on a rank that did not exit
        0 within JOB_TIMEOUT_S (all ranks are then killed)."""
        if self._results is not None:
            return self._results
        try:
            for proc, _ in self.procs:
                proc.wait(timeout=max(1.0, JOB_TIMEOUT_S - (time.time() - self.started)))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for proc, log in self.procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
        codes = [proc.returncode for proc, _ in self.procs]
        if any(codes):
            tails = []
            for rank in range(len(self.procs)):
                with open(os.path.join(self.out, f'rank{rank}.log')) as f:
                    tails.append(f'--- rank {rank} (exit {codes[rank]}):\n' + f.read()[-3000:])
            pytest.fail('a rank failed or hung:\n' + '\n'.join(tails))
        self._results = [torch.load(os.path.join(self.out, f'rank{r}.pt'), weights_only=False)
                         for r in range(len(self.procs))]
        return self._results


# ---------------------------------------------------------------- the specs

def tacotron_spec(recorder):
    """The Tacotron's data-parallel runs: a converted JAX state and the draws of two
    JAX steps (port_noise), on make_batch's two ragged rows, one a rank; and JAX's side:
    its train_step jitted as make_jitted_steps jits it (the state replicated, the batch
    split over a 2-device 'data' mesh), which also hands back the draws it made: each
    step's metrics and the state after them, converted."""
    hp = make_hp(TACO_HP, jax_side=True)
    hp.mesh_data_axis = 2
    mesh = jmesh.make_mesh(hp, jax.devices()[:2])
    v = flax_variables(hp)
    jstate = jtt.TrainState(step=jnp.zeros((), jnp.int32), params=v['params'],
                            batch_stats=v['batch_stats'],
                            opt_state=jtt.make_optimizer(hp).init(v['params']))
    batch = taco_batch(hp)

    def recorded(state, b, key):
        recorder.clear()
        return jtt.train_step(state, b, key, hp), list(recorder)

    step = jax.jit(recorded, in_shardings=(jmesh.replicated(mesh), jmesh.batch_sharding(mesh),
                                           jmesh.replicated(mesh)))
    key = jax.random.PRNGKey(7)
    start = taco_numpy_state(jstate)
    noise, metrics, s = [], [], jmesh.replicate(jstate, mesh)
    for _ in range(STEPS):
        (s, m), draws = step(s, jmesh.shard_batch(batch, mesh), key)
        noise.append(port_noise(hp, draws, train=True))
        metrics.append({k: float(m[k]) for k in TACO_TERMS})
    port_hp = make_hp(TACO_HP)
    state = convert.tacotron_train_state_from_jax(start, port_hp)
    runs = [dict(name='given', noise='given', fault=None),
            dict(name='generator', noise='generator', fault=None),
            dict(name='averaged_normalizers', noise='given', fault='averaged_normalizers'),
            dict(name='local_batch_norm', noise='given', fault='local_batch_norm')]
    jax_side = (metrics, convert.tacotron_train_state_from_jax(taco_numpy_state(s),
                                                               port_hp).state_dict())
    return dict(hparams=TACO_HP, batch=batch, state=state.state_dict(), noise=noise,
                steps=STEPS, seed=SEED, runs=runs), jax_side


def wavenet_spec():
    hp = make_hp(WAVENET_HP, jax_side=True)
    params = flax_params(hp)
    runs = [dict(name='plain', hparams=WAVENET_HP, fault=None),
            dict(name='dropout', hparams=WAVENET_HP + ',wavenet_dropout=0.5', fault=None),
            dict(name='averaged_normalizers', hparams=WAVENET_HP,
                 fault='averaged_normalizers')]
    return dict(batch=wavenet_batch(hp), state=convert.wavenet_state_dict(params, fold=False),
                steps=STEPS, seed=SEED, runs=runs), params


def tp_batch(hp):
    rng = np.random.default_rng(3)
    hop = hp.get_hop_size()
    T = max(TP_LENGTHS)
    return dict(audio=rng.uniform(-0.5, 0.5, (4, T)).astype(np.float32),
                input_lengths=np.asarray(TP_LENGTHS, np.int32),
                mel_conditions=rng.uniform(0, 1, (4, T // hop, hp.num_mels)).astype(np.float32))


def tp_spec():
    hp = make_hp(TP_HP, jax_side=True)
    batch = tp_batch(hp)
    jstate = jwt.create_train_state(hp, jax.random.PRNGKey(0), batch)
    sd = convert.wavenet_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params),
                                    fold=False)
    return dict(hparams=TP_HP, batch=batch, state=sd, clip_scale=TP_CLIP_SCALE), (jstate, batch)


def gen_spec():
    """generate_data_parallel's inputs, and JAX's noise: shard i's is
    make_noise(fold_in(rng, i)), as its shard_map body draws it."""
    hp = make_hp(GEN_HP, jax_side=True)
    rng = np.random.default_rng(0)
    c = rng.uniform(0, 1, (GEN_B, GEN_TC, hp.num_mels)).astype(np.float32)
    jstate = jwt.create_train_state(hp, jax.random.PRNGKey(0), dict(
        audio=np.zeros((GEN_B, GEN_TC * hp.get_hop_size()), np.float32),
        input_lengths=np.full((GEN_B,), GEN_TC * hp.get_hop_size(), np.int32),
        mel_conditions=c))
    key = jax.random.PRNGKey(1)
    T = GEN_TC * hp.get_hop_size()
    noise = np.concatenate([np.asarray(jar.make_noise(hp, jax.random.fold_in(key, i), 1, T))
                            for i in range(GEN_B)])[..., 0]
    ema = jax.tree_util.tree_map(np.asarray, jstate.ema_params)
    return dict(hparams=GEN_HP, c=torch.from_numpy(c), noise=torch.from_numpy(noise),
                state=convert.wavenet_state_dict(ema)), (jstate, c, key)


def pipeline_argv(base):
    return ['--base_dir', base, '--name', 'ranks', '--hparams', PIPE_HP, '--device', 'cpu',
            '--dist_backend', 'gloo', '--tacotron_train_steps', '2', '--wavenet_train_steps',
            '2', '--eval_interval', '2', '--checkpoint_interval', '2', '--summary_interval', '1']


def loop_argv(root, name):
    return ['--model', 'Tacotron', '--tacotron_input', 'train.txt', '--base_dir', root,
            '--name', name, '--tacotron_train_steps', str(LOOP_STEPS), '--eval_interval', '2',
            '--checkpoint_interval', str(LOOP_STEPS), '--summary_interval', '1',
            '--device', 'cpu', '--dist_backend', 'gloo', '--hparams', TACO_TINY + CORPUS_HP]


@pytest.fixture(scope='module')
def jobs(tmp_path_factory, recorder):
    """The 1-rank job (the loop), the 4-rank job (tensor parallelism,
    generate_data_parallel) and the 2-rank job (the data-parallel steps, the loop, the
    pipeline; the Tacotron's spec last, written once JAX's draws are made), started in
    that order; then, while they run, the references: JAX's steps and generation over
    its meshes and the port's one-process steps."""
    root = str(tmp_path_factory.mktemp('parallel'))
    corpus = os.path.join(root, 'corpus')
    os.makedirs(corpus)
    _corpus(corpus, make_hp(TACO_TINY + CORPUS_HP))
    one = Job(root, 1, dict(checks=['train_loop'], train_loop=dict(
        argv=loop_argv(corpus, 'one'), port=_free_port())))
    tp, tp_jax = tp_spec()
    gen, gen_jax = gen_spec()
    four = Job(root, 4, dict(checks=['wavenet_tp', 'generate_dp'], wavenet_tp=tp,
                             generate_dp=gen))
    wave, wave_params = wavenet_spec()
    pipeline = os.path.join(root, 'pipeline')
    make_ljspeech(pipeline)
    taco_path = os.path.join(root, 'tacotron_dp.pt')
    two = Job(root, 2, dict(checks=['wavenet_dp', 'train_loop', 'pipeline_loop', 'tacotron_dp'],
                            tacotron_dp=taco_path, wavenet_dp=wave,
                            train_loop=dict(argv=loop_argv(corpus, 'ranks'),
                                            port=_free_port()),
                            pipeline_loop=dict(base=pipeline, hparams=PIPE_HP,
                                               argv=pipeline_argv(pipeline))))
    # the Tacotron's spec needs JAX's draws: written while the 2-rank job runs
    taco, taco_jax = tacotron_spec(recorder)
    torch.save(taco, taco_path + '.tmp')
    os.replace(taco_path + '.tmp', taco_path)
    return dict(one=one, two=two, four=four, taco=taco, wave=wave, corpus=corpus,
                pipeline=pipeline,
                taco_one={run: _taco_one_process(taco, run) for run in ('given', 'generator')},
                taco_jax=taco_jax,
                wave_one={r['name']: _wavenet_one_process(wave, r) for r in wave['runs']
                          if r['fault'] is None},
                wave_jax=_wavenet_jax_mesh(wave, wave_params),
                tp_ref=_tp_references(tp, *tp_jax), gen_jax=_gen_jax(*gen_jax))


# ---------------------------------------------------------------- pure rules

@pytest.mark.parametrize('shape', [(8, 1), (4, 2), (2, 2), (1, 8)])
def test_mesh_layout_is_jax_device_grid(shape):
    """mesh_layout's grid of ranks is JAX make_mesh's grid of device ids: row-major,
    `np.asarray(devices).reshape(data, model)`."""
    data, model = shape
    overrides = f'mesh_data_axis={data},mesh_model_axis={model}'
    devices = jax.devices()[:data * model]
    want = np.array([[d.id for d in row] for row in
                     jmesh.make_mesh(make_hp(overrides, jax_side=True), devices).devices])
    got = mesh_lib.mesh_layout(make_hp(overrides), data * model)
    assert np.array_equal(got, want - want.min()), (got, want)
    auto = mesh_lib.mesh_layout(make_hp(f'mesh_model_axis={model}'), data * model)
    assert auto.shape == (data, model)


def test_mesh_layout_refuses_what_does_not_cover():
    with pytest.raises(ValueError, match='does not cover 8 devices'):
        mesh_lib.mesh_layout(make_hp('mesh_data_axis=3,mesh_model_axis=2'), 8)
    with pytest.raises(ValueError, match='does not cover 6 devices'):
        mesh_lib.mesh_layout(make_hp('mesh_model_axis=4'), 6)
    with pytest.raises(ValueError, match='mesh_num_slices'):
        mesh_lib.mesh_layout(make_hp('mesh_num_slices=2'), 8)


SPEC_CASES = {'tp-2': (TP_HP, 2), 'tp-4': (TP_HP + ',mesh_data_axis=2,mesh_model_axis=4', 4),
              'indivisible': (TP_HP + ',gate_channels=30', 4)}


@pytest.mark.parametrize('case', list(SPEC_CASES))
def test_sharding_specs_match_jax(case):
    """Every WaveNet parameter is split on the flax axis that JAX's
    `wavenet_param_shardings` splits, or replicated where it is; at gate_channels=30 over
    a model axis of 4 (test_model_parallel.py:67-77) everything falls back to
    replicated."""
    overrides, m = SPEC_CASES[case]
    jhp = make_hp(overrides, jax_side=True)
    jhp.mesh_model_axis, jhp.mesh_data_axis = m, 8 // m
    batch = tp_batch(jhp)
    params = jax.eval_shape(lambda: jwt.create_train_state(jhp, jax.random.PRNGKey(0),
                                                           batch).params)
    shardings = wavenet_param_shardings(params, jmesh.make_mesh(jhp))
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        key = '/'.join(str(getattr(p, 'key', p)) for p in path)
        want[key] = next((i for i, a in enumerate(sh.spec) if a == 'model'), None)
    hp = make_hp(overrides)
    model = WaveNet(hp)
    got = sharding_rules.wavenet_param_specs([n for n, _ in model.named_parameters()], hp, m)
    flax_got = {sharding_rules.flax_path(n): a for n, a in got.items()}
    blocks = {k: a for k, a in want.items() if k.startswith('residual_block_')}
    assert {k: a for k, a in flax_got.items() if k.startswith('residual_block_')} == blocks
    # outside the residual blocks everything is replicated on both sides
    assert all(a is None for k, a in want.items() if k not in blocks)
    assert all(a is None for k, a in flax_got.items() if k not in blocks)
    assert any(a is not None for a in want.values()) == (case != 'indivisible')
    # the rule itself, path by path, as _spec_for_wavenet_param states it
    for path in want:
        spec = _spec_for_wavenet_param(path, 0)
        axis = next((i for i, a in enumerate(spec) if a == 'model'), None)
        assert sharding_rules.spec_for_wavenet_param(path) == axis


def test_split_and_join_are_inverse():
    """convert.split_wavenet_state gives rank r the r-th block of each half of the gate
    channels (so its GLU is local) and the matching rows of out/skip; join puts the
    full state back exactly."""
    hp = make_hp(TP_HP)
    model = WaveNet(hp)
    sd = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
          for i, (k, v) in enumerate(model.state_dict().items())}
    shards = [convert.split_wavenet_state(sd, hp, 2, r) for r in range(2)]
    conv = sd['residual_layers.0.conv.weight']                    # (G, R, k)
    G = hp.gate_channels
    assert torch.equal(shards[1]['residual_layers.0.conv.weight'],
                       torch.cat([conv[G // 4:G // 2], conv[3 * G // 4:]]))
    out = sd['residual_layers.0.conv1x1_out.weight']             # (R, G/2)
    assert torch.equal(shards[1]['residual_layers.0.conv1x1_out.weight'], out[:, G // 4:])
    joined = convert.join_wavenet_shards(shards, hp)
    assert set(joined) == set(sd) and all(torch.equal(joined[k], sd[k]) for k in sd)


def test_nccl_refuses_two_ranks_on_one_device():
    """NCCL with the ranks of a node on one named card raises (no quiet switch to
    gloo); gloo may share it; a rank's cuda:LOCAL_RANK must exist."""
    with pytest.raises(ValueError, match='nccl cannot run 2 ranks'):
        distributed.check_devices('nccl', 'cuda:0', 2, named=True, cuda_count=1)
    distributed.check_devices('gloo', 'cuda:0', 2, named=True, cuda_count=1)
    distributed.check_devices('nccl', 'cuda:1', 2, named=False, cuda_count=2)
    with pytest.raises(ValueError, match='does not exist'):
        distributed.check_devices('nccl', 'cuda:1', 2, named=False, cuda_count=1)
    with pytest.raises(ValueError, match='needs a CUDA device'):
        distributed.check_devices('nccl', 'cpu', 1, named=False, cuda_count=0)


def test_rank_device(monkeypatch):
    for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    assert distributed.rank_device('cuda') == torch.device('cuda')
    monkeypatch.setenv('WORLD_SIZE', '4')
    monkeypatch.setenv('LOCAL_RANK', '3')
    assert distributed.rank_device('cuda') == torch.device('cuda', 3)
    assert distributed.rank_device('cuda:0') == torch.device('cuda', 0)
    assert distributed.rank_device('cpu') == torch.device('cpu')


def test_init_failure_raises(monkeypatch):
    """Divergence from distributed.py:58-60, which goes on in one process after a
    failed start: WORLD_SIZE without MASTER_ADDR raises at once, and a rank whose
    master never answers raises when its timeout runs out."""
    for k in distributed.ENV_KEYS + ('LOCAL_RANK', 'LOCAL_WORLD_SIZE'):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize('gloo', 5, 'cpu') is False
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('RANK', '1')
    t0 = time.time()
    with pytest.raises(RuntimeError, match='MASTER_ADDR'):
        distributed.maybe_initialize('gloo', 5, 'cpu')
    assert time.time() - t0 < 1.0
    monkeypatch.setenv('MASTER_ADDR', '127.0.0.1')
    monkeypatch.setenv('MASTER_PORT', str(_free_port()))   # nobody listens
    with pytest.raises(Exception):
        distributed.maybe_initialize('gloo', 0.5, 'cpu')
    assert not torch.distributed.is_initialized()
    assert distributed.process_shard() is None and distributed.is_lead()


# ---------------------------------------------------------------- loaders

@pytest.mark.parametrize('count', [2, 4])
def test_tacotron_loader_shards_match_jax(tmp_path, count):
    """Each shard's rows equal the JAX loader's process_shard rows (two bucket groups,
    so the permutation wraps), and the shards side by side are the unsharded batch:
    every row padded to the global batch's lengths."""
    overrides = TACO_TINY + CORPUS_HP + ',tacotron_batch_size=4'
    hp, jhp = make_hp(overrides), make_hp(overrides, jax_side=True)
    meta = _corpus(str(tmp_path), hp, n=20)
    whole = list(_take(TacotronDataset(meta, hp).train_batches(seed=3), 6))
    parts = [list(_take(TacotronDataset(meta, hp).train_batches(
        seed=3, process_shard=(i, count)), 6)) for i in range(count)]
    jparts = [list(_take(JTacotronDataset(meta, jhp).train_batches(
        seed=3, process_shard=(i, count)), 6)) for i in range(count)]
    _check_shards(whole, parts, jparts)


@pytest.mark.parametrize('count', [2, 4])
@pytest.mark.parametrize('crop', ['None', '256'])
def test_wavenet_loader_shards_match_jax(tmp_path, count, crop):
    """As the Tacotron loader's, for the WaveNet loader: the crops (max_time_steps=256)
    drawn for the whole global batch from one stream; without crops the pad length the
    global batch's longest row's."""
    from test_torch_train import _corpus as wavenet_corpus
    extra = f',wavenet_batch_size=4,max_time_steps={crop}'
    meta = wavenet_corpus(str(tmp_path), make_hp(WAVENET_HP + extra), n=20)
    hp = make_hp(WAVENET_HP + extra)
    jhp = make_hp(WAVENET_HP + extra, jax_side=True)
    whole = list(_take(WaveNetDataset(meta, hp, base_dir=str(tmp_path))
                       .train_batches(seed=3, group_batches=2), 6))
    parts = [list(_take(WaveNetDataset(meta, hp, base_dir=str(tmp_path)).train_batches(
        seed=3, group_batches=2, process_shard=(i, count)), 6)) for i in range(count)]
    jparts = [list(_take(JWaveNetDataset(meta, jhp, base_dir=str(tmp_path)).train_batches(
        seed=3, group_batches=2, process_shard=(i, count)), 6)) for i in range(count)]
    _check_shards(whole, parts, jparts)


def _take(it, n):
    for _ in range(n):
        yield next(it)


def _check_shards(whole, parts, jparts):
    for b, (w, ps, js) in enumerate(zip(whole, zip(*parts), zip(*jparts))):
        for k in w:
            joined = np.concatenate([p[k] for p in ps])
            assert np.array_equal(joined, w[k]), (b, k)
            for p, j in zip(ps, js):
                assert np.array_equal(p[k], np.asarray(j[k]).astype(p[k].dtype)), (b, k)


# ---------------------------------------------------------------- data parallelism

def _zero_grad_bound():
    """How far apart two runs of STEPS Adam steps may leave a parameter whose first
    moment stays under 1e-8 on both: each step moves it by at most lr * 1e-8 / (1 - b1)
    / eps (the bias-corrected moment over the smallest denominator)."""
    hp = make_hp(TACO_HP)
    step = (hp.tacotron_initial_learning_rate * 1e-8 / (1 - hp.tacotron_adam_beta1)
            / hp.tacotron_adam_epsilon)
    return 2 * STEPS * step


def _state_close(want, got, tol, what, names=None, zero_grad=(), moment_tol=None):
    """Every tensor of two state_dicts (model; EMA where there is one) within tol of its
    largest magnitude, Adam's moments within moment_tol (default tol). `zero_grad`:
    parameters (of `names`, the moments' order) whose gradient is rounding alone
    (test_torch_tacotron_train's noise_gradient_biases, a conv bias BatchNorm follows
    directly): their first moments under 1e-8 on both sides, as that file holds them,
    and the parameters within `_zero_grad_bound`, what such moments can move them (a
    data-parallel sum changes the rounding that is their whole gradient)."""
    for part in ('model', 'ema_model'):
        if part not in want:
            continue
        for k, w in want[part].items():
            if not w.is_floating_point():
                assert torch.equal(w, got[part][k]), (what, part, k)
                continue
            bound = _zero_grad_bound() if k in zero_grad else tol * max(float(w.abs().max()),
                                                                         1e-6)
            assert _max_abs(_np(w), _np(got[part][k])) <= bound, (what, part, k)
    for part in ('exp_avg', 'exp_avg_sq'):
        for i, (w, g) in enumerate(zip(want[part], got[part], strict=True)):
            if names is not None and names[i] in zero_grad:
                if part == 'exp_avg':
                    assert max(float(w.abs().max()), float(g.abs().max())) <= 1e-8
                continue
            bound = (moment_tol or tol) * max(float(w.abs().max()), 1e-6)
            assert _max_abs(_np(w), _np(g)) <= bound, (what, part, i)


def _taco_names():
    model = tt.Tacotron(make_hp(TACO_HP))
    return [n for n, _ in model.named_parameters()], noise_gradient_biases(model)


def _taco_one_process(spec, run):
    """The one-process steps on the global batch that a data-parallel run must equal."""
    hp = make_hp(spec['hparams'])
    state = tt.state_from_model(tt.Tacotron(hp))
    state.load_state_dict(spec['state'])
    batch = {k: torch.as_tensor(v) for k, v in spec['batch'].items()}
    metrics = []
    for i in range(spec['steps']):
        if run == 'given':
            m = tt.train_step(state, batch, hp, noise=spec['noise'][i])
        else:
            m = tt.train_step(state, batch, hp, torch.Generator().manual_seed(spec['seed'] + i))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state.state_dict()


def _wavenet_one_process(spec, run):
    hp = make_hp(run['hparams'])
    model = WaveNet(hp)
    model.load_state_dict(spec['state'])
    state = wt.state_from_model(model)
    batch = {k: torch.as_tensor(v) for k, v in spec['batch'].items()}
    metrics = []
    for i in range(spec['steps']):
        gen = torch.Generator().manual_seed(spec['seed'] + i)
        metrics.append({k: float(v) for k, v in wt.train_step(state, batch, hp, gen).items()})
    return metrics, state.state_dict()


def _wavenet_jax_mesh(spec, params):
    """JAX's make_jitted_steps over a 2-device data mesh from the same params."""
    hp = make_hp(WAVENET_HP, jax_side=True)
    hp.mesh_data_axis = 2
    mesh = jmesh.make_mesh(hp, jax.devices()[:2])
    tx = jwt.make_optimizer(hp)
    state = jwt.WaveNetTrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  ema_params=jax.tree_util.tree_map(jnp.copy, params),
                                  opt_state=tx.init(params))
    step, _ = jwt.make_jitted_steps(hp, mesh)
    state = jmesh.replicate(state, mesh)
    batch = {k: jnp.asarray(v) for k, v in spec['batch'].items()}
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, jmesh.shard_batch(batch, mesh), jax.random.PRNGKey(0))
        metrics.append({k: float(m[k]) for k in ('loss', 'grad_norm')})
    return metrics, convert.wavenet_train_state_from_jax(wavenet_numpy_state(state),
                                                         make_hp(WAVENET_HP)).state_dict()


def _tp_references(spec, jstate, batch):
    """JAX's make_tp_train_step on its (2, 2) mesh after shard_wavenet_state, and the
    port's one-process step, on the batch and on its audio scaled by TP_CLIP_SCALE:
    {run: (the metrics, the state_dict)} of JAX's ('jax'; params as the port's
    state_dict) and the port's ('none', 'clipped'), and the largest per-tensor gradient
    norm and value of the clipped batch's step."""
    jhp = make_hp(TP_HP, jax_side=True)
    mesh = jmesh.make_mesh(jhp, jax.devices()[:4])
    assert dict(mesh.shape) == {'data': 2, 'model': 2}
    jstate = jshard_state(jstate, mesh, jwt.make_optimizer(jhp))
    jstate, jm = jwt.make_tp_train_step(jhp, mesh)(jstate, jmesh.shard_batch(batch, mesh),
                                                    jax.random.PRNGKey(1))
    out = dict(jax=({k: float(jm[k]) for k in ('loss', 'grad_norm')},
                    convert.wavenet_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params),
                                               fold=False)))
    hp = make_hp(TP_HP)
    for run, scale in (('none', 1.0), ('clipped', TP_CLIP_SCALE)):
        model = WaveNet(hp)
        model.load_state_dict(spec['state'])
        state = wt.state_from_model(model)
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        b['audio'] = b['audio'] * scale
        if run == 'clipped':
            params = list(model.parameters())
            grads = torch.autograd.grad(wt._forward_loss(model, b, hp, train=True)[0], params,
                                        allow_unused=True)
            grads = [g for g in grads if g is not None]
            out['clip_reach'] = (max(float(g.norm()) for g in grads),
                                 max(float(g.abs().max()) for g in grads))
        m = wt.train_step(state, b, hp)
        out[run] = ({k: float(m[k]) for k in ('loss', 'grad_norm')}, state.model.state_dict())
    return out


def _gen_jax(jstate, c, key):
    """JAX's generate_data_parallel in interpret mode over a 4-device data mesh."""
    jhp = make_hp(GEN_HP, jax_side=True)
    mesh = jmesh.make_mesh(jhp, jax.devices()[:4])
    out = jwt.generate_data_parallel(jstate.ema_params, jhp, key, jnp.asarray(c), mesh)
    return np.asarray(out['audio']), np.asarray(out['params'])


def _loss_gap(want, got, keys):
    return max(abs(w[k] - g[k]) / max(abs(w[k]), 1e-12) for w, g in zip(want, got) for k in keys)


@pytest.mark.parametrize('run', ['given', 'generator'])
def test_tacotron_dp_equals_one_process(jobs, run):
    """Two ranks, one ragged row each (12 and 7 characters, 16 and 11 frames, the
    masked losses), two steps: every loss term and the grad norm 2e-5 relative, every
    parameter and BatchNorm statistic within DP_TOL of its largest magnitude (the
    moments within MOMENT_TOL), against the one-process steps on both rows; with the
    noise given (the global batch's draws) and with the noise drawn on each rank from the
    step's generator, seeded alike (the global batch's draws, each rank taking its
    rows). Both ranks hold the same state."""
    want_m, want_sd = jobs['taco_one'][run]
    for r in jobs['two'].results():
        got = r['tacotron_dp'][run]
        assert _loss_gap(want_m, got['metrics'], TACO_TERMS) <= DP_TOL
        _state_close(want_sd, got['state'], DP_TOL, run, *_taco_names(), MOMENT_TOL)


@pytest.mark.parametrize('fault', ['averaged_normalizers', 'local_batch_norm'])
def test_tacotron_dp_planted_faults_miss(jobs, fault):
    """Each planted fault moves the data-parallel step off the one-process step by far
    more than DP_TOL: the losses' denominators counted per rank (the mean of the ranks'
    means), or BatchNorm's statistics over each rank's row alone."""
    want_m, _ = jobs['taco_one']['given']
    got = jobs['two'].results()[0]['tacotron_dp'][fault]
    gap = _loss_gap(want_m, got['metrics'], ('loss', 'grad_norm'))
    assert gap > 100 * DP_TOL, gap


def test_tacotron_dp_equals_jax_data_mesh(jobs):
    """The data-parallel steps against JAX's make_jitted_steps over a 2-device data
    mesh, from the same converted state, on the same draws: each loss term and grad
    norm JAX_LOSS_RTOL, every tensor JAX_STATE_TOL of its largest magnitude after two
    steps."""
    want, ref = jobs['taco_jax']
    got = jobs['two'].results()[0]['tacotron_dp']['given']
    assert _loss_gap(want, got['metrics'], TACO_TERMS) <= JAX_LOSS_RTOL
    _state_close(ref, got['state'], JAX_STATE_TOL, 'jax', *_taco_names())


@pytest.mark.parametrize('run', ['plain', 'dropout'])
def test_wavenet_dp_equals_one_process(jobs, run):
    """Two ranks, one row each (128 and 88 valid samples), two steps, without dropout
    and with dropout 0.5 drawn on each rank for the global batch from the step's
    generator: loss and grad norm DP_TOL relative, every parameter and EMA value within
    DP_TOL of its largest magnitude and the moments within MOMENT_TOL, against the
    one-process steps."""
    want_m, want_sd = jobs['wave_one'][run]
    for r in jobs['two'].results():
        got = r['wavenet_dp'][run]
        assert _loss_gap(want_m, got['metrics'], ('loss', 'grad_norm')) <= DP_TOL
        _state_close(want_sd, got['state'], DP_TOL, run, moment_tol=MOMENT_TOL)


def test_wavenet_dp_planted_fault_misses(jobs):
    """The loss's denominator counted per rank misses the one-process step."""
    want_m, _ = jobs['wave_one']['plain']
    got = jobs['two'].results()[0]['wavenet_dp']['averaged_normalizers']
    gap = _loss_gap(want_m, got['metrics'], ('loss', 'grad_norm'))
    assert gap > 100 * DP_TOL, gap


def test_wavenet_dp_equals_jax_data_mesh(jobs):
    """The data-parallel steps (dropout 0) against JAX's make_jitted_steps over a
    2-device data mesh from the same params: loss and grad norm JAX_LOSS_RTOL, every
    tensor JAX_STATE_TOL of its largest magnitude after two steps."""
    want, ref = jobs['wave_jax']
    got = jobs['two'].results()[0]['wavenet_dp']['plain']
    assert _loss_gap(want, got['metrics'], ('loss', 'grad_norm')) <= JAX_LOSS_RTOL
    _state_close(ref, got['state'], JAX_STATE_TOL, 'jax')


# ---------------------------------------------------------------- tensor parallelism

def test_tp_equals_jax_and_one_process(jobs):
    """One step on the (data 2, model 2) grid: each rank holds G/2 = 16 gate channels
    (8 of each half), the loss and the grad norm within TP_LOSS_RTOL and the gathered
    parameters within TP_PARAM_ATOL of JAX's make_tp_train_step on its (2, 2) mesh with
    shard_wavenet_state, and of the port's one-process step; every rank of a model group
    gathers the same full parameters."""
    results = jobs['four'].results()
    ref = jobs['tp_ref']
    assert [r['wavenet_tp']['mesh'] for r in results] == [(2, 2, 0, 0), (2, 2, 0, 1),
                                                          (2, 2, 1, 0), (2, 2, 1, 1)]
    G = make_hp(TP_HP).gate_channels
    for r in results:
        tp = r['wavenet_tp']['none']
        assert tp['shapes']['residual_layers.0.conv.weight'][0] == G // 2
        assert tp['shapes']['residual_layers.0.conv1x1_out.weight'][1] == G // 4
        _tp_close(tp, *ref['jax'])
        _tp_close(tp, *ref['none'])


def _tp_close(tp, metrics, state_dict):
    """A tensor-parallel run's loss and grad norm within TP_LOSS_RTOL of `metrics`, its
    gathered parameters within TP_PARAM_ATOL of `state_dict`."""
    for k in ('loss', 'grad_norm'):
        assert abs(tp['metrics'][k] - metrics[k]) <= TP_LOSS_RTOL * abs(metrics[k]), k
    for k, w in state_dict.items():
        assert _max_abs(_np(torch.as_tensor(w)), _np(tp['params'][k])) <= TP_PARAM_ATOL, k


def test_tp_clip_sums_shard_norms(jobs):
    """With both clips acting (the audio scaled by TP_CLIP_SCALE: a tensor's gradient
    norm past wavenet_gradient_max_norm and a value past wavenet_gradient_max_value),
    the tensor-parallel step, whose per-tensor norms and global norm sum the shards'
    squares over the model group, equals the one-process step."""
    hp = make_hp(TP_HP)
    reach_norm, reach_value = jobs['tp_ref']['clip_reach']
    assert reach_norm > hp.wavenet_gradient_max_norm
    assert reach_value > hp.wavenet_gradient_max_value
    for r in jobs['four'].results():
        _tp_close(r['wavenet_tp']['clipped'], *jobs['tp_ref']['clipped'])


def test_tp_contiguous_glu_split_misses(jobs):
    """The planted fault: a contiguous block of G/m gate channels a rank (rank 0 all
    tanh inputs) misses JAX's loss by far more than TP_LOSS_RTOL."""
    jax_loss = jobs['tp_ref']['jax'][0]['loss']
    bad = jobs['four'].results()[0]['wavenet_tp']['contiguous_glu']['metrics']['loss']
    assert abs(bad - jax_loss) > 100 * TP_LOSS_RTOL * abs(jax_loss), (bad, jax_loss)


# ---------------------------------------------------------------- generation

def test_generate_data_parallel_equals_jax(jobs):
    """generate_data_parallel at 4 ranks, one row each, on JAX's per-shard noise
    (make_noise(fold_in(rng, i))): audio and params within KERNEL_TOL (the vocoder
    tests' bound of the AR path against the Pallas kernel) of JAX's
    generate_data_parallel in interpret mode over a 4-device data mesh; every rank holds
    all rows; rank i generated row i."""
    results = jobs['four'].results()
    audio, params = jobs['gen_jax']
    assert [r['generate_dp']['rows'] for r in results] == [(i, i + 1) for i in range(GEN_B)]
    for r in results:
        got = r['generate_dp']
        assert tuple(got['audio'].shape) == audio.shape == (GEN_B, GEN_TC * 32)
        assert _max_abs(audio, _np(got['audio'])) <= KERNEL_TOL
        assert _max_abs(params, _np(got['params'])) <= KERNEL_TOL


# ---------------------------------------------------------------- the loop

def test_train_loop_on_two_ranks(jobs):
    """`train --model Tacotron --device cpu --dist_backend gloo` on 2 ranks, 4 steps
    (evals at 2 and 4, a checkpoint at 4): rank 0's per-step losses equal a one-rank
    run's (the same command, a world of 1) to 2e-5 relative; only rank 0 wrote the
    checkpoint and the log."""
    loops = [r['train_loop'] for r in jobs['two'].results()]
    assert [l['lead'] for l in loops] == [True, False]
    assert loops[0]['saves'] == [LOOP_STEPS] and loops[1]['saves'] == []
    losses = jobs['one'].results()[0]['train_loop']['losses']
    assert [s for s, _ in losses] == [s for s, _ in loops[0]['losses']] == [1, 2, 3, 4]
    for (_, w), (_, g) in zip(losses, loops[0]['losses']):
        assert abs(w - g) <= 2e-5 * abs(w), (w, g)
    assert loops[1]['losses'] == loops[0]['losses']
    log_dir = os.path.join(jobs['corpus'], 'logs-ranks')
    assert os.listdir(os.path.join(log_dir, 'taco_pretrained')) == [f'ckpt-{LOOP_STEPS}.pt']
    with open(os.path.join(log_dir, 'Terminal_train_log'), encoding='utf-8') as f:
        text = f.read()
    assert text.count('Starting new training!') == 1
    assert 'Data-parallel over 2 ranks (mesh 2x1)' in text


def test_pipeline_on_two_ranks(jobs):
    """`train --model Tacotron-2 --device cpu --dist_backend gloo` on 2 ranks, 2 steps of
    each trainer, on the wavs of test_torch_tacotron2_pipeline.py preprocessed by rank 0:
    both trainers data-parallel, GTA on rank 0 while the other rank waits for its map;
    the state_log `1|1|1|<map>` (train.py's bytes) as both ranks read it, a GTA mel for
    every train.txt row; only rank 0 wrote the checkpoints and the log."""
    base = jobs['pipeline']
    runs = [r['pipeline_loop'] for r in jobs['two'].results()]
    gta_map = os.path.join(base, 'tacotron_output', 'gta', 'map.txt')
    assert runs[0]['state_log'] == runs[1]['state_log']
    assert runs[0]['state_bytes'] == runs[1]['state_bytes'] == ('1|1|1|' + gta_map).encode()
    assert runs[0]['saves'] == [('taco_pretrained', 2), ('wave_pretrained', 2)]
    assert runs[1]['saves'] == []
    with open(os.path.join(base, 'training_data', 'train.txt'), encoding='utf-8') as f:
        n_rows = len(f.read().splitlines())
    with open(gta_map, encoding='utf-8') as f:
        assert len(f.read().splitlines()) == n_rows
    with open(os.path.join(base, 'logs-ranks', 'Terminal_train_log'), encoding='utf-8') as f:
        text = f.read()
    for banner in ('Phase 1/3', 'Phase 2/3', 'Phase 3/3'):
        assert text.count(banner) == 1, banner
    assert text.count('Data-parallel over 2 ranks') == 2   # each trainer's
