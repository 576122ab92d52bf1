"""One rank of a job of tests/test_torch_parallel.py.

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_parallel_worker.py <spec.pt> <out_dir>

Each rank is a fresh interpreter (never a fork of the test process, which holds JAX's
threads) and imports nothing of JAX. It joins a gloo group on the CPU through
`parallel.distributed.maybe_initialize`, runs the checks the spec names, in order (the
same order on every rank: each builds its process groups), and saves what they read to
<out_dir>/rank<r>.pt. The spec (a torch.save of this test's own making) holds the
hparams, the global batches, the starting state dicts and the global noise; a check's
spec may be the path of a file the test writes while the ranks run (`late_spec`).
Planted faults are monkeypatches made here, in the rank, never in the package.
"""

import contextlib
import os
import sys
import time

import torch
import torch.distributed as dist

from tacotron2_tpu_torch.config import default_hparams
from tacotron2_tpu_torch.models.tacotron import losses as taco_losses
from tacotron2_tpu_torch.models.tacotron.model import Tacotron
from tacotron2_tpu_torch.models.wavenet import distributions
from tacotron2_tpu_torch.models.wavenet.model import WaveNet
from tacotron2_tpu_torch.parallel import distributed, mesh as mesh_lib, sharding_rules
from tacotron2_tpu_torch.parallel import tensor_parallel
from tacotron2_tpu_torch.parallel.collectives import group_size
from tacotron2_tpu_torch.training import tacotron_trainer as tt
from tacotron2_tpu_torch.training import wavenet_trainer as wt


def make_hp(overrides: str):
    hp = default_hparams()
    hp.parse(overrides)
    return hp


def averaged(t, group):
    """The planted fault of the normalizers: each rank's own count, so that the ranks'
    losses, summed, are the mean of their means."""
    return t.detach().clone() * group_size(group)


def contiguous_gates(G, model_size, model_index):
    """The planted fault of the GLU split: a contiguous block of G/m gate channels."""
    per = G // model_size
    return torch.arange(model_index * per, (model_index + 1) * per)


@contextlib.contextmanager
def planted(fault):
    """Within the block, the package runs with the planted fault `fault` (or none)."""
    patches = {None: [],
               'averaged_normalizers': [(taco_losses, 'global_sum', averaged),
                                        (distributions, 'global_sum', averaged)],
               'local_batch_norm': [(tt, 'sync_batch_norm', lambda model, group: model)],
               'contiguous_glu': [(sharding_rules, 'gate_index', contiguous_gates)]}[fault]
    saved = [(module, name, getattr(module, name)) for module, name, _ in patches]
    try:
        for module, name, value in patches:
            setattr(module, name, value)
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def tacotron_state(spec, hp):
    state = tt.state_from_model(Tacotron(hp))
    state.load_state_dict(spec['state'])
    return state


def wavenet_state(state_dict, hp):
    model = WaveNet(hp)
    model.load_state_dict(state_dict)
    return wt.state_from_model(model)


def metrics_of(m):
    return {k: float(v) for k, v in m.items()}


def tacotron_dp(spec):
    """Steps of the Tacotron on this rank's rows: with the global noise given, with
    the noise drawn from a generator seeded alike on every rank, and with each planted
    fault (one step: it shows in the first)."""
    hp = make_hp(spec['hparams'])
    mesh = mesh_lib.make_mesh(hp, 'cpu')
    local = mesh_lib.shard_batch(spec['batch'], mesh)
    out = {}
    for run in spec['runs']:
        state = tacotron_state(spec, hp)
        metrics = []
        with planted(run['fault']):
            for i in range(1 if run['fault'] else spec['steps']):
                if run['noise'] == 'given':
                    m = tt.train_step(state, local, hp, noise=spec['noise'][i], mesh=mesh)
                else:
                    gen = torch.Generator().manual_seed(spec['seed'] + i)
                    m = tt.train_step(state, local, hp, gen, mesh=mesh)
                metrics.append(metrics_of(m))
        out[run['name']] = dict(metrics=metrics, state=state.state_dict())
    return out


def wavenet_dp(spec):
    """Steps of the WaveNet on this rank's rows, from a generator seeded alike on every
    rank, with and without the planted fault of the normalizers (one step)."""
    out = {}
    for run in spec['runs']:
        hp = make_hp(run['hparams'])
        mesh = mesh_lib.make_mesh(hp, 'cpu')
        local = mesh_lib.shard_batch(spec['batch'], mesh)
        state = wavenet_state(spec['state'], hp)
        metrics = []
        with planted(run['fault']):
            for i in range(1 if run['fault'] else spec['steps']):
                gen = torch.Generator().manual_seed(spec['seed'] + i)
                metrics.append(metrics_of(wt.train_step(state, local, hp, gen, mesh=mesh)))
        out[run['name']] = dict(metrics=metrics, state=state.state_dict())
    return out


def wavenet_tp(spec):
    """One tensor-parallel step over the (data, model) grid of the spec: as it is, with
    the planted fault of the GLU split, and on the audio scaled by spec['clip_scale']
    (both clips act): the metrics and the full parameters, gathered over the model
    group."""
    hp = make_hp(spec['hparams'])
    mesh = mesh_lib.make_mesh(hp, 'cpu')
    out = dict(mesh=(mesh.data_size, mesh.model_size, mesh.data_index, mesh.model_index))
    for run, fault, scale in (('none', None, 1.0), ('contiguous_glu', 'contiguous_glu', 1.0),
                              ('clipped', None, spec['clip_scale'])):
        local = mesh_lib.shard_batch(dict(spec['batch'], audio=spec['batch']['audio'] * scale),
                                     mesh)
        with planted(fault):
            state = tensor_parallel.shard_wavenet_state(wavenet_state(spec['state'], hp),
                                                        hp, mesh)
            shapes = {n: tuple(p.shape) for n, p in state.model.named_parameters()}
            m = wt.make_tp_train_step(hp, mesh)(state, local)
            out[run] = dict(
                metrics=metrics_of(m), shapes=shapes,
                params=tensor_parallel.gather_state_dict(state.model, hp, mesh))
    return out


def generate_dp(spec):
    """generate_data_parallel over every rank of the data axis, on the spec's noise."""
    from tacotron2_tpu_torch.inference import wavenet_synthesizer

    hp = make_hp(spec['hparams'])
    mesh = mesh_lib.make_mesh(hp, 'cpu')
    model = WaveNet(hp)
    model.load_state_dict(spec['state'])
    out = wavenet_synthesizer.generate_data_parallel(model.eval(), hp, spec['c'], mesh,
                                                     noise=spec['noise'])
    return dict(out, rows=(mesh.rows(spec['c'].shape[0]).start,
                           mesh.rows(spec['c'].shape[0]).stop))


def train_loop(spec):
    """`train.main` under this group's ranks (the process group it starts from the
    environment), recording each step's loss as the loop reads it and every checkpoint
    this rank writes."""
    from tacotron2_tpu_torch import train
    from tacotron2_tpu_torch.training import common
    from tacotron2_tpu_torch.training.checkpointing import CheckpointManager

    dist.barrier()
    dist.destroy_process_group()
    os.environ['MASTER_PORT'] = str(spec['port'])  # a fresh store: the old one's port may linger
    losses, saves = [], []
    resolve, save = common.StepLog._resolve, CheckpointManager.save

    def record_loss(self, step, metrics, start, end):
        losses.append((step, float(metrics['loss'])))
        return resolve(self, step, metrics, start, end)

    def record_save(self, step, state):
        saves.append(step)
        return save(self, step, state)

    common.StepLog._resolve, CheckpointManager.save = record_loss, record_save
    try:
        train.main(spec['argv'])
    finally:
        common.StepLog._resolve, CheckpointManager.save = resolve, save
    return dict(losses=losses, saves=saves, lead=distributed.is_lead())


def pipeline_loop(spec):
    """`train --model Tacotron-2` under the ranks of the group train_loop started, on
    the wavs of spec['base'], which rank 0 preprocesses while the other waits: each
    rank's result, the checkpoints it wrote and the state_log's bytes as each rank
    reads them after the run."""
    from tacotron2_tpu_torch import preprocess, train
    from tacotron2_tpu_torch.training.checkpointing import CheckpointManager

    if dist.get_rank() == 0:
        preprocess.main(['--base_dir', spec['base'], '--hparams', spec['hparams'],
                         '--n_jobs', '1'])
    distributed.barrier()
    saves, save = [], CheckpointManager.save

    def record_save(self, step, state):
        saves.append((os.path.basename(self._dir), step))
        return save(self, step, state)

    CheckpointManager.save = record_save
    try:
        state_log = train.main(spec['argv'])
    finally:
        CheckpointManager.save = save
    distributed.barrier()
    with open(state_log, 'rb') as f:
        return dict(state_log=state_log, saves=saves, state_bytes=f.read())


CHECKS = dict(tacotron_dp=tacotron_dp, wavenet_dp=wavenet_dp, wavenet_tp=wavenet_tp,
              generate_dp=generate_dp, train_loop=train_loop, pipeline_loop=pipeline_loop)


def late_spec(path: str, timeout_s: float):
    """The spec the test writes at `path` while the ranks run (whole: it renames it into
    place), once it is there."""
    deadline = time.time() + timeout_s
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f'no spec at {path} after {timeout_s} s')
        time.sleep(0.1)
    return torch.load(path, weights_only=False)


def main(spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    rank = int(os.environ['RANK'])
    assert distributed.maybe_initialize('gloo', spec['timeout_s'], 'cpu')
    results = {}
    for name in spec['checks']:
        start = time.time()
        check = spec[name]
        if isinstance(check, str):
            check = late_spec(check, spec['timeout_s'])
        results[name] = CHECKS[name](check)
        print(f'{name}: {time.time() - start:.1f} s', flush=True)
    torch.save(results, os.path.join(out_dir, f'rank{rank}.pt'))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == '__main__':
    main(*sys.argv[1:])
