"""Multi-process start-up over `torch.distributed` (counterpart of
`tacotron2_tpu/parallel/distributed.py:24-67`).

A run under several ranks is started by torchrun, one process a rank:

    torchrun --nproc_per_node=N -m tacotron2_tpu_torch.train --model Tacotron ...

torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and
MASTER_PORT; `maybe_initialize` reads them and joins the process group with an explicit
backend (nccl on a CUDA device, gloo on the CPU by default) and an explicit timeout, so
that a lost rank fails the run instead of hanging it. Each rank runs on its own device,
`cuda:LOCAL_RANK` unless the caller names one (`rank_device`).

Divergence from the JAX package: `distributed.py:58-60` catches a failed
`jax.distributed.initialize` and continues in one process. Here a failed start raises:
a rank that silently trains alone computes another run than the one asked for. Nothing
falls back to one process, to the CPU or to gloo unless the caller asks for it.
"""

import datetime
import functools
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

ENV_KEYS = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')
DEFAULT_TIMEOUT_S = 1800.0
# rank 0's work alone (the pipeline's GTA synthesis of a corpus, a natural eval) may
# outlast the timeout that catches a lost rank: the other ranks wait for it in a group
# of their own with this timeout
LEAD_WAIT_TIMEOUT_S = 24 * 3600.0


def requested() -> bool:
    """Whether the environment asks for a process group (torchrun's WORLD_SIZE or
    RANK is set)."""
    return 'WORLD_SIZE' in os.environ or 'RANK' in os.environ


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def rank_device(requested_device: Optional[str] = 'cuda') -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` for a bare 'cuda' (or None) under a process
    group request, else the device named ('cpu', 'cuda:1', ...). One process without a
    process group keeps 'cuda' as it is."""
    name = requested_device or 'cuda'
    device = torch.device(name)
    if device.type == 'cuda' and device.index is None and requested():
        return torch.device('cuda', int(os.environ.get('LOCAL_RANK', '0')))
    return device


def check_devices(backend: str, device, local_world_size: int, named: bool,
                  cuda_count: int) -> None:
    """Raise where the ranks of one node cannot run as asked: NCCL refuses two ranks on
    one device (several local ranks given one named CUDA device), and a rank's
    `cuda:LOCAL_RANK` must exist. `named`: the device index came from the caller, not
    from LOCAL_RANK."""
    device = torch.device(device)
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError(f'the nccl backend needs a CUDA device, not {device}')
    if backend == 'nccl' and named and local_world_size > 1:
        raise ValueError(
            f'nccl cannot run {local_world_size} ranks of one node on the one device '
            f'{device}: give each rank its own card, or ask for --dist_backend gloo')
    if device.type == 'cuda' and device.index is not None and device.index >= cuda_count:
        raise ValueError(f'{device} does not exist: torch sees {cuda_count} CUDA devices')


def maybe_initialize(backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
                     device: Optional[str] = 'cuda') -> bool:
    """Join the process group that torchrun's environment describes, this rank on
    `rank_device(device)` (`device` as the caller asked for it: 'cuda', 'cuda:0',
    'cpu'). Returns False, and does nothing, where the environment asks for none; True
    where a group is (already) up. Raises where the environment is incomplete
    (WORLD_SIZE without MASTER_ADDR fails at once, not after a timeout), the devices
    cannot serve the backend (`check_devices`) or the start fails."""
    if dist.is_available() and dist.is_initialized():
        return True
    if not requested():
        return False
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError('a process group needs {} in the environment; {} missing '
                           '(start the run with torchrun)'.format(', '.join(ENV_KEYS),
                                                                  ', '.join(missing)))
    mine = rank_device(device)
    backend = backend or default_backend(mine)
    world = int(os.environ['WORLD_SIZE'])
    check_devices(backend, mine, int(os.environ.get('LOCAL_WORLD_SIZE', world)),
                  named=torch.device(device or 'cuda').index is not None,
                  cuda_count=torch.cuda.device_count() if mine.type == 'cuda' else 0)
    if mine.type == 'cuda':
        torch.cuda.set_device(mine)
    dist.init_process_group(backend=backend, init_method='env://',
                            rank=int(os.environ['RANK']), world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def process_shard() -> Optional[Tuple[int, int]]:
    """(rank, world size) where a process group is up, else None (one process)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return None


def is_lead() -> bool:
    """Whether this process writes the run's files: rank 0, or the one process."""
    shard = process_shard()
    return shard is None or shard[0] == 0


@functools.lru_cache(maxsize=None)
def _lead_wait_group(world: dist.ProcessGroup) -> dist.ProcessGroup:
    """The gloo group over every rank of the default group `world` (a new one after a
    restart) in which ranks wait for rank 0's work alone, LEAD_WAIT_TIMEOUT_S."""
    return dist.new_group(backend='gloo',
                          timeout=datetime.timedelta(seconds=LEAD_WAIT_TIMEOUT_S))


def broadcast_str(value: str, src: int = 0) -> str:
    """Rank `src`'s string on every rank (a path rank 0 wrote), once it has it: the
    other ranks wait up to LEAD_WAIT_TIMEOUT_S. As it is in one process."""
    if process_shard() is None:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src, group=_lead_wait_group(dist.group.WORLD))
    return box[0]


def barrier() -> None:
    """Wait for every rank, up to LEAD_WAIT_TIMEOUT_S (the others wait out rank 0's work
    alone); nothing in one process."""
    if process_shard() is not None:
        dist.barrier(group=_lead_wait_group(dist.group.WORLD))
