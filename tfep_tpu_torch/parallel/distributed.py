"""Multi-process training: process groups, frame shards and per-rank logs.

Port of ``tfep_tpu/parallel/distributed.py``. JAX runs one process per
host over a global device mesh and assembles global arrays from each
host's rows; here each process drives one device (``torch.distributed``,
one rank per card, or ranks on the CPU over gloo), and there is no global
array: a rank holds its own rows, and a value every rank needs (the loss,
the averaged gradients) is made by a collective. :func:`initialize` wires
the process group, each rank feeds its own shard of the trajectory frames
(:func:`host_frame_indices`) and logs to its own TFEP logger directory
(:func:`host_logger_dir`); the logger's addressing is position-independent,
so analysis concatenates the ranks' rows (:func:`all_hosts_work_values`).

Every collective here is an ``all_reduce`` or a ``broadcast``: gloo
supports both on CUDA tensors but not ``all_gather``, so a gather is an
all-reduce of a zero-filled buffer in which each rank writes its slice
(:func:`gather`). It is exact: each element is one rank's value plus
zeros.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tfep_tpu_torch.device import resolve_device

__all__ = ['initialize', 'is_distributed', 'process_index', 'process_count',
           'host_frame_indices', 'host_logger_dir', 'all_hosts_work_values',
           'global_rows_from_local', 'make_global_batch', 'gather',
           'backend_for']


def backend_for(device) -> str:
    """The process-group backend of a device: NCCL for a card, gloo for
    the CPU."""
    return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, device=None,
               timeout: Optional[float] = None):
    """Initialize the default process group (a no-op for one process).

    Wraps ``torch.distributed.init_process_group``. With no arguments it
    joins the group that the launcher describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torchrun`` sets them) and is a single-process no-op outside such a
    launch. With explicit arguments a misconfigured launch raises instead:
    quietly running every process as a job of its own would train
    unrelated models. A second call is benign.

    Parameters
    ----------
    backend : str, optional
        ``'nccl'`` or ``'gloo'``; by default the device's
        (:func:`backend_for`). Two ranks on one card must use gloo: NCCL
        refuses them.
    init_method : str, optional
        E.g. ``'tcp://localhost:29500'``; ``env://`` by default.
    world_size, rank : int, optional
    device : str or torch.device, optional
        Decides the backend when none is given; defaults to ``cuda`` and
        raises without a card.
    timeout : float, optional
        Seconds a collective may wait before the group fails.
    """
    if world_size is not None and world_size <= 1:
        return
    if dist.is_initialized():
        return
    explicit = any(a is not None for a in (init_method, world_size, rank))
    if not explicit and 'WORLD_SIZE' not in os.environ:
        return
    if (world_size is None) != (rank is None):
        raise ValueError('Pass both world_size and rank to initialize '
                         f'(got world_size={world_size}, rank={rank}).')
    if world_size is not None and not 0 <= rank < world_size:
        raise ValueError(f'rank={rank} is outside the world of '
                         f'{world_size} processes.')
    if backend is None:
        backend = backend_for(resolve_device(device))
    kwargs = {}
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)


def is_distributed() -> bool:
    """Whether this run spans more than one process."""
    return process_count() > 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def host_frame_indices(n_frames: int, process_id: Optional[int] = None,
                       n_processes: Optional[int] = None) -> np.ndarray:
    """This rank's contiguous shard of trajectory-frame indices.

    Shards are exactly equal-sized: every rank must run the same number
    of same-sized batches per epoch, or the ranks' collectives
    desynchronize (one rank enters a step the others never join) and the
    average of the local losses is no longer the global batch's mean. The
    trailing ``n_frames % n_processes`` frames are therefore dropped, with
    a warning, rather than dealt unevenly.
    """
    if process_id is None:
        process_id = process_index()
    if n_processes is None:
        n_processes = process_count()
    per_host, remainder = divmod(n_frames, n_processes)
    if per_host == 0:
        raise ValueError(
            f'Cannot shard {n_frames} frames over {n_processes} hosts: '
            'every host needs at least one frame.')
    if remainder:
        warnings.warn(
            f'host_frame_indices: dropping the trailing {remainder} of '
            f'{n_frames} frames so all {n_processes} hosts hold equal '
            'shards (unequal shards desynchronize the hosts\' batch '
            'counts).', stacklevel=2)
    return np.arange(process_id * per_host, (process_id + 1) * per_host)


def _on_group_device(tensor: torch.Tensor, group) -> torch.Tensor:
    """``tensor`` where the group's backend can reduce it: NCCL reduces
    only on the card."""
    if dist.get_backend(group) == 'nccl' and not tensor.is_cuda:
        return tensor.cuda()
    return tensor


def gather(tensor: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The ranks' equal-sized ``tensor`` concatenated along ``dim`` in
    rank order, on every rank of ``group``.

    An all-reduce of a zero-filled buffer in which each rank writes its
    slice (gloo has no ``all_gather`` for CUDA tensors); exact. Without a
    process group it returns ``tensor``. Not differentiable: the
    tensor-parallel layers' differentiable gather is
    :func:`tfep_tpu_torch.parallel.sharding.gather_from_group`.
    """
    if not dist.is_initialized():
        return tensor
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    tensor = _on_group_device(tensor.detach(), group)
    dim = dim % tensor.ndim
    shape = list(tensor.shape)
    chunk = shape[dim]
    shape[dim] = chunk * size
    # Booleans and integers travel as float64 (exact below 2**53).
    wire = tensor.dtype if tensor.is_floating_point() else torch.float64
    out = torch.zeros(shape, dtype=wire, device=tensor.device)
    out.narrow(dim, rank * chunk, chunk).copy_(tensor)
    dist.all_reduce(out, group=group)
    return out.to(tensor.dtype)


def global_rows_from_local(local_rows, sharding=None) -> torch.Tensor:
    """The global rows (every rank's ``local_rows`` concatenated in rank
    order along the first axis) on every rank: the value that a JAX
    global array with a frames-axis sharding holds.

    ``sharding`` is a :func:`~tfep_tpu_torch.parallel.sharding.
    batch_sharding` (the rows are gathered over its axis, e.g. ``dp`` of a
    ``(dp, tp)`` mesh, whose ``tp`` ranks share their rows) or ``None``
    (the whole world). Every rank must pass the same number of rows.
    """
    rows = torch.as_tensor(local_rows)
    if not dist.is_initialized():
        return rows
    group = None if sharding is None else sharding.group
    return gather(rows, 0, group)


def make_global_batch(batch: dict, mesh=None, axis_name: str = 'dp') -> dict:
    """Each rank's local batch as the global batch (the ranks' rows
    concatenated in rank order), on every rank, key by key."""
    from tfep_tpu_torch.parallel.sharding import batch_sharding

    sharding = None if mesh is None else batch_sharding(mesh, axis_name)
    return {name: global_rows_from_local(value, sharding)
            for name, value in batch.items()}


def host_logger_dir(base_dir: str, process_id: Optional[int] = None) -> str:
    """Per-rank TFEP logger directory (a logger is single-process)."""
    if process_id is None:
        process_id = process_index()
    return os.path.join(base_dir, f'host-{process_id}')


def all_hosts_work_values(base_dir: str, epoch_idx: int,
                          n_hosts: Optional[int] = None,
                          names: Sequence[str] = ('potential', 'log_det_J',
                                                  'dataset_sample_index')):
    """Concatenate the ranks' logged train tensors of an epoch.

    Reads ``host-*/train`` under ``base_dir``, written by this package's
    or the JAX package's :class:`TFEPLogger` (the files are the same).
    Returns a dict of numpy arrays, the ranks' rows in rank order.
    """
    from tfep_tpu_torch.io.log import TFEPLogger

    if n_hosts is None:
        n_hosts = len([d for d in os.listdir(base_dir)
                       if d.startswith('host-')])
    collected = {name: [] for name in names}
    for host in range(n_hosts):
        logger = TFEPLogger(save_dir_path=host_logger_dir(base_dir, host))
        data = logger.read_train_tensors(names=list(names),
                                         epoch_idx=epoch_idx)
        for name in names:
            collected[name].append(data[name])
    return {name: np.concatenate(values)
            for name, values in collected.items()}
