"""Data, tensor and ensemble parallelism over a ``DeviceMesh``.

Port of ``tfep_tpu/parallel/sharding.py``. The scaling dimension of TFEP
is trajectory frames x atoms: there is no sequence axis, so the primary
strategy is frame-axis data parallelism over the mesh's ``dp`` axis, the
parameters replicated, the gradients averaged over ``dp``
(:class:`~tfep_tpu_torch.app.trainer.Trainer` with
``sharding=batch_sharding(mesh)``).

For large solvated systems a MADE conditioner over ``D`` degrees of
freedom holds O(D^2) weights per layer, past what replication affords.
:func:`shard_module` adds Megatron-style tensor parallelism over the MADE
stacks on the ``tp`` axis: hidden layers are column-parallel (their
output rows split), the output layer is row-parallel (its input columns
split). JAX states the same layout as shardings and lets GSPMD derive the
collectives; here they are written out as autograd Functions:

- :func:`copy_to_group` (identity forward, all-reduce backward) where a
  replicated input enters split work;
- :func:`reduce_from_group` (all-reduce forward, identity backward) for
  the row-parallel layer's partial products and its weight norm's partial
  sums of squares;
- :func:`gather_from_group` (a gather forward; backward, the all-reduced
  cotangent's own slice) before a layer whose input is split but which
  needs it whole.

Each is an ``all_reduce``, which gloo supports on CUDA tensors.
:func:`shard_ensemble` splits a stacked ensemble's members over ``dp``.

Differences from JAX: one process per device and no global arrays (a
rank holds its rows and its shards, not views of global arrays);
:func:`make_mesh` always spans every process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.nn.masked import MaskedLinear, low_precision_matmul
from tfep_tpu_torch.parallel.distributed import backend_for, gather

__all__ = ['make_mesh', 'batch_sharding', 'replicated_sharding',
           'shard_batch', 'replicate', 'tensor_parallel_specs',
           'shard_module', 'shard_ensemble', 'full_state_dict',
           'sharded_parameters', 'local_slice', 'TensorParallelLinear',
           'clip_grad_norm_',
           'copy_to_group', 'reduce_from_group', 'gather_from_group']

BATCH_AXIS = 'dp'
MODEL_AXIS = 'tp'


# =============================================================================
# Mesh and data parallelism
# =============================================================================

def make_mesh(n_devices: Optional[int] = None, axis_name: str = BATCH_AXIS,
              model_axis_size: int = 1, model_axis_name: str = MODEL_AXIS,
              device=None):
    """A ``DeviceMesh`` over every process, one device each.

    With ``model_axis_size > 1`` the ranks are laid out as a
    ``(n / model_axis_size, model_axis_size)`` grid named
    ``(axis_name, model_axis_name)``: the model-parallel groups are
    contiguous ranks (``[[0, 1], [2, 3]]`` for 2 x 2), as in JAX.

    Without a process group it makes one of a single process (NCCL on a
    card, gloo on the CPU), so a one-device run needs no launcher.

    Parameters
    ----------
    n_devices : int, optional
        The number of ranks; must be the world size (a mesh spans every
        process), which is the default.
    device : str or torch.device, optional
        The mesh's device type; defaults to ``cuda`` and raises without a
        card.
    """
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if model_axis_size > 1 and n % model_axis_size:
        raise ValueError(
            f'model_axis_size={model_axis_size} must divide the device '
            f'count ({n}).')
    if n != world:
        raise ValueError(f'A mesh spans every process: n_devices={n}, but '
                         f'the world has {world} (one device per process).')
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                world_size=1, rank=0)
    from torch.distributed.device_mesh import init_device_mesh

    if model_axis_size <= 1:
        return init_device_mesh(device.type, (n,),
                                mesh_dim_names=(axis_name,))
    return init_device_mesh(device.type, (n // model_axis_size,
                                          model_axis_size),
                            mesh_dim_names=(axis_name, model_axis_name))


@dataclass(frozen=True)
class BatchSharding:
    """Per-sample arrays split over ``axis_name`` of ``mesh``: each rank
    of the axis holds its own rows (what the ``Trainer`` reads)."""
    mesh: object
    axis_name: str = BATCH_AXIS

    @property
    def group(self):
        return self.mesh.get_group(self.axis_name)

    @property
    def size(self) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(self.axis_name))

    @property
    def rank(self) -> int:
        return self.mesh.get_local_rank(self.axis_name)


@dataclass(frozen=True)
class ReplicatedSharding:
    """Parameters replicated over every rank of ``mesh``."""
    mesh: object


def batch_sharding(mesh, axis_name: str = BATCH_AXIS) -> BatchSharding:
    """Sharding of per-sample arrays: the leading axis split over
    ``axis_name``."""
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f'The mesh has no axis {axis_name!r} (its axes: '
                         f'{mesh.mesh_dim_names}).')
    return BatchSharding(mesh, axis_name)


def replicated_sharding(mesh) -> ReplicatedSharding:
    """Sharding of parameters: fully replicated."""
    return ReplicatedSharding(mesh)


def shard_batch(batch: dict, mesh, axis_name: str = BATCH_AXIS) -> dict:
    """This rank's rows of a (global) batch dict: the leading axis cut in
    as many equal parts as ``axis_name`` has ranks."""
    sharding = batch_sharding(mesh, axis_name)
    out = {}
    for name, value in batch.items():
        value = torch.as_tensor(value)
        rows, rest = divmod(value.shape[0], sharding.size)
        if rest:
            raise ValueError(f'{name}: {value.shape[0]} rows do not split '
                             f'evenly over {sharding.size} ranks.')
        out[name] = value[sharding.rank * rows:(sharding.rank + 1) * rows]
    return out


def _broadcast_(tensor: torch.Tensor, src: int, group=None):
    """Broadcast ``tensor`` in place from the global rank ``src``."""
    if tensor.dtype == torch.bool:
        buffer = tensor.to(torch.uint8)
        dist.broadcast(buffer, src=src, group=group)
        tensor.copy_(buffer.bool())
    elif tensor.is_contiguous():
        dist.broadcast(tensor, src=src, group=group)
    else:
        buffer = tensor.contiguous()
        dist.broadcast(buffer, src=src, group=group)
        tensor.copy_(buffer)


def _tensors(tree):
    if isinstance(tree, nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for value in tree.values() for t in _tensors(value)]
    if isinstance(tree, (list, tuple)):
        return [t for value in tree for t in _tensors(value)]
    return []


@torch.no_grad()
def replicate(tree, mesh=None, group=None, src: int = 0):
    """Replicate a module (its parameters and buffers), a tensor or a
    dict/list of them: broadcast in place from rank ``src`` of ``group``
    (the whole world by default). Returns ``tree``."""
    if dist.is_initialized():
        root = src if group is None else dist.get_global_rank(group, src)
        for tensor in _tensors(tree):
            _broadcast_(tensor.data, root, group)
    return tree


# =============================================================================
# Collectives with gradients (Megatron's f, g and the gather)
# =============================================================================

def _all_reduce(tensor, group):
    tensor = tensor.clone()
    dist.all_reduce(tensor, group=group)
    return tensor


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_consumer):
        ctx.group, ctx.split_consumer = group, split_consumer
        ctx.chunk = x.shape[-1]
        return gather(x.contiguous(), -1, group)

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank(ctx.group)
        if ctx.split_consumer:
            grad = _all_reduce(grad.contiguous(), ctx.group)
        return grad.narrow(-1, rank * ctx.chunk, ctx.chunk), None, None


def copy_to_group(x, group):
    """Identity forward; the cotangent all-reduced over ``group``
    backward. Where a replicated tensor enters work split over the
    group, each rank's backward yields only its part of the gradient."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """``x`` summed over ``group`` forward; identity backward. For
    partial results whose sum every rank then uses alike."""
    return _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group, split_consumer: bool = True):
    """The ranks' last-axis slices concatenated forward; backward, this
    rank's slice of the cotangent, summed over ``group`` first when the
    whole tensor feeds work split over the group (``split_consumer``),
    whose cotangents are partial; taken as it is when it feeds work that
    every rank repeats alike."""
    return _GatherFromGroup.apply(x, group, split_consumer)


# =============================================================================
# Tensor parallelism over MADE conditioners
# =============================================================================

#: The split axis of each tensor of a column- and a row-parallel layer.
_SPLIT_DIMS = {
    'column': {'weight': 0, 'bias': 0, 'gain': 0, 'mask': 0,
               'degrees_out': 0},
    'row': {'weight': 1, 'mask': 1, 'degrees_in': 0},
    'replicated': {},
}


def _layer_kind(layer: MaskedLinear, hidden: bool, axis_size: int) -> str:
    """``'column'`` for a hidden layer, ``'row'`` for the output layer,
    ``'replicated'`` where the split axis does not divide evenly."""
    split = layer.out_features if hidden else layer.in_features
    if split % axis_size:
        return 'replicated'
    return 'column' if hidden else 'row'


def _specs(kind: str, axis_name: str) -> Dict[str, tuple]:
    specs = {}
    for name in ('weight', 'bias', 'gain', 'mask', 'degrees_in',
                 'degrees_out'):
        dim = _SPLIT_DIMS[kind].get(name)
        ndim = 2 if name in ('weight', 'gain', 'mask') else 1
        specs[name] = () if dim is None else tuple(
            axis_name if d == dim else None for d in range(ndim))
    return specs


def _mades(module: nn.Module):
    from tfep_tpu_torch.nn.conditioners.made import MADE
    return [(name, m) for name, m in module.named_modules()
            if isinstance(m, MADE)]


def tensor_parallel_specs(module: nn.Module, axis_name: str = MODEL_AXIS,
                          axis_size: Optional[int] = None) -> Dict[str, tuple]:
    """The split of every parameter and buffer of ``module``:
    ``{qualified name: spec}``, a spec naming ``axis_name`` at the split
    axis (``('tp', None)``: rows, ``(None, 'tp')``: columns) or ``()``
    (replicated), as the JAX package's ``PartitionSpec`` tree.

    MADE hidden layers are column-parallel, the output layer row-parallel;
    with ``axis_size``, a layer whose split axis it does not divide stays
    replicated. Everything else is replicated.
    """
    specs = {name: () for name, _ in module.named_parameters()}
    specs.update({name: () for name, _ in module.named_buffers()})
    for made_name, made in _mades(module):
        n_layers = len(made.layers)
        for i, layer in enumerate(made.layers):
            kind = ('column' if i < n_layers - 1 else 'row') \
                if axis_size is None else _layer_kind(
                    layer, i < n_layers - 1, axis_size)
            prefix = f'{made_name}.layers.{i}.' if made_name else \
                f'layers.{i}.'
            for name, spec in _specs(kind, axis_name).items():
                if prefix + name in specs:
                    specs[prefix + name] = spec
    return specs


class TensorParallelLinear(MaskedLinear):
    """One rank's shard of a :class:`MaskedLinear` over a process group.

    ``kind`` is ``'column'`` (the output rows split: ``weight``,
    ``mask``, ``gain``, ``bias`` and ``degrees_out``), ``'row'`` (the
    input columns split: ``weight``, ``mask`` and ``degrees_in``; the
    partial products and the weight norm's sums of squares all-reduced)
    or ``'replicated'`` (whole, where the split axis does not divide).
    The input may come whole or split (the previous layer's output); each
    kind takes what it needs from either.

    ``state_dict`` holds this rank's shards; :func:`full_state_dict`
    gathers them. ``load_state_dict`` takes shards or whole tensors, which
    it cuts to this rank's shard, so a checkpoint of the whole module
    loads into the sharded one.
    """

    def __init__(self, layer: MaskedLinear, kind: str, group):
        nn.Module.__init__(self)
        self.kind = kind
        self.group = group
        self.tp_rank = dist.get_rank(group)
        self.tp_size = dist.get_world_size(group)
        self.split_dims = dict(_SPLIT_DIMS[kind])
        self.full_in_features = layer.in_features
        self.full_out_features = layer.out_features
        self.strictly_less = layer.strictly_less
        self.compute_dtype = layer.compute_dtype
        self.use_weight_norm = layer.use_weight_norm
        self.full_shapes = {}
        # The whole connectivity, for full_state_dict (it never changes).
        self.full_structure = {}
        for name in ('weight', 'bias', 'gain'):
            value = getattr(layer, name)
            if value is not None:
                self.full_shapes[name] = tuple(value.shape)
                value = nn.Parameter(self._local(value.detach(), name),
                                     requires_grad=value.requires_grad)
            setattr(self, name, value)
        for name in ('mask', 'degrees_in', 'degrees_out'):
            value = getattr(layer, name)
            if value is not None:
                self.full_shapes[name] = tuple(value.shape)
                self.full_structure[name] = value.detach().cpu().clone()
                value = self._local(value, name)
            self.register_buffer(name, value)

    @property
    def in_features(self) -> int:
        return self.full_in_features

    @property
    def out_features(self) -> int:
        return self.full_out_features

    def _local(self, value: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's shard of a whole tensor (itself if not split)."""
        return local_slice(value, self.split_dims.get(name), self.tp_rank,
                           self.tp_size)

    def forward(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        if self.kind == 'replicated':
            if x.shape[-1] != self.full_in_features:
                x = gather_from_group(x, self.group, split_consumer=False)
            return super().forward(x, rows)
        if self.kind == 'column':
            if rows is not None:
                raise ValueError('A column-parallel layer computes all its '
                                 'rows.')
            if x.shape[-1] == self.full_in_features:
                x = copy_to_group(x, self.group)
            else:
                x = gather_from_group(x, self.group)
            return super().forward(x, None)
        local = self.full_in_features // self.tp_size
        if x.shape[-1] == self.full_in_features:
            x = copy_to_group(x, self.group).narrow(
                -1, self.tp_rank * local, local)
        w = self.weight if rows is None else self.weight[rows]
        w = self._masked(w, rows)
        if self.use_weight_norm:
            # The row's norm spans every rank's columns: all-reduce the
            # partial sums of squares before the guard (one rank's part may
            # be 0 where the row's is not).
            sq = reduce_from_group(torch.sum(w * w, dim=1, keepdim=True),
                                   self.group)
            norms = torch.sqrt(torch.where(sq > 0.0, sq, 1.0))
            gain = self.gain if rows is None else self.gain[rows]
            w = (copy_to_group(gain, self.group) * w
                 / copy_to_group(norms, self.group))
        y = reduce_from_group(low_precision_matmul(x, w, self.compute_dtype),
                              self.group)
        if self.bias is not None:
            y = y + (self.bias if rows is None else self.bias[rows])
        return y

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name, shape in self.full_shapes.items():
            value = state_dict.get(prefix + name)
            if value is not None and tuple(value.shape) == shape:
                state_dict[prefix + name] = self._local(value, name)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def local_slice(value: torch.Tensor, dim: Optional[int], rank: int,
                size: int) -> torch.Tensor:
    """Rank ``rank`` of ``size``'s contiguous slice of ``value`` along
    ``dim`` (``value`` itself for ``dim=None``)."""
    if dim is None:
        return value
    chunk = value.shape[dim] // size
    return value.narrow(dim, rank * chunk, chunk).clone()


def _tp_layers(module: nn.Module):
    for name, layer in module.named_modules():
        if isinstance(layer, TensorParallelLinear) and layer.split_dims:
            yield name, layer


def sharded_parameters(module: nn.Module) -> Dict[str, tuple]:
    """``{qualified parameter name: (split axis, process group)}`` of the
    tensor-parallel shards of ``module`` (empty when nothing is split)."""
    out = {}
    for name, layer in _tp_layers(module):
        for pname, dim in layer.split_dims.items():
            if isinstance(getattr(layer, pname), nn.Parameter):
                out[f'{name}.{pname}' if name else pname] = (dim,
                                                             layer.group)
    return out


def full_state_dict(module: nn.Module) -> dict:
    """``module.state_dict()`` with each tensor-parallel shard gathered
    into the whole tensor: the state of the unsharded module, which the
    unsharded port loads. A collective: every rank of each
    tensor-parallel group must call it."""
    state = module.state_dict()
    for name, layer in _tp_layers(module):
        prefix = f'{name}.' if name else ''
        for pname, dim in layer.split_dims.items():
            key = prefix + pname
            if state.get(key) is None:
                continue
            if pname in layer.full_structure:
                state[key] = layer.full_structure[pname].to(
                    state[key].device)
            else:
                state[key] = gather(state[key], dim, layer.group)
    return state


@torch.no_grad()
def clip_grad_norm_(module: nn.Module, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``module`` to global norm ``max_norm`` where
    their norm exceeds it (``optax.clip_by_global_norm``'s rule); returns
    the norm.

    The norm is the whole model's: the squares of each tensor-parallel
    shard are summed over its group, those of replicated parameters
    counted once, so every rank scales by the same factor as the
    unsharded module would.
    """
    shards = sharded_parameters(module)
    replicated, split = [], {}
    for name, p in module.named_parameters():
        if p.grad is None:
            continue
        square = torch.sum(p.grad.double() ** 2)
        if name in shards:
            group = shards[name][1]
            split.setdefault(group, []).append(square)
        else:
            replicated.append(square)
    total = torch.stack(replicated).sum() if replicated else 0.0
    for group, squares in split.items():
        total = total + _all_reduce(torch.stack(squares).sum(), group)
    norm = torch.sqrt(torch.as_tensor(total))
    if norm > max_norm:
        for p in module.parameters():
            if p.grad is not None:
                p.grad.mul_((max_norm / norm).to(p.grad.dtype))
    return norm


def shard_module(module: nn.Module, mesh, axis_name: str = MODEL_AXIS):
    """Split the MADE conditioners of ``module`` over ``axis_name``.

    On a mesh without that axis (data only) this is :func:`replicate`.
    Otherwise the module is first replicated from rank 0, then each MADE
    layer is replaced, in place, by its :class:`TensorParallelLinear`
    shard on this rank: hidden layers column-parallel, the output layer
    row-parallel, a layer whose split axis the axis size does not divide
    replicated. Returns ``module``.
    """
    replicate(module, mesh)
    if axis_name not in mesh.mesh_dim_names:
        return module
    group = mesh.get_group(axis_name)
    size = dist.get_world_size(group)
    for _, made in _mades(module):
        n_layers = len(made.layers)
        kinds = [_layer_kind(layer, i < n_layers - 1, size)
                 for i, layer in enumerate(made.layers)]
        if all(kind == 'replicated' for kind in kinds):
            continue
        for i, kind in enumerate(kinds):
            made.layers[i] = TensorParallelLinear(made.layers[i], kind,
                                                  group)
    return module


# =============================================================================
# Ensembles split over their members
# =============================================================================

def shard_ensemble(stacked: nn.Module, mesh, axis_name: str = BATCH_AXIS,
                   n_members: Optional[int] = None) -> nn.Module:
    """Keep this rank's members of a stacked ensemble.

    Members (:func:`tfep_tpu_torch.nn.ensemble.stack_modules`) are
    independent, so each rank of ``axis_name`` keeps its ``K / size``
    consecutive members (the leading axis of every parameter, cut in
    place) and trains them with no collective; the buffers stay
    replicated. An optimizer built afterwards
    (:func:`~tfep_tpu_torch.nn.ensemble.ensemble_init`) holds this rank's
    members' state.

    Parameters
    ----------
    n_members : int, optional
        The expected member count K. Pass it whenever available: the
        check that every parameter shares its leading axis cannot tell a
        stacked ensemble from a plain module whose parameters happen to
        agree on their first dimension.
    """
    from tfep_tpu_torch.nn import ensemble

    k = ensemble.n_members(stacked)
    trainable = [p for p in stacked.parameters() if p.requires_grad]
    axis0 = {p.shape[0] if p.ndim else None for p in trainable}
    if axis0 != {k}:
        raise ValueError(
            f'Not a stacked ensemble: trainable leaves disagree on the '
            f'leading (member) axis ({sorted(map(str, axis0))}). Build '
            f'the input with tfep_tpu_torch.nn.ensemble.stack_modules.')
    if n_members is not None and k != n_members:
        raise ValueError(
            f'The input looks like a {k}-member ensemble but n_members='
            f'{n_members} was expected — is this really the output of '
            f'stack_modules?')
    sharding = batch_sharding(mesh, axis_name)
    if k % sharding.size:
        raise ValueError(
            f'The member count ({k}) must be divisible by the '
            f'{axis_name!r} mesh axis size ({sharding.size}).')
    replicate(stacked, mesh)
    per_rank = k // sharding.size
    start = sharding.rank * per_rank
    for name, p in list(stacked.named_parameters()):
        ensemble._set_parameter(stacked, name,
                                p.detach()[start:start + per_rank].clone())
    return stacked
