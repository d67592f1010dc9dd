"""One rank of the port's tensor- and ensemble-parallel tests.

Launched by ``tests/test_torch_sharding.py`` as
``python torch_sharding_worker.py PORT RANK WORLD WORKDIR`` with 4 ranks:
joins a gloo process group on the CPU (float64), runs each case, and
saves what the parent asserts on to ``WORKDIR/result-RANK.pt``. It never
imports JAX: the parent leaves the JAX spline MAF's weights, the input
and the JAX forward in ``WORKDIR/jax_flow.pt``.

Cases: (a) ``shard_module`` on the 2 x 2 ``(dp, tp)`` mesh and on a
``tp`` axis of 4: the forward and the gradients against the replicated
flow, each rank's MADE tensors against the slices of the whole ones;
(b) widths that the ``tp`` size does not divide, and a data-only mesh;
(c) ``Trainer`` on a 2 x 2 sharded ``CartesianMAFMap`` against one
process on the global batches, a stopped and resumed run, the whole
checkpoint loaded unsharded; (d) ``shard_ensemble`` with 4 members over
the 2 ``dp`` ranks of the 2 x 2 mesh.
"""

import copy
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tfep_tpu_torch.app import (  # noqa: E402
    CartesianMAFMap, Trainer, load_map_from_checkpoint,
)
from tfep_tpu_torch.convert import load_jax_state  # noqa: E402
from tfep_tpu_torch.io.dataset import Subset  # noqa: E402
from tfep_tpu_torch.io.topology import Topology  # noqa: E402
from tfep_tpu_torch.io.traj import System  # noqa: E402
from tfep_tpu_torch.nn import (  # noqa: E402
    ensemble_init, make_ensemble_train_step, stack_modules, unstack_module,
)
from tfep_tpu_torch.nn.conditioners.made import (  # noqa: E402
    MADE, generate_degrees,
)
from tfep_tpu_torch.nn.flows import MAF, SequentialFlow  # noqa: E402
from tfep_tpu_torch.nn.transformers import (  # noqa: E402
    NeuralSplineTransformer,
)
from tfep_tpu_torch.parallel import distributed as D  # noqa: E402
from tfep_tpu_torch.parallel import sharding as S  # noqa: E402
from tfep_tpu_torch.units import ureg  # noqa: E402

DTYPE = torch.float64
DIM, HIDDEN, N_LAYERS, N_BINS = 24, (96, 96), 2, 4
N_FRAMES, N_ATOMS, LOCAL_BATCH, N_DP, N_TP = 32, 4, 4, 2, 2
MAP_HIDDEN, MAP_EPOCHS, STOP_STEP = [32, 32], 2, 3
N_MEMBERS, ENSEMBLE_FEATURES, ENSEMBLE_BATCH, ENSEMBLE_STEPS = 4, 6, 8, 3
TIMEOUT_S = 120


def spline_maf(hidden=HIDDEN, seed=0):
    """The port's counterpart of the parent's JAX spline MAF."""
    generator = torch.Generator().manual_seed(seed)
    bound = 3.0 * np.ones(DIM)
    return SequentialFlow.create(*[MAF.create(
        generator, generate_degrees(
            DIM, order='ascending' if i % 2 == 0 else 'descending'),
        transformer=NeuralSplineTransformer(-bound, bound, N_BINS,
                                            device='cpu', dtype=DTYPE),
        hidden_layers=list(hidden), initialize_identity=False,
        device='cpu', dtype=DTYPE) for i in range(N_LAYERS)], device='cpu')


def loss_of(flow, x):
    y, ldj = flow(x)
    return torch.mean(0.5 * torch.sum(y ** 2, dim=-1) - ldj)


def made_layers(flow):
    return [layer for m in flow.modules() if isinstance(m, MADE)
            for layer in m.layers]


def compare_sharded(flow, reference, x):
    """The sharded flow's forward and gradients against the replicated
    ``reference``'s, and each shard against its slice of the whole
    tensor: ``(y, ldj, max forward diff, max gradient diff, max slice
    diff, [(kind, weight shape)])``."""
    y, ldj = flow(x)
    y_ref, ldj_ref = reference(x)
    forward = max(float((y - y_ref).abs().max()),
                  float((ldj - ldj_ref).abs().max()))
    grads = torch.autograd.grad(loss_of(flow, x), list(flow.parameters()))
    grads_ref = torch.autograd.grad(loss_of(reference, x),
                                    list(reference.parameters()))
    named_ref = dict(zip([n for n, _ in reference.named_parameters()],
                         grads_ref))
    whole = dict(reference.named_parameters())
    whole.update(reference.named_buffers())
    gradient = slices = 0.0
    shapes = []
    layers = dict(flow.named_modules())
    for (name, p), g in zip(flow.named_parameters(), grads):
        owner, _, leaf = name.rpartition('.')
        layer = layers[owner]
        split = getattr(layer, 'split_dims', {}).get(leaf)
        rank, size = (dist.get_rank(layer.group),
                      dist.get_world_size(layer.group)) \
            if split is not None else (0, 1)
        expected = S.local_slice(named_ref[name], split, rank, size)
        gradient = max(gradient, float((g - expected).abs().max()))
        sliced = S.local_slice(whole[name].detach(), split, rank, size)
        slices = max(slices, float((p.detach() - sliced).abs().max()))
    for layer in made_layers(flow):
        shapes.append((getattr(layer, 'kind', 'plain'),
                       tuple(layer.weight.shape)))
        for name in ('degrees_in', 'degrees_out'):
            if getattr(layer, 'split_dims', {}).get(name) is not None:
                full = layer.full_structure[name]
                sliced = S.local_slice(full, 0, layer.tp_rank,
                                       layer.tp_size)
                slices = max(slices, float(
                    (getattr(layer, name).cpu() - sliced).abs().max()))
    return (y.detach().numpy(), ldj.detach().numpy(), forward, gradient,
            slices, shapes)


def tensor_parallel_case(workdir, meshes, result):
    """(a) and (b)."""
    saved = torch.load(os.path.join(workdir, 'jax_flow.pt'),
                       weights_only=False)
    x = torch.as_tensor(saved['x'], dtype=DTYPE)
    for name, mesh in (('2x2', meshes['2x2']), ('tp4', meshes['tp4'])):
        flow = load_jax_state(spline_maf(), saved['state'])
        reference = copy.deepcopy(flow)
        specs = S.tensor_parallel_specs(
            flow, axis_size=mesh.size(mesh.mesh_dim_names.index('tp')))
        S.shard_module(flow, mesh)
        result[name] = compare_sharded(flow, reference, x)
        result[name + '_specs'] = {k: v for k, v in specs.items()
                                   if 'conditioner.layers' in k}
    # The whole model's gradient norm, clipped alike on every rank.
    flow = load_jax_state(spline_maf(), saved['state'])
    reference = copy.deepcopy(flow)
    S.shard_module(flow, meshes['2x2'])
    loss_of(flow, x).backward()
    loss_of(reference, x).backward()
    norm = S.clip_grad_norm_(flow, 0.1)
    # optax.clip_by_global_norm's rule (torch's clip_grad_norm_ adds 1e-6
    # to the norm).
    norm_ref = torch.sqrt(sum(torch.sum(p.grad ** 2)
                              for p in reference.parameters()))
    whole = {n: p.grad * min(1.0, 0.1 / float(norm_ref))
             for n, p in reference.named_parameters()}
    clipped = 0.0
    for name, p in flow.named_parameters():
        owner, _, leaf = name.rpartition('.')
        layer = dict(flow.named_modules())[owner]
        split = getattr(layer, 'split_dims', {}).get(leaf)
        expected = whole[name] if split is None else S.local_slice(
            whole[name], split, layer.tp_rank, layer.tp_size)
        clipped = max(clipped, float((p.grad - expected).abs().max()))
    result['clip'] = (float(norm), float(norm_ref), clipped)
    for hidden in ((96, 85), (85,)):
        flow = spline_maf(hidden, seed=1)
        reference = copy.deepcopy(flow)
        S.shard_module(flow, meshes['2x2'])
        result[f'hidden{hidden}'] = compare_sharded(flow, reference, x)
    flow = spline_maf(seed=2)
    with torch.no_grad():
        made_layers(flow)[0].weight.fill_(float(dist.get_rank()))
    S.shard_module(flow, meshes['dp'])
    layer = made_layers(flow)[0]
    result['data_only'] = (type(layer).__name__,
                           float(layer.weight.abs().max()))


class Potential:
    """u(x) = sum(x^2), as in tests/parallel/multihost_tp_worker.py."""
    energy_unit = ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return torch.sum(x ** 2, dim=-1)


class GlobalBatches(CartesianMAFMap):
    """The frames in the order of the 2 x 2 run's global batches."""

    def create_dataset(self):
        shards = np.arange(N_FRAMES).reshape(N_DP, -1, LOCAL_BATCH)
        return Subset(super().create_dataset(),
                      shards.transpose(1, 0, 2).reshape(-1))


def cartesian_map(map_class=CartesianMAFMap, batch_size=LOCAL_BATCH):
    positions = np.random.default_rng(321).normal(size=(N_FRAMES, N_ATOMS,
                                                        3))
    return map_class(
        potential_energy_func=Potential(), temperature=300.0 * ureg.kelvin,
        system=System(Topology(names=[f'C{i}' for i in range(N_ATOMS)]),
                      positions),
        batch_size=batch_size, n_maf_layers=2,
        flow_kwargs={'hidden_layers': MAP_HIDDEN}, tfep_logger_dir_path=None,
        seed=7, device='cpu', dtype=DTYPE)


def sharded_fit(mesh, save_dir, max_steps=None, resume=False):
    tfep_map = cartesian_map()
    tfep_map.setup()
    S.shard_module(tfep_map.flow, mesh)
    trainer = Trainer(save_dir=save_dir, max_epochs=MAP_EPOCHS,
                      max_steps=max_steps, shuffle=False,
                      sharding=S.batch_sharding(mesh))
    trainer.fit(tfep_map, resume=resume)
    return tfep_map, trainer


def whole_weights(flow):
    return {k: v.numpy().copy() for k, v in S.full_state_dict(flow).items()
            if v.is_floating_point()}


def trainer_case(workdir, mesh, result):
    """(c)."""
    ckpt = os.path.join(workdir, 'tp-ckpt')
    tfep_map, trainer = sharded_fit(mesh, ckpt)
    result['tp_fit'] = dict(
        global_step=trainer.global_step, losses=list(trainer.loss_history),
        weights=whole_weights(tfep_map.flow),
        shapes=[(getattr(layer, 'kind', 'plain'), tuple(layer.weight.shape))
                for layer in made_layers(tfep_map.flow)],
        frames=D.host_frame_indices(N_FRAMES, S.batch_sharding(mesh).rank,
                                    N_DP).tolist())

    control = cartesian_map(GlobalBatches, batch_size=N_DP * LOCAL_BATCH)
    control_trainer = Trainer(save_dir=None, max_epochs=MAP_EPOCHS,
                              shuffle=False)
    control_trainer.fit(control)
    result['control'] = dict(
        losses=list(control_trainer.loss_history),
        weights={k: v.detach().numpy().copy()
                 for k, v in control.flow.state_dict().items()
                 if v.is_floating_point()})

    resumed_ckpt = os.path.join(workdir, 'tp-resume-ckpt')
    sharded_fit(mesh, resumed_ckpt, max_steps=STOP_STEP)
    tfep_map, trainer = sharded_fit(mesh, resumed_ckpt, resume=True)
    result['tp_resume'] = dict(
        global_step=trainer.global_step, weights=whole_weights(tfep_map.flow),
        kinds=[getattr(layer, 'kind', 'plain')
               for layer in made_layers(tfep_map.flow)])
    dist.barrier()
    if dist.get_rank() == 0:
        loaded = load_map_from_checkpoint(os.path.join(ckpt, 'last.ckpt'))
        result['loaded'] = dict(
            types=sorted({type(layer).__name__
                          for layer in made_layers(loaded.flow)}),
            weights={k: v.detach().numpy().copy()
                     for k, v in loaded.flow.state_dict().items()
                     if v.is_floating_point()})


def ensemble_members(k=N_MEMBERS):
    return [MAF.create(torch.Generator().manual_seed(10 + i),
                       generate_degrees(ENSEMBLE_FEATURES), hidden_layers=2,
                       initialize_identity=False, device='cpu', dtype=DTYPE)
            for i in range(k)]


def train_ensemble(stacked, batches):
    optimizer = ensemble_init(
        lambda p: torch.optim.AdamW(p, lr=1e-2, weight_decay=1e-4), stacked)
    step = make_ensemble_train_step(loss_of, optimizer)
    return [step(stacked, b).detach().numpy() for b in batches]


def ensemble_case(mesh, result):
    """(d)."""
    rng = np.random.default_rng(40)
    batches = [torch.as_tensor(rng.normal(size=(ENSEMBLE_BATCH,
                                                ENSEMBLE_FEATURES)))
               for _ in range(ENSEMBLE_STEPS)]
    reference = stack_modules(ensemble_members())
    sharded = copy.deepcopy(reference)
    reference_losses = train_ensemble(reference, batches)
    S.shard_ensemble(sharded, mesh, 'dp', n_members=N_MEMBERS)
    losses = train_ensemble(sharded, batches)
    per_rank = N_MEMBERS // N_DP
    start = S.batch_sharding(mesh).rank * per_rank
    members = unstack_module(sharded)
    expected = unstack_module(reference)[start:start + per_rank]
    weight_diff = max(
        float((p - q).abs().max())
        for a, b in zip(members, expected)
        for p, q in zip(a.parameters(), b.parameters()))
    errors = {}
    for name, build in (
            ('uneven', lambda: stack_modules(ensemble_members(3))),
            ('unstacked', lambda: ensemble_members(1)[0]),
            ('count', lambda: stack_modules(ensemble_members(2)))):
        try:
            S.shard_ensemble(build(), mesh, 'dp',
                             n_members=N_MEMBERS if name == 'count'
                             else None)
        except ValueError as error:
            errors[name] = str(error)
    result['ensemble'] = dict(
        members=len(members), losses=np.stack(losses),
        expected=np.stack(reference_losses)[:, start:start + per_rank],
        weight_diff=weight_diff, errors=errors)


def main():
    port, rank, world, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    D.initialize(init_method=f'tcp://127.0.0.1:{port}', world_size=world,
                 rank=rank, device='cpu', timeout=TIMEOUT_S)
    meshes = {'2x2': S.make_mesh(model_axis_size=N_TP, device='cpu'),
              'tp4': S.make_mesh(model_axis_size=4, device='cpu'),
              'dp': S.make_mesh(device='cpu')}
    result = dict(mesh=meshes['2x2'].mesh.tolist(),
                  axes=meshes['2x2'].mesh_dim_names)
    tensor_parallel_case(workdir, meshes, result)
    trainer_case(workdir, meshes['2x2'], result)
    ensemble_case(meshes['2x2'], result)
    torch.save(result, os.path.join(workdir, f'result-{rank}.pt'))
    dist.destroy_process_group()
    print(f'rank {rank} done', flush=True)


if __name__ == '__main__':
    main()
