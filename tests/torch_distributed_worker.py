"""One rank of the port's multi-process data-parallel tests.

Launched by ``tests/test_torch_distributed.py`` as
``python torch_distributed_worker.py PORT RANK WORLD WORKDIR``: joins a
gloo process group on the CPU (float64) and runs each case in turn, then
saves what the parent asserts on to ``WORKDIR/result-RANK.pt``. It
imports the port and never JAX: the parent builds the JAX reference and
leaves its weights in ``WORKDIR/jax_state.pt``.

Cases: (a) ``Trainer(sharding=batch_sharding(mesh))`` on the JAX weights,
each rank on its contiguous half of the frames; (b) a run stopped after 2
steps and resumed, with an unseeded shuffle; (c) a sharded
``ContinuousEGNNMap``; (d) the collectives and placement helpers.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tfep_tpu_torch.app import (  # noqa: E402
    CartesianMAFMap, ContinuousEGNNMap, Trainer,
)
from tfep_tpu_torch.convert import load_jax_state  # noqa: E402
from tfep_tpu_torch.io.topology import Topology  # noqa: E402
from tfep_tpu_torch.io.traj import System  # noqa: E402
from tfep_tpu_torch.nn.transformers import (  # noqa: E402
    NeuralSplineTransformer,
)
from tfep_tpu_torch.parallel import distributed as D  # noqa: E402
from tfep_tpu_torch.parallel import sharding as S  # noqa: E402
from tfep_tpu_torch.units import ureg  # noqa: E402

DTYPE = torch.float64
N_ATOMS, N_FRAMES, N_LAYERS, N_BINS = 10, 64, 2, 4
LOCAL_BATCH, N_RANKS, N_EPOCHS = 8, 2, 2
MAPPED, CONDITIONING, ORIGIN, AXES = [1, 2, 4, 5, 7, 8], [0, 6], 0, [2, 5]
N_MAPPED_DOFS = 3 * len(MAPPED) - 3
CNF_FRAMES, CNF_ATOMS, CNF_BATCH = 16, 4, 4
TIMEOUT_S = 120


def frames(n=N_FRAMES, n_atoms=N_ATOMS, seed=0):
    return np.random.default_rng(seed).normal(size=(n, n_atoms, 3))


def topology_kwargs(n_atoms=N_ATOMS):
    return dict(names=[f'C{i}' for i in range(n_atoms)],
                elements=['C'] * n_atoms, resnames=['MOL'] * n_atoms,
                resids=[1] * n_atoms)


def map_kwargs(logs):
    """The configuration of ``tests/test_torch_app_parity.py``, at 64
    frames; the JAX map takes the same."""
    return dict(batch_size=LOCAL_BATCH, tfep_logger_dir_path=logs,
                mapped_atoms=MAPPED, conditioning_atoms=CONDITIONING,
                origin_atom=ORIGIN, axes_atoms=AXES, pca_whitening=True,
                n_maf_layers=N_LAYERS)


def global_order():
    """The frames in the order of the global batches: step k's global
    batch is rank 0's k-th local batch, then rank 1's (contiguous shards,
    no shuffle)."""
    shards = np.arange(N_FRAMES).reshape(N_RANKS, -1, LOCAL_BATCH)
    return shards.transpose(1, 0, 2).reshape(-1)


class Potential:
    """u(x) = sum(x) in kcal/mol, as in tests/app/test_maps.py."""
    energy_unit = ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return torch.sum(x, dim=-1)


def port_map(logs, map_class=CartesianMAFMap):
    bound = 3.0 * np.ones(N_MAPPED_DOFS)
    spline = NeuralSplineTransformer(-bound, bound, N_BINS, device='cpu',
                                     dtype=DTYPE)
    return map_class(
        potential_energy_func=Potential(), temperature=300.0 * ureg.kelvin,
        system=System(Topology(**topology_kwargs()), frames()),
        flow_kwargs=dict(transformer=spline), device='cpu', dtype=DTYPE,
        **map_kwargs(logs))


def weights(flow):
    return {name: p.detach().numpy().copy()
            for name, p in flow.named_parameters()}


def data_parallel_case(workdir, rank, mesh, result):
    """(a) The sharded fit from the JAX weights; the ranks' logs."""
    logs = os.path.join(workdir, 'logs')
    tfep_map = port_map(D.host_logger_dir(logs))
    tfep_map.setup()
    load_jax_state(tfep_map.flow, torch.load(
        os.path.join(workdir, 'jax_state.pt'), weights_only=False))
    trainer = Trainer(save_dir=None, max_epochs=N_EPOCHS, shuffle=False,
                      sharding=S.batch_sharding(mesh))
    trainer.fit(tfep_map)
    result.update(global_step=trainer.global_step,
                  losses=list(trainer.loss_history),
                  weights=weights(tfep_map.flow),
                  allreduce_calls=trainer.host_seconds['allreduce'][1])
    dist.barrier()
    if rank == 0:
        result['merged'] = [D.all_hosts_work_values(
            logs, epoch_idx=epoch,
            names=('potential', 'log_det_J', 'dataset_sample_index',
                   'trajectory_sample_index'))
            for epoch in range(N_EPOCHS)]


def resume_case(workdir, mesh, result):
    """(b) Stopped after 2 of 4 steps and resumed, shuffled: the frames
    each rank's log rows name, run by run."""
    visited = []

    class Recording(CartesianMAFMap):
        def log_train_tensors(self, aux, epoch_idx, batch_idx):
            super().log_train_tensors(aux, epoch_idx, batch_idx)
            visited.append(np.asarray(aux['dataset_sample_index']).tolist())

    runs = []
    for name, max_steps, resume in (('a', 2, False), ('b', None, True)):
        tfep_map = port_map(D.host_logger_dir(
            os.path.join(workdir, f'resume-{name}')), map_class=Recording)
        trainer = Trainer(save_dir=os.path.join(workdir, 'resume-ckpt'),
                          max_epochs=1, max_steps=max_steps, shuffle=True,
                          sharding=S.batch_sharding(mesh))
        visited.clear()
        trainer.fit(tfep_map, resume=resume)
        runs.append(dict(global_step=trainer.global_step,
                         visited=[list(v) for v in visited]))
    result['resume'] = runs


def cnf_case(workdir, mesh, result):
    """(c) ``ContinuousEGNNMap`` over frame-sharded batches."""
    class CNFPotential:
        energy_unit = ureg.kilocalorie_per_mole

        def __call__(self, x, cell=None):
            return torch.sum(x ** 2, dim=-1)

    logs = os.path.join(workdir, 'cnf-logs')
    tfep_map = ContinuousEGNNMap(
        potential_energy_func=CNFPotential(),
        temperature=300.0 * ureg.kelvin,
        system=System(Topology(**topology_kwargs(CNF_ATOMS)),
                      frames(CNF_FRAMES, CNF_ATOMS, seed=1)),
        batch_size=CNF_BATCH, conditioning_atoms=[3],
        tfep_logger_dir_path=D.host_logger_dir(logs), n_egnn_layers=2,
        node_feat_dim=8, distance_feat_dim=4, time_feat_dim=4,
        solver='rk4', n_steps=4, device='cpu', dtype=DTYPE)
    trainer = Trainer(save_dir=None, max_epochs=1, shuffle=False,
                      sharding=S.batch_sharding(mesh))
    trainer.fit(tfep_map)
    # The probes' seed of each rank's first batch.
    first = tfep_map.dataset.get_batch(
        D.host_frame_indices(CNF_FRAMES)[:CNF_BATCH])
    seed = tfep_map.probe_generator(first).initial_seed()
    result['cnf'] = dict(global_step=trainer.global_step,
                         losses=list(trainer.loss_history),
                         probe_seeds=D.gather(torch.tensor(
                             [seed % (1 << 52)], dtype=DTYPE)).tolist())
    dist.barrier()
    if dist.get_rank() == 0:
        result['cnf']['merged'] = D.all_hosts_work_values(
            logs, epoch_idx=0, names=('potential', 'dataset_sample_index'))


def helpers_case(mesh, rank, result):
    """(d) Placement helpers and collectives."""
    rows = torch.arange(6, dtype=DTYPE).reshape(3, 2) + 10 * rank
    batch = {'x': rows, 'i': torch.arange(3) + 3 * rank,
             'b': torch.tensor([True, False, rank == 1])}
    result['helpers'] = dict(
        global_rows=D.global_rows_from_local(
            rows, S.batch_sharding(mesh)).numpy(),
        global_batch={k: v.numpy() for k, v in
                      D.make_global_batch(batch, mesh).items()},
        shard=S.shard_batch({'x': torch.arange(8)}, mesh)['x'].numpy(),
        mesh_shape=tuple(mesh.shape), axes=mesh.mesh_dim_names,
        process=(D.is_distributed(), D.process_index(), D.process_count()))
    module = torch.nn.Linear(3, 2, dtype=DTYPE)
    torch.nn.init.constant_(module.weight, float(rank))
    S.replicate(module, mesh)
    result['helpers']['replicated'] = module.weight.detach().numpy()


def main():
    port, rank, world, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4])
    D.initialize(init_method=f'tcp://127.0.0.1:{port}', world_size=world,
                 rank=rank, device='cpu', timeout=TIMEOUT_S)
    D.initialize(init_method=f'tcp://127.0.0.1:{port}', world_size=world,
                 rank=rank, device='cpu')   # a second call is benign
    assert dist.get_backend() == 'gloo'
    mesh = S.make_mesh(device='cpu')
    result = {}
    data_parallel_case(workdir, rank, mesh, result)
    resume_case(workdir, mesh, result)
    cnf_case(workdir, mesh, result)
    helpers_case(mesh, rank, result)
    torch.save(result, os.path.join(workdir, f'result-{rank}.pt'))
    dist.destroy_process_group()
    print(f'rank {rank} done', flush=True)


if __name__ == '__main__':
    main()
