"""The port's app layer: real training runs with a mock potential.

The port's own mirror of ``tests/app/test_maps.py``, in float64 on
``device='cpu'``: the selection errors, training with each selection set,
PCA whitening, ``degrees_repeats``, the reference-frame index arithmetic,
the forward/inverse round trip, ``run_evaluation``, prefetch, the resume
invariants, the checkpoint round trip with its version and
unpicklable-hyperparameter errors; then what only the port has to show:
parameters that the loss does not read decay as optax decays them, each
MAF layer trains its own copy of a shared transformer, the log rows of a
step are written after the next step is launched, and the profiler window.
"""

import os

import numpy as np
import pytest
import torch

from tfep_tpu_torch.app import (
    CartesianMAFMap, TFEPMapBase, Trainer, load_map_from_checkpoint,
)
from tfep_tpu_torch.app.trainer import CHECKPOINT_FORMAT_VERSION
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.nn.flows import MAF, AutoregressiveFlow
from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
from tfep_tpu_torch.units import ureg
from tfep_tpu_torch.utils.math import batch_log_abs_det_J
from tfep_tpu_torch.utils.misc import atom_to_flattened_indices

N_FRAMES, N_ATOMS = 10, 6
ON_CPU = dict(device='cpu', dtype=torch.float64)


class MockPotential:
    """u(x) = sum(x), as in tests/app/test_maps.py."""
    energy_unit = ureg.kilocalorie_per_mole
    positions_unit = ureg.angstrom

    def __call__(self, x, cell=None):
        return torch.sum(x, dim=-1)


def make_system(n_frames=N_FRAMES, n_atoms=N_ATOMS, seed=0):
    rng = np.random.default_rng(seed)
    topology = Topology(
        names=[f'C{i}' for i in range(n_atoms)],
        elements=['C'] * n_atoms,
        resnames=['MOL'] * (n_atoms // 2) + ['SOL'] * (n_atoms - n_atoms // 2),
        resids=[1] * (n_atoms // 2) + [2] * (n_atoms - n_atoms // 2),
    )
    return System(topology, rng.normal(0, 1, size=(n_frames, n_atoms, 3)))


def make_map(tmp_path, name='logs', map_class=CartesianMAFMap, **kwargs):
    kwargs.setdefault('n_maf_layers', 2)
    kwargs.setdefault('system', make_system())
    return map_class(
        potential_energy_func=MockPotential(),
        temperature=300.0 * ureg.kelvin,
        batch_size=5,
        tfep_logger_dir_path=str(tmp_path / name),
        **ON_CPU, **kwargs)


def first_batch(tfep_map, indices=(0, 1)):
    return tfep_map.dataset.get_batch(list(indices))


# --------------------------------------------------------------------------
# Selection errors (tests/app/test_maps.py:57-90)
# --------------------------------------------------------------------------

def test_overlapping_selections_raise(tmp_path):
    tfep_map = make_map(tmp_path, mapped_atoms=[0, 1, 2],
                        conditioning_atoms=[2, 3])
    with pytest.raises(ValueError, match='overlapping'):
        tfep_map.setup()


def test_origin_must_be_conditioning(tmp_path):
    tfep_map = make_map(tmp_path, mapped_atoms=[0, 1, 2],
                        conditioning_atoms=[3], origin_atom=0)
    with pytest.raises(ValueError, match='conditioning'):
        tfep_map.setup()


def test_fixed_axes_atoms_raise(tmp_path):
    tfep_map = make_map(tmp_path, mapped_atoms=[0, 1],
                        conditioning_atoms=[2], axes_atoms=[4, 5])
    with pytest.raises(ValueError, match='axis and plane'):
        tfep_map.setup()


def test_system_and_file_path_mutually_exclusive(tmp_path):
    with pytest.raises(ValueError, match='not both'):
        make_map(tmp_path, coordinates_file_path='traj.pdb')


def test_no_mapped_atoms_raise(tmp_path):
    tfep_map = make_map(tmp_path, conditioning_atoms='all')
    with pytest.raises(ValueError, match='no atoms to map'):
        tfep_map.setup()


def test_file_paths_are_not_ported(tmp_path):
    """The file branch: a map built from a coordinates file reads it and
    records only the path; a missing file or no system at all raises."""
    path = str(tmp_path / 'traj.pdb')
    make_system().save(path)
    tfep_map = make_map(tmp_path, system=None, coordinates_file_path=path)
    np.testing.assert_array_equal(tfep_map._system.positions,
                                  System.from_file(path).positions)
    assert tfep_map.hparams['system'] is None
    assert tfep_map.hparams['coordinates_file_path'] == path
    with pytest.raises(FileNotFoundError):
        make_map(tmp_path, system=None,
                 coordinates_file_path=str(tmp_path / 'missing.pdb'))
    with pytest.raises(ValueError, match='Pass either'):
        make_map(tmp_path, system=None)


# --------------------------------------------------------------------------
# Training (tests/app/test_maps.py:97-157)
# --------------------------------------------------------------------------

@pytest.mark.parametrize('selections', [
    dict(),
    dict(mapped_atoms=[0, 1, 2, 3]),
    dict(mapped_atoms='resname MOL', conditioning_atoms=[3]),
    dict(mapped_atoms=[0, 1, 2], conditioning_atoms=[3],
         origin_atom=3, axes_atoms=[0, 1]),
])
def test_cartesian_maf_map_trains(tmp_path, selections):
    tfep_map = make_map(tmp_path, **selections)
    trainer = Trainer(save_dir=str(tmp_path / 'ckpt'), max_epochs=2,
                      shuffle=True)
    flow = trainer.fit(tfep_map)
    assert flow is tfep_map.flow
    assert trainer.global_step == 4  # 10 samples / batch 5 * 2 epochs
    assert len(trainer.loss_history) == 4

    batch = first_batch(tfep_map)
    with torch.no_grad():
        out = tfep_map.forward(batch)
    assert out['positions'].shape == batch['positions'].shape
    assert torch.isfinite(out['positions']).all()
    assert not torch.equal(out['positions'],
                           torch.as_tensor(batch['positions']))
    if tfep_map.n_fixed_atoms > 0:
        fixed = atom_to_flattened_indices(tfep_map._fixed_atom_indices)
        np.testing.assert_array_equal(out['positions'][:, fixed].numpy(),
                                      batch['positions'][:, fixed])

    logged = tfep_map.tfep_logger.read_train_tensors(epoch_idx=1)
    assert len(logged['potential']) == N_FRAMES
    assert set(logged['dataset_sample_index'].tolist()) == set(range(N_FRAMES))


def test_pca_whitening_trains(tmp_path):
    tfep_map = make_map(tmp_path, system=make_system(n_frames=64),
                        pca_whitening=True, mapped_atoms=[1, 2, 3, 4, 5],
                        conditioning_atoms=[0], origin_atom=0,
                        axes_atoms=[1, 2])
    tfep_map.batch_size = 16
    trainer = Trainer(save_dir=None, max_epochs=1, shuffle=False)
    trainer.fit(tfep_map)
    assert len(trainer.loss_history) == 4
    assert np.all(np.isfinite(trainer.loss_history))

    # The composed flow's log-det stays exact (autograd oracle).
    batch = first_batch(tfep_map, (0, 1, 2))
    with torch.no_grad():
        out = tfep_map.forward(batch)
    oracle = batch_log_abs_det_J(lambda x: tfep_map.flow(x)[0],
                                 torch.as_tensor(batch['positions']))
    np.testing.assert_allclose(out['log_det_J'].numpy(),
                               oracle.detach().numpy(),
                               atol=1e-7)


def test_pca_whitening_needs_enough_frames(tmp_path):
    tfep_map = make_map(tmp_path, pca_whitening=True)  # 10 frames, 18 dofs
    with pytest.raises(ValueError, match='more frames'):
        tfep_map.setup()


# --------------------------------------------------------------------------
# degrees_repeats (tests/app/test_maps.py:225-273)
# --------------------------------------------------------------------------

@pytest.mark.parametrize('repeats, groups', [(1, 3 * N_ATOMS), (6, 3)])
def test_degrees_repeats_coupling_blocks(tmp_path, repeats, groups):
    tfep_map = make_map(tmp_path, degrees_repeats=repeats)
    tfep_map.setup()
    layers = [m for m in tfep_map.flow.modules()
              if isinstance(m, AutoregressiveFlow)]
    assert len(layers) == 2
    for layer in layers:
        assert layer.inverse_masks.shape[0] == groups

    x = torch.as_tensor(first_batch(tfep_map)['positions'])
    with torch.no_grad():
        y, ldj = tfep_map.flow(x)
        x_back, ldj_inv = tfep_map.flow.inverse(y)
    np.testing.assert_allclose(x_back.numpy(), x.numpy(), atol=1e-8)
    np.testing.assert_allclose((ldj + ldj_inv).numpy(), 0.0, atol=1e-8)


def test_degrees_repeats_trains(tmp_path):
    tfep_map = make_map(tmp_path, degrees_repeats=4)
    trainer = Trainer(save_dir=None, max_steps=3, shuffle=False)
    flow = trainer.fit(tfep_map)
    assert np.isfinite(trainer.loss_history).all()
    x = torch.as_tensor(first_batch(tfep_map)['positions'])
    with torch.no_grad():
        x_back, _ = flow.inverse(flow(x)[0])
    np.testing.assert_allclose(x_back.numpy(), x.numpy(), atol=1e-6)


# --------------------------------------------------------------------------
# Reference frame (tests/app/test_maps.py:520-611)
# --------------------------------------------------------------------------

def _frame_map(tmp_path):
    tfep_map = make_map(tmp_path, mapped_atoms=[0, 1, 2],
                        conditioning_atoms=[3, 4, 5],
                        origin_atom=3, axes_atoms=[4, 5])
    tfep_map.setup()
    return tfep_map


def test_reference_frame_index_arithmetic(tmp_path):
    tfep_map = _frame_map(tmp_path)
    check = np.testing.assert_array_equal
    check(tfep_map.get_mapped_indices(idx_type='atom'), [0, 1, 2])
    check(tfep_map.get_conditioning_indices(idx_type='atom'), [3, 4, 5])
    check(tfep_map.get_mapped_indices(idx_type='dof'), np.arange(9))
    check(tfep_map.get_conditioning_indices(idx_type='dof'),
          np.arange(9, 18))
    # Origin atom 3 loses DOFs 9-11; axis atom 4 loses x,y (12, 13);
    # plane atom 5 loses y (16).
    check(tfep_map.get_mapped_indices(idx_type='dof', remove_reference=True),
          np.arange(9))
    check(tfep_map.get_conditioning_indices(idx_type='dof',
                                            remove_reference=True),
          [9, 10, 11])
    check(tfep_map.get_mapped_indices(idx_type='atom',
                                      remove_reference=True), [0, 1, 2])
    assert len(tfep_map.get_conditioning_indices(
        idx_type='atom', remove_reference=True)) == 0
    check(tfep_map.get_reference_atoms_indices(remove_fixed=True), [3, 4, 5])
    assert tfep_map.get_fixed_indices() is None


def test_reference_frame_flow_dof_count(tmp_path):
    tfep_map = _frame_map(tmp_path)
    assert tfep_map.n_nonfixed_dofs == 3 * N_ATOMS - 6
    mafs = [m for m in tfep_map.flow.modules() if isinstance(m, MAF)]
    assert all(m.conditioner.dimension_in == 3 * N_ATOMS - 6 for m in mafs)
    x = np.random.default_rng(0).normal(size=(2, N_ATOMS * 3))
    with torch.no_grad():
        out = tfep_map.forward({'positions': x})
    assert out['positions'].shape == x.shape
    assert torch.isfinite(out['log_det_J']).all()


def test_app_forward_inverse_round_trip(tmp_path):
    tfep_map = _frame_map(tmp_path)
    with torch.no_grad():
        for p in tfep_map.flow.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator(
                ).manual_seed(p.numel()), dtype=p.dtype))
    x = np.random.default_rng(3).normal(size=(4, N_ATOMS * 3))
    with torch.no_grad():
        fwd = tfep_map.forward({'positions': x})
        back = tfep_map.inverse({'positions': fwd['positions']})
    assert not np.allclose(fwd['positions'].numpy(), x)
    np.testing.assert_allclose(back['positions'].numpy(), x, atol=1e-8)
    np.testing.assert_allclose(
        (fwd['log_det_J'] + back['log_det_J']).numpy(), 0.0, atol=1e-8)


# --------------------------------------------------------------------------
# Evaluation (tests/app/test_maps.py:438)
# --------------------------------------------------------------------------

def test_run_evaluation(tmp_path):
    tfep_map = make_map(tmp_path, name='logs_eval')
    trainer = Trainer(save_dir=None, max_steps=2, shuffle=False)
    trainer.fit(tfep_map)

    tensors = tfep_map.run_evaluation(step_idx=trainer.global_step,
                                      batch_size=4)  # a short last batch
    assert len(tensors['potential']) == N_FRAMES
    assert sorted(tensors['dataset_sample_index'].tolist()) == \
        list(range(N_FRAMES))
    # The same as one forward over the whole dataset.
    batch = first_batch(tfep_map, range(N_FRAMES))
    with torch.no_grad():
        out = tfep_map.forward(batch)
    np.testing.assert_allclose(tensors['log_det_J'], out['log_det_J'].numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(
        tensors['potential'],
        out['positions'].sum(-1).numpy() / tfep_map.kT, atol=1e-12)

    logged = tfep_map.tfep_logger.read_eval_tensors(
        step_idx=trainer.global_step, sort_by='dataset_sample_index')
    np.testing.assert_array_equal(logged['dataset_sample_index'],
                                  np.arange(N_FRAMES))
    assert np.all(np.isfinite(logged['log_det_J']))


# --------------------------------------------------------------------------
# Resume invariants and checkpoints (tests/app/test_maps.py:159-436)
# --------------------------------------------------------------------------

def test_crash_resume_invariant(tmp_path):
    """Union of visited samples across a crash = one epoch, no repeats."""
    visited = []

    class RecordingMap(CartesianMAFMap):
        def log_train_tensors(self, aux, epoch_idx, batch_idx):
            visited.append((epoch_idx,
                            aux['dataset_sample_index'].tolist()))
            super().log_train_tensors(aux, epoch_idx, batch_idx)

    ckpt = str(tmp_path / 'ckpt')
    t1 = Trainer(save_dir=ckpt, max_steps=3, shuffle=True)
    t1.fit(make_map(tmp_path, 'logs1', map_class=RecordingMap))
    assert t1.global_step == 3

    t2 = Trainer(save_dir=ckpt, max_steps=6, shuffle=True)
    t2.fit(make_map(tmp_path, 'logs1', map_class=RecordingMap), resume=True)
    assert t2.global_step == 6

    epoch1_batches = [s for e, s in visited if e == 1]
    assert len(epoch1_batches) == 2
    assert sorted(i for b in epoch1_batches for i in b) == \
        list(range(N_FRAMES))


def test_checkpoint_restores_parameters_and_optimizer(tmp_path):
    tfep_map = make_map(tmp_path, name='logs_a')
    trainer = Trainer(save_dir=str(tmp_path / 'ckpt'), max_steps=3,
                      shuffle=False)
    trainer.fit(tfep_map)

    state = torch.load(trainer.checkpoint_path, weights_only=False)
    assert state['format_version'] == CHECKPOINT_FORMAT_VERSION
    assert (state['global_step'], state['current_epoch']) == (3, 1)
    assert set(state['optimizer_state']['state'][0]) == {
        'step', 'exp_avg', 'exp_avg_sq'}

    tfep_map2 = make_map(tmp_path, name='logs_b')
    tfep_map2.setup()
    trainer2 = Trainer(save_dir=str(tmp_path / 'ckpt'), max_steps=3,
                       shuffle=False)
    flow2 = tfep_map2.flow
    optimizer = trainer2.optimizer(list(flow2.parameters()))
    trainer2._load_checkpoint(flow2, optimizer, _DummySampler())
    for a, b in zip(trainer_params(tfep_map), trainer_params(tfep_map2)):
        np.testing.assert_array_equal(a, b)
    assert trainer2.global_step == 3
    assert float(optimizer.state_dict()['state'][0]['step']) == 3.0


def trainer_params(tfep_map):
    return [p.detach().numpy() for p in tfep_map.flow.parameters()]


class _DummySampler:
    def load_state_dict(self, sd):
        pass

    def state_dict(self):
        return {}


def test_epoch_boundary_checkpoint_resume_adds_no_extra_epoch(tmp_path):
    tfep_map = make_map(tmp_path, name='logs_eb')
    trainer = Trainer(save_dir=str(tmp_path / 'eb'), max_epochs=2,
                      shuffle=False)
    trainer.fit(tfep_map)
    assert trainer.global_step == 4

    t2 = Trainer(save_dir=str(tmp_path / 'eb'), max_epochs=2, shuffle=False)
    t2.fit(make_map(tmp_path, name='logs_eb2'), resume=True)
    assert t2.global_step == 4             # not 6: no replayed epoch
    assert t2.current_epoch == 2
    assert t2.loss_history == []


def test_finished_max_steps_resume_trains_zero_steps(tmp_path):
    tfep_map = make_map(tmp_path, name='logs_ms')
    trainer = Trainer(save_dir=str(tmp_path / 'ms'), max_steps=3,
                      shuffle=False)
    trainer.fit(tfep_map)
    before = trainer_params(tfep_map)

    map2 = make_map(tmp_path, name='logs_ms2')
    t2 = Trainer(save_dir=str(tmp_path / 'ms'), max_steps=3, shuffle=False)
    t2.fit(map2, resume=True)
    assert t2.global_step == 3
    for a, b in zip(before, trainer_params(map2)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_acknowledged_steps_have_logged_rows(tmp_path):
    class CrashAfterSave(Trainer):
        def _save_checkpoint(self, *args, **kwargs):
            super()._save_checkpoint(*args, **kwargs)
            if self.global_step == 2:
                raise RuntimeError('crash right after the save')

    tfep_map = make_map(tmp_path, name='logs_fl')
    trainer = CrashAfterSave(save_dir=str(tmp_path / 'fl'), max_epochs=1,
                             shuffle=False)
    with pytest.raises(RuntimeError, match='right after the save'):
        trainer.fit(tfep_map)
    logged = tfep_map.tfep_logger.read_train_tensors(epoch_idx=0)
    assert set(logged['dataset_sample_index'].tolist()) == set(range(10))


def test_self_contained_checkpoint_round_trip(tmp_path):
    tfep_map = make_map(tmp_path, name='logs_sc', remat=False,
                        mapped_atoms='resname MOL', conditioning_atoms=[3])
    trainer = Trainer(save_dir=str(tmp_path / 'ckpt_sc'), max_steps=3,
                      shuffle=False)
    flow = trainer.fit(tfep_map)
    x = torch.as_tensor(first_batch(tfep_map)['positions'])
    with torch.no_grad():
        y_ref, ldj_ref = flow(x)

    path = str(tmp_path / 'ckpt_sc' / 'last.ckpt')
    for loader in (load_map_from_checkpoint,
                   CartesianMAFMap.load_from_checkpoint):
        restored = loader(path)
        assert isinstance(restored, CartesianMAFMap)
        assert restored.n_maf_layers == tfep_map.n_maf_layers
        assert restored._mapped_atoms == 'resname MOL'
        assert (restored.device, restored.dtype) == (torch.device('cpu'),
                                                     torch.float64)
        with torch.no_grad():
            y, ldj = restored.flow(x)
        np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-12)
        np.testing.assert_allclose(ldj.numpy(), ldj_ref.numpy(), atol=1e-12)

    class OtherMap(TFEPMapBase):
        pass

    with pytest.raises(ValueError, match='not a .*OtherMap'):
        OtherMap.load_from_checkpoint(path)


def test_checkpoint_unpicklable_hparams_need_override(tmp_path):
    class UnpicklablePotential(MockPotential):
        def __init__(self):
            self._handle = lambda x: x   # closures do not pickle

    tfep_map = make_map(tmp_path, name='logs_unp')
    tfep_map._potential_energy_func = UnpicklablePotential()
    tfep_map.hparams['potential_energy_func'] = tfep_map._potential_energy_func
    trainer = Trainer(save_dir=str(tmp_path / 'ckpt_unp'), max_steps=2,
                      shuffle=False)
    trainer.fit(tfep_map)

    path = str(tmp_path / 'ckpt_unp' / 'last.ckpt')
    with pytest.raises(ValueError, match='potential_energy_func'):
        load_map_from_checkpoint(path)
    restored = load_map_from_checkpoint(
        path, potential_energy_func=MockPotential())
    assert isinstance(restored.flow, type(tfep_map.flow))


def test_checkpoint_version_mismatch_raises(tmp_path):
    path = str(tmp_path / 'future.ckpt')
    torch.save({'format_version': CHECKPOINT_FORMAT_VERSION + 1,
                'flow_state': {}, 'optimizer_state': {}, 'global_step': 0,
                'current_epoch': 0, 'sampler_state': {}}, path)
    with pytest.raises(ValueError, match='format version'):
        load_map_from_checkpoint(path)

    # The resume path rejects it too.
    trainer = Trainer(save_dir=str(tmp_path), max_steps=1, shuffle=False)
    os.replace(path, trainer.checkpoint_path)
    with pytest.raises(ValueError, match='format version'):
        trainer.fit(make_map(tmp_path, name='logs_ver'), resume=True)


def test_checkpoint_without_config_and_jax_pickles_refused(tmp_path):
    import pickle

    path = str(tmp_path / 'bare.ckpt')
    torch.save({'format_version': 1, 'flow_state': {}}, path)
    with pytest.raises(ValueError, match='does not embed'):
        load_map_from_checkpoint(path)
    # The JAX package's checkpoint format: a plain pickle.
    jax_path = str(tmp_path / 'jax.ckpt')
    with open(jax_path, 'wb') as f:
        pickle.dump({'format_version': 1, 'flow_leaves': [],
                     'opt_leaves': []}, f)
    with pytest.raises(ValueError, match='not a checkpoint of tfep_tpu_torch'):
        load_map_from_checkpoint(jax_path)


# --------------------------------------------------------------------------
# Prefetch (tests/app/test_maps.py:614-650)
# --------------------------------------------------------------------------

def _train_two_epochs(tmp_path, name, prefetch):
    tfep_map = make_map(tmp_path, name=name)
    trainer = Trainer(save_dir=None, max_epochs=2, shuffle=True,
                      shuffle_seed=11, prefetch=prefetch)
    trainer.fit(tfep_map)
    return trainer.loss_history, trainer_params(tfep_map)


def test_prefetch_trains_identically(tmp_path):
    losses_sync, params_sync = _train_two_epochs(tmp_path, 'sync', False)
    losses_pre, params_pre = _train_two_epochs(tmp_path, 'pre', True)
    assert losses_sync == losses_pre
    for a, b in zip(params_sync, params_pre):
        np.testing.assert_array_equal(a, b)


def test_prefetch_early_exit_max_steps(tmp_path):
    trainer = Trainer(save_dir=None, max_steps=3, shuffle=True,
                      shuffle_seed=5, prefetch=True)
    trainer.fit(make_map(tmp_path, name='early'))
    assert trainer.global_step == 3
    assert len(trainer.loss_history) == 3


def test_prefetch_crash_resume_invariant(tmp_path):
    save_dir = str(tmp_path / 'ckpt_prefetch')
    trainer = Trainer(save_dir=save_dir, max_steps=1, shuffle=True,
                      shuffle_seed=3, prefetch=True)
    trainer.fit(make_map(tmp_path, name='pf_a'))

    tfep_map2 = make_map(tmp_path, name='pf_a')
    trainer2 = Trainer(save_dir=save_dir, max_epochs=1, shuffle=True,
                       shuffle_seed=3, prefetch=True)
    trainer2.fit(tfep_map2, resume=True)
    assert trainer2.global_step == 2

    data = tfep_map2.tfep_logger.read_train_tensors(epoch_idx=0)
    np.testing.assert_array_equal(
        np.sort(data['dataset_sample_index']), np.arange(N_FRAMES))


# --------------------------------------------------------------------------
# What the port adds
# --------------------------------------------------------------------------

def test_unread_parameter_decays_as_optax_does(tmp_path):
    """A parameter that the loss does not read gets a zero gradient before
    each step: AdamW then decays it by (1 - lr * weight_decay) per step,
    as optax.adamw does, where torch alone would leave it untouched."""

    class MapWithIdleParameter(CartesianMAFMap):
        def configure_flow(self):
            flow = super().configure_flow()
            flow.idle = torch.nn.Parameter(torch.full((3,), 2.0,
                                                      dtype=self.dtype))
            return flow

    tfep_map = make_map(tmp_path, map_class=MapWithIdleParameter)
    trainer = Trainer(save_dir=None, max_steps=4, shuffle=False)
    trainer.fit(tfep_map)
    lr = weight_decay = 1e-4
    np.testing.assert_allclose(tfep_map.flow.idle.detach().numpy(),
                               2.0 * (1.0 - lr * weight_decay) ** 4,
                               rtol=0, atol=1e-15)
    assert not np.array_equal(tfep_map.flow.idle.detach().numpy(),
                              np.full(3, 2.0))


def test_default_optimizer_is_optax_adamw_default(tmp_path):
    tfep_map = make_map(tmp_path)
    tfep_map.setup()
    optimizer = Trainer(max_steps=1).optimizer(
        list(tfep_map.flow.parameters()))
    assert isinstance(optimizer, torch.optim.AdamW)
    group = optimizer.param_groups[0]
    assert (group['lr'], group['weight_decay'], group['eps'],
            group['betas']) == (1e-4, 1e-4, 1e-8, (0.9, 0.999))

    # A factory of the caller's choice is used as given.
    trainer = Trainer(max_steps=2, shuffle=False, optimizer=lambda params:
                      torch.optim.SGD(params, lr=0.0))
    before = trainer_params(tfep_map)
    trainer.fit(tfep_map)
    for a, b in zip(before, trainer_params(tfep_map)):
        np.testing.assert_array_equal(a, b)


def test_each_maf_layer_gets_its_own_transformer(tmp_path):
    """One transformer instance in flow_kwargs: each layer gets a copy, on
    the map's device and dtype; the layers share no tensor with each other
    or with the caller's instance, and each layer's copy is listed in the
    flow's buffers (a shared module would be listed once)."""
    shared = NeuralSplineTransformer(-3.0, 3.0, 4, device='cpu',
                                     dtype=torch.float32)
    tfep_map = make_map(tmp_path, n_maf_layers=3,
                        flow_kwargs=dict(transformer=shared))
    tfep_map.setup()
    transformers = [m.transformer for m in tfep_map.flow.modules()
                    if isinstance(m, MAF)]
    assert len(transformers) == 3
    assert len({id(t) for t in transformers + [shared]}) == 4
    pointers = {t.x0.data_ptr() for t in transformers}
    assert len(pointers) == 3 and shared.x0.data_ptr() not in pointers
    assert all(t.x0.dtype == torch.float64 for t in transformers)
    assert shared.x0.dtype == torch.float32
    names = [n for n, _ in tfep_map.flow.named_buffers()
             if n.endswith('transformer.x0')]
    assert len(names) == 3

    # Training one layer's transformer leaves the others alone.
    with torch.no_grad():
        transformers[0].x0.fill_(-2.0)
    assert float(transformers[1].x0) == -3.0 == float(shared.x0)


def test_log_rows_are_written_one_step_late(tmp_path):
    """Step k's aux is read after step k+1 is launched; the last step's
    at the end of the run, and a checkpoint's step before the checkpoint."""
    events = []

    class RecordingMap(CartesianMAFMap):
        def training_step_fn(self, flow, batch):
            events.append(('step', int(batch['dataset_sample_index'][0])))
            return super().training_step_fn(flow, batch)

        def log_train_tensors(self, aux, epoch_idx, batch_idx):
            events.append(('log', int(aux['dataset_sample_index'][0])))
            super().log_train_tensors(aux, epoch_idx, batch_idx)

    tfep_map = make_map(tmp_path, map_class=RecordingMap)
    tfep_map.setup()
    tfep_map.batch_size = 2   # 5 batches per epoch
    Trainer(save_dir=None, max_steps=4, shuffle=False).fit(tfep_map)
    assert events == [('step', 0), ('step', 2), ('log', 0), ('step', 4),
                      ('log', 2), ('step', 6), ('log', 4), ('log', 6)]

    events.clear()
    Trainer(save_dir=str(tmp_path / 'ck'), max_steps=3, shuffle=False,
            checkpoint_every_n_steps=2).fit(tfep_map)
    assert events == [('step', 0), ('step', 2), ('log', 0), ('log', 2),
                      ('step', 4), ('log', 4)]


def test_profile_window_and_host_times(tmp_path):
    tfep_map = make_map(tmp_path)
    trainer = Trainer(save_dir=str(tmp_path / 'ck'), max_epochs=2,
                      shuffle=True, shuffle_seed=0, prefetch=True,
                      profile_dir=str(tmp_path / 'prof'),
                      profile_steps=(1, 3))
    trainer.fit(tfep_map)
    assert os.path.isfile(tmp_path / 'prof' / 'trace.json')
    assert len(trainer.profiled_step_times) == 2
    assert all(s > 0 for s in trainer.profiled_step_times)
    assert trainer.profile is not None
    assert {name: calls for name, (_, calls)
            in trainer.host_seconds.items()} == {
        'read': 4, 'to_device': 4, 'step': 4, 'log': 4, 'checkpoint': 4}


def test_sharding_and_engine_overlap_are_not_ported():
    # sharding is ported (tests/test_torch_distributed.py): it takes a
    # batch_sharding(mesh) and rejects anything else.
    with pytest.raises(TypeError, match='sharding'):
        Trainer(max_steps=1, sharding=object())
    # engine_overlap is ported (tests/test_torch_pipeline.py): it builds.
    assert Trainer(max_steps=1, engine_overlap=True).engine_overlap
    with pytest.raises(ValueError, match='max_epochs/max_steps'):
        Trainer()


def test_drop_last_and_console_log(tmp_path, capsys):
    tfep_map = make_map(tmp_path)
    tfep_map.setup()
    tfep_map.batch_size = 3          # 10 frames: 3 whole batches an epoch
    trainer = Trainer(save_dir=None, max_epochs=2, shuffle=True,
                      shuffle_seed=1, drop_last=True, log_every_n_steps=2)
    trainer.fit(tfep_map)
    assert trainer.global_step == 6 and trainer.current_epoch == 2
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(' loss=')[0] for line in lines] == [
        '[tfep] epoch 0 step 2', '[tfep] epoch 1 step 4',
        '[tfep] epoch 1 step 6']
    for line, loss in zip(lines, trainer.loss_history[1::2]):
        assert line.endswith(f'loss={loss:.6g}')
    logged = tfep_map.tfep_logger.read_train_tensors(epoch_idx=1)
    assert len(logged['dataset_sample_index']) == 9
