"""The port's host data layer against the JAX package's, on the same inputs.

``tfep_tpu_torch.units`` and ``tfep_tpu_torch.io`` are copies of numpy-only
modules of the JAX package. Each case below runs once with the names of
one package and once with those of the other, on the same inputs, and the
two results must be identical: the unit conversions and kT, the selection
language with its periodic geometric selections, the trajectory dataset,
its subsets and timesteps, the sampler's permutations and mid-epoch resume
for a ``shuffle_seed``, and the TFEP logger's addressing, NaN filtering
and metadata resume. The JAX side gives the logger JAX arrays, the port
torch tensors. The cases follow ``tests/io/test_selections.py``,
``tests/io/test_timestep.py``, ``tests/io/test_sampler.py`` and
``tests/io/test_log.py``.
"""

import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.io as jax_io
import tfep_tpu.io.topology as jax_topology
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.units as jax_units
import tfep_tpu.utils.misc as jax_misc
import tfep_tpu_torch.io as port_io
import tfep_tpu_torch.io.topology as port_topology
import tfep_tpu_torch.io.traj as port_traj
import tfep_tpu_torch.units as port_units
import tfep_tpu_torch.utils.misc as port_misc


def _names(io, topology, traj, units, misc, array):
    return SimpleNamespace(
        Topology=topology.Topology, System=traj.System,
        TrajectoryDataset=traj.TrajectoryDataset, Subset=io.Subset,
        TrajectorySubset=io.TrajectorySubset, DictDataset=io.DictDataset,
        MergedDataset=io.MergedDataset, Timestep=traj.Timestep,
        StatefulBatchSampler=io.StatefulBatchSampler,
        TFEPLogger=io.TFEPLogger, ureg=units.ureg, Quantity=units.Quantity,
        min_image=topology._min_image_distances,
        guess_element=topology.guess_element,
        dims_to_box=traj.dimensions_to_box_vectors,
        box_to_dims=traj.box_vectors_to_dimensions,
        subsampled=traj.get_subsampled_indices,
        energies=misc.energies_array_to_numpy,
        forces=misc.forces_array_to_numpy, array=array)


JAX = _names(jax_io, jax_topology, jax_traj, jax_units, jax_misc,
             jnp.asarray)
PORT = _names(port_io, port_topology, port_traj, port_units, port_misc,
              torch.tensor)


def _error(fn):
    """The type and message of what ``fn()`` raises."""
    try:
        fn()
    except Exception as error:  # noqa: BLE001 (compared across packages)
        return type(error).__name__, str(error)
    raise AssertionError('no error raised')


class _Trainer:
    def __init__(self, global_step=0):
        self.global_step = global_step


# --------------------------------------------------------------------------
# Units
# --------------------------------------------------------------------------

def units_kT(m):
    T = 300.0 * m.ureg.kelvin
    return [m.ureg.kT(T, unit).magnitude for unit in (
        m.ureg.kilocalorie_per_mole, m.ureg.kilojoule_per_mole,
        m.ureg.hartree, m.ureg.kilocalorie_per_mole)] + [
        m.ureg.kT(310.5 * m.ureg.kelvin, m.ureg.kilojoule_per_mole).magnitude]


def units_conversions(m):
    u = m.ureg
    x = np.linspace(-2.0, 3.0, 7)
    return [
        (1.0 * u.hartree).to(u.kilocalorie_per_mole).magnitude,
        (x * u.nanometer).to(u.angstrom).magnitude,
        (2.5 * u.picosecond).to(u.femtosecond).magnitude,
        (x * u.kilojoule_per_mole / u.nanometer).to(
            u.kilocalorie_per_mole / u.angstrom).magnitude,
        ((3.0 * u.angstrom) * (2.0 * u.angstrom)).to(u.nanometer ** 2
                                                      ).magnitude,
        str((4.0 * u.kilojoule_per_mole).units),
        _error(lambda: (1.0 * u.angstrom).to(u.kelvin)),
    ]


def units_array_helpers(m):
    u = m.ureg
    rng = np.random.default_rng(0)
    energies = rng.normal(size=5) * u.kilojoule_per_mole
    forces = rng.normal(size=(5, 4, 3)) * u.kilojoule_per_mole / u.nanometer
    return [m.energies(energies, u.kilocalorie_per_mole),
            m.energies(np.arange(3.0)),
            m.forces(forces, u.angstrom, u.kilocalorie_per_mole),
            _error(lambda: m.forces(forces, u.angstrom))]


# --------------------------------------------------------------------------
# Selections (tests/io/test_selections.py)
# --------------------------------------------------------------------------

def _solvated(m, positions=None, dimensions=None):
    names = ['C1', 'C2', 'O1'] + ['OW', 'HW1', 'HW2'] * 3
    resnames = ['LIG'] * 3 + ['SOL'] * 9
    resids = [1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4]
    if positions is None:
        positions = np.array([
            [9.5, 5.0, 5.0], [9.0, 5.5, 5.0], [9.0, 4.5, 5.0],
            [0.4, 5.0, 5.0], [0.9, 5.3, 5.0], [0.9, 4.7, 5.0],
            [5.0, 5.0, 5.0], [5.5, 5.3, 5.0], [5.5, 4.7, 5.0],
            [8.0, 5.0, 5.0], [7.5, 5.3, 5.0], [7.5, 4.7, 5.0]])[None]
    if dimensions is None:
        dimensions = np.array([[10.0, 10.0, 10.0, 90.0, 90.0, 90.0]])
    masses = [12.0, 12.0, 16.0] + [16.0, 1.0, 1.0] * 3
    topology = m.Topology(names=names, resnames=resnames, resids=resids,
                          masses=masses)
    return m.System(topology, positions, dimensions=dimensions)


def select_around_periodic(m):
    system = _solvated(m)
    no_box = m.System(system.topology, np.asarray(system.positions))
    sel = 'resname SOL and around 1.0 resname LIG'
    return [system.select_atoms(sel), no_box.select_atoms(sel)]


def select_around_within(m):
    system = _solvated(m)
    return [system.select_atoms('around 2.0 resname LIG'),
            system.select_atoms('within 2.0 of resname LIG'),
            system.select_atoms('within 4.5 of index 6')]


def select_byres(m):
    return _solvated(m).select_atoms(
        'byres (resname SOL and around 1.0 resname LIG)')


def select_sphzone_point(m):
    system = _solvated(m)
    return [system.select_atoms('sphzone 1.2 resname LIG'),
            system.select_atoms('point 5.0 5.0 5.0 0.4'),
            system.select_atoms('point 0.45 5.0 5.0 0.3'),
            system.select_atoms('sphzone 5.0 resname TYPO')]


def select_attributes(m):
    system = _solvated(m)
    return [system.select_atoms(s) for s in (
        'all', 'none', 'index 3 5 7', 'index 2:10', 'name OW', 'name C1 O1',
        'resname SOL and not name OW', 'resid 2:3', 'mass 10 to 20',
        'bynum 1:4', '(resname LIG or name HW1) and not index 0',
        'element O', [5, 1, 3])] + [
        [m.guess_element(n) for n in ('CA', 'OW', 'HW1', 'Cl1', 'NA')]]


def select_single_frame_dims(m):
    base = _solvated(m)
    system = m.System(base.topology, np.asarray(base.positions),
                      dimensions=np.array([10.0, 10, 10, 90, 90, 90]))
    return [system.dimensions,
            system.select_atoms('resname SOL and around 1.0 resname LIG')]


def select_errors(m):
    system = _solvated(m)
    return [_error(lambda: system.topology.select_atoms(
                'around 5.0 resname LIG')),
            _error(lambda: system.select_atoms('around LIG resname SOL')),
            _error(lambda: system.select_atoms('within 5.0 resname LIG')),
            _error(lambda: system.select_atoms('resname LIG and')),
            len(system.topology.select_atoms('resname SOL'))]


def select_chosen_frame(m):
    pos0 = np.asarray(_solvated(m).positions[0])
    pos1 = pos0.copy()
    pos1[6] = [9.0, 6.0, 5.0]
    system = _solvated(m, np.stack([pos0, pos1]), np.tile(
        [[10.0, 10.0, 10.0, 90.0, 90.0, 90.0]], (2, 1)))
    sel = 'resname SOL and around 1.0 resname LIG'
    return [system.select_atoms(sel, frame=0),
            system.select_atoms(sel, frame=1)]


def select_triclinic_dims(m):
    rng = np.random.default_rng(4)
    dims = np.array([9.0, 10.0, 11.0, 80.0, 95.0, 110.0])
    box = m.dims_to_box(dims)
    pos = rng.uniform(0.0, 9.0, size=(12, 3))
    system = _solvated(m, pos[None], dims[None])
    return [box, m.box_to_dims(box), m.box_to_dims(np.zeros((3, 3))),
            system.select_atoms('resname SOL and around 3.0 resname LIG'),
            system.select_atoms('byres (sphzone 3.5 index 0)')]


def _brute_force(points, ref, cell):
    shifts = np.array([[i, j, k] for i in range(-2, 3) for j in range(-2, 3)
                       for k in range(-2, 3)], dtype=float) @ cell
    return np.min(np.linalg.norm(
        points[:, None, None, :] - (ref[None, :, None, :] + shifts),
        axis=-1), axis=(1, 2))


def min_image_triclinic(m):
    rng = np.random.default_rng(11)
    dims = np.array([9.0, 10.0, 11.0, 80.0, 95.0, 110.0])
    cell = m.dims_to_box(dims)
    points = rng.uniform(-5, 15, (30, 3))
    ref = rng.uniform(-5, 15, (5, 3))
    got = m.min_image(points, ref, dims)
    np.testing.assert_allclose(got, _brute_force(points, ref, cell),
                               atol=1e-9)
    lattice = [m.min_image(np.array([[0.5, 0.5, 0.5]]) + np.asarray(
        shift, dtype=float) @ cell, np.array([[0.5, 0.5, 0.5]]), dims)
        for shift in ([1, 0, 0], [0, 1, 0], [1, 1, 1], [-1, 2, 0])]
    return [got] + lattice


def min_image_orthorhombic(m):
    rng = np.random.default_rng(3)
    dims = np.array([8.0, 11.0, 9.0, 90.0, 90.0, 90.0])
    points = rng.uniform(0, 12, (40, 3))
    ref = rng.uniform(0, 12, (7, 3))
    got = m.min_image(points, ref, dims)
    np.testing.assert_allclose(
        got, _brute_force(points, ref, np.diag(dims[:3])), atol=1e-9)
    return got


# --------------------------------------------------------------------------
# Datasets and timesteps (tests/io/test_timestep.py)
# --------------------------------------------------------------------------

N_FRAMES, N_ATOMS = 8, 5


def _dataset(m, with_box=True, with_times=True):
    rng = np.random.default_rng(0)
    topology = m.Topology(names=[f'C{i}' for i in range(N_ATOMS)])
    positions = rng.normal(0, 1, size=(N_FRAMES, N_ATOMS, 3))
    dimensions = (np.tile([10.0, 11.0, 12.0, 90.0, 90.0, 90.0],
                          (N_FRAMES, 1)) if with_box else None)
    times = np.arange(N_FRAMES) * 0.5 if with_times else None
    return m.TrajectoryDataset(m.System(topology, positions,
                                        dimensions=dimensions, times=times))


def _timestep(ts):
    return [ts.frame, ts.n_atoms, ts.positions, ts.dimensions, ts.time,
            repr(ts)]


def dataset_timesteps(m):
    dataset = _dataset(m)
    bare = _dataset(m, with_box=False, with_times=False)
    return [_timestep(dataset.get_timestep(3)),
            _timestep(bare.get_timestep(0)),
            isinstance(dataset.get_timestep(1), m.Timestep)]


def dataset_subsample_and_select(m):
    dataset = _dataset(m)
    kept = dataset.subsample(step=2)
    chosen = dataset.select_atoms([1, 3])
    return [kept, chosen, dataset.n_atoms, len(dataset),
            [_timestep(ts) for ts in dataset.iterate_as_timestep()],
            dataset.get_batch([0, 3]), dataset[2]]


def dataset_subsample_by_time(m):
    u = m.ureg
    times = np.arange(20) * 0.25
    dataset = _dataset(m)
    dataset.subsample(start=1.0 * u.picosecond, stop=3.2 * u.picosecond,
                      step=2)
    return [m.subsampled(20, times, start=0.3 * u.picosecond,
                         step=1.0 * u.picosecond),
            m.subsampled(20, times, stop=2.9 * u.picosecond, n_frames_out=5),
            m.subsampled(20, start=3, stop=15, step=4),
            dataset.trajectory_sample_indices,
            _error(lambda: m.subsampled(20, step=0.5 * u.picosecond)),
            _error(lambda: m.subsampled(20, step=2, n_frames_out=3))]


def dataset_subset(m):
    dataset = _dataset(m)
    subset = m.Subset(dataset, [2, 5, 7])
    chosen = m.Subset.from_filter(
        dataset, lambda idx, ts: ts.positions[0, 0] > 0)
    return [m.TrajectorySubset is m.Subset,
            [ts.frame for ts in subset.iterate_as_timestep()],
            subset.trajectory_sample_indices, subset[1], subset[-1],
            subset.get_batch([0, 2]), subset.get_batch([-1, 0]),
            [ts.frame for ts in chosen.iterate_as_timestep()],
            subset.n_atoms, len(subset)]


def dataset_aux_and_merge(m):
    dataset = _dataset(m)
    dataset.add_aux('log_weights', np.linspace(-1.0, 1.0, N_FRAMES))
    dataset.subsample(step=3)
    extra = m.DictDataset({'bias': np.arange(len(dataset)) * 0.5})
    merged = m.MergedDataset(dataset, extra)
    return [dataset.get_batch([1, 0]), merged.get_batch([2, 1]), merged[0],
            merged.n_atoms, extra['bias'], extra.keys,
            _error(lambda: dataset.add_aux('w', np.zeros(3))),
            _error(lambda: m.DictDataset({'a': [1, 2], 'b': [1]})),
            _error(lambda: m.MergedDataset(dataset, dataset))]


# --------------------------------------------------------------------------
# StatefulBatchSampler (tests/io/test_sampler.py)
# --------------------------------------------------------------------------

def _collect(sampler):
    return [batch.tolist() for batch in sampler]


def _epochs(m, shuffle_seed, n_epochs=3, n=12, batch_size=4):
    trainer = _Trainer()
    sampler = m.StatefulBatchSampler(list(range(n)), batch_size=batch_size,
                                     shuffle=True, trainer=trainer,
                                     shuffle_seed=shuffle_seed)
    orders = []
    for _ in range(n_epochs):
        orders.append(_collect(sampler))
        trainer.global_step += len(sampler)
    return [orders, sampler.state_dict()]


def sampler_sequential_and_len(m):
    data = list(range(10))
    return [_collect(m.StatefulBatchSampler(list(range(7)), batch_size=3,
                                            trainer=_Trainer())),
            len(m.StatefulBatchSampler(data, batch_size=3)),
            len(m.StatefulBatchSampler(data, batch_size=3, drop_last=True)),
            _collect(m.StatefulBatchSampler(data, batch_size=3,
                                            drop_last=True,
                                            trainer=_Trainer(2))),
            _error(lambda: next(iter(m.StatefulBatchSampler(data)))),
            _error(lambda: m.StatefulBatchSampler(data, shuffle=True,
                                                  shuffle_seed=-1))]


def sampler_mid_epoch_resume(m):
    trainer = _Trainer()
    sampler = m.StatefulBatchSampler(list(range(12)), batch_size=4,
                                     shuffle=True, trainer=trainer,
                                     shuffle_seed=42)
    full_epoch = _collect(sampler)
    state = sampler.state_dict()
    resumed = m.StatefulBatchSampler(list(range(12)), batch_size=4,
                                     shuffle=True, trainer=_Trainer(1),
                                     shuffle_seed=42)
    resumed.load_state_dict(state)
    bare = m.StatefulBatchSampler(list(range(12)), batch_size=4,
                                  shuffle=True, trainer=_Trainer(1),
                                  shuffle_seed=42)
    rest, bare_rest = _collect(resumed), _collect(bare)
    assert rest == bare_rest == full_epoch[1:]
    return [full_epoch, state, rest]


def sampler_stored_seed_resume(m):
    # An unseeded sampler resumes from the stored epoch seed alone.
    state = {'current_epoch_seed': 987654321}
    resumed = m.StatefulBatchSampler(list(range(12)), batch_size=4,
                                     shuffle=True, trainer=_Trainer(2))
    resumed.load_state_dict(state)
    boundary = m.StatefulBatchSampler(list(range(9)), batch_size=3,
                                      shuffle=True, trainer=_Trainer(3),
                                      shuffle_seed=7)
    boundary.load_state_dict({'current_epoch_seed': 1234})
    return [_collect(resumed), _collect(boundary), boundary.state_dict()]


# --------------------------------------------------------------------------
# TFEPLogger (tests/io/test_log.py), torch tensors on the port's side
# --------------------------------------------------------------------------

def _logger(m, path, batch_size=4, n_samples=10):
    return m.TFEPLogger(save_dir_path=str(path), batch_size=batch_size,
                        n_samples_per_epoch=n_samples)


def _tensors(m, indices, potentials=None):
    indices = np.asarray(indices)
    if potentials is None:
        potentials = indices.astype(float) * 10.0
    return {'dataset_sample_index': m.array(indices),
            'potential': m.array(np.asarray(potentials, dtype=np.float64))}


def log_train_addressing(m, path):
    logger = _logger(m, path)
    logger.save_train_tensors(_tensors(m, [8, 9]), epoch_idx=0, batch_idx=2)
    logger.save_train_tensors(_tensors(m, [0, 1, 2, 3]), epoch_idx=0,
                              batch_idx=0)
    logger.save_train_tensors(_tensors(m, [4, 5, 6, 7]), step_idx=4)
    return [logger.read_train_tensors(epoch_idx=0),
            logger.read_train_tensors(epoch_idx=0, batch_idx=2),
            logger.read_train_tensors(epoch_idx=0, batch_idx=1),
            logger.read_train_tensors(step_idx=4),
            os.path.isfile(os.path.join(logger.save_dir_path, 'train',
                                        'epoch-1.npz')),
            logger.n_batches_per_epoch,
            _error(lambda: logger.read_train_tensors())]


def log_train_nans(m, path):
    logger = _logger(m, path, batch_size=4, n_samples=4)
    tensors = {'dataset_sample_index': m.array(np.arange(4)),
               'potential': m.array(np.array([1.0, np.nan, 3.0, 4.0])),
               'log_det_J': m.array(np.array([0.1, 0.2, np.nan, 0.4]))}
    logger.save_train_tensors(tensors, epoch_idx=0, batch_idx=0)
    return [logger.read_train_tensors(epoch_idx=0, remove_nans=True),
            logger.read_train_tensors(epoch_idx=0, remove_nans='potential'),
            logger.read_train_tensors(epoch_idx=0)]


def log_eval_channel(m, path):
    logger = _logger(m, path)
    logger.save_eval_tensors(_tensors(m, [0, 1, 2]), step_idx=7)
    logger.save_eval_tensors(_tensors(m, [3, 4]), step_idx=7)
    appended = logger.read_eval_tensors(step_idx=7)
    logger.save_eval_tensors(_tensors(m, [1, 5], [-1.0, -5.0]), step_idx=7,
                             update=True)
    logger.save_eval_tensors(_tensors(m, [2, 0, 1], [1.0, np.nan, 3.0]),
                             step_idx=0)
    return [appended,
            logger.read_eval_tensors(step_idx=7,
                                     sort_by='dataset_sample_index'),
            logger.read_eval_tensors(step_idx=0, remove_nans=True),
            _error(lambda: logger.save_eval_tensors(
                {'dataset_sample_index': m.array(np.array([2]))},
                step_idx=0)),
            _error(lambda: logger.save_eval_tensors(_tensors(m, [0]),
                                                    epoch_idx=0))]


def log_metadata_resume(m, path):
    logger = _logger(m, path)
    logger.save_train_tensors(_tensors(m, [0, 1, 2, 3]), epoch_idx=0,
                              batch_idx=0)
    logger.save_eval_tensors(_tensors(m, [2, 0, 1]), step_idx=0)
    logger.read_eval_tensors(step_idx=0, sort_by='dataset_sample_index')
    again = m.TFEPLogger(save_dir_path=logger.save_dir_path, batch_size=99,
                         n_samples_per_epoch=99)
    with open(os.path.join(logger.save_dir_path, 'metadata.json')) as f:
        meta = json.load(f)

    class Loader:
        batch_size = 3
        drop_last = True
        dataset = list(range(11))

    from_loader = m.TFEPLogger(save_dir_path=str(path / 'loader'),
                               data_loader=Loader())
    return [again.batch_size, again.n_samples_per_epoch,
            again.read_train_tensors(epoch_idx=0),
            again.read_eval_tensors(step_idx=0), meta,
            from_loader.n_samples_per_epoch, from_loader.n_batches_per_epoch,
            _error(lambda: m.TFEPLogger(save_dir_path=str(path / 'bare')))]


def log_device_tensors(m, path):
    """Tensors that need a grad or a detach: the port moves them to the
    host itself."""
    logger = _logger(m, path, batch_size=2, n_samples=2)
    potential = m.array(np.array([1.0, 2.0]))
    if isinstance(potential, torch.Tensor):
        potential = potential.requires_grad_() * 1.0
    logger.save_train_tensors({'trajectory_sample_index': m.array(
        np.arange(2)), 'potential': potential}, epoch_idx=0, batch_idx=0)
    data = logger.read_train_tensors(epoch_idx=0)
    assert all(isinstance(v, np.ndarray) for v in data.values())
    return data


CASES = [units_kT, units_conversions, units_array_helpers,
         select_around_periodic, select_around_within, select_byres,
         select_sphzone_point, select_attributes, select_single_frame_dims,
         select_errors, select_chosen_frame, select_triclinic_dims,
         min_image_triclinic, min_image_orthorhombic,
         dataset_timesteps, dataset_subsample_and_select,
         dataset_subsample_by_time, dataset_subset, dataset_aux_and_merge,
         sampler_sequential_and_len, sampler_mid_epoch_resume,
         sampler_stored_seed_resume]
LOGGER_CASES = [log_train_addressing, log_train_nans, log_eval_channel,
                log_metadata_resume, log_device_tensors]


def assert_same(port, ref, where='result'):
    """Equal structure, and equal values: these modules are copies, so
    every number agrees bit for bit (NaNs in the same places)."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), where
        for key in ref:
            assert_same(port[key], ref[key], f'{where}[{key!r}]')
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(port) == len(ref), \
            where
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f'{where}[{i}]')
    elif ref is None or isinstance(ref, (str, bool)):
        assert port == ref, where
    else:
        port, ref = np.asarray(port), np.asarray(ref)
        assert port.shape == ref.shape, where
        assert port.dtype.kind == ref.dtype.kind, where
        np.testing.assert_array_equal(port, ref, err_msg=where)


@pytest.mark.parametrize('case', CASES, ids=lambda c: c.__name__)
def test_same_as_jax(case):
    assert_same(case(PORT), case(JAX))


@pytest.mark.parametrize('seed', [0, 123])
def test_sampler_seeded_permutations_same_as_jax(seed):
    port = _epochs(PORT, seed) + [_epochs(PORT, seed, n=40963,
                                          batch_size=4096, n_epochs=2)]
    ref = _epochs(JAX, seed) + [_epochs(JAX, seed, n=40963,
                                        batch_size=4096, n_epochs=2)]
    assert_same(port, ref)
    orders = port[0]
    assert orders[0] != orders[1] != orders[2]
    assert sorted(i for b in orders[0] for i in b) == list(range(12))


@pytest.mark.parametrize('case', LOGGER_CASES, ids=lambda c: c.__name__)
def test_logger_same_as_jax(case, tmp_path):
    assert_same(case(PORT, tmp_path / 'port'), case(JAX, tmp_path / 'jax'))


def test_trajectory_files_are_not_ported(tmp_path):
    """The file branch of ``io/traj.py``: each call that once raised now
    gives what the JAX package's gives on the same files."""
    def calls(m, traj, out):
        out.mkdir()
        system = _solvated(m)
        for ext in ('pdb', 'gro', 'xyz'):
            system.save(str(out / f'x.{ext}'))
        read = {ext: getattr(traj, f'read_{ext}')(str(out / f'x.{ext}'))
                for ext in ('pdb', 'gro', 'xyz')}
        loaded = m.System.from_file(str(out / 'x.pdb'))
        topology = traj.load_topology(str(out / 'x.gro'))
        return ([(s.positions, s.dimensions, s.topology.names)
                 for s in read.values()]
                + [loaded.positions, topology.names, topology.resids]
                + [(out / f'x.{ext}').read_bytes().decode()
                   for ext in ('pdb', 'gro', 'xyz')])

    assert_same(calls(PORT, port_traj, tmp_path / 'port'),
                calls(JAX, jax_traj, tmp_path / 'jax'))
