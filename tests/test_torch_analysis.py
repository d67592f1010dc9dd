"""The port's analysis (``fep_estimator``, ``bootstrap``,
``estimate_from_logger``) against the JAX package's, in float64 on the CPU.

``fep_estimator`` is held against JAX at 1e-12 in every layout and on
every error path. ``bootstrap`` draws with a ``torch.Generator`` where JAX
draws with its own PRNG, so its draws differ from JAX's in value, not in
law: it is held against ``scipy.stats.bootstrap`` (as
``tests/analysis/test_analysis.py`` holds the JAX package's) and, at
1e-12, against a numpy recomputation on the indices and weights that a
generator seeded alike draws again. ``estimate_from_logger`` reads loggers
that each package's ``Trainer`` wrote while training ``CartesianMAFMap``
from the same trajectory files (the two runs are also held against each
other step by step): the work, its sample indices, the sample count and
the point estimate agree with JAX's at 1e-10, the confidence interval
within its Monte Carlo error. Last, ``tests/app/test_biased.py``'s
analytic case runs through the port's map and trainer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import tfep_tpu.analysis as jax_analysis
import tfep_tpu.app as jax_app
import tfep_tpu.io.log as jax_log
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.units as jax_units
from tfep_tpu.nn.transformers import NeuralSplineTransformer as JaxSpline
from tfep_tpu_torch.analysis import (
    bootstrap, estimate_from_logger, fep_estimator,
)
from tfep_tpu_torch.app import CartesianMAFMap, Trainer
from tfep_tpu_torch.io import DictDataset, MergedDataset
from tfep_tpu_torch.io.log import TFEPLogger
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System, TrajectoryDataset
from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
from tfep_tpu_torch.units import ureg

from test_torch_common import CPU, DTYPE, GRAD_ATOL, carry, close, perturb

TIGHT = 1e-12


def _stat(d, vectorized=False, weights=None):
    return fep_estimator(d, vectorized=vectorized, weights=weights)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=DTYPE)


def _lse(x, axis=-1):
    m = np.max(x, axis=axis, keepdims=True)
    return (m + np.log(np.sum(np.exp(x - m), axis=axis,
                              keepdims=True))).squeeze(axis)


# --------------------------------------------------------------------------
# fep_estimator against JAX
# --------------------------------------------------------------------------

def _layouts():
    rng = np.random.default_rng(0)
    work = rng.normal(1.0, 0.6, size=300)
    bias = rng.normal(0.0, 0.8, size=300)
    work_b = rng.normal(1.0, 0.4, size=(6, 300))
    bias_b = rng.normal(size=(6, 300))
    weights = rng.dirichlet(np.ones(300), size=6)
    return {
        'plain': (work, {}),
        'plain_kT': (work * 0.596, dict(kT=0.596)),
        'biased': (np.stack([work, bias], -1), {}),
        'biased_kT': (np.stack([work, bias], -1) * 0.596, dict(kT=0.596)),
        'weighted': (work_b, dict(weights=weights, vectorized=True)),
        'vectorized': (work_b, dict(vectorized=True)),
        'vectorized_biased': (np.stack([work_b, bias_b], -1),
                              dict(vectorized=True)),
        'constant_bias': (np.stack([work, np.full(300, 3.21)], -1), {}),
    }


@pytest.mark.parametrize('layout', sorted(_layouts()))
def test_fep_estimator_same_as_jax(layout):
    data, kwargs = _layouts()[layout]
    ref = np.asarray(jax_analysis.fep_estimator(jnp.asarray(data), **kwargs))
    port = fep_estimator(data, device=CPU, **kwargs)
    assert port.dtype == torch.float64 and port.device.type == 'cpu'
    assert port.shape == ref.shape
    close(port, ref, TIGHT)
    # A tensor stays where it is, with its dtype.
    tensor_kwargs = {k: _t(v) if k == 'weights' else v
                     for k, v in kwargs.items()}
    close(fep_estimator(_t(data), **tensor_kwargs), ref, TIGHT)


def test_fep_estimator_keeps_float32():
    work = np.random.default_rng(1).normal(size=50).astype(np.float32)
    port = fep_estimator(torch.from_numpy(work))
    assert port.dtype == torch.float32
    np.testing.assert_allclose(float(port), float(
        jax_analysis.fep_estimator(jnp.asarray(work))), rtol=1e-6)


@pytest.mark.parametrize('case', ['weights_with_bias', 'transposed'])
def test_fep_estimator_errors_same_as_jax(case):
    def call(estimator, array):
        if case == 'weights_with_bias':
            return estimator(array(np.zeros((10, 2))),
                             weights=array(np.ones(10) / 10))
        return estimator(array(np.zeros((2, 10))))

    errors = []
    for estimator, array in ((jax_analysis.fep_estimator, jnp.asarray),
                             (fep_estimator, _t)):
        with pytest.raises((ValueError, NotImplementedError)) as info:
            call(estimator, array)
        errors.append((info.type, str(info.value)))
    assert errors[0] == errors[1]


def test_numpy_input_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fep_estimator(np.zeros(3))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bootstrap(np.zeros(3), _stat, n_resamples=2)


# --------------------------------------------------------------------------
# bootstrap
# --------------------------------------------------------------------------

def _mean_statistic(data, weights=None, vectorized=False):
    if weights is not None:
        return torch.sum(data * weights, dim=-1)
    if vectorized:
        return torch.mean(data, dim=-1)
    return torch.mean(data)


@pytest.mark.parametrize('method', ['percentile', 'basic'])
def test_bootstrap_matches_scipy(method):
    """As tests/analysis/test_analysis.py:29 holds the JAX package's."""
    data = np.random.default_rng(42).normal(2.0, 1.5, size=400)
    ours = bootstrap(data, _mean_statistic, n_resamples=4000, method=method,
                     seed=1, device=CPU)
    ref = scipy.stats.bootstrap(
        (data,), np.mean, n_resamples=4000, method=method,
        confidence_level=0.95, random_state=np.random.default_rng(1),
        vectorized=False)
    tol = 0.25 * data.std() / np.sqrt(len(data)) * 3
    assert abs(float(ours['confidence_interval']['low'])
               - ref.confidence_interval.low) < tol
    assert abs(float(ours['confidence_interval']['high'])
               - ref.confidence_interval.high) < tol
    np.testing.assert_allclose(float(ours['standard_deviation']),
                               ref.standard_error, rtol=0.15)


def _redrawn_statistics(work, seed, n_resamples, batch, sizes,
                        take_first_only=False, bayesian=False):
    """The bootstrap's FEP statistics recomputed in numpy float64 on the
    draws a generator seeded alike gives again (see the draw order in
    ``tfep_tpu_torch/analysis/bootstrap.py``)."""
    generator = torch.Generator().manual_seed(seed)
    n = len(work)
    out = []
    for size in sizes:
        stats = []
        for k in range(0, n_resamples, batch):
            b = min(batch, n_resamples - k)
            if bayesian:
                w = torch.empty((b, size), dtype=DTYPE).exponential_(
                    generator=generator).numpy()
                w = w / w.sum(-1, keepdims=True)
                stats.append(-_lse(-work[:size] + np.log(w)))
            else:
                idx = torch.randint(0, size if take_first_only else n,
                                    (b, size), generator=generator).numpy()
                stats.append(-_lse(-work[idx] - np.log(size)))
        out.append(np.concatenate(stats))
    return out


def _summary(stats, method='percentile', full=None):
    low, high = np.quantile(stats, [0.025, 0.975])
    if method == 'basic':
        low, high = 2 * full - high, 2 * full - low
    return dict(confidence_interval=dict(low=low, high=high),
                standard_deviation=np.std(stats, ddof=1),
                mean=np.mean(stats), median=np.median(stats))


def _assert_summary(port, ref):
    close(port['confidence_interval']['low'],
          ref['confidence_interval']['low'], TIGHT)
    close(port['confidence_interval']['high'],
          ref['confidence_interval']['high'], TIGHT)
    for key in ('standard_deviation', 'mean', 'median'):
        close(port[key], ref[key], TIGHT)


@pytest.mark.parametrize('method', ['percentile', 'basic'])
@pytest.mark.parametrize('batch', [None, 300])
def test_bootstrap_against_numpy_on_redrawn_indices(method, batch):
    work = np.random.default_rng(3).normal(1.0, 0.7, size=250)
    port = bootstrap(work, _stat, n_resamples=1000, batch=batch,
                     method=method, seed=11, device=CPU)
    (stats,) = _redrawn_statistics(work, 11, 1000, batch or 1000, [250])
    full = -_lse(-work - np.log(250))
    _assert_summary(port, _summary(stats, method, full))


def test_bootstrap_sample_sizes_and_take_first_on_redrawn_indices():
    work = np.random.default_rng(4).normal(0.5, 0.5, size=400)
    port = bootstrap(work, _stat, n_resamples=600, batch=256,
                     bootstrap_sample_size=[20, 400], take_first_only=True,
                     seed=2, device=CPU)
    refs = _redrawn_statistics(work, 2, 600, 256, [20, 400],
                               take_first_only=True)
    assert isinstance(port, list) and len(port) == 2
    for p, stats in zip(port, refs):
        _assert_summary(p, _summary(stats))
    widths = [float(r['confidence_interval']['high']
                    - r['confidence_interval']['low']) for r in port]
    assert widths[0] > 3 * widths[1]
    # A one-element list of sizes returns the bare dict, as in JAX.
    single = bootstrap(work, _stat, n_resamples=50,
                       bootstrap_sample_size=[100], take_first_only=True,
                       seed=0, device=CPU)
    assert isinstance(single, dict)


def test_bayesian_bootstrap_on_redrawn_weights():
    work = np.random.default_rng(5).normal(1.0, 0.5, size=300)
    port = bootstrap(work, _stat, n_resamples=800, batch=500, bayesian=True,
                     seed=6, device=CPU)
    (stats,) = _redrawn_statistics(work, 6, 800, 500, [300], bayesian=True)
    _assert_summary(port, _summary(stats))


def test_bayesian_weights_sum_to_one():
    seen = []

    def statistic(d, vectorized=False, weights=None):
        seen.append(weights)
        return _mean_statistic(d, weights=weights, vectorized=vectorized)

    n = 500
    data = np.random.default_rng(7).normal(3.0, 1.0, size=n)
    result = bootstrap(data, statistic, n_resamples=2000, bayesian=True,
                       seed=5, device=CPU)
    (weights,) = seen
    assert weights.shape == (2000, n) and weights.dtype == torch.float64
    close(weights.sum(-1), np.ones(2000), TIGHT)
    assert bool((weights > 0).all())
    np.testing.assert_allclose(float(weights.mean()), 1.0 / n, rtol=1e-12)
    # Dirichlet(1, ..., 1): each weight has variance (n - 1) / (n^2 (n + 1)).
    np.testing.assert_allclose(float(weights.var()),
                               (n - 1) / (n * n * (n + 1)), rtol=0.05)
    np.testing.assert_allclose(float(result['mean']), data.mean(), atol=0.05)
    np.testing.assert_allclose(float(result['standard_deviation']),
                               1.0 / np.sqrt(n), rtol=0.25)


@pytest.mark.parametrize('n_resamples', [2000, 9999])
def test_median_of_an_even_and_an_odd_count(n_resamples):
    """``torch.median`` takes the lower middle value of an even count;
    the bootstrap's median averages the two, as ``np.median`` does."""
    seen = []

    def statistic(d, vectorized=False, weights=None):
        out = _stat(d, vectorized=vectorized, weights=weights)
        seen.append(out)
        return out

    work = np.random.default_rng(8).normal(size=60)
    result = bootstrap(work, statistic, n_resamples=n_resamples, seed=0,
                       device=CPU)
    stats = torch.cat(seen).numpy()
    assert len(stats) == n_resamples
    assert float(result['median']) == np.median(stats)
    if n_resamples % 2 == 0:
        assert float(torch.median(torch.from_numpy(stats))) != \
            np.median(stats)


def test_bootstrap_seed_spellings_and_errors():
    work = np.random.default_rng(9).normal(size=200)
    draws = [bootstrap(work, _stat, n_resamples=50, seed=s, device=CPU)
             for s in (None, 0, np.int64(0), torch.Generator().manual_seed(0))]
    for d in draws[1:]:
        _assert_summary(d, draws[0])
    # A generator goes on drawing from where it stood.
    generator = torch.Generator().manual_seed(0)
    first = bootstrap(work, _stat, n_resamples=50, seed=generator,
                      device=CPU)
    second = bootstrap(work, _stat, n_resamples=50, seed=generator,
                       device=CPU)
    assert float(first['mean']) != float(second['mean'])
    with pytest.raises(ValueError, match='take_first_only'):
        bootstrap(work, _mean_statistic, bayesian=True,
                  bootstrap_sample_size=[10, 50], n_resamples=10, device=CPU)
    with pytest.raises(ValueError, match='take_first_only'):
        bootstrap(work, _mean_statistic, bayesian=True,
                  bootstrap_sample_size=10, n_resamples=10, device=CPU)
    with pytest.raises(ValueError, match='percentile'):
        bootstrap(work, _mean_statistic, n_resamples=10, method='bca',
                  device=CPU)


def test_bootstrap_keeps_the_tensors_device_and_dtype():
    work = torch.from_numpy(
        np.random.default_rng(10).normal(size=100).astype(np.float32))
    result = bootstrap(work, _stat, n_resamples=100, seed=0)
    for value in (result['mean'], result['confidence_interval']['low']):
        assert value.dtype == torch.float32 and value.device.type == 'cpu'


def test_bootstrapped_fep_estimate_brackets_analytic():
    mu, sigma = 1.0, 0.4
    work = np.random.default_rng(11).normal(mu, sigma, size=4000)
    result = bootstrap(work, _stat, n_resamples=1000, seed=6, device=CPU)
    analytic = mu - sigma ** 2 / 2
    assert float(result['confidence_interval']['low']) < analytic \
        < float(result['confidence_interval']['high'])


# --------------------------------------------------------------------------
# estimate_from_logger on loggers that each package's Trainer wrote, while
# training CartesianMAFMap from the same trajectory files
# --------------------------------------------------------------------------

N_ATOMS, N_FRAMES, N_LAYERS, N_BINS, BATCH, N_EPOCHS = 6, 96, 2, 4, 32, 2
MAPPED, CONDITIONING = [1, 2, 3, 4, 5], [0]
STEPS = N_EPOCHS * N_FRAMES // BATCH


class _JaxPotential:
    energy_unit = jax_units.ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return jnp.sum(x, axis=-1) + 0.3 * jnp.sum(x * x, axis=-1)


class _PortPotential:
    energy_unit = ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return torch.sum(x, dim=-1) + 0.3 * torch.sum(x * x, dim=-1)


def _write_files(path):
    """A PDB topology and an XTC of the frames, written by the port."""
    rng = np.random.default_rng(0)
    topology = Topology(names=[f'C{i}' for i in range(N_ATOMS)],
                        elements=['C'] * N_ATOMS, resnames=['MOL'] * N_ATOMS,
                        resids=[1] * N_ATOMS,
                        bonds=[(i, i + 1) for i in range(N_ATOMS - 1)])
    frames = 10.0 + 1.5 * rng.normal(size=(N_FRAMES, N_ATOMS, 3))
    system = System(topology, frames,
                    dimensions=np.tile([40.0, 40, 40, 90, 90, 90],
                                       (N_FRAMES, 1)))
    system.save(str(path / 'top.pdb'))
    system.save(str(path / 'traj.xtc'))
    return dict(coordinates_file_path=str(path / 'traj.xtc'),
                topology_file_path=str(path / 'top.pdb'),
                lazy_trajectory=True, batch_size=BATCH,
                mapped_atoms=MAPPED, conditioning_atoms=CONDITIONING,
                n_maf_layers=N_LAYERS)


@pytest.fixture(scope='module')
def file_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp('files')
    files = _write_files(path)
    n_dofs = 3 * len(MAPPED)
    jax_map = jax_app.CartesianMAFMap(
        potential_energy_func=_JaxPotential(),
        temperature=300.0 * jax_units.ureg.kelvin,
        tfep_logger_dir_path=str(path / 'jax'),
        flow_kwargs=dict(transformer=JaxSpline.create(
            x0=-30.0 * jnp.ones(n_dofs), xf=30.0 * jnp.ones(n_dofs),
            n_bins=N_BINS, fused='never')), **files)
    jax_map.setup()
    jax_map.flow = perturb(jax_map.flow, seed=1, scale=0.05)
    port_map = CartesianMAFMap(
        potential_energy_func=_PortPotential(),
        temperature=300.0 * ureg.kelvin,
        tfep_logger_dir_path=str(path / 'port'),
        flow_kwargs=dict(transformer=NeuralSplineTransformer(
            -30.0 * np.ones(n_dofs), 30.0 * np.ones(n_dofs), N_BINS,
            device=CPU, dtype=DTYPE)),
        device=CPU, dtype=DTYPE, **files)
    port_map.setup()
    carry(jax_map.flow, port_map.flow)
    jax_trainer = jax_app.Trainer(save_dir=None, max_epochs=N_EPOCHS,
                                  shuffle_seed=0)
    jax_trainer.fit(jax_map)
    port_trainer = Trainer(save_dir=None, max_epochs=N_EPOCHS,
                           shuffle_seed=0)
    port_trainer.fit(port_map)
    jax_map.run_evaluation(STEPS, batch_size=40)
    port_map.run_evaluation(STEPS, batch_size=40)
    rng = np.random.default_rng(5)
    return dict(jax_map=jax_map, port_map=port_map, jax_trainer=jax_trainer,
                port_trainer=port_trainer, jax_logs=str(path / 'jax'),
                port_logs=str(path / 'port'),
                u_a=rng.normal(0.0, 0.5, size=N_FRAMES),
                bias=rng.normal(0.0, 0.7, size=N_FRAMES))


def test_file_maps_read_the_same_frames(file_runs):
    jax_map, port_map = file_runs['jax_map'], file_runs['port_map']
    assert type(port_map._system.positions).__name__ == 'XtcFrameStore'
    assert port_map.hparams['system'] is None
    assert port_map.hparams['coordinates_file_path'].endswith('traj.xtc')
    np.testing.assert_array_equal(np.asarray(port_map._system.positions),
                                  np.asarray(jax_map._system.positions))
    np.testing.assert_array_equal(port_map._system.topology.bonds,
                                  jax_map._system.topology.bonds)


@pytest.mark.parametrize('step', range(STEPS))
def test_file_maps_train_alike(file_runs, step):
    jax_rows = file_runs['jax_map'].tfep_logger.read_train_tensors(
        step_idx=step)
    port_rows = file_runs['port_map'].tfep_logger.read_train_tensors(
        step_idx=step)
    assert sorted(port_rows) == sorted(jax_rows)
    for key in ('dataset_sample_index', 'trajectory_sample_index'):
        np.testing.assert_array_equal(port_rows[key], jax_rows[key])
    close(port_rows['potential'], jax_rows['potential'])
    close(port_rows['log_det_J'], jax_rows['log_det_J'])
    close(file_runs['port_trainer'].loss_history[step],
          file_runs['jax_trainer'].loss_history[step])


def test_file_maps_end_with_the_same_weights(file_runs):
    from tfep_tpu_torch.convert import torch_name

    from test_torch_common import jax_state
    trained = {torch_name(k): v
               for k, v in jax_state(file_runs['jax_map'].flow).items()}
    for name, param in file_runs['port_map'].flow.named_parameters():
        close(param, trained[name], GRAD_ATOL)


MODES = {
    'single': dict(epoch_idx=0),
    'single_reference': dict(epoch_idx=1, reference=True),
    'multimap': dict(epoch_idx=[1, 0]),
    'biased': dict(epoch_idx=1, reference=True, bias=True),
    'multimap_biased': dict(epoch_idx=[0, 1], bias=True),
    'eval': dict(step_idx=STEPS, reference=True),
}


def _estimate(estimate, logger, runs, mode, n_resamples, **kwargs):
    spec = dict(MODES[mode])
    if spec.pop('reference', False):
        kwargs['reference_potentials'] = runs['u_a']
    if spec.pop('bias', False):
        kwargs['bias_potentials'] = runs['bias']
    return estimate(logger, n_resamples=n_resamples, **spec, **kwargs)


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('mode', sorted(MODES))
def test_estimate_from_logger_same_as_jax(file_runs, writer, mode):
    # Each package's logger reads the files that one trainer wrote.
    path = file_runs[f'{writer}_logs']
    logger = TFEPLogger(save_dir_path=path)
    ref_logger = jax_log.TFEPLogger(save_dir_path=path)
    n_resamples = 20_000
    port = _estimate(estimate_from_logger, logger, file_runs, mode,
                     n_resamples, seed=0, device=CPU)
    ref = _estimate(jax_analysis.estimate_from_logger, ref_logger,
                    file_runs, mode, n_resamples, seed=0)
    assert port['n_samples'] == ref['n_samples']
    np.testing.assert_array_equal(port['sample_indices'],
                                  ref['sample_indices'])
    close(port['work'], ref['work'])
    close(port['df'], ref['df'])
    # The two bootstraps draw differently: their endpoints agree within
    # the Monte Carlo error of a 2.5% quantile of 20,000 resamples, about
    # 0.03 bootstrap standard deviations (width / 3.92); 0.15 is five.
    sigma = (ref['confidence_interval']['high']
             - ref['confidence_interval']['low']) / 3.92
    for end in ('low', 'high'):
        assert abs(port['confidence_interval'][end]
                   - ref['confidence_interval'][end]) < 0.15 * sigma
    assert port['confidence_interval']['low'] <= port['df'] <= \
        port['confidence_interval']['high']


def test_estimate_from_logger_on_redrawn_indices(file_runs):
    """The multimap estimate's interval is the frame (cluster) bootstrap of
    the aligned work matrix, on the draws of its generator."""
    logger = file_runs['port_map'].tfep_logger
    result = estimate_from_logger(logger, epoch_idx=[0, 1], n_resamples=500,
                                  seed=3, device=CPU)
    work = result['work']
    generator = torch.Generator().manual_seed(3)
    idx = torch.randint(0, len(work), (500, len(work)),
                        generator=generator).numpy()
    flat = work[idx].reshape(500, -1)
    stats = -_lse(-flat - np.log(flat.shape[-1]))
    low, high = np.quantile(stats, [0.025, 0.975])
    close(result['confidence_interval']['low'], low, TIGHT)
    close(result['confidence_interval']['high'], high, TIGHT)
    close(result['df'], -_lse(-work.reshape(-1) - np.log(work.size)), TIGHT)


def test_estimate_from_logger_errors(tmp_path):
    logger = TFEPLogger(save_dir_path=str(tmp_path / 'logs'), batch_size=4,
                        n_samples_per_epoch=4)
    logger.save_train_tensors({'dataset_sample_index': np.arange(4),
                               'potential': np.ones(4),
                               'log_det_J': np.zeros(4)},
                              epoch_idx=0, batch_idx=0)
    with pytest.raises(ValueError, match='exactly one'):
        estimate_from_logger(logger, device=CPU)
    with pytest.raises(ValueError, match='exactly one'):
        estimate_from_logger(logger, epoch_idx=0, step_idx=0, device=CPU)
    logger.save_train_tensors({'dataset_sample_index': np.arange(4) + 4,
                               'potential': np.ones(4),
                               'log_det_J': np.zeros(4)},
                              epoch_idx=1, batch_idx=0)
    with pytest.raises(ValueError, match='share no'):
        estimate_from_logger(logger, epoch_idx=[0, 1], device=CPU)


# --------------------------------------------------------------------------
# tests/app/test_biased.py's analytic case, through the port
# --------------------------------------------------------------------------

B_FRAMES, B_ATOMS = 2000, 2
D = B_ATOMS * 3
SIGMA_B2 = 0.5
SIGMA_S = np.sqrt(2.0)
ANALYTIC_DF = -0.5 * D * np.log(SIGMA_B2)
WRONG_DF = 0.5 * D * np.log(1.0 + (1.0 / SIGMA_B2 - 1.0) * SIGMA_S ** 2)


class _GaussianB:
    energy_unit = None

    def __call__(self, x, cell=None):
        return torch.sum(x ** 2, dim=-1) / (2.0 * SIGMA_B2)


class _BiasedMAFMap(CartesianMAFMap):
    def __init__(self, *args, bias_values, **kwargs):
        super().__init__(*args, **kwargs)
        self._bias_values = np.asarray(bias_values)

    def create_dataset(self):
        return MergedDataset(TrajectoryDataset(self._system),
                             DictDataset({'bias': self._bias_values}))


@pytest.fixture(scope='module')
def biased_run(tmp_path_factory):
    rng = np.random.default_rng(0)
    positions = rng.normal(0.0, SIGMA_S, size=(B_FRAMES, B_ATOMS, 3))
    flat = positions.reshape(B_FRAMES, -1)
    topology = Topology(names=[f'C{i}' for i in range(B_ATOMS)],
                        elements=['C'] * B_ATOMS, resnames=['MOL'] * B_ATOMS,
                        resids=[1] * B_ATOMS)
    u_a = 0.5 * np.sum(flat ** 2, axis=1)
    bias = -0.25 * np.sum(flat ** 2, axis=1)
    tfep_map = _BiasedMAFMap(
        potential_energy_func=_GaussianB(),
        temperature=300.0 * ureg.kelvin, system=System(topology, positions),
        bias_values=bias, batch_size=200, n_maf_layers=2,
        tfep_logger_dir_path=str(tmp_path_factory.mktemp('biased') / 'logs'),
        device=CPU, dtype=DTYPE)
    Trainer(save_dir=None, max_epochs=2, shuffle=True,
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3)).fit(tfep_map)
    return tfep_map, u_a, bias


def test_biased_training_step_consumes_bias(biased_run):
    tfep_map, u_a, bias = biased_run
    assert tfep_map.kT == 1.0
    batch = tfep_map.batch_to_device(
        tfep_map.dataset.get_batch(list(range(64))))
    assert 'bias' in batch
    with torch.no_grad():
        loss, aux = tfep_map.training_step_fn(tfep_map.flow, batch)
        work = (aux['potential'] - aux['log_det_J']).numpy()
        w = np.exp(bias[:64] - np.max(bias[:64]))
        np.testing.assert_allclose(float(loss), np.sum(w / w.sum() * work),
                                   rtol=1e-8)
        plain = {k: v for k, v in batch.items() if k != 'bias'}
        loss_nb, _ = tfep_map.training_step_fn(tfep_map.flow, plain)
    np.testing.assert_allclose(float(loss_nb), np.mean(work), rtol=1e-8)


def test_biased_identity_map_df(biased_run):
    tfep_map, u_a, bias = biased_run
    flat = np.stack([tfep_map.dataset[i]['positions']
                     for i in range(B_FRAMES)])
    work = _GaussianB()(_t(flat)).numpy() - u_a
    df_weighted = float(fep_estimator(np.stack([work, bias], -1),
                                      device=CPU))
    df_unweighted = float(fep_estimator(work, device=CPU))
    assert abs(df_weighted - ANALYTIC_DF) < 0.15
    assert abs(df_unweighted - WRONG_DF) < 0.25
    assert abs(df_unweighted - ANALYTIC_DF) > 0.8


def test_biased_trained_map_brackets_analytic(biased_run):
    tfep_map, u_a, bias = biased_run
    result = estimate_from_logger(
        tfep_map.tfep_logger, epoch_idx=1, reference_potentials=u_a,
        bias_potentials=bias, n_resamples=1000, seed=0, device=CPU)
    ci = result['confidence_interval']
    half_width = (ci['high'] - ci['low']) / 2
    assert half_width < 0.5
    assert ci['low'] - 0.1 <= ANALYTIC_DF <= ci['high'] + 0.1
    unweighted = estimate_from_logger(
        tfep_map.tfep_logger, epoch_idx=1, reference_potentials=u_a,
        n_resamples=200, seed=0, device=CPU)
    assert abs(unweighted['df'] - ANALYTIC_DF) > 3 * half_width


def test_biased_multimap_estimate(biased_run):
    tfep_map, u_a, bias = biased_run
    result = estimate_from_logger(
        tfep_map.tfep_logger, epoch_idx=[0, 1], reference_potentials=u_a,
        bias_potentials=bias, n_resamples=500, seed=1, device=CPU)
    ci = result['confidence_interval']
    assert ci['low'] - 0.15 <= ANALYTIC_DF <= ci['high'] + 0.15
    assert result['n_samples'] == 2 * B_FRAMES
