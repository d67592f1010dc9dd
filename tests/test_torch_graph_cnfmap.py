"""The port's graph primitives (``nn/graph.py``) and ``ContinuousEGNNMap``
against the JAX package's.

Mirrors the graph tests of ``tests/nn/test_graph_masked.py`` and
``tests/app/test_continuousegnn.py``, in float64 on the CPU:

- each graph helper against its JAX counterpart;
- the JAX map carried into the port's (no leaf missing or extra besides
  JAX's stored probe key), then 3 ``Trainer`` steps on each side with the
  exact trace: batch order, logged work, losses, weights and
  ``run_evaluation`` at ``ATOL`` (weights at ``GRAD_ATOL``);
- one Hutchinson step of the port's main path (``pairwise='pallas'``,
  translated to ``'fused'``, whose kernels' plain versions run on the CPU)
  fed JAX's own probe: loss, per-sample values and gradients against the
  JAX map's step;
- the probe invariants of the JAX tests (fresh per batch and per step,
  reproducible for a given batch and step, refreshed across epochs
  without shuffling), the rejection of reference-frame atoms, the
  translation of ``pairwise`` and a self-contained checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.app as jax_app
import tfep_tpu.io.topology as jax_topology
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.nn.graph as jax_graph
import tfep_tpu.units as jax_units
from tfep_tpu.nn.module import filter_value_and_grad
from tfep_tpu_torch.app import (
    ContinuousEGNNMap, Trainer, load_map_from_checkpoint,
)
from tfep_tpu_torch.convert import load_jax_state, torch_name
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.nn import graph
from tfep_tpu_torch.ops import egnn as E
from tfep_tpu_torch.units import ureg

from test_torch_common import (
    CPU, DTYPE, GRAD_ATOL, close, jax_state, perturb, t,
)

N_FRAMES, N_ATOMS, BATCH, N_STEPS = 10, 6, 5, 3
ELEMENTS = ['C', 'O', 'C', 'H', 'H', 'C']


# =============================================================================
# Graph primitives
# =============================================================================

@pytest.mark.parametrize('n_nodes', [2, 3, 5])
def test_get_all_edges(n_nodes):
    edges = graph.get_all_edges(n_nodes)
    np.testing.assert_array_equal(edges, jax_graph.get_all_edges(n_nodes))
    assert edges.shape == (2, n_nodes * (n_nodes - 1))


@pytest.mark.parametrize('batch_size', [1, 3])
def test_fix_node_indices_batch_size(batch_size):
    edges = graph.get_all_edges(4)
    np.testing.assert_array_equal(
        graph.fix_node_indices_batch_size(edges, batch_size, 4),
        jax_graph.fix_node_indices_batch_size(edges, batch_size, 4))


@pytest.mark.parametrize('normalize', [True, False])
def test_compute_edge_distances_and_pruning(normalize):
    x = np.random.default_rng(0).normal(size=(5, 3))
    x[3] = x[1]   # a zero-length edge: its direction stays finite
    edges = graph.get_all_edges(5)
    expected = jax_graph.compute_edge_distances(
        jnp.asarray(x), edges, normalize_directions=normalize)
    out = graph.compute_edge_distances(t(x), edges,
                                       normalize_directions=normalize)
    for a, b in zip(out, expected):
        close(a, b)
    mask, edges_out, distances, _ = graph.prune_long_edges(1.0, edges, *out)
    mask_j = jax_graph.prune_long_edges(1.0, edges, *expected)[0]
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    assert edges_out is edges and distances is out[0]


def test_unsorted_segment_sum():
    data = np.random.default_rng(1).normal(size=(6, 2))
    seg = np.array([0, 2, 0, 2, 3, 0])
    close(graph.unsorted_segment_sum(t(data), torch.as_tensor(seg), 4),
          jax_graph.unsorted_segment_sum(jnp.asarray(data),
                                         jnp.asarray(seg), 4))


def test_fixed_graph():
    node_types = [0, 1, 1, 2]
    features = graph.FixedGraph.build_node_features(node_types)
    np.testing.assert_array_equal(
        features, jax_graph.FixedGraph.build_node_features(node_types))
    edges = graph.get_all_edges(4)
    port = graph.FixedGraph(features, edges, n_nodes=4, device=CPU)
    ref = jax_graph.FixedGraph(node_types_one_hot=jnp.asarray(features),
                               edges_template=jnp.asarray(edges), n_nodes=4)
    np.testing.assert_array_equal(port.get_edges(3).numpy(),
                                  np.asarray(ref.get_edges(3)))
    assert sorted(name for name, _ in port.named_buffers()) == [
        'edges_template', 'node_types_one_hot']


# =============================================================================
# ContinuousEGNNMap
# =============================================================================

class _JaxPotential:
    energy_unit = jax_units.ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return jnp.sum(x, axis=-1)


class _PortPotential:
    energy_unit = ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return torch.sum(x, dim=-1)


def _frames():
    return np.random.default_rng(0).normal(size=(N_FRAMES, N_ATOMS, 3))


def _topology_kwargs():
    return dict(names=[f'C{i}' for i in range(N_ATOMS)], elements=ELEMENTS)


def _kwargs(path, **kwargs):
    kwargs.setdefault('n_egnn_layers', 2)
    kwargs.setdefault('node_feat_dim', 8)
    kwargs.setdefault('distance_feat_dim', 4)
    kwargs.setdefault('time_feat_dim', 4)
    kwargs.setdefault('n_steps', 4)
    return dict(batch_size=BATCH, tfep_logger_dir_path=str(path), **kwargs)


def jax_map(path, **kwargs):
    system = jax_traj.System(jax_topology.Topology(**_topology_kwargs()),
                             _frames())
    return jax_app.ContinuousEGNNMap(
        potential_energy_func=_JaxPotential(),
        temperature=300.0 * jax_units.ureg.kelvin, system=system,
        **_kwargs(path, **kwargs))


def port_map(path, **kwargs):
    return ContinuousEGNNMap(
        potential_energy_func=_PortPotential(),
        temperature=300.0 * ureg.kelvin,
        system=System(Topology(**_topology_kwargs()), _frames()),
        device=CPU, dtype=DTYPE, **_kwargs(path, **kwargs))


def carried_pair(path, seed=1, jax_kwargs=None, **kwargs):
    """Both maps set up, the JAX flow perturbed and carried into the
    port's (all of its leaves but the stored probe key)."""
    map_j = jax_map(path / 'jax', **{**kwargs, **(jax_kwargs or {})})
    map_j.setup()
    map_j.flow = perturb(map_j.flow, seed=seed, scale=0.05)
    map_t = port_map(path / 'port', **kwargs)
    map_t.setup()
    load_jax_state(map_t.flow, {
        k: v for k, v in jax_state(map_j.flow).items()
        if not k.endswith('.hutchinson_key')})
    return map_j, map_t


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """3 Trainer steps on each side with the exact trace; atoms 0-2
    mapped, 3 conditioning (velocity masking), 4-5 fixed (PartialFlow)."""
    path = tmp_path_factory.mktemp('cnfmap')
    # The exact trace takes one jvp per DOF: midpoint with 2 steps (4
    # evaluations of the field) and no recompute keep the eager port's
    # steps short.
    map_j, map_t = carried_pair(
        path, trace_estimator='exact', solver='midpoint', n_steps=2,
        mapped_atoms=[0, 1, 2], conditioning_atoms=[3],
        cnf_kwargs={'checkpoint': False})
    initial = {n: p.detach().clone()
               for n, p in map_t.flow.named_parameters()}
    trainer_j = jax_app.Trainer(save_dir=None, max_steps=N_STEPS,
                                shuffle=True, shuffle_seed=0)
    trainer_j.fit(map_j)
    trainer_t = Trainer(save_dir=None, max_steps=N_STEPS, shuffle=True,
                        shuffle_seed=0)
    trainer_t.fit(map_t)
    return dict(map_j=map_j, map_t=map_t, trainer_j=trainer_j,
                trainer_t=trainer_t, initial=initial)


@pytest.mark.parametrize('step', range(N_STEPS))
def test_trainer_batch_order_and_logged_values(runs, step):
    rows_j = runs['map_j'].tfep_logger.read_train_tensors(step_idx=step)
    rows_t = runs['map_t'].tfep_logger.read_train_tensors(step_idx=step)
    assert sorted(rows_t) == sorted(rows_j)
    np.testing.assert_array_equal(rows_t['dataset_sample_index'],
                                  rows_j['dataset_sample_index'])
    close(rows_t['potential'], rows_j['potential'])
    close(rows_t['log_det_J'], rows_j['log_det_J'])


def test_trainer_losses_weights_and_evaluation(runs):
    close(np.asarray(runs['trainer_t'].loss_history),
          np.asarray(runs['trainer_j'].loss_history))
    trained = {torch_name(k): v for k, v in jax_state(runs['map_j'].flow)
               .items()}
    moved = False
    for name, param in runs['map_t'].flow.named_parameters():
        close(param, trained[name], GRAD_ATOL)
        moved |= not torch.equal(param, runs['initial'][name])
    assert moved
    port = runs['map_t'].run_evaluation(N_STEPS)
    ref = runs['map_j'].run_evaluation(N_STEPS)
    np.testing.assert_array_equal(port['dataset_sample_index'],
                                  ref['dataset_sample_index'])
    close(port['potential'], ref['potential'])
    close(port['log_det_J'], ref['log_det_J'])
    # Conditioning (3) and fixed (4, 5) atoms stay in place.
    batch = runs['map_t'].dataset.get_batch(np.arange(3))
    with torch.no_grad():
        y = runs['map_t'].forward(batch)['positions'].numpy()
    close(y[:, 9:], batch['positions'][:, 9:], 1e-12)
    assert np.abs(y[:, :9] - batch['positions'][:, :9]).max() > 1e-6


def _jax_probe(tfep_map, batch, x):
    """The probe the JAX map draws for a batch (its ``_run_flow``)."""
    idx = jnp.asarray(batch['dataset_sample_index']).astype(jnp.uint32)
    weights = 2 * jnp.arange(idx.shape[0], dtype=jnp.uint32) + 1
    key = jax.random.fold_in(jax.random.key(tfep_map.seed + 1),
                             jnp.sum(idx * weights))
    key = jax.random.fold_in(key, batch['global_step'])
    return np.asarray(jax.random.normal(key, (1, *x.shape), dtype=x.dtype))


def test_hutchinson_step_with_jax_probe(tmp_path, monkeypatch):
    """One training step of the main path (Hutchinson, fused pairwise
    block) against the JAX map's, on JAX's probe for the batch."""
    map_j, map_t = carried_pair(
        tmp_path, seed=2, egnn_kwargs={'pairwise': 'pallas'},
        jax_kwargs={'egnn_kwargs': {'pairwise': 'xla'}})
    assert all(layer.pairwise == 'fused'
               for layer in map_t.flow.dynamics.graph_layers)
    batch = map_t.dataset.get_batch(np.arange(BATCH))
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_j['global_step'] = jnp.asarray(7, dtype=jnp.uint32)
    eps = _jax_probe(map_j, batch_j, batch['positions'])

    def loss_j(flow):
        return map_j.training_step_fn(flow, batch_j)

    (loss_ref, aux_ref), grads = jax.jit(filter_value_and_grad(
        loss_j, has_aux=True))(map_j.flow)

    monkeypatch.setattr(map_t.flow, 'probes',
                        lambda x, generator=None: t(eps))
    batch_t = map_t.batch_to_device(batch)
    batch_t['global_step'] = 7
    E.LAUNCHES.reset()
    loss, aux = map_t.training_step_fn(map_t.flow, batch_t)
    loss.backward()
    assert (E.LAUNCHES.k3, E.LAUNCHES.k4, E.LAUNCHES.k5) == (0, 0, 0)
    close(loss, loss_ref)
    for key in ('potential', 'log_det_J'):
        close(aux[key], aux_ref[key])
    expected = {torch_name(k): v for k, v in jax_state(grads).items()}
    for name, param in map_t.flow.named_parameters():
        grad = (torch.zeros_like(param) if param.grad is None
                else param.grad)
        close(grad, expected[name], GRAD_ATOL)


@pytest.fixture(scope='module')
def nudged(tmp_path_factory):
    """A port map whose field is off the identity (the trace of the
    identity field is zero whatever the probe)."""
    tfep_map = port_map(tmp_path_factory.mktemp('probes'), solver='midpoint',
                        n_steps=2)
    tfep_map.setup()
    generator = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in tfep_map.flow.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=generator,
                                      dtype=p.dtype))
    return tfep_map


def _ldj(tfep_map, batch):
    with torch.no_grad():
        return tfep_map.forward(dict(batch))['log_det_J']


def test_probes_vary_per_batch_and_step(nudged):
    batch = nudged.host_tensors(nudged.dataset.get_batch([0, 1, 2]))
    ldj = _ldj(nudged, batch)
    other = {**batch,
             'dataset_sample_index': batch['dataset_sample_index'] + 3}
    assert float((ldj - _ldj(nudged, other)).abs().max()) > 1e-10
    assert torch.equal(ldj, _ldj(nudged, batch))
    step0, step7 = {**batch, 'global_step': 0}, {**batch, 'global_step': 7}
    ldj0 = _ldj(nudged, step0)
    assert float((ldj0 - _ldj(nudged, step7)).abs().max()) > 1e-10
    assert torch.equal(ldj0, _ldj(nudged, step0))
    # numpy indices (a batch as the dataset gives it) draw the same.
    numpy_batch = {**nudged.dataset.get_batch([0, 1, 2]), 'global_step': 0}
    assert torch.equal(ldj0, _ldj(nudged, numpy_batch))


def test_probes_refresh_across_epochs_without_shuffle(nudged, tmp_path):
    nudged.trainer = None
    nudged._tfep_logger_dir_path = str(tmp_path / 'logs')
    nudged._tfep_logger = None
    trainer = Trainer(save_dir=None, max_epochs=2, shuffle=False,
                      optimizer=lambda p: torch.optim.SGD(p, lr=0.0))
    trainer.fit(nudged)
    e0 = nudged.tfep_logger.read_train_tensors(epoch_idx=0)
    e1 = nudged.tfep_logger.read_train_tensors(epoch_idx=1)
    np.testing.assert_array_equal(e0['dataset_sample_index'],
                                  e1['dataset_sample_index'])
    assert np.abs(e0['log_det_J'] - e1['log_det_J']).max() > 1e-10


def test_reference_frame_atoms_rejected(tmp_path):
    tfep_map = port_map(tmp_path, mapped_atoms=[0, 1, 2, 4, 5],
                        conditioning_atoms=[3], origin_atom=3)
    with pytest.raises(ValueError, match='equivariant'):
        tfep_map.setup()


@pytest.mark.parametrize('given,built', [
    ('xla', 'dense'), ('pallas', 'fused'), ('dense', 'dense'),
    ('fused', 'fused')])
def test_pairwise_names_translate(tmp_path, given, built):
    """The JAX package's names build the port's paths; the port's own
    names pass as they are; the hyperparameters keep what was given."""
    tfep_map = port_map(tmp_path, egnn_kwargs={'pairwise': given})
    tfep_map.setup()
    assert [layer.pairwise for layer in
            tfep_map.flow.dynamics.graph_layers] == [built, built]
    assert tfep_map.hparams['egnn_kwargs'] == {'pairwise': given}


def test_unknown_pairwise_raises(tmp_path):
    with pytest.raises(ValueError, match="'xla' or 'pallas'"):
        port_map(tmp_path, egnn_kwargs={'pairwise': 'triton'})


def test_self_contained_checkpoint(tmp_path):
    tfep_map = port_map(tmp_path, conditioning_atoms=[5],
                        egnn_kwargs={'pairwise': 'pallas'})
    Trainer(save_dir=str(tmp_path / 'ckpt'), max_epochs=1,
            shuffle=False).fit(tfep_map)
    restored = load_map_from_checkpoint(
        str(tmp_path / 'ckpt' / 'last.ckpt'),
        expected_class=ContinuousEGNNMap)
    batch = tfep_map.dataset.get_batch([0, 1])
    with torch.no_grad():
        close(restored.forward(batch)['positions'],
              tfep_map.forward(batch)['positions'], 0.0)
