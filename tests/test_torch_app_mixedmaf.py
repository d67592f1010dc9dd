"""The port's ``MixedMAFMap`` (``app/mixedmaf.py``) against the JAX
package's.

- The port's bond-graph helpers against networkx (installed here, not on
  the machine with the card), on chains, branched trees, rings, several
  fragments and random graphs: the same sets in the same orders.
- ``check_independent`` and ``is_collinear`` against JAX's.
- For each topology of ``tests/app/test_mixedmaf.py`` and for the 32-atom
  helix of ``bench.py``: the Z-matrix, the Cartesian atoms, the DOF groups,
  every buffer (index tables exactly, spline domains at ``ATOL``) and the
  transformer groups equal to the JAX map's. The helix's Z-matrix is also
  held to the literal that ``chip_smoke.py`` phase [10] checks.
- The JAX map carried into the port's (no leaf missing or extra), then 3
  ``Trainer`` steps on each side: batch order, logged work, losses,
  weights and ``run_evaluation``, as ``tests/test_torch_app_parity.py``
  does for the Cartesian map. Values at ``ATOL``, weights at
  ``GRAD_ATOL``, in float64 on the CPU.
"""

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import tfep_tpu.app as jax_app
import tfep_tpu.io.topology as jax_topology
import tfep_tpu.io.traj as jax_traj
import tfep_tpu.units as jax_units
from tfep_tpu.app.mixedmaf import (
    check_independent as jax_check_independent,
    is_collinear as jax_is_collinear,
)
from tfep_tpu_torch.app import MixedMAFMap, Trainer
from tfep_tpu_torch.app import mixedmaf as mm
from tfep_tpu_torch.convert import torch_name
from tfep_tpu_torch.io.topology import Topology
from tfep_tpu_torch.io.traj import System
from tfep_tpu_torch.units import ureg

import chip_smoke
from test_torch_common import (
    ATOL, CPU, DTYPE, GRAD_ATOL, carry, close, jax_state, perturb,
)

N_FRAMES, N_STEPS = 12, 3


# =============================================================================
# Graph helpers against networkx
# =============================================================================

def _random_graph(seed, n_nodes, n_edges):
    rng = np.random.default_rng(seed)
    pairs = [(a, b) for a in range(n_nodes) for b in range(a + 1, n_nodes)]
    chosen = rng.choice(len(pairs), size=n_edges, replace=False)
    return list(rng.permutation(n_nodes)), [pairs[i] for i in chosen]


def _tree(seed, n_nodes):
    rng = np.random.default_rng(seed)
    bonds = [(int(rng.integers(0, i)), i) for i in range(1, n_nodes)]
    return list(range(n_nodes)), [bonds[i] for i in
                                  rng.permutation(len(bonds))]


GRAPHS = {
    'chain': (list(range(8)), [(i, i + 1) for i in range(7)]),
    'chain-reversed-bonds': (list(range(8)),
                             [(i + 1, i) for i in range(6, -1, -1)]),
    'branched': (list(range(10)), [(0, 1), (1, 2), (2, 3), (1, 4), (4, 5),
                                   (4, 6), (2, 7), (7, 8), (7, 9)]),
    'tree': _tree(3, 14),
    'ring': (list(range(6)), [(i, (i + 1) % 6) for i in range(6)]),
    'fused-rings': (list(range(10)), [(i, (i + 1) % 6) for i in range(6)]
                    + [(5, 6), (6, 7), (7, 8), (8, 9), (9, 4)]),
    'fragments': ([3, 0, 7, 1, 2, 4, 5, 6, 8, 9, 10],
                  [(0, 1), (1, 2), (2, 3), (5, 6), (4, 5), (8, 9)]),
    # Atom indices of a solvated system: a small fragment of a large graph
    # takes the order of networkx's node set, not the graph's.
    'large-ids': ([4097, 12, 2051, 3000, 7, 1025, 999, 5000, 64, 65, 66,
                   67, 68, 69, 70, 71],
                  [(4097, 12), (12, 2051), (3000, 7), (7, 1025), (999, 5000),
                   (64, 65), (65, 66), (66, 67), (67, 68), (68, 69)]),
    'random-a': _random_graph(0, 12, 14),
    'random-b': _random_graph(1, 15, 22),
    'random-c': _random_graph(2, 20, 19),
}


def _nx_graph(nodes, bonds):
    graph = nx.Graph()
    graph.add_nodes_from(nodes)
    for a, b in bonds:
        graph.add_edge(a, b)
    return graph


def _adjacency(graph):
    return [(n, list(graph[n])) for n in graph]


@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_graph_helpers_give_networkx_orders(name):
    nodes, bonds = GRAPHS[name]
    ref = _nx_graph(nodes, bonds)
    adj = mm.bond_graph(nodes, bonds)
    assert _adjacency(adj) == [(n, list(v)) for n, v in _adjacency(ref)]
    components = list(mm.connected_components(adj))
    assert components == list(nx.connected_components(ref))
    for nodes_c in components:
        sub_ref = ref.subgraph(nodes_c).copy()
        sub = mm.subgraph(adj, nodes_c)
        assert [(n, list(v)) for n, v in sub.items()] == _adjacency(sub_ref)
        assert mm.center(sub) == nx.center(sub_ref)
        pairs = mm.all_pairs_shortest_path_length(sub, cutoff=3)
        pairs_ref = dict(nx.all_pairs_shortest_path_length(sub_ref,
                                                           cutoff=3))
        assert [(n, list(d.items())) for n, d in pairs.items()] == [
            (n, list(d.items())) for n, d in pairs_ref.items()]
        for source in sub:
            assert list(mm.single_source_shortest_path_length(
                sub, source).items()) == list(
                nx.single_source_shortest_path_length(sub_ref,
                                                      source).items())
            assert list(mm.bfs_edges(sub, source)) == list(
                nx.bfs_edges(sub_ref, source=source))


def test_center_of_a_disconnected_graph_raises():
    with pytest.raises(ValueError, match='not connected'):
        mm.center(mm.bond_graph([0, 1, 2], [(0, 1)]))


# =============================================================================
# Z-matrix checks
# =============================================================================

@pytest.mark.parametrize('z_matrix', [
    [[3, 0, 1, 2], [4, 3, 0, 1]],
    [[3, 0, 1, 2], [4, 0, 1, 2], [5, 0, 2, 1]],
    [[3, 0, 1, 2], [4, 0, 2, 1]],
])
def test_check_independent(z_matrix):
    try:
        jax_check_independent(z_matrix)
    except RuntimeError as error:
        with pytest.raises(RuntimeError, match='not independent') as port:
            mm.check_independent(z_matrix)
        assert str(port.value) == str(error)
    else:
        mm.check_independent(z_matrix)


@pytest.mark.parametrize('points', [
    [[[0, 0, 0], [1, 0, 0], [2, 0, 0.001]]],
    [[[0, 0, 0], [1, 0, 0], [1, 1, 0]]],
    [[[0, 0, 0], [1, 0, 0], [1, 1, 0]], [[0, 0, 0], [1, 0, 0], [3, 0, 0]]],
    [[[0, 0, 0], [1, 0, 0], [2.0, 0.14, 0]]],
])
@pytest.mark.parametrize('tol', [1e-2, 1e-3])
def test_is_collinear(points, tol):
    points = np.asarray(points, dtype=float)
    assert mm.is_collinear(points, tol) == jax_is_collinear(points, tol)


# =============================================================================
# The topologies of tests/app/test_mixedmaf.py and bench.py's helix
# =============================================================================

_CHAIN = np.array([
    [0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [2.25, 1.3, 0.0], [1.5, 2.2, 1.1],
    [-0.5, -0.7, 0.6], [1.9, -0.6, 0.8], [3.3, 1.4, 0.4], [1.0, 3.0, 0.4]])
_CHAIN_NAMES = ['C1', 'C2', 'C3', 'C4', 'H1', 'H2', 'H3', 'H4']
_CHAIN_BONDS = [(0, 1), (1, 2), (2, 3), (0, 4), (1, 5), (2, 6), (3, 7)]


def butane(with_water=False, near_water=False):
    """The C4H4 chain, optionally with a far water and a near water."""
    rng = np.random.default_rng(0)
    names, bonds, base = list(_CHAIN_NAMES), list(_CHAIN_BONDS), _CHAIN
    elements = [n[0] for n in names]
    resnames, resids = ['MOL'] * 8, [1] * 8
    if with_water:
        names += ['OW', 'HW1', 'HW2']
        elements += ['O', 'H', 'H']
        bonds += [(8, 9), (8, 10)]
        base = np.concatenate([base, [[8.0, 8.0, 8.0], [8.8, 8.3, 8.0],
                                      [7.5, 8.7, 8.2]]])
        resnames += ['SOL'] * 3
        resids += [2] * 3
    positions = base[None] + 0.05 * rng.normal(size=(N_FRAMES, len(names),
                                                     3))
    system = dict(names=names, elements=elements, resnames=resnames,
                  resids=resids, bonds=bonds, positions=positions)
    if near_water:
        near = np.array([[3.5, 3.0, 1.0], [4.3, 3.3, 1.0], [3.0, 3.7, 1.2]])
        system['names'] += ['OW', 'HW1', 'HW2']
        system['elements'] += ['O', 'H', 'H']
        system['resnames'] += ['SOL'] * 3
        system['resids'] += [3] * 3
        system['bonds'] += [(11, 12), (11, 13)]
        system['positions'] = np.concatenate([positions, near[None] + 0.05 *
                                              np.random.default_rng(1).normal(
                                                  size=(N_FRAMES, 3, 3))], 1)
        system['dimensions'] = np.tile([20.0, 20.0, 20.0, 90.0, 90.0, 90.0],
                                       (N_FRAMES, 1))
    return system


def two_fragments():
    rng = np.random.default_rng(3)
    names, elements, bonds, resids, base = [], [], [], [], []
    for frag in range(2):
        off = len(names)
        names += [f'{n}{frag}' for n in _CHAIN_NAMES]
        elements += [n[0] for n in _CHAIN_NAMES]
        bonds += [(a + off, b + off) for a, b in _CHAIN_BONDS]
        resids += [frag + 1] * 8
        base.append(_CHAIN + np.array([8.0, 6.0, 7.0]) * frag)
    base = np.concatenate(base)
    return dict(names=names, elements=elements, resnames=['MOL'] * 16,
                resids=resids, bonds=bonds, positions=base[None] + 0.05 *
                rng.normal(size=(N_FRAMES, 16, 3)))


def small_fragments():
    """A diatomic, an ion and the chain."""
    names = ['O1', 'O2', 'NA', 'C1', 'C2', 'C3', 'C4', 'H1', 'H2', 'H3',
             'H4']
    elements = ['O', 'O', 'Na', 'C', 'C', 'C', 'C', 'H', 'H', 'H', 'H']
    bonds = [(0, 1), (3, 4), (4, 5), (5, 6), (3, 7), (4, 8), (5, 9), (6, 10)]
    base = np.concatenate([[[5.0, 5.0, 5.0], [6.2, 5.0, 5.0],
                            [-3.0, -3.0, -3.0]], _CHAIN])
    return dict(names=names, elements=elements, bonds=bonds,
                positions=base[None] + 0.05 * np.random.default_rng(0)
                .normal(size=(N_FRAMES, 11, 3)))


def helix(n_frames=N_FRAMES):
    """bench.py's 32-atom carbon helix chain (bench_mixed_jax)."""
    positions = chip_smoke.helix_frames(n_frames, np.random.default_rng(0))
    n = chip_smoke.HELIX_ATOMS
    return dict(names=[f'C{i}' for i in range(n)], elements=['C'] * n,
                bonds=[(i, i + 1) for i in range(n - 1)],
                positions=positions)


TOPOLOGIES = {
    'butane': (butane, {}),
    'butane-degrees-repeats': (butane, dict(degrees_repeats=4)),
    'butane-water-conditioning': (
        lambda: butane(with_water=True),
        dict(mapped_atoms='resname MOL', conditioning_atoms='resname SOL')),
    'solvent-shell-selection': (
        lambda: butane(with_water=True, near_water=True),
        dict(mapped_atoms='resname MOL',
             conditioning_atoms='byres (resname SOL and around 4.0 '
                                'resname MOL)')),
    'two-fragments': (two_fragments, {}),
    'small-fragments': (small_fragments, {}),
    'helix': (helix, {}),
}


class _JaxPotential:
    energy_unit = jax_units.ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return jnp.sum(x, axis=-1)


class _PortPotential:
    energy_unit = ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return torch.sum(x, dim=-1)


def _systems(spec):
    spec = dict(spec)
    positions = spec.pop('positions')
    dimensions = spec.pop('dimensions', None)
    spec['bonds'] = np.asarray(spec['bonds'])
    return (jax_traj.System(jax_topology.Topology(**spec), positions,
                            dimensions=dimensions),
            System(Topology(**spec), positions, dimensions=dimensions))


def build_pair(path, name, n_maf_layers=2, n_bins=4, batch_size=6):
    make, kwargs = TOPOLOGIES[name]
    system_j, system_t = _systems(make())
    common = dict(batch_size=batch_size, n_maf_layers=n_maf_layers,
                  n_bins=n_bins, **kwargs)
    map_j = jax_app.MixedMAFMap(
        potential_energy_func=_JaxPotential(),
        temperature=300.0 * jax_units.ureg.kelvin, system=system_j,
        tfep_logger_dir_path=str(path / 'jax'), **common)
    map_t = MixedMAFMap(
        potential_energy_func=_PortPotential(),
        temperature=300.0 * ureg.kelvin, system=system_t,
        tfep_logger_dir_path=str(path / 'port'), device=CPU, dtype=DTYPE,
        **common)
    map_j.setup()
    map_t.setup()
    return map_j, map_t


def _conversion(tfep_map):
    flow = tfep_map.flow
    return flow if hasattr(flow, 'z_matrix') else flow.flow


@pytest.mark.parametrize('name', sorted(TOPOLOGIES))
def test_same_map_as_jax(tmp_path, name):
    map_j, map_t = build_pair(tmp_path, name, n_maf_layers=1)
    conv_j, conv_t = _conversion(map_j), _conversion(map_t)
    np.testing.assert_array_equal(conv_t.z_matrix, conv_j.z_matrix)
    np.testing.assert_array_equal(conv_t.cartesian_atom_indices,
                                  conv_j.cartesian_atom_indices)
    assert map_t._origin_atom_idx == map_j._origin_atom_idx
    np.testing.assert_array_equal(map_t._axes_atoms_indices,
                                  map_j._axes_atoms_indices)
    assert conv_t.n_dofs_out == conv_j.n_dofs_out
    cond = map_j.get_conditioning_indices(idx_type='atom', remove_fixed=True)
    groups_j = conv_j.get_dof_indices_by_type(cond)
    groups_t = conv_t.get_dof_indices_by_type(cond)
    for key, value in groups_j.items():
        if value is None:
            assert groups_t[key] is None
        else:
            np.testing.assert_array_equal(groups_t[key], value)
    mixed_j = conv_j.flow.flows[0].transformer
    mixed_t = conv_t.flow.flows[0].transformer
    assert mixed_t.indices == mixed_j.indices
    # Every buffer: index tables exactly, spline domains at ATOL.
    state = jax_state(map_j.flow)
    names = {torch_name(k): k for k in state}
    buffers = dict(map_t.flow.named_buffers())
    assert sorted(buffers) == sorted(n for n in names
                                     if n not in dict(
                                         map_t.flow.named_parameters()))
    for key, buf in buffers.items():
        if buf.is_floating_point():
            close(buf, state[names[key]])
        else:
            np.testing.assert_array_equal(buf, state[names[key]])
    if name == 'helix':
        np.testing.assert_array_equal(conv_j.z_matrix,
                                      chip_smoke.HELIX_Z_MATRIX)
        assert [len(i) for i in mixed_t.indices] == list(
            chip_smoke.HELIX_GROUPS)
        assert conv_t.placement_schedule.n_levels == chip_smoke.HELIX_LEVELS


# =============================================================================
# Training parity
# =============================================================================

@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The solvated map (fixed far water, conditioning near water), the
    JAX flow perturbed and carried, then 3 Trainer steps on each side."""
    path = tmp_path_factory.mktemp('mixedmaf')
    map_j, map_t = build_pair(path, 'solvent-shell-selection')
    map_j.flow = perturb(map_j.flow, seed=1, scale=0.05)
    carry(map_j.flow, map_t.flow)
    initial = {n: p.detach().clone() for n, p
               in map_t.flow.named_parameters()}
    trainer_j = jax_app.Trainer(save_dir=None, max_steps=N_STEPS,
                                shuffle=True, shuffle_seed=0)
    trainer_j.fit(map_j)
    trainer_t = Trainer(save_dir=None, max_steps=N_STEPS, shuffle=True,
                        shuffle_seed=0)
    trainer_t.fit(map_t)
    return dict(map_j=map_j, map_t=map_t, trainer_j=trainer_j,
                trainer_t=trainer_t, initial=initial)


@pytest.mark.parametrize('step', range(N_STEPS))
def test_batch_order_and_logged_values(runs, step):
    rows_j = runs['map_j'].tfep_logger.read_train_tensors(step_idx=step)
    rows_t = runs['map_t'].tfep_logger.read_train_tensors(step_idx=step)
    assert sorted(rows_t) == sorted(rows_j)
    for key in ('dataset_sample_index', 'trajectory_sample_index'):
        np.testing.assert_array_equal(rows_t[key], rows_j[key])
    close(rows_t['potential'], rows_j['potential'])
    close(rows_t['log_det_J'], rows_j['log_det_J'])


def test_losses_and_weights(runs):
    assert runs['trainer_t'].global_step == N_STEPS
    close(np.asarray(runs['trainer_t'].loss_history),
          np.asarray(runs['trainer_j'].loss_history))
    trained = {torch_name(k): v
               for k, v in jax_state(runs['map_j'].flow).items()}
    moved = False
    for name, param in runs['map_t'].flow.named_parameters():
        close(param, trained[name], GRAD_ATOL)
        moved |= not torch.equal(param, runs['initial'][name])
    assert moved


def test_run_evaluation_and_round_trip(runs):
    port = runs['map_t'].run_evaluation(N_STEPS)
    ref = runs['map_j'].run_evaluation(N_STEPS)
    np.testing.assert_array_equal(port['dataset_sample_index'],
                                  ref['dataset_sample_index'])
    close(port['potential'], ref['potential'], ATOL)
    close(port['log_det_J'], ref['log_det_J'], ATOL)
    tfep_map = runs['map_t']
    batch = tfep_map.batch_to_device(tfep_map.dataset.get_batch(
        np.arange(4)))
    with torch.no_grad():
        out = tfep_map.forward(batch)
        back = tfep_map.inverse({**batch, 'positions': out['positions']})
    close(back['positions'], batch['positions'], 1e-9)
    close(out['log_det_J'] + back['log_det_J'], 0.0, 1e-9)
    # Fixed and conditioning atoms stay in place.
    still = np.concatenate([tfep_map.get_fixed_indices(idx_type='dof'),
                            tfep_map.get_conditioning_indices(
                                idx_type='dof', remove_fixed=False)])
    close(out['positions'][:, still], batch['positions'][:, still], 1e-12)
