"""Mixed internal/Cartesian MAF map, the flagship TFEP map.

Port of ``tfep_tpu/app/mixedmaf.py``. It builds a Z-matrix per connected
fragment from the bond graph (breadth-first, with a priority heuristic:
closeness to the atom, closeness to its bond atom, recency in the
Z-matrix, heavy atoms before hydrogens), checks Z-matrix independence and
non-collinearity over a pass of the dataset, takes per-DOF minima and
maxima over subsampled frames for the spline domains, and wires a
:class:`~tfep_tpu_torch.nn.transformers.MixedTransformer` (splines for
distances, angles, torsions and Cartesians; kept-constant reference DOFs
pass through as conditioning) with a periodic embedding of the torsions
inside MAF layers, wrapped by the Cartesian <-> mixed conversion.

The model's shape depends on the data (the bonds, the observed ranges), so
it is resolved on the host when the map is set up. The JAX package walks
the bond graph with ``networkx``; the port has its own small graph helpers
(:func:`connected_components`, :func:`center`,
:func:`all_pairs_shortest_path_length`,
:func:`single_source_shortest_path_length`, :func:`bfs_edges`) that follow
networkx's algorithms and give its orders, not only its sets: the
breadth-first edge order fixes the Z-matrix rows. A graph is an adjacency
dict ``{node: {neighbor: None}}``: nodes in insertion order, each node's
neighbors in the order its bonds were added.
"""

from __future__ import annotations

import copy
import logging
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from tfep_tpu_torch.app.base import TFEPMapBase
from tfep_tpu_torch.nn.conditioners.made import generate_degrees
from tfep_tpu_torch.nn.embeddings import PeriodicEmbedding
from tfep_tpu_torch.nn.flows import (
    MAF, CartesianToMixedFlow, SequentialFlow,
)
from tfep_tpu_torch.nn.transformers import (
    MixedTransformer, NeuralSplineTransformer,
)
from tfep_tpu_torch.utils.misc import (
    atom_to_flattened_indices, remove_and_shift_sorted_indices,
)

__all__ = ['MixedMAFMap', 'check_independent', 'is_collinear',
           'bond_graph', 'subgraph', 'connected_components', 'center',
           'single_source_shortest_path_length',
           'all_pairs_shortest_path_length', 'bfs_edges']

logger = logging.getLogger(__name__)


# =============================================================================
# Bond graphs, with networkx's orders
# =============================================================================

def bond_graph(nodes: Sequence[int], bonds) -> Dict[int, Dict[int, None]]:
    """The graph of ``nodes`` with the ``bonds`` between two of them, as
    ``networkx.Graph`` builds it with ``add_nodes_from(nodes)`` and one
    ``add_edge`` per bond in order."""
    adj = {int(n): {} for n in nodes}
    for a, b in bonds:
        a, b = int(a), int(b)
        if a in adj and b in adj:
            adj[a][b] = None
            adj[b][a] = None
    return adj


def subgraph(adj, nodes) -> Dict[int, Dict[int, None]]:
    """``G.subgraph(nodes).copy()``, in networkx's orders.

    networkx filters the graph through the set of ``nodes``; where that
    set has fewer than half the graph's nodes it iterates the set itself,
    so the copy takes the set's iteration order, else the graph's. The
    edges are added for each node in that order, its neighbors in the
    graph's order, which can reorder a node's neighbors.
    """
    node_ok = set(n for n in nodes if n in adj)

    def shown(atlas):
        if 2 * len(node_ok) < len(atlas):
            return [n for n in node_ok if n in atlas]
        return [n for n in atlas if n in node_ok]

    sub = {n: {} for n in shown(adj)}
    for u in sub:
        for v in shown(adj[u]):
            sub[u][v] = None
            sub[v][u] = None
    return sub


def connected_components(adj) -> Iterator[set]:
    """The node sets of the connected components, in the order of their
    first node; each set is built in breadth-first order, as networkx
    builds it (its iteration order can matter to :func:`subgraph`)."""
    seen = set()
    for source in adj:
        if source not in seen:
            component = _plain_bfs(adj, len(adj) - len(seen), source)
            seen.update(component)
            yield component


def _plain_bfs(adj, n, source) -> set:
    seen = {source}
    next_level = [source]
    while next_level:
        this_level, next_level = next_level, []
        for v in this_level:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    next_level.append(w)
            if len(seen) == n:
                return seen
    return seen


def single_source_shortest_path_length(adj, source, cutoff=None) -> dict:
    """``{node: hops from source}`` in breadth-first order, up to
    ``cutoff`` hops."""
    if cutoff is None:
        cutoff = float('inf')
    seen = {source}
    lengths = {source: 0}
    next_level = [source]
    level = 0
    while next_level and cutoff > level:
        level += 1
        this_level, next_level = next_level, []
        for v in this_level:
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    next_level.append(w)
                    lengths[w] = level
            if len(seen) == len(adj):
                return lengths
    return lengths


def all_pairs_shortest_path_length(adj, cutoff=None) -> dict:
    """``{node: single_source_shortest_path_length(node)}`` in node
    order."""
    return {n: single_source_shortest_path_length(adj, n, cutoff)
            for n in adj}


def center(adj) -> list:
    """The nodes of least eccentricity, in node order (the graph must be
    connected)."""
    eccentricity = {}
    for n in adj:
        lengths = single_source_shortest_path_length(adj, n)
        if len(lengths) != len(adj):
            raise ValueError('The graph is not connected.')
        eccentricity[n] = max(lengths.values())
    radius = min(eccentricity.values())
    return [n for n, e in eccentricity.items() if e == radius]


def bfs_edges(adj, source) -> Iterator[tuple]:
    """The (parent, child) edges of a breadth-first search from
    ``source``, children in their parent's neighbor order."""
    seen = {source}
    next_parents = [source]
    while next_parents:
        this_parents, next_parents = next_parents, []
        for parent in this_parents:
            for child in adj[parent]:
                if child not in seen:
                    seen.add(child)
                    next_parents.append(child)
                    yield parent, child
            if len(seen) == len(adj):
                return


# =============================================================================
# Z-matrix checks
# =============================================================================

def check_independent(z_matrix):
    """Raise if two Z-matrix rows share the same bond atom and reference
    set: dependent rows make the coordinate map non-invertible."""
    dependent_rows = []
    all234 = [(row[1], frozenset(row[2:])) for row in z_matrix]
    for i, other in enumerate(all234):
        if other in all234[:i]:
            dependent_rows.append(i)
    if len(dependent_rows) > 1:
        err_msg = 'The following Z-matrix rows are not independent:\n'
        for i in dependent_rows:
            err_msg += f'\tRow {i}: {list(z_matrix[i])}\n'
        raise RuntimeError(err_msg)


def is_collinear(points, tol: float = 1e-2) -> bool:
    """True if any sample's three points are (nearly) collinear.

    ``points``: (batch, 3, 3), numpy.
    """
    points = np.asarray(points)
    p0, p1, p2 = points[:, 0], points[:, 1], points[:, 2]
    v01 = p1 - p0
    v12 = p2 - p1
    v01 = v01 / np.linalg.norm(v01, axis=-1, keepdims=True)
    v12 = v12 / np.linalg.norm(v12, axis=-1, keepdims=True)
    cos = np.abs(np.sum(v01 * v12, axis=-1))
    return bool(np.any(np.isclose(cos, 1.0, atol=tol, rtol=0.0)))


# =============================================================================
# The map
# =============================================================================

class MixedMAFMap(TFEPMapBase):
    """TFEP map on mixed internal/Cartesian coordinates (the flagship map).

    Molecular fragments with at least 4 bonded atoms are represented in
    internal coordinates (bonds, angles, torsions from an automatically
    built Z-matrix); smaller fragments and conditioning atoms stay
    Cartesian. Every internal coordinate goes through a rational-quadratic
    spline whose domain comes from the dataset's observed ranges; torsions
    take circular splines and a periodic (cos, sin) conditioner embedding.
    The conversion carries the exact log-det, so the work values are exact
    in Cartesian space.

    Accepts every :class:`~tfep_tpu_torch.app.TFEPMapBase` argument plus
    the ones below.

    Parameters
    ----------
    n_maf_layers : int
        Number of MAF layers (alternating ascending/descending degrees).
    distance_lower_limit_displacement : float
        Widens each bond's spline domain below its observed minimum (in
        the positions' unit), leaving room to contract bonds.
    remove_translation, remove_rotation : bool
        Drop the reference atoms' roto-translational DOFs even when those
        atoms are mapped.
    n_bins : int
        Spline bins per internal coordinate.
    flow_kwargs : dict, optional
        Extra keyword arguments for :meth:`tfep_tpu_torch.nn.flows.MAF.
        create`.
    remat : bool
        Recompute each MAF layer in the backward pass.
    degrees_repeats : int, optional
        Consecutive DOFs per autoregressive degree (default 1).
    """

    def __init__(self, *args, n_maf_layers: int = 6,
                 distance_lower_limit_displacement: float = 0.3,
                 remove_translation: bool = False,
                 remove_rotation: bool = False,
                 n_bins: int = 5,
                 flow_kwargs: Optional[Dict] = None,
                 remat: bool = False, degrees_repeats: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_maf_layers = int(n_maf_layers)
        self.distance_lower_limit_displacement = float(
            distance_lower_limit_displacement)
        self.remove_translation = bool(remove_translation)
        self.remove_rotation = bool(remove_rotation)
        self.n_bins = int(n_bins)
        self.flow_kwargs = dict(flow_kwargs or {})
        self.remat = bool(remat)
        self.degrees_repeats = int(degrees_repeats)
        self.hparams.update(
            n_maf_layers=self.n_maf_layers,
            distance_lower_limit_displacement=(
                self.distance_lower_limit_displacement),
            remove_translation=self.remove_translation,
            remove_rotation=self.remove_rotation,
            n_bins=self.n_bins, flow_kwargs=self.flow_kwargs,
            remat=self.remat, degrees_repeats=self.degrees_repeats)

    # ------------------------------------------------------------------ #
    def configure_flow(self):
        """The conversion flow around the spline MAF stack: Z-matrix from
        the bond graph, one dataset pass for the spline domains and the
        collinearity checks, then the layers."""
        cartesian_atom_indices, z_matrix = self._build_z_matrix()
        if len(z_matrix) == 0:
            raise ValueError('There are no internal coordinates to map. '
                             'Consider using a Cartesian flow.')

        reference_atom_indices = self.get_reference_atoms_indices(
            remove_fixed=True)
        conditioning_atom_indices = self.get_conditioning_indices(
            idx_type='atom', remove_fixed=True)
        if conditioning_atom_indices is None:
            is_ref_conditioning = [False, False, False]
        else:
            is_ref_conditioning = np.isin(
                reference_atom_indices, conditioning_atom_indices).tolist()

        conversion = CartesianToMixedFlow.create(
            flow=None,
            cartesian_atom_indices=cartesian_atom_indices,
            z_matrix=z_matrix,
            reference_atom_indices=reference_atom_indices,
            remove_ref_rototranslation=[
                self.remove_translation or is_ref_conditioning[0],
                self.remove_rotation or is_ref_conditioning[1],
                self.remove_rotation or is_ref_conditioning[2],
            ], device=self.device)

        min_dof_vals, max_dof_vals = self._analyze_dataset(z_matrix,
                                                           conversion)
        maf_dof_indices = conversion.get_dof_indices_by_type(
            conditioning_atom_indices)

        transformer = self._get_transformer(
            conversion, min_dof_vals, max_dof_vals, maf_dof_indices)
        degrees_in = self._get_maf_degrees_in(
            n_dofs_in=conversion.n_dofs_out,
            maf_dof_indices=maf_dof_indices)

        generator = torch.Generator().manual_seed(self.seed)
        like = dict(device=self.device, dtype=self.dtype)
        maf_layers = []
        for layer_idx in range(self.n_maf_layers):
            maf_layers.append(MAF.create(
                generator, degrees_in=degrees_in[layer_idx % 2],
                # Each layer its own copy: a shared module would appear in
                # the state once, under the first layer only.
                transformer=copy.deepcopy(transformer),
                embedding=PeriodicEmbedding(
                    n_features_in=conversion.n_dofs_out,
                    # Angles are normalized to [0, 1] by the conversion.
                    limits=[0.0, 1.0],
                    periodic_indices=maf_dof_indices['torsions'], **like),
                **like, **self.flow_kwargs))
        conversion.flow = SequentialFlow.create(*maf_layers, remat=self.remat,
                                                device=self.device)
        return conversion

    # ------------------------------------------------------------------ #
    # Z-matrix construction (host side).
    # ------------------------------------------------------------------ #
    def _build_z_matrix(self):
        """Z-matrix + Cartesian atoms; picks the reference atoms if unset."""
        mapped_w_fixed = self.get_mapped_indices(idx_type='atom',
                                                 remove_fixed=False)
        conditioning_w_fixed = self.get_conditioning_indices(
            idx_type='atom', remove_fixed=False)
        if conditioning_w_fixed is None:
            nonfixed_w_fixed = np.asarray(mapped_w_fixed)
        else:
            nonfixed_w_fixed = np.sort(np.concatenate(
                [mapped_w_fixed, conditioning_w_fixed]))

        graph = bond_graph(nonfixed_w_fixed.tolist(),
                           self._system.topology.bonds.tolist())

        ref_atom_indices = self.get_reference_atoms_indices(
            remove_fixed=False)
        ref_atom_indices = ([] if ref_atom_indices is None
                            else list(np.asarray(ref_atom_indices).tolist()))
        if not set(ref_atom_indices).issubset(set(nonfixed_w_fixed.tolist())):
            raise ValueError(
                'The origin and axes atoms must be mapped or conditioning.')

        mapped_set = set(np.asarray(mapped_w_fixed).tolist())

        frags_z_matrices = [
            self._build_connected_graph_z_matrix(subgraph(graph, nodes),
                                                 ref_atom_indices)
            for nodes in connected_components(graph)]

        # Auto-select the reference frame from the largest fragment.
        largest = frags_z_matrices[int(np.argmax(
            [len(z) for z in frags_z_matrices]))]
        if self._origin_atom_idx is None:
            self._origin_atom_idx = int(largest[0][0])
        if self._axes_atoms_indices is None:
            self._axes_atoms_indices = np.asarray(
                [largest[1][0], largest[2][0]], dtype=np.int64)

        cartesian_atom_indices = []
        ic_z_matrix = []
        for z_matrix in frags_z_matrices:
            # The first three atoms of each fragment are Cartesian.
            cartesian_atom_indices.extend(row[0] for row in z_matrix[:3])
            is_mapped = False
            for row in z_matrix[3:]:
                if row[0] in mapped_set:
                    ic_z_matrix.append(row)
                    is_mapped = True
                else:
                    # Conditioning atoms stay Cartesian.
                    cartesian_atom_indices.append(row[0])
            if is_mapped:
                check_independent(z_matrix)

        # From with-fixed to fixed-removed indexing.
        indices_map = {atom: i for i, atom
                       in enumerate(nonfixed_w_fixed.tolist())}
        logger.info('Determined Z-Matrix:\n%s', np.asarray(ic_z_matrix))

        cartesian_atom_indices = sorted(
            indices_map[i] for i in cartesian_atom_indices)
        ic_z_matrix = [[indices_map[i] for i in row] for row in ic_z_matrix]
        return (np.asarray(cartesian_atom_indices, dtype=np.int64),
                np.asarray(ic_z_matrix, dtype=np.int64).reshape(-1, 4))

    def _is_hydrogen(self, atom_idx: int) -> bool:
        element = str(self._system.topology.elements[atom_idx]).upper()
        if element == '':
            raise ValueError(
                'The topology has no information on the atom elements, '
                'which is required to infer a robust Z-matrix.')
        return element == 'H'

    def _build_connected_graph_z_matrix(self, graph,
                                        ref_atom_indices: Sequence[int]):
        """Breadth-first Z-matrix of one connected fragment."""
        ref_atoms_in_graph = [i for i in ref_atom_indices if i in graph]
        if len(ref_atoms_in_graph) == 0:
            ref_atoms_in_graph = [center(graph)[0]]

        n_ref = len(ref_atoms_in_graph)
        z_matrix = [[-1] * 4 for _ in range(n_ref)]
        for row_idx in range(n_ref):
            z_matrix[row_idx][:row_idx + 1] = list(
                reversed(ref_atoms_in_graph[:row_idx + 1]))

        atoms_order = {atom: row for row, atom
                       in enumerate(ref_atoms_in_graph)}

        graph_distances = all_pairs_shortest_path_length(graph, cutoff=3)
        # Axes atoms might be far from the search's source: add their
        # distances.
        for axes_atom in ref_atoms_in_graph[1:]:
            dists = single_source_shortest_path_length(graph, axes_atom)
            for target, dist in dists.items():
                graph_distances[axes_atom][target] = dist
                graph_distances[target][axes_atom] = dist

        for _, added_atom in bfs_edges(graph, source=ref_atoms_in_graph[0]):
            if added_atom in ref_atoms_in_graph[1:]:
                continue

            row = [added_atom]
            is_h = self._is_hydrogen(added_atom)
            priorities = self._get_atom_zmatrix_priorities(
                added_atom, graph_distances, atoms_order, is_h)
            row.append(priorities[0][0])

            bond_atom = row[-1]
            priorities = self._get_atom_zmatrix_priorities(
                added_atom, graph_distances, atoms_order, is_h, bond_atom)
            row.extend(p[0] for p in priorities[:2])

            if len(row) < 4:
                # Only possible while the fragment's first rows are filling.
                assert len(z_matrix) < 4
                row = row + [-1] * (4 - len(row))

            z_matrix.append(row)
            atoms_order[added_atom] = len(atoms_order)

        return z_matrix

    def _get_atom_zmatrix_priorities(self, atom, graph_distances,
                                     atoms_order, is_h, bond_atom=None):
        """Sorted priority rows: closest to the atom, closest to the bond
        atom, most recent in the Z-matrix, heavy atoms first."""
        priorities = []
        for prev_atom, dist in graph_distances[atom].items():
            if prev_atom not in atoms_order or prev_atom == atom:
                continue
            if bond_atom is None:
                bond_atom_dist = 0
            elif prev_atom == bond_atom:
                continue
            elif prev_atom not in graph_distances[bond_atom]:
                continue
            else:
                bond_atom_dist = graph_distances[bond_atom][prev_atom]
            priorities.append([
                prev_atom, dist, bond_atom_dist, -atoms_order[prev_atom],
                float(not is_h and self._is_hydrogen(prev_atom)),
            ])
        priorities.sort(key=lambda k: tuple(k[1:]))
        return priorities

    # ------------------------------------------------------------------ #
    # Dataset analysis.
    # ------------------------------------------------------------------ #
    def _analyze_dataset(self, z_matrix, conversion):
        """Collinearity checks (host) and per-DOF min/max (device) over at
        most 5 x 1024 frames."""
        ref_atoms = self.get_reference_atoms_indices(remove_fixed=True)
        nonfixed_dofs = atom_to_flattened_indices(
            self.get_nonfixed_indices(idx_type='atom', remove_fixed=False))

        batch_size = 1024
        max_n_samples = 5 * batch_size
        n = len(self.dataset)
        if n > max_n_samples:
            step = int(np.ceil(n / max_n_samples))
            sample_indices = np.arange(0, n, step)
        else:
            sample_indices = np.arange(n)

        min_dofs = None
        max_dofs = None
        for start in range(0, len(sample_indices), batch_size):
            batch_idx = sample_indices[start:start + batch_size]
            positions = np.asarray(
                self.dataset.get_batch(batch_idx)['positions'])
            positions = positions[:, nonfixed_dofs]

            atoms = positions.reshape(positions.shape[0], -1, 3)
            for row_idx, row in enumerate(np.asarray(z_matrix)):
                if (is_collinear(atoms[:, row[:3]])
                        or is_collinear(atoms[:, row[1:]])):
                    raise RuntimeError(
                        f'Row {row_idx + 1} have collinear atoms.')
            if is_collinear(atoms[:, ref_atoms]):
                raise RuntimeError('Axes atoms are collinear!')

            with torch.no_grad():
                dofs = conversion.cartesian_to_mixed(torch.as_tensor(
                    positions, dtype=self.dtype, device=self.device))[0]
                # One copy to the host per batch.
                batch_min, batch_max = torch.stack(
                    [dofs.amin(dim=0), dofs.amax(dim=0)]).cpu().numpy()
            if min_dofs is None:
                min_dofs, max_dofs = batch_min, batch_max
            else:
                min_dofs = np.minimum(min_dofs, batch_min)
                max_dofs = np.maximum(max_dofs, batch_max)

        return min_dofs, max_dofs

    # ------------------------------------------------------------------ #
    # Transformer + degree assignment.
    # ------------------------------------------------------------------ #
    def _get_transformer(self, conversion, min_dof_vals, max_dof_vals,
                         dof_indices):
        x0 = np.array(min_dof_vals, dtype=np.float64)
        xf = np.array(max_dof_vals, dtype=np.float64)

        x0[dof_indices['distances']] = np.maximum(
            0.0, x0[dof_indices['distances']]
            - self.distance_lower_limit_displacement)

        # Kept-constant reference DOFs are conditioning, as in the JAX
        # package: propagated unchanged, so the map's log-det stays exact.
        excluded = dof_indices['conditioning']
        if len(dof_indices['reference']) > 0:
            excluded = (dof_indices['reference'] if excluded is None
                        else np.sort(np.concatenate(
                            [excluded, dof_indices['reference']])))
        if excluded is not None:
            mask = ~np.isin(np.arange(conversion.n_dofs_out), excluded)
            x0 = x0[mask]
            xf = xf[mask]
            dof_indices = dof_indices.copy()
            for key in ('distances', 'angles', 'torsions', 'cartesians'):
                dof_indices[key] = remove_and_shift_sorted_indices(
                    np.sort(dof_indices[key]), removed_indices=excluded)

        like = dict(device=self.device, dtype=self.dtype)
        n_angles = len(dof_indices['angles'])
        n_torsions = len(dof_indices['torsions'])
        transformer_indices = [
            dof_indices['distances'],
            dof_indices['angles'],
            dof_indices['torsions'],
        ]
        transformers = [
            NeuralSplineTransformer(
                x0[dof_indices['distances']], xf[dof_indices['distances']],
                self.n_bins, circular=False, identity_boundary_slopes=True,
                learn_lower_bound=False, learn_upper_bound=True, **like),
            NeuralSplineTransformer(np.zeros(n_angles), np.ones(n_angles),
                                    self.n_bins, circular=False, **like),
            NeuralSplineTransformer(np.zeros(n_torsions),
                                    np.ones(n_torsions), self.n_bins,
                                    circular=True, **like),
        ]

        if len(dof_indices['cartesians']) > 0:
            transformers.append(NeuralSplineTransformer(
                x0[dof_indices['cartesians']], xf[dof_indices['cartesians']],
                self.n_bins, circular=False, identity_boundary_slopes=True,
                learn_lower_bound=True, learn_upper_bound=True, **like))
            transformer_indices.append(dof_indices['cartesians'])

        return MixedTransformer(transformers, transformer_indices,
                                device=self.device)

    def _get_maf_degrees_in(self, n_dofs_in, maf_dof_indices):
        """[ascending, descending] degree vectors; the kept-constant
        reference DOFs are conditioning (see :meth:`_get_transformer`)."""
        conditioning = maf_dof_indices['conditioning']
        reference = maf_dof_indices['reference']
        if len(reference) > 0:
            conditioning = (reference if conditioning is None
                            else np.concatenate([conditioning, reference]))

        return [generate_degrees(
            n_features=n_dofs_in, order=order,
            conditioning_indices=(None if conditioning is None
                                  else np.sort(conditioning)),
            repeats=self.degrees_repeats)
            for order in ('ascending', 'descending')]
