"""Continuous-flow TFEP map with E(n)-equivariant GNN dynamics.

Port of ``tfep_tpu/app/continuousegnn.py``: the CNF app map, with the full
:class:`~tfep_tpu_torch.app.TFEPMapBase` contract (atom partitioning,
logging, checkpointing, resume).

- Conditioning atoms are velocity masking
  (:class:`~tfep_tpu_torch.nn.dynamics.MaskedVelocityDynamics`): the EGNN
  sees their coordinates, their velocities are zero, so they stay in
  place and add nothing to ``log_det_J``.
- Hutchinson probes are drawn per batch and step from a
  ``torch.Generator`` seeded on the host from the map's seed, the batch's
  sample indices and the trainer's global step: training steps see fresh
  probes, while evaluation and resume stay reproducible. The JAX package
  folds the same three numbers into a ``jax.random`` key, which gives
  other probes.
- ``egnn_kwargs`` takes the JAX package's names of the pairwise path,
  ``pairwise='xla'``/``'pallas'``, and passes the port's own
  ``'dense'``/``'fused'`` as they are: hyperparameters written for the
  JAX map build the same map here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from tfep_tpu_torch.app.base import TFEPMapBase

__all__ = ['ContinuousEGNNMap']

#: ``pairwise`` as the JAX package names it -> the port's name.
PAIRWISE_NAMES = {'xla': 'dense', 'pallas': 'fused',
                  'dense': 'dense', 'fused': 'fused'}


def translate_egnn_kwargs(egnn_kwargs) -> dict:
    """``egnn_kwargs`` with ``pairwise`` in the port's name; raises
    ``ValueError`` on a name neither package has."""
    kwargs = dict(egnn_kwargs)
    if 'pairwise' in kwargs:
        name = kwargs['pairwise']
        if name not in PAIRWISE_NAMES:
            raise ValueError(
                f"pairwise must be 'xla' or 'pallas' (the JAX package's "
                f"names) or 'dense' or 'fused', got {name!r}.")
        kwargs['pairwise'] = PAIRWISE_NAMES[name]
    return kwargs


class ContinuousEGNNMap(TFEPMapBase):
    """TFEP map: continuous normalizing flow with EGNN dynamics.

    The velocity field is an E(n)-equivariant graph network over the
    non-fixed atoms (node types = chemical elements by default), so the
    learned map commutes with rotations, translations and permutations of
    same-type atoms: no reference-frame atoms are needed (and none are
    accepted). Accepts every :class:`~tfep_tpu_torch.app.TFEPMapBase`
    argument plus the ones below.

    Parameters
    ----------
    r_cutoff : float, optional
        Radial message-passing cutoff in the positions unit (angstrom).
    n_egnn_layers : int, optional
        Number of message-passing layers.
    node_feat_dim, distance_feat_dim, time_feat_dim : int, optional
        Node-feature width, radial-basis size and Gaussian time-embedding
        size.
    node_types : sequence of int, optional
        Integer type per *non-fixed* atom. Defaults to one type per
        chemical element.
    solver : str, optional
        ``'euler'``, ``'midpoint'``, ``'rk4'`` or ``'dopri5'``.
    n_steps : int, optional
        Integration steps from t=0 to 1.
    trace_estimator : str, optional
        ``'hutchinson'`` (default) or ``'exact'``.
    n_hutchinson_samples : int, optional
        Probes per trace estimate.
    regularization : bool, optional
        Add the Finlay kinetic + Frobenius regularizer to the loss.
    egnn_kwargs : dict, optional
        Extra arguments for
        :meth:`tfep_tpu_torch.nn.dynamics.EGNNDynamics.create` (e.g.
        ``speed_factor``, ``compute_dtype='bfloat16'``,
        ``pairwise='pallas'``, which runs the kernels).
    cnf_kwargs : dict, optional
        Extra arguments for
        :meth:`tfep_tpu_torch.nn.flows.ContinuousFlow.create` (e.g.
        ``checkpoint=False``).
    """

    #: Ask the trainer to put the global step into each batch so the
    #: Hutchinson probes refresh every optimization step.
    needs_global_step = True

    def __init__(self, *args, r_cutoff: float = 6.0, n_egnn_layers: int = 4,
                 node_feat_dim: int = 64, distance_feat_dim: int = 64,
                 time_feat_dim: int = 16,
                 node_types: Optional[Sequence[int]] = None,
                 solver: str = 'rk4', n_steps: int = 10,
                 trace_estimator: str = 'hutchinson',
                 n_hutchinson_samples: int = 1, regularization: bool = True,
                 egnn_kwargs=None, cnf_kwargs=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.r_cutoff = float(r_cutoff)
        self.n_egnn_layers = int(n_egnn_layers)
        self.node_feat_dim = int(node_feat_dim)
        self.distance_feat_dim = int(distance_feat_dim)
        self.time_feat_dim = int(time_feat_dim)
        self.node_types = (None if node_types is None
                           else list(int(t) for t in node_types))
        self.solver = solver
        self.n_steps = int(n_steps)
        self.trace_estimator = trace_estimator
        self.n_hutchinson_samples = int(n_hutchinson_samples)
        self.regularization = bool(regularization)
        self.egnn_kwargs = dict(egnn_kwargs or {})
        # Fail at construction, not in setup(), on an unknown name.
        translate_egnn_kwargs(self.egnn_kwargs)
        self.cnf_kwargs = dict(cnf_kwargs or {})
        self.hparams.update(
            r_cutoff=self.r_cutoff, n_egnn_layers=self.n_egnn_layers,
            node_feat_dim=self.node_feat_dim,
            distance_feat_dim=self.distance_feat_dim,
            time_feat_dim=self.time_feat_dim, node_types=self.node_types,
            solver=self.solver, n_steps=self.n_steps,
            trace_estimator=self.trace_estimator,
            n_hutchinson_samples=self.n_hutchinson_samples,
            regularization=self.regularization,
            egnn_kwargs=self.egnn_kwargs, cnf_kwargs=self.cnf_kwargs)

    # ------------------------------------------------------------------ #
    def determine_atom_indices(self):
        super().determine_atom_indices()
        if (self._origin_atom_idx is not None
                or self._axes_atoms_indices is not None):
            raise ValueError(
                'ContinuousEGNNMap does not accept origin_atom/axes_atoms: '
                'the EGNN velocity field is already equivariant under '
                'rigid motions, so reference-frame fixing is unnecessary.')

    def configure_flow(self):
        from tfep_tpu_torch.nn.dynamics import (
            EGNNDynamics, MaskedVelocityDynamics,
        )
        from tfep_tpu_torch.nn.flows import ContinuousFlow

        node_types = self.node_types
        if node_types is None:
            elements = np.asarray(self._system.topology.elements)
            nonfixed = np.setdiff1d(
                np.arange(len(elements)),
                np.zeros(0, np.int64) if self._fixed_atom_indices is None
                else np.asarray(self._fixed_atom_indices))
            elements = elements[nonfixed]
            unique = {e: i for i, e in enumerate(sorted(set(elements)))}
            node_types = [unique[e] for e in elements]
        if len(node_types) != self.n_nonfixed_atoms:
            raise ValueError(
                f'node_types has {len(node_types)} entries but the map has '
                f'{self.n_nonfixed_atoms} non-fixed atoms.')

        like = dict(device=self.device, dtype=self.dtype)
        dynamics = EGNNDynamics.create(
            torch.Generator().manual_seed(self.seed), node_types=node_types,
            r_cutoff=self.r_cutoff, time_feat_dim=self.time_feat_dim,
            node_feat_dim=self.node_feat_dim,
            distance_feat_dim=self.distance_feat_dim,
            n_layers=self.n_egnn_layers,
            **translate_egnn_kwargs(self.egnn_kwargs), **like)

        conditioning_dofs = self.get_conditioning_indices(
            idx_type='dof', remove_fixed=True)
        if conditioning_dofs is not None and len(conditioning_dofs):
            dynamics = MaskedVelocityDynamics.create(
                dynamics, conditioning_dofs,
                dim=3 * self.n_nonfixed_atoms, **like)

        return ContinuousFlow.create(
            dynamics, trace_estimator=self.trace_estimator,
            solver=self.solver, n_steps=self.n_steps,
            n_hutchinson_samples=self.n_hutchinson_samples,
            regularization=self.regularization, seed=self.seed,
            device=self.device, **self.cnf_kwargs)

    # ------------------------------------------------------------------ #
    def probe_generator(self, batch) -> Optional[torch.Generator]:
        """The generator of a batch's Hutchinson probes, on the map's
        device, or ``None`` for the exact trace.

        Its seed mixes ``seed + 1``, ``sum_k idx_k (2k + 1)`` over the
        batch's dataset sample indices (uint32 arithmetic, as the JAX
        package folds them) and, when the trainer put it in the batch, the
        global step. The indices are read on the host, so no device sync
        is needed; probes refresh every step even with ``shuffle=False``,
        and a given (batch, step) stays reproducible across evaluation and
        resume.
        """
        if self.trace_estimator != 'hutchinson':
            return None
        idx = batch['dataset_sample_index']
        if isinstance(idx, torch.Tensor):
            idx = idx.cpu().numpy()
        idx = np.asarray(idx).astype(np.uint64)
        weights = 2 * np.arange(len(idx), dtype=np.uint64) + 1
        fold = int(np.sum(idx * weights) % (1 << 32))
        entropy = [self.seed + 1, fold]
        if 'global_step' in batch:
            entropy.append(int(batch['global_step']))
        seed = np.random.SeedSequence(entropy).generate_state(
            2, np.uint32).astype(np.uint64)
        return torch.Generator(device=self.device).manual_seed(
            int(seed[0] << np.uint64(32) | seed[1]))

    def _run_flow(self, flow, batch, inverse: bool):
        """Like the base, with the batch's Hutchinson probes."""
        x = batch['positions']
        generator = self.probe_generator(batch)
        out = (flow.inverse(x, generator=generator) if inverse
               else flow.forward(x, generator=generator))
        result = dict(positions=out[0], log_det_J=out[1])
        if len(out) > 2:
            result['regularization'] = out[2]
        return result
