"""TFEP map base: wires dataset, flow, potential, loss, and logging together.

Port of ``tfep_tpu/app/base.py``. The map is a host-side coordinator: it
owns the data-dependent construction (atom-role partitioning into
mapped/conditioning/fixed sets, reference-frame bookkeeping, flow
creation), which runs once in :meth:`TFEPMapBase.setup`. The training step
is :meth:`TFEPMapBase.training_step_fn(flow, batch)`, which
:class:`tfep_tpu_torch.app.trainer.Trainer` differentiates and steps.

Batches come from the dataset as numpy arrays. :meth:`host_tensors` turns
them into CPU tensors (the floating arrays in the map's dtype, in pinned
memory when the map is on a card) and :meth:`batch_to_device` sends the
floating ones to the map's device; the sample indices stay on the host,
where the logger reads them.

The system comes in memory or from trajectory files
(:meth:`tfep_tpu_torch.io.traj.System.from_file`, lazily with
``lazy_trajectory=True``). The target potential is a torch function or an
:class:`~tfep_tpu_torch.potentials.EnginePotential`; for the latter the
map also offers the split step that ``Trainer(engine_overlap=True)``
pipelines (``forward_step_fn``, ``host_engine_eval``,
``pipelined_update_fn``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from tfep_tpu_torch.device import resolve_device
from tfep_tpu_torch.io.log import TFEPLogger
from tfep_tpu_torch.io.traj import System, TrajectoryDataset
from tfep_tpu_torch.loss import boltzmann_kl_div_loss
from tfep_tpu_torch.nn.flows import PartialFlow
from tfep_tpu_torch.units import Quantity, ureg
from tfep_tpu_torch.utils import tracing
from tfep_tpu_torch.utils.misc import (
    atom_to_flattened_indices, ensure_int_array,
    remove_and_shift_sorted_indices,
)

__all__ = ['TFEPMapBase']

#: Per-sample entries of the aux dict that the evaluation collects.
_EVAL_KEYS = ('potential', 'log_det_J', 'dataset_sample_index',
              'trajectory_sample_index')


class TFEPMapBase:
    """Abstract base class for TFEP maps.

    A map bundles everything one targeted-free-energy-perturbation run
    needs: the trajectory dataset, the atom-role partitioning
    (mapped / conditioning / fixed), the invertible flow over the
    non-fixed degrees of freedom (fixed atoms are wrapped away by a
    :class:`~tfep_tpu_torch.nn.flows.PartialFlow`), the target potential,
    the kT-reduced KL loss, and per-sample work logging for the estimator.
    Subclasses implement :meth:`configure_flow`.

    Example
    -------
    >>> from tfep_tpu_torch.app import CartesianMAFMap, Trainer  # doctest: +SKIP
    >>> tfep_map = CartesianMAFMap(
    ...     potential_energy_func=potential,
    ...     temperature=300.0 * ureg.kelvin,
    ...     system=System(topology, frames),
    ...     batch_size=1024,
    ...     mapped_atoms='resname MOL',
    ...     conditioning_atoms='resname SOL')                   # doctest: +SKIP
    >>> Trainer(save_dir='ckpt', max_epochs=10).fit(tfep_map)   # doctest: +SKIP

    Afterwards ``tfep_map.tfep_logger`` holds per-sample potentials and
    log-det-Jacobians for the free-energy estimator.

    Parameters
    ----------
    potential_energy_func : callable
        The target potential ``u_B``: maps ``(batch, n_atoms*3)`` flattened
        positions on the map's device (plus ``dimensions`` when the dataset
        has a box) to ``(batch,)`` energies, as torch tensors. Its
        ``energy_unit`` attribute (None means "already in kT") drives the
        kT reduction.
    temperature : Quantity
        The ensemble temperature (used with ``energy_unit`` to form kT).
    system : System, optional
        In-memory topology + frames.
    topology_file_path, coordinates_file_path : str, optional
        Files to load the system from: coordinates in PDB/GRO/XYZ or
        binary DCD/XTC/TRR/AMBER NetCDF (which additionally need the
        topology file — PDB/GRO/prmtop/.top/.psf). The hparams record only
        the paths, so a map restored from a checkpoint rereads the files.
    batch_size : int
        Frames per optimization step.
    mapped_atoms, conditioning_atoms : selection, optional
        Index lists or selection strings (:mod:`tfep_tpu_torch.io.topology`).
        Mapped atoms are transformed; conditioning atoms influence the map
        but stay fixed; everything else is fixed and removed from the
        flow entirely. Defaults: all atoms mapped.
    origin_atom, axes_atoms : selection, optional
        Reference-frame atoms: the origin atom is pinned at the origin
        (must be conditioning) and the two axes atoms fix the global
        rotation. Their constrained DOFs are removed from the flow with
        exact log-det accounting.
    tfep_logger_dir_path : str, optional
        Where per-sample work values are stored (None disables logging).
    ignore_nan : bool
        Ignore NaN energies (failed engine evaluations) in the loss.
    lazy_trajectory : bool
        Stream binary trajectories from disk per batch (with a file only).
    seed : int
        Seed of the ``torch.Generator`` that initializes the parameters.
    device : str or torch.device, optional
        Where the flow and the batches live. Defaults to ``cuda``; raises
        without a card.
    dtype : torch.dtype, optional
        Type of the flow's parameters and of the batches' positions.
    """

    def __init__(self,
                 potential_energy_func,
                 temperature: Quantity,
                 system: Optional[System] = None,
                 topology_file_path: Optional[str] = None,
                 coordinates_file_path: Optional[Union[str, Sequence[str]]] = None,
                 batch_size: int = 1,
                 mapped_atoms=None,
                 conditioning_atoms=None,
                 origin_atom=None,
                 axes_atoms=None,
                 tfep_logger_dir_path: Optional[str] = 'tfep_logs',
                 ignore_nan: bool = False,
                 lazy_trajectory: bool = False,
                 seed: int = 0,
                 device=None,
                 dtype: torch.dtype = torch.float32):
        if system is not None and coordinates_file_path is not None:
            # Mutually exclusive: the in-memory system would win while the
            # checkpoint recorded only the (never-read) path, so a map
            # restored from the checkpoint would train on different data.
            raise ValueError(
                'Pass either system or coordinates_file_path, not both.')
        self.device = resolve_device(device)
        self.dtype = dtype
        # Constructor config recorded for self-contained checkpoints.
        self.hparams: Dict[str, Any] = {
            'potential_energy_func': potential_energy_func,
            'temperature': temperature,
            'system': system,
            'topology_file_path': topology_file_path,
            'coordinates_file_path': coordinates_file_path,
            'batch_size': batch_size,
            'mapped_atoms': mapped_atoms,
            'conditioning_atoms': conditioning_atoms,
            'origin_atom': origin_atom,
            'axes_atoms': axes_atoms,
            'tfep_logger_dir_path': tfep_logger_dir_path,
            'ignore_nan': ignore_nan,
            'lazy_trajectory': lazy_trajectory,
            'seed': seed,
            'device': device,
            'dtype': dtype,
        }

        if system is None:
            if coordinates_file_path is None:
                raise ValueError(
                    'Pass either system or coordinates_file_path.')
            system = System.from_file(coordinates_file_path,
                                      topology_path=topology_file_path,
                                      lazy=lazy_trajectory)
        self._system = system
        self._potential_energy_func = potential_energy_func
        self.batch_size = int(batch_size)
        self._mapped_atoms = mapped_atoms
        self._conditioning_atoms = conditioning_atoms
        self._origin_atom = origin_atom
        self._axes_atoms = axes_atoms
        self._tfep_logger_dir_path = tfep_logger_dir_path
        self._ignore_nan = ignore_nan
        self.seed = seed

        # kT in the energy unit returned by the potential (per-mole units
        # use R, per-particle kB).
        energy_unit = getattr(potential_energy_func, 'energy_unit', None)
        if energy_unit is None:
            self.kT = 1.0
        else:
            self.kT = float(ureg.kT(temperature, energy_unit).magnitude)

        # Data-dependent state initialized in setup().
        self.dataset: Optional[TrajectoryDataset] = None
        self.flow = None
        self.trainer = None
        self._tfep_logger: Optional[TFEPLogger] = None
        self._mapped_atom_indices = None
        self._conditioning_atom_indices = None
        self._fixed_atom_indices = None
        self._origin_atom_idx = None
        self._axes_atoms_indices = None

    # ------------------------------------------------------------------ #
    @classmethod
    def load_from_checkpoint(cls, checkpoint_path: str, **override_hparams):
        """Rebuild a map (constructor config + trained parameters) from a
        checkpoint of :class:`~tfep_tpu_torch.app.trainer.Trainer` alone.

        Hyperparameters that could not be pickled at save time (e.g. a
        non-picklable engine handle) must be supplied as keyword
        overrides; any override replaces the stored value.
        """
        from tfep_tpu_torch.app.trainer import load_map_from_checkpoint
        return load_map_from_checkpoint(checkpoint_path,
                                        expected_class=cls,
                                        **override_hparams)

    # ------------------------------------------------------------------ #
    # Setup phase (host-side).
    # ------------------------------------------------------------------ #
    def setup(self):
        """Build dataset, atom partitioning, and flow.

        Idempotent: calling it again after the flow exists is a no-op, so
        :meth:`Trainer.fit` can always call it safely.
        """
        if self.flow is not None:
            return
        self.dataset = self.create_dataset()
        self.determine_atom_indices()
        flow = self.configure_flow()
        self.flow = self.create_partial_flow(flow)

    def create_dataset(self) -> TrajectoryDataset:
        """Build the :class:`~tfep_tpu_torch.io.traj.TrajectoryDataset` for
        the run. Override to subsample frames or merge auxiliary datasets
        (e.g. precomputed log-weights)."""
        return TrajectoryDataset(self._system)

    def configure_flow(self):
        """Build the flow over non-fixed DOFs (abstract)."""
        raise NotImplementedError

    def create_partial_flow(self, flow, return_partial: bool = False):
        """Wrap ``flow`` in a PartialFlow carrying the fixed DOFs."""
        if self.n_fixed_atoms > 0:
            fixed_dof_indices = atom_to_flattened_indices(
                self._fixed_atom_indices)
            n_dofs = self.dataset.n_atoms * 3
            flow = PartialFlow.create(
                flow, fixed_dof_indices, n_features=n_dofs,
                return_partial=return_partial, device=self.device)
        return flow

    def determine_atom_indices(self):
        """Partition atoms into mapped / conditioning / fixed and resolve
        the reference-frame (origin/axes) atoms, with the JAX package's
        validation errors."""
        n_atoms = self.dataset.n_atoms
        mapped = self._mapped_atoms
        conditioning = self._conditioning_atoms

        if mapped is None and conditioning is None:
            mapped_idx = np.arange(n_atoms)
            conditioning_idx = None
            fixed_idx = None
        elif conditioning is None:
            mapped_idx = self._get_selected_indices(mapped)
            fixed_idx = np.setdiff1d(np.arange(n_atoms), mapped_idx)
            conditioning_idx = None
        elif mapped is None:
            conditioning_idx = self._get_selected_indices(conditioning)
            mapped_idx = np.setdiff1d(np.arange(n_atoms), conditioning_idx)
            fixed_idx = None
        else:
            mapped_idx = self._get_selected_indices(mapped)
            conditioning_idx = self._get_selected_indices(conditioning)
            if len(np.intersect1d(mapped_idx, conditioning_idx)) > 0:
                raise ValueError('Mapped and conditioning selections cannot '
                                 'have overlapping atoms.')
            non_fixed = np.union1d(mapped_idx, conditioning_idx)
            fixed_idx = np.setdiff1d(np.arange(n_atoms), non_fixed)

        if conditioning_idx is not None and len(conditioning_idx) == 0:
            conditioning_idx = None
        if fixed_idx is not None and len(fixed_idx) == 0:
            fixed_idx = None
        if len(mapped_idx) == 0:
            raise ValueError('There are no atoms to map.')
        if len(set(mapped_idx.tolist())) != len(mapped_idx):
            raise ValueError('There are duplicate mapped atom indices.')
        if (conditioning_idx is not None and
                len(set(conditioning_idx.tolist())) != len(conditioning_idx)):
            raise ValueError('There are duplicate conditioning atom indices.')

        origin = self._origin_atom
        if origin is None:
            origin_idx = None
        else:
            origin_arr = self._get_selected_indices(origin, sort=False)
            if origin_arr.size > 1:
                raise ValueError('Selected multiple atoms as the origin atom')
            origin_idx = int(origin_arr.reshape(-1)[0])

        axes = self._axes_atoms
        if axes is None:
            axes_idx = None
        else:
            axes_idx = self._get_selected_indices(axes, sort=False)
            if len(axes_idx) != 2:
                raise ValueError('Exactly 2 axes atoms must be given.')
            reference = list(axes_idx.tolist())
            if origin_idx is not None:
                reference = [origin_idx] + reference
            if len(set(reference)) != len(reference):
                raise ValueError(
                    'center, axis, and plane atoms must be different')
            if fixed_idx is not None and np.any(np.isin(axes_idx, fixed_idx)):
                raise ValueError(
                    'axis and plane atoms must be mapped or conditioning '
                    'atoms as they affect the mapping.')

        self._mapped_atom_indices = mapped_idx.astype(np.int64)
        self._conditioning_atom_indices = (
            None if conditioning_idx is None
            else conditioning_idx.astype(np.int64))
        self._fixed_atom_indices = (
            None if fixed_idx is None else fixed_idx.astype(np.int64))
        self._origin_atom_idx = origin_idx
        self._axes_atoms_indices = (
            None if axes is None else np.asarray(axes_idx, dtype=np.int64))

    def _get_selected_indices(self, selection, sort: bool = True):
        """Resolve a selection string / index sequence to atom indices."""
        if isinstance(selection, str):
            idx = self._system.select_atoms(selection)
        else:
            idx = ensure_int_array(selection)
        if sort:
            idx = np.sort(idx)
        return idx

    # ------------------------------------------------------------------ #
    # Index bookkeeping helpers for subclasses.
    # ------------------------------------------------------------------ #
    @property
    def n_mapped_atoms(self) -> int:
        """Number of mapped (transported) atoms."""
        return len(self._mapped_atom_indices)

    @property
    def n_conditioning_atoms(self) -> int:
        """Number of conditioning atoms (seen by the flow, not moved)."""
        if self._conditioning_atom_indices is None:
            return 0
        return len(self._conditioning_atom_indices)

    @property
    def n_fixed_atoms(self) -> int:
        """Number of fixed atoms (removed from the flow entirely)."""
        if self._fixed_atom_indices is None:
            return 0
        return len(self._fixed_atom_indices)

    @property
    def n_nonfixed_atoms(self) -> int:
        """Mapped + conditioning atoms (the atoms the flow sees)."""
        return self.n_mapped_atoms + self.n_conditioning_atoms

    @property
    def n_nonfixed_dofs(self) -> int:
        """Non-fixed DOFs after removing the reference-frame constrained ones
        (origin: 3, axes: 3)."""
        n = 3 * self.n_nonfixed_atoms
        if self._origin_atom_idx is not None:
            n -= 3
        if self._axes_atoms_indices is not None:
            n -= 3
        return n

    def get_reference_atoms_indices(self, remove_fixed: bool,
                                    separate_origin_axes: bool = False):
        """Indices of origin+axes atoms, optionally in the fixed-removed
        frame."""
        origin, axes = self._origin_atom_idx, self._axes_atoms_indices
        if origin is None and axes is None:
            if separate_origin_axes:
                return None, None
            return None

        indices = []
        if origin is not None:
            indices.append(origin)
        if axes is not None:
            indices.extend(axes.tolist())
        indices = np.asarray(indices, dtype=np.int64)

        if remove_fixed and self._fixed_atom_indices is not None:
            indices = remove_and_shift_sorted_indices(
                np.sort(indices), self._fixed_atom_indices, remove=False)
            # Restore original (origin, axis, plane) order.
            order = np.argsort(np.argsort(
                ([origin] if origin is not None else [])
                + (axes.tolist() if axes is not None else [])))
            indices = indices[order]

        if separate_origin_axes:
            if origin is None:
                return None, indices
            if axes is None:
                return indices[0], None
            return indices[0], indices[1:]
        return indices

    def get_mapped_indices(self, idx_type: str = 'atom',
                           remove_fixed: bool = True) -> np.ndarray:
        """Mapped atom (or DOF) indices, optionally after fixed-atom removal."""
        return self._get_nonfixed_indices(self._mapped_atom_indices,
                                          idx_type, remove_fixed)

    def get_conditioning_indices(self, idx_type: str = 'atom',
                                 remove_fixed: bool = True):
        """Conditioning atom (or DOF) indices, or ``None`` if there are
        none; optionally in the fixed-removed indexing."""
        if self._conditioning_atom_indices is None:
            return None
        return self._get_nonfixed_indices(self._conditioning_atom_indices,
                                          idx_type, remove_fixed)

    def get_nonfixed_indices(self, idx_type: str = 'atom',
                             remove_fixed: bool = True) -> np.ndarray:
        """All mapped + conditioning atom (or DOF) indices, sorted."""
        nonfixed = self._mapped_atom_indices
        if self._conditioning_atom_indices is not None:
            nonfixed = np.sort(np.concatenate(
                [nonfixed, self._conditioning_atom_indices]))
        return self._get_nonfixed_indices(nonfixed, idx_type, remove_fixed)

    def get_fixed_indices(self, idx_type: str = 'atom'):
        """Fixed atom (or DOF) indices in the full-system indexing, or
        ``None`` when no atoms are fixed."""
        if self._fixed_atom_indices is None:
            return None
        if idx_type == 'atom':
            return self._fixed_atom_indices
        if idx_type == 'dof':
            return atom_to_flattened_indices(self._fixed_atom_indices)
        raise ValueError("idx_type must be 'atom' or 'dof'.")

    def _get_nonfixed_indices(self, atom_indices, idx_type, remove_fixed):
        if remove_fixed and self._fixed_atom_indices is not None:
            atom_indices = remove_and_shift_sorted_indices(
                atom_indices, self._fixed_atom_indices, remove=False)
        if idx_type == 'atom':
            return atom_indices
        if idx_type == 'dof':
            return atom_to_flattened_indices(atom_indices)
        raise ValueError("idx_type must be 'atom' or 'dof'.")

    # ------------------------------------------------------------------ #
    # Batches.
    # ------------------------------------------------------------------ #
    def host_tensors(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A dataset batch as CPU tensors: the floating arrays cast to the
        map's dtype (in pinned memory when the map is on a card, so the
        copy to the card does not block the host), the rest as they are."""
        pin = self.device.type == 'cuda'
        out = {}
        for name, value in batch.items():
            tensor = torch.as_tensor(np.asarray(value))
            if tensor.is_floating_point():
                if pin:
                    pinned = torch.empty(tensor.shape, dtype=self.dtype,
                                         pin_memory=True)
                    tensor = pinned.copy_(tensor)
                else:
                    tensor = tensor.to(self.dtype)
            out[name] = tensor
        return out

    def batch_to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Send the floating tensors of a batch to the map's device (the
        output of :meth:`host_tensors`, or numpy arrays); the sample
        indices stay on the host."""
        if not all(isinstance(v, torch.Tensor) for v in batch.values()):
            batch = self.host_tensors(batch)
        return {name: value.to(self.device, non_blocking=True)
                if value.is_floating_point() else value
                for name, value in batch.items()}

    # ------------------------------------------------------------------ #
    # The map.
    # ------------------------------------------------------------------ #
    def forward(self, batch: Dict) -> Dict:
        """Map a batch through the flow (the training direction).

        Parameters
        ----------
        batch : dict
            As produced by ``dataset.get_batch`` (numpy arrays, sent to the
            map's device) or tensors already there: must carry
            ``'positions'`` of shape ``(batch, n_atoms*3)``.

        Returns
        -------
        dict
            ``{'positions', 'log_det_J'}`` plus ``'regularization'`` when
            the flow returns one.
        """
        return self._run_flow(self.flow, self.batch_to_device(batch),
                              inverse=False)

    def inverse(self, batch: Dict) -> Dict:
        """Exact inverse of :meth:`forward`; same batch contract."""
        return self._run_flow(self.flow, self.batch_to_device(batch),
                              inverse=True)

    @staticmethod
    def _run_flow(flow, batch: Dict, inverse: bool) -> Dict:
        x = batch['positions']
        out = flow.inverse(x) if inverse else flow.forward(x)
        result = dict(positions=out[0], log_det_J=out[1])
        if len(out) > 2:
            result['regularization'] = out[2]
        return result

    def training_step_fn(self, flow, batch: Dict):
        """The loss of one batch on the device: ``(flow, batch) -> (loss,
        aux)``, with the per-sample ``potential`` (in kT), ``log_det_J``
        and sample indices in ``aux``."""
        result = self._run_flow(flow, batch, inverse=False)

        potential_kwargs = {}
        if getattr(self._potential_energy_func, 'uses_sample_keys', False):
            potential_kwargs['sample_keys'] = batch['trajectory_sample_index']
        if 'dimensions' in batch:
            potential = self._potential_energy_func(
                result['positions'], batch['dimensions'], **potential_kwargs)
        else:
            potential = self._potential_energy_func(
                result['positions'], **potential_kwargs)
        potential = potential / self.kT

        if 'log_weights' in batch:
            log_weights = batch['log_weights']
        elif 'bias' in batch:
            log_weights = batch['bias'] / self.kT
        else:
            log_weights = None

        loss = boltzmann_kl_div_loss(
            target_potentials=potential,
            log_det_J=result['log_det_J'],
            log_weights=log_weights,
            ignore_nan=self._ignore_nan,
        )
        if 'regularization' in result:
            loss = loss + torch.mean(result['regularization'])

        aux = {
            'potential': potential,
            'log_det_J': result['log_det_J'],
            'dataset_sample_index': batch['dataset_sample_index'],
            'trajectory_sample_index': batch['trajectory_sample_index'],
            'loss': loss,
        }
        return loss, aux

    # ------------------------------------------------------------------ #
    # Pipelined (engine-overlap) training contract: the step is split so
    # the trainer can run the external engine on the host while the card
    # works. The engine sees y(θ_k); the update computes the exact loss
    # gradient at θ_k via a surrogate whose potential term is
    # sum(-forces * y) with the forces held constant — the same cotangent
    # the autograd bridge injects (bridge.py, backward).
    # ------------------------------------------------------------------ #
    def forward_step_fn(self, flow, batch: Dict) -> Dict:
        """The flow's forward only (no potential): the pipeline's phase A."""
        return self._run_flow(flow, batch, inverse=False)

    def host_engine_eval(self, mapped_positions, batch: Dict):
        """Blocking host-side engine evaluation: the pipeline's phase B.

        ``mapped_positions`` and the batch's ``dimensions`` and
        ``trajectory_sample_index`` are on the host (numpy arrays or CPU
        tensors). Returns ``(potentials_kT, forces_kT)`` — per-sample
        reduced potentials and forces in 1/kT units, numpy.
        """
        potential = self._potential_energy_func
        kwargs = {}
        if getattr(potential, 'uses_sample_keys', False):
            kwargs['sample_keys'] = np.asarray(
                batch['trajectory_sample_index'])
        cell = (np.asarray(batch['dimensions']) if 'dimensions' in batch
                else None)
        energies, forces = potential.compute_energies_and_forces(
            np.asarray(mapped_positions), cell, **kwargs)
        return energies / self.kT, forces / self.kT

    def pipelined_update_fn(self, flow, batch: Dict, potentials_kT,
                            forces_kT):
        """The loss of phase C, differentiable through the flow.

        The value reported in ``aux['loss']`` is the true TFEP loss; the
        returned differentiable loss is the force-linearized surrogate
        (identical gradient at the parameters the engine evaluated).
        ``potentials_kT`` and ``forces_kT`` are tensors on the batch's
        device.
        """
        result = self._run_flow(flow, batch, inverse=False)
        surrogate = torch.sum(-forces_kT.detach() * result['positions'],
                              dim=-1)
        # Engine failures (NaN energy, zero forces) must keep poisoning
        # the sample so the NaN policy applies to the surrogate too.
        surrogate = surrogate.masked_fill(torch.isnan(potentials_kT),
                                          float('nan'))

        if 'log_weights' in batch:
            log_weights = batch['log_weights']
        elif 'bias' in batch:
            log_weights = batch['bias'] / self.kT
        else:
            log_weights = None

        loss = boltzmann_kl_div_loss(
            target_potentials=surrogate, log_det_J=result['log_det_J'],
            log_weights=log_weights, ignore_nan=self._ignore_nan)
        log_det_J = result['log_det_J'].detach()
        true_loss = boltzmann_kl_div_loss(
            target_potentials=potentials_kT, log_det_J=log_det_J,
            log_weights=log_weights, ignore_nan=self._ignore_nan)
        if 'regularization' in result:
            reg = torch.mean(result['regularization'])
            loss = loss + reg
            true_loss = true_loss + reg.detach()

        aux = {
            'potential': potentials_kT,
            'log_det_J': log_det_J,
            'dataset_sample_index': batch['dataset_sample_index'],
            'trajectory_sample_index': batch['trajectory_sample_index'],
            'loss': true_loss,
        }
        return loss, aux

    # ------------------------------------------------------------------ #
    # Host-side logging.
    # ------------------------------------------------------------------ #
    @property
    def tfep_logger(self) -> Optional[TFEPLogger]:
        """Lazily-created per-sample :class:`~tfep_tpu_torch.io.log.TFEPLogger`
        (``None`` when logging is disabled via
        ``tfep_logger_dir_path=None``)."""
        if self._tfep_logger is None and self._tfep_logger_dir_path is not None:
            n = len(self.dataset)
            self._tfep_logger = TFEPLogger(
                save_dir_path=self._tfep_logger_dir_path,
                batch_size=self.batch_size,
                n_samples_per_epoch=n)
        return self._tfep_logger

    def log_train_tensors(self, aux: Dict, epoch_idx: int, batch_idx: int):
        """Write a training step's per-sample scalars (potential,
        log_det_J, sample indices, any extra ``(batch,)`` entry in
        ``aux``) to the TFEP logger. No-op when logging is disabled."""
        logger = self.tfep_logger
        if logger is None:
            return
        tensors = {k: v for k, v in aux.items() if np.ndim(v) == 1}
        logger.save_train_tensors(tensors, epoch_idx=epoch_idx,
                                  batch_idx=batch_idx)

    # ------------------------------------------------------------------ #
    # Evaluation.
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def run_evaluation(self, step_idx: int, batch_size: Optional[int] = None,
                       flow=None) -> Dict[str, np.ndarray]:
        """Evaluate the map over the full dataset and log eval tensors.

        Stores (and returns) per-sample ``potential`` and ``log_det_J``
        (with the sample indices) under ``eval/step-{step_idx}.npz``: the
        work values of the flow as trained for ``step_idx`` steps.

        With the span recorder on (:mod:`tfep_tpu_torch.utils.tracing`),
        each batch is an ``eval.batch`` span (its step id the batch's
        number) holding ``eval.read`` (``get_batch`` and the host
        tensors), ``eval.to_device``, ``eval.forward`` and ``eval.to_host``
        (the copies of the work values back to the host), and the pass
        ends in ``eval.log`` (the concatenation and the logger).
        """
        if flow is None:
            flow = self.flow
        if batch_size is None:
            batch_size = self.batch_size

        collected: Dict[str, list] = {}
        n = len(self.dataset)
        for start in range(0, n, batch_size):
            tracing.set_step(start // batch_size)
            with tracing.span('eval.batch'):
                with tracing.span('eval.read'):
                    indices = np.arange(start, min(start + batch_size, n))
                    batch = self.host_tensors(self.dataset.get_batch(indices))
                with tracing.span('eval.to_device'):
                    batch = self.batch_to_device(batch)
                with tracing.span('eval.forward'):
                    aux = self.training_step_fn(flow, batch)[1]
                with tracing.span('eval.to_host'):
                    for key in _EVAL_KEYS:
                        collected.setdefault(key, []).append(
                            aux[key].detach().cpu().numpy())

        with tracing.span('eval.log'):
            tensors = {k: np.concatenate(v) for k, v in collected.items()}
            logger = self.tfep_logger
            if logger is not None:
                logger.save_eval_tensors(tensors, step_idx=step_idx)
        return tensors
