"""Cartesian MAF map: stacked MAF layers on Cartesian coordinates.

Port of ``tfep_tpu/app/cartesianmaf.py``. Alternating ascending/descending
degree MAF layers over the non-fixed DOFs, optionally PCA-whitened and in
a relative reference frame: an OrientedFlow places the axes atoms on the z
axis / xz plane and a CenteredCentroidFlow pins the origin atom.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from tfep_tpu_torch.app.base import TFEPMapBase
from tfep_tpu_torch.nn.conditioners.made import generate_degrees
from tfep_tpu_torch.nn.flows import (
    MAF, CenteredCentroidFlow, Flow, OrientedFlow, PCAWhitenedFlow,
    SequentialFlow,
)
from tfep_tpu_torch.utils.misc import (
    atom_to_flattened_indices, remove_and_shift_sorted_indices,
)

__all__ = ['CartesianMAFMap']


class CartesianMAFMap(TFEPMapBase):
    """TFEP map built from MAF layers acting on Cartesian coordinates.

    ``n_maf_layers`` masked autoregressive flows with alternating
    ascending/descending degree assignments act on the non-fixed degrees
    of freedom; passing ``origin_atom``/``axes_atoms`` (see
    :class:`~tfep_tpu_torch.app.TFEPMapBase`) additionally maps in a
    relative reference frame, so the learned map commutes with rigid
    motions of the system. All reference-frame wrappers contribute their
    exact log-det-Jacobian volume corrections.

    Accepts every :class:`~tfep_tpu_torch.app.TFEPMapBase` argument plus
    the ones below.

    Parameters
    ----------
    n_maf_layers : int, optional
        Number of stacked MAF layers (default 6).
    flow_kwargs : dict, optional
        Extra arguments forwarded to :meth:`tfep_tpu_torch.nn.flows.MAF.create`
        — e.g. ``transformer``, ``hidden_layers``, ``embedding``. A module
        among them (a transformer instance) is copied for each layer and
        moved to the map's device and dtype, so the layers share no
        tensor and each trains its own.
    remat : bool, optional
        Recompute each MAF layer's activations in the backward pass
        (``torch.utils.checkpoint``).
    pca_whitening : bool, optional
        Run the MAF stack in PCA-whitened coordinates: a
        :class:`~tfep_tpu_torch.nn.flows.PCAWhitenedFlow` is fitted (in
        float64) during setup on up to ``pca_n_frames`` dataset frames as
        the MAF sees them (after fixed-DOF removal and reference-frame
        alignment).
    pca_n_frames : int, optional
        Frame budget for the PCA fit.
    degrees_repeats : int, optional
        Consecutive DOFs sharing each autoregressive degree (default 1 =
        fully autoregressive); the inverse needs ``ceil(n_dofs / k)``
        conditioner passes instead of ``n_dofs``.
    """

    def __init__(self, *args, n_maf_layers: int = 6, flow_kwargs=None,
                 remat: bool = False, pca_whitening: bool = False,
                 pca_n_frames: int = 5120, degrees_repeats: int = 1,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.n_maf_layers = int(n_maf_layers)
        self.flow_kwargs = dict(flow_kwargs or {})
        self.remat = bool(remat)
        self.pca_whitening = bool(pca_whitening)
        self.pca_n_frames = int(pca_n_frames)
        self.degrees_repeats = int(degrees_repeats)
        self.hparams.update(
            n_maf_layers=self.n_maf_layers, flow_kwargs=self.flow_kwargs,
            remat=self.remat, pca_whitening=self.pca_whitening,
            pca_n_frames=self.pca_n_frames,
            degrees_repeats=self.degrees_repeats)

    # ------------------------------------------------------------------ #
    def determine_atom_indices(self):
        """Additionally validates that the origin atom is conditioning."""
        super().determine_atom_indices()
        if self._origin_atom_idx is not None and (
                self._conditioning_atom_indices is None
                or self._origin_atom_idx
                not in self._conditioning_atom_indices):
            raise ValueError(
                'origin_atom is not a conditioning atom. origin_atom affects '
                'the mapping but its position is constrained.')

    def configure_flow(self):
        """Build the alternating-degree MAF stack (plus optional PCA
        whitening and reference-frame wrappers); called once by
        :meth:`setup`."""
        conditioning_indices = self.get_conditioning_indices(
            idx_type='dof', remove_fixed=True, remove_reference=True)

        # n_nonfixed_dofs already excludes the reference-frame constrained
        # DOFs (origin xyz + axis-atom xy + plane-atom y), which the
        # Oriented/CenteredCentroid wrappers remove before the MAF sees them.
        n_flow_features = self.n_nonfixed_dofs
        n_total_features = 3 * self.n_nonfixed_atoms
        origin_atom_idx, axes_atoms_indices = self.get_reference_atoms_indices(
            remove_fixed=True, separate_origin_axes=True)

        generator = torch.Generator().manual_seed(self.seed)
        maf_layers = []
        for layer_idx in range(self.n_maf_layers):
            degrees_in = generate_degrees(
                n_features=n_flow_features,
                conditioning_indices=conditioning_indices,
                order='ascending' if layer_idx % 2 == 0 else 'descending',
                repeats=self.degrees_repeats,
            )
            maf_layers.append(MAF.create(
                generator, degrees_in, device=self.device, dtype=self.dtype,
                **self._layer_kwargs()))
        flow = SequentialFlow.create(*maf_layers, remat=self.remat,
                                     device=self.device)

        if self.pca_whitening:
            flow = PCAWhitenedFlow.create(
                flow, self._collect_maf_inputs(origin_atom_idx,
                                               axes_atoms_indices),
                device=self.device, dtype=self.dtype)

        return self._wrap_reference_frame(flow, origin_atom_idx,
                                          axes_atoms_indices,
                                          n_total_features)

    def _layer_kwargs(self):
        """One layer's ``flow_kwargs``: every module in them copied, on the
        map's device and dtype. The JAX trainer gives each layer its own
        copy of a leaf that the layers share; a torch module shared by the
        layers would instead train once, on the sum of their gradients."""
        return {name: copy.deepcopy(value).to(device=self.device,
                                              dtype=self.dtype)
                if isinstance(value, nn.Module) else value
                for name, value in self.flow_kwargs.items()}

    def _wrap_reference_frame(self, flow, origin_atom_idx,
                              axes_atoms_indices, n_total_features,
                              dtype=None):
        """Wrap ``flow`` in the Oriented/CenteredCentroid reference stack."""
        dtype = self.dtype if dtype is None else dtype
        # If the removed origin atom sits before an axes atom, the axes-atom
        # index shifts down in the origin-removed frame seen by OrientedFlow.
        if origin_atom_idx is not None and axes_atoms_indices is not None:
            axes_atoms_indices = np.where(
                origin_atom_idx < axes_atoms_indices,
                axes_atoms_indices - 1, axes_atoms_indices)

        if axes_atoms_indices is not None:
            n_oriented_features = (n_total_features - 3
                                   if origin_atom_idx is not None
                                   else n_total_features)
            flow = OrientedFlow.create(
                flow, n_features=n_oriented_features,
                axis_point_idx=int(axes_atoms_indices[0]),
                plane_point_idx=int(axes_atoms_indices[1]),
                axis='z', plane='xz', device=self.device, dtype=dtype)

        if origin_atom_idx is not None:
            flow = CenteredCentroidFlow.create(
                flow, space_dimension=3, n_features=n_total_features,
                subset_point_indices=[int(origin_atom_idx)],
                device=self.device, dtype=dtype)

        return flow

    def _collect_maf_inputs(self, origin_atom_idx, axes_atoms_indices
                            ) -> torch.Tensor:
        """One dataset pass collecting, in float64, the coordinates the MAF
        stack sees (after fixed-DOF removal + reference-frame alignment),
        for the PCA whitening estimate."""
        capture = _Capture()
        probe = self._wrap_reference_frame(
            capture, origin_atom_idx, axes_atoms_indices,
            3 * self.n_nonfixed_atoms, dtype=torch.float64)
        probe = self.create_partial_flow(probe)

        n = len(self.dataset)
        take = min(n, self.pca_n_frames)
        sample_indices = np.unique(
            np.linspace(0, n - 1, take).round().astype(np.int64))
        with torch.no_grad():
            for start in range(0, len(sample_indices), 1024):
                batch = self.dataset.get_batch(
                    sample_indices[start:start + 1024])
                probe(torch.as_tensor(batch['positions'],
                                      dtype=torch.float64,
                                      device=self.device))

        samples = torch.cat(capture.captured)
        if samples.shape[0] <= samples.shape[1]:
            raise ValueError(
                f'PCA whitening needs more frames ({samples.shape[0]}) than '
                f'flow features ({samples.shape[1]}); pass a longer '
                'trajectory or disable pca_whitening.')
        return samples

    # ------------------------------------------------------------------ #
    def get_mapped_indices(self, idx_type: str = 'atom',
                           remove_fixed: bool = True,
                           remove_reference: bool = False) -> np.ndarray:
        indices = super().get_mapped_indices(idx_type=idx_type,
                                             remove_fixed=remove_fixed)
        if remove_reference:
            indices = self._remove_reference_indices(
                indices, idx_type=idx_type, remove_fixed=remove_fixed)
        return indices

    def get_conditioning_indices(self, idx_type: str = 'atom',
                                 remove_fixed: bool = True,
                                 remove_reference: bool = False):
        indices = super().get_conditioning_indices(idx_type=idx_type,
                                                   remove_fixed=remove_fixed)
        if remove_reference and indices is not None:
            indices = self._remove_reference_indices(
                indices, idx_type=idx_type, remove_fixed=remove_fixed)
        return indices

    def _remove_reference_indices(self, indices, idx_type: str,
                                  remove_fixed: bool):
        """Shift out the reference-frame constrained atom/DOF indices: the
        origin atom loses all 3 DOFs, the axis atom its x,y, and the plane
        atom its y (axis='z', plane='xz')."""
        removed = self.get_reference_atoms_indices(remove_fixed=remove_fixed)
        if removed is None:
            return indices

        if idx_type == 'dof':
            removed_dofs = []
            has_origin = len(removed) in (1, 3)
            if has_origin:
                removed_dofs.append(atom_to_flattened_indices(removed[:1]))
            has_axes = len(removed) > 1
            if has_axes:
                # axes atom 0 on the z axis: x,y constrained.
                removed_dofs.append(
                    atom_to_flattened_indices(removed[-2:-1])[:2])
                # axes atom 1 on the xz plane: y constrained.
                removed_dofs.append(
                    atom_to_flattened_indices(removed[-1:])[1:2])
            removed = np.concatenate(removed_dofs)
        else:
            removed = np.asarray(removed).reshape(-1)

        removed = np.sort(removed)
        return remove_and_shift_sorted_indices(indices, removed)


class _Capture(Flow):
    """The identity, keeping what it sees: the frames as the MAF stack
    sees them, for the PCA fit."""

    def __init__(self):
        super().__init__()
        self.captured = []

    def forward(self, x):
        self.captured.append(x.detach())
        return x, torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
