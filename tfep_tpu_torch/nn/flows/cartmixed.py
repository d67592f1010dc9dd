"""Cartesian <-> mixed (internal + Cartesian) coordinate conversion flow.

Port of ``tfep_tpu/nn/flows/cartmixed.py``. Wraps a flow so it runs in
mixed coordinates: Z-matrix atoms become (bond, angle, torsion) triplets
while Cartesian atoms are expressed in a relative reference frame (origin
atom at the origin, axis atom on the positive x axis, plane atom on the xy
plane with its position in polar coordinates d02/a102). Constant
roto-translational DOFs are removed from the flow's input, or kept as
always-zero "reference" DOFs. All index bookkeeping happens on the host
when the flow is built, and the placement schedule is built once.

Layout of the mixed coordinates (n_ic = number of Z-matrix rows):
``[bonds (n_ic), angles (n_ic), torsions (n_ic), d01, d02, a102,
cartesian DOFs (with constant reference DOFs last)]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tfep_tpu_torch.device import StaticIndices, resolve_device
from tfep_tpu_torch.nn.flows.flow import Flow
from tfep_tpu_torch.ops.zmatrix import (
    PlacementSchedule, cartesian_to_internal, internal_to_cartesian,
    normalize_torsions_fn, unnormalize_torsions_fn,
)
from tfep_tpu_torch.utils.geometry import (
    batchwise_rotate, cartesian_to_polar, polar_to_cartesian,
    reference_frame_rotation_matrix,
)
from tfep_tpu_torch.utils import tracing
from tfep_tpu_torch.utils.misc import remove_and_shift_sorted_indices

__all__ = ['CartesianToMixedFlow']


class CartesianToMixedFlow(Flow):
    """Convert to mixed coordinates, run the wrapped flow, convert back.

    The workhorse of :class:`~tfep_tpu_torch.app.MixedMAFMap`: Z-matrix
    atoms as (bond, angle, torsion) internal coordinates, the other atoms
    Cartesian in a relative frame defined by three reference atoms. The
    round trip (Cartesian -> mixed -> flow -> Cartesian) is a bijection
    whose log-det sums the conversion Jacobians (analytic, with the
    global-frame volume elements) and the wrapped flow's. Build with
    :meth:`create`.

    Buffers, with the JAX package's names: ``z_matrix`` ``(n_ic, 4)``
    rows ``(atom, bond_ref, angle_ref, torsion_ref)``;
    ``cartesian_atom_indices`` (the three reference atoms, origin, axis and
    plane, last); ``cartesian_keep_indices`` (the flattened relative-frame
    Cartesian DOFs the flow sees, kept-constant reference DOFs last); and
    ``placement_schedule`` (:class:`~tfep_tpu_torch.ops.zmatrix.
    PlacementSchedule`).
    """

    def __init__(self, flow, z_matrix, cartesian_atom_indices,
                 cartesian_keep_indices, remove_ref_rototranslation,
                 n_atoms: int, device=None):
        super().__init__()
        device = resolve_device(device)
        self.flow = flow

        def index(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                   device=device)

        self.register_buffer('z_matrix', index(z_matrix))
        self.register_buffer('cartesian_atom_indices',
                             index(cartesian_atom_indices))
        self.register_buffer('cartesian_keep_indices',
                             index(cartesian_keep_indices))
        self.placement_schedule = PlacementSchedule(z_matrix, n_atoms,
                                                    device=device)
        # The relative-frame Cartesian DOFs the frame atoms' polar and
        # radial coordinates fill: the axis atom's x, the plane atom's x, y.
        n_cart_dofs = 3 * len(np.asarray(cartesian_atom_indices))
        self.columns = StaticIndices(device, frame_dofs=[
            n_cart_dofs - 6, n_cart_dofs - 3, n_cart_dofs - 2])
        self.remove_ref_rototranslation = tuple(
            bool(b) for b in remove_ref_rototranslation)
        self.n_atoms = int(n_atoms)

    @classmethod
    def create(cls, flow, cartesian_atom_indices: Sequence[int], z_matrix,
               reference_atom_indices: Sequence[int],
               remove_ref_rototranslation: Sequence[bool],
               device=None) -> 'CartesianToMixedFlow':
        """Build the conversion flow; all bookkeeping happens here.

        Parameters
        ----------
        flow : Flow or None
            The wrapped flow; it must accept ``n_dofs_out`` features laid
            out as the module docstring says. ``None`` builds the
            conversion alone (set ``flow`` later).
        cartesian_atom_indices : sequence of int
            Sorted indices (fixed atoms removed) of the atoms kept
            Cartesian, including the three reference atoms.
        z_matrix : array_like
            ``(n_ic, 4)`` integer Z-matrix in the same index space.
        reference_atom_indices : sequence of int
            The (origin, axis, plane) atoms defining the relative frame.
        remove_ref_rototranslation : sequence of bool
            Length 3; whether each reference atom's constant DOFs are
            removed from the flow's input (or kept as zero features).
        device : str or torch.device, optional
            Defaults to ``cuda``; raises without a card.
        """
        z_matrix = np.asarray(z_matrix, dtype=np.int64).reshape(-1, 4)
        cartesian_atom_indices = np.asarray(cartesian_atom_indices,
                                            dtype=np.int64)
        reference_atom_indices = np.asarray(reference_atom_indices,
                                            dtype=np.int64)

        # Move the reference atoms to the end (they are always Cartesian).
        cartesian_atom_indices = remove_and_shift_sorted_indices(
            cartesian_atom_indices,
            removed_indices=np.sort(reference_atom_indices),
            remove=True, shift=False)
        cartesian_atom_indices = np.concatenate(
            [cartesian_atom_indices, reference_atom_indices])

        n_atoms = len(cartesian_atom_indices) + len(z_matrix)

        # The relative-frame Cartesian DOFs to keep: the 9 reference-atom
        # DOFs are removed outright or re-appended last as kept constants.
        n_cart_dofs = 3 * len(cartesian_atom_indices)
        remove = tuple(bool(b) for b in remove_ref_rototranslation)
        keep = np.ones(n_cart_dofs, dtype=bool)
        keep[-9:] = False
        ref_kept = []
        if not remove[0]:
            # Origin atom: all three translations are kept constants.
            ref_kept.extend([n_cart_dofs - 9, n_cart_dofs - 8,
                             n_cart_dofs - 7])
        if not remove[1]:
            # Axis atom: x is d01; y, z are constant zeros.
            ref_kept.extend([n_cart_dofs - 5, n_cart_dofs - 4])
        if not remove[2]:
            # Plane atom: x, y are polar d02/a102; z is a constant zero.
            ref_kept.append(n_cart_dofs - 1)
        keep_indices = np.concatenate(
            [np.nonzero(keep)[0], np.asarray(ref_kept, dtype=np.int64)])

        module = cls(flow, z_matrix, cartesian_atom_indices, keep_indices,
                     remove, int(n_atoms), device=device)
        return module.to(resolve_device(device))

    # ------------------------------------------------------------------ #
    # Introspection (host side).
    # ------------------------------------------------------------------ #
    @property
    def n_ic_atoms(self) -> int:
        return int(self.z_matrix.shape[0])

    @property
    def n_cartesian_atoms(self) -> int:
        return int(self.cartesian_atom_indices.shape[0])

    @property
    def n_reference_dofs_kept(self) -> int:
        return sum(n for n, removed in zip(
            (3, 2, 1), self.remove_ref_rototranslation) if not removed)

    @property
    def n_dofs_out(self) -> int:
        return 3 * self.n_ic_atoms + 3 + int(
            self.cartesian_keep_indices.shape[0])

    def n_parameters(self) -> int:
        return self.flow.n_parameters()

    def get_dof_indices_by_type(self, conditioning_atom_indices=None
                                ) -> Dict[str, Optional[np.ndarray]]:
        """Mixed-coordinate DOF indices grouped by type.

        Keys: distances (with d01/d02), angles (with a102), torsions,
        d01, d02, a102, cartesians, reference (kept-constant
        roto-translational DOFs), conditioning (``None`` when empty).
        """
        n_ic = self.n_ic_atoms
        d01 = np.asarray([3 * n_ic])
        d02 = np.asarray([3 * n_ic + 1])
        a102 = np.asarray([3 * n_ic + 2])
        cart_start = 3 * n_ic + 3
        n_cart = int(self.cartesian_keep_indices.shape[0])
        cartesians = np.arange(cart_start, cart_start + n_cart)

        n_ref = self.n_reference_dofs_kept
        if n_ref > 0:
            reference = cartesians[-n_ref:]
            cartesians = cartesians[:-n_ref]
        else:
            reference = np.asarray([], dtype=np.int64)

        out = {
            'distances': np.concatenate([np.arange(n_ic), d01, d02]),
            'angles': np.concatenate([np.arange(n_ic, 2 * n_ic), a102]),
            'torsions': np.arange(2 * n_ic, 3 * n_ic),
            'd01': d01, 'd02': d02, 'a102': a102,
            'cartesians': cartesians,
            'reference': reference,
            'conditioning': None,
        }
        if conditioning_atom_indices is None:
            return out

        cond_set = set(np.asarray(conditioning_atom_indices).tolist())
        cart_atoms = self.cartesian_atom_indices.cpu().numpy()
        # Conditioning atoms are always Cartesian: their DOF positions among
        # the non-reference Cartesian atoms.
        positions = [i for i, v in enumerate(cart_atoms[:-3].tolist())
                     if v in cond_set]
        dof_positions = (np.asarray(positions, dtype=np.int64)[:, None] * 3
                         + np.arange(3)).reshape(-1)
        cond = [out['cartesians'][dof_positions]] if len(positions) else []

        axis_atom, plane_atom = cart_atoms[-2:].tolist()
        if axis_atom in cond_set:
            cond.append(d01)
        if plane_atom in cond_set:
            cond.append(d02)
            cond.append(a102)
        if cond:
            out['conditioning'] = np.sort(np.concatenate(cond))
        return out

    # ------------------------------------------------------------------ #
    # Conversion.
    # ------------------------------------------------------------------ #
    def forward(self, x):
        """Map ``(batch, 3*n_atoms)`` Cartesians through the wrapped flow.

        Returns ``(y, log_det_J, *extras)`` in Cartesian coordinates; the
        log-det includes both conversion Jacobians and the flow's.
        """
        return self._pass(x, inverse=False)

    def inverse(self, y):
        """Invert :meth:`forward` (the wrapped flow's inverse between the
        same coordinate conversions)."""
        return self._pass(y, inverse=True)

    def _pass(self, x, inverse: bool):
        # The spans (while the recorder is on) hold the whole conversion
        # each way: the Z-matrix and the reference frame.
        y, ldj, origin_position, rotation = tracing.layer(
            'zmatrix.to_internal', self.cartesian_to_mixed, x)
        out = self.flow.inverse(y) if inverse else self.flow.forward(y)
        ldj = ldj + out[1]
        x_out, inv_ldj = tracing.layer(
            'zmatrix.to_cartesian', self.mixed_to_cartesian, out[0],
            origin_position, rotation)
        return (x_out, ldj + inv_ldj, *out[2:])

    def cartesian_to_mixed(self, x):
        """``(batch, n_atoms*3)`` -> the mixed coordinates, their log-det,
        and the frame (origin, rotation) for the way back."""
        batch = x.shape[0]
        x_atoms = x.reshape(batch, self.n_atoms, 3)

        bonds, angles, torsions, ldj = cartesian_to_internal(
            x_atoms, self.z_matrix, normalize_angles=True)

        x_cart = x_atoms.index_select(1, self.cartesian_atom_indices)

        # Relative frame: origin atom at the origin, axis atom on +x (the
        # spline keeps d01 positive, so the projection on the positive axis
        # stays invertible), plane atom on the xy plane.
        origin_position = x_cart[:, -3]
        x_cart = x_cart - origin_position[:, None, :]
        # The x and y axes made on the device, not copied from the host.
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        rotation = reference_frame_rotation_matrix(
            axis_atom_positions=x_cart[:, -2],
            plane_atom_positions=x_cart[:, -1],
            axis=eye[0], plane_axis=eye[1], project_on_positive_axis=True)
        x_cart = batchwise_rotate(x_cart, rotation)

        d01 = x_cart[:, -2, 0]
        d02, a102 = cartesian_to_polar(x_cart[:, -1, 0], x_cart[:, -1, 1])
        # Global-frame volume element: the axis atom carries d01^2 (its two
        # angular DOFs are the frame rotation applied to every atom), the
        # plane atom d02^2 sin(a102) (its azimuth about the axis is the
        # third frame angle).
        ldj = ldj - 2.0 * torch.log(d01) - 2.0 * torch.log(d02) \
            - torch.log(torch.abs(torch.sin(a102)))
        a102n, tor_ldj = normalize_torsions_fn(a102[:, None])
        ldj = ldj + tor_ldj

        x_cart_kept = x_cart.reshape(batch, -1).index_select(
            1, self.cartesian_keep_indices)

        y = torch.cat([bonds, angles, torsions, d01[:, None], d02[:, None],
                       a102n, x_cart_kept], dim=-1)
        return y, ldj, origin_position, rotation

    def mixed_to_cartesian(self, y, origin_position, rotation):
        """Inverse of :meth:`cartesian_to_mixed` given the stored frame."""
        batch = y.shape[0]
        n_ic = self.n_ic_atoms

        bonds = y[:, :n_ic]
        angles = y[:, n_ic:2 * n_ic]
        torsions = y[:, 2 * n_ic:3 * n_ic]
        d01 = y[:, 3 * n_ic]
        d02 = y[:, 3 * n_ic + 1]
        y_cart_kept = y[:, 3 * n_ic + 3:]

        a102u, ldj = unnormalize_torsions_fn(y[:, 3 * n_ic + 2:3 * n_ic + 3])
        a102 = a102u[:, 0]
        plane_x, plane_y = polar_to_cartesian(d02, a102)
        # Inverse of the global-frame volume element (cartesian_to_mixed).
        ldj = ldj + 2.0 * torch.log(d01) + 2.0 * torch.log(d02) \
            + torch.log(torch.abs(torch.sin(a102)))

        # The full relative-frame Cartesian block, out of place: the kept
        # DOFs, then the axis atom's x and the plane atom's x and y.
        n_cart_dofs = 3 * self.n_cartesian_atoms
        cart_full = y.new_zeros((batch, n_cart_dofs)).index_copy(
            1, self.cartesian_keep_indices, y_cart_kept)
        cart_full = cart_full.index_copy(
            1, self.columns['frame_dofs'],
            torch.stack([d01, plane_x, plane_y], dim=1))

        cart_atoms = batchwise_rotate(cart_full.reshape(batch, -1, 3),
                                      rotation, inverse=True)
        cart_atoms = cart_atoms + origin_position[:, None, :]

        # The Cartesian atoms into the full positions, then the IC atoms.
        positions_init = y.new_zeros((batch, self.n_atoms, 3)).index_copy(
            1, self.cartesian_atom_indices, cart_atoms)
        positions, rec_ldj = internal_to_cartesian(
            bonds, angles, torsions, positions_init, self.z_matrix,
            normalize_angles=True, schedule=self.placement_schedule)
        return positions.reshape(batch, -1), ldj + rec_ldj
