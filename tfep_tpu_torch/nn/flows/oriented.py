"""Oriented flow: constrains the rotational degrees of freedom (3D).

Port of ``tfep_tpu/nn/flows/oriented.py``. Batch-rotates each
configuration so a chosen axis point lies on a coordinate axis and a plane
point on a coordinate plane, zeroes the 3 constrained DOFs (``index_fill``
on a new tensor), runs the wrapped flow on the rest, and optionally rotates
back, adding the frame volume element to ``log_det_J``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tfep_tpu_torch.nn.flows.partial import PartialFlow
from tfep_tpu_torch.utils.geometry import (
    batchwise_rotate, get_axis_from_name, reference_frame_rotation_matrix,
)

__all__ = ['OrientedFlow']


class OrientedFlow(PartialFlow):
    """Wraps a flow, fixing the frame orientation via two reference points.

    On each pass it:

    1. builds a per-sample rotation that puts ``axis_point_idx`` on the
       chosen coordinate ``axis`` and ``plane_point_idx`` on the chosen
       coordinate ``plane`` (a batched ``(batch, 3, 3)`` product);
    2. zeroes the three constrained coordinates (two off-axis for the axis
       point, one off-plane for the plane point) and runs the wrapped flow
       on the remaining DOFs through the :class:`PartialFlow` machinery;
    3. optionally (``rotate_back=True``) applies the inverse rotation so
       input and output share a frame, adding the exact frame volume
       element to ``log_det_J`` (:meth:`_frame_log_weight`; without it the
       log-det is biased whenever the wrapped flow moves the radial frame
       DOFs).

    Build with :meth:`create`, which takes these arguments and ``device``.

    Parameters
    ----------
    flow : Flow
        The wrapped flow; receives ``n_features - 3`` features.
    n_features : int
        Total flattened DOF count (``3 * n_atoms``).
    axis_point_idx, plane_point_idx : int, optional
        Atoms constrained to the axis and plane respectively. Default:
        atoms 0 and 1 (whichever is not taken by the other).
    axis : {'x', 'y', 'z'}, optional
        Coordinate axis for the axis point. Default ``'x'``.
    plane : {'xy', 'yz', 'xz'}, optional
        Coordinate plane for the plane point; must contain ``axis``.
        Default ``'xy'``.
    round_off_imprecisions : bool, optional
        Zero the constrained DOFs after rotating (default ``True``).
    rotate_back : bool, optional
        Restore the input frame on output (default ``True``); required
        for :meth:`inverse`.
    return_partial : bool, optional
        Return only propagated features; incompatible with
        ``rotate_back=True``.
    dtype : torch.dtype, optional
        Type of the frame buffers (cast to the input's type on use).

    Raises
    ------
    ValueError
        If the two reference points coincide, ``axis`` is not in
        ``plane``, or ``return_partial`` conflicts with ``rotate_back``.

    Notes
    -----
    Buffers, named as the JAX module's leaves: ``axis_vec``,
    ``plane_axis_vec`` and ``plane_normal_vec`` (the orthonormal frame),
    besides :class:`PartialFlow`'s.
    """

    def __init__(self, flow, n_features: int,
                 axis_point_idx: Optional[int] = None,
                 plane_point_idx: Optional[int] = None,
                 axis: str = 'x', plane: str = 'xy',
                 round_off_imprecisions: bool = True,
                 rotate_back: bool = True,
                 return_partial: bool = False,
                 dtype: torch.dtype = torch.float32):
        if return_partial and rotate_back:
            raise ValueError("'return_partial=True' is supported only if "
                             "'rotate_back=False'")

        # Automatic selection of the reference points.
        if axis_point_idx is None:
            axis_point_idx = 0 if plane_point_idx != 0 else 1
        if plane_point_idx is None:
            plane_point_idx = 0 if axis_point_idx != 0 else 1
        if axis_point_idx == plane_point_idx:
            raise ValueError("'axis_point_idx' and 'plane_point_idx' must be "
                             'different.')
        if axis not in plane:
            raise ValueError(
                f"To constrain 'plane_point_idx' to stay on plane {plane} "
                "'axis_point_idx' must be constrained on an axis on the same "
                'plane.')

        axis_vector = get_axis_from_name(axis).numpy()
        plane_axis_vector = [get_axis_from_name(n).numpy() for n in 'xyz'
                             if (n not in axis) and (n in plane)][0]
        plane_normal_vector = np.cross(axis_vector, plane_axis_vector)

        # DOFs constrained to zero: off-axis coordinates of the axis point
        # and the off-plane coordinate of the plane point.
        axis_dofs = 3 * axis_point_idx + np.nonzero(axis_vector == 0.0)[0]
        plane_dofs = 3 * plane_point_idx + np.nonzero(
            plane_normal_vector != 0.0)[0]
        super().__init__(flow, np.concatenate([axis_dofs, plane_dofs]),
                         n_features=n_features,
                         return_partial=return_partial)

        for name, vector in (('axis_vec', axis_vector),
                             ('plane_axis_vec', plane_axis_vector),
                             ('plane_normal_vec', plane_normal_vector)):
            self.register_buffer(name, torch.as_tensor(vector, dtype=dtype))
        self.axis_point_idx = int(axis_point_idx)
        self.plane_point_idx = int(plane_point_idx)
        self.axis_dim = int(np.argmax(np.abs(axis_vector)))
        self.plane_axis_dim = int(np.argmax(np.abs(plane_axis_vector)))
        self.round_off_imprecisions = bool(round_off_imprecisions)
        self.rotate_back = bool(rotate_back)

    def forward(self, x):
        """Map ``x`` of shape ``(batch, 3*n_atoms)`` forward.

        Returns ``(y, log_det_J, *extras)``; with ``rotate_back=True`` the
        log-det includes the exact frame volume-element correction.
        """
        return self._transform(x, inverse=False)

    def inverse(self, y):
        """Invert :meth:`forward`; requires ``rotate_back=True``."""
        if not self.rotate_back:
            raise ValueError(
                "The inverse of OrientedFlow can be computed only if "
                "'rotate_back' is set to True during both the forward and "
                'inverse transformations.')
        return self._transform(y, inverse=True)

    def _frame_log_weight(self, flat):
        """log of the frame volume element at a constrained configuration.

        With the frame fixed, the axis point's 3 coordinates reduce to one
        signed radial coordinate (its 2 angles parametrize the global
        rotation applied to every atom: weight r^2), and the plane point's
        to 2 in-plane coordinates (its azimuth about the axis is the third
        rotation angle: weight = |off-axis component|). When the wrapped
        flow changes these radial DOFs the weights do not cancel between
        the rotation and its inverse.
        """
        a = flat[:, 3 * self.axis_point_idx + self.axis_dim]
        p = flat[:, 3 * self.plane_point_idx + self.plane_axis_dim]
        return 2.0 * torch.log(torch.abs(a)) + torch.log(torch.abs(p))

    def _transform(self, x, inverse: bool):
        batch = x.shape[0]
        x_atoms = x.reshape(batch, -1, 3)
        dtype = x.dtype

        rotation_matrices = reference_frame_rotation_matrix(
            axis_atom_positions=x_atoms[:, self.axis_point_idx],
            plane_atom_positions=x_atoms[:, self.plane_point_idx],
            axis=self.axis_vec.to(dtype),
            plane_axis=self.plane_axis_vec.to(dtype),
            plane_normal=self.plane_normal_vec.to(dtype),
            project_on_positive_axis=False,
        )

        x_flat = batchwise_rotate(x_atoms, rotation_matrices).reshape(
            batch, -1)
        if self.round_off_imprecisions:
            x_flat = x_flat.index_fill(1, self.fixed_indices_buf, 0.0)

        out = self._pass(x_flat, inverse=inverse)
        if self.return_partial:
            return out
        y, log_det_J = out[0], out[1]

        if self.rotate_back:
            # Exact frame volume element (cancels when the wrapped flow
            # leaves the radial frame DOFs unchanged).
            log_det_J = (log_det_J - self._frame_log_weight(x_flat)
                         + self._frame_log_weight(y))
            y = batchwise_rotate(y.reshape(batch, -1, 3), rotation_matrices,
                                 inverse=True).reshape(batch, -1)

        return (y, log_det_J, *out[2:])
