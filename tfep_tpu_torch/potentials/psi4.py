"""Psi4 potential: ab initio QM energies/forces.

A copy of ``tfep_tpu/potentials/psi4.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

Engine units hartree/bohr. Supports per-sample SCF restart files — either
positional per-batch lists (``write_orbitals``/``restart_file``, reference
parity) or, beyond the reference, a ``restart_dir`` whose files are keyed
by *trajectory sample index* so each frame's wavefunction warm-starts its
next evaluation even across shuffled epochs — and the
``on_unconverged='raise'|'nan'`` failure policy. Because Psi4 molecules are
not picklable, process pools need a pool ``initializer`` creating the
molecule per worker (reference note:
upstream tfep/potentials/psi4.py:369-375). Reference behaviors:
psi4.py:34-955. Force matching (differentiating through
:meth:`Psi4Potential.forces`) is supported via the generic
finite-difference vector-Hessian product of
:func:`tfep_tpu_torch.potentials.bridge.make_callback_forces` — the
counterpart of the reference's double-backprop Function (psi4.py:641-766).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np

from tfep_tpu_torch.potentials.engine import EnginePotential
from tfep_tpu_torch.units import Quantity, ureg

__all__ = ['Psi4Potential', 'psi4_potential_energy',
           'create_psi4_molecule', 'configure_psi4']

try:
    import psi4  # noqa: F401
    PSI4_INSTALLED = True
except ImportError:
    PSI4_INSTALLED = False


def create_psi4_molecule(positions, fix_com: bool = True,
                         fix_orientation: bool = True, **kwargs):
    """Create a ``psi4.core.Molecule`` from positions with units.

    Unlike Psi4's defaults, COM/orientation are fixed so forces and final
    positions aren't silently re-referenced (reference rationale:
    psi4.py:45-50). ``positions`` is a :class:`tfep_tpu_torch.units.Quantity`
    of shape (n_atoms, 3); pass ``elem``/``elez``/``elbl`` via kwargs.
    """
    import psi4
    if isinstance(positions, Quantity):
        magnitude = positions.magnitude
        units = positions.units.name or 'bohr'
    else:
        magnitude = np.asarray(positions)
        units = 'bohr'
    return psi4.core.Molecule.from_arrays(
        geom=magnitude, units=units, fix_com=fix_com,
        fix_orientation=fix_orientation, **kwargs)


def configure_psi4(memory=None, n_threads=None, psi4_output_file_path=None,
                   psi4_scratch_dir_path=None, active_molecule=None,
                   global_options=None):
    """Set common Psi4 global configuration (memory, threads, scratch, ...)."""
    import psi4

    if memory is not None:
        psi4.set_memory(memory)
    if n_threads is not None:
        psi4.core.set_num_threads(n_threads)
    if psi4_output_file_path == 'quiet':
        psi4.core.be_quiet()
    elif psi4_output_file_path is not None:
        psi4.core.set_output_file(psi4_output_file_path)
    if psi4_scratch_dir_path is not None:
        psi4.core.IOManager.shared_object().set_default_path(
            psi4_scratch_dir_path)
    if active_molecule is not None:
        psi4.core.set_active_molecule(active_molecule)
    if global_options is not None:
        psi4.set_options(global_options)


class Psi4Potential(EnginePotential):
    """Differentiable potential energy via Psi4 (e.g. ``name='mp2'``).

    Quantum-chemistry target potential through the ``psi4`` Python
    bindings (reference: upstream tfep/potentials/psi4.py:147-336).
    Native units hartree/bohr.

    Parameters
    ----------
    name : str
        The Psi4 method passed to ``psi4.energy``/``psi4.gradient``
        (e.g. ``'mp2'``, ``'scf'``).
    molecule : psi4.core.Molecule, optional
        The molecule whose geometry each batch sample overwrites; the
        currently activated molecule when ``None``.
    positions_unit, energy_unit : Unit, optional
        User-facing units (defaults bohr / hartree).
    write_orbitals : bool, str, or sequence of str, optional
        Save converged wavefunctions (optionally one path per batch
        sample) for later restarts.
    restart_file : str or sequence of str, optional
        Wavefunction guess file(s) for this batch.
    restart_dir : str, optional
        Directory keying one restart file per *trajectory sample index*,
        so SCF warm starts follow frames across shuffled epochs; mutually
        exclusive with ``write_orbitals``/``restart_file`` and requires
        per-sample keys (the app layer passes them automatically).
    parallelization_strategy : ParallelizationStrategy, optional
        Per-sample fan-out; psi4 handles are not picklable, so process
        pools need a pool initializer (reference note: psi4.py:369-375).
    precompute_gradient : bool, optional
        Converge the wavefunction once per sample, computing the gradient
        alongside the energy.
    on_unconverged : {'raise', 'nan'}, optional
        SCF-failure policy: raise, or return NaN for the sample (pair
        with ``ignore_nan`` in the loss).
    **psi4_kwargs
        Extra keyword arguments forwarded to ``psi4.energy``/``psi4.gradient``.
    """

    DEFAULT_ENERGY_UNIT = 'hartree'
    DEFAULT_POSITIONS_UNIT = 'bohr'
    ENGINE_ENERGY_UNIT = 'hartree'
    ENGINE_POSITIONS_UNIT = 'bohr'

    def __init__(self, name: str, molecule=None,
                 positions_unit=None, energy_unit=None,
                 write_orbitals: Union[bool, str, Sequence[str]] = False,
                 restart_file: Union[None, str, Sequence[str]] = None,
                 restart_dir: Optional[str] = None,
                 parallelization_strategy=None,
                 precompute_gradient: bool = True,
                 on_unconverged: str = 'raise',
                 **psi4_kwargs):
        """``name`` is the Psi4 method; ``molecule`` the active Molecule
        (when None, the currently active one is used). ``write_orbitals`` /
        ``restart_file`` may be per-sample path lists. ``restart_dir``
        (mutually exclusive with both) keys one restart file per
        *trajectory sample index* inside that directory, so warm starts
        follow frames across shuffled epochs; it requires the caller to
        pass ``sample_keys`` (the app layer does this automatically,
        see :attr:`uses_sample_keys`)."""
        if not PSI4_INSTALLED:
            raise ImportError(
                'Psi4Potential requires the psi4 package to be installed.')
        if on_unconverged not in ('raise', 'nan'):
            raise ValueError("on_unconverged must be 'raise' or 'nan'.")
        if restart_dir is not None and (
                write_orbitals is not False or restart_file is not None):
            raise ValueError('restart_dir is mutually exclusive with '
                             'write_orbitals/restart_file.')
        super().__init__(positions_unit=positions_unit,
                         energy_unit=energy_unit,
                         parallelization_strategy=parallelization_strategy,
                         precompute_gradient=precompute_gradient)
        self.name = name
        self.molecule = molecule
        self.write_orbitals = write_orbitals
        self.restart_file = restart_file
        self.restart_dir = restart_dir
        self.on_unconverged = on_unconverged
        self.psi4_kwargs = psi4_kwargs
        if restart_dir is not None:
            self.uses_sample_keys = True
            os.makedirs(restart_dir, exist_ok=True)

    def _per_sample(self, option, i, n_samples):
        if isinstance(option, (list, tuple)):
            if len(option) != n_samples:
                raise ValueError(
                    'Per-sample option lists must match the batch size.')
            return option[i]
        return option

    def _restart_options(self, i, n_samples):
        """Resolve (write_orbitals, restart_file) for batch sample ``i``."""
        if self.restart_dir is None:
            return (self._per_sample(self.write_orbitals, i, n_samples),
                    self._per_sample(self.restart_file, i, n_samples))
        keys = self._current_sample_keys
        if keys is None:
            raise ValueError(
                'restart_dir requires per-sample keys; pass sample_keys '
                '(e.g. trajectory sample indices) when calling the '
                'potential.')
        path = os.path.join(self.restart_dir, f'sample-{int(keys[i])}.npy')
        # Read the wavefunction back only once the frame has one.
        return path, (path if os.path.isfile(path) else None)

    def _compute_batch(self, positions: np.ndarray,
                       cell: Optional[np.ndarray], compute_forces: bool):
        n_samples = positions.shape[0]
        task_args = []
        for i in range(n_samples):
            write_orbitals, restart_file = self._restart_options(i, n_samples)
            task_args.append((
                self.name, self.molecule, positions[i].reshape(-1, 3),
                compute_forces, write_orbitals, restart_file,
                self.on_unconverged, self.psi4_kwargs,
            ))
        results = self.parallelization_strategy.run(_run_psi4_task, task_args)
        energies = np.asarray([r[0] for r in results])
        forces = (np.stack([r[1].reshape(-1) for r in results])
                  if compute_forces else None)
        return energies, forces


def _run_psi4_task(name, molecule, positions, return_forces, write_orbitals,
                   restart_file, on_unconverged, psi4_kwargs):
    """One Psi4 single point (bohr in, hartree out). Pool workers must set
    the active molecule via an initializer (molecules don't pickle)."""
    import psi4

    if molecule is not None:
        psi4.core.set_active_molecule(molecule)
        active = molecule
    else:
        active = psi4.core.get_active_molecule()

    # Update the geometry (bohr).
    active.set_geometry(psi4.core.Matrix.from_array(positions))
    active.update_geometry()

    kwargs = dict(psi4_kwargs)
    if write_orbitals:
        kwargs['write_orbitals'] = write_orbitals
    if restart_file is not None:
        kwargs['restart_file'] = restart_file

    try:
        if return_forces:
            gradient, wfn = psi4.gradient(name, return_wfn=True, **kwargs)
            energy = wfn.energy()
            forces = -np.asarray(gradient)
            return energy, forces
        energy = psi4.energy(name, **kwargs)
        return energy, None
    except psi4.SCFConvergenceError:
        if on_unconverged == 'nan':
            zeros = np.zeros_like(positions)
            return (np.nan, zeros) if return_forces else (np.nan, None)
        raise


def psi4_potential_energy(batch_positions, name, molecule=None,
                          positions_unit=None, energy_unit=None,
                          write_orbitals=False, restart_file=None,
                          restart_dir=None, parallelization_strategy=None,
                          precompute_gradient=True, on_unconverged='raise',
                          sample_keys=None, **psi4_kwargs):
    """Functional form of :class:`Psi4Potential`.

    Returns differentiable per-sample energies via ``psi4.energy``/
    ``psi4.gradient``. Prefer the class for repeated evaluation.
    Reference: upstream tfep/potentials/psi4.py:766-810.
    """
    potential = Psi4Potential(
        name, molecule=molecule, positions_unit=positions_unit,
        energy_unit=energy_unit, write_orbitals=write_orbitals,
        restart_file=restart_file, restart_dir=restart_dir,
        parallelization_strategy=parallelization_strategy,
        precompute_gradient=precompute_gradient,
        on_unconverged=on_unconverged, **psi4_kwargs)
    return potential(batch_positions, sample_keys=sample_keys)
