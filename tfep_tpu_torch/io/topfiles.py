"""Topology-file parsers: AMBER prmtop, GROMACS .top, and CHARMM/NAMD PSF,
plus distance-based bond guessing.

A copy of ``tfep_tpu/io/topfiles.py`` (numpy only, no JAX).

These supply bonds + elements to :class:`tfep_tpu_torch.app.MixedMAFMap` (which
builds Z-matrices from the bond graph) for trajectories whose coordinate
files carry no connectivity (DCD/XTC/TRR). The reference reads these
through MDAnalysis (upstream tfep/io/dataset/traj.py:43; its own
tests ship an AMBER prmtop, tests/data/water.prmtop).
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from tfep_tpu_torch.io.topology import ELEMENT_MASSES, Topology, guess_element

__all__ = ['read_prmtop', 'read_gromacs_top', 'read_psf', 'guess_bonds']

# Atomic number -> element symbol for elements common in simulations.
_Z_TO_ELEMENT = {
    1: 'H', 2: 'He', 3: 'Li', 4: 'Be', 5: 'B', 6: 'C', 7: 'N', 8: 'O',
    9: 'F', 10: 'Ne', 11: 'Na', 12: 'Mg', 13: 'Al', 14: 'Si', 15: 'P',
    16: 'S', 17: 'Cl', 18: 'Ar', 19: 'K', 20: 'Ca', 25: 'Mn', 26: 'Fe',
    27: 'Co', 28: 'Ni', 29: 'Cu', 30: 'Zn', 34: 'Se', 35: 'Br', 53: 'I',
}

# Covalent radii (angstrom) for bond guessing.
_COVALENT_RADII = {
    'H': 0.31, 'He': 0.28, 'Li': 1.28, 'Be': 0.96, 'B': 0.84, 'C': 0.76,
    'N': 0.71, 'O': 0.66, 'F': 0.57, 'Na': 1.66, 'Mg': 1.41, 'Al': 1.21,
    'Si': 1.11, 'P': 1.07, 'S': 1.05, 'Cl': 1.02, 'K': 2.03, 'Ca': 1.76,
    'Fe': 1.32, 'Cu': 1.32, 'Zn': 1.22, 'Br': 1.20, 'I': 1.39,
}


def _element_from_mass(mass: float) -> Optional[str]:
    """Nearest-mass element (within 0.5 amu), else None."""
    best, best_err = None, 0.5
    for element, element_mass in ELEMENT_MASSES.items():
        err = abs(element_mass - mass)
        if err < best_err:
            best, best_err = element, err
    return best


# =============================================================================
# AMBER prmtop
# =============================================================================

def _parse_prmtop_sections(path: str) -> Dict[str, List[str]]:
    """Split a prmtop into raw token lists keyed by %FLAG name."""
    sections: Dict[str, List[str]] = {}
    current: Optional[List[str]] = None
    fixed_width: Optional[int] = None
    with open(path) as f:
        for line in f:
            if line.startswith('%FLAG'):
                current = sections[line.split()[1]] = []
                fixed_width = None
            elif line.startswith('%FORMAT'):
                # Character fields (e.g. 20a4) must split by width, not
                # whitespace — atom names can contain spaces or be blank.
                spec = line[line.index('(') + 1:line.index(')')]
                match = re.fullmatch(r'(\d+)[aA](\d+)', spec.strip())
                fixed_width = int(match.group(2)) if match else None
            elif line.startswith('%'):
                continue
            elif current is not None:
                row = line.rstrip('\n')
                if fixed_width:
                    current.extend(
                        row[i:i + fixed_width].strip()
                        for i in range(0, len(row), fixed_width))
                else:
                    current.extend(row.split())
    return sections


def read_prmtop(path: str) -> Topology:
    """Parse an AMBER prmtop/parm7 topology file.

    Reads the ``%FLAG`` sections needed to build a
    :class:`~tfep_tpu_torch.io.topology.Topology`: atom names, masses,
    elements (from ``ATOMIC_NUMBER`` when present, else nearest-mass
    lookup with a name-based fallback), residue labels/pointers, and both
    bond tables (``BONDS_INC_HYDROGEN`` + ``BONDS_WITHOUT_HYDROGEN``,
    whose atom indices are stored pre-multiplied by 3 in the format).
    Character sections are split at their ``%FORMAT`` fixed width so
    blank-padded atom names survive.

    Parameters
    ----------
    path : str
        Path to a ``.prmtop``/``.parm7`` file.

    Returns
    -------
    Topology
        Full topology with bonds; validated against the reference's own
        test fixture (upstream tfep/tests/data/water.prmtop).
    """
    sections = _parse_prmtop_sections(path)
    pointers = [int(x) for x in sections['POINTERS']]
    n_atoms = pointers[0]

    names = sections['ATOM_NAME'][:n_atoms]
    masses = np.asarray([float(x) for x in sections['MASS'][:n_atoms]])

    if 'ATOMIC_NUMBER' in sections:
        numbers = [int(x) for x in sections['ATOMIC_NUMBER'][:n_atoms]]
        elements = [_Z_TO_ELEMENT.get(z) or guess_element(name)
                    for z, name in zip(numbers, names)]
    else:
        elements = [_element_from_mass(m) or guess_element(name)
                    for m, name in zip(masses, names)]

    # Residues: labels + 1-based first-atom pointers.
    labels = sections.get('RESIDUE_LABEL', ['UNK'])
    starts = [int(x) - 1
              for x in sections.get('RESIDUE_POINTER', ['1'])]
    starts.append(n_atoms)
    resnames = np.empty(n_atoms, dtype=object)
    resids = np.empty(n_atoms, dtype=np.int64)
    for res_idx, (label, lo, hi) in enumerate(
            zip(labels, starts[:-1], starts[1:])):
        resnames[lo:hi] = label
        resids[lo:hi] = res_idx + 1

    # Bonds: triplets of (3*atom_i, 3*atom_j, type); H and heavy tables.
    bonds = []
    for flag in ('BONDS_INC_HYDROGEN', 'BONDS_WITHOUT_HYDROGEN'):
        values = [int(x) for x in sections.get(flag, [])]
        for k in range(0, len(values), 3):
            bonds.append(sorted((values[k] // 3, values[k + 1] // 3)))

    return Topology(names=names, elements=elements, resnames=resnames,
                    resids=resids, masses=masses, bonds=sorted(map(tuple,
                                                                   bonds)))


# =============================================================================
# GROMACS .top
# =============================================================================

class _MoleculeType:
    def __init__(self, name: str):
        self.name = name
        self.atom_names: List[str] = []
        self.atom_masses: List[Optional[float]] = []
        self.resnames: List[str] = []
        self.bonds: List[Tuple[int, int]] = []
        self.settle_atoms: List[int] = []

    @property
    def n_atoms(self) -> int:
        return len(self.atom_names)

    def finalized_bonds(self) -> List[Tuple[int, int]]:
        """Bonds incl. those implied by [ settles ] (rigid waters)."""
        bonds = list(self.bonds)
        for oxygen in self.settle_atoms:
            for other in range(self.n_atoms):
                mass = self.atom_masses[other]
                is_h = (mass is not None and mass < 3.5) or \
                    (mass is None
                     and self.atom_names[other].upper().startswith('H'))
                if other != oxygen and is_h:
                    bonds.append(tuple(sorted((oxygen, other))))
        return bonds


def _top_lines(path: str, defines: Optional[set] = None):
    """Yield content lines, following resolvable #include directives.

    Tracks ``#define``/``#ifdef``/``#ifndef``/``#else``/``#endif`` so
    mutually exclusive blocks yield only the active branch — e.g. the
    standard water itp's ``#ifndef FLEXIBLE [settles] #else [bonds]
    #endif`` must not contribute *both* the settles-implied and the
    flexible bonds (duplicate edges in the bond graph). Symbols come from
    file-level ``#define`` lines (shared across includes); ``-D`` grompp
    defines have no file counterpart, so undefined symbols follow the
    ``#ifndef`` branch — the GROMACS default.
    """
    if defines is None:
        defines = set()

    def _eval_if(expr: str) -> bool:
        """Best-effort truth of a ``#if`` expression: integer literal
        (C semantics: nonzero = true, so ``#if 1`` includes), ``defined(X)``
        / ``defined X``, or bare symbol test; anything richer (arithmetic,
        ``||``) is out of scope for molecule-composition parsing, so warn
        and include the block (conservative — composition sections are
        never guarded by exotic expressions in practice)."""
        expr = expr.strip()
        if re.fullmatch(r'[+-]?\d+', expr):
            return int(expr) != 0
        match = re.fullmatch(r'!?\s*defined\s*[( ]\s*(\w+)\s*\)?', expr)
        if match:
            value = match.group(1) in defines
            return not value if expr.startswith('!') else value
        if re.fullmatch(r'\w+', expr):
            return expr in defines
        warnings.warn(
            f'Unsupported #if expression {expr!r} in {path}; '
            'including the block.')
        return True

    # One frame per open conditional: [active, ever_taken]. ever_taken
    # tracks whether any prior branch of this #if/#elif/#else chain was
    # active, so #elif/#else activate at most one branch.
    stack: list = []
    with open(path) as f:
        for raw in f:
            line = raw.split(';', 1)[0].strip()
            if not line:
                continue
            if line.startswith('#ifndef'):
                symbol = (line.split(None, 1) + [''])[1].strip()
                active = symbol not in defines
                stack.append([active, active])
                continue
            if line.startswith('#ifdef'):
                symbol = (line.split(None, 1) + [''])[1].strip()
                active = symbol in defines
                stack.append([active, active])
                continue
            if line.startswith('#if'):
                # Inside an inactive region the branch value is irrelevant
                # (and evaluating it could emit a misleading 'including
                # the block' warning for content the outer gate drops).
                if all(frame[0] for frame in stack):
                    active = _eval_if(line[3:])
                else:
                    active = False
                stack.append([active, active])
                continue
            if line.startswith('#elif'):
                if stack:
                    enclosing_active = all(
                        frame[0] for frame in stack[:-1])
                    active = (enclosing_active and not stack[-1][1]
                              and _eval_if(line[5:]))
                    stack[-1][0] = active
                    stack[-1][1] = stack[-1][1] or active
                continue
            if line.startswith('#else'):
                if stack:
                    stack[-1][0] = not stack[-1][1]
                    stack[-1][1] = True
                continue
            if line.startswith('#endif'):
                if stack:
                    stack.pop()
                continue
            if not all(frame[0] for frame in stack):
                continue
            if line.startswith('#define'):
                parts = line.split()
                if len(parts) >= 2:
                    defines.add(parts[1])
                continue
            if line.startswith('#include'):
                target = line.split(None, 1)[1].strip('"\'<>')
                resolved = os.path.join(os.path.dirname(path), target)
                if os.path.isfile(resolved):
                    yield from _top_lines(resolved, defines)
                # Force-field includes that aren't present are skipped:
                # they define parameters, not the molecule composition.
                continue
            if line.startswith('#'):
                continue  # other preprocessor directives
            yield line


def read_gromacs_top(path: str) -> Topology:
    """Parse a GROMACS ``.top`` topology.

    ``[ moleculetype ]`` blocks are collected (atoms, bonds, constraints,
    and ``[ settles ]``-implied rigid-water bonds), then expanded by the
    ``[ molecules ]`` composition into one flat per-atom topology, one
    residue id per molecule copy. ``#include`` directives are followed
    when the target file exists relative to the including file;
    parameter-level force-field includes that cannot be found are
    ignored — atoms and bonds must be declared in reachable files
    (standard for solute topologies written by ``pdb2gmx``/``acpype``).
    Elements are recovered from explicit masses when given, else guessed
    from atom names.

    Parameters
    ----------
    path : str
        Path to a ``.top`` (or itp-style) file.

    Returns
    -------
    Topology
        Expanded system topology with bonds.

    Raises
    ------
    ValueError
        If ``[ molecules ]`` references a molecule type that no reachable
        ``[ moleculetype ]`` defines.
    """
    molecule_types: Dict[str, _MoleculeType] = {}
    composition: List[Tuple[str, int]] = []
    section = None
    current: Optional[_MoleculeType] = None

    for line in _top_lines(path):
        if line.startswith('['):
            section = line.strip('[] ').lower()
            continue
        fields = line.split()
        if section == 'moleculetype':
            current = _MoleculeType(fields[0])
            molecule_types[current.name] = current
        elif section == 'atoms' and current is not None:
            # nr type resnr residue atom cgnr [charge [mass]]
            current.atom_names.append(fields[4])
            current.resnames.append(fields[3])
            current.atom_masses.append(
                float(fields[7]) if len(fields) > 7 else None)
        elif section in ('bonds', 'constraints', 'pairs') and \
                current is not None:
            if section == 'pairs':
                continue  # nonbonded 1-4 pairs, not connectivity
            current.bonds.append(tuple(sorted(
                (int(fields[0]) - 1, int(fields[1]) - 1))))
        elif section == 'settles' and current is not None:
            current.settle_atoms.append(int(fields[0]) - 1)
        elif section == 'molecules':
            composition.append((fields[0], int(fields[1])))

    if not composition:
        # A bare itp-style file: single copy of each declared type.
        composition = [(name, 1) for name in molecule_types]

    names, elements, resnames, resids, masses, bonds = \
        [], [], [], [], [], []
    offset = 0
    resid = 0
    for mol_name, count in composition:
        if mol_name not in molecule_types:
            raise ValueError(
                f'[ molecules ] references {mol_name!r} but no '
                '[ moleculetype ] defines it (missing #include?).')
        mol = molecule_types[mol_name]
        mol_bonds = mol.finalized_bonds()
        for _ in range(count):
            resid += 1
            names.extend(mol.atom_names)
            resnames.extend(mol.resnames)
            resids.extend([resid] * mol.n_atoms)
            for name, mass in zip(mol.atom_names, mol.atom_masses):
                element = (_element_from_mass(mass)
                           if mass is not None else None)
                elements.append(element or guess_element(name))
                masses.append(mass if mass is not None
                              else ELEMENT_MASSES.get(elements[-1], 0.0))
            bonds.extend((i + offset, j + offset) for i, j in mol_bonds)
            offset += mol.n_atoms

    return Topology(names=names, elements=elements, resnames=resnames,
                    resids=resids, masses=masses, bonds=sorted(bonds))


# =============================================================================
# CHARMM/NAMD PSF
# =============================================================================

def read_psf(path: str) -> Topology:
    """Parse a CHARMM/X-PLOR/NAMD PSF topology file.

    The protein-structure file is the topology CHARMM and NAMD pair with
    the DCD trajectories this package already decodes natively
    (:mod:`tfep_tpu_torch.io.dcd`); the reference reads both through MDAnalysis
    (upstream tfep/io/dataset/traj.py:43). The published format is
    a sequence of ``<count> !NAME`` sections; this reader consumes
    ``!NATOM`` (atom id, segment, residue id, residue name, atom name,
    atom type, charge, mass, fixed flag) and ``!NBOND`` (1-based atom-index
    pairs, eight integers per line) and ignores the force-field sections
    (angles, dihedrals, cross-terms). Both the classic fixed-column
    layout and the wide ``EXT`` (extended) layout parse identically:
    PSF fields never contain whitespace, so whitespace tokenization
    covers CHARMM, X-PLOR, and NAMD flavors (including trailing CHEQ
    columns, which are ignored).

    Parameters
    ----------
    path : str
        Path to a ``.psf`` file.

    Returns
    -------
    Topology
        Atom names/residues/masses and the bond list; elements are
        recovered from the masses (nearest-mass lookup, same policy as
        :func:`read_prmtop` without ``ATOMIC_NUMBER``) with a name-based
        fallback.
    """
    with open(path) as f:
        first = f.readline()
        if not first.lstrip().startswith('PSF'):
            raise ValueError(f'{path} is not a PSF file (missing PSF '
                             'header line).')
        lines = f.read().splitlines()

    header_re = re.compile(r'^\s*(\d+)\s+!(\w+)')
    names: List[str] = []
    resnames: List[str] = []
    resids: List[int] = []
    masses: List[float] = []
    bonds: List[Tuple[int, int]] = []
    n_atoms = None

    i = 0
    while i < len(lines):
        match = header_re.match(lines[i])
        if match is None:
            i += 1
            continue
        count, section = int(match.group(1)), match.group(2).upper()
        i += 1
        if section == 'NATOM':
            n_atoms = count
            parsed = 0
            while parsed < count:
                if i >= len(lines):
                    raise ValueError(
                        f'{path}: !NATOM section truncated '
                        f'({parsed} of {count} atom lines).')
                fields = lines[i].split()
                i += 1
                if not fields:
                    continue
                if len(fields) < 8:
                    raise ValueError(
                        f'{path}: malformed PSF atom line '
                        f'{parsed + 1}/{count}: {lines[i - 1]!r}')
                # id segname resid resname name type charge mass [imove...]
                names.append(fields[4])
                resnames.append(fields[3])
                resid_match = re.match(r'-?\d+', fields[2])
                resids.append(int(resid_match.group())
                              if resid_match else parsed + 1)
                masses.append(float(fields[7]))
                parsed += 1
        elif section == 'NBOND':
            values: List[int] = []
            while len(values) < 2 * count and i < len(lines):
                values.extend(int(x) for x in lines[i].split())
                i += 1
            if len(values) < 2 * count:
                raise ValueError(
                    f'{path}: !NBOND section truncated '
                    f'({len(values)} of {2 * count} indices).')
            for k in range(0, 2 * count, 2):
                a, b = values[k] - 1, values[k + 1] - 1   # 1-based on disk
                if min(a, b) < 0:
                    raise ValueError(
                        f'{path}: !NBOND contains index '
                        f'{min(values[k], values[k + 1])} (PSF bond '
                        'indices are 1-based and must be >= 1).')
                bonds.append((min(a, b), max(a, b)))
        # Other sections (NTHETA, NPHI, ...) are skipped; their data lines
        # don't match header_re, so the scan naturally jumps to the next
        # section header.

    if n_atoms is None:
        raise ValueError(f'{path}: no !NATOM section found.')
    if bonds and max(max(b) for b in bonds) >= n_atoms:
        raise ValueError(f'{path}: bond index out of range '
                         f'(n_atoms={n_atoms}).')

    elements = [_element_from_mass(m) or guess_element(name)
                for m, name in zip(masses, names)]
    return Topology(names=names, elements=elements, resnames=resnames,
                    resids=resids, masses=masses, bonds=sorted(bonds))


# =============================================================================
# Distance-based bond guessing
# =============================================================================

def guess_bonds(positions: np.ndarray, elements,
                tolerance: float = 0.45,
                min_distance: float = 0.4) -> np.ndarray:
    """Guess bonds from one frame's coordinates.

    Uses the same criterion as MDAnalysis' bond guesser (which the
    reference relies on when a format carries no connectivity): two atoms
    are bonded when their distance is below the sum of their covalent
    radii plus ``tolerance``, and above ``min_distance`` (rejecting
    overlapping duplicate atoms). O(n^2) in memory — intended for solute
    or single-molecule systems, not full solvent boxes; for those, read
    connectivity from a prmtop/.top instead.

    Parameters
    ----------
    positions : numpy.ndarray
        One frame, ``(n_atoms, 3)``, in angstrom.
    elements : sequence of str
        Element symbols used to look up covalent radii (unknown elements
        fall back to carbon's radius).
    tolerance : float, optional
        Slack added to the radii sum, in angstrom.
    min_distance : float, optional
        Minimum separation below which a pair is ignored.

    Returns
    -------
    numpy.ndarray
        ``(n_bonds, 2)`` sorted zero-based index pairs.
    """
    positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
    radii = np.asarray([_COVALENT_RADII.get(str(e).capitalize(), 0.76)
                        for e in elements])
    deltas = positions[:, None, :] - positions[None, :, :]
    distances = np.sqrt((deltas ** 2).sum(-1))
    cutoffs = radii[:, None] + radii[None, :] + tolerance
    candidates = (distances < cutoffs) & (distances > min_distance)
    i_idx, j_idx = np.nonzero(np.triu(candidates, k=1))
    return np.stack([i_idx, j_idx], axis=1).astype(np.int64)
