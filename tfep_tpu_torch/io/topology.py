"""Molecular topology and a small atom-selection language.

A copy of ``tfep_tpu/io/topology.py`` (numpy only). MDAnalysis is not a
dependency, so the framework ships its own host-side topology model plus a subset of the MDAnalysis selection
grammar (the reference accepts selection strings or index lists everywhere,
cf. upstream tfep/app/base.py:906-944). Supported selections:

    all, none, index 3 5 7, index 2:10, name CA CB, element C H,
    resname MOL, resid 1:5, mass 10 to 20, bynum 1:4 (1-based),
    not <sel>, <sel> and <sel>, <sel> or <sel>, parentheses,

plus geometric selections (periodic-aware, evaluated against a chosen
frame's coordinates — pass ``positions``/``dimensions`` to
:meth:`Topology.select_atoms`, or use :meth:`System.select_atoms
<tfep_tpu_torch.io.traj.System.select_atoms>` which supplies them):

    around 5.0 <sel>        atoms within 5 A of <sel>, excluding <sel>
    within 5.0 of <sel>     same but including <sel> (VMD spelling)
    sphzone 5.0 <sel>       within 5 A of the center of geometry of <sel>
    point x y z 5.0         within 5 A of a fixed point
    byres <sel>             expand <sel> to every atom of its residues

Distances are minimum-image under the frame's (possibly triclinic) box
when dimensions are available. This covers the canonical solvated-system
workflow of the reference ("solvent within X A of the solute" via
MDAnalysis selection strings, upstream tfep/app/base.py:906-944).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ['Topology', 'ELEMENT_MASSES', 'guess_element']

# Standard atomic masses (amu) for common elements in biomolecular systems.
ELEMENT_MASSES: Dict[str, float] = {
    'H': 1.008, 'D': 2.014, 'He': 4.0026, 'Li': 6.94, 'Be': 9.0122,
    'B': 10.81, 'C': 12.011, 'N': 14.007, 'O': 15.999, 'F': 18.998,
    'Ne': 20.180, 'Na': 22.990, 'Mg': 24.305, 'Al': 26.982, 'Si': 28.085,
    'P': 30.974, 'S': 32.06, 'Cl': 35.45, 'Ar': 39.948, 'K': 39.098,
    'Ca': 40.078, 'Ti': 47.867, 'Cr': 51.996, 'Mn': 54.938, 'Fe': 55.845,
    'Co': 58.933, 'Ni': 58.693, 'Cu': 63.546, 'Zn': 65.38, 'Se': 78.971,
    'Br': 79.904, 'Kr': 83.798, 'Rb': 85.468, 'Sr': 87.62, 'Mo': 95.95,
    'Pd': 106.42, 'Ag': 107.87, 'Cd': 112.41, 'I': 126.90, 'Xe': 131.29,
    'Cs': 132.91, 'Ba': 137.33, 'Pt': 195.08, 'Au': 196.97, 'Hg': 200.59,
    'Pb': 207.2,
}

_TWO_LETTER = {k.upper(): k for k in ELEMENT_MASSES if len(k) == 2}


def guess_element(atom_name: str) -> str:
    """Guess the chemical element from an atom name (PDB conventions).

    Leading digits are stripped (``1HB2`` is hydrogen). A two-letter
    element symbol is recognized only on an exact capitalization match
    (``Cl``, ``Na``) so that all-caps alpha carbons (``CA``) are not
    mistaken for calcium — the same disambiguation rule MDAnalysis applies
    for the reference. Falls back to the first alphabetic character, and
    to carbon if the name has none.

    Parameters
    ----------
    atom_name : str
        Atom name as found in a PDB/GRO/prmtop file.

    Returns
    -------
    str
        Capitalized element symbol (e.g. ``'C'``, ``'Cl'``).
    """
    name = atom_name.strip().lstrip('0123456789')
    # Prefer a two-letter element only on exact capitalization match
    # ('Cl', 'Na', ...) so 'CA' (alpha carbon) is not read as calcium.
    if name[:2] in ELEMENT_MASSES:
        return name[:2]
    for ch in name:
        if ch.isalpha():
            return ch.upper()
    return 'C'


class Topology:
    """Host-side per-atom attributes plus bonds.

    This is the framework's replacement for the slice of the MDAnalysis
    ``Universe`` the reference actually consumes (atom names, elements,
    residues, masses, bonds, and the selection language;
    upstream tfep/io/dataset/traj.py:43-120). It is a plain numpy
    container — nothing here is traced or device-resident; topology
    information is consumed at map-construction time only (e.g. to build
    the Z-matrix in :class:`tfep_tpu.app.mixedmaf.MixedMAFMap` of the JAX package).

    Missing attributes are derived: elements from atom names via
    :func:`guess_element`, masses from elements via :data:`ELEMENT_MASSES`,
    residue names/ids default to a single ``UNK`` residue.

    Parameters
    ----------
    names : sequence of str
        Atom names, length ``n_atoms``.
    elements : sequence of str, optional
        Element symbols; guessed from ``names`` if omitted.
    resnames : sequence of str, optional
        Per-atom residue names.
    resids : sequence of int, optional
        Per-atom residue ids.
    masses : sequence of float, optional
        Atomic masses in amu; looked up from elements if omitted.
    bonds : sequence of (int, int), optional
        Zero-based atom-index pairs.
    """

    def __init__(self, names: Sequence[str],
                 elements: Optional[Sequence[str]] = None,
                 resnames: Optional[Sequence[str]] = None,
                 resids: Optional[Sequence[int]] = None,
                 masses: Optional[Sequence[float]] = None,
                 bonds: Optional[Sequence] = None):
        self.names = np.asarray(names, dtype=object)
        n = len(self.names)
        if elements is None:
            elements = [guess_element(x) for x in self.names]
        self.elements = np.asarray(
            [str(e).capitalize() for e in elements], dtype=object)
        self.resnames = (np.asarray(resnames, dtype=object) if resnames
                         is not None else np.full(n, 'UNK', dtype=object))
        self.resids = (np.asarray(resids, dtype=np.int64) if resids
                       is not None else np.ones(n, dtype=np.int64))
        if masses is None:
            masses = [ELEMENT_MASSES.get(e, 0.0) for e in self.elements]
        self.masses = np.asarray(masses, dtype=np.float64)
        self.bonds = (np.asarray(bonds, dtype=np.int64).reshape(-1, 2)
                      if bonds is not None and len(bonds) else
                      np.zeros((0, 2), dtype=np.int64))

    @property
    def n_atoms(self) -> int:
        return len(self.names)

    # ------------------------------------------------------------------ #
    def select_atoms(self, selection, positions=None,
                     dimensions=None) -> np.ndarray:
        """Resolve a selection to sorted atom indices.

        Parameters
        ----------
        selection : str or sequence of int or None
            Either a selection string in the mini-grammar documented in the
            module docstring (e.g. ``'resname MOL and not element H'``),
            an explicit index array (returned sorted), or ``None`` for an
            empty selection.
        positions : numpy.ndarray, optional
            ``(n_atoms, 3)`` coordinates in angstrom. Required only for
            geometric selections (``around``/``within``/``sphzone``/
            ``point``).
        dimensions : numpy.ndarray, optional
            Unit-cell ``[lx, ly, lz, alpha, beta, gamma]`` (angstrom,
            degrees). When given, geometric distances are minimum-image.

        Returns
        -------
        numpy.ndarray
            Sorted, zero-based atom indices, shape ``(n_selected,)``.

        Raises
        ------
        ValueError
            If the selection string cannot be parsed, or a geometric
            keyword is used without ``positions``.
        """
        if selection is None:
            return np.zeros(0, dtype=np.int64)
        if not isinstance(selection, str):
            return np.sort(np.asarray(selection, dtype=np.int64).reshape(-1))
        mask = _SelectionParser(self, positions=positions,
                                dimensions=dimensions).parse(selection)
        return np.nonzero(mask)[0].astype(np.int64)


_GEOMETRIC_KEYWORDS = ('around', 'within', 'sphzone', 'point')
_GEOMETRIC_RE = re.compile(
    r'(?:^|[\s()])(?:' + '|'.join(_GEOMETRIC_KEYWORDS) + r')(?:[\s()]|$)')


def _needs_coordinates(selection: str) -> bool:
    """Whether a selection string uses a geometric (coordinate) keyword.

    Geometric keywords are reserved words in the grammar (they terminate
    value lists), so their presence as standalone tokens is unambiguous.
    """
    return _GEOMETRIC_RE.search(selection) is not None


def _min_image_distances(points: np.ndarray, ref: np.ndarray,
                         dimensions: Optional[np.ndarray]) -> np.ndarray:
    """Min distance (angstrom) from each point to the nearest ref atom.

    Minimum-image under the unit cell when ``dimensions`` is given:
    orthorhombic boxes wrap per axis; triclinic boxes wrap fractional
    coordinates and then search the 27 neighbour images (sufficient for
    boxes satisfying the GROMACS triclinic reduction conventions).
    """
    points = np.asarray(points, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if ref.size == 0:
        return np.full(len(points), np.inf)
    out = np.empty(len(points), dtype=np.float64)
    # Chunk candidates to bound the pair matrix at ~few MB.
    chunk = max(1, 2_000_000 // max(1, len(ref)))

    if dimensions is None or not np.all(np.asarray(dimensions)[:3] > 0):
        for s in range(0, len(points), chunk):
            delta = points[s:s + chunk, None, :] - ref[None, :, :]
            out[s:s + chunk] = np.sqrt((delta ** 2).sum(-1).min(axis=1))
        return out

    dims = np.asarray(dimensions, dtype=np.float64)
    orthorhombic = np.allclose(dims[3:], 90.0, atol=1e-4)
    if orthorhombic:
        lengths = dims[:3]
        for s in range(0, len(points), chunk):
            delta = points[s:s + chunk, None, :] - ref[None, :, :]
            delta -= lengths * np.round(delta / lengths)
            out[s:s + chunk] = np.sqrt((delta ** 2).sum(-1).min(axis=1))
        return out

    # Triclinic: rows of `cell` are the box vectors.
    from tfep_tpu_torch.io.traj import dimensions_to_box_vectors
    cell = dimensions_to_box_vectors(dims)
    inv_cell = np.linalg.inv(cell)
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], dtype=np.float64) @ cell
    for s in range(0, len(points), chunk):
        delta = points[s:s + chunk, None, :] - ref[None, :, :]
        frac = delta @ inv_cell
        delta = (frac - np.round(frac)) @ cell
        # Loop over the 27 images instead of broadcasting a
        # (chunk, n_ref, 27, 3) array — keeps the transient footprint at
        # the same per-chunk budget as the orthorhombic branch.
        best = np.full(delta.shape[:2], np.inf)
        for shift in shifts:
            np.minimum(best, ((delta + shift) ** 2).sum(-1), out=best)
        out[s:s + chunk] = np.sqrt(best.min(axis=1))
    return out


class _SelectionParser:
    """Recursive-descent parser for the mini selection grammar."""

    _KEYWORDS = {'and', 'or', 'not', '(', ')', 'all', 'none', 'index',
                 'bynum', 'name', 'element', 'type', 'resname', 'resid',
                 'mass', 'around', 'within', 'of', 'sphzone', 'point',
                 'byres'}

    def __init__(self, topology: Topology, positions=None, dimensions=None):
        self.top = topology
        self.positions = positions
        self.dimensions = dimensions

    def parse(self, text: str) -> np.ndarray:
        self.tokens = re.findall(r'\(|\)|[^\s()]+', text)
        self.pos = 0
        mask = self._parse_or()
        if self.pos != len(self.tokens):
            raise ValueError(f'Could not parse selection: {text!r} '
                             f'(stuck at token {self.tokens[self.pos]!r})')
        return mask

    def _peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def _next(self):
        tok = self._peek()
        self.pos += 1
        return tok

    def _parse_or(self):
        mask = self._parse_and()
        while self._peek() == 'or':
            self._next()
            mask = mask | self._parse_and()
        return mask

    def _parse_and(self):
        mask = self._parse_unary()
        while self._peek() == 'and':
            self._next()
            mask = mask & self._parse_unary()
        return mask

    def _parse_unary(self):
        tok = self._peek()
        if tok == 'not':
            self._next()
            return ~self._parse_unary()
        if tok == 'byres':
            self._next()
            inner = self._parse_unary()
            selected_resids = np.unique(self.top.resids[inner])
            return np.isin(self.top.resids, selected_resids)
        if tok == 'around':
            self._next()
            radius = self._number('around')
            ref = self._parse_unary()
            dist = self._distances_to(self._coords()[ref])
            return (dist <= radius) & ~ref
        if tok == 'within':
            self._next()
            radius = self._number('within')
            if self._next() != 'of':
                raise ValueError("Expected 'of' after 'within <radius>' "
                                 "(VMD spelling: within 5.0 of <sel>).")
            ref = self._parse_unary()
            # Reference atoms are at distance 0 of themselves: included.
            return self._distances_to(self._coords()[ref]) <= radius
        if tok == 'sphzone':
            self._next()
            radius = self._number('sphzone')
            ref = self._parse_unary()
            ref_coords = self._coords()[ref]
            if len(ref_coords) == 0:
                # Center of an empty selection is undefined; match
                # around/within semantics (empty reference -> empty match)
                # instead of a NaN mean + RuntimeWarning.
                return np.zeros(self.top.n_atoms, dtype=bool)
            center = ref_coords.mean(axis=0, keepdims=True)
            return self._distances_to(center) <= radius
        if tok == 'point':
            self._next()
            x, y, z = (self._number('point') for _ in range(3))
            radius = self._number('point')
            return self._distances_to(np.array([[x, y, z]])) <= radius
        if tok == '(':
            self._next()
            mask = self._parse_or()
            if self._next() != ')':
                raise ValueError('Unbalanced parentheses in selection.')
            return mask
        return self._parse_primary()

    def _number(self, keyword: str) -> float:
        tok = self._next()
        try:
            return float(tok)
        except (TypeError, ValueError):
            raise ValueError(f'{keyword!r} expects a number, got {tok!r}.')

    def _coords(self) -> np.ndarray:
        if self.positions is None:
            raise ValueError(
                'Geometric selections (around/within/sphzone/point) need '
                'coordinates: call System.select_atoms (which passes the '
                'chosen frame) or Topology.select_atoms(..., positions=).')
        return np.asarray(self.positions, dtype=np.float64).reshape(-1, 3)

    def _distances_to(self, ref_coords: np.ndarray) -> np.ndarray:
        return _min_image_distances(self._coords(), ref_coords,
                                    self.dimensions)

    def _values(self) -> List[str]:
        vals = []
        while (self._peek() is not None
               and self._peek() not in self._KEYWORDS):
            vals.append(self._next())
        if not vals:
            raise ValueError('Selection keyword requires at least one value.')
        return vals

    def _index_mask(self, vals, offset=0):
        n = self.top.n_atoms
        mask = np.zeros(n, dtype=bool)
        for v in vals:
            if ':' in v or '-' in v and not v.lstrip('-').isdigit():
                sep = ':' if ':' in v else '-'
                lo, hi = v.split(sep)
                lo, hi = int(lo) - offset, int(hi) - offset
                mask[lo:hi + 1] = True
            else:
                mask[int(v) - offset] = True
        return mask

    def _parse_primary(self):
        tok = self._next()
        n = self.top.n_atoms
        if tok == 'all':
            return np.ones(n, dtype=bool)
        if tok == 'none':
            return np.zeros(n, dtype=bool)
        if tok == 'index':
            return self._index_mask(self._values(), offset=0)
        if tok == 'bynum':
            return self._index_mask(self._values(), offset=1)
        if tok in ('name',):
            vals = set(self._values())
            return np.asarray([x in vals for x in self.top.names])
        if tok in ('element', 'type'):
            vals = {v.capitalize() for v in self._values()}
            return np.asarray([x in vals for x in self.top.elements])
        if tok == 'resname':
            vals = set(self._values())
            return np.asarray([x in vals for x in self.top.resnames])
        if tok == 'resid':
            mask = np.zeros(n, dtype=bool)
            for v in self._values():
                if ':' in v:
                    lo, hi = map(int, v.split(':'))
                    mask |= (self.top.resids >= lo) & (self.top.resids <= hi)
                else:
                    mask |= self.top.resids == int(v)
            return mask
        if tok == 'mass':
            vals = self._values()
            if len(vals) == 3 and vals[1] == 'to':
                lo, hi = float(vals[0]), float(vals[2])
                return (self.top.masses >= lo) & (self.top.masses <= hi)
            sel = np.zeros(n, dtype=bool)
            for v in vals:
                sel |= np.isclose(self.top.masses, float(v))
            return sel
        raise ValueError(f'Unknown selection keyword: {tok!r}')
