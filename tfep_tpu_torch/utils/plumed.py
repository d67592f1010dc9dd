"""PLUMED file utilities: COLVAR tables, aux data for datasets, sum_hills.

A copy of ``tfep_tpu/utils/plumed.py``: the port keeps its own,
because importing the JAX package's module would import JAX.

Supports biased-simulation workflows: read per-frame bias potentials from
PLUMED COLVAR output and register them as auxiliary log-weight data on a
:class:`tfep_tpu_torch.io.traj.TrajectoryDataset` (entering the loss as
softmax-weighted means). Reference behaviors:
upstream tfep/utils/plumed/{io.py,auxreader.py,sumhills.py}. The
MDAnalysis-based aux reader is replaced by a direct
:func:`add_plumed_aux_to_dataset` hook onto the native dataset.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, List, Optional, Union

import numpy as np

from tfep_tpu_torch.parallel.cli import CLITool, KeyValueOption
from tfep_tpu_torch.parallel.launcher import Launcher
from tfep_tpu_torch.units import Quantity, ureg

__all__ = [
    'read_table_field_names', 'read_table_n_rows', 'read_table',
    'write_table', 'add_plumed_aux_to_dataset', 'PlumedSumHills',
    'run_plumed_sum_hills', 'check_plumed_is_installed', 'plot_trajectory',
]


def check_plumed_is_installed() -> bool:
    return shutil.which('plumed') is not None


# =============================================================================
# COLVAR / table I/O
# =============================================================================

def read_table_field_names(file_path: str) -> List[str]:
    """Column names from the '#! FIELDS ...' header record."""
    with open(file_path) as f:
        for line in f:
            if line.startswith('#! FIELDS'):
                return line.split()[2:]
    raise ValueError(
        f"No '#! FIELDS' record could be found in file {file_path}")


def read_table_n_rows(file_path: str) -> int:
    """Number of data rows (comments/blank lines skipped)."""
    with open(file_path) as f:
        return sum(1 for line in f
                   if not (line.startswith('#!') or line.strip() == ''))


def read_table(file_path: str, col_names: Optional[List[str]] = None,
               as_array: bool = False, remove_duplicates: bool = True,
               row_filter_func: Optional[Callable[[str], bool]] = None,
               dtype=None, ordering_col_name: Optional[str] = None
               ) -> Union[np.ndarray, Dict[str, np.ndarray]]:
    """Read columns of a PLUMED output table.

    With ``remove_duplicates`` rows repeating the previous row's leading
    (time) value are dropped (PLUMED restarts duplicate the first record).
    """
    field_names = read_table_field_names(file_path)
    if col_names is None:
        col_names = field_names
    col_indices = [field_names.index(name) for name in col_names]

    rows = []
    last_time = None
    with open(file_path) as f:
        for line in f:
            if line.startswith('#!') or line.strip() == '':
                continue
            if row_filter_func is not None and not row_filter_func(line):
                continue
            fields = line.split()
            if remove_duplicates:
                if fields[0] == last_time:
                    rows.pop()
                last_time = fields[0]
            rows.append([float(fields[i]) for i in col_indices])

    data = np.asarray(rows, dtype=dtype)
    if data.size == 0:
        data = data.reshape(0, len(col_indices))

    if ordering_col_name is not None:
        order = np.argsort(data[:, col_names.index(ordering_col_name)])
        data = data[order]

    if as_array:
        return data
    return {name: data[:, i] for i, name in enumerate(col_names)}


def write_table(data: Union[np.ndarray, Dict[str, np.ndarray]],
                file_path: str, col_names: Optional[List[str]] = None):
    """Write a table in PLUMED format ('#! FIELDS ...' header + rows)."""
    if isinstance(data, dict):
        if col_names is None:
            col_names = list(data)
        array = np.stack([np.asarray(data[name]) for name in col_names],
                         axis=1)
    else:
        array = np.asarray(data)
        if col_names is None:
            raise ValueError('col_names must be passed with array data.')

    with open(file_path, 'w') as f:
        f.write('#! FIELDS ' + ' '.join(col_names) + '\n')
        np.savetxt(f, array, fmt='%25.16f')


# =============================================================================
# Dataset hook (aux reader replacement)
# =============================================================================

def add_plumed_aux_to_dataset(dataset, file_path: str,
                              col_names: Optional[List[str]] = None,
                              units: Optional[Dict] = None,
                              dest_units: Optional[Dict] = None):
    """Register COLVAR columns as per-frame auxiliary data on a dataset.

    ``units``/``dest_units`` optionally map column name -> Unit for
    conversion (e.g. a bias in kJ/mol to the potential's energy unit). The
    COLVAR file must have one row per trajectory frame (after duplicate
    removal). Replaces the reference's MDAnalysis-based ``PLUMEDAuxReader``
    (auxreader.py:28-135).
    """
    table = read_table(file_path, col_names=col_names)
    for name, values in table.items():
        if name == 'time':
            continue
        if units is not None and name in units:
            quantity = Quantity(values, units[name])
            target = (dest_units or {}).get(name, units[name])
            values = quantity.to(target).magnitude
        dataset.add_aux(name, values)
    return dataset


# =============================================================================
# sum_hills wrapper
# =============================================================================

class PlumedSumHills(CLITool):
    """``plumed sum_hills`` command wrapper."""
    EXECUTABLE_PATH = 'plumed'
    SUBPROGRAM = 'sum_hills'
    hills_file_path = KeyValueOption('--hills')
    out_file_path = KeyValueOption('--outfile')
    bin_sizes = KeyValueOption('--bin')
    min_values = KeyValueOption('--min')
    max_values = KeyValueOption('--max')
    stride = KeyValueOption('--stride')
    mintozero = KeyValueOption('--mintozero')


def run_plumed_sum_hills(hills_file_path: str, out_file_path: str,
                         launcher: Optional[Launcher] = None,
                         **kwargs):
    """Run ``plumed sum_hills`` to integrate a HILLS file into an FES."""
    if launcher is None:
        launcher = Launcher()
    cmd = PlumedSumHills(hills_file_path=hills_file_path,
                         out_file_path=out_file_path, **kwargs)
    return launcher.run(cmd, check=True)


# =============================================================================
# Plotting (optional; requires matplotlib)
# =============================================================================

def plot_trajectory(data, col_names=None, time_unit=None, stride: int = 1,
                    axes=None, plot_kwargs: Optional[Dict] = None):
    """Plot PLUMED table columns against time.

    ``data`` is a column dict as returned by :func:`read_table` (must
    include a ``'time'`` column, in femtoseconds as PLUMED writes it);
    ``time_unit`` optionally converts the time axis (e.g. ``'ps'``).
    Reference behavior: upstream tfep/utils/plumed/plot.py:24-90.
    """
    import matplotlib.pyplot as plt

    plot_kwargs = plot_kwargs or {}
    if axes is None:
        _, axes = plt.subplots()

    if col_names is None:
        col_names = [k for k in data if k != 'time']
    elif isinstance(col_names, str):
        col_names = [col_names]

    if time_unit is None or time_unit == 'fs':
        time_unit = 'fs'
        time = data['time']
    else:
        time = Quantity(np.asarray(data['time']), ureg.femtosecond).to(
            ureg.parse_units(time_unit)).magnitude

    for name in col_names:
        axes.plot(time[::stride], data[name][::stride], label=name,
                  **plot_kwargs)

    axes.set_xlabel(f'simulation time [{time_unit}]')
    axes.legend()
    return axes
