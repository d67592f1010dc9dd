"""TFEP logger: per-sample scalar store feeding the free-energy estimator.

A copy of ``tfep_tpu/io/log.py``. It takes torch tensors on any device
(moved to the host with ``.detach().cpu().numpy()``) where the JAX
package's copy takes JAX arrays; the files are the same.

Stores per-sample quantities (target potentials, log_det_J, sample indices,
CVs) produced during training/evaluation, and reads them back for
:func:`tfep_tpu.analysis.fep_estimator`. On-disk layout (kept byte-compatible
with the reference, upstream tfep/io/log.py, so archives are
interchangeable):

* ``metadata.json`` — batch/epoch sizes + format version; its presence makes
  a re-created logger resume from disk, ignoring constructor sizes.
* ``train/epoch-X.npz`` — fixed-length columns of ``n_samples_per_epoch``
  rows, row ``i`` = sample ``i % batch_size`` of batch ``i // batch_size``,
  with a boolean ``__mask`` column marking rows actually written.
* ``eval/step-X.npz`` — growable columns appended to (or updated in place,
  keyed by sample index) on every save.

Internally the logger is built from two pieces the reference does not have:
a :class:`_ColumnFile` (one npz archive of aligned named columns, owning its
own load/flush/row-selection logic) and a per-channel LRU-of-one cache in
the logger that maps an epoch/step address to its file. A single logger
instance is not multi-process safe; for multi-host sharded training use one
logger per host with the host's global sample indices (the addressing
scheme is position-independent).
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ['TFEPLogger']

#: Column marking which rows of a fixed-length archive hold real data.
_WRITTEN = '__mask'

#: Recognized per-sample index columns (used to key eval updates and to
#: warn when a save carries no way to match rows back to their frames).
_SAMPLE_KEYS = ('trajectory_sample_index', 'dataset_sample_index')


def _columns_from(tensors: Dict) -> Dict[str, np.ndarray]:
    """Convert a dict of array-likes (tensors/np/lists) to numpy columns."""
    return {name: value.detach().cpu().numpy()
            if isinstance(value, torch.Tensor) else np.asarray(value)
            for name, value in tensors.items()}


def _finite_rows(columns: Dict[str, np.ndarray], which) -> np.ndarray:
    """Boolean row filter dropping NaNs.

    ``which`` may be a column name (filter on that column only) or ``True``
    (a row survives only if every floating column is NaN-free).
    """
    if which is not True:
        return ~np.isnan(columns[which])
    n_rows = len(next(iter(columns.values())))
    keep = np.ones(n_rows, dtype=bool)
    for name, col in columns.items():
        if name != _WRITTEN and np.issubdtype(col.dtype, np.floating):
            keep &= ~np.isnan(col)
    return keep


class _ColumnFile:
    """One ``.npz`` archive of aligned, named per-sample columns.

    Two shapes of file exist:

    * fixed-length (``n_rows`` given): columns are preallocated to
      ``n_rows`` and a ``__mask`` column tracks which rows were written —
      the train channel's epoch files;
    * growable (``n_rows=None``): columns start empty and every store
      appends (or updates keyed rows) — the eval channel's step files.
    """

    def __init__(self, path: str, n_rows: Optional[int] = None):
        self.path = path
        self.n_rows = n_rows
        if os.path.isfile(path):
            with np.load(path) as archive:
                self.columns = {name: archive[name]
                                for name in archive.files}
        elif n_rows is None:
            self.columns = {}
        else:
            self.columns = {_WRITTEN: np.zeros(n_rows, dtype=bool)}

    def flush(self):
        """Write the columns to disk as a compressed ``.npz``."""
        np.savez_compressed(self.path, **self.columns)

    @property
    def names(self) -> List[str]:
        """Stored column names (excluding the internal written-mask)."""
        return [name for name in self.columns if name != _WRITTEN]

    # -- fixed-length files --------------------------------------------- #
    def fill_rows(self, start: Optional[int], columns: Dict[str, np.ndarray]):
        """Write ``columns`` at rows ``start:start+len`` (all rows if None)."""
        written = self.columns[_WRITTEN]
        for name, col in columns.items():
            if start is None:
                self.columns[name] = col
                written[:] = True
                continue
            stop = start + len(col)
            if name not in self.columns:
                self.columns[name] = np.empty(self.n_rows, dtype=col.dtype)
            self.columns[name][start:stop] = col
            written[start:stop] = True

    # -- growable files ------------------------------------------------- #
    def merge_rows(self, columns: Dict[str, np.ndarray], update: bool):
        """Append rows; with ``update``, overwrite rows whose sample key
        already exists instead of duplicating them."""
        if self.columns:
            missing = [n for n in self.columns if n not in columns]
            if missing:
                raise KeyError(
                    "'tensors' must include all the following arrays: "
                    + str(list(self.columns)))
            # New names appearing mid-stream would misalign row counts.
            columns = {n: columns[n] for n in self.columns}

        append = columns
        if update and self.columns:
            key = next((k for k in _SAMPLE_KEYS if k in columns), None)
            if key is not None:
                # Row position of each existing sample key in this file.
                position = {sample: row for row, sample
                            in enumerate(self.columns[key])}
                hits = np.array([sample in position
                                 for sample in columns[key]])
                if hits.any():
                    rows = [position[sample]
                            for sample in columns[key][hits]]
                    for name, col in columns.items():
                        self.columns[name][rows] = col[hits]
                    append = {name: col[~hits]
                              for name, col in columns.items()}

        for name, col in append.items():
            if name in self.columns:
                self.columns[name] = np.concatenate(
                    (self.columns[name], col))
            else:
                self.columns[name] = col

    # -- reading -------------------------------------------------------- #
    def select(self, names: Optional[List[str]], row_filter=None,
               row_slice=slice(None)) -> Dict[str, np.ndarray]:
        """Read columns (all when ``names`` is None), optionally sliced
        and filtered by a boolean row mask."""
        if names is None:
            names = self.names
        if row_filter is None:
            return {name: self.columns[name][row_slice] for name in names}
        keep = row_filter[row_slice]
        return {name: self.columns[name][row_slice][keep] for name in names}

    def sort_by(self, name: str):
        """Reorder every column by ascending values of column ``name``."""
        order = np.argsort(self.columns[name])
        self.columns = {n: col[order] for n, col in self.columns.items()}


class TFEPLogger:
    """Store and retrieve per-sample quantities by epoch, batch, or step.

    The training channel stores fixed-length per-epoch archives addressed
    by ``(epoch_idx, batch_idx)`` (or a global ``step_idx``); the eval
    channel stores growable per-step archives. Reads return dicts of numpy
    columns and drive :func:`tfep_tpu.analysis.fep_estimator` /
    :func:`tfep_tpu.analysis.estimate_from_logger`.

    Parameters
    ----------
    save_dir_path : str, optional
        Root directory (created if missing). If it already holds a
        ``metadata.json``, the logger resumes from disk and the size
        arguments are ignored.
    batch_size, n_samples_per_epoch : int, optional
        Geometry of the train channel (row addressing within epoch files).
    data_loader : object, optional
        Alternative to the explicit sizes: anything exposing
        ``batch_size``, ``drop_last`` and ``dataset``.
    train_subdir_name, eval_subdir_name : str, optional
        Channel subdirectory names.

    Notes
    -----
    A single instance is not multi-process safe (same caveat as the
    reference, upstream tfep/io/log.py:40-43); under multi-host
    training use one logger per host (see
    :func:`tfep_tpu.parallel.distributed.host_logger_dir`).
    """

    VERSION = '0.1'
    METADATA_FILE_NAME = 'metadata.json'
    INDEX_NAMES = list(_SAMPLE_KEYS)
    MASK_NAME = _WRITTEN

    def __init__(self, save_dir_path='tfep_logs',
                 batch_size: Optional[int] = None,
                 n_samples_per_epoch: Optional[int] = None,
                 data_loader=None,
                 train_subdir_name='train', eval_subdir_name='eval'):
        """Create or resume a logger.

        Either pass ``batch_size`` + ``n_samples_per_epoch`` directly, or a
        ``data_loader``-like object exposing ``batch_size``, ``drop_last``
        and ``dataset``. When ``save_dir_path`` already holds a
        ``metadata.json`` these are ignored and the logger resumes from
        disk.
        """
        self._save_dir_path = os.path.realpath(save_dir_path)
        self._train_dir_path = os.path.join(save_dir_path, train_subdir_name)
        self._eval_dir_path = os.path.join(save_dir_path, eval_subdir_name)
        # address -> _ColumnFile caches, one entry each (the training loop
        # touches one epoch/step at a time; keeping one avoids rereading
        # the archive on every batch while bounding memory).
        self._open_files: Dict[str, tuple] = {'train': None, 'eval': None}

        sizes = self._restore_metadata()
        if sizes is None:
            sizes = self._initial_sizes(batch_size, n_samples_per_epoch,
                                        data_loader)
        self._batch_size, self._n_samples_per_epoch = sizes

        for dir_path in (self._save_dir_path, self._train_dir_path,
                         self._eval_dir_path):
            os.makedirs(dir_path, exist_ok=True)
        self._persist_metadata()

    # -- metadata ------------------------------------------------------- #
    @property
    def _metadata_path(self):
        return os.path.join(self._save_dir_path, self.METADATA_FILE_NAME)

    def _restore_metadata(self):
        if not os.path.isfile(self._metadata_path):
            return None
        with open(self._metadata_path) as f:
            meta = json.load(f)
        return meta['batch_size'], meta['n_samples_per_epoch']

    def _persist_metadata(self):
        if os.path.isfile(self._metadata_path):
            return
        with open(self._metadata_path, 'w') as f:
            json.dump({'batch_size': self._batch_size,
                       'n_samples_per_epoch': self._n_samples_per_epoch,
                       'version': self.VERSION}, f)

    @staticmethod
    def _initial_sizes(batch_size, n_samples_per_epoch, data_loader):
        if data_loader is not None:
            batch_size = data_loader.batch_size
            n_samples_per_epoch = len(data_loader.dataset)
            if getattr(data_loader, 'drop_last', False):
                n_samples_per_epoch -= n_samples_per_epoch % batch_size
        if batch_size is None or n_samples_per_epoch is None:
            raise ValueError(
                'When creating a new logger, pass batch_size and '
                'n_samples_per_epoch (or a data_loader).')
        return int(batch_size), int(n_samples_per_epoch)

    # -- public geometry ------------------------------------------------ #
    @property
    def batch_size(self) -> int:
        """Batch size rows are addressed with (fixed per logger)."""
        return self._batch_size

    @property
    def n_samples_per_epoch(self) -> int:
        """Rows per training-epoch archive."""
        return self._n_samples_per_epoch

    @property
    def n_batches_per_epoch(self) -> int:
        """Batches per epoch (ceil division)."""
        return -(-self._n_samples_per_epoch // self._batch_size)

    @property
    def save_dir_path(self) -> str:
        """Directory holding the ``train/``/``eval/`` archives."""
        return self._save_dir_path

    # -- train channel (fixed-length epoch files) ----------------------- #
    def save_train_tensors(self, tensors: Dict, step_idx=None, epoch_idx=None,
                           batch_idx=None):
        """Save per-sample arrays for a training batch (or a whole epoch
        when only ``epoch_idx`` is given)."""
        self._require_sample_key(tensors)
        _, epoch_idx, batch_idx = self._resolve_address(
            step_idx, epoch_idx, batch_idx, batch_required=False)
        archive = self._open('train', epoch_idx)
        start = None if batch_idx is None else batch_idx * self._batch_size
        archive.fill_rows(start, _columns_from(tensors))
        archive.flush()

    def read_train_tensors(self, names: Optional[List[str]] = None,
                           step_idx=None, epoch_idx=None, batch_idx=None,
                           remove_nans=False) -> Dict[str, np.ndarray]:
        """Read saved training arrays; only written (masked-in) entries.

        ``remove_nans`` further drops rows with NaNs in every float column
        (``True``) or in one named column (a string).
        """
        _, epoch_idx, batch_idx = self._resolve_address(
            step_idx, epoch_idx, batch_idx, batch_required=False)
        archive = self._open('train', epoch_idx)
        keep = archive.columns[_WRITTEN].copy()
        if remove_nans is not False:
            keep &= _finite_rows(archive.columns, remove_nans)
        row_slice = slice(None)
        if batch_idx is not None:
            row_slice = slice(batch_idx * self._batch_size,
                              (batch_idx + 1) * self._batch_size)
        return archive.select(names, keep, row_slice)

    # -- eval channel (growable step files) ----------------------------- #
    def save_eval_tensors(self, tensors: Dict, step_idx=None, epoch_idx=None,
                          batch_idx=None, update=False):
        """Append (or, with ``update``, overwrite rows matched by sample
        index) per-sample evaluation arrays for a step."""
        self._require_sample_key(tensors)
        step_idx, _, _ = self._resolve_address(
            step_idx, epoch_idx, batch_idx, batch_required=True)
        archive = self._open('eval', step_idx)
        archive.merge_rows(_columns_from(tensors), update=update)
        archive.flush()

    def read_eval_tensors(self, names: Optional[List[str]] = None,
                          step_idx=None, epoch_idx=None, batch_idx=None,
                          remove_nans=False,
                          sort_by: Optional[str] = None
                          ) -> Dict[str, np.ndarray]:
        """Read saved evaluation arrays for a given step.

        ``sort_by`` reorders the whole archive by a column (persisted, so
        subsequent reads stay sorted).
        """
        step_idx, _, _ = self._resolve_address(
            step_idx, epoch_idx, batch_idx, batch_required=True)
        archive = self._open('eval', step_idx)
        if sort_by is not None:
            archive.sort_by(sort_by)
            archive.flush()
        keep = None
        if remove_nans is not False:
            keep = _finite_rows(archive.columns, remove_nans)
        return archive.select(names, keep)

    # -- internals ------------------------------------------------------ #
    def _open(self, channel: str, idx: int) -> _ColumnFile:
        cached = self._open_files[channel]
        if cached is not None and cached[0] == idx:
            return cached[1]
        if channel == 'train':
            path = os.path.join(self._train_dir_path, f'epoch-{idx}.npz')
            archive = _ColumnFile(path, n_rows=self._n_samples_per_epoch)
        else:
            path = os.path.join(self._eval_dir_path, f'step-{idx}.npz')
            archive = _ColumnFile(path)
        self._open_files[channel] = (idx, archive)
        return archive

    def _resolve_address(self, step_idx, epoch_idx, batch_idx,
                         batch_required: bool):
        """Normalize a (step | epoch[, batch]) address to all three parts."""
        per_epoch = self.n_batches_per_epoch
        if step_idx is not None:
            return (step_idx, *divmod(step_idx, per_epoch))
        if epoch_idx is None or (batch_idx is None and batch_required):
            raise ValueError(
                "Either 'step_idx' or both 'epoch_idx' and 'batch_idx' "
                'must be passed.' if batch_required else
                'Either step_idx or epoch_idx must be passed.')
        if batch_idx is None:
            return None, epoch_idx, None
        return epoch_idx * per_epoch + batch_idx, epoch_idx, batch_idx

    @classmethod
    def _require_sample_key(cls, tensors):
        if not any(key in tensors for key in _SAMPLE_KEYS):
            warnings.warn(
                'tensors does not contain any sample indices among: '
                f'{cls.INDEX_NAMES}. Without it, matching configurations to '
                'their reference potential may be difficult.')
