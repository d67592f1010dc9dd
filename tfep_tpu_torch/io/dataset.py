"""Host-side datasets feeding device batches.

A copy of ``tfep_tpu/io/dataset.py`` (numpy only).

The data layer is deliberately host-side numpy: trajectory frames are loaded,
selected and batched on the host and shipped to the device as whole sharded
batches (frames axis), so nothing here ever traces. Samples are dicts of
arrays keyed like the reference's datasets
(upstream tfep/io/dataset/dict.py:29-75,
upstream tfep/io/dataset/merged.py:27-80,
upstream tfep/io/dataset/traj.py:382-460).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = ['Dataset', 'DictDataset', 'MergedDataset', 'Subset',
           'TrajectorySubset']


class Dataset:
    """Map-style dataset: ``__len__`` + ``__getitem__`` -> dict of arrays.

    The torch ``Dataset``/``DataLoader`` pair the reference builds on is
    replaced by this minimal protocol plus
    :class:`tfep_tpu_torch.io.sampler.StatefulBatchSampler`: the trainer asks
    the sampler for index batches and the dataset for
    :meth:`get_batch`, then ships one whole dict of host arrays to the
    device (sharded on the frames axis). Subclasses should override
    :meth:`get_batch` when they can fetch a batch in one vectorized read
    — the base implementation just stacks per-sample ``__getitem__``
    results.
    """

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    def get_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Stack the samples at ``indices`` into a batch dict (host-side)."""
        samples = [self[int(i)] for i in indices]
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DictDataset(Dataset):
    """In-memory dataset over a dict of equal-length arrays.

    Parameters
    ----------
    data : dict of str -> array_like
        Named per-sample arrays sharing the same leading length. Indexing
        with an int returns a sample dict; indexing with a key name
        returns that whole column.
    """

    def __init__(self, data: Dict[str, Sequence]):
        self._data = {k: np.asarray(v) for k, v in data.items()}
        lengths = {k: len(v) for k, v in self._data.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f'All arrays must have equal length: {lengths}')

    @property
    def keys(self) -> List[str]:
        """Names of the per-sample arrays."""
        return list(self._data)

    def __len__(self):
        return len(next(iter(self._data.values())))

    def __getitem__(self, index):
        if isinstance(index, str):
            return self._data[index]
        return {k: v[index] for k, v in self._data.items()}

    def get_batch(self, indices):
        """One vectorized fancy-index read per column."""
        indices = np.asarray(indices)
        return {k: v[indices] for k, v in self._data.items()}


class MergedDataset(Dataset):
    """Zip-merge datasets with disjoint keys and equal lengths.

    The standard way to attach precomputed per-frame data (e.g. log-weights)
    to a trajectory dataset: ``MergedDataset(traj_dataset,
    DictDataset({'log_weights': w}))`` yields samples containing both
    datasets' keys.

    Parameters
    ----------
    *datasets : Dataset
        Datasets of identical length whose sample keys don't overlap.
    """

    def __init__(self, *datasets: Dataset):
        if len(datasets) == 0:
            raise ValueError('At least one dataset is required.')
        lengths = {len(d) for d in datasets}
        if len(lengths) > 1:
            raise ValueError('All merged datasets must have equal length.')
        # Verify key disjointness using the first sample.
        seen = set()
        for d in datasets:
            keys = set(d[0].keys())
            overlap = seen & keys
            if overlap:
                raise ValueError(f'Duplicate keys across datasets: {overlap}')
            seen |= keys
        self._datasets = datasets

    def __len__(self):
        return len(self._datasets[0])

    def __getitem__(self, index):
        out = {}
        for d in self._datasets:
            out.update(d[index])
        return out

    def get_batch(self, indices):
        """Union of every merged dataset's batch for ``indices``."""
        out = {}
        for d in self._datasets:
            out.update(d.get_batch(indices))
        return out

    @property
    def n_atoms(self) -> int:
        """Atom count of the (unique) merged trajectory dataset.

        Lets a merged dataset stand in for a plain trajectory dataset in
        the app layer (the reference merges aux data the same way,
        upstream tfep/io/dataset/merged.py), e.g. when
        ``create_dataset`` attaches precomputed bias/log-weights.
        """
        for d in self._datasets:
            n = getattr(d, 'n_atoms', None)
            if n is not None:
                return n
        raise AttributeError('No merged dataset exposes n_atoms.')


class Subset(Dataset):
    """Arbitrary-index view of a dataset.

    Mirrors the reference's ``TrajectorySubset``
    (upstream tfep/io/dataset/traj.py:470-540): indices are
    composed, not copied, so a subset of a lazy trajectory dataset still
    streams frames on demand. Exposed under both names (``Subset`` /
    ``TrajectorySubset``) for API parity.
    """

    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self._dataset = dataset
        self._indices = np.asarray(indices)

    @classmethod
    def from_filter(cls, dataset, filter_func):
        """Build a subset from a per-frame boolean filter.

        ``filter_func(idx, ts)`` receives the sample index and its
        :class:`~tfep_tpu_torch.io.traj.Timestep` record and returns whether to
        keep the frame — the reference's filter constructor
        (upstream tfep/io/dataset/traj.py:452-476).
        """
        indices = [idx for idx, ts in enumerate(dataset.iterate_as_timestep())
                   if filter_func(idx, ts)]
        return cls(dataset, indices)

    @property
    def dataset(self):
        """The wrapped dataset."""
        return self._dataset

    @property
    def indices(self):
        """Subset indices into the wrapped dataset."""
        return self._indices

    @property
    def trajectory_sample_indices(self) -> np.ndarray:
        """Absolute trajectory frame number of each subset sample."""
        return np.asarray(
            self._dataset.trajectory_sample_indices)[self._indices]

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, index):
        # Normalize now: the raw caller index is stamped into
        # dataset_sample_index below, and a negative value would later
        # silently select the wrong row from anything indexed by it
        # (e.g. reference_potentials[sample_idx] in the estimator).
        index = int(index)
        if index < 0:
            index += len(self)
        sample = self._dataset[int(self._indices[index])]
        if 'dataset_sample_index' in sample:
            # Samplers/loggers address *this* dataset: the sample index
            # must be the subset's, not the parent's (reference
            # TrajectorySubset.__getitem__, traj.py:508-518).
            sample = dict(sample, dataset_sample_index=np.int64(index))
        return sample

    def get_batch(self, indices):
        """Batch from the wrapped dataset at the composed indices."""
        indices = np.asarray(indices)
        indices = np.where(indices < 0, indices + len(self), indices)
        batch = self._dataset.get_batch(self._indices[indices])
        if 'dataset_sample_index' in batch:
            batch = dict(batch,
                         dataset_sample_index=indices.astype(np.int64))
        return batch

    def get_timestep(self, index: int):
        """The composed-index :class:`~tfep_tpu_torch.io.traj.Timestep` record."""
        return self._dataset.get_timestep(int(self._indices[index]))

    def iterate_as_timestep(self):
        """Iterate subset frames as Timestep records (delegated)."""
        for idx in range(len(self)):
            yield self.get_timestep(idx)

    def select_atoms(self, selection):
        """Select atoms on the wrapped dataset (shared with the parent)."""
        return self._dataset.select_atoms(selection)

    @property
    def n_atoms(self) -> int:
        """Atom count of the wrapped dataset (delegated)."""
        return self._dataset.n_atoms


#: Reference-API alias (the reference names this TrajectorySubset).
TrajectorySubset = Subset
