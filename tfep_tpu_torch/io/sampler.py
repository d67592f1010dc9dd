"""Stateful batch sampler for exact mid-epoch resume.

A copy of ``tfep_tpu/io/sampler.py``: the same ``shuffle_seed`` gives the
same permutations as the JAX package's sampler.

The epoch's shuffle permutation is derived from a stored seed; on resume the
sampler replays the same permutation and skips the first
``global_step % n_batches`` batches, so the union of visited samples across a
crash is exactly one epoch with no repeats (the invariant tested by the
reference at tests/app/test_maps.py:202-303). Reference behavior:
upstream tfep/io/sampler.py:29-192.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

import numpy as np

__all__ = ['StatefulBatchSampler']


class StatefulBatchSampler:
    """Batch sampler whose shuffle state is checkpointable.

    Iterating yields index arrays of (up to) ``batch_size`` dataset
    indices. Check-pointing stores only the epoch seed
    (:meth:`state_dict`); the resume position is re-derived from the
    trainer's ``global_step``, so a restored sampler yields exactly the
    batches not yet visited.

    Parameters
    ----------
    dataset : sequence
        Anything with ``__len__`` (indices are produced, not samples).
    batch_size : int, optional
        Samples per batch.
    shuffle : bool, optional
        Draw a fresh permutation each epoch (seeded, replayable).
    drop_last : bool, optional
        Drop the final incomplete batch.
    trainer : object, optional
        Must expose ``global_step`` (total optimizer steps so far) before
        iteration; may be attached later via the :attr:`trainer` attribute.
    shuffle_seed : int, optional
        Base seed for the per-epoch shuffle. ``None`` (the default, the
        reference's behavior) draws each epoch's seed from OS entropy —
        every training run visits a different batch order. Set it to make
        the whole shuffle sequence a deterministic function of
        ``(shuffle_seed, epoch)``: runs become exactly reproducible while
        epochs still differ from each other. Checkpoint/resume semantics
        are identical either way (the drawn epoch seed is what gets
        stored and replayed).
    """

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, trainer=None,
                 shuffle_seed: Optional[int] = None):
        """``trainer`` must expose a ``global_step`` attribute (total batches
        seen across the entire training), set here or later via the
        :attr:`trainer` attribute."""
        self._dataset = dataset
        self._batch_size = int(batch_size)
        self._shuffle = bool(shuffle)
        self._drop_last = bool(drop_last)
        self._current_epoch_seed: Optional[int] = None
        if shuffle_seed is not None and int(shuffle_seed) < 0:
            # SeedSequence rejects negative entropy — fail here with
            # context rather than deep inside the first epoch's __iter__.
            raise ValueError(
                f'shuffle_seed must be a non-negative int or None, got '
                f'{shuffle_seed}.')
        self._shuffle_seed = shuffle_seed
        self.trainer = trainer

    @property
    def batch_size(self) -> int:
        """Samples per yielded batch."""
        return self._batch_size

    @property
    def shuffle(self) -> bool:
        """Whether a fresh permutation is drawn each epoch."""
        return self._shuffle

    @property
    def drop_last(self) -> bool:
        """Whether the final incomplete batch is dropped."""
        return self._drop_last

    def __len__(self) -> int:
        n = len(self._dataset)
        if self._drop_last:
            return n // self._batch_size
        return (n + self._batch_size - 1) // self._batch_size

    def __iter__(self) -> Iterator[np.ndarray]:
        if self.trainer is None:
            raise RuntimeError('trainer must be set before iterating.')

        # != 0 when resuming from a mid-epoch checkpoint.
        current_batch_idx = self.trainer.global_step % len(self)

        if self._shuffle:
            if current_batch_idx == 0 or (
                    self._shuffle_seed is not None
                    and self._current_epoch_seed is None):
                # New epoch: draw a fresh seed (kept for checkpointing).
                # The second condition covers a seeded mid-epoch start
                # where only global_step was restored (no
                # load_state_dict): the epoch seed is a pure function of
                # (shuffle_seed, epoch), so recomputing it reproduces the
                # interrupted epoch's permutation exactly — an unseeded
                # sampler cannot do this and must rely on the stored seed.
                if self._shuffle_seed is None:
                    entropy = np.random.SeedSequence().entropy
                else:
                    # Deterministic in (shuffle_seed, epoch): spawn the
                    # epoch's stream from the base seed so reruns replay
                    # the same shuffle sequence while epochs differ.
                    epoch = self.trainer.global_step // len(self)
                    entropy = int(np.random.SeedSequence(
                        [self._shuffle_seed, epoch]).generate_state(
                            1, np.uint64)[0])
                self._current_epoch_seed = int(entropy % (2 ** 63))
            rng = np.random.default_rng(self._current_epoch_seed)
            epoch_indices = rng.permutation(len(self._dataset))
        else:
            epoch_indices = np.arange(len(self._dataset))

        for batch_idx in range(current_batch_idx, len(self)):
            start = batch_idx * self._batch_size
            yield epoch_indices[start:start + self._batch_size]

    def state_dict(self) -> dict:
        """Checkpoint payload: the current epoch's shuffle seed (the
        resume position is re-derived from the trainer's global step,
        cf. upstream tfep/io/sampler.py:165-192)."""
        return {'current_epoch_seed': self._current_epoch_seed}

    def load_state_dict(self, state_dict: dict):
        """Restore the epoch seed saved by :meth:`state_dict`."""
        self._current_epoch_seed = state_dict['current_epoch_seed']
