"""Training loop with exact mid-epoch resume.

Port of ``tfep_tpu/app/trainer.py``. The trainer owns the optimization loop
(a ``torch.optim`` optimizer), checkpointing of the flow, the optimizer,
the sampler's seed and the global step, and per-step TFEP logging. Each
step is one forward/backward/update on the map's device; the host moves
batches and writes logs while the device works.

Resume semantics: restarting from a mid-epoch checkpoint replays the same
epoch permutation and visits exactly the unseen batches.

Deferred logging: a step's aux tensors are copied into pinned host memory
without blocking, and read only after the next step has been launched, so
the host writes step k-1's log rows while the card runs step k. Only a
checkpoint (which acknowledges its step) and the end of the run wait for
the last step.

Engine overlap (``engine_overlap=True``): the flow's forward of batch
k+1 runs on the card while a host thread runs the external engine on
batch k, and each update applies the exact gradient at the parameters the
engine saw (one step delayed). See :meth:`Trainer._fit_pipelined`.

Data parallelism (``sharding=batch_sharding(mesh)``, see
:mod:`tfep_tpu_torch.parallel.sharding`): one process per device, each
training on its own shard of the frames (``host_frame_indices``) with
``batch_size`` rows per step; after each backward one all-reduce over the
mesh's ``dp`` axis averages the gradients and the loss, so every rank
applies the update of the global batch and records the same loss. Rank 0
alone writes the checkpoint; a flow whose MADE layers are split over the
``tp`` axis (``shard_module``) keeps its shards, and its checkpoint holds
the whole tensors.
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tfep_tpu_torch.io.sampler import StatefulBatchSampler
from tfep_tpu_torch.utils import tracing

__all__ = ['Trainer', 'load_map_from_checkpoint', 'default_optimizer']

# Bump when the checkpoint layout changes incompatibly. Loaders accept any
# version <= current; newer files raise a clear error.
CHECKPOINT_FORMAT_VERSION = 1


def default_optimizer(params) -> torch.optim.Optimizer:
    """AdamW with the JAX package's default, ``optax.adamw(1e-4)``: its
    weight decay is 1e-4 (``torch.optim.AdamW``'s own default is 0.01)."""
    return torch.optim.AdamW(params, lr=1e-4, weight_decay=1e-4, eps=1e-8)


class Trainer:
    """Train a TFEP map.

    Parameters
    ----------
    save_dir : str, optional
        Directory for checkpoints. ``None`` disables checkpointing.
    max_epochs, max_steps : int, optional
        Stop conditions (whichever comes first).
    optimizer : callable, optional
        A factory ``params -> torch.optim.Optimizer``, called once per
        :meth:`fit` on the flow's trainable parameters (so that a resumed
        run can rebuild the optimizer before loading its state). Defaults
        to :func:`default_optimizer`.
    checkpoint_every_n_steps : int, optional
        Write ``last.ckpt`` every N steps (default 1).
    shuffle : bool, optional
        Shuffle batches each epoch through the stateful sampler.
    shuffle_seed : int, optional
        Base seed for the per-epoch shuffles. ``None`` (default) draws
        each epoch's permutation from OS entropy; an int makes the whole
        batch-order sequence reproducible run-to-run (see
        :class:`tfep_tpu_torch.io.sampler.StatefulBatchSampler`).
    prefetch : bool, optional
        Read the next batch (``dataset.get_batch`` and the copy into
        pinned memory) on a background thread while the current step
        runs. Identical math and resume semantics either way. Ignored by
        the ``engine_overlap`` pipeline, which already overlaps host work
        with device compute.
    drop_last : bool, optional
        Drop the final incomplete batch of each epoch.
    sharding : BatchSharding, optional
        Data parallelism over a mesh's ``dp`` axis
        (:func:`tfep_tpu_torch.parallel.sharding.batch_sharding`). Each
        rank trains on its ``host_frame_indices`` shard of the map's
        dataset (the logged ``dataset_sample_index`` stays the dataset's),
        ``batch_size`` is the local batch, and the gradients and the loss
        are averaged over the axis after each backward: with the local
        batches equal in size, the update and :attr:`loss_history` are
        the global batch's (up to the order of the sums), on every rank.
        The exception is a loss that is not a plain mean over the batch
        (``log_weights``, or NaN samples dropped by ``ignore_nan``): it is
        averaged over the ranks' batches as they are. Unseeded shuffles
        use one seed drawn on rank 0. At the start of :meth:`fit` each
        rank takes the parameters of the first rank of its ``dp`` group.
        The default optimizer is elementwise; an ``optimizer`` that
        reduces over the whole model (clipping by the global norm) must
        take a tensor-parallel flow's shards over their group, as
        :func:`tfep_tpu_torch.parallel.sharding.clip_grad_norm_` does.
    log_every_n_steps : int, optional
        Print ``epoch/step/loss`` every N optimization steps; 0 disables
        console output. The loss of every step is recorded in
        :attr:`loss_history` regardless.
    engine_overlap : bool, optional
        Pipeline the target-potential engine against device compute: the
        flow forward of batch k+1 runs while the host engine evaluates
        batch k, and each update applies the exact loss gradient at the
        parameters the engine saw (one-step delayed, standard pipelined
        SGD). Step time approaches max(device, engine) instead of their
        sum. Requires the map to implement the ``forward_step_fn`` /
        ``host_engine_eval`` / ``pipelined_update_fn`` contract
        (TFEPMapBase does) with an
        :class:`~tfep_tpu_torch.potentials.EnginePotential` target.
    profile_dir : str, optional
        Trace steps ``profile_steps`` with ``torch.profiler`` and write the
        trace to ``profile_dir/trace.json`` (Chrome/Perfetto format). Over
        the same steps the port's span recorder
        (:mod:`tfep_tpu_torch.utils.tracing`) is on, and its spans join
        the trace as complete (``X``) events on the trace's time base, in
        the rows of the threads that opened them, so that Perfetto shows
        them beside the device's rows. The spans: the names of
        :attr:`host_seconds`; ``read_wait`` (the main thread waiting for
        the prefetch thread's batch); ``step.forward``, ``step.backward``
        and ``step.optimizer`` inside ``step``; the layers'
        ``zmatrix.to_internal``, ``zmatrix.to_cartesian``,
        ``maf.conditioner``, ``maf.transformer`` and each one's
        ``.backward`` (on the thread that runs the backward), and
        ``ode.step``. The profile stays in :attr:`profile`, and each
        profiled step's time (from one step's start to the next's, on the
        card's clock when the map is on a card) in
        :attr:`profiled_step_times`.
    profile_steps : (int, int), optional
        Half-open ``[start, stop)`` global-step window to trace.

    Attributes
    ----------
    host_seconds : dict
        ``{name: [seconds, calls]}`` of the host's work in :meth:`fit`:
        ``read`` (``get_batch`` and the copy into pinned memory, on the
        prefetch thread when ``prefetch``), ``to_device`` (enqueuing the
        copy to the device), ``step`` (enqueuing forward, backward and
        update), ``wait`` (waiting for a finished step's aux), ``log``
        (the logger and the loss channel) and ``checkpoint``. The
        ``engine_overlap`` pipeline adds ``forward`` (enqueuing phase A,
        the forward whose positions go to the engine), ``engine`` (the
        engine's host call, on its thread) and ``engine_wait`` (the main
        thread waiting for an engine result); its ``step`` enqueues the
        update of phase C. With ``sharding``, ``allreduce`` is the
        average of the gradients and the loss over the ``dp`` axis (it
        waits for the backward).
    """

    CHECKPOINT_NAME = 'last.ckpt'

    def __init__(self, save_dir: Optional[str] = None,
                 max_epochs: Optional[int] = None,
                 max_steps: Optional[int] = None,
                 optimizer: Optional[Callable] = None,
                 checkpoint_every_n_steps: int = 1,
                 shuffle: bool = True,
                 shuffle_seed: Optional[int] = None,
                 prefetch: bool = False,
                 drop_last: bool = False,
                 sharding=None,
                 log_every_n_steps: int = 0,
                 engine_overlap: bool = False,
                 profile_dir: Optional[str] = None,
                 profile_steps: tuple = (2, 5)):
        if max_epochs is None and max_steps is None:
            raise ValueError('Set at least one of max_epochs/max_steps.')
        if sharding is not None and not hasattr(sharding, 'group'):
            raise TypeError('sharding must be a batch_sharding(mesh) of '
                            'tfep_tpu_torch.parallel.sharding.')
        self.sharding = sharding
        self.save_dir = save_dir
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.optimizer = (default_optimizer if optimizer is None
                          else optimizer)
        self.checkpoint_every_n_steps = checkpoint_every_n_steps
        self.shuffle = shuffle
        self.shuffle_seed = shuffle_seed
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.log_every_n_steps = log_every_n_steps
        self.engine_overlap = engine_overlap

        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)
        self.profile = None

        self.global_step = 0
        self.current_epoch = 0
        self.loss_history: list = []
        self.profiled_step_times: list = []
        self.host_seconds: Dict[str, list] = {}
        self._profiler = None
        self._profile_marks: list = []
        self._on_card = False
        self._resume_snapshot = None
        self._dataset = None

    # ------------------------------------------------------------------ #
    @property
    def checkpoint_path(self) -> Optional[str]:
        """Full path of ``last.ckpt``, or ``None`` when checkpointing is
        disabled."""
        if self.save_dir is None:
            return None
        return os.path.join(self.save_dir, self.CHECKPOINT_NAME)

    def fit(self, tfep_map, resume: bool = False):
        """Run the optimization loop on ``tfep_map``; returns its flow.

        ``tfep_map`` implements the app contract: ``setup()``, ``dataset``,
        ``batch_size``, ``flow`` (an ``nn.Module``, trained in place),
        ``host_tensors``/``batch_to_device``,
        ``training_step_fn(flow, batch) -> (loss, aux_dict)`` and
        optionally ``log_train_tensors(aux, epoch_idx, batch_idx)``. With
        ``resume``, training continues from ``last.ckpt`` when it exists.
        """
        tfep_map.setup()
        self._on_card = tfep_map.device.type == 'cuda'
        if getattr(tfep_map, 'trainer', None) is None:
            tfep_map.trainer = self
        # The embedded map config is immutable across a fit: test-pickle it
        # (which may include an in-memory System) once, not per step.
        self._map_config = _map_config_entries(tfep_map)

        self._dataset = tfep_map.dataset
        shuffle_seed = self.shuffle_seed
        flow = tfep_map.flow
        if self.sharding is not None:
            from tfep_tpu_torch.parallel.distributed import (
                host_frame_indices,
            )
            from tfep_tpu_torch.parallel.sharding import replicate
            self._dataset = _FrameShard(self._dataset, host_frame_indices(
                len(self._dataset), self.sharding.rank, self.sharding.size))
            if self.shuffle and shuffle_seed is None:
                shuffle_seed = _shared_seed(tfep_map.device)
            replicate(flow, group=self.sharding.group)
        sampler = StatefulBatchSampler(
            self._dataset, batch_size=tfep_map.batch_size,
            shuffle=self.shuffle, drop_last=self.drop_last, trainer=self,
            shuffle_seed=shuffle_seed)
        n_batches = len(sampler)

        params = [p for p in flow.parameters() if p.requires_grad]
        optimizer = self.optimizer(params)
        if resume:
            self._load_checkpoint(flow, optimizer, sampler)

        loop = self._fit_pipelined if self.engine_overlap else self._fit_loop
        try:
            pending = loop(tfep_map, sampler, flow, optimizer, params,
                           n_batches)
        finally:
            self._stop_profiler()
        if pending is not None:
            self._consume_aux(tfep_map, *pending)
        return flow

    def _fit_loop(self, tfep_map, sampler, flow, optimizer, params,
                  n_batches):
        pending = None  # (host aux, its event, epoch_idx, batch_idx)
        stop = False
        while not stop:
            if self.max_epochs is not None and \
                    self.current_epoch >= self.max_epochs:
                break
            # Pre-check so resuming an already-finished run trains zero
            # extra steps (the in-loop check only fires after a step).
            if self.max_steps is not None and \
                    self.global_step >= self.max_steps:
                break
            epoch_idx = self.current_epoch
            for host_batch in self._epoch_batches(tfep_map, sampler):
                batch_idx = self.global_step % n_batches
                tracing.set_step(self.global_step)
                batch = self._device_batch(tfep_map, host_batch,
                                           step=self.global_step)

                self._profile_tick()
                aux, event = self._step(tfep_map, flow, optimizer, params,
                                        batch)
                # Per-sample TFEP logging + loss channel, deferred by one
                # step: the host reads the previous step's aux while the
                # device runs this one.
                if pending is not None:
                    self._consume_aux(tfep_map, *pending)
                pending = (aux, event, epoch_idx, batch_idx,
                           self.global_step)

                self.global_step += 1
                # Derived, not incremented at the epoch boundary: an
                # epoch-boundary checkpoint must store the *next* epoch or
                # a resume replays a full extra epoch.
                self.current_epoch = self.global_step // n_batches
                self._profile_tock()

                if (self.checkpoint_path is not None
                        and self.global_step % self.checkpoint_every_n_steps
                        == 0):
                    # Flush this step's log rows first: the checkpoint
                    # acknowledges the step, so a crash right after must
                    # not lose its per-sample work values (resume skips
                    # the batch).
                    self._consume_aux(tfep_map, *pending)
                    pending = None
                    with self._timed('checkpoint'):
                        self._save_checkpoint(flow, optimizer, sampler,
                                              tfep_map)

                if self.max_steps is not None and \
                        self.global_step >= self.max_steps:
                    stop = True
                    break
            else:
                continue
            break
        return pending

    def _step(self, tfep_map, flow, optimizer, params, batch):
        """Launch one optimization step; returns its aux on the host (still
        being copied) and the event that marks the copy's end (``None``
        off the card)."""
        with self._timed('step'):
            optimizer.zero_grad(set_to_none=True)
            with tracing.span('step.forward'):
                loss, aux = tfep_map.training_step_fn(flow, batch)
            with tracing.span('step.backward'):
                loss.backward()
                tracing.end_backward()
                # A parameter that the loss does not read has no gradient:
                # torch's AdamW would skip it, optax decays it. Give it
                # zeros.
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            if self.sharding is not None:
                aux = dict(aux, loss=self._average_over_batch_axis(
                    params, aux['loss']))
            with tracing.span('step.optimizer'):
                optimizer.step()
            return _aux_to_host(aux)

    def _average_over_batch_axis(self, params, loss):
        """Average the gradients and the loss over the ``dp`` axis, one
        all-reduce per dtype; returns the global loss."""
        with self._timed('allreduce'):
            loss = loss.detach().clone().reshape(1)
            buckets = {}
            for t in [p.grad for p in params] + [loss]:
                buckets.setdefault(t.dtype, []).append(t)
            for tensors in buckets.values():
                flat = torch.cat([t.reshape(-1) for t in tensors])
                dist.all_reduce(flat, group=self.sharding.group)
                flat /= self.sharding.size
                for t, part in zip(tensors, flat.split(
                        [t.numel() for t in tensors])):
                    t.copy_(part.view_as(t))
            return loss.reshape(())

    # ------------------------------------------------------------------ #
    def _fit_pipelined(self, tfep_map, sampler, flow, optimizer, params,
                       n_batches):
        """Engine-overlap loop: the forward of batch k+1 runs on the device
        while a host thread runs the engine on batch k; each update applies
        the exact gradient at the parameters the engine saw (one-step
        delayed SGD).

        ``optimizer.step()`` changes the parameters in place, so each
        batch keeps a snapshot (a clone) of the trainable parameters its
        forward saw; its update differentiates the map's surrogate loss
        through ``torch.func.functional_call`` on that snapshot and writes
        the gradients into the current parameters' ``.grad``. The
        positions reach the engine thread through pinned memory and an
        event recorded right after the forward, so the copy never waits
        for the update enqueued behind it; the engine's results come back
        through pinned memory with a non-blocking copy.

        The pipeline drains at each epoch boundary. A checkpoint taken
        mid-epoch also stores the snapshot of the next batch (the
        parameters before the last update), so a resumed run continues
        on the same delayed gradients as a run that was not stopped.
        Returns the last step's aux, as :meth:`_fit_loop` does.
        """
        names = [name for name, p in flow.named_parameters()
                 if p.requires_grad]
        executor = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix='tfep-engine')
        in_flight = None  # (future, snapshot, batch, epoch_idx, batch_idx)
        logged = None     # (host aux, its event, epoch_idx, batch_idx)
        next_snapshot, self._resume_snapshot = self._resume_snapshot, None

        def on_snapshot(snapshot):
            return _SnapshotFlow(flow, dict(zip(names, snapshot)))

        def apply(entry):
            """Phase C of ``entry``: its update, logging, checkpoint."""
            nonlocal logged
            future, snapshot, batch, epoch_idx, batch_idx = entry
            step = self.global_step + 1
            checkpoint = (self.checkpoint_path is not None
                          and step % self.checkpoint_every_n_steps == 0)
            keep = None
            if checkpoint and in_flight is not None:
                keep = in_flight[1]
            elif checkpoint and step % n_batches != 0:
                # Stopped mid-epoch: the next batch's forward would have
                # seen the parameters before this update.
                keep = [p.detach().clone() for p in params]
            tracing.set_step(step - 1)
            with self._timed('engine_wait'):
                potentials, forces = future.result()
            self._profile_tick()
            with self._timed('step'):
                like = batch['positions']
                potentials, forces = (
                    t.to(like.device, like.dtype, non_blocking=True)
                    for t in (potentials, forces))
                leaves = [s.requires_grad_() for s in snapshot]
                loss, aux = tfep_map.pipelined_update_fn(
                    on_snapshot(leaves), batch, potentials, forces)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
                # An unread parameter gets zeros, as on the plain path.
                for p, g in zip(params, grads):
                    p.grad = torch.zeros_like(p) if g is None else g
                if self.sharding is not None:
                    aux = dict(aux, loss=self._average_over_batch_axis(
                        params, aux['loss']))
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
                host_aux = _aux_to_host(aux)
            if logged is not None:
                self._consume_aux(tfep_map, *logged)
            logged = (*host_aux, epoch_idx, batch_idx, step - 1)
            self.global_step = step
            # Derived like in _fit_loop: checkpoints written at an epoch
            # boundary must store the next epoch.
            self.current_epoch = self.global_step // n_batches
            self._profile_tock()
            if checkpoint:
                self._consume_aux(tfep_map, *logged)
                logged = None
                with self._timed('checkpoint'):
                    self._save_checkpoint(
                        flow, optimizer, sampler, tfep_map,
                        None if keep is None else dict(zip(names, keep)))

        # Forward passes run one batch ahead of applied updates.
        fwd_count = self.global_step
        stop = False
        try:
            while not stop:
                if self.max_epochs is not None and \
                        self.current_epoch >= self.max_epochs:
                    break
                if self.max_steps is not None and \
                        self.global_step >= self.max_steps:
                    break
                epoch_idx = self.current_epoch
                for indices in sampler:
                    tracing.set_step(fwd_count)
                    host_batch = self._read(tfep_map, indices)
                    batch_idx = fwd_count % n_batches
                    batch = self._device_batch(tfep_map, host_batch,
                                               step=fwd_count)
                    fwd_count += 1

                    # Phase A (device): the forward at the parameters of
                    # this moment, kept as the batch's snapshot.
                    snapshot = next_snapshot
                    if snapshot is None:
                        snapshot = [p.detach().clone() for p in params]
                    next_snapshot = None
                    with self._timed('forward'), torch.no_grad():
                        result = tfep_map.forward_step_fn(
                            on_snapshot(snapshot), batch)
                        mapped, ready = _aux_to_host(
                            {'positions': result['positions']})
                    # Phase B (host thread): the engine on this batch.
                    future = executor.submit(
                        self._engine_eval, tfep_map, mapped['positions'],
                        ready, host_batch, fwd_count - 1)
                    # Phase C: finish the previous batch while the engine
                    # works on this one.
                    previous, in_flight = in_flight, (
                        future, snapshot, batch, epoch_idx, batch_idx)
                    if previous is not None:
                        apply(previous)

                    if self.max_steps is not None and \
                            self.global_step + 1 >= self.max_steps:
                        stop = True
                        break
                else:
                    # Drain before the sampler restarts: its resume
                    # arithmetic (and the derived current_epoch) come
                    # from global_step, which must not lag at the boundary.
                    if in_flight is not None:
                        last, in_flight = in_flight, None
                        apply(last)
                    continue
                break

            if in_flight is not None:
                last, in_flight = in_flight, None
                apply(last)
        finally:
            executor.shutdown(wait=False, cancel_futures=True)
        return logged

    def _engine_eval(self, tfep_map, positions, ready, host_batch, step):
        """Phase B on the engine thread: wait for the positions' copy (and
        nothing else), run the engine, return its reduced potentials and
        forces as CPU tensors (pinned when the map is on a card)."""
        if ready is not None:
            ready.synchronize()
        with self._timed('engine', step):
            results = tfep_map.host_engine_eval(positions.numpy(),
                                                host_batch)
        return tuple(_pinned(np.asarray(r), self._on_card) for r in results)

    # ------------------------------------------------------------------ #
    def _timed(self, name, step=None):
        """``name``'s seconds into :attr:`host_seconds`, and its span while
        the recorder is on (``step``: as :func:`tracing.timed`)."""
        return tracing.timed(self.host_seconds, name, step)

    # ------------------------------------------------------------------ #
    # Profiler: a torch.profiler trace and each step's time over the
    # configured global-step window.
    # ------------------------------------------------------------------ #
    def _profile_tick(self):
        if self.profile_dir is None or not (
                self.profile_steps[0] <= self.global_step
                < self.profile_steps[1]):
            return
        if self._profiler is None:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self._on_card:
                torch.cuda.synchronize()
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.__enter__()
            tracing.start()
            self._profile_marks = []
        self._profile_marks.append(_mark(self._on_card))

    def _profile_tock(self):
        if self._profiler is not None and \
                self.global_step >= self.profile_steps[1]:
            self._stop_profiler()

    def _stop_profiler(self):
        if self._profiler is None:
            return
        end = _mark(self._on_card)
        if self._on_card:
            torch.cuda.synchronize()
        spans = tracing.stop()
        self._profiler.__exit__(None, None, None)
        marks = self._profile_marks + [end]
        self.profiled_step_times.extend(
            _seconds_between(a, b) for a, b in zip(marks, marks[1:]))
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(self.profile_dir, 'trace.json')
        self._profiler.export_chrome_trace(path)
        _add_spans_to_chrome_trace(path, spans)
        self.profile, self._profiler = self._profiler, None

    # ------------------------------------------------------------------ #
    def _epoch_batches(self, tfep_map, sampler):
        """Yield one epoch's batches as host tensors.

        With ``prefetch=True`` a background thread reads one batch ahead:
        batch k+1's read is submitted before batch k is yielded. The
        sampler iterates on this thread, so the seeds are drawn exactly
        as without prefetch; an early exit (``max_steps`` mid-epoch closes
        the generator) waits for at most the one read in flight.
        """
        first = self.global_step
        if not self.prefetch:
            for step, indices in enumerate(sampler, first):
                yield self._read(tfep_map, indices, step)
            return

        with ThreadPoolExecutor(
                max_workers=1,
                thread_name_prefix='tfep-batch-prefetch') as pool:
            pending = None
            for step, indices in enumerate(sampler, first):
                future = pool.submit(self._read, tfep_map, indices, step)
                if pending is not None:
                    yield self._wait_for_read(pending, step - 1)
                pending = future
            if pending is not None:
                yield self._wait_for_read(pending, self.global_step)

    @staticmethod
    def _wait_for_read(future, step):
        with tracing.span('read_wait', step):
            return future.result()

    def _read(self, tfep_map, indices, step=None):
        with self._timed('read', step):
            return tfep_map.host_tensors(self._dataset.get_batch(indices))

    def _device_batch(self, tfep_map, host_batch, step=None):
        with self._timed('to_device'):
            batch = tfep_map.batch_to_device(host_batch)
        if step is not None and getattr(tfep_map, 'needs_global_step', False):
            # Maps opt in to fold the step into stochastic state.
            batch['global_step'] = step
        return batch

    def _consume_aux(self, tfep_map, aux, event, epoch_idx, batch_idx, step):
        """Read a finished step's aux: TFEP logging + loss channel."""
        if event is not None:
            with self._timed('wait', step):
                event.synchronize()
        with self._timed('log', step):
            if hasattr(tfep_map, 'log_train_tensors'):
                tfep_map.log_train_tensors(aux, epoch_idx=epoch_idx,
                                           batch_idx=batch_idx)
            scalars = {name: float(value) for name, value in aux.items()
                       if np.ndim(value) == 0}
            loss = scalars.get('loss')
            if loss is not None:
                self.loss_history.append(loss)
            if self.log_every_n_steps and loss is not None and \
                    len(self.loss_history) % self.log_every_n_steps == 0:
                extras = ' '.join(f'{k}={v:.6g}' for k, v in scalars.items()
                                  if k != 'loss')
                print(f'[tfep] epoch {epoch_idx} step '
                      f'{len(self.loss_history)} loss={loss:.6g}'
                      + (f' {extras}' if extras else ''), flush=True)

    # ------------------------------------------------------------------ #
    def _save_checkpoint(self, flow, optimizer, sampler, tfep_map=None,
                         pipeline_snapshot=None):
        """Write ``last.ckpt``: the whole tensors of a tensor-parallel flow
        (gathered, so every rank takes part), written by rank 0 alone."""
        shards = _shards(flow)
        flow_state = flow.state_dict()
        optimizer_state = optimizer.state_dict()
        if shards:
            from tfep_tpu_torch.parallel.distributed import gather
            from tfep_tpu_torch.parallel.sharding import full_state_dict
            flow_state = full_state_dict(flow)
            _map_shards(optimizer, optimizer_state, flow, shards,
                        lambda t, dim, group, size: gather(t, dim, group))
            if pipeline_snapshot is not None:
                pipeline_snapshot = {
                    name: gather(t, *shards[name][:2]) if name in shards
                    else t for name, t in pipeline_snapshot.items()}
        if self.sharding is not None and dist.get_rank() != 0:
            return
        os.makedirs(self.save_dir, exist_ok=True)
        state = {
            'format_version': CHECKPOINT_FORMAT_VERSION,
            'flow_state': flow_state,
            'optimizer_state': optimizer_state,
            'global_step': self.global_step,
            'current_epoch': self.current_epoch,
            'sampler_state': sampler.state_dict(),
        }
        if pipeline_snapshot is not None:
            # The engine_overlap pipeline's next forward runs on these.
            state['pipeline_snapshot'] = pipeline_snapshot
        config = getattr(self, '_map_config', None)
        state.update(_map_config_entries(tfep_map)
                     if config is None else config)
        tmp_path = self.checkpoint_path + '.tmp'
        torch.save(state, tmp_path)
        os.replace(tmp_path, self.checkpoint_path)

    def _load_checkpoint(self, flow, optimizer, sampler):
        path = self.checkpoint_path
        if self.sharding is not None:
            # Rank 0 has finished writing before any rank looks.
            dist.barrier()
        if path is None or not os.path.isfile(path):
            return
        state = _read_checkpoint(path)
        # A tensor-parallel flow cuts the whole tensors to its shards.
        flow.load_state_dict(state['flow_state'])
        shards = _shards(flow)
        optimizer_state = state['optimizer_state']
        if shards:
            from tfep_tpu_torch.parallel.sharding import local_slice
            _map_shards(optimizer, optimizer_state, flow, shards,
                        lambda t, dim, group, size: local_slice(
                            t, dim, dist.get_rank(group), size),
                        whole=True)
        optimizer.load_state_dict(optimizer_state)
        self.global_step = state['global_step']
        self.current_epoch = state['current_epoch']
        sampler.load_state_dict(state['sampler_state'])
        snapshot = state.get('pipeline_snapshot')
        if snapshot is not None and self.engine_overlap:
            named = dict(flow.named_parameters())
            self._resume_snapshot = [
                _shard_of(snapshot[name], shards.get(name)).to(
                    named[name].device, named[name].dtype)
                for name, p in named.items() if p.requires_grad]


class _FrameShard:
    """The frames ``indices`` of ``dataset`` as a dataset of their own;
    batches keep the dataset's own sample indices."""

    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def get_batch(self, indices):
        return self.dataset.get_batch(self.indices[np.asarray(indices)])


def _shared_seed(device) -> int:
    """A shuffle seed drawn on rank 0 and broadcast to every rank."""
    seed = torch.tensor([np.random.SeedSequence().entropy % (2 ** 62)],
                        dtype=torch.int64, device=device)
    dist.broadcast(seed, src=0)
    return int(seed.item())


def _shards(flow) -> Dict[str, tuple]:
    """``{parameter name: (split axis, group, group size)}`` of a
    tensor-parallel flow's shards (empty for any other flow)."""
    from tfep_tpu_torch.parallel.sharding import sharded_parameters
    return {name: (dim, group, dist.get_world_size(group))
            for name, (dim, group) in sharded_parameters(flow).items()}


def _shard_of(tensor, shard):
    """This rank's shard of a whole tensor (``shard``: as in
    :func:`_shards`, ``None`` for a replicated one)."""
    if shard is None:
        return tensor
    from tfep_tpu_torch.parallel.sharding import local_slice
    dim, group, size = shard
    return local_slice(tensor, dim, dist.get_rank(group), size)


def _map_shards(optimizer, state, flow, shards, fn, whole=False):
    """Replace, in the optimizer's ``state`` dict, each tensor that has the
    shape of a sharded parameter of ``flow`` (its whole shape if
    ``whole``) by ``fn(tensor, dim, group, size)``."""
    names = {id(p): name for name, p in flow.named_parameters()
             if name in shards}
    for group, saved in zip(optimizer.param_groups, state['param_groups']):
        for p, index in zip(group['params'], saved['params']):
            name = names.get(id(p))
            if name is None or index not in state['state']:
                continue
            dim, process_group, size = shards[name]
            shape = list(p.shape)
            if whole:
                shape[dim] *= size
            state['state'][index] = {
                key: fn(value, dim, process_group, size)
                if torch.is_tensor(value) and list(value.shape) == shape
                else value
                for key, value in state['state'][index].items()}


def _mark(on_card: bool):
    """A point in time: a recorded CUDA event on a card, else the host's
    clock."""
    if on_card:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _seconds_between(a, b) -> float:
    if isinstance(a, float):
        return b - a
    return a.elapsed_time(b) / 1e3


class _SnapshotFlow:
    """``flow`` run on other values of its trainable parameters (a
    ``{name: tensor}`` dict; tied parameters stay tied)."""

    def __init__(self, flow, parameters):
        self.flow, self.parameters = flow, parameters

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.flow, self.parameters, args,
                                          kwargs)


def _add_spans_to_chrome_trace(path: str, spans):
    """Append the recorder's ``spans`` to the Chrome trace at ``path`` as
    complete events, on the trace's time base (microseconds after its
    ``baseTimeNanoseconds``) and in the rows of their threads."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get('baseTimeNanoseconds', 0)
    pid = os.getpid()
    trace['traceEvents'].extend(
        dict(ph='X', cat='tfep_span', name=s.name, pid=pid,
             tid=s.native_thread, ts=(s.start_ns - base) / 1e3,
             dur=(s.end_ns - s.start_ns) / 1e3,
             args=dict(id=s.id, parent=s.parent, step=s.step,
                       thread=s.thread_name))
        for s in spans)
    with open(path, 'w') as f:
        json.dump(trace, f)


def _pinned(array: np.ndarray, on_card: bool) -> torch.Tensor:
    """A host array as a CPU tensor, in pinned memory when ``on_card``."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if not on_card:
        return tensor
    return torch.empty(tensor.shape, dtype=tensor.dtype,
                       pin_memory=True).copy_(tensor)


def _aux_to_host(aux: Dict):
    """Detach every tensor of ``aux``; start copying those on a card into
    pinned host memory without blocking. Returns the host dict and the
    event that marks the copies' end (``None`` when nothing was on a
    card)."""
    host, on_card = {}, False
    for name, value in aux.items():
        if isinstance(value, torch.Tensor):
            value = value.detach()
            if value.is_cuda:
                pinned = torch.empty(value.shape, dtype=value.dtype,
                                     pin_memory=True)
                value = pinned.copy_(value, non_blocking=True)
                on_card = True
        host[name] = value
    if not on_card:
        return host, None
    event = torch.cuda.Event()
    event.record()
    return host, event


def _map_config_entries(tfep_map) -> Dict[str, Any]:
    """Checkpoint entries embedding the map's constructor config.

    Each hyperparameter is test-pickled individually; values that cannot
    be serialized (e.g. live engine handles) are recorded by name so the
    loader can demand them as overrides instead of failing opaquely.
    """
    hparams = getattr(tfep_map, 'hparams', None)
    if tfep_map is None or hparams is None:
        return {}
    saved, unsaved = {}, []
    for name, value in hparams.items():
        try:
            pickle.dumps(value)
        except Exception:
            unsaved.append(name)
        else:
            saved[name] = value
    map_class = type(tfep_map)
    return {
        'map_class': f'{map_class.__module__}:{map_class.__qualname__}',
        'map_hparams': saved,
        'unsaved_hparams': unsaved,
    }


def _read_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint written by :class:`Trainer` onto the CPU and check
    its version. ``weights_only=False``: the hyperparameters hold a
    ``System`` and the potential."""
    try:
        state = torch.load(path, map_location='cpu', weights_only=False)
    except (pickle.UnpicklingError, RuntimeError) as error:
        raise ValueError(
            f'{path!r} is not a checkpoint of tfep_tpu_torch (the JAX '
            'package\'s pickled checkpoints are not read).') from error
    version = state.get('format_version', 0)
    if not isinstance(version, int) or version > CHECKPOINT_FORMAT_VERSION:
        raise ValueError(
            f'Checkpoint {path!r} has format version {version!r}, but this '
            f'version of tfep_tpu_torch reads at most '
            f'{CHECKPOINT_FORMAT_VERSION}. Upgrade the library to load it.')
    return state


def load_map_from_checkpoint(checkpoint_path: str, expected_class=None,
                             **override_hparams):
    """Reconstruct a trained TFEP map from a checkpoint of :class:`Trainer`.

    The checkpoint (written with ``torch.save``) embeds the map's class and
    constructor configuration, so a fresh process needs only the
    checkpoint file. The map is rebuilt, ``setup()`` recreates the flow
    structure, and the trained parameters are loaded into it. This reads
    the port's own format only: the JAX package's pickled checkpoints are
    not read.

    Parameters
    ----------
    checkpoint_path : str
        Path to a ``last.ckpt`` written by :class:`Trainer`.
    expected_class : type, optional
        Raise if the stored class is not this class or a subclass
        (used by ``TFEPMapBase.load_from_checkpoint``).
    **override_hparams
        Replace stored hyperparameters; required for any listed in the
        checkpoint's ``unsaved_hparams`` (values that could not be
        pickled at save time).

    Returns
    -------
    tfep_map
        The reconstructed map with trained parameters in ``.flow``.
    """
    state = _read_checkpoint(checkpoint_path)
    if 'map_class' not in state:
        raise ValueError(
            f'Checkpoint {checkpoint_path!r} does not embed the map '
            'configuration. Rebuild the map manually and use '
            'Trainer(..., save_dir=...).fit(map, resume=True).')

    module_name, _, qualname = state['map_class'].partition(':')
    map_class = importlib.import_module(module_name)
    for attr in qualname.split('.'):
        map_class = getattr(map_class, attr)
    if expected_class is not None and not issubclass(map_class,
                                                     expected_class):
        raise ValueError(
            f'Checkpoint {checkpoint_path!r} holds a '
            f'{state["map_class"]}, not a {expected_class.__qualname__}.')

    missing = [name for name in state.get('unsaved_hparams', ())
               if name not in override_hparams]
    if missing:
        raise ValueError(
            f'Checkpoint {checkpoint_path!r} could not serialize the '
            f'hyperparameters {missing}; pass them as keyword overrides, '
            f'e.g. load_map_from_checkpoint(path, {missing[0]}=...).')

    hparams = {**state['map_hparams'], **override_hparams}
    tfep_map = map_class(**hparams)
    tfep_map.setup()
    tfep_map.flow.load_state_dict(state['flow_state'])
    return tfep_map
