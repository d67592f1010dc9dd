"""The port's tensor and ensemble parallelism over 4 real processes.

The port's mirror of the tensor-parallel cases of
``tests/parallel/test_distributed.py``, of
``tests/parallel/test_multihost.py``'s 2dp x 2tp run and of the
``shard_ensemble`` cases of ``tests/nn/test_ensemble.py``. Four processes
join a gloo process group on the CPU in float64
(``tests/torch_sharding_worker.py``, which imports no JAX). The parent
builds the JAX spline MAF of ``tests/parallel/test_distributed.py`` in
float64, perturbs and converts it; each rank splits the port's copy over
``tp`` with ``shard_module``. Held: the forward ``(y, log_det_J)`` of 2
and 4 ``tp`` ranks against the replicated flow and JAX to 1e-10, the
gradients to 1e-9, each rank's MADE tensors against the same slices of
the converted whole tensors (exactly); widths that do not divide and a
data-only mesh; ``Trainer`` over the 2 x 2 mesh against one process on
the global batches (the JAX test's own 1e-8 on the losses), its resume
and its whole checkpoint read unsharded; ``shard_ensemble``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.conditioners.made import generate_degrees
from tfep_tpu.nn.flows import MAF, SequentialFlow
from tfep_tpu.nn.transformers import NeuralSplineTransformer

import torch_sharding_worker as W
from test_torch_common import ATOL, GRAD_ATOL, close, jax_state, perturb
from test_torch_distributed import run_workers

N_RANKS = 4


def jax_spline_maf(key, hidden=W.HIDDEN):
    """``_make_spline_maf`` of ``tests/parallel/test_distributed.py`` in
    float64."""
    keys = jax.random.split(key, W.N_LAYERS)
    bound = 3.0 * jnp.ones(W.DIM, jnp.float64)
    return SequentialFlow.create(*[MAF.create(
        keys[i], generate_degrees(
            W.DIM, order='ascending' if i % 2 == 0 else 'descending'),
        transformer=NeuralSplineTransformer.create(
            x0=-bound, xf=bound, n_bins=W.N_BINS),
        dtype=jnp.float64, hidden_layers=list(hidden))
        for i in range(W.N_LAYERS)])


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp('sharding')
    flow = perturb(jax_spline_maf(jax.random.key(0)), seed=3, scale=0.1)
    x = np.random.default_rng(1).normal(size=(8, W.DIM))
    y, ldj = jax.jit(lambda f, x: f.forward(x))(flow, jnp.asarray(x))
    torch.save(dict(state=jax_state(flow), x=x), workdir / 'jax_flow.pt')
    results = run_workers('torch_sharding_worker.py', N_RANKS, workdir,
                          timeout=300)
    return dict(results=results, y=np.asarray(y), ldj=np.asarray(ldj))


def test_mesh_layout(runs):
    for result in runs['results']:
        assert result['axes'] == ('dp', 'tp')
        # Contiguous tp groups, as JAX lays the devices out.
        assert result['mesh'] == [[0, 1], [2, 3]]


@pytest.mark.parametrize('mesh, tp', [('2x2', 2), ('tp4', 4)])
def test_tensor_parallel_forward_and_gradients(runs, mesh, tp):
    for result in runs['results']:
        y, ldj, forward, gradient, slices, shapes = result[mesh]
        close(y, runs['y'], ATOL)
        close(ldj, runs['ldj'], ATOL)
        assert forward <= ATOL
        assert gradient <= GRAD_ATOL
        # Each shard is its slice of the converted whole tensor, exactly.
        assert slices == 0.0
        hidden, out = W.HIDDEN[0], (3 * W.N_BINS + 1) * W.DIM
        assert shapes == [('column', (hidden // tp, W.DIM)),
                          ('column', (hidden // tp, hidden)),
                          ('row', (out, hidden // tp))] * W.N_LAYERS


def test_tensor_parallel_specs(runs):
    specs = runs['results'][0]['2x2_specs']
    prefix = 'flows.0.conditioner.layers.'
    assert specs[prefix + '0.weight'] == ('tp', None)   # column
    assert specs[prefix + '0.bias'] == ('tp',)
    assert specs[prefix + '0.degrees_out'] == ('tp',)
    assert specs[prefix + '0.degrees_in'] == ()
    assert specs[prefix + '2.weight'] == (None, 'tp')   # row
    assert specs[prefix + '2.degrees_in'] == ('tp',)
    assert specs[prefix + '2.bias'] == ()


@pytest.mark.parametrize('hidden, kinds', [
    ((96, 85), ['column', 'replicated', 'replicated']),
    ((85,), ['plain', 'plain'])])
def test_nondivisible_widths_stay_replicated(runs, hidden, kinds):
    """A layer whose split axis 2 does not divide stays whole; where it
    follows a column-parallel layer it gathers that layer's output."""
    for result in runs['results']:
        _, _, forward, gradient, slices, shapes = result[f'hidden{hidden}']
        assert [kind for kind, _ in shapes] == kinds * W.N_LAYERS
        for (kind, shape), width in zip(shapes, hidden):
            if kind != 'column':
                assert shape[0] == width
        assert forward <= ATOL and gradient <= GRAD_ATOL and slices == 0.0


def test_clip_grad_norm_spans_the_tp_group(runs):
    """The global norm of a split flow's gradients is the whole model's,
    and every rank clips by the same factor as the unsharded flow."""
    for result in runs['results']:
        norm, norm_ref, clipped = result['clip']
        assert norm > 0.1
        assert abs(norm - norm_ref) <= ATOL * norm_ref
        assert clipped <= GRAD_ATOL


def test_data_only_mesh_replicates(runs):
    for result in runs['results']:
        assert result['data_only'] == ('MaskedLinear', 0.0)


def test_tensor_parallel_trainer_matches_one_process(runs):
    for result in runs['results']:
        fit, control = result['tp_fit'], result['control']
        assert fit['global_step'] == W.MAP_EPOCHS * W.N_FRAMES // (
            W.N_DP * W.LOCAL_BATCH)
        assert fit['losses'] == runs['results'][0]['tp_fit']['losses']
        assert max(abs(a - b) for a, b in zip(fit['losses'],
                                              control['losses'])) < 1e-8
        assert sorted(fit['weights']) == sorted(control['weights'])
        for name, value in fit['weights'].items():
            close(value, control['weights'][name], ATOL)
        # The trainer kept the shards (it never re-replicates).
        assert [kind for kind, _ in fit['shapes']] == [
            'column', 'column', 'row'] * 2


def test_tensor_parallel_dp_groups_feed_disjoint_frames(runs):
    frames = [r['tp_fit']['frames'] for r in runs['results']]
    assert frames[0] == frames[1] and frames[2] == frames[3]
    assert sorted(frames[0] + frames[2]) == list(range(W.N_FRAMES))


def test_tensor_parallel_sharding_survives_resume(runs):
    for result in runs['results']:
        resumed, fit = result['tp_resume'], result['tp_fit']
        assert resumed['global_step'] == fit['global_step']
        assert resumed['kinds'] == ['column', 'column', 'row'] * 2
        for name, value in resumed['weights'].items():
            np.testing.assert_array_equal(value, fit['weights'][name])


def test_whole_checkpoint_loads_unsharded(runs):
    loaded = runs['results'][0]['loaded']
    assert loaded['types'] == ['MaskedLinear']
    for name, value in runs['results'][0]['tp_fit']['weights'].items():
        np.testing.assert_array_equal(loaded['weights'][name], value)


def test_sharded_ensemble_matches_unsharded(runs):
    for result in runs['results']:
        ensemble = result['ensemble']
        assert ensemble['members'] == W.N_MEMBERS // W.N_DP
        np.testing.assert_array_equal(ensemble['losses'],
                                      ensemble['expected'])
        assert ensemble['weight_diff'] == 0.0


@pytest.mark.parametrize('case, message', [
    ('uneven', 'divisible'), ('unstacked', 'Not a stacked ensemble'),
    ('count', 'n_members=4')])
def test_shard_ensemble_rejects(runs, case, message):
    for result in runs['results']:
        assert message in result['ensemble']['errors'][case]
