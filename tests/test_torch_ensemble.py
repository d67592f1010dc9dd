"""Vmapped ensembles of the port (``nn/ensemble.py``) against the JAX
package, float64 on the CPU: each case of ``tests/nn/test_ensemble.py``
but the three ``shard_ensemble`` ones (in ``tests/test_torch_sharding.py``,
over processes), with
members of the affine MAF and of the spline MAF; the carrying of a JAX
stacked ensemble; and the fused spline's ``vmap`` rule, which folds the
members' rows into one launch of each kernel."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfep_tpu.nn import ensemble_init as jax_ensemble_init
from tfep_tpu.nn import ensemble_map as jax_ensemble_map
from tfep_tpu.nn import make_ensemble_train_step as jax_train_step
from tfep_tpu.nn import stack_modules as jax_stack
from tfep_tpu.nn.conditioners.made import generate_degrees as jax_degrees
from tfep_tpu.nn.flows import MAF as JaxMAF
from tfep_tpu.nn.transformers.spline import (
    NeuralSplineTransformer as JaxSpline,
)
from tfep_tpu_torch.convert import load_jax_ensemble_state
from tfep_tpu_torch.nn import (
    ensemble_init, ensemble_map, make_ensemble_train_step, n_members,
    stack_modules, unstack_module,
)
from tfep_tpu_torch.nn.conditioners.made import generate_degrees
from tfep_tpu_torch.nn.flows import MAF, SequentialFlow
from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer
from tfep_tpu_torch.nn.transformers import spline as spline_transformer
from tfep_tpu_torch.ops import spline as ops_spline

from test_torch_common import (
    ATOL, CPU, DTYPE, carry, close, jax_state, t, torch_generator,
)

K = 3
N_FEATURES = 6
BATCH = 4
LR = 1e-2
TRANSFORMERS = ['affine', 'spline']


def _transformers(name):
    if name == 'affine':
        return None, None
    bound = 4.0 * np.ones(N_FEATURES)
    return (NeuralSplineTransformer(-bound, bound, 4, device=CPU,
                                    dtype=DTYPE),
            JaxSpline.create(x0=-jnp.asarray(bound), xf=jnp.asarray(bound),
                             n_bins=4))


def build_members(k=K, transformer='affine', hidden_layers=2):
    """K JAX members and their ports, same weights."""
    members = []
    for i in range(k):
        tr_t, tr_j = _transformers(transformer)
        maf_j = JaxMAF.create(jax.random.key(i), jax_degrees(N_FEATURES),
                              transformer=tr_j, hidden_layers=hidden_layers,
                              initialize_identity=False)
        maf_t = MAF.create(torch_generator(i), generate_degrees(N_FEATURES),
                           transformer=tr_t, hidden_layers=hidden_layers,
                           initialize_identity=False, device=CPU,
                           dtype=DTYPE)
        members.append((maf_j, carry(maf_j, maf_t)))
    return [j for j, _ in members], [p for _, p in members]


def single_loss_j(flow, x):
    y, ldj = flow.forward(x)
    return jnp.mean(0.5 * jnp.sum(y ** 2, axis=-1) - ldj)


def single_loss(flow, x):
    y, ldj = flow(x)
    return torch.mean(0.5 * torch.sum(y ** 2, dim=-1) - ldj)


def adamw(params):
    """``optax.adamw(LR)``: decay 1e-4, eps 1e-8."""
    return torch.optim.AdamW(params, lr=LR, weight_decay=1e-4, eps=1e-8)


def batch(seed, shape):
    return np.random.default_rng(seed).normal(size=shape)


def assert_members(stacked, expected, rtol=0.0, atol=ATOL):
    """Each member's parameters against a list of JAX or port modules."""
    for k, member in enumerate(unstack_module(stacked)):
        ref = expected[k]
        ref_state = (dict(ref.named_parameters())
                     if isinstance(ref, torch.nn.Module) else
                     {name: v for name, v in _port_named(ref).items()})
        for name, p in member.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(
                    ref_state[name].detach() if isinstance(
                        ref_state[name], torch.Tensor) else ref_state[name]),
                rtol=rtol, atol=atol, err_msg=f'member {k}: {name}')


def _port_named(jax_module):
    """``{port name: array}`` of a JAX module's leaves."""
    from tfep_tpu_torch.convert import torch_name
    return {torch_name(k): v for k, v in jax_state(jax_module).items()}


def test_stack_unstack_round_trip():
    _, members = build_members()
    stacked = stack_modules(members)
    assert n_members(stacked) == K
    for k, m in enumerate(unstack_module(stacked)):
        assert type(m) is type(members[k])
        for (na, a), (nb, b) in zip(m.state_dict().items(),
                                    members[k].state_dict().items()):
            assert na == nb
            assert torch.equal(a, b)
    # A member is a real module: it runs, and owns its parameters.
    m = unstack_module(stacked, 1)
    x = t(batch(0, (BATCH, N_FEATURES)))
    close(m(x)[0], members[1](x)[0].detach(), 0.0)
    next(m.parameters()).data.add_(1.0)
    assert not torch.equal(next(m.parameters())[0],
                           next(stacked.parameters())[1][0])


def test_stack_requires_same_structure():
    _, (a,) = build_members(1, hidden_layers=[32])
    _, (b,) = build_members(1, hidden_layers=[32, 32])
    with pytest.raises(ValueError, match='different module structures'):
        stack_modules([a, b])
    # Same structure but different widths: the degrees (buffers) differ.
    _, (c,) = build_members(1, hidden_layers=[16, 16])
    _, (d,) = build_members(1, hidden_layers=[32, 32])
    with pytest.raises(ValueError, match='buffer'):
        stack_modules([c, d])
    with pytest.raises(ValueError, match='at least one'):
        stack_modules([])


def test_stack_requires_same_buffers():
    def member(bound):
        tr = NeuralSplineTransformer(-bound * np.ones(N_FEATURES),
                                     bound * np.ones(N_FEATURES), 4,
                                     device=CPU, dtype=DTYPE)
        return MAF.create(torch_generator(0), generate_degrees(N_FEATURES),
                          transformer=tr, device=CPU, dtype=DTYPE)

    with pytest.raises(ValueError, match='buffer'):
        stack_modules([member(4.0), member(2.0)])


@pytest.mark.parametrize('transformer', TRANSFORMERS)
def test_ensemble_map_matches_members(transformer):
    jax_members, members = build_members(transformer=transformer)
    stacked = stack_modules(members)
    x = batch(10, (BATCH, N_FEATURES))
    ys, ldjs = ensemble_map(lambda m, x: m(x), stacked, t(x))
    assert ys.shape == (K, BATCH, N_FEATURES)
    ys_j, ldjs_j = jax_ensemble_map(lambda m, x: m.forward(x),
                                    jax_stack(jax_members), jnp.asarray(x))
    close(ys, ys_j)
    close(ldjs, ldjs_j)
    for k, m in enumerate(members):
        y_ref, ldj_ref = m(t(x))
        close(ys[k], y_ref.detach())
        close(ldjs[k], ldj_ref.detach())
    # Any method of the member, not only forward.
    xs, _ = ensemble_map(lambda m, y: m.inverse(y), stacked, ys,
                         member_axes=(0,))
    close(xs, np.broadcast_to(x, xs.shape), 1e-9)


def test_ensemble_map_per_member_args():
    jax_members, members = build_members()
    stacked = stack_modules(members)
    xs = batch(11, (K, BATCH, N_FEATURES))
    ys, _ = ensemble_map(lambda m, x: m(x), stacked, t(xs), member_axes=(0,))
    ys_j, _ = jax_ensemble_map(lambda m, x: m.forward(x),
                               jax_stack(jax_members), jnp.asarray(xs),
                               member_axes=(0,))
    close(ys, ys_j)
    for k, m in enumerate(members):
        close(ys[k], m(t(xs[k]))[0].detach())


def _separate_runs(members, batches, optimizer, share_batch, max_norm=None):
    """Each member trained alone with its own optimizer."""
    members = [copy.deepcopy(m) for m in members]
    optimizers = [optimizer(list(m.parameters())) for m in members]
    losses = []
    for b in batches:
        row = []
        for k, (m, opt) in enumerate(zip(members, optimizers)):
            opt.zero_grad()
            loss = single_loss(m, t(b if share_batch else b[k]))
            loss.backward()
            if max_norm is not None:
                grads = [p.grad for p in m.parameters()]
                norm = torch.sqrt(sum(torch.sum(g ** 2) for g in grads))
                if norm >= max_norm:
                    for g in grads:
                        g.mul_(max_norm / norm)
            opt.step()
            row.append(float(loss.detach()))
        losses.append(row)
    return members, np.asarray(losses)


@pytest.mark.parametrize('transformer', TRANSFORMERS)
@pytest.mark.parametrize('share_batch', [True, False])
def test_ensemble_training_matches_separate_runs(share_batch, transformer):
    """The vmapped step equals K separate single-model steps, and JAX's
    vmapped step (``optax.adamw``), over 3 steps with the AdamW moments
    carried along."""
    jax_members, members = build_members(transformer=transformer)
    shape = (BATCH, N_FEATURES) if share_batch else (K, BATCH, N_FEATURES)
    batches = [batch(20 + s, shape) for s in range(3)]

    stacked = stack_modules(members)
    step = make_ensemble_train_step(single_loss, ensemble_init(adamw, stacked),
                                    share_batch=share_batch)
    losses = np.asarray([step(stacked, t(b)).numpy() for b in batches])
    assert losses.shape == (3, K)

    ref_members, ref_losses = _separate_runs(members, batches, adamw,
                                             share_batch)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-9)
    assert_members(stacked, ref_members, rtol=1e-8, atol=1e-12)

    stacked_j = jax_stack(jax_members)
    optimizer = optax.adamw(LR)
    opt_state = jax_ensemble_init(optimizer, stacked_j)
    step_j = jax.jit(jax_train_step(single_loss_j, optimizer,
                                    share_batch=share_batch))
    losses_j = []
    for b in batches:
        stacked_j, opt_state, l_j = step_j(stacked_j, opt_state,
                                           jnp.asarray(b))
        losses_j.append(np.asarray(l_j))
    # The JAX test's own tolerances for an ensemble against separate runs.
    np.testing.assert_allclose(losses, np.asarray(losses_j), rtol=1e-9)
    # The spline's two implementations (JAX's XLA path, the port's plain
    # fused spline) round differently, about 1e-16 of a gradient's terms.
    # AdamW's step lr * m / (sqrt(v) + eps) changes at up to lr / eps =
    # 1e6 per unit of a gradient near eps = 1e-8, so such an element moves
    # up to about 1e-7 apart in 3 steps (measured 1.0e-7).
    atol = 1e-6 if transformer == 'spline' else 1e-12
    from tfep_tpu.nn import unstack_module as jax_unstack
    assert_members(stacked, jax_unstack(stacked_j), rtol=1e-8, atol=atol)


def test_ensemble_has_aux():
    _, members = build_members()
    stacked = stack_modules(members)

    def loss_aux(m, x):
        y, ldj = m(x)
        return torch.mean(0.5 * torch.sum(y ** 2, dim=-1) - ldj), ldj

    step = make_ensemble_train_step(loss_aux, ensemble_init(adamw, stacked),
                                    has_aux=True)
    losses, ldjs = step(stacked, t(batch(25, (BATCH, N_FEATURES))))
    assert losses.shape == (K,) and ldjs.shape == (K, BATCH)


def test_ensemble_checkpoint_roundtrip(tmp_path):
    """A stacked ensemble checkpoints like one flow (``torch.save`` of its
    state) and restores into another stack of the same structure."""
    _, members = build_members()
    stacked = stack_modules(members)
    torch.save(stacked.state_dict(), tmp_path / 'ens.pt')
    other = stack_modules([
        MAF.create(torch_generator(10 + i), generate_degrees(N_FEATURES),
                   initialize_identity=False, device=CPU, dtype=DTYPE)
        for i in range(K)])
    other.load_state_dict(torch.load(tmp_path / 'ens.pt'))
    x = t(batch(30, (BATCH, N_FEATURES)))
    y0, _ = ensemble_map(lambda m, x: m(x), stacked, x)
    y1, _ = ensemble_map(lambda m, x: m(x), other, x)
    assert torch.equal(y0, y1)


def test_ensemble_matches_separate_runs_with_global_norm_clipping():
    """Clipping by the global norm sees one member at a time, as
    ``optax.chain(clip_by_global_norm(0.01), sgd(1e-2))`` under JAX's
    vmapped update does."""
    jax_members, members = build_members()
    sgd = lambda params: torch.optim.SGD(params, lr=LR)  # noqa: E731
    batches = [batch(50 + s, (BATCH, N_FEATURES)) for s in range(2)]

    stacked = stack_modules(members)
    step = make_ensemble_train_step(single_loss, ensemble_init(sgd, stacked),
                                    max_grad_norm=0.01)
    for b in batches:
        step(stacked, t(b))
    ref_members, _ = _separate_runs(members, batches, sgd, True,
                                    max_norm=0.01)
    assert_members(stacked, ref_members, rtol=1e-9, atol=1e-13)

    optimizer = optax.chain(optax.clip_by_global_norm(0.01), optax.sgd(LR))
    stacked_j = jax_stack(jax_members)
    opt_state = jax_ensemble_init(optimizer, stacked_j)
    step_j = jax.jit(jax_train_step(single_loss_j, optimizer))
    for b in batches:
        stacked_j, opt_state, _ = step_j(stacked_j, opt_state, jnp.asarray(b))
    from tfep_tpu.nn import unstack_module as jax_unstack
    assert_members(stacked, jax_unstack(stacked_j), rtol=1e-9, atol=1e-13)


@pytest.mark.parametrize('transformer', TRANSFORMERS)
def test_carry_jax_ensemble(transformer):
    """A JAX stacked ensemble loads member by member into the port's
    stacked module; a missing or an extra leaf raises."""
    jax_members, _ = build_members(transformer=transformer)
    stacked_j = jax_stack(jax_members)
    _, fresh = build_members(transformer=transformer)
    stacked = stack_modules([
        MAF.create(torch_generator(20 + i), generate_degrees(N_FEATURES),
                   transformer=_transformers(transformer)[0],
                   initialize_identity=False, device=CPU, dtype=DTYPE)
        for i in range(K)])
    load_jax_ensemble_state(stacked, jax_state(stacked_j))
    assert_members(stacked, jax_members, atol=0.0)
    x = batch(31, (BATCH, N_FEATURES))
    ys, _ = ensemble_map(lambda m, x: m(x), stacked, t(x))
    ys_j, _ = jax_ensemble_map(lambda m, x: m.forward(x), stacked_j,
                               jnp.asarray(x))
    close(ys, ys_j)

    state = jax_state(stacked_j)
    missing = dict(state)
    missing.pop(next(k for k in state if k.endswith('.gain')))
    with pytest.raises(KeyError, match='missing'):
        load_jax_ensemble_state(stacked, missing)
    with pytest.raises(KeyError, match='extra'):
        load_jax_ensemble_state(stacked, {**state, '.spare': np.zeros(3)})
    unstacked = {k: v[0] if k.endswith('.weight') else v
                 for k, v in state.items()}
    with pytest.raises(ValueError, match='member axis'):
        load_jax_ensemble_state(stacked, unstacked)


# -----------------------------------------------------------------------------
# The fused spline (K1/K2) under vmap
# -----------------------------------------------------------------------------

@pytest.fixture
def counting_launchers(monkeypatch):
    """K1/K2's launchers replaced by their plain version, counting each
    call's rows; the spline transformer takes the kernel route
    (``_FusedSpline``) on the CPU."""
    calls = []

    def launch_forward(x, params, x0, xf, y0, yf, *config):
        calls.append(('forward', tuple(x.shape)))
        return ops_spline.fused_spline_reference(x, params, x0, xf, y0, yf,
                                                 *config)

    def launch_backward(x, params, x0, xf, y0, yf, gy, gl, *config):
        calls.append(('backward', tuple(x.shape)))
        _, vjp = torch.func.vjp(
            lambda a, p: ops_spline.fused_spline_reference(
                a, p, x0, xf, y0, yf, *config), x, params)
        return vjp((gy, gl))

    def kernel_route(x, params, x0, xf, y0, yf, n_bins, min_bin_size=1e-4,
                     min_slope=1e-4, kind='standard'):
        ops_spline._check(x, params, dict(x0=x0, xf=xf, y0=y0, yf=yf),
                          n_bins, kind)
        return ops_spline._FusedSpline.apply(x, params, x0, xf, y0, yf,
                                             n_bins, min_bin_size, min_slope,
                                             kind)

    monkeypatch.setattr(ops_spline, 'launch_forward', launch_forward)
    monkeypatch.setattr(ops_spline, 'launch_backward', launch_backward)
    monkeypatch.setattr(spline_transformer, 'fused_spline', kernel_route)
    return calls


def _spline_flow(seed, n_layers=2):
    bound = 4.0 * np.ones(N_FEATURES)
    generator = torch_generator(seed)
    return SequentialFlow.create(*[
        MAF.create(generator, generate_degrees(
            N_FEATURES, order='ascending' if i % 2 == 0 else 'descending'),
            transformer=NeuralSplineTransformer(-bound, bound, 4, device=CPU,
                                                dtype=DTYPE),
            initialize_identity=False, device=CPU, dtype=DTYPE)
        for i in range(n_layers)], device=CPU)


def test_fused_spline_vmap_folds_members(counting_launchers):
    """The ensemble step (``vmap(grad)`` over K members) calls K1 and K2
    once per layer on the (K·B, F) folded rows and gives each member's own
    loss; one member alone launches on its B rows."""
    members = [_spline_flow(i) for i in range(K)]
    stacked = stack_modules(members)
    x = t(batch(40, (BATCH, N_FEATURES)))
    optimizer = ensemble_init(lambda p: torch.optim.SGD(p, lr=0.0), stacked)
    step = make_ensemble_train_step(single_loss, optimizer)
    counting_launchers.clear()
    losses = step(stacked, x)
    rows = (K * BATCH, N_FEATURES)
    assert counting_launchers == [('forward', rows)] * 2 + [
        ('backward', rows)] * 2

    counting_launchers.clear()
    for k, m in enumerate(members):
        loss = single_loss(m, x)
        close(losses[k], float(loss))
    assert counting_launchers == [('forward', (BATCH, N_FEATURES))] * 2 * K


def test_fused_spline_vmap_gradients_per_member(counting_launchers):
    """Each member's gradients through the folded K1/K2 equal those of the
    member alone."""
    members = [_spline_flow(i, n_layers=1) for i in range(K)]
    stacked = stack_modules(members)
    x = t(batch(41, (BATCH, N_FEATURES)))
    params = {name: p.detach() for name, p in stacked.named_parameters()}

    def member_loss(p):
        flow = _Member(stacked, p)
        return single_loss(flow, x)

    counting_launchers.clear()
    grads = torch.func.vmap(torch.func.grad(member_loss))(params)
    assert counting_launchers == [('forward', (K * BATCH, N_FEATURES)),
                                  ('backward', (K * BATCH, N_FEATURES))]
    for k, m in enumerate(members):
        m.zero_grad()
        single_loss(m, x).backward()
        for name, p in m.named_parameters():
            close(grads[name][k], p.grad, 1e-12)


class _Member:
    """``stacked`` called with the parameters ``params`` (one member's, or
    batched under vmap)."""

    def __init__(self, stacked, params):
        self.stacked, self.params = stacked, params

    def __call__(self, x):
        return torch.func.functional_call(self.stacked, self.params, (x,))


def test_fused_spline_vmap_rejects_mapped_bounds(counting_launchers):
    g = torch_generator(0)
    x = torch.randn(BATCH, N_FEATURES, generator=g, dtype=DTYPE)
    params = torch.randn(K, BATCH, 13 * N_FEATURES, generator=g, dtype=DTYPE)
    x0 = -4.0 * torch.ones(K, N_FEATURES, dtype=DTYPE)
    xf = 4.0 * torch.ones(N_FEATURES, dtype=DTYPE)

    def spline(p, lower):
        return ops_spline._FusedSpline.apply(x, p, lower, xf, -xf, xf, 4,
                                             1e-4, 1e-4)

    with pytest.raises(ValueError, match='shared by every member'):
        torch.func.vmap(spline)(params, x0)
    # Shared bounds: one launch over the folded rows.
    counting_launchers.clear()
    y, _ = torch.func.vmap(spline, in_dims=(0, None))(params, x0[0])
    assert counting_launchers == [('forward', (K * BATCH, N_FEATURES))]
    for k in range(K):
        close(y[k], ops_spline.fused_spline_reference(
            x, params[k], x0[0], xf, -xf, xf, 4)[0], 0.0)
