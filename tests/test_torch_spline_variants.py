"""The fused spline's other kinds (``identity_upper``, ``circular``,
``circular_identity`` in ``tfep_tpu_torch/ops/spline.py``), float64 on the
CPU:

- their plain version against the transformer's one-hot path
  (``fused='never'``) and against the JAX package's transformer: values,
  log-dets and the gradients with respect to x and every parameter row,
  the domain scale and the shift included, with inputs in the linear
  tails and torsions that wrap across the period;
- K1's and K2's Triton source for every kind, through the stand-in for
  ``triton.language`` of ``tests/test_torch_spline_k2_host.py``, against
  the plain version, on contiguous and on strided parameter rows;
- the kinds under ``torch.func.vmap``: one launch on the folded members'
  rows, each member's gradients as its own;
- a mixed transformer's groups: each takes its kind, reading its slice of
  the parameters in place, and ``fused='never'`` takes none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfep_tpu.nn.transformers import NeuralSplineTransformer as JaxSpline
from tfep_tpu_torch.nn.transformers import (
    MixedTransformer, NeuralSplineTransformer,
)
from tfep_tpu_torch.nn.transformers import spline as spline_transformer
from tfep_tpu_torch.ops import spline as fs

from test_torch_common import ATOL, CPU, DTYPE, GRAD_ATOL, close, t
from test_torch_spline_cuda import TOLERANCES
from test_torch_spline_k2_host import standin  # noqa: F401 (a fixture)

B, F, K = 23, 7, 5
MIN = 1e-4
# The transformer's options of each kind the kernels take besides the
# standard one.
OPTIONS = {
    'identity_upper': dict(identity_boundary_slopes=True,
                           learn_upper_bound=True),
    'circular': dict(circular=True),
    'circular_identity': dict(circular=True, identity_boundary_slopes=True),
}


def make_inputs(kind, seed):
    """``x, params, x0, xf`` (numpy, float64). Distances: x from below x0
    to past the largest learned upper bound (domain scales e^-0.5 to
    e^0.5). Torsions: x inside the period, shifts up to 1.5 periods
    either way, so that ``x - x0 + shift`` wraps both ways."""
    rng = np.random.default_rng(seed)
    P = fs.n_parameters(kind, K)
    params = 0.5 * rng.normal(size=(B, P, F))
    x0 = 0.5 + rng.random(F) if kind == 'identity_upper' else \
        -1.0 - rng.random(F)
    W = 1.0 + rng.random(F)
    if kind == 'identity_upper':
        params[:, -1] = rng.uniform(-0.5, 0.5, (B, F))
        x = x0 + W * rng.uniform(-0.6, 2.0, (B, F))
    else:
        params[:, -1] = W * rng.uniform(-1.5, 1.5, (B, F))
        x = x0 + W * rng.random((B, F))
    return x, params.reshape(B, P * F), x0, x0 + W


def _regions(kind, x, params, x0, xf):
    """How many inputs lie below and above the domain (distances), or
    wrap below and above the period (torsions)."""
    last = params.reshape(B, -1, F)[:, -1]
    if kind == 'identity_upper':
        upper = x0 + (xf - x0 - K * MIN) * np.exp(last) + K * MIN
        return int((x < x0).sum()), int((x > upper).sum())
    shifted = x - x0 + last
    return int((shifted < 0).sum()), int((shifted >= xf - x0).sum())


def _weights(seed):
    rng = np.random.default_rng(seed)
    return t(rng.normal(size=(B, F))), t(rng.normal(size=B))


def plain(kind, x, params, x0, xf):
    """The kind's plain version as the transformer returns it."""
    y, dl = fs.fused_spline_reference(x, params, x0, xf, x0, xf, K, MIN,
                                      MIN, kind)
    return y, dl.sum(dim=1)


def unfused(kind, x, params, x0, xf):
    tr = NeuralSplineTransformer(x0.numpy(), xf.numpy(), K, fused='never',
                                 device=CPU, dtype=DTYPE, **OPTIONS[kind])
    return tr(x, params)


def _values_and_grads(fn, kind, inputs, seed=9):
    """``y``, ``log_det_J`` and the gradients of a weighted sum of both
    with respect to x and the parameters."""
    x, params, x0, xf = map(t, inputs)
    x.requires_grad_()
    params.requires_grad_()
    y, ldj = fn(kind, x, params, x0, xf)
    wy, wl = _weights(seed)
    gx, gp = torch.autograd.grad(
        torch.sum(wy * torch.sin(y)) + torch.sum(wl * ldj), (x, params))
    return [v.detach() for v in (y, ldj, gx, gp)]


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('kind', sorted(OPTIONS))
def test_plain_version_matches_unfused_path(kind, seed):
    inputs = make_inputs(kind, seed)
    below, above = _regions(kind, *inputs)
    assert below > 0 and above > 0
    got = _values_and_grads(plain, kind, inputs)
    want = _values_and_grads(unfused, kind, inputs)
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w.numpy(), ATOL if i < 2 else GRAD_ATOL)
    # The scale's or the shift's row has a gradient of its own (a
    # distance's only inside its domain: with both boundary slopes 1 the
    # scale moves neither tail).
    assert (got[3].reshape(B, -1, F)[:, -1] != 0).sum() > B * F // 4


@pytest.mark.parametrize('kind', sorted(OPTIONS))
def test_plain_version_matches_jax_transformer(kind):
    x, params, x0, xf = make_inputs(kind, 2)
    tr_j = JaxSpline.create(jnp.asarray(x0), jnp.asarray(xf), K,
                            fused='never', **OPTIONS[kind])
    y_j, ldj_j = tr_j.forward(jnp.asarray(x), jnp.asarray(params))
    wy, wl = _weights(9)

    def loss_j(x, p):
        y, ldj = tr_j.forward(x, p)
        return (jnp.sum(wy.numpy() * jnp.sin(y))
                + jnp.sum(wl.numpy() * ldj))

    gx_j, gp_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(params))
    y, ldj, gx, gp = _values_and_grads(plain, kind, (x, params, x0, xf))
    close(y, y_j)
    close(ldj, ldj_j)
    close(gx, gx_j, GRAD_ATOL)
    close(gp, gp_j, GRAD_ATOL)


# -----------------------------------------------------------------------------
# K1's and K2's Triton source through the stand-in
# -----------------------------------------------------------------------------

def _kind_inputs(kind, seed):
    if kind == 'standard':
        rng = np.random.default_rng(seed)
        x0 = -1.0 - rng.random(F)
        xf = x0 + 1.0 + rng.random(F)
        x = x0 + (xf - x0) * rng.uniform(-0.3, 1.3, (B, F))
        return x, 0.5 * rng.normal(size=(B, (3 * K + 1) * F)), x0, xf
    return make_inputs(kind, seed)


@pytest.mark.parametrize('strided', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('kind', sorted(fs.KINDS))
def test_kernel_sources_match_plain_version(standin, kind, dtype, strided):
    x, params, x0, xf = (t(a).to(dtype) for a in _kind_inputs(kind, 3))
    if strided:
        # The kind's columns of a wider conditioner output.
        wide = torch.randn(B, params.shape[1] + 11, dtype=dtype)
        wide[:, 5:5 + params.shape[1]] = params
        params = wide[:, 5:5 + params.shape[1]]
        assert not params.is_contiguous()
    gy, gl = (w.to(dtype) for w in _weights(4)[0:1] * 2)
    gl = gl.flip(0)
    # A taller output domain where the kind allows one, so that a learned
    # upper bound moves the upper tail.
    bounds = (x0, xf, x0, xf if fs.KINDS[kind][2] else xf + 0.5)
    consts = fs._constants(x.device, dtype, MIN, MIN)
    y, dl = torch.full_like(x, float('nan')), torch.full_like(x, float('nan'))
    fs._forward_launch(x, params, bounds, consts, y, dl, K, kind)
    gx = torch.full_like(x, float('nan'))
    gp = torch.full(params.shape, float('nan'), dtype=dtype)
    fs._backward_launch(x, params, bounds, consts, gy, gl, gx, gp, K,
                        fs.BACKWARD_LAYOUT, kind)

    xi = x.clone().requires_grad_()
    pi = params.clone().requires_grad_()
    want = fs.fused_spline_reference(xi, pi, *bounds, K, MIN, MIN, kind)
    want = [v.detach() for v in want] + list(
        torch.autograd.grad(want, (xi, pi), (gy, gl)))
    fwd_tol, bwd_tol = TOLERANCES[dtype]
    for i, (g, w) in enumerate(zip((y, dl, gx, gp), want)):
        assert torch.isfinite(g).all()
        scale = max(1.0, float(w.abs().max()))
        tol = fwd_tol if i < 2 else bwd_tol
        assert float((g - w).abs().max()) <= tol * scale, i


@pytest.mark.parametrize('kind', sorted(fs.KINDS))
def test_launchers_count_each_kind(standin, kind, monkeypatch):
    monkeypatch.setattr(fs, '_require_cuda', lambda *tensors: None)
    x, params, x0, xf = (t(a) for a in _kind_inputs(kind, 6))
    fs.LAUNCHES.reset()
    fs.launch_forward(x, params, x0, xf, x0, xf, K, MIN, MIN, kind)
    fs.launch_backward(x, params, x0, xf, x0, xf, x, x, K, MIN, MIN, kind)
    fs.launch_backward(x, params, x0, xf, x0, xf, x, x, K, MIN, MIN, kind)
    for other in fs.KINDS:
        expected = (1, 2) if other == kind else (0, 0)
        assert (getattr(fs.LAUNCHES, f'forward_{other}'),
                getattr(fs.LAUNCHES, f'backward_{other}')) == expected
    assert (fs.LAUNCHES.forward, fs.LAUNCHES.backward) == (1, 2)


# -----------------------------------------------------------------------------
# vmap
# -----------------------------------------------------------------------------

@pytest.fixture
def plain_launchers(monkeypatch):
    """K1/K2's launchers replaced by the plain version, recording each
    call's rows and kind."""
    calls = []

    def launch_forward(x, params, x0, xf, y0, yf, *config):
        calls.append(('forward', tuple(x.shape), config[-1]))
        return fs.fused_spline_reference(x, params, x0, xf, y0, yf, *config)

    def launch_backward(x, params, x0, xf, y0, yf, gy, gl, *config):
        calls.append(('backward', tuple(x.shape), config[-1]))
        _, vjp = torch.func.vjp(lambda a, p: fs.fused_spline_reference(
            a, p, x0, xf, y0, yf, *config), x, params)
        return vjp((gy, gl))

    monkeypatch.setattr(fs, 'launch_forward', launch_forward)
    monkeypatch.setattr(fs, 'launch_backward', launch_backward)
    return calls


@pytest.mark.parametrize('kind', sorted(OPTIONS))
def test_kinds_fold_members_under_vmap(plain_launchers, kind):
    members = 3
    x, _, x0, xf = map(t, make_inputs(kind, 7))
    params = torch.stack([t(make_inputs(kind, 10 + m)[1])
                          for m in range(members)])

    def loss(p, spline):
        y, dl = spline(x, p, x0, xf, x0, xf, K, MIN, MIN, kind)
        return torch.sum(torch.sin(y)) + torch.sum(dl)

    grads = torch.func.vmap(torch.func.grad(
        lambda p: loss(p, fs._FusedSpline.apply)))(params)
    rows = (members * B, F)
    assert plain_launchers == [('forward', rows, kind),
                               ('backward', rows, kind)]
    for m in range(members):
        p = params[m].clone().requires_grad_()
        loss(p, fs.fused_spline_reference).backward()
        close(grads[m], p.grad.numpy(), 1e-12)


# -----------------------------------------------------------------------------
# A mixed transformer's groups
# -----------------------------------------------------------------------------

def _mixed(fused):
    """Distances, angles and torsions as ``MixedMAFMap`` builds them,
    over interleaved features."""
    rng = np.random.default_rng(8)
    d_lo = 0.5 + rng.random(3)
    groups = [np.array([0, 3, 6]), np.array([1, 4, 7]), np.array([2, 5])]
    transformers = [
        NeuralSplineTransformer(d_lo, d_lo + 1.0, K, fused=fused,
                                device=CPU, dtype=DTYPE,
                                **OPTIONS['identity_upper']),
        NeuralSplineTransformer(np.zeros(3), np.ones(3), K, fused=fused,
                                device=CPU, dtype=DTYPE),
        NeuralSplineTransformer(np.zeros(2), np.ones(2), K, fused=fused,
                                device=CPU, dtype=DTYPE, circular=True),
    ]
    return MixedTransformer(transformers, groups, device=CPU)


def test_mixed_groups_take_their_kinds_in_place(monkeypatch):
    seen = []
    real = spline_transformer.fused_spline

    def spy(x, params, *args, kind='standard'):
        seen.append((kind, params.is_contiguous(), params.stride(0)))
        return real(x, params, *args, kind=kind)

    monkeypatch.setattr(spline_transformer, 'fused_spline', spy)
    rng = np.random.default_rng(9)
    mixed = _mixed('auto')
    n_params = len(mixed.get_identity_parameters(8))
    x = rng.uniform(-0.2, 1.8, (B, 8))
    params = 0.5 * rng.normal(size=(B, n_params))
    results = {}
    for fused in ('auto', 'never'):
        seen.clear()
        xi = t(x).requires_grad_()
        pi = t(params).requires_grad_()
        y, ldj = _mixed(fused)(xi, pi)
        (torch.sum(torch.sin(y)) + torch.sum(ldj)).backward()
        results[fused] = (y.detach(), ldj.detach(), xi.grad, pi.grad)
        if fused == 'auto':
            # Each group's columns of the parameters, read in place.
            assert seen == [('identity_upper', False, n_params),
                            ('standard', False, n_params),
                            ('circular', False, n_params)]
        else:
            assert seen == []
    for i, (a, b) in enumerate(zip(results['auto'], results['never'])):
        close(a, b.numpy(), ATOL if i < 2 else GRAD_ATOL)
