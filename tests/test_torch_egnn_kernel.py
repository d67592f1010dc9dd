"""The EGNN pairwise block's plain versions (the CPU side of kernels K3,
K4, K5) against the JAX package's ``fused_egnn_pairwise``, whose Pallas
kernels run in interpret mode as ``tests/ops/test_pallas_egnn.py`` runs
them. The port's gradients come from its hand-derived K5 math (the
backward of ``_EGNNPairwiseJVP`` on the CPU); JAX's from autodiff inside
its kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tfep_tpu.ops.pallas.egnn as jax_egnn
from tfep_tpu_torch.ops import egnn as E

from test_torch_common import ATOL, GRAD_ATOL, close, t

N, FEAT, DFEAT, BATCH = 6, 8, 10, 4
R_CUTOFF = 6.0
NAMES = ('a_i', 'a_j', 'dist') + E.WEIGHTS


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jax_egnn, 'INTERPRET', True)


def make_inputs(seed, batch=BATCH, spread=2.0):
    """The 14 primals, 3 tangents and 4 cotangents as numpy arrays."""
    rng = np.random.default_rng(seed)
    sc = 0.5
    pos = spread * rng.normal(size=(batch, N, 3))
    diff = pos[:, :, None] - pos[:, None]
    eye = np.eye(N, dtype=bool)[None]
    dist = np.sqrt(np.where(eye, 1.0, (diff ** 2).sum(-1)) + 1e-20)
    primals = [rng.normal(size=(batch, N, FEAT)),
               rng.normal(size=(batch, N, FEAT)), dist,
               np.linspace(0.0, R_CUTOFF, DFEAT),
               0.1 * rng.normal(size=DFEAT),
               sc * rng.normal(size=(FEAT, DFEAT)),
               sc * rng.normal(size=FEAT),
               sc * rng.normal(size=(FEAT, FEAT)),
               sc * rng.normal(size=FEAT), sc * rng.normal(size=FEAT),
               sc * rng.normal(size=1),
               sc * rng.normal(size=(FEAT, FEAT)),
               sc * rng.normal(size=FEAT), sc * rng.normal(size=FEAT)]
    tangents = [rng.normal(size=(batch, N, FEAT)),
                rng.normal(size=(batch, N, FEAT)),
                rng.normal(size=(batch, N, N))]
    cots = [rng.normal(size=(batch, N, FEAT)), rng.normal(size=(batch, N, N)),
            rng.normal(size=(batch, N, FEAT)), rng.normal(size=(batch, N, N))]
    return primals, tangents, cots


def jax_fused(*args):
    return jax_egnn.fused_egnn_pairwise(*args, N, FEAT, R_CUTOFF, 2)


def test_forward_matches_jax():
    primals, _, _ = make_inputs(0)
    nm_j, mag_j = jax_fused(*map(jnp.asarray, primals))
    with torch.no_grad():
        nm_t, mag_t = E.egnn_pairwise(*map(t, primals), R_CUTOFF)
    assert nm_t.shape == (BATCH, N, FEAT) and mag_t.shape == (BATCH, N, N)
    close(nm_t, nm_j, ATOL)
    close(mag_t, mag_j, ATOL)


@pytest.mark.parametrize('spread', [0.5, 2.0, 4.0])
def test_jvp_matches_jax(spread):
    """K4's outputs; ``spread`` 4 puts many pairs beyond the cutoff."""
    primals, tangents, _ = make_inputs(1, spread=spread)
    zeros = [np.zeros_like(p) for p in primals[3:]]
    out_j, tan_j = jax.jvp(jax_fused, tuple(map(jnp.asarray, primals)),
                           tuple(map(jnp.asarray, tangents + zeros)))
    outs = E.egnn_pairwise_jvp(*map(t, primals + tangents), R_CUTOFF)
    for a, b in zip(outs, (*out_j, *tan_j)):
        close(a, b, ATOL)


def _grad_of_jvp(primals, tangents, cots):
    """Gradients of <cots, (nm, mag, dnm, dmag)> with respect to the 14
    primals and the 3 tangents, on both sides."""
    n_t = len(tangents)

    def scalar(*args):
        zeros = [jnp.zeros_like(p) for p in args[3:14]]
        (nm, mag), (dnm, dmag) = jax.jvp(jax_fused, args[:14],
                                         (*args[14:], *zeros))
        return sum(jnp.sum(o * c) for o, c in
                   zip((nm, mag, dnm, dmag), map(jnp.asarray, cots)))

    g_j = jax.grad(scalar, argnums=tuple(range(14 + n_t)))(
        *map(jnp.asarray, primals + tangents))
    args = [t(a).requires_grad_() for a in primals + tangents]
    outs = E.egnn_pairwise_jvp(*args, R_CUTOFF)
    g_t = torch.autograd.grad(outs, args, [t(c) for c in cots])
    return g_t, g_j


def test_grad_of_jvp_matches_jax():
    """Every gradient of the CNF's pattern (reverse over the jvp),
    including ``log_gammas`` and the tangents'."""
    g_t, g_j = _grad_of_jvp(*make_inputs(2))
    for name, a, b in zip(NAMES + ('da_i', 'da_j', 'dd'), g_t, g_j):
        assert a.shape == b.shape, name
        close(a, b, GRAD_ATOL)


def test_non_dividing_batch():
    """Batch 3: the JAX kernels' tiles (block_b 2) must divide the batch;
    the port has no tiling constraint."""
    primals, tangents, cots = make_inputs(3, batch=3)
    g_t, g_j = _grad_of_jvp(primals, tangents, cots)
    for a, b in zip(g_t, g_j):
        close(a, b, GRAD_ATOL)


def test_hand_derived_backward_matches_autograd():
    """K5's plain version against torch.func (vjp of the plain jvp)."""
    primals, tangents, cots = make_inputs(4, spread=3.0)
    args = [t(a) for a in primals + tangents]
    _, vjp = torch.func.vjp(
        lambda *a: E.pairwise_jvp_reference(*a, R_CUTOFF), *args)
    expected = vjp(tuple(t(c) for c in cots))
    got = E.pairwise_jvp_backward_reference(*args, R_CUTOFF,
                                            *[t(c) for c in cots])
    for a, b in zip(got, expected):
        close(a, b, GRAD_ATOL)


def test_plain_primal_has_no_gradient():
    primals, _, _ = make_inputs(5)
    args = [t(a) for a in primals]
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match='no gradient'):
        E.egnn_pairwise(*args, R_CUTOFF)


def test_cpu_path_launches_no_kernel():
    primals, tangents, cots = make_inputs(6)
    E.LAUNCHES.reset()
    args = [t(a).requires_grad_() for a in primals + tangents]
    outs = E.egnn_pairwise_jvp(*args, R_CUTOFF)
    torch.autograd.grad(outs, args, [t(c) for c in cots])
    assert (E.LAUNCHES.k3, E.LAUNCHES.k4, E.LAUNCHES.k5) == (0, 0, 0)


@pytest.mark.parametrize('change, error', [
    (lambda a: [x.float() for x in a[:1]] + a[1:], TypeError),
    (lambda a: [x.int() for x in a], TypeError),
    (lambda a: [a[0][:, :-1]] + a[1:], ValueError),
    (lambda a: a[:2] + [a[2][:, :, :-1]] + a[3:], ValueError),
    (lambda a: a[:5] + [a[5][:, :-1]] + a[6:], ValueError),
    (lambda a: a[:10] + [a[10].reshape(())] + a[11:], ValueError),
    (lambda a: [a[0].transpose(1, 2).contiguous().transpose(1, 2)] + a[1:],
     ValueError),
    (lambda a: [x.to('meta') for x in a], ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    primals, _, _ = make_inputs(7)
    with pytest.raises(error):
        with torch.no_grad():
            E.egnn_pairwise(*change([t(a) for a in primals]), R_CUTOFF)


def test_byte_and_operation_counts_at_bench_shape():
    nw = E.n_weight_elements(64, 64)
    assert nw == 2 * 64 + 64 * 64 + 2 * 64 * 64 + 5 * 64 + 1
    assert E.k3_bytes(256, 32, 64, 64, 4) == 4 * (
        3 * 256 * 32 * 64 + 2 * 256 * 32 * 32 + nw)
    pairs = 256 * 32 * 32
    # The products alone: 2 FLOP per multiply-add, 3 (K3), 6 (K4) and
    # 18 (K5) matrix-vector products of 64 x 64 per pair.
    assert E.k3_ops(256, 32, 64, 64) > 2 * 3 * 4096 * pairs
    assert E.k4_ops(256, 32, 64, 64) > 2 * 6 * 4096 * pairs
    assert E.k5_ops(256, 32, 64, 64) > 2 * 18 * 4096 * pairs
