"""Kernels K3/K4/K5 (``tfep_tpu_torch/ops/egnn.py``, ``csrc/egnn.cu``)
against their plain version on a CUDA card. Marked ``gpu``: without a card
every test skips.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_egnn_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)
"""

import math

import pytest
import torch

from tfep_tpu_torch.ops import egnn as E

pytestmark = pytest.mark.gpu

R_CUTOFF = 6.0
# |kernel - plain| <= TOL * max(1, max|plain|). float32: the products sum
# 64 terms in another order than cuBLAS, and the weight gradients sum
# over every pair of the batch (per frame, then over frames) in another
# order than autograd; float64: the same arithmetic in another order.
TOLERANCES = {torch.float32: (1e-4, 1e-3), torch.float64: (1e-12, 1e-10)}
# The bench shape; ragged ones; three sender tiles with a partial last one,
# F and D multiples of 4 (every K5 product register-tiled) and not (every
# K5 product scalar); F a multiple of 4 and D not (K5's products over D
# scalar, the others tiled); a single atom, every pair masked; n not a
# multiple of K5's sender tile and F not a multiple of 8, so that masked
# pairs meet an uneven split of the features over K5's threads.
SHAPES = [(256, 32, 64, 64), (7, 13, 64, 64), (3, 70, 32, 16), (5, 9, 24, 10),
          (3, 70, 33, 17), (2, 1, 64, 64), (4, 37, 20, 12)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _inputs(B, n, F, D, dtype, device, spread=1.5, seed=0):
    """Inputs at the scale of an initialized layer; ``spread`` sets the
    positions' scale, so that some pairs fall beyond the cutoff."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, fan_in=1):
        return torch.randn(*shape, generator=g,
                           dtype=torch.float64) / math.sqrt(fan_in)

    pos = spread * r(B, n, 3)
    diff = pos[:, :, None] - pos[:, None]
    eye = torch.eye(n, dtype=torch.bool)
    dist = torch.sqrt(torch.where(eye, 1.0, (diff ** 2).sum(-1)) + 1e-20)
    weights = [torch.linspace(0, R_CUTOFF, D, dtype=torch.float64),
               0.1 * r(D) + math.log(1.0 / (3 * R_CUTOFF / (D - 1)) ** 2),
               r(F, D, fan_in=D), r(F, fan_in=F), r(F, F, fan_in=F),
               r(F, fan_in=F), r(F, fan_in=F), r(1, fan_in=F),
               r(F, F, fan_in=F), r(F, fan_in=F), r(F, fan_in=F)]
    primals = [r(B, n, F), r(B, n, F), dist] + weights
    tangents = [r(B, n, F), r(B, n, F), r(B, n, n)]
    cotangents = [r(B, n, F), r(B, n, n), r(B, n, F), r(B, n, n)]
    return [[t.to(dtype=dtype, device=device) for t in group]
            for group in (primals, tangents, cotangents)]


def _check(actual, expected, tol, label):
    assert torch.isfinite(actual).all(), label
    scale = max(1.0, float(expected.abs().max()))
    err = float((actual - expected).abs().max())
    assert err <= tol * scale, (label, err, scale)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_kernels_match_plain_version(cuda, dtype, shape):
    primals, tangents, cots = _inputs(*shape, dtype, cuda,
                                      spread=1.5 if shape[0] > 100 else 4.0)
    fwd_tol, bwd_tol = TOLERANCES[dtype]
    with torch.no_grad():
        out = E.egnn_pairwise(*primals, R_CUTOFF)
        ref = E.pairwise_reference(*primals, R_CUTOFF)
    for label, a, b in zip(('nm', 'mag'), out, ref):
        _check(a, b, fwd_tol, f'K3 {label}')

    # K4 forward and K5 backward against torch.autograd of the plain
    # forward-and-tangent function.
    results = {}
    for name, fn in (('kernel', E.egnn_pairwise_jvp),
                     ('plain', E.pairwise_jvp_reference)):
        args = [t.clone().requires_grad_() for t in primals + tangents]
        outs = fn(*args, R_CUTOFF)
        grads = torch.autograd.grad(outs, args, cots)
        results[name] = ([o.detach() for o in outs], grads)
    torch.cuda.synchronize()
    for label, a, b in zip(('nm', 'mag', 'dnm', 'dmag'),
                           results['kernel'][0], results['plain'][0]):
        _check(a, b, fwd_tol, f'K4 {label}')
    names = ('a_i', 'a_j', 'dist') + E.WEIGHTS + ('da_i', 'da_j', 'dd')
    for label, a, b in zip(names, results['kernel'][1], results['plain'][1]):
        _check(a, b, bwd_tol, f'K5 grad {label}')


def test_k4_repeats_bit_for_bit(cuda):
    # The sums over senders run in a fixed order, with no atomics.
    primals, tangents, _ = _inputs(3, 70, 33, 17, torch.float32, cuda)
    first = E.launch_k4(*primals, *tangents, r_cutoff=R_CUTOFF)
    second = E.launch_k4(*primals, *tangents, r_cutoff=R_CUTOFF)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_k5_repeats_bit_for_bit(cuda):
    # Every sum runs in a fixed order, with no atomics; at this shape every
    # product takes the register-tiled path.
    primals, tangents, cots = _inputs(3, 70, 32, 16, torch.float32, cuda)
    first = E.launch_k5(*primals, *tangents, *cots, r_cutoff=R_CUTOFF)
    second = E.launch_k5(*primals, *tangents, *cots, r_cutoff=R_CUTOFF)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_k5_does_not_spill(cuda, dtype):
    name = 'egnn_kernelI%sE' % ('f' if dtype == torch.float32 else 'd')
    (ptxas,) = [v for k, v in E.ptxas_report().items() if name in k]
    assert ptxas['spill_store_bytes'] == 0, ptxas
    assert ptxas['spill_load_bytes'] == 0, ptxas


def test_k5_launch_config_at_the_bench_shape(cuda):
    # The per-phase scratch must not push K5 off its widest configuration:
    # a sender tile of 32 pairs, the weights and the weight-gradient sums
    # in shared memory (B=256, n=32, F=D=64, float32).
    cfg = E.k5_config(torch.float32, 64, 64)
    assert (cfg['pt'], cfg['w_smem'], cfg['g_smem']) == (32, True, True), cfg


@pytest.mark.parametrize('tangent', [False, True], ids=['k3', 'k4'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_forward_kernel_launch_config(cuda, dtype, tangent):
    cfg = E.forward_config(dtype, tangent, 256, 32, 64, 64)
    name = 'egnn_fwd_kernelI%sLb%d' % ('f' if dtype == torch.float32 else 'd',
                                       tangent)
    (ptxas,) = [v for k, v in E.ptxas_report().items() if name in k]
    assert ptxas['spill_store_bytes'] == 0, ptxas
    assert cfg['warps_per_block'] >= 1 and cfg['blocks_per_sm'] >= 1, cfg
    if dtype == torch.float32:
        assert cfg['warps_per_block'] * cfg['blocks_per_sm'] >= 4, cfg


def test_launch_counts(cuda):
    primals, tangents, cots = _inputs(4, 8, 16, 12, torch.float32, cuda)
    E.LAUNCHES.reset()
    with torch.no_grad():
        E.egnn_pairwise(*primals, R_CUTOFF)
    assert (E.LAUNCHES.k3, E.LAUNCHES.k4, E.LAUNCHES.k5) == (1, 0, 0)
    args = [t.requires_grad_() for t in primals + tangents]
    outs = E.egnn_pairwise_jvp(*args, R_CUTOFF)
    assert (E.LAUNCHES.k3, E.LAUNCHES.k4, E.LAUNCHES.k5) == (1, 1, 0)
    torch.autograd.grad(outs, args, cots)
    assert (E.LAUNCHES.k3, E.LAUNCHES.k4, E.LAUNCHES.k5) == (1, 1, 1)


def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    primals, _, _ = _inputs(2, 5, 8, 6, torch.float32, cuda)
    with pytest.raises(TypeError):
        E.egnn_pairwise(*[t.half() for t in primals], R_CUTOFF)
    with pytest.raises(TypeError):
        E.egnn_pairwise(primals[0].cpu(), *primals[1:], R_CUTOFF)
    with pytest.raises(ValueError):
        E.egnn_pairwise(primals[0].transpose(1, 2).contiguous()
                        .transpose(1, 2), *primals[1:], R_CUTOFF)
    with pytest.raises(RuntimeError, match='no gradient'):
        E.egnn_pairwise(primals[0].requires_grad_(), *primals[1:],
                        R_CUTOFF)
