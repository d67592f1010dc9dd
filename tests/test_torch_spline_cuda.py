"""Kernels K1/K2 (``tfep_tpu_torch/ops/spline.py``) against their plain
version on a CUDA card, every kind; the standard kind bit for bit against
digests recorded from the kernels' source before the other kinds joined
it (``tests/data/spline_standard_digests.json``); the launches of a
``MixedMAFMap`` training step by kind. Marked ``gpu``: without a card
every test skips.

This file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_spline_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) The
digests are recorded on a card from a copy of ``ops/spline.py``:

    PYTHONPATH=. python tests/test_torch_spline_cuda.py --record SPLINE_PY
"""

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tfep_tpu_torch.ops import spline as fs
from tfep_tpu_torch.units import ureg

pytestmark = pytest.mark.gpu

# |kernel - plain| <= TOL * max(1, max|plain|). float32: Triton's exp, log
# and division are approximate (a few ulp) over some fifty dependent
# operations; float64: the same arithmetic in another order.
TOLERANCES = {torch.float32: (1e-4, 1e-3), torch.float64: (1e-12, 1e-10)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def _inputs(B, F, K, dtype, device, adversarial=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    f64 = dict(generator=g, dtype=torch.float64)
    if adversarial:
        x = -2.95 + 0.75 * torch.rand(B, F, **f64)
        params = torch.zeros(B, (3 * K + 1) * F, dtype=torch.float64)
        params[:, 2 * K * F:] = 9.0
        params[:, (K + 3) * F:(K + 4) * F] = -30.0
        params += 0.1 * torch.randn(params.shape, **f64)
    else:
        x = -6.0 + 12.0 * torch.rand(B, F, **f64)
        params = 0.5 * torch.randn(B, (3 * K + 1) * F, **f64)
    x0 = -3.0 * torch.ones(F, dtype=torch.float64)
    xf = -x0
    # Keep x off the knots, where the gradient jumps between bins.
    knots = x0 + torch.cumsum(torch.softmax(
        params.reshape(B, 3 * K + 1, F)[:, :K], dim=1) * (6.0 - K * 1e-4)
        + 1e-4, dim=1)
    near = (x[:, None] - knots).abs().min(dim=1).values < 1e-4
    near |= (x - x0).abs() < 1e-4
    x = torch.where(near, x + 3e-4, x)
    gy = torch.randn(B, F, **f64)
    gl = torch.randn(B, F, **f64)
    return [t.to(dtype=dtype, device=device)
            for t in (x, params, x0, xf, x0, xf, gy, gl)]


def _check(actual, expected, tol):
    assert torch.isfinite(actual).all()
    scale = max(1.0, float(expected.abs().max()))
    assert float((actual - expected).abs().max()) <= tol * scale


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
# (B, F, K): the bench shape; ragged tiles; K = 3 and 16 (bins padded to 4
# and 16 in K2's tile, 16 a full one); F = 97 and 13, neither a multiple
# of 4 nor of the tile; one row.
@pytest.mark.parametrize('shape', [(4096, 96, 8), (37, 13, 5), (257, 97, 3),
                                   (33, 13, 16), (1, 97, 8), (1, 13, 3)])
@pytest.mark.parametrize('adversarial', [False, True])
def test_kernels_match_plain_version(cuda, dtype, shape, adversarial):
    B, F, K = shape
    x, params, x0, xf, y0, yf, gy, gl = _inputs(B, F, K, dtype, cuda,
                                                adversarial)
    fwd_tol, bwd_tol = TOLERANCES[dtype]
    outs = {}
    for name, fn in (('kernel', fs.fused_spline),
                     ('plain', fs.fused_spline_reference)):
        xi = x.clone().requires_grad_()
        pi = params.clone().requires_grad_()
        y, dl = fn(xi, pi, x0, xf, y0, yf, K)
        gx, gp = torch.autograd.grad((y, dl), (xi, pi), (gy, gl))
        outs[name] = (y, dl, gx, gp)
    torch.cuda.synchronize()
    for i, (kern, plain) in enumerate(zip(outs['kernel'], outs['plain'])):
        _check(kern.detach(), plain.detach(), fwd_tol if i < 2 else bwd_tol)


def test_launch_counts(cuda):
    x, params, x0, xf, y0, yf, gy, gl = _inputs(64, 96, 8, torch.float32,
                                                cuda)
    fs.LAUNCHES.reset()
    y, dl = fs.fused_spline(x, params.requires_grad_(), x0, xf, y0, yf, 8)
    assert (fs.LAUNCHES.forward, fs.LAUNCHES.backward) == (1, 0)
    torch.autograd.grad((y, dl), params, (gy, gl))
    assert (fs.LAUNCHES.forward, fs.LAUNCHES.backward) == (1, 1)


def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, params, x0, xf, y0, yf, _, _ = _inputs(8, 16, 4, torch.float32, cuda)
    with pytest.raises(TypeError):
        fs.fused_spline(x.half(), params.half(), x0.half(), xf.half(),
                        y0.half(), yf.half(), 4)
    with pytest.raises(ValueError):
        fs.fused_spline(x.t().contiguous().t(), params, x0, xf, y0, yf, 4)
    with pytest.raises(TypeError):
        fs.fused_spline(x, params.cpu(), x0, xf, y0, yf, 4)


def _kind_inputs(B, F, K, kind, dtype, device, strided, seed=0):
    """``x, params, x0, xf, gy, gl`` for ``kind``: distances from below the
    domain to past its learned upper bound, torsions in the period with
    shifts of up to 1.5 periods; x kept off the knots (the gradient jumps
    there) and, for torsions, off the period's ends. ``strided``: params
    are the kind's columns of a wider tensor."""
    g = torch.Generator().manual_seed(seed)
    f64 = dict(generator=g, dtype=torch.float64)
    identity, scale, circular = fs.KINDS[kind]
    P = fs.n_parameters(kind, K)
    params = 0.5 * torch.randn(B, P, F, **f64)
    x0 = -1.0 - torch.rand(F, **f64)
    W = 1.0 + torch.rand(F, **f64)
    R = (W - K * 1e-4).expand(B, F)
    if scale:
        params[:, -1] = torch.rand(B, F, **f64) - 0.5
        R = R * params[:, -1].exp()
        x = x0 + (R + K * 1e-4) * (2.6 * torch.rand(B, F, **f64) - 0.6)
    elif circular:
        params[:, -1] = W * (3.0 * torch.rand(B, F, **f64) - 1.5)
        x = x0 + W * torch.rand(B, F, **f64)
    else:
        x = x0 + W * (1.6 * torch.rand(B, F, **f64) - 0.3)
    xr = x - x0
    if circular:
        xr = torch.remainder(xr + params[:, -1], W)
    knots = torch.cumsum(torch.softmax(params[:, :K], dim=1) * R[:, None]
                         + 1e-4, dim=1)
    near = (xr[:, None] - knots).abs().min(dim=1).values < 1e-4
    near |= xr.abs() < 1e-4
    x = torch.where(near, x + 3e-4, x)
    wide = torch.randn(B, P * F + 37, **f64)
    wide[:, 5:5 + P * F] = params.reshape(B, P * F)
    gy = torch.randn(B, F, **f64)
    gl = torch.randn(B, F, **f64)
    x, wide, x0, xf, gy, gl = (t.to(dtype=dtype, device=device)
                               for t in (x, wide, x0, x0 + W, gy, gl))
    params = wide[:, 5:5 + P * F]
    return x, params if strided else params.contiguous(), x0, xf, gy, gl


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
# The flagship's distances (F = 31) and torsions (F = 29) at the training
# cell's batch, in place in a wider tensor as the map passes them; ragged
# tiles, K = 3 and 16.
@pytest.mark.parametrize('case', [
    (65536, 31, 8, 'identity_upper', True), (65536, 29, 8, 'circular', True),
    (65536, 30, 8, 'circular_identity', False),
    (37, 13, 5, 'identity_upper', False), (257, 97, 3, 'circular', False),
    (33, 13, 16, 'circular_identity', True), (1, 13, 3, 'identity_upper',
                                              True)])
def test_kinds_match_plain_version(cuda, dtype, case):
    B, F, K, kind, strided = case
    x, params, x0, xf, gy, gl = _kind_inputs(B, F, K, kind, dtype, cuda,
                                             strided)
    assert (params.stride(0) > params.shape[1]) == strided
    fwd_tol, bwd_tol = TOLERANCES[dtype]
    outs = {}
    for name, fn in (('kernel', fs.fused_spline),
                     ('plain', fs.fused_spline_reference)):
        xi = x.clone().requires_grad_()
        pi = params.clone().requires_grad_()
        y, dl = fn(xi, pi, x0, xf, x0, xf, K, kind=kind)
        gx, gp = torch.autograd.grad((y, dl), (xi, pi), (gy, gl))
        outs[name] = (y, dl, gx, gp)
    torch.cuda.synchronize()
    for i, (kern, plain) in enumerate(zip(outs['kernel'], outs['plain'])):
        _check(kern.detach(), plain.detach(), fwd_tol if i < 2 else bwd_tol)


# The standard kind's outputs and gradients at these cases, as sha256
# digests of their bytes, recorded from the source before the kinds were
# added; Triton's version and the card's compute capability with them.
DIGESTS = Path(__file__).parent / 'data' / 'spline_standard_digests.json'
STANDARD_CASES = [(dtype, shape)
                  for dtype in (torch.float32, torch.float64)
                  for shape in ((65536, 30, 8), (4096, 96, 8), (37, 13, 5))]


def _case_key(dtype, shape):
    return f"{str(dtype).split('.')[-1]}-{'x'.join(map(str, shape))}"


def _compiler():
    import triton
    major, minor = torch.cuda.get_device_capability()
    return dict(triton=triton.__version__, capability=f'{major}.{minor}')


def _standard_digests(module, dtype, shape, device):
    """Digests of the inputs and of ``module.fused_spline``'s outputs and
    gradients on ``_inputs(*shape)``."""
    B, F, K = shape
    x, params, x0, xf, y0, yf, gy, gl = _inputs(B, F, K, dtype, device)
    xi = x.clone().requires_grad_()
    pi = params.clone().requires_grad_()
    y, dl = module.fused_spline(xi, pi, x0, xf, y0, yf, K)
    gx, gp = torch.autograd.grad((y, dl), (xi, pi), (gy, gl))

    def digest(*tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    return dict(inputs=digest(x, params, x0, xf, y0, yf, gy, gl),
                y=digest(y), log_dy_dx=digest(dl), grad_x=digest(gx),
                grad_params=digest(gp))


@pytest.mark.parametrize('dtype,shape', STANDARD_CASES)
def test_standard_kind_bit_identical_to_baseline(cuda, dtype, shape):
    recorded = json.loads(DIGESTS.read_text())
    if recorded['compiler'] != _compiler():
        pytest.skip(f"digests recorded with {recorded['compiler']}, this "
                    f'card and Triton are {_compiler()}')
    expected = recorded['cases'][_case_key(dtype, shape)]
    now = _standard_digests(fs, dtype, shape, cuda)
    assert now['inputs'] == expected['inputs'], 'the inputs differ'
    assert now == expected


class Harmonic:
    energy_unit = ureg.kilocalorie_per_mole

    def __call__(self, x, cell=None):
        return 0.5 * torch.sum(x * x, dim=-1)


def test_mixed_map_step_launches_each_kind(cuda):
    """One ``Trainer.fit`` step of a ``MixedMAFMap`` on a 32-atom helical
    chain (the flagship's groups: distances F = 31, angles F = 30,
    torsions F = 29) at batch 512: every MAF layer takes K1 and K2 once
    for each of its spline groups."""
    from tfep_tpu_torch.app import MixedMAFMap, Trainer
    from tfep_tpu_torch.io.topology import Topology
    from tfep_tpu_torch.io.traj import System

    n_atoms, n_layers = 32, 6
    turns = np.arange(n_atoms) * 1.2
    helix = np.stack([1.5 * np.cos(turns), 1.5 * np.sin(turns),
                      0.3 * np.arange(n_atoms)], axis=1)
    frames = helix + 0.05 * np.random.default_rng(7).standard_normal(
        (1024, n_atoms, 3))
    topology = Topology(names=[f'C{i}' for i in range(n_atoms)],
                        elements=['C'] * n_atoms,
                        bonds=[(i, i + 1) for i in range(n_atoms - 1)])
    tfep_map = MixedMAFMap(
        potential_energy_func=Harmonic(), temperature=300.0 * ureg.kelvin,
        system=System(topology, frames.astype(np.float32)), batch_size=512,
        n_maf_layers=n_layers, n_bins=8, device=cuda, dtype=torch.float32)
    tfep_map.setup()
    groups = tuple(len(g) for g in
                   tfep_map.flow.flow[0].transformer.indices)
    assert groups == (31, 30, 29)
    fs.LAUNCHES.reset()
    Trainer(max_steps=1).fit(tfep_map)
    torch.cuda.synchronize()
    n = n_layers
    launches = {kind: (getattr(fs.LAUNCHES, f'forward_{kind}'),
                       getattr(fs.LAUNCHES, f'backward_{kind}'))
                for kind in fs.KINDS}
    assert launches == dict(standard=(n, n), identity_upper=(n, n),
                            circular=(n, n), circular_identity=(0, 0))
    assert (fs.LAUNCHES.forward, fs.LAUNCHES.backward) == (3 * n, 3 * n)


def _record(spline_py):
    """Write the digests of ``spline_py``'s standard kind on this card."""
    from tfep_tpu_torch.tools import spline_k2_probe
    module = spline_k2_probe._load(Path(spline_py), 1)
    cuda = torch.device('cuda')
    cases = {_case_key(dtype, shape):
             _standard_digests(module, dtype, shape, cuda)
             for dtype, shape in STANDARD_CASES}
    DIGESTS.write_text(json.dumps(dict(
        compiler=_compiler(), device=torch.cuda.get_device_name(0),
        cases=cases), indent=1) + '\n')


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description=_record.__doc__)
    parser.add_argument('--record', metavar='SPLINE_PY', required=True)
    sys.exit(_record(parser.parse_args().record))
