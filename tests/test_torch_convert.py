"""``tfep_tpu_torch.convert``: carrying JAX leaves into the port, and the
errors on keys or shapes that do not match."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tfep_tpu.nn.flows import MAF as JaxMAF
from tfep_tpu.nn.flows import SequentialFlow as JaxSequential
from tfep_tpu.nn.transformers import NeuralSplineTransformer as JaxSpline
from tfep_tpu_torch.convert import load_jax_state, torch_name
from tfep_tpu_torch.nn.conditioners.made import generate_degrees
from tfep_tpu_torch.nn.flows import MAF, SequentialFlow
from tfep_tpu_torch.nn.transformers import NeuralSplineTransformer

from test_torch_common import CPU, DTYPE, close, jax_state, perturb, torch_generator

N = 4


def _pair():
    x0, xf = -3.0 * np.ones(N), 3.0 * np.ones(N)
    flow_j = perturb(JaxSequential.create(JaxMAF.create(
        jax.random.key(0), generate_degrees(N),
        transformer=JaxSpline.create(jnp.asarray(x0), jnp.asarray(xf), 3))),
        seed=1)
    flow_t = SequentialFlow.create(MAF.create(
        torch_generator(), generate_degrees(N),
        transformer=NeuralSplineTransformer(x0, xf, 3, device=CPU,
                                            dtype=DTYPE),
        device=CPU, dtype=DTYPE), device=CPU)
    return flow_j, flow_t


def test_torch_name():
    assert torch_name('.flows[0].conditioner.layers[2].gain') == \
        'flows.0.conditioner.layers.2.gain'
    with pytest.raises(ValueError):
        torch_name("['flows'][0]")


def test_every_leaf_is_carried():
    flow_j, flow_t = _pair()
    state = jax_state(flow_j)
    load_jax_state(flow_t, state)
    named = dict(flow_t.named_parameters()) | dict(flow_t.named_buffers())
    assert set(named) == {torch_name(k) for k in state}
    for key, value in state.items():
        close(named[torch_name(key)], value, 0.0)


@pytest.mark.parametrize('edit, error', [
    (lambda s: s.pop('.flows[0].conditioner.layers[1].gain'), KeyError),
    (lambda s: s.update({'.flows[0].conditioner.scale': np.ones(1)}),
     KeyError),
    (lambda s: s.update({'.flows[0].conditioner.layers[0].bias':
                         np.ones(3)}), ValueError),
    (lambda s: s.update({'.flows[0].inverse_masks':
                         ~s['.flows[0].inverse_masks']}), ValueError),
])
def test_mismatch_raises(edit, error):
    flow_j, flow_t = _pair()
    state = jax_state(flow_j)
    edit(state)
    with pytest.raises(error):
        load_jax_state(flow_t, state)
