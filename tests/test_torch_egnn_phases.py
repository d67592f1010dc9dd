"""The phase counters of ``tfep_tpu_torch/tools/egnn_{fwd,k5}_phases.py``
against the kernel source, on the CPU: each tool's ``instrument()`` must
find every anchor in ``tfep_tpu_torch/csrc/egnn.cu`` exactly once and put
in one counter per phase it prints. Neither nvcc nor a card is needed, so
an edit of the kernel that breaks a tool fails here first."""

import re

import pytest

from tfep_tpu_torch.ops import egnn as E
from tfep_tpu_torch.tools import egnn_fwd_phases, egnn_k5_phases

TOOLS = {'fwd': egnn_fwd_phases, 'k5': egnn_k5_phases}


@pytest.mark.parametrize('name', sorted(TOOLS))
def test_instrument_puts_one_counter_per_phase(name):
    tool = TOOLS[name]
    source = E._SOURCE.read_text()
    marked = tool.instrument(source)
    counters = [int(i) for i in re.findall(r'PHASE\((\d+)\);', marked)]
    assert sorted(counters) == list(range(len(tool.PHASES)))
    assert 'egnn_phases' in marked and 'egnn_phases' not in source


@pytest.mark.parametrize('name', sorted(TOOLS))
def test_instrument_stops_on_a_missing_anchor(name):
    tool = TOOLS[name]
    source = E._SOURCE.read_text()
    anchor = '      // pre = a_i + a_j + W_e emb + b1,'
    assert source.count(anchor) == 2  # one in each kernel
    with pytest.raises(SystemExit, match='anchor'):
        tool.instrument(source.replace(anchor, '      // (moved)'))


def test_k5_tool_counts_every_phase_of_the_tile():
    # The K5 counters sit after every barrier that ends a phase of the
    # tile, the last after the tile's final one.
    marked = egnn_k5_phases.instrument(E._SOURCE.read_text())
    kernel = marked[marked.index('egnn_kernel(Args<T> a) {'):]
    last = len(egnn_k5_phases.PHASES) - 1
    assert re.search(r'__syncthreads\(\);\n\s*PHASE\(%d\);' % last, kernel)
    assert kernel.count('++tiles_;') == 1
