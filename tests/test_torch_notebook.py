"""Execute the port's tutorial notebook (docs/intro_to_MTFEP_torch.ipynb)
on the CPU.

The notebook sets ``DEVICE = 'cuda'`` in its first code cell; the test
puts the repository on the kernel's path first and, right after that
cell, a cell that sets ``DEVICE = 'cpu'``. Its last code cell asserts
that the multimap interval brackets the quadrature's df, and prints its
OK line, which the test reads.
"""

import os

import pytest

nbformat = pytest.importorskip('nbformat')
nbclient = pytest.importorskip('nbclient')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOK = os.path.join(ROOT, 'docs', 'intro_to_MTFEP_torch.ipynb')


def test_tutorial_notebook_executes_on_the_cpu(tmp_path):
    nb = nbformat.read(NOTEBOOK, as_version=4)
    first_code = next(i for i, cell in enumerate(nb.cells)
                      if cell.cell_type == 'code')
    assert "DEVICE = 'cuda'" in nb.cells[first_code].source
    nb.cells.insert(first_code + 1, nbformat.v4.new_code_cell(
        "DEVICE = 'cpu'\ntorch.set_num_threads(1)"))
    nb.cells.insert(0, nbformat.v4.new_code_cell(
        f'import sys\nsys.path.insert(0, {ROOT!r})'))
    client = nbclient.NotebookClient(
        nb, timeout=600, kernel_name='python3',
        resources={'metadata': {'path': str(tmp_path)}})
    client.execute()

    last = [cell for cell in nb.cells if cell.cell_type == 'code'][-1]
    text = ''.join(out.get('text', '') for out in last.outputs
                   if out.get('output_type') == 'stream')
    assert 'OK — the multimap TFEP CI brackets the exact answer.' in text
