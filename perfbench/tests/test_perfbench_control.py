"""The control of each training cell comes out not correct: the plain
reference with its float32 products in TF32 (the nearest precision below
the configurations' float32), put in the program's place, fails one of
the cell's limits, while the program on the same seed passes them all.
On the card, at the cells' own sizes (a minute or two a cell):

    python -m pytest -p no:cacheprovider perfbench/tests -m cuda
"""
import pytest

from perfbench import control
from perfbench import run as R
from perfbench.tests.conftest import load_cell

CELLS = ("goat-r2r.finetune", "goat-r2r.pretrain")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_passes(card, tmp_path, name):
    R.cache_env()
    cell = load_cell(name, tmp_path)
    limits = cell["workload"]["limits"]
    r = control.readings(cell, 2 ** 32 + 17, True)
    assert r["leaves_agree"]
    assert all(r["program"][k] <= lim for k, lim in limits.items()), r
    assert any(r["control"][k] > lim for k, lim in limits.items()
               if k in r["control"]), r
