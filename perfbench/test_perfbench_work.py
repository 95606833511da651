"""The yardstick's arithmetic: the bounds of the paper's 81920^2 sweep and
of one keyed launch at the 20480^2 lattice the kernel table reports."""
from __future__ import annotations

import pytest

from perfbench import work

KEYED = ("void ising::half_sweep_vec<__nv_bfloat16, 128, 0, true, "
         "ising::TileHalo<__nv_bfloat16> >(ising::Params<__nv_bfloat16>, "
         "ising::TileHalo<__nv_bfloat16>)")


def test_sweep_bounds_of_the_81920_lattice():
    ops, nbytes = work.sweep_bounds_s(81920 ** 2)
    assert round(ops * 1e3, 2) == 16.85
    assert round(nbytes * 1e3, 2) == 8.01
    assert work.sweep_bound_s(81920 ** 2) == ops


def test_keyed_launch_bound_is_the_kernel_tables():
    assert work.site_clocks() == 0.65625
    assert round(work.colour_bound_s(20480 ** 2) * 1e3, 4) == 0.5266
    # one colour is half the sweep's operations
    assert work.colour_bound_s(81920 ** 2) == pytest.approx(
        work.sweep_bound_s(81920 ** 2) / 2)


@pytest.mark.parametrize("name, keyed", [
    (KEYED, True),
    (KEYED.replace(", true,", ", false,"), False),
    (KEYED.replace("TileHalo", "LineHalo"), False),
    ("_ZN5ising14half_sweep_vecI13__nv_bfloat16Li128ELi1ELb1ENS_8TileHalo"
     "IS1_EEEEvNS_6ParamsIT_EET3_", True),
    ("_ZN5ising14half_sweep_vecI13__nv_bfloat16Li128ELi1ELb0ENS_8TileHalo"
     "IS1_EEEEvNS_6ParamsIT_EET3_", False),
    ("void at::native::reduce_kernel<512, 1>(...)", False),
])
def test_keyed_tile_launches_are_told_by_name(name, keyed):
    assert work.is_keyed_tile_launch(name) is keyed
