"""The frozen roofline counts against the bounds PERF.md's kernel table
gives at their shapes."""

import pytest

from h100_bench import roofline


@pytest.mark.parametrize("fn, args, ms", [
    (roofline.k1_bound, (3, 32768), 0.0517),       # K1, the main path
    (roofline.k2_bound, (3, 32768), 0.0551),       # K2, the grid form
    (roofline.fd_dir_bound, (7, 4096), 0.0376),    # split fd, a direction
    (roofline.k4_bound, (3, 4096), 0.0197),        # K4 at dim 3
])
def test_bounds_match_the_kernel_table(fn, args, ms):
    b = fn(*args)
    assert b.by == "bytes"
    assert abs(b.ms - ms) <= 5e-5


def test_split_form_of_k2():
    b = roofline.k2_bound(7, 4096, split_form=True)
    assert abs(b.ms - 0.0747) <= 5e-5


def test_k1_at_the_cavity_size_is_the_same_function():
    big, small = roofline.k1_bound(3, 32768), roofline.k1_bound(3, 4096)
    op = roofline.hex_operators(3)
    fixed = (op["ef"].size + op["lift"].size) * roofline.ITEM
    assert (big.n_bytes - fixed) == 8 * (small.n_bytes - fixed)
    assert big.ops.flops() == 8 * small.ops.flops()


def test_counts_read_the_reference_operators():
    op = roofline.hex_operators(3)
    # Gauss-collocated hex: Ef and LIFT touch one node line a face point
    assert roofline.entries(op["ef"]) == 96 * 4
    assert roofline.entries(op["lift"]) == 96 * 4
    assert roofline.PAIR_3D["diag"].flops() == 74
