"""The port's Becker shock-tube verification (``verification.
becker_shocktube_errors``, ``becker_errors``) against the JAX package's
(f64, CPU): the same configuration, initial step, DOPRI45 trajectory and
norm conventions give the same errors to 1e-9 relative (the two RHS
agree to about 1e-13; the norms of an O(1e-3) error magnify that), and
the same number of accepted steps.
"""

import jax
import pytest
import torch

from esdg_cns_tpu.verification import becker_shocktube_errors as jax_errors
from esdg_cns_tpu_torch.verification import becker_shocktube_errors

KEYS = ("l1", "l2", "linf")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_becker_errors_match_jax():
    ref = jax_errors(2, 16, t_end=0.01, err_tol=1e-9)
    got = becker_shocktube_errors(2, 16, t_end=0.01, err_tol=1e-9,
                                  dtype=torch.float64, device="cpu")
    assert set(got) == set(ref)
    assert got["n_accepted"] == ref["n_accepted"]
    for key in KEYS:
        assert abs(got[key] - ref[key]) <= 1e-9 * ref[key], key


def test_fused_path_scores_as_the_twin():
    """volume_impl='fused' (on the CPU the kernels' plain versions) is
    scored by the same norms and lands on the twin's errors."""
    kw = dict(t_end=0.01, err_tol=1e-9, dtype=torch.float64, device="cpu")
    twin = becker_shocktube_errors(2, 16, **kw)
    fused = becker_shocktube_errors(2, 16, volume_impl="fused", **kw)
    assert fused["n_accepted"] == twin["n_accepted"]
    for key in KEYS:
        assert abs(fused[key] - twin[key]) <= 1e-9 * twin[key], key
