"""Plain versions of the split CNS kernels, K8 (``ops.cns_surface``) and K7
(``ops.surface_viscous.cns_viscous``), and of K4 at dim=3 without the
projection block, against the JAX Pallas kernels in interpret mode (f64,
CPU).

The plain versions are what the CUDA wrappers take on CPU tensors and
what the card holds the kernels against.  Both packages get the same
inputs from ``esdg_cns_tpu_torch.cavity_cases`` (moving states, the plain
volume front, one exchange, the BC pool and its recipe, which the two
packages encode alike) over the seven BC shapes, on the tri cavity (2D)
and the collocated hex cavity (3D).  Tolerance 1e-11 of max |out|: the
two sum in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esdg_cns_tpu.ops.pallas_cns_surface import cns_surface_pallas
from esdg_cns_tpu.ops.pallas_viscous import (
    cns_surface_viscous_pallas,
    cns_viscous_pallas,
)
from esdg_cns_tpu_torch.cavity_cases import (
    CAVITY_BCS,
    cavity_case,
    k4_inputs,
    k7_inputs,
    k8_inputs,
)
from esdg_cns_tpu_torch.ops.cns_surface import cns_surface_plain
from esdg_cns_tpu_torch.ops.surface_viscous import (
    cns_surface_viscous_plain,
    cns_viscous_plain,
)

F64 = torch.float64
TOL = 1e-11
# (n, k1d): tri N=2 with K=18, hex N=2 with K=8
SIZES = {2: (2, 3), 3: (2, 2)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _j(a):
    return None if a is None else jnp.asarray(a.numpy())


def _case(case, dim):
    n, k1d = SIZES[dim]
    return cavity_case(case, n, k1d, F64, "cpu", dim=dim)


def _assert_match(tout, jout, what):
    assert len(tout) == len(jout), what
    for a, b in zip(tout, jout):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, what
        err = np.abs(a - b).max()
        assert err <= TOL * max(np.abs(b).max(), 1e-300), (what, err)


@pytest.mark.parametrize("case", CAVITY_BCS)
@pytest.mark.parametrize("dim", [2, 3])
def test_surface_plain_matches_pallas(dim, case):
    disc, q, bc, p = _case(case, dim)
    args, kw = k8_inputs(disc, q, bc, p)
    tout = cns_surface_plain(*args, **kw)
    qm, uf, qm_log, vuf, nbr, nxj, sj, inv_sj, pool = map(_j, args)
    jout = cns_surface_pallas(qm, uf, qm_log, vuf, nbr, list(nxj), sj,
                              inv_sj, pool, interpret=True, **kw)
    _assert_match(tout, jout, (dim, case))
    # without the penalty rows the third output is zeros
    tout = cns_surface_plain(*args, **dict(kw, with_penalty=False))
    assert not bool(tout[2].any())


@pytest.mark.parametrize("case", CAVITY_BCS)
@pytest.mark.parametrize("dim", [2, 3])
def test_viscous_plain_matches_pallas(dim, case):
    disc, q, bc, p = _case(case, dim)
    args, kw = k7_inputs(disc, q, bc, p)
    assert kw["proj"] == (dim == 2) and kw["contract"]
    tout = cns_viscous_plain(*args, **kw)
    jout = cns_viscous_pallas(*map(_j, args), interpret=True, **kw)
    _assert_match(tout, jout, (dim, case))


@pytest.mark.parametrize("dim", [2, 3])
def test_viscous_plain_component_traces_match_pallas(dim):
    """contract=False: the dim * Nf component stress traces."""
    disc, q, bc, p = _case("mixed", dim)
    args, kw = k7_inputs(disc, q, bc, p)
    kw["contract"] = False
    tout = cns_viscous_plain(*args, **kw)
    assert tout[0].shape == (dim * (dim + 2), disc.nfq, disc.num_elements)
    jout = cns_viscous_pallas(*map(_j, args), interpret=True, **kw)
    _assert_match(tout, jout, dim)


@pytest.mark.parametrize("case", CAVITY_BCS)
def test_surface_viscous_3d_plain_matches_pallas(case):
    """K4 at dim=3 with proj=False (the front is the gradient rows only,
    vuq the input v(U)), both fold_tail forms."""
    disc, q, bc, p = _case(case, 3)
    args, tail, kw = k4_inputs(disc, q, bc, p)
    assert not kw["proj"]
    jargs = list(map(_j, args))
    jargs[4] = list(jargs[4])                       # nxj as dim rows
    for fold in (False, True):
        extra = tail if fold else ()
        tout = cns_surface_viscous_plain(*args, *extra, fold_tail=fold,
                                         **kw)
        jout = cns_surface_viscous_pallas(*jargs, *map(_j, extra),
                                          interpret=True, fold_tail=fold,
                                          **kw)
        assert tout[-1] is args[0]                  # vuq is v(U) itself
        _assert_match(tout, jout, (case, fold))
