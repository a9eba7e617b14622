"""How the wall BC reaches the merged surface/viscous kernel (K4).

Port of the BC transport of ``esdg_cns_tpu/ops/pallas_cns_surface.py``
(``prepare_surface_bc`` / ``rebuild_surface_bc``): the boundary-region
arrays (normals, masks, wall-velocity and wall-temperature rows, and the
per-call Dirichlet states) ride into the kernel as ONE stacked
[L, Nfq, K] tensor, the "pool", with a hashable "recipe" that says which
row is what.  The plain version rebuilds the ``WallBC`` from the pool
and runs the very same hooks; the CUDA kernel walks the flat table of
``region_table`` in region order instead.
"""

from __future__ import annotations

import functools

import torch

from ..solvers.boundary import Region, WallBC

# wall kinds as the CUDA kernel numbers them (csrc/cns_surface_viscous.cu)
KIND_CODES = {"adiabatic": 0, "isothermal": 1, "slip": 2, "dirichlet": 3}
REGION_INTS = 8       # kind, mask, u_wall rows[3], theta row, qbc, vbc
REGION_FLOATS = 4     # u_wall values[3], theta value


def prepare_surface_bc(bc, adiab, dim):
    """Flatten a WallBC into (static_pool [Ls, Nfq, K], recipe,
    dirichlet_evals).

    recipe is a hashable static description; dirichlet_evals is a tuple
    of callables t -> [Nf, Nfq, K] whose results the caller concatenates
    AFTER the static pool (their row ranges are already in the recipe).
    Boolean arrays ride as 0/1 floats (rebuilt via > 0.5).
    """
    if bc is None:
        return None, None, ()

    rows = []          # [Nfq, K] tensors (static part)
    evals = []         # dirichlet callables, evaluated per RHS call
    shape = bc.bmask.shape
    dtype = bc.nhat[0].dtype

    def add(a):
        a = torch.as_tensor(a, device=bc.bmask.device)
        if a.ndim == 0:
            a = a.expand(shape)
        rows.append(a.to(dtype))
        return len(rows) - 1

    nhat0 = len(rows)
    for d in range(dim):
        add(bc.nhat[d])
    bmask_i = add(bc.bmask)
    adiab_i = add(adiab) if adiab is not None else -1

    region_specs = []
    nf = dim + 2
    dyn = []
    for r in bc.regions:
        mask_i = add(r.mask)
        uw = []
        for c in r.u_wall:
            if isinstance(c, (int, float)):
                uw.append(("s", float(c)))
            else:
                uw.append(("a", add(c)))
        if r.theta is None:
            theta = None
        elif isinstance(r.theta, (int, float)):
            theta = ("s", float(r.theta))
        else:
            theta = ("a", add(r.theta))
        region_specs.append([r.kind, mask_i, tuple(uw), theta, -1, -1])
        if r.kind == "dirichlet":
            dyn.append((len(region_specs) - 1, r))

    n_static = len(rows)
    idx = n_static
    for spec_i, r in dyn:
        region_specs[spec_i][4] = idx
        evals.append(lambda t, rr=r: rr.state(t))
        idx += nf
        ent = r.entropy_state if r.entropy_state is not None else r.state
        region_specs[spec_i][5] = idx
        evals.append(lambda t, ee=ent: ee(t))
        idx += nf

    recipe = (nhat0, bmask_i, adiab_i,
              tuple(tuple(s) for s in region_specs), n_static)
    return torch.stack(rows), recipe, tuple(evals)


def rebuild_surface_bc(pool, recipe, dim, nf):
    """Inverse of prepare_surface_bc: (WallBC, adiabatic mask) whose
    arrays are rows of the pool (Dirichlet states included)."""
    nhat0, bmask_i, adiab_i, region_specs, _ = recipe
    nhat = tuple(pool[nhat0 + d] for d in range(dim))
    bmask = pool[bmask_i] > 0.5
    adiab = pool[adiab_i] > 0.5 if adiab_i >= 0 else None
    regions = []
    for kind, mask_i, uw, theta, qbc_i, vbc_i in region_specs:
        u_wall = tuple(c[1] if c[0] == "s" else pool[c[1]] for c in uw)
        if theta is not None:
            theta = theta[1] if theta[0] == "s" else pool[theta[1]]
        state = entropy_state = None
        if qbc_i >= 0:
            qbc = pool[qbc_i:qbc_i + nf]
            vbc = pool[vbc_i:vbc_i + nf]
            state = lambda t, v=qbc: v
            entropy_state = lambda t, v=vbc: v
        regions.append(Region(mask=pool[mask_i] > 0.5, kind=kind,
                              u_wall=u_wall, theta=theta, state=state,
                              entropy_state=entropy_state))
    bc = WallBC(regions=tuple(regions), nhat=nhat, bmask=bmask, dim=dim)
    return bc, adiab


def recipe_rows(recipe, nf):
    """The pool rows a recipe reads: the static rows, then 2 Nf rows for
    each Dirichlet region (its flux-variable and entropy-variable
    states), which the caller concatenates after the static pool."""
    n_dir = sum(spec[0] == "dirichlet" for spec in recipe[3])
    return recipe[4] + 2 * nf * n_dir


class DiscShim:
    """The BC hooks read only disc.dim."""

    def __init__(self, dim):
        self.dim = dim


@functools.lru_cache(maxsize=32)
def region_table(recipe, device):
    """The recipe as the CUDA kernel reads it: (ints int32 [4 + 8 R],
    floats float64 [4 R]) on ``device``.

    ints: header (R, nhat row, bmask row, adiabatic-mask row), then per
    region in order: kind code (``KIND_CODES``), mask row, three u_wall
    rows, theta row (-1 where the value is a scalar or absent), the first
    row of the Dirichlet flux-variable state and of its entropy-variable
    state (-1 unless dirichlet).  floats: per region the three u_wall
    scalars and the theta scalar (0 where a row is given).
    """
    nhat0, bmask_i, adiab_i, region_specs, _ = recipe
    ints = [len(region_specs), nhat0, bmask_i, adiab_i]
    floats = []
    for kind, mask_i, uw, theta, qbc_i, vbc_i in region_specs:
        uw = list(uw) + [("s", 0.0)] * (3 - len(uw))
        uw_rows = [c[1] if c[0] == "a" else -1 for c in uw]
        uw_vals = [c[1] if c[0] == "s" else 0.0 for c in uw]
        if theta is None:
            th_row, th_val = -1, 0.0
        elif theta[0] == "s":
            th_row, th_val = -1, theta[1]
        else:
            th_row, th_val = theta[1], 0.0
        ints += [KIND_CODES[kind], mask_i, *uw_rows, th_row, qbc_i, vbc_i]
        floats += [*uw_vals, th_val]
    floats = floats or [0.0]
    return (torch.tensor(ints, dtype=torch.int32, device=device),
            torch.tensor(floats, dtype=torch.float64, device=device))
