"""Entropy-stable wall boundary conditions via ghost states.

Port of ``esdg_cns_tpu/solvers/boundary.py``.  Boundary regions are
boolean masks [Nfq, K]; ghost states are blended into the gathered
neighbour traces with ``torch.where`` (no scatter).  ``Region`` and
``WallBC`` are plain dataclasses of tensors.  Regions apply in order: a
later region overrides an earlier one on the nodes they share.

Hooks, at the reference's interface stages
(dg2D_CNS_cavity_optimized.jl:135-265):
  * ``inviscid``: mirror-velocity ghost on the (rho, u, beta) traces;
  * ``entropy_vars``: adiabatic / isothermal no-slip and reflective
    ghosts on the BR1 gradient traces;
  * ``stress`` / ``stress_normal``: ghost viscous stresses (zero heat
    flux, wall work), per component or normal-contracted;
  * ``penalty_energy_rows``: the wall override of the penalty's energy
    row.

Wall kinds: 'adiabatic' (no-slip, zero heat flux), 'isothermal'
(no-slip, theta = cv T_wall), 'slip' (reflective), 'dirichlet'
(far-field state).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

KINDS = ("adiabatic", "isothermal", "slip", "dirichlet")


@dataclasses.dataclass
class Region:
    """One boundary region.

    mask: bool [Nfq, K]; kind: one of ``KINDS``; u_wall: tangential wall
    velocity components (Python floats or [Nfq, K] tensors); theta:
    cv T_wall of an isothermal wall (float or tensor).  A 'dirichlet'
    region's callables give its ghost traces: ``state(t)`` the stacked
    flux variables [Nf, Nfq, K], ``entropy_state(t)`` the entropy
    variables for the gradient stage (default: ``state``) and
    ``stress_state(t)`` the ghost stresses (default: natural).
    """

    mask: torch.Tensor
    kind: str
    u_wall: tuple = (0.0, 0.0, 0.0)
    theta: Optional[object] = None
    state: Optional[Callable] = None
    entropy_state: Optional[Callable] = None
    stress_state: Optional[Callable] = None


def region_from_indicator(disc, indicator, kind, **kw) -> Region:
    """Build a Region by evaluating a coordinate indicator on face nodes."""
    coords = [c.detach().cpu().numpy() for c in disc.xf]
    mask = np.asarray(indicator(*coords), dtype=bool)
    mask &= disc.bmask.cpu().numpy()
    return Region(mask=torch.as_tensor(mask, device=disc.bmask.device),
                  kind=kind, **kw)


@dataclasses.dataclass
class WallBC:
    """The ghost-state hooks of a set of wall regions.

    regions: tuple of Region; nhat: unit outward normals, dim x [Nfq, K];
    bmask: bool [Nfq, K].  Build with ``make_wall_bc``.
    """

    regions: tuple
    nhat: tuple
    bmask: torch.Tensor
    dim: int

    def _mirror_normal(self, vec, mask):
        """v -> v - 2 (v.n) n on masked nodes (vec: list of [Nfq, K])."""
        dim = self.dim
        vn = sum(vec[d] * self.nhat[d] for d in range(dim))
        return [
            torch.where(mask, vec[d] - 2.0 * vn * self.nhat[d], vec[d])
            for d in range(dim)
        ]

    def inviscid(self, disc, qm, qp, um, up, t=0.0):
        """Ghost for the (rho, u_1..d, beta) traces.

        No-slip/slip walls: rho+ = rho-, beta+ = beta-, u+ = mirror(u-).
        Dirichlet: the far-field state.  ``up`` passes through.
        """
        dim = disc.dim
        for r in self.regions:
            m = r.mask
            if r.kind == "dirichlet":
                qp = torch.where(m[None], r.state(t), qp)
                continue
            vel = [qp[1 + d] for d in range(dim)]
            vel_in = [torch.where(m, qm[1 + d], v) for d, v in enumerate(vel)]
            vel_out = self._mirror_normal(vel_in, m)
            rows = [torch.where(m, qm[0], qp[0])]
            rows += vel_out
            rows += [torch.where(m, qm[dim + 1], qp[dim + 1])]
            qp = torch.stack(rows)
        return qp, up

    def entropy_vars(self, disc, vuf, vup, t=0.0):
        """Ghost entropy-variable traces for the BR1 gradient."""
        dim = disc.dim
        for r in self.regions:
            m = r.mask
            if r.kind == "dirichlet":
                src = r.entropy_state if r.entropy_state is not None else r.state
                vup = torch.where(m[None], src(t), vup)
                continue
            if r.kind == "slip":
                vmom = [torch.where(m, vuf[1 + d], vup[1 + d])
                        for d in range(dim)]
                vmom = self._mirror_normal(vmom, m)
                rows = [vup[0]] + vmom + [
                    torch.where(m, vuf[dim + 1], vup[dim + 1])]
                vup = torch.stack(rows)
                continue
            if r.kind == "adiabatic":
                # v_mom+ = -v_mom- + 2 u_wall (-v4-): u = u_wall at the
                # interface average; v4+ = v4- (zero heat flux)
                rows = [vup[0]]
                for d in range(dim):
                    target = r.u_wall[d] * (-vuf[dim + 1])
                    rows.append(
                        torch.where(m, 2.0 * target - vuf[1 + d], vup[1 + d]))
                rows.append(torch.where(m, vuf[dim + 1], vup[dim + 1]))
                vup = torch.stack(rows)
                continue
            if r.kind == "isothermal":
                # wall state: v_mom = u_wall/theta, v4 = -1/theta
                th = r.theta
                rows = [vup[0]]
                for d in range(dim):
                    rows.append(torch.where(
                        m, 2.0 * r.u_wall[d] / th - vuf[1 + d], vup[1 + d]))
                rows.append(
                    torch.where(m, -2.0 / th - vuf[dim + 1], vup[dim + 1]))
                vup = torch.stack(rows)
                continue
            raise ValueError(f"unknown wall kind {r.kind!r}")
        return vup

    def stress(self, disc, s_f, s_p, vuf, t=0.0):
        """Ghost stress traces (tuples over directions of [Nf, Nfq, K]).

        Adiabatic: momentum stresses pass, the energy stress reflects with
        2 u_wall . tau added.  Isothermal: natural.  Slip: the traction
        mirrors, the energy row reflects.
        """
        dim = disc.dim
        new_sp = []
        for xdir in range(dim):
            sp = s_p[xdir]
            sf = s_f[xdir]
            for r in self.regions:
                m = r.mask
                if r.kind == "dirichlet" and r.stress_state is not None:
                    sp = torch.where(m[None], r.stress_state(t)[xdir], sp)
                    continue
                if r.kind in ("dirichlet", "isothermal"):
                    sp = torch.where(m[None], sf, sp)
                    continue
                if r.kind == "adiabatic":
                    rows = [sp[0]]
                    for d in range(dim):
                        rows.append(torch.where(m, sf[1 + d], sp[1 + d]))
                    work = sum(2.0 * r.u_wall[d] * sf[1 + d]
                               for d in range(dim))
                    rows.append(
                        torch.where(m, -sf[dim + 1] + work, sp[dim + 1]))
                    sp = torch.stack(rows)
                    continue
                if r.kind == "slip":
                    smom = [torch.where(m, sf[1 + d], sp[1 + d])
                            for d in range(dim)]
                    sn = sum(smom[d] * self.nhat[d] for d in range(dim))
                    rows = [sp[0]]
                    for d in range(dim):
                        rows.append(torch.where(
                            m, -smom[d] + 2.0 * self.nhat[d] * sn, sp[1 + d]))
                    rows.append(torch.where(m, -sf[dim + 1], sp[dim + 1]))
                    sp = torch.stack(rows)
                    continue
            new_sp.append(sp)
        return tuple(new_sp)

    def stress_normal(self, disc, t_f, t_ex, t=0.0):
        """Normal-contracted ghost traction sum_x s_p[x] nxj_m[x] from the
        local contraction t_f and the exchanged neighbour contraction t_ex
        (interior faces read -t_ex: conforming faces carry negated
        normals).  Each wall rule of ``stress`` is linear with
        direction-independent coefficients, so these are its contracted
        images: dirichlet/isothermal natural (t_pn = t_f); adiabatic
        momentum passes and energy reflects with 2 u_wall . traction;
        slip mirrors the traction about nhat and reflects energy.
        """
        dim = self.dim
        # self-mapped boundary faces not covered by a region stay natural
        t_pn = torch.where(disc.bmask[None], t_f, -t_ex)
        for r in self.regions:
            m = r.mask
            if r.kind == "dirichlet" and r.stress_state is not None:
                st = r.stress_state(t)
                contr = sum(st[x] * disc.nxj[x][None] for x in range(dim))
                t_pn = torch.where(m[None], contr, t_pn)
                continue
            if r.kind in ("dirichlet", "isothermal"):
                t_pn = torch.where(m[None], t_f, t_pn)
                continue
            if r.kind == "adiabatic":
                rows = [torch.where(m, t_f[0], t_pn[0])]
                for d in range(dim):
                    rows.append(torch.where(m, t_f[1 + d], t_pn[1 + d]))
                work = sum(2.0 * r.u_wall[d] * t_f[1 + d]
                           for d in range(dim))
                rows.append(
                    torch.where(m, -t_f[dim + 1] + work, t_pn[dim + 1]))
                t_pn = torch.stack(rows)
                continue
            if r.kind == "slip":
                tmom = [torch.where(m, t_f[1 + d], t_pn[1 + d])
                        for d in range(dim)]
                tn = sum(tmom[d] * self.nhat[d] for d in range(dim))
                rows = [torch.where(m, t_f[0], t_pn[0])]
                for d in range(dim):
                    rows.append(torch.where(
                        m, -tmom[d] + 2.0 * self.nhat[d] * tn, t_pn[1 + d]))
                rows.append(torch.where(m, -t_f[dim + 1], t_pn[dim + 1]))
                t_pn = torch.stack(rows)
                continue
            raise ValueError(f"unknown wall kind {r.kind!r}")
        return t_pn

    def penalty_energy_rows(self, vuf, vup, dv, tau, adiabatic_mask):
        """Boundary override of the viscous-penalty energy row
        (dg2D_CNS_cavity_optimized.jl:827-837)."""
        avg2 = 0.5 * (vup + vuf)
        last = self.dim + 1
        base = sum(avg2[1 + d] * dv[1 + d] for d in range(self.dim))
        full = base + 0.5 * dv[last] * dv[last]
        num = torch.where(adiabatic_mask, base, full)
        return torch.where(self.bmask, -tau * num / vuf[last], tau * dv[last])


def make_wall_bc(disc, regions: Sequence[Region]) -> WallBC:
    """Assemble a WallBC; checks that every boundary node is covered."""
    for r in regions:
        if r.kind not in KINDS:
            raise ValueError(f"unknown wall kind {r.kind!r}")
    covered = torch.zeros_like(disc.bmask)
    for r in regions:
        covered = covered | r.mask
    missing = disc.bmask & ~covered
    if bool(missing.any()):
        raise ValueError(f"{int(missing.sum())} boundary face nodes not "
                         "covered by any region")
    nhat = tuple(n * disc.inv_sj for n in disc.nxj)
    return WallBC(regions=tuple(regions), nhat=nhat, bmask=disc.bmask,
                  dim=disc.dim)
