"""The frozen plain reference against the port's own plain twin at tiny
sizes (the only place that imports both), and its imports."""

import ast
import importlib
import json
from pathlib import Path

import pytest
import torch

from h100_bench import reference

BENCH = Path(__file__).resolve().parents[1]
F64 = torch.float64


def _config(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    return cfg, importlib.import_module(f"h100_bench.configs.{name}")


@pytest.mark.parametrize("n, k1d", [(3, 2), (3, 3), (2, 4)])
def test_euler_reference_matches_the_port_twin(n, k1d):
    from esdg_cns_tpu_torch.presets import euler_hex_3d
    from esdg_cns_tpu_torch.solvers.euler import make_euler_rhs

    cfg, mod = _config("euler_hex")
    wl = {"n": n, "k1d": k1d}
    disc, _ = euler_hex_3d(n, k1d, dtype=F64, device="cpu")
    twin = make_euler_rhs(disc, dissipation=True, flux_diff_impl="lines",
                          compute_rhstest=False)
    ref = mod.reference_rhs(cfg, wl, F64, "cpu")
    q = mod.start_state(cfg, wl, 2 ** 31 + 7, "cpu").to(F64)
    a, b = twin(q, 0.0)[0], ref(q, 0.0)
    assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


@pytest.mark.parametrize("n, k1d", [(3, 2), (2, 3)])
def test_cavity_reference_matches_the_port_twin(n, k1d):
    from esdg_cns_tpu_torch.presets import lid_driven_cavity_3d
    from esdg_cns_tpu_torch.solvers.cns import make_cns_rhs

    cfg, mod = _config("cns_cavity_3d")
    wl = {"n": n, "k1d": k1d}
    disc, _, bc, p = lid_driven_cavity_3d(n, k1d, ma=cfg["ma"], re=cfg["re"],
                                          dtype=F64, device="cpu")
    twin = make_cns_rhs(disc, mu=p["mu"], pr=cfg["pr"], re=p["re"], bc=bc,
                        inviscid_dissipation=True, viscous_dissipation=True,
                        flux_diff_impl="lines", compute_rhstest=False)
    ref = mod.reference_rhs(cfg, wl, F64, "cpu")
    q = mod.start_state(cfg, wl, 12345, "cpu").to(F64)
    a, b = twin(q, 0.0)[0], ref(q, 0.0)
    assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    # the start state's coordinates are the discretization's own
    x = mod.node_coordinates(n, k1d)
    for c, xc in zip(x, disc.x):
        assert float((torch.as_tensor(c) - xc).abs().max()) == 0.0


def test_start_states_come_from_the_seed():
    for name, wl in (("euler_hex", {"n": 2, "k1d": 2}),
                     ("cns_cavity_3d", {"n": 2, "k1d": 2})):
        cfg, mod = _config(name)
        a = mod.start_state(cfg, wl, 2 ** 31 + 11, "cpu")
        b = mod.start_state(cfg, wl, 2 ** 31 + 11, "cpu")
        c = mod.start_state(cfg, wl, 2 ** 31 + 12, "cpu")
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert torch.equal(a, b) and not torch.equal(a, c)
    cfg, mod = _config("cns_cavity_3d")
    q = mod.start_state(cfg, {"n": 3, "k1d": 3}, 5, "cpu").double()
    # the velocity's largest component is the amplitude
    vel = q[1:4] / q[0]
    assert abs(float(vel.abs().max()) - cfg["velocity_amplitude"]) < 1e-6


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      1.0 + 2.0 ** -12, -3.0 - 2.0 ** -11, -3.0 - 2.0 ** -10])
    y = reference.to_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -3.0,
                          -3.0 - 2.0 ** -9]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = {"jax", "jaxlib", "flax", "esdg_cns_tpu"}


def test_reference_imports_neither_jax_nor_either_package():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & (FORBIDDEN | {"esdg_cns_tpu_torch"}), path


def test_harness_imports_no_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        tops = {name.split(".", 1)[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
