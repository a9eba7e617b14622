"""The port stands alone: it runs with JAX unimportable and loads no
module of the JAX package, its copies of the NumPy ``basis`` and ``mesh``
packages build what the originals build, and its chip check refuses to
run without a CUDA device (there is no CPU path)."""

import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import torch
import esdg_cns_tpu_torch
for m in pkgutil.walk_packages(esdg_cns_tpu_torch.__path__, "esdg_cns_tpu_torch."):
    importlib.import_module(m.name)
assert "esdg_cns_tpu_torch.ops.dense_fd" in sys.modules
from esdg_cns_tpu_torch.presets import euler_hex_3d
from esdg_cns_tpu_torch.solvers import make_euler_rhs, make_euler_rhs_fused
from esdg_cns_tpu_torch.timestepping import lsrk45
disc, q0 = euler_hex_3d(n=2, k1d=2, dtype=torch.float64, device="cpu")
a, _ = make_euler_rhs_fused(disc)(q0)
b, _ = make_euler_rhs(disc, flux_diff_impl="lines", compute_rhstest=False)(q0)
qf, _ = lsrk45(make_euler_rhs_fused(disc), q0, 1e-3, 1)
assert bool(torch.isfinite(qf).all())
rel = float((a - b).abs().max() / b.abs().max())
assert rel < 1e-11, rel
for impl in ("pallas", "lines_pallas"):
    c, _ = make_euler_rhs(disc, flux_diff_impl=impl, compute_rhstest=False)(q0)
    rel = float((c - b).abs().max() / b.abs().max())
    assert rel < 1e-11, (impl, rel)
assert "esdg_cns_tpu_torch.ops.fused_volume" in sys.modules
for n, modes in ((4, ("split", "split_pad8", "split_dense")), (7, ("auto",))):
    disc, q0 = euler_hex_3d(n=n, k1d=2, dtype=torch.float64, device="cpu")
    b, _ = make_euler_rhs(disc, flux_diff_impl="lines",
                          compute_rhstest=False)(q0)
    for mode in modes:
        c, _ = make_euler_rhs_fused(disc, force_fused=True,
                                    volume_mode=mode)(q0)
        rel = float((c - b).abs().max() / b.abs().max())
        assert rel < 1e-11, (n, mode, rel)
from esdg_cns_tpu_torch.presets import lid_driven_cavity
from esdg_cns_tpu_torch.solvers import make_cns_rhs, make_cns_rhs_affine
disc, q0, bc, p = lid_driven_cavity(n=2, k1d=2, dtype=torch.float64,
                                    device="cpu")
flags = dict(mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc,
             inviscid_dissipation=True, viscous_dissipation=True,
             compute_rhstest=False)
a, _ = make_cns_rhs_affine(disc, volume_impl="fused", **flags)(q0 * 1.01)
b, _ = make_cns_rhs(disc, **flags)(q0 * 1.01)
rel = float((a - b).abs().max() / b.abs().max())
assert rel < 1e-11, rel
c, _ = make_cns_rhs_affine(disc, volume_impl="fused", surface_impl="fused",
                           **flags)(q0 * 1.01)
rel = float((c - b).abs().max() / b.abs().max())
assert rel < 1e-11, rel
from esdg_cns_tpu_torch.presets import lid_driven_cavity_3d
disc, q0, bc, p = lid_driven_cavity_3d(n=2, k1d=2, dtype=torch.float64,
                                       device="cpu")
flags = dict(flags, mu=p["mu"], pr=p["pr"], re=p["re"], bc=bc)
a, _ = make_cns_rhs_affine(disc, volume_impl="fused_hex", **flags)(q0 * 1.01)
b, _ = make_cns_rhs(disc, **flags)(q0 * 1.01)
rel = float((a - b).abs().max() / b.abs().max())
assert rel < 1e-11, rel
assert "esdg_cns_tpu_torch.physics.exact" in sys.modules
from esdg_cns_tpu_torch.presets import becker_shocktube_3d
from esdg_cns_tpu_torch.solvers import l2_error
disc, q0, bc, shock = becker_shocktube_3d(n=5, k1d=4, dtype=torch.float64,
                                          device="cpu")
flags = dict(mu=shock.mu, pr=shock.pr, bc=bc, inviscid_dissipation=True,
             viscous_dissipation=True, compute_rhstest=False)
a, _ = make_cns_rhs_affine(disc, volume_impl="fused_hex", **flags)(q0, 0.01)
b, _ = make_cns_rhs(disc, **flags)(q0, 0.01)
rel = float((a - b).abs().max() / b.abs().max())
assert rel < 1e-9, rel
assert float(l2_error(disc, q0, disc.vq @ q0)) == 0.0
disc, q0 = euler_hex_3d(n=5, k1d=2, dtype=torch.float64, device="cpu")
a, _ = make_euler_rhs_fused(disc)(q0)
b, _ = make_euler_rhs(disc, flux_diff_impl="lines", compute_rhstest=False)(q0)
rel = float((a - b).abs().max() / b.abs().max())
assert rel < 1e-11, rel
for m in ("ops.becker_bisect", "timestepping.adaptive", "verification"):
    assert "esdg_cns_tpu_torch." + m in sys.modules, m
from esdg_cns_tpu_torch.presets import becker_shocktube_1d
from esdg_cns_tpu_torch.timestepping import dopri45
from esdg_cns_tpu_torch.verification import becker_shocktube_errors
disc, q0, bc, shock = becker_shocktube_1d(n=4, k=8, dtype=torch.float64,
                                          device="cpu")
flags = dict(mu=shock.mu, pr=shock.pr, bc=bc, inviscid_dissipation=True,
             compute_rhstest=False)
fused = make_cns_rhs_affine(disc, volume_impl="fused", **flags)
a, _ = fused(q0, 0.01)
b, _ = make_cns_rhs(disc, **flags)(q0, 0.01)
rel = float((a - b).abs().max() / b.abs().max())
assert rel < 1e-10, rel
qf, stats = dopri45(fused, q0, 2e-3, 1e-4, err_tol=1e-8)
assert bool(torch.isfinite(qf).all()) and stats["n_accepted"] > 0
errs = becker_shocktube_errors(2, 8, t_end=2e-3, dtype=torch.float64,
                               device="cpu")
assert 0.0 < errs["l2"] < 1.0, errs
for m in ("peak", "divide", "transcendental", "fd_section", "timing"):
    assert "esdg_cns_tpu_torch.probes." + m in sys.modules, m
from esdg_cns_tpu_torch.probes import fd_section, transcendental
x = torch.ones(4, 8)
assert bool(torch.isfinite(transcendental.chain(x, "log", 8)).all())
args = fd_section.as_tensors(fd_section.study_inputs(3, 4, False), "cpu")
out = fd_section.fd_section(*args, 1.4, n1=3, diag=False)
assert out.shape == (5, 27 + 6 * 9, 4) and bool(torch.isfinite(out).all())
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "esdg_cns_tpu" or m.startswith("esdg_cns_tpu.")]
assert loaded == ["jax"], loaded
assert sys.modules["jax"] is None
print("OK")
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO
    return env


def test_port_runs_with_jax_blocked():
    """(g) importing every module (``ops.dense_fd`` and ``physics.exact``
    among them), one Euler RHS (with the 'lines', 'pallas' and
    'lines_pallas' flux differencing), the split volume path (N=4 in its
    three split modes, N=7 as 'auto' picks it), the cavity RHS on the 2D
    merged and split paths and on the 3D fused_hex path, the 3D Becker
    shock tube at N=5 on the fused_hex path, the Euler RHS at N=5 as
    'auto' picks it (K1), and the 1D Becker tube's 'fused' RHS (K3 at
    dim 1, K4 at (1, True)), stepped by dopri45 and scored by
    verification.becker_shocktube_errors, and the probes (every module
    of esdg_cns_tpu_torch.probes imported, a chain and the fd section on
    their plain versions), with no JAX; no module of the JAX package is
    loaded."""
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                       env=_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """(h) no CUDA device -> non-zero exit, a message, and no result;
    likewise from a directory that holds chip_smoke.py alone."""
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"ok"' not in r.stdout

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_basis_and_mesh_copies_match_the_jax_package():
    """The port's copies of basis/ and mesh/: the quadrature tables are
    byte-equal, and ref_tri(3) and uniform_tri_mesh(4) are bitwise equal
    to what the JAX package's NumPy originals build."""
    from esdg_cns_tpu.core.ref_elem import ref_tri as jax_ref_tri
    from esdg_cns_tpu.mesh import uniform_tri_mesh as jax_tri_mesh
    from esdg_cns_tpu_torch.core import ref_tri
    from esdg_cns_tpu_torch.mesh import uniform_tri_mesh

    src = os.path.join(REPO, "esdg_cns_tpu", "basis", "quadrature_data")
    dst = os.path.join(REPO, "esdg_cns_tpu_torch", "basis",
                       "quadrature_data")
    names = sorted(os.listdir(src))
    assert names == sorted(os.listdir(dst)) and len(names) == 27
    _, mismatch, errors = filecmp.cmpfiles(src, dst, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)

    a, b = ref_tri(3), jax_ref_tri(3)
    for f in ("vq", "vf", "pq", "lift", "vh", "ph", "vhp", "ef", "wq", "wf",
              "m", "vdm", "v1", "vp"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for f in ("r", "rq", "rf", "nrst_j", "d", "q_skew"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            assert np.array_equal(x, y), f
    for x, y in zip(uniform_tri_mesh(4), jax_tri_mesh(4)):
        assert np.array_equal(x, y)
