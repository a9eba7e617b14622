"""The port stands alone: it runs with JAX unimportable, and its chip
check refuses to run without a CUDA device (there is no CPU path)."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import torch
import esdg_cns_tpu_torch
for m in pkgutil.walk_packages(esdg_cns_tpu_torch.__path__, "esdg_cns_tpu_torch."):
    importlib.import_module(m.name)
from esdg_cns_tpu_torch.presets import euler_hex_3d
from esdg_cns_tpu_torch.solvers import make_euler_rhs, make_euler_rhs_fused
from esdg_cns_tpu_torch.timestepping import lsrk45
disc, q0 = euler_hex_3d(n=2, k1d=2, dtype=torch.float64, device="cpu")
a, _ = make_euler_rhs_fused(disc)(q0)
b, _ = make_euler_rhs(disc, compute_rhstest=False)(q0)
qf, _ = lsrk45(make_euler_rhs_fused(disc), q0, 1e-3, 1)
assert bool(torch.isfinite(qf).all())
rel = float((a - b).abs().max() / b.abs().max())
assert rel < 1e-11, rel
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m.startswith("esdg_cns_tpu.") and m.split(".")[1]
          not in ("basis", "mesh")]
assert loaded == ["jax"], loaded
print("OK")
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO
    return env


def test_port_runs_with_jax_blocked():
    """(g) importing every module and one RHS, with no JAX."""
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
