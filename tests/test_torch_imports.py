"""Each repro_torch package imports first in a fresh interpreter: no
import cycle between its modules, and neither jax nor the JAX package is
loaded (the isolation test imports every module, but in one fixed order
that hides a cycle reached only from a later package)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PACKAGES = sorted(
    ".".join(("repro_torch",) + d.relative_to(PKG).parts)
    for d in [PKG, *PKG.rglob("*")]
    if d.is_dir() and (d / "__init__.py").exists())

_PROBE = r"""
import importlib, pkgutil, sys
pkg = importlib.import_module(sys.argv[1])
for m in pkgutil.iter_modules(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
"""


def test_every_package_is_listed():
    assert {"repro_torch.graphs", "repro_torch.core",
            "repro_torch.kernels.bsr_spmm", "repro_torch.serve",
            "repro_torch.serve.frontend",
            "repro_torch.serve.resilience", "repro_torch.analysis",
            "repro_torch.launch"} <= set(PACKAGES)


@pytest.mark.parametrize("package", PACKAGES)
def test_package_imports_first_without_jax(package):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE, package], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", ["repro_torch.analysis",
                                    "repro_torch.analysis.collective_audit",
                                    "repro_torch.analysis.lint",
                                    "repro_torch.analysis.locks",
                                    "repro_torch.launch.bfs_audit",
                                    "repro_torch.launch.roofline"])
def test_audit_modules_import_first_without_jax(module):
    """The audits and their gate import first, and load neither jax nor
    the JAX package (the reference they port)."""
    probe = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
             "bad = sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
             "m.startswith('repro.')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", probe, module], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", ["repro_torch.core.dist_mesh",
                                    "repro_torch.launch.bfs_run"])
def test_dist_modules_import_first_without_jax(module):
    """The ``torch.distributed`` mesh and the launcher that runs it under
    ``torch.distributed.run`` import first, with neither jax nor the JAX
    package loaded."""
    probe = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
             "bad = sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
             "m.startswith('repro.')); assert not bad, bad; "
             "assert 'torch.distributed' in sys.modules")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", probe, module], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
