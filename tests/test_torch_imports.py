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
            "repro_torch.launch", "repro_torch.optim",
            "repro_torch.train"} <= set(PACKAGES)


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


@pytest.mark.parametrize("module", ["repro_torch.tree",
                                    "repro_torch.optim.adamw",
                                    "repro_torch.train.compress",
                                    "repro_torch.train.checkpoint",
                                    "repro_torch.train.trainer",
                                    "repro_torch.data.pipeline",
                                    "repro_torch.serve.batcher",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.serve",
                                    "repro_torch.layers.core",
                                    "repro_torch.models.transformer",
                                    "repro_torch.launch.steps"])
def test_train_and_decode_modules_import_first_without_jax(module):
    """The train substrate, the LM model with its train step, the LM
    server and their launchers import
    first, with neither jax nor the JAX package loaded (nor ``ml_dtypes``:
    the checkpoint reads bf16 through ``torch.int16``)."""
    probe = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
             "bad = sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib', 'ml_dtypes')) or m == 'repro' "
             "or m.startswith('repro.')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", probe, module], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", ["repro_torch.models.gnn.common",
                                    "repro_torch.models.gnn.models",
                                    "repro_torch.models.gnn.dist_graphcast",
                                    "repro_torch.models.convert",
                                    "repro_torch.graphs.sampler",
                                    "repro_torch.data.synthetic",
                                    "repro_torch.configs.gcn_cora",
                                    "repro_torch.configs.gatedgcn",
                                    "repro_torch.configs.schnet",
                                    "repro_torch.configs.graphcast"])
def test_gnn_modules_import_first_without_jax(module):
    """The GNN family (its configs, models, owner-exchange GraphCast, the
    neighbour sampler and the batch builder) imports first, with neither
    jax nor the JAX package loaded."""
    probe = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
             "bad = sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
             "m.startswith('repro.')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", probe, module], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", ["repro_torch.models.moe",
                                    "repro_torch.configs.dbrx_132b",
                                    "repro_torch.configs."
                                    "llama4_maverick_400b_a17b",
                                    "repro_torch.configs.yi_34b",
                                    "repro_torch.configs.qwen1_5_110b"])
def test_moe_and_lm_config_modules_import_first_without_jax(module):
    """The MoE layer and the four LM configs of its slice import first,
    with neither jax nor the JAX package loaded (the configs keep their
    own copy of ``MoEConfig``)."""
    probe = ("import importlib, sys; importlib.import_module(sys.argv[1]); "
             "bad = sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
             "m.startswith('repro.')); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", probe, module], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
