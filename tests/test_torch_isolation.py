"""The PyTorch port stands alone: it imports neither JAX nor anything of
the JAX package, and its entry points refuse to run on a missing card
instead of falling back to the CPU."""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "code2vec_tpu_torch")
# `code2vec_tpu_torch` itself starts with `code2vec_tpu`
_FORBIDDEN = re.compile(r"^(jax|jaxlib|code2vec_tpu(?!_torch))(\.|$)")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(PORT):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_forbidden_pattern_tells_the_packages_apart():
    assert _FORBIDDEN.match("code2vec_tpu.ops.attention")
    assert _FORBIDDEN.match("code2vec_tpu")
    assert _FORBIDDEN.match("jax.numpy")
    assert not _FORBIDDEN.match("code2vec_tpu_torch.ops.attention")
    assert not _FORBIDDEN.match("jaxtyping")


@pytest.mark.parametrize("module", [
    "ops/xf_attention.py", "ops/xf_attention_kernel.py",
    "models/transformer_encoder.py", "tree.py"])
def test_scan_covers_the_transformer_modules(module):
    """The transformer slice's modules are among the scanned sources and
    import neither JAX nor the JAX package."""
    path = os.path.join(PORT, module)
    assert path in _port_sources()
    assert not [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]


@pytest.mark.parametrize("module", [
    "serving/replicas.py", "serving/reload.py", "serving/autoscale.py",
    "serving/frontend.py", "serving/server.py", "tools/loadgen.py",
    "tools/serving_bench.py", "tools/obs_top.py", "tools/chaos.py"])
def test_scan_covers_the_serving_fleet_modules(module):
    """The serving fleet's modules and tools are among the scanned
    sources and import neither JAX nor the JAX package."""
    path = os.path.join(PORT, module)
    assert path in _port_sources()
    assert not [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]


@pytest.mark.parametrize("module", [
    "parallel/collectives.py", "ops/ring_attention.py", "parallel/mesh.py",
    "parallel/sharding.py", "tools/train_supervisor.py"])
def test_scan_covers_the_context_axis_modules(module):
    """The context and dcn axes' modules (the ctx collectives, the ring,
    the mesh and its sharding, the supervisor's refusal) are among the
    scanned sources and import neither JAX nor the JAX package."""
    path = os.path.join(PORT, module)
    assert path in _port_sources()
    assert not [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]


@pytest.mark.parametrize("module", [
    "models/varmisuse.py", "models/vm_model.py", "training/vm_steps.py",
    "data/vm_reader.py", "data/varmisuse_gen.py"])
def test_scan_covers_the_varmisuse_modules(module):
    """The VarMisuse head's modules are among the scanned sources and
    import neither JAX nor the JAX package."""
    path = os.path.join(PORT, module)
    assert path in _port_sources()
    assert not [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]


@pytest.mark.parametrize("module", [
    "attacks/__init__.py", "attacks/gradient_attack.py",
    "attacks/source_attack.py", "attacks/detect.py",
    "attacks/robustness.py", "attacks/defense.py", "attacks/vm_attack.py",
    "attacks/vm_robustness.py"])
def test_scan_covers_the_attack_modules(module):
    """The attacks' modules are among the scanned sources and import
    neither JAX nor the JAX package."""
    path = os.path.join(PORT, module)
    assert path in _port_sources()
    assert not [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]


@pytest.mark.parametrize("module", [
    "parallel/compat.py", "parallel/mesh.py", "parallel/distributed.py",
    "parallel/sharding.py", "ops/logits.py", "tools/robustness_study.py"])
def test_scan_covers_the_data_axis_modules(module):
    """The data axis's modules (mesh, process group, sharding), the
    float32 logits and the robustness study are among the scanned
    sources and import neither JAX nor the JAX package."""
    path = os.path.join(PORT, module)
    assert path in _port_sources()
    assert not [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]


@pytest.mark.parametrize("module", [
    "training/supervisor.py", "tools/train_supervisor.py", "tools/chaos.py",
    "training/checkpoint.py", "training/phase_probes.py",
    "attacks/defense.py", "training/draws.py", "resilience/faults.py",
    "obs/fleet.py"])
def test_scan_covers_the_cohort_modules(module):
    """The supervised cohort's modules (the spawn with its --dist_* flags,
    the tool, the chaos legs, the cohort's checkpoint load, the
    all-reduce probe, the batch rename across ranks, the failpoints and
    the fleet collector) are among the scanned sources and import
    neither JAX nor the JAX package."""
    path = os.path.join(PORT, module)
    assert path in _port_sources()
    assert not [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_port_sources(path):
    bad = [m for m in _imported_modules(path) if _FORBIDDEN.match(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    """Every module of the port (and chip_smoke.py) imports in a process
    where `jax` and `code2vec_tpu` cannot be imported."""
    code = r"""
import importlib, os, pkgutil, sys
for name in ("jax", "jaxlib", "code2vec_tpu"):
    sys.modules[name] = None  # any import of them now raises
import code2vec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    code2vec_tpu_torch.__path__, "code2vec_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "code2vec_tpu")
                and sys.modules[m] is not None)
print(len(names), loaded)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n, loaded = r.stdout.strip().split(" ", 1)
    assert int(n) >= 35 and loaded == "[]"


def test_default_device_is_the_card_and_never_the_cpu():
    from code2vec_tpu_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")


def test_params_default_device_is_the_card():
    from code2vec_tpu_torch import convert
    tree = {"transform": np.eye(4, dtype=np.float32)}
    if torch.cuda.is_available():
        assert convert.params_from_numpy(tree)["transform"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            convert.params_from_numpy(tree)
