"""Importing hcmoco_tpu_torch and every one of its modules pulls in neither
JAX, flax, optax, triton nor anything of the JAX package (hcmoco_tpu), and
needs no GPU or CUDA toolkit; no module of the port names hcmoco_tpu in
an import, and chip_smoke.py imports nothing of it."""

import ast
import os
import pkgutil
import subprocess
import sys

import hcmoco_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "triton", "hcmoco_tpu")


def _port_modules():
    names = [m.name for m in pkgutil.walk_packages(
        hcmoco_tpu_torch.__path__, "hcmoco_tpu_torch.")]
    assert "hcmoco_tpu_torch.train.contrast_step" in names
    assert "hcmoco_tpu_torch.export.convert" in names
    return ["hcmoco_tpu_torch"] + names


def _import_roots(path):
    """The top-level package of every absolute import in a source file,
    those inside functions included."""
    tree = ast.parse(open(path).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _import_in_subprocess(names, banned):
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {banned!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_imports_without_jax_or_triton():
    _import_in_subprocess(_port_modules(), BANNED)


def test_runtime_modules_import_nothing_of_jax_package():
    """No source file of the port names JAX or hcmoco_tpu in an import,
    not even inside a function that the import test above never runs."""
    pkg = os.path.join(REPO, "hcmoco_tpu_torch")
    sources = [os.path.join(d, f) for d, _, files in os.walk(pkg)
               for f in files if f.endswith(".py")]
    assert len(sources) >= len(_port_modules())
    for path in sources:
        bad = _import_roots(path) & set(BANNED)
        assert not bad, (path, bad)


def test_chip_smoke_imports_nothing_of_jax():
    roots = _import_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "hcmoco_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "hcmoco_tpu"}


def test_chip_smoke_fails_without_cuda():
    """No CUDA device: non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
