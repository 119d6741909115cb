"""The PyTorch package stands alone: it never loads JAX and imports
nothing of the JAX package, and neither does ``chip_smoke.py``."""

import ast
import os
import pkgutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "learningorchestra_tpu_torch")


def _modules():
    import learningorchestra_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(
        learningorchestra_tpu_torch.__path__, "learningorchestra_tpu_torch."))


def test_import_leaves_jax_unloaded():
    # A fresh interpreter: this test process already imported jax
    # (tests/conftest.py).
    mods = _modules()
    for m in ("models.builder", "ops.exec_jail", "utils.fitckpt"):
        assert f"learningorchestra_tpu_torch.{m}" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jaxlib', 'learningorchestra_tpu.')) "
            "or k == 'learningorchestra_tpu')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name):
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "learningorchestra_tpu")


def test_no_file_of_the_package_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG)
             for f in fs if f.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(p, REPO), n) for p in files
           for n in _imported_roots(p) if _forbidden(n)]
    assert bad == []


def test_chip_smoke_imports_neither():
    names = list(_imported_roots(os.path.join(REPO, "chip_smoke.py")))
    assert "learningorchestra_tpu_torch.ops" in names
    assert [n for n in names if _forbidden(n)] == []


def test_exec_jail_child_never_loads_jax():
    """The jail's child runs ``-m learningorchestra_tpu_torch.ops.exec_jail``
    in a fresh interpreter, as ``preprocess.exec_preprocess`` starts it:
    the package's import chain must not reach jax."""
    code = ("import sys\n"
            "sys.argv = ['exec_jail']\n"
            "import learningorchestra_tpu_torch.ops.exec_jail as j\n"
            "import learningorchestra_tpu_torch.ops.preprocess\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'learningorchestra_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad or not hasattr(j, 'main') else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
