"""The port's import boundary: ``pytorch_distributed_tpu_torch`` imports
torch and never JAX or the JAX package, not even its framework-free
modules.  Checked twice: at run time in a fresh interpreter (what the
import adds to ``sys.modules``) and statically over the sources."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "pytorch_distributed_tpu_torch"
PORT_DIR = os.path.join(REPO, PORT)


def _forbidden(name: str) -> bool:
    """JAX, jaxlib and the JAX package itself — matched on whole dotted
    components, since the port's own name shares the package's prefix."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "pytorch_distributed_tpu") \
        or top.startswith("jax_")


def _port_modules():
    mods = [PORT]
    for info in pkgutil.walk_packages([PORT_DIR], prefix=PORT + "."):
        mods.append(info.name)
    return sorted(mods)


def _port_sources():
    for root, _dirs, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_forbidden_name_matching():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("jaxlib.xla_client")
    assert _forbidden("pytorch_distributed_tpu")
    assert _forbidden("pytorch_distributed_tpu.ops.nstep")
    assert not _forbidden(PORT) and not _forbidden(PORT + ".ops.nstep")


def test_every_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) > 20, mods
    code = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    added = json.loads(out.stdout.strip().splitlines()[-1])
    assert PORT + ".ops.cuda_torso" in added
    bad = [m for m in added if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_name_no_forbidden_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [n for n in names if _forbidden(n)]
    assert not bad, (path, bad)
