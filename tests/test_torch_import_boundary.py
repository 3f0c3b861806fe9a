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


# the modules of the planes that are on by default, of row 19, of the
# planes that are off by default (the perf plane, the profile window and
# mission control), of DDPG, of the DTQN family and of the fleet, each of
# which copies what it needs of its reference module
PLANE_MODULES = ("utils.metrics", "utils.experience", "utils.tracing",
                 "utils.bandwidth", "utils.flow", "utils.render",
                 "models.dqn_cnn_wide", "convert", "utils.perf",
                 "utils.profiling", "utils.telemetry",
                 # DDPG's: the noise, the envs, the model and its steps
                 "utils.random_process", "envs.classic", "envs.gym_adapter",
                 "models.ddpg_mlp", "ops.losses",
                 # the DTQN family's: attention, the three models, the step
                 "ops.ring_attention", "models.dtqn", "models.moe",
                 "models.dtqn_pipeline", "ops.sequence_losses",
                 # the fleet's: the wire, the fault plane, the CLI
                 "parallel.dcn", "utils.faults", "fleet")


@pytest.mark.parametrize("name", PLANE_MODULES)
def test_plane_modules_are_walked_and_import_without_jax(name):
    mod = f"{PORT}.{name}"
    assert mod in _port_modules()
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({mod!r})\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert mod in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


# the modules of the replica and HA planes and the telemetry verbs, new
# or grown, each with its own copy of what it needs of the reference
REPLICA_HA_MODULES = ("parallel.learner", "utils.rngs", "parallel.dcn",
                      "agents.learner", "ops.losses", "factory",
                      "memory.device_per", "utils.checkpoint", "utils.perf",
                      "utils.telemetry", "utils.bandwidth",
                      "utils.flight_recorder", "runtime", "config", "fleet")


def test_replica_and_ha_modules_are_walked_and_import_without_jax():
    """One fresh interpreter imports them all (one process, not one each)."""
    mods = [f"{PORT}.{name}" for name in REPLICA_HA_MODULES]
    walked = set(_port_modules())
    assert all(m in walked for m in mods), sorted(set(mods) - walked)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(m in loaded for m in mods)
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


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


def test_gym_adapter_imports_without_gymnasium():
    """The card's machine has no gymnasium: the adapter, and the factory
    that routes ``env_type`` "gym" to it, import with gymnasium and gym
    blocked, and only making a gym env raises, naming what is missing."""
    code = (
        "import sys\n"
        "sys.modules['gymnasium'] = None\n"
        "sys.modules['gym'] = None\n"
        f"from {PORT}.envs import gym_adapter\n"
        f"from {PORT} import factory\n"
        f"from {PORT}.config import build_options\n"
        "assert 'gymnasium' in sys.modules and sys.modules['gymnasium'] "
        "is None\n"
        "try:\n"
        "    factory.build_env(build_options(9))\n"
        "except ImportError as e:\n"
        "    print('refused:', e)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "refused: env_type 'gym' needs gymnasium" in out.stdout
