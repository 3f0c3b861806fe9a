"""The port's fleet (pytorch_distributed_tpu_torch/fleet.py) end to end on
the CPU, over 127.0.0.1:

- row 1 with a ``FleetTopology`` on the thread backend and two remote
  actors, as tests/test_dcn.py's fleet test runs the JAX package;
- the CLI as two processes (``--role learner`` and ``--role actors``) on
  row 1: both exit 0 at the learner's stop;
- a remote actor whose gateway is gone past its reconnect timeout exits
  ``EXIT_DISCONNECTED``, and an actor host whose slot runs out of
  restart budget exits 1;
- the Anakin hybrid on config 12 at a small width: a remote actor on
  the device schedule feeds ring 0 of the Anakin learner;
- the roles and the option groups that are not ported raise.

Every run is small (row 1: a 512-row ring, tens of updates); each test
carries its own timeout.
"""

import functools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from pytorch_distributed_tpu_torch import fleet
from pytorch_distributed_tpu_torch.agents.clocks import ActorStats, GlobalClock
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, num_params,
)
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.factory import build_model, probe_env
from pytorch_distributed_tpu_torch.parallel import dcn
from pytorch_distributed_tpu_torch.utils.supervision import (
    EXIT_DISCONNECTED,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL = "127.0.0.1"


def _row1(tmp_path, **kw):
    base = dict(num_actors=2, root_dir=str(tmp_path), seed=7, device="cpu",
                steps=30, learn_start=20, memory_size=512, batch_size=16,
                actor_freq=25, actor_sync_freq=20, param_publish_freq=10,
                learner_freq=10, evaluator_freq=1, evaluator_nepisodes=1,
                checkpoint_freq=0, early_stop=50)
    base.update(kw)
    return build_options(1, **base)


@pytest.mark.timeout(120)
def test_remote_actors_train_row_1_over_localhost(tmp_path):
    opt = _row1(tmp_path)
    topo = fleet.FleetTopology(opt, local_actors=0, port=0,
                               backend="thread", host=LOCAL)
    assert topo._num_actor_workers() == 0
    actors = [threading.Thread(target=fleet._remote_actor_main,
                               args=(opt, f"{LOCAL}:{topo.port}", ind),
                               daemon=True) for ind in range(2)]
    for t in actors:
        t.start()
    summary = topo.run()
    for t in actors:
        t.join(30)
        assert not t.is_alive()
    assert summary["learner/steps"] >= 30
    assert topo.clock.actor_step.value > 0
    assert topo.gateway.chunks_in > 0
    assert topo.gateway.active_slots == {}  # both left at the stop
    status = topo.gateway.status_snapshot()
    assert status["run_id"] == opt.refs
    assert status["flow"]["conservation"]["ingested"] > 0


def _env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        REPO, os.environ.get("PYTHONPATH")))))
    for k in list(env):
        if k.startswith("DCN_"):
            del env[k]
    return env


@pytest.mark.timeout(180)
def test_the_cli_runs_a_learner_host_and_an_actor_host(tmp_path):
    sets = ["--config", "1", "--num-actors", "2", "--seed", "7",
            "--set", "steps=60", "--set", "learn_start=32",
            "--set", "memory_size=512", "--set", "batch_size=16",
            "--set", "evaluator_nepisodes=0", "--set", "learner_freq=20",
            "--set", "early_stop=50", "--set", f"root_dir={tmp_path}",
            "--set", "refs=cli"]
    mod = [sys.executable, "-m", "pytorch_distributed_tpu_torch.fleet"]
    learner = subprocess.Popen(
        mod + ["--role", "learner", "--device", "cpu", "--backend",
               "thread", "--port", "0", *sets],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    actors = None
    try:
        lines = []
        for line in learner.stdout:
            lines.append(line)
            if "gateway on port" in line:
                port = int(line.split("gateway on port")[1].split(",")[0])
                break
        actors = subprocess.Popen(
            mod + ["--role", "actors", "--coordinator", f"{LOCAL}:{port}",
                   "--actor-base", "0", "--actor-count", "2", *sets],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        out, _ = learner.communicate(timeout=150)
        lines += out.splitlines()
        a_out, _ = actors.communicate(timeout=60)
    finally:
        for p in (learner, actors):
            if p is not None and p.poll() is None:
                p.kill()
    assert learner.returncode == 0, "".join(lines[-30:])
    assert actors.returncode == 0, a_out[-3000:]
    import json

    summary = json.loads(lines[-1])
    assert summary["learner/steps"] == 60
    assert summary["gateway/chunks_in"] > 0
    assert summary["runtime/children_with_cuda"] == 0
    assert "actor-0 done" in a_out and "actor-1 done" in a_out


def _plane(opt, **gw_kw):
    spec = probe_env(opt)
    store = ParamStore(num_params(build_model(
        opt, spec, init_weights=False).state_dict()))
    store.publish(np.zeros(store.num_params, np.float32))
    chunks = []
    gw = dcn.DcnGateway(store, GlobalClock(), ActorStats(),
                        put_chunk=chunks.append, host=LOCAL, port=0,
                        **gw_kw)
    return gw, chunks


@pytest.mark.timeout(180)
def test_a_remote_actor_exits_disconnected_past_its_reconnect_timeout(
        tmp_path, monkeypatch):
    monkeypatch.setenv("DCN_RECONNECT_TIMEOUT", "1.0")
    opt = _row1(tmp_path)
    gw, chunks = _plane(opt)
    try:
        p = fleet._CTX.Process(
            target=fleet._remote_actor_child,
            args=(opt, f"{LOCAL}:{gw.port}", 1, None, 1), daemon=True)
        p.start()
        deadline = time.monotonic() + 120  # a spawn child imports torch
        while gw.chunks_in < 2:
            assert time.monotonic() < deadline and p.is_alive()
            time.sleep(0.05)
    finally:
        gw.close()  # and it never comes back
    p.join(60)
    assert p.exitcode == EXIT_DISCONNECTED


@pytest.mark.timeout(120)
def test_an_actor_host_out_of_restart_budget_exits_nonzero(tmp_path,
                                                           monkeypatch):
    opt = _row1(tmp_path)
    gw, _chunks = _plane(opt, local_actors=2)  # every HELLO is refused
    monkeypatch.setattr(fleet, "run_fleet_actors", functools.partial(
        fleet.run_fleet_actors, max_restarts=1))
    try:
        with pytest.raises(SystemExit) as ei:
            fleet.main(["--role", "actors", "--config", "1",
                        "--num-actors", "2", "--coordinator",
                        f"{LOCAL}:{gw.port}", "--actor-base", "1",
                        "--actor-count", "1",
                        "--set", f"root_dir={tmp_path}"])
    finally:
        gw.close()
    assert ei.value.code == 1


@pytest.mark.timeout(120)
def test_the_anakin_hybrid_drains_remote_rows_into_ring_0(tmp_path):
    opt = build_options(
        12, root_dir=str(tmp_path), refs="hybrid", device="cpu",
        num_actors=2, num_envs_per_actor=4, actor_backend="anakin",
        nstep=4, memory_size=512, learn_start=64, batch_size=8, steps=24,
        early_stop=50, device_rollout_ticks=8, rollout_ratio=16.0,
        evaluator_nepisodes=0, learner_freq=8)
    topo = fleet.FleetTopology(opt, local_actors=0, port=0,
                               backend="thread", host=LOCAL)
    assert topo.anakin and topo._num_actor_workers() == 0
    remote = threading.Thread(target=fleet._remote_actor_main,
                              args=(opt, f"{LOCAL}:{topo.port}", 1),
                              daemon=True)
    remote.start()
    # claimed before the learner runs: the remote actor then waits only
    # for the first weights, which the Anakin loop publishes as it starts
    deadline = time.monotonic() + 60
    while 1 not in topo.gateway.active_slots:
        assert time.monotonic() < deadline and remote.is_alive()
        time.sleep(0.05)
    summary = topo.run()
    remote.join(30)
    assert not remote.is_alive()
    assert summary["learner/steps"] == 24
    assert topo.gateway.chunks_in > 0
    assert summary["anakin/ingest_rows"] > 0


@pytest.mark.parametrize("role", ["learner-replica", "gateway-standby",
                                  "replay-shard"])
def test_the_unported_roles_raise(role):
    with pytest.raises(NotImplementedError, match="not ported"):
        fleet.main(["--role", role, "--config", "1",
                    "--coordinator", f"{LOCAL}:1"])


@pytest.mark.parametrize("field", [
    "replicas", "round_timeout_s", "replica_params.replicas", "lease_s",
    "sync_s", "standby", "gateway_params.enabled", "shards",
    "mass_refresh_s", "shard_params.shards"])
def test_the_replica_gateway_and_shard_fields_raise(field):
    with pytest.raises(ValueError, match="unknown option"):
        build_options(1, **{field: 1})
