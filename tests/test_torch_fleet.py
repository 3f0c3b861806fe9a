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
- learner replicas: row 1 with ``replicas=2`` through the CLI as two
  processes, one model to the bit;
- the HA plane as processes: a standby promoting after its primary's
  host is SIGKILLed, an actor failing over to it;
- a running learner host serving ``fetch_profile`` and taking an actor
  host's ``MetricsPusher`` rows into mission control;
- the role and the option group that are not ported (``replay-shard``,
  ``ShardParams``) raise.

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


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        REPO, os.environ.get("PYTHONPATH")))))
    for k in list(env):
        if k.startswith(("DCN_", "TPU_APEX_GATEWAY", "TPU_APEX_REPLICA")):
            del env[k]
    env.update(extra)
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


@pytest.mark.parametrize("role", ["replay-shard"])
def test_the_unported_roles_raise(role):
    with pytest.raises(NotImplementedError, match="not ported"):
        fleet.main(["--role", role, "--config", "1",
                    "--coordinator", f"{LOCAL}:1"])


@pytest.mark.parametrize("field", [
    "shards", "mass_refresh_s", "shard_params.shards",
    "shard_params.lease_s", "shard_params.renew_s",
    "shard_params.coordinator"])
def test_the_replica_gateway_and_shard_fields_raise(field):
    """The shard plane's fields raise; the replica and gateway groups are
    ported (tests/test_torch_replicas.py routes them)."""
    with pytest.raises(ValueError, match="unknown option"):
        build_options(1, **{field: 1})


def test_the_ported_roles_parse_and_need_a_coordinator():
    for role in ("learner-replica", "gateway-standby"):
        with pytest.raises(SystemExit):
            fleet.main(["--role", role, "--config", "1", "--device", "cpu"])
    _ap, args = fleet.parse_args(["--role", "learner-replica",
                                  "--coordinator", f"{LOCAL}:1",
                                  "--replica-id", "3"])
    assert (args.replica_id, args.device) == (3, "cuda")


def test_the_standby_role_needs_the_ha_plane(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_APEX_GATEWAY_ENABLED", raising=False)
    with pytest.raises(SystemExit, match="HA plane"):
        fleet.main(["--role", "gateway-standby", "--config", "1",
                    "--coordinator", f"{LOCAL}:1",
                    "--set", f"root_dir={tmp_path}"])


def _lines_until(proc, needle: str, lines: list, timeout: float = 120.0):
    """Read ``proc``'s output into ``lines`` until a line holds
    ``needle``; returns that line."""
    deadline = time.monotonic() + timeout
    for line in proc.stdout:
        lines.append(line)
        if needle in line:
            return line
        assert time.monotonic() < deadline, "".join(lines[-20:])
    raise AssertionError(f"{needle!r} never came: " + "".join(lines[-20:]))


def _drain(proc, lines: list) -> threading.Thread:
    t = threading.Thread(target=lambda: lines.extend(proc.stdout),
                         daemon=True)
    t.start()
    return t


@pytest.mark.timeout(180)
def test_row_1_replicas_through_the_cli_train_one_model(tmp_path):
    """``--role learner --set replicas=2`` and ``--role learner-replica``
    as two processes on the CPU: both reach the round count, the
    registry completed every round, the published parameters are equal
    to the bit, and both exit 0."""
    import json

    sets = ["--config", "1", "--num-actors", "1", "--device", "cpu",
            "--set", "replicas=2", "--set", "steps=60",
            "--set", "memory_size=512", "--set", "batch_size=16",
            "--set", "learn_start=64", "--set", "hidden_dim=32",
            "--set", "evaluator_nepisodes=0", "--set", f"root_dir={tmp_path}",
            "--set", "refs=replicas", "--set", "replica_params.lease_s=3.0"]
    mod = [sys.executable, "-m", "pytorch_distributed_tpu_torch.fleet"]
    lead = subprocess.Popen(
        mod + ["--role", "learner", "--port", "0", "--local-actors", "0",
               *sets], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    rep = None
    try:
        lines = []
        line = _lines_until(lead, "gateway on port", lines)
        port = int(line.split("gateway on port")[1].split(",")[0])
        rep = subprocess.Popen(
            mod + ["--role", "learner-replica", "--coordinator",
                   f"{LOCAL}:{port}", "--replica-id", "1", *sets],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        r_out, _ = rep.communicate(timeout=150)
        out, _ = lead.communicate(timeout=60)
        lines += out.splitlines()
    finally:
        for p in (lead, rep):
            if p is not None and p.poll() is None:
                p.kill()
    assert lead.returncode == 0, "".join(lines[-30:])
    assert rep.returncode == 0, r_out[-3000:]
    s_lead = json.loads(lines[-1])
    s_rep = json.loads(r_out.splitlines()[-1])
    assert s_lead["replica/rounds_completed"] == 60
    assert s_lead["replica/rounds"] == s_rep["replica/rounds"] == 60
    assert s_lead["learner/steps"] == s_rep["learner/steps"] == 60
    assert s_lead["replica/params_sha256"] == s_rep["replica/params_sha256"]
    assert s_lead["replica/degraded_completions"] == 0
    assert s_lead["runtime/children_with_cuda"] == 0


@pytest.mark.timeout(180)
def test_the_standby_promotes_and_an_actor_fails_over(tmp_path):
    """The HA plane as processes on row 1: a learner host journaling, a
    standby syncing from it and an actor host on ``--coordinator P,PS``.
    The learner host is SIGKILLed; the standby promotes within its lease,
    the actor fails over to it once and its rows are spooled; a SIGTERM
    ends the standby, which parts from the actor as a learner host does:
    both exit 0."""
    env = _env(TPU_APEX_GATEWAY_ENABLED="1", TPU_APEX_GATEWAY_LEASE_S="1.0",
               TPU_APEX_GATEWAY_SYNC_S="0.1")
    sets = ["--config", "1", "--num-actors", "1",
            "--set", "steps=100000", "--set", "memory_size=512",
            "--set", "batch_size=16", "--set", "learn_start=64",
            "--set", "hidden_dim=32", "--set", "evaluator_nepisodes=0",
            "--set", "max_replay_ratio=1", "--set", f"root_dir={tmp_path}",
            "--set", "refs=ha"]
    mod = [sys.executable, "-m", "pytorch_distributed_tpu_torch.fleet"]
    procs = []

    def start(*argv):
        # a process group each: a host's SIGKILL takes its workers too
        p = subprocess.Popen(mod + list(argv) + sets, cwd=REPO, env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True,
                             start_new_session=True)
        procs.append(p)
        return p

    try:
        lead_lines, sb_lines, act_lines = [], [], []
        lead = start("--role", "learner", "--device", "cpu", "--port", "0",
                     "--local-actors", "0")
        line = _lines_until(lead, "gateway on port", lead_lines)
        port = int(line.split("gateway on port")[1].split(",")[0])
        _drain(lead, lead_lines)
        sb = start("--role", "gateway-standby", "--port", "0",
                   "--coordinator", f"{LOCAL}:{port}")
        line = _lines_until(sb, "standby up on port", sb_lines)
        sport = int(line.split("standby up on port")[1].split(",")[0])
        act = start("--role", "actors", "--coordinator",
                    f"{LOCAL}:{port},{LOCAL}:{sport}", "--actor-base", "0",
                    "--actor-count", "1")
        drain_act = _drain(act, act_lines)
        deadline = time.monotonic() + 120
        while dcn.fetch_status((LOCAL, port)).get("learner_step", 0) < 5:
            assert time.monotonic() < deadline, "".join(lead_lines[-20:])
            time.sleep(0.2)
        st = dcn.fetch_status((LOCAL, sport))["gateway"]
        assert st["role"] == "standby" and st["sync_seq"] > 0
        t_kill = time.monotonic()
        os.killpg(lead.pid, 9)  # the learner host with its logger
        while dcn.fetch_status((LOCAL, sport))["gateway"]["promotions"] < 1:
            assert time.monotonic() - t_kill < 10.0
            time.sleep(0.1)
        while dcn.fetch_status((LOCAL, sport))["chunks_in"] < 1:
            assert time.monotonic() - t_kill < 60.0, "".join(act_lines)
            time.sleep(0.1)
        sb.send_signal(15)
        sb_out, _ = sb.communicate(timeout=60)
        act.wait(timeout=60)
        drain_act.join(10)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, 9)
            except (ProcessLookupError, PermissionError):
                pass
            p.wait()
    assert sb.returncode == 0, sb_out[-3000:]
    assert act.returncode == 0, "".join(act_lines[-30:])
    assert "standby promoted to gateway term 2" in sb_out
    assert "actor-0 done (reconnects 1, faults 0, failovers 1)" in \
        "".join(act_lines), "".join(act_lines[-20:])
    import json

    summary = json.loads(sb_out.splitlines()[-1])
    assert summary["gateway/role"] == "primary"
    assert summary["gateway/promotions"] == 1
    assert summary["gateway/spooled_rows"] > 0


@pytest.mark.timeout(120)
def test_a_running_learner_host_serves_profiles_and_takes_pushes(
        tmp_path, monkeypatch):
    """A row-1 learner host on the thread backend with the perf and
    metrics planes on: the profiler is prewarmed, ``fetch_profile``
    returns a trace written by the learner's window, an actor host's
    ``MetricsPusher`` reaches mission control, and STATUS carries the
    ``perf``, ``alerts`` and ``series`` blocks."""
    import glob

    from pytorch_distributed_tpu_torch.config import MetricsParams
    from pytorch_distributed_tpu_torch.utils import perf, telemetry
    from pytorch_distributed_tpu_torch.utils.metrics import MetricsWriter

    for var in list(os.environ):
        if var.startswith(("TPU_APEX_PERF", "TPU_APEX_METRICS")):
            monkeypatch.delenv(var)
    saved = dict(os.environ)
    perf.reset()
    opt = _row1(tmp_path, steps=100000, evaluator_nepisodes=0,
                max_replay_ratio=1.0, **{"perf_params.enabled": True,
                                         "metrics_params.enabled": True,
                                         "metrics_params.poll_s": 0.2})
    topo = fleet.FleetTopology(opt, local_actors=1, port=0,
                               backend="thread", host=LOCAL)
    try:
        assert topo.profiler_prewarm_s is not None
        runner = threading.Thread(target=topo.run, daemon=True)
        runner.start()
        addr = (LOCAL, topo.port)
        deadline = time.monotonic() + 60
        while dcn.fetch_status(addr).get("learner_step", 0) < 10:
            assert time.monotonic() < deadline and runner.is_alive()
            time.sleep(0.1)
        reply = dcn.fetch_profile(addr, seconds=0.3, label="probe")
        assert reply.get("seconds") == 0.3, reply
        assert glob.glob(os.path.join(reply["trace_dir"],
                                      "*.pt.trace.json"))
        host_dir = tmp_path / "actor_host"
        w = MetricsWriter(str(host_dir), enable_tensorboard=False,
                          role="actor-1")
        w.scalar("actor/env_frames_per_s", 123.0, step=1)
        w.close()
        pusher = telemetry.MetricsPusher(addr, str(host_dir),
                                         MetricsParams(enabled=True))
        assert pusher.push_once() == 1
        st = dcn.fetch_status(addr)
        assert st["telemetry"]["remote_batches"] >= 2
        assert topo.mission.metrics.latest(
            "actor/env_frames_per_s")[1] == 123.0
        assert {"perf", "alerts", "series"} <= set(st)
    finally:
        topo.clock.stop.set()
        runner.join(60)
        os.environ.clear()
        os.environ.update(saved)
        perf.reset()
    assert topo.gateway.profiles_served == 1
    assert topo.gateway.metrics_batches == 2
