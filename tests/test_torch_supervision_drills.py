"""Failure drills of the port's runtime on the process backend (config 12
at a small size, on the CPU, with spawn children): an actor SIGKILLed
mid-run is respawned on a fresh slot queue and the run goes on; a spent
restart budget makes ``run`` raise; an actor SIGSTOPped under the hang
watchdog is killed and respawned; and ``main`` sent SIGTERM exits 0 with a
committed epoch, which ``--resume REFS`` continues.  The counts are exact.

Each drill carries its own timeout: every child imports torch, so a
respawn takes some seconds.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch import runtime
from pytorch_distributed_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(root, refs="drill", *extra):
    return ["--config", "12", "--backend", "process", "--device", "cpu",
            "--memory-size", "2048", "--batch-size", "8",
            "--num-actors", "2", "--num-envs-per-actor", "2",
            "--set", "learn_start=64", "--set", "learner_freq=10",
            "--set", "evaluator_nepisodes=0", "--set", "early_stop=200",
            "--set", f"root_dir={root}", "--set", f"refs={refs}", *extra]


def _topology(root, *extra, max_restarts=3):
    opt = port_main.options_from_args(port_main.parse_args(_argv(
        root, "drill", "--steps", str(10 ** 6), "--set", "max_seconds=60",
        *extra)))
    return runtime.Topology(opt, backend="process",
                            max_restarts=max_restarts)


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.05)


def _child(topo, name):
    return next(p for p in list(topo._workers) if p.name == name)


def _run_with(topo, drill):
    """Run ``topo`` here while ``drill(topo)`` runs on a thread; the
    drill's error, if any, is raised after the run."""
    errors = []

    def body():
        try:
            drill(topo)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            topo.clock.stop.set()

    t = threading.Thread(target=body, daemon=True)
    t.start()
    try:
        summary = topo.run()
    finally:
        t.join(timeout=10.0)
    if errors:
        raise errors[0]
    return summary


def _respawned_and_ticking(topo, name, restarts):
    """Wait for the ``restarts``-th respawn and for the new incarnation
    of ``name`` to tick."""
    _wait(lambda: topo.restarts >= restarts, 20.0, "no respawn")
    _wait(lambda: topo.progress_board.marks(name) > 0, 30.0,
          f"the respawned {name} never ticked")


@pytest.mark.timeout(90)
def test_a_killed_actor_is_respawned_on_a_fresh_queue(tmp_path):
    topo = _topology(tmp_path)
    ingest = topo.handles.learner_side
    seen = {}

    def drill(topo):
        _wait(lambda: topo.clock.learner_step.value > 0, 40.0,
              "the learner never stepped")
        seen["queue"] = ingest._live[0]
        _child(topo, "actor-0").kill()
        _respawned_and_ticking(topo, "actor-0", 1)
        seen["respawned_queue"] = ingest._live[0]
        fed = ingest._fed_total
        # the new incarnation's rows arrive through its own queue
        _wait(lambda: ingest._fed_total > fed + 32, 20.0, "no new rows")

    summary = _run_with(topo, drill)
    assert summary["runtime/restarts"] == 1
    assert summary["runtime/hang_kills"] == 0
    assert summary["runtime/preempted"] == 0
    assert summary["runtime/children_with_cuda"] == 0
    assert seen["respawned_queue"] is not seen["queue"]
    assert seen["queue"] not in ingest._retiring  # read to its end
    assert ingest.torn_reads >= 1
    assert summary["checkpoint/epochs_committed"] == 1


@pytest.mark.timeout(90)
def test_a_spent_restart_budget_makes_run_raise(tmp_path):
    topo = _topology(tmp_path, max_restarts=1)
    kills = []

    def drill(topo):
        _wait(lambda: topo.clock.learner_step.value > 0, 40.0,
              "the learner never stepped")
        _child(topo, "actor-0").kill()
        kills.append(time.monotonic())
        _respawned_and_ticking(topo, "actor-0", 1)
        _child(topo, "actor-0").kill()
        kills.append(time.monotonic())
        _wait(lambda: topo.clock.stop.is_set(), 20.0, "the run went on")

    with pytest.raises(RuntimeError, match="actor-0"):
        _run_with(topo, drill)
    assert len(kills) == 2 and topo.restarts == 1
    assert not any(p.is_alive() for p in topo._workers)


@pytest.mark.timeout(90)
def test_the_watchdog_kills_and_respawns_a_stopped_actor(tmp_path):
    topo = _topology(tmp_path, "--set", "hang_deadline=3",
                     "--set", "hang_grace=60")
    stopped = []

    def drill(topo):
        # a child that never marked answers to deadline + grace
        _wait(lambda: topo.clock.learner_step.value > 0
              and topo.progress_board.marks("actor-1") > 0, 40.0,
              "the learner or actor-1 never stepped")
        victim = _child(topo, "actor-1")
        os.kill(victim.pid, signal.SIGSTOP)
        stopped.append(victim)
        _respawned_and_ticking(topo, "actor-1", 1)

    summary = _run_with(topo, drill)
    assert summary["runtime/hang_kills"] == 1
    assert summary["runtime/restarts"] == 1
    assert stopped[0].exitcode == -signal.SIGKILL
    assert summary["learner/steps"] > 0


def _main_subprocess(root, refs, *extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        REPO, os.environ.get("PYTHONPATH")))))
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.main",
         *_argv(root, refs, "--steps", str(10 ** 6), *extra)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.mark.timeout(150)
def test_sigterm_commits_an_epoch_that_resume_continues(tmp_path):
    proc = _main_subprocess(tmp_path, "pre",
                            "--set", "checkpoint_replay=true")
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("[learner] step 20 "):
                break
        proc.send_signal(signal.SIGTERM)
        sent = time.monotonic()
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    lines += out.splitlines()
    assert proc.returncode == 0, "".join(lines[-30:])
    assert time.monotonic() - sent < 60.0
    assert any("preemption notice" in ln for ln in lines)
    name = str(tmp_path / "models" / "pre")
    report = checkpoint.fsck(checkpoint.ckpt_root(name))
    assert not report["violations"] and report["newest_complete"] == 0
    info = checkpoint.resolve_epoch(name)
    assert set(info.manifest["artifacts"]) == {
        checkpoint.STATE, checkpoint.REPLAY, checkpoint.EXTRAS}
    step = info.learner_step
    assert step >= 20
    rows = info.manifest["artifacts"][checkpoint.REPLAY]["rows"]
    assert rows > 64

    summary = port_main.main(_argv(tmp_path, "pre", "--resume", "pre",
                                   "--steps", str(step + 10),
                                   "--set", "checkpoint_replay=true"))
    assert summary["learner/resumed_from_step"] == step
    assert summary["learner/steps"] == step + 10
    assert summary["runtime/preempted"] == 0
    assert summary["replay/size"] >= rows
    after = checkpoint.resolve_epoch(name)
    assert after.epoch == 1 and after.learner_step == step + 10
    assert after.extras["actor_step"] >= info.extras["actor_step"]
