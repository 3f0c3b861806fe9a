"""Failure drills of the shared inference server (``actor_backend=
batched``) in the port's runtime, config 12 at a small size on the CPU:

- on the process backend, an actor SIGKILLed while it waits in
  ``collect`` is respawned with a fresh pair of pipes and ticks again,
  and the other actor goes on ticking through the whole drill;
- a serve thread that dies makes ``run`` raise within seconds, on both
  backends.

Each drill carries its own timeout: every child imports torch, so a
respawn takes some seconds.
"""

import threading
import time

import pytest

from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch import runtime


def _topology(root, backend, max_seconds=180):
    opt = port_main.options_from_args(port_main.parse_args([
        "--config", "12", "--backend", backend, "--device", "cpu",
        "--memory-size", "2048", "--batch-size", "8",
        "--num-actors", "2", "--num-envs-per-actor", "2",
        "--steps", str(10 ** 6), "--set", f"max_seconds={max_seconds}",
        "--set", "learn_start=64", "--set", "learner_freq=10",
        "--set", "evaluator_nepisodes=0", "--set", "early_stop=200",
        "--set", "actor_backend=batched",
        "--set", f"root_dir={root}", "--set", "refs=drill"]))
    return runtime.Topology(opt, backend=backend)


def _wait(pred, timeout, what):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.01)


def _run_with(topo, drill):
    """Run ``topo`` here while ``drill(topo)`` runs on a thread; returns
    the run's summary or exception and the drill's error."""
    errors, out = [], {}

    def body():
        try:
            drill(topo)
        except BaseException as e:  # noqa: BLE001 - raised by the caller
            errors.append(e)
        finally:
            topo.clock.stop.set()

    t = threading.Thread(target=body, daemon=True)
    t.start()
    try:
        out["summary"] = topo.run()
    except Exception as e:  # noqa: BLE001 - returned to the caller
        out["error"] = e
    finally:
        t.join(timeout=10.0)
    return out, errors


@pytest.mark.timeout(240)
def test_an_actor_killed_in_collect_is_respawned_with_fresh_pipes(tmp_path):
    topo = _topology(tmp_path, "process")
    srv = topo.inference_server
    board = topo.progress_board
    respond = srv._respond
    held = threading.Event()
    hold = threading.Event()
    seen = {"gaps": []}

    def holding_respond(link, msg):
        # once asked, keep actor-0's next response: it waits in collect
        if hold.is_set() and link.slot == 0 and not held.is_set():
            held.set()
            return
        respond(link, msg)

    srv._respond = holding_respond

    def drill(topo):
        _wait(lambda: topo.clock.learner_step.value > 0, 120.0,
              "the learner never stepped")
        seen["link"] = srv._links[0]
        hold.set()
        _wait(held.is_set, 20.0, "actor-0 sent no request")
        victim = next(p for p in topo._workers if p.name == "actor-0")
        victim.kill()
        # actor-1 must tick on while actor-0 dies and respawns
        last, t_last = board.marks("actor-1"), time.monotonic()
        seen["marks_at_kill"] = last
        deadline = time.monotonic() + 120.0
        while topo.restarts < 1 or board.marks("actor-0") == 0:
            if time.monotonic() > deadline:
                raise TimeoutError("actor-0 was not respawned and ticking")
            marks = board.marks("actor-1")
            if marks != last:
                seen["gaps"].append(time.monotonic() - t_last)
                last, t_last = marks, time.monotonic()
            time.sleep(0.005)
        seen["gaps"].append(time.monotonic() - t_last)
        seen["ticks_meanwhile"] = (board.marks("actor-1")
                                   - seen["marks_at_kill"])
        seen["new_link"] = srv._links[0]
        rows = srv.stats["rows"]
        _wait(lambda: srv.stats["rows"] > rows + 40, 60.0,
              "no requests after the respawn")

    out, errors = _run_with(topo, drill)
    assert not errors, errors
    summary = out["summary"]
    assert summary["runtime/restarts"] == 1
    assert summary["runtime/children_with_cuda"] == 0
    assert seen["new_link"] is not seen["link"] and seen["link"].dead
    # actor-1 never stalled: it ticked on while actor-0 was down, with no
    # gap anywhere near collect's 300 s timeout (a shared queue's lock,
    # held by the killed actor, would have stopped it)
    assert seen["ticks_meanwhile"] >= 10, seen
    assert max(seen["gaps"]) < 30.0, seen["gaps"]
    assert summary["inference/requests"] > 0


@pytest.mark.timeout(240)
@pytest.mark.parametrize("backend", ["process", "thread"])
def test_a_dead_serve_thread_makes_run_raise(tmp_path, backend):
    topo = _topology(tmp_path, backend)
    srv = topo.inference_server
    sweep = srv._run_sweep
    die = threading.Event()
    seen = {}

    def dying_sweep(batch, rows):
        if die.is_set():
            raise RuntimeError("serve thread killed by the drill")
        sweep(batch, rows)

    srv._run_sweep = dying_sweep

    def drill(topo):
        _wait(lambda: topo.clock.learner_step.value > 0, 120.0,
              "the learner never stepped")
        die.set()
        seen["killed"] = time.monotonic()
        _wait(lambda: not srv.healthy(), 30.0, "the serve thread lived on")
        # the run is stopped by the monitor, not by the drill's end
        _wait(topo.clock.stop.is_set, 30.0, "the run went on")
        seen["stopped"] = time.monotonic()

    out, errors = _run_with(topo, drill)
    assert not errors, errors
    assert isinstance(out.get("error"), RuntimeError)
    assert "inference server died" in str(out["error"])
    assert seen["stopped"] - seen["killed"] < 30.0
