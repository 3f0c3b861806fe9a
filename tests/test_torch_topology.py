"""The run topology of the port against the reference: the config fields
it copies, the evaluator -> logger handshake and the logger's rows, the
params checkpoints and their ``_best`` tier, and config 12 end to end on
the process backend (actors, an evaluator and a logger in children
forked from the forkserver, the learner here) followed by ``--mode 2`` on
its params file, each child under the environment of its own start, and
a dead child the run cannot replace (the evaluator, or an actor with no
restart left), which must make ``run`` raise, not hang.

The process-backend tests carry their own timeout: the forkserver imports
torch once, so a run takes some seconds to start.
"""

import dataclasses
import math
import os
import threading
import time

import numpy as np
import pytest

import torch

from pytorch_distributed_tpu.agents import clocks as jax_clocks
from pytorch_distributed_tpu.agents.logger import run_logger as jax_logger
from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.utils.metrics import (
    read_scalars as jax_read_scalars,
)
from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch import runtime
from pytorch_distributed_tpu_torch.agents import clocks
from pytorch_distributed_tpu_torch.agents import evaluator as evaluator_mod
from pytorch_distributed_tpu_torch.agents.logger import run_logger
from pytorch_distributed_tpu_torch.agents.param_store import ParamStore
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.factory import EnvSpec
from pytorch_distributed_tpu_torch.utils import checkpoint
from pytorch_distributed_tpu_torch.utils.metrics import read_scalars

# the fields of each Options part that the port copies, with the
# reference's defaults for config 12; ``device`` is the port's own
PORT_ONLY = {"device"}


def _fields(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def test_config_copies_the_reference(tmp_path):
    kw = dict(root_dir=str(tmp_path), refs="run")
    port, ref = build_options(12, **kw), jax_options(12, **kw)
    ours, theirs = _fields(port), _fields(ref)
    for name, value in ours.items():
        if name.split(".")[-1] in PORT_ONLY:
            continue
        assert name in theirs, name
        assert value == theirs[name], (name, value, theirs[name])
    for key in ("logger_freq", "evaluator_freq", "evaluator_nepisodes",
                "tester_nepisodes", "early_stop"):
        assert any(n.endswith("." + key) for n in ours), key
    for prop in ("model_dir", "model_name", "log_dir"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.mode == ref.mode == 1 and port.model_file is None
    test = build_options(12, mode=2, **kw)
    assert test.model_file == jax_options(12, mode=2, **kw).model_file \
        == test.model_name


def _drive_handshake(mod):
    """The same publish / consume sequence on either package's stats."""
    stats = mod.EvaluatorStats()
    seen = [stats.consume()]
    stats.publish(5, wall=123.5, avg_steps=180.0, avg_reward=-20.0,
                  nepisodes=2.0, nepisodes_solved=0.0)
    seen += [stats.consume(), stats.consume()]
    stats.publish(9, avg_steps=1.0, avg_reward=3.0)
    stats.publish(11, wall=7.0, avg_reward=4.0)  # overwrites the unread one
    seen += [stats.consume(), bool(stats.done.value)]
    return seen


def test_evaluator_handshake_matches_the_reference():
    assert _drive_handshake(clocks) == _drive_handshake(jax_clocks)
    assert clocks.ActorStats.FIELDS == jax_clocks.ActorStats.FIELDS
    assert clocks.LearnerStats.FIELDS == jax_clocks.LearnerStats.FIELDS
    assert clocks.EvaluatorStats.FIELDS == jax_clocks.EvaluatorStats.FIELDS


def _logger_rows(mod, logger, opt):
    """Run ``logger`` to its end on fixed inputs: one evaluator result,
    one actor and two learner adds, then the end of the run."""
    clock = mod.GlobalClock()
    a, le, ev = mod.ActorStats(), mod.LearnerStats(), mod.EvaluatorStats()
    ev.publish(5, wall=1_700_000_000.25, avg_steps=180.0, avg_reward=-20.0,
               nepisodes=2.0, nepisodes_solved=0.0)
    a.add(nepisodes=2, nepisodes_solved=1, total_steps=300,
          total_reward=-10.0, total_nframes=640)
    le.add(counter=1, critic_loss=0.5, q_mean=0.25, grad_norm=2.0,
           steps_per_sec=100.0)
    le.add(counter=1, critic_loss=0.25, q_mean=0.75, grad_norm=1.0,
           steps_per_sec=300.0)
    clock.set_learner_step(7)
    ev.done.value = 1
    clock.stop.set()
    t = threading.Thread(target=logger, args=(opt, clock, a, le, ev),
                         daemon=True)
    t.start()
    return t


def test_logger_rows_match_the_reference(tmp_path):
    kw = dict(root_dir=str(tmp_path), refs="log", steps=7)
    opt, jopt = build_options(12, **kw), jax_options(12, visualize=False,
                                                     **kw)
    # the two loggers would append to one file: give each its own root
    jopt.root_dir = str(tmp_path / "ref")
    threads = [_logger_rows(clocks, run_logger, opt),
               _logger_rows(jax_clocks, jax_logger, jopt)]
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    ours, theirs = read_scalars(opt.log_dir), jax_read_scalars(jopt.log_dir)
    assert len(ours) == len(theirs) == 4 + 4 + 6
    for r in ours + theirs:
        assert set(r) == {"tag", "value", "step", "wall", "role", "run_id"}
    key = lambda r: (r["tag"], r["value"], r["step"], r["role"],
                     r["run_id"])
    assert sorted(map(key, ours)) == sorted(map(key, theirs))
    # evaluator rows carry the capture wall time
    assert {r["wall"] for r in ours if r["tag"].startswith("evaluator/")} \
        == {1_700_000_000.25}


def test_checkpoint_round_trip(tmp_path):
    params = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(
        0)), "b": torch.arange(4, dtype=torch.float32)}
    name = str(tmp_path / "models" / "run")
    path = checkpoint.save_params(checkpoint.params_path(name), params)
    assert path == name + ".pt" and os.path.exists(path)
    back = checkpoint.load_params(path)
    assert back.keys() == params.keys()
    assert all(torch.equal(back[k], params[k]) for k in params)
    assert checkpoint.load_best_score(name) == float("-inf")
    checkpoint.save_best_score(name, 2.5, step=10)
    assert checkpoint.load_best_score(name) == 2.5
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path / "models"))


def test_best_tier_only_moves_up(tmp_path, monkeypatch):
    """The evaluator on scripted scores: every evaluation rewrites the
    params file, the ``_best`` tier only follows a new maximum."""
    frame = (4, 44, 44)
    opt = build_options(12, device="cpu", root_dir=str(tmp_path),
                        refs="best", evaluator_freq=0, evaluator_nepisodes=1,
                        steps=10 ** 9)
    spec = EnvSpec(frame, 6, 255.0)
    scores = [1.0, 3.0, 2.0, 0.5, -1.0]
    seen = []
    from pytorch_distributed_tpu_torch.factory import build_model
    from pytorch_distributed_tpu_torch.agents.param_store import (
        make_flattener,
    )
    flat0, _ = make_flattener(build_model(opt, spec).state_dict(), frame)
    store = ParamStore(flat0.size)
    store.publish(flat0)
    clock, stats = clocks.GlobalClock(), clocks.EvaluatorStats()

    def scripted(opt_, spec_, model, params, env, nepisodes):
        seen.append({k: v.clone() for k, v in params.items()})
        store.publish(flat0 + len(seen))  # the learner moves on
        clock.set_learner_step(len(seen))
        if len(seen) == len(scores) - 1:
            clock.stop.set()
        while stats.flag.value and not clock.stop.is_set():
            stats.consume()
        return 10.0, scores[len(seen) - 1], 0

    monkeypatch.setattr(evaluator_mod, "greedy_episodes", scripted)
    t = threading.Thread(target=evaluator_mod.run_evaluator,
                         args=(opt, spec, 0, None, store, clock, stats),
                         daemon=True)
    t.start()
    t.join(timeout=30.0)
    assert not t.is_alive() and stats.done.value == 1
    assert len(seen) == len(scores)  # the last one is the final eval
    best = int(np.argmax(scores))
    assert clock.best_eval_reward.value == max(scores)
    assert checkpoint.load_best_score(opt.model_name) == max(scores)
    tiers = {tier: checkpoint.load_params(checkpoint.params_path(
        opt.model_name + tier)) for tier in ("", "_best")}
    for k in seen[0]:
        assert torch.equal(tiers["_best"][k], seen[best][k]), k
        assert torch.equal(tiers[""][k], seen[-1][k]), k


def _process_run(root, *extra):
    return ["--config", "12", "--backend", "process", "--device", "cpu",
            "--memory-size", "2048", "--batch-size", "8", "--steps", "20",
            "--num-actors", "2", "--num-envs-per-actor", "2",
            "--set", "learn_start=64", "--set", "learner_freq=10",
            "--set", "evaluator_nepisodes=1", "--set", "early_stop=200",
            "--set", f"root_dir={root}", "--set", "refs=proc", *extra]


@pytest.mark.timeout(120)
def test_process_backend_end_to_end_then_mode_2(tmp_path):
    summary = port_main.main(_process_run(tmp_path))
    assert summary["learner/steps"] == 20
    assert math.isfinite(summary["learner/critic_loss"])
    assert summary["runtime/children_with_cuda"] == 0
    assert summary["replay/size"] > 64 and summary["actor/steps"] > 64
    opt = build_options(12, root_dir=str(tmp_path), refs="proc")
    rows = read_scalars(opt.log_dir)
    tags = {r["tag"] for r in rows}
    assert {"evaluator/avg_reward", "learner/critic_loss",
            "actor/total_nframes"} <= tags
    # the final evaluation is of the finished weights
    assert max(r["step"] for r in rows
               if r["tag"] == "evaluator/avg_reward") == 20
    for tier in ("", "_best"):
        assert os.path.exists(checkpoint.params_path(opt.model_name + tier))
    stats = port_main.main(["--config", "12", "--mode", "2", "--device",
                            "cpu", "--model-file", opt.model_name,
                            "--set", "tester_nepisodes=1",
                            "--set", "early_stop=200"])
    assert stats["nepisodes"] == 1.0
    assert all(math.isfinite(v) for v in stats.values())
    assert 0 < stats["avg_steps"] <= 200


@pytest.mark.timeout(180)
def test_each_child_runs_under_the_environment_of_its_start(tmp_path,
                                                            monkeypatch):
    """The forkserver keeps the environment of its first use; a drill set
    in this process after it started (``FEEDER_FAULTS``, read by each
    actor child's feeder) still reaches the next run's children, as it
    would reach spawn children: the poisoned chunks are quarantined."""
    monkeypatch.delenv("FEEDER_FAULTS", raising=False)
    clean = port_main.main(_process_run(tmp_path))  # the server is up
    assert runtime._CTX.get_start_method() == "forkserver"
    assert clean["ingest/quarantined"] == 0
    monkeypatch.setenv("FEEDER_FAULTS", "poison_chunk@1")
    drilled = port_main.main(_process_run(tmp_path, "--set",
                                          "refs=drilled"))
    assert drilled["ingest/quarantined"] > 0
    assert drilled["learner/steps"] == 20
    assert drilled["runtime/children_with_cuda"] == 0


@pytest.mark.timeout(120)
@pytest.mark.parametrize("victim", ["actor-1", "evaluator-0"])
def test_a_dead_child_makes_run_raise(tmp_path, victim):
    """A child killed mid-run that the run cannot replace (the actor's
    slot has no restart left): the monitor stops the run, the learner's
    loop ends (its ingest read too, if the child was writing a chunk), the
    logger does not wait for a dead evaluator's last point, and ``run``
    raises naming the child, within seconds."""
    # the evaluator at full priority: its final evaluation is in the
    # join, and a niced one (``evaluator_nice``) waits behind every busy
    # core of a loaded test host
    opt = port_main.options_from_args(port_main.parse_args(_process_run(
        tmp_path, "--set", "max_seconds=45", "--set", "evaluator_nice=0")))
    opt.agent_params.steps = 10 ** 6
    topo = runtime.Topology(opt, backend="process", max_restarts=0)
    killed = []

    def kill_the_victim():
        deadline = time.monotonic() + 40.0
        while time.monotonic() < deadline:
            found = [p for p in topo._workers if p.name == victim]
            if found and topo.clock.actor_step.value > 0:
                found[0].kill()
                killed.append(time.monotonic())
                return
            time.sleep(0.05)

    threading.Thread(target=kill_the_victim, daemon=True).start()
    with pytest.raises(RuntimeError, match=victim):
        topo.run()
    assert killed, f"{victim} was not killed"
    assert time.monotonic() - killed[0] < 20.0
    assert not any(p.is_alive() for p in topo._workers)


def test_mode_2_without_a_gpu_refuses_cuda(tmp_path):
    """The tester runs on the run's device: with no GPU visible and no
    ``--device cpu``, mode 2 raises before it plays; and mode 1's default
    backend is the reference's ``process``."""
    assert port_main.parse_args([]).backend == "process"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        port_main.main(["--config", "12", "--mode", "2", "--model-file",
                        str(tmp_path / "models" / "none"),
                        "--set", "tester_nepisodes=1"])
