"""The port's co-located Anakin loop (agents/anakin.py) and the backend
gates (factory.py).

The headline is the parity test: on the CPU, under a fixed seed and
strict alternation, an ``AnakinDriver`` run is bit-identical to the
``actor_backend=device`` path driven to the same schedule (ring contents,
PER priorities, learner params after the run, and the actions), because
both run the same programs: the fused rollout (replay emit against chunk
emit fed through feeder -> queue -> drain) and the learner's fused step
on the learner's draws.  The device leg is that path's pieces in one
process: the device actor's rollout and generator, the in-process ingest,
and run_learner's fused step, beta schedule and generator, the actor
acting on the train state's params each dispatch (the zero staleness the
co-located loop has).

Also: the backend gates step down as the JAX package's do; the scheduler
(warmup, strict alternation, the ``rollout_ratio`` setpoint, the
double-buffer geometry and swap, the environment override), the topology
(no actor worker), ``--resume`` seeding the cumulative frame count, and a
short run through ``main`` on each of ``anakin`` and ``device``.
"""

import dataclasses
import json
import math
import warnings

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.factory import (
    resolve_actor_backend as jax_resolve,
)
from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch.agents.anakin import (
    AnakinDriver, resolve_anakin,
)
from pytorch_distributed_tpu_torch.agents.clocks import (
    ActorStats, GlobalClock, LearnerStats,
)
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, num_params,
)
from pytorch_distributed_tpu_torch.config import AnakinParams, build_options
from pytorch_distributed_tpu_torch.factory import (
    anakin_active, anakin_eligible, build_device_env, build_memory,
    build_model, build_train_state_and_step, init_params, module_apply,
    probe_env, resolve_actor_backend, role_seed,
)
from pytorch_distributed_tpu_torch.models.policies import (
    apex_epsilons, build_fused_rollout, init_rollout_carry,
)
from pytorch_distributed_tpu_torch.runtime import Topology
from pytorch_distributed_tpu_torch.utils.experience import (
    REPLAY_FIELDS, Transition,
)
from pytorch_distributed_tpu_torch.utils.metrics import read_scalars


def _opts(tmp_path, **kw):
    """Config 12 shrunk for the CPU: 16 envs, K_roll 8, nstep 4, a
    256-row ring, batch 32, learn_start 64 = the first rollout's rows."""
    base = dict(
        root_dir=str(tmp_path), refs="anakin_t", device="cpu",
        num_actors=1, num_envs_per_actor=16, actor_backend="anakin",
        nstep=4, memory_size=256, learn_start=64, batch_size=32,
        steps=10 ** 6, early_stop=50, device_rollout_ticks=8,
        actor_freq=10 ** 9, learner_freq=10 ** 9,
        param_publish_freq=10 ** 9, checkpoint_freq=10 ** 9)
    base.update(kw)
    return build_options(12, **base)


def _driver(opt):
    spec = probe_env(opt)
    handles = build_memory(opt, spec, in_process=True)
    store = ParamStore(num_params(build_model(
        opt, spec, init_weights=False).state_dict()))
    drv = AnakinDriver(opt, spec, handles.learner_side, store, GlobalClock(),
                       LearnerStats(), actor_stats=ActorStats())
    return drv, handles


# ---------------------------------------------------------------------------
# the backend gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,change,expect,warns", [
    ("anakin", {}, "anakin", 0),
    ("device", {}, "device", 0),
    # a host ring: anakin steps down to device (the JAX package's config 4)
    ("anakin", {"memory_type": "shared"}, "device", 1),
    # no device env: anakin -> device -> pipelined (its config 1)
    ("anakin", {"env_type": "fake"}, "pipelined", 2),
    ("device", {"env_type": "fake"}, "pipelined", 1),
    ("device", {"agent_type": "ddpg"}, "pipelined", 1),
])
def test_backend_gates_step_down_as_the_reference(tmp_path, backend, change,
                                                  expect, warns):
    opt = _opts(tmp_path, actor_backend=backend)
    jopt = jax_options(12, root_dir=str(tmp_path), num_actors=1,
                       actor_backend=backend)
    for o in (opt, jopt):
        for k, v in change.items():
            setattr(o, k, v)
            if k == "env_type":
                o.env_params.env_type = v
    results = []
    for fn, o in ((resolve_actor_backend, opt), (jax_resolve, jopt)):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            results.append(fn(o))
        assert sum(issubclass(w.category, UserWarning) for w in got) \
            == warns, [str(w.message) for w in got]
    assert results == [expect, expect]
    assert anakin_active(opt) == (expect == "anakin")
    assert anakin_eligible(opt)[0] == (expect == "anakin"
                                       or backend == "device" and not change)


# ---------------------------------------------------------------------------
# parity: anakin against the device path
# ---------------------------------------------------------------------------

DISPATCHES = 8  # strict alternation: 4 rollouts and 4 learner dispatches


def _device_leg(opt, schedule):
    ap = opt.agent_params
    spec = probe_env(opt)
    ingest = build_memory(opt, spec, in_process=True).learner_side
    model = build_model(opt, spec)
    params = init_params(opt, spec, seed=opt.seed, device="cpu")
    state, step_fn = build_train_state_and_step(opt, model, params)
    ring = ingest.attach("cpu")
    fused = ring.build_fused_step(step_fn, ap.batch_size, steps_per_call=1)
    gen = torch.Generator().manual_seed(role_seed(opt.seed, "learner", 0))
    n, k_roll = opt.env_params.num_envs_per_actor, \
        opt.env_params.device_rollout_ticks
    env = build_device_env(opt, 0, n, "cpu")
    roll = build_fused_rollout(
        module_apply(model), env, nstep=ap.nstep, gamma=ap.gamma,
        rollout_ticks=k_roll,
        eps=apex_epsilons(0, 1, n, ap.eps, ap.eps_alpha))
    carry = init_rollout_carry(env, ap.nstep)
    act_gen = torch.Generator().manual_seed(role_seed(opt.seed, "actor", 0))
    feeder = ingest.make_feeder()
    actions, beta, next_beta, lstep = [], 0.0, 0, 0
    for kind in schedule:
        if kind == "R":
            roll.draw(act_gen)
            ch = roll(state.params, carry)
            for k, j in zip(*np.nonzero(ch.valid.numpy())):
                row = Transition(*(getattr(ch, f)[k, j].numpy()
                                   for f in REPLAY_FIELDS))
                feeder.feed(row)
                actions.append(int(row.action))
            feeder.flush()
        else:
            ingest.drain()
            if lstep >= next_beta:
                beta, next_beta = ring.beta(lstep), lstep + 64
            us = torch.rand((1, ap.batch_size), generator=gen)
            state, _m = fused(state, ring.state, us, beta)
            lstep += 1
    ingest.close()
    return ring.state, state.params, actions


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("anakin_parity")
    drv, handles = _driver(_opts(tmp / "a"))
    assert len(drv.rings) == 1 and drv.min_fill == 64
    schedule, fed = [], 0
    for _ in range(DISPATCHES):
        if drv.want_rollout():
            fed += drv.dispatch_rollout().rows
            schedule.append("R")
        else:
            drv.dispatch_learn()
            schedule.append("L")
    drv.writer.close()
    handles.learner_side.close()
    ring_b, params_b, actions = _device_leg(
        _opts(tmp / "b", actor_backend="device"), schedule)
    return dict(schedule="".join(schedule), ring_a=drv.rings[0].state,
                params_a=drv.state.params, ring_b=ring_b, params_b=params_b,
                actions=actions, fed=fed, frames=drv.frames,
                memory_size=handles.learner_side.size)


def test_schedule_is_strict_alternation_after_warmup(parity):
    # min_fill = learn_start = 64 = the first rollout's rows
    assert parity["schedule"] == "RLRLRLRL"
    assert parity["frames"] == 4 * 8 * 16
    assert parity["fed"] == 64 + 3 * 128
    assert parity["memory_size"] == 256  # the ingest counts the scatter


def test_ring_contents_bit_identical(parity):
    a, b = parity["ring_a"], parity["ring_b"]
    for f in REPLAY_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.pos, a.fill) == (b.pos, b.fill) == (
        parity["fed"] % 256, 256)
    assert float(a.fill_rows) == float(b.fill_rows) == 256.0


def test_per_priorities_bit_identical(parity):
    a, b = parity["ring_a"], parity["ring_b"]
    assert torch.equal(a.priority, b.priority)
    assert torch.equal(a.max_priority, b.max_priority)
    assert float(a.max_priority) != 1.0  # the learner wrote priorities


def test_learner_params_bit_identical(parity):
    a, b = parity["params_a"], parity["params_b"]
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_actions_bit_identical(parity):
    """The device leg's emitted actions, later writes winning as in the
    ring, against the co-located ring's action column (the run wraps)."""
    acts = parity["actions"]
    assert len(acts) == parity["fed"] > 256
    exp = np.zeros(256, np.int32)
    for i, a in enumerate(acts):
        exp[i % 256] = a
    np.testing.assert_array_equal(parity["ring_a"].action.numpy(), exp)


# ---------------------------------------------------------------------------
# the duty-cycle scheduler: host logic, no dispatch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sched(tmp_path_factory):
    drv, handles = _driver(_opts(tmp_path_factory.mktemp("anakin_sched"),
                                 double_buffer=True, learn_start=32))
    yield drv
    drv.writer.close()
    handles.learner_side.close()


def _reset(d):
    d._fill = [0 for _ in d.rings]
    d._fresh = 0
    d.sample_ix = d.write_ix = 0
    d.frames = 0
    d.lstep = d.lstep0 = 0
    d._last_was_rollout = False


def test_double_buffer_geometry(sched):
    assert len(sched.rings) == 2 and len(sched.rollouts) == 2
    assert sched.rings[0].capacity == sched.rings[1].capacity == 128
    assert sched.min_fill == 32
    assert sched.rollouts[1].ring is sched.rings[1].state


def test_warmup_forces_rollouts(sched):
    _reset(sched)
    assert sched.want_rollout()
    sched._fill[0] = sched.min_fill - 1
    assert sched.want_rollout()


def test_cold_start_split_then_swap_on_fresh(sched):
    _reset(sched)
    sched._fill[0] = sched.min_fill
    sched._maybe_swap()
    assert (sched.sample_ix, sched.write_ix) == (0, 1)
    sched._fresh = sched.min_fill - 1
    sched._maybe_swap()
    assert (sched.sample_ix, sched.write_ix) == (0, 1)
    sched._fresh = sched.min_fill
    sched._maybe_swap()
    assert (sched.sample_ix, sched.write_ix) == (1, 0)
    assert sched._fresh == 0
    for _ in range(8):
        sched._fresh = sched.min_fill
        sched._maybe_swap()
        assert sched.sample_ix != sched.write_ix


def test_strict_alternation_when_ratio_zero(sched):
    _reset(sched)
    sched._fill[0] = sched.min_fill
    sched._maybe_swap()
    assert sched.an.rollout_ratio == 0
    sched._last_was_rollout = True
    assert not sched.want_rollout()
    sched._last_was_rollout = False
    assert sched.want_rollout()


def test_rollout_ratio_setpoint(sched):
    _reset(sched)
    sched._fill[0] = sched.min_fill
    sched._maybe_swap()
    sched.an = dataclasses.replace(sched.an, rollout_ratio=128.0)
    try:
        sched.lstep = sched.lstep0 + 2  # 2 updates -> setpoint 256
        sched.frames = 255
        assert sched.want_rollout()
        sched.frames = 256
        assert not sched.want_rollout()
    finally:
        sched.an = dataclasses.replace(sched.an, rollout_ratio=0.0)


def test_double_buffer_run_writes_one_half_and_samples_the_other(tmp_path):
    """A driven run of the double buffer: rollouts write the write half,
    learner dispatches sample the other (never the one being written),
    and the halves swap once ``min_fill`` fresh rows landed."""
    drv, handles = _driver(_opts(tmp_path, num_envs_per_actor=4,
                                 learn_start=24, batch_size=8,
                                 double_buffer=True))
    try:
        seen = set()
        for _ in range(24):
            if drv.want_rollout():
                before = [r.state.pos for r in drv.rings]
                ix = drv.write_ix
                rows = drv.dispatch_rollout().rows
                after = [r.state.pos for r in drv.rings]
                assert after[1 - ix] == before[1 - ix]
                assert after[ix] == (before[ix] + rows) % 128
            else:
                assert drv.sample_ix != drv.write_ix
                drv.dispatch_learn()
                seen.add(drv.sample_ix)
        assert seen == {0, 1}  # the halves swapped
        assert all(f >= drv.min_fill for f in drv._fill)
        assert handles.learner_side.size == min(drv.frames - 4 * 4, 256)
    finally:
        drv.writer.close()
        handles.learner_side.close()


def test_env_knob_override(monkeypatch):
    monkeypatch.setenv("TPU_APEX_ANAKIN_ROLLOUT_RATIO", "64")
    monkeypatch.setenv("TPU_APEX_ANAKIN_DOUBLE_BUFFER", "1")
    monkeypatch.setenv("TPU_APEX_ANAKIN_MIN_FILL", "7")
    ap = AnakinParams()
    out = resolve_anakin(ap)
    assert (out.rollout_ratio, out.double_buffer, out.min_fill) \
        == (64.0, True, 7)
    assert ap.rollout_ratio == 0.0  # the input is not changed


def test_rollout_ratio_is_reachable_by_set():
    opt = build_options(12, rollout_ratio=16.0, double_buffer=True)
    assert opt.anakin_params.rollout_ratio == 16.0
    assert opt.anakin_params.double_buffer


# ---------------------------------------------------------------------------
# topology, resume, and runs through main
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,actors", [("anakin", 0), ("device", 3)])
def test_topology_spawns_actors_only_off_anakin(tmp_path, backend, actors):
    topo = Topology(_opts(tmp_path, num_actors=3, actor_backend=backend),
                    backend="thread")
    try:
        assert topo.anakin == (backend == "anakin")
        roles = [s[0] for s in topo._worker_specs()]
        assert roles.count("actor") == actors and "logger" in roles
        assert sorted(topo.progress_board.labels) == sorted(
            ["learner", "evaluator-0"]
            + [f"actor-{i}" for i in range(actors)])
    finally:
        topo.handles.learner_side.close()


def test_resume_seeds_cumulative_frames(tmp_path):
    """A resumed driver restores the cumulative frames beside lstep and
    lstep0, so the setpoint's deficit survives the restart."""
    opt = _opts(tmp_path, num_envs_per_actor=4, learn_start=8, batch_size=8,
                rollout_ratio=64.0)
    drv, handles = _driver(opt)
    for _ in range(5):
        if drv.want_rollout():
            drv.dispatch_rollout()
        else:
            drv.dispatch_learn()
    frames, lstep = drv.frames, drv.lstep
    assert frames > 0 and lstep > drv.lstep0
    deficit = (lstep - drv.lstep0) * drv.an.rollout_ratio - frames
    drv.save_epoch()
    drv.writer.close()
    handles.learner_side.close()
    drv2, handles2 = _driver(opt)
    try:
        assert drv2.lstep == lstep and drv2.frames == frames
        assert (drv2.lstep - drv2.lstep0) * drv2.an.rollout_ratio \
            - drv2.frames == deficit
        assert drv2.clock.actor_step.value == frames
    finally:
        drv2.writer.close()
        handles2.learner_side.close()


@pytest.mark.parametrize("backend", ["anakin", "device"])
def test_main_runs_each_backend_on_the_cpu(tmp_path, backend, capsys):
    summary = port_main.main([
        "--config", "12", "--device", "cpu", "--backend", "thread",
        "--memory-size", "2048", "--batch-size", "8", "--steps", "20",
        "--num-actors", "2", "--num-envs-per-actor", "2",
        "--set", "learn_start=64", "--set", "evaluator_nepisodes=1",
        "--set", "early_stop=200", "--set", f"root_dir={tmp_path}",
        "--set", "refs=r", "--set", f"actor_backend={backend}"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == json.loads(json.dumps(summary))
    assert summary["learner/steps"] == 20
    assert math.isfinite(summary["learner/critic_loss"])
    assert summary["runtime/actor_steps"] > 0
    if backend == "anakin":
        assert summary["anakin/learns"] == 20
        assert summary["anakin/rollouts"] >= 20
        assert summary["runtime/actor_steps"] == summary["anakin/frames"]
    tags = {r["tag"] for r in read_scalars(
        build_options(12, root_dir=str(tmp_path), refs="r").log_dir)}
    assert {"evaluator/avg_reward", "actor/total_nframes"} <= tags
