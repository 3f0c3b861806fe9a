"""The actor's schedules, its weight prefetch and its step timer
(agents/actor.py, agents/param_store.py ``ParamPrefetcher``,
utils/profiling.py ``StepTimer``), held to the reference's contracts:

- ``pipelined`` changes when the forward runs, never what is computed: its
  transition stream equals ``inline``'s bit for bit (the reference's
  oracle, tests/test_actor_pipeline.py:54), on numpy and on native Pong;
- a weight swap mid-run lands at the same tick in both schedules;
- the prefetcher's take/version semantics (reference
  tests/test_actor_pipeline.py:331-391), and its params equal an inline
  unflatten exactly;
- the timer's drained rows land in ``scalars.jsonl`` with role
  ``actor-{i}`` under the tags the JAX package's actor writes."""

import time

import numpy as np
import pytest

from pytorch_distributed_tpu.agents.actor import (
    bounded_actor_run as jax_bounded_actor_run,
)
from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.utils.profiling import StepTimer as JaxTimer
from pytorch_distributed_tpu_torch.agents.actor import bounded_actor_run
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamPrefetcher, ParamStore, make_flattener,
)
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.factory import init_params, probe_env
from pytorch_distributed_tpu_torch.utils.experience import REPLAY_FIELDS
from pytorch_distributed_tpu_torch.utils.metrics import (
    read_scalars, timer_phases,
)
from pytorch_distributed_tpu_torch.utils.profiling import StepTimer

SUFFIXES = ("ms", "max_ms", "calls", "total_ms", "last_wall")


def _opt(tmp_path, backend, **kw):
    kw.setdefault("actor_freq", 10 ** 9)  # no mid-run drain of the timer
    return build_options(12, device="cpu", num_actors=2,
                         num_envs_per_actor=2, root_dir=str(tmp_path),
                         refs=f"t_{backend}", actor_backend=backend,
                         early_stop=25, **kw)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_pipelined_stream_equals_inline(tmp_path, native):
    """Actor 1 of 2, 2 envs, 60 ticks; early_stop 25 puts episode ends
    and auto-resets inside the window."""
    runs = {b: bounded_actor_run(_opt(tmp_path, b, native_env=native), 60,
                                 process_ind=1)
            for b in ("inline", "pipelined")}
    a, b = runs["inline"]["stream"], runs["pipelined"]["stream"]
    assert len(a) == len(b) > 60
    assert any(float(t.terminal1) == 0.0 and float(t.gamma_n) > 0.99 ** 5
               for t in a), "no truncated tail in the window"
    for t1, t2 in zip(a, b):
        for f in REPLAY_FIELDS:
            x, y = np.asarray(getattr(t1, f)), np.asarray(getattr(t2, f))
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    # the schedules book their own phases (reference _drive_actor_loop)
    ti, tp = runs["inline"]["timer_ms"], runs["pipelined"]["timer_ms"]
    for phase in ("act", "env", "advance"):
        assert ti[f"actor/time_{phase}_calls"] == 60.0
    assert "actor/time_sync_ms" not in ti
    assert tp["actor/time_sync_calls"] == 60.0
    assert tp["actor/time_dispatch_calls"] == 61.0  # the first, ahead
    assert runs["inline"]["env_steps"] == runs["pipelined"]["env_steps"] \
        == 120


def _rows(stream):
    return [tuple(np.asarray(getattr(t, f)).tobytes() for f in REPLAY_FIELDS)
            for t in stream]


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_streams_stay_equal_across_a_weight_swap(tmp_path, native):
    """A second snapshot published at tick 20 is swapped in at the sync
    point (env step 100, tick 50) by both schedules: the streams stay
    identical, and they differ from a run that kept the first weights."""
    opt = lambda b: _opt(tmp_path, b, native_env=native)
    runs = {b: bounded_actor_run(opt(b), 60, process_ind=1, publish_at=20)
            for b in ("inline", "pipelined")}
    for r in runs.values():
        assert r["version"] == 2
        assert r["timer_ms"]["actor/time_param_swap_calls"] == 1.0
    swapped = _rows(runs["inline"]["stream"])
    assert swapped == _rows(runs["pipelined"]["stream"])
    kept = _rows(bounded_actor_run(opt("inline"), 60,
                                   process_ind=1)["stream"])
    n = min(len(kept), len(swapped))
    assert kept[:40] == swapped[:40]  # the first weights up to tick 50
    assert kept[:n] != swapped[:n]


def _wait_take(pf, seconds=5.0):
    deadline = time.monotonic() + seconds
    got = None
    while got is None and time.monotonic() < deadline:
        got = pf.take()
        time.sleep(0.01)
    return got


def test_param_prefetcher_basic():
    store = ParamStore(4)
    v1 = store.publish(np.arange(4, dtype=np.float32))
    pf = ParamPrefetcher(store, lambda f: f * 2.0, start_version=v1,
                         poll_secs=0.01)
    try:
        assert pf.take() is None  # nothing newer than v1
        v2 = store.publish(np.ones(4, dtype=np.float32))
        got = _wait_take(pf)
        assert got is not None
        tree, version = got
        assert version == v2
        np.testing.assert_array_equal(tree, np.full(4, 2.0, np.float32))
        assert pf.take() is None  # consumed
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_param_prefetcher_delivers_the_newest_unflatten():
    """A failing refresh is counted and retried, not fatal; the newest
    publish then reaches ``take()`` equal to an inline unflatten of it."""
    opt = build_options(12, device="cpu")
    spec = probe_env(opt)
    flats = [make_flattener(init_params(opt, spec, seed=s),
                            spec.state_shape)[0] for s in (1, 2)]
    _flat0, unflatten = make_flattener(init_params(opt, spec, seed=0),
                                       spec.state_shape)
    store = ParamStore(flats[0].size)
    calls = []

    def flaky(flat):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("first refresh fails")
        return unflatten(flat)

    store.publish(flats[0])
    pf = ParamPrefetcher(store, flaky, poll_secs=0.01, refresh_secs=0.01)
    try:
        deadline = time.monotonic() + 5.0
        while pf.failures == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pf.failures == 1
        store.publish(flats[1])
        deadline = time.monotonic() + 5.0
        got = None
        while time.monotonic() < deadline:
            got = pf.take() or got
            if got is not None and got[1] == 2:
                break
            time.sleep(0.01)
        tree, version = got
        assert version == 2
        expect = unflatten(flats[1])
        assert tree.keys() == expect.keys()
        for k in expect:
            assert tree[k].dtype == expect[k].dtype
            assert np.array_equal(tree[k].numpy(), expect[k].numpy()), k
    finally:
        pf.close()


def test_step_timer_drains_like_the_reference():
    ours, theirs = StepTimer("actor"), JaxTimer("actor")
    for name, secs in (("env", 0.002), ("act", 0.004), ("env", 0.001),
                       ("act", 0.010), ("advance", 0.0005)):
        ours.add(name, secs)
        theirs.add(name, secs)
    with ours.phase("sync"):
        pass
    with theirs.phase("sync"):
        pass
    a, b = ours.drain(), theirs.drain()
    assert a.keys() == b.keys()
    for k in a:
        if not k.endswith("_last_wall") and "sync" not in k:
            assert a[k] == b[k], k
    assert a["actor/time_act_max_ms"] == 10.0
    assert a["actor/time_env_calls"] == 2.0
    assert ours.drain() == {}


def test_timer_rows_land_under_the_references_tags(tmp_path):
    """A pipelined run that drains its timer every 4 env steps writes rows
    with role actor-0 under the tags of the JAX package's pipelined actor,
    run on its own smoke row (config 1) with the same cadence."""
    opt = _opt(tmp_path, "pipelined", actor_freq=4)
    bounded_actor_run(opt, 12)
    rows = [r for r in read_scalars(opt.log_dir)
            if r["tag"].startswith("actor/time_")]
    assert rows and {r["role"] for r in rows} == {"actor-0"}
    assert {r["run_id"] for r in rows} == {opt.refs}
    ours = {r["tag"] for r in rows}
    assert ours == {f"actor/time_{p}_{s}" for p in (
        "dispatch", "sync", "act", "env", "advance") for s in SUFFIXES}
    # summed over the windows: every tick's env step, and a tick's time
    # as its sync, dispatch, env and advance
    phases = timer_phases(opt.log_dir)
    assert phases["ticks"] == 12.0
    total = lambda p: sum(r["value"] for r in rows
                          if r["tag"] == f"actor/time_{p}_total_ms")
    assert phases["tick"] == pytest.approx(sum(total(p) for p in (
        "sync", "dispatch", "env", "advance")) / 12, rel=1e-12)
    jopt = jax_options(1, root_dir=str(tmp_path / "jax"), refs="t_jax",
                       actor_backend="pipelined", visualize=False,
                       num_actors=2, num_envs_per_actor=2, actor_freq=4)
    jax_bounded_actor_run(jopt, 12)
    theirs = {r["tag"] for r in read_scalars(jopt.log_dir)
              if r["tag"].startswith("actor/time_")}
    assert ours == theirs
