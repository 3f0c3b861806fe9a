"""The port's health plane against the JAX package's, on the CPU:

- parity, the same numpy inputs on both sides: ``AnomalyDetector`` (labels
  and streak at every window, exact), the host X-ray, ``ChunkValidator``
  (the accept/reject split and the reasons, exact), ``QuarantineStore``
  (the ``.npz`` files' arrays, exact but for the wall clock),
  ``poison_items``, ``priority_xray_device`` (counts, rows exact; ESS and
  mass within 1e-5 relative, the two sum the float32 leaves in different
  orders), ``FaultInjector`` (parsing and firing, action by action), the
  ``TPU_APEX_HEALTH_<FIELD>`` overrides, and the rollback machinery of the
  checkpoint epochs (``resolve_epoch(before=)``, fencing, ``fsck``, GC);
- the ingest's quarantine boundary (memory/device_replay.py) and the
  ``FEEDER_FAULTS`` plane;
- drills of config 12 at a small ring and batch (thread backend;
  ``compute_dtype`` float32, whose CPU kernels are about twice as fast
  as bfloat16's): ``poison_chunk`` with the quarantine off trips the
  streak and rolls the learner back exactly once to an epoch older than
  the poison; with ``max_rollbacks=0`` it raises; with the quarantine on
  the poison lands in ``quarantine/`` and never in the ring; an
  ``ACTOR_FAULTS`` hang under the watchdog (process backend) is killed,
  respawned and left in the blackbox;
- ``--model-file`` in mode 1: the learner and the Anakin loop start
  from the file's params.

The drills pace the learner (``max_replay_ratio``) well below its CPU
rate, so its step follows the actor's frames and a scheduled flush lands
between two known epochs.
"""

import json
import math
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.config import HealthParams as JaxHealthParams
from pytorch_distributed_tpu.memory.device_per import (
    priority_xray_device as jax_xray_device,
)
from pytorch_distributed_tpu.utils import checkpoint as jax_ckpt
from pytorch_distributed_tpu.utils import faults as jax_faults
from pytorch_distributed_tpu.utils import flight_recorder as jax_fr
from pytorch_distributed_tpu.utils import health as jax_health
from pytorch_distributed_tpu.utils.experience import (
    Transition as JaxTransition,
)
from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch import runtime
from pytorch_distributed_tpu_torch.agents.anakin import AnakinDriver
from pytorch_distributed_tpu_torch.agents.clocks import (
    ActorStats, GlobalClock, LearnerStats,
)
from pytorch_distributed_tpu_torch.agents.learner import (
    initial_params, run_learner,
)
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, make_flattener, num_params,
)
from pytorch_distributed_tpu_torch.config import HealthParams, build_options
from pytorch_distributed_tpu_torch.factory import (
    build_memory, build_model, init_params, probe_env,
)
from pytorch_distributed_tpu_torch.memory.device_per import (
    PerReplayState, priority_xray_device,
)
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DeviceReplayIngest,
)
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils import faults, flight_recorder
from pytorch_distributed_tpu_torch.utils import health
from pytorch_distributed_tpu_torch.utils.experience import Transition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = ("FEEDER_FAULTS", "LEARNER_FAULTS", "ACTOR_FAULTS", "CKPT_FAULTS",
        "TPU_APEX_QUARANTINE", "TPU_APEX_BLACKBOX_DIR", "TPU_APEX_RUN_ID")


@pytest.fixture(autouse=True)
def _isolate():
    """Empty registries on both sides and no fault plane, quarantine
    switch or blackbox dir from the environment, before and after each
    test (a topology exports the blackbox dir)."""
    saved = {v: os.environ.pop(v, None) for v in _ENV}
    for mod in (jax_health, jax_fr, health, flight_recorder):
        mod.reset()
    yield
    for mod in (jax_health, jax_fr, health, flight_recorder):
        mod.reset()
    for var, val in saved.items():
        os.environ.pop(var, None)
        if val is not None:
            os.environ[var] = val


# ---------------------------------------------------------------------------
# the anomaly detector and the X-rays
# ---------------------------------------------------------------------------

def _window_stream(seed: int):
    """One observe() keyword dict a window: a noisy steady loss, then a
    NaN, a loss spike, a grad spike, a TD spike, a mass collapse, an ESS
    collapse and guard skips, each after healthy windows."""
    rng = np.random.default_rng(seed)
    out = []
    for w in range(70):
        kw = dict(loss=float(1.0 + 0.05 * rng.normal()),
                  grad_norm=float(0.5 + 0.02 * rng.normal()),
                  td_mean=float(0.3 + 0.01 * rng.normal()),
                  priority_mass=float(100.0 + rng.normal()),
                  replay_rows=1000, skipped=0.0,
                  priority_ess=float(0.5 + 0.01 * rng.normal()))
        if w == 12:
            kw["loss"] = float("nan")
        elif w in (20, 21, 22):
            kw["loss"] = 400.0
        elif w in (30, 31):
            kw["grad_norm"] = 900.0
        elif w == 38:
            kw["td_mean"] = float("inf")
        elif w in (40, 41):
            kw["td_mean"] = 80.0
        elif w == 48:
            kw["priority_mass"] = 0.0
        elif w in (52, 53, 54):
            kw["priority_ess"] = 0.001
        elif w in (60, 61, 62, 63):
            kw["skipped"] = float(w - 59)
        elif w == 66:
            kw.update(priority_mass=0.0, replay_rows=0)  # empty: no label
        out.append(kw)
    return out


@pytest.mark.parametrize("seed,zmax,spike,threshold,floor", [
    (0, 8.0, 100.0, 3, 0.02), (1, 6.0, 10.0, 2, 0.05), (2, 3.0, 5.0, 1, 0.3)])
def test_detector_labels_and_streak_match_the_reference(seed, zmax, spike,
                                                        threshold, floor):
    kw = dict(zmax=zmax, grad_spike=spike, threshold=threshold,
              ess_floor=floor)
    ours, theirs = health.AnomalyDetector(**kw), \
        jax_health.AnomalyDetector(**kw)
    labels = set()
    for w, obs in enumerate(_window_stream(seed)):
        got, want = ours.observe(**obs), theirs.observe(**obs)
        assert got == want, (w, got, want)
        assert ours.streak == theirs.streak, w
        assert ours.should_rollback() == theirs.should_rollback(), w
        labels.update(got)
        if w == 45:  # a rollback: both start over
            ours.reset()
            theirs.reset()
    assert ours.anomalies_total == theirs.anomalies_total
    assert (ours.loss.mean, ours.grad.var) == (theirs.loss.mean,
                                               theirs.grad.var)
    if seed == 0:
        assert labels == {"nonfinite", "loss_spike", "grad_spike",
                          "td_explosion", "priority_collapse", "skipped"}


def _priorities(seed: int, n: int = 5000) -> np.ndarray:
    """p ** alpha leaves: log-uniform over the grid and past both of its
    edges, a quarter of the rows empty, and the edges themselves."""
    rng = np.random.default_rng(seed)
    p = (10.0 ** rng.uniform(-8.0, 5.0, n)).astype(np.float32)
    p[rng.random(n) < 0.25] = 0.0
    p[:6] = [1e-6, 1e3, 1e-7, 2e4, 1e-6, 0.0]
    return p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_xray_matches_the_reference(seed):
    p = _priorities(seed)
    got, want = health.priority_xray(p), jax_health.priority_xray(p)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert health.priority_xray(np.zeros(8)) is None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_xray_matches_the_reference(seed):
    import jax.numpy as jnp

    p = _priorities(seed)
    counts, ess, rows, mass = priority_xray_device(
        SimpleNamespace(priority=torch.from_numpy(p)))
    jc, je, jr, jm = jax_xray_device(SimpleNamespace(
        priority=jnp.asarray(p)))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    assert counts.dtype == torch.int32 and int(rows) == int(jr)
    # the sums run over float32 leaves in another order on each side
    np.testing.assert_allclose(float(ess), float(je), rtol=1e-5)
    np.testing.assert_allclose(float(mass), float(jm), rtol=1e-5)
    host = health.priority_xray(p)
    np.testing.assert_array_equal(counts.numpy(), host["counts"])
    assert int(rows) == host["rows"]


def test_device_xray_of_an_empty_ring_and_of_exact_sums():
    import jax.numpy as jnp

    empty = priority_xray_device(SimpleNamespace(priority=torch.zeros(64)))
    assert [float(x) for x in empty[1:]] == [0.0, 0.0, 0.0]
    assert int(empty[0].sum()) == 0
    # dyadic leaves whose sums are exact in float32: equal to the bit
    p = np.array([0.5, 0.25, 0.0, 2.0, 1.0, 0.0, 4.0, 0.125], np.float32)
    got = [np.asarray(x) for x in priority_xray_device(
        SimpleNamespace(priority=torch.from_numpy(p)))]
    want = [np.asarray(x) for x in jax_xray_device(
        SimpleNamespace(priority=jnp.asarray(p)))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_resolve_overrides_match_the_reference(monkeypatch):
    env = {"TPU_APEX_HEALTH_ANOMALY_ZMAX": "5.5",
           "TPU_APEX_HEALTH_MAX_ROLLBACKS": "4.0",
           "TPU_APEX_HEALTH_ROLLBACK": "off",
           "TPU_APEX_HEALTH_QUARANTINE": "yes",
           "TPU_APEX_HEALTH_HANG_DEADLINE": "7"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = health.resolve(HealthParams()), \
        jax_health.resolve(JaxHealthParams())
    for name in ("anomaly_zmax", "grad_spike", "anomaly_threshold",
                 "ess_floor", "rollback", "max_rollbacks", "quarantine",
                 "quarantine_max_files", "numeric_guards", "hang_deadline",
                 "hang_grace"):
        assert getattr(ours, name) == getattr(theirs, name), name
        assert type(getattr(ours, name)) is type(getattr(theirs, name))
    assert (ours.anomaly_zmax, ours.max_rollbacks, ours.rollback) == (
        5.5, 4, False)
    for raw, want in (("0", False), ("off", False), ("1", True),
                      ("", False)):
        monkeypatch.setenv("TPU_APEX_QUARANTINE", raw)
        assert health.quarantine_active() is want \
            is jax_health.quarantine_active()
    monkeypatch.delenv("TPU_APEX_QUARANTINE")
    assert health.quarantine_active() and jax_health.quarantine_active()


def test_set_reaches_every_health_field():
    vals = dict(anomaly_zmax=4.0, grad_spike=20.0, anomaly_threshold=5,
                ess_floor=0.1, rollback=False, max_rollbacks=7,
                quarantine=False, quarantine_max_files=3)
    hp = build_options(12, **vals).health_params
    assert {k: getattr(hp, k) for k in vals} == vals
    opt = port_main.options_from_args(port_main.parse_args(
        [a for k, v in vals.items()
         for a in ("--set", f"{k}={str(v).lower()}")]))
    assert {k: getattr(opt.health_params, k) for k in vals} == vals


# ---------------------------------------------------------------------------
# ingest validation and quarantine
# ---------------------------------------------------------------------------

def _rows(cls, shape=(4,), dtype=np.float32):
    """(name, (Transition, priority)) rows of ``cls``: clean and each
    fault the validator knows, on the same numpy values."""
    def t(reward=0.5, state=None, action=0, gamma=0.99, term=0.0,
          shape=shape, dtype=dtype):
        s = (np.arange(np.prod(shape)).reshape(shape) % 7).astype(dtype) \
            if state is None else np.asarray(state, dtype)
        return cls(state0=s, action=np.int32(action),
                   reward=np.float32(reward), gamma_n=np.float32(gamma),
                   state1=s.copy(), terminal1=np.float32(term))

    nan_state = np.zeros(shape, dtype)
    if dtype == np.float32:
        nan_state.flat[1] = np.nan
    return [
        ("clean", (t(), None)),
        ("clean_prio", (t(1.0), 2.0)),
        ("nan_reward", (t(np.nan), None)),
        ("inf_gamma", (t(gamma=np.inf), 1.0)),
        ("nan_terminal", (t(term=np.nan), None)),
        ("nan_prio", (t(), float("nan"))),
        ("neg_prio", (t(), -1.0)),
        ("str_prio", (t(), "x")),
        ("nan_state", (t(state=nan_state), None)),
        ("shape", (t(shape=(5,) + shape[1:]), None)),
        ("dtype", (t(dtype=np.float64 if dtype == np.float32
                     else np.int16), 0.5)),
        ("action", (t(action=7), None)),
        ("neg_action", (t(action=-1), 3.0)),
        ("clean_last", (t(0.25), 0.0)),
    ]


@pytest.mark.parametrize("shape,dtype,num_actions,schema", [
    ((4,), np.float32, 6, True), ((4,), np.float32, None, False),
    ((2, 3, 3), np.uint8, 6, True), ((2, 3, 3), np.uint8, None, False)])
def test_validator_split_and_reasons_match_the_reference(shape, dtype,
                                                         num_actions,
                                                         schema):
    kw = dict(num_actions=num_actions)
    if schema:
        kw.update(state_shape=shape, state_dtype=dtype)
    ours, theirs = health.ChunkValidator(**kw), \
        jax_health.ChunkValidator(**kw)
    mine = [it for _n, it in _rows(Transition, shape, dtype)]
    ref = [it for _n, it in _rows(JaxTransition, shape, dtype)]
    good, bad = ours.filter(mine)
    jgood, jbad = theirs.filter(ref)
    assert [r for _t, _p, r in bad] == [r for _t, _p, r in jbad]
    assert [p for _t, p in good] == [p for _t, p in jgood]
    assert [float(t.reward) for t, _p in good] == \
        [float(t.reward) for t, _p in jgood]
    assert (ours.checked, ours.rejected) == (theirs.checked,
                                             theirs.rejected)
    assert len(good) >= 3 and len(bad) >= 8
    # a clean chunk passes as the same object
    clean = mine[:2]
    assert ours.filter(clean)[0] is clean


def test_validator_latches_the_first_schema():
    for mod, cls in ((health, Transition), (jax_health, JaxTransition)):
        v = mod.ChunkValidator()
        rows = dict(_rows(cls))
        assert not v.filter([rows["clean"]])[1]
        _good, bad = v.filter([rows["shape"], rows["clean"]])
        assert len(bad) == 1 and "shape" in bad[0][2]


def _rejected(cls):
    """The rows the validator rejects, but the one with a string priority,
    which the reference's ``put`` cannot write (its float column); the
    port's queue carries no priorities at all."""
    v = (health if cls is Transition else jax_health).ChunkValidator(
        state_shape=(4,), state_dtype=np.float32, num_actions=6)
    return v.filter([it for n, it in _rows(cls) if n != "str_prio"])[1]


@pytest.mark.parametrize("drifted", [False, True])
def test_quarantine_files_hold_the_references_arrays(tmp_path, drifted):
    got = {}
    for name, mod, fr, cls in (("jax", jax_health, jax_fr, JaxTransition),
                               ("port", health, flight_recorder,
                                Transition)):
        fr.configure(str(tmp_path / name), run_id="run-q")
        bad = _rejected(cls)
        if not drifted:
            bad = [b for b in bad if "shape" not in b[2]]
        path = mod.get_quarantine("feeder-device").put(bad, trace_id=0)
        assert path == str(tmp_path / name / "quarantine"
                           / "feeder-device-00000.npz")
        with np.load(path) as z:
            got[name] = {k: z[k] for k in z.files}
        assert mod.quarantine_counts() == {"feeder-device": len(bad)}
    assert got["port"].keys() == got["jax"].keys()
    for k in got["jax"]:
        if k == "wall":
            continue
        np.testing.assert_array_equal(got["port"][k], got["jax"][k],
                                      err_msg=k)
        assert got["port"][k].dtype == got["jax"][k].dtype, k
    assert got["port"]["state0"].dtype.kind == ("U" if drifted else "f")


def test_quarantine_budget_bounds_files_not_counting(tmp_path):
    flight_recorder.configure(str(tmp_path))
    st = health.QuarantineStore("bounded", max_files=2)
    bad = _rejected(Transition)[:1]
    paths = [st.put(bad) for _ in range(5)]
    assert paths[2:] == [None] * 3 and all(paths[:2])
    assert (st.files, st.count) == (2, 5)
    assert st.put([]) is None
    flight_recorder.reset()
    assert health.QuarantineStore("nodir").put(bad) is None


def test_poison_items_poison_the_same_fields():
    for dtype in (np.float32, np.uint8):
        mine = [it for _n, it in _rows(Transition, dtype=dtype)[:2]]
        ref = [it for _n, it in _rows(JaxTransition, dtype=dtype)[:2]]
        got, want = health.poison_items(mine), jax_health.poison_items(ref)
        assert len(got) == len(want) == 2
        for (t, p), (jt, jp) in zip(got, want):
            assert math.isnan(p) and math.isnan(jp)
            for f in ("state0", "action", "reward", "gamma_n", "state1",
                      "terminal1"):
                np.testing.assert_array_equal(getattr(t, f),
                                              getattr(jt, f), err_msg=f)
                assert np.asarray(getattr(t, f)).dtype == \
                    np.asarray(getattr(jt, f)).dtype
            assert np.isnan(t.reward)
            assert np.isnan(t.state0).all() == (dtype == np.float32)
        # the input rows are left as they were
        assert float(mine[0][0].reward) == 0.5


def _ingest(**kw):
    ing = DeviceReplayIngest(capacity=64, state_shape=(4,),
                             state_dtype=np.float32, in_process=True, **kw)
    ing.attach("cpu")
    return ing


def _feed(ing, rewards, chunk=2, shapes=None):
    f = ing.make_feeder(chunk=chunk)
    for i, r in enumerate(rewards):
        shape = (shapes or {}).get(i, (4,))
        s = np.full(shape, 0.5, np.float32)
        f.feed(Transition(s, np.int32(1), np.float32(r), np.float32(0.99),
                          s, np.float32(0.0)))
    f.flush()


def test_drain_quarantines_nan_and_drift_but_feeds_the_rest(tmp_path):
    flight_recorder.configure(str(tmp_path))
    ing = _ingest()
    _feed(ing, [0.1, np.nan, 0.2, 0.3, 0.4], shapes={2: (7,)})
    assert ing.drain() == 3
    snap = ing.snapshot()
    np.testing.assert_array_equal(snap["reward"],
                                  np.float32([0.1, 0.3, 0.4]))
    assert (ing.validated, ing.quarantined) == (5, 2)
    assert ing.validate_s > 0
    assert health.quarantine_counts() == {"feeder-device": 2}
    files = os.listdir(tmp_path / "quarantine")
    assert files == ["feeder-device-00000.npz"]
    with np.load(tmp_path / "quarantine" / files[0]) as z:
        assert [str(r) for r in z["reason"]] == [
            "non-finite reward", "state0 shape (7,) != expected (4,)"]


@pytest.mark.parametrize("switch", ["env", "param"])
def test_the_quarantine_switches_off(monkeypatch, switch):
    if switch == "env":
        monkeypatch.setenv("TPU_APEX_QUARANTINE", "0")
    ing = _ingest(quarantine=switch != "param")
    _feed(ing, [0.1, np.nan])
    assert ing.drain() == 2
    assert np.isnan(ing.snapshot()["reward"][1])
    assert (ing.validated, ing.quarantined) == (0, 0)
    assert health.quarantine_counts() == {}


def test_feeder_poison_chunk_is_quarantined(monkeypatch):
    monkeypatch.setenv("FEEDER_FAULTS", "poison_chunk@1")
    ing = _ingest()
    _feed(ing, [0.1, 0.2, 0.3, 0.4, 0.5, 0.6])  # flush 1 is rows 2 and 3
    assert ing.drain() == 4
    np.testing.assert_array_equal(ing.snapshot()["reward"],
                                  np.float32([0.1, 0.2, 0.5, 0.6]))
    assert health.quarantine_counts() == {"feeder-device": 2}
    rec = flight_recorder.get_recorder("faults-feeder").snapshot()
    assert [(e["action"], e["frame"]) for e in rec] == [("poison_chunk", 1)]


def test_the_feeder_injector_never_rides_a_pickle(monkeypatch):
    monkeypatch.setenv("FEEDER_FAULTS", "poison_chunk@5")
    f = _ingest().make_feeder(chunk=1)
    s = np.zeros(4, np.float32)
    f.feed(Transition(s, np.int32(0), np.float32(0.0), np.float32(0.9), s,
                      np.float32(0.0)))
    assert f._faults is not None and f._faults.frames_seen == 1
    # a spawn child builds its own injector from the inherited schedule
    assert f.__getstate__()["_faults"] is None


# ---------------------------------------------------------------------------
# the fault injector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "", "kill@5", "delay@3:0.5,crash@9", "poison_chunk@1,poison_chunk@2",
    " hang@4:1.5 , poison_grad@0 ", "delay@7:0.25,delay@7:0.5"])
def test_parse_matches_the_reference(spec):
    assert faults.parse_faults(spec) == jax_faults.parse_faults(spec)


@pytest.mark.parametrize("spec", ["kill", "kill@x", "nope@3", "crash@1:y"])
def test_parse_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError):
        jax_faults.parse_faults(spec)
    with pytest.raises(ValueError):
        faults.parse_faults(spec)


@pytest.mark.parametrize("spec", ["sever@1", "corrupt@2", "blackhole@3:1"])
def test_the_wire_verbs_are_not_ported(spec, monkeypatch):
    assert jax_faults.parse_faults(spec)
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.parse_faults(spec)
    monkeypatch.setenv("FEEDER_FAULTS", "random:3")
    with pytest.raises(ValueError, match="random"):
        faults.FaultInjector.from_env("feeder")


def _fire(mod, spec, frames, want):
    """Step an injector of ``mod``: per frame, what data_frame returned or
    the name of what it raised, and how long it took."""
    inj = mod.FaultInjector(mod.parse_faults(spec), name="drill")
    out = []
    for _ in range(frames):
        t0 = time.monotonic()
        try:
            got = inj.data_frame(want)
        except mod.InjectedCrash as e:
            got = ("crash", str(e))
        out.append((got, time.monotonic() - t0))
    return inj, out


@pytest.mark.parametrize("spec,want", [
    ("poison_chunk@2,poison_chunk@4", ("poison_chunk",)),
    ("poison_chunk@2,poison_grad@3", ("poison_grad",)),
    ("poison_grad@1", ()),
    ("crash@3", ()),
    ("delay@1:0.3,delay@1:0.2,poison_grad@1", ("poison_grad",)),
    ("hang@2:0.4", ()),
])
def test_firing_matches_the_reference(spec, want):
    ours, got = _fire(faults, spec, 6, want)
    theirs, ref = _fire(jax_faults, spec, 6, want)
    assert [g for g, _dt in got] == [g for g, _dt in ref]
    assert (ours.injected, ours.frames_seen) == (theirs.injected,
                                                 theirs.frames_seen)
    # delays and bounded hangs sleep at least their scheduled seconds at
    # their frame on both sides, and nothing else sleeps
    sleep = [0.0] * 6
    for at, action, arg in faults.parse_faults(spec):
        if action in ("delay", "hang") and action not in want:
            sleep[at] += arg
    for (_g, dt), (_r, jdt), s in zip(got, ref, sleep):
        assert s <= dt < s + 2.0 and s <= jdt < s + 2.0
    assert [(e["action"], e["frame"]) for e in flight_recorder.get_recorder(
        "faults-drill").snapshot()] == [
        (e["action"], e["frame"]) for e in jax_fr.get_recorder(
            "faults-drill").snapshot()]


def test_a_fatal_fault_dumps_first(tmp_path):
    flight_recorder.configure(str(tmp_path))
    flight_recorder.get_recorder("actor-0").record("tick", i=1)
    inj = faults.FaultInjector(faults.parse_faults("crash@0"), name="actor")
    with pytest.raises(faults.InjectedCrash):
        inj.frame()
    with open(tmp_path / "blackbox" / "actor-0.jsonl") as f:
        head = json.loads(f.readline())
    assert head["reason"] == "injected crash at frame 0 (faults:actor)"


def test_kill_fires_at_its_frame_on_both_sides(tmp_path):
    code = ("import sys\n"
            "from {pkg}.utils.faults import FaultInjector, parse_faults\n"
            "inj = FaultInjector(parse_faults('kill@3'), name='k')\n"
            "for i in range(10):\n"
            "    print(i, flush=True)\n"
            "    inj.data_frame(())\n")
    outs = []
    for pkg in ("pytorch_distributed_tpu", "pytorch_distributed_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-c", code.format(pkg=pkg)], cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == -signal.SIGKILL
        outs.append(proc.stdout.split())
    assert outs[0] == outs[1] == ["0", "1", "2", "3", "[faults:k]",
                                  "SIGKILL", "at", "frame", "3"]


# ---------------------------------------------------------------------------
# rollback machinery of the checkpoint epochs (reference tests/
# test_health.py:630-715), on both packages' epochs
# ---------------------------------------------------------------------------

CKPT = [pytest.param(ckpt, id="port"), pytest.param(jax_ckpt, id="jax")]


def _save(mod, name, step, extras=None):
    return mod.save_epoch(name, state=None,
                          extras=dict(learner_step=step, **(extras or {})),
                          retain=10)


@pytest.mark.parametrize("mod", CKPT)
def test_resolve_skips_rolled_back_and_respects_before(tmp_path, mod):
    name = str(tmp_path / "run")
    for step in (10, 20, 30):
        _save(mod, name, step)
    info = mod.resolve_epoch(name)
    assert (info.epoch, info.learner_step) == (2, 30)
    mod.mark_rolled_back(info.path, to_epoch=1, reason="drill")
    info = mod.resolve_epoch(name)
    assert (info.epoch, info.learner_step) == (1, 20)
    assert mod.resolve_epoch(name, before=1).epoch == 0
    assert mod.resolve_epoch(name, before=5).epoch == 1
    assert mod.resolve_epoch(name, before=0) is None


@pytest.mark.parametrize("mod", CKPT)
def test_fence_then_fsck_reports_a_rolled_back_root_clean(tmp_path, mod):
    name = str(tmp_path / "run")
    for step in (10, 20, 30):
        _save(mod, name, step)
    root = mod.ckpt_root(name)
    assert mod.fence_epochs_after(name, 0, reason="drill") == [2, 1]
    assert mod.fence_epochs_after(name, 0) == []  # idempotent
    # the run goes on from epoch 0 and saves a regressed step: legal,
    # since the overtaken epochs are fenced
    _save(mod, name, 15, extras={"rollbacks": 1})
    rep = mod.fsck(root)
    assert rep["violations"] == []
    assert (rep["rolled_back"], rep["newest_complete"]) == (2, 3)
    assert [e["status"] for e in rep["epochs"]] == [
        "complete", "rolled-back", "rolled-back", "complete"]
    with open(os.path.join(root, "epoch_1", "ROLLED_BACK.json")) as f:
        marker = json.load(f)
    assert (marker["rolled_back_to"], marker["reason"]) == (0, "drill")


@pytest.mark.parametrize("mod", CKPT)
def test_fsck_flags_an_unmarked_step_regression(tmp_path, mod):
    name = str(tmp_path / "run")
    _save(mod, name, 30)
    _save(mod, name, 10)
    assert any("regressed" in v
               for v in mod.fsck(mod.ckpt_root(name))["violations"])


@pytest.mark.parametrize("mod", CKPT)
def test_gc_never_lets_fenced_epochs_crowd_out_good(tmp_path, mod):
    name = str(tmp_path / "run")
    for step in (10, 20, 30):
        _save(mod, name, step)
    root = mod.ckpt_root(name)
    for k in (1, 2):
        mod.mark_rolled_back(os.path.join(root, f"epoch_{k}"))
    mod.gc_epochs(root, retain=1)
    assert mod.resolve_epoch(name).epoch == 0


def test_ckpt_fsck_cli_exits_clean_on_a_rolled_back_root(tmp_path):
    name = str(tmp_path / "run")
    for step in (10, 20):
        _save(ckpt, name, step)
    root = ckpt.ckpt_root(name)
    ckpt.mark_rolled_back(os.path.join(root, "epoch_1"), to_epoch=0)
    _save(ckpt, name, 12, extras={"rollbacks": 1})
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.ckpt_fsck",
         root], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# drills of config 12 on the CPU
# ---------------------------------------------------------------------------

# the poisoned flushes: one actor of one env flushes every 16 frames, and
# max_replay_ratio 0.125 at batch 8 holds the learner at one step per 64
# frames, so flush 160 comes near step 40: after the epoch of step 30,
# and the streak trips well before the epoch of step 60
POISON = ",".join(f"poison_chunk@{n}" for n in range(160, 164))


def _drill_opts(tmp_path, refs, **kw):
    base = dict(root_dir=str(tmp_path), refs=refs, device="cpu",
                num_actors=1, num_envs_per_actor=1, memory_size=512,
                batch_size=8, learn_start=64, compute_dtype="float32",
                max_replay_ratio=0.125, learner_freq=2,
                anomaly_threshold=2, checkpoint_freq=30, steps=90,
                checkpoint_replay=True, checkpoint_retain=10,
                evaluator_nepisodes=0, early_stop=200)
    base.update(kw)
    return build_options(12, **base)


def _blackbox(opt, role):
    with open(os.path.join(opt.log_dir, "blackbox", f"{role}.jsonl")) as f:
        return [json.loads(line) for line in f]


def _epoch_walls(opt):
    out = {}
    root = ckpt.ckpt_root(opt.model_name)
    for name in os.listdir(root):
        with open(os.path.join(root, name, "MANIFEST.json")) as f:
            man = json.load(f)
        out[man["epoch"]] = (man["wall"], man["learner_step"])
    return out


@pytest.mark.timeout(300)
def test_poison_without_quarantine_rolls_back_once(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_APEX_QUARANTINE", "0")
    monkeypatch.setenv("FEEDER_FAULTS", POISON)
    opt = _drill_opts(tmp_path, "rb")
    topo = runtime.Topology(opt, backend="thread")
    summary = topo.run()
    assert topo.clock.rollbacks.value == summary["health/rollbacks"] == 1
    assert summary["learner/steps"] == 90
    assert summary["learner/updates"] > 90  # the rolled-back tail too
    assert topo.clock.skipped_steps.value >= 2
    assert summary["ingest/quarantined"] == 0
    events = _blackbox(opt, "learner")
    (rb,) = [e for e in events if e["kind"] == "rollback"]
    assert [e["kind"] for e in events[1:]].count("anomaly") >= 2
    # the target epoch was committed before the first poisoned flush
    poisoned = [e["t"] for e in _blackbox(opt, "faults-feeder")
                if e.get("action") == "poison_chunk"]
    assert len(poisoned) == 4
    walls = _epoch_walls(opt)
    assert walls[rb["epoch"]][0] < min(poisoned)
    assert rb["step"] == walls[rb["epoch"]][1] == 30
    rep = ckpt.fsck(ckpt.ckpt_root(opt.model_name))
    assert rep["violations"] == []
    # every epoch committed after the target and before the rollback is
    # fenced; the run's later epochs are not
    for e in rep["epochs"]:
        if e["epoch"] > rb["epoch"] and walls[e["epoch"]][0] < rb["t"]:
            assert e["status"] == "rolled-back"
    final = ckpt.load_epoch_state(ckpt.resolve_epoch(opt.model_name))
    assert final.step == 90
    assert all(torch.isfinite(v).all() for v in final.params.values())
    # the ring was restored from the epoch: no poisoned row is left
    ring = topo.handles.learner_side.replay.state
    assert torch.isfinite(ring.reward).all()
    assert math.isfinite(summary["learner/critic_loss"])
    rows = [r for r in _scalars(opt) if r["tag"] == "health/rollbacks"]
    assert rows and rows[-1]["value"] == 1.0


def _scalars(opt):
    from pytorch_distributed_tpu_torch.utils.metrics import read_scalars

    return read_scalars(opt.log_dir)


@pytest.mark.timeout(300)
def test_poison_with_no_rollback_budget_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_APEX_QUARANTINE", "0")
    monkeypatch.setenv("FEEDER_FAULTS", POISON)
    opt = _drill_opts(tmp_path, "fatal", max_rollbacks=0)
    with pytest.raises(RuntimeError, match="health"):
        runtime.train(opt, backend="thread")
    kinds = [e["kind"] for e in _blackbox(opt, "learner")]
    assert "divergence-fatal" in kinds and "rollback" not in kinds


@pytest.mark.timeout(300)
def test_poison_with_quarantine_never_reaches_the_ring(tmp_path,
                                                       monkeypatch, capsys):
    monkeypatch.setenv("FEEDER_FAULTS", POISON)
    monkeypatch.setenv("LEARNER_FAULTS", "poison_grad@5")
    opt = _drill_opts(tmp_path, "q", steps=60, checkpoint_replay=False)
    topo = runtime.Topology(opt, backend="thread")
    summary = topo.run()
    assert summary["health/rollbacks"] == 0
    assert topo.clock.skipped_steps.value == 0
    assert summary["ingest/quarantined"] == 64
    assert summary["ingest/validated"] >= summary["replay/size"]
    files = os.listdir(os.path.join(opt.log_dir, "quarantine"))
    assert files and all(f.startswith("feeder-device-") for f in files)
    ring = topo.handles.learner_side.replay.state
    assert torch.isfinite(ring.reward).all()
    assert "poison_grad targets the host-sampled batch" in \
        capsys.readouterr().out
    xr = [r for r in _scalars(opt) if r["tag"] == "replay/priority_ess_frac"]
    assert xr and all(0.0 < r["value"] <= 1.0 for r in xr)


@pytest.mark.timeout(150)
def test_an_actor_hang_is_killed_and_respawned(tmp_path, monkeypatch):
    """Process backend: ``hang@60`` stops the actor at its 60th tick
    without exiting; the watchdog kills it and respawns it once, and the
    run is stopped as soon as the new incarnation ticks (before it
    reaches its own 60th)."""
    monkeypatch.setenv("ACTOR_FAULTS", "hang@60")
    monkeypatch.setenv("TPU_APEX_HEALTH_HANG_DEADLINE", "3")
    opt = port_main.options_from_args(port_main.parse_args([
        "--config", "12", "--backend", "process", "--device", "cpu",
        "--memory-size", "2048", "--batch-size", "8", "--num-actors", "1",
        "--num-envs-per-actor", "2", "--steps", str(10 ** 6),
        "--set", "learn_start=64", "--set", "learner_freq=10",
        "--set", "evaluator_nepisodes=0", "--set", "early_stop=200",
        "--set", "hang_grace=60", "--set", "max_seconds=90",
        "--set", f"root_dir={tmp_path}", "--set", "refs=hang"]))
    topo = runtime.Topology(opt, backend="process")
    import threading

    def drill():
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not (
                topo.hang_kills >= 1 and topo.restarts >= 1
                and topo.progress_board.marks("actor-0") > 0):
            time.sleep(0.05)
        topo.clock.stop.set()

    t = threading.Thread(target=drill, daemon=True)
    t.start()
    summary = topo.run()
    t.join(timeout=10)
    assert summary["runtime/hang_kills"] == 1
    assert summary["runtime/restarts"] == 1
    runtime_events = _blackbox(opt, "runtime")
    assert [e["kind"] for e in runtime_events[1:]] == [
        "worker-hung", "worker-restarted"]
    hung, restarted = runtime_events[1:]
    assert (hung["slot"], restarted["slot"]) == (0, 0)
    assert hung["age"] >= 3 and restarted["restarts"] == 1
    assert "hung" in runtime_events[0]["reason"]
    # the hung child dumped its own rings before it stopped
    child = _blackbox(opt, "faults-actor")
    assert child[0]["reason"] == "injected hang at frame 60 (faults:actor)"


# ---------------------------------------------------------------------------
# --model-file in mode 1
# ---------------------------------------------------------------------------

class FirstPublication(ParamStore):
    """A store that keeps the first vector published to it."""

    first = None

    def publish(self, flat):
        if self.first is None:
            self.first = (np.array(flat, dtype=np.float32), self.version + 1)
        return super().publish(flat)


def _model_file(tmp_path, opt, spec):
    params = init_params(opt, spec, seed=4321)
    path = ckpt.save_params(str(tmp_path / "finetune.pt"), params)
    return path, make_flattener(params, spec.state_shape)[0]


@pytest.mark.parametrize("backend", ["pipelined", "anakin"])
def test_model_file_is_what_mode_1_publishes_first(tmp_path, backend):
    kw = dict(root_dir=str(tmp_path), refs="ft", device="cpu",
              num_actors=1, num_envs_per_actor=4, memory_size=256,
              batch_size=8, learn_start=32, steps=4, early_stop=50,
              compute_dtype="float32", actor_backend=backend)
    opt = build_options(12, **kw)
    spec = probe_env(opt)
    path, want = _model_file(tmp_path, opt, spec)
    # the published path is taken as given, and without its extension
    for model_file in (path, path[:-len(ckpt.EXT)]):
        opt = build_options(12, model_file=model_file,
                            refs=f"ft{len(model_file)}",
                            **{k: v for k, v in kw.items() if k != "refs"})
        handles = build_memory(opt, spec, in_process=True)
        store = FirstPublication(num_params(build_model(
            opt, spec, init_weights=False).state_dict()))
        clock = GlobalClock()
        if backend == "anakin":
            drv = AnakinDriver(opt, spec, handles.learner_side, store, clock,
                               LearnerStats(), actor_stats=ActorStats())
            summary = drv.run()
        else:
            f = handles.actor_side
            rng = np.random.default_rng(0)
            for _ in range(64):
                s = rng.integers(0, 255, spec.state_shape, dtype=np.uint8)
                f.feed(Transition(s, np.int32(1), np.float32(0.5),
                                  np.float32(0.9), s, np.float32(0.0)))
            f.flush()
            summary = run_learner(opt, spec, 0, handles.learner_side, store,
                                  clock, LearnerStats())
        handles.learner_side.close()
        flat, version = store.first
        assert version == 1
        np.testing.assert_array_equal(flat, want)
        assert summary["learner/steps"] >= 4


def test_model_file_of_the_jax_package_or_another_model_is_refused(
        tmp_path):
    opt = build_options(12, device="cpu",
                        model_file=str(tmp_path / "run.msgpack"))
    spec = probe_env(opt)
    with pytest.raises(ValueError, match="convert"):
        initial_params(opt, spec, "cpu")
    bad = {k: v[..., :1] for k, v in init_params(opt, spec, 0).items()}
    path = ckpt.save_params(str(tmp_path / "bad.pt"), bad)
    with pytest.raises(ValueError, match="does not fit"):
        initial_params(build_options(12, device="cpu", model_file=path),
                       spec, "cpu")
    assert initial_params(build_options(12, device="cpu"), spec, "cpu"
                          ).keys() == bad.keys()
