"""Mission control in the port (pytorch_distributed_tpu_torch/utils/
telemetry.py and utils/metrics.ScalarsTail) against the JAX package's on
the CPU: knob resolution, the tail reader's four cases, the rule
language, the time series, the alert engine's transitions and the
OpenMetrics text, each on the same inputs and clock; the HTTP scrape;
``MissionControl`` over a run dir; the runtime's hook in a short run of
row 1; and an actor host's ``MetricsPusher`` against the reference's, on
either package's gateway: the handshake, the offset on an injected clock
2.5 s behind (within 0.5 s, the reference's bound), ``MAX_PENDING``
shedding, brownout shedding and ``ingest_remote`` of a pushed batch."""

import dataclasses
import json
import os
import time
import urllib.request

import pytest

from pytorch_distributed_tpu.config import (
    AlertParams as JaxAlertParams, MetricsParams as JaxMetricsParams,
)
from pytorch_distributed_tpu.utils import flight_recorder as jfr
from pytorch_distributed_tpu.utils import metrics as jmetrics
from pytorch_distributed_tpu.utils import telemetry as jtel
from pytorch_distributed_tpu_torch import runtime
from pytorch_distributed_tpu_torch.config import (
    AlertParams, MetricsParams, build_options,
)
from pytorch_distributed_tpu_torch.utils import flight_recorder as fr
from pytorch_distributed_tpu_torch.utils import metrics, perf, telemetry
from pytorch_distributed_tpu_torch.utils.metrics import MetricsWriter


PLANE_VARS = ("TPU_APEX_PERF", "TPU_APEX_METRICS", "TPU_APEX_ALERT")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No plane knob of an earlier test in the environment, and none this
    test's runs export left for the next; fresh registries."""
    for var in list(os.environ):
        if var.startswith(PLANE_VARS):
            monkeypatch.delenv(var, raising=False)
    for mod in (fr, jfr, perf):
        mod.reset()
    yield
    for var in list(os.environ):  # monkeypatch then restores the originals
        if var.startswith(PLANE_VARS):
            del os.environ[var]
    for mod in (fr, jfr, perf):
        mod.reset()


def test_resolution_matches_the_reference(monkeypatch):
    monkeypatch.setenv("TPU_APEX_METRICS", "1")
    monkeypatch.setenv("TPU_APEX_METRICS_POLL_S", "0.25")
    monkeypatch.setenv("TPU_APEX_METRICS_RAW_POINTS", "64")
    monkeypatch.setenv("TPU_APEX_METRICS_SERIES_TAGS", "a/b,c/d")
    monkeypatch.setenv("TPU_APEX_METRICS_OPENMETRICS", "true")
    monkeypatch.setenv("TPU_APEX_ALERT_RULES", "x: a/b absent 5s")
    monkeypatch.setenv("TPU_APEX_ALERT_RESOLVE_S", "2")
    got = telemetry.resolve_metrics(MetricsParams())
    want = jtel.resolve_metrics(JaxMetricsParams())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.enabled and got.poll_s == 0.25 and got.raw_points == 64
    got = telemetry.resolve_alerts(AlertParams())
    want = jtel.resolve_alerts(JaxAlertParams())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.rules == "x: a/b absent 5s" and got.resolve_s == 2.0


def test_options_take_the_planes_by_group_name():
    opt = build_options(12, device="cpu", **{
        "perf_params.enabled": True, "metrics_params.openmetrics": True,
        "alert_params.rules": "x: a absent 1s", "peak_flops": 5.0})
    assert opt.perf_params.enabled and opt.perf_params.peak_flops == 5.0
    assert opt.metrics_params.openmetrics
    assert opt.alert_params.rules == "x: a absent 1s"
    assert not opt.metrics_params.enabled and opt.flow_params.enabled
    with pytest.raises(ValueError, match="ambiguous option 'enabled'"):
        build_options(12, device="cpu", enabled=True)
    with pytest.raises(ValueError, match="unknown option"):
        build_options(12, device="cpu", **{"perf_params.nope": 1})


# ---------------------------------------------------------------------------
# the tail reader (the reference's four cases, tests/test_perf.py:356-410)
# ---------------------------------------------------------------------------

TAILS = [metrics.ScalarsTail, jmetrics.ScalarsTail]


@pytest.mark.parametrize("tail_cls", TAILS)
def test_tail_reads_remember_their_offset(tail_cls, tmp_path):
    path = tmp_path / "scalars.jsonl"
    tail = tail_cls(str(tmp_path))
    assert tail.poll() == []  # no file yet
    with open(path, "w") as f:
        f.write(json.dumps({"tag": "a", "value": 1.0}) + "\n")
    assert [r["tag"] for r in tail.poll()] == ["a"]
    assert tail.poll() == []
    with open(path, "a") as f:
        f.write(json.dumps({"tag": "b", "value": 2.0}) + "\n")
        f.write(json.dumps({"tag": "c", "value": 3.0}) + "\n")
    assert [r["tag"] for r in tail.poll()] == ["b", "c"]


@pytest.mark.parametrize("tail_cls", TAILS)
def test_tail_leaves_an_unterminated_line(tail_cls, tmp_path):
    path = tmp_path / "scalars.jsonl"
    tail = tail_cls(str(tmp_path))
    with open(path, "w") as f:
        f.write(json.dumps({"tag": "a", "value": 1.0}) + "\n")
        f.write('{"tag": "b", "val')  # mid-append
    assert [r["tag"] for r in tail.poll()] == ["a"]
    with open(path, "a") as f:
        f.write('ue": 2.0}\n')
    assert tail.poll() == [{"tag": "b", "value": 2.0}]


@pytest.mark.parametrize("tail_cls", TAILS)
def test_tail_skips_a_torn_terminated_line(tail_cls, tmp_path):
    with open(tmp_path / "scalars.jsonl", "w") as f:
        f.write('{"tag": "torn", "val\n')
        f.write(json.dumps({"tag": "good", "value": 1.0}) + "\n")
    assert [r["tag"] for r in tail_cls(str(tmp_path)).poll()] == ["good"]


@pytest.mark.parametrize("tail_cls", TAILS)
def test_tail_resets_on_truncation(tail_cls, tmp_path):
    path = tmp_path / "scalars.jsonl"
    tail = tail_cls(str(tmp_path))
    with open(path, "w") as f:
        f.write(json.dumps({"tag": "old", "value": 1.0}) + "\n")
        f.write(json.dumps({"tag": "old2", "value": 2.0}) + "\n")
    assert len(tail.poll()) == 2
    with open(path, "w") as f:  # rotated: a fresh, shorter file
        f.write(json.dumps({"tag": "fresh", "value": 9.0}) + "\n")
    assert [r["tag"] for r in tail.poll()] == ["fresh"]


def test_bounded_tail_reads_match(tmp_path):
    with open(tmp_path / "scalars.jsonl", "w") as f:
        for i in range(40):
            f.write(json.dumps({"tag": f"t{i}", "value": i}) + "\n")
        f.write("x" * 300 + "\n")  # one line wider than the bound
        f.write(json.dumps({"tag": "end", "value": 1}) + "\n")
    got, want = ([], [])
    for tail_cls, out in ((metrics.ScalarsTail, got),
                          (jmetrics.ScalarsTail, want)):
        tail = tail_cls(str(tmp_path), max_bytes=128)
        for _ in range(60):
            out.append([r["tag"] for r in tail.poll()])
    assert got == want
    assert sum(len(p) for p in got) == 41


# ---------------------------------------------------------------------------
# the rule language, the series and the engine
# ---------------------------------------------------------------------------

SPECS = ["stall: learner/updates_per_s absent 120s",
         "learner/mfu < 0.5 for 2m", "burn: data/x >= 2e-2 frac 0.25 over 1h",
         "q: a.b-c/d <= -3.5", "x: y > .5 for 250ms", "z: w absent 30"]
BAD = ["learner/x", "a: b > five", "a: b > 1 frac 1.5 over 3s",
       "a: b absent soon", "a b c"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_rule_matches(spec):
    got, want = telemetry.parse_rule(spec), jtel.parse_rule(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("spec", BAD)
def test_bad_rules_raise_as_the_reference(spec):
    with pytest.raises(ValueError) as got:
        telemetry.parse_rule(spec)
    with pytest.raises(ValueError) as want:
        jtel.parse_rule(spec)
    assert str(got.value) == str(want.value)


def test_rule_sets_match():
    joined = "; ".join(SPECS)
    assert [dataclasses.asdict(r) for r in telemetry.parse_rules(joined)] \
        == [dataclasses.asdict(r) for r in jtel.parse_rules(joined)]
    assert [dataclasses.asdict(r) for r in telemetry.parse_rules(
        telemetry.DEFAULT_RULES)] == [dataclasses.asdict(r) for r in
                                      jtel.parse_rules(jtel.DEFAULT_RULES)]
    with pytest.raises(ValueError, match="duplicate"):
        telemetry.parse_rules("a: x absent 1s; a: y absent 2s")


def _rows(t0: float):
    """Two roles' rows over 20 minutes, out of order now and then."""
    rows = []
    for i in range(400):
        wall = t0 + 3.0 * i + (5.0 if i % 37 == 0 else 0.0)
        rows.append({"tag": "learner/updates_per_s", "value": 600.0 - i,
                     "wall": wall, "role": "learner"})
        rows.append({"tag": "actor/env_frames_per_s", "value": float(i % 7),
                     "wall": wall, "role": f"actor-{i % 2}"})
    rows.append({"tag": "h", "kind": "histogram", "value": 1.0,
                 "wall": t0})
    rows.append({"tag": "bad", "value": "x", "wall": t0})
    return rows


def test_series_match_the_reference():
    t0 = 1_000_000.0
    stores = [telemetry.FleetMetrics(MetricsParams(raw_span_s=120.0,
                                                   raw_points=50)),
              jtel.FleetMetrics(JaxMetricsParams(raw_span_s=120.0,
                                                 raw_points=50))]
    for m in stores:
        assert m.ingest(_rows(t0), offset=1.5) == 800
    got, want = stores
    assert got.tags() == want.tags()
    now = t0 + 1200.0
    for tag in ("learner/updates_per_s", "actor/env_frames_per_s"):
        assert got.latest(tag) == want.latest(tag)
        for seconds in (30.0, 300.0, 1800.0):
            assert got.window(tag, seconds, now=now) == want.window(
                tag, seconds, now=now)
    assert got.series_block(points=8) == want.series_block(points=8)
    capped = [telemetry.FleetMetrics(MetricsParams(max_series=2)),
              jtel.FleetMetrics(JaxMetricsParams(max_series=2))]
    for m in capped:
        m.ingest(_rows(t0)[:10])
    assert capped[0].series_dropped == capped[1].series_dropped > 0


RULES = ("stall: learner/updates_per_s absent 10s; "
         "slow: learner/updates_per_s < 450 for 20s; "
         "burn: actor/env_frames_per_s > 4 frac 0.4 over 60s; "
         "never: replica/members absent 5s")


def _engines(resolve_s: float):
    out = []
    for mod, mp in ((telemetry, MetricsParams), (jtel, JaxMetricsParams)):
        store = mod.FleetMetrics(mp())
        out.append((store, mod.AlertEngine(
            mod.parse_rules(RULES), store, resolve_s=resolve_s,
            clock=lambda: 0.0)))
    return out


@pytest.mark.parametrize("resolve_s", [0.0, 15.0])
def test_alert_engine_transitions_match(resolve_s):
    """The same rows and clock give the same transitions, pass by pass:
    a rate that slows (pending, firing), goes silent (absence fires) and
    comes back (resolved, then ok)."""
    (store, engine), (jstore, jengine) = _engines(resolve_s)
    t0, seen = 1000.0, []
    rows = _rows(t0)
    for k in range(0, 160):
        now = t0 + 3.0 * k
        batch = [r for r in rows
                 if now - 3.0 < r.get("wall", 0) <= now and not (
                     60 <= k < 80 and r["tag"].startswith("learner"))]
        store.ingest(batch)
        jstore.ingest(batch)
        got, want = engine.evaluate(now=now), jengine.evaluate(now=now)
        assert got == want, k
        seen += [(t["rule"], t["state"]) for t in got]
    assert engine.snapshot() == jengine.snapshot()
    assert ("stall", "firing") in seen and ("stall", "resolved") in seen
    assert ("slow", "firing") in seen
    assert not any(rule == "never" for rule, _s in seen)


def test_transitions_reach_the_recorder_and_the_stream(tmp_path):
    store = telemetry.FleetMetrics(MetricsParams())
    writer = MetricsWriter(str(tmp_path), enable_tensorboard=False,
                           role="missionctl")
    rec = fr.get_recorder("missionctl")
    engine = telemetry.AlertEngine(
        telemetry.parse_rules("stall: a/b absent 5s"), store,
        recorder=rec, writer=writer, clock=lambda: 0.0)
    store.ingest([{"tag": "a/b", "value": 1.0, "wall": 10.0}])
    assert engine.evaluate(now=12.0) == []
    states = [t["state"] for t in engine.evaluate(now=16.0)]
    assert states == ["pending", "firing"]
    assert engine.firing() == ["stall"]
    writer.close()
    rows = metrics.read_scalars(str(tmp_path))
    assert [(r["tag"], r["value"]) for r in rows] == [
        ("alert/stall", 1.0), ("alert/stall", 2.0)]
    assert [e["state"] for e in rec.snapshot() if e["kind"] == "alert"] \
        == ["pending", "firing"]


def test_openmetrics_text_is_byte_equal():
    (store, engine), (jstore, jengine) = _engines(0.0)
    t0 = 1000.0
    rows = _rows(t0)[:300] + [
        {"tag": "9lives/x", "value": 2.5e-7, "wall": t0, "role": 'a"b\\c\nd'}]
    for s in (store, jstore):
        s.ingest(rows)
    engine.evaluate(now=t0 + 600.0)
    jengine.evaluate(now=t0 + 600.0)
    got = telemetry.openmetrics_text(store, engine)
    assert got == jtel.openmetrics_text(jstore, jengine)
    assert got.endswith("# EOF\n")
    assert "tpu_apex__9lives_x" in got
    assert telemetry.openmetrics_text(store) == jtel.openmetrics_text(jstore)


def test_openmetrics_endpoint_serves_the_text():
    store = telemetry.FleetMetrics(MetricsParams())
    store.ingest([{"tag": "learner/updates_per_s", "value": 3.0,
                   "wall": 5.0, "role": "learner"}])
    server = telemetry.OpenMetricsServer(
        lambda: telemetry.openmetrics_text(store), host="127.0.0.1", port=0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            body = r.read().decode()
            assert r.headers["Content-Type"].startswith("text/plain")
        assert 'tpu_apex_learner_updates_per_s{role="learner"} 3 5000' in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert server.scrapes == 1
    finally:
        server.close()


def test_mission_control_tails_a_run_dir(tmp_path, monkeypatch):
    """Both packages' mission control over identical run dirs: the same
    transitions at the same clock, their alert rows in each stream and
    the same status block."""
    monkeypatch.setenv("TPU_APEX_ALERT_RULES",
                       "stall: learner/updates_per_s absent 5s")
    out = []
    for mod, mp in ((telemetry, MetricsParams), (jtel, JaxMetricsParams)):
        d = tmp_path / mod.__name__.split(".")[0]
        w = (MetricsWriter if mod is telemetry else jmetrics.MetricsWriter)(
            str(d), enable_tensorboard=False, role="learner")
        w.scalar("learner/updates_per_s", 500.0, step=1, wall=100.0)
        w.scalar("learner/critic_loss", 0.5, step=1, wall=100.0)
        w.flush()
        mc = mod.MissionControl(str(d), mp(enabled=True),
                                clock=lambda: 0.0)
        trail = [mc.poll(now=103.0), mc.poll(now=106.0)]
        w.scalar("learner/updates_per_s", 400.0, step=2, wall=107.0)
        w.flush()
        trail.append(mc.poll(now=107.5))
        block = mc.status_block()
        mc.stop()
        w.close()
        out.append((trail, block, [
            (r["tag"], r["value"], r.get("role"))
            for r in (metrics.read_scalars(str(d))) if
            r["tag"].startswith("alert/")]))
    assert out[0] == out[1]
    trail, block, alert_rows = out[0]
    assert [[t["state"] for t in p] for p in trail] == [
        [], ["pending", "firing"], ["resolved"]]
    assert alert_rows == [("alert/stall", 1.0, "missionctl"),
                          ("alert/stall", 2.0, "missionctl"),
                          ("alert/stall", 0.0, "missionctl")]
    assert set(block["series"]) == {"learner/updates_per_s",
                                    "learner/critic_loss"}


def test_runtime_runs_mission_control(tmp_path, monkeypatch):
    """A short run of row 1 with ``TPU_APEX_METRICS=1`` and a rule that
    the perf plane's first MFU row violates: mission control polls the
    run's rows and writes the alert's transitions, in the runtime's
    process, as role ``missionctl``."""
    monkeypatch.setenv("TPU_APEX_PERF", "1")
    monkeypatch.setenv("TPU_APEX_PERF_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("TPU_APEX_METRICS", "1")
    monkeypatch.setenv("TPU_APEX_METRICS_POLL_S", "0.2")
    monkeypatch.setenv("TPU_APEX_ALERT_RULES",
                       "low_mfu: learner/mfu < 2 for 0s")
    opt = build_options(
        1, device="cpu", memory_type="device", root_dir=str(tmp_path),
        refs="mission", num_actors=1, seed=5, steps=150,
        max_replay_ratio=8.0, learn_start=16, memory_size=512,
        batch_size=16, actor_freq=25, learner_freq=50,
        evaluator_nepisodes=0, early_stop=50)
    topology = runtime.Topology(opt, backend="thread")
    assert topology.mission is not None
    topology.run()
    rows = metrics.read_scalars(opt.log_dir)
    alerts = [(r["value"], r["role"]) for r in rows
              if r["tag"] == "alert/low_mfu"]
    assert alerts[:2] == [(1.0, "missionctl"), (2.0, "missionctl")]
    assert topology.mission.metrics.latest("learner/mfu") is not None
    assert topology.mission._thread is None  # stopped with the run


# ---------------------------------------------------------------------------
# MetricsPusher against the reference's (an actor host's push leg)
# ---------------------------------------------------------------------------

def _push_gateway(pkg: str, sink=None, tier: int = 0):
    """A gateway of ``pkg`` on 127.0.0.1 port 0 whose ``T_METRICS`` goes to
    ``sink``; ``tier`` > 0 sets its flow governor's brownout tier."""
    if pkg == "port":
        from pytorch_distributed_tpu_torch.agents.clocks import (
            ActorStats, GlobalClock,
        )
        from pytorch_distributed_tpu_torch.agents.param_store import (
            ParamStore,
        )
        from pytorch_distributed_tpu_torch.parallel.dcn import DcnGateway
    else:
        from pytorch_distributed_tpu.agents.clocks import (
            ActorStats, GlobalClock,
        )
        from pytorch_distributed_tpu.agents.param_store import ParamStore
        from pytorch_distributed_tpu.parallel.dcn import DcnGateway
    gw = DcnGateway(ParamStore(4), GlobalClock(), ActorStats(),
                    put_chunk=lambda items: None, host="127.0.0.1", port=0,
                    metrics_sink=sink)
    if tier:
        gw.flow.governor.tier = tier
    return gw


def _pusher(pkg: str, addr, log_dir, clock=None):
    cls = telemetry.MetricsPusher if pkg == "port" else jtel.MetricsPusher
    params = (MetricsParams if pkg == "port" else JaxMetricsParams)(
        enabled=True)
    kw = {} if clock is None else {"clock": clock}
    return cls(addr, str(log_dir), params, host="actor-host", **kw)


def _write_rows(log_dir, n, clock=None, start=0):
    w = MetricsWriter(str(log_dir), enable_tensorboard=False,
                      role="actor-0")
    for i in range(start, start + n):
        w.scalar("actor/env_frames_per_s", float(i), step=i,
                 wall=None if clock is None else clock())
    w.close()


@pytest.mark.parametrize("pusher_pkg,gateway_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_pusher_handshake_and_offset_on_an_injected_clock(
        tmp_path, pusher_pkg, gateway_pkg):
    """A host whose clock runs 2.5 s behind: the first push is the empty
    handshake, the rows follow with the offset (about +2.5 s) and land on
    the gateway's clock in mission control; either package's pusher
    against either's gateway, the port's ingest as the sink."""
    clock = lambda: time.time() - 2.5  # noqa: E731
    mission = telemetry.MissionControl(
        None, MetricsParams(enabled=True), AlertParams(enabled=False))
    gw = _push_gateway(gateway_pkg, sink=mission.ingest_remote)
    try:
        _write_rows(tmp_path, 3, clock)
        p = _pusher(pusher_pkg, ("127.0.0.1", gw.port), tmp_path, clock)
        assert p.offset is None
        assert p.push_once() == 3
        assert p.offset == pytest.approx(2.5, abs=0.5)
        assert mission.metrics.remote_batches == 2  # handshake + rows
        wall, value = mission.metrics.latest("actor/env_frames_per_s")
        assert value == 2.0 and abs(wall - time.time()) < 0.5
        assert (p.pushed_rows, p.push_errors) == (3, 0)
    finally:
        gw.close()


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_pusher_sheds_past_max_pending_as_the_reference(tmp_path):
    """A dead gateway: rows buffer, the oldest past ``MAX_PENDING`` are
    shed and counted, the rest kept in order — both packages alike."""
    _write_rows(tmp_path, 30)
    seen = []
    for pkg in ("port", "jax"):
        p = _pusher(pkg, ("127.0.0.1", _free_port()), tmp_path)
        p.MAX_PENDING = 10
        assert p.push_once() == 0
        seen.append((p.dropped_rows, p.push_errors,
                     [r["value"] for r in p._pending]))
    assert seen[0] == seen[1] == (20, 1, [float(i) for i in range(20, 30)])


@pytest.mark.parametrize("gateway_pkg", ["port", "jax"])
def test_pusher_sheds_at_brownout_tier_1_as_the_reference(tmp_path,
                                                          gateway_pkg):
    """A gateway at brownout tier 1 answers ``brownout`` on T_METRICS: the
    next cadence's rows are shed (counted) and an empty ping goes; the
    reference's pusher does the same against the same gateway."""
    got = []
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        mission = telemetry.MissionControl(
            None, MetricsParams(enabled=True), AlertParams(enabled=False))
        gw = _push_gateway(gateway_pkg, sink=mission.ingest_remote, tier=1)
        try:
            p = _pusher(pkg, ("127.0.0.1", gw.port), d)
            _write_rows(d, 2)
            first = p.push_once()  # handshake, then the rows are accepted
            _write_rows(d, 5, start=2)
            second = p.push_once()  # the reply said brownout: shed
            got.append((first, second, p.brownout, p.brownout_shed_rows,
                        p.pushed_rows, mission.metrics.ingested_rows))
        finally:
            gw.close()
    assert got[0] == got[1] == (2, 0, 1, 5, 2, 2)


def test_ingest_remote_of_a_pushed_batch_matches_the_reference():
    """The same pushed batch (rows, an offset, a host) into both packages'
    mission control: the same rows absorbed, batches counted and walls
    shifted."""
    rows = [{"tag": "a/b", "value": 1.5, "wall": 100.0, "role": "actor-1"},
            {"tag": "h", "kind": "histogram", "wall": 0.0},
            {"tag": "a/b", "value": 2.5, "wall": 101.0}]
    batch = {"rows": rows, "offset": 3.25, "host": "h1"}
    port = telemetry.MissionControl(None, MetricsParams(enabled=True),
                                    AlertParams(enabled=False))
    ref = jtel.MissionControl(None, JaxMetricsParams(enabled=True),
                              JaxAlertParams(enabled=False))
    assert port.ingest_remote(batch) == ref.ingest_remote(batch) == 2
    assert port.metrics.remote_batches == ref.metrics.remote_batches == 1
    assert port.metrics.latest("a/b") == ref.metrics.latest("a/b") == (
        104.25, 2.5)
