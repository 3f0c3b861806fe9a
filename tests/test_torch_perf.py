"""The port's perf plane (pytorch_distributed_tpu_torch/utils/perf.py)
against the JAX package's (pytorch_distributed_tpu/utils/perf.py) on the
CPU: the drain's maths, the recapture detector (fed the same counts the
reference's jit caches would give) and the knob resolution exactly; the
FLOPs of an update against XLA's cost analysis of the reference's fused
step within 10% and against the GEMM count exactly, and rows 15 and 17's
DTQN update against XLA's within 10%; the peak table; the
sync audit's attribution; and a short run of row 1 through the runtime
that exports the learner's and the actors' rows, as the reference's
acceptance test does (tests/test_perf.py:642-760), without the gateway."""

import dataclasses
import os
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import jax

from pytorch_distributed_tpu.config import PerfParams as JaxPerfParams
from pytorch_distributed_tpu.utils import perf as jperf
from pytorch_distributed_tpu_torch import runtime
from pytorch_distributed_tpu_torch.config import PerfParams, build_options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, frame_flops, update_flops,
)
from pytorch_distributed_tpu_torch.utils import perf
from pytorch_distributed_tpu_torch.utils import tracing
from pytorch_distributed_tpu_torch.utils.metrics import read_scalars

# the Nature torso at batch B: (M, K, N) of each layer's GEMM
NATURE = ((20 * 20, 8 * 8 * 4, 32), (9 * 9, 4 * 4 * 32, 64),
          (7 * 7, 3 * 3 * 64, 64), (1, 7 * 7 * 64, 512), (1, 512, 6))


def analytic_update_flops(batch: int) -> int:
    """2 M N K of the online and the target net's forward, every layer's
    ``dw`` and every layer's ``dx`` but the first's."""
    return sum(2 * batch * m * k * n * (3 + (i > 0))
               for i, (m, k, n) in enumerate(NATURE))


PLANE_VARS = ("TPU_APEX_PERF", "TPU_APEX_METRICS", "TPU_APEX_ALERT")


@pytest.fixture(autouse=True)
def _fresh_planes(monkeypatch):
    """Both packages' monitors are per-process registries: isolate each
    test, with no perf knob of an earlier run left in the environment,
    and none this test's runs export (``export_env``) left for the next."""
    for var in list(os.environ):
        if var.startswith(PLANE_VARS):
            monkeypatch.delenv(var, raising=False)
    perf.reset()
    jperf.reset()
    yield
    for var in list(os.environ):  # monkeypatch then restores the originals
        if var.startswith(PLANE_VARS):
            del os.environ[var]
    perf.reset()
    jperf.reset()


def _pair(**kw):
    """The same monitor in both packages, the memory rows off (they read
    the process)."""
    kw.setdefault("memory_watermarks", False)
    name = kw.pop("name", "learner")
    prefix = kw.pop("prefix", None)
    return (perf.PerfMonitor(name, PerfParams(enabled=True, **kw),
                             prefix=prefix),
            jperf.PerfMonitor(name, JaxPerfParams(enabled=True, **kw),
                              prefix=prefix))


# the (updates, frames, now) of each drain after the anchor at now=100
WINDOWS = ((50, 0, 105.0), (0, 0, 106.0), (120, 3000, 107.5),
           (7, 11, 107.75))


@pytest.mark.parametrize("case", ["learner", "actor", "anakin",
                                  "no_flops", "retrace_and_audit"])
def test_drain_matches_the_reference(case):
    port, ref = _pair(
        peak_flops=200.0, transfer_audit=case == "retrace_and_audit",
        **({"name": "actor-3", "prefix": "actor"} if case == "actor"
           else {}))
    sizes = [3]
    if case == "retrace_and_audit":
        for m in (port, ref):
            m.register_jit("fused_step", lambda: sizes[0])
            m.register_jit("eager", lambda: None)
    for m in (port, ref):
        if case in ("learner", "anakin", "retrace_and_audit"):
            m.flops_per_update = 10.0
        if case in ("actor", "anakin"):
            m.flops_per_frame = 0.25
        m.set_gauge("learner/replay_ratio", 7.5)
    assert port.drain(now=100.0) == ref.drain(now=100.0)
    for i, (updates, frames, now) in enumerate(WINDOWS):
        if i == 2:
            sizes[0] += 2  # two captures after the warm-up
        for m in (port, ref):
            if case != "actor":
                m.note_updates(updates)
            if case in ("actor", "anakin"):
                m.note_frames(frames)
            m.set_gauge("data/staleness_p50", float(i))
        got, want = port.drain(step=i, now=now), ref.drain(step=i, now=now)
        assert got == want
    assert port.snapshot() == ref.snapshot()
    assert port.retraces.fired == ref.retraces.fired
    if case == "anakin":  # the card's whole use: both programs summed
        assert got["learner/achieved_flops_per_s"] == pytest.approx(
            7 / 0.25 * 10.0 + 11 / 0.25 * 0.25)
    if case == "retrace_and_audit":
        assert got["perf/learner/retraces"] == 2.0
        assert port.retraces.fired == {"fused_step": 2}


def test_disabled_monitor_is_inert():
    m = perf.PerfMonitor("learner", PerfParams(enabled=False))
    assert m.capture_flops(lambda: 1 / 0) is None  # never called
    m.note_updates(5)
    m.note_frames(5)
    m.register_jit("fused_step", lambda: 1)
    assert m.drain() == {} and m.audit is None
    assert perf.status_snapshot() == {}


def test_status_snapshot_and_env_resolution_match(monkeypatch):
    monkeypatch.setenv("TPU_APEX_PERF", "1")
    monkeypatch.setenv("TPU_APEX_PERF_PEAK_FLOPS", "123.0")
    monkeypatch.setenv("TPU_APEX_PERF_TRANSFER_AUDIT", "yes")
    monkeypatch.setenv("TPU_APEX_PERF_PROFILE_WINDOW_MAX", "7")
    got, want = perf.resolve(PerfParams()), jperf.resolve(JaxPerfParams())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.enabled and got.peak_flops == 123.0 and got.transfer_audit
    for mod in (perf, jperf):
        m = mod.get_monitor("learner")  # the knobs from the environment
        m.note_updates(3)
        m.drain(now=1.0)
    assert perf.status_snapshot()["learner"]["updates_total"] == 3.0
    assert perf.status_snapshot().keys() == jperf.status_snapshot().keys()


def test_export_env_matches_the_reference():
    exported = []
    for mod, params in ((perf, PerfParams), (jperf, JaxPerfParams)):
        for var in list(os.environ):  # the fixture cleans up after
            if var.startswith("TPU_APEX_PERF"):
                del os.environ[var]
        mod.export_env(params(enabled=True, peak_flops=5e12,
                              retrace_detector=False))
        exported.append({k: v for k, v in os.environ.items()
                         if k.startswith("TPU_APEX_PERF")})
    assert exported[0] == exported[1] == {
        "TPU_APEX_PERF": "1", "TPU_APEX_PERF_ENABLED": "1",
        "TPU_APEX_PERF_PEAK_FLOPS": "5000000000000.0",
        "TPU_APEX_PERF_RETRACE_DETECTOR": "0"}


def test_retrace_detector_matches_the_reference():
    sizes = {"a": 1, "b": None}
    port, ref = perf.RetraceDetector(), jperf.RetraceDetector()
    for det in (port, ref):
        det.register("a", lambda: sizes["a"])
        det.register("b", lambda: sizes["b"])
        det.register("none", None)
    trail = []
    for a, b in ((1, None), (1, None), (2, 4), (2, 4), (5, 6), (5, 6)):
        sizes.update(a=a, b=b)
        got, want = port.check(), ref.check()
        assert got == want
        trail.append(got)
    # a: 1 -> 2 -> 5; b first seen at 4 (its own warm-up), then 6
    assert port.retraces == ref.retraces == 6
    assert port.fired == ref.fired == {"a": 4, "b": 2}
    assert trail[0] == []  # the first check is the warm-up mark


def test_peak_table_and_compute_dtype():
    assert perf.peak_flops_of("NVIDIA H100 80GB HBM3") == 989.4e12
    assert perf.peak_flops_of("NVIDIA H100 80GB HBM3", "float32") == 66.9e12
    assert perf.peak_flops_of("NVIDIA H100 PCIe", "bfloat16") == 756e12
    assert perf.peak_flops_of("NVIDIA H100 PCIe", "float32") == 51.2e12
    assert perf.peak_flops_of("NVIDIA H100 NVL", "float32") == 60e12
    # a dtype the table lacks keeps the bf16 figure, as the reference
    assert perf.peak_flops_of("NVIDIA H100 NVL", "int8") == 835e12
    assert perf.peak_flops_of("cpu") is None
    assert perf.peak_flops_of("NVIDIA A100-SXM4-80GB") is None
    assert perf.device_kind() == "cpu"
    m = perf.PerfMonitor("learner", PerfParams(enabled=True))
    m.set_compute_dtype(torch.float32)
    assert m.compute_dtype == "float32"
    m2 = perf.PerfMonitor("learner", PerfParams(enabled=True,
                                                peak_flops=123.0))
    m2.set_compute_dtype("float32")
    assert m2._peak_flops() == 123.0  # an explicit peak is never scaled


def test_unknown_card_has_no_mfu_row_and_says_so(capsys):
    m = perf.PerfMonitor("learner", PerfParams(enabled=True,
                                               memory_watermarks=False))
    m.flops_per_update = 10.0
    m.drain(now=0.0)
    m.note_updates(4)
    out = m.drain(now=2.0)
    assert out["learner/achieved_flops_per_s"] == 20.0
    assert "learner/mfu" not in out
    assert "no peak FLOP/s for 'cpu'" in capsys.readouterr().out


def test_failed_flops_capture_leaves_mfu_off(capsys):
    m = perf.PerfMonitor("learner", PerfParams(enabled=True))
    assert m.capture_flops(lambda: 1 / 0) is None
    assert "flops capture failed" in capsys.readouterr().out
    assert m.capture_frame_flops(lambda: 64.0, frames_per_call=4) == 16.0


def test_watermarks_on_the_cpu_host():
    """No card used here: no device rows, the host RSS ones."""
    out = perf.PerfMonitor("learner", PerfParams(enabled=True)).drain()
    assert out["perf/learner/rss_bytes"] > 0
    assert out["perf/learner/rss_peak_bytes"] > 0
    assert perf.device_memory_watermarks() == {}
    assert not any("device" in k for k in out)


def test_update_flops_match_the_gemm_count_and_xla():
    """dqn-cnn at batch 32: the port's count equals the update's GEMMs to
    the FLOP; XLA's cost analysis of the reference's fused step (which
    also counts the elementwise work) is within 10%."""
    from pytorch_distributed_tpu.config import build_options as jax_options
    from pytorch_distributed_tpu.factory import (
        EnvSpec as JaxEnvSpec, build_model as jax_build_model,
        build_train_state_and_step as jax_state_and_step,
        init_params as jax_init_params,
    )
    from pytorch_distributed_tpu.memory.device_per import (
        DevicePerReplay as JaxDevicePerReplay,
    )

    batch, frame = 32, (4, 84, 84)
    for torso in (True, False):
        opt = build_options(12, device="cpu", batch_size=batch,
                            pallas_torso=torso)
        got = update_flops(opt, EnvSpec(frame, 6, 255.0))
        assert got == analytic_update_flops(batch)
    assert frame_flops(opt, EnvSpec(frame, 6, 255.0)) == sum(
        2 * m * k * n for m, k, n in NATURE)  # one forward of one frame
    jopt = jax_options(12, batch_size=batch)
    jspec = JaxEnvSpec(state_shape=frame, discrete=True, num_actions=6,
                       action_dim=0, norm_val=255.0)
    jmodel = jax_build_model(jopt, jspec)
    jstate, jstep = jax_state_and_step(
        jopt, jspec, jmodel, jax_init_params(jopt, jspec, jmodel, seed=0))
    jring = JaxDevicePerReplay(64, frame)
    fused = jring.build_fused_step(jstep, batch, donate=False,
                                   steps_per_call=1)
    xla = jperf.flops_of_compiled(fused.lower(
        jstate, jring.state, jax.random.PRNGKey(0),
        np.float32(0.4)).compile())
    print(f"flops per update at batch {batch}: port {got:.0f} (GEMMs), "
          f"XLA {xla:.0f} ({xla / got - 1:+.2%})")
    assert abs(xla - got) <= 0.10 * got


@pytest.mark.parametrize("config", [15, 17])
def test_dtqn_update_flops_match_xla(config):
    """Rows 15 and 17 at the reference's full width and a batch of 4
    segments: the port's count (the products and einsums, forward and
    backward, on fake tensors) is within 10% of XLA's cost analysis of the
    reference's DTQN step, as config 12's is; row 18 computes row 15's
    products and counts the same."""
    from pytorch_distributed_tpu.config import build_options as jax_options
    from pytorch_distributed_tpu.factory import (
        EnvSpec as JaxEnvSpec, build_model as jax_build_model,
        build_train_state_and_step as jax_state_and_step,
        init_params as jax_init_params,
    )
    from pytorch_distributed_tpu.memory.sequence_replay import (
        SegmentBatch as JaxSegmentBatch,
    )

    batch, obs = 4, (8,)
    got = update_flops(build_options(config, device="cpu",
                                     batch_size=batch), EnvSpec(obs, 2, 1.0))
    if config == 15:
        assert got == update_flops(build_options(
            18, device="cpu", batch_size=batch), EnvSpec(obs, 2, 1.0))
    jopt = jax_options(config, batch_size=batch)
    jspec = JaxEnvSpec(state_shape=obs, discrete=True, num_actions=2,
                       action_dim=0, norm_val=1.0)
    jmodel = jax_build_model(jopt, jspec)
    jstate, jstep = jax_state_and_step(
        jopt, jspec, jmodel, jax_init_params(jopt, jspec, jmodel, seed=0))
    T = jopt.agent_params.seq_len
    z = lambda *shape: np.zeros(shape, np.float32)
    segs = JaxSegmentBatch(
        obs=z(batch, T + 1, *obs), action=np.zeros((batch, T), np.int32),
        reward=z(batch, T), terminal=z(batch, T),
        mask=np.ones((batch, T), np.float32), c0=z(batch, 1),
        h0=z(batch, 1), weight=np.ones(batch, np.float32),
        index=np.zeros(batch, np.int32))
    xla = jperf.flops_of_compiled(jax.jit(jstep).lower(jstate, segs)
                                  .compile())
    print(f"row {config} flops per update at batch {batch}: port {got:.0f},"
          f" XLA {xla:.0f} ({xla / got - 1:+.2%})")
    assert abs(xla - got) <= 0.10 * got


# ---------------------------------------------------------------------------
# the sync audit
# ---------------------------------------------------------------------------

def _syncing(where):
    """Raises the warning CUDA's sync debug mode raises, as a
    ``.item()`` on a CUDA tensor would, on the line ``where`` records."""
    where.append(sys._getframe().f_lineno + 1)
    warnings.warn(perf.SYNC_WARNING + " (Triggered internally)", UserWarning)
    return 7


def test_audit_attributes_a_sync_to_its_line(capsys):
    aud = perf.TransferAudit()
    where = []
    assert aud.run(_syncing, where) == 7  # run once, its result returned
    site = f"test_torch_perf.py:{where[0]} (_syncing)"
    assert aud.total == 1 and len(aud.sites) == 1
    assert next(iter(aud.sites)).endswith(site)
    assert perf.SYNC_WARNING in aud.last_error
    aud.run(_syncing, where)  # the same site again: counted, printed once
    assert aud.total == 2 and list(aud.sites.values()) == [2]
    assert capsys.readouterr().out.count("transfer audit") == 1


def test_audit_passes_clean_calls_other_warnings_and_errors():
    aud = perf.TransferAudit()
    assert aud.run(lambda x: x * 2, 21) == 42
    with pytest.warns(DeprecationWarning):
        aud.run(lambda: warnings.warn("old", DeprecationWarning))
    with pytest.raises(ZeroDivisionError):
        aud.run(lambda: 1 / 0)
    assert aud.total == 0 and aud.sites == {}


def test_audit_drops_other_threads_syncs():
    aud = perf.TransferAudit()
    started, release = threading.Event(), threading.Event()

    def other():
        started.set()
        release.wait(10)
        warnings.warn(perf.SYNC_WARNING, UserWarning)

    t = threading.Thread(target=other)
    t.start()

    def body():
        started.wait(10)
        release.set()
        t.join(10)

    aud.run(body)
    assert not t.is_alive()
    assert aud.total == 0


def test_overlapping_audits_keep_the_hook_until_the_last_leaves():
    """Two threads' audits overlap (device actors beside the learner) and
    the first to enter leaves first: the other keeps the hook, each counts
    its own thread's syncs, and the last to leave restores the process."""
    shown = warnings.showwarning
    first, second = perf.TransferAudit(), perf.TransferAudit()
    entered, overlapped = threading.Event(), threading.Event()
    where_first, where_second = [], []

    def first_body():
        entered.set()
        assert overlapped.wait(10)  # the second audit is running too
        return _syncing(where_first)

    t = threading.Thread(target=lambda: first.run(first_body))
    t.start()

    def second_body():
        assert entered.wait(10)
        overlapped.set()
        t.join(10)  # the first audit has left
        _syncing(where_second)
        _syncing(where_second)

    second.run(second_body)
    assert not t.is_alive()
    assert first.total == 1 and second.total == 2
    assert next(iter(first.sites)).endswith(
        f"test_torch_perf.py:{where_first[0]} (_syncing)")
    assert next(iter(second.sites)).endswith(
        f"test_torch_perf.py:{where_second[0]} (_syncing)")
    assert warnings.showwarning is shown  # the last audit restored it
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _syncing([])  # no audit running: shown as any warning
    assert len(seen) == 1


def test_nested_audits_on_one_thread_go_to_the_inner_one():
    outer, inner = perf.TransferAudit(), perf.TransferAudit()

    def body():
        inner.run(_syncing, [])
        return _syncing([])

    assert outer.run(body) == 7
    assert inner.total == 1 and outer.total == 1


# ---------------------------------------------------------------------------
# acceptance: a short run of row 1 exports the plane's rows
# ---------------------------------------------------------------------------

def test_short_cpu_run_exports_the_perf_plane(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_APEX_PERF", "1")
    # no peak for the CPU: the knob gives one, so the mfu row exists
    monkeypatch.setenv("TPU_APEX_PERF_PEAK_FLOPS", "1e12")
    tracing.reset()
    opt = build_options(
        1, device="cpu", memory_type="device", root_dir=str(tmp_path),
        refs="perfrun", num_actors=1, seed=3, steps=300,
        max_replay_ratio=8.0, learn_start=16, memory_size=512,
        batch_size=16, actor_freq=25, param_publish_freq=50,
        learner_freq=50, evaluator_nepisodes=0, early_stop=50,
        num_envs_per_actor=1)
    summary = runtime.Topology(opt, backend="thread").run()
    assert summary["learner/steps"] >= 300
    by_tag = {}
    for r in read_scalars(opt.log_dir):
        by_tag.setdefault(r["tag"], []).append(r)
    for tag in ("learner/mfu", "learner/updates_per_s",
                "learner/flops_per_update", "learner/replay_ratio",
                "learner/achieved_flops_per_s", "learner/ingest_queue_depth",
                "actor/env_frames_per_s", "data/staleness_p50",
                "data/sample_age_p95", "data/top_actor_share",
                "perf/learner/rss_bytes", "perf/learner/rss_peak_bytes",
                "perf/actor/rss_bytes"):
        assert tag in by_tag, f"{tag} missing (have {sorted(by_tag)})"
    assert any(r["value"] > 0 for r in by_tag["learner/mfu"])
    assert any(r["value"] > 0 for r in by_tag["actor/env_frames_per_s"])
    assert by_tag["learner/mfu"][0]["role"] == "learner"
    assert by_tag["perf/actor/rss_bytes"][0]["role"] == "actor-0"
    (flops,) = by_tag["learner/flops_per_update"]
    # dqn-mlp, the chain's 8 wide input -> 3 x 256 -> 2 actions: the
    # online and target forward, dw of each layer, dx of all but the first
    dims = [(8, 256), (256, 256), (256, 256), (256, 2)]
    assert flops["value"] == sum(
        2 * 16 * k * n * (3 + (i > 0)) for i, (k, n) in enumerate(dims))
    # mfu = achieved / the knob's peak
    for a, m in zip(by_tag["learner/achieved_flops_per_s"],
                    by_tag["learner/mfu"]):
        assert m["value"] == pytest.approx(a["value"] / 1e12)
    # no graph on the CPU: the detector reads nothing and stays at 0
    assert all(r["value"] == 0.0
               for r in by_tag.get("perf/learner/retraces", []))
