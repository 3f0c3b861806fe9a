"""Configuration for the port (counterpart of pytorch_distributed_tpu/config.py).

The CONFIGS table is the reference's, row for row, so ``--config N`` names
the same component bundle in both packages.  The dataclasses carry the
fields the port's slice reads, under the reference's names, so the same
``--set k=v`` lines work on both packages; a ``--set`` naming a field the
port does not carry yet raises instead of being dropped.

Port-only field: ``Options.device`` (``cuda`` by default; ``cpu`` is what
the tests pass).  There is no ``pallas_interpret``: on a CPU tensor the
kernel wrappers take their plain versions by rule, and on a CUDA tensor
they launch the kernel or raise.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# [agent_type, env_type, game, memory_type, model_type] — the reference's
# table (pytorch_distributed_tpu/config.py:37-59); the port runs the rows
# of PORTED_CONFIGS
CONFIGS = [
    ["dqn",  "atari",    "pong",        "shared",          "dqn-cnn"],      # 0
    ["dqn",  "fake",     "chain",       "shared",          "dqn-mlp"],      # 1
    ["ddpg", "classic",  "pendulum",    "shared",          "ddpg-mlp"],     # 2
    ["dqn",  "classic",  "cartpole",    "shared",          "dqn-mlp"],      # 3
    ["dqn",  "pong-sim", "pong",        "shared",          "dqn-cnn"],      # 4
    ["dqn",  "atari",    "breakout",    "shared",          "dqn-cnn"],      # 5
    ["dqn",  "pong-sim", "pong",        "prioritized",     "dqn-cnn"],      # 6
    ["dqn",  "atari",    "pong",        "prioritized",     "dqn-cnn"],      # 7
    ["dqn",  "pong-sim", "pong",        "device",          "dqn-cnn"],      # 8
    ["ddpg", "gym",      "halfcheetah", "shared",          "ddpg-mlp"],     # 9
    ["ddpg", "gym",      "humanoid",    "shared",          "ddpg-mlp"],     # 10
    ["dqn",  "atari",    "breakout",    "device",          "dqn-cnn"],      # 11
    ["dqn",  "pong-sim", "pong",        "device-per",      "dqn-cnn"],      # 12
    ["r2d2", "fake",     "chain",       "sequence",        "drqn-mlp"],     # 13
    ["r2d2", "pong-sim", "pong",        "device-sequence", "drqn-cnn"],     # 14
    ["r2d2", "fake",     "chain",       "sequence",        "dtqn-mlp"],     # 15
    ["ddpg", "classic",  "reacher",     "shared",          "ddpg-mlp"],     # 16
    ["r2d2", "fake",     "chain",       "sequence",        "dtqn-moe"],     # 17
    ["r2d2", "fake",     "chain",       "sequence",        "dtqn-pipe"],    # 18
    ["dqn",  "pong-sim", "pong",        "device-per",      "dqn-cnn-wide"], # 19
]

# the rows this port runs end to end so far
PORTED_CONFIGS = (1, 2, 3, 4, 6, 8, 9, 10, 12, 13, 14, 15, 16, 17, 18,
                  19)


def _default_refs() -> str:
    """Run signature ``{machine}_{timestamp}`` keying checkpoints and logs
    (reference config.py:141-145)."""
    machine = os.uname().nodename.split(".")[0] or "machine"
    return f"{machine}_{time.strftime('%y%m%d%H%M%S')}"


@dataclass
class EnvParams:
    env_type: str = "pong-sim"
    game: str = "pong"
    seed: int = 100
    state_cha: int = 4
    state_hei: int = 84
    state_wid: int = 84
    early_stop: int = 12500
    action_repetition: int = 4
    num_envs_per_actor: int = 1
    # "pipelined" (default) dispatches tick k+1's forward before it feeds
    # tick k; "inline" runs act, env step and feed in turn; both give the
    # same transitions.  "batched" sends each tick's observations to the
    # shared inference server in the learner's process (agents/
    # inference.py), and gives the same transitions too.  "device" runs
    # the Pong fleet as tensors (envs/device_env.py), fused with the
    # forward and the n-step assembly into one rollout of
    # ``device_rollout_ticks`` ticks (models/policies.py); "anakin" runs
    # that rollout in the learner's process, writing straight into the
    # ring between learner dispatches (agents/anakin.py, AnakinParams).
    # anakin steps down to device, and device to pipelined, with a
    # warning where the config cannot run them (factory.py)
    actor_backend: str = "pipelined"
    # ticks of the whole fleet per fused rollout dispatch
    device_rollout_ticks: int = 8
    # the device env family: "auto" takes env_type's own ("pong" for
    # pong-sim); a named family must be that one (envs/device_env.py)
    device_env_family: str = "auto"
    # pong-sim actors step their envs through the C++ batched stepper
    # (native/pong_batch.cpp, built with g++); false: the numpy simulators
    native_env: bool = True

    @property
    def state_shape(self) -> Tuple[int, ...]:
        return (self.state_cha, self.state_hei, self.state_wid)
    # dump the evaluator's and the tester's frames as PNGs under
    # ``{log_dir}/frames`` (utils/render.py; ``main --render``)
    render: bool = False


@dataclass
class MemoryParams:
    memory_type: str = "device-per"
    memory_size: int = 50000
    state_dtype: str = "uint8"
    priority_exponent: float = 0.6
    priority_weight: float = 0.4
    # save the ring's rows and priorities with every checkpoint epoch
    # (utils/checkpoint.py save_epoch); off by default: config 12's ring
    # compresses slowly on the host
    checkpoint_replay: bool = False


@dataclass
class ModelParams:
    model_type: str = "dqn-cnn"
    orthogonal_init: bool = True
    compute_dtype: str = "bfloat16"
    # dqn-mlp width (reference config.py:269)
    hidden_dim: int = 256
    # dqn-cnn-wide base width: sections of (width, 2 width, 2 width)
    # channels (models/dqn_cnn_wide.py, reference config.py:275-278)
    cnn_wide_width: int = 128
    # the LSTM core's width (drqn-* models, reference config.py:270); the
    # drqn-cnn floors it at 512 (factory.lstm_dim_of)
    lstm_dim: int = 256
    # the transformer Q-networks' (dtqn-*) width, heads and blocks
    # (reference config.py:271-274); their window is seq_len + 1
    tf_dim: int = 128
    tf_heads: int = 4
    tf_depth: int = 2
    # dtqn-moe's routing: experts, choices a token, slot headroom a batch
    # row and the Switch load-balancing loss's weight (reference
    # config.py:279-285, models/moe.py).  The reference's mesh fields
    # (its ParallelParams: sp_size, ep_size, pp_size, ...) come with
    # ROADMAP.md Queue A item 9; a --set of one raises as unknown
    moe_experts: int = 8
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01


@dataclass
class AgentParams:
    agent_type: str = "dqn"
    steps: int = 500000
    max_seconds: float = 0.0
    gamma: float = 0.99
    clip_grad: float = float("inf")    # dqn: inf; ddpg: 40.0
    lr: float = 1e-4
    # anneal the learning rate linearly to 0 over ``steps`` (optax's
    # ``linear_schedule``, reference config.py:313; ops/losses.adam_update)
    lr_decay: bool = False
    # decoupled weight decay added to the gradient after the clip
    # (``add_decayed_weights``); the dqn family's optimizer only, as the
    # reference's (factory.py:548 vs :658-661)
    weight_decay: float = 0.0
    actor_sync_freq: int = 100         # dqn: 100; ddpg: 400
    # logger cadences (reference config.py:315-322)
    logger_freq: int = 15              # secs
    actor_freq: int = 250              # ddpg: 2500
    learner_freq: int = 100            # ddpg: 1000
    evaluator_freq: int = 30           # secs; ddpg: 60
    evaluator_nepisodes: int = 2
    tester_nepisodes: int = 50
    # niceness of the evaluator's process (0 = none; reference
    # config.py:323-332): its bursty greedy episodes must not starve the
    # learner on a busy host
    evaluator_nice: int = 5
    param_publish_freq: int = 10
    # learner steps between checkpoint epochs; 0: the final epoch only
    checkpoint_freq: int = 0
    # committed epochs kept on disk (utils/checkpoint.py gc_epochs)
    checkpoint_retain: int = 3
    learn_start: int = 5000            # ddpg: 250
    batch_size: int = 128              # ddpg: 64
    max_replay_ratio: float = 0.0
    # 0 = auto: 1 sub-step per dispatch.  On the GPU a dispatch is one
    # CUDA-graph replay; 32 per dispatch measured slower end to end in the
    # thread backend (PERF.md)
    steps_per_dispatch: int = 0
    target_model_update: float = 250   # >= 1: hard every N; < 1: tau
    nstep: int = 5
    enable_double: bool = False
    eps: float = 0.4
    eps_alpha: float = 7.0
    # ddpg (reference config.py:382-392): the critic's learning rate (the
    # actor's is ``lr``) and the actors' Ornstein-Uhlenbeck noise
    # (utils/random_process.py)
    critic_lr: float = 1e-3
    ou_theta: float = 0.15
    ou_sigma: float = 0.3
    ou_mu: float = 0.0
    # one Adam over both nets, the policy loss's gradient reaching the
    # critic, as the original DDPG learner; false: an optimizer a net
    # (ops/losses.build_ddpg_train_step)
    ddpg_coupled_update: bool = False
    # r2d2 (reference config.py:374-381): segment length and the overlap
    # of adjacent segments, the stored-state burn-in prefix, the h(x)
    # value rescaling of the targets, and the max/mean blend of the
    # sequence priorities.  learn_start and batch_size count segments
    seq_len: int = 80
    seq_overlap: int = 40
    burn_in: int = 40
    value_rescale: bool = True
    priority_eta: float = 0.9


def build_agent_params(agent_type: str) -> AgentParams:
    """The family's defaults (reference config.py:400-425)."""
    if agent_type == "dqn":
        return AgentParams(agent_type="dqn")
    if agent_type == "r2d2":
        return AgentParams(
            agent_type="r2d2", enable_double=True, nstep=5, batch_size=64,
            learn_start=64, target_model_update=2500)
    if agent_type == "ddpg":
        return AgentParams(
            agent_type="ddpg", clip_grad=40.0, actor_sync_freq=400,
            actor_freq=2500, learner_freq=1000, evaluator_freq=60,
            learn_start=250, batch_size=64, target_model_update=1e-3)
    raise ValueError(f"unknown agent_type: {agent_type}")


@dataclass
class HealthParams:
    """The training health sentinel's knobs (utils/health.py, reference
    config.py:428-465).  Every field is overridable from the environment
    as ``TPU_APEX_HEALTH_<FIELD>`` (``health.resolve``), which spawn
    children inherit."""

    # the in-step finite check (ops/losses.finite_guard): a non-finite
    # step is skipped and reported as learner/skipped
    numeric_guards: bool = True
    # the anomaly detector on the learner's stats cadence: the loss's
    # z-score bound against its EWMA, the grad-norm spike ratio against
    # its EWMA, and the consecutive anomalous windows that trip a rollback
    anomaly_zmax: float = 8.0
    grad_spike: float = 100.0
    anomaly_threshold: int = 3
    # the priority-collapse floor on the PER X-ray's ESS / rows
    ess_floor: float = 0.02
    # roll back in process to an older committed checkpoint epoch on a
    # tripped streak, at most ``max_rollbacks`` times; then the learner
    # raises
    rollback: bool = True
    max_rollbacks: int = 2
    # validate every drained row and divert offenders to
    # {log_dir}/quarantine/ (also switched off by TPU_APEX_QUARANTINE=0);
    # past ``quarantine_max_files`` files a source only counts
    quarantine: bool = True
    quarantine_max_files: int = 64
    # the hang watchdog (runtime.py): seconds a worker may go without a
    # progress mark before it is SIGKILLed and respawned; 0 turns it off.
    # ``hang_grace`` is added before a worker's first mark
    hang_deadline: float = 0.0
    hang_grace: float = 120.0


@dataclass
class LearnerPerfParams:
    """The learner's MFU knobs (reference config.py:851-888), each
    overridable from the environment as ``TPU_APEX_MXU_<FIELD>``
    (``utils/perf.resolve_mxu``)."""

    # megabatch factor M of the fused device-replay step: each group of M
    # minibatches is drawn in one widened draw and its M gradients are
    # taken at the group-entry params in one forward and backward over
    # M*B rows, then the M optimizer updates apply in turn
    # (ops/losses.build_dqn_megabatch_step); 1 = off.  A dispatch's
    # ``steps_per_dispatch`` is rounded up to a multiple of M
    megabatch: int = 1
    # the learner's train apply runs the dqn-cnn torso through the
    # hand-written GEMM kernel (ops/cuda_torso.py)
    pallas_torso: bool = False


@dataclass
class AnakinParams:
    """The co-located Anakin loop's knobs (agents/anakin.py), active under
    ``actor_backend="anakin"``; each is overridable from the environment
    as ``TPU_APEX_ANAKIN_<FIELD>`` (``anakin.resolve_anakin``)."""

    # env frames per learner update the scheduler aims at; 0: strict
    # alternation of one rollout and one learner dispatch
    rollout_ratio: float = 0.0
    # ring rows (per half with ``double_buffer``) before the first learner
    # dispatch; 0: ``learn_start``, clamped below the ring's capacity
    min_fill: int = 0
    # two half-capacity rings: learner dispatches sample one while
    # rollouts write the other, swapping once ``min_fill`` fresh rows
    # landed
    double_buffer: bool = False
    # drain the ingest queues between dispatches (rows from actors of
    # another host; none in a co-located run)
    drain_ingest: bool = True


@dataclass
class PerfParams:
    """The perf plane's knobs (utils/perf.py, reference config.py:477-520),
    each overridable from the environment as ``TPU_APEX_PERF_<FIELD>``
    (``perf.resolve``; the bare ``TPU_APEX_PERF=1`` is ``enabled``), which
    spawn children inherit."""

    # export the learner's updates/s, FLOPs per update and MFU, the actors'
    # env frames/s, the replay-ratio and data gauges and each role's memory
    # watermarks as scalar rows on the roles' stats cadences.  Off by
    # default: the hot path pays one counter add, start-up one FLOP count
    # of an update
    enabled: bool = False
    # the card's peak FLOP/s for MFU; 0: from the card's name and the
    # compute dtype (utils/perf.PEAK_FLOPS); a card not in the table gets
    # achieved FLOP/s and no MFU row unless this is set
    peak_flops: float = 0.0
    # device live/peak bytes (the CUDA allocator) and host RSS
    # current/peak on every drain
    memory_watermarks: bool = True
    # count the registered CUDA graphs' captures and flag any after the
    # warm-up: a recapture on the hot path is the port's retrace
    retrace_detector: bool = True
    # run the learner's fused dispatch (and the device actor's rollout)
    # with CUDA's sync debug mode at "warn" and attribute every host sync
    # it makes to its call site; the call is never run twice
    transfer_audit: bool = False
    # upper bound, seconds, on one profile window (run_profile_window's
    # default; TPU_APEX_PERF_PROFILE_WINDOW_MAX)
    profile_window_max: float = 30.0


@dataclass
class MetricsParams:
    """Mission control's metrics plane (utils/telemetry.py, reference
    config.py:523-561), each field overridable as
    ``TPU_APEX_METRICS_<FIELD>`` (``telemetry.resolve_metrics``; the bare
    ``TPU_APEX_METRICS=1`` is ``enabled``)."""

    # tail the run's scalars.jsonl into bounded time series and evaluate
    # the alert rules on the poll cadence.  Off by default
    enabled: bool = False
    # the tail and alert cadence, seconds
    poll_s: float = 2.0
    # the remote hosts' push cadence, seconds: an actor host's
    # ``telemetry.MetricsPusher`` ships its scalar rows over ``T_METRICS``
    # this often
    push_s: float = 5.0
    # raw points cover ``raw_span_s`` seconds (at most ``raw_points`` a
    # series); 10 s and 60 s bucket tiers keep the older history
    raw_span_s: float = 300.0
    raw_points: int = 1024
    # distinct (tag, role) series; more are counted and dropped
    max_series: int = 512
    # points a series in the status ``series`` block
    series_points: int = 32
    # more tags for the status ``series`` block, comma-separated
    series_tags: str = ""
    # serve the series and the alert states as OpenMetrics text (stdlib
    # HTTP, GET /metrics)
    openmetrics: bool = False
    openmetrics_port: int = 9108


@dataclass
class AlertParams:
    """The alert rules over mission control's series (utils/telemetry.py
    ``AlertEngine``, reference config.py:564-584), each field overridable
    as ``TPU_APEX_ALERT_<FIELD>``; ``TPU_APEX_ALERT_RULES`` replaces the
    whole rule set (``;``-separated)."""

    enabled: bool = True
    # one rule a line, ``;``-separated:
    #
    #   name: tag absent 120s                  (absence)
    #   name: tag > 100 for 60s                (threshold with a dwell)
    #   name: tag < 0.02 frac 0.5 over 300s    (windowed burn rate)
    #
    # "": telemetry.DEFAULT_RULES
    rules: str = ""
    # seconds a firing rule must read clean before it resolves; 0: the
    # first clean evaluation
    resolve_s: float = 0.0


@dataclass
class FlowParams:
    """Flow control on the local transports (utils/flow.py, reference
    config.py:588-641), each field overridable as ``TPU_APEX_FLOW_<FIELD>``
    (``TPU_APEX_FLOW=0`` is ``enabled``).  On by default; inert under
    ``local_policy="block"`` and, on a gateway, until its pressure
    crosses ``throttle_at``."""

    enabled: bool = True
    # the chunks a creditless DcnClient parks in its drop-oldest ring
    client_ring: int = 256
    # "block": a full ingest queue stalls the producer; "shed": bounded
    # drop-oldest buffers, every drop counted and provenance-stamped
    local_policy: str = "block"
    # the feeder's shed ring (chunks) and the device ingest's pending
    # bound (rows) under "shed"
    feeder_ring: int = 64
    max_pending_rows: int = 65536
    # the gateway's per-slot token bucket (chunks/s and burst), metering
    # the throttled grants and the tier-3 shed
    bucket_rate: float = 200.0
    bucket_burst: float = 400.0
    # the credit cap an ack grants while throttled (healthy grants no
    # credit field, shedding grants 0)
    credits_throttled: int = 4
    # the overload governor's thresholds on the 0..1 pressure: sustained
    # >= throttle_at (then shed_at) for dwell_s climbs one state,
    # sustained < recover_at for recover_s steps down one
    throttle_at: float = 0.75
    shed_at: float = 0.92
    recover_at: float = 0.50
    dwell_s: float = 1.0
    recover_s: float = 3.0
    # seconds of shedding per brownout rung (1 telemetry, 2 + traces,
    # 3 + oldest experience)
    brownout_dwell_s: float = 5.0


@dataclass
class BandwidthParams:
    """The bandwidth X-ray (utils/bandwidth.py, reference
    config.py:644-667), each field overridable as ``TPU_APEX_WIRE_<FIELD>``
    (``TPU_APEX_WIRE=0`` is ``enabled``).  On by default."""

    enabled: bool = True
    # count the spawn queues' mint and drain boundaries
    spawn: bool = True
    # least seconds between two emits for a ``wire/<link>/bytes_per_s``
    rate_floor_s: float = 0.05


@dataclass
class ReplicaParams:
    """The learner replica plane (parallel/dcn.py ``ReplicaRegistry``,
    agents/learner.py ``ReplicaLearnerDriver``; reference config.py:
    709-755), each field overridable as ``TPU_APEX_REPLICA_<FIELD>``
    (``parallel.dcn.resolve_replica``).  N data-parallel replicas hold
    leases with monotonic generations on the lead gateway and train one
    model through generation-stamped gradient rounds; a missed lease
    expires the replica and fences its stale writes."""

    # replicas configured (1: the plane is off); fewer live members is
    # a degraded state, not an error
    replicas: int = 1
    # the lease window, seconds; also the round-stall window after which
    # a silent member is expelled from a started round
    lease_s: float = 5.0
    # the renew cadence, seconds (0: lease_s / 3)
    renew_s: float = 0.0
    # the cap on one blocking round, seconds (0: 3 lease windows + 1)
    round_timeout_s: float = 0.0
    # seconds a rejoiner may take to load the barrier epoch and activate
    join_timeout_s: float = 30.0
    # the lead gateway's ``host:port`` a remote replica host dials
    coordinator: str = ""


@dataclass
class GatewayParams:
    """The gateway's HA plane (parallel/dcn.py ``GatewayJournal`` and the
    gateway's standby role; reference config.py:757-801), each field
    overridable as ``TPU_APEX_GATEWAY_<FIELD>``
    (``parallel.dcn.resolve_gateway``).  The primary journals its
    control state to a fsynced WAL under ``{log_dir}/gateway/`` and
    serves it over ``T_SYNC``; a warm standby promotes once the primary
    has been silent for a lease window, under a term written to the
    shared ``TERM.json``.  Off: no journal, no ``gateway`` block in
    STATUS, the wire as without the plane."""

    enabled: bool = False
    # the primary's lease, seconds: the standby promotes after failing to
    # sync this long
    lease_s: float = 2.0
    # the standby's sync cadence, seconds
    sync_s: float = 0.25
    # the standby's bind ``host:port`` ("": 0.0.0.0 on the --port given)
    standby: str = ""
    # the ordered dial list ``host:port,host:port``, primary first
    endpoints: str = ""


_SUBS = ("env_params", "memory_params", "model_params", "agent_params",
         "health_params", "perf_params", "metrics_params", "alert_params",
         "learner_perf_params", "anakin_params", "flow_params",
         "replica_params", "gateway_params")
# the fields of the reference's option groups the port does not carry
# (ShardParams, the sharded replay plane, reference config.py:804-861): a
# bare key only they own raises as unknown, and one they share with a
# ported group raises as ambiguous, as the reference's router does
_UNPORTED_FIELDS = {
    "shard_params": ("shards", "lease_s", "renew_s", "mass_refresh_s",
                     "join_timeout_s", "coordinator"),
}
# the CONFIGS columns a run may not override; ``memory_type`` and
# ``model_type`` may (``--set memory_type=native``, ``--set
# model_type=dqn-cnn-wide``), as the reference's selectors
_SELECTORS = ("agent_type", "env_type", "game")


@dataclass
class Options:
    # run identity (reference config.py:930-947)
    mode: int = 1                      # 1 = train, 2 = test model_file
    config: int = 12
    seed: int = 100
    refs: str = field(default_factory=_default_refs)
    root_dir: str = field(default_factory=os.getcwd)
    num_actors: int = 8
    model_file: Optional[str] = None   # the checkpoint mode 2 tests
    # checkpoint epochs (utils/checkpoint.py, reference config.py:941-949):
    # "auto" resumes from the newest complete epoch under
    # ``{model_name}_ckpt`` if there is one; "must" (``--resume REFS``)
    # raises without one; "never" starts fresh
    resume: str = "auto"
    device: str = "cuda"
    # the logger's TensorBoard mirror (reference config.py:950; ``main
    # --no-tensorboard`` turns it off)
    visualize: bool = True

    agent_type: str = "dqn"
    env_type: str = "pong-sim"
    game: str = "pong"
    memory_type: str = "device-per"
    model_type: str = "dqn-cnn"

    env_params: EnvParams = field(default_factory=EnvParams)
    memory_params: MemoryParams = field(default_factory=MemoryParams)
    model_params: ModelParams = field(default_factory=ModelParams)
    agent_params: AgentParams = field(default_factory=AgentParams)
    health_params: HealthParams = field(default_factory=HealthParams)
    perf_params: PerfParams = field(default_factory=PerfParams)
    metrics_params: MetricsParams = field(default_factory=MetricsParams)
    alert_params: AlertParams = field(default_factory=AlertParams)
    learner_perf_params: LearnerPerfParams = field(
        default_factory=LearnerPerfParams)
    anakin_params: AnakinParams = field(default_factory=AnakinParams)
    flow_params: FlowParams = field(default_factory=FlowParams)
    replica_params: ReplicaParams = field(default_factory=ReplicaParams)
    gateway_params: GatewayParams = field(default_factory=GatewayParams)

    @property
    def model_dir(self) -> str:
        return os.path.join(self.root_dir, "models")

    @property
    def model_name(self) -> str:
        # reference config.py:979-982
        return os.path.join(self.model_dir, f"{self.refs}")

    @property
    def log_dir(self) -> str:
        # reference config.py:984-987
        return os.path.join(self.root_dir, "logs", self.refs)


def parse_set_overrides(pairs) -> dict:
    """Parse repeatable CLI ``--set key=value`` pairs (bool, int, float,
    else string) — the reference's parser (config.py:990-1007)."""
    out = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        else:
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    continue
        out[k] = v
    return out


def build_options(config: int = 12, **overrides: Any) -> Options:
    """Options from a CONFIGS row plus keyword overrides, routed to the
    sub-dataclass that owns each key (reference config.py:1010-1098).
    Raises for a row the port does not run yet and for unknown keys."""
    if config not in PORTED_CONFIGS:
        raise NotImplementedError(
            f"config {config} ({'/'.join(CONFIGS[config])}) is not ported "
            f"yet; this slice runs {PORTED_CONFIGS} (ROADMAP.md Queue A)")
    agent_type, env_type, game, memory_type, model_type = CONFIGS[config]
    # ``--set memory_type=native`` and ``--set model_type=...`` land
    # before the sub-params are made, as the reference's selector
    # overrides do (:1021-1028); a ring or model the port cannot build
    # raises in factory.py
    memory_type = overrides.pop("memory_type", memory_type)
    model_type = overrides.pop("model_type", model_type)
    if "cnn" in model_type:
        env_shape = dict(state_cha=4, state_hei=84, state_wid=84)
        state_dtype = "uint8"
    else:
        # low-dim envs: the env probe gives the width (reference
        # config.py:1030-1037)
        env_shape = dict(state_cha=1, state_hei=1, state_wid=0)
        state_dtype = "float32"
    opt = Options(
        config=config, agent_type=agent_type, env_type=env_type, game=game,
        memory_type=memory_type, model_type=model_type,
        env_params=EnvParams(env_type=env_type, game=game, **env_shape),
        memory_params=MemoryParams(
            memory_type=memory_type, state_dtype=state_dtype,
            # the segment rings' R2D2 priorities (reference :1051-1054)
            **({"priority_exponent": 0.9, "priority_weight": 0.6}
               if memory_type in ("sequence", "device-sequence") else {})),
        model_params=ModelParams(model_type=model_type),
        agent_params=build_agent_params(agent_type),
    )
    for key, val in overrides.items():
        if key in _SELECTORS or key in _SUBS:
            raise ValueError(f"option {key!r} is fixed by the CONFIGS row")
        sub, dot, field_name = key.rpartition(".")
        if dot:
            # ``perf_params.enabled``: the group named, the field its own
            if sub not in _SUBS or not hasattr(getattr(opt, sub),
                                               field_name):
                raise ValueError(f"unknown option: {key}")
            setattr(getattr(opt, sub), field_name, val)
            continue
        # a top-level field wins (``seed`` is mirrored into env_params
        # below); otherwise exactly one sub-dataclass owns the key
        if hasattr(opt, key):
            setattr(opt, key, val)
            continue
        owners = [s for s in _SUBS if hasattr(getattr(opt, s), key)]
        if not owners:
            raise ValueError(f"unknown option: {key}")
        owners += [g for g, names in _UNPORTED_FIELDS.items()
                   if key in names]
        if len(owners) > 1:
            # ``enabled`` is on several planes: a bare override would flip
            # them all (reference :1071-1081)
            raise ValueError(
                f"ambiguous option {key!r}: lives on {', '.join(owners)}; "
                f"name the group ({owners[0]}.{key}=...) or use the "
                f"plane's TPU_APEX_* knob")
        setattr(getattr(opt, owners[0]), key, val)
    opt.env_params.seed = opt.seed
    if opt.mode == 2 and opt.model_file is None:
        # reference config.py:1094-1097: test mode defaults to this run's
        # checkpoint path
        opt.model_file = opt.model_name
    return opt
