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
PORTED_CONFIGS = (1, 3, 4, 6, 8, 12)


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


@dataclass
class AgentParams:
    agent_type: str = "dqn"
    steps: int = 500000
    max_seconds: float = 0.0
    gamma: float = 0.99
    clip_grad: float = float("inf")
    lr: float = 1e-4
    actor_sync_freq: int = 100
    # logger cadences (reference config.py:315-322)
    logger_freq: int = 15              # secs
    actor_freq: int = 250
    learner_freq: int = 100
    evaluator_freq: int = 30           # secs
    evaluator_nepisodes: int = 2
    tester_nepisodes: int = 50
    param_publish_freq: int = 10
    # learner steps between checkpoint epochs; 0: the final epoch only
    checkpoint_freq: int = 0
    # committed epochs kept on disk (utils/checkpoint.py gc_epochs)
    checkpoint_retain: int = 3
    learn_start: int = 5000
    batch_size: int = 128
    max_replay_ratio: float = 0.0
    # 0 = auto: 1 sub-step per dispatch.  On the GPU a dispatch is one
    # CUDA-graph replay; 32 per dispatch measured slower end to end in the
    # thread backend (PERF.md)
    steps_per_dispatch: int = 0
    target_model_update: float = 250
    nstep: int = 5
    enable_double: bool = False
    eps: float = 0.4
    eps_alpha: float = 7.0


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


_SUBS = ("env_params", "memory_params", "model_params", "agent_params",
         "health_params", "learner_perf_params", "anakin_params")
# the CONFIGS columns a run may not override; ``memory_type`` may
# (``--set memory_type=native``)
_SELECTORS = ("agent_type", "env_type", "game", "model_type")


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
    learner_perf_params: LearnerPerfParams = field(
        default_factory=LearnerPerfParams)
    anakin_params: AnakinParams = field(default_factory=AnakinParams)

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
    # ``--set memory_type=native`` lands before the sub-params are made,
    # as the reference's selector overrides do (:1021-1028); a ring the
    # port cannot build raises in factory.py
    memory_type = overrides.pop("memory_type", memory_type)
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
        memory_params=MemoryParams(memory_type=memory_type,
                                   state_dtype=state_dtype),
        model_params=ModelParams(model_type=model_type),
        agent_params=AgentParams(agent_type=agent_type),
    )
    for key, val in overrides.items():
        if key in _SELECTORS or key in _SUBS:
            raise ValueError(f"option {key!r} is fixed by the CONFIGS row")
        # a top-level field wins (``seed`` is mirrored into env_params
        # below); otherwise exactly one sub-dataclass owns the key
        owner = opt if hasattr(opt, key) else next(
            (getattr(opt, s) for s in _SUBS
             if hasattr(getattr(opt, s), key)), None)
        if owner is None:
            raise ValueError(f"unknown option: {key}")
        setattr(owner, key, val)
    opt.env_params.seed = opt.seed
    if opt.mode == 2 and opt.model_file is None:
        # reference config.py:1094-1097: test mode defaults to this run's
        # checkpoint path
        opt.model_file = opt.model_name
    return opt
