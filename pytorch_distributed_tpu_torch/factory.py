"""Builders shared by the port's workers — the port of
pytorch_distributed_tpu/factory.py: the Anakin gates ``anakin_eligible``
and ``anakin_active`` (:108-141), the actor backend's gate
``resolve_actor_backend`` (:144-215), ``build_device_env`` (:216-230),
``needs_inference_server`` (:228-232), the env probe and ``EnvSpec``
(:239), the device-env predicate ``device_backend_active`` (:270-277),
the actors' env vector and the stepper's prebuild (:280-353),
``build_model`` for ``dqn-cnn`` and ``dqn-mlp`` (:400-436), the dqn branch
of ``build_train_state_and_step`` (:636-647), the learner's train apply
gate ``_dqn_train_apply`` (:674-723), ``build_megabatch_train_step``
(:726-771), ``resolve_megabatch`` (:774-791) and ``build_memory`` for the
``shared``, ``native``, ``prioritized``, ``device`` and ``device-per``
rings (:862-940).

The port runs CONFIGS rows 1, 3, 4, 6, 8 and 12 (config.PORTED_CONFIGS):
the pong-sim, fake-chain and cartpole envs, the ``dqn-cnn`` and ``dqn-mlp``
models and those five rings.  Anything else raises
``NotImplementedError`` naming the ROADMAP queue that will bring it.
Where the reference warns and takes the Python ring for a native ring
that cannot be built (:891-905), the port raises with g++'s stderr.
"""

from __future__ import annotations

import warnings
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call, vmap

from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.envs.device_env import (
    TorchOps, device_env_supported,
)
from pytorch_distributed_tpu_torch.envs.device_env import (
    build_device_env as _build_device_env,
)
from pytorch_distributed_tpu_torch.envs.classic import make_classic_env
from pytorch_distributed_tpu_torch.envs.fake_env import FakeChainEnv
from pytorch_distributed_tpu_torch.envs.native_pong import (
    NativePongVectorEnv,
)
from pytorch_distributed_tpu_torch.envs.pong_sim import PongSimEnv
from pytorch_distributed_tpu_torch.envs.vector import VectorEnv
from pytorch_distributed_tpu_torch.memory.device_replay import (
    DevicePerIngest, DeviceReplayIngest,
)
from pytorch_distributed_tpu_torch.memory.feeder import QueueOwner
from pytorch_distributed_tpu_torch.memory.prioritized import (
    PrioritizedReplay,
)
from pytorch_distributed_tpu_torch.memory.shared_replay import SharedReplay
from pytorch_distributed_tpu_torch.models.dqn_cnn import DqnCnnModel
from pytorch_distributed_tpu_torch.models.dqn_mlp import DqnMlpModel
from pytorch_distributed_tpu_torch.ops.cuda_torso import (
    build_torso_apply, build_torso_group_apply,
)
from pytorch_distributed_tpu_torch.ops.losses import (
    TrainState, build_dqn_megabatch_step, build_dqn_train_step,
    init_train_state,
)
from pytorch_distributed_tpu_torch.utils import health
from pytorch_distributed_tpu_torch.utils.native_build import build_library
from pytorch_distributed_tpu_torch.utils.perf import resolve_mxu

ENVS = {"pong-sim": PongSimEnv, "fake": FakeChainEnv,
        "classic": make_classic_env}
MODELS = ("dqn-cnn", "dqn-mlp")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"Queue A)")


ACTOR_BACKENDS = ("pipelined", "inline", "batched", "device", "anakin")


def anakin_eligible(opt: Options) -> Tuple[bool, str]:
    """Whether this config can run the co-located Anakin loop: the dqn
    family, a device env implementation and a device ring for the
    rollout's in-graph writes.  Returns ``(ok, reason)``."""
    if opt.agent_type != "dqn":
        return False, f"agent_type={opt.agent_type} (dqn only)"
    if not device_env_supported(opt.env_params):
        return False, (f"env_type={opt.env_params.env_type!r} has no "
                       f"device env implementation")
    if opt.memory_type not in ("device", "device-per"):
        return False, (f"memory_type={opt.memory_type!r} (the fused "
                       f"rollout writes into a device ring: use 'device' "
                       f"or 'device-per')")
    return True, ""


def anakin_active(opt: Options) -> bool:
    """Whether the run is the co-located Anakin loop: the env fleet in the
    learner's process and no actor workers.  One predicate for the
    topology and the learner."""
    return (opt.env_params.actor_backend == "anakin"
            and anakin_eligible(opt)[0])


def device_backend_active(opt: Options) -> bool:
    """Whether the actor slots run the device env fleet (``device``, or
    ``anakin``'s fleet in the learner): no actor steps the C++ stepper
    then.  Warns about nothing, unlike ``resolve_actor_backend``."""
    return (opt.env_params.actor_backend in ("device", "anakin")
            and opt.agent_type == "dqn"
            and device_env_supported(opt.env_params))


def resolve_actor_backend(opt: Options, inference: Any = None) -> str:
    """The actor schedule a worker runs, from ``actor_backend``: one gate
    for the actor and the topology.  Each backend steps down with a
    warning where the reference's does: ``batched`` without an inference
    client (``inference``) to ``pipelined``; ``anakin`` on a config that
    cannot run it (``anakin_eligible``) to ``device``; ``device`` outside
    the dqn family, or on an env with no device implementation, to
    ``pipelined``."""
    backend = opt.env_params.actor_backend
    if backend not in ACTOR_BACKENDS:
        raise ValueError(f"unknown actor_backend {backend!r} (one of "
                         f"{ACTOR_BACKENDS})")
    if backend == "batched" and inference is None:
        warnings.warn("actor_backend=batched but no InferenceClient was "
                      "wired in (a topology without the server); falling "
                      "back to pipelined", stacklevel=2)
        return "pipelined"
    if backend == "anakin":
        ok, why = anakin_eligible(opt)
        if ok:
            return "anakin"
        warnings.warn(f"actor_backend=anakin is not runnable here ({why}); "
                      f"falling back to the split-process device backend",
                      stacklevel=2)
        backend = "device"
    if backend == "device":
        if opt.agent_type != "dqn":
            warnings.warn(f"actor_backend=device serves the flat dqn "
                          f"family only (got agent_type={opt.agent_type}); "
                          f"falling back to pipelined", stacklevel=2)
            return "pipelined"
        if not device_env_supported(opt.env_params):
            warnings.warn(f"actor_backend=device but env_type="
                          f"{opt.env_params.env_type!r} has no device env "
                          f"implementation (envs/device_env."
                          f"DEVICE_ENV_FAMILIES); falling back to "
                          f"pipelined", stacklevel=2)
            return "pipelined"
    return backend


def build_device_env(opt: Options, process_ind: int, num_envs: int,
                     device="cpu"):
    """The device env fleet of one actor slot on ``device``, on the slot
    contract of ``build_env_vector`` (env j of actor i takes slot
    ``seed + i*N + j``)."""
    return _build_device_env(opt.env_params, process_ind, num_envs,
                             ops=TorchOps(device))


def needs_inference_server(opt: Options) -> bool:
    """Whether a topology stands up the shared inference server for its
    actors (runtime.Topology)."""
    return opt.env_params.actor_backend == "batched"


def resolve_device(opt: Options) -> torch.device:
    """The run's device.  ``cuda`` (the default) needs a visible GPU and
    raises without one: the port never carries on on the CPU unless the
    caller asked for it."""
    dev = torch.device(opt.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no GPU; "
                           "pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {opt.device!r}")
    return dev


def role_seed(seed: int, role: str, index: int = 0) -> int:
    """A distinct, reproducible seed per (run seed, role, worker index)."""
    return (seed * 1_000_003 + zlib.crc32(role.encode()) * 7919
            + index) % (2 ** 63)


def compute_dtype(opt: Options) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[opt.model_params.compute_dtype]


def state_dtype(opt: Options) -> np.dtype:
    """The rings' and the actors' observation type: uint8 frames for the
    pixel rows, float32 for the low-dim ones (config.build_options)."""
    return np.dtype(opt.memory_params.state_dtype)


@dataclass(frozen=True)
class EnvSpec:
    """What the model and the ring need to know about the env."""

    state_shape: Tuple[int, ...]
    num_actions: int
    norm_val: float

    @property
    def action_shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def action_dtype(self):
        return np.int32


def build_env(opt: Options, process_ind: int = 0):
    if opt.env_type not in ENVS:
        raise _not_ported(f"env_type {opt.env_type!r}")
    return ENVS[opt.env_type](opt.env_params, process_ind)


def wants_native_pong(opt: Options) -> bool:
    """One gate for the C++ stepper, shared by ``build_env_vector`` and
    ``prebuild_native`` (reference ``_wants_native_pong`` :280); runs of
    the device env fleet build none."""
    return (opt.env_type == "pong-sim" and opt.env_params.native_env
            and not device_backend_active(opt))


def build_env_vector(opt: Options, process_ind: int, num_envs: int):
    """The actors' N envs as one vector; env j of actor i takes the seed
    slot i*N + j (reference :291-330).  Pong steps through the C++ stepper
    unless ``native_env`` is false; a stepper that cannot be built raises
    (``NativeBuildError``), where the reference warns and takes the numpy
    simulators."""
    if wants_native_pong(opt):
        return NativePongVectorEnv(opt.env_params, process_ind, num_envs)
    return VectorEnv([build_env(opt, process_ind * num_envs + j)
                      for j in range(num_envs)])


def prebuild_native(opt: Options) -> None:
    """Build the stepper's library once, before any worker starts, so N
    actors do not race one g++ (reference :333-353); raises if it cannot
    be built."""
    if wants_native_pong(opt):
        build_library("pong_batch", timeout=600.0)


def probe_env(opt: Options) -> EnvSpec:
    env = build_env(opt, process_ind=0)
    return EnvSpec(state_shape=tuple(env.state_shape),
                   num_actions=env.action_space.n,
                   norm_val=float(env.norm_val))


def build_model(opt: Options, spec: EnvSpec, device=None,
                generator: Optional[torch.Generator] = None,
                init_weights: bool = True) -> torch.nn.Module:
    """The configured model on ``device``, initialised from
    ``generator``.  ``init_weights=False`` skips the orthogonal init (a QR
    per layer, seconds on a busy host) for a caller that wants only the
    forward's structure and brings its own weights."""
    if opt.model_type not in MODELS:
        raise _not_ported(f"model_type {opt.model_type!r}")
    ortho = init_weights and opt.model_params.orthogonal_init
    if opt.model_type == "dqn-mlp":
        model = DqnMlpModel(spec.num_actions,
                            int(np.prod(spec.state_shape)),
                            hidden_dim=opt.model_params.hidden_dim,
                            norm_val=spec.norm_val, orthogonal_init=ortho,
                            generator=generator)
    else:
        model = DqnCnnModel(spec.num_actions, spec.state_shape,
                            norm_val=spec.norm_val, orthogonal_init=ortho,
                            compute_dtype=compute_dtype(opt),
                            generator=generator)
    return model.to(device) if device is not None else model


def init_params(opt: Options, spec: EnvSpec, seed: int,
                device=None) -> Dict[str, torch.Tensor]:
    """A fresh parameter dict (the model's state_dict) from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    model = build_model(opt, spec, generator=gen)
    return {k: v.to(device) if device is not None else v
            for k, v in model.state_dict().items()}


def module_apply(model: torch.nn.Module) -> Callable:
    """``apply(params, obs) -> q`` through the module's own forward."""
    return lambda params, obs: functional_call(model, params, (obs,))


def module_group_apply(model: torch.nn.Module) -> Callable:
    """``group_apply(stacked, obs (M, B, ...)) -> q (M, B, A)`` through the
    module's own forward, row group m on ``stacked[k][m]``: one forward
    over the M*B rows, batched over the M weight copies by
    ``torch.func.vmap`` (a grouped convolution for the dqn-cnn's layers, a
    batched product for the linear ones)."""
    return vmap(module_apply(model))


def _kernel_torso(opt: Options) -> bool:
    """Whether the learner runs the dqn-cnn torso through the GEMM kernel:
    ``pallas_torso`` (or ``TPU_APEX_MXU_PALLAS_TORSO``) on a dqn-cnn
    model; on another model it warns and keeps the module's forward, as
    the reference does (:693-699)."""
    if not resolve_mxu(opt.learner_perf_params).pallas_torso:
        return False
    if opt.model_type != "dqn-cnn":
        warnings.warn(f"pallas_torso=true serves the dqn-cnn torso only "
                      f"(got model_type={opt.model_type}); keeping the "
                      f"module's forward", stacklevel=3)
        return False
    return True


def dqn_train_apply(opt: Options, model: torch.nn.Module) -> Callable:
    """The learner's train apply: the module's forward, or — with
    ``learner_perf_params.pallas_torso`` on and the ``dqn-cnn`` model —
    the torso through the GEMM kernel (ops/cuda_torso.py).  One gate for
    the sequential and the megabatch steps, so both train through the
    same torso.  Actors never route through this; the parameters are the
    same either way."""
    if _kernel_torso(opt):
        return build_torso_apply(model.norm_val, model.compute_dtype)
    return module_apply(model)


def dqn_group_apply(opt: Options, model: torch.nn.Module) -> Callable:
    """The megabatch group's online forward, through the same torso as
    ``dqn_train_apply``: the GEMM kernel's group products
    (``build_torso_group_apply``) or the module's forward
    (``module_group_apply``)."""
    if _kernel_torso(opt):
        return build_torso_group_apply(model.norm_val, model.compute_dtype)
    return module_group_apply(model)


def build_train_state_and_step(opt: Options, model: torch.nn.Module,
                               params: Dict[str, torch.Tensor]
                               ) -> Tuple[TrainState, Callable]:
    if opt.agent_type != "dqn":
        raise _not_ported(f"agent_type {opt.agent_type!r}")
    ap = opt.agent_params
    state = init_train_state(params)
    step = build_dqn_train_step(
        dqn_train_apply(opt, model), lr=ap.lr, clip_grad=ap.clip_grad,
        enable_double=ap.enable_double,
        target_model_update=ap.target_model_update,
        guard=opt.health_params.numeric_guards)
    return state, step


def build_megabatch_train_step(opt: Options, model: torch.nn.Module
                               ) -> Optional[Callable]:
    """The megabatch twin of ``build_train_state_and_step``'s step:
    ``(state, batches (M, B)) -> (state', metrics, td_abs (M, B), ok
    (M,))``, with the optimizer and the train apply built as the
    sequential step's, so the state the sequential path made (or a
    checkpoint) serves it as it is.  None for a family without a group
    step (DDPG's waits for its slice): the caller runs the sequential
    step and says so."""
    if opt.agent_type != "dqn":
        return None
    ap = opt.agent_params
    return build_dqn_megabatch_step(
        dqn_train_apply(opt, model), dqn_group_apply(opt, model), lr=ap.lr,
        clip_grad=ap.clip_grad, enable_double=ap.enable_double,
        target_model_update=ap.target_model_update,
        guard=health.resolve(opt.health_params).numeric_guards)


def resolve_megabatch(opt: Options, steps_per_call: int) -> Tuple[int, int]:
    """``(M, K)``: the megabatch factor (at least 1) and the dispatch's
    sub-steps, rounded up to a multiple of M (an overshoot of the steps
    budget by part of a dispatch is tolerated; dropping updates is not).
    One resolution for the learner and the Anakin driver."""
    M = max(1, int(resolve_mxu(opt.learner_perf_params).megabatch))
    K = max(1, int(steps_per_call))
    if M > 1 and K % M:
        K = ((K + M - 1) // M) * M
        print(f"[learner] steps_per_dispatch rounded up to {K} "
              f"(multiple of megabatch {M})", flush=True)
    return M, K


def resolve_fused_step(opt: Options, model: torch.nn.Module, role: str
                       ) -> Tuple[int, int, Optional[Callable]]:
    """``(M, K, megabatch_step)`` of a learner's fused dispatch, as the
    reference's learner (agents/learner.py:318-345) and Anakin driver
    (agents/anakin.py:255-275) resolve them: K from
    ``steps_per_dispatch``, rounded up to a multiple of M only when a
    group step exists; a family without one runs the sequential step at
    the configured K, with the reference's line.  ``role`` prefixes the
    line."""
    K = max(1, opt.agent_params.steps_per_dispatch)
    M, K_mb = resolve_megabatch(opt, K)
    if M == 1:
        return 1, K, None
    step = build_megabatch_train_step(opt, model)
    if step is None:
        print(f"[{role}] megabatch={M} is not supported for agent_type="
              f"{opt.agent_type} (dqn/decoupled-ddpg only); running the "
              f"sequential fused step at steps_per_dispatch={K}",
              flush=True)
        return 1, K, None
    return M, K_mb, step


@dataclass
class MemoryHandles:
    """``actor_side`` is what actors feed; ``learner_side`` what the
    learner attaches, drains and samples."""

    actor_side: Any
    learner_side: Any


def build_memory(opt: Options, spec: EnvSpec,
                 in_process: bool = False) -> MemoryHandles:
    """The run's ring and its ingest (reference :862-940):

    - ``shared`` and ``native``: a host ring in process-shared pages that
      every actor writes in place (``SharedReplay``; ``NativeRingReplay``
      over ``native/ring_buffer.cpp``, which raises when g++ cannot build
      it);
    - ``prioritized``: the learner's host PER ring behind ``QueueOwner``;
    - ``device`` and ``device-per``: the device rings behind their ingest,
      with one queue per actor slot (``learner_side.make_feeder(i)``) or
      one in-process queue when every producer is a thread of the
      learner's process (``in_process``, the thread backend).

    ``actor_side`` is slot 0's feeder; the runtime asks ``learner_side``
    for each slot's."""
    mp_ = opt.memory_params
    hp = health.resolve(opt.health_params)
    sdt = state_dtype(opt)
    rows = dict(capacity=mp_.memory_size, state_shape=spec.state_shape,
                action_shape=spec.action_shape, state_dtype=sdt,
                action_dtype=spec.action_dtype)
    queues = dict(in_process=in_process, slots=max(1, opt.num_actors),
                  quarantine=hp.quarantine,
                  quarantine_max_files=hp.quarantine_max_files)
    per = dict(priority_exponent=mp_.priority_exponent,
               importance_weight=mp_.priority_weight,
               importance_anneal_steps=opt.agent_params.steps)
    if opt.memory_type in ("shared", "native"):
        if opt.memory_type == "native":
            from pytorch_distributed_tpu_torch.memory.native_ring import (
                NativeRingReplay,
            )

            mem = NativeRingReplay(**rows)
        else:
            mem = SharedReplay(**rows)
        return MemoryHandles(actor_side=mem.make_feeder(), learner_side=mem)
    if opt.memory_type == "prioritized":
        owner = QueueOwner(PrioritizedReplay(**rows, **per), **queues)
        return MemoryHandles(actor_side=owner.make_feeder(),
                             learner_side=owner)
    if opt.memory_type not in ("device", "device-per"):
        raise _not_ported(f"memory_type {opt.memory_type!r}")
    if opt.memory_type == "device":
        ingest = DeviceReplayIngest(**rows, **queues)
    else:
        ingest = DevicePerIngest(**rows, **queues, **per)
    return MemoryHandles(actor_side=ingest.make_feeder(), learner_side=ingest)
