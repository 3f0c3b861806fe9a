"""Builders shared by the port's workers — the port of
pytorch_distributed_tpu/factory.py: the Anakin gates ``anakin_eligible``
and ``anakin_active`` (:108-141), the actor backend's gate
``resolve_actor_backend`` (:144-215), ``build_device_env`` (:216-230),
``needs_inference_server`` (:228-232), the env probe and ``EnvSpec``
(:239-258) with continuous actions, the gym entry of the env table
(:35-46), the device-env predicate ``device_backend_active`` (:270-277),
the actors' env vector and the stepper's prebuild (:280-353),
``sequence_pack_frames`` and ``lstm_dim_of`` (:373-397), ``build_model``
for ``dqn-cnn``, ``dqn-cnn-wide``, ``dqn-mlp``, ``ddpg-mlp``, ``drqn-mlp``,
``drqn-cnn`` and the three ``dtqn-*`` families (:400-485), ``ddpg_applies``
(:506-510), the r2d2 (:536-633, on one device: no mesh), dqn and ddpg
branches of
``build_train_state_and_step`` (:636-669), the learner's
train apply gate ``_dqn_train_apply`` (:674-723),
``build_megabatch_train_step`` (:726-771), ``resolve_megabatch``
(:774-791), the replica plane's ``build_replica_grad_apply`` and
``replica_active`` (:793-828), ``published_params`` (:830-839) and ``build_memory`` for the
``shared``, ``native``, ``prioritized``, ``device``, ``device-per``,
``sequence`` and ``device-sequence`` rings (:862-997).  ``update_flops`` and ``frame_flops`` are the FLOP
counts the perf plane's MFU divides by (utils/perf.py), where the
reference reads its compiled programs' cost analysis.

The port runs CONFIGS rows 1-4, 6, 8-10 and 12-19
(config.PORTED_CONFIGS): the pong-sim, fake-chain, classic (cartpole,
pendulum, reacher) and gym envs, the ``dqn-cnn``, ``dqn-cnn-wide``,
``dqn-mlp``, ``ddpg-mlp``, ``drqn-mlp``, ``drqn-cnn``, ``dtqn-mlp``,
``dtqn-moe`` and ``dtqn-pipe`` models and those seven rings.  The r2d2
family has no megabatch group step and no shared inference server, as
the reference's (:165-171, :736-741).  Row 19's wide torso trains
through the module's own forward, as every model but ``dqn-cnn`` does
(``_kernel_torso``).  Anything else raises
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
from pytorch_distributed_tpu_torch.envs.base import DiscreteSpace
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
from pytorch_distributed_tpu_torch.memory.device_sequence import (
    DeviceSequenceIngest,
)
from pytorch_distributed_tpu_torch.memory.sequence_replay import (
    SegmentBatch, SequenceReplay,
)
from pytorch_distributed_tpu_torch.memory.feeder import QueueOwner
from pytorch_distributed_tpu_torch.memory.prioritized import (
    PrioritizedReplay,
)
from pytorch_distributed_tpu_torch.memory.shared_replay import SharedReplay
from pytorch_distributed_tpu_torch.models.dqn_cnn import DqnCnnModel
from pytorch_distributed_tpu_torch.models.dqn_cnn_wide import DqnCnnWideModel
from pytorch_distributed_tpu_torch.models.ddpg_mlp import (
    DdpgMlpModel, actor_apply, critic_apply,
)
from pytorch_distributed_tpu_torch.models.dqn_mlp import DqnMlpModel
from pytorch_distributed_tpu_torch.models.drqn import (
    DrqnCnnModel, DrqnMlpModel,
)
from pytorch_distributed_tpu_torch.models.dtqn import DtqnMlpModel
from pytorch_distributed_tpu_torch.models.dtqn_pipeline import (
    DtqnPipelineModel,
)
from pytorch_distributed_tpu_torch.models.moe import DtqnMoeModel
from pytorch_distributed_tpu_torch.ops.cuda_torso import (
    build_torso_apply, build_torso_group_apply,
)
from pytorch_distributed_tpu_torch.ops.losses import (
    TrainState, build_ddpg_megabatch_step, build_ddpg_train_step,
    build_ddpg_train_step_coupled, build_dqn_grad_and_apply,
    build_dqn_megabatch_step, build_dqn_train_step, init_ddpg_train_state, init_train_state,
    make_optimizer, merge_ddpg_params,
)
from pytorch_distributed_tpu_torch.ops.sequence_losses import (
    build_drqn_train_step, build_dtqn_train_step,
)
from pytorch_distributed_tpu_torch.utils import health
from pytorch_distributed_tpu_torch.utils.native_build import build_library
from pytorch_distributed_tpu_torch.utils.experience import Batch
from pytorch_distributed_tpu_torch.utils.perf import flops_of, resolve_mxu

def _gym_env(env_params, process_ind: int = 0):
    # gymnasium is imported when a gym env is made, never before
    from pytorch_distributed_tpu_torch.envs.gym_adapter import GymEnv

    return GymEnv(env_params, process_ind)


ENVS = {"pong-sim": PongSimEnv, "fake": FakeChainEnv,
        "classic": make_classic_env, "gym": _gym_env}
MODELS = ("dqn-cnn", "dqn-cnn-wide", "dqn-mlp", "ddpg-mlp", "drqn-mlp",
          "drqn-cnn", "dtqn-mlp", "dtqn-moe", "dtqn-pipe")
# the transformer families (reference :447-475)
DTQN_MODELS = {"dtqn-mlp": DtqnMlpModel, "dtqn-moe": DtqnMoeModel,
               "dtqn-pipe": DtqnPipelineModel}


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
    warning where the reference's does: ``batched`` outside the dqn and
    ddpg families (an r2d2 actor keeps its envs' recurrent state) or
    without an inference client (``inference``) to ``pipelined``;
    ``anakin`` on a config that
    cannot run it (``anakin_eligible``) to ``device``; ``device`` outside
    the dqn family, or on an env with no device implementation, to
    ``pipelined``.  A remote actor host (fleet.py) has no server, so its
    ``batched`` steps down to ``pipelined``; under an ``anakin`` learner
    its actors run ``device`` (agents/actor.py)."""
    backend = opt.env_params.actor_backend
    if backend not in ACTOR_BACKENDS:
        raise ValueError(f"unknown actor_backend {backend!r} (one of "
                         f"{ACTOR_BACKENDS})")
    if backend == "batched" and opt.agent_type not in ("dqn", "ddpg"):
        warnings.warn(f"actor_backend=batched does not serve agent_type="
                      f"{opt.agent_type} (per-env recurrent state stays "
                      f"actor-side); falling back to pipelined",
                      stacklevel=2)
        return "pipelined"
    if backend == "batched" and inference is None:
        warnings.warn("actor_backend=batched but no InferenceClient was "
                      "wired in (remote actor host, or a topology without "
                      "the server); falling back to pipelined", stacklevel=2)
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
    actors (runtime.Topology): ``batched`` in the dqn and ddpg families
    (reference :228-232)."""
    return (opt.env_params.actor_backend == "batched"
            and opt.agent_type in ("dqn", "ddpg"))


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
    """The dtype the model computes in: ``compute_dtype`` for the dqn-cnn
    torsos; the DDPG MLP computes in fp32 whatever it says, as the
    reference's (its ``Dense`` layers take no compute dtype), so its MFU
    divides by the fp32 peak; so do the DRQN MLP and the transformer
    families (flax ``Dense`` and einsums in fp32).  The DRQN CNN's torso
    computes in ``compute_dtype``, its LSTM in fp32."""
    if opt.model_type in ("ddpg-mlp", "drqn-mlp", *DTQN_MODELS):
        return torch.float32
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[opt.model_params.compute_dtype]


def state_dtype(opt: Options) -> np.dtype:
    """The rings' and the actors' observation type: uint8 frames for the
    pixel rows, float32 for the low-dim ones (config.build_options)."""
    return np.dtype(opt.memory_params.state_dtype)


@dataclass(frozen=True)
class EnvSpec:
    """What the model and the ring need to know about the env: a discrete
    env's ``num_actions``, or a continuous one's ``action_dim`` (actions
    of shape (d,), float32, in [-1, 1])."""

    state_shape: Tuple[int, ...]
    num_actions: int
    norm_val: float
    discrete: bool = True
    action_dim: int = 0

    @property
    def action_shape(self) -> Tuple[int, ...]:
        return () if self.discrete else (self.action_dim,)

    @property
    def action_dtype(self):
        return np.int32 if self.discrete else np.float32


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
    space = env.action_space
    if isinstance(space, DiscreteSpace):
        return EnvSpec(state_shape=tuple(env.state_shape),
                       num_actions=space.n, norm_val=float(env.norm_val))
    return EnvSpec(state_shape=tuple(env.state_shape), num_actions=0,
                   norm_val=float(env.norm_val), discrete=False,
                   action_dim=space.dim)


def sequence_pack_frames(opt: Options) -> int:
    """The frame-pack factor C of the segment rings (0: unpacked): the
    pixel R2D2 row's C-stacked uint8 segments travel and lie in the ring
    as their (T+C, H, W) frames, and the learner rebuilds the stacks.  One
    decision for the actors' builders, the ring and the learner's step
    (reference :373-387)."""
    if (opt.memory_type in ("sequence", "device-sequence")
            and opt.model_type == "drqn-cnn"
            and opt.memory_params.state_dtype == "uint8"):
        return opt.env_params.state_cha
    return 0


def segment_capacity(opt: Options) -> int:
    """A segment ring's rows: ``memory_size`` steps of history in windows
    that advance by ``seq_len - seq_overlap``, at least 16 (reference
    :957-960)."""
    ap = opt.agent_params
    return max(opt.memory_params.memory_size
               // max(ap.seq_len - ap.seq_overlap, 1), 16)


def lstm_dim_of(opt: Options) -> int:
    """The stored carry's width: ``lstm_dim``, floored at 512 for the CNN
    (its torso's output width), and 1 for a transformer, whose segments
    store a placeholder (reference :390-397)."""
    if opt.model_type in DTQN_MODELS:
        return 1
    d = opt.model_params.lstm_dim
    return max(d, 512) if opt.model_type == "drqn-cnn" else d


def build_model(opt: Options, spec: EnvSpec, device=None,
                generator: Optional[torch.Generator] = None,
                init_weights: bool = True) -> torch.nn.Module:
    """The configured model on ``device``, initialised from
    ``generator``.  ``init_weights=False`` skips the init (the orthogonal
    one is a QR per layer, seconds on a busy host) for a caller that wants
    only the forward's structure and brings its own weights."""
    if opt.model_type not in MODELS:
        raise _not_ported(f"model_type {opt.model_type!r}")
    ortho = init_weights and opt.model_params.orthogonal_init
    if opt.model_type == "ddpg-mlp":
        if spec.discrete:
            raise ValueError("ddpg-mlp needs a continuous action space")
        model = DdpgMlpModel(spec.action_dim, int(np.prod(spec.state_shape)),
                             norm_val=spec.norm_val, generator=generator,
                             init_weights=init_weights)
    elif opt.model_type == "drqn-mlp":
        model = DrqnMlpModel(spec.num_actions,
                             int(np.prod(spec.state_shape)),
                             hidden_dim=opt.model_params.hidden_dim,
                             lstm_dim=lstm_dim_of(opt),
                             norm_val=spec.norm_val, generator=generator,
                             init_weights=init_weights)
    elif opt.model_type in DTQN_MODELS:
        mp_ = opt.model_params
        kw = dict(window=opt.agent_params.seq_len + 1, dim=mp_.tf_dim,
                  heads=mp_.tf_heads, depth=mp_.tf_depth,
                  norm_val=spec.norm_val, generator=generator,
                  init_weights=init_weights)
        if opt.model_type == "dtqn-moe":
            kw.update(num_experts=mp_.moe_experts, top_k=mp_.moe_top_k,
                      capacity_factor=mp_.moe_capacity_factor)
        # the acting window and the learner's T+1-long segments share one
        # positional table
        model = DTQN_MODELS[opt.model_type](spec.num_actions,
                                            spec.state_shape, **kw)
    elif opt.model_type == "drqn-cnn":
        model = DrqnCnnModel(spec.num_actions, spec.state_shape,
                             lstm_dim=lstm_dim_of(opt),
                             norm_val=spec.norm_val,
                             compute_dtype=compute_dtype(opt),
                             generator=generator, init_weights=init_weights)
    elif opt.model_type == "dqn-mlp":
        model = DqnMlpModel(spec.num_actions,
                            int(np.prod(spec.state_shape)),
                            hidden_dim=opt.model_params.hidden_dim,
                            norm_val=spec.norm_val, orthogonal_init=ortho,
                            generator=generator)
    elif opt.model_type == "dqn-cnn-wide":
        model = DqnCnnWideModel(spec.num_actions, spec.state_shape,
                                norm_val=spec.norm_val,
                                width=opt.model_params.cnn_wide_width,
                                orthogonal_init=ortho,
                                compute_dtype=compute_dtype(opt),
                                generator=generator)
    else:
        model = DqnCnnModel(spec.num_actions, spec.state_shape,
                            norm_val=spec.norm_val, orthogonal_init=ortho,
                            compute_dtype=compute_dtype(opt),
                            generator=generator)
    return model.to(device) if device is not None else model


def init_params(opt: Options, spec: EnvSpec, seed: int,
                device=None) -> Dict[str, torch.Tensor]:
    """A fresh parameter dict (the model's state_dict) from ``seed``, on one
    CPU thread: the orthogonal init's QR gives other bits on another
    thread count, and learner replicas in processes of different thread
    counts must start from the same params."""
    gen = torch.Generator().manual_seed(seed)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = build_model(opt, spec, generator=gen)
    finally:
        torch.set_num_threads(threads)
    return {k: v.to(device) if device is not None else v
            for k, v in model.state_dict().items()}


def is_recurrent(model: torch.nn.Module) -> bool:
    """A model with a carry: the DRQN and the DTQN families."""
    return isinstance(model, (DrqnMlpModel, DrqnCnnModel, DtqnMlpModel))


def module_apply(model: torch.nn.Module) -> Callable:
    """``apply(params, obs) -> q`` through the module's own forward; for
    the DDPG model the policy's deterministic forward, ``actor_apply``;
    for a recurrent model one step, ``apply(params, obs, carry=None) ->
    (q, carry')``."""
    if isinstance(model, DdpgMlpModel):
        return ddpg_applies(model)[0]
    if is_recurrent(model):
        return lambda params, obs, carry=None: model.step(params, obs, carry)
    return lambda params, obs: functional_call(model, params, (obs,))


def ddpg_applies(model: DdpgMlpModel) -> Tuple[Callable, Callable]:
    """``(actor_fn(params, obs), critic_fn(params, obs, a))`` over the
    state-dict keys of ``model``'s nets, at its ``norm_val``."""
    nv = model.norm_val
    return (lambda p, o: actor_apply(p, o, nv),
            lambda p, o, a: critic_apply(p, o, a, nv))


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


def make_optimizers(opt: Options):
    """The run's optimizers, as the reference's factory makes them
    (:546-549, :636-669): one for the dqn and r2d2 families (with
    ``weight_decay``) and for
    coupled DDPG, ``(actor_tx, critic_tx)`` for decoupled DDPG (neither
    with weight decay); ``lr_decay`` anneals each over ``steps``."""
    ap = opt.agent_params
    decay = ap.steps if ap.lr_decay else 0
    if opt.agent_type in ("dqn", "r2d2"):
        return make_optimizer(ap.lr, ap.clip_grad, ap.weight_decay, decay)
    actor_tx = make_optimizer(ap.lr, ap.clip_grad, lr_decay_steps=decay)
    if ap.ddpg_coupled_update:
        return actor_tx
    return actor_tx, make_optimizer(ap.critic_lr, ap.clip_grad,
                                    lr_decay_steps=decay)


def build_train_state_and_step(opt: Options, model: torch.nn.Module,
                               params: Dict[str, torch.Tensor]
                               ) -> Tuple[TrainState, Callable]:
    if opt.agent_type not in ("dqn", "ddpg", "r2d2"):
        raise _not_ported(f"agent_type {opt.agent_type!r}")
    ap = opt.agent_params
    guard = health.resolve(opt.health_params).numeric_guards
    if opt.agent_type == "r2d2":
        if not is_recurrent(model):
            raise _not_ported(f"model_type {opt.model_type!r}")
        seq = dict(nstep=ap.nstep, gamma=ap.gamma,
                   enable_double=ap.enable_double,
                   target_model_update=ap.target_model_update,
                   rescale_values=ap.value_rescale,
                   priority_eta=ap.priority_eta, guard=guard)
        if isinstance(model, DtqnMlpModel):
            # burn-in refreshes a stale recurrent state, which a
            # transformer has not: every window position trains
            # (reference :561-570)
            if isinstance(model, DtqnMoeModel):
                # the (q, aux) apply; the frozen target pass is q only
                # (reference :613-624)
                step = build_dtqn_train_step(
                    model.window_q_with_aux, make_optimizers(opt),
                    burn_in=0, aux_weight=opt.model_params.moe_aux_weight,
                    target_window_apply=model.window_q, **seq)
            else:
                step = build_dtqn_train_step(
                    model.window_q, make_optimizers(opt), burn_in=0, **seq)
            return init_train_state(params), step
        if ap.burn_in >= ap.seq_len:
            raise ValueError(f"burn_in={ap.burn_in} must leave a train "
                             f"window inside seq_len={ap.seq_len} (did a "
                             f"--set seq_len override forget burn_in?)")
        step = build_drqn_train_step(
            model, make_optimizers(opt), burn_in=ap.burn_in,
            packed_frames=sequence_pack_frames(opt), **seq)
        return init_train_state(params), step
    if opt.agent_type == "dqn":
        step = build_dqn_train_step(
            dqn_train_apply(opt, model), make_optimizers(opt),
            enable_double=ap.enable_double,
            target_model_update=ap.target_model_update, guard=guard)
        return init_train_state(params), step
    actor_fn, critic_fn = ddpg_applies(model)
    if ap.ddpg_coupled_update:
        step = build_ddpg_train_step_coupled(
            actor_fn, critic_fn, make_optimizers(opt),
            target_model_update=ap.target_model_update, guard=guard)
        return init_train_state(params), step
    step = build_ddpg_train_step(
        actor_fn, critic_fn, *make_optimizers(opt),
        target_model_update=ap.target_model_update, guard=guard)
    return init_ddpg_train_state(params), step


def build_replica_grad_apply(opt: Options, model: torch.nn.Module
                             ) -> Optional[Tuple[Callable, Callable]]:
    """The dqn update cut at the gradient for the replica plane
    (``ops/losses.build_dqn_grad_and_apply``; reference :793-818), on the
    train apply and optimizer ``build_train_state_and_step`` builds, so a
    replica's train state is a solo learner's and the other way round.
    None for a family the plane does not serve."""
    if opt.agent_type != "dqn":
        return None
    ap = opt.agent_params
    return build_dqn_grad_and_apply(
        dqn_train_apply(opt, model), make_optimizers(opt),
        enable_double=ap.enable_double,
        target_model_update=ap.target_model_update)


def replica_active(opt: Options) -> bool:
    """Is the replica plane on (reference :821-828)?  One resolution,
    with the ``TPU_APEX_REPLICA_*`` knobs, for the runtime, the learner's
    delegation and the fleet."""
    from pytorch_distributed_tpu_torch.parallel.dcn import resolve_replica

    return resolve_replica(opt.replica_params).replicas > 1


def published_params(opt: Options, state: TrainState
                     ) -> Dict[str, torch.Tensor]:
    """The params the learner publishes and checkpoints: the model's whole
    state dict (merged back from the decoupled DDPG state's split)."""
    if opt.agent_type == "ddpg" and not opt.agent_params.ddpg_coupled_update:
        return merge_ddpg_params(state.params["actor"],
                                 state.params["critic"])
    return state.params


def _fake_model_params(opt: Options, spec: EnvSpec, mode) -> tuple:
    """The model's structure and its state dict as fake tensors of
    ``mode``."""
    model = build_model(opt, spec, init_weights=False)
    return model, {k: mode.from_tensor(v)
                   for k, v in model.state_dict().items()}


def update_flops(opt: Options, spec: EnvSpec) -> float:
    """The FLOPs of one update of the run's train step at its batch size
    (``utils/perf.flops_of``: the products and convolutions, forward and
    backward), counted on fake tensors: nothing is computed, and the
    tensors lie on the CPU, so the kernel torso's wrappers take their plain
    versions, which run the same products through aten (the CUDA kernels
    are ctypes launches the counter cannot see).  A megabatch group step
    does the same work an update as the sequential step counted here.  The
    r2d2 step counts on a ``SegmentBatch`` of ``batch_size`` segments of
    ``seq_len`` steps (frame-packed where the ring packs them)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    B = opt.agent_params.batch_size
    obs = torch.from_numpy(np.zeros(0, dtype=state_dtype(opt))).dtype
    act = torch.from_numpy(np.zeros(0, dtype=spec.action_dtype)).dtype
    with FakeTensorMode() as mode:
        model, params = _fake_model_params(opt, spec, mode)
        state, step = build_train_state_and_step(opt, model, params)
        if opt.agent_type == "r2d2":
            return flops_of(step, state, _fake_segments(opt, spec, obs))
        batch = Batch(
            state0=torch.zeros((B, *spec.state_shape), dtype=obs),
            action=torch.zeros((B, *spec.action_shape), dtype=act),
            reward=torch.zeros(B), gamma_n=torch.zeros(B),
            state1=torch.zeros((B, *spec.state_shape), dtype=obs),
            terminal1=torch.zeros(B), weight=torch.ones(B),
            index=torch.zeros(B, dtype=torch.int64))
        return flops_of(step, state, batch)


def _fake_segments(opt: Options, spec: EnvSpec, obs_dtype) -> SegmentBatch:
    """A ``SegmentBatch`` of zeros at the run's geometry (under a fake
    tensor mode: nothing is allocated)."""
    ap = opt.agent_params
    B, T, C = ap.batch_size, ap.seq_len, sequence_pack_frames(opt)
    S = spec.state_shape
    obs_shape = (B, T + C, *S[1:]) if C else (B, T + 1, *S)
    carry = torch.zeros((B, lstm_dim_of(opt)))
    return SegmentBatch(
        obs=torch.zeros(obs_shape, dtype=obs_dtype),
        action=torch.zeros((B, T), dtype=torch.int32),
        reward=torch.zeros((B, T)), terminal=torch.zeros((B, T)),
        mask=torch.ones((B, T)), c0=carry, h0=carry.clone(),
        weight=torch.ones(B), index=torch.zeros(B, dtype=torch.int64))


def frame_flops(opt: Options, spec: EnvSpec) -> float:
    """The FLOPs of the acting forward for one env frame (the module's
    forward at batch 1; DDPG's policy forward), counted on fake tensors as
    ``update_flops``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    obs = torch.from_numpy(np.zeros(0, dtype=state_dtype(opt))).dtype
    with FakeTensorMode() as mode, torch.no_grad():
        model, params = _fake_model_params(opt, spec, mode)
        return flops_of(module_apply(model), params,
                        torch.zeros((1, *spec.state_shape), dtype=obs))


def build_megabatch_train_step(opt: Options, model: torch.nn.Module
                               ) -> Optional[Callable]:
    """The megabatch twin of ``build_train_state_and_step``'s step:
    ``(state, batches (M, B)) -> (state', metrics, td_abs (M, B), ok
    (M,))``, with the optimizers and the train apply built as the
    sequential step's, so the state the sequential path made (or a
    checkpoint) serves it as it is.  None for coupled DDPG, which has no
    group step (reference :726-771): the caller runs the sequential step
    and says so."""
    ap = opt.agent_params
    guard = health.resolve(opt.health_params).numeric_guards
    if opt.agent_type == "dqn":
        return build_dqn_megabatch_step(
            dqn_train_apply(opt, model), dqn_group_apply(opt, model),
            make_optimizers(opt), enable_double=ap.enable_double,
            target_model_update=ap.target_model_update, guard=guard)
    if opt.agent_type == "ddpg" and not ap.ddpg_coupled_update:
        return build_ddpg_megabatch_step(
            *ddpg_applies(model), *make_optimizers(opt),
            target_model_update=ap.target_model_update, guard=guard)
    return None


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
      learner's process (``in_process``, the thread backend);
    - ``sequence`` and ``device-sequence``: the host segment ring behind
      ``QueueOwner`` and the device segment ring behind its ingest, each
      of ``segment_capacity`` rows (reference :951-997).

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
    if opt.memory_type in ("sequence", "device-sequence"):
        ap = opt.agent_params
        seqs = dict(
            capacity=segment_capacity(opt), seq_len=ap.seq_len, state_shape=spec.state_shape,
            lstm_dim=lstm_dim_of(opt), state_dtype=sdt,
            priority_exponent=mp_.priority_exponent,
            importance_weight=mp_.priority_weight,
            pack_frames=sequence_pack_frames(opt))
        if opt.memory_type == "sequence":
            owner = QueueOwner(SequenceReplay(
                **seqs, importance_anneal_steps=ap.steps * ap.batch_size),
                **queues)
            return MemoryHandles(actor_side=owner.make_feeder(),
                                 learner_side=owner)
        ingest = DeviceSequenceIngest(
            **seqs, importance_anneal_steps=ap.steps, **queues)
        return MemoryHandles(actor_side=ingest.make_feeder(),
                             learner_side=ingest)
    if opt.memory_type not in ("device", "device-per"):
        raise _not_ported(f"memory_type {opt.memory_type!r}")
    if opt.memory_type == "device":
        ingest = DeviceReplayIngest(**rows, **queues)
    else:
        ingest = DevicePerIngest(**rows, **queues, **per)
    return MemoryHandles(actor_side=ingest.make_feeder(), learner_side=ingest)
