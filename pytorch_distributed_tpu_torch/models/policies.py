"""Action selection — the port of pytorch_distributed_tpu/models/policies.py:
``apex_epsilon(s)`` (:22-45), epsilon-greedy act (:48-70), the inference
server's packed acts (``_pack_dqn`` :100-108, ``build_packed_roll_act``
:140-165, ``build_packed_act_rowkeys`` :168-180) and greedy act (:517).

The reference derives per-(tick, row) JAX keys on the device; those
streams cannot be replayed in torch, so the port's act takes its
randomness as arguments (explore uniforms and random actions, one per
row) and the caller draws them from its own ``torch.Generator``.  So a
row's action depends on that row's arguments alone, however rows were
batched together.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def apex_epsilon(process_ind: int, num_actors: int,
                 eps: float = 0.4, eps_alpha: float = 7.0) -> float:
    """Ape-X per-actor schedule ``eps ** (1 + i/(N-1) * alpha)``, with the
    single-actor debug value 0.1."""
    if num_actors <= 1:
        return 0.1
    frac = process_ind / (num_actors - 1)
    return float(eps ** (1.0 + frac * eps_alpha))


def apex_epsilons(process_ind: int, num_actors: int, num_envs: int,
                  eps: float = 0.4, eps_alpha: float = 7.0) -> np.ndarray:
    """Per-env epsilons: env j of actor i takes fleet slot i*num_envs + j
    of num_actors*num_envs."""
    total = num_actors * num_envs
    return np.asarray(
        [apex_epsilon(process_ind * num_envs + j, total, eps, eps_alpha)
         for j in range(num_envs)], dtype=np.float32)


@torch.no_grad()
def epsilon_greedy_act(apply_fn: Callable, params, obs: torch.Tensor,
                       eps: torch.Tensor, explore_u: torch.Tensor,
                       random_a: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row i takes ``random_a[i]`` when ``explore_u[i] < eps[i]``, else its
    greedy action.  Returns ``(action, q_sel, q_max)``."""
    q = apply_fn(params, obs)
    action = torch.where(explore_u < eps, random_a, q.argmax(-1))
    q_sel = q.gather(1, action[:, None])[:, 0]
    return action, q_sel, q.max(-1).values


def pack_dqn(q: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """One (3, B) float32 tensor of (action, q_sel, q_max) rows, so a
    response costs one device-to-host copy (action indices are small
    integers, exact in fp32)."""
    q_sel = q.gather(1, action[:, None])[:, 0]
    return torch.stack([action.float(), q_sel.float(),
                        q.max(-1).values.float()])


@torch.no_grad()
def packed_act_rows(apply_fn: Callable, params, obs: torch.Tensor,
                    eps: torch.Tensor, explore_u: torch.Tensor,
                    random_a: torch.Tensor) -> torch.Tensor:
    """The epsilon-greedy act over rows of any origin, packed: the
    inference server's program for a full upload, one client's rows or
    several clients' concatenated, each row with its own ``eps``,
    ``explore_u`` and ``random_a``."""
    q = apply_fn(params, obs)
    action = torch.where(explore_u < eps, random_a, q.argmax(-1))
    return pack_dqn(q, action)


@torch.no_grad()
def packed_roll_act(apply_fn: Callable, params, stack: torch.Tensor,
                    new: torch.Tensor, eps: torch.Tensor,
                    explore_u: torch.Tensor, random_a: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frame-packed act: roll the client's resident ``(B, C, H, W)``
    uint8 ``stack`` by its newest ``(B, H, W)`` frames, in place, then act
    on it.  Returns ``(stack, packed)``.  The client sends only the newest
    frames when the roll held on its side, so the rolled stack is what
    the env emitted."""
    stack.copy_(torch.cat([stack[:, 1:], new[:, None]], dim=1))
    return stack, packed_act_rows(apply_fn, params, stack, eps, explore_u,
                                  random_a)


@torch.no_grad()
def greedy_act(apply_fn: Callable, params, obs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pure-greedy act, for evaluation: ``(action, q_max)``."""
    q = apply_fn(params, obs)
    return q.argmax(-1), q.max(-1).values
