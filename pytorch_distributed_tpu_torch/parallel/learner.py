"""The gradient exchange of a learner replica — the port of
pytorch_distributed_tpu/parallel/learner.py ``ReplicaExchange``
(:109-157).  The reference's ``ShardedLearner`` (one program over a
mesh) is item 9 of ROADMAP.md's Queue A and is not here.

``ReplicaExchange`` is the glue between the grad/apply halves
(ops/losses.build_dqn_grad_and_apply) and a replica channel
(parallel/dcn.py ``LocalReplicaChannel`` or ``ReplicaClient``): it lays
the gradients out as one fp32 vector in the reference's ``ravel_pytree``
order and layout (``agents/param_store.flatten_into``, the converter's
flax leaves), so a JAX replica and a port replica exchange the same
bytes, submits the vector as a generation-stamped round and writes the
members' mean back into gradient tensors on the gradients' device."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from pytorch_distributed_tpu_torch.agents.param_store import (
    flatten_into, num_params, unflatten_into,
)

Params = Dict[str, torch.Tensor]


class ReplicaExchange:
    """One replica's rounds over ``channel``.  ``state_shape`` names the
    model's flax layout (``convert.flax_leaves``)."""

    def __init__(self, channel, state_shape: Sequence[int] = ()):
        self.channel = channel
        self.state_shape = tuple(state_shape)
        self.rounds = 0
        self.degraded_rounds = 0
        self.last_members: list = []
        self._flat: Optional[torch.Tensor] = None    # on the grads' device
        self._reduced: Optional[Params] = None       # the mean's tensors

    def flatten(self, grads: Params) -> np.ndarray:
        """The gradients as the reference's fp32 vector, on the host."""
        if self._flat is None:
            dev = next(iter(grads.values())).device
            self._flat = torch.empty(num_params(grads), dtype=torch.float32,
                                     device=dev)
        return flatten_into(grads, self._flat, self.state_shape).cpu().numpy()

    def unflatten(self, flat: np.ndarray, like: Params) -> Params:
        """A vector in the reference's layout as gradient tensors shaped
        and placed like ``like`` (buffers kept from round to round)."""
        if self._reduced is None:
            self._reduced = {k: torch.empty_like(v) for k, v in like.items()}
        dev = next(iter(self._reduced.values())).device
        src = torch.from_numpy(np.ascontiguousarray(flat, np.float32))
        return unflatten_into(src.to(dev), self._reduced, self.state_shape)

    def exchange(self, round_idx: int, grads: Params, ok: bool = True,
                 pidx=None, ptd=None) -> Tuple[dict, Optional[Params]]:
        """One round: ``(reply, reduced)``; ``reduced`` is None when the
        round applied nothing (no finite contribution) or did not
        complete (the reply's status says why: the driver tells a rejoin
        from an exit)."""
        from pytorch_distributed_tpu_torch.parallel.dcn import RSTAT_OK

        reply = self.channel.submit_round(round_idx, self.flatten(grads),
                                          ok=ok, pidx=pidx, ptd=ptd)
        if reply["status"] != RSTAT_OK:
            return reply, None
        self.rounds += 1
        members = list(reply.get("members", []))
        if self.last_members and len(members) < len(self.last_members):
            self.degraded_rounds += 1
        self.last_members = members
        if reply.get("applied", 0) <= 0 or reply.get("grad") is None:
            return reply, None
        return reply, self.unflatten(reply["grad"], grads)
