"""Seeds of the replica plane — the port of pytorch_distributed_tpu/
utils/rngs.py's ``ROLE_SALTS``, ``process_seed`` and ``np_rng`` (:14-42),
with no JAX.  ``np_rng(seed, "replica-ingest", k)`` draws the same bytes
as the reference's, so a port replica and a JAX replica mint the same
shared ingest stream.

The reference's ``process_key`` (a threefry key) has no counterpart: the
port's replica key stream is ``replica_round_seed``, a pure function of
``(seed, round, rank)`` that seeds a torch generator (ROADMAP.md,
divergences)."""

from __future__ import annotations

import numpy as np

# the role salts, so actor 0 and learner 0 never share a stream
ROLE_SALTS = {
    "main": 0,
    "actor": 1_000_000,
    "learner": 2_000_000,
    "evaluator": 3_000_000,
    "tester": 4_000_000,
    "logger": 5_000_000,
    "env": 6_000_000,
    # the replica plane: one shared stream a fleet (index 0; the rank
    # tells replicas apart) and the shared ingest stream, indexed by a
    # counter every replica advances alike
    "replica-plane": 7_000_000,
    "replica-ingest": 8_000_000,
}


def process_seed(root_seed: int, role: str, index: int = 0) -> int:
    return (root_seed + ROLE_SALTS[role] + index) % (2 ** 31 - 1)


def np_rng(root_seed: int, role: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(process_seed(root_seed, role, index))


def replica_round_seed(base: int, round_idx: int, rank: int) -> int:
    """The seed of round ``round_idx``'s draw at ``rank`` in the sorted
    live membership: the rank and not the world size, so a survivor at
    rank 0 draws what a solo driver draws."""
    return int(np.random.SeedSequence(
        (int(base), int(round_idx), int(rank))).generate_state(
            1, np.uint64)[0] >> 1)
