"""Resume from a checkpoint epoch (agents/learner.py, utils/checkpoint.py)
on the CPU:

- the learner through the fused step on a fixed ring, no actors: 2N
  updates in one go equal, to the bit, N updates, then ``save_epoch``,
  ``load_epoch_state`` and the ring's and the generator's restore, then N
  more (params, target, Adam state, step and the ring's priorities);
- ``resume``'s three modes: "must" without an epoch raises, "never"
  ignores one, "auto" takes the newest complete one;
- ``run_learner`` resumed: its first published weights are the epoch's
  params to the bit, ``best_eval_reward`` is the larger of the epoch's
  and the ``_best`` sidecar's, ``actor_step`` is restored additively, and
  the steps go on from the epoch's.
"""

import os

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.agents.clocks import (
    GlobalClock, LearnerStats,
)
from pytorch_distributed_tpu_torch.agents.learner import (
    resume_epoch, run_learner,
)
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, make_flattener, num_params,
)
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_memory, build_model, build_train_state_and_step,
    init_params,
)
from pytorch_distributed_tpu_torch.memory.device_per import DevicePerReplay
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils.experience import Transition

FRAME, ACTIONS, B, N, CAPACITY, ROWS = (4, 44, 44), 6, 8, 3, 256, 200
SPEC = EnvSpec(FRAME, ACTIONS, 255.0)


def _cols(seed: int = 0, rows: int = ROWS):
    rng = np.random.default_rng(seed)
    return dict(
        state0=rng.integers(0, 255, (rows, *FRAME)).astype(np.uint8),
        action=rng.integers(0, ACTIONS, rows).astype(np.int32),
        reward=rng.normal(size=rows).astype(np.float32),
        gamma_n=np.full(rows, 0.99 ** 5, np.float32),
        state1=rng.integers(0, 255, (rows, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(rows) < 0.1).astype(np.float32))


def _learner(param_seed: int):
    opt = build_options(12, device="cpu", batch_size=B,
                        compute_dtype="float32", pallas_torso=True,
                        target_model_update=2)
    state, step = build_train_state_and_step(
        opt, build_model(opt, SPEC), init_params(opt, SPEC, seed=param_seed))
    ring = DevicePerReplay(CAPACITY, FRAME)
    return state, step, ring


def _updates(state, step, ring, gen, lsteps):
    fused = ring.build_fused_step(step, B)
    for lstep in lsteps:
        us = torch.rand((1, B), generator=gen)
        state, _metrics = fused(state, ring.state, us, ring.beta(lstep))
    return state


def _tensors(state, ring):
    out = {"step": state.step, "count": state.opt_state.count,
           "priority": ring.state.priority,
           "max_priority": ring.state.max_priority}
    for name, tree in (("params", state.params),
                       ("target", state.target_params),
                       ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        out.update({f"{name}/{k}": v for k, v in tree.items()})
    return out


def test_resumed_updates_equal_straight_ones(tmp_path):
    state, step, ring = _learner(0)
    ring.feed_chunk(Transition(**_cols()))
    gen = torch.Generator().manual_seed(11)
    straight = _updates(state, step, ring, gen, range(2 * N))
    want = {k: v.clone() for k, v in _tensors(straight, ring).items()}

    state, step, ring = _learner(0)
    ring.feed_chunk(Transition(**_cols()))
    gen = torch.Generator().manual_seed(11)
    state = _updates(state, step, ring, gen, range(N))
    name = str(tmp_path / "run")
    ckpt.save_epoch(name, state=state, memory=ring, extras=dict(
        learner_step=N, rng=dict(
            learner_device=ckpt.serialize_torch_rng(gen))))

    # a learner from other weights and an empty ring, brought back
    state, step, ring = _learner(1)
    info = ckpt.resolve_epoch(name)
    state = ckpt.load_epoch_state(info)
    assert ckpt.load_epoch_replay(info, ring) == ROWS
    gen = torch.Generator().manual_seed(99)
    assert ckpt.restore_torch_rng(gen, info.extras["rng"]["learner_device"])
    resumed = _updates(state, step, ring, gen, range(N, 2 * N))
    got = _tensors(resumed, ring)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    assert int(resumed.step) == 2 * N


def _opt(tmp_path, **kw):
    kw = dict(dict(device="cpu", root_dir=str(tmp_path), refs="r",
                   batch_size=B, memory_size=CAPACITY, learn_start=16,
                   compute_dtype="float32", learner_freq=10 ** 6), **kw)
    return build_options(12, **kw)


def test_resume_modes(tmp_path):
    with pytest.raises(RuntimeError, match="no complete checkpoint"):
        resume_epoch(_opt(tmp_path, resume="must"))
    assert resume_epoch(_opt(tmp_path)) is None
    with pytest.raises(ValueError, match="resume mode"):
        resume_epoch(_opt(tmp_path, resume="sometimes"))
    state, _step, _ring = _learner(0)
    name = _opt(tmp_path).model_name
    for lstep in (4, 9):
        ckpt.save_epoch(name, state=state, extras={"learner_step": lstep})
    # a newer epoch that was never committed
    os.makedirs(os.path.join(ckpt.ckpt_root(name), "epoch_2"))
    assert resume_epoch(_opt(tmp_path, resume="never")) is None
    for mode in ("auto", "must"):
        info = resume_epoch(_opt(tmp_path, resume=mode))
        assert (info.epoch, info.learner_step) == (1, 9)


class FirstPublication(ParamStore):
    """A store that keeps the first vector published to it."""

    first = None

    def publish(self, flat):
        if self.first is None:
            self.first = np.array(flat, dtype=np.float32)
        return super().publish(flat)


def _run(opt, clock):
    handles = build_memory(opt, SPEC, in_process=True)
    cols = _cols(seed=4)
    for i in range(ROWS):
        handles.actor_side.feed(Transition(**{k: v[i]
                                              for k, v in cols.items()}))
    handles.actor_side.flush()
    store = FirstPublication(num_params(build_model(opt, SPEC).state_dict()))
    summary = run_learner(opt, SPEC, 0, handles.learner_side, store, clock,
                          LearnerStats())
    return summary, store


@pytest.mark.parametrize("sidecar,best", [(5.0, 5.0), (1.0, 3.0)])
def test_run_learner_resumes_the_counters(tmp_path, sidecar, best):
    clock = GlobalClock()
    clock.actor_step.value = 1000
    clock.best_eval_reward.value = 3.0
    first, _store = _run(_opt(tmp_path, steps=N), clock)
    assert first["learner/steps"] == N
    assert first["checkpoint/epochs_committed"] == 1
    info = ckpt.resolve_epoch(_opt(tmp_path).model_name)
    assert (info.learner_step, info.extras["actor_step"]) == (N, 1000)
    assert info.extras["best_eval_reward"] == 3.0
    ckpt.save_best_score(_opt(tmp_path).model_name, sidecar, step=N)

    clock = GlobalClock()
    clock.actor_step.value = 7  # an actor stepped before the restore
    summary, store = _run(_opt(tmp_path, steps=N + 2), clock)
    assert summary["learner/resumed_from_step"] == N
    assert summary["learner/steps"] == N + 2
    assert clock.actor_step.value == 1007
    assert clock.best_eval_reward.value == best
    saved = ckpt.load_epoch_state(info)
    flat, _ = make_flattener(saved.params, FRAME)
    assert np.array_equal(store.first, flat)
    after = ckpt.resolve_epoch(_opt(tmp_path).model_name)
    assert (after.epoch, after.learner_step) == (1, N + 2)
    assert after.extras["lstep0"] == 0
