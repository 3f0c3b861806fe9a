"""The learner's replay-ratio pacing gate, port against reference, at
``steps_per_dispatch`` K = 4.

Both learners (config 12 at a small size, fp32, on the CPU) run in
threads on a warm ring with the actors' clock held at a fixed
``actor_step``.  The reference lets a dispatch through while
``(lstep - lstep0 + 1) * batch_size <= max_replay_ratio * actor_step``
(pytorch_distributed_tpu/agents/learner.py:651-654); each dispatch adds K
steps.  Once a learner's step has stood still for a while, it is blocked
at the gate, and both must stand at the same step: the first multiple of
K past the bound.  With the numbers below a gate on ``+ K`` instead of
``+ 1`` would stop one dispatch earlier, at 8 instead of 12.
"""

import threading
import time

import numpy as np
import pytest

import jax

from pytorch_distributed_tpu.agents.clocks import (
    GlobalClock as JaxClock, LearnerStats as JaxLearnerStats,
)
from pytorch_distributed_tpu.agents.learner import (
    run_learner as jax_run_learner,
)
from pytorch_distributed_tpu.agents.param_store import (
    ParamStore as JaxParamStore, make_flattener as jax_make_flattener,
)
from pytorch_distributed_tpu.config import build_options as jax_options
from pytorch_distributed_tpu.factory import (
    EnvSpec as JaxEnvSpec, build_memory as jax_build_memory,
    build_model as jax_build_model, init_params as jax_init_params,
)
from pytorch_distributed_tpu.utils.experience import (
    Transition as JaxTransition,
)
from pytorch_distributed_tpu_torch.agents.clocks import (
    GlobalClock, LearnerStats,
)
from pytorch_distributed_tpu_torch.agents.learner import run_learner
from pytorch_distributed_tpu_torch.agents.param_store import (
    ParamStore, num_params,
)
from pytorch_distributed_tpu_torch.config import build_options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_memory, build_model,
)
from pytorch_distributed_tpu_torch.utils.experience import Transition

FRAME, ACTIONS = (4, 44, 44), 6
BATCH, RATIO, ACTOR_STEP, K = 8, 1.0, 90, 4
# the first multiple of K whose next step would draw past the bound
EXPECT = next(s for s in range(0, 1000, K)
              if (s + 1) * BATCH > RATIO * ACTOR_STEP)
SETTINGS = dict(batch_size=BATCH, memory_size=256, learn_start=16,
                max_replay_ratio=RATIO, steps=10 ** 6, steps_per_dispatch=K,
                compute_dtype="float32", learner_freq=10 ** 6)


def _rows(n: int = 200):
    rng = np.random.default_rng(0)
    for _ in range(n):
        yield dict(
            state0=rng.integers(0, 255, FRAME).astype(np.uint8),
            action=np.int32(rng.integers(ACTIONS)),
            reward=np.float32(rng.normal()),
            gamma_n=np.float32(0.99 ** 5),
            state1=rng.integers(0, 255, FRAME).astype(np.uint8),
            terminal1=np.float32(0.0))


def _feed(feeder, cls) -> None:
    for row in _rows():
        feeder.feed(cls(**row))
    feeder.flush()


def _reference(tmp_path):
    opt = jax_options(12, root_dir=str(tmp_path), refs="gate",
                      visualize=False, resume="never", **SETTINGS)
    spec = JaxEnvSpec(state_shape=FRAME, discrete=True, num_actions=ACTIONS,
                      action_dim=0, norm_val=255.0)
    handles = jax_build_memory(opt, spec)
    _feed(handles.actor_side, JaxTransition)
    flat, _ = jax_make_flattener(jax_init_params(
        opt, spec, jax_build_model(opt, spec), seed=0))
    clock = JaxClock()
    clock.actor_step.value = ACTOR_STEP
    args = (opt, spec, 0, handles.learner_side, JaxParamStore(flat.size),
            clock, JaxLearnerStats())
    return clock, jax_run_learner, args, handles.learner_side


def _port(tmp_path):
    opt = build_options(12, device="cpu", root_dir=str(tmp_path / "port"),
                        **SETTINGS)
    spec = EnvSpec(FRAME, ACTIONS, 255.0)
    handles = build_memory(opt, spec)
    _feed(handles.actor_side, Transition)
    clock = GlobalClock()
    clock.actor_step.value = ACTOR_STEP
    store = ParamStore(num_params(build_model(opt, spec).state_dict()))
    args = (opt, spec, 0, handles.learner_side, store, clock,
            LearnerStats())
    return clock, run_learner, args, handles.learner_side


@pytest.mark.timeout(90)
def test_gate_lets_the_same_steps_through_at_k4(tmp_path):
    assert EXPECT == 12  # a "+ K" gate would stop at 8
    sides = {"reference": _reference(tmp_path), "port": _port(tmp_path)}
    errors = []

    def run(fn, args):
        try:
            fn(*args)
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = {name: threading.Thread(target=run, args=(fn, args),
                                      daemon=True)
               for name, (_clock, fn, args, _mem) in sides.items()}
    for t in threads.values():
        t.start()
    # blocked at the gate: the step stands still for 3 s after the first
    # dispatch (a dispatch takes milliseconds here)
    last = {name: (-1, time.monotonic()) for name in sides}
    deadline = time.monotonic() + 70.0
    while time.monotonic() < deadline and not errors:
        now = time.monotonic()
        for name, (clock, *_rest) in sides.items():
            step = clock.learner_step.value
            if step != last[name][0]:
                last[name] = (step, now)
        if all(step > 0 and now - t0 > 3.0 for step, t0 in last.values()):
            break
        time.sleep(0.05)
    for clock, _fn, _args, _mem in sides.values():
        clock.stop.set()
    for t in threads.values():
        t.join(timeout=60.0)
    for _clock, _fn, _args, mem in sides.values():
        mem.close()
    assert not errors, errors
    steps = {name: clock.learner_step.value
             for name, (clock, *_rest) in sides.items()}
    assert steps == {"reference": EXPECT, "port": EXPECT}, steps
    jax.clear_caches()
