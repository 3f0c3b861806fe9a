"""The port's checkpoint epochs (utils/checkpoint.py) on the CPU: save,
resolve and load round trips (the state to the bit, the ring's snapshot
array for array), torn and corrupt epochs skipped, retention, fenced
epochs, a SIGKILL at each of the six write points of a save (in a child
process, through ``CKPT_FAULTS``), and the two packages reading each
other's roots: the JAX package's ``verify_epoch`` and ``fsck`` accept
every epoch the port commits, and the port's ``fsck`` gives the JAX
package's report on a root the JAX package wrote.  All exact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu.utils import checkpoint as jax_ckpt
from pytorch_distributed_tpu_torch import ckpt_fsck
from pytorch_distributed_tpu_torch.memory.device_per import DevicePerReplay
from pytorch_distributed_tpu_torch.ops.losses import init_train_state
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils.experience import Transition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAME, CAPACITY = (2, 6, 6), 48


def _state(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    st = init_train_state({"w": torch.randn(5, 3, generator=g),
                           "b": torch.randn(3, generator=g)})
    # a state that is not its own initialisation: moments and steps set
    for tree in (st.opt_state.mu, st.opt_state.nu, st.target_params):
        for v in tree.values():
            v.copy_(torch.randn(v.shape, generator=g))
    st.opt_state.count.fill_(7)
    st.step.fill_(7)
    return st


def _ring(rows: int = 30, seed: int = 0):
    rng = np.random.default_rng(seed)
    ring = DevicePerReplay(CAPACITY, FRAME)
    ring.feed_chunk(Transition(
        state0=rng.integers(0, 255, (rows, *FRAME)).astype(np.uint8),
        action=rng.integers(0, 6, rows).astype(np.int32),
        reward=rng.normal(size=rows).astype(np.float32),
        gamma_n=np.full(rows, 0.99 ** 5, np.float32),
        state1=rng.integers(0, 255, (rows, *FRAME)).astype(np.uint8),
        terminal1=(rng.random(rows) < 0.2).astype(np.float32)))
    ring.state.priority[:rows] = torch.as_tensor(
        rng.random(rows).astype(np.float32) + 0.1)
    return ring


def _leaves(st):
    return [st.params, st.target_params, st.opt_state.mu, st.opt_state.nu,
            {"count": st.opt_state.count, "step": st.step}]


def _assert_state_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype, k
            assert torch.equal(x[k], y[k]), k


def _extras(step: int, **kw):
    return dict(learner_step=step, lstep0=0, actor_step=100 * step, **kw)


def test_round_trip(tmp_path):
    name = str(tmp_path / "models" / "run")
    st, ring = _state(), _ring()
    path = ckpt.save_epoch(name, state=st, memory=ring,
                           extras=_extras(7, best_eval_reward=2.5))
    assert path == os.path.join(ckpt.ckpt_root(name), "epoch_0")
    info = ckpt.resolve_epoch(name)
    assert (info.epoch, info.learner_step) == (0, 7)
    assert info.has_state and info.has_replay
    assert info.extras["best_eval_reward"] == 2.5
    _assert_state_equal(ckpt.load_epoch_state(info), st)
    back = DevicePerReplay(CAPACITY, FRAME)
    assert ckpt.load_epoch_replay(info, back) == 30
    want, got = ring.snapshot(), back.snapshot()
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(want[k], got[k]), k
    # the JAX package's reader accepts the port's epoch
    assert jax_ckpt.verify_epoch(path) == ("complete", [])
    assert jax_ckpt.resolve_epoch(name).learner_step == 7
    assert ckpt_fsck.main([ckpt.ckpt_root(name)]) == 0


def test_torn_epoch_is_skipped_and_cleared(tmp_path):
    name = str(tmp_path / "run")
    ckpt.save_epoch(name, state=_state(), extras=_extras(1))
    torn = os.path.join(ckpt.ckpt_root(name), "epoch_1")
    os.makedirs(torn)
    with open(os.path.join(torn, ckpt.STATE), "wb") as f:
        f.write(b"half a state")
    assert ckpt.resolve_epoch(name).epoch == 0
    report = ckpt.fsck(ckpt.ckpt_root(name))
    assert [e["status"] for e in report["epochs"]] == ["incomplete",
                                                       "complete"]
    assert not report["violations"]
    assert report == jax_ckpt.fsck(ckpt.ckpt_root(name))
    ckpt.save_epoch(name, state=_state(1), extras=_extras(2))
    info = ckpt.resolve_epoch(name)
    assert (info.epoch, info.learner_step) == (1, 2)
    _assert_state_equal(ckpt.load_epoch_state(info), _state(1))


def _flip_state_byte(path):
    p = os.path.join(path, ckpt.STATE)
    data = bytearray(open(p, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(p, "wb").write(bytes(data))


def _garbage_manifest(path):
    with open(os.path.join(path, ckpt.MANIFEST), "w") as f:
        f.write("{not json")


def _extras_step(path):
    """Rewrite the extras with another step and digest them anew, so only
    the step disagrees with the manifest."""
    ep = os.path.join(path, ckpt.EXTRAS)
    extras = json.load(open(ep))
    extras["learner_step"] += 1
    json.dump(extras, open(ep, "w"))
    mp = os.path.join(path, ckpt.MANIFEST)
    man = json.load(open(mp))
    digest, nbytes = ckpt._digest_file(ep)
    man["artifacts"][ckpt.EXTRAS] = {"sha256": digest, "bytes": nbytes}
    json.dump(man, open(mp, "w"))


@pytest.mark.parametrize("damage", [_flip_state_byte, _garbage_manifest,
                                    _extras_step])
def test_a_corrupt_epoch_is_skipped(tmp_path, damage):
    name = str(tmp_path / "run")
    ckpt.save_epoch(name, state=_state(0), extras=_extras(1))
    newest = ckpt.save_epoch(name, state=_state(1), extras=_extras(2))
    damage(newest)
    status, bad = ckpt.verify_epoch(newest)
    assert status == "corrupt" and bad
    assert (status, bad) == jax_ckpt.verify_epoch(newest)
    info = ckpt.resolve_epoch(name)
    assert info.epoch == 0
    _assert_state_equal(ckpt.load_epoch_state(info), _state(0))
    report = ckpt.fsck(ckpt.ckpt_root(name))
    assert report["violations"] and report["newest_complete"] == 0
    assert ckpt_fsck.main([ckpt.ckpt_root(name)]) == 1


def test_retention_and_fencing(tmp_path):
    name = str(tmp_path / "run")
    for step in range(1, 6):
        ckpt.save_epoch(name, state=_state(step), extras=_extras(step),
                        retain=2)
    root = ckpt.ckpt_root(name)
    assert sorted(os.listdir(root)) == ["epoch_3", "epoch_4"]
    assert ckpt.fence_epochs_after(name, 3, reason="drill") == [4]
    assert ckpt.fence_epochs_after(name, 3) == []  # idempotent
    info = ckpt.resolve_epoch(name)
    assert (info.epoch, info.learner_step) == (3, 4)
    report = ckpt.fsck(root)
    assert report["rolled_back"] == 1 and not report["violations"]
    assert report == jax_ckpt.fsck(root)
    # a fenced epoch is not counted against retain, and the next save
    # numbers past it
    ckpt.save_epoch(name, state=_state(9), extras=_extras(9), retain=2)
    assert sorted(os.listdir(root)) == ["epoch_3", "epoch_4", "epoch_5"]
    assert ckpt.resolve_epoch(name).epoch == 5


_SAVE_TWICE = """
import sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
from test_torch_checkpoint_epochs import _extras, _ring, _state
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
ckpt.save_epoch({name!r}, state=_state(0), memory=_ring(), extras=_extras(1))
ckpt.save_epoch({name!r}, state=_state(1), memory=_ring(20, 1),
                extras=_extras(2))
print("both saved")
"""


@pytest.mark.parametrize("point", range(ckpt.FRAMES_PER_SAVE))
def test_a_kill_at_each_write_point_keeps_the_last_epoch(tmp_path, point):
    """The child's second save dies at write point ``point``: the first
    epoch stays resumable, and the second exists only if its manifest
    was committed (the last point)."""
    name = str(tmp_path / "run")
    code = _SAVE_TWICE.format(repo=REPO, tests=os.path.join(REPO, "tests"),
                              name=name)
    env = dict(os.environ,
               CKPT_FAULTS=f"kill@{ckpt.FRAMES_PER_SAVE + point}")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == -9, out.stdout + out.stderr
    assert "both saved" not in out.stdout
    committed = point == ckpt._FRAME_POINTS.index("post_commit")
    info = ckpt.resolve_epoch(name)
    assert (info.epoch, info.learner_step) == ((1, 2) if committed
                                               else (0, 1))
    _assert_state_equal(ckpt.load_epoch_state(info), _state(info.epoch))
    root = ckpt.ckpt_root(name)
    for report in (ckpt.fsck(root), jax_ckpt.fsck(root)):
        assert not report["violations"]
        assert report["newest_complete"] == info.epoch
    epoch0 = os.path.join(root, "epoch_0")
    assert ckpt.verify_epoch(epoch0) == jax_ckpt.verify_epoch(epoch0) \
        == ("complete", [])
    # the next save clears the debris and commits past the survivor
    ckpt.save_epoch(name, state=_state(5), extras=_extras(5))
    assert ckpt.resolve_epoch(name).epoch == info.epoch + 1


def test_fsck_reads_a_root_the_jax_package_wrote(tmp_path):
    import jax.numpy as jnp

    name = str(tmp_path / "models" / "jax")
    for step in (3, 4):
        jax_ckpt.save_epoch(name, state={"w": jnp.arange(6.0) * step,
                                         "step": jnp.int32(step)},
                            extras={"learner_step": step})
    root = jax_ckpt.ckpt_root(name)
    assert ckpt.fsck(root) == jax_ckpt.fsck(root)
    assert ckpt.resolve_epoch(name).learner_step == 4
    _flip_orbax_file(os.path.join(root, "epoch_1", "state"))
    assert ckpt.fsck(root) == jax_ckpt.fsck(root)
    assert ckpt.resolve_epoch(name).learner_step == 3


def _flip_orbax_file(state_dir):
    for dirpath, _dirs, files in os.walk(state_dir):
        for fn in sorted(files):
            p = os.path.join(dirpath, fn)
            if os.path.getsize(p):
                data = bytearray(open(p, "rb").read())
                data[0] ^= 0xFF
                open(p, "wb").write(bytes(data))
                return


def test_fault_specs_and_rng_states_match_the_reference():
    from pytorch_distributed_tpu.utils import faults as jax_faults
    from pytorch_distributed_tpu_torch.utils import faults

    for spec in ("kill@9", " kill@0, kill@17 ,", "kill@3:1.5"):
        assert faults.parse_faults(spec) == jax_faults.parse_faults(spec)
    for bad in ("kill", "kill@x", "sever@3"):
        with pytest.raises(ValueError):
            faults.parse_faults(bad)
    rng = np.random.default_rng(4)
    rng.random(5)
    state = ckpt.serialize_np_rng(rng)
    assert json.loads(json.dumps(state)) == jax_ckpt.serialize_np_rng(rng)
    back = np.random.default_rng(0)
    assert ckpt.restore_np_rng(back, json.loads(json.dumps(state)))
    assert not ckpt.restore_np_rng(back, None)
    assert np.array_equal(back.random(4), rng.random(4))
