"""The port's restart budget, progress board and exit vocabulary
(utils/supervision.py) against the JAX package's, on the same call
sequences under one patched clock: the restart delays, the budgets, the
``hung()`` lists, ages, marks and ``describe_exit`` strings must be equal
(exact: host logic only)."""

import types

import pytest

from pytorch_distributed_tpu.utils import supervision as jax_sup
from pytorch_distributed_tpu_torch.utils import supervision as port_sup


class FakeClock:
    """One clock for ``time.monotonic`` and ``time.time``."""

    def __init__(self, now: float = 1000.0):
        self.now = now

    def module(self):
        return types.SimpleNamespace(monotonic=lambda: self.now,
                                     time=lambda: self.now)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (jax_sup, port_sup):
        monkeypatch.setattr(mod, "time", c.module())
    return c


def test_exit_vocabulary_matches():
    for name in ("EXIT_OK", "EXIT_CRASH", "EXIT_DISCONNECTED", "EXIT_HUNG"):
        assert getattr(port_sup, name) == getattr(jax_sup, name), name
    for code in (0, 1, 2, 3, 4, -9, -15, None, 137):
        assert port_sup.describe_exit(code) == jax_sup.describe_exit(code)


def _budget_trace(mod, clock, **kw):
    """Crash loops, an isolated crash after the grace period, and an
    unborn slot, on one budget; every answer recorded."""
    budget = mod.RestartBudget(**kw)
    out = []
    clock.now = 1000.0
    for slot in (0, 1):
        budget.note_birth(slot)
    for step in range(5):  # slot 0 crash-loops: young deaths
        clock.now += 1.0
        out.append(("loop", budget.request_restart(0), budget.count(0)))
        budget.note_birth(0)
    clock.now += kw.get("grace", 300.0) + 5.0  # slot 1 lived long
    out.append(("isolated", budget.request_restart(1), budget.count(1)))
    budget.note_birth(1)
    out.append(("unborn", budget.request_restart(7), budget.count(7)))
    out.append(("remaining", budget.remaining()))
    clock.now += kw.get("grace", 300.0) + 5.0  # slot 0's last incarnation
    out.append(("reset", budget.request_restart(0), budget.count(0)))
    return out


@pytest.mark.parametrize("kw", [
    {}, dict(max_restarts=1), dict(max_restarts=0),
    dict(backoff=True), dict(backoff=True, max_backoff=5.0, grace=10.0)])
def test_restart_budget_matches(clock, kw):
    ours = _budget_trace(port_sup, clock, **kw)
    theirs = _budget_trace(jax_sup, clock, **kw)
    assert ours == theirs


def _board_trace(mod, clock):
    labels = ["learner", "evaluator-0", "actor-0", "actor-1"]
    board = mod.ProgressBoard(labels)
    out = [board.labels]
    clock.now = 5000.0
    out.append(("unstarted", board.hung(2.0, 10.0), board.age("actor-0")))
    for lb in ("learner", "actor-0", "actor-1"):
        board.note_start(lb)
    board.bump("learner")
    board.bump("actor-0", n=3)
    board.bump("nobody")  # unknown labels are ignored
    for dt in (1.0, 2.5, 9.0, 20.0):
        clock.now = 5000.0 + dt
        out.append((dt, board.hung(2.0, 10.0), board.hung(0.0),
                    board.hung(2.0, 10.0, only=["actor-1"]),
                    [board.age(lb) for lb in labels],
                    [board.marks(lb) for lb in labels]))
    board.note_start("actor-0")  # a respawn: the grace window restarts
    out.append(("respawn", board.hung(2.0, 10.0), board.marks("actor-0"),
                board.hung(2.0, 10.0, now=clock.now + 11.0)))
    return out


def test_progress_board_matches(clock):
    assert _board_trace(port_sup, clock) == _board_trace(jax_sup, clock)
