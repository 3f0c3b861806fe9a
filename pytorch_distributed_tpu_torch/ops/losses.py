"""The DQN update as a plain tensor function — the port of
pytorch_distributed_tpu/ops/losses.py:49-150 and of its megabatch group
step (``_per_minibatch_ok`` and ``build_dqn_megabatch_step``, :231-343),
with ``update_target`` (utils/helpers.py:18-50) and the ``finite_guard`` /
``suppress_writeback`` semantics of utils/health.py:105-161.

``step(state, batch) -> (state', metrics, td_abs)``:

- n-step target ``r + gamma_n * bootstrap(s1) * (1 - terminal)``, optional
  double-DQN action selection by the online net;
- squared error with no 1/2 factor, weighted by the IS weights (:85-95);
- the optimizer is optax's ``chain(clip(c), adam(lr))`` written out as
  tensor code (clip by value, then Adam with b1 0.9, b2 0.999, eps 1e-8 and
  bias correction), so its moments can be compared with the reference's;
- the target net is hard-copied every N steps (N >= 1) or Polyak-averaged
  with tau (< 1), from the post-update params;
- the guard: when the loss, ``q_mean``, the grad norm or any |TD| is
  non-finite, the whole candidate state is discarded (per-tensor select, no
  host sync), |TD| is zeroed and ``learner/skipped`` reads 1.

The state is functional: a step returns new tensors and never writes into
the input state, so the guard can select between the two.

``step(state, batches) -> (state', metrics, td_abs (M, B), ok (M,))``, the
megabatch group step, takes M minibatches as (M, B)-leading fields and
takes all M gradients at the group-entry params in one forward and one
backward over M*B rows: the params are stacked M times as autograd leaves
(expanded views, no copy) and ``group_apply_fn(stacked, obs (M, B, ...))``
runs row group m on copy m, so one ``autograd.grad`` of the summed losses
gives each minibatch's gradient on its own copy.  Then the M Adam
updates apply in turn, the step counter and the target cadence advancing
as in M sequential steps; the guard runs per minibatch, and a non-finite
minibatch skips its own update only.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from pytorch_distributed_tpu_torch.utils.experience import Batch

SKIPPED_KEY = "learner/skipped"
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

Params = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32, updates applied
    mu: Params
    nu: Params


class TrainState(NamedTuple):
    params: Params
    target_params: Params
    opt_state: AdamState
    step: torch.Tensor  # () int32 learner step


def init_train_state(params: Params) -> TrainState:
    """Fresh state with the target hard-synced to (a copy of) ``params``."""
    params = {k: v.detach().clone() for k, v in params.items()}
    dev = next(iter(params.values())).device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return TrainState(
        params=params,
        target_params={k: v.clone() for k, v in params.items()},
        opt_state=AdamState(zero.clone(),
                            {k: torch.zeros_like(v) for k, v in params.items()},
                            {k: torch.zeros_like(v) for k, v in params.items()}),
        step=zero.clone())


def adam_update(grads: Params, opt: AdamState, params: Params, lr: float,
                clip_grad: float = float("inf")) -> Tuple[Params, AdamState]:
    """optax ``chain(clip(clip_grad), adam(lr))`` applied once."""
    if clip_grad != float("inf"):
        grads = {k: g.clamp(-clip_grad, clip_grad) for k, g in grads.items()}
    count = opt.count + 1
    c = count.float()
    bc1 = 1.0 - torch.pow(ADAM_B1, c)
    bc2 = 1.0 - torch.pow(ADAM_B2, c)
    mu, nu, new = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * opt.mu[k]
        nu[k] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * opt.nu[k]
        upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        new[k] = params[k] + upd * (-lr)
    return new, AdamState(count, mu, nu)


def update_target(target: Params, online: Params, step: torch.Tensor,
                  target_model_update: float) -> Params:
    """< 1: soft tau update every step; >= 1: hard copy every N steps."""
    if target_model_update < 1:
        tau = float(target_model_update)
        return {k: (1.0 - tau) * target[k] + tau * online[k] for k in target}
    do = (step % int(target_model_update)) == 0
    return {k: torch.where(do, online[k], target[k]) for k in target}


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))


def _select(ok: torch.Tensor, new, old):
    """Per-tensor ``where(ok, new, old)`` over matching state trees."""
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if isinstance(new, dict):
        return {k: torch.where(ok, new[k], old[k]) for k in new}
    return type(new)(*(_select(ok, n, o) for n, o in zip(new, old)))


def build_dqn_train_step(apply_fn: Callable[[Params, torch.Tensor],
                                            torch.Tensor],
                         *, lr: float, clip_grad: float = float("inf"),
                         enable_double: bool = False,
                         target_model_update: float = 250,
                         guard: bool = True) -> Callable:
    """``apply_fn(params, obs) -> q (B, A) fp32``; returns
    ``step(state, batch) -> (state', metrics, td_abs)``."""

    def step(state: TrainState, batch: Batch):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        q = apply_fn(params, batch.state0)
        q_sel = q.gather(1, batch.action.long().view(-1, 1))[:, 0]
        with torch.no_grad():
            q_next = apply_fn(state.target_params, batch.state1)
            if enable_double:
                a_next = apply_fn(state.params, batch.state1).argmax(-1)
                bootstrap = q_next.gather(1, a_next[:, None])[:, 0]
            else:
                bootstrap = q_next.max(-1).values
            target = (batch.reward
                      + batch.gamma_n * bootstrap * (1.0 - batch.terminal1))
        td = q_sel - target
        loss = torch.mean(batch.weight * td.square())
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        with torch.no_grad():
            q_mean = q.max(-1).values.mean()
            new_params, opt = adam_update(grads, state.opt_state,
                                          state.params, lr, clip_grad)
            new_step = state.step + 1
            new_target = update_target(state.target_params, new_params,
                                       new_step, target_model_update)
            new = TrainState(new_params, new_target, opt, new_step)
            metrics = {"learner/critic_loss": loss.detach(),
                       "learner/q_mean": q_mean,
                       "learner/grad_norm": global_norm(grads)}
            td_abs = td.detach().abs()
            if not guard:
                return new, metrics, td_abs
            ok = torch.isfinite(td_abs).all()
            for v in metrics.values():
                ok = ok & torch.isfinite(v)
            metrics[SKIPPED_KEY] = 1.0 - ok.float()
            return (_select(ok, new, state), metrics,
                    torch.where(ok, td_abs, torch.zeros_like(td_abs)))

    return step


def _per_minibatch_ok(*arrays: torch.Tensor, grads=()) -> torch.Tensor:
    """(M,) float32: 1.0 where every per-minibatch row of ``arrays`` (the
    losses, the |TD| rows, the q means) and of every gradient leaf (M
    leading) is finite (reference :231-248)."""
    ok = None
    for a in (*arrays, *grads):
        this = torch.isfinite(a.reshape(a.shape[0], -1)).all(1)
        ok = this if ok is None else ok & this
    return ok.float()


def build_dqn_megabatch_step(apply_fn: Callable[[Params, torch.Tensor],
                                                torch.Tensor],
                             group_apply_fn: Callable[[Params, torch.Tensor],
                                                      torch.Tensor],
                             *, lr: float, clip_grad: float = float("inf"),
                             enable_double: bool = False,
                             target_model_update: float = 250,
                             guard: bool = True) -> Callable:
    """The megabatch group step (reference :250-343).  ``apply_fn(params,
    obs (R, ...)) -> q (R, A)`` serves the target (and, with double DQN,
    the online) forward over the M*B next states, which takes no
    gradient; ``group_apply_fn(stacked, obs (M, B, ...)) -> q (M, B, A)``
    the online forward, whose row group m reads ``stacked[k][m]``.
    Metrics are the last minibatch's; ``learner/skipped`` counts the
    group's skipped minibatches."""

    def step(state: TrainState, batches: Batch):
        M, B = batches.reward.shape
        stacked = {k: v.detach().expand(M, *v.shape).requires_grad_(True)
                   for k, v in state.params.items()}
        q = group_apply_fn(stacked, batches.state0)                # (M, B, A)
        q_sel = q.gather(2, batches.action.long().view(M, B, 1))[..., 0]
        with torch.no_grad():
            s1 = batches.state1.reshape(M * B, *batches.state1.shape[2:])
            q_next = apply_fn(state.target_params, s1)
            if enable_double:
                a_next = apply_fn(state.params, s1).argmax(-1)
                bootstrap = q_next.gather(1, a_next[:, None])[:, 0]
            else:
                bootstrap = q_next.max(-1).values
            target = (batches.reward + batches.gamma_n
                      * bootstrap.view(M, B) * (1.0 - batches.terminal1))
        td = q_sel - target
        losses = torch.mean(batches.weight * td.square(), 1)
        leaves = list(stacked.values())
        grads = dict(zip(stacked, torch.autograd.grad(losses.sum(), leaves)))
        with torch.no_grad():
            losses = losses.detach()
            q_means = q.max(-1).values.mean(1)
            td_abs = td.detach().abs()
            ok = (_per_minibatch_ok(losses, td_abs, q_means,
                                    grads=grads.values()) if guard
                  else torch.ones(M, device=losses.device))
            params, target_p = state.params, state.target_params
            opt, step_c = state.opt_state, state.step
            for m in range(M):
                new_params, new_opt = adam_update(
                    {k: g[m] for k, g in grads.items()}, opt, params, lr,
                    clip_grad)
                new_step = step_c + 1
                new_target = update_target(target_p, new_params, new_step,
                                           target_model_update)
                keep = ok[m] > 0.5
                params, target_p, opt, step_c = _select(
                    keep, TrainState(new_params, new_target, new_opt,
                                     new_step),
                    TrainState(params, target_p, opt, step_c))
            metrics = {"learner/critic_loss": losses[-1],
                       "learner/q_mean": q_means[-1],
                       "learner/grad_norm": global_norm(
                           {k: g[-1] for k, g in grads.items()})}
            if guard:
                metrics[SKIPPED_KEY] = torch.sum(1.0 - ok)
            td_abs = torch.where(ok[:, None] > 0.5, td_abs,
                                 torch.zeros_like(td_abs))
            return (TrainState(params, target_p, opt, step_c), metrics,
                    td_abs, ok)

    return step
