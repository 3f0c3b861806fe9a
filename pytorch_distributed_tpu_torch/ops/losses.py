"""The learner's updates as plain tensor functions — the port of
pytorch_distributed_tpu/ops/losses.py: ``make_optimizer`` (:67-82),
``_value_loss`` (:85-95), the DQN update (:98-150), its cut at the
gradient for learner replicas (``build_dqn_grad_and_apply`` :153-228)
and its megabatch group
step (``_per_minibatch_ok`` and ``build_dqn_megabatch_step``, :231-343),
the DDPG updates (``build_ddpg_megabatch_step`` :346-470,
``init_ddpg_train_state`` :473, ``build_ddpg_train_step`` :491,
``build_ddpg_train_step_coupled`` :568, ``split_ddpg_params`` /
``merge_ddpg_params`` :624-634), with ``update_target``
(utils/helpers.py:18-50) and the ``finite_guard`` / ``suppress_writeback``
semantics of utils/health.py:105-161.

``step(state, batch) -> (state', metrics, td_abs)``:

- n-step target ``r + gamma_n * bootstrap(s1) * (1 - terminal)``, optional
  double-DQN action selection by the online net;
- squared error with no 1/2 factor, weighted by the IS weights (:85-95);
- the optimizer is optax's ``chain(clip(c), add_decayed_weights(wd),
  adam(lr or linear_schedule(lr, 0, steps)))`` written out as tensor code
  (clip by value, the decayed weights added, then Adam with b1 0.9, b2
  0.999, eps 1e-8 and bias correction, its step size read at the count
  before the update's increment, as optax's schedule is), so its moments
  can be compared with the reference's;
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

DDPG (the actor-critic of models/ddpg_mlp.py): ``actor_fn(params, obs) ->
a`` and ``critic_fn(params, obs, a) -> q`` over the nets' own params.
The decoupled step's state holds ``{"actor": ..., "critic": ...}`` params,
targets and Adam states: the critic takes its TD step (the target ``r +
gamma_n Q'(s1, pi'(s1)) (1 - terminal)`` from the target nets), then the
actor its step on ``-mean Q(s, pi(s))`` through the *updated* critic, then
both targets move by tau; the guard is the whole step's.  The coupled step
(``ddpg_coupled_update``) holds the merged params under one Adam and
descends ``critic_loss + actor_loss`` at once, so the policy loss's
gradient reaches the critic, as the original learner did.  The DDPG group
step takes the M critic gradients at the group-entry params, applies them
in turn, then the M actor gradients at (the entry actor, the final critic),
applied in turn with the targets chained on each (actor_m, critic_m); its
guard has two masks a minibatch: the critic's gates the critic chain, the
combined one the actor, the targets, the step counter and |TD|.
"""

from __future__ import annotations

import functools
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
    opt = init_adam(params)
    return TrainState(
        params=params,
        target_params={k: v.clone() for k, v in params.items()},
        opt_state=opt, step=opt.count.clone())


def adam_update(grads: Params, opt: AdamState, params: Params, lr: float,
                clip_grad: float = float("inf"), weight_decay: float = 0.0,
                lr_decay_steps: int = 0) -> Tuple[Params, AdamState]:
    """optax ``chain(clip(clip_grad), add_decayed_weights(weight_decay),
    adam(lr))`` applied once; ``lr_decay_steps`` > 0 takes the step size
    from ``linear_schedule(lr, 0, lr_decay_steps)`` at the count before
    this update."""
    if clip_grad != float("inf"):
        grads = {k: g.clamp(-clip_grad, clip_grad) for k, g in grads.items()}
    if weight_decay > 0.0:
        grads = {k: g + weight_decay * params[k] for k, g in grads.items()}
    step_size = lr
    if lr_decay_steps > 0:
        done = torch.clamp(opt.count.float(), 0.0, float(lr_decay_steps))
        step_size = lr * (1.0 - done / lr_decay_steps)
    count = opt.count + 1
    c = count.float()
    bc1 = 1.0 - torch.pow(ADAM_B1, c)
    bc2 = 1.0 - torch.pow(ADAM_B2, c)
    mu, nu, new = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * opt.mu[k]
        nu[k] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * opt.nu[k]
        upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
        new[k] = params[k] + upd * (-step_size)
    return new, AdamState(count, mu, nu)


def make_optimizer(lr: float, clip_grad: float = float("inf"),
                   weight_decay: float = 0.0, lr_decay_steps: int = 0
                   ) -> Callable[[Params, AdamState, Params],
                                 Tuple[Params, AdamState]]:
    """``tx(grads, opt, params) -> (params', opt')``: ``adam_update`` with
    the reference's chain fixed (reference :67-82)."""
    return functools.partial(adam_update, lr=lr, clip_grad=clip_grad,
                             weight_decay=weight_decay,
                             lr_decay_steps=lr_decay_steps)


def init_adam(params: Params) -> AdamState:
    dev = next(iter(params.values())).device
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                     {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


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
        return {k: _select(ok, new[k], old[k]) for k in new}
    picked = [_select(ok, n, o) for n, o in zip(new, old)]
    return tuple(picked) if type(new) is tuple else type(new)(*picked)


def _value_loss(pred: torch.Tensor, target: torch.Tensor,
                weight: torch.Tensor, huber: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(mean(weight * per-row loss), |TD|)``: the squared error with no
    1/2 factor, or optax's Huber loss at delta 1 (reference :85-95);
    ``target`` takes no gradient."""
    td = pred - target.detach()
    if huber:
        a = td.abs()
        per = torch.where(a <= 1.0, 0.5 * td.square(), a - 0.5)
    else:
        per = td.square()
    return torch.mean(weight * per, dim=-1), td.detach().abs()


def _grad_leaves(params: Params) -> Params:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def _guarded(guard: bool, new, old, metrics: dict, td_abs: torch.Tensor):
    """The whole-step finite guard (utils/health.py finite_guard): a
    non-finite |TD| or metric keeps ``old`` and zeroes |TD|."""
    if not guard:
        return new, metrics, td_abs
    ok = torch.isfinite(td_abs).all()
    for v in metrics.values():
        ok = ok & torch.isfinite(v)
    metrics[SKIPPED_KEY] = 1.0 - ok.float()
    return (_select(ok, new, old), metrics,
            torch.where(ok, td_abs, torch.zeros_like(td_abs)))


def _dqn_grads(apply_fn: Callable[[Params, torch.Tensor], torch.Tensor],
               enable_double: bool) -> Callable:
    """``grads_of(state, batch) -> (grads, loss, metrics, td_abs)``: the
    DQN loss (reference :98-150), its gradient at ``state.params`` and
    the update's metrics; the one loss of the fused step and of the
    replicas' grad half."""

    def grads_of(state: TrainState, batch: Batch):
        params = _grad_leaves(state.params)
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
            metrics = {"learner/critic_loss": loss.detach(),
                       "learner/q_mean": q.max(-1).values.mean(),
                       "learner/grad_norm": global_norm(grads)}
            return grads, loss.detach(), metrics, td.detach().abs()

    return grads_of


def _dqn_apply(tx: Callable, target_model_update: float) -> Callable:
    """``apply(state, grads) -> state'``: the optimizer, the step and the
    target cadence, chained once for the fused step and the replicas'
    apply half."""

    def apply(state: TrainState, grads: Params) -> TrainState:
        new_params, opt = tx(grads, state.opt_state, state.params)
        new_step = state.step + 1
        new_target = update_target(state.target_params, new_params,
                                   new_step, target_model_update)
        return TrainState(new_params, new_target, opt, new_step)

    return apply


def build_dqn_train_step(apply_fn: Callable[[Params, torch.Tensor],
                                            torch.Tensor],
                         tx: Callable, *, enable_double: bool = False,
                         target_model_update: float = 250,
                         guard: bool = True) -> Callable:
    """``apply_fn(params, obs) -> q (B, A) fp32``, ``tx`` from
    ``make_optimizer``; returns ``step(state, batch) -> (state', metrics,
    td_abs)``."""
    grads_of = _dqn_grads(apply_fn, enable_double)
    apply = _dqn_apply(tx, target_model_update)

    def step(state: TrainState, batch: Batch):
        grads, _loss, metrics, td_abs = grads_of(state, batch)
        with torch.no_grad():
            return _guarded(guard, apply(state, grads), state, metrics,
                            td_abs)

    return step


def build_dqn_grad_and_apply(apply_fn: Callable[[Params, torch.Tensor],
                                                torch.Tensor],
                             tx: Callable, *, enable_double: bool = False,
                             target_model_update: float = 250
                             ) -> Tuple[Callable, Callable]:
    """The DQN update of ``build_dqn_train_step`` cut at the gradient
    (reference :153-228), so learner replicas can reduce their gradients
    between the halves:

    - ``grad_fn(state, batch) -> (grads, ok, metrics, td_abs)``: the
      fused step's loss, double-DQN and |TD| at the current params, and
      ``ok`` (() fp32, 1.0 when the loss, every |TD| and every gradient
      are finite: a replica's non-finite gradient is left out of the
      reduce instead of reaching every member);
    - ``apply_grads(state, grads, ok) -> state'``: the optimizer, the
      step and the target cadence chained as the fused step chains them;
      ``ok <= 0`` passes the input state through, per tensor.

    With the same gradient the halves give the fused step's state to the
    bit (a round of one member divides by 1.0)."""
    grads_of = _dqn_grads(apply_fn, enable_double)
    apply = _dqn_apply(tx, target_model_update)

    def grad_fn(state: TrainState, batch: Batch):
        grads, loss, metrics, td_abs = grads_of(state, batch)
        with torch.no_grad():
            ok = torch.isfinite(loss) & torch.isfinite(td_abs).all()
            for g in grads.values():
                ok = ok & torch.isfinite(g).all()
            return grads, ok.float(), metrics, td_abs

    def apply_grads(state: TrainState, grads: Params, ok) -> TrainState:
        with torch.no_grad():
            ok = torch.as_tensor(ok, dtype=torch.float32,
                                 device=state.step.device)
            return _select(ok > 0, apply(state, grads), state)

    return grad_fn, apply_grads


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
                             tx: Callable, *, enable_double: bool = False,
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
                new_params, new_opt = tx(
                    {k: g[m] for k, g in grads.items()}, opt, params)
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


# ---------------------------------------------------------------------------
# DDPG.  The model's state dict splits by key prefix into its two nets
# (models/ddpg_mlp.py), so each optimizer owns exactly its net.
# ---------------------------------------------------------------------------

def split_ddpg_params(full: Params) -> Dict[str, Params]:
    actor = {k: v for k, v in full.items() if k.startswith("actor")}
    critic = {k: v for k, v in full.items() if k.startswith("critic")}
    if not actor or not critic or len(actor) + len(critic) != len(full):
        raise ValueError(f"unexpected DDPG param layout: {list(full)}")
    return {"actor": actor, "critic": critic}


def merge_ddpg_params(actor: Params, critic: Params) -> Params:
    return {**actor, **critic}


def init_ddpg_train_state(full_params: Params) -> TrainState:
    """The decoupled step's state: params, targets and Adam states as
    ``{"actor": ..., "critic": ...}``, the targets copies of the params."""
    split = {net: {k: v.detach().clone() for k, v in p.items()}
             for net, p in split_ddpg_params(full_params).items()}
    opt = {net: init_adam(p) for net, p in split.items()}
    return TrainState(
        params=split,
        target_params={net: {k: v.clone() for k, v in p.items()}
                       for net, p in split.items()},
        opt_state=opt, step=opt["actor"].count.clone())


def _ddpg_target(actor_fn, critic_fn, target: Dict[str, Params],
                 batch: Batch) -> torch.Tensor:
    """``r + gamma_n Q'(s1, pi'(s1)) (1 - terminal)``, no gradient."""
    with torch.no_grad():
        a_next = actor_fn(target["actor"], batch.state1)
        q_next = critic_fn(target["critic"], batch.state1, a_next)
        return (batch.reward
                + batch.gamma_n * q_next * (1.0 - batch.terminal1))


def _soft_targets(target: Dict[str, Params], online: Dict[str, Params],
                  step: torch.Tensor, target_model_update: float):
    return {net: update_target(target[net], online[net], step,
                               target_model_update) for net in target}


def build_ddpg_train_step(actor_fn: Callable, critic_fn: Callable,
                          actor_tx: Callable, critic_tx: Callable, *,
                          target_model_update: float = 1e-3,
                          huber: bool = False, guard: bool = True
                          ) -> Callable:
    """The decoupled update (reference :491-565): ``step(state, batch) ->
    (state', metrics, td_abs)`` over the split state of
    ``init_ddpg_train_state``."""

    def step(state: TrainState, batch: Batch):
        params, opt = state.params, state.opt_state
        tgt = _ddpg_target(actor_fn, critic_fn, state.target_params, batch)
        cp = _grad_leaves(params["critic"])
        q = critic_fn(cp, batch.state0, batch.action)
        critic_loss, td_abs = _value_loss(q, tgt, batch.weight, huber)
        cgrads = dict(zip(cp, torch.autograd.grad(critic_loss,
                                                  list(cp.values()))))
        with torch.no_grad():
            new_critic, copt = critic_tx(cgrads, opt["critic"],
                                         params["critic"])
        ap = _grad_leaves(params["actor"])
        actor_loss = -torch.mean(critic_fn(
            new_critic, batch.state0, actor_fn(ap, batch.state0)))
        agrads = dict(zip(ap, torch.autograd.grad(actor_loss,
                                                  list(ap.values()))))
        with torch.no_grad():
            new_actor, aopt = actor_tx(agrads, opt["actor"], params["actor"])
            new_params = {"actor": new_actor, "critic": new_critic}
            new_step = state.step + 1
            new = TrainState(new_params, _soft_targets(
                state.target_params, new_params, new_step,
                target_model_update),
                {"actor": aopt, "critic": copt}, new_step)
            metrics = {"learner/critic_loss": critic_loss.detach(),
                       "learner/actor_loss": actor_loss.detach(),
                       "learner/grad_norm": global_norm(
                           {**agrads, **cgrads})}
            return _guarded(guard, new, state, metrics, td_abs)

    return step


def build_ddpg_train_step_coupled(actor_fn: Callable, critic_fn: Callable,
                                  tx: Callable, *,
                                  target_model_update: float = 1e-3,
                                  huber: bool = False, guard: bool = True
                                  ) -> Callable:
    """The coupled update (reference :568-621): one Adam over the merged
    params, one gradient of ``critic_loss + actor_loss``; the state is
    ``init_train_state``'s over the whole state dict."""

    def step(state: TrainState, batch: Batch):
        target = split_ddpg_params(state.target_params)
        tgt = _ddpg_target(actor_fn, critic_fn, target, batch)
        p = _grad_leaves(state.params)
        q = critic_fn(p, batch.state0, batch.action)
        critic_loss, td_abs = _value_loss(q, tgt, batch.weight, huber)
        actor_loss = -torch.mean(critic_fn(p, batch.state0,
                                           actor_fn(p, batch.state0)))
        grads = dict(zip(p, torch.autograd.grad(critic_loss + actor_loss,
                                                list(p.values()))))
        with torch.no_grad():
            new_params, opt = tx(grads, state.opt_state, state.params)
            new_step = state.step + 1
            new = TrainState(new_params, update_target(
                state.target_params, new_params, new_step,
                target_model_update), opt, new_step)
            metrics = {"learner/critic_loss": critic_loss.detach(),
                       "learner/actor_loss": actor_loss.detach(),
                       "learner/grad_norm": global_norm(grads)}
            return _guarded(guard, new, state, metrics, td_abs)

    return step


def _stacked_leaves(params: Params, m: int) -> Params:
    return {k: v.detach().expand(m, *v.shape).requires_grad_(True)
            for k, v in params.items()}


def build_ddpg_megabatch_step(actor_fn: Callable, critic_fn: Callable,
                              actor_tx: Callable, critic_tx: Callable, *,
                              target_model_update: float = 1e-3,
                              huber: bool = False, guard: bool = True
                              ) -> Callable:
    """The decoupled DDPG group step (reference :346-470): ``step(state,
    batches (M, B)) -> (state', metrics, td_abs (M, B), ok (M,))``.
    ``actor_fn`` and ``critic_fn`` take stacked (M, ...) weights over
    (M, B, ...) rows as well as plain ones (models/ddpg_mlp.py)."""

    def step(state: TrainState, batches: Batch):
        M, B = batches.reward.shape
        params, opt, target = (state.params, state.opt_state,
                               state.target_params)
        flat = lambda t: t.reshape(M * B, *t.shape[2:])
        flat_batch = Batch(*(flat(t) for t in batches))
        tgt = _ddpg_target(actor_fn, critic_fn, target,
                           flat_batch).view(M, B)
        # stage 1: the M critic gradients at the group-entry critic
        cs = _stacked_leaves(params["critic"], M)
        q = critic_fn(cs, batches.state0, batches.action)        # (M, B)
        closs, td_abs = _value_loss(q, tgt, batches.weight, huber)
        cgrads = dict(zip(cs, torch.autograd.grad(closs.sum(),
                                                  list(cs.values()))))
        ones = torch.ones(M, device=closs.device)
        with torch.no_grad():
            closs = closs.detach()
            ok_c = (_per_minibatch_ok(closs, td_abs, grads=cgrads.values())
                    if guard else ones)
            cp, copt, critics = params["critic"], opt["critic"], []
            for m in range(M):
                new_cp, new_copt = critic_tx(
                    {k: g[m] for k, g in cgrads.items()}, copt, cp)
                cp, copt = _select(ok_c[m] > 0.5, (new_cp, new_copt),
                                   (cp, copt))
                critics.append(cp)
        # stage 2: the M actor gradients at (the entry actor, the final
        # critic)
        acts = _stacked_leaves(params["actor"], M)
        a = actor_fn(acts, batches.state0)                       # (M, B, d)
        aq = critic_fn(cp, flat(batches.state0), flat(a)).view(M, B)
        aloss = -aq.mean(1)
        agrads = dict(zip(acts, torch.autograd.grad(aloss.sum(),
                                                    list(acts.values()))))
        with torch.no_grad():
            aloss = aloss.detach()
            ok = ok_c * (_per_minibatch_ok(aloss, grads=agrads.values())
                         if guard else ones)
            ap, aopt, tgt_p, step_c = (params["actor"], opt["actor"],
                                       target, state.step)
            for m in range(M):
                new_ap, new_aopt = actor_tx(
                    {k: g[m] for k, g in agrads.items()}, aopt, ap)
                new_step = step_c + 1
                new_tgt = _soft_targets(
                    tgt_p, {"actor": new_ap, "critic": critics[m]},
                    new_step, target_model_update)
                ap, aopt, tgt_p, step_c = _select(
                    ok[m] > 0.5, (new_ap, new_aopt, new_tgt, new_step),
                    (ap, aopt, tgt_p, step_c))
            metrics = {"learner/critic_loss": closs[-1],
                       "learner/actor_loss": aloss[-1],
                       "learner/grad_norm": global_norm(
                           {**{k: g[-1] for k, g in agrads.items()},
                            **{k: g[-1] for k, g in cgrads.items()}})}
            if guard:
                metrics[SKIPPED_KEY] = torch.sum(1.0 - ok)
            td_abs = torch.where(ok[:, None] > 0.5, td_abs,
                                 torch.zeros_like(td_abs))
            new = TrainState({"actor": ap, "critic": cp}, tgt_p,
                             {"actor": aopt, "critic": copt}, step_c)
            return new, metrics, td_abs, ok

    return step
