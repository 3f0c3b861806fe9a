"""The R2D2 sequence update as tensor code — the port of the DRQN half of
pytorch_distributed_tpu/ops/sequence_losses.py: ``value_rescale`` /
``value_unrescale`` (:48-57), ``unpack_frame_stacks`` (:60-69),
``unroll`` (:72-81), ``nstep_window_returns`` (:84-116),
``_masked_loss_and_priority`` (:119-130), ``_bootstrap_values``
(:133-141), ``_apply_update`` (:144-157), ``build_drqn_train_step``
(:159-229) and ``build_dtqn_train_step`` (:232-312).

``step(state, batch) -> (state', metrics, seq_priorities)`` on a
``SegmentBatch`` of tensors:

- the target net unrolls the whole window from the stored carry (its
  burn-in and its train window are one unroll, the same as the
  reference's two chained ones) with no gradient;
- the online net's burn-in prefix runs with no gradient and its carry is
  detached (the reference's ``stop_gradient``), then the train window
  unrolls with gradients;
- the targets are within-window n-step returns with double-DQN bootstraps
  (the online argmax, the target's value), through the value rescaling
  h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x and its inverse;
- the loss is the IS-weighted masked squared error over the valid steps;
  the sequence priorities are ``eta max |td| + (1 - eta) mean |td|`` over
  them;
- Adam, the target cadence and the finite guard are ops/losses.py's (the
  guard reads ``numeric_guards`` through ``health.resolve`` in the
  factory).

``model`` is a models/drqn.py model: its ``sequence(params, obs_tm,
carry)`` runs the torso over all of a window's frames at once and steps
only the LSTM cell over time.  ``packed_frames=C``: ``batch.obs`` is the
frame-packed (B, T+C, H, W) and the stacks are rebuilt here, on the
batch's device.

The DTQN step has the same contract with one causal pass per segment in
place of the unrolls: ``window_apply(params, obs (B, T+1, *S))`` gives
(B, T+1, A), or ``(q, aux)`` for the MoE family, whose load-balancing
loss joins the TD loss with ``aux_weight`` and is reported as
``learner/moe_aux``.  The target pass runs ``target_window_apply`` where
one is given (q only), with no gradient.
"""

from __future__ import annotations

from typing import Callable

import torch

from pytorch_distributed_tpu_torch.ops.losses import (
    TrainState, _guarded, global_norm, update_target,
)

RESCALE_EPS = 1e-3


def value_rescale(x: torch.Tensor, eps: float = RESCALE_EPS) -> torch.Tensor:
    return torch.sign(x) * (torch.sqrt(torch.abs(x) + 1.0) - 1.0) + eps * x


def value_unrescale(x: torch.Tensor,
                    eps: float = RESCALE_EPS) -> torch.Tensor:
    """The closed-form inverse of ``value_rescale``."""
    return torch.sign(x) * (torch.square(
        (torch.sqrt(1.0 + 4.0 * eps * (torch.abs(x) + 1.0 + eps)) - 1.0)
        / (2.0 * eps)) - 1.0)


def unpack_frame_stacks(frames: torch.Tensor, C: int,
                        seq_len: int) -> torch.Tensor:
    """Frame-packed segments (B, T+C, H, W) -> C-stacked observations (B,
    T+1, C, H, W): stack t is frames [t, t+C), channel 0 the oldest."""
    return torch.stack([frames[:, i:i + seq_len + 1] for i in range(C)],
                       dim=2)


def unroll(step_fn: Callable, params, carry, obs_tm: torch.Tensor):
    """The single-step recurrent apply scanned over a time-major sequence
    (T, B, ...): ``(carry_out, q_seq (T, B, A))``, the reference's
    ``unroll``.  The learner runs the model's ``sequence`` instead, which
    gives the same values with the torso batched over time."""
    qs = []
    for t in range(obs_tm.shape[0]):
        q, carry = step_fn(params, obs_tm[t], carry)
        qs.append(q)
    return carry, torch.stack(qs)


def nstep_window_returns(boot: torch.Tensor, r_tm: torch.Tensor,
                         d_tm: torch.Tensor, m_tm: torch.Tensor, *,
                         nstep: int, gamma: float) -> torch.Tensor:
    """Within-window n-step returns: for each position t of the window,

        G_t = sum_{k<K} gamma^k r_{t+k} alive_{t,k} m_{t+k}
              + gamma^K alive_{t,K} boot_{t+K}

    with K = min(nstep, n_valid - t, L - t) — the lookahead shrinks at the
    window's end and at a masked tail (a truncated episode ends its
    segment without a terminal, so the bootstrap comes from the successor
    obs stored right after the tail) — and alive_{t,k} = prod_{j<k} (1 -
    terminal_{t+j}), which zeroes the bootstrap past a real death.
    ``boot`` is (L+1, B), already unrescaled; r, d, m are (L, B)."""
    L = r_tm.shape[0]
    pad = lambda x: torch.cat([x, x.new_zeros((nstep, *x.shape[1:]))], 0)
    r_p, d_p, m_p = pad(r_tm), pad(d_tm), pad(m_tm)
    ret = torch.zeros_like(r_tm)
    alive = torch.ones_like(r_tm)
    for k in range(nstep):
        ret = ret + (gamma ** k) * r_p[k:k + L] * alive * m_p[k:k + L]
        alive = alive * (1.0 - d_p[k:k + L])
    idx_t = torch.arange(L, device=r_tm.device)[:, None]
    n_valid = m_tm.sum(0).to(torch.int64)
    boot_idx = torch.clamp(torch.minimum(idx_t + nstep, n_valid[None, :]),
                           max=L)
    boot_at = torch.gather(boot, 0, boot_idx)
    K = torch.clamp(boot_idx - idx_t, min=0).to(r_tm.dtype)
    return ret + torch.pow(gamma, K) * alive * boot_at


def masked_loss_and_priority(q_sel, target, m_tm, weight, eta: float):
    """``(loss, seq_priorities)``: the IS-weighted masked squared error
    over the valid steps, and the eta-blended max / mean |td| of each
    sequence."""
    td = q_sel - target.detach()
    loss = torch.sum(td.square() * m_tm * weight[None, :]) / torch.clamp(
        m_tm.sum(), min=1.0)
    td_abs = td.detach().abs() * m_tm
    valid = torch.clamp(m_tm.sum(0), min=1.0)
    seq_pr = eta * td_abs.amax(0) + (1.0 - eta) * td_abs.sum(0) / valid
    return loss, seq_pr


def bootstrap_values(q_tm, q_target_tm, enable_double: bool,
                     h_inv: Callable) -> torch.Tensor:
    """Each position's bootstrap value, unrescaled: the target's value at
    the online argmax (double DQN) or the target's max."""
    if enable_double:
        a_star = q_tm.argmax(-1, keepdim=True)
        boot = torch.gather(q_target_tm, -1, a_star)[..., 0]
    else:
        boot = q_target_tm.amax(-1)
    return h_inv(boot)


def build_drqn_train_step(model, tx: Callable, *, burn_in: int = 10,
                          nstep: int = 5, gamma: float = 0.99,
                          enable_double: bool = True,
                          target_model_update: float = 2500,
                          rescale_values: bool = True,
                          priority_eta: float = 0.9, packed_frames: int = 0,
                          guard: bool = True) -> Callable:
    """``step(state, batch) -> (state', metrics, seq_priorities (B,))``;
    ``tx`` from ops/losses.make_optimizer."""
    seq = model.sequence
    h = value_rescale if rescale_values else (lambda x: x)
    h_inv = value_unrescale if rescale_values else (lambda x: x)

    def step(state: TrainState, batch):
        T = batch.action.shape[1]
        obs = batch.obs
        if packed_frames:
            obs = unpack_frame_stacks(obs, packed_frames, T)
        obs_tm = obs.transpose(0, 1)                      # (T+1, B, ...)
        carry0 = (batch.c0, batch.h0)
        with torch.no_grad():
            q_target_tm = seq(state.target_params, obs_tm,
                              carry0)[0][burn_in:]        # (L+1, B, A)
            bcarry = (seq(state.params, obs_tm[:burn_in], carry0)[1]
                      if burn_in else carry0)
        a_tm = batch.action.t()[burn_in:].long()          # (L, B)
        r_tm = batch.reward.t()[burn_in:]
        d_tm = batch.terminal.t()[burn_in:]
        m_tm = batch.mask.t()[burn_in:]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        q_tm, _ = seq(leaves, obs_tm[burn_in:], bcarry)
        q_sel = torch.gather(q_tm[:-1], -1, a_tm[..., None])[..., 0]
        with torch.no_grad():
            boot = bootstrap_values(q_tm, q_target_tm, enable_double, h_inv)
            target = h(nstep_window_returns(boot, r_tm, d_tm, m_tm,
                                            nstep=nstep, gamma=gamma))
        loss, seq_pr = masked_loss_and_priority(q_sel, target, m_tm,
                                                batch.weight, priority_eta)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        with torch.no_grad():
            q_mean = q_tm.amax(-1).mean()
            new_params, opt = tx(grads, state.opt_state, state.params)
            new_step = state.step + 1
            new = TrainState(new_params, update_target(
                state.target_params, new_params, new_step,
                target_model_update), opt, new_step)
            metrics = {"learner/critic_loss": loss.detach(),
                       "learner/q_mean": q_mean,
                       "learner/grad_norm": global_norm(grads)}
            return _guarded(guard, new, state, metrics, seq_pr)

    return step


def build_dtqn_train_step(window_apply: Callable, tx: Callable, *,
                          burn_in: int = 10, nstep: int = 5,
                          gamma: float = 0.99, enable_double: bool = True,
                          target_model_update: float = 2500,
                          rescale_values: bool = True,
                          priority_eta: float = 0.9, aux_weight: float = 0.0,
                          target_window_apply: Callable = None,
                          guard: bool = True) -> Callable:
    """``step(state, batch) -> (state', metrics, seq_priorities (B,))``.
    The factory passes ``burn_in`` 0 (reference factory.py:565-570): the
    positions before ``burn_in`` would be attention context only."""
    h = value_rescale if rescale_values else (lambda x: x)
    h_inv = value_unrescale if rescale_values else (lambda x: x)

    def split_apply(params, obs):
        out = window_apply(params, obs)
        return out if isinstance(out, tuple) else (out, None)

    def target_apply(params, obs):
        if target_window_apply is not None:
            return target_window_apply(params, obs)
        return split_apply(params, obs)[0]

    def step(state: TrainState, batch):
        T = batch.action.shape[1]
        to_tm = lambda q: q.transpose(0, 1)[burn_in:]    # (L+1, B, A)
        with torch.no_grad():
            q_target_tm = to_tm(target_apply(state.target_params, batch.obs))
        a_tm = batch.action.t()[burn_in:].long()          # (L, B)
        r_tm = batch.reward.t()[burn_in:]
        d_tm = batch.terminal.t()[burn_in:]
        m_tm = batch.mask.t()[burn_in:]
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        q, aux = split_apply(leaves, batch.obs)
        q_tm = to_tm(q)
        q_sel = torch.gather(q_tm[:T - burn_in], -1, a_tm[..., None])[..., 0]
        with torch.no_grad():
            boot = bootstrap_values(q_tm, q_target_tm, enable_double, h_inv)
            target = h(nstep_window_returns(boot, r_tm, d_tm, m_tm,
                                            nstep=nstep, gamma=gamma))
        loss, seq_pr = masked_loss_and_priority(q_sel, target, m_tm,
                                                batch.weight, priority_eta)
        if aux is not None:
            loss = loss + aux_weight * aux
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        with torch.no_grad():
            q_mean = q_tm.amax(-1).mean()
            new_params, opt = tx(grads, state.opt_state, state.params)
            new_step = state.step + 1
            new = TrainState(new_params, update_target(
                state.target_params, new_params, new_step,
                target_model_update), opt, new_step)
            metrics = {"learner/critic_loss": loss.detach(),
                       "learner/q_mean": q_mean,
                       "learner/grad_norm": global_norm(grads)}
            if aux_weight:
                metrics["learner/moe_aux"] = (
                    aux.detach() if aux is not None else torch.zeros_like(q_mean))
            return _guarded(guard, new, state, metrics, seq_pr)

    return step
