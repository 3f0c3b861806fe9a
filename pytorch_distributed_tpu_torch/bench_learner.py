"""The learner's fused PER update at config 12's full width (or another
row's: ``--config 19``, the wide torso; ``--config 2`` or ``16``, DDPG on
a ``device-per`` ring of low-dim rows; ``--config 14``, R2D2's fused
burn-in update on the device segment ring of 1,250 frame-packed
segments; ``--config 13``, ``15``, ``17`` or ``18``, the recurrent and
transformer Q-networks' update on the row's host ``sequence`` ring, as
the learner runs it there: a draw on the host, the upload through pinned
memory, the eager update and the priorities' write-back; with ``--set
memory_type=device-sequence`` the fused update on the device segment
ring), timed alone or beside busy threads, on a ring filled with random
rows.

    python -m pytorch_distributed_tpu_torch.bench_learner [--config 12] \\
        [--device cuda] [--torso kernel|module] [--updates 100] \\
        [--busy none|host|actor] [--busy-threads 2] [--eager] \\
        [--profile] [--set k=v ...]

    # the torso with compute_dtype float32 (the fp32 GEMM kernel)
    python -m pytorch_distributed_tpu_torch.bench_learner --profile \\
        --set compute_dtype=float32
    # megabatch groups of 4 in dispatches of 8 updates
    python -m pytorch_distributed_tpu_torch.bench_learner \\
        --set megabatch=4 --set steps_per_dispatch=8
    # DDPG (row 16's reacher: 10-d states, 2-d actions, batch 64)
    python -m pytorch_distributed_tpu_torch.bench_learner --config 16
    # R2D2 (row 14: 64 segments of 80 steps, burn-in 40, LSTM 512)
    python -m pytorch_distributed_tpu_torch.bench_learner --config 14
    # DTQN (row 15: 64 windows of 81 steps, width 128, 4 heads, depth 2)
    python -m pytorch_distributed_tpu_torch.bench_learner --config 15 \\
        --set memory_type=device-sequence

The dispatch is resolved as the learner resolves it
(``factory.resolve_fused_step``): with ``megabatch`` M > 1 it runs K/M
group steps, K rounded up to a multiple of M.

``--busy`` starts threads beside the learner, as the thread backend's
actors would run: ``host`` steps 16 Pong simulators with random actions
(numpy only); ``actor`` also picks them with a batch-16 forward of the
model on the card, on a high-priority stream of its own, and copies them
back, as an actor does; the timed window starts once every busy thread
has ticked.  On a GPU the update is replayed from a CUDA graph, as the
learner runs it, unless ``--eager``.  Prints one JSON object: wall
milliseconds and updates per second over ``--updates`` updates (ending in
a device synchronise), the kernels' launches per update in that window
(``launches_per_update``), and with ``--profile`` the profiler's device
milliseconds per update by kernel, and summed for each of the port's
kernels (``kernel_device_ms``).
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np
import torch

from pytorch_distributed_tpu_torch.config import (
    build_options, parse_set_overrides,
)
from pytorch_distributed_tpu_torch.factory import (
    build_env_vector, build_model, build_train_state_and_step, init_params,
    compute_dtype, lstm_dim_of, module_apply, probe_env, resolve_device,
    resolve_fused_step, segment_capacity, sequence_pack_frames, state_dtype,
)
from pytorch_distributed_tpu_torch.memory.device_per import (
    DevicePerReplay, GraphedFusedStep,
)
from pytorch_distributed_tpu_torch.memory.device_sequence import (
    DeviceSequenceReplay,
)
from pytorch_distributed_tpu_torch.memory.sequence_replay import (
    SequenceReplay,
)
from pytorch_distributed_tpu_torch.ops.cuda_sampling import (
    hierarchical_sample,
)
from pytorch_distributed_tpu_torch.ops.cuda_torso import (
    COUNTERS as GEMM_COUNTERS,
)


# the kernels' launch counters
COUNTED = (hierarchical_sample, *GEMM_COUNTERS)
# how long the busy threads may take to tick once
BUSY_START_S = 300.0


def kernel_label(name: str):
    """The row of PERF.md's kernel table that the profiler's kernel
    ``name`` belongs to, or None.  The bf16 GEMM's forward instantiations
    read both operands K-major (``<BM, BN, false, false>``); the fp32 GEMM
    is one row, forward and backward; the split-K reduce is shared by all
    the GEMMs."""
    if "sample_kernel" in name:
        return "per_sample"
    if "gemm_bf16_sm90" in name:
        return ("torso_gemm_fwd" if "false, false>" in name
                else "torso_gemm_bwd")
    if "gemm_f32_sm90" in name:
        return "torso_gemm_f32"
    if "splitk_reduce_kernel" in name:
        return "splitk_reduce"
    return None


def fill_ring(ring: DevicePerReplay, num_actions: int,
              gen: torch.Generator) -> None:
    """Every row valid, random frames (or standard normal low-dim states),
    actions (discrete, or uniform in [-1, 1]) and rewards, and random
    priorities."""
    st = ring.state
    for col in (st.state0, st.state1):
        if col.dtype == torch.uint8:
            col.copy_(torch.randint(0, 255, col.shape, generator=gen,
                                    device=col.device, dtype=torch.uint8))
        else:
            col.normal_(generator=gen)
    if st.action.dtype.is_floating_point:
        st.action.uniform_(-1.0, 1.0, generator=gen)
    else:
        st.action.copy_(torch.randint(0, num_actions, st.action.shape,
                                      generator=gen,
                                      device=st.action.device))
    st.reward.normal_(generator=gen)
    st.gamma_n.fill_(0.99 ** 5)
    st.priority.uniform_(0.1, 1.0, generator=gen)
    st.fill = ring.capacity
    st.fill_rows.fill_(float(ring.capacity))


def segment_ring(opt, spec, device,
                 gen: torch.Generator) -> DeviceSequenceReplay:
    """Row 14's device segment ring at the run's geometry, every row valid:
    random frames, actions and rewards, a death in about one step in 200,
    whole masks, small random stored carries and random priorities."""
    ap = opt.agent_params
    ring = DeviceSequenceReplay(
        segment_capacity(opt), ap.seq_len, spec.state_shape,
        lstm_dim_of(opt),
        state_dtype=torch.from_numpy(np.zeros(0, state_dtype(opt))).dtype,
        priority_exponent=opt.memory_params.priority_exponent,
        importance_weight=opt.memory_params.priority_weight,
        pack_frames=sequence_pack_frames(opt), device=device)
    st = ring.state
    if st.obs.dtype == torch.uint8:
        st.obs.copy_(torch.randint(0, 255, st.obs.shape, generator=gen,
                                   device=device, dtype=torch.uint8))
    else:
        st.obs.normal_(generator=gen)
    st.action.copy_(torch.randint(0, spec.num_actions, st.action.shape,
                                  generator=gen, device=device))
    st.reward.normal_(generator=gen)
    st.terminal.copy_((torch.rand(st.terminal.shape, generator=gen,
                                  device=device) < 0.005).float())
    st.mask.fill_(1.0)
    for c in (st.c0, st.h0):
        c.normal_(generator=gen).mul_(0.1)
    st.priority.uniform_(0.1, 1.0, generator=gen)
    st.fill = ring.capacity
    st.fill_rows.fill_(float(ring.capacity))
    return ring


def host_segment_ring(opt, spec, rng: np.random.Generator
                      ) -> SequenceReplay:
    """The row's host segment ring at the run's geometry, every row valid:
    standard normal observations, random actions and rewards, whole
    masks, no death, small random stored carries and random
    priorities."""
    ap = opt.agent_params
    ring = SequenceReplay(
        segment_capacity(opt), ap.seq_len, spec.state_shape,
        lstm_dim_of(opt), state_dtype=state_dtype(opt),
        priority_exponent=opt.memory_params.priority_exponent,
        importance_weight=opt.memory_params.priority_weight,
        pack_frames=sequence_pack_frames(opt))
    ring.obs[...] = rng.normal(size=ring.obs.shape)
    ring.action[...] = rng.integers(0, spec.num_actions, ring.action.shape)
    ring.reward[...] = rng.normal(size=ring.reward.shape)
    ring.mask[...] = 1.0
    for c in (ring.c0, ring.h0):
        c[...] = 0.1 * rng.normal(size=c.shape)
    ring.priority[...] = rng.uniform(0.1, 1.0, ring.capacity)
    ring.full = True
    return ring


def _busy(kind: str, opt, spec, device, params, stop: threading.Event,
          ticks: list, index: int) -> None:
    env = build_env_vector(opt, index, 16)
    apply_fn = module_apply(build_model(opt, spec))
    rng = np.random.default_rng(index)
    obs = env.reset()
    stream = (torch.cuda.Stream(device, priority=-1)
              if device.type == "cuda" else None)
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(device))
    while not stop.is_set():
        if kind == "actor":  # on its own stream, as an actor
            with torch.no_grad(), torch.cuda.stream(stream):
                q = apply_fn(params, torch.from_numpy(obs).to(device))
                actions = q.argmax(-1).cpu().numpy()
        else:
            actions = rng.integers(0, spec.num_actions, 16)
        obs, _r, _t, _i = env.step(actions)
        ticks[index] += 1


def run(opt, updates: int = 100, busy: str = "none", busy_threads: int = 2,
        profile: bool = False, graph: bool = True) -> dict:
    device = resolve_device(opt)
    spec = probe_env(opt)
    ap = opt.agent_params
    if busy == "actor" and opt.agent_type == "r2d2":
        raise ValueError("--busy actor runs the flat families' forward")
    gen = torch.Generator(device=device).manual_seed(opt.seed)
    host_ring = opt.agent_type == "r2d2" and opt.memory_type == "sequence"
    if host_ring:
        ring = host_segment_ring(opt, spec, np.random.default_rng(opt.seed))
    elif opt.agent_type == "r2d2":
        ring = segment_ring(opt, spec, device, gen)
    else:
        ring = DevicePerReplay(
            opt.memory_params.memory_size, spec.state_shape,
            spec.action_shape,
            state_dtype=torch.from_numpy(np.zeros(0, state_dtype(opt))).dtype,
            action_dtype=torch.from_numpy(
                np.zeros(0, spec.action_dtype)).dtype,
            device=device)
        fill_ring(ring, spec.num_actions, gen)
    model = build_model(opt, spec, init_weights=False)  # the structure
    state, step = build_train_state_and_step(
        opt, model, init_params(opt, spec, seed=opt.seed, device=device))
    if host_ring:
        from pytorch_distributed_tpu_torch.agents.learner import upload_batch

        M, K, fused = 1, 1, None
        rng = np.random.default_rng(opt.seed + 1)

        def dispatch(state):
            batch = ring.sample(ap.batch_size, rng)
            state, _m, td = step(state, upload_batch(batch, device))
            ring.update_priorities(batch.index, td.cpu().numpy())
            return state
    else:
        M, K, mega_step = resolve_fused_step(opt, model, "bench_learner")
        fused = ring.build_fused_step(step, ap.batch_size, steps_per_call=K,
                                      megabatch=M, megabatch_step=mega_step)
        if device.type == "cuda" and graph:
            fused = GraphedFusedStep(fused, ring.state, counters=COUNTED)

        def dispatch(state):
            us = torch.rand((K, ap.batch_size), generator=gen, device=device)
            return fused(state, ring.state, us, 0.4)[0]

    def updates_of(n: int) -> None:
        """``n`` updates, rounded up to whole dispatches of K."""
        nonlocal state
        for _ in range(-(-n // K)):
            state = dispatch(state)

    stop = threading.Event()
    ticks = [0] * busy_threads
    threads = [] if busy == "none" else [
        threading.Thread(target=_busy, daemon=True, args=(
            busy, opt, spec, device, state.params, stop, ticks, i))
        for i in range(busy_threads)]
    updates_of(3 * K)  # warm-up, and the graph's capture
    for t in threads:
        t.start()
    deadline = time.monotonic() + BUSY_START_S
    # a busy thread's first tick builds its model and env
    while threads and not all(ticks):
        if (time.monotonic() > deadline
                or not all(t.is_alive() for t in threads)):
            raise RuntimeError(f"busy threads ticked {ticks} before "
                               f"timing, within {BUSY_START_S} s")
        time.sleep(0.01)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    sync()
    ticks0 = sum(ticks)
    for c in COUNTED:
        c.launches = 0
    t0 = time.perf_counter()
    updates_of(updates)
    sync()
    seconds = time.perf_counter() - t0
    updates = -(-updates // K) * K
    launches = {c.__name__: c.launches / updates for c in COUNTED}
    busy_ticks = sum(ticks) - ticks0
    kernel_torso = (opt.model_type == "dqn-cnn"
                    and opt.learner_perf_params.pallas_torso)
    out = {"config": opt.config, "memory_type": opt.memory_type,
           "torso": "kernel" if kernel_torso else "module",
           "compute_dtype": str(compute_dtype(opt)).split(".")[-1],
           "cuda_graph": isinstance(fused, GraphedFusedStep),
           "steps_per_dispatch": K, "megabatch": M, "busy": busy,
           "busy_threads": len(threads), "updates": updates,
           "wall_ms_per_update": seconds * 1e3 / updates,
           "updates_per_sec": updates / seconds,
           "busy_ticks_per_sec": busy_ticks / seconds,
           "launches_per_update": launches}
    if profile and device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        profiled = -(-20 // K) * K
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            updates_of(profiled)
            sync()
        rows = sorted(((e.key, e.self_device_time_total / (profiled * 1e3))
                       for e in prof.key_averages()
                       if e.self_device_time_total > 0),
                      key=lambda r: -r[1])
        out["device_ms_per_update"] = sum(r[1] for r in rows)
        out["kernel_device_ms"] = {}
        for k, v in rows:
            label = kernel_label(k)
            if label is not None:
                out["kernel_device_ms"][label] = (
                    out["kernel_device_ms"].get(label, 0.0) + v)
        out["top_device_ms"] = [(k[:64], round(v, 5)) for k, v in rows[:24]]
    stop.set()
    for t in threads:
        t.join(timeout=30.0)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=int, default=12,
                   help="the CONFIGS row (12; 19 for the wide torso)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--torso", choices=("kernel", "module"), default="kernel")
    p.add_argument("--updates", type=int, default=100)
    p.add_argument("--busy", choices=("none", "host", "actor"),
                   default="none")
    p.add_argument("--busy-threads", type=int, default=2)
    p.add_argument("--eager", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--set", action="append", default=[], metavar="K=V")
    args = p.parse_args(argv)
    overrides = dict(device=args.device,
                     pallas_torso=args.torso == "kernel")
    overrides.update(parse_set_overrides(args.set))
    out = run(build_options(args.config, **overrides), args.updates,
              args.busy, args.busy_threads, args.profile,
              graph=not args.eager)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
