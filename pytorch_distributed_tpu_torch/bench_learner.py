"""The learner's fused PER update at config 12's full width, timed alone or
beside busy threads, on a ring filled with random rows.

    python -m pytorch_distributed_tpu_torch.bench_learner \\
        [--device cuda] [--torso kernel|module] [--updates 100] \\
        [--busy none|host|actor] [--busy-threads 2] [--eager] \\
        [--profile] [--set k=v ...]

    # the torso with compute_dtype float32 (the fp32 GEMM kernel)
    python -m pytorch_distributed_tpu_torch.bench_learner --profile \\
        --set compute_dtype=float32
    # megabatch groups of 4 in dispatches of 8 updates
    python -m pytorch_distributed_tpu_torch.bench_learner \\
        --set megabatch=4 --set steps_per_dispatch=8

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
    module_apply, probe_env, resolve_device, resolve_fused_step,
)
from pytorch_distributed_tpu_torch.memory.device_per import (
    DevicePerReplay, GraphedFusedStep,
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
    """Every row valid, random frames, actions and rewards, and random
    priorities."""
    st = ring.state
    for col in (st.state0, st.state1):
        col.copy_(torch.randint(0, 255, col.shape, generator=gen,
                                device=col.device, dtype=torch.uint8))
    st.action.copy_(torch.randint(0, num_actions, st.action.shape,
                                  generator=gen, device=st.action.device))
    st.reward.normal_(generator=gen)
    st.gamma_n.fill_(0.99 ** 5)
    st.priority.uniform_(0.1, 1.0, generator=gen)
    st.fill = ring.capacity
    st.fill_rows.fill_(float(ring.capacity))


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
    gen = torch.Generator(device=device).manual_seed(opt.seed)
    ring = DevicePerReplay(opt.memory_params.memory_size, spec.state_shape,
                           device=device)
    fill_ring(ring, spec.num_actions, gen)
    model = build_model(opt, spec)
    state, step = build_train_state_and_step(
        opt, model, init_params(opt, spec, seed=opt.seed, device=device))
    M, K, mega_step = resolve_fused_step(opt, model, "bench_learner")
    fused = ring.build_fused_step(step, ap.batch_size, steps_per_call=K,
                                  megabatch=M, megabatch_step=mega_step)
    if device.type == "cuda" and graph:
        fused = GraphedFusedStep(fused, ring.state, counters=COUNTED)

    def updates_of(n: int) -> None:
        """``n`` updates, rounded up to whole dispatches of K."""
        nonlocal state
        for _ in range(-(-n // K)):
            us = torch.rand((K, ap.batch_size), generator=gen, device=device)
            state, _m = fused(state, ring.state, us, 0.4)

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
    out = {"torso": "kernel" if opt.learner_perf_params.pallas_torso
           else "module", "compute_dtype": opt.model_params.compute_dtype,
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
    out = run(build_options(12, **overrides), args.updates, args.busy,
              args.busy_threads, args.profile, graph=not args.eager)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
