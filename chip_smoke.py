#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. build: compiles ``pytorch_distributed_tpu_torch/csrc/*.cu`` with nvcc
   (one process per source, all at once) and times it, then reads the
   GEMMs' SASS (``cuobjdump``): the bf16 GEMM's instantiations of every
   operand layout, K-major and transposed, must hold wgmma (``HGMMA``) and
   TMA loads (``UTMALDG``); every instantiation of the fp32 GEMM must hold
   ``UTMALDG``, ``FFMA`` and 128-bit shared loads (``LDS.128``) and no
   local memory (``LDL``/``STL``); prints the registers per thread;
2. per_sample: kernel B1 (the PER draw, one launch) against its plain
   PyTorch version on the card, at config 12's shapes (a 50,000-row
   priority vector, 128 draws), on random priorities and on a case forced
   onto the zero-row remap; the profiler's count of kernels per eager
   call; kernel, plain and library (cumsum + searchsorted) times;
3. torso_gemm: kernel B2 (the torso GEMM: ``torso_gemm_sm90.cu`` for the
   bf16 torso, ``torso_gemm.cu`` for the torso with ``compute_dtype``
   float32) against its plain version on the card, at each GEMM shape of
   one config-12 update, 10 forward and 9 backward GEMMs for each type,
   the forward's operands both K-major and the backward's transposed
   views, as the main path hands them over (``bench_gemm.update_gemms``),
   with kernel, plain and library (``torch.matmul``) times; then each
   kernel alone on a sweep of ragged shapes in each of the four operand
   layouts, every tile of its plan, split and unsplit, and operands with
   200-byte lines, which no TMA descriptor reads (they must raise, with
   no launch);
4. torso_apply: the kernel torso against the ``nn.Module`` forward, and
   its gradients against autograd through the module, on a small batch;
5. learner_alone: for the bf16 torso and for the torso with
   ``compute_dtype`` float32, the CUDA-graph replay of the fused update
   against the eager update (identical results), then the update on a
   full random ring with no actors (``bench_learner.run``), with the
   kernel torso and with the module's forward, graphed and eager, with
   the profiler's device time per update; the launch counters are zeroed
   just before each timed window and read just after: per update 1 draw
   and, for the kernel torso, 10 forward and 9 backward GEMMs of the
   torso's type and none of the other;
6. native_pong: the C++ Pong stepper (``native/pong_batch.cpp``) built
   with g++ on this host, 16 envs x 1,000 ticks of random actions against
   the numpy simulators (ms a tick), and its dynamics against the numpy
   ``PongSimEnv`` to the bit under ``set_state``;
7. device_env: torch device Pong (``envs/device_env.py``) on the card
   against the numpy float32 oracle, every state and StepOut field to
   the bit at every step of 350 steps of 32 envs (three truncated
   episodes); ms per tick at 32, 256 and 1,024 envs, one step replayed
   from a CUDA graph (device time) and eager;
8. fused_rollout: config 12's fleet (32 envs, 8 ticks a dispatch) as
   one fused rollout: the graphed rollout against the same rollout run
   eagerly, every chunk column to the bit; ``emit="replay"`` against
   ``emit="chunk"`` fed into a ring, the rings to the bit; device ms per
   dispatch and frames/s of the rollout alone;
9. actor_tick: one CPU actor in a spawn child set up as the process
   backend's (the CPU, its thread share), 300 ticks of 16 envs inline and
   pipelined on native and numpy Pong: the StepTimer's phases in ms a
   tick, frames/s, and the inline and pipelined transition streams
   identical (sha256 of every row);
10. actor_gpu: one actor in this process inferring on the card, as the
   thread backend runs it (its own stream; pinned staging; a
   non-blocking copy of the actions and an event), 300 ticks of 16 envs
   inline and pipelined, with a second snapshot published at tick 100 so
   that the prefetcher's stream path (a copy on its own stream, an
   event, ``record_stream``) runs inside the window: the two transition
   streams identical, each with the second weights swapped in;
11. staged_drain: the same rows through the blocking path (``feed_chunk``
   of a stacked chunk) and the staged path (the ingest queue's ``drain``:
   pinned slabs, non-blocking copies) into two rings on the card, with a
   drain larger than one slab and a wrap: the rings equal to the bit;
12. train: config 12 at full width through the port's entry point
   (``pytorch_distributed_tpu_torch.main``) on the thread backend with the
   kernel torso on, native Pong and pipelined actors (the defaults), an
   evaluator of one capped episode, and logs and checkpoints under a
   temporary directory; the kernels' launch counters are zeroed just
   before and read just after: per update 1 draw, 10 forward and 9
   backward bf16 GEMMs, no fp32 GEMM; the actors' timer phases from
   ``scalars.jsonl``;
13. train_process: the same run on the process backend (actors, the
   evaluator and the logger in spawn children on the CPU, the learner in
   this process), after a check of the learner's publication off the
   loop against the inline flatten: the same launches per update, read
   here; a finite loss;
   no child with a CUDA context; ``scalars.jsonl`` with evaluator and
   learner rows; a params file and its ``_best`` tier; prints updates/s,
   actor frames/s, the actors' phases, the replay ratio and the learner's
   host seconds per part beside the thread backend's;
14. test_mode: ``main --mode 2`` on that params file, one capped episode
   with inference on the card: finite stats of one episode, and the peak
   of allocated device memory up by at least the weights' bytes;
15. process_trace: the process run again with the device traced by
   ``torch.profiler`` (CUDA activity only, started and stopped in the
   learner's thread between graph replays) over updates 600 to 850: the
   device's idle share in that window as traced, its busy ms per update,
   and, labelled as an estimate, the idle share that busy time would
   leave at train_process's unprofiled rate;
16. train_paced: the process run with the reference's config-12 pacing
   (``max_replay_ratio`` 8, ``learn_start`` 5,000): updates/s, the pacing
   seconds, the actors' phases, the same launches per update;
17. inference: the shared inference server (``actor_backend=batched``)
   alone on the card, on random weights: one batched actor of 16 envs,
   300 ticks of native Pong with every env reset at ticks 100 and 200
   (so full uploads reseed the server's stack between packed ones),
   against an ``inline`` actor on its own CUDA stream at the same seed and
   weights: identical transition streams (sha256 of every row); each
   program's CUDA graph against the same act run eagerly, to the bit;
   sweeps of 2 and 6 clients' full requests coalesced into one forward,
   each client's q_sel and q_max against its own 16-row forward within
   rtol and atol 1e-2 (a wider batch may pick other convolution
   algorithms), and its actions equal wherever the top-two gap exceeds
   that; the share of equal actions; round trip ms per request, device
   ms per forward (graph replays timed by events) and rows per sweep at
   1, 2 and 6 clients;
18. train_batched: the process run with ``actor_backend=batched``,
   unpaced and then paced as train_paced: the same launches per update,
   a finite loss, no child with CUDA, ``inference/rows`` equal to the
   actors' frames within one tick per actor; updates/s, frames/s, the
   actors' phases, the learner's host seconds and the server's counts
   beside train_process's and train_paced's;
19. train_anakin: config 12 at full width through ``main`` with
   ``actor_backend=anakin`` (the fleet and the learner in this process,
   the evaluator and the logger in children), strict and at
   ``rollout_ratio`` 16: the same launches per update, a finite loss,
   no actor child and no child with CUDA, evaluator rows; updates/s,
   frames/s and the duty cycle; then each variant's loop driven here by
   ``AnakinDriver``'s own scheduler and traced by ``torch.profiler`` over a
   window (40 updates strict, 200 at ratio 16, the profiler started and
   stopped between dispatches in the launching thread): the device's
   idle share as traced and, as an estimate, at the untraced rate;
20. train_device: the process run with ``actor_backend=device`` (each
   actor child one fused rollout on the CPU): the same checks, frames/s,
   the actors' phases and the learner's host seconds; then one device
   actor on the card as the thread backend runs it (40 dispatches);
21. resume: supervision and resume at full width, in three legs. (1) A
   process-backend run here, paced (``max_replay_ratio`` 8), with the
   hang watchdog at 10 s and an epoch every 500 steps: a timer thread
   SIGKILLs ``actor-0`` once the learner passes step 300 and SIGSTOPs
   ``actor-1`` after step 900; the run must finish its 3,500 steps
   (enough that, on a fast host, the watchdog's 10 s and the respawn
   fall well before the end) with 2
   restarts and 1 hang kill, no child with CUDA and the same launches
   per update; the time from the kill to the respawned child's first
   tick. (2) ``main`` in a subprocess with ``checkpoint_replay`` on, sent
   SIGTERM once its log passes step 1,000: it must exit 0 within 60 s,
   and its newest epoch must pass ``ckpt_fsck`` and hold ``state.pt``,
   ``replay.npz`` and ``extras.json``. (3) A run here with ``resume``
   "must" on the same refs: its first published weights equal to the bit
   the epoch's ``state.pt`` params, its ring restored with the epoch's
   rows, then its steps with the same launches per update. It prints the
   epochs' bytes and save seconds with and without the ring, the rows
   and seconds of the restore, and ``train_process``'s updates/s.

22. health: the health plane at full width on the process backend,
   with the reference's defaults (detector, rollback ladder, quarantine).
   (a) The rollback drill: ``TPU_APEX_QUARANTINE=0``, actor-0 alone
   poisons four flushes after the epoch of step 800 (``FEEDER_FAULTS``
   in its spawn), the NaN rows make the guard skip, the streak trips and
   the learner rolls back: exactly one rollback to that epoch, an
   ``fsck``-clean root, the launch counters still advancing after the
   restore and the same launches per dispatched update; the first update
   after the restore, replayed from the CUDA graph, against the same
   update run eagerly on a clone of the restored state and ring, to the
   bit; the ring it replays on is the live ring, holding the epoch's rows
   and priorities and no NaN; the seconds from the streak's start to the
   rollback, of the restore and of that first update. (b) The
   quarantine drill: the same poison with the quarantine on: its 64 rows
   in ``quarantine/``, no rollback, no skipped step, no NaN in the ring.
   (c) The validator's cost: ``main`` with pipelined and with batched
   actors, the quarantine on (train_process's and train_batched's
   unpaced runs) and off: updates/s, frames/s, the drain's host seconds
   and the validator's own seconds side by side. (d) The X-ray of a full
   ring: host ms a stats window (the one copy included) and device ms,
   against the host X-ray.  The quarantine drill runs unpaced, 600
   updates, its poison early in the warm-up (it needs no epoch).
23. megabatch: config 12's learner alone at full width in groups of M
   (``megabatch``): a graphed dispatch of groups of 4 against its eager
   twin, with the kernel torso and with the module's forward (``vmap``
   over the weight copies), to the bit; a group of one minibatch against
   the sequential step, to the bit with the kernel torso (the module's
   ``vmap`` forward: its difference recorded); B1 drawing a group's 512
   rows in one
   launch against ``sample_plain`` (identical); B2's products of a group
   of 4 (the forward and ``dx`` over 512 rows, ``dw`` on each
   minibatch's row slice) against ``gemm_plain``, with kernel, plain,
   library and bound ms; updates/s at M = 1, 2, 4 and 8 with the
   launches per update counted in each timed window (1/M draws, 10/M
   forward and (4 + 5M)/M backward GEMMs), the fp32 torso and the
   module's forward at M = 4; then the split-process learner with
   ``megabatch=4`` through ``main`` (pipelined actors, 2,000 updates),
   its launches held to one draw and 10 + 24 GEMMs a group;
24. anakin_megabatch: Anakin through ``main`` at ``rollout_ratio`` 16
   with ``megabatch=4`` and ``double_buffer=true``, 4,000 updates: the
   launches per group, updates/s, frames/s, the duty cycle and the
   device ms a learner update over the run, and the median of its stats
   windows past step 400 (the warm-up and the graphs' captures left
   out), beside train_anakin's ratio-16 run;
25. train_uniform: CONFIGS row 8 (the uniform device ring) through
   ``main``, pipelined actors at replay ratio 8 and Anakin at ratio 16
   (the same ratio at batch 128), as users run it: no draw, 10 + 9
   GEMMs an update; updates/s, frames/s;
26. train_host: rows 4 (``shared``) and 6 (``prioritized``) through
   ``main`` on the process backend at replay ratio 8, 500 updates
   each, row 6 with ``LEARNER_FAULTS=poison_grad@250`` (exactly one
   skipped update, its batch the NaN one, its params unchanged, no
   rollback), then row 4 on ``memory_type=native`` unpaced; no draw, 10
   + 9 GEMMs an update;
27. small_rows: rows 1 and 3 (``dqn-mlp``, no kernel on their path)
   through ``main``: row 1 learns the chain (the evaluator reaches 1.0,
   mode 2 on its best params solves every episode in 7 steps).

``python3 chip_smoke.py PHASE ...`` runs ``build`` and the named phases
only.  Then a ``kernels`` line (the table PERF.md is written from: B1's
and the bf16 GEMM's launches from the train_process phase, the fp32
GEMM's from the fp32 learner run, and each kernel's launches on the
process runs with pipelined, batched and device actors, on the two
Anakin runs, on the two health drills, on the megabatch learner and
Anakin runs, on row 8's two runs and on the three host runs; B1 and
B2 held at a megabatch group beside their per-update numbers), the
card's name and power limit, and the verdict as the last line.  Exits non-zero, with no
verdict, if there is no GPU, if the package is missing, or if any phase
fails.  TF32 is off throughout, so fp32 references are full fp32.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

# imported (not run) again by the spawn children of the train_process
# phase, which must not touch the card: the check for a GPU is in
# ``__main__`` below
from pytorch_distributed_tpu_torch.bench_gemm import (
    TORSO_GEMMS, time_ms, update_gemms,
)
from pytorch_distributed_tpu_torch.ops import cuda_sampling, cuda_torso
from pytorch_distributed_tpu_torch.ops import kernels

DEV = torch.device("cuda", 0)
# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# config 12 (dqn/pong-sim/device-per/dqn-cnn) at full width
RING_ROWS, BATCH, FRAME, ACTIONS = 50_000, 128, (4, 84, 84), 6
TRAIN_STEPS = 2000
# the cap on an episode's agent steps in the end-to-end phases, so the
# evaluator's and the tester's greedy episodes end in seconds
EARLY_STOP = 1000
RUN_DIR = ""  # the end-to-end phases' logs and checkpoints, made by main
# (M, K, N) of each kernel's sweep, each run in all four operand layouts:
# ragged M, N 6 to 512, K from 64 to 51,200 (136, 200 and 1,096 ragged
# against either K tile), split and unsplit plans, every (row tile, tile
# width) of either kernel's dispatch (bf16: 64 x 8, 32, 64, 128 and 128 x
# 8, 32, 64, 128; fp32: 64 and 128 x 32, 64, 128; the 128-row tiles only
# where they alone give 1 (bf16) or 4 (fp32) blocks a SM: M of 70,000 and
# 20,000 x N 512 for fp32), 49 bf16 and 98 fp32 K tiles unsplit
# (9,000 x 3,136 x 64), which wraps the 4-stage ring 12 and 24 times, and
# Conv_0's dw contraction of 800 bf16 and 1,600 fp32 K tiles (256 x
# 51,200 x 32), split
GEMM_SWEEP = ((100, 64, 6), (100, 136, 6), (2000, 512, 6), (800, 576, 32),
              (300, 1096, 32), (25650, 256, 32), (6437, 200, 64),
              (800, 3136, 64), (800, 512, 128), (100, 3136, 512),
              (12800, 256, 64), (9000, 3136, 64), (20000, 512, 6),
              (20000, 256, 64), (5000, 512, 512), (256, 51200, 32),
              (577, 6270, 70), (70000, 256, 32), (70000, 256, 64),
              (20000, 256, 512))
LAYOUTS = ((False, False), (False, True), (True, False), (True, True))

RESULTS: dict = {}
FAILED: list = []


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def phase(fn):
    """Run one phase; a failure is printed and remembered, and the later
    phases still run."""
    t0 = time.monotonic()
    try:
        out = fn()
        emit({"phase": fn.__name__, "ok": True,
              "seconds": time.monotonic() - t0, **(out or {})})
    except Exception:  # noqa: BLE001 - reported, and fails the run
        FAILED.append(fn.__name__)
        traceback.print_exc()
        emit({"phase": fn.__name__, "ok": False,
              "seconds": time.monotonic() - t0})


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """(least time in ms, what bounds it): bytes over the memory rate or
    operations over the peak rate for the operand type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def card_name_and_power_limit() -> str:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    lines = smi.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi failed: {smi.stderr.strip()}"


# ---------------------------------------------------------------------------

def build():
    t0 = time.monotonic()
    took = kernels.build()
    out = {"build_s": time.monotonic() - t0,
           "per_source_s": took, "flags": " ".join(kernels.NVCC_FLAGS)}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = kernels.library_path("torso_gemm_sm90")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    # per operand layout: the mangled template arguments of
    # gemm_bf16_sm90<BM, BN, a_mn, b_mn> end in Lb<a_mn>ELb<b_mn>E
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        if "gemm_bf16_sm90" not in name:
            continue
        layout = re.search(r"Lb([01])ELb([01])E", name)
        key = f"a_mn={layout[1]},b_mn={layout[2]}"
        c = counts.setdefault(key, {"functions": 0, "HGMMA": 0,
                                    "UTMALDG": 0})
        c["functions"] += 1
        for op in ("HGMMA", "UTMALDG"):
            c[op] += fn.count(op)
    out["sass_counts"] = counts
    if len(counts) != 4 or not all(c["HGMMA"] and c["UTMALDG"]
                                   for c in counts.values()):
        raise AssertionError(f"bf16 GEMM SASS lacks wgmma or TMA in some "
                             f"operand layout: {counts}")
    out["f32_sass"] = _f32_sass(tool)
    # per GEMM kernel, from "Function <name>:" and "REG:n STACK:n ...
    # LOCAL:n ...", on one line or two (cuobjdump reads one file a run)
    usage = {}
    for path in (lib, kernels.library_path("torso_gemm")):
        res = subprocess.run([tool, "-res-usage", path], capture_output=True,
                             text=True, timeout=300, check=True).stdout
        name, parsed = None, False
        for ln in res.splitlines():
            if "Function" in ln:
                name = ln.split("Function", 1)[1]
            found = re.findall(r"\b(REG|STACK|LOCAL):(\d+)", ln)
            if found and name and "gemm_" in name:
                usage[_gemm_key(name)] = {k: int(v) for k, v in found}
                parsed = True
        if not parsed:  # a layout not parsed above: its lines as printed
            usage[path.rsplit("/", 1)[-1]] = [
                ln.strip()[:200] for ln in res.splitlines() if "REG" in ln]
    out["res_usage"] = usage
    return out


def _gemm_key(name: str) -> str:
    """``bf16 128x64 a_mn=0 b_mn=1`` from a GEMM kernel's mangled
    (``...ILi128ELi64ELb0ELb1E...``) or demangled (``...<128, 64, false,
    true>...``) name; the name itself if it is neither."""
    t = (re.search(r"ILi(\d+)ELi(\d+)ELb([01])ELb([01])E", name)
         or re.search(r"<(\d+), (\d+), (false|true), (false|true)>", name))
    if t is None:
        return name.strip()[:120]
    flag = {"0": 0, "1": 1, "false": 0, "true": 1}
    kind = "bf16" if "gemm_bf16" in name else "f32"
    return f"{kind} {t[1]}x{t[2]} a_mn={flag[t[3]]} b_mn={flag[t[4]]}"


def _f32_sass(tool: str) -> dict:
    """Per instantiation of the fp32 GEMM (``gemm_f32_sm90<BM, BN, a_mn,
    b_mn>``): its counts of TMA loads, FFMA and 128-bit shared loads, which
    must all be there, and of local loads and stores, which must not."""
    sass = subprocess.run([tool, "-sass",
                           kernels.library_path("torso_gemm")],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops = {"UTMALDG": r"\bUTMALDG\b", "FFMA": r"\bFFMA\b",
           "LDS.128": r"\bLDS(?:\.U)?\.128\b", "LDL": r"\bLDL\b",
           "STL": r"\bSTL\b"}
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(None, 1)[0]
        if "gemm_f32_sm90" in name:
            counts[_gemm_key(name)] = {op: len(re.findall(rx, fn))
                                       for op, rx in ops.items()}
    bad = {n: c for n, c in counts.items()
           if not (c["UTMALDG"] and c["FFMA"] and c["LDS.128"])
           or c["LDL"] or c["STL"]}
    if len(counts) != 24 or bad:
        raise AssertionError(f"fp32 GEMM SASS: {len(counts)} "
                             f"instantiations, failing {bad}")
    return counts


def _kernels_per_call(fn, calls: int = 10) -> dict:
    """The profiler's device kernels over ``calls`` eager calls of ``fn``:
    ``{kernel name: launches per call}``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.count / calls for e in prof.key_averages()
            if e.self_device_time_total > 0}


def _forced_remap(gen) -> dict:
    """B1 on a draw forced onto the zero-row remap: integer priorities (so
    every sum is exact in any order) on rows below 45,000, a tie at the
    maximum (rows 1,000 and 30,000), zeros after, and ``u = 1``, whose
    target is the total and so lands past the last nonzero row; beside it
    the largest float32 below 1, 0 and random uniforms."""
    p = torch.randint(1, 4, (RING_ROWS,), generator=gen, device=DEV).float()
    p[45_000:] = 0.0
    p[[1_000, 30_000]] = 5.0
    u = torch.rand(BATCH, generator=gen, device=DEV)
    u[:4] = torch.tensor([1.0, 1.0 - 2.0 ** -24, 0.0, 1.0])
    idx_k, pr_k = cuda_sampling.hierarchical_sample(p, u)
    idx_p, pr_p = cuda_sampling.sample_plain(p, u)
    torch.cuda.synchronize()
    # the flat inverse-CDF row before the remap (exact: integer sums)
    cdf = torch.cumsum(p.double(), 0)
    raw = torch.searchsorted(cdf, u.double() * cdf[-1], right=True).clamp_(
        max=RING_ROWS - 1)
    forced = p[raw] == 0
    if not (bool(forced[0]) and bool(forced[3])):
        raise AssertionError("u = 1 did not reach the zero rows")
    if not (torch.equal(idx_k, idx_p) and torch.equal(pr_k, pr_p)):
        raise AssertionError(f"B1 forced case: kernel {idx_k[:4].tolist()} "
                             f"plain {idx_p[:4].tolist()}")
    if not bool((idx_k[forced] == 1_000).all()):
        raise AssertionError(f"remap did not pick the first maximum: "
                             f"{idx_k[forced].tolist()}")
    return {"forced_draws": int(forced.sum()),
            "forced_idx": idx_k[:4].tolist()}


def per_sample():
    """B1 at the ring's full size: kernel vs plain version, same inputs."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    p = torch.rand(RING_ROWS, generator=gen, device=DEV)
    p = torch.where(torch.rand(RING_ROWS, generator=gen, device=DEV) < 0.1,
                    torch.zeros_like(p), p)  # some empty rows
    u = torch.rand(BATCH, generator=gen, device=DEV)
    worst_err, mismatches = 0.0, 0
    for _ in range(20):  # 20 draws of 128 uniforms each
        us = torch.rand(BATCH, generator=gen, device=DEV)
        idx_k, pr_k = cuda_sampling.hierarchical_sample(p, us)
        idx_p, pr_p = cuda_sampling.sample_plain(p, us)
        same = idx_k == idx_p
        mismatches += int((~same).sum())
        worst_err = max(worst_err,
                        float((pr_k - pr_p)[same].abs().max()))
        if not bool((p[idx_k] > 0).all()):
            raise AssertionError("kernel drew an empty row")
    # tolerance: none.  The plain version takes the kernel's fp32 sums in
    # the kernel's order (and no fused multiply-add on either side), so the
    # two agree to the bit
    if mismatches or worst_err:
        raise AssertionError(f"B1 disagrees: {mismatches} index "
                             f"mismatches, probs err {worst_err}")
    forced = _forced_remap(gen)
    per_call = _kernels_per_call(
        lambda: cuda_sampling.hierarchical_sample(p, u))
    if sum(per_call.values()) != 1 or not all(
            "sample_kernel" in k for k in per_call):
        raise AssertionError(f"B1 launched {per_call} per call, not one "
                             f"kernel")

    def library():
        cdf = torch.cumsum(p, 0)
        idx = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp_(
            max=RING_ROWS - 1)
        return idx, p[idx] / cdf[-1]

    ms = time_ms(lambda: cuda_sampling.hierarchical_sample(p, u), 200)
    eager = time_ms(lambda: cuda_sampling.hierarchical_sample(p, u), 200,
                    graph=False)
    plain = time_ms(lambda: cuda_sampling.sample_plain(p, u), 200)
    lib = time_ms(library, 200)
    nblocks = -(-RING_ROWS // cuda_sampling.BLOCK)
    # priority read once, uniforms read, idx (int64) and probs written;
    # one add per priority for the block sums, a scan and a compare per
    # priority of each drawn superblock
    nbytes = RING_ROWS * 4 + BATCH * 4 + BATCH * (8 + 4)
    flops = RING_ROWS + 2 * BATCH * cuda_sampling.BLOCK + 2 * nblocks
    b, by = bound_ms(nbytes, flops, torch.float32)
    RESULTS["per_sample"] = dict(max_abs_err=worst_err, ms=ms,
                                 plain_ms=plain, bound_ms=b, bound_by=by,
                                 library_ms=lib)
    return {"n": RING_ROWS, "batch": BATCH, "index_mismatches": mismatches,
            "eager_ms": eager, "kernels_per_eager_call": per_call,
            # each block reads every priority for its block sums, from L2
            "l2_bytes_read": BATCH * RING_ROWS * 4, **forced,
            "draws": 20 * BATCH, "tolerance": "identical indices and probs",
            **RESULTS["per_sample"]}


def _sweep_operand(rows: int, cols: int, unit_dim: int, dtype, gen):
    """A (rows, cols) operand of ``dtype`` with stride 1 along
    ``unit_dim``, its lines padded to 16 bytes."""
    per = 16 // (torch.finfo(dtype).bits // 8)
    if unit_dim == 1:
        pad = -(-cols // per) * per
        return torch.randn(rows, pad, generator=gen, device=DEV).to(
            dtype)[:, :cols]
    pad = -(-rows // per) * per
    return torch.randn(cols, pad, generator=gen, device=DEV).to(
        dtype)[:, :rows].t()


def _rel_err(c_k, c_p) -> tuple:
    torch.cuda.synchronize()
    err = float((c_k - c_p).abs().max())
    return err, err / max(float(c_p.abs().max()), 1e-30)


# per operand type: the kernel's plan, its tiles and K tile, and its
# forward and gradient launch counters
GEMM_KINDS = {
    torch.bfloat16: (cuda_torso.plan_bf16, cuda_torso.BF16_TILE_M,
                     cuda_torso.BF16_TILE_N, cuda_torso.BF16_TILE_K,
                     (cuda_torso.gemm_bf16, cuda_torso.gemm_bf16_grad)),
    torch.float32: (cuda_torso.plan_f32, cuda_torso.F32_TILE_M,
                    cuda_torso.F32_TILE_N, cuda_torso.F32_TILE_K,
                    (cuda_torso.gemm_f32, cuda_torso.gemm_f32_grad)),
}


def _sweep(dtype) -> tuple:
    """The kernel for ``dtype`` on GEMM_SWEEP in all four layouts, against
    its plain version: (rows, worst error relative to the output scale);
    raises unless every (row tile, tile width) of its plan and a split
    800-K-tile contraction were reached, or if an operand with 200-byte
    lines does not raise or counts a launch."""
    plan, tiles_m, tiles_n, tile_k, counters = GEMM_KINDS[dtype]
    worst, sweep = 0.0, []
    for m, k, n in GEMM_SWEEP:
        for a_mn, b_mn in LAYOUTS:
            gen = torch.Generator(device=DEV).manual_seed(m * 7 + k * 3 + n)
            a = _sweep_operand(m, k, 0 if a_mn else 1, dtype, gen)
            b = _sweep_operand(k, n, 1 if b_mn else 0, dtype, gen)
            layout = (cuda_torso.tma_major(a, 1), cuda_torso.tma_major(b, 0))
            if layout != ("mn" if a_mn else "k", "mn" if b_mn else "k"):
                raise AssertionError(f"sweep operand read as {layout}")
            err, rel = _rel_err(cuda_torso.gemm(a, b, grad=True),
                                cuda_torso.gemm_plain(a, b))
            worst = max(worst, rel)
            sweep.append(dict(m=m, k=k, n=n, layout=layout,
                              plan=plan(m, n, k), max_rel_err=rel))
    reached = {(*r["plan"][:2], *r["layout"]) for r in sweep}
    if len(reached) != len(tiles_m) * len(tiles_n) * len(LAYOUTS):
        raise AssertionError(f"the {dtype} sweep reaches only "
                             f"{sorted(reached)}")
    if not any(r["plan"][3] > 1 and r["k"] >= 800 * tile_k for r in sweep):
        raise AssertionError(f"the {dtype} sweep has no split 800-K-tile "
                             f"contraction")
    # K = 200 bytes of bf16 or fp32: lines 200 bytes apart, which no TMA
    # descriptor takes
    a = torch.ones(64, 200 // (torch.finfo(dtype).bits // 8), device=DEV,
                   dtype=dtype)
    launches = [c.launches for c in counters]
    refused = []
    for x, y in ((a, a[:6].t()), (a.t(), a[:, :6])):
        try:
            cuda_torso.gemm(x, y, grad=True)
            raise AssertionError(f"an operand with 200-byte lines did not "
                                 f"raise: {tuple(x.stride())}")
        except ValueError as e:
            refused.append(str(e))
    if [c.launches for c in counters] != launches:
        raise AssertionError("a refused operand counted a launch")
    return sweep, worst, refused


def torso_gemm():
    rows = []
    parts = ("fwd", "bwd", "f32_fwd", "f32_bwd")
    totals = {part: dict(ms=0.0, eager_ms=0.0, plain_ms=0.0, library_ms=0.0,
                         bound_ms=0.0, t_bytes=0.0, t_ops=0.0, calls=0,
                         max_abs_err=0.0, max_rel_err=0.0)
              for part in parts}
    for part_name, label, a, b, count in update_gemms(DEV):
        grad = part_name.endswith("bwd")
        err, rel = _rel_err(cuda_torso.gemm(a, b, grad=grad),
                            cuda_torso.gemm_plain(a, b))
        part = totals[part_name]
        part["max_abs_err"] = max(part["max_abs_err"], err)
        part["max_rel_err"] = max(part["max_rel_err"], rel)
        (m, k), n = a.shape, b.shape[1]
        es = a.element_size()
        nbytes = (m * k + k * n) * es + m * n * 4
        bd, by = bound_ms(nbytes, 2.0 * m * n * k, a.dtype)
        iters = 200
        row = dict(part=part_name, gemm=label, m=m, k=k, n=n,
                   dtype=str(a.dtype)[6:], calls_per_update=count,
                   max_abs_err=err,
                   ms=time_ms(lambda: cuda_torso.gemm(a, b, grad=grad),
                              iters),
                   eager_ms=time_ms(lambda: cuda_torso.gemm(a, b, grad=grad),
                                    iters, graph=False),
                   plain_ms=time_ms(lambda: cuda_torso.gemm_plain(a, b),
                                    iters),
                   library_ms=time_ms(lambda: torch.matmul(a, b), iters),
                   bound_ms=bd, bound_by=by,
                   plan=GEMM_KINDS[a.dtype][0](m, n, k),
                   layout=(cuda_torso.tma_major(a, 1),
                           cuda_torso.tma_major(b, 0)))
        emit({"torso_gemm_shape": row})
        rows.append(row)
        part["calls"] += count
        for key in ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms"):
            part[key] += count * row[key]
        part["t_bytes" if by == "bytes" else "t_ops"] += count * bd
    if any(r["layout"] != (("k", "k") if r["part"].endswith("fwd")
                           else ("mn", "mn") if r["gemm"].endswith("dw")
                           else ("k", "mn")) for r in rows):
        raise AssertionError("a GEMM did not read its operands as the main "
                             "path lays them out")
    sweeps = {str(dt)[6:]: _sweep(dt) for dt in GEMM_KINDS}
    # tolerance: the same bf16 (or fp32) products, exact in fp32, summed in
    # another order
    worst = max(*(w for _s, w, _r in sweeps.values()),
                *(p["max_rel_err"] for p in totals.values()))
    if worst > 1e-4:
        raise AssertionError(f"B2 disagrees: {worst:.2e} of the output "
                             f"scale (sweeps {sweeps})")

    def result(names):
        ps = [totals[p] for p in names]
        return dict(max_abs_err=max(p["max_abs_err"] for p in ps),
                    **{k: sum(p[k] for p in ps) for k in (
                        "ms", "plain_ms", "bound_ms", "library_ms")},
                    bound_by="bytes" if sum(p["t_bytes"] for p in ps)
                    >= sum(p["t_ops"] for p in ps) else "operations")

    RESULTS["torso_gemm_fwd"] = result(["fwd"])
    RESULTS["torso_gemm_bwd"] = result(["bwd"])
    RESULTS["torso_gemm_f32"] = dict(
        result(["f32_fwd", "f32_bwd"]),
        parts={p: result([p]) for p in ("f32_fwd", "f32_bwd")})
    return {"gemms_per_update": {p: t["calls"] for p, t in totals.items()},
            "max_rel_err": worst,
            "eager_ms_per_update": {p: t["eager_ms"]
                                    for p, t in totals.items()},
            "tolerance": "max |kernel - plain| <= 1e-4 x max |plain|",
            "sweeps": {dt: {"worst_rel_err": w, "gemms": len(sw),
                            "refused": r, "sweep": sw}
                       for dt, (sw, w, r) in sweeps.items()},
            "per_update": {p: result([p]) for p in parts}}


def torso_apply():
    """The kernel torso against the module forward and autograd on the
    same weights (batch 2, 84x84), fp32 and bf16."""
    from pytorch_distributed_tpu_torch.models.dqn_cnn import DqnCnnModel

    obs = torch.randint(0, 255, (2, *FRAME), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(2)).to(DEV)
    out = {}
    for cd, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
        model = DqnCnnModel(ACTIONS, FRAME, compute_dtype=cd,
                            generator=torch.Generator().manual_seed(3))
        model = model.to(DEV)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in model.named_parameters()}
        apply_fn = cuda_torso.build_torso_apply(255.0, cd)
        q_k = apply_fn(params, obs)
        q_m = model(obs)
        err = float((q_k - q_m).detach().abs().max())
        if not (q_k.shape == (2, ACTIONS) and torch.isfinite(q_k).all()
                and err <= tol * (1 + float(q_m.detach().abs().max()))):
            raise AssertionError(f"{cd} torso forward err {err}")
        out[f"{str(cd)[6:]}_fwd_err"] = err
        g_k = torch.autograd.grad(q_k.square().mean(), list(params.values()))
        g_m = torch.autograd.grad(q_m.square().mean(),
                                  list(model.parameters()))
        fk = torch.cat([g.flatten() for g in g_k])
        fm = torch.cat([g.flatten() for g in g_m])
        cos = float(fk @ fm / (fk.norm() * fm.norm()))
        out[f"{str(cd)[6:]}_grad_cos"] = cos
        if cos < 0.999:
            raise AssertionError(f"{cd} torso grads disagree, cos {cos}")
    return out


def _graph_matches_eager(compute_dtype: str, megabatch: int = 1,
                         torso: bool = True) -> float:
    """Six dispatches of four updates each replayed from the CUDA graph
    against six eager ones, from the same state, ring and uniforms, with
    the kernel torso (or, ``torso=False``, the module's forward) in
    ``compute_dtype``, in groups of ``megabatch``: the largest difference
    over params and priorities (the same kernels in the same order: 0 in
    every run so far)."""
    from pytorch_distributed_tpu_torch import bench_learner
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.factory import (
        EnvSpec, build_model, build_train_state_and_step, init_params,
        resolve_fused_step,
    )
    from pytorch_distributed_tpu_torch.memory.device_per import (
        DevicePerReplay, GraphedFusedStep,
    )

    opt = build_options(12, device="cuda", pallas_torso=torso,
                        compute_dtype=compute_dtype, megabatch=megabatch,
                        steps_per_dispatch=4)
    spec = EnvSpec(FRAME, ACTIONS, 255.0)
    runs = []
    for graphed in (False, True):
        ring = DevicePerReplay(4096, FRAME, device=DEV)
        bench_learner.fill_ring(ring, ACTIONS,
                                torch.Generator(device=DEV).manual_seed(5))
        model = build_model(opt, spec)
        state, step = build_train_state_and_step(
            opt, model, init_params(opt, spec, seed=0, device=DEV))
        m, k, mega = resolve_fused_step(opt, model, "chip_smoke")
        fused = ring.build_fused_step(step, BATCH, steps_per_call=k,
                                      megabatch=m, megabatch_step=mega)
        if graphed:
            fused = GraphedFusedStep(fused, ring.state)
        gen = torch.Generator(device=DEV).manual_seed(6)
        for _ in range(6):
            us = torch.rand((4, BATCH), generator=gen, device=DEV)
            state, _m = fused(state, ring.state, us, 0.4)
        torch.cuda.synchronize()
        runs.append((state, ring.state.priority.clone()))
    (s_e, p_e), (s_g, p_g) = runs
    diffs = [float((s_e.params[k] - s_g.params[k]).abs().max())
             for k in s_e.params] + [float((p_e - p_g).abs().max())]
    return max(diffs)


def learner_alone():
    """The fused PER update at config 12's full width on a full random
    ring with no actors (bench_learner), for the bf16 torso and for the
    torso with ``compute_dtype`` float32: updates/s with the kernel torso
    and with the module's (cuDNN) forward, replayed from a CUDA graph and
    eager, the profiler's device time per update by kernel, and the
    kernels' launches per update in each timed window."""
    from pytorch_distributed_tpu_torch import bench_learner
    from pytorch_distributed_tpu_torch.config import build_options

    out = {}
    for cd, own, other in (("bfloat16", "gemm_bf16", "gemm_f32"),
                           ("float32", "gemm_f32", "gemm_bf16")):
        diff = _graph_matches_eager(cd)
        if diff > 1e-6:  # tolerance: fp32 rounding noise at most
            raise AssertionError(f"{cd}: graph replay differs from eager "
                                 f"by {diff}")
        out[f"{cd}_graph_vs_eager_max_abs_diff"] = diff
        for torso in ("kernel", "module"):
            for graph in (True, False):
                r = bench_learner.run(
                    build_options(12, device="cuda",
                                  pallas_torso=torso == "kernel",
                                  compute_dtype=cd),
                    updates=100, profile=torso == "kernel", graph=graph)
                emit({"learner_alone": r})
                run = f"{cd}_{torso}_{'graph' if graph else 'eager'}"
                out[f"{run}_updates_per_sec"] = r["updates_per_sec"]
                # per update: one draw; the kernel torso's 10 forward and
                # 9 backward GEMMs of its type, none of the other type
                n = 10 if torso == "kernel" else 0
                want = {"hierarchical_sample": 1, own: n, f"{own}_grad":
                        9 * n // 10, other: 0, f"{other}_grad": 0}
                if r["launches_per_update"] != want:
                    raise AssertionError(f"{run}: launches per update "
                                         f"{r['launches_per_update']}")
                if cd == "float32" and torso == "kernel" and graph:
                    RESULTS["f32_launches"] = {
                        "launches": (n + 9 * n // 10) * r["updates"],
                        "per_update": r["launches_per_update"],
                        "device_ms_per_update": r["kernel_device_ms"]}
    return out


def _e2e_argv(backend: str, refs: str = "", *sets: str,
              config: int = 12, steps: int = TRAIN_STEPS) -> list:
    """A CONFIGS row (config 12 unless said) at full width, 2 actors x 16
    envs (native Pong, pipelined: the defaults), the kernel torso, an
    evaluator of one capped episode, logs and checkpoints in RUN_DIR;
    ``sets`` are more ``--set`` values."""
    argv = ["--config", str(config), "--backend", backend,
            "--device", "cuda",
            "--num-actors", "2", "--num-envs-per-actor", "16",
            "--memory-size", str(RING_ROWS), "--batch-size", str(BATCH),
            "--steps", str(steps),
            "--set", "learn_start=2000", "--set", "pallas_torso=true",
            "--set", "learner_freq=100", "--set", "evaluator_nepisodes=1",
            "--set", f"early_stop={EARLY_STOP}",
            "--set", f"root_dir={RUN_DIR}", "--set", f"refs={refs or backend}"]
    for kv in sets:
        argv += ["--set", kv]
    return argv


def expected_launches(updates: int, megabatch: int = 1, draws: bool = True,
                      torso: bool = True) -> dict:
    """The kernels' launches over ``updates`` bf16 updates with double DQN
    off: a draw (B1) per group of ``megabatch`` updates on a PER device
    ring (none on a uniform or host ring); per group, 10 forward GEMMs (5
    layers, the online and the target net, each over the group's M*B
    rows), 4 ``dx`` GEMMs over the M*B rows and 5 ``dw`` GEMMs a minibatch
    (the kernel torso; none with the module's forward); no fp32 GEMM."""
    groups = updates // megabatch
    return {"per_sample": groups if draws else 0,
            "torso_gemm_fwd": 10 * groups if torso else 0,
            "torso_gemm_bwd": (4 + 5 * megabatch) * groups if torso else 0,
            "torso_gemm_f32": 0}


def _train_through_main(backend: str, refs: str = "", *sets: str,
                        phases=("env", "advance", "tick"), config: int = 12,
                        steps: int = TRAIN_STEPS, megabatch: int = 1,
                        draws: bool = True) -> tuple:
    """One end-to-end run through ``main``; the kernels' launch counters
    are zeroed just before it and read just after, in this process, and
    held to ``expected_launches``.  ``phases``: the actors' timer phases
    the run must have logged."""
    from pytorch_distributed_tpu_torch import main as port_main
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.utils.metrics import timer_phases

    argv = _e2e_argv(backend, refs, *sets, config=config, steps=steps)
    _zero_launches()
    summary = port_main.main(argv)
    launches = {"per_sample": cuda_sampling.hierarchical_sample.launches,
                "torso_gemm_fwd": cuda_torso.gemm_bf16.launches,
                "torso_gemm_bwd": cuda_torso.gemm_bf16_grad.launches,
                "torso_gemm_f32": cuda_torso.gemm_f32.launches}
    steps_done = summary["learner/steps"]
    if steps_done < steps or not math.isfinite(
            summary["learner/critic_loss"]):
        raise AssertionError(f"{backend} train: {summary}")
    want = expected_launches(steps_done, megabatch, draws)
    if launches != want:
        raise AssertionError(f"launch counts {launches} for {steps_done} "
                             f"steps, not {want}")
    seconds = summary["learner/train_seconds"]
    actor_steps = summary["actor/steps_per_sec"] * seconds
    log_dir = build_options(config, root_dir=RUN_DIR,
                            refs=refs or backend).log_dir
    logged = timer_phases(log_dir)
    if not set(phases) <= logged.keys():
        raise AssertionError(f"no actor timer rows in {log_dir}: {logged}")
    out = {"argv": " ".join(argv), "launches": launches,
           "updates_per_sec": summary["learner/updates_per_sec"],
           "actor_frames_per_sec": summary["actor/steps_per_sec"],
           "actor_phases_ms": logged,
           # samples drawn per transition stored, over the train loop
           "replay_ratio": steps_done * BATCH / max(actor_steps, 1.0),
           "host_s": {k: summary.get(f"learner/host_s_{k}")
                      for k in ("pacing", "drain", "step", "publish")},
           "train_seconds": seconds,
           "critic_loss": summary["learner/critic_loss"],
           "peak_mem_gb": torch.cuda.max_memory_allocated(DEV) / 1e9,
           "cpu_count": os.cpu_count(), "summary": summary}
    RESULTS[f"e2e_{refs or backend}"] = out
    return out, summary


def train():
    """Config 12 at full width through the port's entry point, thread
    backend."""
    out, _summary = _train_through_main("thread")
    return out


def _publisher_matches_inline() -> int:
    """The learner's publication off the loop on the card: three
    snapshots of changing weights submitted back to back, then closed; the
    shared store must hold the last one exactly as the inline flatten lays
    it out.  Returns how many snapshots the thread wrote."""
    from pytorch_distributed_tpu_torch.agents.param_store import (
        DevicePublisher, ParamStore, make_flattener,
    )
    from pytorch_distributed_tpu_torch.models.dqn_cnn import DqnCnnModel

    base = {k: v.to(DEV) for k, v in DqnCnnModel(
        ACTIONS, FRAME, generator=torch.Generator().manual_seed(4)
    ).state_dict().items()}
    expect, _ = make_flattener({k: v + 2.0 for k, v in base.items()}, FRAME)
    store = ParamStore(expect.size)
    pub = DevicePublisher(store, FRAME, DEV)
    for i in range(3):
        pub.submit({k: v + float(i) for k, v in base.items()})
    pub.close()
    flat, _version = store.fetch(0)
    if not (flat == expect).all():
        raise AssertionError("the published vector differs from the "
                             "inline flatten")
    return pub.published


def train_process():
    """The same run on the process backend: the learner here, the actors,
    the evaluator and the logger in spawn children on the CPU."""
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.utils import checkpoint, metrics

    publisher_writes = _publisher_matches_inline()
    out, summary = _train_through_main("process")
    RESULTS["launches"] = out["launches"]
    if summary["runtime/children_with_cuda"] != 0:
        raise AssertionError(f"{summary['runtime/children_with_cuda']} "
                             f"children made a CUDA context")
    opt = build_options(12, root_dir=RUN_DIR, refs="process")
    tags = {r["tag"] for r in metrics.read_scalars(opt.log_dir)}
    if not {"evaluator/avg_reward", "learner/critic_loss"} <= tags:
        raise AssertionError(f"scalars.jsonl holds only {sorted(tags)}")
    files = [checkpoint.params_path(opt.model_name),
             checkpoint.params_path(opt.model_name + "_best")]
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise AssertionError(f"no checkpoint at {missing}")
    thread = RESULTS.get("e2e_thread", {})
    return dict(out, children_with_cuda=summary[
        "runtime/children_with_cuda"], scalar_tags=sorted(tags),
        checkpoints=files, publisher_check_writes=publisher_writes,
        thread_backend={
            k: thread.get(k) for k in ("updates_per_sec",
                                       "actor_frames_per_sec",
                                       "actor_phases_ms", "replay_ratio",
                                       "host_s")})


def test_mode():
    """Mode 2 through ``main`` on the process run's params file."""
    from pytorch_distributed_tpu_torch import main as port_main
    from pytorch_distributed_tpu_torch.agents.param_store import num_params
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.factory import build_model, probe_env

    model_file = build_options(12, root_dir=RUN_DIR,
                               refs="process").model_name
    argv = ["--config", "12", "--mode", "2", "--device", "cuda",
            "--model-file", model_file, "--set", "tester_nepisodes=1",
            "--set", f"early_stop={EARLY_STOP}"]
    # the tester's weights live on the card while it plays: the peak of
    # allocated device memory rises by at least their fp32 bytes
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = port_main.main(argv)
    grew = torch.cuda.max_memory_allocated() - before
    weights = 4 * num_params(build_model(
        build_options(12), probe_env(build_options(12))).state_dict())
    if stats["nepisodes"] != 1 or not all(math.isfinite(v)
                                          for v in stats.values()):
        raise AssertionError(f"tester stats {stats}")
    if grew < weights:
        raise AssertionError(f"the tester's device memory grew by {grew} B, "
                             f"under its weights' {weights} B")
    return {"argv": " ".join(argv), "tester": stats,
            "device_bytes_grew": grew, "weight_bytes": weights}


NATIVE_ENVS, NATIVE_TICKS = 16, 1000
ACTOR_TICKS = 300


def _pong_ms_per_tick(env, ticks: int, seed: int) -> float:
    actions = np.random.default_rng(seed).integers(0, ACTIONS,
                                                   (ticks, NATIVE_ENVS))
    env.reset()
    t0 = time.perf_counter()
    for a in actions:
        env.step(a)
    return (time.perf_counter() - t0) / ticks * 1e3


def native_pong():
    """The C++ stepper built on this host (from an empty library path),
    16 envs x 1,000 ticks of random actions against the numpy simulators,
    and its dynamics against the numpy ``PongSimEnv`` to the bit under
    ``set_state`` (no point scored, so no serve is drawn)."""
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.envs.native_pong import (
        NativePongVectorEnv,
    )
    from pytorch_distributed_tpu_torch.envs.pong_sim import PongSimEnv
    from pytorch_distributed_tpu_torch.factory import build_env_vector
    from pytorch_distributed_tpu_torch.utils import native_build

    so = os.path.join(native_build.BUILD_DIR, "libpong_batch.so")
    if os.path.exists(so):
        os.unlink(so)  # built here, never one brought from elsewhere
    t0 = time.monotonic()
    native_build.build_library("pong_batch")
    build_s = time.monotonic() - t0
    opt = build_options(12, device="cpu")
    env = build_env_vector(opt, 0, NATIVE_ENVS)
    if not isinstance(env, NativePongVectorEnv):
        raise AssertionError(f"config 12 built {type(env).__name__}")
    ms = {"native": _pong_ms_per_tick(env, NATIVE_TICKS, 1),
          "numpy": _pong_ms_per_tick(build_env_vector(build_options(
              12, device="cpu", native_env=False), 0, NATIVE_ENVS),
              NATIVE_TICKS, 1)}
    params = build_options(12).env_params
    sim, nat = PongSimEnv(params, 0), NativePongVectorEnv(params, 0, 1)
    sim.reset()
    nat.reset()
    sim.player_y, sim.enemy_y, sim.ball_x, sim.ball_y = 30.0, 55.0, 42.0, 40.0
    sim.ball_vx, sim.ball_vy, sim._score = -1.4, 0.3, [0, 0]
    nat.set_state(0, np.array([30.0, 55.0, 42.0, 40.0, -1.4, 0.3, 0, 0]))
    for t, a in enumerate((2, 3, 0, 5, 4, 1, 2, 2, 3, 0, 1, 4)):
        obs, r, term, _ = sim.step(a)
        nobs, nr, nterm, _ = nat.step([a])
        # from the 4th step on the whole stack is frames of this window
        if not np.array_equal(obs[-1], nobs[0, -1]) or (
                t >= 3 and not np.array_equal(obs, nobs[0])) or (
                r, term) != (0.0, False) or (nr[0], nterm[0]) != (0.0, False):
            raise AssertionError(f"the stepper's dynamics differ from the "
                                 f"numpy simulator's at step {t}")
    return {"build_s": build_s, "envs": NATIVE_ENVS, "ticks": NATIVE_TICKS,
            "ms_per_tick": ms, "speedup": ms["numpy"] / ms["native"],
            "dynamics": "bit-equal over 12 steps"}


def _digest(stream) -> str:
    """sha256 over every column of every transition, in order."""
    import hashlib

    h = hashlib.sha256()
    for t in stream:
        for col in t:
            h.update(np.ascontiguousarray(col).tobytes())
    return h.hexdigest()


def _actor_tick_child(results, root: str) -> None:
    """Spawn child: the process backend's actor set-up (the CPU, the
    thread share of a 2-actor run with an evaluator), then one bounded actor run of ACTOR_TICKS ticks of 16 envs
    for each env and schedule."""
    from pytorch_distributed_tpu_torch import runtime
    from pytorch_distributed_tpu_torch.agents.actor import bounded_actor_run
    from pytorch_distributed_tpu_torch.config import build_options

    def opt(native, backend):
        return build_options(
            12, device="cpu", num_actors=2, num_envs_per_actor=NATIVE_ENVS,
            evaluator_nepisodes=1, native_env=native, actor_backend=backend,
            actor_freq=10 ** 9, root_dir=root, refs="actor_tick")

    try:
        threads = runtime.child_threads(opt(True, "inline"))
        runtime.enter_child(threads)
        bounded_actor_run(opt(True, "inline"), 20)  # warm-up
        out = {"threads": threads, "runs": {}}
        for native in (True, False):
            for backend in ("inline", "pipelined"):
                r = bounded_actor_run(opt(native, backend), ACTOR_TICKS)
                t = r["timer_ms"]
                out["runs"][f"{'native' if native else 'numpy'}_{backend}"] \
                    = {"frames_per_sec": r["env_steps"] / r["seconds"],
                       "ms_per_tick": r["seconds"] / ACTOR_TICKS * 1e3,
                       "phases_ms": {k[len("actor/time_"):-3]: v
                                     for k, v in t.items()
                                     if k.endswith("_ms") and not
                                     k.endswith(("_max_ms", "_total_ms"))},
                       "rows": len(r["stream"]),
                       "digest": _digest(r["stream"])}
        out["cuda_initialized"] = torch.cuda.is_initialized()
        results.put(out)
    except BaseException as e:  # reported by the parent
        results.put({"error": repr(e)})
        raise


def actor_tick():
    """One CPU actor in a spawn child pinned to the CPU, inline and
    pipelined, on native and numpy Pong: the StepTimer's phases in ms a
    tick, and the inline and pipelined transition streams identical."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    child = ctx.Process(target=_actor_tick_child,
                        args=(results, os.path.join(RUN_DIR, "actor_tick")))
    child.start()
    try:
        out = results.get(timeout=400)
    finally:
        child.join(60)
        if child.is_alive():
            child.terminate()
            child.join(5)
    if "error" in out:
        raise AssertionError(f"actor_tick child: {out['error']}")
    runs = out["runs"]
    for env in ("native", "numpy"):
        a, b = runs[f"{env}_inline"], runs[f"{env}_pipelined"]
        if a["digest"] != b["digest"] or a["rows"] != b["rows"] or \
                not a["rows"]:
            raise AssertionError(f"{env}: the pipelined stream differs from "
                                 f"the inline one ({a['rows']} and "
                                 f"{b['rows']} rows)")
    if out["cuda_initialized"]:
        raise AssertionError("the actor child initialised CUDA")
    return dict(out, ticks=ACTOR_TICKS, envs=NATIVE_ENVS,
                streams="inline == pipelined (sha256 of every row)")


GPU_SWAP_TICK = 100


def actor_gpu():
    """One actor inferring on the card in this thread, as the thread
    backend runs it, inline and pipelined over the same ticks, with a
    second snapshot published at ``GPU_SWAP_TICK``: the two transition
    streams must be identical and both must have swapped the second
    weights in."""
    from pytorch_distributed_tpu_torch.agents.actor import bounded_actor_run
    from pytorch_distributed_tpu_torch.config import build_options

    runs = {}
    for backend in ("inline", "pipelined"):
        r = bounded_actor_run(build_options(
            12, device="cuda", num_actors=2, num_envs_per_actor=NATIVE_ENVS,
            actor_backend=backend, actor_freq=10 ** 9,
            root_dir=os.path.join(RUN_DIR, "actor_gpu"), refs=backend),
            ACTOR_TICKS, publish_at=GPU_SWAP_TICK)
        t = r["timer_ms"]
        runs[backend] = {
            "frames_per_sec": r["env_steps"] / r["seconds"],
            "version": r["version"],
            "param_swaps": t.get("actor/time_param_swap_calls", 0.0),
            "phases_ms": {k[len("actor/time_"):-3]: v for k, v in t.items()
                          if k.endswith("_ms") and not
                          k.endswith(("_max_ms", "_total_ms"))},
            "rows": len(r["stream"]), "digest": _digest(r["stream"])}
    a, b = runs["inline"], runs["pipelined"]
    if a["digest"] != b["digest"] or a["rows"] != b["rows"] or not a["rows"]:
        raise AssertionError(f"on the card the pipelined stream differs from "
                             f"the inline one ({a['rows']} and {b['rows']} "
                             f"rows)")
    if a["version"] != 2 or b["version"] != 2 or not b["param_swaps"]:
        raise AssertionError(f"the second snapshot was not swapped in: {runs}")
    return {"runs": runs, "ticks": ACTOR_TICKS, "envs": NATIVE_ENVS,
            "published_at_tick": GPU_SWAP_TICK,
            "streams": "inline == pipelined (sha256 of every row)"}


def staged_drain():
    """The same rows into two rings on the card: the blocking path (a
    stacked chunk per drain, ``feed_chunk`` from pageable memory) and the
    staged path (the ingest queue, ``drain``: pinned slabs, non-blocking
    copies); drains under and over one slab, across the wrap.  The rings
    must be equal to the bit."""
    from pytorch_distributed_tpu_torch.memory.device_per import (
        DevicePerReplay,
    )
    from pytorch_distributed_tpu_torch.memory.device_replay import (
        STAGE_ROWS, STAGE_SLABS, DevicePerIngest,
    )
    from pytorch_distributed_tpu_torch.utils.experience import (
        REPLAY_FIELDS, Transition,
    )

    capacity, drains = 2048, (100, 1300, 900, 700)
    rng = np.random.default_rng(8)
    blocking = DevicePerReplay(capacity, FRAME, device=DEV)
    ingest = DevicePerIngest(capacity, FRAME, in_process=True)
    staged = ingest.attach(DEV)
    feeder = ingest.make_feeder()
    secs = {"blocking": 0.0, "staged": 0.0}
    for n in drains:
        rows = [Transition(
            state0=rng.integers(0, 255, FRAME, dtype=np.uint8),
            action=np.asarray(rng.integers(0, ACTIONS)),
            reward=np.float32(rng.normal()),
            gamma_n=np.float32(0.99 ** rng.integers(1, 6)),
            state1=rng.integers(0, 255, FRAME, dtype=np.uint8),
            terminal1=np.float32(rng.random() < 0.1)) for _ in range(n)]
        for t in rows:
            feeder.feed(t)
        feeder.flush()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk = Transition(*(np.stack([np.asarray(
            getattr(r, f), np.int32 if f == "action" else None)
            for r in rows]) for f in REPLAY_FIELDS))
        blocking.feed_chunk(chunk)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if ingest.drain() != n:
            raise AssertionError("the drain did not take every row")
        torch.cuda.synchronize()
        secs["blocking"] += t1 - t0
        secs["staged"] += time.perf_counter() - t1
    torch.cuda.synchronize()
    for f in (*REPLAY_FIELDS, "priority", "max_priority", "fill_rows"):
        if not torch.equal(getattr(blocking.state, f),
                           getattr(staged.state, f)):
            raise AssertionError(f"staged ring differs in {f}")
    if (blocking.state.pos, blocking.state.fill) != (staged.state.pos,
                                                     staged.state.fill):
        raise AssertionError("cursors differ")
    rows = sum(drains)
    return {"capacity": capacity, "drains": drains, "slab_rows": STAGE_ROWS,
            "slabs": STAGE_SLABS, "pinned": ingest._staging.pinned,
            "wrapped": rows > capacity, "rings": "bit-equal",
            "us_per_row": {k: v / rows * 1e6 for k, v in secs.items()}}


def _busy_us(trace_path: str) -> tuple:
    """The union of the device's kernel, copy and set intervals in a
    chrome trace, in us, and their count."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, len(spans)


def process_trace():
    """The unpaced process-backend run of ``train_process`` again, with the
    device traced by ``torch.profiler`` while the learner takes updates 600
    to 850: the device's idle share in that window as traced (the
    union of its kernels and copies against the window's wall time), its
    busy time per update, the window's updates/s beside the unprofiled
    run's, and, as an estimate, the idle share that busy time would leave
    at the unprofiled rate."""
    summary, window = _traced_run(
        _e2e_argv("process", "process_trace"), 600, 850, "process_trace")
    busy_ms = window["device_busy_ms_per_update"]
    rate = RESULTS.get("e2e_process", {}).get("updates_per_sec")
    return {**{k: window[k] for k in (
        "window_s", "updates", "window_updates_per_sec", "device_spans",
        "device_busy_ms_per_update", "device_idle_share_traced")},
            "unprofiled_updates_per_sec": rate,
            # not traced: the window's busy ms per update at the rate of
            # train_process, which ran without the profiler
            "device_idle_share_estimate_at_unprofiled_rate":
                None if rate is None else 1.0 - busy_ms * rate / 1e3,
            "top_kernels_ms": window["top_kernels_ms"],
            "children_with_cuda": summary["runtime/children_with_cuda"]}


def train_paced():
    """The process backend with the reference's config-12 pacing
    (``max_replay_ratio`` 8, ``learn_start`` 5,000): the rate users feel,
    set by the actors' frames."""
    out, summary = _train_through_main("process", "paced",
                                       "max_replay_ratio=8",
                                       "learn_start=5000")
    if summary["runtime/children_with_cuda"] != 0:
        raise AssertionError("a child made a CUDA context")
    return dict(out, pacing_s=summary["learner/host_s_pacing"],
                pacing_share=summary["learner/host_s_pacing"]
                / out["train_seconds"],
                children_with_cuda=summary["runtime/children_with_cuda"])


# the inference phase's tolerance for a wider sweep against one client's
# forward, on q_sel and q_max (bf16 compute; a wider batch may pick other
# convolution algorithms)
SWEEP_RTOL = SWEEP_ATOL = 1e-2
INFER_EARLY_STOP = 100  # every env resets at ticks 100 and 200 of 300
TIMED_TICKS = 200


def _batched_opt(backend: str, refs: str, **kw):
    from pytorch_distributed_tpu_torch.config import build_options

    return build_options(
        12, device="cuda", num_actors=2, num_envs_per_actor=NATIVE_ENVS,
        actor_backend=backend, actor_freq=10 ** 9,
        early_stop=INFER_EARLY_STOP, root_dir=os.path.join(RUN_DIR, refs),
        refs=refs, **kw)


def _server(opt, spec, clients: int, in_process: bool = False):
    """A server on the card over ``init_params(seed=0)`` with ``clients``
    clients, on pipes as the process backend wires it, or on in-process
    queues (whose puts never wait for the server)."""
    from pytorch_distributed_tpu_torch.agents.actor import snapshot_store
    from pytorch_distributed_tpu_torch.agents.inference import (
        InferenceServer,
    )

    srv = InferenceServer(opt, spec, snapshot_store(opt, spec, 0),
                          in_process=in_process)
    return srv, [srv.make_client(i) for i in range(clients)]


def _graph_vs_eager(srv, spec, gen) -> dict:
    """Each program kind replayed from its graph against the same act run
    eagerly on the same inputs, on the server's stream: max abs difference
    of the packed output (0.0 is bit-equal)."""
    from pytorch_distributed_tpu_torch.models.policies import (
        packed_act_rows, packed_roll_act,
    )

    n = NATIVE_ENVS
    obs = torch.randint(0, 255, (n, *FRAME), generator=gen,
                        dtype=torch.uint8)
    new = torch.randint(0, 255, (n, *FRAME[1:]), generator=gen,
                        dtype=torch.uint8)
    ctl = torch.stack([torch.full((n,), 0.3), torch.rand(n, generator=gen),
                       torch.randint(0, ACTIONS, (n,), generator=gen).float()])
    out = {}
    srv._refresh_params(block=True)
    with torch.cuda.stream(srv._stream):
        rows = srv._rows_progs[n]
        rows.stage("obs", 0, n, obs.numpy())
        rows.stage("ctl", 0, n, ctl.numpy())
        rows.launch(("obs", "ctl"))
        got = torch.from_numpy(rows.result().copy())
        d = {k: v.to(DEV) for k, v in (("obs", obs), ("ctl", ctl))}
        want = packed_act_rows(srv._apply, srv._params, d["obs"],
                               d["ctl"][0], d["ctl"][1], d["ctl"][2].long())
        out["rows"] = (got - want.cpu()).abs().max().item()
        roll = srv._roll_progs[0]
        roll.dev["stack"].copy_(d["obs"])
        stack = d["obs"].clone()
        roll.stage("new", 0, n, new.numpy())
        roll.stage("ctl", 0, n, ctl.numpy())
        roll.launch(("new", "ctl"))
        got = torch.from_numpy(roll.result().copy())
        stack, want = packed_roll_act(srv._apply, srv._params, stack,
                                      new.to(DEV), d["ctl"][0], d["ctl"][1],
                                      d["ctl"][2].long())
        out["roll"] = (got - want.cpu()).abs().max().item()
        out["roll_stack_equal"] = bool(torch.equal(stack, roll.dev["stack"]))
    srv._stream.synchronize()
    return out


def _sweep_check(spec, clients: int, gen) -> dict:
    """``clients`` clients submit the same full observations before the
    server starts, so its first sweep takes them all in one forward; each
    client's q_sel and q_max against its own forward at one client's
    width, eagerly, within SWEEP_RTOL/ATOL, and its actions equal wherever
    the top-two gap of q exceeds the tolerance."""
    from pytorch_distributed_tpu_torch.models.policies import packed_act_rows

    opt = _batched_opt("batched", f"sweep{clients}")
    # a pipe's send of a full stack waits for a reader: in-process queues
    # hold every request until the server starts
    srv, cs = _server(opt, spec, clients, in_process=True)
    n = NATIVE_ENVS
    obs = torch.randint(0, 255, (n, *FRAME), generator=gen,
                        dtype=torch.uint8)
    sent = []
    for c in cs:
        eps = torch.rand(n, generator=gen)
        u = torch.rand(n, generator=gen)
        a = torch.randint(0, ACTIONS, (n,), generator=gen)
        c.begin_session(eps.numpy())
        sent.append((c.submit(obs.numpy(), 1, u.numpy(), a.numpy()),
                     eps, u, a))
    srv.start()
    try:
        got = [c.collect(h, timeout=120.0) for c, (h, *_r) in zip(cs, sent)]
        with torch.cuda.stream(srv._stream):
            q = srv._apply(srv._params, obs.to(DEV)).cpu()
            want = [packed_act_rows(srv._apply, srv._params, obs.to(DEV),
                                    e.to(DEV), u.to(DEV), a.to(DEV)).cpu()
                    for _h, e, u, a in sent]
        srv._stream.synchronize()
    finally:
        srv.stop()
    if srv.stats["batches"] != 1 or srv.stats["widest_batch"] != clients * n:
        raise AssertionError(f"{clients} clients were not one sweep: "
                             f"{srv.stats}")
    top2 = q.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > SWEEP_ATOL
    equal, worst = 0, 0.0
    for g, w in zip(got, want):
        g = torch.from_numpy(g)
        torch.testing.assert_close(g[1:], w[1:], rtol=SWEEP_RTOL,
                                   atol=SWEEP_ATOL)
        worst = max(worst, (g[1:] - w[1:]).abs().max().item())
        same = g[0] == w[0]
        if not bool(same[clear].all()):
            raise AssertionError(f"{clients} clients: an action with a "
                                 f"clear top-two gap differs")
        equal += int(same.sum())
    return {"rows": srv.stats["widest_batch"],
            "bucket": min(r for r in srv._rows_progs
                          if r >= clients * n),
            "max_abs_q_diff": worst,
            "equal_action_share": equal / (clients * n)}


def _timed_clients(spec, clients: int, gen) -> dict:
    """``clients`` threads, each a client sending TIMED_TICKS rolled frame
    stacks (packed after the first): round trip ms per request, rows per
    sweep, and the server's device ms per forward (its roll-act graph at
    one client's width and its rows graph at the widest bucket, replayed
    alone on its stream and timed by events)."""
    import threading

    opt = _batched_opt("batched", f"timed{clients}")
    srv, cs = _server(opt, spec, clients)
    n = NATIVE_ENVS
    frames = torch.randint(0, 255, (TIMED_TICKS + FRAME[0], n, *FRAME[1:]),
                           generator=gen, dtype=torch.uint8).numpy()
    rtt = [[] for _ in cs]
    errors = []

    def client(i):
        try:
            c = cs[i]
            c.begin_session(np.full(n, 0.1, np.float32))
            u = np.ones(n, np.float32)
            a = np.zeros(n, np.int64)
            for k in range(TIMED_TICKS):
                obs = np.ascontiguousarray(
                    frames[k:k + FRAME[0]].transpose(1, 0, 2, 3))
                t0 = time.perf_counter()
                c.collect(c.submit(obs, k + 1, u, a), timeout=120.0)
                rtt[i].append(time.perf_counter() - t0)
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    srv.start()
    try:
        ts = [threading.Thread(target=client, args=(i,)) for i in
              range(clients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(300)
        dev_ms = {}
        for name, prog in (("roll_16", srv._roll_progs[0]),
                           (f"rows_{max(srv._rows_progs)}",
                            srv._rows_progs[max(srv._rows_progs)])):
            start, end = torch.cuda.Event(True), torch.cuda.Event(True)
            with torch.cuda.stream(srv._stream):
                prog.graph.replay()
                start.record()
                for _ in range(50):
                    prog.graph.replay()
                end.record()
            end.synchronize()
            dev_ms[name] = start.elapsed_time(end) / 50
    finally:
        srv.stop()
    if errors:
        raise errors[0]
    all_rtt = sorted(x for r in rtt for x in r[1:])
    st = srv.stats
    if st["requests"] != clients * TIMED_TICKS or st["packed"] != \
            clients * (TIMED_TICKS - 1):
        raise AssertionError(f"{clients} clients: {st}")
    return {"round_trip_ms_mean": 1e3 * sum(all_rtt) / len(all_rtt),
            "round_trip_ms_p50": 1e3 * all_rtt[len(all_rtt) // 2],
            "round_trip_ms_p99": 1e3 * all_rtt[int(len(all_rtt) * 0.99)],
            "rows_per_sweep": st["rows"] / st["batches"],
            "rows_per_forward": st["rows"] / st["forwards"],
            "device_ms_per_forward": dev_ms, "stats": dict(st)}


def inference():
    """The shared inference server alone on the card (random weights from
    ``init_params``): one batched actor of 16 envs over 300 ticks of
    native Pong against an ``inline`` actor on its own CUDA stream at the
    same seed and weights (every env resets at ticks 100 and 200, so full
    uploads reseed the stack mid-run): identical sha256 streams; each
    program's graph against the eager act (bit-equal); coalesced sweeps of
    2 and 6 clients against one client's forward (SWEEP_RTOL, SWEEP_ATOL);
    round trip, device ms per forward and rows per sweep at 1, 2 and 6
    clients."""
    from pytorch_distributed_tpu_torch.agents.actor import bounded_actor_run
    from pytorch_distributed_tpu_torch.factory import probe_env

    gen = torch.Generator().manual_seed(9)
    opt_b = _batched_opt("batched", "inference")
    spec = probe_env(opt_b)
    srv, (client,) = _server(opt_b, spec, 1)
    srv.start()
    try:
        graph_vs_eager = _graph_vs_eager(srv, spec, gen)
        batched = bounded_actor_run(opt_b, ACTOR_TICKS, spec=spec,
                                    inference=client)
    finally:
        srv.stop()
    inline = bounded_actor_run(_batched_opt("inline", "inference_inline"),
                               ACTOR_TICKS, spec=spec)
    if (graph_vs_eager["rows"], graph_vs_eager["roll"]) != (0.0, 0.0) \
            or not graph_vs_eager["roll_stack_equal"]:
        raise AssertionError(f"graph against eager: {graph_vs_eager}")
    a, b = _digest(inline["stream"]), _digest(batched["stream"])
    if a != b or len(inline["stream"]) != len(batched["stream"]):
        raise AssertionError("the batched stream differs from the inline "
                             "one")
    st = srv.stats
    full = st["requests"] - st["packed"]
    if st["packed"] == 0 or full < 3:
        raise AssertionError(f"both upload paths did not run: {st}")
    phases = {k[len("actor/time_"):-3]: v for k, v in
              batched["timer_ms"].items()
              if k.endswith("_ms") and not k.endswith(("_max_ms",
                                                       "_total_ms"))}
    return {"streams": "batched == inline on the card (sha256 of every "
                       "row)", "rows": len(batched["stream"]),
            "ticks": ACTOR_TICKS, "envs": NATIVE_ENVS,
            "server_stats": dict(st), "full_requests": full,
            "graph_vs_eager_max_abs": graph_vs_eager,
            "batched_frames_per_sec":
                batched["env_steps"] / batched["seconds"],
            "inline_frames_per_sec": inline["env_steps"] / inline["seconds"],
            "batched_phases_ms": phases,
            "sweep_tolerance": {"rtol": SWEEP_RTOL, "atol": SWEEP_ATOL},
            "sweeps": {k: _sweep_check(spec, k, gen) for k in (2, 6)},
            "timed": {k: _timed_clients(spec, k, gen) for k in (1, 2, 6)}}


def train_batched():
    """Config 12 at full width through ``main`` on the process backend with
    ``actor_backend=batched``, unpaced and then paced (the reference's
    flags): the same launches per update, a finite loss, no child with
    CUDA, ``inference/rows`` equal to the actors' frames within one tick
    per actor, beside train_process's and train_paced's numbers."""
    out = {}
    for name, sets in (("unpaced", ()),
                       ("paced", ("max_replay_ratio=8", "learn_start=5000"))):
        r, summary = _train_through_main("process", f"batched_{name}",
                                         "actor_backend=batched", *sets)
        RESULTS[f"launches_batched_{name}"] = r["launches"]
        if summary["runtime/children_with_cuda"] != 0:
            raise AssertionError("a child made a CUDA context")
        over = summary["inference/rows"] - summary["runtime/actor_steps"]
        if not 0 <= over <= 2 * NATIVE_ENVS:
            raise AssertionError(
                f"{name}: inference/rows {summary['inference/rows']} for "
                f"{summary['runtime/actor_steps']} actor frames")
        r = {k: r[k] for k in ("launches", "updates_per_sec",
                               "actor_frames_per_sec", "actor_phases_ms",
                               "replay_ratio", "host_s", "train_seconds",
                               "critic_loss")}
        r["inference"] = {k.split("/", 1)[1]: v for k, v in summary.items()
                          if k.startswith("inference/")}
        r["rows_over_frames"] = over
        out[name] = r
    keys = ("updates_per_sec", "actor_frames_per_sec", "actor_phases_ms",
            "host_s")
    return dict(out, card=card_name_and_power_limit(), pipelined={
        "unpaced": {k: RESULTS.get("e2e_process", {}).get(k) for k in keys},
        "paced": {k: RESULTS.get("e2e_paced", {}).get(k) for k in keys}})


def _zero_launches() -> None:
    for fn in (cuda_sampling.hierarchical_sample, *cuda_torso.COUNTERS):
        fn.launches = 0


def _launches_per_update(updates: int) -> dict:
    """The launch counters over ``updates``; raises unless each update
    launched 1 draw and 10 + 9 bf16 GEMMs and no fp32 one."""
    got = {"per_sample": cuda_sampling.hierarchical_sample.launches,
           "torso_gemm_fwd": cuda_torso.gemm_bf16.launches,
           "torso_gemm_bwd": cuda_torso.gemm_bf16_grad.launches,
           "torso_gemm_f32": cuda_torso.gemm_f32.launches}
    if updates <= 0 or got != expected_launches(updates):
        raise AssertionError(f"launch counts {got} for {updates} updates")
    return got


def _drill_timer(topology, out: dict) -> None:
    """Leg 1's faults: SIGKILL ``actor-0`` past learner step 300, time its
    respawn to a first tick, SIGSTOP ``actor-1`` past step 900."""
    import multiprocessing
    import signal

    clock, board = topology.clock, topology.progress_board

    def child(name):
        return next(p for p in multiprocessing.active_children()
                    if p.name == name)

    def wait(pred, what, timeout=240.0):
        deadline = time.monotonic() + timeout
        while not pred():
            if clock.stop.is_set() or time.monotonic() > deadline:
                raise AssertionError(f"leg 1: {what}")
            time.sleep(0.005)

    try:
        wait(lambda: clock.learner_step.value > 300, "no step 300")
        os.kill(child("actor-0").pid, signal.SIGKILL)
        t_kill = time.monotonic()
        out["killed_at_step"] = clock.learner_step.value
        wait(lambda: topology.restarts >= 1, "no respawn")
        wait(lambda: board.marks("actor-0") > 0, "no respawned tick")
        out["respawn_to_first_tick_s"] = time.monotonic() - t_kill
        wait(lambda: clock.learner_step.value > 900, "no step 900")
        os.kill(child("actor-1").pid, signal.SIGSTOP)
        out["stopped_at_step"] = clock.learner_step.value
        t_stop = time.monotonic()
        wait(lambda: topology.hang_kills >= 1, "no hang kill")
        out["stop_to_hang_kill_s"] = time.monotonic() - t_stop
    except BaseException as e:  # noqa: BLE001 - reported by the leg
        out["error"] = repr(e)


# leg 1's updates: after the SIGSTOP (about step 1,000 on a fast host)
# the paced run needs time for the 10 s watchdog and the respawn
DRILL_STEPS = 3500


def _resume_leg_drill() -> dict:
    import threading

    from pytorch_distributed_tpu_torch import main as port_main
    from pytorch_distributed_tpu_torch import runtime

    opt = port_main.options_from_args(port_main.parse_args(_e2e_argv(
        "process", "resume_drill", "max_replay_ratio=8",
        "hang_deadline=10", "hang_grace=120", "checkpoint_freq=500",
        "evaluator_nepisodes=0", steps=DRILL_STEPS)))
    topology = runtime.Topology(opt, backend="process")
    faults: dict = {}
    timer = threading.Thread(target=_drill_timer, args=(topology, faults),
                             daemon=True)
    _zero_launches()
    timer.start()
    summary = topology.run()
    launches = _launches_per_update(summary["learner/steps"])
    timer.join(timeout=10.0)
    if "error" in faults or summary["learner/steps"] < DRILL_STEPS:
        raise AssertionError(f"leg 1: {faults} {summary}")
    counts = {k: summary[f"runtime/{k}"] for k in (
        "restarts", "hang_kills", "children_with_cuda", "preempted")}
    if counts != {"restarts": 2, "hang_kills": 1, "children_with_cuda": 0,
                  "preempted": 0}:
        raise AssertionError(f"leg 1: runtime counts {counts}")
    return dict(faults, **counts, launches=launches,
                updates_per_sec=summary["learner/updates_per_sec"],
                epochs=summary["checkpoint/epochs_committed"],
                epoch_bytes=summary["checkpoint/epoch_bytes"],
                save_s_per_epoch=summary["checkpoint/save_seconds"]
                / summary["checkpoint/epochs_committed"])


PREEMPT_AT = 1000


def _resume_leg_preempt() -> dict:
    import signal

    argv = _e2e_argv("process", "preempt", "checkpoint_replay=true")
    argv[argv.index("--steps") + 1] = str(10 ** 6)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
        os.path.dirname(os.path.abspath(__file__)),
        os.environ.get("PYTHONPATH")))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.main", *argv],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, sent = [], None
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            m = re.match(r"\[learner\] step (\d+) ", line)
            if m and int(m.group(1)) >= PREEMPT_AT:
                break
        proc.send_signal(signal.SIGTERM)
        sent = time.monotonic()
        out, _ = proc.communicate(timeout=60)
        exit_s = time.monotonic() - sent
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines += out.splitlines()
    if proc.returncode != 0 or exit_s >= 60.0:
        raise AssertionError(f"leg 2: exit {proc.returncode} after "
                             f"{exit_s} s: " + "\n".join(lines[-40:]))
    summary = json.loads(next(ln for ln in reversed(lines)
                              if ln.startswith("{")))
    root = os.path.join(RUN_DIR, "models", "preempt_ckpt")
    fsck = subprocess.run(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.ckpt_fsck",
         root, "--json"], env=env, capture_output=True, text=True,
        timeout=600)
    report = json.loads(fsck.stdout.strip().splitlines()[-1])
    if fsck.returncode != 0:
        raise AssertionError(f"leg 2: fsck {report}")
    newest = report["epochs"][0]
    if set(newest["artifacts"]) != {"state.pt", "replay.npz",
                                    "extras.json"}:
        raise AssertionError(f"leg 2: epoch holds {newest['artifacts']}")
    return {"exit_code": proc.returncode, "sigterm_to_exit_s": exit_s,
            "preempted": summary["runtime/preempted"],
            "steps": summary["learner/steps"], "epoch": newest["epoch"],
            "epoch_step": newest["learner_step"],
            "epoch_bytes": newest["bytes"],
            "artifact_bytes": newest["artifacts"],
            "save_s": summary["checkpoint/save_seconds"],
            "replay_rows": summary["replay/size"]}


def _resume_leg_resume(preempt: dict) -> dict:
    import threading

    from pytorch_distributed_tpu_torch import main as port_main
    from pytorch_distributed_tpu_torch import runtime
    from pytorch_distributed_tpu_torch.agents.param_store import (
        make_flattener,
    )
    from pytorch_distributed_tpu_torch.utils import checkpoint

    argv = _e2e_argv("process", "preempt", "checkpoint_replay=true")
    argv[argv.index("--steps") + 1] = str(preempt["epoch_step"] + 1000)
    opt = port_main.options_from_args(port_main.parse_args(
        argv + ["--resume", "preempt"]))
    info = checkpoint.resolve_epoch(opt.model_name)
    want, _ = make_flattener(checkpoint.load_epoch_state(info).params, FRAME)
    rows = info.manifest["artifacts"]["replay.npz"]["rows"]
    topology = runtime.Topology(opt, backend="process")
    store, first = topology.param_store, {}

    def watch():  # the first publication, before the ring's restore ends
        while not topology.clock.stop.is_set():
            got = store.fetch(0)
            if got is not None:
                first["flat"], first["version"] = got
                return
            time.sleep(0.0005)

    watcher = threading.Thread(target=watch, daemon=True)
    _zero_launches()
    watcher.start()
    summary = topology.run()
    watcher.join(timeout=5.0)
    updates = summary["learner/steps"] - summary["learner/resumed_from_step"]
    launches = _launches_per_update(updates)
    if first.get("version") != 1 or not np.array_equal(first["flat"], want):
        raise AssertionError(f"leg 3: the first publication (version "
                             f"{first.get('version')}) is not the epoch's "
                             f"params")
    if (summary["learner/resumed_from_step"] != info.learner_step
            or summary["replay/restored_rows"] != min(rows, RING_ROWS)
            or summary["learner/steps"] != info.learner_step + 1000):
        raise AssertionError(f"leg 3: {summary}")
    return {"resumed_epoch": info.epoch,
            "resumed_from_step": info.learner_step,
            "steps": summary["learner/steps"], "launches": launches,
            "first_publication": "bit-equal to state.pt",
            "restored_rows": summary["replay/restored_rows"],
            "restore_s": summary["checkpoint/restore_seconds"],
            "updates_per_sec": summary["learner/updates_per_sec"],
            "children_with_cuda": summary["runtime/children_with_cuda"]}


def resume():
    """Supervision and resume at config 12's full width, in three legs:
    restarts and the hang watchdog, SIGTERM preemption, resume."""
    drill = _resume_leg_drill()
    preempt = _resume_leg_preempt()
    resumed = _resume_leg_resume(preempt)
    return {"card": card_name_and_power_limit(), "drill": drill,
            "preempt": preempt, "resume": resumed,
            "train_process_updates_per_sec": RESULTS.get(
                "e2e_process", {}).get("updates_per_sec")}


# ---------------------------------------------------------------------------
# the device env fleet, the fused rollout and the Anakin loop
# ---------------------------------------------------------------------------

FLEET = 32  # config 12's fleet: 2 actors x 16 envs
# train_anakin's traced windows, in learner steps: a strict window's
# trace holds every kernel of 40 rollouts
TRACE_WINDOWS = {"strict": (300, 340), "ratio16": (400, 600)}
ENV_SIZES = (32, 256, 1024)
ENV_EARLY_STOP, ENV_STEPS = 100, 350  # 3 truncated episodes and a half
ROLLOUT_TICKS, ROLLOUT_TIMED = 8, 50


def _graph_of(fn):
    """``fn()`` captured into a CUDA graph on a side stream (after two
    uncaptured calls for lazy set-up), and its outputs."""
    side = torch.cuda.Stream(DEV)
    side.wait_stream(torch.cuda.current_stream(DEV))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(DEV).wait_stream(side)
    return graph, out


def _replay_ms(graph, reps: int) -> float:
    """Device ms per replay of ``graph``, by CUDA events over ``reps``."""
    graph.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_env():
    """Torch device Pong on the card against the numpy float32 oracle
    (envs/device_env.py ``NumpyOps``), every state and StepOut field to the
    bit at every step of 350 steps of 32 envs (early_stop 100: three full
    truncated episodes, points scored and serves redrawn); then ms per
    tick at 32, 256 and 1,024 envs: one step replayed from a CUDA graph
    (device time by events) and the same step eager (host clock after a
    synchronize)."""
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.envs.device_env import (
        NumpyOps, TorchOps, build_device_env,
    )

    ep = build_options(12, early_stop=ENV_EARLY_STOP).env_params
    dev = build_device_env(ep, 0, FLEET, ops=TorchOps(DEV))
    orc = build_device_env(ep, 0, FLEET, ops=NumpyOps(np.float32))
    sd, so = dev.init(), orc.init()
    rng = np.random.default_rng(11)
    ends = 0
    for t in range(ENV_STEPS):
        acts = rng.integers(0, ACTIONS, FLEET)
        sd, od = dev.step(sd, torch.as_tensor(acts, device=DEV))
        so, oo = orc.step(so, acts)
        for tup_d, tup_o in ((od, oo), (sd, so)):
            for name, a, b in zip(tup_d._fields, tup_d, tup_o):
                if not np.array_equal(a.cpu().numpy(), b):
                    raise AssertionError(f"step {t}: {name} differs from "
                                         f"the numpy oracle")
        ends += int(od.terminal.sum())
    if ends != 3 * FLEET or int(sd.rng_count.max()) <= 3:
        raise AssertionError(f"{ends} episode ends, rng_count "
                             f"{int(sd.rng_count.max())}")
    timing = {}
    for n in ENV_SIZES:
        env = build_device_env(ep, 0, n, ops=TorchOps(DEV))
        state = env.init()
        acts = torch.randint(0, ACTIONS, (n,), device=DEV,
                             generator=torch.Generator(device=DEV).manual_seed(n))

        def step():
            nxt, out = env.step(state, acts)
            for dst, src in zip(state, nxt):
                if src is not dst:
                    dst.copy_(src)
            return out

        graph, _out = _graph_of(step)
        graph_ms = _replay_ms(graph, 200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            step()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / 50 * 1e3
        timing[n] = {"graph_ms_per_tick": graph_ms,
                     "eager_ms_per_tick": eager_ms,
                     "graph_frames_per_sec": n / graph_ms * 1e3}
    RESULTS["device_env"] = timing
    return {"oracle": f"bit-equal, {ENV_STEPS} steps x {FLEET} envs, "
                      f"{ends} episode ends", "timing": timing,
            "card": card_name_and_power_limit()}


def _fleet_rollout(emit: str, graph: bool, ring=None):
    """Config 12's fleet (32 envs, K 8, nstep 5, random bf16 dqn-cnn
    weights from seed 3) as a fused rollout on the card, its carry, the
    weights and a generator at seed 5."""
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.factory import (
        build_device_env, build_model, init_params, module_apply, probe_env,
    )
    from pytorch_distributed_tpu_torch.memory.device_per import (
        per_write_masked,
    )
    from pytorch_distributed_tpu_torch.models.policies import (
        apex_epsilons, build_fused_rollout, init_rollout_carry,
    )

    opt = build_options(12, early_stop=EARLY_STOP)
    spec = probe_env(opt)
    ap = opt.agent_params
    env = build_device_env(opt, 0, FLEET, DEV)
    roll = build_fused_rollout(
        module_apply(build_model(opt, spec, init_weights=False)), env,
        nstep=ap.nstep, gamma=ap.gamma, rollout_ticks=ROLLOUT_TICKS,
        eps=apex_epsilons(0, 1, FLEET, ap.eps, ap.eps_alpha), emit=emit,
        ring=ring, ring_write_fn=per_write_masked, graph=graph)
    params = init_params(opt, spec, seed=3, device=DEV)
    return (roll, init_rollout_carry(env, ap.nstep), params,
            torch.Generator(device=DEV).manual_seed(5))


def fused_rollout():
    """The fused rollout of config 12's fleet on the card (32 envs x 8
    ticks a dispatch, nstep 5, the module's bf16 forward): the graphed
    rollout against the same rollout run eagerly, every chunk column of 6
    dispatches to the bit (the first two graphed calls run eagerly, the
    rest replay the graph); ``emit="replay"`` (graphed, into a PER ring)
    against ``emit="chunk"``'s valid rows fed into another ring
    (``feed_chunk``), the rings' columns, priorities and cursors to the
    bit after 6 dispatches; then device ms per dispatch of the graph by
    CUDA events over 50 dispatches, and frames/s of the rollout alone."""
    from pytorch_distributed_tpu_torch.memory.device_per import (
        DevicePerReplay,
    )
    from pytorch_distributed_tpu_torch.utils.experience import (
        REPLAY_FIELDS, Transition,
    )

    eager = _fleet_rollout("chunk", graph=False)
    graphed = _fleet_rollout("chunk", graph=True)
    fed = DevicePerReplay(4096, FRAME, device=DEV)
    direct = DevicePerReplay(4096, FRAME, device=DEV)
    replay = _fleet_rollout("replay", graph=True, ring=direct.state)
    dispatches = 6
    for d in range(dispatches):
        chunks = []
        for roll, carry, params, gen in (eager, graphed):
            roll.draw(gen)
            ch = roll(params, carry)
            chunks.append({f: getattr(ch, f).cpu() for f in ch._fields})
        for f in chunks[0]:
            if not torch.equal(chunks[0][f], chunks[1][f]):
                raise AssertionError(f"dispatch {d}: graphed {f} differs "
                                     f"from eager")
        valid = chunks[0]["valid"]
        if valid.any():
            fed.feed_chunk(Transition(*(chunks[0][f][valid]
                                        for f in REPLAY_FIELDS)))
        roll, carry, params, gen = replay
        roll.draw(gen)
        stats = roll(params, carry)
        if stats.rows != int(valid.sum()) or int(stats.fed) != stats.rows:
            raise AssertionError(f"dispatch {d}: {stats.rows} rows, "
                                 f"{int(stats.fed)} written, "
                                 f"{int(valid.sum())} valid")
    for f in REPLAY_FIELDS + ("priority", "max_priority", "fill_rows"):
        if not torch.equal(getattr(fed.state, f), getattr(direct.state, f)):
            raise AssertionError(f"replay emit: ring {f} differs from the "
                                 f"chunk emit's")
    if (fed.state.pos, fed.state.fill) != (direct.state.pos,
                                           direct.state.fill):
        raise AssertionError("replay emit: cursor differs")
    roll, carry, params, gen = graphed
    roll.draw(gen)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(ROLLOUT_TIMED):
        roll(params, carry)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / ROLLOUT_TIMED
    frames = FLEET * ROLLOUT_TICKS
    RESULTS["fused_rollout"] = {"device_ms_per_dispatch": ms,
                                "frames_per_sec": frames / ms * 1e3}
    return {"graph_vs_eager": f"bit-equal over {dispatches} dispatches",
            "replay_vs_chunk": f"bit-equal rings, {direct.state.fill} rows",
            "envs": FLEET, "ticks": ROLLOUT_TICKS,
            "device_ms_per_dispatch": ms,
            "device_ms_per_tick": ms / ROLLOUT_TICKS,
            "frames_per_sec": frames / ms * 1e3,
            "card": card_name_and_power_limit()}


def _traced_run(argv, start: int, stop: int, name: str) -> tuple:
    """``argv`` run as ``main`` runs it (``runtime.Topology``, the learner
    on this thread) with the device traced by ``torch.profiler`` (CUDA
    activity only: tracing the host's ops slows the loop) from learner
    step ``start`` to ``stop``.  The profiler starts and stops in the
    learner's own thread, between two replays of its graph (a hook on
    ``GraphedFusedStep``): one started from another thread hung beside
    the replays.  Returns (summary, the window)."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_tpu_torch import main as port_main
    from pytorch_distributed_tpu_torch import runtime
    from pytorch_distributed_tpu_torch.memory.device_per import (
        GraphedFusedStep,
    )

    opt = port_main.options_from_args(port_main.parse_args(argv))
    topology = runtime.Topology(opt, backend="process")
    clock = topology.clock
    window: dict = {}
    traced: dict = {}
    replay = GraphedFusedStep.__call__

    def hooked(self, *args, **kw):
        step = clock.learner_step.value
        if "prof" not in traced and start <= step < stop:
            traced["prof"] = profile(activities=[ProfilerActivity.CUDA])
            traced["prof"].__enter__()
            traced["t0"], traced["s0"] = time.perf_counter(), step
        elif "prof" in traced and "window" not in traced and step >= stop:
            torch.cuda.synchronize()
            window["window_s"] = time.perf_counter() - traced["t0"]
            window["updates"] = step - traced["s0"]
            traced["prof"].__exit__(None, None, None)
            traced["window"] = True
        return replay(self, *args, **kw)

    GraphedFusedStep.__call__ = hooked
    try:
        summary = topology.run()
    finally:
        GraphedFusedStep.__call__ = replay
        if "prof" in traced and "window" not in traced:
            traced["prof"].__exit__(None, None, None)
    if "window" not in traced:
        raise AssertionError(f"no trace window from step {start} to "
                             f"{stop}: {summary}")
    prof = traced["prof"]
    window["trace"] = os.path.join(RUN_DIR, f"{name}.json")
    prof.export_chrome_trace(window["trace"])
    window["top_kernels_ms"] = sorted(
        ((e.key[:60], e.self_device_time_total / 1e3)
         for e in prof.key_averages() if e.self_device_time_total > 0),
        key=lambda kv: -kv[1])[:8]
    _busy_share(window)
    return summary, window


def _busy_share(window: dict) -> None:
    """Add the trace's busy ms per update and idle share to ``window``."""
    busy_us, spans = _busy_us(window["trace"])
    if not spans:
        raise AssertionError("the trace holds no device activity")
    window.update(device_spans=spans,
                  device_busy_ms_per_update=busy_us / 1e3 / window["updates"],
                  device_idle_share_traced=1.0 - busy_us
                  / (window["window_s"] * 1e6),
                  window_updates_per_sec=window["updates"]
                  / window["window_s"])


def _anakin_loop_traced(sets, start: int, stop: int, name: str) -> dict:
    """The Anakin driver of config 12 at full width (the options of the
    run through ``main``) driven here, in this thread, by its own
    scheduler (``want_rollout``, then a rollout or a learner dispatch)
    to learner step ``start``; then ``stop - start`` updates timed
    without the profiler and as many traced by ``torch.profiler`` (CUDA
    activity), the profiler started and stopped between dispatches in
    the thread that launches them.  Returns the traced window with its
    idle share, and the untraced window's updates/s."""
    from torch.profiler import ProfilerActivity, profile

    from pytorch_distributed_tpu_torch import main as port_main
    from pytorch_distributed_tpu_torch.agents.anakin import AnakinDriver
    from pytorch_distributed_tpu_torch.agents.clocks import (
        ActorStats, GlobalClock, LearnerStats,
    )
    from pytorch_distributed_tpu_torch.agents.param_store import (
        ParamStore, num_params,
    )
    from pytorch_distributed_tpu_torch.factory import (
        build_memory, build_model, probe_env,
    )

    opt = port_main.options_from_args(port_main.parse_args(_e2e_argv(
        "process", f"anakin_{name}_trace", "actor_backend=anakin", *sets)))
    spec = probe_env(opt)
    handles = build_memory(opt, spec, in_process=True)
    store = ParamStore(num_params(build_model(
        opt, spec, init_weights=False).state_dict()))
    drv = AnakinDriver(opt, spec, handles.learner_side, store, GlobalClock(),
                       LearnerStats(), actor_stats=ActorStats())

    def until(step: int) -> float:
        torch.cuda.synchronize()
        t0, s0 = time.perf_counter(), drv.lstep
        while drv.lstep < step:
            if drv.want_rollout():
                drv.dispatch_rollout()
            else:
                drv.dispatch_learn()
        torch.cuda.synchronize()
        return (drv.lstep - s0) / (time.perf_counter() - t0)

    try:
        until(start)
        untraced = until(start + (stop - start))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0, s0 = time.perf_counter(), drv.lstep
            until(drv.lstep + (stop - start))
            window = {"window_s": time.perf_counter() - t0,
                      "updates": drv.lstep - s0}
    finally:
        drv.writer.close()
        handles.learner_side.close()
    window["trace"] = os.path.join(RUN_DIR, f"anakin_{name}.json")
    prof.export_chrome_trace(window["trace"])
    window["top_kernels_ms"] = sorted(
        ((e.key[:60], e.self_device_time_total / 1e3)
         for e in prof.key_averages() if e.self_device_time_total > 0),
        key=lambda kv: -kv[1])[:8]
    _busy_share(window)
    window["untraced_updates_per_sec"] = untraced
    # not traced: the window's busy ms per update at the untraced rate
    window["device_idle_share_estimate_at_untraced_rate"] = 1.0 - window[
        "device_busy_ms_per_update"] * untraced / 1e3
    return window


def train_anakin():
    """Config 12 at full width through ``main`` with ``actor_backend=
    anakin`` on the process backend (the evaluator and the logger in
    spawn children, the fleet of 2 x 16 envs and the learner in this
    process), at strict alternation and at ``rollout_ratio`` 16 (the
    reference's replay ratio 8 at batch 128): 1 draw and 10 + 9 bf16 GEMMs
    per update and no fp32 GEMM, a finite loss, no actor child and no
    child with CUDA, evaluator rows; updates/s, frames/s and the duty
    cycle (the rollouts' share of the device time between CUDA events).
    Then each variant's loop traced over ``TRACE_WINDOWS``
    (``_anakin_loop_traced``): the idle share of the device."""
    from pytorch_distributed_tpu_torch import runtime
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.utils import metrics

    out = {}
    spawn = runtime.Topology._spawn
    for name, sets in (("strict", ()), ("ratio16", ("rollout_ratio=16",))):
        roles: list = []

        def spy(topology, role, ind, args, roles=roles):
            roles.append(role)
            return spawn(topology, role, ind, args)

        runtime.Topology._spawn = spy  # notes the role of every child
        try:
            r, summary = _train_through_main(
                "process", f"anakin_{name}", "actor_backend=anakin", *sets,
                phases=())
        finally:
            runtime.Topology._spawn = spawn
        RESULTS[f"launches_anakin_{name}"] = r["launches"]
        if "actor" in roles or summary["runtime/children_with_cuda"] != 0:
            raise AssertionError(f"children {roles}, "
                                 f"{summary['runtime/children_with_cuda']} "
                                 f"with CUDA")
        if summary["anakin/rollouts"] <= 0 or summary[
                "runtime/actor_steps"] != summary["anakin/frames"]:
            raise AssertionError(f"anakin {name}: {summary}")
        tags = {row["tag"] for row in metrics.read_scalars(build_options(
            12, root_dir=RUN_DIR, refs=f"anakin_{name}").log_dir)}
        if not {"evaluator/avg_reward", "learner/critic_loss",
                "anakin/duty_cycle"} <= tags:
            raise AssertionError(f"scalars.jsonl holds only {sorted(tags)}")
        window = _anakin_loop_traced(sets, *TRACE_WINDOWS[name], name)
        out[name] = {
            "launches": r["launches"],
            "updates_per_sec": r["updates_per_sec"],
            "frames_per_sec": r["actor_frames_per_sec"],
            "duty_cycle": summary["anakin/duty_cycle"],
            "rollout_device_s": summary["anakin/rollout_s"],
            "learn_device_s": summary["anakin/learn_s"],
            "rollouts": summary["anakin/rollouts"],
            "learns": summary["anakin/learns"],
            "train_seconds": r["train_seconds"],
            "critic_loss": r["critic_loss"],
            "replay_ratio": r["replay_ratio"],
            "children": sorted(set(roles)),
            "traced": {k: window[k] for k in (
                "window_s", "updates", "window_updates_per_sec",
                "untraced_updates_per_sec", "device_busy_ms_per_update",
                "device_idle_share_traced",
                "device_idle_share_estimate_at_untraced_rate",
                "top_kernels_ms")}}
    keys = ("updates_per_sec", "actor_frames_per_sec", "host_s")
    return dict(out, card=card_name_and_power_limit(), beside={
        run: {k: RESULTS.get(f"e2e_{run}", {}).get(k) for k in keys}
        for run in ("process", "paced", "batched_unpaced",
                    "batched_paced")})


def train_device():
    """Config 12 at full width through ``main`` on the process backend
    with ``actor_backend=device``: each actor child steps its 16 envs as
    one fused rollout on the CPU (8 ticks a dispatch); the same launches
    per update, a finite loss, no child with CUDA; frames/s, the actors'
    phases (rollout, emit, advance) and the learner's host seconds.
    Then one device actor of 16 envs in this process on the card, as the
    thread backend runs it (its rollout one CUDA graph on the actor's
    stream), for 40 dispatches: the rows it fed and its frames/s."""
    from pytorch_distributed_tpu_torch.agents.actor import bounded_actor_run
    from pytorch_distributed_tpu_torch.config import build_options

    r, summary = _train_through_main("process", "device",
                                     "actor_backend=device",
                                     phases=("rollout", "emit", "advance"))
    RESULTS["launches_device"] = r["launches"]
    if summary["runtime/children_with_cuda"] != 0:
        raise AssertionError("a child made a CUDA context")
    opt = build_options(
        12, device="cuda", num_actors=2, num_envs_per_actor=NATIVE_ENVS,
        actor_backend="device", early_stop=EARLY_STOP, actor_freq=10 ** 9,
        root_dir=RUN_DIR, refs="device_gpu_actor")
    dispatches = 40
    gpu = bounded_actor_run(opt, dispatches)
    k, nstep = opt.env_params.device_rollout_ticks, opt.agent_params.nstep
    rows = NATIVE_ENVS * (dispatches * k - nstep)
    if len(gpu["stream"]) != rows:
        raise AssertionError(f"the GPU device actor fed "
                             f"{len(gpu['stream'])} rows, not {rows}")
    return dict({k_: r[k_] for k_ in (
        "launches", "updates_per_sec", "actor_frames_per_sec",
        "actor_phases_ms", "replay_ratio", "host_s", "train_seconds",
        "critic_loss")}, gpu_thread_actor={
            "rows": rows, "frames_per_sec": gpu["env_steps"]
            / gpu["seconds"], "timer_ms": gpu["timer_ms"]},
        card=card_name_and_power_limit())


# ---------------------------------------------------------------------------
# the health plane: rollback, quarantine, validator and X-ray costs
# ---------------------------------------------------------------------------

# the drills: actor-0 alone poisons 4 flushes (64 rows) from its 480th,
# near learner step 970 at replay ratio 8 (2 actors x 16 envs: 32 frames
# a tick, 16 frames an update; 830 to 1,110 if one actor runs 15% ahead):
# the epoch of step 800 is the clean restore point, and the default
# streak (3 windows of 50 steps) trips by about step 1,310, before the
# run ends at 1,500 and before the next epoch (1,600)
HEALTH_POISON = ",".join(f"poison_chunk@{n}" for n in range(480, 484))
HEALTH_STEPS, HEALTH_EPOCH = 1500, 800


# the quarantine drill needs no epoch before its poison: four flushes of
# actor-0 early in the warm-up, and a short unpaced run
QUARANTINE_POISON = ",".join(f"poison_chunk@{n}" for n in range(40, 44))
QUARANTINE_STEPS = 600


def _tree_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k])
                                            for k in a)
    return all(_tree_equal(x, y) for x, y in zip(a, b))


def _poison_actor_0(topology, spec: str) -> None:
    """Spawn actor-0, and only it, with ``FEEDER_FAULTS=spec``: one
    poisoning actor, so no second poison can land after the restore."""
    spawn = topology._spawn

    def spawn_poisoned(role, ind, args):
        if (role, ind) == ("actor", 0):
            os.environ["FEEDER_FAULTS"] = spec
        try:
            spawn(role, ind, args)
        finally:
            os.environ.pop("FEEDER_FAULTS", None)

    topology._spawn = spawn_poisoned


def _first_update_spy(seen: dict):
    """A ``GraphedFusedStep`` that, on the first replay handed a train
    state other than its static buffers (the rollback's restored state),
    keeps clones of that state, the ring, the uniforms and beta, runs the
    replay, and keeps its result, the launch counters and its time."""
    from pytorch_distributed_tpu_torch.memory import device_per

    class Spy(device_per.GraphedFusedStep):
        def __call__(self, ts, rs, us, beta):
            if self._graph is None or ts is self._static \
                    or "graph_out" in seen:
                return super().__call__(ts, rs, us, beta)
            from pytorch_distributed_tpu_torch.utils import checkpoint

            torch.cuda.synchronize(DEV)
            seen["counters_at_restore"] = {
                c.__name__: c.launches for c in self._counters}
            seen["state_in"] = device_per._clone_tree(ts)
            seen["ring_in"] = dataclasses.replace(rs, **{
                f.name: getattr(rs, f.name).clone()
                for f in dataclasses.fields(rs)
                if isinstance(getattr(rs, f.name), torch.Tensor)})
            seen["us"], seen["beta"] = us.clone(), float(beta)
            seen["target"] = checkpoint.resolve_epoch(seen["model_name"])
            t0 = time.perf_counter()
            out = super().__call__(ts, rs, us, beta)
            torch.cuda.synchronize(DEV)
            seen["first_update_s"] = time.perf_counter() - t0
            seen["graph_out"] = device_per._clone_tree(out[0])
            seen["graph_priority"] = rs.priority.clone()
            seen["fused"], seen["ring"] = self._fused, rs
            return out

    return Spy


def _restored_ring_is_the_epochs(seen: dict) -> int:
    """The ring the first post-restore update replays holds the target
    epoch's rows and priorities: the restore writes the newest ``n`` from
    slot 0, no update has touched their priorities yet, and the ``k``
    rows drained since then went to the slots after them (over the
    oldest restored ones only if the ring wrapped).  Returns the rows
    compared."""
    ring, target = seen["ring_in"], seen["target"]
    with np.load(os.path.join(target.path, "replay.npz")) as z:
        cols = {k: z[k] for k in ("reward", "action", "gamma_n",
                                  "terminal1", "leaf_priority")}
    cap = ring.reward.shape[0]
    n = min(len(cols["reward"]), cap)
    k = (ring.pos - n) % cap
    lo = max(0, n + k - cap)
    for name, col in (("reward", ring.reward), ("action", ring.action),
                      ("gamma_n", ring.gamma_n),
                      ("terminal1", ring.terminal1),
                      ("leaf_priority", ring.priority)):
        if not np.array_equal(col[lo:n].cpu().numpy(),
                              cols[name][len(cols[name]) - n + lo:]):
            raise AssertionError(f"the restored ring's {name} is not the "
                                 f"epoch's")
    if not torch.isfinite(ring.reward[:ring.fill]).all():
        raise AssertionError("a NaN reward is left in the restored ring")
    return n - lo


def _health_rollback() -> dict:
    """(a) The rollback drill at full width on the process backend."""
    from pytorch_distributed_tpu_torch import main as port_main
    from pytorch_distributed_tpu_torch import runtime
    from pytorch_distributed_tpu_torch.agents import learner as learner_mod
    from pytorch_distributed_tpu_torch.utils import checkpoint, flight_recorder

    opt = port_main.options_from_args(port_main.parse_args(_e2e_argv(
        "process", "health_rollback", "max_replay_ratio=8",
        f"checkpoint_freq={HEALTH_EPOCH}", "checkpoint_replay=true",
        "checkpoint_retain=10", "learner_freq=50",
        "evaluator_nepisodes=0")))
    opt.agent_params.steps = HEALTH_STEPS
    flight_recorder.reset()  # no event of an earlier run in the rings
    topology = runtime.Topology(opt, backend="process")
    _poison_actor_0(topology, HEALTH_POISON)
    seen = {"model_name": opt.model_name}
    graphed = learner_mod.GraphedFusedStep
    learner_mod.GraphedFusedStep = _first_update_spy(seen)
    os.environ["TPU_APEX_QUARANTINE"] = "0"
    _zero_launches()
    try:
        summary = topology.run()
    finally:
        learner_mod.GraphedFusedStep = graphed
        os.environ.pop("TPU_APEX_QUARANTINE", None)
    launches = _launches_per_update(summary["learner/updates"])
    RESULTS["launches_health_rollback"] = launches
    if (summary["health/rollbacks"] != 1 or "graph_out" not in seen
            or summary["learner/steps"] < HEALTH_STEPS):
        raise AssertionError(f"(a) rollbacks {summary['health/rollbacks']}, "
                             f"restore seen {'graph_out' in seen}: {summary}")
    at_restore = seen["counters_at_restore"]
    after = {"hierarchical_sample": launches["per_sample"],
             "gemm_bf16": launches["torso_gemm_fwd"],
             "gemm_bf16_grad": launches["torso_gemm_bwd"]}
    if not all(after[k] > at_restore[k] for k in after):
        raise AssertionError(f"(a) the counters stood still after the "
                             f"restore: {at_restore} -> {after}")
    # the first update after the restore, replayed from the graph, against
    # the same update run eagerly on the same restored state and ring
    ring = seen["ring_in"]
    rows = _restored_ring_is_the_epochs(seen)
    eager_ts, _m = seen["fused"](seen["state_in"], ring, seen["us"],
                                 seen["beta"])
    torch.cuda.synchronize(DEV)
    if not (_tree_equal(seen["graph_out"], eager_ts)
            and torch.equal(seen["graph_priority"], ring.priority)):
        raise AssertionError("(a) the graph's first update after the "
                             "restore differs from the eager update")
    live = topology.handles.learner_side.replay.state
    if live.priority.data_ptr() != seen["ring"].priority.data_ptr() \
            or not torch.isfinite(live.reward).all():
        raise AssertionError("(a) the graph's ring is not the live ring, "
                             "or it holds a NaN reward")
    root = checkpoint.ckpt_root(opt.model_name)
    report = checkpoint.fsck(root)
    target = seen["target"]
    with open(os.path.join(opt.log_dir, "blackbox", "learner.jsonl")) as f:
        events = [json.loads(line) for line in f]
    (rb,) = [e for e in events if e["kind"] == "rollback"]
    # the streak that tripped the rollback starts at its last streak-1 mark
    start = [e for e in events if e["kind"] == "anomaly"
             and e["t"] <= rb["t"] and e["streak"] == 1][-1]
    if report["violations"] or rb["epoch"] != target.epoch \
            or target.learner_step >= start["step"]:
        raise AssertionError(f"(a) fsck {report['violations']}, rollback "
                             f"{rb}, target {target.epoch}")
    return {"launches": launches, "counters_at_restore": at_restore,
            "updates": summary["learner/updates"],
            "steps": summary["learner/steps"],
            "skipped_steps": summary["learner/skipped"],
            "rollback": {k: rb[k] for k in ("epoch", "step", "reason")},
            "streak_start_step": start["step"],
            "fsck_violations": report["violations"],
            "rolled_back_epochs": report["rolled_back"],
            "restored_rows_checked": rows,
            "first_update_after_restore": "graph == eager to the bit",
            # the rollback's record follows its restore
            "detect_s": rb["t"] - start["t"]
            - summary["health/rollback_seconds"],
            "restore_s": summary["health/rollback_seconds"],
            "first_update_s": seen["first_update_s"],
            "updates_per_sec": summary["learner/updates_per_sec"],
            "children_with_cuda": summary["runtime/children_with_cuda"]}


def _health_quarantine() -> dict:
    """(b) A poison of four flushes with the quarantine on, unpaced and
    early (QUARANTINE_POISON, during the warm-up; QUARANTINE_STEPS
    updates): files, no rollback, no NaN in the ring, no skipped step."""
    from pytorch_distributed_tpu_torch import main as port_main
    from pytorch_distributed_tpu_torch import runtime
    from pytorch_distributed_tpu_torch.utils import flight_recorder, health

    opt = port_main.options_from_args(port_main.parse_args(_e2e_argv(
        "process", "health_quarantine", "evaluator_nepisodes=0",
        steps=QUARANTINE_STEPS)))
    flight_recorder.reset()
    health.reset()
    topology = runtime.Topology(opt, backend="process")
    _poison_actor_0(topology, QUARANTINE_POISON)
    _zero_launches()
    summary = topology.run()
    launches = _launches_per_update(summary["learner/updates"])
    RESULTS["launches_health_quarantine"] = launches
    qdir = os.path.join(opt.log_dir, "quarantine")
    files = sorted(os.listdir(qdir)) if os.path.isdir(qdir) else []
    filed = 0
    for name in files:
        with np.load(os.path.join(qdir, name)) as z:
            filed += len(z["reason"])
    ring = topology.handles.learner_side.replay.state
    # four poisoned flushes of at most 16 rows (a flush on the actor's
    # stats cadence can be shorter)
    if (not 0 < summary["ingest/quarantined"] == filed <= 64
            or summary["health/rollbacks"] != 0
            or summary["learner/skipped"] != 0
            or not torch.isfinite(ring.reward).all()):
        raise AssertionError(f"(b) files {files} ({filed} rows): {summary}")
    return {"files": files, "quarantined": summary["ingest/quarantined"],
            "validated": summary["ingest/validated"],
            "rollbacks": summary["health/rollbacks"], "launches": launches}


def _validator_cost() -> dict:
    """(c) ``main`` under pipelined and batched actors with the quarantine
    on (the train_process and train_batched runs, or run here) and with
    ``TPU_APEX_QUARANTINE=0``: updates/s, frames/s and the drain's host
    seconds side by side, and the seconds the validator took."""
    out = {}
    for backend, key, sets in (
            ("pipelined", "e2e_process", ()),
            ("batched", "e2e_batched_unpaced", ("actor_backend=batched",))):
        row = {}
        for label in ("on", "off"):
            refs = f"health_{backend}_{label}"
            if label == "on" and key in RESULTS:
                summary = RESULTS[key]["summary"]
            else:
                if label == "off":
                    os.environ["TPU_APEX_QUARANTINE"] = "0"
                try:
                    _r, summary = _train_through_main("process", refs, *sets)
                finally:
                    os.environ.pop("TPU_APEX_QUARANTINE", None)
            validated = summary["ingest/validated"]
            if (label == "on") != (validated > 0):
                raise AssertionError(f"(c) {refs}: {validated} rows "
                                     f"validated")
            row[label] = {
                "updates_per_sec": summary["learner/updates_per_sec"],
                "actor_frames_per_sec": summary["actor/steps_per_sec"],
                "host_s_drain": summary["learner/host_s_drain"],
                "train_seconds": summary["learner/train_seconds"],
                "validated_rows": validated,
                "validate_s": summary["ingest/validate_seconds"],
                "validate_us_per_row": 1e6 * summary[
                    "ingest/validate_seconds"] / max(validated, 1)}
        out[backend] = row
    return out


def _xray_cost() -> dict:
    """(d) The X-ray of a full 50,000-row ring on the card, as the
    learner reads it once a stats window (``read_xray``: the histogram,
    ESS, rows and mass, then one copy to the host): host ms a window and
    device ms, against the host X-ray of the same leaves."""
    from pytorch_distributed_tpu_torch.memory.device_per import read_xray
    from pytorch_distributed_tpu_torch.memory.device_per import (
        DevicePerReplay, priority_xray_device,
    )
    from pytorch_distributed_tpu_torch.utils import health

    ring = DevicePerReplay(RING_ROWS, FRAME, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(5)
    p = ring.state.priority
    p.copy_(torch.rand(RING_ROWS, generator=gen, device=DEV) ** 4)
    p[:RING_ROWS // 10] = 0.0
    for _ in range(5):
        read_xray(ring.state)
    reps, t0 = 50, time.perf_counter()
    for _ in range(reps):
        xr = read_xray(ring.state)
    ms = 1e3 * (time.perf_counter() - t0) / reps
    host = health.priority_xray(p.cpu().numpy())
    if not (np.array_equal(xr["counts"], host["counts"])
            and xr["rows"] == host["rows"]
            and math.isclose(xr["ess"], host["ess"], rel_tol=1e-4)):
        raise AssertionError(f"(d) the device X-ray {xr} is not the host "
                             f"X-ray {host}")
    graph = _graph_of(lambda: priority_xray_device(ring.state))[0]
    return {"ms_per_window": ms, "device_ms": _replay_ms(graph, 200),
            "rows": xr["rows"], "ess_frac": xr["ess_frac"]}


def health_phase():
    """The health plane at config 12's full width on the process backend
    (the reference's defaults: detector, rollback ladder and quarantine
    on): (a) the rollback drill, (b) the quarantine drill, (c) the
    validator's cost, (d) the X-ray's."""
    return {"card": card_name_and_power_limit(),
            "rollback": _health_rollback(),
            "quarantine": _health_quarantine(),
            "validator": _validator_cost(),
            "xray": _xray_cost()}


health_phase.__name__ = "health"


# ---------------------------------------------------------------------------
# megabatch, the uniform device ring, the host rings and the small rows
# ---------------------------------------------------------------------------

MEGABATCHES = (1, 2, 4, 8)
MB_DISPATCH = 8        # updates a dispatch in the megabatch rates
MB_UPDATES = 400       # timed updates a rate
MB_GROUP = 4           # the group the kernels are held at
ANAKIN_MB_STEPS = 4000
HOST_STEPS = 500       # each host row, paced at replay ratio 8
NATIVE_STEPS = 500
POISON_AT = 250        # the learner dispatch row 6's poison_grad hits
ROW1_STEPS = 1500


def _b1_at_group_width(m: int) -> dict:
    """B1 drawing one megabatch group, M*B uniforms in one launch, over a
    50,000-row priority vector: indices and probabilities against
    ``sample_plain`` (identical), kernel, plain and library times."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    p = torch.rand(RING_ROWS, generator=gen, device=DEV)
    p = torch.where(torch.rand(RING_ROWS, generator=gen, device=DEV) < 0.1,
                    torch.zeros_like(p), p)
    n = m * BATCH
    mismatches, worst = 0, 0.0
    for _ in range(10):
        us = torch.rand(n, generator=gen, device=DEV)
        before = cuda_sampling.hierarchical_sample.launches
        idx_k, pr_k = cuda_sampling.hierarchical_sample(p, us)
        if cuda_sampling.hierarchical_sample.launches != before + 1:
            raise AssertionError("B1 took more than one launch a group")
        idx_p, pr_p = cuda_sampling.sample_plain(p, us)
        mismatches += int((idx_k != idx_p).sum())
        worst = max(worst, float((pr_k - pr_p).abs().max()))
    if mismatches or worst:
        raise AssertionError(f"B1 at {n} draws: {mismatches} index "
                             f"mismatches, probs err {worst}")
    u = torch.rand(n, generator=gen, device=DEV)

    def library():
        cdf = torch.cumsum(p, 0)
        idx = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp_(
            max=RING_ROWS - 1)
        return idx, p[idx] / cdf[-1]

    nblocks = -(-RING_ROWS // cuda_sampling.BLOCK)
    b, by = bound_ms(RING_ROWS * 4 + n * 4 + n * 12,
                     RING_ROWS + 2 * n * cuda_sampling.BLOCK + 2 * nblocks,
                     torch.float32)
    return dict(draws=n, index_mismatches=mismatches, max_abs_err=worst,
                ms=time_ms(lambda: cuda_sampling.hierarchical_sample(p, u),
                           200),
                plain_ms=time_ms(lambda: cuda_sampling.sample_plain(p, u),
                                 200),
                library_ms=time_ms(library, 200), bound_ms=b, bound_by=by,
                tolerance="identical indices and probs")


def _group_products(m: int) -> dict:
    """B2's products of one megabatch group of ``m`` at config 12's width
    (bf16), with the operands laid out as the group step hands them over:
    each layer's forward over the M*B rows (twice: the online and the
    target net), its ``dx = g w^T`` over the M*B rows (but Conv_0's) and
    its ``dw_m = x_m^T g_m`` on each minibatch's row slice, each against
    ``gemm_plain`` on the same operands; the group's kernel, plain and
    library times (``torch.matmul``, and one ``torch.bmm`` for a layer's
    M ``dw``) and bound, forward and backward apart."""
    gen = torch.Generator(device=DEV).manual_seed(12)
    calls = {"fwd": [], "bwd": []}   # (a, b, grad, times a group)
    library = {"fwd": [], "bwd": []}
    for i, (_name, rows, k, n) in enumerate(TORSO_GEMMS):
        x = torch.randn(m * rows, k, generator=gen, device=DEV).to(
            torch.bfloat16)
        w = (torch.randn(n, k, generator=gen, device=DEV)
             / math.sqrt(k)).to(torch.bfloat16).t()
        g = cuda_torso.tma_rows((torch.randn(m * rows, n, generator=gen,
                                             device=DEV) / rows).to(
            torch.bfloat16))
        calls["fwd"].append((x, w, False, 2))
        library["fwd"].append((lambda x=x, w=w: torch.matmul(x, w), 2))
        if i > 0:
            calls["bwd"].append((g, w.t(), True, 1))
            library["bwd"].append((lambda g=g, w=w: torch.matmul(g, w.t()),
                                   1))
        for j in range(m):
            sl = slice(j * rows, (j + 1) * rows)
            calls["bwd"].append((x[sl].t(), g[sl], True, 1))
        library["bwd"].append((lambda x=x, g=g, rows=rows: torch.bmm(
            x.view(m, rows, -1).transpose(1, 2), g.view(m, rows, -1)), 1))
    out = {}
    for part, cs in calls.items():
        worst_abs = worst_rel = 0.0
        t_bytes = t_ops = 0.0
        for a, b, grad, times in cs:
            err, rel = _rel_err(cuda_torso.gemm(a, b, grad=grad),
                                cuda_torso.gemm_plain(a, b))
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            (rows_a, kk), nn = a.shape, b.shape[1]
            bd, by = bound_ms((rows_a * kk + kk * nn) * 2 + rows_a * nn * 4,
                              2.0 * rows_a * nn * kk, torch.bfloat16)
            if by == "bytes":
                t_bytes += times * bd
            else:
                t_ops += times * bd
        # tolerance: the same bf16 products, exact in fp32, summed in
        # another order (as torso_gemm)
        if worst_rel > 1e-4:
            raise AssertionError(f"B2 group {part}: {worst_rel:.2e} of the "
                                 f"output scale")

        def run(fn, cs=cs):
            for a, b, grad, times in cs:
                for _ in range(times):
                    fn(a, b, grad)

        out[part] = dict(
            launches_per_group=sum(c[3] for c in cs),
            max_abs_err=worst_abs, max_rel_err=worst_rel,
            ms=time_ms(lambda: run(lambda a, b, grad: cuda_torso.gemm(
                a, b, grad=grad)), 50),
            plain_ms=time_ms(lambda: run(
                lambda a, b, grad: cuda_torso.gemm_plain(a, b)), 50),
            library_ms=time_ms(lambda lib=library[part]: [
                f() for f, times in lib for _ in range(times)], 50),
            bound_ms=t_bytes + t_ops,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            tolerance="max |kernel - plain| <= 1e-4 x max |plain|")
    return out


def _one_minibatch_group_is_sequential() -> dict:
    """On the card, bf16: the group step of one minibatch against the
    sequential step on the same batch, state and ring rows, over 3
    updates.  Through the kernel torso every tensor of the new state,
    |TD| and the metrics to the bit.  Through the module's forward, which
    the group step runs under ``vmap`` (a group of one never runs in
    training: ``megabatch=1`` takes the sequential step), the largest
    parameter difference is recorded, not held."""
    from pytorch_distributed_tpu_torch import bench_learner
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.factory import (
        EnvSpec, build_megabatch_train_step, build_model,
        build_train_state_and_step, init_params,
    )
    from pytorch_distributed_tpu_torch.memory.device_per import (
        DevicePerReplay, per_sample,
    )
    from pytorch_distributed_tpu_torch.memory.device_replay import (
        group_batches,
    )

    spec = EnvSpec(FRAME, ACTIONS, 255.0)
    ring = DevicePerReplay(4096, FRAME, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(7)
    bench_learner.fill_ring(ring, ACTIONS, gen)
    out = {}
    for torso in (True, False):
        opt = build_options(12, device="cuda", pallas_torso=torso)
        model = build_model(opt, spec)
        state, step = build_train_state_and_step(
            opt, model, init_params(opt, spec, seed=0, device=DEV))
        mega = build_megabatch_train_step(opt, model)
        diff = 0.0
        for _ in range(3):
            batch = per_sample(ring.state, torch.rand(BATCH, generator=gen,
                                                      device=DEV), 0.4)
            s_seq, m_seq, td_seq = step(state, batch)
            s_grp, m_grp, td_grp, ok = mega(state, group_batches(batch, 1))
            if not torso:
                diff = max(diff, max(
                    float((s_seq.params[k] - s_grp.params[k]).abs().max())
                    for k in s_seq.params))
            elif not (_tree_equal(s_seq, s_grp)
                    and torch.equal(td_seq, td_grp[0])
                    and all(torch.equal(m_seq[k], m_grp[k])
                            for k in m_seq) and bool(ok.all())):
                raise AssertionError("the group of one minibatch is not "
                                     "the sequential step (kernel torso)")
            state = s_seq
        out["kernel" if torso else "module_max_abs_param_diff"] = (
            "identical over 3 updates" if torso else diff)
    return out


def megabatch():
    """Megabatch on config 12's learner alone at full width (batch 128, a
    full 50,000-row ring, bf16, the kernel torso): a graphed dispatch in
    groups of 4 against its eager twin (identical); a group of one
    minibatch against the sequential step (identical, both torsos); B1
    drawing a group's 512 rows in one launch against ``sample_plain``;
    B2's group products against ``gemm_plain``; updates/s at M = 1, 2, 4
    and 8 (dispatches of 8 updates, replayed from a CUDA graph) with the
    launches per update by kernel counted in each timed window and, at
    M = 1 and 4, the profiler's device ms per update; the fp32 torso once
    at M = 4; the module's forward (vmap over the weight copies)
    captured into a CUDA graph at M = 4.  Then the split-process learner
    with ``megabatch=4`` through ``main`` (process backend, pipelined
    actors): its launches, counted over that run, held to
    ``expected_launches`` and printed in the kernels line."""
    from pytorch_distributed_tpu_torch import bench_learner
    from pytorch_distributed_tpu_torch.config import build_options

    out = {"card": card_name_and_power_limit()}
    for torso in (True, False):
        diff = _graph_matches_eager("bfloat16", MB_GROUP, torso)
        # tolerance: none, for either torso (the same kernels in the same
        # order; 0 in every run so far)
        if diff > 0.0:
            raise AssertionError(f"megabatch graph replay differs from "
                                 f"eager by {diff}")
        out[f"graph_vs_eager_{'kernel' if torso else 'module'}"] = diff
    out["one_minibatch"] = _one_minibatch_group_is_sequential()
    b1 = _b1_at_group_width(MB_GROUP)
    products = _group_products(MB_GROUP)
    RESULTS.setdefault("per_sample", {})["megabatch_group"] = b1
    RESULTS.setdefault("torso_gemm_fwd", {})["megabatch_group"] = \
        products["fwd"]
    RESULTS.setdefault("torso_gemm_bwd", {})["megabatch_group"] = \
        products["bwd"]
    out.update(b1_group=b1, b2_group=products)
    rates = {}
    for cd, m, torso in ([("bfloat16", m, "kernel") for m in MEGABATCHES]
                         + [("float32", MB_GROUP, "kernel"),
                            ("bfloat16", MB_GROUP, "module")]):
        r = bench_learner.run(
            build_options(12, device="cuda", pallas_torso=torso == "kernel",
                          compute_dtype=cd, megabatch=m,
                          steps_per_dispatch=MB_DISPATCH),
            updates=MB_UPDATES, profile=(torso == "kernel" and cd ==
                                         "bfloat16" and m in (1, MB_GROUP)))
        own = "gemm_bf16" if cd == "bfloat16" else "gemm_f32"
        other = "gemm_f32" if cd == "bfloat16" else "gemm_bf16"
        on = 1.0 if torso == "kernel" else 0.0
        want = {"hierarchical_sample": 1 / m, own: on * 10 / m,
                f"{own}_grad": on * (4 + 5 * m) / m, other: 0.0,
                f"{other}_grad": 0.0}
        got = r["launches_per_update"]
        if (r["megabatch"] != m or not r["cuda_graph"]
                or any(abs(got[k] - v) > 1e-9 for k, v in want.items())):
            raise AssertionError(f"M={m} {cd} {torso}: {r}")
        emit({"megabatch_learner": r})
        rates[f"{cd}_{torso}_M{m}"] = {k: r.get(k) for k in (
            "updates_per_sec", "wall_ms_per_update", "launches_per_update",
            "device_ms_per_update", "kernel_device_ms")}
    out["rates"] = rates
    r, _summary = _train_through_main(
        "process", "mb_learner", f"megabatch={MB_GROUP}",
        megabatch=MB_GROUP)
    RESULTS["launches_megabatch_learner"] = r["launches"]
    out["learner_through_main"] = {k: r[k] for k in (
        "launches", "updates_per_sec", "actor_frames_per_sec",
        "replay_ratio", "host_s", "train_seconds", "critic_loss")}
    return out


# the stats windows a run's rate is read over: past the captures and the
# warm-up's rollouts, which the whole run's rates include
STEADY_AFTER = 400


def _steady_windows(refs: str) -> dict:
    """The median of an Anakin run's stats windows (``learner_freq``
    updates each) past step STEADY_AFTER, from its ``scalars.jsonl``:
    updates/s, frames/s and the duty cycle."""
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.utils import metrics

    rows = metrics.read_scalars(build_options(12, root_dir=RUN_DIR,
                                              refs=refs).log_dir)
    out = {}
    for tag, key in (("anakin/updates_per_s", "updates_per_sec"),
                     ("anakin/rollout_frames_per_s", "frames_per_sec"),
                     ("anakin/duty_cycle", "duty_cycle")):
        vals = [r["value"] for r in rows
                if r["tag"] == tag and r["step"] > STEADY_AFTER]
        out[key] = float(np.median(vals)) if vals else None
    out["windows"] = len(vals)
    return out


def anakin_megabatch():
    """Anakin at full width through ``main`` (process backend) at
    ``rollout_ratio`` 16 with ``megabatch=4`` and ``double_buffer=true``
    (two 25,000-row halves), ANAKIN_MB_STEPS updates: one draw and 10 +
    24 bf16 GEMMs a group of 4, a finite loss, no actor child and no child
    with CUDA; updates/s, frames/s, the duty cycle and the device ms a
    learner update over the whole run (warm-up and captures included),
    and the median of its stats windows past step STEADY_AFTER, beside
    train_anakin's ratio-16 run (M = 1, one ring)."""
    r, summary = _train_through_main(
        "process", "anakin_mb", "actor_backend=anakin", "rollout_ratio=16",
        f"megabatch={MB_GROUP}", "double_buffer=true", phases=(),
        steps=ANAKIN_MB_STEPS, megabatch=MB_GROUP)
    RESULTS["launches_anakin_megabatch"] = r["launches"]
    if (summary["runtime/children_with_cuda"] != 0
            or summary["anakin/rollouts"] <= 0
            or summary["runtime/actor_steps"] != summary["anakin/frames"]):
        raise AssertionError(f"anakin megabatch: {summary}")
    steps = summary["learner/steps"]
    out = dict(updates_per_sec=r["updates_per_sec"],
               frames_per_sec=r["actor_frames_per_sec"],
               duty_cycle=summary["anakin/duty_cycle"],
               learn_device_ms_per_update=1e3 * summary["anakin/learn_s"]
               / steps,
               rollout_device_s=summary["anakin/rollout_s"],
               learn_device_s=summary["anakin/learn_s"],
               rollouts=summary["anakin/rollouts"],
               learns=summary["anakin/learns"], steps=steps,
               replay_fill=summary["anakin/replay_fill"],
               replay_ratio=r["replay_ratio"], launches=r["launches"],
               critic_loss=r["critic_loss"], train_seconds=r["train_seconds"],
               steady=_steady_windows("anakin_mb"))
    base = RESULTS.get("e2e_anakin_ratio16", {}).get("summary")
    if base:
        out["beside_M1_single_ring"] = dict(
            updates_per_sec=base["learner/updates_per_sec"],
            frames_per_sec=base["actor/steps_per_sec"],
            duty_cycle=base["anakin/duty_cycle"],
            learn_device_ms_per_update=1e3 * base["anakin/learn_s"]
            / base["learner/steps"],
            steady=_steady_windows("anakin_ratio16"))
    return dict(out, card=card_name_and_power_limit())


def train_uniform():
    """CONFIGS row 8 (dqn/pong-sim/device/dqn-cnn: the uniform device
    ring) at full width through ``main``: on the process backend with
    pipelined actors paced at replay ratio 8, and under Anakin at
    ``rollout_ratio`` 16 (the same ratio); no draw
    (the uniform draw is torch ops) and 10 + 9 bf16 GEMMs an update, a
    finite loss, no child with CUDA; updates/s and frames/s."""
    out = {}
    for name, sets, phases in (
            ("process", ("max_replay_ratio=8",), ("env", "advance", "tick")),
            ("anakin", ("actor_backend=anakin", "rollout_ratio=16"), ())):
        r, summary = _train_through_main("process", f"uniform_{name}",
                                         *sets, phases=phases, config=8,
                                         draws=False)
        RESULTS[f"launches_uniform_{name}"] = r["launches"]
        if summary["runtime/children_with_cuda"] != 0:
            raise AssertionError("a child made a CUDA context")
        out[name] = dict(updates_per_sec=r["updates_per_sec"],
                         frames_per_sec=r["actor_frames_per_sec"],
                         replay_ratio=r["replay_ratio"],
                         host_s=r["host_s"], launches=r["launches"],
                         train_seconds=r["train_seconds"],
                         critic_loss=r["critic_loss"])
        if name == "anakin":
            out[name]["duty_cycle"] = summary["anakin/duty_cycle"]
    return dict(out, card=card_name_and_power_limit())


def _poison_spy(seen: list):
    """Wrap the learner's train step so that every update records, on the
    device (no wait), its skip flag, whether its batch held a NaN reward
    and whether its params came out as they went in."""
    from pytorch_distributed_tpu_torch.agents import learner
    from pytorch_distributed_tpu_torch.ops.losses import SKIPPED_KEY

    real = learner.build_train_state_and_step

    def spy(opt, model, params):
        state, step = real(opt, model, params)

        def step_spy(st, batch):
            out = step(st, batch)
            same = torch.stack([(st.params[k] == out[0].params[k]).all()
                                for k in st.params]).all()
            seen.append(torch.stack([out[1][SKIPPED_KEY].float(),
                                     torch.isnan(batch.reward).any().float(),
                                     same.float()]))
            return out
        return state, step_spy

    return learner, real, spy


def train_host():
    """The host rings at full width through ``main`` on the process
    backend: row 4 (``shared``: the actors write process-shared pages)
    and row 6 (``prioritized``: the learner's sum tree behind the queues)
    paced at the reference's replay ratio (``max_replay_ratio`` 8,
    ``learn_start`` 5,000), HOST_STEPS updates each; row 6 with the
    ``poison_grad`` drill (``LEARNER_FAULTS=poison_grad@250``): exactly
    one skipped update, its batch the NaN one, its params unchanged, no
    rollback; then row 4 on ``memory_type=native`` (the C++ ring) once,
    unpaced.  Each update: no draw, 10 + 9 bf16 GEMMs (an eager step);
    updates/s, frames/s, the learner's host seconds."""
    out = {}
    for name, config, sets, steps in (
            ("shared", 4, ("max_replay_ratio=8", "learn_start=5000"),
             HOST_STEPS),
            ("prioritized", 6, ("max_replay_ratio=8", "learn_start=5000"),
             HOST_STEPS),
            ("native", 4, ("memory_type=native",), NATIVE_STEPS)):
        seen: list = []
        if name == "prioritized":
            module, real, spy = _poison_spy(seen)
            module.build_train_state_and_step = spy
            os.environ["LEARNER_FAULTS"] = f"poison_grad@{POISON_AT}"
        try:
            r, summary = _train_through_main("process", f"host_{name}",
                                             *sets, config=config,
                                             steps=steps, draws=False)
        finally:
            if name == "prioritized":
                module.build_train_state_and_step = real
                os.environ.pop("LEARNER_FAULTS", None)
        RESULTS[f"launches_host_{name}"] = r["launches"]
        if summary["runtime/children_with_cuda"] != 0:
            raise AssertionError("a child made a CUDA context")
        row = dict(updates_per_sec=r["updates_per_sec"],
                   frames_per_sec=r["actor_frames_per_sec"],
                   replay_ratio=r["replay_ratio"], host_s=r["host_s"],
                   launches=r["launches"], train_seconds=r["train_seconds"],
                   critic_loss=r["critic_loss"],
                   skipped=summary["learner/skipped"])
        if name == "prioritized":
            flags = torch.stack(seen).cpu().numpy()
            hit = np.nonzero(flags[:, 0] == 1.0)[0]
            if (summary["learner/skipped"] != 1.0
                    or summary["health/rollbacks"] != 0 or len(hit) != 1
                    or flags[hit[0], 1] != 1.0 or flags[hit[0], 2] != 1.0
                    or flags[:, 1].sum() != 1.0
                    or (flags[flags[:, 0] == 0.0, 2] != 0.0).any()):
                raise AssertionError(f"poison_grad drill: skipped at "
                                     f"{hit.tolist()}, {summary}")
            row["poison_grad"] = dict(skipped_update=int(hit[0]) + 1,
                                      params_unchanged=True, rollbacks=0)
        out[name] = row
    return dict(out, card=card_name_and_power_limit())


def small_rows():
    """Rows 1 and 3 (``dqn-mlp`` on the host ring, no kernel on their
    path) on the card through ``main`` on the process backend, 2 actors
    of one env, batch 32: row 1 learns the chain (the evaluator reaches
    ``avg_reward`` 1.0, and mode 2 on its best params solves every
    episode in 7 steps), row 3 runs; no kernel launch."""
    from pytorch_distributed_tpu_torch import main as port_main
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.utils import metrics

    out = {}
    for config, steps in ((1, ROW1_STEPS), (3, 500)):
        refs = f"row{config}"
        argv = ["--config", str(config), "--backend", "process",
                "--device", "cuda", "--num-actors", "2", "--steps",
                str(steps), "--memory-size", "4096", "--batch-size", "32",
                "--set", "learn_start=64", "--set", "evaluator_freq=1",
                "--set", "evaluator_nepisodes=2", "--set", "early_stop=50",
                "--set", "max_replay_ratio=4",
                "--set", f"root_dir={RUN_DIR}", "--set", f"refs={refs}"]
        _zero_launches()
        summary = port_main.main(argv)
        launches = sum(c.launches for c in (
            cuda_sampling.hierarchical_sample, *cuda_torso.COUNTERS))
        if (summary["learner/steps"] < steps or launches
                or not math.isfinite(summary["learner/critic_loss"])
                or summary["runtime/children_with_cuda"] != 0):
            raise AssertionError(f"row {config}: {launches} launches, "
                                 f"{summary}")
        log_dir = build_options(config, root_dir=RUN_DIR, refs=refs).log_dir
        rewards = [row["value"] for row in metrics.read_scalars(log_dir)
                   if row["tag"] == "evaluator/avg_reward"]
        row = dict(updates_per_sec=summary["learner/updates_per_sec"],
                   frames_per_sec=summary["actor/steps_per_sec"],
                   evals=len(rewards),
                   best_avg_reward=max(rewards) if rewards else None)
        if config == 1:
            stats = port_main.main([
                "--config", "1", "--mode", "2", "--device", "cuda",
                "--model-file", os.path.join(RUN_DIR, "models",
                                             f"{refs}_best"),
                "--set", "tester_nepisodes=3", "--set", "early_stop=50"])
            if not (rewards and max(rewards) == 1.0
                    and stats["avg_reward"] == 1.0
                    and stats["avg_steps"] == 7.0):
                raise AssertionError(f"row 1 did not learn the chain: "
                                     f"evals {rewards}, mode 2 {stats}")
            row["mode2"] = stats
        out[f"row{config}"] = row
    return dict(out, card=card_name_and_power_limit())


KERNELS = (
    ("per_sample", "pytorch_distributed_tpu_torch/csrc/per_sample.cu",
     "pytorch_distributed_tpu/ops/pallas_sampling.py:141"),
    ("torso_gemm_fwd", "pytorch_distributed_tpu_torch/csrc/torso_gemm_sm90.cu",
     "pytorch_distributed_tpu/ops/pallas_torso.py:104"),
    ("torso_gemm_bwd", "pytorch_distributed_tpu_torch/csrc/torso_gemm_sm90.cu",
     "pytorch_distributed_tpu/ops/pallas_torso.py:104"),
    ("torso_gemm_f32", "pytorch_distributed_tpu_torch/csrc/torso_gemm.cu",
     "pytorch_distributed_tpu/ops/pallas_torso.py:104"),
)


def main() -> int:
    global RUN_DIR
    t0 = time.monotonic()
    RUN_DIR = tempfile.mkdtemp(prefix="chip_smoke_")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    phases = (build, per_sample, torso_gemm, torso_apply, learner_alone,
              native_pong, device_env, fused_rollout, actor_tick, actor_gpu,
              staged_drain, train, train_process, test_mode, process_trace,
              train_paced, inference, train_batched, train_anakin,
              train_device, resume, health_phase, megabatch,
              anakin_megabatch, train_uniform, train_host, small_rows)
    only = set(sys.argv[1:])  # phase names to run after build; none: all
    unknown = only - {fn.__name__ for fn in phases}
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {sorted(unknown)}")
    for fn in phases:
        if fn is not build and "build" in FAILED:
            break
        if fn is build or not only or fn.__name__ in only:
            phase(fn)
    table = []
    # B1's and the bf16 GEMM's launches from the train_process phase, the
    # fp32 GEMM's from the fp32 learner run
    launches = dict(RESULTS.get("launches", {}), torso_gemm_f32=RESULTS.get(
        "f32_launches", {}).get("launches", 0))
    for name, source, replaces in KERNELS:
        r = RESULTS.get(name, {})
        by_path = {path: RESULTS.get(key, {}).get(name) for path, key in (
            ("train_process", "launches"),
            ("train_batched_unpaced", "launches_batched_unpaced"),
            ("train_batched_paced", "launches_batched_paced"),
            ("anakin", "launches_anakin_strict"),
            ("anakin_ratio16", "launches_anakin_ratio16"),
            ("train_device", "launches_device"),
            ("health_rollback", "launches_health_rollback"),
            ("health_quarantine", "launches_health_quarantine"),
            ("megabatch_learner_M4", "launches_megabatch_learner"),
            ("anakin_megabatch_M4", "launches_anakin_megabatch"),
            ("uniform_process", "launches_uniform_process"),
            ("uniform_anakin", "launches_uniform_anakin"),
            ("host_shared", "launches_host_shared"),
            ("host_prioritized", "launches_host_prioritized"),
            ("host_native", "launches_host_native"))}
        table.append(dict(name=name, route="cuda", source=source,
                          replaces=replaces, launches=launches.get(name, 0),
                          launches_by_path=by_path,
                          **{k: r.get(k) for k in (
                              "max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}))
        if "megabatch_group" in r:  # held at a group of MB_GROUP
            table[-1]["megabatch_group"] = r["megabatch_group"]
        if name == "torso_gemm_f32":
            table[-1].update(parts=r.get("parts"),
                             fp32_run=RESULTS.get("f32_launches"))
    emit({"kernels": table})
    print(card_name_and_power_limit(), flush=True)
    print(f"chip_smoke: {time.monotonic() - t0:.1f} s", file=sys.stderr)
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    if FAILED:
        print(f"chip_smoke: failed phases {FAILED}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
