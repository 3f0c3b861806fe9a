"""The torso GEMM kernels at the GEMM shapes of one config-12 update, each
timed under the kernel's own plan and, with ``--plans``, under every other
plan of its tiles, beside ``torch.matmul`` on the same operands.

    python -m pytorch_distributed_tpu_torch.bench_gemm \\
        [--part f32_fwd f32_bwd fwd bwd] [--plans] [--iters 200] \\
        [--square 2048 4096]

Needs a CUDA device.  Parts: ``fwd``/``bwd`` are the bf16 torso's 10
forward and 9 backward GEMMs, ``f32_fwd``/``f32_bwd`` the same of the torso
with ``compute_dtype`` float32; each operand is laid out (and strided) as
the main path hands it over.  Prints one JSON line per GEMM: its shape,
layout, plan, the kernel's and ``torch.matmul``'s milliseconds per call
replayed from a CUDA graph, its largest error against ``gemm_plain``
relative to the output scale, and with ``--plans`` every plan's time,
fastest first.  ``--square`` times instead the fp32 kernel on S x S x S
products in each operand layout under each of its unsplit tiles, beside
``torch.matmul``, with the rate in TFLOP/s: the kernel's ceiling, away
from the update's small shapes.  TF32 is off, so fp32 ``torch.matmul`` is
full fp32.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from pytorch_distributed_tpu_torch.ops import cuda_torso

# config 12 (dqn/pong-sim/device-per/dqn-cnn) at batch 128: (layer, M, K,
# N) of each forward GEMM (im2col'd convs, Dense_0, the Q head)
BATCH, ACTIONS = 128, 6
TORSO_GEMMS = (("Conv_0", BATCH * 20 * 20, 8 * 8 * 4, 32),
               ("Conv_1", BATCH * 9 * 9, 4 * 4 * 32, 64),
               ("Conv_2", BATCH * 7 * 7, 3 * 3 * 64, 64),
               ("Dense_0", BATCH, 7 * 7 * 64, 512),
               ("Dense_1", BATCH, 512, ACTIONS))
PARTS = ("fwd", "bwd", "f32_fwd", "f32_bwd")


def update_gemms(device, seed: int = 1):
    """The GEMMs of one update: ``(part, label, a, b, calls per update)``
    for each part of ``PARTS``, with operands laid out (and strided) as the
    main path hands them over: weights stored (N, K) and read K-major by
    the forward; the backward's ``dw = x^T g`` and ``dx = g w^T`` reading
    x, g and w as they lie, the cotangent's rows aligned as ``backward``
    aligns them.  The fp32 operands are fp32 copies of the bf16 ones."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for i, (name, m, k, n) in enumerate(TORSO_GEMMS):
        x = torch.randn(m, k, generator=gen, device=device).to(
            torch.bfloat16)
        w = (torch.randn(n, k, generator=gen, device=device)
             / math.sqrt(k)).to(torch.bfloat16).t()
        g = (torch.randn(m, n, generator=gen, device=device) / m).to(
            torch.bfloat16)
        for pre, xs, ws, gs in (
                ("", x, w, cuda_torso.tma_rows(g)),
                ("f32_", x.float(), w.float(),
                 cuda_torso.tma_rows(g.float()))):
            # forward: online and target nets; then dw and (but for
            # Conv_0, whose input is the observation) dx
            out.append((f"{pre}fwd", f"{name}.fwd", xs, ws, 2))
            out.append((f"{pre}bwd", f"{name}.dw", xs.t(), gs, 1))
            if i > 0:
                out.append((f"{pre}bwd", f"{name}.dx", gs, ws.t(), 1))
    return out


def time_ms(fn, iters: int = 50, graph: bool = True) -> float:
    """Mean device time of one call of ``fn`` over ``iters`` back-to-back
    calls, replayed from a CUDA graph (as the learner's main path runs
    it), or with ``graph=False`` called eagerly, which adds the host's
    launch overhead wherever it exceeds the device time.  Twenty
    untimed calls first bring the clocks up."""
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    cur.wait_stream(side)
    torch.cuda.synchronize()
    run = fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        run = g.replay
    for _ in range(20):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def candidate_plans(m: int, n: int, k: int, dtype: torch.dtype):
    """Every ``(tile_m, tile_n, k_chunk, splits)`` of the kernel's tiles,
    unsplit or split into 2 to about 2 blocks per SM, each chunk at least
    its minimum of K tiles."""
    if dtype == torch.float32:
        tms, tns, tk, least = (cuda_torso.F32_TILE_M, cuda_torso.F32_TILE_N,
                               cuda_torso.F32_TILE_K,
                               cuda_torso.F32_MIN_K_TILES)
    else:
        tms, tns, tk, least = (cuda_torso.BF16_TILE_M,
                               cuda_torso.BF16_TILE_N,
                               cuda_torso.BF16_TILE_K,
                               cuda_torso.BF16_MIN_K_TILES)
    k_tiles = -(-k // tk)
    plans = set()
    for tm in tms:
        for tn in tns:
            tiles = -(-m // tm) * -(-n // tn)
            if -(-m // tm) > 65535:
                continue
            for want in {1, 2, 4, 8, 16, 32, 64, 128,
                         -(-cuda_torso.NUM_SMS // tiles),
                         -(-2 * cuda_torso.NUM_SMS // tiles)}:
                want = min(want, max(1, k_tiles // least))
                chunk = -(-k_tiles // want) * tk
                plans.add((tm, tn, chunk, -(-k // chunk)))
    return sorted(plans)


def square(sizes, iters: int, device) -> list:
    """The fp32 kernel on S x S x S products, each layout, each tile."""
    rows = []
    for s in sizes:
        gen = torch.Generator(device=device).manual_seed(s)
        x = torch.randn(s, s, generator=gen, device=device)
        y = torch.randn(s, s, generator=gen, device=device)
        for a, b in ((x, y.t()), (x, y), (x.t(), y), (x.t(), y.t())):
            row = dict(size=s, layout=(cuda_torso.tma_major(a, 1),
                                       cuda_torso.tma_major(b, 0)),
                       library_ms=time_ms(lambda: torch.matmul(a, b), iters))
            for tm in cuda_torso.F32_TILE_M:
                for tn in cuda_torso.F32_TILE_N:
                    row[f"{tm}x{tn}_ms"] = time_ms(
                        lambda: cuda_torso.launch(a, b, torch.float32,
                                                  (tm, tn, s, 1)), iters)
            row["tflops"] = {k[:-3]: 2 * s ** 3 / v / 1e9
                             for k, v in row.items() if k.endswith("_ms")}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--part", nargs="+", choices=PARTS, default=PARTS)
    p.add_argument("--plans", action="store_true")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--square", type=int, nargs="+", metavar="S")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_gemm: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    if args.square:
        return square(args.square, args.iters, device)
    rows = []
    for part, label, a, b, calls in update_gemms(device):
        if part not in args.part:
            continue
        (m, k), n = a.shape, b.shape[1]
        plan = (cuda_torso.plan_f32 if a.dtype == torch.float32
                else cuda_torso.plan_bf16)(m, n, k)
        c = cuda_torso.launch(a, b, a.dtype)
        ref = cuda_torso.gemm_plain(a, b)
        rel = float((c - ref).abs().max()) / max(float(ref.abs().max()),
                                                 1e-30)
        row = dict(part=part, gemm=label, m=m, k=k, n=n,
                   calls_per_update=calls,
                   layout=(cuda_torso.tma_major(a, 1),
                           cuda_torso.tma_major(b, 0)),
                   plan=plan, max_rel_err=rel,
                   ms=time_ms(lambda: cuda_torso.launch(a, b, a.dtype),
                              args.iters),
                   library_ms=time_ms(lambda: torch.matmul(a, b),
                                      args.iters))
        if args.plans:
            row["plans"] = sorted(
                ((time_ms(lambda: cuda_torso.launch(a, b, a.dtype, q),
                          args.iters), q)
                 for q in candidate_plans(m, n, k, a.dtype)),
                key=lambda r: r[0])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
