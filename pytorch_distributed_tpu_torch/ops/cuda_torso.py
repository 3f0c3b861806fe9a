"""Kernel B2: the dqn-cnn torso GEMM, as two Hopper kernels.

Port of pytorch_distributed_tpu/ops/pallas_torso.py: ``_mm`` (the
``pl.pallas_call`` at :104, body ``_mm_kernel`` :64-74), ``make_mxu_matmul``
(:118-140, custom VJP) and ``build_pallas_torso_apply`` (:165-205).  Each
kernel's source note says what bounds it on the card.

- ``gemm(a, b)``: ``a (M, K) @ b (K, N) -> fp32 (M, N)`` with fp32
  accumulation, for bf16 or fp32 operands.  CPU tensors take
  ``gemm_plain``; CUDA tensors launch a kernel, or raise: bf16 operands
  ``gemm_bf16`` (``csrc/torso_gemm_sm90.cu``: TMA, an mbarrier ring and
  wgmma), fp32 operands ``gemm_f32`` (``csrc/torso_gemm.cu``: TMA, an
  mbarrier ring and FFMA on register tiles; the torso with
  ``compute_dtype`` float32).  Both kernels read each operand through a
  TMA descriptor, K-major or, for the backward's transposed operands, M-
  or N-major (``tma_major``), and raise, with the reason, for an operand
  that no descriptor can describe; ``plan_bf16`` and ``plan_f32`` pick
  their tiles and split K.  ``gemm_bf16.launches`` and
  ``gemm_f32.launches`` count the launches of forward products,
  ``gemm_bf16_grad.launches`` and ``gemm_f32_grad.launches`` those of
  gradients (``grad=True``).
- ``matmul(x, w, out_dtype)``: the differentiable product, returned in
  fp32 (the reference's ``mm``) or, with ``out_dtype=bf16``, already
  rounded to bf16, as the reference's torso rounds each ``mm``
  (:193-201).  Its backward computes ``dx = g w^T`` and ``dw = x^T g``
  (the reference's bwd, :132-137), skips ``dx`` when ``x`` needs no
  gradient, and casts ``dx``/``dw`` to ``x``'s/``w``'s dtype.  A bf16
  cotangent with bf16 ``x`` and ``w`` goes to the bf16 kernel as it lies:
  every operand is bf16-exact, so the same products summed in fp32 are
  the reference's fp32 backward.  Otherwise the operands are fp32, as in
  the reference, and go to the fp32 kernel as they lie.
- ``build_torso_apply``: the learner's ``(params, obs) -> q`` running the
  whole torso through ``matmul``, on the port's own ``state_dict``.
- ``group_matmul(x, w_stack, out_dtype)`` and ``build_torso_group_apply``:
  the megabatch group's products (ops/losses.build_dqn_megabatch_step;
  the reference vmaps its Pallas VJP, losses.py:315-318).  The weights
  are the same M copies at group entry, so the forward is one launch over
  the M*B rows and ``dx = g w^T`` one more; ``dw_m = x_m^T g_m`` is one
  launch per minibatch, on row slices of ``x`` and ``g`` (M launches of
  the same kernel; the slices start a multiple of 16 bytes apart since
  every K of the torso is).  No library GEMM stands in for any of them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.models.dqn_cnn import CONV_LAYERS
from pytorch_distributed_tpu_torch.ops import kernels

# each kernel's K tile, row tiles and tile widths (BK, BM, BN of
# csrc/torso_gemm_sm90.cu for bf16, of csrc/torso_gemm.cu for fp32): the
# bf16 kernel has 64 rows per consumer warpgroup, the fp32 kernel 16
# thread rows of 4 or 8 rows each
BF16_TILE_K = 64
BF16_TILE_M = (64, 128)
BF16_TILE_N = (8, 32, 64, 128)
F32_TILE_K = 32
F32_TILE_M = (64, 128)
F32_TILE_N = (32, 64, 128)
# the taller row tile only where it alone gives *_TALL_BLOCKS blocks a SM;
# split K only for a contraction of at least *_SPLIT_K_TILES K tiles over
# fewer output tiles than half the SMs, into about *_SPLIT_BLOCKS blocks a
# SM, in chunks of at least *_MIN_K_TILES.  A split costs a second launch
# and the fp32 slabs' traffic: the bf16 kernel, bytes-bound, ran config
# 12's Conv_2 (98 tiles of 9 K tiles) and the Q head in about half the
# time unsplit; the fp32 kernel, FFMA-bound, ran config 12's GEMMs fastest
# with 64-row tiles and two blocks a SM (chip_smoke.py and bench_gemm on
# an H100 SXM; see PERF.md)
BF16_TALL_BLOCKS, F32_TALL_BLOCKS = 1, 4
BF16_SPLIT_K_TILES, F32_SPLIT_K_TILES = 16, 8
BF16_SPLIT_BLOCKS, F32_SPLIT_BLOCKS = 1, 2
BF16_MIN_K_TILES = F32_MIN_K_TILES = 2
NUM_SMS = 132  # H100 SXM
# the operand types a TMA descriptor of the kernels reads
TMA_DTYPES = (torch.bfloat16, torch.float32)

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# pdt_gemm_bf16 and pdt_gemm_f32: (A, lda, a_mn, B, ldb, b_mn, C, ws, M, N,
# K, bm, bn, k_chunk, splits, stream)
_GEMM_ARGS = (_VP, _LL, _INT, _VP, _LL, _INT, _VP, _VP, _INT, _INT, _INT,
              _INT, _INT, _INT, _INT, _VP)


def _plan(m: int, n: int, k: int, tile_m: Sequence[int],
          tile_n: Sequence[int], tile_k: int, tall_blocks: int,
          split_tiles: int, split_blocks: int, min_tiles: int):
    """``(tile_m, tile_n, k_chunk, splits)``: the narrowest tile width that
    holds N (the widest past it); the taller row tile where it alone gives
    ``tall_blocks`` blocks a SM, else the shorter; and a contraction of at
    least ``split_tiles`` K tiles over fewer output tiles than half the
    SMs split into about ``split_blocks`` blocks a SM, each chunk at least
    ``min_tiles`` K tiles.  ``k_chunk`` is a multiple of the K tile."""
    tn = next((t for t in tile_n if t >= n), tile_n[-1])
    n_tiles = -(-n // tn)
    tm = (tile_m[1] if -(-m // tile_m[1]) * n_tiles >= tall_blocks * NUM_SMS
          else tile_m[0])
    tiles = -(-m // tm) * n_tiles
    k_tiles = -(-k // tile_k)
    want = 1
    if 2 * tiles <= NUM_SMS and k_tiles >= split_tiles:
        want = min(-(-split_blocks * NUM_SMS // tiles), k_tiles // min_tiles)
    chunk = -(-k_tiles // want) * tile_k
    return tm, tn, chunk, -(-k // chunk)


def plan_bf16(m: int, n: int, k: int):
    """The bf16 kernel's ``(tile_m, tile_n, k_chunk, splits)``."""
    return _plan(m, n, k, BF16_TILE_M, BF16_TILE_N, BF16_TILE_K,
                 BF16_TALL_BLOCKS, BF16_SPLIT_K_TILES, BF16_SPLIT_BLOCKS,
                 BF16_MIN_K_TILES)


def plan_f32(m: int, n: int, k: int):
    """The fp32 kernel's ``(tile_m, tile_n, k_chunk, splits)``."""
    return _plan(m, n, k, F32_TILE_M, F32_TILE_N, F32_TILE_K,
                 F32_TALL_BLOCKS, F32_SPLIT_K_TILES, F32_SPLIT_BLOCKS,
                 F32_MIN_K_TILES)


def tma_major(t: torch.Tensor, k_dim: int) -> Optional[str]:
    """Which way a TMA descriptor reads the 2-D bf16 or fp32 operand ``t``,
    where ``k_dim`` is its contraction dimension (1 for ``a``, 0 for
    ``b``): ``"k"`` (K-major: unit stride along K) or ``"mn"`` (M- or
    N-major: unit stride along the other dimension), or ``None`` when no
    descriptor can.  Either way the lines along the unit-stride dimension
    must not overlap and must start a multiple of 16 bytes apart, from a
    16-byte-aligned base."""
    if (t.dtype not in TMA_DTYPES or t.dim() != 2
            or t.data_ptr() % 16 != 0):
        return None
    for major, unit in (("k", k_dim), ("mn", 1 - k_dim)):
        line = t.stride(1 - unit)
        if (t.stride(unit) == 1 and line >= t.shape[unit]
                and line * t.element_size() % 16 == 0):
            return major
    return None


def check_tma_operands(a: torch.Tensor, b: torch.Tensor,
                       what: str = "gemm") -> None:
    """Raise, with the reason, unless ``tma_major`` takes both operands of
    ``a @ b``; ``what`` names the kernel in the message."""
    for name, t, k_dim in (("a", a, 1), ("b", b, 0)):
        if tma_major(t, k_dim) is None:
            raise ValueError(
                f"{what}: no TMA descriptor reads operand {name} "
                f"({t.dtype}, shape {tuple(t.shape)}, strides {t.stride()}, "
                f"base {t.data_ptr() % 16} bytes past 16-byte alignment); "
                f"it must be bf16 or fp32 with stride 1 along one "
                f"dimension, lines along it a multiple of 16 bytes apart "
                f"and a 16-byte-aligned base")


def tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (2-D, unit stride along its last dimension), or a copy of it
    whose rows start a multiple of 16 bytes apart when its own do not: the
    Q head's (B, 6) cotangent has 12-byte rows in bf16 and 24-byte rows in
    fp32, which no TMA descriptor reads."""
    rows, cols = t.shape
    if t.stride(1) == 1 and t.stride(0) * t.element_size() % 16 == 0:
        return t
    per = 16 // t.element_size()
    out = t.new_empty(rows, -(-cols // per) * per)[:, :cols]
    return out.copy_(t)


def _check_args(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gemm takes two bf16 or two fp32 operands, got "
                         f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    if 0 in a.shape or 0 in b.shape:
        raise ValueError("empty gemm operand")


def gemm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: the same products of the same operand values,
    summed in fp32."""
    _check_args(a, b)
    return torch.matmul(a.float(), b.float())


def gemm(a: torch.Tensor, b: torch.Tensor, grad: bool = False
         ) -> torch.Tensor:
    """``a @ b -> fp32`` through the kernel for the operands' device and
    type; ``grad`` marks a gradient's product, counted apart."""
    _check_args(a, b)
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if a.dtype == torch.bfloat16:
        return gemm_bf16_grad(a, b) if grad else gemm_bf16(a, b)
    return gemm_f32_grad(a, b) if grad else gemm_f32(a, b)


# operand type -> (source, C entry, tile plan)
_KERNELS = {torch.bfloat16: ("torso_gemm_sm90", "pdt_gemm_bf16", plan_bf16),
            torch.float32: ("torso_gemm", "pdt_gemm_f32", plan_f32)}


def launch(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype,
           plan: Optional[tuple] = None) -> torch.Tensor:
    """The kernel for ``dtype`` on CUDA operands that TMA can read, in the
    layout ``tma_major`` finds, tiled by its plan (or by ``plan``, a
    ``(tile_m, tile_n, k_chunk, splits)`` of the kernel's tiles with
    ``k_chunk`` a multiple of its K tile, which
    ``pytorch_distributed_tpu_torch.bench_gemm`` passes); counts nothing."""
    _check_args(a, b)
    source, entry, plan_fn = _KERNELS[dtype]
    if a.device.type != "cuda" or a.dtype != dtype:
        raise ValueError(f"{entry} takes {dtype} CUDA operands, got "
                         f"{a.dtype} on {a.device}")
    check_tma_operands(a, b, entry)
    (m, k), n = a.shape, b.shape[1]
    tm, tn, chunk, splits = plan or plan_fn(m, n, k)
    if -(-m // tm) > 65535:
        raise ValueError(f"{entry}: {m} rows exceed the grid's 65,535 row "
                         f"tiles of {tm}")
    a_mn, b_mn = tma_major(a, 1) == "mn", tma_major(b, 0) == "mn"
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    ws = (torch.empty(splits, m, n, dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    lib = kernels.library(source, {f"{entry}_init": (), entry: _GEMM_ARGS},
                          init=f"{entry}_init")
    err = getattr(lib, entry)(
        a.data_ptr(), a.stride(1 if a_mn else 0), int(a_mn),
        b.data_ptr(), b.stride(0 if b_mn else 1), int(b_mn), c.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, n, k, tm, tn, chunk,
        splits, kernels.stream_ptr(a.device))
    kernels.check(lib, err, entry)
    return c


def gemm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel for a forward product."""
    c = launch(a, b, torch.bfloat16)
    gemm_bf16.launches += 1
    return c


def gemm_bf16_grad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel for a gradient's product (transposed operands)."""
    c = launch(a, b, torch.bfloat16)
    gemm_bf16_grad.launches += 1
    return c


def gemm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fp32 kernel for a forward product."""
    c = launch(a, b, torch.float32)
    gemm_f32.launches += 1
    return c


def gemm_f32_grad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fp32 kernel for a gradient's product (transposed operands)."""
    c = launch(a, b, torch.float32)
    gemm_f32_grad.launches += 1
    return c


gemm_bf16.launches = 0
gemm_bf16_grad.launches = 0
gemm_f32.launches = 0
gemm_f32_grad.launches = 0
# every launch counter of the module
COUNTERS = (gemm_bf16, gemm_bf16_grad, gemm_f32, gemm_f32_grad)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return gemm(x, w).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x_dtype, w_dtype = x.dtype, w.dtype
        if not g.dtype == x_dtype == w_dtype == torch.bfloat16:
            g, x, w = g.float(), x.float(), w.float()
        # the operands as they lie (w^T and x^T are transposed views of the
        # stored w and x); only g's rows may need aligning
        g = tma_rows(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gemm(g, w.t(), grad=True).to(x_dtype)
        if ctx.needs_input_grad[1]:
            dw = gemm(x.t(), g, grad=True).to(w_dtype)
        return dx, dw, None


def matmul(x: torch.Tensor, w: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Differentiable ``x @ w``, summed in fp32 and returned as
    ``out_dtype``, whose forward and backward GEMMs all run through
    ``gemm``."""
    return _Matmul.apply(x, w, out_dtype)


class _GroupMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return gemm(x, w[0]).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x_dtype, w_dtype = x.dtype, w.dtype
        if not g.dtype == x_dtype == w_dtype == torch.bfloat16:
            g, x, w = g.float(), x.float(), w.float()
        g = tma_rows(g)
        m = w.shape[0]
        rows = x.shape[0] // m
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gemm(g, w[0].t(), grad=True).to(x_dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.stack([
                gemm(x[i * rows:(i + 1) * rows].t(),
                     g[i * rows:(i + 1) * rows], grad=True)
                for i in range(m)]).to(w_dtype)
        return dx, dw, None


def group_matmul(x: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Differentiable product of a megabatch group: ``x`` (M*R, K), ``w``
    (M, K, N) whose M copies are equal (the group-entry weights, stacked);
    row group m of ``x`` multiplies copy m.  The forward is ``x @ w[0]``,
    one launch; the backward gives ``dx = g w[0]^T`` in one launch and
    ``dw[m] = x_m^T g_m`` in one launch per copy, so each copy's gradient
    is its minibatch's alone."""
    if x.shape[0] % w.shape[0]:
        raise ValueError(f"{x.shape[0]} rows do not split into "
                         f"{w.shape[0]} groups")
    return _GroupMatmul.apply(x, w, out_dtype)


def _patches(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """im2col of NHWC ``x`` -> (B, OH, OW, k*k*C), features in (kh, kw, c)
    order (reference ``_patches``, :143-155)."""
    p = x.unfold(1, k, stride).unfold(2, k, stride)  # (B, OH, OW, C, kh, kw)
    b, oh, ow, c = p.shape[:4]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(b, oh, ow, k * k * c)


def build_torso_apply(norm_val: float = 255.0,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> Callable[[Dict[str, torch.Tensor], torch.Tensor],
                                    torch.Tensor]:
    """``apply(params, obs) -> q`` through the GEMM kernels, on the port's
    ``DqnCnnModel`` state_dict and NCHW uint8 ``obs``.  Rounds to
    ``compute_dtype`` where the reference does (:193-203): inputs and
    weights before each GEMM, the GEMM output (``out_dtype``) before the
    bias add, so a bf16 torso's backward gets bf16 cotangents.  The
    im2col runs NHWC with (kh, kw, c) features, so each OIHW conv weight
    is permuted to (kh, kw, c) columns, and ``fc``'s (c, h, w) columns to
    the (h, w, c) order of the NHWC flatten — the same function as the
    module's NCHW forward.  Every weight is laid out (N, K), row-major, and
    handed over as its transpose: each forward GEMM reads both operands
    K-major, and the backward reads the same tensors M- or N-major."""
    cd = compute_dtype

    def apply_fn(params: Dict[str, torch.Tensor],
                 obs: torch.Tensor) -> torch.Tensor:
        x = (obs.to(cd) / norm_val).permute(0, 2, 3, 1)
        for name, cout, k, stride in CONV_LAYERS:
            pat = _patches(x, k, stride)
            b, oh, ow, feat = pat.shape
            w = params[f"{name}.weight"].permute(0, 2, 3, 1).reshape(
                cout, feat)
            y = matmul(pat.reshape(-1, feat), w.to(cd).t(), out_dtype=cd)
            y = y + params[f"{name}.bias"].to(cd)
            x = F.relu(y).reshape(b, oh, ow, cout)
        b, oh, ow, c = x.shape
        w0 = params["fc.weight"]
        w0 = w0.reshape(w0.shape[0], c, oh, ow).permute(0, 2, 3, 1).reshape(
            w0.shape[0], oh * ow * c)
        y = matmul(x.reshape(b, -1), w0.to(cd).t(), out_dtype=cd)
        x = F.relu(y + params["fc.bias"].to(cd))
        q = matmul(x, params["head.weight"].to(cd).t(), out_dtype=cd)
        return (q + params["head.bias"].to(cd)).float()

    return apply_fn


def build_torso_group_apply(norm_val: float = 255.0,
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> Callable[[Dict[str, torch.Tensor],
                                           torch.Tensor], torch.Tensor]:
    """The megabatch twin of ``build_torso_apply``: ``apply(stacked, obs
    (M, B, C, H, W)) -> q (M, B, A)``, where every tensor of ``stacked``
    holds the M copies of a parameter (M leading) and row group m runs on
    copy m.  Each layer's product is one ``group_matmul`` over the M*B
    rows (M*B*OH*OW patch rows for a convolution); each bias is added per
    group; every rounding is ``build_torso_apply``'s."""
    cd = compute_dtype

    def group_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        m, n = b.shape
        return (y.view(m, -1, n) + b.to(cd)[:, None, :]).view(-1, n)

    def apply_fn(stacked: Dict[str, torch.Tensor],
                 obs: torch.Tensor) -> torch.Tensor:
        m, b0 = obs.shape[:2]
        x = (obs.reshape(m * b0, *obs.shape[2:]).to(cd) / norm_val
             ).permute(0, 2, 3, 1)
        for name, cout, k, stride in CONV_LAYERS:
            pat = _patches(x, k, stride)
            b, oh, ow, feat = pat.shape
            w = stacked[f"{name}.weight"].permute(0, 1, 3, 4, 2).reshape(
                m, cout, feat)
            y = group_matmul(pat.reshape(-1, feat), w.to(cd).transpose(1, 2),
                             out_dtype=cd)
            y = group_bias(y, stacked[f"{name}.bias"])
            x = F.relu(y).reshape(b, oh, ow, cout)
        b, oh, ow, c = x.shape
        w0 = stacked["fc.weight"]
        w0 = w0.reshape(m, w0.shape[1], c, oh, ow).permute(
            0, 1, 3, 4, 2).reshape(m, w0.shape[1], oh * ow * c)
        y = group_matmul(x.reshape(b, -1), w0.to(cd).transpose(1, 2),
                         out_dtype=cd)
        x = F.relu(group_bias(y, stacked["fc.bias"]))
        q = group_matmul(x, stacked["head.weight"].to(cd).transpose(1, 2),
                         out_dtype=cd)
        q = group_bias(q, stacked["head.bias"])
        return q.float().view(m, b0, -1)

    return apply_fn
