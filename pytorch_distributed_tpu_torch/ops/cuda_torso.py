"""Kernel B2: the dqn-cnn torso GEMM, as a Hopper kernel.

Port of pytorch_distributed_tpu/ops/pallas_torso.py: ``_mm`` (the
``pl.pallas_call`` at :104, body ``_mm_kernel`` :64-74), ``make_mxu_matmul``
(:118-140, custom VJP) and ``build_pallas_torso_apply`` (:165-205).  The
kernel is ``csrc/torso_gemm.cu``; its note says what bounds it on the card.

- ``gemm(a, b)``: ``a (M, K) @ b (K, N) -> fp32 (M, N)`` with fp32
  accumulation, for bf16 or fp32 operands of any strides.  CPU tensors take
  ``gemm_plain``; CUDA tensors launch the kernel, or raise.
  ``gemm.launches`` counts kernel launches.
- ``matmul(x, w)``: the differentiable product.  Its backward calls the
  same kernel for ``dx = g w^T`` and ``dw = x^T g`` with fp32 operands (the
  reference's bwd, :132-137), skips ``dx`` when ``x`` needs no gradient,
  and casts ``dx``/``dw`` to ``x``'s/``w``'s dtype.
- ``build_torso_apply``: the learner's ``(params, obs) -> q`` running the
  whole torso through ``matmul``, on the port's own ``state_dict``.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.models.dqn_cnn import CONV_LAYERS
from pytorch_distributed_tpu_torch.ops import kernels

# the kernel's output tile and K tile (csrc/torso_gemm.cu BM/BN/BK)
TILE_M, TILE_N, TILE_K = 64, 64, 32
NUM_SMS = 132  # H100 SXM

_ENTRY = {torch.bfloat16: "pdt_gemm_bf16", torch.float32: "pdt_gemm_f32"}
_GEMM_ARGS = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_SIGNATURES = {name: _GEMM_ARGS for name in _ENTRY.values()}


def split_k(m: int, n: int, k: int):
    """``(k_chunk, splits)``: enough blocks for about two waves over the
    SMs when the output has few tiles, each chunk at least four K tiles
    deep; ``k_chunk`` is a multiple of the K tile."""
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    want = 1
    if tiles < NUM_SMS:
        want = max(1, min(-(-2 * NUM_SMS // tiles), k // (4 * TILE_K)))
    chunk = -(-k // want)
    chunk = -(-chunk // TILE_K) * TILE_K
    return chunk, -(-k // chunk)


def _check_args(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _ENTRY:
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


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_args(a, b)
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    chunk, splits = split_k(m, n, k)
    ws = (torch.empty(splits, m, n, dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    lib = kernels.library("torso_gemm", _SIGNATURES)
    entry = _ENTRY[a.dtype]
    err = getattr(lib, entry)(
        a.data_ptr(), a.stride(0), a.stride(1),
        b.data_ptr(), b.stride(0), b.stride(1),
        c.data_ptr(), ws.data_ptr() if ws is not None else None,
        m, n, k, chunk, splits, kernels.stream_ptr(a.device))
    kernels.check(lib, err, entry)
    gemm.launches += 1
    return c


gemm.launches = 0


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return gemm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gemm(g, w.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = gemm(x.float().t(), g).to(w.dtype)
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable ``x @ w -> fp32`` whose forward and backward GEMMs
    all run through ``gemm``."""
    return _Matmul.apply(x, w)


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
    """``apply(params, obs) -> q`` through the GEMM kernel, on the port's
    ``DqnCnnModel`` state_dict and NCHW uint8 ``obs``.  Rounds to
    ``compute_dtype`` where the reference does (:193-203): inputs and
    weights before each GEMM, the GEMM output before the bias add.  The
    im2col runs NHWC with (kh, kw, c) features, so each OIHW conv weight
    is permuted to (kh, kw, c) rows, and ``fc``'s (c, h, w) columns to the
    (h, w, c) order of the NHWC flatten — the same function as the
    module's NCHW forward."""
    cd = compute_dtype

    def apply_fn(params: Dict[str, torch.Tensor],
                 obs: torch.Tensor) -> torch.Tensor:
        x = (obs.to(cd) / norm_val).permute(0, 2, 3, 1)
        for name, cout, k, stride in CONV_LAYERS:
            pat = _patches(x, k, stride)
            b, oh, ow, feat = pat.shape
            w = params[f"{name}.weight"].permute(2, 3, 1, 0).reshape(
                feat, cout)
            y = matmul(pat.reshape(-1, feat), w.to(cd))
            y = y.to(cd) + params[f"{name}.bias"].to(cd)
            x = F.relu(y).reshape(b, oh, ow, cout)
        b, oh, ow, c = x.shape
        w0 = params["fc.weight"]
        w0 = w0.reshape(-1, c, oh, ow).permute(2, 3, 1, 0).reshape(
            oh * ow * c, -1)
        y = matmul(x.reshape(b, -1), w0.to(cd))
        x = F.relu(y.to(cd) + params["fc.bias"].to(cd))
        q = matmul(x, params["head.weight"].t().to(cd))
        return (q.to(cd) + params["head.bias"].to(cd)).float()

    return apply_fn
