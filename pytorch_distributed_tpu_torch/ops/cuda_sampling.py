"""Kernel B1: the proportional PER draw, as a Hopper kernel.

Port of pytorch_distributed_tpu/ops/pallas_sampling.py
``hierarchical_sample`` (the ``pl.pallas_call`` at :141, body
``_draw_kernel`` :52-80).  The kernel is ``csrc/per_sample.cu``; its note
says what bounds it on the card.  The reference draws its uniforms from a
JAX key inside the function; here the caller passes the uniforms ``u``
(B,) in [0, 1), so the tests can hand both implementations the same
numbers.

Semantics, kept from the reference: the (N,) priority vector (zeros are
empty rows) is cut into 1024-row superblocks; each draw's target
``u * total`` picks a superblock through the cumulative block sums and
then the in-block index ``count(prefix <= residual)``, clamped to 1023 and
then to N-1.  A draw that lands on a zero-priority row (fp-order
disagreement at a block's upper CDF edge) is remapped to the ``argmax``
row, and ``probs = p[idx] / max(total, 1e-12)``.

Dispatch rule: a priority vector on the CPU takes ``sample_plain`` (a
blocked torch version of the same phases); one on a CUDA device launches
the kernel, or raises.  ``hierarchical_sample.launches`` counts the calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.ops import kernels

BLOCK = 1024  # priorities per superblock (the reference's DEFAULT_BLOCK)

_SIGNATURES = {
    "pdt_block_sums": (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p),
    "pdt_draw": (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_void_p),
}


def _check_args(priority: torch.Tensor, u: torch.Tensor) -> None:
    if priority.dim() != 1 or priority.dtype != torch.float32:
        raise ValueError(f"priority must be a 1-D float32 tensor, got "
                         f"{tuple(priority.shape)} {priority.dtype}")
    if u.dim() != 1 or u.dtype != torch.float32:
        raise ValueError(f"u must be a 1-D float32 tensor, got "
                         f"{tuple(u.shape)} {u.dtype}")
    if priority.device != u.device:
        raise ValueError(f"priority on {priority.device}, u on {u.device}")
    if not priority.is_contiguous():
        raise ValueError("priority must be contiguous")
    if priority.numel() == 0 or u.numel() == 0:
        raise ValueError("empty priority vector or batch")


def _targets(block_sums: torch.Tensor, u: torch.Tensor):
    """Phase 2 (torch in both versions): the superblock and residual target
    of each draw, and the total mass."""
    block_cdf = torch.cumsum(block_sums, 0)
    total = block_cdf[-1]
    target = u * total
    bid = torch.searchsorted(block_cdf, target, right=True).clamp_(
        0, block_sums.numel() - 1)
    prev = torch.where(bid > 0, block_cdf[(bid - 1).clamp_(min=0)],
                       torch.zeros_like(target))
    return bid, (target - prev).contiguous(), total


def _finish(priority: torch.Tensor, bid: torch.Tensor, local: torch.Tensor,
            total: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clamp, zero-row remap and probabilities (reference :148-157)."""
    idx = torch.clamp(bid.long() * BLOCK + local.long(),
                      max=priority.numel() - 1)
    idx = torch.where(priority[idx] > 0, idx, torch.argmax(priority))
    probs = priority[idx] / torch.clamp(total, min=1e-12)
    return idx, probs


def sample_plain(priority: torch.Tensor, u: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the same three phases as blocked torch ops."""
    _check_args(priority, u)
    n = priority.numel()
    nb = -(-n // BLOCK)
    blocks = F.pad(priority, (0, nb * BLOCK - n)).view(nb, BLOCK)
    bid, targets, total = _targets(blocks.sum(1), u)
    prefix = torch.cumsum(blocks[bid], 1)
    local = (prefix <= targets[:, None]).sum(1).clamp_(max=BLOCK - 1)
    return _finish(priority, bid, local, total)


def hierarchical_sample(priority: torch.Tensor, u: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Proportional draw of ``len(u)`` indices from ``priority``.
    Returns ``(idx int64 (B,), probs float32 (B,))``."""
    _check_args(priority, u)
    if priority.device.type == "cpu":
        return sample_plain(priority, u)
    if priority.device.type != "cuda":
        raise ValueError(f"no kernel for device {priority.device}")
    if priority.data_ptr() % 16:
        raise ValueError("priority must be 16-byte aligned (float4 loads)")
    lib = kernels.library("per_sample", _SIGNATURES)
    stream = kernels.stream_ptr(priority.device)
    n = priority.numel()
    nb = -(-n // BLOCK)
    sums = torch.empty(nb, dtype=torch.float32, device=priority.device)
    kernels.check(lib, lib.pdt_block_sums(priority.data_ptr(), n,
                                          sums.data_ptr(), nb, stream),
                  "pdt_block_sums")
    bid, targets, total = _targets(sums, u)
    bid32 = bid.to(torch.int32)
    local = torch.empty(u.numel(), dtype=torch.int32, device=u.device)
    kernels.check(lib, lib.pdt_draw(priority.data_ptr(), n, bid32.data_ptr(),
                                    targets.data_ptr(), local.data_ptr(),
                                    u.numel(), stream), "pdt_draw")
    hierarchical_sample.launches += 1
    return _finish(priority, bid, local, total)


hierarchical_sample.launches = 0
