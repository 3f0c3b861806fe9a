"""Kernel B1: the proportional PER draw, as one Hopper kernel.

Port of pytorch_distributed_tpu/ops/pallas_sampling.py
``hierarchical_sample`` (the ``pl.pallas_call`` at :141, body
``_draw_kernel`` :52-80, and the XLA block sums, cumsum and searchsorted
around it).  The kernel is ``csrc/per_sample.cu``, one launch per call
with no torch op around it, so it stays capturable in a CUDA graph; its
note says what bounds it on the card.  The reference draws its uniforms
from a JAX key inside the function; here the caller passes the uniforms
``u`` (B,) in [0, 1], so the tests can hand both implementations the same
numbers.

Semantics, kept from the reference: the (N,) priority vector (zeros are
empty rows) is cut into 1024-row superblocks; each draw's target
``u * total`` picks a superblock through the cumulative block sums
(``count(block_cdf <= target)``, clamped to the last superblock) and then
the in-block index ``count(prefix <= residual)``, clamped to 1023 and
then to N-1.  A draw that lands on a zero-priority row (fp-order
disagreement at a block's upper CDF edge, or ``u = 1``, which reaches
past the last nonzero row) is remapped to the ``argmax`` row, the first
of a tie, and ``probs = p[idx] / max(total, 1e-12)``.

Dispatch rule: a priority vector on the CPU takes ``sample_plain`` (the
same steps as torch ops, with the fp32 sums taken in the kernel's order,
so the two agree to the bit); one on a CUDA device launches the kernel,
or raises.  ``hierarchical_sample.launches`` counts the calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from pytorch_distributed_tpu_torch.ops import kernels

BLOCK = 1024  # priorities per superblock (the reference's DEFAULT_BLOCK)
# the kernel keeps the superblock CDF in 48 KB of shared memory
MAX_ROWS = 48 * 1024 // 4 * BLOCK

_VP = ctypes.c_void_p
_SIGNATURES = {"pdt_sample": (_VP, ctypes.c_longlong, _VP, ctypes.c_int, _VP,
                              _VP, _VP)}


def _check_args(priority: torch.Tensor, u: torch.Tensor) -> None:
    if priority.dim() != 1 or priority.dtype != torch.float32:
        raise ValueError(f"priority must be a 1-D float32 tensor, got "
                         f"{tuple(priority.shape)} {priority.dtype}")
    if u.dim() != 1 or u.dtype != torch.float32:
        raise ValueError(f"u must be a 1-D float32 tensor, got "
                         f"{tuple(u.shape)} {u.dtype}")
    if priority.device != u.device:
        raise ValueError(f"priority on {priority.device}, u on {u.device}")
    if not priority.is_contiguous() or not u.is_contiguous():
        raise ValueError("priority and u must be contiguous")
    if priority.numel() == 0 or u.numel() == 0:
        raise ValueError("empty priority vector or batch")


def _warp_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along the last dimension (32 lanes), in the kernel's
    order: five shifted adds, as its warp shuffles."""
    for o in (1, 2, 4, 8, 16):
        x = x + F.pad(x[..., :-o], (o, 0))
    return x


def sample_plain(priority: torch.Tensor, u: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: the reference's steps (:131-157) as torch ops, its
    fp32 sums taken in the kernel's order, so both give the same bits."""
    _check_args(priority, u)
    n, batch = priority.numel(), u.numel()
    nb = -(-n // BLOCK)
    blocks = F.pad(priority, (0, nb * BLOCK - n)).view(nb, BLOCK)
    # block sums: each lane adds its eight float4 in turn, then the warp's
    # butterfly over the 32 lanes
    v = blocks.view(nb, 8, 32, 4)
    lanes = torch.zeros(nb, 32, dtype=torch.float32, device=u.device)
    for j in range(8):
        lanes = lanes + ((v[:, j, :, 0] + v[:, j, :, 1])
                         + (v[:, j, :, 2] + v[:, j, :, 3]))
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32, device=u.device) ^ o]
    # the superblock CDF: 32 sums at a time, each chunk carried into the next
    chunks = _warp_scan(F.pad(lanes[:, 0], (0, -nb % 32)).view(-1, 32))
    carry, parts = torch.zeros((), device=u.device), []
    for row in chunks:
        parts.append(row + carry)
        carry = parts[-1][31]
    block_cdf = torch.cat(parts)[:nb]
    total = block_cdf[-1]
    target = u * total
    bid = (block_cdf <= target[:, None]).sum(1).clamp_(max=nb - 1)
    prev = torch.where(bid > 0, block_cdf[(bid - 1).clamp(min=0)],
                       torch.zeros_like(target))
    residual = (target - prev)[:, None, None]
    # the in-block search: four rows a lane, the lanes' scan, then the
    # warps' totals added in warp order
    v = blocks[bid].view(batch, 8, 32, 4)
    q = [v[..., 0]]
    for i in (1, 2, 3):
        q.append(q[-1] + v[..., i])
    q = torch.stack(q, 3)
    incl = _warp_scan(q[..., 3])
    warp_tot = incl[..., 31]
    off = [torch.zeros(batch, device=u.device)]
    for w in range(7):
        off.append(off[-1] + warp_tot[:, w])
    off = torch.stack(off, 1)[..., None] + F.pad(incl[..., :-1], (1, 0))
    local = ((off[..., None] + q) <= residual[..., None]).sum((1, 2, 3))
    idx = torch.clamp(bid * BLOCK + local.clamp(max=BLOCK - 1), max=n - 1)
    idx = torch.where(priority[idx] > 0, idx, torch.argmax(priority))
    return idx, priority[idx] / torch.clamp(total, min=1e-12)


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
    n, batch = priority.numel(), u.numel()
    if n > MAX_ROWS:
        raise ValueError(f"{n} priorities: the kernel's superblock CDF "
                         f"holds at most {MAX_ROWS} rows")
    idx = torch.empty(batch, dtype=torch.int64, device=priority.device)
    probs = torch.empty(batch, dtype=torch.float32, device=priority.device)
    lib = kernels.library("per_sample", _SIGNATURES)
    kernels.check(lib, lib.pdt_sample(
        priority.data_ptr(), n, u.data_ptr(), batch, idx.data_ptr(),
        probs.data_ptr(), kernels.stream_ptr(priority.device)), "pdt_sample")
    hierarchical_sample.launches += 1
    return idx, probs


hierarchical_sample.launches = 0
