"""Kernel B2 (the torso GEMM) and the port's dqn-cnn: CPU tensors take the
kernel's plain version, held here against the JAX package's Pallas
``make_mxu_matmul`` / ``build_pallas_torso_apply`` run in interpret mode
and against the flax ``DqnCnnModel``, on converted weights
(``convert.convert_dqn_cnn``) and the same numpy inputs.

Tolerances: fp32 rtol/atol 1e-4 on values and 1e-3 on gradients, as
tests/test_pallas_torso.py; bf16 2e-2 relative to the output scale (the
two frameworks round to bf16 at other points), for bf16 gradients their
direction (cosine > 0.999) and each element within 2e-2 of its tensor's
largest, and bitwise equality between the bf16 backward and fp32 copies
of its operands.  Frames are 84x84 and one smaller
non-square frame, batch 2.  Compiling the interpret-mode JAX torso and
the flax init is what costs time here, so the weights are drawn with
numpy in flax's layout and the interpret-mode torso runs at the small
frame only; torch runs one intra-op thread, since the tier-1 run shares
the cores among its workers."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pytorch_distributed_tpu.models import DqnCnnModel as JaxDqnCnn
from pytorch_distributed_tpu.ops.pallas_torso import (
    build_pallas_torso_apply, make_mxu_matmul,
)
from pytorch_distributed_tpu_torch import bench_gemm
from pytorch_distributed_tpu_torch.convert import convert_dqn_cnn
from pytorch_distributed_tpu_torch.models.dqn_cnn import (
    DqnCnnModel, torso_out_hw,
)
from pytorch_distributed_tpu_torch.ops import cuda_torso
from pytorch_distributed_tpu_torch.ops.cuda_torso import (
    build_torso_apply, gemm, gemm_bf16, gemm_bf16_grad, gemm_f32,
    gemm_f32_grad, gemm_plain, matmul,
)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
SMALL = (44, 52)  # conv stack 10x12 -> 4x5 -> 2x3
# (M, N, K) of the plans' split tests, and of config 12's five forward
# GEMMs at batch 128 (im2col'd convs, Dense_0, the Q head)
SPLIT_K_SHAPES = [(256, 32, 51200), (128, 512, 3136), (51200, 32, 256),
                  (512, 6, 128)]
FORWARD_SHAPES = [(128 * 20 * 20, 32, 256), (128 * 9 * 9, 64, 512),
                  (128 * 7 * 7, 64, 576), (128, 512, 3136), (128, 6, 512)]
# (M, N, K) of config 12's nine backward GEMMs: dw = x^T g of each layer,
# dx = g w^T of all but Conv_0
BACKWARD_SHAPES = [(k, n, m) for m, n, k in FORWARD_SHAPES] + [
    (m, k, n) for m, n, k in FORWARD_SHAPES[1:]]
torch.set_num_threads(1)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


class TestGemm:
    @pytest.mark.parametrize("shape", [(100, 70, 33), (16, 40, 24),
                                       (128, 512, 6)])
    def test_plain_matches_jax_kernel(self, shape):
        m, k, n = shape
        rng = np.random.default_rng(1)
        x = rng.normal(size=(m, k)).astype(np.float32)
        w = rng.normal(size=(k, n)).astype(np.float32)
        ref = np.asarray(make_mxu_matmul(interpret=True)(x, w))
        out = gemm(torch.from_numpy(x), torch.from_numpy(w))
        assert out.dtype == torch.float32 and out.shape == (m, n)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)

    def test_bf16_operands_accumulate_in_fp32(self):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(64, 300)).astype(np.float32)
        w = rng.normal(size=(300, 32)).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        wb = jnp.asarray(w, jnp.bfloat16)
        ref = np.asarray(make_mxu_matmul(interpret=True)(xb, wb))
        out = gemm(torch.from_numpy(x).bfloat16(),
                   torch.from_numpy(w).bfloat16())
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-3)

    def test_strided_operands(self):
        # the backward hands transposed views over; no copy is needed
        a = torch.randn(40, 70, generator=torch.Generator().manual_seed(3))
        b = torch.randn(33, 70, generator=torch.Generator().manual_seed(4))
        np.testing.assert_allclose(gemm(a, b.t()).numpy(),
                                   (a @ b.t()).numpy(), rtol=1e-5, atol=1e-5)

    def test_autograd_matches_jax_custom_vjp(self):
        rng = np.random.default_rng(5)
        x = rng.normal(size=(16, 40)).astype(np.float32)
        w = rng.normal(size=(40, 24)).astype(np.float32)
        mm = make_mxu_matmul(interpret=True)
        gx_j, gw_j = jax.grad(lambda a, b: jnp.sum(mm(a, b) ** 2),
                              argnums=(0, 1))(x, w)
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        gx_t, gw_t = torch.autograd.grad(matmul(xt, wt).square().sum(),
                                         (xt, wt))
        np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gw_t.numpy(), np.asarray(gw_j),
                                   rtol=1e-4, atol=1e-4)

    def test_backward_casts_and_skips_input_grad(self):
        x = torch.randn(8, 16).bfloat16()  # an observation: no grad
        w = torch.randn(16, 4).bfloat16().requires_grad_(True)
        (gw,) = torch.autograd.grad(matmul(x, w).sum(), (w,))
        assert gw.dtype == torch.bfloat16
        xg = torch.randn(8, 16).bfloat16().requires_grad_(True)
        gx, gw = torch.autograd.grad(matmul(xg, w).sum(), (xg, w))
        assert gx.dtype == torch.bfloat16 and gw.dtype == torch.bfloat16

    def test_cpu_counts_no_launch(self):
        before = [c.launches for c in cuda_torso.COUNTERS]
        a, b = torch.randn(5, 7), torch.randn(7, 3)
        for grad in (False, True):
            assert torch.equal(gemm(a, b, grad=grad), gemm_plain(a, b))
            assert torch.equal(gemm(a.bfloat16(), b.bfloat16(), grad=grad),
                               gemm_plain(a.bfloat16(), b.bfloat16()))
        assert [c.launches for c in cuda_torso.COUNTERS] == before

    @pytest.mark.parametrize("launcher", [gemm_bf16, gemm_bf16_grad,
                                          gemm_f32, gemm_f32_grad])
    def test_kernel_launchers_take_cuda_operands_only(self, launcher):
        a, b = torch.randn(4, 8), torch.randn(8, 4)
        if launcher in (gemm_bf16, gemm_bf16_grad):
            a, b = a.bfloat16(), b.bfloat16()
        with pytest.raises(ValueError):
            launcher(a, b)

    @pytest.mark.parametrize("bad", ["mixed", "int", "shape", "device",
                                     "rank"])
    def test_rejects_what_the_kernel_does_not_take(self, bad):
        a, b = torch.randn(4, 6), torch.randn(6, 3)
        if bad == "mixed":
            b = b.bfloat16()
        elif bad == "int":
            a, b = a.int(), b.int()
        elif bad == "shape":
            b = torch.randn(5, 3)
        elif bad == "device":
            a, b = a.to("meta"), b.to("meta")
        else:
            a = a[None]
        with pytest.raises(ValueError):
            cuda_torso.gemm(a, b)

    @pytest.mark.parametrize("m, n, k", SPLIT_K_SHAPES + FORWARD_SHAPES
                             + BACKWARD_SHAPES)
    def test_plan_f32_covers_the_contraction(self, m, n, k):
        tm, tn, chunk, splits = cuda_torso.plan_f32(m, n, k)
        assert tm in cuda_torso.F32_TILE_M
        assert chunk % cuda_torso.F32_TILE_K == 0
        assert (splits - 1) * chunk < k <= splits * chunk
        # the narrowest tile width that holds N, the widest past it
        wide = [t for t in cuda_torso.F32_TILE_N if t >= n]
        assert tn == (min(wide) if wide else max(cuda_torso.F32_TILE_N))

    @pytest.mark.parametrize("m, n, k, tile", [
        (100, 6, 64, (64, 32)), (6437, 64, 200, (64, 64)),
        (100, 512, 3136, (64, 128)), (70000, 32, 256, (128, 32)),
        (70000, 64, 256, (128, 64)), (20000, 512, 256, (128, 128))])
    def test_plan_f32_reaches_every_tile(self, m, n, k, tile):
        # each (tile_m, tile_n) the fp32 kernel instantiates, at a shape of
        # chip_smoke.py's sweep: 128-row tiles only where they alone give
        # F32_TALL_BLOCKS blocks a SM
        assert cuda_torso.plan_f32(m, n, k)[:2] == tile

    def test_plan_f32_splits_conv0_dw_not_the_forward(self):
        # Conv_0's dw (1,600 K tiles over 4 output tiles) is split into
        # about F32_SPLIT_BLOCKS blocks a SM, each chunk whole K tiles; the
        # forward's 51,200 rows fill the SMs unsplit, in 64-row tiles
        tm, tn, chunk, splits = cuda_torso.plan_f32(256, 32, 51200)
        assert (tm, tn) == (64, 32) and splits > 1
        blocks = -(-256 // tm) * splits
        want = cuda_torso.F32_SPLIT_BLOCKS * cuda_torso.NUM_SMS
        assert want // 2 <= blocks <= want
        assert chunk // cuda_torso.F32_TILE_K >= cuda_torso.F32_MIN_K_TILES
        assert cuda_torso.plan_f32(51200, 32, 256) == (64, 32, 256, 1)

    def test_plan_f32_splits_the_q_head_not_a_short_contraction(self):
        # the Q head's forward (2 output tiles, 16 K tiles) splits into
        # chunks of F32_MIN_K_TILES; its dw (4 K tiles) does not split
        tm, tn, chunk, splits = cuda_torso.plan_f32(128, 6, 512)
        assert chunk == cuda_torso.F32_MIN_K_TILES * cuda_torso.F32_TILE_K
        assert splits == 512 // chunk
        assert cuda_torso.plan_f32(512, 6, 128)[3] == 1

    @pytest.mark.parametrize("m, n, k", SPLIT_K_SHAPES + FORWARD_SHAPES
                             + BACKWARD_SHAPES)
    def test_plan_bf16_covers_the_contraction(self, m, n, k):
        tm, tn, chunk, splits = cuda_torso.plan_bf16(m, n, k)
        assert tm in cuda_torso.BF16_TILE_M
        assert chunk % cuda_torso.BF16_TILE_K == 0
        assert (splits - 1) * chunk < k <= splits * chunk
        # the narrowest tile width that holds N, the widest past it
        wide = [t for t in cuda_torso.BF16_TILE_N if t >= n]
        assert tn == (min(wide) if wide else max(cuda_torso.BF16_TILE_N))

    @pytest.mark.parametrize("m, n, k, tile", [
        (100, 6, 64, (64, 8)), (800, 32, 576, (64, 32)),
        (800, 64, 3136, (64, 64)), (800, 128, 512, (64, 128)),
        (20000, 6, 512, (128, 8)), (25650, 32, 256, (128, 32)),
        (20000, 64, 256, (128, 64)), (5000, 512, 512, (128, 128))])
    def test_plan_bf16_reaches_every_tile(self, m, n, k, tile):
        # each (tile_m, tile_n) the kernel instantiates, at a shape of
        # chip_smoke.py's forward sweep
        assert cuda_torso.plan_bf16(m, n, k)[:2] == tile

    def test_plan_bf16_splits_only_a_short_grid(self):
        plan = cuda_torso.plan_bf16
        assert plan(128, 512, 7 * 7 * 64)[3] > 1  # Dense_0: 8 output tiles
        assert plan(128 * 20 * 20, 32, 256)[3] == 1  # Conv_0: 400 tiles
        assert plan(128 * 20 * 20, 32, 256)[:2] == (128, 32)
        tm, tn, _chunk, splits = plan(128, 512, 7 * 7 * 64)
        blocks = -(-128 // tm) * -(-512 // tn) * splits
        assert cuda_torso.NUM_SMS <= blocks < 2 * cuda_torso.NUM_SMS

    def test_plan_bf16_splits_the_long_backward_contractions(self):
        # the backward shares the forward's plan: Conv_0's dw (800 K tiles
        # over 4 output tiles) is split into about one block per SM, each
        # chunk whole K tiles
        tm, tn, chunk, splits = cuda_torso.plan_bf16(256, 32, 51200)
        assert (tm, tn) == (64, 32) and splits > 1
        blocks = -(-256 // tm) * splits
        assert cuda_torso.NUM_SMS // 2 <= blocks <= cuda_torso.NUM_SMS
        assert chunk // cuda_torso.BF16_TILE_K >= cuda_torso.BF16_MIN_K_TILES
        for m, n, k in BACKWARD_SHAPES:
            tm, tn, _chunk, splits = cuda_torso.plan_bf16(m, n, k)
            tiles = -(-m // tm) * -(-n // tn)
            assert tiles * splits < 4 * cuda_torso.NUM_SMS or splits == 1

    def test_torso_hands_over_tma_ready_operands(self, monkeypatch):
        # every forward GEMM of the bf16 torso, as build_torso_apply calls
        # it: both operands K-major, 16-byte rows, no copy needed
        seen = []

        def record(a, b):
            seen.append((a, b))
            return gemm_plain(a, b)

        monkeypatch.setattr(cuda_torso, "gemm", record)
        _jm, _jp, _m, sd, obs = _jax_and_port(torch.bfloat16)
        build_torso_apply(255.0, torch.bfloat16)(sd, torch.from_numpy(obs))
        assert [(a.shape[1], b.shape[1]) for a, b in seen] == [
            (256, 32), (512, 64), (576, 64), (3136, 512), (512, 6)]
        for a, b in seen:
            assert cuda_torso.tma_major(a, 1) == "k", (a.shape, a.stride())
            assert cuda_torso.tma_major(b, 0) == "k", (b.shape, b.stride())
            assert b.stride(0) == 1  # a view of an (N, K) weight

    def test_tma_major_reads_the_backward_operands_as_they_lie(self):
        major = cuda_torso.tma_major
        x = torch.randn(200, 256).bfloat16()  # patches (rows, features)
        w = torch.randn(32, 256).bfloat16()  # a weight, stored (N, K)
        g = torch.randn(200, 32).bfloat16()  # a cotangent (rows, N)
        assert major(x, 1) == "k" and major(w.t(), 0) == "k"  # forward
        assert major(x.t(), 1) == "mn" and major(g, 0) == "mn"  # dw
        assert major(g, 1) == "k" and major(w, 0) == "mn"  # dx
        # a ragged line padded to 16 bytes reads MN-major too
        assert major(torch.randn(64, 72).bfloat16()[:, :70], 0) == "mn"
        assert major(torch.randn(64, 70).bfloat16(), 0) is None

    def test_tma_rows_aligns_only_what_needs_it(self):
        g = torch.randn(128, 6).bfloat16()  # the Q head's cotangent
        a = cuda_torso.tma_rows(g)
        assert a.stride() == (8, 1) and torch.equal(a, g)
        assert cuda_torso.tma_major(a, 1) == "k"
        assert cuda_torso.tma_major(a, 0) == "mn"
        ok = torch.randn(128, 64).bfloat16()
        assert cuda_torso.tma_rows(ok) is ok

    def test_tma_predicate_rejects_what_no_descriptor_reads(self):
        def ok(t, k_dim):
            return cuda_torso.tma_major(t, k_dim) is not None

        head = torch.randn(6, 512).bfloat16()
        assert ok(head.t(), 0)  # K-major (512, 6): rows 1,024 bytes apart
        n_major = head.t().contiguous()  # (512, 6): rows 12 bytes apart
        assert not ok(n_major, 0)
        assert not ok(torch.randn(64, 100).bfloat16(), 1)  # 200-byte rows
        assert not ok(torch.randn(64, 128).bfloat16()[:, 1:], 1)  # base + 2
        # fp32 is read; float64 and float16 are refused
        assert ok(torch.randn(64, 128), 1)
        assert not ok(torch.randn(64, 128).double(), 1)
        assert not ok(torch.randn(64, 128).half(), 1)

    @pytest.mark.parametrize("bad", ["a_n_major", "a_row_12_bytes",
                                     "b_n_major", "b_misaligned"])
    def test_check_tma_operands_raises_with_the_reason(self, bad):
        a = torch.randn(64, 512).bfloat16()
        b = torch.randn(6, 512).bfloat16().t()  # the head, K-major
        cuda_torso.check_tma_operands(a, b)
        if bad == "a_n_major":
            # M-major, but its K lines 136 bytes apart
            a = torch.randn(512, 68).bfloat16()[:, :64].t()
        elif bad == "a_row_12_bytes":
            a, b = torch.randn(64, 6).bfloat16(), torch.randn(6, 6).bfloat16()
        elif bad == "b_n_major":
            b = b.contiguous()  # (512, 6): rows 12 bytes apart
        else:
            b = torch.randn(6, 520).bfloat16()[:, 1:513].t()  # base + 2
        with pytest.raises(ValueError, match="no TMA descriptor"):
            cuda_torso.check_tma_operands(a, b)


    def test_tma_major_reads_fp32_operands_as_they_lie(self):
        major = cuda_torso.tma_major
        x = torch.randn(200, 256)  # patches (rows, features)
        w = torch.randn(32, 256)  # a weight, stored (N, K)
        g = torch.randn(200, 32)  # a cotangent (rows, N)
        assert major(x, 1) == "k" and major(w.t(), 0) == "k"  # forward
        assert major(x.t(), 1) == "mn" and major(g, 0) == "mn"  # dw
        assert major(g, 1) == "k" and major(w, 0) == "mn"  # dx
        # a ragged line padded to 16 bytes reads MN-major too
        assert major(torch.randn(64, 72)[:, :70], 0) == "mn"
        assert major(torch.randn(64, 70), 0) is None  # 280-byte lines

    def test_tma_rows_aligns_the_fp32_head_cotangent(self):
        g = torch.randn(128, 6)  # the Q head's fp32 cotangent: 24-byte rows
        assert cuda_torso.tma_major(g, 1) is None
        assert cuda_torso.tma_major(g, 0) is None
        a = cuda_torso.tma_rows(g)
        assert a.stride() == (8, 1) and torch.equal(a, g)
        assert cuda_torso.tma_major(a, 1) == "k"
        assert cuda_torso.tma_major(a, 0) == "mn"
        ok = torch.randn(128, 64)
        assert cuda_torso.tma_rows(ok) is ok

    @pytest.mark.parametrize("bad, operand", [
        ("a_k_major_200_byte_rows", "a"), ("a_m_major_200_byte_lines", "a"),
        ("b_n_major_24_byte_rows", "b"), ("b_misaligned", "b"),
        ("float64", "a"), ("float16", "a")])
    def test_check_tma_operands_raises_for_fp32(self, bad, operand):
        a = torch.randn(64, 512)
        b = torch.randn(6, 512).t()  # the head, K-major
        cuda_torso.check_tma_operands(a, b)
        if bad == "a_k_major_200_byte_rows":
            a, b = torch.randn(64, 50), torch.randn(50, 8)
        elif bad == "a_m_major_200_byte_lines":
            a, b = torch.randn(64, 50).t(), torch.randn(64, 8)
        elif bad == "b_n_major_24_byte_rows":
            b = torch.randn(512, 6)
        elif bad == "b_misaligned":
            b = torch.randn(6, 520)[:, 1:513].t()  # base + 4
        else:
            dt = torch.float64 if bad == "float64" else torch.float16
            a, b = a.to(dt), b.to(dt)
        with pytest.raises(ValueError, match=f"no TMA descriptor reads "
                                             f"operand {operand}"):
            cuda_torso.check_tma_operands(a, b)

    def test_fp32_torso_hands_over_tma_ready_operands(self, monkeypatch):
        # every GEMM of the fp32 torso, forward and backward, as
        # build_torso_apply and backward call it: the forward reads both
        # operands K-major; dw = x^T g reads both M-/N-major and dx = g w^T
        # g K-major and w N-major, as they lie; only the Q head's cotangent
        # (24-byte rows) is copied, into 32-byte rows
        seen = []

        def record(a, b, grad=False):
            seen.append((grad, a, b))
            return gemm_plain(a, b)

        monkeypatch.setattr(cuda_torso, "gemm", record)
        _jm, _jp, _m, sd, obs = _jax_and_port(torch.float32, SMALL)
        params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
        q = build_torso_apply(255.0, torch.float32)(params,
                                                    torch.from_numpy(obs))
        torch.autograd.grad(q.square().sum(), list(params.values()))
        major = cuda_torso.tma_major
        fwd = [(a, b) for grad, a, b in seen if not grad]
        bwd = [(a, b) for grad, a, b in seen if grad]
        assert [(a.shape[1], b.shape[1]) for a, b in fwd] == [
            (256, 32), (512, 64), (576, 64), (384, 512), (512, 6)]
        for a, b in fwd + bwd:
            assert a.dtype == b.dtype == torch.float32
        assert [(major(a, 1), major(b, 0)) for a, b in fwd] == [("k", "k")] * 5
        layouts = [(major(a, 1), major(b, 0)) for a, b in bwd]
        assert sorted(layouts) == sorted([("mn", "mn")] * 5
                                         + [("k", "mn")] * 4), layouts
        head_dx = bwd[0][0]  # the Q head's dx = g w^T comes first
        assert head_dx.shape == (2, 6) and head_dx.stride() == (8, 1)


    def test_bench_gemm_lays_out_the_operands_of_the_main_path(self):
        # the GEMMs chip_smoke.py and bench_gemm time: per update and per
        # type 10 forward GEMMs reading both operands K-major, 5 dw reading
        # both M-/N-major and 4 dx reading g K-major and w N-major
        calls, layouts = {}, {}
        for part, label, a, b, count in bench_gemm.update_gemms("cpu"):
            calls[part] = calls.get(part, 0) + count
            layouts.setdefault((part, label.split(".")[1]), set()).add(
                (cuda_torso.tma_major(a, 1), cuda_torso.tma_major(b, 0)))
            assert a.dtype == (torch.float32 if part.startswith("f32")
                               else torch.bfloat16)
        assert calls == {"fwd": 10, "bwd": 9, "f32_fwd": 10, "f32_bwd": 9}
        for (part, kind), seen in layouts.items():
            assert seen == {{"fwd": ("k", "k"), "dw": ("mn", "mn"),
                             "dx": ("k", "mn")}[kind]}, (part, kind)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_bench_gemm_candidate_plans_cover_the_contraction(self, dtype):
        tile_k = (cuda_torso.F32_TILE_K if dtype == torch.float32
                  else cuda_torso.BF16_TILE_K)
        for m, n, k in FORWARD_SHAPES + BACKWARD_SHAPES:
            plans = bench_gemm.candidate_plans(m, n, k, dtype)
            assert (cuda_torso.plan_f32 if dtype == torch.float32
                    else cuda_torso.plan_bf16)(m, n, k) in plans
            for _tm, _tn, chunk, splits in plans:
                assert chunk % tile_k == 0
                assert (splits - 1) * chunk < k <= splits * chunk


def _flax_params(frame, actions: int, rng) -> dict:
    """A ``DqnCnnModel`` param tree in flax's layout (HWIO convs, (in, out)
    denses), fan-in scaled, with non-zero biases."""
    shapes, cin = {}, 4
    for i, (cout, k) in enumerate(((32, 8), (64, 4), (64, 3))):
        shapes[f"Conv_{i}"] = ((k, k, cin, cout), cout)
        cin = cout
    oh, ow = torso_out_hw(*frame)
    shapes["Dense_0"] = ((oh * ow * cin, 512), 512)
    shapes["Dense_1"] = ((512, actions), actions)
    tree = {}
    for name, (kshape, width) in shapes.items():
        fan_in = int(np.prod(kshape[:-1]))
        tree[name] = {
            "kernel": (rng.normal(size=kshape) * np.sqrt(2.0 / fan_in)
                       ).astype(np.float32),
            "bias": rng.normal(scale=0.05, size=width).astype(np.float32)}
    return {"params": tree}


def _jax_and_port(cd: torch.dtype, frame=(84, 84), actions=6, seed=0):
    jmodel = JaxDqnCnn(action_space=actions, norm_val=255.0,
                       compute_dtype=_JNP[cd])
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 255, (2, 4, *frame)).astype(np.uint8)
    jparams = _flax_params(frame, actions, rng)
    state_shape = (4, *frame)
    sd = convert_dqn_cnn(jax.device_get(jparams), state_shape)
    model = DqnCnnModel(actions, state_shape, compute_dtype=cd)
    model.load_state_dict(sd)
    return jmodel, jparams, model, sd, obs


class _Fp32OperandMatmul(torch.autograd.Function):
    """The bf16 torso's product as it stood before bf16 cotangents: the
    fp32 product is rounded outside, so the cotangent arrives fp32, and the
    backward multiplies fp32 copies of x and w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return gemm_plain(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.float()
        return (gemm_plain(g, w.float().t()).to(x.dtype),
                gemm_plain(x.float().t(), g).to(w.dtype))


def _grad_tree_to_port(grads, state_shape):
    return {k: v.numpy() for k, v in
            convert_dqn_cnn(jax.device_get(grads), state_shape).items()}


class TestTorso:
    @pytest.mark.parametrize("frame", [(84, 84), SMALL])
    def test_forward_fp32(self, frame):
        jmodel, jparams, model, sd, obs = _jax_and_port(torch.float32, frame)
        q_ref = np.asarray(jmodel.apply(jparams, obs))
        obs_t = torch.from_numpy(obs)
        q_mod = model(obs_t)
        q_kern = build_torso_apply(255.0, torch.float32)(sd, obs_t)
        for q in (q_mod, q_kern):
            assert q.dtype == torch.float32 and q.shape == (2, 6)
            np.testing.assert_allclose(_np(q), q_ref, rtol=1e-4, atol=1e-4)
        if frame == SMALL:
            q_pal = np.asarray(build_pallas_torso_apply(
                255.0, jnp.float32, interpret=True)(jparams, obs))
            np.testing.assert_allclose(_np(q_kern), q_pal, rtol=1e-4,
                                       atol=1e-4)

    def test_gradients_fp32(self):
        jmodel, jparams, model, sd, obs = _jax_and_port(torch.float32,
                                                        SMALL, seed=1)
        g_ref = _grad_tree_to_port(jax.grad(
            lambda p: jnp.sum(jmodel.apply(p, obs) ** 2))(jparams),
            (4, *SMALL))
        g_pal = _grad_tree_to_port(jax.grad(
            lambda p: jnp.sum(build_pallas_torso_apply(
                255.0, jnp.float32, interpret=True)(p, obs) ** 2))(jparams),
            (4, *SMALL))
        params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
        q = build_torso_apply(255.0, torch.float32)(params,
                                                    torch.from_numpy(obs))
        g_kern = dict(zip(params, torch.autograd.grad(
            q.square().sum(), list(params.values()))))
        g_mod = dict(zip(sd, torch.autograd.grad(
            model(torch.from_numpy(obs)).square().sum(),
            [dict(model.named_parameters())[k] for k in sd])))
        for name in sd:
            for g, ref in ((g_kern, g_pal), (g_kern, g_ref), (g_mod, g_ref)):
                np.testing.assert_allclose(_np(g[name]), ref[name],
                                           rtol=1e-3, atol=1e-3,
                                           err_msg=name)

    def test_forward_bf16(self):
        jmodel, jparams, model, sd, obs = _jax_and_port(torch.bfloat16,
                                                        seed=3)
        q_ref = np.asarray(jmodel.apply(jparams, obs))
        obs_t = torch.from_numpy(obs)
        scale = max(1.0, float(np.abs(q_ref).max()))
        for q in (model(obs_t),
                  build_torso_apply(255.0, torch.bfloat16)(sd, obs_t)):
            assert q.dtype == torch.float32
            np.testing.assert_allclose(_np(q), q_ref, rtol=2e-2,
                                       atol=2e-2 * scale)

    def test_gradients_bf16_direction(self):
        jmodel, jparams, model, sd, obs = _jax_and_port(torch.bfloat16,
                                                        seed=4)
        g_ref = _grad_tree_to_port(jax.grad(
            lambda p: jnp.mean(jmodel.apply(p, obs) ** 2))(jparams),
            (4, 84, 84))
        params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
        q = build_torso_apply(255.0, torch.bfloat16)(params,
                                                     torch.from_numpy(obs))
        grads = torch.autograd.grad(q.square().mean(), list(params.values()))
        flat_t = np.concatenate([_np(g).ravel() for g in grads])
        flat_r = np.concatenate([g_ref[k].ravel() for k in params])
        cos = flat_t @ flat_r / (np.linalg.norm(flat_t)
                                 * np.linalg.norm(flat_r))
        assert cos > 0.999, cos


    def test_bf16_backward_equals_the_fp32_operand_formulation(
            self, monkeypatch):
        # every operand of the backward is bf16-exact, so the bf16 backward
        # (bf16 cotangent, x and w as they lie, through the plain version
        # here) computes the same products and sums as fp32 copies do:
        # bitwise equal gradients
        _jm, _jp, _m, sd, obs = _jax_and_port(torch.bfloat16, SMALL, seed=6)
        obs_t = torch.from_numpy(obs)

        def grads():
            params = {k: v.clone().requires_grad_(True)
                      for k, v in sd.items()}
            q = build_torso_apply(255.0, torch.bfloat16)(params, obs_t)
            return torch.autograd.grad(q.square().mean(),
                                       list(params.values()))

        cotangents = []
        backward = cuda_torso._Matmul.backward

        def spy(ctx, g):
            cotangents.append(g.dtype)
            return backward(ctx, g)

        monkeypatch.setattr(cuda_torso._Matmul, "backward",
                            staticmethod(spy))
        new = grads()
        assert cotangents == [torch.bfloat16] * 5
        monkeypatch.setattr(
            cuda_torso, "matmul",
            lambda x, w, out_dtype: _Fp32OperandMatmul.apply(x, w).to(
                out_dtype))
        for name, a, b in zip(sd, new, grads()):
            assert torch.equal(a, b), name

    def test_gradients_bf16_elementwise_against_the_pallas_torso(self):
        # tolerance: 2e-2 of each gradient's largest entry.  bf16 keeps 8
        # significant bits (3.9e-3 per rounding), and the two frameworks
        # round activations and cotangents to bf16 at other points of the
        # im2col, bias and relu (6.8e-3 at most on these inputs)
        _jm, jparams, _m, sd, obs = _jax_and_port(torch.bfloat16, SMALL,
                                                  seed=7)
        g_pal = _grad_tree_to_port(jax.grad(
            lambda p: jnp.mean(build_pallas_torso_apply(
                255.0, jnp.bfloat16, interpret=True)(p, obs) ** 2))(jparams),
            (4, *SMALL))
        params = {k: v.clone().requires_grad_(True) for k, v in sd.items()}
        q = build_torso_apply(255.0, torch.bfloat16)(params,
                                                     torch.from_numpy(obs))
        grads = torch.autograd.grad(q.square().mean(), list(params.values()))
        for name, g in zip(params, grads):
            ref = g_pal[name]
            np.testing.assert_allclose(_np(g), ref, rtol=0,
                                       atol=2e-2 * np.abs(ref).max(),
                                       err_msg=name)


class TestConvert:
    def test_dense0_permutation_and_layouts(self):
        _jm, jparams, _m, sd, _obs = _jax_and_port(torch.float32, (84, 108))
        p = jparams["params"]
        assert sd["conv0.weight"].shape == (32, 4, 8, 8)
        np.testing.assert_array_equal(
            sd["conv1.weight"].numpy(),
            np.asarray(p["Conv_1"]["kernel"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                      np.asarray(p["Dense_1"]["kernel"]).T)
        # flax row (h, w, c) of Dense_0 lands at the port's column
        # (c, h, w): oh 7, ow 10, c 64 at a 84x108 frame
        k0 = np.asarray(p["Dense_0"]["kernel"])
        h, w, c = 3, 8, 17
        np.testing.assert_array_equal(
            sd["fc.weight"][:, c * 70 + h * 10 + w].numpy(),
            k0[(h * 10 + w) * 64 + c])

    def test_orthogonal_init_gains(self):
        model = DqnCnnModel(6, generator=torch.Generator().manual_seed(0))
        w = model.head.weight.detach()
        np.testing.assert_allclose((w @ w.t()).numpy(), np.eye(6),
                                   atol=1e-5)
        fc = model.fc.weight.detach()
        np.testing.assert_allclose((fc @ fc.t()).numpy(), 2 * np.eye(512),
                                   atol=1e-4)
        assert all(float(b.detach().abs().max()) == 0.0
                   for n, b in model.named_parameters() if n.endswith("bias"))
