"""What the GEMM wrapper computes in Python before it launches
csrc/gemm_bf16_wgmma.cu, on the CPU: the tile and split-K plan
(``gemm_plan``) covers every output element and every term of its sum
exactly once, and the TMA checks refuse operands that a tensor map cannot
take."""
import numpy as np
import pytest
import torch

from myrtle_vision_tpu_torch.ops import _kernels as K

ROWS = 256 * 197  # ViT-S/16 at batch 256

# (M, N, K, a transposed): the 13 ViT-S/16 products of a train step
# (forward: qkv, proj, fc1, fc2; backward: d_o, dWp, dWqkv, dxn, the fc1
# remat, dW2, dh, dW1, dxn) and a YOLOS-S block at 677 tokens, batch 8
MAIN = [(ROWS, 1152, 384, False), (ROWS, 384, 384, False),
        (ROWS, 1536, 384, False), (ROWS, 384, 1536, False),
        (384, 384, ROWS, True), (1152, 384, ROWS, True),
        (ROWS, 384, 1152, False), (384, 1536, ROWS, True),
        (1536, 384, ROWS, True), (8 * 677, 1152, 384, False),
        (1152, 384, 8 * 677, True)]
# ragged: one row, a row past the tile, N not a multiple of the tile, K
# not a multiple of the 64-deep step, weight gradients with K = B * N
RAGGED = [(1, 8, 8, False), (197, 136, 72, False),
          (4 * 197 + 3, 1152, 384, False), (129, 200, 1000, False),
          (136, 72, 150, True), (8, 8, 1, True), (384, 1152, 3 * 197, True),
          (1152, 136, 64 * 197, True)]


def blocks_of(plan, m, n, k):
    """Each output tile's (rows, columns, K rows) as the kernel derives
    them from its tile index (z, y, x): half-open ranges clipped to (M,
    N, K)."""
    (bm, bn), ks = plan["tile"], plan["k_split"]
    gx, gy, gz = plan["grid"]
    return [((y * bm, min(m, (y + 1) * bm)), (x * bn, min(n, (x + 1) * bn)),
             (z * ks, min(k, (z + 1) * ks)))
            for z in range(gz) for y in range(gy) for x in range(gx)]


def _partition(intervals, length):
    """The sorted distinct half-open intervals tile [0, length) with no
    gap, overlap or empty interval."""
    at = 0
    for lo, hi in sorted(set(intervals)):
        assert lo == at and hi > lo, (lo, hi, at)
        at = hi
    assert at == length


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("m,n,k,at", MAIN + RAGGED)
def test_plan_covers_every_output_and_term_once(m, n, k, at, sms):
    plan = K.gemm_plan(m, n, k, at, sms)
    bm, bn = plan["tile"]
    assert (bm, bn) == K.GEMM_TILE
    blocks = blocks_of(plan, m, n, k)
    gx, gy, gz = plan["grid"]
    assert len(blocks) == len(set(blocks)) == gx * gy * gz
    rows, cols, ks = zip(*blocks)
    _partition(rows, m)
    _partition(cols, n)
    _partition(ks, k)
    # each CTA's K chunk starts on a 64-deep step of the kernel, so no
    # step straddles two chunks, and only a weight gradient splits K
    assert all(lo % K.GEMM_BK == 0 for lo, _ in ks)
    assert plan["k_split"] % K.GEMM_BK == 0 or not at
    assert gz == 1 or at
    if m * n <= 2 ** 20:
        # every (row, column, K chunk) of the output exactly once
        count = np.zeros((gz, m, n), np.int32)
        chunks = sorted(set(ks))
        for (r0, r1), (c0, c1), kr in blocks:
            count[chunks.index(kr), r0:r1, c0:c1] += 1
        assert (count == 1).all()


def test_split_k_fills_one_wave():
    # the weight gradients split K into as many CTAs as one wave of two
    # an SM holds on 132 SMs (more would leave a tail wave), at least one
    # an SM, each chunk at least 256 rows deep
    for m, n, k, at in MAIN:
        if not at:
            continue
        plan = K.gemm_plan(m, n, k, at, 132)
        gx, gy, gz = plan["grid"]
        assert 132 <= gx * gy * gz <= 2 * 132, (m, n, plan)
        assert plan["k_split"] >= 256


def test_f32x3_split_is_unchanged():
    # gemm_f32x3 keeps its own tile, step and split (gemm_f32x3_plan):
    # 128 x 128 tiles, 32-deep fp32 steps, about four waves of one CTA an
    # SM, each chunk at least 8 steps deep
    for m, n, k in ((384, 384, ROWS), (1152, 384, ROWS), (136, 72, 150)):
        tiles = -(-m // 128) * -(-n // 128)
        splits = max(1, min(4 * 132 // tiles, k // 256))
        want = -(-(-(-k // splits)) // 32) * 32
        plan = K.gemm_f32x3_plan(m, n, k, True, 132)
        assert plan["tile"] == K.F32X3_TILE == (128, 128)
        assert plan["k_split"] == want and want % K.F32X3_BK == 0


def test_tma_takes_aligned_rows():
    t = torch.zeros(64, 384, dtype=torch.bfloat16)
    K.tma_operand(t, "a")
    K.tma_operand(t.t().contiguous(), "b")


def test_tma_refuses_a_misaligned_base():
    flat = torch.zeros(64 * 384 + 8, dtype=torch.bfloat16)
    t = flat[1:1 + 64 * 384].view(64, 384)  # 2 bytes past an aligned base
    assert t.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.tma_operand(t, "a")


def test_tma_refuses_rows_not_16_bytes_apart():
    t = torch.zeros(16, 12, dtype=torch.bfloat16)  # rows 24 bytes apart
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        K.tma_operand(t, "a")
    wide = torch.zeros(16, 20, dtype=torch.bfloat16)[:, :16]  # 40 bytes
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        K.tma_operand(wide, "b")


def test_tma_refuses_a_strided_row():
    t = torch.zeros(16, 32, dtype=torch.bfloat16)[:, ::2]
    with pytest.raises(ValueError, match="row-major"):
        K.tma_operand(t, "b")
