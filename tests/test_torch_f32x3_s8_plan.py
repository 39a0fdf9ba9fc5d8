"""What the wrappers of gemm_f32x3_epilogue and gemm_s8_epilogue compute in
Python before they launch csrc/gemm_f32x3_wgmma.cu and
csrc/gemm_s8_wgmma.cu, on the CPU: each plan covers every output element
and every term of its sum exactly once, epilogue 5's column sums have a
row for each row tile, and the wrappers refuse operands that a tensor map
cannot take before anything is launched."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

ROWS = 256 * 197  # ViT-S/16 at batch 256

GELU, GELU_GRAD = "bias_snap_gelu_snap", "bias_snap_gelu_snap_grad"
# (M, N, K, a transposed, epilogue): the 3-pass products of a FP16_32 or
# INT8 QAT step at ViT-S/16 (forward: qkv, proj, fc1, fc2; backward: d_o,
# dWp, dWqkv, dxn, the fc1 recompute, dW2, dh, dW1, dxn)
F32X3_MAIN = [(ROWS, 1152, 384, False, "bias_snap"),
              (ROWS, 384, 384, False, "bias_snap_residual_snap"),
              (ROWS, 1536, 384, False, GELU),
              (ROWS, 384, 1536, False, "bias_snap_residual_snap"),
              (ROWS, 384, 384, False, "f32"), (384, 384, ROWS, True, "f32"),
              (1152, 384, ROWS, True, "f32"), (ROWS, 384, 1152, False, "f32"),
              (ROWS, 1536, 384, False, GELU_GRAD),
              (384, 1536, ROWS, True, "f32"),
              (ROWS, 1536, 384, False, "mul_aux"),
              (1536, 384, ROWS, True, "f32"), (ROWS, 384, 1536, False, "f32")]
# ragged: one row, M = 4 * 197 + 3, the head's N = 45, K not a multiple
# of the 32-deep step, weight gradients with K = B * 197 and K = 1
F32X3_RAGGED = [(1, 8, 4, False, "f32"), (4 * 197 + 3, 1152, 384, False,
                                          GELU),
                (197, 45, 384, False, "bias_snap"),
                (129, 200, 1000, False, GELU_GRAD),
                (136, 72, 150, True, "f32"), (8, 8, 1, True, "f32"),
                (384, 1152, 3 * 197, True, "f32"),
                (1152, 136, 64 * 197, True, "f32")]
# (M, N, K): the converted INT8 model's products (qkv, out, fc1, fc2, the
# patch embedding, the head), then ragged ones: one row, M = 4 * 197 + 3,
# N = 45 with K not a multiple of the 128-byte step
S8_MAIN = [(ROWS, 1152, 384), (ROWS, 384, 384), (ROWS, 1536, 384),
           (ROWS, 384, 1536), (256 * 196, 384, 768), (256, 45, 384)]
S8_RAGGED = [(1, 16, 16), (4 * 197 + 3, 1152, 384), (197, 45, 400),
             (129, 200, 1008)]


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


def _covered_once(blocks, m, n, gz):
    """Every (row, column, K chunk) of the output exactly once."""
    count = np.zeros((gz, m, n), np.int32)
    chunks = sorted({kr for _, _, kr in blocks})
    for (r0, r1), (c0, c1), kr in blocks:
        count[chunks.index(kr), r0:r1, c0:c1] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("m,n,k,at,epilogue", F32X3_MAIN + F32X3_RAGGED)
def test_f32x3_plan_covers_every_output_and_term_once(m, n, k, at, epilogue,
                                                      sms):
    plan = K.gemm_f32x3_plan(m, n, k, at, sms, epilogue)
    assert plan["tile"] == (K.F32X3_GELU_TILE if "gelu" in epilogue
                            else K.F32X3_TILE)
    blocks = blocks_of(plan, m, n, k)
    gx, gy, gz = plan["grid"]
    assert len(blocks) == len(set(blocks)) == gx * gy * gz
    rows, cols, ks = zip(*blocks)
    _partition(rows, m)
    _partition(cols, n)
    _partition(ks, k)
    # each K chunk starts on a 32-deep step of the kernel, so no step
    # straddles two chunks; only a weight gradient splits K, in chunks of
    # at least 8 steps unless K itself is shorter
    assert all(lo % K.F32X3_BK == 0 for lo, _ in ks)
    assert plan["k_split"] % K.F32X3_BK == 0 or not at
    assert gz == 1 or at
    assert plan["k_split"] >= min(k, K.F32X3_MIN_CHUNK)
    if m * n <= 2 ** 20:
        _covered_once(blocks, m, n, gz)


def test_f32x3_split_k_fills_about_four_waves():
    # the main path's weight gradients: enough tiles for 3.5-4 waves of
    # one CTA an SM on 132 SMs, so the last wave is nearly full
    for m, n, k, at, _ in F32X3_MAIN:
        if not at:
            continue
        gx, gy, gz = K.gemm_f32x3_plan(m, n, k, True, 132)["grid"]
        assert 3.5 * 132 <= gx * gy * gz <= 4 * 132, (m, n, gx, gy, gz)


@pytest.mark.parametrize("m,n,k", S8_MAIN + S8_RAGGED)
def test_s8_plan_covers_every_output_and_term_once(m, n, k):
    plan = K.gemm_s8_plan(m, n, k)
    assert plan["tile"] == K.S8_TILE and plan["k_split"] == k
    blocks = blocks_of(plan, m, n, k)
    gx, gy, gz = plan["grid"]
    assert gz == 1 and len(blocks) == len(set(blocks)) == gx * gy
    rows, cols, ks = zip(*blocks)
    _partition(rows, m)
    _partition(cols, n)
    _partition(ks, k)
    # the K steps cover K once, the last one zero-filled past it
    steps = plan["steps"]
    assert (steps - 1) * K.S8_BK < k <= steps * K.S8_BK
    if m * n <= 2 ** 20:
        _covered_once(blocks, m, n, 1)


@pytest.fixture
def launches(monkeypatch):
    """The wrappers run on CPU tensors up to their launch: the device
    check passes, and each launch records its entry point and arguments
    instead of running."""
    calls = []
    monkeypatch.setattr(K, "_require", lambda t, name, dtype=None: None)
    monkeypatch.setattr(K, "_require_site", lambda site, name: None)
    monkeypatch.setattr(K, "_sms", lambda t: 132)
    monkeypatch.setattr(K, "_lib", lambda: SimpleNamespace(
        mvt_gemm_f32x3="mvt_gemm_f32x3", mvt_gemm_f32x3_at="mvt_gemm_f32x3_at",
        mvt_gemm_s8="mvt_gemm_s8"))

    def launch(name, fn, t, *args, launched=None):
        calls.append((fn, args))

    def colsum(t):
        calls.append(("colsum_rows", tuple(t.shape)))
        return t.sum(0)

    monkeypatch.setattr(K, "_launch", launch)
    monkeypatch.setattr(K, "colsum_rows_cuda", colsum)
    return calls


def _misaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose base is 4 bytes past a
    16-byte boundary (one fp32, or four int8)."""
    count = int(np.prod(shape))
    skip = 4 // torch.tensor([], dtype=dtype).element_size()
    flat = torch.zeros(count + 16, dtype=dtype)
    t = flat[skip:skip + count].view(*shape)
    assert t.data_ptr() % 16 == 4
    return t


@pytest.mark.parametrize("m", [1, 4 * 197 + 3, 300])
def test_f32x3_colpart_has_a_row_per_row_tile(launches, m):
    n, k = 72, 64
    K.gemm_f32x3_epilogue_cuda(torch.zeros(m, k), torch.zeros(k, n), None,
                               "mul_aux", (8, 10, False),
                               aux=torch.zeros(m, n))
    (fn, _), colsum = launches
    plan = K.gemm_f32x3_plan(m, n, k, False, 132, "mul_aux")
    # the kernel writes row y of colpart for row tile y: one row a tile
    rows = {y for y in range(plan["grid"][1])}
    assert fn == "mvt_gemm_f32x3"
    assert colsum == ("colsum_rows", (len(rows), n))
    assert len(rows) == -(-m // K.F32X3_TILE[0])


def test_f32x3_weight_gradient_takes_the_plans_split(launches):
    m, n, k = 384, 1152, 3 * 197
    a = torch.zeros(k, m).t()  # the (K, M) activation as it is stored
    w = torch.zeros(k, n)
    got = K.gemm_f32x3_epilogue_cuda(a, w, None, "f32", (8, 10, False))
    (fn, args), colsum = launches
    plan = K.gemm_f32x3_plan(m, n, k, True, 132)
    assert fn == "mvt_gemm_f32x3_at"
    assert args[3:7] == (m, n, k, plan["k_split"])
    # the partial products of the K chunks, summed in order
    assert plan["grid"][2] > 1
    assert colsum == ("colsum_rows", (plan["grid"][2], m * n))
    assert tuple(got.shape) == (m, n)


@pytest.mark.parametrize("epilogue", ["bias_snap", "f32"])
def test_f32x3_refuses_what_tma_cannot_load(launches, epilogue):
    m, n, k = 16, 8, 32
    w = torch.zeros(n, k).t() if epilogue == "bias_snap" else \
        torch.zeros(k, n)
    bias = torch.zeros(n) if epilogue == "bias_snap" else None
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_f32x3_epilogue_cuda(_misaligned((m, k), torch.float32), w,
                                   bias, epilogue, (8, 10, False))
    wm = _misaligned((n, k), torch.float32).t() if epilogue == "bias_snap" \
        else _misaligned((k, n), torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_f32x3_epilogue_cuda(torch.zeros(m, k), wm, bias, epilogue,
                                   (8, 10, False))
    # rows that are not 16 bytes apart: K = 6 fp32 (24 bytes)
    with pytest.raises(ValueError, match="multiple of 4"):
        K.gemm_f32x3_epilogue_cuda(torch.zeros(m, 6), torch.zeros(n, 6).t(),
                                   torch.zeros(n), "bias_snap",
                                   (8, 10, False))
    # a weight gradient's (K, M) activation with M = 6 (24-byte rows)
    with pytest.raises(ValueError, match="multiples of 4"):
        K.gemm_f32x3_epilogue_cuda(torch.zeros(k, 6).t(), torch.zeros(k, 8),
                                   None, "f32", (8, 10, False))
    assert launches == []


def test_s8_refuses_what_tma_cannot_load(launches):
    m, n, k = 16, 45, 32
    site = torch.tensor([0.1, 128.0, 1.0])
    col, one = torch.zeros(n), torch.ones(())
    w = torch.zeros(n, k, dtype=torch.int8)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_s8_epilogue_cuda(_misaligned((m, k), torch.int8), w.t(), col,
                                one, site, col, "requant", site)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_s8_epilogue_cuda(torch.zeros(m, k, dtype=torch.int8),
                                _misaligned((n, k), torch.int8).t(), col,
                                one, site, col, "requant", site)
    # rows of 24 bytes
    with pytest.raises(ValueError, match="multiple of 16"):
        K.gemm_s8_epilogue_cuda(torch.zeros(m, 24, dtype=torch.int8),
                                torch.zeros(n, 24, dtype=torch.int8).t(),
                                col, one, site, col, "requant", site)
    assert launches == []
    # what a tensor map takes reaches the launch, the head's ragged N too
    out = K.gemm_s8_epilogue_cuda(torch.zeros(m, k, dtype=torch.int8),
                                  w.t(), col, one, site, col, "requant",
                                  site)
    fn, args = launches[-1]
    assert fn == "mvt_gemm_s8" and args[10:14] == (m, n, k, 0)
    assert tuple(out.shape) == (m, n)


def test_f32x3_int8_sites_reach_the_launch(launches):
    m, n, k = 8, 16, 32
    s0, s1 = torch.tensor([0.1, 128.0, 1.0]), torch.tensor([0.2, 3.0, 1.0])
    K.gemm_f32x3_epilogue_cuda(torch.zeros(m, k), torch.zeros(n, k).t(),
                               torch.zeros(n), "bias_snap_gelu_snap",
                               Int8Sites(s0, s1))
    _, args = launches[-1]
    assert args[-2:] == (s0.data_ptr(), s1.data_ptr())
