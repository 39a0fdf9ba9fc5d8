"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  They need a CUDA device and skip without one; this file imports
torch only, so on a machine without jax it runs as

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""
import numpy as np
import pytest
import torch

from myrtle_vision_tpu_torch.models.vit import ViT
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
    fused_attention_block_plain,
)
from myrtle_vision_tpu_torch.ops.fused_mlp import (
    fused_mlp_block,
    fused_mlp_block_plain,
)

pytestmark = pytest.mark.cuda

# kernel and plain version round at the same points; summation order
# alone differs, which can move a value across a bf16 rounding boundary.
# Bar per element, as in chip_smoke.py: two bf16 steps of |ref| plus an
# atol for fp32 noise (one kernel) or a flipped intermediate carried
# through the next product (a block-half chain).
RTOL = 2.0 ** -6
KERNEL_ATOL = 2.0 ** -7
CHAIN_ATOL = 2.0 ** -6
# A weight or bias gradient is a sum over the B*N rows; a flipped bf16
# intermediate moves one of its terms, so its bar adds 2^-8 of the
# tensor's largest magnitude to the per-element term (chip_smoke.py).
SUM_ATOL = 2.0 ** -8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def close(got, ref, atol=KERNEL_ATOL):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=RTOL,
                               atol=atol)


def close_grads(got, ref, names):
    """Block gradients: dx (bf16) per element with the chain bar, the
    parameter gradients with the sum bar."""
    for g, r, name in zip(got, ref, names):
        atol = (CHAIN_ATOL if name == "x"
                else SUM_ATOL * max(1.0, float(r.abs().max())))
        assert g.shape == r.shape and g.dtype == r.dtype, name
        torch.testing.assert_close(g.float(), r.float(), rtol=RTOL,
                                   atol=atol, msg=name)


def grads_of(fn, x, params, extra, do):
    leaves = [x.detach().clone().requires_grad_()] + [
        p.detach().clone().requires_grad_() for p in params]
    fn(*leaves, *extra).backward(do)
    torch.cuda.synchronize()
    return [t.grad for t in leaves]


def block(c, hid, b, n, seed, dev):
    rng = np.random.RandomState(seed)

    def t(*shape, std=1.0, dtype=torch.float32):
        return torch.from_numpy(
            (rng.randn(*shape) * std).astype(np.float32)
        ).to(dev, dtype)

    # std-1 biases, so that a dropped bias shows in the output; weights
    # (in, out) views of torch (out, in) tensors, as the ViT block passes
    x = t(b, n, c, dtype=torch.bfloat16)
    attn = [1 + t(c, std=0.1), t(c, std=0.1), t(3 * c, c, std=c ** -0.5).t(),
            t(3 * c), t(c, c, std=c ** -0.5).t(), t(c)]
    mlp = [1 + t(c, std=0.1), t(c, std=0.1), t(hid, c, std=c ** -0.5).t(),
           t(hid), t(c, hid, std=hid ** -0.5).t(), t(c)]
    return x, attn, mlp


# (C, heads, hidden, B, N): head widths 32 and 64, sequences shorter than
# a head (N < D), ragged against the 16-row tiles, and ViT-S/16
SHAPES = [(64, 2, 128, 3, 17), (64, 2, 128, 3, 50), (128, 2, 256, 3, 17),
          (128, 2, 256, 2, 37), (384, 6, 1536, 4, 197)]


@pytest.mark.parametrize("c,heads,hid,b,n", SHAPES)
def test_attention_chain_matches_plain(dev, c, heads, hid, b, n):
    x, attn, _ = block(c, hid, b, n, n, dev)
    scale = (c // heads) ** -0.5
    before = fused_attention_block.launches
    close(fused_attention_block(x, *attn, heads, scale),
          fused_attention_block_plain(x, *attn, heads, scale), CHAIN_ATOL)
    assert fused_attention_block.launches == before + 1


@pytest.mark.parametrize("c,heads,hid,b,n", SHAPES)
def test_mlp_chain_matches_plain(dev, c, heads, hid, b, n):
    x, _, mlp = block(c, hid, b, n, n + 1, dev)
    before = fused_mlp_block.launches
    close(fused_mlp_block(x, *mlp), fused_mlp_block_plain(x, *mlp),
          CHAIN_ATOL)
    assert fused_mlp_block.launches == before + 1


@pytest.mark.parametrize("epilogue", ["bias", "bias_gelu", "bias_residual"])
@pytest.mark.parametrize("col_major", [False, True])
def test_gemm_epilogues_and_layouts(dev, epilogue, col_major):
    rng = np.random.RandomState(3)
    m, k, n = 197 * 2 + 5, 72, 136  # ragged M; K, N multiples of 8 only
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy(rng.randn(k, n).astype(np.float32) * k ** -0.5)
    w = (w.t().contiguous().to(dev, torch.bfloat16).t() if col_major
         else w.to(dev, torch.bfloat16))
    bias = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    res = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(
        dev, torch.bfloat16)
    close(K.gemm_bf16_epilogue_cuda(a, w, bias, epilogue, residual=res),
          K.gemm_bf16_epilogue_plain(a, w, bias, epilogue, residual=res))


def test_layernorm_and_attention_core(dev):
    x, attn, _ = block(384, 1536, 2, 197, 9, dev)
    s, b = attn[0].to(torch.bfloat16), attn[1].to(torch.bfloat16)
    close(K.layernorm_rows_cuda(x, s, b), K.layernorm_rows_plain(x, s, b))
    qkv = torch.randn(2, 197, 3 * 384, device=dev).to(torch.bfloat16)
    close(K.attention_core_cuda(qkv, 6, 0.125),
          K.attention_core_plain(qkv, 6, 0.125))


def test_kernels_refuse_what_they_do_not_take(dev):
    n = K.attention_core_max_n() + 1
    with pytest.raises(ValueError, match="exceeds"):
        K.attention_core_cuda(
            torch.zeros(1, n, 3 * 64, device=dev, dtype=torch.bfloat16),
            1, 0.125)
    a = torch.zeros(4, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        K.gemm_bf16_epilogue_cuda(a, torch.zeros_like(a).t(),
                                  torch.zeros(4, device=dev), "bias")
    w = torch.zeros(16, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="b must be row-major"):
        K.gemm_bf16_epilogue_cuda(w[:4, :8].contiguous(), w[:8, ::2],
                                  torch.zeros(16, device=dev), "bias")
    x, attn, _ = block(64, 128, 1, 17, 0, dev)
    with pytest.raises(TypeError, match="bf16"):
        fused_attention_block(x.float(), *attn, 2, 0.125)


def test_model_runs_through_the_kernels(dev):
    kw = dict(decoder="classification", image_size=96, patch_size=16,
              num_classes=7, dim=128, depth=3, heads=2, mlp_dim=256)
    model = ViT(**kw, device=dev).eval()
    img = torch.from_numpy(
        np.random.RandomState(0).uniform(-1, 1, (4, 96, 96, 3)).astype(
            np.float32)).to(dev)
    before = (fused_attention_block.launches, fused_mlp_block.launches)
    with torch.inference_mode():
        out = model(img)
        ref = model(img, plain=True)
    assert (fused_attention_block.launches - before[0],
            fused_mlp_block.launches - before[1]) == (3, 3)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=2.0 ** -4)


@pytest.mark.parametrize("save", ["0", "1"])
@pytest.mark.parametrize("c,heads,hid,b,n", SHAPES)
def test_attention_backward_matches_plain(dev, c, heads, hid, b, n, save,
                                          monkeypatch):
    monkeypatch.setenv("MVT_SAVE_ACTS", save)
    x, attn, _ = block(c, hid, b, n, n + 2, dev)
    do = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(n)).to(x.dtype)
    extra = ((heads, (c // heads) ** -0.5))
    before = fused_attention_block.bwd_launches
    got = grads_of(fused_attention_block, x, attn, extra, do)
    assert fused_attention_block.bwd_launches == before + 1
    ref = grads_of(fused_attention_block_plain, x, attn, extra, do)
    close_grads(got, ref, ["x", "scale", "bias", "wqkv", "bqkv", "wp", "bp"])


@pytest.mark.parametrize("c,heads,hid,b,n", SHAPES)
def test_mlp_backward_matches_plain(dev, c, heads, hid, b, n):
    x, _, mlp = block(c, hid, b, n, n + 3, dev)
    do = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(n)).to(x.dtype)
    before = fused_mlp_block.bwd_launches
    got = grads_of(fused_mlp_block, x, mlp, (), do)
    assert fused_mlp_block.bwd_launches == before + 1
    ref = grads_of(fused_mlp_block_plain, x, mlp, (), do)
    close_grads(got, ref, ["x", "scale", "bias", "w1", "b1", "w2", "b2"])


@pytest.mark.parametrize("m", [150, 197 * 2 + 5, 64 * 197])
def test_gemm_weight_gradient_ragged_k(dev, m):
    """dW^T = A^T B with K = B*N rows (150 = 3 x 50: not a multiple of
    8), split over blocks at the larger K."""
    rng = np.random.RandomState(m)
    a = torch.from_numpy(rng.randn(m, 136).astype(np.float32)).to(
        dev, torch.bfloat16)
    b = torch.from_numpy(rng.randn(m, 72).astype(np.float32)).to(
        dev, torch.bfloat16)
    got = K.gemm_bf16_epilogue_cuda(a.t(), b, None, "f32")
    ref = K.gemm_bf16_epilogue_plain(a.t(), b, None, "f32")
    close(got, ref, SUM_ATOL * float(ref.abs().max()))


@pytest.mark.parametrize("col_major", [False, True])
def test_gemm_backward_epilogues(dev, col_major):
    rng = np.random.RandomState(4)
    m, k, n = 197 * 2 + 5, 72, 136

    def t(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)

    a = t(m, k)
    w = t(n, k).t() if col_major else t(k, n)
    bias = t(n, dtype=torch.float32)
    close(K.gemm_bf16_epilogue_cuda(a, w, None, "f32"),
          K.gemm_bf16_epilogue_plain(a, w, None, "f32"))
    for got, ref in zip(
            K.gemm_bf16_epilogue_cuda(a, w, bias, "bias_gelu_grad"),
            K.gemm_bf16_epilogue_plain(a, w, bias, "bias_gelu_grad")):
        close(got, ref)
    aux = t(m, n, dtype=torch.float32)
    got = K.gemm_bf16_epilogue_cuda(a, w, None, "mul_aux", aux=aux)
    ref = K.gemm_bf16_epilogue_plain(a, w, None, "mul_aux", aux=aux)
    close(got[0], ref[0])
    close(got[1], ref[1], SUM_ATOL * float(ref[1].abs().max()))


@pytest.mark.parametrize("b,n,d", [(2, 197, 64), (3, 17, 64), (2, 37, 64),
                                   (3, 50, 32)])
def test_attention_core_stats_and_backward(dev, b, n, d):
    heads = 2
    gen = torch.Generator(dev).manual_seed(n)
    qkv = torch.randn(b, n, 3 * heads * d, device=dev,
                      generator=gen).to(torch.bfloat16)
    got = K.attention_core_cuda(qkv, heads, d ** -0.5, stats=True)
    ref = K.attention_core_plain(qkv, heads, d ** -0.5, stats=True)
    for g, r in zip(got, ref):
        close(g, r)
    d_o = torch.randn(b, n, heads * d, device=dev, generator=gen)
    got = K.attention_core_bwd_cuda(qkv, d_o, ref[1], ref[2], heads,
                                    d ** -0.5)
    want = K.attention_core_bwd_plain(qkv, d_o, ref[1], ref[2], heads,
                                      d ** -0.5)
    close(got[0], want[0], CHAIN_ATOL)
    close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))


@pytest.mark.parametrize("rows", [50, 64 * 197])
def test_layernorm_bwd_and_colsum(dev, rows):
    rng = np.random.RandomState(rows)

    def t(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)

    x, do, scale = t(rows, 384), t(rows, 384), t(384)
    dxn = t(rows, 384, dtype=torch.float32)
    got = K.layernorm_rows_bwd_cuda(x, scale, dxn, do)
    ref = K.layernorm_rows_bwd_plain(x, scale, dxn, do)
    close(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g, r, SUM_ATOL * float(r.abs().max()))
    for src in (do, dxn):
        want = K.colsum_rows_plain(src)
        before = K.LAUNCHES["colsum_rows"]
        close(K.colsum_rows_cuda(src), want,
              SUM_ATOL * float(want.abs().max()))
        # one kernel up to a chunk of 64 rows, then a second pass
        assert K.LAUNCHES["colsum_rows"] - before == (1 if rows <= 64 else 2)


def test_model_trains_through_the_kernels(dev):
    kw = dict(decoder="classification", image_size=96, patch_size=16,
              num_classes=7, dim=128, depth=3, heads=2, mlp_dim=256)
    model = ViT(**kw, device=dev)
    img = torch.from_numpy(
        np.random.RandomState(1).uniform(-1, 1, (4, 96, 96, 3)).astype(
            np.float32)).to(dev)
    labels = torch.tensor([0, 3, 6, 2], device=dev)
    grads = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        before = (fused_attention_block.bwd_launches,
                  fused_mlp_block.bwd_launches)
        loss = torch.nn.functional.cross_entropy(model(img, plain=plain),
                                                 labels)
        loss.backward()
        after = (fused_attention_block.bwd_launches,
                 fused_mlp_block.bwd_launches)
        assert (after[0] - before[0], after[1] - before[1]) == \
            ((0, 0) if plain else (3, 3))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    for name, ref in grads[1].items():
        got = grads[0][name]
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(
            got, ref, rtol=2.0 ** -4,
            atol=2.0 ** -4 * max(float(ref.abs().max()), 1e-3), msg=name)


# ----------------------------------------------------- converted INT8
# Kernel and plain version compute the integer products exactly and every
# other step in the same order of fp32 operations, so they differ only
# where an fp32 sum (LayerNorm statistics, softmax rowsum, the products
# of the 3-pass core) is ordered differently and that moves a value
# across a rint boundary.  Bar: at least 99.9% of the output elements
# identical, none more than 2 steps of its grid apart; in a block-half
# chain one flipped intermediate reaches a row of the next product and,
# through a key or value, every query of its image, so a chain may differ
# in 1% of its elements, and by up to 4 steps after the residual requant
# (chip_smoke.py).
INT8_SAME = 0.999
INT8_CHAIN_SAME = 0.99
INT8_STEPS = 2
INT8_CHAIN_STEPS = 4


def site_of(t):
    """A site row (scale, zero point, 1) from t's range, as an observer
    that has seen t."""
    from myrtle_vision_tpu_torch.quantize import affine_uint8_qparams

    scale, zp = affine_uint8_qparams(t.min(), t.max())
    return torch.stack([scale, zp, torch.ones_like(scale)])


def close_on_grid(got, ref, step, same=INT8_SAME, steps=INT8_STEPS):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    diff = (got.float() - ref.float()).abs()
    assert float((diff == 0).float().mean()) >= same
    assert float(diff.max()) <= steps * float(step) * (1 + 1e-5)


def int8_block(c, hid, b, n, seed, dev):
    """fp32 x; int8 weights, each the (in, out) view of a torch (out, in)
    tensor, with their scales and column sums; std-1 biases; and the
    sites of both halves, observed on the plain chain's own values."""
    from myrtle_vision_tpu_torch.ops.fused_int8_block import weight_colsum
    from myrtle_vision_tpu_torch.quantize import symmetric_int8_scale

    rng = np.random.RandomState(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * std).astype(np.float32)).to(dev)

    def w8(out_f, in_f):
        w = t(out_f, in_f, std=in_f ** -0.5)
        s = symmetric_int8_scale(w.abs().max())
        q = torch.clamp(torch.round(w / s), -128, 127).to(torch.int8).t()
        return q, s, weight_colsum(q)

    nosite = torch.zeros(3, device=dev)
    heads = max(c // 64, 1)
    x = t(b, n, c)
    x2 = x.view(-1, c)
    ln_a, ln_b = 1 + t(c, std=0.1), t(c, std=0.1)
    wqkv, sqkv, csqkv = w8(3 * c, c)
    bqkv = t(3 * c)
    wout, sout, csout = w8(c, c)
    bout = t(c)
    y = K.layernorm_rows_plain(x2, ln_a, ln_b)
    a_sites = [site_of(y)]
    q8 = K.quantize_i8(y, a_sites[0])
    v = K.gemm_s8_epilogue_plain(q8, wqkv, csqkv, sqkv, a_sites[0], bqkv,
                                 "requant", nosite)
    a_sites.append(site_of(v))
    qkv = K.requant(v, a_sites[1]).view(b, n, 3 * c)
    ctx = K.attention_context_f32(qkv, heads, (c // heads) ** -0.5)
    a_sites.append(site_of(ctx))
    ctx8 = K.quantize_i8(ctx, a_sites[2]).view(-1, c)
    v = K.gemm_s8_epilogue_plain(ctx8, wout, csout, sout, a_sites[2], bout,
                                 "requant", nosite)
    a_sites.append(site_of(v))
    a_sites.append(site_of(K.requant(v, a_sites[3]) + x2))
    attn = [ln_a, ln_b, wqkv, sqkv, bqkv, wout, sout, bout,
            torch.stack(a_sites)]

    ln_a, ln_b = 1 + t(c, std=0.1), t(c, std=0.1)
    w1, s1, cs1 = w8(hid, c)
    b1 = t(hid)
    w2, s2, cs2 = w8(c, hid)
    b2 = t(c)
    y = K.layernorm_rows_plain(x2, ln_a, ln_b)
    m_sites = [site_of(y)]
    v = K.gemm_s8_epilogue_plain(K.quantize_i8(y, m_sites[0]), w1, cs1, s1,
                                 m_sites[0], b1, "requant", nosite)
    m_sites.append(site_of(v))
    g = K.gelu_poly(K.requant(v, m_sites[1]))
    m_sites.append(site_of(g))
    v = K.gemm_s8_epilogue_plain(K.quantize_i8(g, m_sites[2]), w2, cs2, s2,
                                 m_sites[2], b2, "requant", nosite)
    m_sites.append(site_of(v))
    m_sites.append(site_of(K.requant(v, m_sites[3]) + x2))
    mlp = [ln_a, ln_b, w1, s1, b1, w2, s2, b2, torch.stack(m_sites)]
    return x, attn, mlp, ((csqkv, csout), (cs1, cs2))


# (C, hidden, B, N): head widths 64 (C // 64 heads) and 32 (C = 32, one
# head), ragged against the 16-row tiles and the 128-row GEMM tiles
INT8_SHAPES = [(64, 128, 3, 17), (32, 64, 2, 37), (128, 256, 3, 50),
               (384, 1536, 4, 197)]


@pytest.mark.parametrize("c,hid,b,n", INT8_SHAPES)
def test_int8_kernels_match_plain(dev, c, hid, b, n):
    from myrtle_vision_tpu_torch.ops.fused_int8_block import weight_colsum

    x, attn, mlp, _ = int8_block(c, hid, b, n, n + 7, dev)
    heads = max(c // 64, 1)
    x2 = x.view(-1, c)
    ln_a, ln_b, wqkv, sqkv, bqkv, wout, sout, bout, sites = attn
    before = dict(K.LAUNCHES)
    close_on_grid(K.layernorm_quant_rows_cuda(x2, ln_a, ln_b, sites[0]),
                  K.layernorm_quant_rows_plain(x2, ln_a, ln_b, sites[0]), 1)
    q8 = K.layernorm_quant_rows_plain(x2, ln_a, ln_b, sites[0])
    cs = weight_colsum(wqkv)
    args = (q8, wqkv, cs, sqkv, sites[0], bqkv, "requant", sites[1])
    close_on_grid(K.gemm_s8_epilogue_cuda(*args),
                  K.gemm_s8_epilogue_plain(*args), sites[1][0])
    qkv = K.gemm_s8_epilogue_plain(*args).view(b, n, 3 * c)
    scale = (c // heads) ** -0.5
    close_on_grid(K.attention_core_f32_cuda(qkv, heads, scale, sites[2]),
                  K.attention_core_f32_plain(qkv, heads, scale, sites[2]), 1)
    ctx8 = K.attention_core_f32_plain(qkv, heads, scale, sites[2]).view(-1, c)
    args = (ctx8, wout, weight_colsum(wout), sout, sites[2], bout,
            "requant_residual_requant", sites[3], sites[4])
    close_on_grid(K.gemm_s8_epilogue_cuda(*args, residual=x2),
                  K.gemm_s8_epilogue_plain(*args, residual=x2), sites[4][0])
    ln_a, ln_b, w1, s1, b1, w2, s2, b2, sites = mlp
    q8 = K.layernorm_quant_rows_plain(x2, ln_a, ln_b, sites[0])
    args = (q8, w1, weight_colsum(w1), s1, sites[0], b1,
            "requant_gelu_quant", sites[1], sites[2])
    close_on_grid(K.gemm_s8_epilogue_cuda(*args),
                  K.gemm_s8_epilogue_plain(*args), 1)
    assert {k: K.LAUNCHES[k] - before[k] for k in
            ("layernorm_quant_rows", "gemm_s8_epilogue",
             "attention_core_f32")} == {"layernorm_quant_rows": 1,
                                        "gemm_s8_epilogue": 3,
                                        "attention_core_f32": 1}


@pytest.mark.parametrize("c,hid,b,n", INT8_SHAPES)
def test_int8_chains_match_plain(dev, c, hid, b, n):
    from myrtle_vision_tpu_torch.ops.fused_int8_block import (
        int8_attention_block,
        int8_attention_block_plain,
        int8_mlp_block,
        int8_mlp_block_plain,
    )

    x, attn, mlp, colsums = int8_block(c, hid, b, n, n + 8, dev)
    heads = max(c // 64, 1)
    scale = (c // heads) ** -0.5
    before = (int8_attention_block.launches, int8_mlp_block.launches)
    close_on_grid(
        int8_attention_block(x, *attn, heads, scale, colsums=colsums[0]),
        int8_attention_block_plain(x, *attn, heads, scale), attn[-1][4][0],
        INT8_CHAIN_SAME, INT8_CHAIN_STEPS)
    close_on_grid(int8_mlp_block(x, *mlp, colsums=colsums[1]),
                  int8_mlp_block_plain(x, *mlp), mlp[-1][4][0],
                  INT8_CHAIN_SAME, INT8_CHAIN_STEPS)
    assert (int8_attention_block.launches - before[0],
            int8_mlp_block.launches - before[1]) == (1, 1)


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    n = K.attention_core_f32_max_n() + 1
    site = torch.tensor([0.1, 128.0, 1.0], device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        K.attention_core_f32_cuda(torch.zeros(1, n, 3 * 64, device=dev), 1,
                                  0.125, site)
    a = torch.zeros(4, 24, device=dev, dtype=torch.int8)
    w = torch.zeros(8, 24, device=dev, dtype=torch.int8)
    one, col = torch.ones((), device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        K.gemm_s8_epilogue_cuda(a, w.t(), col, one, site, col, "requant",
                                site)
    with pytest.raises(ValueError, match="transpose of a row-major"):
        K.gemm_s8_epilogue_cuda(a[:, :16].contiguous(),
                                w[:, :16].t().contiguous(), col, one, site,
                                col, "requant", site)
    with pytest.raises(TypeError, match="float32"):
        K.layernorm_quant_rows_cuda(a.to(torch.bfloat16), col, col, site)
