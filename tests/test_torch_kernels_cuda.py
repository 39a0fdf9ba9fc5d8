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
from myrtle_vision_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_f32_split_plain,
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
# a head (N < D), ragged against the 16-row tiles, ViT-S/16, the DeiT-S
# student (the distillation token makes 198 tokens), and the widths of
# ViT-Ti/16 and ViT-B/16 (classification/train_configs/
# vit_{tiny,base}.json)
SHAPES = [(64, 2, 128, 3, 17), (64, 2, 128, 3, 50), (128, 2, 256, 3, 17),
          (128, 2, 256, 2, 37), (384, 6, 1536, 4, 197),
          (384, 6, 1536, 4, 198), (192, 3, 768, 2, 197),
          (768, 12, 3072, 2, 197)]


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
    qkv = torch.zeros(1, n, 3 * 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head widths 32 and 64"):
        K.attention_core_bwd_cuda(qkv, torch.zeros(1, n, 48, device=dev),
                                  torch.zeros(1, 1, n, device=dev),
                                  torch.zeros(1, 1, n, device=dev), 1, 0.125)
    q = torch.zeros(1, 2, 40, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head width 48"):
        K.flash_attention_fwd_cuda(q, q, q, 0.125)
    with pytest.raises(ValueError, match="head width 48"):
        K.flash_attention_bwd_cuda(q, q, q, q, q, torch.zeros(
            1, 2, 40, device=dev), 0.125)
    q = torch.zeros(1, 2, 40, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="n_valid 0"):
        K.flash_attention_fwd_cuda(q, q, q, 0.125, n_valid=0)
    with pytest.raises(TypeError, match="bf16"):
        K.flash_attention_fwd_cuda(q.float(), q.float(), q.float(), 0.125)
    lse = torch.zeros(1, 2, 40, device=dev)
    with pytest.raises(ValueError, match="n_valid 41"):
        K.flash_attention_bwd_cuda(q, q, q, q, q, lse, 0.125, n_valid=41)
    with pytest.raises(ValueError, match="share strides"):
        K.flash_attention_bwd_cuda(q, q.transpose(1, 2).contiguous()
                                   .transpose(1, 2), q, q, q, lse, 0.125)
    a = torch.zeros(4, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        K.gemm_bf16_epilogue_cuda(a, torch.zeros_like(a).t(),
                                  torch.zeros(4, device=dev), "bias")
    w = torch.zeros(16, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="b must be row-major"):
        K.gemm_bf16_epilogue_cuda(w[:4, :8].contiguous(), w[:8, ::2],
                                  torch.zeros(16, device=dev), "bias")
    x, attn, _ = block(64, 128, 1, 17, 0, dev)
    # fp32 activations take the fp32 chain since compute_dtype float32
    # was ported; fp16 has no chain
    with pytest.raises(TypeError, match="bf16 or fp32"):
        fused_attention_block(x.half(), *attn, 2, 0.125)


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
    # above the one-CTA kernel's 256 tokens the converted core takes the
    # long route (its int8 mode), which refuses past the longest sequence
    # the fused gate lets through
    n = K.F32_LONG_MAX_N + 1
    site = torch.tensor([0.1, 128.0, 1.0], device=dev)
    with pytest.raises(NotImplementedError, match="fused gate"):
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


# The discrete converted Block (models/vit.py forward_converted_discrete)
# on the card against its plain path: (image size, patch, dim, heads,
# depth, MLP, B, variable): past the fused gate at 16 heads of 4 (485
# tokens) and at ViT-S/16's widths at 448 px (785 tokens), and under
# MVT_INT8_FUSE=0 at 26 tokens
DISCRETE_CASES = [(88, 4, 64, 16, 2, 128, 2, None),
                  (448, 16, 384, 6, 1, 1536, 2, None),
                  (80, 16, 64, 1, 2, 128, 3, "MVT_INT8_FUSE")]


@pytest.mark.parametrize("fresh", [False, True], ids=["calibrated",
                                                      "quant_out fresh"])
@pytest.mark.parametrize("size,patch,dim,heads,depth,mlp,b,env",
                         DISCRETE_CASES)
def test_discrete_converted_block_matches_plain(dev, monkeypatch, size, patch,
                                                dim, heads, depth, mlp, b,
                                                env, fresh):
    """Each block of a converted model calibrated on the card, kernel path
    (``gemm_s8_epilogue``, ``layernorm_quant_rows``) against plain path on
    the same input, under the INT8 chain bar (99% identical, 4 steps of
    the res_add grid), the logits likewise; launches: 2 LayerNorms and 4
    products a block (to_out's product the fallback where quant_out has
    no statistics), no fused op, no attention kernel."""
    from myrtle_vision_tpu_torch.ops.fused_int8_block import (
        int8_attention_block,
    )
    from myrtle_vision_tpu_torch.quantize import convert_params

    if env:
        monkeypatch.setenv(env, "0")
    kw = dict(decoder="classification", image_size=size, patch_size=patch,
              num_classes=10, dim=dim, depth=depth, heads=heads, mlp_dim=mlp,
              dim_head=dim // heads, q_format="PyTorchINT8", device=dev)
    gen = torch.Generator(dev).manual_seed(size + dim)
    imgs = torch.randn(b, size, size, 3, device=dev, generator=gen)
    model = ViT(**kw)
    with torch.no_grad():
        model(imgs, calibrating=True)
    sd = convert_params(model.state_dict(), "PyTorchINT8")
    if fresh:
        sd["transformer.layers.0.0.fn.fn.quant_out.min"].fill_(float("inf"))
        sd["transformer.layers.0.0.fn.fn.quant_out.max"].fill_(-float("inf"))
    conv = ViT(**kw, converted=True)
    conv.load_state_dict(sd, strict=True)
    before = dict(K.LAUNCHES), int8_attention_block.launches
    with torch.inference_mode():
        x = conv.embed_converted(imgs, K.PLAIN)
        for block, sites in zip(conv.transformer.layers, conv.block_sites):
            got = block.forward_converted(x, sites)
            x = block.forward_converted(x, sites, plain=True)
            close_on_grid(got, x, sites[1][4][0], INT8_CHAIN_SAME,
                          INT8_CHAIN_STEPS)
        moved = {k: K.LAUNCHES[k] - before[0][k] for k in K.LAUNCHES}
        assert {k: v for k, v in moved.items() if v} == {
            "layernorm_quant_rows": 2 * depth,
            "gemm_s8_epilogue": 4 * depth - fresh}
        assert int8_attention_block.launches == before[1]
        close_on_grid(conv(imgs), conv(imgs, plain=True), conv.io_sites[3][0],
                      INT8_CHAIN_SAME, INT8_CHAIN_STEPS)


# flash_attention_fwd: the detection eval's K6 regime (800 px, 2601
# tokens), the K5 regime (512 px, 1125 tokens), a ragged head-32 case
# with masked keys; each against its plain version in that regime
FLASH = [(8, 6, 2601, 64, None), (8, 6, 1125, 64, None), (3, 2, 50, 32, 40),
         (2, 3, 130, 64, 129)]


@pytest.mark.parametrize("b,h,n,d,n_valid", FLASH)
def test_flash_attention_matches_plain(dev, b, h, n, d, n_valid):
    gen = torch.Generator(dev).manual_seed(n)
    q, k, v = (torch.randn(b, h, n, d, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(3))
    before = K.LAUNCHES["flash_attention_fwd"]
    got = K.flash_attention_fwd_cuda(q, k, v, d ** -0.5, n_valid, lse=True)
    assert K.LAUNCHES["flash_attention_fwd"] == before + 1
    ref = flash_attention_plain(q, k, v, d ** -0.5, n_valid, lse=True)
    close(got[0], ref[0])
    close(got[1], ref[1])


def test_flash_attention_reads_qkv_rows_in_place(dev):
    """The (B, H, N, D) views of fused (B, N, 3C) rows, as the discrete
    Block passes them, give what contiguous copies give."""
    b, n, h, d = 2, 301, 6, 64
    qkv = torch.randn(b, n, 3 * h * d, device=dev).to(torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    got = flash_attention(q, k, v, 0.125)
    assert got.shape == (b, h, n, d)
    ref = K.flash_attention_fwd_cuda(q.contiguous(), k.contiguous(),
                                     v.contiguous(), 0.125)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("b,n,d", [(2, 257, 64), (3, 300, 32), (2, 677, 64)])
def test_long_attention_core_matches_plain(dev, b, n, d):
    heads = 2
    gen = torch.Generator(dev).manual_seed(n)
    qkv = torch.randn(b, n, 3 * heads * d, device=dev,
                      generator=gen).to(torch.bfloat16)
    got = K.attention_core_cuda(qkv, heads, d ** -0.5, stats=True)
    ref = K.attention_core_plain(qkv, heads, d ** -0.5, stats=True)
    for g, r in zip(got, ref):
        close(g, r)


@pytest.mark.parametrize("n", [297, 677])
def test_long_attention_chain_matches_plain(dev, n):
    """YOLOS-S at 224 and 384 px: sequences the JAX gate fuses."""
    x, attn, _ = block(384, 1536, 4, n, n, dev)
    close(fused_attention_block(x, *attn, 6, 0.125),
          fused_attention_block_plain(x, *attn, 6, 0.125), CHAIN_ATOL)


def test_detection_model_runs_through_the_flash_kernel(dev, monkeypatch):
    """A tiny detection ViT with the fused gate forced off: the flash
    kernel once per block, outputs near the plain path's."""
    from myrtle_vision_tpu_torch.models import vit

    monkeypatch.setattr(vit, "fuses_at", lambda n, h, d: False)
    model = ViT(decoder="detection", image_size=160, patch_size=16,
                num_classes=3, dim=128, depth=3, heads=2, mlp_dim=256,
                num_det_tokens=10, device=dev).eval()
    img = torch.from_numpy(
        np.random.RandomState(0).uniform(-1, 1, (2, 160, 160, 3)).astype(
            np.float32)).to(dev)
    before = K.LAUNCHES["flash_attention_fwd"]
    with torch.inference_mode():
        out = model(img)
        ref = model(img, plain=True)
    assert K.LAUNCHES["flash_attention_fwd"] == before + 3
    for key in ("pred_logits", "pred_boxes"):
        assert out[key].shape == ref[key].shape
        torch.testing.assert_close(out[key], ref[key], rtol=RTOL,
                                   atol=CHAIN_ATOL)


def flash_case(b, h, n, d, seed, dev):
    """q, k, v and an output gradient, std 1, bf16, from a seed."""
    gen = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(b, h, n, d, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(4)]


# flash_attention_bwd: YOLOS-S training at 400 px (726 tokens, the K8
# regime) and 608 px (1545, n_pad 1664: K7), a ragged head-32 case with
# masked keys and rows, and one masked just past a 128 multiple
FLASH_BWD = [(2, 6, 726, 64, None), (2, 6, 1545, 64, None),
             (3, 2, 50, 32, 40), (2, 3, 130, 64, 129)]


@pytest.mark.parametrize("b,h,n,d,n_valid", FLASH_BWD)
def test_flash_attention_backward_matches_plain(dev, b, h, n, d, n_valid):
    """The kernel from the kernel forward's residuals against the plain
    backward from the plain forward's, each in its own regime: dq per
    element under the chain bar, dk and dv (sums over the queries) under
    the sum bar; zero rows past n_valid."""
    q, k, v, do = flash_case(b, h, n, d, n, dev)
    sc = d ** -0.5
    o, lse = K.flash_attention_fwd_cuda(q, k, v, sc, n_valid, lse=True)
    before = K.LAUNCHES["flash_attention_bwd"]
    got = K.flash_attention_bwd_cuda(q, k, v, o, do, lse, sc, n_valid)
    assert K.LAUNCHES["flash_attention_bwd"] == before + 3
    o_p, lse_p = flash_attention_plain(q, k, v, sc, n_valid, lse=True)
    ref = flash_attention_bwd_plain(q, k, v, o_p, do, lse_p, sc, n_valid)
    close(got[0], ref[0], CHAIN_ATOL)
    for g, r in zip(got[1:], ref[1:]):
        close(g, r, SUM_ATOL * max(1.0, float(r.float().abs().max())))
    if n_valid is not None:
        for g in got:
            assert not g[:, :, n_valid:].any()


# the wgmma flash kernels' tile edges (128-row CTAs, 128-key forward tiles,
# 64-row backward tiles): both head widths, 2 and 6 heads, every key valid
# or the last third masked, q, k and v the in-place (B, H, N, D) views of
# fused (B, N, 3 H D) qkv rows, as the discrete Block hands them over
FLASH_EDGE_N = [1, 63, 64, 65, 127, 128, 129, 1125, 1536, 1537, 2601]
FLASH_BWD_EDGE_N = [1, 65, 129, 726, 1470, 1545, 2495]


def qkv_views(b, n, h, d, seed, dev):
    """q, k, v: views of fused bf16 qkv rows, std 1, from a seed."""
    gen = torch.Generator(dev).manual_seed(seed)
    rows = torch.randn(b, n, 3 * h * d, device=dev, generator=gen).to(
        torch.bfloat16)
    return rows.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)


def edge_n_valid(n, masked):
    return max(1, n - n // 3) if masked else None


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h", [2, 6])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", FLASH_EDGE_N)
def test_wgmma_flash_forward_tile_edges(dev, n, d, h, masked):
    """Output and LSE against the plain version in its regime under the
    one-kernel bar; one launch a call."""
    q, k, v = qkv_views(2, n, h, d, n * d + h, dev)
    n_valid = edge_n_valid(n, masked)
    before = K.LAUNCHES["flash_attention_fwd"]
    got = K.flash_attention_fwd_cuda(q, k, v, d ** -0.5, n_valid, lse=True)
    assert K.LAUNCHES["flash_attention_fwd"] == before + 1
    ref = flash_attention_plain(q, k, v, d ** -0.5, n_valid, lse=True)
    close(got[0], ref[0])
    close(got[1], ref[1])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h", [2, 6])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", FLASH_BWD_EDGE_N)
def test_wgmma_flash_backward_tile_edges(dev, n, d, h, masked):
    """The backward kernel against the plain backward in its regime, both
    from the kernel forward's residuals (o and the LSE; the forward is
    held by the test above): dq under the chain bar, dk and dv under the
    sum bar, zero rows past n_valid; three launches a call.  o is the
    forward's (B, N, H, D)-storage view, do a contiguous tensor: both read
    through strides of their own.  (Each backward from its own forward,
    as test_flash_attention_backward_matches_plain holds it, carries the
    forward's roundings into dsum: at N 65, D 64, 6 heads one dk element
    then passes the sum bar, with this kernel and with the mma.sync
    kernel it replaced alike.)"""
    q, k, v = qkv_views(2, n, h, d, n * d + h + 1, dev)
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(
        dev).manual_seed(n + 3)).to(torch.bfloat16)
    n_valid, sc = edge_n_valid(n, masked), d ** -0.5
    o, lse = K.flash_attention_fwd_cuda(q, k, v, sc, n_valid, lse=True)
    before = K.LAUNCHES["flash_attention_bwd"]
    got = K.flash_attention_bwd_cuda(q, k, v, o, do, lse, sc, n_valid)
    assert K.LAUNCHES["flash_attention_bwd"] == before + 3
    ref = flash_attention_bwd_plain(q, k, v, o, do, lse, sc, n_valid)
    close(got[0], ref[0], CHAIN_ATOL)
    for g, r in zip(got[1:], ref[1:]):
        close(g, r, SUM_ATOL * max(1.0, float(r.float().abs().max())))
    if n_valid is not None:
        for g in got:
            assert not g[:, :, n_valid:].any()


def test_wgmma_flash_forward_is_deterministic(dev):
    """Two launches on the same inputs give the same bits."""
    q, k, v = qkv_views(2, 1545, 6, 64, 11, dev)
    first = K.flash_attention_fwd_cuda(q, k, v, 0.125, 1500, lse=True)
    again = K.flash_attention_fwd_cuda(q, k, v, 0.125, 1500, lse=True)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0])
    assert torch.equal(first[1], again[1])


def test_wgmma_flash_backward_is_deterministic(dev):
    """No atomics and a fixed summation order: two launches give the same
    bits."""
    q, k, v = qkv_views(2, 1545, 6, 64, 12, dev)
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(
        dev).manual_seed(13)).to(torch.bfloat16)
    o, lse = K.flash_attention_fwd_cuda(q, k, v, 0.125, 1500, lse=True)
    first = K.flash_attention_bwd_cuda(q, k, v, o, do, lse, 0.125, 1500)
    again = K.flash_attention_bwd_cuda(q, k, v, o, do, lse, 0.125, 1500)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_launches_match_the_plan(dev):
    """The kernels' own figures (grid, rows, tiles, threads, stages,
    shared memory, and the runtime's occupancy of the compiled kernels)
    and launches against flash_plan."""
    for n in (1, 63, 128, 129, 1125, 1545, 2601, 4096):
        for d in (32, 64):
            plan = K.flash_plan(n, d)
            got = K.flash_launch(n, d)
            for key in ("fwd", "dkdv", "dq"):
                want = {f: v for f, v in plan[key].items() if f != "walk"}
                assert got[key] == want, (n, d, key)
            assert got["launches"] == plan["launches"]


def test_flash_gradient_through_the_qkv_rows(dev):
    """The autograd node on the card: gradients of the (B, H, N, D) views
    of fused qkv rows, as the discrete Block takes them, from a sum (an
    expanded upstream gradient), against the node's plain side."""
    b, n, h, d = 2, 301, 6, 64
    gen = torch.Generator(dev).manual_seed(5)
    rows = torch.randn(b, n, 3 * h * d, device=dev, generator=gen).to(
        torch.bfloat16)
    grads = []
    for plain in (False, True):
        qkv = rows.clone().requires_grad_()
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        before = K.LAUNCHES["flash_attention_bwd"]
        flash_attention(q, k, v, 0.125, plain=plain).float().sum().backward()
        assert K.LAUNCHES["flash_attention_bwd"] - before == (0 if plain
                                                              else 3)
        grads.append(qkv.grad)
    close(grads[0], grads[1], CHAIN_ATOL)


@pytest.mark.parametrize("b,n,d", [(2, 257, 64), (3, 300, 32), (2, 677, 64)])
def test_long_attention_core_backward_matches_plain(dev, b, n, d):
    """The KV-tiled core backward (four launches) from the plain forward's
    statistics against the plain backward."""
    heads = 2
    gen = torch.Generator(dev).manual_seed(n + 1)
    qkv = torch.randn(b, n, 3 * heads * d, device=dev,
                      generator=gen).to(torch.bfloat16)
    _, m, rs = K.attention_core_plain(qkv, heads, d ** -0.5, stats=True)
    d_o = torch.randn(b, n, heads * d, device=dev, generator=gen)
    before = K.LAUNCHES["attention_core_bwd"]
    got = K.attention_core_bwd_cuda(qkv, d_o, m, rs, heads, d ** -0.5)
    assert K.LAUNCHES["attention_core_bwd"] == before + 4
    want = K.attention_core_bwd_plain(qkv, d_o, m, rs, heads, d ** -0.5)
    close(got[0], want[0], CHAIN_ATOL)
    close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))


@pytest.mark.parametrize("n", [357, 677])
def test_long_attention_backward_matches_plain(dev, n):
    """YOLOS-S training at 256 and 384 px: the fused backward chain above
    256 tokens, each path from its own forward."""
    x, attn, _ = block(384, 1536, 4, n, n + 5, dev)
    do = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(n)).to(x.dtype)
    got = grads_of(fused_attention_block, x, attn, (6, 0.125), do)
    ref = grads_of(fused_attention_block_plain, x, attn, (6, 0.125), do)
    close_grads(got, ref, ["x", "scale", "bias", "wqkv", "bqkv", "wp", "bp"])


def test_detection_model_trains_through_the_flash_kernels(dev, monkeypatch):
    """A tiny detection ViT with the fused gate forced off: the flash
    forward and backward once per block, gradients near the plain
    path's."""
    from myrtle_vision_tpu_torch.models import vit

    monkeypatch.setattr(vit, "fuses_at", lambda n, h, d: False)
    model = ViT(decoder="detection", image_size=160, patch_size=16,
                num_classes=3, dim=128, depth=3, heads=2, mlp_dim=256,
                num_det_tokens=10, device=dev)
    img = torch.from_numpy(
        np.random.RandomState(2).uniform(-1, 1, (2, 160, 160, 3)).astype(
            np.float32)).to(dev)
    grads = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        before = K.LAUNCHES["flash_attention_bwd"]
        out = model(img, plain=plain)
        (out["pred_logits"].square().mean()
         + out["pred_boxes"].mean()).backward()
        assert K.LAUNCHES["flash_attention_bwd"] - before == (0 if plain
                                                              else 9)
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
    for name, ref in grads[1].items():
        rel = float((grads[0][name] - ref).norm() / ref.norm().clamp_min(
            1e-30))
        assert rel <= 2.0 ** -4, name


# ------------------------------------------------------ float formats
# K11 (fake_quant_rows) is bit-identical to its plain version, fp32
# subnormals included.  The float-format chain kernels snap with the same
# code as their plain versions at the same points; they differ only where
# an fp32 sum is ordered differently, which is fp32 noise (2^-16 of the
# output's largest magnitude) unless it moves a value across a snap's
# rounding boundary: that element is then a step of the format away, two
# where an epilogue snaps twice in series (FP16_16's GELU input and
# output, its projection before the residual add and the sum), at the
# larger magnitude of the two.  At most 0.2% of a kernel's elements, 5% of
# a chain's, whose flipped elements reach the rows of the products after
# them (chip_smoke.py).
FLOAT_TIGHT = 2.0 ** -16
FLOAT_QSPECS = [(5, 10, True), (5, 10, False), (8, 10, False)]


def format_step(v, qspec):
    exp_bits, man_bits, _ = qspec
    min_exp = 2 - 2 ** (exp_bits - 1)
    return torch.exp2(torch.floor(torch.log2(
        v.abs().clamp_min(2.0 ** min_exp))) - man_bits)


def close_float(got, ref, qspec, first=None, chain=False):
    """``first``: the first of two snapped values in series (the GELU's
    input, the projection a residual sum adds), or None."""
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.float32
    g, r = got.double(), ref.double()
    diff = (g - r).abs()
    largest = float(r.abs().max())
    beyond = diff > FLOAT_TIGHT * largest
    if chain:
        assert float(beyond.double().mean()) <= 0.05
        assert float(diff.max()) <= FLOAT_TIGHT * largest + float(
            format_step(torch.tensor(largest), qspec))
        return
    assert float(beyond.double().mean()) <= 2e-3
    at, steps = r.abs(), 1
    if first is not None:
        at, steps = torch.maximum(at, first.double().abs()), 2
    assert bool((diff[beyond] <= steps * format_step(at[beyond], qspec)).all())


def fake_quant_values(n, dev):
    """Magnitudes 2^-149 (fp32 subnormals) to 2^24, either sign, led by
    halfway ties of the fp16 / TF32 mantissas, the fp16 subnormal quantum
    and the fixed-point quanta, saturation and signed zeros."""
    gen = torch.Generator(dev).manual_seed(5)
    x = torch.exp2(torch.rand(n, device=dev, generator=gen) * 173 - 149) * (
        torch.randint(0, 2, (n,), device=dev, generator=gen) * 2 - 1)
    k = torch.arange(-300, 300, device=dev, dtype=torch.float64) + 0.5
    special = torch.cat([
        k * 2.0 ** -10, k * 2.0 ** -24, k * 2.0 ** -9, k * 2.0 ** -8,
        k * 2.0 ** -7, torch.tensor([0.0, -0.0, 65504.0, 65519.0, 65520.0,
                                     -65520.0, 3.4e38, 2.0 ** -149],
                                    device=dev, dtype=torch.float64)])
    x[:special.numel()] = special.float()
    return x


@pytest.mark.parametrize("mode,a,b", [("float", 5, 10), ("float", 8, 10),
                                      ("fixed", 11, 9), ("fixed", 11, 8),
                                      ("fixed", 11, 7)])
def test_fake_quant_rows_matches_plain(dev, mode, a, b):
    x = fake_quant_values(2 ** 20 + 7, dev)
    before = K.LAUNCHES["fake_quant_rows"]
    for t in (x, x[1:], x[3:1002].view(3, -1)):  # vectors, scalars, shapes
        got = K.fake_quant_rows_cuda(t, mode, a, b)
        torch.cuda.synchronize()
        assert got.shape == t.shape
        assert torch.equal(got.view(torch.int32),
                           K.fake_quant_rows_plain(t, mode, a, b).view(
                               torch.int32))
    assert K.LAUNCHES["fake_quant_rows"] == before + 3
    if (mode, a, b) == ("float", 5, 10):
        half = x.clamp(-65504, 65504).half().float()
        assert torch.equal(K.fake_quant_rows_cuda(x, mode, a, b).view(
            torch.int32), half.view(torch.int32))


def float_block(c, hid, b, n, seed, dev, qspec):
    """fp32 x; both halves' parameters with the weights through the
    format's fake-quant, each the (in, out) view of a torch (out, in)
    tensor; std-1 biases."""
    from myrtle_vision_tpu_torch.ops.fake_quant import float_quantize

    rng = np.random.RandomState(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * std).astype(np.float32)).to(dev)

    def w(out_f, in_f):
        return float_quantize(t(out_f, in_f, std=in_f ** -0.5), qspec[0],
                              qspec[1]).t()

    x = t(b, n, c)
    attn = [1 + t(c, std=0.1), t(c, std=0.1), w(3 * c, c), t(3 * c),
            w(c, c), t(c)]
    mlp = [1 + t(c, std=0.1), t(c, std=0.1), w(hid, c), t(hid), w(c, hid),
           t(c)]
    return x, attn, mlp


# (C, hidden, B, N): head widths 32 and 64, ragged against the tiles,
# ViT-S/16, and a length past the 224 tokens up to which the fp32 core's
# backward runs eight warps (four above)
FLOAT_SHAPES = [(64, 128, 3, 17), (32, 64, 2, 37), (128, 256, 3, 50),
                (384, 1536, 4, 197), (128, 256, 2, 250)]


@pytest.mark.parametrize("qspec", FLOAT_QSPECS)
@pytest.mark.parametrize("c,hid,b,n", FLOAT_SHAPES)
def test_float_kernels_match_plain(dev, c, hid, b, n, qspec):
    x, attn, mlp = float_block(c, hid, b, n, n + 9, dev, qspec)
    heads = max(c // 64, 1)
    scale = (c // heads) ** -0.5
    x2 = x.view(-1, c)
    before = dict(K.LAUNCHES)
    close_float(K.layernorm_snap_rows_cuda(x2, attn[0], attn[1], qspec),
                K.layernorm_snap_rows_plain(x2, attn[0], attn[1], qspec),
                qspec)
    xn = K.layernorm_snap_rows_plain(x2, attn[0], attn[1], qspec)
    args = (xn, attn[2], attn[3], "bias_snap", qspec)
    close_float(K.gemm_f32x3_epilogue_cuda(*args),
                K.gemm_f32x3_epilogue_plain(*args), qspec)
    qkv = K.gemm_f32x3_epilogue_plain(*args).view(b, n, 3 * c)
    close_float(K.attention_core_snap_cuda(qkv, heads, scale, qspec),
                K.attention_core_snap_plain(qkv, heads, scale, qspec), qspec)
    ctx = K.attention_core_snap_plain(qkv, heads, scale, qspec).view(-1, c)
    args = (ctx, attn[4], attn[5], "bias_snap_residual_snap", qspec)
    ref = K.gemm_f32x3_epilogue_plain(*args, residual=x2)
    close_float(K.gemm_f32x3_epilogue_cuda(*args, residual=x2), ref, qspec,
                first=ref - x2)
    args = (xn, mlp[2], mlp[3], "bias_snap_gelu_snap", qspec)
    close_float(K.gemm_f32x3_epilogue_cuda(*args),
                K.gemm_f32x3_epilogue_plain(*args), qspec,
                first=K.gemm_f32x3_epilogue_plain(xn, mlp[2], mlp[3],
                                                  "bias_snap", qspec))
    assert {k: K.LAUNCHES[k] - before[k] for k in
            ("layernorm_snap_rows", "gemm_f32x3_epilogue",
             "attention_core_f32")} == {"layernorm_snap_rows": 1,
                                        "gemm_f32x3_epilogue": 3,
                                        "attention_core_f32": 1}


@pytest.mark.parametrize("qspec", FLOAT_QSPECS)
@pytest.mark.parametrize("c,hid,b,n", FLOAT_SHAPES)
def test_float_chains_match_plain(dev, c, hid, b, n, qspec):
    x, attn, mlp = float_block(c, hid, b, n, n + 10, dev, qspec)
    heads = max(c // 64, 1)
    scale = (c // heads) ** -0.5
    before = (fused_attention_block.launches, fused_mlp_block.launches)
    close_float(fused_attention_block(x, *attn, heads, scale, qspec=qspec),
                fused_attention_block_plain(x, *attn, heads, scale,
                                            qspec=qspec), qspec, chain=True)
    close_float(fused_mlp_block(x, *mlp, qspec=qspec),
                fused_mlp_block_plain(x, *mlp, qspec=qspec), qspec,
                chain=True)
    assert (fused_attention_block.launches - before[0],
            fused_mlp_block.launches - before[1]) == (1, 1)


def test_float_kernels_refuse_what_they_do_not_take(dev):
    qspec = (5, 10, False)
    n = K.F32_LONG_MAX_N + 1
    with pytest.raises(NotImplementedError, match="fused gate"):
        K.attention_core_snap_cuda(torch.zeros(1, n, 3 * 64, device=dev), 1,
                                   0.125, qspec)
    a = torch.zeros(4, 6, device=dev)
    w = torch.zeros(8, 6, device=dev)
    bias = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        K.gemm_f32x3_epilogue_cuda(a, w.t(), bias, "bias_snap", qspec)
    with pytest.raises(ValueError, match="transpose of a row-major"):
        K.gemm_f32x3_epilogue_cuda(a[:, :4].contiguous(),
                                   w[:, :4].t().contiguous(), bias,
                                   "bias_snap", qspec)
    with pytest.raises(TypeError, match="fp32"):
        K.fake_quant_rows_cuda(a.to(torch.bfloat16), "float", 5, 10)
    with pytest.raises(ValueError, match="row-major w"):
        K.gemm_f32x3_epilogue_cuda(a[:, :4].contiguous(),
                                   w[:, :4].contiguous().t(), None, "f32",
                                   qspec)
    with pytest.raises(ValueError, match="transposed `a`"):
        K.gemm_f32x3_epilogue_cuda(a.t(), a, bias[:6], "bias_snap", qspec)
    with pytest.raises(NotImplementedError, match="fused gate"):
        K.attention_core_f32_bwd_cuda(
            torch.zeros(1, n, 3 * 64, device=dev), torch.zeros(
                1, n, 64, device=dev), *[torch.zeros(1, 1, n, device=dev)] * 2,
            1, 0.125)
    # a qspec op that records now runs its backward (QAT) on the card
    x = torch.zeros(2, 3, 64, device=dev, requires_grad=True)
    before = fused_mlp_block.bwd_launches
    fused_mlp_block(x, *[torch.ones(64, device=dev)] * 2,
                    torch.zeros(128, 64, device=dev).t(), bias.new_zeros(128),
                    torch.zeros(64, 128, device=dev).t(),
                    torch.zeros(64, device=dev), qspec=qspec).sum().backward()
    torch.cuda.synchronize()
    assert fused_mlp_block.bwd_launches == before + 1
    assert torch.equal(x.grad, torch.ones_like(x))  # the residual alone


@pytest.mark.parametrize("q_format", ["FP16_16", "FP16_32", "TF32"])
def test_float_model_runs_through_the_kernels(dev, q_format):
    from myrtle_vision_tpu_torch.ops import fused_mlp

    depth = 2
    model = ViT("classification", 224, 16, 10, 128, depth, 2, 256,
                q_format=q_format, converted=True, device=dev).eval()
    img = torch.randn(3, 224, 224, 3, device=dev,
                      generator=torch.Generator(dev).manual_seed(0))
    K.reset_launches()
    before = (fused_attention_block.launches,
              fused_mlp.fused_mlp_block.launches)
    with torch.inference_mode():
        out = model(img)
        ref = model(img, plain=True)
    torch.cuda.synchronize()
    assert (fused_attention_block.launches - before[0],
            fused_mlp.fused_mlp_block.launches - before[1]) == (depth, depth)
    assert K.LAUNCHES["layernorm_snap_rows"] == 2 * depth
    assert K.LAUNCHES["gemm_f32x3_epilogue"] == 4 * depth
    assert K.LAUNCHES["attention_core_f32"] == depth
    # the sites outside the blocks and every weight's fake-quant
    assert K.LAUNCHES["fake_quant_rows"] >= 6 * depth + 6
    assert out.shape == (3, 10) and bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 2.0 ** -6 * max(
        1.0, float(ref.abs().max()))


@pytest.mark.parametrize("qspec", FLOAT_QSPECS)
@pytest.mark.parametrize("c,hid,b,n", FLOAT_SHAPES)
def test_float_backward_kernels_match_plain(dev, c, hid, b, n, qspec):
    """Each kernel of the qspec backward chains (K2 and K4 with qspec)
    against its plain version at the main path's operand layouts: the
    fp32 bars of the FP32 backward (the outputs are unsnapped gradients),
    the float bar for the snapped GELU output."""
    x, attn, mlp = float_block(c, hid, b, n, n + 19, dev, qspec)
    heads = max(c // 64, 1)
    scale = (c // heads) ** -0.5
    x2 = x.view(-1, c)
    do2 = torch.randn(x2.shape, device=dev,
                      generator=torch.Generator(dev).manual_seed(n))
    before = dict(K.LAUNCHES)
    xn = K.layernorm_snap_rows_plain(x2, attn[0], attn[1], qspec)
    qkv = K.gemm_f32x3_epilogue_plain(xn, attn[2], attn[3], "bias_snap",
                                      qspec).view(b, n, 3 * c)
    got = K.attention_core_snap_cuda(qkv, heads, scale, qspec, stats=True)
    ref = K.attention_core_snap_plain(qkv, heads, scale, qspec, stats=True)
    close_float(got[0], ref[0], qspec)
    close(got[1], ref[1])
    close(got[2], ref[2])
    ctx, m, rs = ref
    wp_t = attn[4].t()  # the torch (out, in) weight as it is stored
    assert wp_t.is_contiguous()
    d_o = K.gemm_f32x3_epilogue_plain(do2, wp_t, None, "f32", qspec)
    close(K.gemm_f32x3_epilogue_cuda(do2, wp_t, None, "f32", qspec), d_o)
    got = K.attention_core_f32_bwd_cuda(qkv, d_o.view(b, n, c), m, rs,
                                        heads, scale)
    want = K.attention_core_f32_bwd_plain(qkv, d_o.view(b, n, c), m, rs,
                                          heads, scale)
    close(got[0], want[0], CHAIN_ATOL)
    close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))
    dqkv = want[0].view(-1, 3 * c)
    for a, w in ((do2.t(), ctx.view(-1, c)), (dqkv.t(), xn)):
        want = K.gemm_f32x3_epilogue_plain(a, w, None, "f32", qspec)
        close(K.gemm_f32x3_epilogue_cuda(a, w, None, "f32", qspec), want,
              SUM_ATOL * float(want.abs().max()))
    args = (xn, mlp[2], mlp[3], "bias_snap_gelu_snap_grad", qspec)
    got, want = K.gemm_f32x3_epilogue_cuda(*args), \
        K.gemm_f32x3_epilogue_plain(*args)
    close_float(got[0], want[0], qspec,
                first=K.gemm_f32x3_epilogue_plain(xn, mlp[2], mlp[3],
                                                  "bias_snap", qspec))
    close(got[1], want[1])
    gp = want[1]
    w2_t = mlp[4].t()
    got = K.gemm_f32x3_epilogue_cuda(do2, w2_t, None, "mul_aux", qspec,
                                     aux=gp)
    want = K.gemm_f32x3_epilogue_plain(do2, w2_t, None, "mul_aux", qspec,
                                       aux=gp)
    close(got[0], want[0])
    close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))
    dxn = K.gemm_f32x3_epilogue_plain(want[0], mlp[2].t(), None, "f32", qspec)
    got = K.layernorm_rows_bwd_cuda(x2, attn[0], dxn, do2, qspec)
    want = K.layernorm_rows_bwd_plain(x2, attn[0], dxn, do2, qspec)
    close(got[0], want[0])
    for g, r in zip(got[1:], want[1:]):
        close(g, r, SUM_ATOL * float(r.abs().max()))
    launched = {k: K.LAUNCHES[k] - before[k] for k in
                ("attention_core_f32", "attention_core_f32_bwd",
                 "layernorm_snap_rows_bwd")}
    assert launched == {"attention_core_f32": 1, "attention_core_f32_bwd": 1,
                        "layernorm_snap_rows_bwd": 1}


@pytest.mark.parametrize("save", ["0", "1"])
@pytest.mark.parametrize("qspec", FLOAT_QSPECS)
@pytest.mark.parametrize("c,hid,b,n", FLOAT_SHAPES)
def test_float_backward_chains_match_plain(dev, c, hid, b, n, qspec, save,
                                           monkeypatch):
    monkeypatch.setenv("MVT_SAVE_ACTS", save)
    x, attn, mlp = float_block(c, hid, b, n, n + 29, dev, qspec)
    heads = max(c // 64, 1)
    extra = (heads, (c // heads) ** -0.5)
    do = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(n))

    def with_q(op):
        def run(*args):
            return op(*args, qspec=qspec)
        return run

    before = (fused_attention_block.bwd_launches,
              fused_mlp_block.bwd_launches)
    got = grads_of(with_q(fused_attention_block), x, attn, extra, do)
    ref = grads_of(with_q(fused_attention_block_plain), x, attn, extra, do)
    close_grads(got, ref, ["x", "scale", "bias", "wqkv", "bqkv", "wp", "bp"])
    got = grads_of(with_q(fused_mlp_block), x, mlp, (), do)
    ref = grads_of(with_q(fused_mlp_block_plain), x, mlp, (), do)
    close_grads(got, ref, ["x", "scale", "bias", "w1", "b1", "w2", "b2"])
    assert (fused_attention_block.bwd_launches - before[0],
            fused_mlp_block.bwd_launches - before[1]) == (1, 1)


@pytest.mark.parametrize("q_format", ["FP16_16", "FP16_32", "TF32"])
def test_float_model_trains_through_the_kernels(dev, q_format):
    """One QAT step of a small float-format ViT through the kernels: the
    backward chains launch once per block half, the fake-quant of the
    weights and sites run K11, and the gradients agree with the plain
    path's (relative L2 2^-4, chip_smoke.py's first-step bar)."""
    from myrtle_vision_tpu_torch.training.optim import cross_entropy_loss

    depth = 2
    model = ViT("classification", 224, 16, 10, 128, depth, 2, 256,
                q_format=q_format, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    img = torch.randn(4, 224, 224, 3, device=dev, generator=gen)
    labels = torch.randint(0, 10, (4,), device=dev, generator=gen)
    runs = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        K.reset_launches()
        before = fused_attention_block.bwd_launches
        loss = cross_entropy_loss(model(img, plain=plain), labels)
        loss.backward()
        torch.cuda.synchronize()
        if not plain:
            assert fused_attention_block.bwd_launches - before == depth
            assert K.LAUNCHES["attention_core_f32_bwd"] == depth
            assert K.LAUNCHES["layernorm_snap_rows_bwd"] == 2 * depth
            assert K.LAUNCHES["fake_quant_rows"] >= 4 * depth + 2
        runs.append((float(loss), {n: p.grad.clone()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None}))
    (k_loss, k_grads), (p_loss, p_grads) = runs
    assert abs(k_loss - p_loss) <= 2.0 ** -6 * max(1.0, abs(p_loss))
    for name, ref in p_grads.items():
        got = k_grads[name]
        assert bool(torch.isfinite(got).all()), name
        assert float((got - ref).norm() / ref.norm().clamp_min(1e-30)) <= \
            2.0 ** -4, name


# ------------------------------------------------------- INT8 QAT
# The two-pass INT8 QAT chains (K1-K4 with qspec "int8"): the float
# chains' kernels with PyTorchINT8's frozen observer sites in place of the
# float snaps.  Kernel and plain version run the same fp32 operations and
# snap with bit-identical code, so they differ by fp32 noise (FLOAT_TIGHT
# of the largest magnitude) unless a sum-order difference moves a value
# across a site's rint edge, which moves it a whole step of the site's
# grid (its scale).  Bars (chip_smoke.py): a snapped output at least
# 99.8% within the noise and every element within one step of its site; a
# block-half chain 99% and 4 steps of the output's site; the unsnapped
# outputs (the gradients) the FP32 bars.
I8_SAME = 0.998
I8_CHAIN_SAME = 0.99
I8_CHAIN_STEPS = 4


def close_sites(got, ref, step, same=I8_SAME, steps=1):
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.float32
    diff = (got.double() - ref.double()).abs()
    tight = FLOAT_TIGHT * float(ref.abs().max())
    assert float((diff > tight).double().mean()) <= 1 - same
    assert float(diff.max()) <= tight + steps * float(step) * (1 + 1e-5)


def i8_block(c, hid, b, n, seed, dev, fresh=False):
    """fp32 x; both halves' parameters with the Linear weights through
    their symmetric int8 fake-quant, each the (in, out) view of a torch
    (out, in) tensor; std-1 biases; the (2, 5, 3) site table of a port
    Block calibrated on x (``fresh``: row 2 of each half without
    statistics, as a new observer has none)."""
    from myrtle_vision_tpu_torch.models.vit import Block
    from myrtle_vision_tpu_torch.quantize import (
        QFormat,
        is_observer,
        quantize_weight,
    )

    rng = np.random.RandomState(seed)
    heads = max(c // 64, 1)
    block = Block(c, heads, c // heads, hid, 0.0, 12, dev,
                  QFormat.PyTorchINT8)
    sd = {}
    for name, t in block.state_dict().items():
        if is_observer(name):
            sd[name] = t
            continue
        std = (t.shape[1] ** -0.5 if t.dim() == 2 else
               0.1 if "norm" in name else 1.0)
        arr = rng.randn(*t.shape) * std + (1 if name.endswith(
            "norm.weight") else 0)
        sd[name] = torch.from_numpy(arr.astype(np.float32)).to(dev)
    block.load_state_dict(sd)
    x = torch.from_numpy(rng.randn(b, n, c).astype(np.float32)).to(dev)
    with torch.no_grad():
        block.forward_int8(x)
        sites = block.site_table()
    if fresh:
        sites[:, 2] = torch.tensor([1.1920929e-7, 0.0, 0.0], device=dev)
    qkv, out, fc1, fc2 = block._linears()
    a, f = block._modules["0"].fn.norm, block._modules["1"].fn.norm

    def qw(lin):
        return quantize_weight(lin.weight.detach(), QFormat.PyTorchINT8,
                               "linear", False).t()

    attn = [a.weight.detach(), a.bias.detach(), qw(qkv), qkv.bias.detach(),
            qw(out), out.bias.detach()]
    mlp = [f.weight.detach(), f.bias.detach(), qw(fc1), fc1.bias.detach(),
           qw(fc2), fc2.bias.detach()]
    return x, attn, mlp, sites


def step_of(site):
    return float(site[0]) if float(site[2]) > 0 else 0.0


def series_bar(s1, s2):
    """(step, steps) of an output snapped at a site of step s2 after one of
    step s1 (either 0 without statistics): a flip of the first, through a
    slope under 1.2 (GELU' < 1.13), reaches the second grid as up to
    ceil(1.2 s1 / s2) + 1 of its steps (chip_smoke.py)."""
    if s2 == 0.0:
        return 1.2 * s1, 1
    return s2, 1 + int(np.ceil(1.2 * s1 / s2))


I8_SHAPES = [(64, 128, 3, 17), (32, 64, 2, 37), (384, 1536, 4, 197)]


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("c,hid,b,n", I8_SHAPES)
def test_int8_qat_kernels_match_plain(dev, c, hid, b, n, fresh):
    """Each kernel in its INT8 mode against its plain version, forward
    (the LayerNorm, the QKV, projection, fc1 and fc2 epilogues, the
    attention core's site snap with its statistics) and backward (the fc1
    recompute, the LayerNorm backward with x unsnapped)."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    x, attn, mlp, sites = i8_block(c, hid, b, n, n + 41, dev, fresh)
    heads = max(c // 64, 1)
    scale = (c // heads) ** -0.5
    x2 = x.view(-1, c)
    qa, qm = sites[0], sites[1]
    before = dict(K.LAUNCHES)
    args = (x2, attn[0], attn[1], Int8Sites(qa[0]))
    xn = K.layernorm_snap_rows_plain(*args)
    close_sites(K.layernorm_snap_rows_cuda(*args), xn, step_of(qa[0]))
    args = (xn, attn[2], attn[3], "bias_snap", Int8Sites(qa[1]))
    qkv = K.gemm_f32x3_epilogue_plain(*args)
    close_sites(K.gemm_f32x3_epilogue_cuda(*args), qkv, step_of(qa[1]))
    qkv = qkv.view(b, n, 3 * c)
    got = K.attention_core_snap_cuda(qkv, heads, scale, Int8Sites(qa[2]),
                                     stats=True)
    ref = K.attention_core_snap_plain(qkv, heads, scale, Int8Sites(qa[2]),
                                      stats=True)
    close_sites(got[0], ref[0], step_of(qa[2]))
    close(got[1], ref[1])
    close(got[2], ref[2])
    ctx = ref[0].view(-1, c)
    # two sites in series: the first's step reaches the second's grid as
    # up to ceil(s1 / s2) + 1 steps of it
    for a_in, w, bias, sp, epi in (
            (ctx, attn[4], attn[5], qa, "bias_snap_residual_snap"),
            (xn, mlp[2], mlp[3], qm, "bias_snap_gelu_snap")):
        kw = {"residual": x2} if epi.endswith("residual_snap") else {}
        args = (a_in, w, bias, epi, Int8Sites(*(
            sp[3:5] if kw else sp[1:3])))
        want = K.gemm_f32x3_epilogue_plain(*args, **kw)
        s1, s2 = (step_of(sp[3]), step_of(sp[4])) if kw else \
            (step_of(sp[1]), step_of(sp[2]))
        step, steps = series_bar(s1, s2)
        close_sites(K.gemm_f32x3_epilogue_cuda(*args, **kw), want, step,
                    steps=steps)
    args = (xn, mlp[2], mlp[3], "bias_snap_gelu_snap_grad",
            Int8Sites(qm[1], qm[2]))
    got, want = K.gemm_f32x3_epilogue_cuda(*args), \
        K.gemm_f32x3_epilogue_plain(*args)
    s1, s2 = step_of(qm[1]), step_of(qm[2])
    step, steps = series_bar(s1, s2)
    close_sites(got[0], want[0], step, steps=steps)
    # GELU' of h, itself snapped: a flipped h moves GELU' by up to
    # max|GELU''| (~0.8) times a step
    close(got[1], want[1], KERNEL_ATOL + s1)
    do2 = torch.randn(x2.shape, device=dev,
                      generator=torch.Generator(dev).manual_seed(n))
    dxn = K.gemm_f32x3_epilogue_plain(do2, attn[4].t(), None, "f32",
                                      Int8Sites())
    got = K.layernorm_rows_bwd_cuda(x2, attn[0], dxn, do2, Int8Sites())
    want = K.layernorm_rows_bwd_plain(x2, attn[0], dxn, do2, Int8Sites())
    close(got[0], want[0])
    for g, r in zip(got[1:], want[1:]):
        close(g, r, SUM_ATOL * float(r.abs().max()))
    launched = {k: K.LAUNCHES[k] - before[k] for k in
                ("layernorm_snap_rows", "gemm_f32x3_epilogue",
                 "attention_core_f32", "layernorm_snap_rows_bwd")}
    assert launched == {"layernorm_snap_rows": 1, "gemm_f32x3_epilogue": 4,
                        "attention_core_f32": 1,
                        "layernorm_snap_rows_bwd": 1}


@pytest.mark.parametrize("save", ["0", "1"])
@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("c,hid,b,n", I8_SHAPES)
def test_int8_qat_chains_match_plain(dev, c, hid, b, n, fresh, save,
                                     monkeypatch):
    """Both INT8 QAT ops, forward (the chain bar on the residual sum's
    grid) and backward (the FP32 gradient bars), kernel chain against
    plain chain, each from its own forward; one launch of each op and of
    each backward."""
    from myrtle_vision_tpu_torch.ops.fused_attention_block import (
        fused_attention_block_i8,
        fused_attention_block_i8_plain,
    )
    from myrtle_vision_tpu_torch.ops.fused_mlp import (
        fused_mlp_block_i8,
        fused_mlp_block_i8_plain,
    )

    monkeypatch.setenv("MVT_SAVE_ACTS", save)
    x, attn, mlp, sites = i8_block(c, hid, b, n, n + 43, dev, fresh)
    heads = max(c // 64, 1)
    extra = (heads, (c // heads) ** -0.5)
    do = torch.randn(x.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(n))

    def with_sites(op, table, *tail):
        def run(*args):
            return op(*args, table, *tail)
        return run

    before = (fused_attention_block_i8.launches,
              fused_attention_block_i8.bwd_launches,
              fused_mlp_block_i8.launches, fused_mlp_block_i8.bwd_launches)
    with torch.no_grad():
        for op, plain, table, params, tail in (
                (fused_attention_block_i8, fused_attention_block_i8_plain,
                 sites[0], attn, extra),
                (fused_mlp_block_i8, fused_mlp_block_i8_plain, sites[1],
                 mlp, ())):
            close_sites(op(x, *params, table, *tail),
                        plain(x, *params, table, *tail),
                        step_of(table[4]), I8_CHAIN_SAME, I8_CHAIN_STEPS)
    got = grads_of(with_sites(fused_attention_block_i8, sites[0], *extra), x,
                   attn, (), do)
    ref = grads_of(with_sites(fused_attention_block_i8_plain, sites[0],
                              *extra), x, attn, (), do)
    close_grads(got, ref, ["x", "scale", "bias", "wqkv", "bqkv", "wp", "bp"])
    got = grads_of(with_sites(fused_mlp_block_i8, sites[1]), x, mlp, (), do)
    ref = grads_of(with_sites(fused_mlp_block_i8_plain, sites[1]), x, mlp,
                   (), do)
    close_grads(got, ref, ["x", "scale", "bias", "w1", "b1", "w2", "b2"])
    assert (fused_attention_block_i8.launches - before[0],
            fused_attention_block_i8.bwd_launches - before[1],
            fused_mlp_block_i8.launches - before[2],
            fused_mlp_block_i8.bwd_launches - before[3]) == (2, 1, 2, 1)


def test_int8_qat_step_reads_the_sites_on_the_device(dev):
    """The two-pass step of a small PyTorchINT8 ViT through the kernels:
    pass 2 and the backward never wait on the host (the site tables are
    computed and read on the device: CUDA's sync debug mode raises on any
    synchronizing call), one launch of each INT8 op per block and
    direction, and the gradients as the plain path's (relative L2 2^-4,
    chip_smoke.py's first-step bar); the observers after pass 2 are pass
    1's."""
    from myrtle_vision_tpu_torch.ops.fused_attention_block import (
        fused_attention_block_i8,
    )
    from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block_i8
    from myrtle_vision_tpu_torch.training.optim import cross_entropy_loss

    depth = 2
    model = ViT("classification", 224, 16, 10, 128, depth, 2, 256,
                q_format="PyTorchINT8", device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    img = torch.randn(4, 224, 224, 3, device=dev, generator=gen)
    labels = torch.randint(0, 10, (4,), device=dev, generator=gen)
    with torch.no_grad():
        model(img, calibrating=True)
    observers = {n: t.clone() for n, t in model.state_dict().items()}
    runs = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        before = (fused_attention_block_i8.launches,
                  fused_attention_block_i8.bwd_launches,
                  fused_mlp_block_i8.launches,
                  fused_mlp_block_i8.bwd_launches)
        torch.cuda.synchronize()
        if not plain:
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss = cross_entropy_loss(model(img, plain=plain,
                                            int8_fused=True), labels)
            loss.backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launched = (fused_attention_block_i8.launches - before[0],
                    fused_attention_block_i8.bwd_launches - before[1],
                    fused_mlp_block_i8.launches - before[2],
                    fused_mlp_block_i8.bwd_launches - before[3])
        assert launched == ((0,) * 4 if plain else (depth,) * 4)
        runs.append((float(loss), {n: p.grad.clone()
                                   for n, p in model.named_parameters()
                                   if p.grad is not None}))
    for name, t in model.state_dict().items():
        assert torch.equal(t, observers[name]), name
    (k_loss, k_grads), (p_loss, p_grads) = runs
    assert abs(k_loss - p_loss) <= 2.0 ** -6 * max(1.0, abs(p_loss))
    for name, ref in p_grads.items():
        got = k_grads[name]
        assert bool(torch.isfinite(got).all()), name
        assert float((got - ref).norm() / ref.norm().clamp_min(1e-30)) <= \
            2.0 ** -4, name
    # a site table changed on the device changes what the kernels snap to
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    x2 = torch.randn(64, 128, device=dev, generator=gen)
    site = torch.tensor([0.5, 128.0, 1.0], device=dev)
    ones, zeros = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    a = K.layernorm_snap_rows_cuda(x2, ones, zeros, Int8Sites(site))
    site[0] = 0.25
    b = K.layernorm_snap_rows_cuda(x2, ones, zeros, Int8Sites(site))
    torch.cuda.synchronize()
    assert torch.equal(a, torch.round(a / 0.5) * 0.5)
    assert not torch.equal(a, b)
    assert torch.equal(b, K.layernorm_snap_rows_plain(x2, ones, zeros,
                                                      Int8Sites(site)))


# ------------------------------------------------------------------ probes
# The probes of the port's kernels (myrtle_vision_tpu_torch/perf/, K12-K14):
# each new kernel mode against its plain version, with the bars above.

def probe_qkv(b, n, c, seed, dev):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(b, n, 3 * c).astype(np.float32)).to(
        dev, torch.bfloat16)


@pytest.mark.parametrize("mode", sorted(K.PROBE_MODES))
@pytest.mark.parametrize("b,n", [(2, 197), (3, 50), (2, 17), (1, 256)])
def test_attention_core_probe_matches_plain(dev, mode, b, n):
    qkv = probe_qkv(b, n, 128, n, dev)
    before = K.LAUNCHES["attention_core_probe"]
    got = K.attention_core_probe_cuda(qkv, 2, 0.125, mode)
    assert K.LAUNCHES["attention_core_probe"] == before + 1
    if mode != "none":  # none divides by a sum of signed scores: parts
        close(got, K.attention_core_probe_plain(qkv, 2, 0.125, mode))
    if mode in K.DEFERRED_MODES:
        parts = K.attention_core_probe_cuda(qkv, 2, 0.125, mode, parts=True)
        ref = K.attention_core_probe_plain(qkv, 2, 0.125, mode, parts=True)
        close(parts[0], ref[0])
        close(parts[1], ref[1])
        torch.testing.assert_close(parts[2], ref[2], rtol=RTOL,
                                   atol=SUM_ATOL * float(ref[2].abs().max()))


def test_attention_core_probe_refuses_what_it_does_not_take(dev):
    with pytest.raises(ValueError, match="take 64"):
        K.attention_core_probe_cuda(probe_qkv(1, 17, 64, 0, dev), 2, 0.125,
                                    "defer")
    with pytest.raises(ValueError, match="no parts"):
        K.attention_core_probe_cuda(probe_qkv(1, 17, 128, 0, dev), 2, 0.125,
                                    "rowmajor", parts=True)
    with pytest.raises(ValueError, match="exceeds"):
        K.attention_core_probe_cuda(probe_qkv(1, 257, 128, 0, dev), 2,
                                    0.125, "defer")


@pytest.mark.parametrize("gelu", sorted(K.GELU_MODES))
@pytest.mark.parametrize("m", [2 * 197, 50])
def test_gemm_probe_gelu_modes_match_plain(dev, gelu, m):
    rng = np.random.RandomState(m)

    def t(*shape, std=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.randn(*shape) * std).astype(
            np.float32)).to(dev, dtype)

    a, w = t(m, 384), t(384, 1536, std=384 ** -0.5)
    bias = t(1536, dtype=torch.float32)
    before = K.LAUNCHES["gemm_bf16_gelu_probe"]
    got = K.gemm_bf16_probe_cuda(a, w, bias, "bias_gelu", gelu=gelu)
    assert K.LAUNCHES["gemm_bf16_gelu_probe"] == before + 1
    close(got, K.gemm_bf16_epilogue_plain(a, w, bias, "bias_gelu",
                                          gelu=gelu))


def test_gemm_probe_store_residual_and_head_major(dev):
    rng = np.random.RandomState(3)

    def t(*shape, std=1.0, dtype=torch.bfloat16):
        return torch.from_numpy((rng.randn(*shape) * std).astype(
            np.float32)).to(dev, dtype)

    a, w = t(150, 384), t(384, 1152, std=0.05)
    bias = t(1152, dtype=torch.float32)
    w3 = w.view(384, 3, 6, 64).permute(1, 2, 0, 3).contiguous()
    close(K.gemm_bf16_probe_cuda(a, w3, bias, "bias"),
          K.gemm_bf16_epilogue_plain(a, w, bias, "bias"))
    close(K.gemm_bf16_probe_cuda(a, w3, bias, "bias"),
          K.gemm_bf16_probe_cuda(a, w, bias, "bias"))
    close(K.gemm_bf16_probe_cuda(a, w, None, "store"),
          K.gemm_bf16_epilogue_plain(a, w, None, "store"))
    r = t(150, 1152)
    close(K.gemm_bf16_probe_cuda(a, w, bias, "bias_residual", residual=r),
          K.gemm_bf16_epilogue_plain(a, w, bias, "bias_residual",
                                     residual=r))
    with pytest.raises(ValueError, match="contiguous"):
        K.gemm_bf16_probe_cuda(a, w.t().contiguous().t(), bias, "bias")


@pytest.mark.parametrize("n", [197, 50])
@pytest.mark.parametrize("case", range(10))
def test_layout_probe_matches_plain(dev, case, n):
    from myrtle_vision_tpu_torch.perf import layout_probe as lp

    name, shapes, contract, per_head, explicit = lp.cases(n, 384, 6)[case]
    a, b = lp.make_operands(shapes, 3, case, dev)
    heads = 6 if per_head else None
    before = K.LAUNCHES["gemm_layout_probe"]
    got = K.batched_layout_dot_cuda(a, b, contract, heads, explicit)
    assert K.LAUNCHES["gemm_layout_probe"] == before + 1
    ref = K.batched_layout_dot_plain(a, b, contract, heads, explicit)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and got.dtype == torch.float32, name
    # exact products of bf16 values summed in fp32 on both sides
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=2.0 ** -16 * float(ref.abs().max()),
                               msg=name)


@pytest.mark.parametrize("dim,heads", [(384, 6), (192, 3), (768, 12)])
def test_probe_chains_match_plain(dev, dim, heads):
    """Every K12 / K13 variant's chain against its plain chain, at the
    widths of vit_small, vit_tiny and vit_base; K12 none by its parts
    (the tests above), the mlp pipe on two streams."""
    from myrtle_vision_tpu_torch.perf import attn_microbench as am
    from myrtle_vision_tpu_torch.perf import mlp_microbench as mm

    inputs = am.make_inputs(4, 197, dim, heads, dim, dev)
    kern, plain = am.variants(inputs, heads), am.variants(inputs, heads, True)
    failed = []
    for name in am.VARIANTS:
        if name in am.YARDSTICKS + ("none",):
            continue
        got, ref = kern[name]().float(), plain[name]().float()
        torch.cuda.synchronize()
        # dotonly normalizes nothing: its activations are ~100x the
        # others', and so is what one flipped bf16 rounding moves
        atol = CHAIN_ATOL * (float(ref.square().mean().sqrt())
                             if name == "dotonly" else 1.0)
        if not ((got - ref).abs() <= RTOL * ref.abs() + atol).all():
            failed.append((name, float((got - ref).abs().max())))
    inputs = mm.make_inputs(4, 197, dim, dim + 1, dev)
    kern, plain = mm.variants(inputs), mm.variants(inputs, True)
    for name in mm.VARIANTS:
        got = mm.joined(kern[name]()).float()
        ref = mm.joined(plain[name]()).float()
        torch.cuda.synchronize()
        if not ((got - ref).abs() <= RTOL * ref.abs() + CHAIN_ATOL).all():
            failed.append((f"mlp {name}", float((got - ref).abs().max())))
    assert not failed, failed


# The wgmma GEMM (csrc/gemm_bf16_wgmma.cu): every (A layout, B layout,
# epilogue) the wrapper takes.  (M, K, N) with A row-major: one row, a
# row past a 128-row tile, 4 x 197 + 3 rows with K = 3072 (48 steps), the
# ViT-S/16 batch of 256 x 197 rows; N = 576 and 192 are not multiples of
# the 128-column tile.  With A transposed (a weight gradient) the rows are
# the K of the product: (K, M, N), K split across CTAs at the largest; the
# fewest are 3, since an (M, 1) view is row-major as well.
GEMM_ROWS = [(1, 192, 576), (197, 384, 1152), (4 * 197 + 3, 3072, 192),
             (256 * 197, 1536, 384)]
GEMM_AT = [(3, 192, 576), (197, 384, 1152), (4 * 197 + 3, 1536, 192),
           (256 * 197, 1152, 384), (256 * 197, 384, 1536)]
GEMM_EPILOGUES = ["bias", "bias_gelu", "bias_residual", "f32",
                  "bias_gelu_grad", "mul_aux"]


def gemm_operands(m, k, n, seed, dev, b_col_major=False, a_col_major=False):
    gen = torch.Generator(dev).manual_seed(seed)

    def t(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device=dev, generator=gen) * std).to(
            dtype)

    a = t(k, m).t() if a_col_major else t(m, k)
    w = (t(n, k, std=k ** -0.5).t() if b_col_major
         else t(k, n, std=k ** -0.5))
    return (a, w, t(n, dtype=torch.float32), t(m, n),
            t(m, n, dtype=torch.float32))


@pytest.mark.parametrize("epilogue", GEMM_EPILOGUES)
@pytest.mark.parametrize("b_col_major", [False, True])
@pytest.mark.parametrize("m,k,n", GEMM_ROWS)
def test_wgmma_gemm_layouts_and_epilogues(dev, m, k, n, b_col_major,
                                          epilogue):
    a, w, bias, res, aux = gemm_operands(m, k, n, m + k + n, dev,
                                         b_col_major)
    kw = {"residual": res} if epilogue == "bias_residual" else (
        {"aux": aux} if epilogue == "mul_aux" else {})
    before = K.LAUNCHES["gemm_bf16_epilogue"]
    got = K.gemm_bf16_epilogue_cuda(a, w, bias, epilogue, **kw)
    assert K.LAUNCHES["gemm_bf16_epilogue"] == before + 1
    ref = K.gemm_bf16_epilogue_plain(a, w, bias, epilogue, **kw)
    if epilogue == "mul_aux":
        close(got[0], ref[0])
        close(got[1], ref[1], SUM_ATOL * float(ref[1].abs().max()))
    elif epilogue == "bias_gelu_grad":
        for g, r in zip(got, ref):
            close(g, r)
    else:
        close(got, ref)


@pytest.mark.parametrize("k,m,n", GEMM_AT)
def test_wgmma_gemm_weight_gradient(dev, k, m, n):
    a, b, *_ = gemm_operands(m, k, n, k + m, dev, a_col_major=True)
    got = K.gemm_bf16_epilogue_cuda(a, b, None, "f32")
    ref = K.gemm_bf16_epilogue_plain(a, b, None, "f32")
    plan = K.gemm_plan(m, n, k, True, K._sms(a))
    assert plan["grid"][2] > 1 or k < 256 * 197
    close(got, ref, SUM_ATOL * float(ref.abs().max()))


def test_wgmma_gemm_plan_matches_the_kernel(dev):
    lib = K._lib()
    assert tuple(lib.mvt_gemm_bf16_tile(i) for i in range(3)) == (
        *K.GEMM_TILE, K.GEMM_BK)


def test_wgmma_gemm_refuses_what_tma_cannot_load(dev):
    flat = torch.zeros(64 * 384 + 8, device=dev, dtype=torch.bfloat16)
    a = flat[1:1 + 64 * 384].view(64, 384)
    w = torch.zeros(384, 128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.gemm_bf16_epilogue_cuda(a, w, None, "f32")
    # a weight gradient's A stored with rows of 12 elements (24 bytes)
    a = torch.zeros(100, 12, device=dev, dtype=torch.bfloat16).t()
    with pytest.raises(ValueError, match="multiples of 8"):
        K.gemm_bf16_epilogue_cuda(a, w[:100].contiguous(), None, "f32")


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("heads", [3, 6, 12])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [1, 16, 17, 197, 255, 256])
def test_wgmma_attention_core(dev, n, d, heads, stats):
    gen = torch.Generator(dev).manual_seed(n * d + heads)
    qkv = torch.randn(2, n, 3 * heads * d, device=dev,
                      generator=gen).to(torch.bfloat16)
    before = K.LAUNCHES["attention_core"]
    got = K.attention_core_cuda(qkv, heads, d ** -0.5, stats=stats)
    assert K.LAUNCHES["attention_core"] == before + 1
    ref = K.attention_core_plain(qkv, heads, d ** -0.5, stats=stats)
    for g, r in zip(*((got, ref) if stats else ((got,), (ref,)))):
        close(g, r)


def test_wgmma_kernels_are_deterministic(dev):
    """Two launches on the same inputs give the same bits: the split-K
    weight gradient (partials summed in order), the column sums of the
    mul_aux epilogue, a forward product and the attention core."""
    m, k, n = 256 * 197, 384, 1152
    a, w, bias, _, aux = gemm_operands(m, k, n, 5, dev, b_col_major=True)
    dy = torch.randn(m, n, device=dev).to(torch.bfloat16)
    qkv = torch.randn(64, 197, 3 * 384, device=dev).to(torch.bfloat16)
    runs = [
        lambda: (K.gemm_bf16_epilogue_cuda(dy.t(), a, None, "f32"),),
        lambda: K.gemm_bf16_epilogue_cuda(a, w.contiguous(), None,
                                          "mul_aux", aux=aux),
        lambda: (K.gemm_bf16_epilogue_cuda(a, w, bias, "bias_gelu"),),
        lambda: K.attention_core_cuda(qkv, 6, 0.125, stats=True),
    ]
    for run in runs:
        first = [t.clone() for t in run()]
        second = run()
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            assert torch.equal(x, y)


def core_bwd_inputs(b, n, heads, d, seed, dev):
    """qkv rows, the plain forward's saved m and rs, and an fp32 d_o."""
    gen = torch.Generator(dev).manual_seed(seed)
    qkv = torch.randn(b, n, 3 * heads * d, device=dev,
                      generator=gen).to(torch.bfloat16)
    _, m, rs = K.attention_core_plain(qkv, heads, d ** -0.5, stats=True)
    d_o = torch.randn(b, n, heads * d, device=dev, generator=gen)
    return qkv, d_o, m, rs


@pytest.mark.parametrize("heads", [2, 6])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [1, 15, 16, 17, 64, 65, 128, 197, 208, 255,
                               256])
def test_wgmma_attention_core_backward(dev, n, d, heads):
    """The one-CTA wgmma core backward at every tile edge up to 256
    tokens: one launch, dqkv under the chain bar and its per-image column
    sums under the sum bar, as the WMMA kernel it replaced was held."""
    qkv, d_o, m, rs = core_bwd_inputs(2, n, heads, d, n * d + heads, dev)
    before = K.LAUNCHES["attention_core_bwd"]
    got = K.attention_core_bwd_cuda(qkv, d_o, m, rs, heads, d ** -0.5)
    assert K.LAUNCHES["attention_core_bwd"] == before + 1
    want = K.attention_core_bwd_plain(qkv, d_o, m, rs, heads, d ** -0.5)
    close(got[0], want[0], CHAIN_ATOL)
    close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))


@pytest.mark.parametrize("n", [17, 197, 256])
def test_wgmma_attention_core_backward_is_deterministic(dev, n):
    qkv, d_o, m, rs = core_bwd_inputs(8, n, 6, 64, n, dev)
    first = [t.clone() for t in K.attention_core_bwd_cuda(qkv, d_o, m, rs,
                                                          6, 0.125)]
    second = K.attention_core_bwd_cuda(qkv, d_o, m, rs, 6, 0.125)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", [32, 64])
def test_tiled_core_backward_agrees_at_197(dev, d):
    """The KV-tiled route forced at 197 tokens (four launches) against the
    one-CTA kernel and the plain version, under the same bars."""
    qkv, d_o, m, rs = core_bwd_inputs(4, 197, 6, d, 197 + d, dev)
    before = K.LAUNCHES["attention_core_bwd"]
    tiled = K.attention_core_bwd_cuda(qkv, d_o, m, rs, 6, d ** -0.5,
                                      tiled=True)
    assert K.LAUNCHES["attention_core_bwd"] == before + 4
    one = K.attention_core_bwd_cuda(qkv, d_o, m, rs, 6, d ** -0.5)
    want = K.attention_core_bwd_plain(qkv, d_o, m, rs, 6, d ** -0.5)
    for ref in (one, want):
        close(tiled[0], ref[0], CHAIN_ATOL)
        close(tiled[1], ref[1], SUM_ATOL * float(ref[1].abs().max()))


# the fused core's long route (csrc/attention_core_long_wgmma.cu,
# csrc/attention_core_bwd_long_wgmma.cu) at its tile edges: 64-row CTAs,
# 128-key forward tiles, 64-row backward tiles; up to the fused gate (701)
LONG_CORE_EDGE_N = [257, 319, 320, 321, 383, 384, 385, 511, 512, 513, 677,
                    701]


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("heads", [2, 6])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", LONG_CORE_EDGE_N)
def test_long_core_forward_tile_edges(dev, n, d, heads, b):
    """Context, rowmax and reciprocal rowsum against the plain version
    under the one-kernel bar; one launch a call."""
    gen = torch.Generator(dev).manual_seed(n * d + heads + b)
    qkv = torch.randn(b, n, 3 * heads * d, device=dev,
                      generator=gen).to(torch.bfloat16)
    before = K.LAUNCHES["attention_core"]
    got = K.attention_core_cuda(qkv, heads, d ** -0.5, stats=True)
    assert K.LAUNCHES["attention_core"] == before + 1
    ref = K.attention_core_plain(qkv, heads, d ** -0.5, stats=True)
    for g, r in zip(got, ref):
        close(g, r)


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("heads", [2, 6])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", LONG_CORE_EDGE_N)
def test_long_core_backward_tile_edges(dev, n, d, heads, b):
    """dqkv under the chain bar and its per-image column sums under the
    sum bar, from the plain forward's statistics; the plan's launches a
    call."""
    qkv, d_o, m, rs = core_bwd_inputs(b, n, heads, d, n * d + heads + b, dev)
    before = K.LAUNCHES["attention_core_bwd"]
    got = K.attention_core_bwd_cuda(qkv, d_o, m, rs, heads, d ** -0.5)
    assert K.LAUNCHES["attention_core_bwd"] == before + K.core_long_plan(
        n, d)["launches"]["bwd"]
    want = K.attention_core_bwd_plain(qkv, d_o, m, rs, heads, d ** -0.5)
    close(got[0], want[0], CHAIN_ATOL)
    close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))


def test_long_core_is_deterministic(dev):
    """Two launches of each long kernel on the same inputs give the same
    bits (no atomics, every sum in a fixed order)."""
    qkv, d_o, m, rs = core_bwd_inputs(8, 677, 6, 64, 677, dev)
    runs = [lambda: K.attention_core_cuda(qkv, 6, 0.125, stats=True),
            lambda: K.attention_core_bwd_cuda(qkv, d_o, m, rs, 6, 0.125)]
    for run in runs:
        first = [t.clone() for t in run()]
        second = run()
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            assert torch.equal(x, y)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [1, 17, 197])
def test_long_core_forced_agrees_with_one_cta(dev, n, d):
    """The long route forced at lengths the one-CTA kernels take, forward
    and backward, against those kernels and the plain versions under the
    same bars."""
    heads, sc = 6, d ** -0.5
    qkv, d_o, m, rs = core_bwd_inputs(2, n, heads, d, n + d + 1, dev)
    before = K.LAUNCHES["attention_core"]
    fwd = K.attention_core_cuda(qkv, heads, sc, stats=True, tiled=True)
    assert K.LAUNCHES["attention_core"] == before + 1
    for ref in (K.attention_core_cuda(qkv, heads, sc, stats=True),
                K.attention_core_plain(qkv, heads, sc, stats=True)):
        for g, r in zip(fwd, ref):
            close(g, r)
    before = K.LAUNCHES["attention_core_bwd"]
    bwd = K.attention_core_bwd_cuda(qkv, d_o, m, rs, heads, sc, tiled=True)
    assert K.LAUNCHES["attention_core_bwd"] == before + 4
    for ref in (K.attention_core_bwd_cuda(qkv, d_o, m, rs, heads, sc),
                K.attention_core_bwd_plain(qkv, d_o, m, rs, heads, sc)):
        close(bwd[0], ref[0], CHAIN_ATOL)
        close(bwd[1], ref[1], SUM_ATOL * float(ref[1].abs().max()))


def test_core_long_launches_match_the_plan(dev):
    """The long kernels' own figures (grid, rows, tiles, threads, stages,
    shared memory) and launches against core_long_plan, and the runtime's
    occupancy of the compiled kernels: at least the two CTAs an SM that
    their launch bounds count on (at head width 32 the smaller tiles and
    fewer registers let some fit three)."""
    skip = ("walk", "passes", "ctas_per_sm")
    for n in (1, 17, 197, 257, 677, 701, 4096):
        for d in (32, 64):
            plan = K.core_long_plan(n, d)
            got = K.core_long_launch(n, d)
            for key in ("fwd", "dq", "dkdv"):
                want = {f: v for f, v in plan[key].items() if f not in skip}
                ctas = got[key].pop("ctas_per_sm")
                assert got[key] == want, (n, d, key)
                assert ctas >= plan[key]["ctas_per_sm"], (n, d, key)
                if d == 64:
                    assert ctas == plan[key]["ctas_per_sm"], (n, key)
            assert got["launches"] == plan["launches"]


# the LayerNorm backward's widths: one to six chunks of four columns a
# lane (128 columns a chunk step), idle lanes in the last one, the model
# widths 192 (ViT-Ti), 384 (ViT-S), 768 (ViT-B)
LN_BWD_COLS = [32, 64, 128, 132, 192, 384, 640, 764, 768]


@pytest.mark.parametrize("form", ["bf16", "FP16_32", "FP16_16", "int8"])
@pytest.mark.parametrize("cols", LN_BWD_COLS)
@pytest.mark.parametrize("rows", [1, 50, 3 * 197])
def test_layernorm_bwd_widths(dev, rows, cols, form):
    """dx under the one-kernel bar (the float formats' snap of x is the
    plain version's), dscale and dbias under the sum bar, in the bf16
    form, two float formats' snap form and INT8 QAT's form."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    rng = np.random.RandomState(rows * cols)
    dt = torch.bfloat16 if form == "bf16" else torch.float32
    qspec = {"bf16": None, "int8": Int8Sites(),
             "FP16_32": (5, 10, False), "FP16_16": (5, 10, True)}[form]

    def t(*shape, dtype=dt):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dtype)

    x, do, scale = t(rows, cols), t(rows, cols), t(cols)
    dxn = t(rows, cols, dtype=torch.float32)
    name = "layernorm_rows_bwd" if form == "bf16" else \
        "layernorm_snap_rows_bwd"
    before = K.LAUNCHES[name]
    got = K.layernorm_rows_bwd_cuda(x, scale, dxn, do, qspec)
    assert K.LAUNCHES[name] == before + 1
    ref = K.layernorm_rows_bwd_plain(x, scale, dxn, do, qspec)
    close(got[0], ref[0])
    for g, r in zip(got[1:], ref[1:]):
        close(g, r, SUM_ATOL * max(1.0, float(r.abs().max())))


def test_layernorm_bwd_is_deterministic_and_refuses_ragged_widths(dev):
    """Two launches give the same bits; a width that is not a multiple of
    four (the kernel's 16-byte chunks) is refused before any launch."""
    x = torch.randn(3 * 197, 384, device=dev)
    dxn = torch.randn(3 * 197, 384, device=dev)
    args = (x, torch.randn(384, device=dev), dxn, torch.randn_like(x),
            (5, 10, False))
    first = [t.clone() for t in K.layernorm_rows_bwd_cuda(*args)]
    again = K.layernorm_rows_bwd_cuda(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    r = torch.randn(5, 130, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        K.layernorm_rows_bwd_cuda(r, torch.randn(130, device=dev), r, r,
                                  (5, 10, False))


# layernorm_snap_rows: every width a shipped config or a test takes, rows
# from one to one past a full wave of its grid on this card, and every
# snap policy: the float formats, and INT8 QAT's site with and without
# statistics
LN_SNAP_COLS = [32, 64, 128, 192, 384, 768]
LN_SNAP_POLICIES = ["FP16_16", "FP16_32", "TF32", "int8", "int8 fresh"]


def ln_snap_lane_order(x, scale, bias, qspec):
    """layernorm_snap_rows_plain with the kernel's sums: lane l adds the
    columns l, l + 32, ... in turn, then the lanes meet as
    ``mvt::warp_sum``'s butterfly does; every step a separate fp32 op."""
    from myrtle_vision_tpu_torch.ops.fake_quant import (
        snap,
        snap_all,
        snap_int8,
    )

    rows, cols = x.shape
    values = cols // 32
    lanes = torch.arange(32, device=x.device)
    # a tensor, not a Python number: PyTorch divides by a host scalar as a
    # multiply by its reciprocal, the kernel by a true divide
    n = torch.tensor(float(cols), device=x.device)

    def row_sum(t):
        acc = torch.zeros(rows, 32, device=x.device)
        for i in range(values):
            acc = acc + t[:, i]
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lanes ^ o]
        return acc[:, :1, None]

    xs = snap(x, qspec).view(rows, values, 32)
    d = xs - row_sum(xs) / n
    rstd = torch.rsqrt(row_sum(d * d) / n + K.EPS)
    y = d * rstd * scale.view(values, 32) + bias.view(values, 32)
    return snap_int8(snap(snap_all(y.view(rows, cols), qspec), qspec),
                     qspec, 0)


@pytest.mark.parametrize("policy", LN_SNAP_POLICIES)
@pytest.mark.parametrize("cols", LN_SNAP_COLS)
def test_layernorm_snap_widths(dev, cols, policy):
    """At 1, 7, 33 rows and one past the rows of a full wave of blocks
    (the card's SMs times the blocks an SM of ``K.layernorm_snap_plan``,
    four rows a block): one launch a call, the bits of the kernel's
    arithmetic in its own order (``ln_snap_lane_order``) and of a second
    call; the four outputs together against the plain version under the
    one-kernel bars (a single snap flipped by the sums' order is 1/32 of a
    one-row output at width 32, past the bars' 0.2% share, so the share
    is taken over all four)."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    plan = K.layernorm_snap_plan(1, cols)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wave = sms * plan["blocks_per_sm"] * plan["warps"]
    gen = torch.Generator(dev).manual_seed(cols)
    scale = 1 + 0.1 * torch.randn(cols, device=dev, generator=gen)
    bias = 0.1 * torch.randn(cols, device=dev, generator=gen)
    xs = [3 * torch.randn(rows, cols, device=dev, generator=gen) + 0.5
          for rows in (1, 7, 33, wave + 1)]
    if policy.startswith("int8"):
        y = torch.nn.functional.layer_norm(torch.cat(xs), (cols,), scale,
                                           bias, K.EPS)
        site = (site_of(y) if policy == "int8" else
                torch.tensor([1.1920929e-7, 0.0, 0.0], device=dev))
        qspec = Int8Sites(site)
    else:
        qspec = {"FP16_16": (5, 10, True), "FP16_32": (5, 10, False),
                 "TF32": (8, 10, False)}[policy]
    got, ref = [], []
    for x in xs:
        before = K.LAUNCHES["layernorm_snap_rows"]
        out = K.layernorm_snap_rows_cuda(x, scale, bias, qspec)
        again = K.layernorm_snap_rows_cuda(x, scale, bias, qspec)
        assert K.LAUNCHES["layernorm_snap_rows"] == before + 2
        torch.cuda.synchronize()
        bits = out.view(torch.int32)
        assert torch.equal(bits, again.view(torch.int32)), x.shape
        assert torch.equal(bits, ln_snap_lane_order(
            x, scale, bias, qspec).view(torch.int32)), x.shape
        got.append(out)
        ref.append(K.layernorm_snap_rows_plain(x, scale, bias, qspec))
    if isinstance(qspec, Int8Sites):
        close_sites(torch.cat(got), torch.cat(ref), step_of(site))
    else:
        close_float(torch.cat(got), torch.cat(ref), qspec)


@pytest.mark.parametrize("cols", [768 + 32, 100, 16])
def test_layernorm_snap_refuses_other_widths(dev, cols):
    """A width past the maximum or not a multiple of 32 is refused before
    any launch."""
    x = torch.randn(5, cols, device=dev)
    before = K.LAUNCHES["layernorm_snap_rows"]
    with pytest.raises(ValueError, match="multiple of 32"):
        K.layernorm_snap_rows_cuda(x, torch.ones(cols, device=dev),
                                   torch.zeros(cols, device=dev),
                                   (5, 10, False))
    assert K.LAUNCHES["layernorm_snap_rows"] == before


@pytest.mark.parametrize("cols", LN_SNAP_COLS)
def test_layernorm_snap_launch_matches_the_plan(dev, cols):
    """The kernel's own figures (values a lane, warps, grid, the blocks an
    SM it is built for) are the plan's, the runtime fits at least those
    blocks an SM of both policies' kernels, and the maximum width is the
    plan's."""
    assert K._lib().mvt_layernorm_snap_rows_max_cols() == K.LN_SNAP_MAX_COLS
    for rows in (1, 7, 256 * 197, 256 * 577):
        got = K.layernorm_snap_launch(rows, cols)
        occupancy = got.pop("occupancy")
        plan = K.layernorm_snap_plan(rows, cols)
        assert got == plan, (rows, cols)
        assert min(occupancy.values()) >= plan["blocks_per_sm"], occupancy


# colsum_rows: rows at and around the one-kernel limit (64) and the
# 50,432 rows of a ViT-S/16 block at batch 256; widths of dbp/db2 (384),
# dbqkv (1152) and one that takes the scalar path (100)
COLSUM_ROWS = [1, 63, 64, 65, 257, 50432]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cols", [384, 1152, 100])
@pytest.mark.parametrize("rows", COLSUM_ROWS)
def test_colsum_rows(dev, rows, cols, dtype):
    gen = torch.Generator(dev).manual_seed(rows + cols)
    t = torch.randn(rows, cols, device=dev, generator=gen).to(dtype)
    want = K.colsum_rows_plain(t)
    before = K.LAUNCHES["colsum_rows"]
    got = K.colsum_rows_cuda(t)
    assert K.LAUNCHES["colsum_rows"] - before == (1 if rows <= 64 else 2)
    close(got, want, SUM_ATOL * float(want.abs().max()))
    again = K.colsum_rows_cuda(t)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_colsum_rows_split_k_partials(dev):
    """The split-K weight gradient's partial products, (splits, M N) fp32
    with M N = 384 x 1536: one kernel over 7 rows."""
    t = torch.randn(7, 384 * 1536, device=dev,
                    generator=torch.Generator(dev).manual_seed(7))
    before = K.LAUNCHES["colsum_rows"]
    got = K.colsum_rows_cuda(t)
    assert K.LAUNCHES["colsum_rows"] - before == 1
    want = K.colsum_rows_plain(t)
    close(got, want, SUM_ATOL * float(want.abs().max()))
    assert torch.equal(got, K.colsum_rows_cuda(t))


# ----------------------------------- the wgmma 3-pass and int8 GEMMs
# csrc/gemm_f32x3_wgmma.cu and csrc/gemm_s8_wgmma.cu against their plain
# versions at ragged shapes (one row, M = 4 * 197 + 3, N = 45, K not a
# multiple of the kernel's step) and a full tile, with the existing
# per-element bars; each output again from a second launch, bit for bit.

def test_f32x3_and_s8_tiles_match_the_plans(dev):
    lib = K._lib()
    assert tuple(lib.mvt_gemm_f32x3_tile(i) for i in range(5)) == (
        *K.F32X3_TILE, K.F32X3_BK, *K.F32X3_GELU_TILE)
    assert tuple(lib.mvt_gemm_s8_tile(i) for i in range(3)) == (
        *K.S8_TILE, K.S8_BK)


def _seeded(seed, dev):
    rng = np.random.RandomState(seed)

    def t(*shape, std=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * std).astype(np.float32)).to(dev)
    return t


def _same_twice(fn, got):
    """A second launch gives the same bits."""
    again = fn()
    torch.cuda.synchronize()
    for g, a in zip(got if isinstance(got, tuple) else (got,),
                    again if isinstance(again, tuple) else (again,)):
        assert torch.equal(g, a)


F32X3_POLICIES = {"FP16_16": (5, 10, True), "FP16_32": (5, 10, False),
                  "int8": None}
F32X3_CASES = [(1, 45, 388), (4 * 197 + 3, 200, 388), (300, 1152, 384)]
F32X3_EPI_POLICY = [(e, p) for e in ("bias_snap", "bias_snap_gelu_snap",
                                     "bias_snap_residual_snap",
                                     "bias_snap_gelu_snap_grad")
                    for p in F32X3_POLICIES] + [("f32", "FP16_32"),
                                                ("mul_aux", "FP16_32")]


@pytest.mark.parametrize("epilogue,policy", F32X3_EPI_POLICY)
@pytest.mark.parametrize("m,n,k", F32X3_CASES)
def test_wgmma_f32x3_epilogues(dev, m, n, k, epilogue, policy):
    """All six epilogues, the snapping ones under a float qspec (FP16_16
    snaps at every site, FP16_32 at the pre_linear ones) and under
    Int8Sites observed on the plain values, with the (N, K) weight read
    in place; "f32" and "mul_aux" with a row-major (K, N) matrix."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites
    from myrtle_vision_tpu_torch.ops.high_precision import matmul_high3

    t = _seeded(m + n + k, dev)
    row_b = epilogue in ("f32", "mul_aux")
    n = n if not row_b else -(-n // 4) * 4
    a = t(m, k)
    w = t(k, n, std=k ** -0.5) if row_b else t(n, k, std=k ** -0.5).t()
    bias, residual, aux = t(n), t(m, n), t(m, n)
    qspec = F32X3_POLICIES[policy]
    s0 = s1 = 0.0
    if qspec is None:
        p = matmul_high3(a, w) + bias
        site0 = site_of(p)
        h = K.requant(p, site0)
        site1 = site_of(h + residual if "residual" in epilogue
                        else K.gelu_poly(h))
        qspec = Int8Sites(site0, None if epilogue == "bias_snap" else site1)
        s0, s1 = step_of(site0), step_of(site1)
    kw = {"residual": residual} if "residual" in epilogue else \
        {"aux": aux} if epilogue == "mul_aux" else {}
    args = (a, w, None if row_b else bias, epilogue, qspec)
    before = K.LAUNCHES["gemm_f32x3_epilogue"]
    got = K.gemm_f32x3_epilogue_cuda(*args, **kw)
    want = K.gemm_f32x3_epilogue_plain(*args, **kw)
    assert K.LAUNCHES["gemm_f32x3_epilogue"] - before == 1
    if row_b:
        if epilogue == "f32":
            close(got, want)
        else:
            close(got[0], want[0])
            close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))
    else:
        out, ref = (got[0], want[0]) if isinstance(got, tuple) else (got,
                                                                     want)
        if isinstance(qspec, Int8Sites):
            step, steps = (s0, 1) if epilogue == "bias_snap" else \
                series_bar(s0, s1)
            close_sites(out, ref, step, steps=steps)
        else:
            first = None if epilogue == "bias_snap" else \
                K.gemm_f32x3_epilogue_plain(a, w, bias, "bias_snap", qspec)
            close_float(out, ref, qspec, first=first)
        if epilogue == "bias_snap_gelu_snap_grad":
            close(got[1], want[1], KERNEL_ATOL + s0)
    _same_twice(lambda: K.gemm_f32x3_epilogue_cuda(*args, **kw), got)


@pytest.mark.parametrize("m,n,k", [(384, 1152, 3 * 197), (136, 72, 150),
                                   (1152, 384, 64 * 197), (8, 8, 4)])
def test_wgmma_f32x3_weight_gradient_split_k(dev, m, n, k):
    """The transposed-A weight gradient: each K chunk's partial product
    against the plain product of its rows, colsum_rows' ordered sum of
    the partials as the wrapper's result, and the result against the
    plain product with the sum bar."""
    t = _seeded(m * n + k, dev)
    a = t(k, m).t()  # the (K, M) activation as it is stored
    w = t(k, n)
    qspec = (5, 10, False)
    got = K.gemm_f32x3_epilogue_cuda(a, w, None, "f32", qspec)
    want = K.gemm_f32x3_epilogue_plain(a, w, None, "f32", qspec)
    close(got, want, SUM_ATOL * float(want.abs().max()))
    plan = K.gemm_f32x3_plan(m, n, k, True, K._sms(a))
    ks, splits = plan["k_split"], plan["grid"][2]
    assert splits > 1 or k < 2 * K.F32X3_MIN_CHUNK
    part = torch.empty((splits, m, n), device=dev)
    at = a.t()
    K._launch("gemm_f32x3_epilogue", K._lib().mvt_gemm_f32x3_at, at,
              at.data_ptr(), w.data_ptr(), part.data_ptr(), m, n, k, ks)
    for z in range(splits):
        chunk = K.gemm_f32x3_epilogue_plain(
            a[:, z * ks:(z + 1) * ks], w[z * ks:(z + 1) * ks], None, "f32",
            qspec)
        close(part[z], chunk, SUM_ATOL * float(chunk.abs().max()))
    summed = part[0] if splits == 1 else K.colsum_rows_cuda(
        part.view(splits, m * n)).view(m, n)
    torch.cuda.synchronize()
    assert torch.equal(got, summed)
    _same_twice(lambda: K.gemm_f32x3_epilogue_cuda(a, w, None, "f32", qspec),
                got)


S8_CASES = [(3, 16, 16), (4 * 197 + 3, 1152, 384), (256, 45, 384),
            (197, 45, 400), (300, 1536, 768)]


@pytest.mark.parametrize("epilogue", list(K.INT8_EPILOGUES))
@pytest.mark.parametrize("m,n,k", S8_CASES)
def test_wgmma_s8_epilogues(dev, m, n, k, epilogue):
    """All three epilogues with the weight read in place as the (in, out)
    view of the (N, K) int8 weight; sites observed on the plain values."""
    from myrtle_vision_tpu_torch.ops.fused_int8_block import weight_colsum

    gen = torch.Generator(dev).manual_seed(m + n + k)
    t = _seeded(m * n + k, dev)
    a = torch.randint(-128, 128, (m, k), device=dev, generator=gen,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), device=dev, generator=gen,
                      dtype=torch.int8).t()
    colsum = weight_colsum(w)
    w_scale = torch.tensor(0.02 * k ** -0.5, device=dev)
    a_site = torch.tensor([0.05, 121.0, 1.0], device=dev)
    bias, residual = t(n), t(m, n)
    nosite = torch.zeros(3, device=dev)
    v = K.gemm_s8_epilogue_plain(a, w, colsum, w_scale, a_site, bias,
                                 "requant", nosite)
    site = site_of(v)
    h = K.requant(v, site)
    site2 = site_of(h + residual if epilogue.endswith("residual_requant")
                    else K.gelu_poly(h))
    kw = {"residual": residual} if epilogue.endswith("residual_requant") \
        else {}
    args = (a, w, colsum, w_scale, a_site, bias, epilogue, site, site2)
    before = K.LAUNCHES["gemm_s8_epilogue"]
    got = K.gemm_s8_epilogue_cuda(*args, **kw)
    assert K.LAUNCHES["gemm_s8_epilogue"] - before == 1
    step = 1 if epilogue == "requant_gelu_quant" else \
        float(site2[0]) if kw else float(site[0])
    close_on_grid(got, K.gemm_s8_epilogue_plain(*args, **kw), step)
    _same_twice(lambda: K.gemm_s8_epilogue_cuda(*args, **kw), got)


# ------------------------------- the wgmma 3-pass fp32 attention core
# csrc/attention_core_f32_wgmma.cu and csrc/attention_core_f32_bwd_wgmma.cu
# against their plain versions at every tile edge up to 256 tokens, head
# widths 32 and 64, with the existing per-element bars; each output again
# from a second launch, bit for bit.

F32_CORE_NS = [1, 16, 17, 63, 64, 65, 197, 208, 250, 256]
# the forward's output modes: the converted model's int8 grid, the snap
# under a float format or an INT8 QAT site, and the snap with statistics
F32_CORE_MODES = ["int8", "FP16_16", "FP16_32", "TF32", "sites",
                  "FP16_32+stats", "sites+stats"]
F32_CORE_QSPECS = {"FP16_16": (5, 10, True), "FP16_32": (5, 10, False),
                   "TF32": (8, 10, False)}


def test_f32_core_launches_match_the_plan(dev):
    """The kernels' own launch figures against attention_core_f32_plan:
    warpgroups, KA, launches and shared memory exactly; CTAs an SM from
    the runtime's occupancy of the compiled kernels, equal to the plan's
    where shared memory alone sets it, else at least the plan's."""
    for n in (1, 16, 17, 63, 64, 65, 193, 197, 208, 209, 224, 225, 250,
              256):
        for d in (32, 64):
            plan = K.attention_core_f32_plan(n, d)
            got = K.attention_core_f32_launch(n, d)
            for key in ("fwd", "bwd"):
                want, have = plan[key], got[key]
                for field in ("warpgroups", "ka", "launches", "smem"):
                    assert have[field] == want[field], (n, d, key, field)
                fits = K.SM_SHARED_BYTES // (want["smem"] +
                                             K.CTA_RESERVED_BYTES)
                if fits == want["ctas_per_sm"]:
                    assert have["ctas_per_sm"] == fits, (n, d, key)
                else:
                    assert have["ctas_per_sm"] >= want["ctas_per_sm"], (
                        n, d, key)


def f32_core_qkv(b, n, heads, d, seed, dev):
    gen = torch.Generator(dev).manual_seed(seed)
    return torch.randn(b, n, 3 * heads * d, device=dev, generator=gen)


@pytest.mark.parametrize("mode", F32_CORE_MODES)
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", F32_CORE_NS)
def test_wgmma_f32_core_forward(dev, n, d, mode):
    """Every output mode against its plain version: the int8 grid with
    the INT8 bar, a float format's snap with the float bar, an INT8
    site's snap with the site bar, the rowmax and reciprocal rowsum with
    the one-kernel bar; one launch a call."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    heads, scale = 2, d ** -0.5
    qkv = f32_core_qkv(2, n, heads, d, n * d + len(mode), dev)
    ctx = K.attention_context_f32(qkv, heads, scale)
    site = site_of(ctx)
    policy, stats = mode.split("+")[0], mode.endswith("+stats")
    if policy == "int8":
        run = lambda: K.attention_core_f32_cuda(qkv, heads, scale, site)
        ref = K.attention_core_f32_plain(qkv, heads, scale, site)
    else:
        qspec = Int8Sites(site) if policy == "sites" else \
            F32_CORE_QSPECS[policy]
        run = lambda: K.attention_core_snap_cuda(qkv, heads, scale, qspec,
                                                 stats=stats)
        ref = K.attention_core_snap_plain(qkv, heads, scale, qspec,
                                          stats=stats)
    before = K.LAUNCHES["attention_core_f32"]
    got = run()
    assert K.LAUNCHES["attention_core_f32"] == before + 1
    out, want = (got[0], ref[0]) if stats else (got, ref)
    if policy == "int8":
        close_on_grid(out, want, 1)
    elif policy == "sites":
        close_sites(out, want, step_of(site))
    else:
        close_float(out, want, qspec)
    if stats:
        close(got[1], ref[1])
        close(got[2], ref[2])
    _same_twice(run, got)


def f32_core_bwd_inputs(b, n, heads, d, seed, dev):
    """qkv rows, the plain forward's saved m and rs, and an fp32 d_o."""
    qkv = f32_core_qkv(b, n, heads, d, seed, dev)
    _, m, rs = K.attention_context_f32(qkv, heads, d ** -0.5, stats=True)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    d_o = torch.randn(b, n, heads * d, device=dev, generator=gen)
    return qkv, d_o, m, rs


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", F32_CORE_NS)
def test_wgmma_f32_core_backward(dev, n, d):
    """The backward at every tile edge: one launch, dqkv under the chain
    bar and its per-image column sums under the sum bar, as the WMMA
    kernel it replaced was held; a second launch gives the same bits."""
    heads, scale = 2, d ** -0.5
    qkv, d_o, m, rs = f32_core_bwd_inputs(2, n, heads, d, n * d, dev)
    before = K.LAUNCHES["attention_core_f32_bwd"]
    run = lambda: K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs, heads,
                                                scale)
    got = run()
    assert K.LAUNCHES["attention_core_f32_bwd"] == before + 1
    want = K.attention_core_f32_bwd_plain(qkv, d_o, m, rs, heads, scale)
    close(got[0], want[0], CHAIN_ATOL)
    close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))
    _same_twice(run, got)


@pytest.mark.parametrize("d", [32, 64])
def test_wgmma_f32_core_dominant_key(dev, d):
    """Rows whose scores one key dominates (by ~100 before the exp, so
    every other e underflows): the kernel forward's statistics feed the
    kernel backward, the plain forward's the plain backward; outputs and
    gradients finite and within their bars."""
    b, n, heads, scale = 2, 197, 2, d ** -0.5
    gen = torch.Generator(dev).manual_seed(d)
    qkv = f32_core_qkv(b, n, heads, d, d + 7, dev)
    c = heads * d
    u = torch.randn(d, device=dev, generator=gen)
    u = u * (100.0 / (scale * float(u.square().sum()))) ** 0.5
    for h in range(heads):
        qkv[:, :, h * d:(h + 1) * d] += u  # every query
        qkv[:, 3 + 50 * h, c + h * d:c + (h + 1) * d] = u  # one key
    qspec = F32_CORE_QSPECS["FP16_32"]
    got = K.attention_core_snap_cuda(qkv, heads, scale, qspec, stats=True)
    ref = K.attention_core_snap_plain(qkv, heads, scale, qspec, stats=True)
    for t in got:
        assert bool(torch.isfinite(t).all())
    close_float(got[0], ref[0], qspec)
    close(got[1], ref[1])
    close(got[2], ref[2])
    d_o = torch.randn(b, n, c, device=dev, generator=gen)
    dq = K.attention_core_f32_bwd_cuda(qkv, d_o, got[1], got[2], heads,
                                       scale)
    want = K.attention_core_f32_bwd_plain(qkv, d_o, ref[1], ref[2], heads,
                                          scale)
    for t in dq:
        assert bool(torch.isfinite(t).all())
    close(dq[0], want[0], CHAIN_ATOL)
    close(dq[1], want[1], SUM_ATOL * float(want[1].abs().max()))


def test_wgmma_f32_core_recip_probe(dev):
    """The timing variant that multiplies by the reciprocal rowsum stays
    within the float bar of the exact divide; it takes only N_pad 208 at
    head width 64."""
    qspec = F32_CORE_QSPECS["FP16_32"]
    qkv = f32_core_qkv(4, 197, 6, 64, 11, dev)
    got = K.attention_core_f32_recip_probe_cuda(qkv, 6, 0.125, qspec)
    ref = K.attention_core_snap_plain(qkv, 6, 0.125, qspec, stats=True)
    close_float(got[0], ref[0], qspec)
    close(got[1], ref[1])
    close(got[2], ref[2])
    with pytest.raises(RuntimeError, match="CUDA error"):
        K.attention_core_f32_recip_probe_cuda(qkv[:, :100].contiguous(), 6,
                                              0.125, qspec)


# the fp32 core's long route (csrc/attention_core_f32_long_wgmma.cu,
# csrc/attention_core_f32_bwd_long_wgmma.cu): YOLOS-S's fused canvases
# (257 just past the one-CTA kernels, 357 at 256 px, 677 at 384 px, 701 at
# the fused gate), a ragged 300 and the score-block design's top, 768, at
# 12 heads of 32 and 6 of 64; past it (the forward's three-sweep design)
# yolos_tiny.json's fused canvases at 3 heads of 64 (769, 1001 at 480 px,
# 1017 at the fused gate), 3 heads of 32 at 1001, and the gate's longest
# at one head of 64 (1806) and of 32 (1837, the route's top)
F32_LONG_NS = [257, 300, 357, 677, 701, 768]
F32_SWEEP_CASES = [(769, 64, 3), (1001, 64, 3), (1017, 64, 3),
                   (1001, 32, 3), (1806, 64, 1), (1837, 32, 1)]
F32_LONG_CASES = [(n, d, heads) for n in F32_LONG_NS
                  for d, heads in ((32, 12), (64, 6))] + F32_SWEEP_CASES


@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("n,d,heads", F32_LONG_CASES)
def test_f32_long_core_forward(dev, n, d, heads, stats, b):
    """The long forward in each float format against its plain version:
    the snapped context under the float bar, the rowmax and reciprocal
    rowsum under the one-kernel bar; two launches a call (the split pass
    and the core), counted as attention_core_f32_long; a second call gives
    the same bits."""
    scale = d ** -0.5
    for i, qspec in enumerate(F32_CORE_QSPECS.values()):
        qkv = f32_core_qkv(b, n, heads, d, n * d + i + b, dev)
        run = lambda: K.attention_core_snap_cuda(qkv, heads, scale, qspec,
                                                 stats=stats)
        before = dict(K.LAUNCHES)
        got = run()
        assert K.LAUNCHES["attention_core_f32_long"] == \
            before["attention_core_f32_long"] + K.F32_LONG_FWD_LAUNCHES
        assert K.LAUNCHES["attention_core_f32"] == \
            before["attention_core_f32"]
        ref = K.attention_core_snap_plain(qkv, heads, scale, qspec,
                                          stats=stats)
        if stats:
            close_float(got[0], ref[0], qspec)
            close(got[1], ref[1])
            close(got[2], ref[2])
        else:
            close_float(got, ref, qspec)
        _same_twice(run, got)


@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("n,d,heads", F32_LONG_CASES)
def test_f32_long_core_backward(dev, n, d, heads, b):
    """The long backward against its plain version from the plain
    forward's statistics: dqkv under the chain bar, the per-image column
    sums under the sum bar; four launches a call (the split pass, dq,
    dk / dv, the column sums), counted as attention_core_f32_bwd_long; a
    second call gives the same bits."""
    scale = d ** -0.5
    qkv, d_o, m, rs = f32_core_bwd_inputs(b, n, heads, d, n * d + b, dev)
    run = lambda: K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs, heads,
                                                scale)
    before = dict(K.LAUNCHES)
    got = run()
    assert K.LAUNCHES["attention_core_f32_bwd_long"] == \
        before["attention_core_f32_bwd_long"] + K.F32_LONG_BWD_LAUNCHES
    assert K.LAUNCHES["attention_core_f32_bwd"] == \
        before["attention_core_f32_bwd"]
    want = K.attention_core_f32_bwd_plain(qkv, d_o, m, rs, heads, scale)
    close(got[0], want[0], CHAIN_ATOL)
    close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))
    _same_twice(run, got)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [1, 17, 64, 197])
def test_f32_long_core_forced_agrees_with_one_cta(dev, n, d):
    """Forced at N <= 256 (``tiled``), the long route against the one-CTA
    kernels, forward (FP16_32, with statistics) and backward."""
    heads, scale = 6, d ** -0.5
    qspec = F32_CORE_QSPECS["FP16_32"]
    qkv, d_o, _, _ = f32_core_bwd_inputs(4, n, heads, d, n + d, dev)
    long = K.attention_core_snap_cuda(qkv, heads, scale, qspec, stats=True,
                                      tiled=True)
    short = K.attention_core_snap_cuda(qkv, heads, scale, qspec, stats=True)
    close_float(long[0], short[0], qspec)
    close(long[1], short[1])
    close(long[2], short[2])
    m, rs = short[1], short[2]
    got = K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs, heads, scale,
                                        tiled=True)
    want = K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs, heads, scale)
    close(got[0], want[0], CHAIN_ATOL)
    close(got[1], want[1], SUM_ATOL * float(want[1].abs().max()))


def test_f32_long_launches_match_the_plan(dev):
    """The long route's own launch figures against K.f32_long_plan: grid,
    rows, tile, threads, ring stages, shared memory and launches exactly;
    CTAs an SM from the runtime's occupancy of the compiled kernels, equal
    to the plan's where shared memory alone sets it (the forward's score
    block above 256 tokens leaves room for one, the backward's kernels'
    for two), else at least the plan's."""
    cases = [(n, False) for n in F32_LONG_I8_NS + [1, 64, 197, 640, 641,
                                                   704, 705]]
    cases += [(n, False) for n, _, _ in F32_SWEEP_CASES]
    cases += [(n, True) for n in F32_SWEEP_FORCED_NS]
    for n, sweep in cases:
        for d in (32, 64):
            plan = K.f32_long_plan(n, d, sweep=sweep)
            got = K.f32_long_launch(n, d, sweep=sweep)
            assert got["launches"] == plan["launches"], (n, d)
            for key in ("fwd", "dq", "dkdv"):
                want, have = dict(plan[key]), dict(got[key])
                ctas = have.pop("ctas_per_sm")
                fits = K.SM_SHARED_BYTES // (want["smem"] +
                                             K.CTA_RESERVED_BYTES)
                assert ctas == want["ctas_per_sm"] if fits == \
                    want["ctas_per_sm"] else ctas >= want["ctas_per_sm"], \
                    (n, d, key, ctas)
                want.pop("ctas_per_sm")
                assert have == want, (n, d, key)


@pytest.mark.parametrize("d,heads", [(32, 12), (64, 6)])
@pytest.mark.parametrize("b,n", [(8, 577), (8, 677), (2, 677), (3, 768)])
def test_f32_long_core_same_bits_twice(dev, b, n, d, heads):
    """Two calls on the same inputs give the same bits: the forward in
    each mode (a float format's snap with statistics, the INT8 site's
    snap, the int8 grid) and the backward (no atomics, every sum in a
    fixed order, the split scratch written anew each call)."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    scale = d ** -0.5
    qkv, d_o, m, rs = f32_core_bwd_inputs(b, n, heads, d, 7 * n + d, dev)
    site = site_of(K.attention_context_f32(qkv, heads, scale))
    runs = [
        lambda: K.attention_core_snap_cuda(
            qkv, heads, scale, F32_CORE_QSPECS["FP16_32"], stats=True),
        lambda: K.attention_core_snap_cuda(qkv, heads, scale,
                                           Int8Sites(site), stats=True),
        lambda: K.attention_core_f32_cuda(qkv, heads, scale, site),
        lambda: K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs, heads,
                                              scale),
    ]
    for run in runs:
        got = run()
        torch.cuda.synchronize()
        _same_twice(run, got)


def test_f32_long_core_refuses_what_it_does_not_take(dev):
    """Past the route's top, the longest sequence that the fused gate lets
    through at a head width of 32 or 64 (1837, one head of 32), in every
    mode (the float and INT8 QAT snaps, the converted model's int8 grid),
    forced into the three-sweep design, and in the backward; the C entry
    points report that top and the score-block design's, 768."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    lib = K._lib()
    assert lib.mvt_attention_core_f32_long_max_n() == K.F32_LONG_MAX_N
    assert lib.mvt_attention_core_f32_bwd_long_max_n() == K.F32_LONG_MAX_N
    assert lib.mvt_attention_core_f32_long_block_max_n() == \
        K.F32_LONG_BLOCK_MAX_N
    n = K.F32_LONG_MAX_N + 1
    qkv = torch.zeros(1, n, 3 * 64, device=dev)
    site = torch.tensor([0.1, 128.0, 1.0], device=dev)
    with pytest.raises(NotImplementedError, match="fused gate"):
        K.attention_core_snap_cuda(qkv, 1, 0.125, (5, 10, False))
    with pytest.raises(NotImplementedError, match="fused gate"):
        K.attention_core_snap_cuda(qkv, 1, 0.125, Int8Sites(site),
                                   sweep=True)
    with pytest.raises(NotImplementedError, match="fused gate"):
        K.attention_core_f32_cuda(qkv, 1, 0.125, site)
    with pytest.raises(NotImplementedError, match="fused gate"):
        K.attention_core_f32_bwd_cuda(
            qkv, torch.zeros(1, n, 64, device=dev),
            *[torch.zeros(1, 1, n, device=dev)] * 2, 1, 0.125)


# the long route's int8 modes: the converted model's int8 grid (K9 above
# 256 tokens) and INT8 QAT's site snap with and without the statistics (K1
# int8 above 256 tokens), at the long lengths and ViT-S/16's 577 tokens at
# 384 px; a site with statistics and one without
F32_LONG_I8_NS = [257, 300, 357, 577, 677, 701, 768]
F32_LONG_I8_CASES = [(n, d, heads) for n in F32_LONG_I8_NS
                     for d, heads in ((32, 12), (64, 6))] + F32_SWEEP_CASES
F32_LONG_I8_MODES = ["int8", "sites", "sites+stats", "int8 fresh",
                     "sites fresh"]


@pytest.mark.parametrize("b", [2, 8])
@pytest.mark.parametrize("n,d,heads", F32_LONG_I8_CASES)
def test_f32_long_core_int8_modes(dev, n, d, heads, b):
    """Each int8 mode of the long forward against its plain version: the
    int8 grid under the INT8 bar, the site's snap under the site bar (no
    statistics: the context as it is, within the fp32 noise), the
    statistics under the one-kernel bar; two launches a call (the split
    pass and the core), counted as attention_core_f32_long; a second call
    gives the same bits."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    scale = d ** -0.5
    for i, mode in enumerate(F32_LONG_I8_MODES):
        qkv = f32_core_qkv(b, n, heads, d, n * d + b + 10 * i, dev)
        site = site_of(K.attention_context_f32(qkv, heads, scale))
        if mode.endswith("fresh"):
            site = torch.tensor([1.1920929e-7, 0.0, 0.0], device=dev)
        stats = mode.endswith("+stats")
        if mode.startswith("int8"):
            run = lambda: K.attention_core_f32_cuda(qkv, heads, scale, site)
            ref = K.attention_core_f32_plain(qkv, heads, scale, site)
        else:
            run = lambda: K.attention_core_snap_cuda(
                qkv, heads, scale, Int8Sites(site), stats=stats)
            ref = K.attention_core_snap_plain(qkv, heads, scale,
                                              Int8Sites(site), stats=stats)
        before = dict(K.LAUNCHES)
        got = run()
        assert K.LAUNCHES["attention_core_f32_long"] == \
            before["attention_core_f32_long"] + K.F32_LONG_FWD_LAUNCHES, mode
        assert K.LAUNCHES["attention_core_f32"] == \
            before["attention_core_f32"], mode
        out, want = (got[0], ref[0]) if stats else (got, ref)
        if mode.startswith("int8"):
            close_on_grid(out, want, 1)
        elif mode.endswith("fresh"):
            close(out, want, FLOAT_TIGHT * float(want.abs().max()))
        else:
            close_sites(out, want, step_of(site))
        if stats:
            close(got[1], ref[1])
            close(got[2], ref[2])
        _same_twice(run, got)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [1, 17, 64, 197])
def test_f32_long_core_int8_forced_agrees_with_one_cta(dev, n, d):
    """Forced at N <= 256 (``tiled``), the long route's int8 modes against
    the one-CTA kernel's: the int8 grid under the INT8 bar, the site's
    snap under the site bar, the statistics under the one-kernel bar."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    heads, scale = 6, d ** -0.5
    qkv = f32_core_qkv(4, n, heads, d, n + d + 3, dev)
    site = site_of(K.attention_context_f32(qkv, heads, scale))
    long = K.attention_core_f32_cuda(qkv, heads, scale, site, tiled=True)
    short = K.attention_core_f32_cuda(qkv, heads, scale, site)
    close_on_grid(long, short, 1)
    long = K.attention_core_snap_cuda(qkv, heads, scale, Int8Sites(site),
                                      stats=True, tiled=True)
    short = K.attention_core_snap_cuda(qkv, heads, scale, Int8Sites(site),
                                       stats=True)
    close_sites(long[0], short[0], step_of(site))
    close(long[1], short[1])
    close(long[2], short[2])


# the three-sweep design forced where the score-block design runs
F32_SWEEP_FORCED_NS = [257, 300, 677, 701, 768]


@pytest.mark.parametrize("d,heads", [(32, 12), (64, 6)])
@pytest.mark.parametrize("n", F32_SWEEP_FORCED_NS)
def test_f32_sweep_core_forced_against_the_block_design(dev, n, d, heads):
    """Forced at N <= 768, the three-sweep design and the score-block
    design, each against the plain version in every mode (a float format's
    snap with the statistics, INT8 QAT's site snap with the statistics, the
    int8 grid) at its bar; the three-sweep design's scores are the plain
    version's in-order sums, so its row max is the plain version's bit for
    bit; the share of elements where the two designs differ is printed.
    Two launches a call either way."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    scale = d ** -0.5
    qkv = f32_core_qkv(2, n, heads, d, 3 * n + d, dev)
    site = site_of(K.attention_context_f32(qkv, heads, scale))
    qspec = F32_CORE_QSPECS["FP16_32"]
    ref = K.attention_core_snap_plain(qkv, heads, scale, qspec, stats=True)
    ref_site = K.attention_core_snap_plain(qkv, heads, scale, Int8Sites(site),
                                           stats=True)
    ref_grid = K.attention_core_f32_plain(qkv, heads, scale, site)
    differ = []
    for sweep in (False, True):
        before = K.LAUNCHES["attention_core_f32_long"]
        got = K.attention_core_snap_cuda(qkv, heads, scale, qspec, stats=True,
                                         sweep=sweep)
        got_site = K.attention_core_snap_cuda(qkv, heads, scale,
                                              Int8Sites(site), stats=True,
                                              sweep=sweep)
        got_grid = K.attention_core_f32_cuda(qkv, heads, scale, site,
                                             sweep=sweep)
        assert K.LAUNCHES["attention_core_f32_long"] == \
            before + 3 * K.F32_LONG_FWD_LAUNCHES
        close_float(got[0], ref[0], qspec)
        close_sites(got_site[0], ref_site[0], step_of(site))
        close_on_grid(got_grid, ref_grid, 1)
        for x, y in ((got, ref), (got_site, ref_site)):
            close(x[1], y[1])
            close(x[2], y[2])
        differ.append((got, got_site, got_grid))
    assert torch.equal(differ[1][0][1], ref[1])
    shares = [float((x != y).double().mean())
              for x, y in ((differ[0][0][0], differ[1][0][0]),
                           (differ[0][1][0], differ[1][1][0]),
                           (differ[0][2], differ[1][2]))]
    print(f"N={n} D={d}: the designs differ in {shares} of the elements "
          "(FP16_32 context, INT8 site context, int8 grid)")


# The cluster design past 768 tokens (attention_core_f32_cluster_kernel):
# (B, N, D, heads) at just past the score block's top (13 key tiles: a
# cluster of 4 at 3 heads, the last rank one tile; a cluster of 8 at one
# (image, head), the last rank none), YOLOS-Ti's 480 px canvas, and the
# route's top at one head of 32 and of 64 (29 tiles, no multiple of the
# cluster); each at the plan's cluster for its (image, head) pairs
F32_CLUSTER_CASES = [(2, 769, 64, 3), (1, 769, 64, 1), (2, 1001, 64, 3),
                     (2, 1837, 32, 1), (1, 1837, 32, 1), (2, 1806, 64, 1),
                     (8, 1001, 32, 3)]


@pytest.mark.parametrize("b,n,d,heads", F32_CLUSTER_CASES)
def test_f32_cluster_core_modes_and_bits(dev, b, n, d, heads):
    """Each mode of the cluster design (a float format's snap with the
    statistics, INT8 QAT's site snap with the statistics, the int8 grid)
    against the plain version at its bar, the row max the plain version's
    bit for bit (its scores are the plain version's in-order sums), and
    every output again, bit for bit, from a second call (no atomics: the
    ranks' rowsums and partial contexts add in rank order)."""
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    scale = d ** -0.5
    qkv = f32_core_qkv(b, n, heads, d, 5 * n + d + b, dev)
    site = site_of(K.attention_context_f32(qkv, heads, scale))
    qspec = F32_CORE_QSPECS["FP16_32"]
    runs = {
        "float": lambda: K.attention_core_snap_cuda(qkv, heads, scale, qspec,
                                                    stats=True),
        "site": lambda: K.attention_core_snap_cuda(
            qkv, heads, scale, Int8Sites(site), stats=True),
        "grid": lambda: K.attention_core_f32_cuda(qkv, heads, scale, site)}
    refs = {
        "float": K.attention_core_snap_plain(qkv, heads, scale, qspec,
                                             stats=True),
        "site": K.attention_core_snap_plain(qkv, heads, scale,
                                            Int8Sites(site), stats=True),
        "grid": K.attention_core_f32_plain(qkv, heads, scale, site)}
    for mode, run in runs.items():
        before = K.LAUNCHES["attention_core_f32_long"]
        got = run()
        assert K.LAUNCHES["attention_core_f32_long"] == \
            before + K.F32_LONG_FWD_LAUNCHES, mode
        ref = refs[mode]
        if mode == "grid":
            close_on_grid(got, ref, 1)
        else:
            if mode == "float":
                close_float(got[0], ref[0], qspec)
            else:
                close_sites(got[0], ref[0], step_of(site))
            assert torch.equal(got[1], ref[1]), mode
            close(got[2], ref[2])
        _same_twice(run, got)


def test_f32_cluster_launches_match_the_plan(dev):
    """The cluster design's own figures for the (image, head) pairs of the
    main path's shapes (cluster size, CTAs per (image, head), key tiles a
    CTA, shared memory, threads, CTAs an SM) against K.f32_long_plan with
    the device's SM count, and at least one cluster of that size fitting
    the device at once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [(n, d, b * heads) for b, n, d, heads in F32_CLUSTER_CASES]
    cases += [(n, d, bh) for n in (257, 300, 677, 768, 769, 1001, 1837)
              for d in (32, 64) for bh in (1, 6, 24, 64)]
    for n, d, bh in cases:
        plan = K.f32_long_plan(n, d, b=bh, sweep=True, sms=sms)
        got = K.f32_long_launch(n, d, sweep=True, bh=bh)
        assert got["fwd"] == plan["fwd"], (n, d, bh)
        assert got["clusters"] >= 1, (n, d, bh)
        fwd = plan["fwd"]
        assert fwd["cluster"] * fwd["stages"] >= plan["tiles"], (n, d, bh)
        assert fwd["ctas_per_sm"] == 1 and \
            fwd["smem"] <= K.F32_LONG_SMEM_OPTIN, (n, d, bh)


# ------------------------------------------------ distillation (DeiT)
# The teacher's convolutions run in fp32 without TF32 on the card, so its
# logits are the CPU's up to fp32 roundoff (cuDNN's and the CPU's sums
# ordered differently): 1e-4 of the largest logit; TF32 would be ~1e-3.
TEACHER_BAR = 1e-4


@pytest.mark.parametrize("arch", ["resnet18", "resnet50", "mnasnet1_0",
                                  "mobilenet_v2", "shufflenet_v2_x1_0",
                                  "squeezenet1_0", "squeezenet1_1"])
def test_cnn_on_the_card_matches_the_cpu(dev, arch, tmp_path):
    from myrtle_vision_tpu_torch.models.cnn import (
        apply_any_torch_sd,
        random_any_state_dict,
    )
    from myrtle_vision_tpu_torch.models.resnet import make_teacher_fn

    sd = {k: torch.as_tensor(v) for k, v in
          random_any_state_dict(arch, 45, seed=1).items()}
    img = torch.from_numpy(np.random.RandomState(2).uniform(
        -1, 1, (4, 224, 224, 3)).astype(np.float32))
    params = {k: v.float() for k, v in sd.items()
              if not k.endswith("num_batches_tracked")}
    ref = apply_any_torch_sd(params, img, arch)
    got = apply_any_torch_sd({k: v.to(dev) for k, v in params.items()},
                             img.to(dev), arch)
    bar = TEACHER_BAR * float(ref.abs().max())
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=bar)
    if arch.startswith("resnet"):
        path = str(tmp_path / "teacher.pth")
        torch.save(sd, path)
        teacher = make_teacher_fn(path, arch, device=dev)
        torch.testing.assert_close(teacher(img.to(dev)).cpu(), ref, rtol=0,
                                   atol=bar)


def test_distilled_student_trains_through_the_kernels(dev, tmp_path):
    """The DeiT wrapper's loss and gradients through the fused chains
    (N = 37 + the distillation token) against the plain path, the
    launches one op per block, forward and backward."""
    from myrtle_vision_tpu_torch.models.distill import DistillWrapper
    from myrtle_vision_tpu_torch.models.resnet import (
        make_teacher_fn,
        random_state_dict,
    )

    path = str(tmp_path / "teacher.pth")
    torch.save({k: torch.as_tensor(v) for k, v in
                random_state_dict("resnet50", 7).items()}, path)
    teacher = make_teacher_fn(path, device=dev)
    kw = dict(decoder="classification", image_size=96, patch_size=16,
              num_classes=7, dim=128, depth=3, heads=2, mlp_dim=256)
    model = DistillWrapper(ViT(**kw, device=dev), temperature=3.0)
    img = torch.from_numpy(
        np.random.RandomState(4).uniform(-1, 1, (4, 96, 96, 3)).astype(
            np.float32)).to(dev)
    labels = torch.tensor([0, 3, 6, 2], device=dev)
    runs = []
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        before = (fused_attention_block.launches, fused_mlp_block.launches,
                  fused_attention_block.bwd_launches,
                  fused_mlp_block.bwd_launches)
        loss, _ = model(img, labels, teacher(img), plain=plain)
        loss.backward()
        after = (fused_attention_block.launches, fused_mlp_block.launches,
                 fused_attention_block.bwd_launches,
                 fused_mlp_block.bwd_launches)
        assert tuple(a - b for a, b in zip(after, before)) == \
            ((0,) * 4 if plain else (3,) * 4)
        runs.append((loss.item(), {n: p.grad.clone() for n, p in
                                   model.named_parameters()
                                   if p.grad is not None}))
    (k_loss, k_grads), (p_loss, p_grads) = runs
    assert abs(k_loss - p_loss) <= 2.0 ** -6 * max(1.0, abs(p_loss))
    for name, ref in p_grads.items():
        got = k_grads[name]
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(
            got, ref, rtol=2.0 ** -4,
            atol=2.0 ** -4 * max(float(ref.abs().max()), 1e-3), msg=name)


# compute_dtype float32.  The fp32 flash kernels run every product as
# 3xTF32 on the tensor cores (csrc/flash_tf32.cuh: about 2^-22 of each
# product off true fp32), against the plain version's true fp32.  Bar per
# element 2^-14 of |plain| plus 2^-14 of the largest |plain| (outputs and
# the LSE); 2^-12 of the largest for dq, dk and dv, sums over up to 2601
# rows (tests/test_torch_flash_f32_split.py holds the same arithmetic to
# the same bars against JAX on the CPU).
F32_FLASH_RTOL = 2.0 ** -14
F32_FLASH_ATOL = 2.0 ** -14
F32_FLASH_GRAD_ATOL = 2.0 ** -12
# The fp32 block-half chains (the qspec chains snapping nothing) take
# 3-pass bf16 products, about 2^-16 of each product off, against the plain
# chain's true fp32: bar 2^-10 of |plain| plus 2^-10 of the largest
# |plain| for the outputs and dx, 2^-8 of the largest for the parameter
# gradients, sums over the B N rows.
F32_CHAIN_RTOL = 2.0 ** -10
F32_CHAIN_ATOL = 2.0 ** -10
F32_CHAIN_SUM_ATOL = 2.0 ** -8
F32_FLASH_N = [1, 17, 50, 197, 1536, 1545, 2601]


def close_f32(got, ref, rtol, atol_share):
    """fp32 against fp32: |got - ref| <= rtol |ref| + atol_share times the
    largest |ref| (at least 1)."""
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert got.dtype == ref.dtype == torch.float32
    atol = atol_share * max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


def f32_qkv_views(b, n, h, d, seed, dev):
    """q, k, v: views of fused fp32 qkv rows, std 1, from a seed, as the
    discrete Block hands them over."""
    gen = torch.Generator(dev).manual_seed(seed)
    rows = torch.randn(b, n, 3 * h * d, device=dev, generator=gen)
    return rows.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", F32_FLASH_N)
def test_f32_flash_forward_matches_plain(dev, n, d, masked):
    """K5 / K6 on fp32: output and LSE against the plain version in its
    regime (unblocked up to n_pad 1536, blocked above); two launches."""
    assert not torch.backends.cuda.matmul.allow_tf32
    q, k, v = f32_qkv_views(2, n, 2, d, n * d + 5, dev)
    n_valid = edge_n_valid(n, masked)
    before = K.LAUNCHES["flash_attention_f32_fwd"]
    got = K.flash_attention_f32_fwd_cuda(q, k, v, d ** -0.5, n_valid,
                                         lse=True)
    assert K.LAUNCHES["flash_attention_f32_fwd"] == \
        before + K.F32_FLASH_FWD_LAUNCHES
    ref = flash_attention_plain(q, k, v, d ** -0.5, n_valid, lse=True)
    close_f32(got[0], ref[0], F32_FLASH_RTOL, F32_FLASH_ATOL)
    close_f32(got[1], ref[1], F32_FLASH_RTOL, F32_FLASH_ATOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", F32_FLASH_N)
def test_f32_flash_backward_matches_plain(dev, n, d, masked):
    """K7 / K8 on fp32: dq, dk, dv against the plain backward in its
    regime, both from the kernel forward's o (its (B, N, H, D)-storage
    view) and LSE, do contiguous; zero rows past n_valid; four launches
    a call."""
    q, k, v = f32_qkv_views(2, n, 2, d, n * d + 6, dev)
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(
        dev).manual_seed(n + 7))
    n_valid, sc = edge_n_valid(n, masked), d ** -0.5
    o, lse = K.flash_attention_f32_fwd_cuda(q, k, v, sc, n_valid, lse=True)
    before = K.LAUNCHES["flash_attention_f32_bwd"]
    got = K.flash_attention_f32_bwd_cuda(q, k, v, o, do, lse, sc, n_valid)
    assert K.LAUNCHES["flash_attention_f32_bwd"] == \
        before + K.F32_FLASH_BWD_LAUNCHES
    ref = flash_attention_bwd_plain(q, k, v, o, do, lse, sc, n_valid)
    for g, r in zip(got, ref):
        close_f32(g, r, F32_FLASH_RTOL, F32_FLASH_GRAD_ATOL)
    if n_valid is not None:
        for g in got:
            assert not g[:, :, n_valid:].any()


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [50, 197])
def test_f32_flash_split_pass_is_split_tf32(dev, n, d, monkeypatch):
    """The split pass's halves, bit for bit, are ``split_tf32`` of the
    operands in :func:`flash_f32_split_plain`'s layouts: the forward's K
    as it lies and V transposed; the backward's K, V, q and do as they lie,
    then K, q and do transposed."""
    q, k, v = f32_qkv_views(2, n, 2, d, n + d, dev)
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(
        dev).manual_seed(n))
    split, scratch = [], K._flash_f32_scratch

    def kept(*args):
        split.append(scratch(*args))
        return split[-1]

    monkeypatch.setattr(K, "_flash_f32_scratch", kept)
    o, lse = K.flash_attention_f32_fwd_cuda(q, k, v, d ** -0.5, lse=True)
    K.flash_attention_f32_bwd_cuda(q, k, v, o, do, lse, d ** -0.5)
    torch.cuda.synchronize()
    fwd = torch.cat([flash_f32_split_plain(k).flatten(),
                     flash_f32_split_plain(v, True).flatten()])
    bwd = torch.cat([*(flash_f32_split_plain(t).flatten()
                       for t in (k, v, q, do)),
                     *(flash_f32_split_plain(t, True).flatten()
                       for t in (k, q, do))])
    for got, want in zip(split, (fwd, bwd)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_f32_flash_same_bits_twice(dev):
    """No atomics: a second call gives the same bits, forward and
    backward."""
    q, k, v = f32_qkv_views(2, 1545, 2, 64, 11, dev)
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(
        dev).manual_seed(12))
    sc, n_valid = 0.125, 1400
    o, lse = K.flash_attention_f32_fwd_cuda(q, k, v, sc, n_valid, lse=True)
    _same_twice(lambda: K.flash_attention_f32_fwd_cuda(q, k, v, sc, n_valid,
                                                       lse=True), (o, lse))
    grads = K.flash_attention_f32_bwd_cuda(q, k, v, o, do, lse, sc, n_valid)
    _same_twice(lambda: K.flash_attention_f32_bwd_cuda(q, k, v, o, do, lse,
                                                       sc, n_valid), grads)


@pytest.mark.parametrize("n,n_valid", [(300, 70), (300, 100), (130, 64),
                                       (2601, 900)])
def test_f32_flash_masked_tiles(dev, n, n_valid):
    """n_valid inside a 64-token tile and whole tiles past it (never
    visited): output, LSE and gradients against the plain versions, zero
    gradient rows past n_valid."""
    q, k, v = f32_qkv_views(2, n, 2, 64, n + n_valid, dev)
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(
        dev).manual_seed(n_valid))
    sc = 0.125
    o, lse = K.flash_attention_f32_fwd_cuda(q, k, v, sc, n_valid, lse=True)
    ref = flash_attention_plain(q, k, v, sc, n_valid, lse=True)
    for g, r in zip((o, lse), ref):
        close_f32(g, r, F32_FLASH_RTOL, F32_FLASH_ATOL)
    grads = K.flash_attention_f32_bwd_cuda(q, k, v, o, do, lse, sc, n_valid)
    refs = flash_attention_bwd_plain(q, k, v, o, do, lse, sc, n_valid)
    for g, r in zip(grads, refs):
        close_f32(g, r, F32_FLASH_RTOL, F32_FLASH_GRAD_ATOL)
        assert not g[:, :, n_valid:].any()


def test_f32_flash_contiguous_operands_match_views(dev):
    """q, k, v as (B, H, N, D) views of the fused qkv rows and as
    contiguous copies give the same bits."""
    q, k, v = f32_qkv_views(2, 197, 6, 64, 13, dev)
    sc = 0.125
    views = K.flash_attention_f32_fwd_cuda(q, k, v, sc, lse=True)
    copies = K.flash_attention_f32_fwd_cuda(
        *(t.contiguous() for t in (q, k, v)), sc, lse=True)
    torch.cuda.synchronize()
    for a, b in zip(views, copies):
        assert torch.equal(a, b)


def test_f32_flash_expanded_output_gradient(dev):
    """The gradient of a sum reaches the backward as a stride-0 expanded
    tensor: q, k, v gradients through flash_attention against the plain
    versions' autograd."""
    q, k, v = f32_qkv_views(2, 300, 2, 32, 14, dev)
    runs = []
    for plain in (False, True):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        flash_attention(*leaves, 32 ** -0.5, 250, plain=plain).sum() \
            .backward()
        runs.append([t.grad for t in leaves])
    for g, r in zip(*runs):
        close_f32(g, r, F32_FLASH_RTOL, F32_FLASH_GRAD_ATOL)


def test_f32_flash_dispatch_and_refusals(dev):
    """flash_attention takes the kernels of the operands' dtype, forward
    and backward; the fp32 wrappers refuse what they do not take."""
    q, k, v = f32_qkv_views(1, 40, 2, 64, 3, dev)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    before = (K.LAUNCHES["flash_attention_f32_fwd"],
              K.LAUNCHES["flash_attention_f32_bwd"],
              K.LAUNCHES["flash_attention_fwd"])
    flash_attention(q, k, v, 0.125).sum().backward()
    assert (K.LAUNCHES["flash_attention_f32_fwd"],
            K.LAUNCHES["flash_attention_f32_bwd"],
            K.LAUNCHES["flash_attention_fwd"]) == (
        before[0] + K.F32_FLASH_FWD_LAUNCHES,
        before[1] + K.F32_FLASH_BWD_LAUNCHES, before[2])
    with pytest.raises(TypeError, match="no kernel for torch.float16"):
        flash_attention(*(t.detach().half() for t in (q, k, v)), 0.125)
    x = torch.zeros(1, 2, 40, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="fp32"):
        K.flash_attention_f32_fwd_cuda(x, x, x, 0.125)
    x = torch.zeros(1, 2, 40, 48, device=dev)
    with pytest.raises(ValueError, match="head width 48"):
        K.flash_attention_f32_fwd_cuda(x, x, x, 0.125)
    x = torch.zeros(1, 2, 40, 64, device=dev)
    with pytest.raises(ValueError, match="n_valid 41"):
        K.flash_attention_f32_bwd_cuda(x, x, x, x, x, torch.zeros(
            1, 2, 40, device=dev), 0.125, n_valid=41)


def f32_block(c, hid, b, n, seed, dev):
    """:func:`block` with fp32 activations."""
    x, attn, mlp = block(c, hid, b, n, seed, dev)
    return x.float(), attn, mlp


@pytest.mark.parametrize("n", [197, 677])
def test_f32_block_chains_match_plain(dev, n):
    """The fp32 K1-K4 route (the qspec chains with no site snapping)
    against the plain chains' true fp32, forward and backward, at ViT-S/16
    (197 tokens) and YOLOS-S at 384 px (677: the long fp32 core)."""
    x, attn, mlp = f32_block(384, 1536, 2, n, n + 11, dev)
    scale = 64 ** -0.5
    for op, plain, params, extra in (
            (fused_attention_block, fused_attention_block_plain, attn,
             (6, scale)),
            (fused_mlp_block, fused_mlp_block_plain, mlp, ())):
        before = (op.launches, op.bwd_launches)
        close_f32(op(x, *params, *extra), plain(x, *params, *extra),
                  F32_CHAIN_RTOL, F32_CHAIN_ATOL)
        do = torch.randn(x.shape, device=dev, generator=torch.Generator(
            dev).manual_seed(n))
        got = grads_of(op, x, params, extra, do)
        ref = grads_of(plain, x, params, extra, do)
        assert (op.launches, op.bwd_launches) == (before[0] + 2,
                                                  before[1] + 1)
        close_f32(got[0], ref[0], F32_CHAIN_RTOL, F32_CHAIN_ATOL)
        for g, r in zip(got[1:], ref[1:]):
            close_f32(g, r, F32_CHAIN_RTOL, F32_CHAIN_SUM_ATOL)


# ------------------------------------------------- res_scale (B10)
# Head-sharded tensor parallelism runs K1-K4 with ``res_scale`` 1/n_tp:
# gemm_bf16_epilogue's and gemm_f32x3_epilogue's residual epilogues
# (residual * res_scale + (acc + bias)) and layernorm_rows_bwd in both
# forms (dx = do * res_scale + the LayerNorm's part).  Shapes: ViT-S/16's
# local widths at n_tp = 2 (C 384, 3 heads of 64, qkv 576, hidden 768).
RES_SCALES = [0.5, 0.25]


def local_block(b, n, seed, dev, dtype=torch.bfloat16, c=384, cl=192,
                hid=768):
    """x (B, N, C) and the local weights of one model rank: the attention
    half's (C, 3 cl) and (cl, C), the MLP half's (C, hid) and (hid, C),
    each the (in, out) view of a row-major torch weight, as the Block's
    tensor-parallel branch hands them over."""
    rng = np.random.RandomState(seed)

    def t(*shape, std=1.0, dt=torch.float32):
        return torch.from_numpy(
            (rng.randn(*shape) * std).astype(np.float32)).to(dev, dt)

    x = t(b, n, c, dt=dtype)
    attn = [1 + t(c, std=0.1), t(c, std=0.1),
            t(3 * cl, c, std=c ** -0.5).t(), t(3 * cl),
            t(c, cl, std=cl ** -0.5).contiguous().t(), t(c) * 0.5]
    mlp = [1 + t(c, std=0.1), t(c, std=0.1), t(hid, c, std=c ** -0.5).t(),
           t(hid), t(c, hid, std=hid ** -0.5).contiguous().t(), t(c) * 0.5]
    return x, attn, mlp


@pytest.mark.parametrize("res_scale", RES_SCALES)
def test_res_scale_kernels_match_plain(dev, res_scale):
    """The three kernels in their res_scale form against their plain
    versions, each launch counted in RES_SCALE_LAUNCHES; with res_scale 1
    the same bits as a call without it, and no count."""
    from myrtle_vision_tpu_torch.ops.fake_quant import kernel_sites
    from myrtle_vision_tpu_torch.ops.fused_attention_block import (
        no_snap_sites,
    )

    rng = np.random.RandomState(11)
    m, k, n = 4 * 197, 192, 384

    def t(*shape, dt=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, dt)

    a, w = t(m, k, dt=torch.bfloat16), t(n, k, dt=torch.bfloat16).t()
    bias, res = t(n), t(m, n, dt=torch.bfloat16)
    K.reset_launches()
    got = K.gemm_bf16_epilogue_cuda(a, w, bias, "bias_residual", res,
                                    res_scale=res_scale)
    close(got, K.gemm_bf16_epilogue_plain(a, w, bias, "bias_residual", res,
                                          res_scale=res_scale))
    one = K.gemm_bf16_epilogue_cuda(a, w, bias, "bias_residual", res,
                                    res_scale=1.0)
    assert torch.equal(one, K.gemm_bf16_epilogue_cuda(
        a, w, bias, "bias_residual", res))
    sites = kernel_sites(no_snap_sites(dev), 3, 4)
    a32, w32, r32 = a.float(), t(n, k).t(), res.float()
    got = K.gemm_f32x3_epilogue_cuda(a32, w32, bias, "bias_snap_residual_snap",
                                     sites, r32, res_scale=res_scale)
    ref = K.gemm_f32x3_epilogue_plain(a32, w32, bias,
                                      "bias_snap_residual_snap", sites, r32,
                                      res_scale=res_scale)
    close_f32(got, ref, F32_CHAIN_RTOL, F32_CHAIN_ATOL)
    x, do, dxn, sc = (t(m, n, dt=torch.bfloat16), t(m, n, dt=torch.bfloat16),
                      t(m, n), 1 + 0.1 * t(n, dt=torch.bfloat16))
    got = K.layernorm_rows_bwd_cuda(x, sc, dxn, do, res_scale=res_scale)
    ref = K.layernorm_rows_bwd_plain(x, sc, dxn, do, res_scale=res_scale)
    close(got[0], ref[0], CHAIN_ATOL)
    for g, r in zip(got[1:], ref[1:]):
        close(g, r, SUM_ATOL * max(1.0, float(r.abs().max())))
    snap = kernel_sites(no_snap_sites(dev))
    got = K.layernorm_rows_bwd_cuda(x.float(), sc.float(), dxn, do.float(),
                                    snap, res_scale=res_scale)
    ref = K.layernorm_rows_bwd_plain(x.float(), sc.float(), dxn, do.float(),
                                     snap, res_scale=res_scale)
    for g, r in zip(got, ref):
        close_f32(g, r, F32_CHAIN_RTOL, F32_CHAIN_SUM_ATOL)
    assert K.RES_SCALE_LAUNCHES == {
        "gemm_bf16_epilogue": 1, "gemm_f32x3_epilogue": 1,
        "layernorm_rows_bwd": 1, "layernorm_snap_rows_bwd": 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("res_scale", RES_SCALES)
def test_res_scale_chains_match_plain(dev, res_scale, dtype):
    """Both block halves on one model rank's local heads and hidden
    columns, forward and backward, in the bf16 chain and the fp32 one
    (compute_dtype float32), against their plain chains: the bf16 chain
    and sum bars, or the fp32 chain's."""
    x, attn, mlp = local_block(4, 197, 7, dev, dtype)
    do = torch.randn(x.shape, device=dev, generator=torch.Generator(
        dev).manual_seed(3)).to(dtype)
    scale = 64 ** -0.5
    K.reset_launches()
    for op, plain, params, extra, names in (
            (fused_attention_block, fused_attention_block_plain, attn,
             (3, scale, None, None, res_scale),
             ["x", "scale", "bias", "wqkv", "bqkv", "wp", "bp"]),
            (fused_mlp_block, fused_mlp_block_plain, mlp,
             (None, res_scale), ["x", "scale", "bias", "w1", "b1", "w2",
                                 "b2"])):
        out = op(x, *params, *extra)
        ref = plain(x, *params, *extra)
        got_g = grads_of(op, x, params, extra, do)
        ref_g = grads_of(plain, x, params, extra, do)
        if dtype == torch.bfloat16:
            close(out, ref, CHAIN_ATOL)
            close_grads(got_g, ref_g, names)
        else:
            close_f32(out, ref, F32_CHAIN_RTOL, F32_CHAIN_ATOL)
            for g, r, name in zip(got_g, ref_g, names):
                close_f32(g, r, F32_CHAIN_RTOL, F32_CHAIN_ATOL if name == "x"
                          else F32_CHAIN_SUM_ATOL)
    counted = K.RES_SCALE_LAUNCHES
    if dtype == torch.bfloat16:
        assert counted["gemm_bf16_epilogue"] == 4  # 2 halves x (out, grads)
        assert counted["layernorm_rows_bwd"] == 2
    else:
        assert counted["gemm_f32x3_epilogue"] == 4
        assert counted["layernorm_snap_rows_bwd"] == 2


def test_res_scale_refusals(dev):
    """A res_scale that is not a real number, or not finite, raises in the
    kernel wrappers and the plain versions alike."""
    x, attn, _ = local_block(1, 17, 1, dev)
    for bad, err in (("0.5", TypeError), (True, TypeError),
                     (torch.tensor(0.5), TypeError),
                     (float("nan"), ValueError), (float("inf"), ValueError)):
        for op in (fused_attention_block, fused_attention_block_plain):
            with pytest.raises(err):
                op(x, *attn, 3, 0.125, res_scale=bad)
        with pytest.raises(err):
            K.layernorm_rows_bwd_cuda(x[0], attn[0].to(x.dtype),
                                      x[0].float(), x[0], res_scale=bad)
