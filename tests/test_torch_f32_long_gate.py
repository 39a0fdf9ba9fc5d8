"""The fused attention block's fp32 core past 768 tokens, the port against
the JAX package on the CPU, at the widths of yolos_tiny.json and
vit_tiny.json (dim 192, 3 heads of 64, MLP 768), where the JAX gate
``fuses_at`` fuses up to 1017 tokens and the card takes the long core's
cluster design (csrc/attention_core_f32_long_wgmma.cu) above 768:

- the long route's limit against the gate: every length ``fuses_at`` lets
  through at a head width of 32 or 64 is one the route takes;
- the FP16_32 attention half at N = 800, forward and gradients, against
  the JAX ``fused_attention_block`` with ``qspec`` (K1 / K2 in interpret
  mode);
- the PyTorchINT8 QAT attention half (K1 / K2 int8) and the converted
  attention half (K9) at N = 800;
- a yolos_tiny-width detector (depth 1, 100 detection tokens) on a 448 px
  canvas, 885 tokens, in FP16_32: one QAT step against the JAX step.

Inputs from np.random.RandomState; the bars are those of the same checks
at shorter lengths (tests/test_torch_float_detection.py,
tests/test_torch_int8_long.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtle_vision_tpu.ops import fake_quant as jfq
from myrtle_vision_tpu.ops import fused_attention_block as jfa
from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fused_attention_block import (
    fused_attention_block,
    fuses_at,
)
from myrtle_vision_tpu_torch.quantize import QSPECS, QFormat

from test_torch_float_detection import (
    BLOCK_BAR,
    check_qat_step,
    fmt_step,
    grads_close,
)
from test_torch_int8_long import check_converted_half, check_int8_qat_attention

C, HEADS, HID = 192, 3, 768
D = C // HEADS
SCALE = D ** -0.5
N = 800
DET_KW = dict(decoder="detection", image_size=160, patch_size=16,
              num_classes=3, dim=C, depth=1, heads=HEADS, mlp_dim=HID,
              dim_head=D, num_det_tokens=100)
CANVAS = 448


def longest_fused(heads, d, gate):
    """The longest sequence that ``gate`` fuses at ``heads`` heads of d."""
    lo, hi = 1, 4096
    assert gate(lo, heads, d) and not gate(hi, heads, d)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if gate(mid, heads, d) else (lo, mid)
    return lo


def test_long_route_takes_every_length_the_gate_fuses():
    """The route's limit is the longest sequence the JAX gate fuses at one
    head of 32 (one head of 64 fuses up to 1806); at 1 to 12 heads of 32
    or 64 the longest fused length is within it, takes the cluster
    design above 768 tokens (its clusters hold every key tile), and is not
    refused; one more than the limit
    is refused, naming the gate."""
    assert longest_fused(1, 32, jfa.fuses_at) == K.F32_LONG_MAX_N == 1837
    assert longest_fused(1, 64, jfa.fuses_at) == 1806
    assert longest_fused(HEADS, D, jfa.fuses_at) == 1017
    for heads in range(1, 13):
        for d in (32, 64):
            n = longest_fused(heads, d, jfa.fuses_at)
            assert n == longest_fused(heads, d, fuses_at)
            assert n <= K.F32_LONG_MAX_N
            K._long_route(n, "attention_core_f32")
            plan = K.f32_long_plan(n, d, b=2, heads=heads)
            assert plan["sweep"] == (n > K.F32_LONG_BLOCK_MAX_N)
    for n in (769, 1001, 1806, K.F32_LONG_MAX_N):
        for d in (32, 64):
            plan = K.f32_long_plan(n, d)
            fwd = plan["fwd"]
            assert fwd["cluster"] * fwd["stages"] >= plan["tiles"]
            assert fwd["stages"] <= K.f32_sweep_max_tiles(d)
            assert fwd["smem"] == K.f32_sweep_smem(d, fwd["stages"]) <= \
                K.F32_LONG_SMEM_OPTIN
    with pytest.raises(NotImplementedError, match="fused gate"):
        K._long_route(K.F32_LONG_MAX_N + 1, "attention_core_f32")
    with pytest.raises(ValueError):
        K.f32_long_plan(K.F32_LONG_MAX_N + 1, 32)


def test_fp16_32_attention_half_past_768_matches_jax():
    """The FP16_32 attention half at 800 tokens, 3 heads of 64, one image,
    forward and backward, against the JAX fused kernel (K1 and K2 in
    interpret mode): the output within 3e-5 plus one format step at its
    largest magnitude, 95% within 3e-5; every gradient within 2e-4 of its
    leaf's largest magnitude (the key third of dbqkv left out)."""
    assert fuses_at(N, HEADS, D) and N > K.F32_LONG_BLOCK_MAX_N
    qspec = QSPECS[QFormat.FP16_32]
    rng = np.random.RandomState(N)
    f = np.float32
    args = [rng.randn(1, N, C).astype(f), (1 + 0.1 * rng.randn(C)).astype(f),
            (0.1 * rng.randn(C)).astype(f),
            (rng.randn(C, 3 * C) * C ** -0.5).astype(f),
            (0.1 * rng.randn(3 * C)).astype(f),
            (rng.randn(C, C) * C ** -0.5).astype(f),
            (0.1 * rng.randn(C)).astype(f)]
    for i in (3, 5):
        args[i] = np.array(jfq.float_quantize(jnp.asarray(args[i]), qspec[0],
                                              qspec[1]))
    g = rng.randn(1, N, C).astype(f)
    out_j, vjp = jax.vjp(
        lambda *a: jfa.fused_attention_block(*a, HEADS, SCALE, qspec),
        *(jnp.asarray(a) for a in args))
    refs = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fused_attention_block(*leaves, HEADS, SCALE, qspec=qspec)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    out, out_j = out.detach().numpy(), np.asarray(out_j)
    d = np.abs(out - out_j)
    print(f"FP16_32 N={N}: output max abs {d.max():.3g}, "
          f"{(d > BLOCK_BAR).mean():.5f} past 3e-5")
    assert d.max() <= BLOCK_BAR + fmt_step(np.abs(out_j).max(), qspec)
    assert (d <= BLOCK_BAR).mean() >= 0.95
    names = ["x", "ln_scale", "ln_bias", "wqkv", "bqkv", "wp", "bp"]
    for gr, r, name in zip(grads, refs, names):
        grads_close(f"FP16_32 N={N} d{name}", gr.numpy(), r,
                    skip_key_bias=name == "bqkv")


def test_int8_qat_attention_half_past_768_matches_jax():
    """The PyTorchINT8 QAT attention half at 800 tokens, 3 heads of 64,
    one image, on a calibrated site table, against the JAX K1 / K2 int8
    (interpret mode), at the bars of the same check above 256 tokens."""
    check_int8_qat_attention(N, N + 2, C, HEADS, HID, 1)


def test_converted_attention_half_past_768_matches_jax():
    """The converted INT8 attention half at 800 tokens, 3 heads of 64, one
    image, against the JAX K9 (interpret mode) on the same int8 weights
    and sites, at the converted bar."""
    check_converted_half(N, N + 3, "attention", C, HEADS, HID, 1)


def test_yolos_tiny_width_qat_step_past_768_matches_jax(monkeypatch):
    """A yolos_tiny-width detector (depth 1) on two 448 px images: 28 x 28
    patches + cls + 100 detection tokens = 885, fused at 3 heads of 64;
    one FP16_32 QAT step against the JAX step at the bars of
    tests/test_torch_float_detection.py's step."""
    n = (CANVAS // 16) ** 2 + 1 + DET_KW["num_det_tokens"]
    assert n == 885 and fuses_at(n, HEADS, D)
    check_qat_step("FP16_32", DET_KW, CANVAS, "fused_885", monkeypatch)
