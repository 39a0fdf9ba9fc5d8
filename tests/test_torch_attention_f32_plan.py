"""How the fp32 attention core and its backward cover one (image, head),
on the CPU: ``attention_core_f32_plan`` (the figures of
csrc/attention_core_f32_wgmma.cu and csrc/attention_core_f32_bwd_wgmma.cu)
keeps every CTA inside a block's shared memory, splits the backward's
keys between its two warpgroups in steps of 16 that cover the padded
sequence, and gives the figures the kernel headers quote at 197 tokens.
The kernels' own figures are held to the plan on the card
(tests/test_torch_kernels_cuda.py)."""
import pytest
import torch

from myrtle_vision_tpu_torch.ops import _kernels as K

BLOCK_SMEM = 232448  # the most dynamic shared memory a block can take
NS = range(1, K.F32_CORE_MAX_N + 1)


@pytest.mark.parametrize("d", [32, 64])
def test_every_cta_fits_shared_memory(d):
    for n in NS:
        plan = K.attention_core_f32_plan(n, d)
        for key in ("fwd", "bwd"):
            f = plan[key]
            assert f["smem"] <= BLOCK_SMEM, (n, key)
            # the CTAs an SM the plan counts on fit the SM's shared memory
            assert f["ctas_per_sm"] * (f["smem"] + K.CTA_RESERVED_BYTES) \
                <= K.SM_SHARED_BYTES, (n, key)
            assert f["launches"] == 1


@pytest.mark.parametrize("d", [32, 64])
def test_backward_key_split_covers_the_padded_sequence(d):
    for n in NS:
        plan = K.attention_core_f32_plan(n, d)
        n_pad, ka = plan["n_pad"], plan["bwd"]["ka"]
        assert n_pad % 16 == 0 and n <= n_pad < n + 16
        # warpgroup 0 takes keys [0, ka), warpgroup 1 [ka, n_pad): both
        # in whole 16-key steps, warpgroup 0 never the smaller share
        assert ka % 16 == 0 and 0 < ka <= n_pad
        assert (n_pad - ka) % 16 == 0 and n_pad - ka <= ka
        assert ka - (n_pad - ka) <= 16
        assert plan["bwd"]["warpgroups"] == 2
        assert plan["fwd"]["ka"] == 0


@pytest.mark.parametrize("d", [32, 64])
def test_forward_takes_two_ctas_where_they_fit(d):
    """One warpgroup a CTA and two CTAs an SM up to N_pad 224 at head
    width 64 and at every length at 32 (the forward's header); above it
    one CTA of two warpgroups, so an SM still runs eight warps."""
    for n in NS:
        fwd = K.attention_core_f32_plan(n, d)["fwd"]
        n_pad = K.attention_core_f32_plan(n, d)["n_pad"]
        two = d == 32 or n_pad <= 224
        assert (fwd["warpgroups"], fwd["ctas_per_sm"]) == (
            (1, 2) if two else (2, 1)), n
        assert fwd["smem"] == K.TILE_ALIGN_BYTES + 4 * n_pad * 2 * d


@pytest.mark.parametrize("d,fwd_smem,bwd_smem", [(64, 107520, 182784),
                                                 (32, 54272, 93696)])
def test_figures_at_197_tokens(d, fwd_smem, bwd_smem):
    """ViT-S/16's 197 tokens: 208 padded, K and V split into 106,496 bytes
    at head width 64, keys 112 / 96 in the backward's query pass."""
    plan = K.attention_core_f32_plan(197, d)
    assert plan["n_pad"] == 208
    assert plan["fwd"] == {"warpgroups": 1, "ka": 0, "launches": 1,
                           "smem": fwd_smem, "ctas_per_sm": 2}
    assert plan["bwd"] == {"warpgroups": 2, "ka": 112, "launches": 1,
                           "smem": bwd_smem, "ctas_per_sm": 1}
    if d == 64:
        assert 4 * 208 * 2 * d == 106496


@pytest.mark.parametrize("n,d", [(0, 64), (257, 64), (197, 48), (197, 128)])
def test_plan_refuses_what_the_kernels_do_not_take(n, d):
    with pytest.raises(ValueError):
        K.attention_core_f32_plan(n, d)


def test_wrappers_take_cuda_tensors_only():
    """On a CPU tensor the launchers raise rather than run a plain
    version; the plain versions are the CPU's path."""
    qkv = torch.zeros(1, 197, 3 * 384)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.attention_core_f32_recip_probe_cuda(qkv, 6, 0.125, (5, 10, False))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.attention_core_snap_cuda(qkv, 6, 0.125, (5, 10, False), stats=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.attention_core_f32_bwd_cuda(qkv, torch.zeros(1, 197, 384),
                                      torch.zeros(1, 6, 197),
                                      torch.zeros(1, 6, 197), 6, 0.125)
