"""How the flash-attention kernels cover one (image, head), on the CPU:
``flash_plan`` (the figures of csrc/flash_attention_fwd_wgmma.cu and
csrc/flash_attention_bwd_wgmma.cu, their layouts in csrc/flash_wgmma.cuh)
keeps every CTA inside a block's shared memory and the CTAs an SM inside
the SM's, lets the grid and each kernel's walk cover every query and key
tile, and gives the figures the kernel sources quote at 2601 and 1545
tokens.  The kernels' own figures are held to the plan on the card
(tests/test_torch_kernels_cuda.py)."""
import math

import pytest
import torch

from myrtle_vision_tpu_torch.ops import _kernels as K

BLOCK_SMEM = 232448  # the most dynamic shared memory a block can take
NS = range(1, 4097)
KERNELS = ("fwd", "dkdv", "dq")


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("key", KERNELS)
def test_every_cta_fits_shared_memory(d, key):
    for n in (1, 197, 1545, 2601, 4096):
        f = K.flash_plan(n, d)[key]
        assert f["smem"] <= BLOCK_SMEM, (n, key)
        assert f["ctas_per_sm"] * (f["smem"] + K.CTA_RESERVED_BYTES) \
            <= K.SM_SHARED_BYTES, (n, key)
        # the swizzled tiles' 1024-byte alignment is in the figure
        assert f["smem"] >= K.TILE_ALIGN_BYTES


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("key", KERNELS)
def test_grid_and_walk_cover_every_tile(d, key):
    """A CTA per tile of its own rows, none past the sequence; each CTA
    walks tiles of the other side up to the last token."""
    for n in NS:
        f = K.flash_plan(n, d)[key]
        assert (f["grid"] - 1) * f["rows"] < n <= f["grid"] * f["rows"], n
        assert (f["walk"] - 1) * f["tile"] < n <= f["walk"] * f["tile"], n


@pytest.mark.parametrize("d", [32, 64])
def test_tiles_fit_the_products(d):
    """Two consumer warpgroups of 64 rows and a producer warpgroup; tiles
    in whole wgmma steps (16 deep) and widths (multiples of 8, at most
    256); the forward's ring holds at least two KV tiles, the backward's
    at least two walked tiles."""
    plan = K.flash_plan(1545, d)
    for key in KERNELS:
        f = plan[key]
        assert f["threads"] == 3 * 128 and f["rows"] == 2 * 64
        assert f["tile"] % 16 == 0 and f["tile"] <= 256
        assert f["stages"] >= 2
    assert plan["launches"] == {"fwd": 1, "bwd": 3}


@pytest.mark.parametrize("d,smem", [(64, 115816), (32, 58472)])
def test_forward_figures_at_2601_tokens(d, smem):
    """YOLOS-S eval at 800 px: 21 CTAs of 128 queries per (image, head),
    each walking 21 tiles of 128 keys through a ring of three; at head
    width 64 the Q tile (16,384 bytes) and three K and V tiles (98,304)."""
    f = K.flash_plan(2601, d)["fwd"]
    assert f == {"grid": 21, "rows": 128, "tile": 128, "walk": 21,
                 "threads": 384, "stages": 3, "smem": smem,
                 "ctas_per_sm": 1}
    if d == 64:
        assert 1024 + 16384 + 98304 + 8 * 13 == smem


@pytest.mark.parametrize("d,dkdv,dq", [(64, 103496, 99400),
                                       (32, 54344, 50248)])
def test_backward_figures_at_1545_tokens(d, dkdv, dq):
    """YOLOS-S training at 608 px: 13 CTAs of 128 keys (dk / dv) or
    queries (dq) per (image, head), each walking 25 tiles of 64 rows
    through a ring of four."""
    plan = K.flash_plan(1545, d)
    for key, smem in (("dkdv", dkdv), ("dq", dq)):
        assert plan[key] == {"grid": 13, "rows": 128, "tile": 64,
                             "walk": 25, "threads": 384, "stages": 4,
                             "smem": smem, "ctas_per_sm": 1}, key
    assert math.ceil(1545 / 64) == 25


@pytest.mark.parametrize("n,d", [(0, 64), (-1, 32), (197, 48), (197, 128)])
def test_plan_refuses_what_the_kernels_do_not_take(n, d):
    with pytest.raises(ValueError):
        K.flash_plan(n, d)


def test_wrappers_take_cuda_tensors_only():
    """On a CPU tensor the launchers raise rather than run a plain
    version; the plain versions are the CPU's path."""
    q = torch.zeros(1, 2, 40, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="CUDA tensor"):
        K.flash_attention_fwd_cuda(q, q, q, 0.125)
    with pytest.raises(TypeError, match="CUDA tensor"):
        K.flash_attention_bwd_cuda(q, q, q, q, q, torch.zeros(1, 2, 40),
                                   0.125)
