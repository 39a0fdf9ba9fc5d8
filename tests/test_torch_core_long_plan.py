"""How the fused attention core's long route covers one (image, head), on
the CPU: ``core_long_plan`` (the figures of csrc/attention_core_long_wgmma.cu
and csrc/attention_core_bwd_long_wgmma.cu, their layouts in
csrc/core_long_wgmma.cuh) keeps every CTA inside a block's shared memory
and two CTAs inside an SM's, lets the grid and each kernel's walk cover
every query and key tile, gives the figures the sources quote at 677
tokens, and the wrappers allocate exactly the plan's scratch and count
the launches the entry point reports.  The kernels' own figures are held
to the plan on the card (tests/test_torch_kernels_cuda.py)."""
import ctypes
import math

import pytest
import torch

from myrtle_vision_tpu_torch.ops import _kernels as K

BLOCK_SMEM = 232448  # the most dynamic shared memory a block can take
SMS = 132  # an H100's streaming multiprocessors
NS = range(1, 4097)
KERNELS = ("fwd", "dq", "dkdv")


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("key", KERNELS)
def test_every_cta_fits_shared_memory(d, key):
    for n in (1, 197, 257, 677, 701, 4096):
        f = K.core_long_plan(n, d)[key]
        assert f["smem"] <= BLOCK_SMEM, (n, key)
        assert f["ctas_per_sm"] == 2
        assert f["ctas_per_sm"] * (f["smem"] + K.CTA_RESERVED_BYTES) \
            <= K.SM_SHARED_BYTES, (n, key)
        # the swizzled tiles' 1024-byte alignment is in the figure
        assert f["smem"] >= K.TILE_ALIGN_BYTES


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("key", KERNELS)
def test_grid_and_walk_cover_every_tile(d, key):
    """A CTA per tile of its own rows, none past the sequence (the
    backward's grid covers n_pad, the rows of its statistics, which is
    fewer than a tile past n); each pass of a CTA walks tiles of the other
    side up to the last token."""
    for n in NS:
        plan = K.core_long_plan(n, d)
        f = plan[key]
        assert (f["grid"] - 1) * f["rows"] < n <= f["grid"] * f["rows"], n
        assert (f["walk"] - 1) * f["tile"] < n <= f["walk"] * f["tile"], n
        assert plan["n_pad"] % K.CORE_LONG_BWD_TILE == 0
        assert n <= plan["n_pad"] < n + K.CORE_LONG_BWD_TILE
        if key != "fwd":
            assert f["grid"] * f["rows"] == plan["n_pad"]


@pytest.mark.parametrize("d", [32, 64])
def test_tiles_fit_the_products(d):
    """One consumer warpgroup of 64 rows, and in the backward a producer
    warp; tiles in
    whole wgmma steps (16 deep) and widths (multiples of 8, at most 256);
    the rings hold at least two tiles; the dq kernel walks the keys twice
    (r of the whole row before any ds), the others once."""
    plan = K.core_long_plan(677, d)
    for key in KERNELS:
        f = plan[key]
        assert f["threads"] == 128 + (0 if key == "fwd" else 32)
        assert f["rows"] == 64
        assert f["tile"] % 16 == 0 and f["tile"] <= 256
        assert f["stages"] >= 2
        assert f["passes"] == (2 if key == "dq" else 1)
    assert plan["launches"] == {"fwd": 1, "bwd": 4}


@pytest.mark.parametrize("d,fwd,dq,dkdv", [(64, 99376, 86088, 90184),
                                           (32, 50224, 43592, 47688)])
def test_figures_at_677_tokens(d, fwd, dq, dkdv):
    """YOLOS-S at 384 px: 11 CTAs of 64 queries (or keys) per (image,
    head); the forward walks 6 tiles of 128 keys through a ring of three
    (at head width 64 three K and three V tiles, 98,304 bytes, and six
    barriers), the backward 11 tiles of 64 rows through a ring of four,
    the dq kernel twice; n_pad 704."""
    plan = K.core_long_plan(677, d)
    common = {"grid": 11, "rows": 64, "threads": 160, "ctas_per_sm": 2}
    assert plan["fwd"] == {**common, "threads": 128, "tile": 128, "walk": 6,
                           "passes": 1, "stages": 3, "smem": fwd}
    assert plan["dq"] == {**common, "tile": 64, "walk": 11, "passes": 2,
                          "stages": 4, "smem": dq}
    assert plan["dkdv"] == {**common, "tile": 64, "walk": 11, "passes": 1,
                            "stages": 4, "smem": dkdv}
    assert plan["n_pad"] == 704
    if d == 64:
        assert 1024 + 98304 + 8 * 6 == fwd
        # own qs and du, four stages of a K and a V tile, nine barriers,
        # the column-sum buffer
        assert 1024 + 16384 + 4 * 16384 + 8 * 9 + 3072 == dq
        assert 1024 + 16384 + 4 * (16384 + 1024) + 8 * 9 + 3072 == dkdv


@pytest.mark.parametrize("b,ctas", [(2, 132), (8, 528)])
def test_grid_sized_for_the_train_step(b, ctas):
    """At 677 tokens and 6 heads the train step's micro-batch of 2 gives
    each SM of an H100 one CTA of every kernel, batch 8 two waves of two
    CTAs an SM."""
    plan = K.core_long_plan(677, 64, b, 6)
    for key in KERNELS:
        f = plan[key]
        assert f["grid"] * b * 6 == ctas
        assert math.ceil(ctas / (SMS * f["ctas_per_sm"])) == (
            1 if b == 2 else 2)


@pytest.mark.parametrize("b,n,heads,d", [(2, 677, 6, 64), (1, 257, 2, 32),
                                         (8, 701, 6, 64), (3, 1, 2, 64)])
def test_scratch_shapes(b, n, heads, d):
    """qs and du, (b, n, heads d) bf16 each; m log2(e) and r rs in rows of
    n_pad per (image, head); a row of column sums per 64-row tile."""
    plan = K.core_long_plan(n, d, b, heads)
    c = heads * d
    assert plan["scratch"] == {
        "qd": (2, b, n, c), "stats": (2, b * heads * plan["n_pad"]),
        "colpart": (b, plan["n_pad"] // 64, 3 * c)}


@pytest.mark.parametrize("n,d,b,heads", [(0, 64, 1, 1), (-1, 32, 1, 1),
                                         (677, 48, 1, 1), (677, 128, 1, 1),
                                         (677, 64, 0, 6), (677, 64, 2, 0)])
def test_plan_refuses_what_the_kernels_do_not_take(n, d, b, heads):
    with pytest.raises(ValueError):
        K.core_long_plan(n, d, b, heads)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _stand_in(monkeypatch, lib, max_n=256):
    """Run the wrappers on CPU tensors against a stand-in library: the
    device checks, the stream and the device context pass through; every
    tensor the wrappers allocate (``torch.empty``, ``torch.empty_like``)
    is recorded."""
    made = []

    def recorded(make):
        def fn(*args, **kwargs):
            out = make(*args, **kwargs)
            made.append((tuple(out.shape), out.dtype))
            return out
        return fn

    lib.mvt_attention_core_max_n = staticmethod(lambda: max_n)
    monkeypatch.setattr(K, "_require", lambda t, name, dt=None: None)
    monkeypatch.setattr(torch, "empty", recorded(torch.empty))
    monkeypatch.setattr(torch, "empty_like", recorded(torch.empty_like))
    monkeypatch.setattr(K, "_lib", lambda: lib)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    return made


def _core_inputs(b, n, heads, d):
    c = heads * d
    qkv = torch.zeros(b, n, 3 * c, dtype=torch.bfloat16)
    return (qkv, torch.zeros(b, n, c), torch.zeros(b, heads, n),
            torch.zeros(b, heads, n))


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("n", [197, 677])
def test_backward_wrapper_allocates_the_plans_scratch(n, tiled,
                                                      monkeypatch):
    """attention_core_bwd_cuda on a stand-in entry point: on the long
    route (above 256 tokens, or forced) it allocates the outputs and
    exactly the plan's scratch and hands those pointers to the entry it
    calls; the one-CTA route allocates no scratch; each adds the kernels
    the entry reports to LAUNCHES."""
    b, heads, d = 2, 6, 64
    seen = {}

    def entry(name, count):
        def fn(qkv, d_o, m, rs, dqkv, dbias, qd, stats, colpart, b_, n_,
               heads_, d_, scale, launched, stream):
            seen.update(name=name, scratch=(qd, stats, colpart),
                        shape=(b_, n_, heads_, d_))
            ctypes.c_int.from_address(launched).value = count
            return 0
        return staticmethod(fn)

    class Lib:
        mvt_attention_core_bwd = entry("one", 1)
        mvt_attention_core_bwd_tiled = entry("long", 4)

    made = _stand_in(monkeypatch, Lib)
    before = K.LAUNCHES["attention_core_bwd"]
    dqkv, dbias = K.attention_core_bwd_cuda(*_core_inputs(b, n, heads, d),
                                            heads, 0.125, tiled=tiled)
    c3 = 3 * heads * d
    assert dqkv.shape == (b, n, c3) and dbias.shape == (b, c3)
    assert seen["shape"] == (b, n, heads, d)
    outputs = [((b, n, c3), torch.bfloat16), ((b, c3), torch.float32)]
    long_route = tiled or n > 256
    if long_route:
        sc = K.core_long_plan(n, d, b, heads)["scratch"]
        assert seen["name"] == "long"
        assert made == outputs + [(sc["qd"], torch.bfloat16),
                                  (sc["stats"], torch.float32),
                                  (sc["colpart"], torch.float32)]
        assert all(p is not None for p in seen["scratch"])
    else:
        assert seen["name"] == "one"
        assert made == outputs and seen["scratch"] == (None, None, None)
    assert K.LAUNCHES["attention_core_bwd"] - before == (4 if long_route
                                                         else 1)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_forward_wrapper_takes_the_long_entry_when_forced(tiled, stats,
                                                         monkeypatch):
    """attention_core_cuda hands ``tiled`` calls to the long route's own
    entry point (any N) and the others to the dispatching one (the long
    route above 256 tokens); one launch a call either way."""
    b, n, heads, d = 2, 197, 6, 64
    seen = []

    def entry(name):
        def fn(qkv, out, m, rs, b_, n_, heads_, d_, scale, stream):
            seen.append((name, m is None, rs is None, (b_, n_, heads_, d_)))
            return 0
        return staticmethod(fn)

    class Lib:
        mvt_attention_core = entry("dispatch")
        mvt_attention_core_long = entry("long")

    made = _stand_in(monkeypatch, Lib)
    before = K.LAUNCHES["attention_core"]
    out = K.attention_core_cuda(_core_inputs(b, n, heads, d)[0], heads,
                                0.125, stats=stats, tiled=tiled)
    assert K.LAUNCHES["attention_core"] - before == 1
    assert seen == [("long" if tiled else "dispatch", not stats, not stats,
                     (b, n, heads, d))]
    stat = ((b, heads, n), torch.float32)
    assert made == [((b, n, heads * d), torch.bfloat16)] + (
        [stat, stat] if stats else [])
    assert (out[0] if stats else out).shape == (b, n, heads * d)


def test_wrappers_refuse_cpu_tensors():
    """Without a stand-in the launchers raise on a CPU tensor rather than
    run a plain version; the plain versions are the CPU's path."""
    qkv, d_o, m, rs = _core_inputs(1, 300, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.attention_core_cuda(qkv, 2, 0.125, tiled=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.attention_core_bwd_cuda(qkv, d_o, m, rs, 2, 0.125, tiled=True)
