"""What the float-format and INT8 QAT LayerNorm wrapper computes in Python
before it launches csrc/layernorm_snap_rows.cu, on the CPU: the plan
(``layernorm_snap_plan``) gives each lane every 32nd column of its row and
each warp one row, covers every column and every row exactly once, keeps a
row's values, scale and bias inside a thread's registers at the blocks an
SM the kernel is built for, takes every width a shipped config uses, and
refuses any other width before the wrapper launches anything.  The
kernel's own figures are held to the plan on the card
(tests/test_torch_kernels_cuda.py)."""
import ctypes
import glob
import json
import os

import pytest
import torch

from myrtle_vision_tpu_torch.ops import _kernels as K
from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTERS_PER_SM = 65536
WIDTHS = range(32, K.LN_SNAP_MAX_COLS + 1, 32)
# ViT-S/16 at 224 and 384 px and YOLOS-S's 384 px micro-batch at B=256 and
# 2; a row, a few, one past a block, one past 132 SMs' full wave of blocks
ROWS = [1, 7, 33, 256 * 197, 256 * 577, 2 * 677, 132 * 8 * 4 + 1]


def shipped_widths():
    """The embedding widths of every task config of the repository."""
    widths = set()
    for path in glob.glob(os.path.join(REPO, "*", "train_configs", "*.json")):
        with open(path) as f:
            widths.add(json.load(f)["vit_config"]["embed_dim"])
    return sorted(widths)


@pytest.mark.parametrize("cols", WIDTHS)
def test_lanes_cover_every_column_once(cols):
    plan = K.layernorm_snap_plan(1, cols)
    values = plan["values"]
    assert values == cols // 32
    held = [lane + 32 * i for lane in range(32) for i in range(values)]
    assert sorted(held) == list(range(cols))
    # a row's values, scale and bias (3 values registers) fit a thread's
    # share of the SM's registers at the blocks an SM the kernel is built
    # for, within the 255 a thread can have
    threads = plan["blocks_per_sm"] * plan["warps"] * 32
    budget = min(255, REGISTERS_PER_SM // threads)
    assert 3 * values < budget
    assert plan["blocks_per_sm"] == (
        8 if values <= K.LN_SNAP_FEW_VALUES else 4)


@pytest.mark.parametrize("cols", [128, 384, 768])
@pytest.mark.parametrize("rows", ROWS)
def test_grid_covers_every_row_once(rows, cols):
    """Warp w of block b takes row b * warps + w; the grid's warps cover
    the rows with none left over past the last block's."""
    plan = K.layernorm_snap_plan(rows, cols)
    warps, blocks = plan["warps"], plan["blocks"]
    taken = [b * warps + w for b in range(blocks) for w in range(warps)]
    assert taken[:rows] == list(range(rows))
    assert 0 <= len(taken) - rows < warps


def test_main_path_figures():
    """ViT-S/16 at B=256: 12,608 blocks of four rows at 224 px, 36,928 at
    384 px; 12 values a lane, built for eight blocks an SM (64 registers a
    thread); ViT-B's 768: 24 values, four blocks an SM."""
    assert K.layernorm_snap_plan(256 * 197, 384) == {
        "values": 12, "warps": 4, "blocks": 12608, "blocks_per_sm": 8}
    assert K.layernorm_snap_plan(256 * 577, 384)["blocks"] == 36928
    assert K.layernorm_snap_plan(8, 768) == {
        "values": 24, "warps": 4, "blocks": 2, "blocks_per_sm": 4}


def test_every_shipped_width_is_taken():
    widths = shipped_widths()
    assert {128, 192, 384, 768} <= set(widths)
    for cols in widths:
        assert K.layernorm_snap_plan(256, cols)["values"] * 32 == cols


@pytest.mark.parametrize("cols", [0, 16, 100, 130, 388, 772, 800, 1024])
def test_plan_refuses_other_widths(cols):
    with pytest.raises(ValueError, match="multiple of 32"):
        K.layernorm_snap_plan(64, cols)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def stand_in_device(monkeypatch, entry):
    """Run the wrapper on CPU tensors against ``entry`` in place of the C
    entry point; returns the list of _lib() calls."""
    opened = []

    class Lib:
        mvt_layernorm_snap_rows = staticmethod(entry)

    def lib():
        opened.append(True)
        return Lib

    monkeypatch.setattr(K, "_require", lambda t, name, dt=None: None)
    monkeypatch.setattr(K, "_require_site", lambda t, name: None)
    monkeypatch.setattr(K, "_lib", lib)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    return opened


@pytest.mark.parametrize("cols", [100, 130, 800])
def test_wrapper_refuses_before_any_launch(cols, monkeypatch):
    def entry(*args):
        raise AssertionError("launched")

    opened = stand_in_device(monkeypatch, entry)
    before = K.LAUNCHES["layernorm_snap_rows"]
    x = torch.zeros(5, cols)
    with pytest.raises(ValueError, match="multiple of 32"):
        K.layernorm_snap_rows_cuda(x, torch.ones(cols), torch.zeros(cols),
                                   (5, 10, False))
    assert not opened
    assert K.LAUNCHES["layernorm_snap_rows"] == before


@pytest.mark.parametrize("policy", ["FP16_32", "int8"])
@pytest.mark.parametrize("shape", [(3, 17, 384), (2 * 677, 384), (1, 32)])
def test_wrapper_passes_rows_width_and_policy(shape, policy, monkeypatch):
    """The rows and width of an (..., C) tensor, the float format's qspec or
    the INT8 site's row, one launch counted a call."""
    seen = {}

    def entry(x, scale, bias, out, rows, cols, eps, e, m, a, site, stream):
        seen.update(rows=rows, cols=cols, eps=eps, qspec=(e, m, a),
                    site=site)
        return 0

    stand_in_device(monkeypatch, entry)
    cols = shape[-1]
    site = torch.tensor([0.5, 128.0, 1.0])
    q = Int8Sites(site) if policy == "int8" else (5, 10, False)
    before = K.LAUNCHES["layernorm_snap_rows"]
    out = K.layernorm_snap_rows_cuda(torch.zeros(shape), torch.ones(cols),
                                     torch.zeros(cols), q)
    assert out.shape == shape and out.dtype == torch.float32
    assert seen["rows"] == torch.Size(shape[:-1]).numel()
    assert seen["cols"] == cols and seen["eps"] == K.EPS
    if policy == "int8":
        assert seen["site"] == site.data_ptr() and seen["qspec"] == K._NO_SNAP
    else:
        assert seen["site"] is None and seen["qspec"] == (5, 10, 0)
    assert K.LAUNCHES["layernorm_snap_rows"] == before + 1


def test_launch_figures_read_the_entry_point(monkeypatch):
    """layernorm_snap_launch unpacks the entry point's six figures in the
    plan's order."""
    def plan_entry(rows, cols, figures):
        f = ctypes.cast(figures, ctypes.POINTER(ctypes.c_int))
        for i, v in enumerate((cols // 32, 4, -(-rows // 4), 8, 9, 10)):
            f[i] = v
        return 0

    class Lib:
        mvt_layernorm_snap_rows_plan = staticmethod(plan_entry)

    monkeypatch.setattr(K, "_lib", lambda: Lib)
    got = K.layernorm_snap_launch(50432, 384)
    assert got == {"values": 12, "warps": 4, "blocks": 12608,
                   "blocks_per_sm": 8, "occupancy": {"float": 9, "int8": 10}}
