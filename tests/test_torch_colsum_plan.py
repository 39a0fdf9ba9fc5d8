"""What the column-sum wrapper computes in Python before it launches
csrc/layernorm_rows_bwd.cu's colsum kernels, on the CPU: the chunk plan
(``colsum_plan``) covers every row exactly once, takes one kernel exactly
up to 64 rows, keeps the second pass's partials bounded, and the wrapper
sizes its scratch and passes its chunk from that plan."""
import ctypes
import math

import pytest
import torch

from myrtle_vision_tpu_torch.ops import _kernels as K

ROWS = 256 * 197  # ViT-S/16 at batch 256

# (rows, cols) of every colsum_rows caller at ViT-S/16, batch 256: dbp and
# db2 (the bf16 upstream gradient), dbqkv (the core's per-image sums),
# the LayerNorm backward's block partials (2 x 384), the mul_aux
# epilogue's 128-row tile partials (db1), a split-K weight gradient's
# partial products (7 x 384 x 1536); and rows around the one-kernel limit,
# one row, a width that is not a multiple of 8
CASES = [(ROWS, 384), (256, 1152), (528, 768), (394, 1536),
         (7, 384 * 1536), (1, 384), (63, 384), (64, 1152), (65, 100),
         (257, 100), (ROWS, 1152), (8 * 677, 384)]


@pytest.mark.parametrize("sms", [132, 7, 1])
@pytest.mark.parametrize("rows,cols", CASES)
def test_plan_covers_every_row_once(rows, cols, sms):
    plan = K.colsum_plan(rows, cols, sms)
    chunk, chunks = plan["chunk"], plan["chunks"]
    assert chunk >= 1 and chunks == math.ceil(rows / chunk)
    # chunk i sums rows [i chunk, min(rows, (i + 1) chunk)): none empty,
    # none past the matrix, together every row
    spans = [(i * chunk, min(rows, (i + 1) * chunk)) for i in range(chunks)]
    assert all(hi > lo for lo, hi in spans)
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # one kernel exactly when the rows fit one chunk, as the launch count
    # promises (1 up to COLSUM_ONE_PASS rows, else 2)
    assert (chunks == 1) == (rows <= K.COLSUM_ONE_PASS)
    if chunks > 1:
        assert chunk % 8 == 0 and chunk >= K.COLSUM_MIN_CHUNK
        # about COLSUM_BLOCKS_PER_SM first-pass blocks an SM, so the
        # second pass adds a bounded number of partials a column
        col_blocks = math.ceil(cols / K.COLSUM_COLS)
        want = max(2, math.ceil(K.COLSUM_BLOCKS_PER_SM * sms / col_blocks))
        assert chunks <= want


def test_tall_case_fills_the_card_with_bounded_partials():
    """dbp / db2 at ViT-S/16, batch 256, on 132 SMs: one wave of four
    blocks an SM, each of 288 rows; 176 partials a column, where the
    design before had 788."""
    plan = K.colsum_plan(ROWS, 384, 132)
    assert plan == {"chunk": 288, "chunks": 176}
    blocks = math.ceil(384 / K.COLSUM_COLS) * plan["chunks"]
    assert 3 * 132 <= blocks <= K.COLSUM_BLOCKS_PER_SM * 132


@pytest.mark.parametrize("rows,cols", [(1, 384), (64, 7)])
def test_short_matrices_take_one_chunk(rows, cols):
    assert K.colsum_plan(rows, cols, 132) == {"chunk": rows, "chunks": 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,cols", [(ROWS // 64, 384), (150, 1152),
                                       (64, 384), (65, 100)])
def test_wrapper_passes_the_plan(rows, cols, dtype, monkeypatch):
    """colsum_rows_cuda on a stand-in device: the chunk it hands the C
    entry point and the scratch it allocates are the plan's, and the
    entry's count of kernels is what it adds to LAUNCHES."""
    seen = {}

    def fake_entry(ptr, is_bf16, scratch, out, r, c, chunk, launched,
                   stream):
        seen.update(is_bf16=is_bf16, scratch=scratch, rows=r, cols=c,
                    chunk=chunk)
        n = 1 if chunk >= r else 2
        ctypes.c_int.from_address(launched).value = n
        return 0

    made, real_empty = [], torch.empty

    def empty(*args, **kwargs):
        out = real_empty(*args, **kwargs)
        made.append(tuple(out.shape))
        return out

    class Lib:
        mvt_colsum_rows = staticmethod(fake_entry)

    monkeypatch.setattr(K, "_require", lambda t, name, dt=None: None)
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(K, "_sms", lambda t: 132)
    monkeypatch.setattr(K, "_lib", lambda: Lib)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    t = torch.zeros(rows, cols, dtype=dtype)
    plan = K.colsum_plan(rows, cols, 132)
    before = K.LAUNCHES["colsum_rows"]
    out = K.colsum_rows_cuda(t)
    assert out.shape == (cols,) and out.dtype == torch.float32
    assert seen["chunk"] == plan["chunk"]
    assert (seen["rows"], seen["cols"]) == (rows, cols)
    assert seen["is_bf16"] == int(dtype == torch.bfloat16)
    # the tensors it allocates: the (chunks, cols) scratch above one
    # chunk, and the (cols,) sums
    if plan["chunks"] > 1:
        assert made == [(plan["chunks"], cols), (cols,)]
        assert seen["scratch"] is not None
    else:
        assert made == [(cols,)] and seen["scratch"] is None
    assert K.LAUNCHES["colsum_rows"] - before == (
        1 if rows <= K.COLSUM_ONE_PASS else 2)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
