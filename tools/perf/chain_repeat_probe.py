#!/usr/bin/env python3
"""Repeats the float formats' attention chain (K1 with ``qspec``) at
chip_smoke.py's kernel-phase shape (B=64, N=197, its seeded inputs) on
the card: each stage (``layernorm_snap_rows``, the qkv and projection
``gemm_f32x3_epilogue`` calls, ``attention_core_snap``) on its plain
version's input, and the whole op, the two products also on a fresh copy
of their input each call, every output bitwise against the stage's first
one, each call after the allocator's next blocks were filled with NaN (an
element that a kernel never writes then shows); the op's first output
against the plain chain.  Looks for nondeterminism in that chain (ROADMAP
C11).

For every call whose projection output differs from the first, each
differing element (at most ``--detail`` a call) is printed with its place
in the kernel: the output tile (row and column tile, the persistent CTA
that takes it and which of that CTA's tiles it is), the consumer
warpgroup, warp and lane and the accumulator index 4 j + 2 h2 + e of
``gemm_f32x3_wgmma.cu``'s epilogue; and with what the host recomputes
from the same inputs in fp64: the three products hh, hl and lh of the
split operands, the epilogue of their sum (it should give the first
call's value), and which single change of the kernel's inputs gives the
wrong value: one product left out, one 16-deep step of one product left
out or counted twice, the residual read as 0, or the value of another
element of the first output.  Also how many elements of the row and of
the column differ (a stale A value moves a row of the tile, a stale
split B value a column).

    python3 tools/perf/chain_repeat_probe.py [reps] [--stages a,b]
        [--formats FP16_32,...] [--batch 64] [--detail 4] [--json path]

``--stages`` picks among ln, qkv, core, proj, proj-fresh, qkv-fresh,
core+proj, op, chain, chain-sync, chain-freed (default: all); ``--json``
writes each stage's counts.  Needs a CUDA device (and builds the
kernels, as chip_smoke.py does).
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

STAGES = ("ln", "qkv", "core", "proj", "proj-fresh", "qkv-fresh",
          "core+proj", "op", "chain", "chain-sync", "chain-freed")
# the stages whose last output is the projection's
PROJ_STAGES = ("proj", "proj-fresh", "core+proj", "op", "chain",
               "chain-sync", "chain-freed")


def first_of(out):
    return out[0] if isinstance(out, tuple) else out


def place(row, col, m, n, sms, bm=128, bn=128):
    """Where element (row, col) of an (m, n) output lies in the persistent
    f32x3 kernel's walk (epilogue 2's 128 x 128 tiles)."""
    tiles_n, tiles_m = -(-n // bn), -(-m // bm)
    tile = (row // bm) * tiles_n + col // bn
    grid = min(tiles_n * tiles_m, sms)
    r_in, c_in = row % bm, col % bn
    wg, w16 = divmod(r_in, 64)
    warp, r16 = divmod(w16, 16)
    h2, g = divmod(r16, 8)
    j, c8 = divmod(c_in, 8)
    t, e = divmod(c8, 2)
    return {"tile": tile, "tile_m": row // bm, "tile_n": col // bn,
            "cta": tile % grid, "cta_iter": tile // grid, "warpgroup": wg,
            "warp": 4 * wg + warp, "lane": 4 * g + t,
            "acc": 4 * j + 2 * h2 + e}


def explain(torch, K, qspec_sites, a_row, w_col, bias, res, good, bad,
            first):
    """The host's account of one wrong element: the fp64 products of the
    split operands and the single changes of the kernel's inputs whose
    epilogue gives ``bad`` (or comes nearest)."""
    ah = a_row.bfloat16().float()
    al = (a_row - ah).bfloat16().float()
    bh = w_col.bfloat16().float()
    bl = (w_col - bh).bfloat16().float()
    terms = {"hh": ah.double() * bh.double(), "hl": ah.double() * bl.double(),
             "lh": al.double() * bh.double()}
    tot = {k: v.sum() for k, v in terms.items()}
    p = tot["hh"] + tot["hl"] + tot["lh"]
    cands = {"all three": p, "no hl": p - tot["hl"], "no lh": p - tot["lh"],
             "hh only": tot["hh"]}
    steps = a_row.numel() // 16
    for k, v in terms.items():
        per = v.view(steps, 16).sum(1)
        for s in range(steps):
            cands[f"{k} step {s} left out"] = p - per[s]
            cands[f"{k} step {s} twice"] = p + per[s]
    names = list(cands)
    ps = torch.stack([cands[k] for k in names]).float()
    b = torch.full_like(ps, float(bias))

    def epi(pv, r):
        v = K.snap_int8(K.snap_all(pv + b, qspec_sites), qspec_sites, 0)
        return K.snap_int8(K.snap_all(r * 1.0 + v, qspec_sites),
                           qspec_sites, 1)

    outs = epi(ps, torch.full_like(ps, float(res)))
    zero = epi(ps[:1], torch.zeros_like(ps[:1]))
    dist = (outs - bad).abs()
    best = [names[i] for i in torch.nonzero(dist == dist.min()).flatten()
            .tolist()][:4]
    elsewhere = torch.nonzero(first == bad)[:4].tolist()
    return {"hh": float(tot["hh"]), "hl": float(tot["hl"]),
            "lh": float(tot["lh"]), "epilogue of all three": float(outs[0]),
            "first call": good, "this call": bad,
            "epilogue with residual 0": float(zero[0]),
            "nearest single change": best,
            "its distance": float(dist.min()),
            "same value elsewhere in the first output": elsewhere,
            "dp (this - first)": bad - good}


def main(argv=None):
    import torch

    import chip_smoke as cs
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops.fake_quant import kernel_sites

    ap = argparse.ArgumentParser()
    ap.add_argument("reps", nargs="?", type=int, default=40)
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--formats", default=",".join(cs.FLOAT_QSPECS))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--detail", type=int, default=4)
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    chosen = args.stages.split(",")
    unknown = set(chosen) - set(STAGES)
    if unknown:
        raise SystemExit(f"unknown stages {sorted(unknown)}")

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.phase_build()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    report = {}

    def poison():
        junk = torch.full((1 << 28,), float("nan"), device=device)
        del junk

    for qname in args.formats.split(","):
        qspec = cs.FLOAT_QSPECS[qname]
        x, attn, _ = cs.float_block_inputs(
            args.batch, 197, seed=args.batch * 1000 + 197 + 2,
            device=device, qspec=qspec)
        s_ln, b_ln, wqkv, bqkv, wp, bp = attn
        b, n, c = x.shape
        x2 = x.contiguous().view(b * n, c)
        xn = K.layernorm_snap_rows_plain(x2, s_ln, b_ln,
                                         kernel_sites(qspec, 0))
        qkv = K.gemm_f32x3_epilogue_plain(
            xn, wqkv, bqkv, "bias_snap", kernel_sites(qspec, 1)).view(
                b, n, 3 * c)
        ctx = K.attention_core_snap_plain(qkv, cs.HEADS, cs.SCALE,
                                          kernel_sites(qspec, 2))

        def proj(t):
            return K.gemm_f32x3_epilogue_cuda(
                t.view(b * n, c), wp, bp, "bias_snap_residual_snap",
                kernel_sites(qspec, 3, 4), residual=x2)

        def core(t):
            return K.attention_core_snap_cuda(
                t.view(b, n, 3 * c), cs.HEADS, cs.SCALE,
                kernel_sites(qspec, 2))

        def core_then_proj():
            """The core on the plain qkv, its output unused, then the
            projection on the plain context: whether a core kernel just
            before changes the projection."""
            core(qkv)
            return proj(ctx)

        def chain(sync, freed=False):
            """The op's kernels in its order, each fed the one before;
            every intermediate returned (and with ``sync`` a synchronize
            after each kernel; with ``freed`` copies of them, the
            intermediates themselves freed on return, as the op frees
            its own)."""
            outs = [K.layernorm_snap_rows_cuda(x2, s_ln, b_ln,
                                               kernel_sites(qspec, 0))]
            steps = (
                lambda t: K.gemm_f32x3_epilogue_cuda(
                    t, wqkv, bqkv, "bias_snap", kernel_sites(qspec, 1)),
                core, proj)
            for step in steps:
                if sync:
                    torch.cuda.synchronize()
                outs.append(step(outs[-1]))
            if freed:
                return [t.clone() for t in outs]
            return outs

        stages = {
            "ln": lambda: K.layernorm_snap_rows_cuda(
                x2, s_ln, b_ln, kernel_sites(qspec, 0)),
            "qkv": lambda: K.gemm_f32x3_epilogue_cuda(
                xn, wqkv, bqkv, "bias_snap", kernel_sites(qspec, 1)),
            "core": lambda: core(qkv),
            "proj": lambda: proj(ctx),
            "proj-fresh": lambda: proj(ctx.clone()),
            "qkv-fresh": lambda: K.gemm_f32x3_epilogue_cuda(
                xn.clone(), wqkv, bqkv, "bias_snap", kernel_sites(qspec, 1)),
            "core+proj": core_then_proj,
            "op": lambda: fa.fused_attention_block(x, *attn, cs.HEADS,
                                                   cs.SCALE, qspec=qspec),
            "chain": lambda: chain(False),
            "chain-sync": lambda: chain(True),
            "chain-freed": lambda: chain(False, True)}
        ref = fa.fused_attention_block_plain(x, *attn, cs.HEADS, cs.SCALE,
                                             qspec=qspec)
        chain_ctx = None
        for name in chosen:
            fn = stages[name]
            poison()
            firsts = fn()
            first = firsts[-1] if isinstance(firsts, list) else first_of(
                firsts)
            if isinstance(firsts, list):
                chain_ctx = firsts[2].view(b * n, c).clone()
            first2 = first.reshape(-1, first.shape[-1])
            nan = int(torch.isnan(first).sum())
            bad, worst, where, counts = 0, 0.0, [], []
            for rep in range(args.reps):
                poison()
                gots = fn()
                got = gots[-1] if isinstance(gots, list) else first_of(gots)
                torch.cuda.synchronize()
                if torch.equal(got, first):
                    continue
                bad += 1
                worst = max(worst, float((got - first).abs().max()))
                if isinstance(gots, list):
                    # the first intermediate that differs
                    where.append(next(i for i, (g, f) in enumerate(
                        zip(gots, firsts)) if not torch.equal(g, f)))
                got2 = got.reshape(first2.shape)
                diff = torch.nonzero(got2 != first2)
                counts.append(len(diff))
                if name not in PROJ_STAGES:
                    continue
                a_in = chain_ctx if chain_ctx is not None and name not in (
                    "proj", "proj-fresh", "core+proj") else ctx.view(b * n, c)
                for row, col in diff[:args.detail].tolist():
                    info = {"rep": rep, "row": row, "col": col,
                            "differing in its row":
                                int((got2[row] != first2[row]).sum()),
                            "differing in its column":
                                int((got2[:, col] != first2[:, col]).sum()),
                            **place(row, col, b * n, c, sms)}
                    info.update(explain(
                        torch, K, kernel_sites(qspec, 3, 4), a_in[row],
                        wp[:, col], bp[col], x2[row, col],
                        float(first2[row, col]), float(got2[row, col]),
                        first2))
                    print(f"{qname} {name} differing element: "
                          f"{json.dumps(info)}", flush=True)
            extra = (f"; against the plain chain max "
                     f"{float((first - ref).abs().max())}"
                     if name == "op" else "")
            if where:
                extra += (f"; first differing intermediate (0 LN, 1 qkv, 2 "
                          f"core, 3 projection) {where}")
            if counts:
                extra += f"; differing elements per call {counts}"
            print(f"{qname} {name}: {nan} NaN, {bad} of {args.reps} repeats "
                  f"differ bitwise from the first, worst {worst}{extra}",
                  flush=True)
            report[f"{qname} {name}"] = {"reps": args.reps, "differ": bad,
                                         "nan": nan, "worst": worst}
    print(cs.power_line())
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
