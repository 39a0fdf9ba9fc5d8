#!/usr/bin/env python3
"""Fingerprints and times ``gemm_f32x3_epilogue`` on the card, so that two
trees (a change and its parent) can be compared in one call: every
epilogue at ViT-S/16's block shapes at B=64, N=197 (chip_smoke.py's
seeded float-format inputs, FP16_16, FP16_32 and TF32): the forward
products of ``float_kernel_cases`` (qkv, the projection, fc1, fc2), and
the backward's "f32" (dX = dY W), "bias_snap_gelu_snap_grad",
"mul_aux" and the weight gradient (a transposed ``a``).  For each: the
SHA-256 of its output bytes, the most frequent of five calls
(bit-identical outputs give equal hashes), and its mean time over
``--iters`` calls (CUDA events).

    python3 tools/perf/f32x3_ab.py --out <json> [--iters 50]
    python3 tools/perf/f32x3_ab.py --compare <a.json> <b.json> ...

Run it from the root of each tree (each builds its own kernels); with
``--compare`` it prints, for each case, whether every file's hash is the
same and each file's time (parent, change, change, parent order is the
caller's).
"""
import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def cases(torch, cs, K, device):
    from myrtle_vision_tpu_torch.ops.fake_quant import kernel_sites

    out = []
    for qname, qspec in cs.FLOAT_QSPECS.items():
        x, attn, mlp = cs.float_block_inputs(64, cs.N, seed=11,
                                             device=device, qspec=qspec)
        for name, kernel, *_ in cs.float_kernel_cases(x, attn, mlp, qspec):
            if name.startswith("gemm_f32x3_epilogue"):
                out.append((f"{qname} {name}", kernel))
        rng = cs.np.random.RandomState(12)
        m = x.shape[0] * x.shape[1]
        dy = cs.seeded(rng, (m, cs.C), 1.0, device)
        h = cs.seeded(rng, (m, cs.HID), 1.0, device)
        w2 = mlp[4].t().contiguous()     # (C, HID) as stored
        w1 = mlp[2]                      # (C, HID): fc1's (in, out) view
        xm = cs.seeded(rng, (m, cs.C), 1.0, device)
        aux = cs.seeded(rng, (m, cs.HID), 1.0, device)
        out += [
            (f"{qname} gemm_f32x3_epilogue[dX,f32]",
             lambda dy=dy, w2=w2: K.gemm_f32x3_epilogue_cuda(
                 dy, w2, None, "f32", None)),
            (f"{qname} gemm_f32x3_epilogue[fc1 recompute,gelu grad]",
             lambda xm=xm, w1=w1, b=mlp[3], q=qspec:
             K.gemm_f32x3_epilogue_cuda(xm, w1, b, "bias_snap_gelu_snap_grad",
                                        kernel_sites(q, 6, 7))),
            (f"{qname} gemm_f32x3_epilogue[dh,mul_aux]",
             lambda dy=dy, w2=w2, aux=aux: K.gemm_f32x3_epilogue_cuda(
                 dy, w2, None, "mul_aux", None, aux=aux)),
            (f"{qname} gemm_f32x3_epilogue[dW2,weight gradient]",
             lambda h=h, dy=dy: K.gemm_f32x3_epilogue_cuda(
                 h.t(), dy, None, "f32", None)),
        ]
    return out


def digest(out):
    outs = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def measure(iters):
    import torch

    import chip_smoke as cs
    from myrtle_vision_tpu_torch.ops import _kernels as K

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.phase_build()
    result = {"device": cs.power_line(), "cases": {}}
    for name, fn in cases(torch, cs, K, device):
        # the most frequent of five calls' outputs (a tree with a race may
        # give another now and then: their number is kept)
        digests = [digest(fn()) for _ in range(5)]
        first = max(set(digests), key=digests.count)
        ms = cs.cuda_ms(fn, iters=iters, warmup=3)
        result["cases"][name] = {"sha256": first, "ms": ms,
                                 "distinct": len(set(digests))}
        print(f"{name}: {ms:.4f} ms, sha256 {first[:16]}, "
              f"{len(set(digests))} distinct of 5", flush=True)
    return result


def compare(paths):
    runs = [json.load(open(p)) for p in paths]
    names = list(runs[0]["cases"])
    same_all = True
    for name in names:
        hashes = {r["cases"][name]["sha256"] for r in runs}
        same = len(hashes) == 1
        same_all &= same
        times = ", ".join(f"{r['cases'][name]['ms']:.4f}" for r in runs)
        print(f"{name}: outputs {'bit-identical' if same else 'DIFFER'}; "
              f"ms {times}")
    print(f"devices: {[r['device'] for r in runs]}")
    print(f"all outputs bit-identical across {len(paths)} runs: {same_all}")
    return same_all


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args()
    if args.compare:
        sys.exit(0 if compare(args.compare) else 1)
    result = measure(args.iters)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
