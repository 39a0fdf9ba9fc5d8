#!/usr/bin/env python3
"""Where the time of the long fp32 core's cluster design goes, phase by
phase, on the card.

    python3 tools/perf/cluster_stamps.py [--dir archive/stamps]

Copies ``myrtle_vision_tpu_torch`` into ``--dir`` (git-ignored by
default) with ``%clock64`` stamps added at the end of each phase of
``attention_core_f32_cluster_kernel``
(csrc/attention_core_f32_long_wgmma.cu: the q rows, S with the K tiles'
conversion apart, the CTA's row max, the cluster's, the exponentials and
rowsum, the cluster's rowsum, P V, the pushed partial contexts, the
epilogue), builds that copy, runs the forward (FP16_32 with statistics)
at chip_smoke.py's ``SWEEP_TIMED`` shapes and prints, per shape, the mean,
least and largest cycles of each phase over the CTAs, the SM clock and
the CTAs' start times (``%globaltimer``) as a histogram: the waves.  The
stamps cost time of their own; the kernel's times come from
chip_smoke.py and tools/perf/core_long_bench.py.  Needs a CUDA device.
"""
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = ((2, 3, 1001, 64), (8, 3, 1001, 64), (2, 1, 1837, 32))
PHASES = ("q rows", "S", "CTA max", "cluster max", "exp and sum",
          "cluster sum", "P V", "partials pushed", "epilogue")
SLOTS = 16  # int64 a CTA: stamps 0-9, conversion and S cycles, SM, start

STAMP = f"""__device__ long long g_stamp[1 << 20];
__device__ __forceinline__ void stamp(int k) {{
  if (threadIdx.x == 0) {{
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
    const long long cta = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    g_stamp[cta * {SLOTS} + k] = t;
    if (k == 0) {{
      long long g;
      unsigned sm;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      g_stamp[cta * {SLOTS} + 15] = g;
      g_stamp[cta * {SLOTS} + 14] = sm;
    }}
  }}
}}
__device__ __forceinline__ long long clk() {{
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
  return t;
}}

"""

# (anchor in the kernel, code put after it, or before it where the anchor
# starts with "<")
EDITS = (
    ("  const int own = max(0, min(RT, tiles - first));\n",
     "  stamp(0);\n  long long conv = 0, sct = 0, tw = 0, tc = 0;\n"),
    ("          bf16_low(l0), bf16_high(l0), bf16_low(l1), bf16_high(l1));\n"
     "    }\n  }\n  __syncthreads();\n", "  stamp(1);\n"),
    ("    for (int p = 0; p < pair; ++p) sm::mbar_wait(&full[i + p], 0);\n",
     "    tw = clk();\n"),
    ("                          bf16_low(w[k].w), bf16_high(w[k].w));\n"
     "        }\n      }\n    }\n    __syncthreads();\n",
     "    tc = clk();\n    conv += tc - tw;\n"),
    ("    __syncthreads();  // the scores stored, the K rows free again\n",
     "    sct += clk() - tc;\n"),
    ("<  // ---- the row max:",
     f"  stamp(2);\n  if (threadIdx.x == 0) {{\n    const long long cta = "
     f"(long long)blockIdx.y * gridDim.x + blockIdx.x;\n    g_stamp[cta * "
     f"{SLOTS} + 12] = conv;\n    g_stamp[cta * {SLOTS} + 13] = sct;\n  }}\n"),
    ("    xmax[tid] = m;\n  }\n", "  stamp(3);\n"),
    ("    mfin[tid] = m;\n  }\n  __syncthreads();\n", "  stamp(4);\n"),
    ("      if (lane == 0) xsum[8 * warp + rr] = make_float2(hi[rr], lo[rr]);"
     "\n    }\n  }\n", "  stamp(5);\n"),
    ("    sfin[tid] = __fadd_rn(hi, lo);\n  }\n  __syncthreads();\n",
     "  stamp(6);\n"),
    ("<  // ---- the partial context to the ranks", "  stamp(7);\n"),
    ("                    u[4 * j + 2 * half + 1]);\n    }\n  }\n"
     "  cluster_sync();\n", "  stamp(8);\n"),
    ("        a.rs_out[so] = __fdiv_rn(1.0f, sfin[lr]);\n      }\n    }\n  }\n",
     "  stamp(9);\n"),
)


def stamped_copy(dst):
    """The package copied to ``dst`` with the stamps in the kernel."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "myrtle_vision_tpu_torch"),
                    os.path.join(dst, "myrtle_vision_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, "myrtle_vision_tpu_torch", "csrc",
                        "attention_core_f32_long_wgmma.cu")
    src = open(path).read()
    head = "// ---- the cluster design: its cluster"
    src = src.replace(head, STAMP + head)
    at = src.index("attention_core_f32_cluster_kernel(const __grid_constant__")
    body = src[at:]
    for anchor, code in EDITS:
        before = anchor.startswith("<")
        anchor = anchor.lstrip("<")
        i = body.index(anchor)  # raises where the kernel no longer matches
        i += 0 if before else len(anchor)
        body = body[:i] + code + body[i:]
    src = src[:at] + body + (
        "\nMVT_EXPORT int mvt_cluster_stamps(void* dst, long long n) {\n"
        "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamp, n * 8));"
        "\n}\n")
    open(path, "w").write(src)


def main():
    args = sys.argv[1:]
    dst = os.path.join(ROOT, "archive", "stamps")
    if "--dir" in args:
        dst = os.path.abspath(args[args.index("--dir") + 1])
    stamped_copy(dst)
    sys.path.insert(0, dst)
    import numpy as np
    import torch

    from myrtle_vision_tpu_torch.ops import _build
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.perf._timing import power_line

    if not torch.cuda.is_available():
        raise SystemExit("cluster_stamps: no CUDA device")
    lib = _build.lib()
    lib.mvt_cluster_stamps.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    power = power_line()
    for b, h, n, d in SHAPES:
        rng = np.random.RandomState(n)
        qkv = torch.from_numpy(rng.randn(b, n, 3 * h * d).astype(
            np.float32)).cuda()
        for _ in range(3):
            K.attention_core_snap_cuda(qkv, h, d ** -0.5, (5, 10, False),
                                       stats=True)
        torch.cuda.synchronize()
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        plan = K.f32_long_plan(n, d, b, h)
        ctas = plan["fwd"]["grid"] * b * h
        buf = np.zeros(ctas * SLOTS, dtype=np.int64)
        assert lib.mvt_cluster_stamps(buf.ctypes.data, buf.size) == 0
        s = buf.reshape(ctas, SLOTS)
        rel = s[:, :10] - s[:, :1]
        print(f"cluster_stamps: B={b} H={h} N={n} D={d}, a cluster of "
              f"{plan['fwd']['cluster']}, {ctas} CTAs, SM clock {clock} "
              f"[{power}]")
        for k, name in enumerate(PHASES, 1):
            dk = rel[:, k] - rel[:, k - 1]
            print(f"cluster_stamps:   {name:>16}: mean {dk.mean():8.0f} "
                  f"cycles (least {dk.min():.0f}, most {dk.max():.0f})")
        print(f"cluster_stamps:   a CTA {rel[:, 9].mean():.0f} cycles; of S "
              f"the K tiles' conversion {s[:, 12].mean():.0f}, the scores "
              f"{s[:, 13].mean():.0f}; SMs used {len(set(s[:, 14]))}")
        start = (s[:, 15] - s[:, 15].min()) / 1e3
        hist, edges = np.histogram(start, bins=12)
        print(f"cluster_stamps:   CTA start times (us) by bin of "
              f"{edges[1]:.1f}: {hist.tolist()}")


if __name__ == "__main__":
    main()
