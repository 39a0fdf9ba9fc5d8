#!/usr/bin/env python3
"""The S loop of the long fp32 core's cluster design in isolation
(tools/perf/s_loop_bench.cu): builds it with nvcc for sm_90a into a
temporary directory and runs it on the card, which prints each
variant's FMAs an SM retires a cycle.

    python3 tools/perf/s_loop_bench.py

Needs a CUDA device and nvcc.
"""
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))


def main():
    from myrtle_vision_tpu_torch.ops._build import NVCC_FLAGS, nvcc
    from myrtle_vision_tpu_torch.perf._timing import power_line

    with tempfile.TemporaryDirectory() as tmp:
        exe = os.path.join(tmp, "s_loop_bench")
        subprocess.run([nvcc(), *NVCC_FLAGS[:4], "-o", exe,
                        os.path.join(HERE, "s_loop_bench.cu")], check=True)
        print(subprocess.run([exe], check=True, capture_output=True,
                             text=True).stdout.rstrip())
    print(f"s_loop_bench: [{power_line()}]")


if __name__ == "__main__":
    main()
