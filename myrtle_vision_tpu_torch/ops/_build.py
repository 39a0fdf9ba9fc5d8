"""Build and load the port's CUDA kernels.

At first use the sources ``myrtle_vision_tpu_torch/csrc/*.cu`` are
compiled by ``nvcc`` for Hopper (``sm_90a``), one process per source, all
started together, and linked into one shared library with a plain C
interface, in ``myrtle_vision_tpu_torch/_build/`` (listed in
``.gitignore``), and loaded with ``ctypes``.  The library's name
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused.  Nothing is downloaded; only sources in
the repository are built.  The TMA kernels reach the driver's
tensor-map encoder through ``cudaGetDriverEntryPoint`` (csrc/sm90.cuh), so
the library links the CUDA runtime only, not ``-lcuda``.

Importing this module compiles nothing: the kernels build when
:func:`lib` is first called, which happens only for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lib = None


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else /usr/local/cuda/bin."""
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of myrtle_vision_tpu_torch "
            "build with the CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return path


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return BUILD_DIR / f"libmvt_kernels_{h.hexdigest()[:16]}.so"


def _run(procs):
    """Wait for every (command, process) and raise on the first failure;
    returns their combined output."""
    report = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            for _, other in procs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{stdout}\n{stderr}"
            )
        report.append(stdout + stderr)
    return "".join(report)


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the build directory unless an up-to-date
    library is there already; returns the library's path.  Each source
    compiles in its own nvcc process, all at once, then one link.
    ``verbose`` adds ``-Xptxas -v`` and prints what nvcc reports
    (registers, shared memory and spills of each kernel)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects, compiles = [], []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objects.append(obj)
    try:
        report = _run(compiles)
        tmp = out.with_name(f"{out.name}.{tag}")
        link = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                *map(str, objects)]
        report += _run([(link, subprocess.Popen(
            link, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))])
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    if verbose:
        print(report)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at the first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ll = ctypes.c_longlong
        for name, args in (
            ("mvt_layernorm_rows", [p, p, p, p, i, i, f, p]),
            ("mvt_gemm_bf16", [p, p, p, p, p, p, p, i, i, i, i, i, f, p]),
            ("mvt_gemm_bf16_at", [p, p, p, i, i, i, i, p]),
            ("mvt_gemm_bf16_tile", [i]),
            ("mvt_gemm_bf16_encode_ns", [p, p, i, i, i, i]),
            ("mvt_attention_core", [p, p, p, p, i, i, i, i, f, p]),
            ("mvt_attention_core_max_n", []),
            ("mvt_attention_core_long", [p, p, p, p, i, i, i, i, f, p]),
            ("mvt_attention_core_long_plan", [i, i, p]),
            ("mvt_attention_core_bwd", [p] * 9 + [i, i, i, i, f, p, p]),
            ("mvt_attention_core_bwd_tiled",
             [p] * 9 + [i, i, i, i, f, p, p]),
            ("mvt_layernorm_rows_bwd", [p, p, p, p, p, p, i, i, i, f, f, p]),
            ("mvt_layernorm_rows_bwd_max_cols", []),
            ("mvt_colsum_rows", [p, i, p, p, i, i, i, p, p]),
            ("mvt_layernorm_quant_rows", [p, p, p, p, p, i, i, f, p]),
            ("mvt_gemm_s8", [p] * 10 + [i, i, i, i, p]),
            ("mvt_gemm_s8_tile", [i]),
            ("mvt_attention_core_f32", [p, p, p, i, i, i, i, f, p]),
            ("mvt_attention_core_f32_max_n", []),
            ("mvt_attention_core_f32_snap",
             [p, p, p, p, i, i, i, i, f, i, i, p, p]),
            ("mvt_attention_core_f32_bwd", [p] * 6 + [i, i, i, i, f, p]),
            ("mvt_attention_core_f32_bwd_max_n", []),
            ("mvt_attention_core_f32_snap_recip",
             [p, p, p, p, i, i, i, i, f, i, i, p]),
            ("mvt_attention_core_f32_launch", [i, i, p]),
            ("mvt_attention_core_f32_bwd_launch", [i, i, p]),
            ("mvt_attention_core_f32_long",
             [p] * 5 + [i, i, i, i, f, i, i, p, i, p, p]),
            ("mvt_attention_core_f32_long_i8",
             [p] * 4 + [i, i, i, i, f, i, p, p]),
            ("mvt_attention_core_f32_long_max_n", []),
            ("mvt_attention_core_f32_long_block_max_n", []),
            ("mvt_attention_core_f32_long_plan", [i, i, i, i, p]),
            ("mvt_attention_core_f32_bwd_long",
             [p] * 9 + [i, i, i, i, f, p, p]),
            ("mvt_attention_core_f32_bwd_long_max_n", []),
            ("mvt_fake_quant_rows", [p, p, ll, i, i, i, p]),
            ("mvt_layernorm_snap_rows",
             [p, p, p, p, i, i, f, i, i, i, p, p]),
            ("mvt_layernorm_snap_rows_max_cols", []),
            ("mvt_layernorm_snap_rows_plan", [i, i, p]),
            ("mvt_gemm_f32x3", [p] * 7 + [i] * 8 + [p, p, f, p]),
            ("mvt_gemm_f32x3_at", [p, p, p, i, i, i, i, p]),
            ("mvt_gemm_f32x3_tile", [i]),
            ("mvt_layernorm_snap_rows_bwd",
             [p] * 6 + [i, i, i, f, i, i, i, i, f, p]),
            ("mvt_flash_attention_fwd",
             [p] * 5 + [ll, i, i, ll, i, i, i, i, i, i, i, f, p]),
            ("mvt_flash_attention_bwd",
             [p] * 10 + [ll, i, i] * 4 + [i] * 5 + [f, p, p]),
            ("mvt_flash_attention_fwd_plan", [i, i, p]),
            ("mvt_flash_attention_f32_fwd",
             [p] * 6 + [ll, i, i] + [i] * 5 + [f, p, p]),
            ("mvt_flash_attention_f32_bwd",
             [p] * 11 + [ll, i, i] * 3 + [i] * 5 + [f, p, p]),
            ("mvt_flash_attention_bwd_plan", [i, i, p]),
            ("mvt_attention_core_probe", [p, p, p, p, i, i, i, i, f, i, p]),
            ("mvt_gemm_bf16_probe", [p] * 5 + [i] * 6 + [p]),
            ("mvt_gemm_layout_probe",
             [p, p, p] + [i] * 5 + [ll, ll, i] * 3 + [i, i, i, p]),
        ):
            fn = getattr(handle, name)
            fn.argtypes = args
            fn.restype = i
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (a launch that the
    driver refused never runs, and a later synchronize would not say)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
