"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every `kernels/csrc/*.cu` is compiled on first use, one nvcc process per
source, all started together, for `sm_90a` (Hopper), then linked into one
shared library with a plain C interface. The sources share headers:
`csrc/hccs_common.cuh` (element loads, locators, Stage 5; kv_quant.cu uses
its loads) and the split-KV sweep `csrc/hccs_split.cuh` (hccs_arena.cu,
hccs_packed.cu, hccs_paged.cu), with the query-tiled sweep
`csrc/hccs_tiled.cuh` over it (hccs_packed.cu); ssd_packed.cu (the
Mamba-2 mixer's packed scan) stands alone.
The library:

    build/repro_torch_kernels/libkernels-<hash>.so

under the repository root. The hash covers the sources and the flags, so an
edited source rebuilds and an unchanged one loads the cached library. Only
sources in the repository are compiled; a failed compile raises with nvcc's
stderr. Fast-math flags are deliberately absent: an approximate division or
reciprocal moves logits across int8 bin boundaries.

`launch` is the one path by which every kernel wrapper calls the library:
on the current stream, raising on a CUDA error, counting the launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lib = None
# what the last build printed and how long it took (chip_smoke.py reports
# registers and shared memory per kernel from -Xptxas -v)
build_log = {"seconds": 0.0, "ptxas": "", "cached": False}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every source (in parallel) and link the shared library;
    returns its path. A cached library with the same hash is reused."""
    out = library_path()
    if out.is_file():
        build_log.update(seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}-{out.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        stdout, stderr = p.communicate()
        logs.append(stdout + stderr)
        if p.returncode != 0:
            failed.append(f"{src.name}:\n{stderr}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs]],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed\n{link.stderr}")
    os.replace(tmp, out)
    build_log.update(seconds=time.perf_counter() - t0, ptxas="".join(logs),
                     cached=False)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use, with the argument
    types of every C entry point declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        sz = ctypes.c_size_t
        # the split-sweep entry points take a workspace pointer and its
        # size in bytes after qint_out
        lib.hccs_packed_prefill_launch.argtypes = (
            [vp] * 13 + [sz] + [i] * 9 + [f, vp])
        lib.hccs_packed_prefill_launch.restype = i
        lib.hccs_paged_decode_launch.argtypes = (
            [vp] * 12 + [sz] + [i] * 9 + [f, vp])
        lib.hccs_paged_decode_launch.restype = i
        lib.hccs_decode_launch.argtypes = [vp] * 9 + [sz] + [i] * 8 + [f, vp]
        lib.hccs_decode_launch.restype = i
        lib.hccs_rows_launch.argtypes = [vp] * 3 + [i] * 3 + [vp]
        lib.hccs_rows_launch.restype = i
        lib.softmax_bf16_launch.argtypes = [vp] * 2 + [i] * 3 + [vp]
        lib.softmax_bf16_launch.restype = i
        lib.hccs_fused_launch.argtypes = [vp] * 7 + [i] * 8 + [f, i, vp]
        lib.hccs_fused_launch.restype = i
        lib.hccs_fused_smem_bytes.argtypes = [i] * 4
        lib.hccs_fused_smem_bytes.restype = sz
        # the fold takes its rows' strides as a host array of 10 int64
        lib.paged_quant_scatter_kv_launch.argtypes = (
            [vp] * 9 + [ctypes.POINTER(ctypes.c_longlong)] + [i] * 10 + [vp])
        lib.paged_quant_scatter_kv_launch.restype = i
        lib.paged_quant_scatter_kv_smem_bytes.argtypes = [i] * 2
        lib.paged_quant_scatter_kv_smem_bytes.restype = sz
        lib.ssd_packed_launch.argtypes = [vp] * 13 + [i] * 5 + [vp]
        lib.ssd_packed_launch.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def cuda_device(*tensors) -> torch.device:
    """The one CUDA device all `tensors` (None skipped) lie on; raises for
    any other device or a mix, and for a non-contiguous operand."""
    devices = {a.device for a in tensors if a is not None}
    if len(devices) != 1:
        raise ValueError("all operands must lie on one device")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not all(a.is_contiguous() for a in tensors if a is not None):
        raise ValueError("every operand must be contiguous")
    return dev


def launch(fn, entry: str, device: torch.device, *args) -> None:
    """Call the C entry point `entry` on `device`'s current stream and count
    one launch on `fn`. Tensors pass as pointers (None as a null pointer),
    other arguments as `load_library` declares them. A non-zero cudaError_t
    raises; nothing falls back."""
    lib = load_library()
    conv = [ctypes.c_void_p(0 if a is None else a.data_ptr())
            if a is None or isinstance(a, torch.Tensor) else a for a in args]
    if device.index == torch.cuda.current_device():
        err = getattr(lib, entry)(*conv, ctypes.c_void_p(
            torch.cuda.current_stream().cuda_stream))
    else:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, entry)(*conv, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")
    fn.launches += 1
