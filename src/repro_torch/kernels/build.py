"""Build and load the Hopper kernels: nvcc into plain-C shared libraries,
bound with ctypes.

Each `csrc/<name>.cu` becomes `build/kernels/<name>-<digest>.so` under the
repository root (listed in `.gitignore`); the digest covers the sources
and the flags, so an edited source rebuilds. Nothing is built at import:
`library(name)` builds on first use, and `build()` starts one nvcc per
missing source, all at once, for callers that want the build up front.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("unipc_update", "adaln_modulate", "flash_attention", "quant_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# dtype codes shared with csrc/common.cuh (DTypeCode): DTYPE_CODES for the
# float kernels, OPERAND_CODES adds the quantized operands of quant_matmul
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
OPERAND_CODES = {**DTYPE_CODES, torch.int8: 2, torch.float8_e4m3fn: 3}

# the SM count a CPU tensor's plan assumes: an H100 SXM's, so the CPU tests
# check the plans the card will run
H100_SMS = 132

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA toolkit is needed "
                           "to build the port's kernels")
    return found


def target(name: str) -> Path:
    """The shared library built from `csrc/<name>.cu` with the current
    sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every missing library among `names`, one nvcc each, all in
    parallel. Returns {name: ptxas report} for what was built; raises with
    nvcc's output if any compile fails."""
    todo = [n for n in names if not target(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target(name))  # atomic: concurrent builders agree
            reports[name] = out
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    if name not in _LIBS:
        build((name,))
        lib = ctypes.CDLL(str(target(name)))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check(rc: int, name: str, lib: str | None = None) -> None:
    """Raise unless a launch function of kernel `name` (in the library of
    `csrc/<lib>.cu`, by default `<name>.cu`) returned cudaSuccess (0)."""
    if rc:
        msg = library(lib or name).error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the kernels take float32 or bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]


def operand_code(dtype: torch.dtype) -> int:
    if dtype not in OPERAND_CODES:
        raise TypeError(f"quant_matmul takes operands in "
                        f"{list(OPERAND_CODES)}, got {dtype}")
    return OPERAND_CODES[dtype]


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """The SM count of the card `t` lies on (H100_SMS for a CPU tensor)."""
    return _sms(t.device.index) if t.is_cuda else H100_SMS
