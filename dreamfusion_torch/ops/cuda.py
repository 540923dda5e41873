"""Build, load and count the port's hand-written CUDA kernels and its host
C++ library.

Each ``dreamfusion_torch/csrc/<name>.cu`` holds one kernel family behind a
plain C interface. It is compiled by ``nvcc`` for Hopper (``sm_90a``) into
``dreamfusion_torch/build/lib<name>.so`` at first use and loaded with
ctypes. A ``.cpp`` source (the mesh export's ``mesh_native.cpp``) is
compiled the same way by the host C++ compiler (``$CXX``, default ``g++``;
no ``-march`` flag, so the bits do not depend on the host CPU). Every
source gets its own compiler process and all of them start together. A
library is rebuilt when its source or flags change (the build directory
keeps their hash beside the library). A failed build raises with the
compiler's output; nothing falls back.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc`` or a GPU.

``launch_counts`` holds one integer per kernel. A wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

# library -> source file (under csrc/)
SOURCES = {
    "grid_encoder_bwd": "grid_encoder_bwd.cu",
    "grid_encoder_fwd": "grid_encoder_fwd.cu",
    "fused_composite": "fused_composite.cu",
    "flash_attention": "flash_attention.cu",
    "probe_select": "probe_select.cu",
    "march_cone": "march_cone.cu",
    "grid_sample": "grid_sample.cu",
    "mesh_native": "mesh_native.cpp",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-Wall"]

launch_counts: Dict[str, int] = {
    "grid_encoder_bwd": 0,
    "grid_encoder_bwd_rows": 0,
    "grid_encoder_fwd": 0,
    "composite_fwd": 0,
    "composite_bwd": 0,
    "composite_compact": 0,
    "attention_fwd": 0,
    "attention_bwd": 0,
    "probe_select_small": 0,
    "march_cone": 0,
    "grid_sample_fwd": 0,
    "grid_sample_bwd": 0,
}

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}


def reset_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or NVCC); the port's "
                       "CUDA kernels are built from dreamfusion_torch/csrc")


def _command(src: Path) -> List[str]:
    """The compiler and flags for one source, by its suffix."""
    if src.suffix == ".cpp":
        return [os.environ.get("CXX", "g++"), *CXX_FLAGS]
    return [_nvcc(), *NVCC_FLAGS]


def _digest(src: Path, cmd: List[str]) -> str:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(cmd).encode())
    return h.hexdigest()


def build(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Compile the named libraries (default: all) in parallel.
    Returns the seconds each compile took (0.0 when it was up to date);
    raises with the compiler's output if any compile fails."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        src = CSRC_DIR / SOURCES[name]
        lib = BUILD_DIR / f"lib{name}.so"
        stamp = BUILD_DIR / f"lib{name}.sha256"
        cmd = _command(src)
        digest = _digest(src, cmd)
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        try:
            p = subprocess.Popen([*cmd, "-o", str(tmp), str(src)],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the compiler {cmd[0]!r} for "
                               f"{SOURCES[name]}: {e}") from e
        procs[name] = (p, cmd[0], tmp, lib, stamp, digest)
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (p, compiler, tmp, lib, stamp, digest) in procs.items():
        out, _ = p.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = out
        if p.returncode != 0:
            errors.append(f"{compiler} failed for {SOURCES[name]}:\n{out}")
            continue
        os.replace(tmp, lib)
        stamp.write_text(digest)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        _libs[name] = lib
    return lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(err: int, kernel: str) -> None:
    """Raise if the C launcher reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch "
                           f"(cudaError {err})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
            device: Optional[torch.device] = None) -> None:
    """Wrapper-side argument checks: device, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
