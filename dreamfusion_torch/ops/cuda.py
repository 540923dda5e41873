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

``ENTRIES`` is the one record of the libraries' C interface: every
``extern "C"`` function of ``csrc/``, its library, its parameters' ctypes
and the ``launch_counts`` key it advances. A library's entry points are
typed from it when the library is loaded (``tests/test_torch_kernel_abi.py``
holds it against the C prototypes), and a wrapper reaches a kernel only
through ``launch``, or a host function through ``function``.

``launch_counts`` holds one integer per counted kernel. ``launch`` adds one
per kernel call (a wrapper whose one call makes several C calls counts
once itself) and nothing else does, so a run can show that its main path
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
from typing import Dict, List, NamedTuple, Optional, Tuple

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
    "march_window": "march_window.cu",
    "grid_sample": "grid_sample.cu",
    "mesh_native": "mesh_native.cpp",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-Wall"]

# the kinds of C parameter: a pointer, int (32-bit), int64_t / long long
# and float
_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)


class Entry(NamedTuple):
    """One C entry point: its library, its parameters' ctypes (a CUDA
    entry's last is the stream) and the launch_counts key that a call
    advances (None where no call is counted: the host library's functions
    and attention's delta pass). Every entry returns int: 0, or a
    cudaError / nonzero code."""
    library: str
    argtypes: Tuple[type, ...]
    counter: Optional[str]


ENTRIES: Dict[str, Entry] = {
    "grid_encoder_bwd": Entry("grid_encoder_bwd", (_P,) * 5 + (_I32, _I32, _P),
                              "grid_encoder_bwd"),
    "grid_encoder_bwd_rows": Entry("grid_encoder_bwd",
                                   (_P,) * 4 + (_I32, _I32, _P),
                                   "grid_encoder_bwd_rows"),
    "grid_encoder_fwd": Entry("grid_encoder_fwd",
                              (_P, _P, _I32, _P, _P, _F32, _F32, _I32, _I32,
                               _P), "grid_encoder_fwd"),
    "composite_fwd": Entry("fused_composite",
                           (_P,) * 7 + (_I32, _I32, _F32, _P),
                           "composite_fwd"),
    "composite_bwd": Entry("fused_composite",
                           (_P,) * 9 + (_I32, _I32, _F32, _P),
                           "composite_bwd"),
    "composite_compact": Entry("fused_composite",
                               (_P,) * 7 + (_I32, _I64, _F32, _P),
                               "composite_compact"),
    "attention_fwd": Entry("flash_attention",
                           (_P,) * 7 + (_I32,) * 7 + (_F32, _P),
                           "attention_fwd"),
    "attention_bwd_delta": Entry("flash_attention",
                                 (_P,) * 3 + (_I32,) * 4 + (_P,), None),
    "attention_bwd": Entry("flash_attention",
                           (_P,) * 11 + (_I32,) * 7 + (_F32, _P),
                           "attention_bwd"),
    "probe_select": Entry("probe_select", (_P, _P, _P, _I32, _I64, _P),
                          "probe_select_small"),
    "march_cone": Entry("march_cone",
                        (_P,) * 9 + (_I32,) * 5 + (_F32,) * 5 + (_P,),
                        "march_cone"),
    "march_window": Entry("march_window",
                          (_P,) * 17 + (_I32,) * 12 + (_F32,) * 5 + (_P,),
                          "march_window"),
    "grid_sample_fwd": Entry("grid_sample",
                             (_P,) * 3 + (_I32,) * 4 + (_I64, _P),
                             "grid_sample_fwd"),
    "grid_sample_bwd": Entry("grid_sample",
                             (_P,) * 3 + (_I32,) * 4 + (_I64, _P),
                             "grid_sample_bwd"),
    "marching_tetrahedra": Entry("mesh_native",
                                 (_P, _I32, _I32, _I32, _F32, _P, _P, _P, _P),
                                 None),
    "rasterize_uv": Entry("mesh_native", (_P, _I64, _I32, _I32, _P, _P), None),
    "nearest_inpaint": Entry("mesh_native", (_P, _P) + (_I32,) * 4, None),
}

launch_counts: Dict[str, int] = {
    e.counter: 0 for e in ENTRIES.values() if e.counter is not None}

_libs: Dict[str, ctypes.CDLL] = {}
# symbol -> its typed C function, set when its library is loaded
_fns: Dict[str, ctypes._CFuncPtr] = {}
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
    """The loaded library `name`, built first if needed; its entry points
    are typed from ENTRIES once, when it is loaded."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        for symbol, entry in ENTRIES.items():
            if entry.library == name:
                fn = _fns[symbol] = getattr(lib, symbol)
                fn.argtypes, fn.restype = entry.argtypes, ctypes.c_int
        _libs[name] = lib
    return lib


def function(symbol: str):
    """The typed C function `symbol` of ENTRIES, its library loaded (and
    built) first if needed."""
    library(ENTRIES[symbol].library)
    return _fns[symbol]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(symbol: str, device: torch.device, *args, count: bool = True
           ) -> None:
    """Call the CUDA entry point `symbol` with `args` and `device`'s current
    stream; raise if the C launcher reported a CUDA error
    (cudaGetLastError). The call advances the entry's launch_counts key,
    if it has one, unless `count` is False: a wrapper that makes several
    calls for one kernel call counts once itself."""
    err = (_fns.get(symbol) or function(symbol))(*args, stream_ptr(device))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch "
                           f"(cudaError {err})")
    if count and (counter := ENTRIES[symbol].counter) is not None:
        launch_counts[counter] += 1


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
