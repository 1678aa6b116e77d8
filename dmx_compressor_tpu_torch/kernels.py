"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library under ``build/dmx_kernels/`` at the root of the
checkout (``.gitignore`` lists ``build/``), loaded with ``ctypes``.  The
library's file name carries a hash of its source, the shared headers
``csrc/*.cuh`` and the flags, so an edit rebuilds it.  :func:`build` starts
one ``nvcc`` per source, all at once; :func:`function` builds a single
missing one at first use.  Nothing is built
or imported from the CUDA toolchain when this module is imported.

``LAUNCHES`` counts, per kernel, the launches its wrapper made: each wrapper
adds one where it launches its kernel and nowhere else.  ``ROUTE_LAUNCHES``
counts them again by route for a kernel whose C entry point picks among
several (``"sbfp_linear/gemv"``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "dmx_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# name -> (C symbol, argument types); every pointer and the stream are c_void_p
SIGNATURES = {
    "bfp_linear": ("dmx_bfp_linear", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "flash_decode_int8": (
        "dmx_flash_decode_int8",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    ),
    "flash_attention": (
        "dmx_flash_attention",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL,
         _P],
    ),
    "sbfp_linear": ("dmx_sbfp_linear", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "flash_decode": (
        "dmx_flash_decode", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "bfp_cast": ("dmx_bfp_cast", [_P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "bfp_linear_bf16": (
        "dmx_bfp_linear_bf16", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}
# "<kernel>/<route>" -> launches, for the launches that named a route
ROUTE_LAUNCHES: Dict[str, int] = {}

_FUNCS: Dict[str, object] = {}


def reset_launches() -> None:
    """Every count to 0, by kernel and by route."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


def count(name: str, route: Optional[str] = None) -> None:
    """One launch of kernel ``name``, by ``route`` where the caller names one."""
    LAUNCHES[name] += 1
    if route is not None:
        key = f"{name}/{route}"
        ROUTE_LAUNCHES[key] = ROUTE_LAUNCHES.get(key, 0) + 1


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asked
    for the CPU.  Raises when the card is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return device


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    """The library of ``<name>.cu``, named by a hash of its source, every
    shared header ``csrc/*.cuh`` (an edit to one rebuilds all) and the
    flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for a library already present); the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) goes to
    ``build/dmx_kernels/<name>.log``."""
    names = list(SIGNATURES if names is None else names)
    todo = [name for name in names if not library_path(name).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        target = library_path(name)
        tmp = target.with_name(f"{target.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        log = open(BUILD_DIR / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, target, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exited {rc}\n"
                          + (BUILD_DIR / f"{name}.log").read_text()[-4000:])
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def function(name: str):
    """The ctypes entry point of kernel ``name``, built at first use."""
    fn = _FUNCS.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


@torch.compiler.disable
def launch(name: str, *args, route: Optional[str] = None) -> None:
    """Launch kernel ``name`` on PyTorch's current stream, count it (by
    ``route`` too, where given), and raise if the launch was refused.
    ``torch.compile`` does not trace it (a foreign call through ctypes): a
    compiled caller's graph breaks here and the launch runs as in eager."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = function(name)(*args, stream)
    count(name, route)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


@torch.compiler.disable
def check_cuda(*tensors: torch.Tensor, dtypes, align: int = 16, contiguous: bool = True) -> None:
    """Validate what a kernel takes: the current CUDA device (the kernel
    launches on its stream), contiguous (unless the kernel reads through
    the strides) and ``align``-byte aligned (16 for the kernels that read
    with 16-byte loads), dtype."""
    for t, dt in zip(tensors, dtypes):
        if not t.is_cuda or t.device.index != torch.cuda.current_device():
            raise ValueError(f"kernel operands must be on the current CUDA device, got {t.device}")
        if contiguous and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"kernel operands must start on a {align}-byte boundary")
        if t.dtype != dt:
            raise ValueError(f"kernel operand dtype {t.dtype}, expected {dt}")


def plain_or_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain PyTorch version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain path for device {t.device}")
