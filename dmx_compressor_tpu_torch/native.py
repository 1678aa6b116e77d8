"""ctypes bindings of the native host-side quantization library
(``csrc/dmxq.cpp`` at the root of the checkout, read only).

Port of ``dmx_compressor_tpu/native.py``, with the same C entry points: an
independent C++ oracle of the fixed-point, low-bit float and block
quantizers and of BFP packing, on numpy arrays.  It is built on first use
with the system ``g++`` into ``build/dmxq/`` at the root of the checkout
(``.gitignore`` lists ``build/``; the library's name carries a hash of its
source and flags, so an edit rebuilds it).  ``AVAILABLE`` is False until a
build succeeded, and :func:`is_available` tries one; it is on no path of
the port, and a function called without a library raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
AVAILABLE = False

_ROOT = Path(__file__).resolve().parent.parent
_SRC = _ROOT / "csrc" / "dmxq.cpp"
_BUILD = _ROOT / "build" / "dmxq"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _build() -> Optional[Path]:
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / f"libdmxq_{digest}.so"
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, AVAILABLE
    if _LIB is not None:
        return _LIB
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    f32p = ctypes.POINTER(ctypes.c_float)
    i8p = ctypes.POINTER(ctypes.c_int8)
    L, I = ctypes.c_long, ctypes.c_int
    lib.dmxq_fixed_point_nearest.argtypes = [f32p, f32p, L, I, I, I, I]
    lib.dmxq_float_nearest.argtypes = [f32p, f32p, L, I, I, I, I]
    lib.dmxq_block_nearest.argtypes = [f32p, f32p, L, L, I]
    lib.dmxq_bfp_pack.argtypes = [f32p, i8p, i8p, L, L, I, I]
    lib.dmxq_bfp_unpack.argtypes = [i8p, i8p, f32p, L, L, I, I]
    _LIB = lib
    AVAILABLE = True
    return lib


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native library could not be built from {_SRC} (g++ missing "
                           "or failed)")
    return lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def fixed_point_quantize_nearest(x: np.ndarray, wl: int, fl: int, clamp: bool = True,
                                 symmetric: bool = False) -> np.ndarray:
    lib = _lib()
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty_like(x)
    lib.dmxq_fixed_point_nearest(_f32(x), _f32(y), x.size, wl, fl, int(clamp), int(symmetric))
    return y


def float_quantize_nearest(x: np.ndarray, man: int, exp: int, bias: int,
                           flush_subnormal: bool = True) -> np.ndarray:
    lib = _lib()
    x = np.ascontiguousarray(x, np.float32)
    y = np.empty_like(x)
    lib.dmxq_float_nearest(_f32(x), _f32(y), x.size, man, exp, bias, int(flush_subnormal))
    return y


def block_quantize_nearest(blocks: np.ndarray, wl: int) -> np.ndarray:
    """Blocks along the last axis."""
    lib = _lib()
    b = np.ascontiguousarray(blocks, np.float32)
    y = np.empty_like(b)
    rows = int(np.prod(b.shape[:-1])) if b.ndim > 1 else 1
    lib.dmxq_block_nearest(_f32(b), _f32(y), rows, b.shape[-1], wl)
    return y


def bfp_pack(x: np.ndarray, wl: int = 8, block_size: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """[rows, cols] f32 to (int8 mantissas, int8 block exponents)."""
    lib = _lib()
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] % block_size:
        raise ValueError(f"bfp_pack takes [rows, cols] with cols % {block_size} == 0, got "
                         f"{x.shape}")
    man = np.empty(x.shape, np.int8)
    exp = np.empty((x.shape[0], x.shape[1] // block_size), np.int8)
    lib.dmxq_bfp_pack(_f32(x), _i8(man), _i8(exp), x.shape[0], x.shape[1], block_size, wl)
    return man, exp


def bfp_unpack(man: np.ndarray, exp: np.ndarray, wl: int, block_size: int) -> np.ndarray:
    lib = _lib()
    man = np.ascontiguousarray(man, np.int8)
    exp = np.ascontiguousarray(exp, np.int8)
    y = np.empty(man.shape, np.float32)
    lib.dmxq_bfp_unpack(_i8(man), _i8(exp), _f32(y), man.shape[0], man.shape[1], block_size, wl)
    return y


def is_available() -> bool:
    return _load() is not None
