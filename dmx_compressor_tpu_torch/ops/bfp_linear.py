"""Fused BFP and SBFP dequant + matmul (kernels B1, B5 and T1).

Port of ``bfp_linear_ref`` / ``bfp_linear`` and ``sbfp_linear_ref`` /
``sbfp_linear`` of ``dmx_compressor_tpu/ops/bfp_linear.py``, and of the bf16
form of the BFP dequant-matmul (``expand_full`` of
``dmx_compressor_tpu/tools/diag_bfpkernel_ab.py:bfp_matmul_variant``):
``bfp_linear_bf16`` / ``bfp_linear_bf16_ref``, the matmul of the BASIC fused
linear, on tensor cores (``csrc/bfp_linear_bf16.cu``).  BFP weights stay
int8 mantissas + per-block int8 exponents in device memory, SBFP weights int4
mantissas two to a byte + one f32 scale per block; the CUDA kernels
(``csrc/bfp_linear.cu``, ``csrc/sbfp_linear.cu``) dequantize them in
registers on their way into the f32 products, so a decode step reads a
quarter (BFP) or 0.19 (SBFP12_16) of the fp32 weight bytes.

B1, B5 and T1 share the kernels of ``csrc/bfp_wgmma.cuh``, on bf16 planes of
x: one for T1 (bf16(x)), three for B1 and B5 (x = h + m + l exactly,
:func:`split_bf16x3_ref`), so that their exact f32 products run on the bf16
tensor cores; the weight format (BFP int8 or SBFP int4 + scale, each exact
in bf16 once dequantized) is a template policy of those kernels.  Up to 16
rows a tensor-core GEMV reads x itself; above, the wgmma mainloop reads the
planes that a pre-pass of the same C entry point writes into a scratch
buffer the wrapper allocates.

``bfp_linear``, ``bfp_linear_bf16`` and ``sbfp_linear`` launch their kernel
for CUDA tensors and run the plain version (``*_ref``) for CPU tensors;
there is no other path.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .bfp_cast import fp16_cast_ref
from .bfp_pack import PackedBFP, PackedSBFP, bfp_unpack, sbfp_unpack
from .bfp_pack import sbfp_unpack_mantissa_int8  # noqa: F401  (as in the JAX module)


def _check_bfp_payload(w: PackedBFP, K: int) -> int:
    N = w.mantissa.shape[0]
    if w.mantissa.shape != (N, K) or w.mantissa.dtype != torch.int8:
        raise ValueError(f"packed weight {tuple(w.mantissa.shape)} {w.mantissa.dtype} "
                         f"does not take x [..., {K}] (int8 mantissas, [N, K])")
    if K % w.block_size or w.exponent.shape != (N, K // w.block_size):
        raise ValueError("exponents must be [N, K // block_size]")
    return N


# rows of x that B1, B5 and T1 serve with their decode kernel; above them
# the entry points take the wgmma path and its bf16 x-plane scratch
_DECODE_ROWS = 16


def _x_planes(x2: torch.Tensor, planes: int) -> Optional[torch.Tensor]:
    """Scratch for the wgmma path's bf16 planes of x: [planes, M, K rounded
    up to 64]; None for the decode rows (the kernel then reads x itself)."""
    M, K = x2.shape
    if M <= _DECODE_ROWS:
        return None
    return torch.empty((planes, M, -(-K // 64) * 64), dtype=torch.bfloat16, device=x2.device)


_HIGH_HALF = -65536  # 0xffff0000 as an int32: the bits of an f32 that bf16 keeps
_QUIET_NAN = 0x00400000
_SIGN = -2147483648  # 0x80000000 as an int32


def split_bf16x3_ref(x: torch.Tensor):
    """Plain transcription of the three-plane split of B1, B3 and B5
    (csrc/bfp_wgmma.cuh ``split_x``), for tests: x = h + m + l, each the
    high 16 bits of an f32
    and so exact in bf16.  h is x with its low 16 bits cleared (truncation;
    a NaN keeps its quiet bit set, since its payload may lie in the low
    half), r = x - h (exact), m = r truncated the same way and l = r - m
    (exact) truncated to bf16, m and l with x's sign bit set where x's is
    (so a zero of m or l is signed like x, and -0.0 splits into three
    -0.0); where x is not finite, m = l = 0.  (h + m) + l == x bit for bit
    where |x| >= 2^-110; below that l loses what lies under 2^-133.
    Returns (h, m, l) as bfloat16."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    sign = bits & _SIGN
    h = bits & _HIGH_HALF
    h = torch.where(torch.isnan(x), h | _QUIET_NAN, h).view(torch.float32)
    finite = torch.isfinite(x)
    r = x - h
    m = ((r.view(torch.int32) & _HIGH_HALF) | sign).view(torch.float32)
    l = (((r - m).view(torch.int32) & _HIGH_HALF) | sign).view(torch.float32)
    zero = torch.zeros_like(x)
    m, l = torch.where(finite, m, zero), torch.where(finite, l, zero)
    return tuple(p.to(torch.bfloat16) for p in (h, m, l))


def bfp_linear_ref(x: torch.Tensor, w: PackedBFP,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: unpack, then one f32 matmul."""
    y = torch.matmul(x.to(torch.float32), bfp_unpack(w).T)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(x.dtype)


def bfp_linear(x: torch.Tensor, w: PackedBFP,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ dequant(w).T + bias; ``x`` may have any leading shape."""
    if not kernels.plain_or_kernel(x):
        return bfp_linear_ref(x, w, bias)
    *lead, K = x.shape
    N = _check_bfp_payload(w, K)
    x2 = x.reshape(-1, K).to(torch.float32).contiguous()
    M = x2.shape[0]
    operands = [x2, w.mantissa, w.exponent]
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        operands.append(bias)
    kernels.check_cuda(*operands, dtypes=(torch.float32, torch.int8, torch.int8, torch.float32))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    planes = _x_planes(x2, 3)
    kernels.launch(
        "bfp_linear",
        x2.data_ptr(), w.mantissa.data_ptr(), w.exponent.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        planes.data_ptr() if planes is not None else None,
        M, N, K, w.block_size, w.precision,
    )
    return out.reshape(*lead, N).to(x.dtype)


def bfp_linear_bf16_ref(x: torch.Tensor, w: PackedBFP, bias: Optional[torch.Tensor] = None,
                        out_fp16: bool = False,
                        residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of T1: bf16(x) times the dequantized weight (exact in
    bf16 for <= 8-bit mantissas) in f32, + bias, then the FLOAT16 output
    cast when ``out_fp16`` and FLOAT16(y + residual) when ``residual`` (on
    the fp16 grid, shaped like the output) is given.  f32 out."""
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float32), bfp_unpack(w).T)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if out_fp16:
        y = fp16_cast_ref(y)
    if residual is not None:
        y = fp16_cast_ref(y + residual.to(torch.float32))
    return y


def bfp_linear_bf16(x: torch.Tensor, w: PackedBFP, bias: Optional[torch.Tensor] = None,
                    out_fp16: bool = False,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = bf16(x) @ bf16(dequant(w)).T + bias with f32 accumulation, and the
    optional FLOAT16 and ResAdd-FLOAT16 epilogues of
    :func:`bfp_linear_bf16_ref`; ``x`` may have any leading shape.  Exact
    products where x is exact in bf16 (after a BFP cast of <= 8 bits).  f32
    out."""
    if not kernels.plain_or_kernel(x):
        return bfp_linear_bf16_ref(x, w, bias, out_fp16, residual)
    *lead, K = x.shape
    N = _check_bfp_payload(w, K)
    x2 = x.reshape(-1, K).to(torch.float32).contiguous()
    M = x2.shape[0]
    operands, dtypes = [x2, w.mantissa, w.exponent], [torch.float32, torch.int8, torch.int8]
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        operands.append(bias)
        dtypes.append(torch.float32)
    if residual is not None:
        residual = residual.reshape(M, N).to(torch.float32).contiguous()
        operands.append(residual)
        dtypes.append(torch.float32)
    kernels.check_cuda(*operands, dtypes=dtypes)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    planes = _x_planes(x2, 1)
    kernels.launch(
        "bfp_linear_bf16",
        x2.data_ptr(), w.mantissa.data_ptr(), w.exponent.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        planes.data_ptr() if planes is not None else None,
        M, N, K, w.block_size, w.precision, int(out_fp16),
    )
    return out.reshape(*lead, N)


def sbfp_linear_ref(x: torch.Tensor, w: PackedSBFP,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: unpack, then one f32 matmul."""
    y = torch.matmul(x.to(torch.float32), sbfp_unpack(w).T)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(x.dtype)


def sbfp_w_planes_ref(w: PackedSBFP, planes: int):
    """Plain transcription of the weight split of B5's planes route
    (csrc/bfp_wgmma.cuh ``SbfpPlanesW``), for tests: the dequantized weight
    (``sbfp_unpack``) as its first ``planes`` (2 or 3) bf16 truncation
    planes of :func:`split_bf16x3_ref`, whose sum is the weight bit for bit
    where ``planes >= w.planes``."""
    return split_bf16x3_ref(sbfp_unpack(w))[:planes]


def sbfp_tensor_cores(w: PackedSBFP, K: int) -> bool:
    """Whether B5 serves ``w`` on its bf16 tensor-core kernels: weights exact
    in bf16 (recorded at pack time, so no call reads the scales) with K and
    the block multiples of 16.  Any other payload takes its f32 route
    (:func:`sbfp_route`), at every M."""
    return w.bf16_exact and K % 16 == 0 and w.block_size % 16 == 0


def sbfp_weight_planes(w: PackedSBFP, K: int) -> int:
    """The bf16 planes of the weight (2 or 3) on which B5's f32 route runs
    the wgmma mainloop above 16 rows: a payload off the tensor-core kernels
    whose format splits exactly (``PackedSBFP.planes``, recorded at pack
    time; one plane is served as two), with K a multiple of 32 (a TMA'd
    nibble row) and the block of 16 (one scale per 16 weights).  0 where
    the SIMT GEMM serves it instead."""
    if sbfp_tensor_cores(w, K) or not w.planes or K % 32 or w.block_size % 16:
        return 0
    return max(2, w.planes)


# B5's kernels (csrc/sbfp_linear.cu), numbered as its C entry point takes
# them; kernels.ROUTE_LAUNCHES counts B5's launches by these names
SBFP_ROUTES = ("tensor_cores", "gemv", "planes", "simt")


def sbfp_route(w: PackedSBFP, M: int, K: int) -> str:
    """The kernel of B5 that serves x [M, K] times ``w``, decided from M, K,
    the block and the format (never from the scales): the bf16 tensor-core
    kernels for :func:`sbfp_tensor_cores` payloads (the decode GEMV up to 16
    rows, the wgmma mainloop above where K % 32 == 0); for any other
    payload up to 16 rows, the f32 split-K GEMV; above, the wgmma mainloop
    on the weight's exact bf16 planes (:func:`sbfp_weight_planes`); the
    SIMT f32 GEMM for what is left (M > 16 with K % 32 != 0, or a block or
    format the planes cannot take)."""
    tc = sbfp_tensor_cores(w, K)
    if M <= _DECODE_ROWS:
        return "tensor_cores" if tc else "gemv"
    if tc and K % 32 == 0:
        return "tensor_cores"
    return "planes" if sbfp_weight_planes(w, K) else "simt"


def sbfp_linear(x: torch.Tensor, w: PackedSBFP,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ dequant(w).T + bias; ``x`` may have any leading shape; K even
    and a multiple of the block (as ``sbfp_pack`` makes it)."""
    if not kernels.plain_or_kernel(x):
        return sbfp_linear_ref(x, w, bias)
    *lead, K = x.shape
    N = w.nibbles.shape[0]
    if K % 2 or w.nibbles.shape != (N, K // 2) or w.nibbles.dtype != torch.uint8:
        raise ValueError(f"packed weight {tuple(w.nibbles.shape)} {w.nibbles.dtype} "
                         f"does not take x [..., {K}] (uint8 nibbles, [N, K // 2])")
    if K % w.block_size or w.scale.shape != (N, K // w.block_size):
        raise ValueError(f"scales must be [N, K // block_size], K a multiple of the block; "
                         f"got K={K}, block_size={w.block_size}, scales {tuple(w.scale.shape)}")
    x2 = x.reshape(-1, K).to(torch.float32).contiguous()
    M = x2.shape[0]
    operands = [x2, w.nibbles, w.scale]
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        operands.append(bias)
    kernels.check_cuda(*operands,
                       dtypes=(torch.float32, torch.uint8, torch.float32, torch.float32))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    route = sbfp_route(w, M, K)
    # the wgmma mainloop (above 16 rows) reads the pre-pass's planes of x
    planes = _x_planes(x2, 3) if route in ("tensor_cores", "planes") else None
    kernels.launch(
        "sbfp_linear",
        x2.data_ptr(), w.nibbles.data_ptr(), w.scale.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        planes.data_ptr() if planes is not None else None,
        M, N, K, w.block_size, SBFP_ROUTES.index(route), sbfp_weight_planes(w, K),
        route=route,
    )
    return out.reshape(*lead, N).to(x.dtype)
