"""Fused BFP and SBFP dequant + matmul (kernels B1 and B5).

Port of ``bfp_linear_ref`` / ``bfp_linear`` and ``sbfp_linear_ref`` /
``sbfp_linear`` of ``dmx_compressor_tpu/ops/bfp_linear.py``.  BFP weights stay
int8 mantissas + per-block int8 exponents in device memory, SBFP weights int4
mantissas two to a byte + one f32 scale per block; the CUDA kernels
(``csrc/bfp_linear.cu``, ``csrc/sbfp_linear.cu``) dequantize them in
registers on their way into the f32 products, so a decode step reads a
quarter (BFP) or 0.19 (SBFP12_16) of the fp32 weight bytes.

``bfp_linear`` and ``sbfp_linear`` launch their kernel for CUDA tensors and
run the plain version (``*_ref``) for CPU tensors; there is no other path.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .bfp_pack import PackedBFP, PackedSBFP, bfp_unpack, sbfp_unpack
from .bfp_pack import sbfp_unpack_mantissa_int8  # noqa: F401  (as in the JAX module)


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
    N = w.mantissa.shape[0]
    if w.mantissa.shape != (N, K) or w.mantissa.dtype != torch.int8:
        raise ValueError(f"packed weight {tuple(w.mantissa.shape)} {w.mantissa.dtype} "
                         f"does not take x [..., {K}] (int8 mantissas, [N, K])")
    if K % w.block_size or w.exponent.shape != (N, K // w.block_size):
        raise ValueError("exponents must be [N, K // block_size]")
    x2 = x.reshape(-1, K).to(torch.float32).contiguous()
    M = x2.shape[0]
    operands = [x2, w.mantissa, w.exponent]
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        operands.append(bias)
    kernels.check_cuda(*operands, dtypes=(torch.float32, torch.int8, torch.int8, torch.float32))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    kernels.launch(
        "bfp_linear",
        x2.data_ptr(), w.mantissa.data_ptr(), w.exponent.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        M, N, K, w.block_size, w.precision,
    )
    return out.reshape(*lead, N).to(x.dtype)


def sbfp_linear_ref(x: torch.Tensor, w: PackedSBFP,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: unpack, then one f32 matmul."""
    y = torch.matmul(x.to(torch.float32), sbfp_unpack(w).T)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y.to(x.dtype)


def sbfp_linear(x: torch.Tensor, w: PackedSBFP,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ dequant(w).T + bias; ``x`` may have any leading shape.  The
    kernel takes K and the block size as multiples of 16."""
    if not kernels.plain_or_kernel(x):
        return sbfp_linear_ref(x, w, bias)
    *lead, K = x.shape
    N = w.nibbles.shape[0]
    if w.nibbles.shape != (N, K // 2) or w.nibbles.dtype != torch.uint8:
        raise ValueError(f"packed weight {tuple(w.nibbles.shape)} {w.nibbles.dtype} "
                         f"does not take x [..., {K}] (uint8 nibbles, [N, K // 2])")
    if K % 16 or w.block_size % 16 or K % w.block_size:
        raise ValueError(f"the SBFP kernel takes K and block_size as multiples of 16 "
                         f"(K % block_size == 0), got K={K}, block_size={w.block_size}")
    if w.scale.shape != (N, K // w.block_size):
        raise ValueError("scales must be [N, K // block_size]")
    x2 = x.reshape(-1, K).to(torch.float32).contiguous()
    M = x2.shape[0]
    operands = [x2, w.nibbles, w.scale]
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        operands.append(bias)
    kernels.check_cuda(*operands,
                       dtypes=(torch.float32, torch.uint8, torch.float32, torch.float32))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    kernels.launch(
        "sbfp_linear",
        x2.data_ptr(), w.nibbles.data_ptr(), w.scale.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        M, N, K, w.block_size,
    )
    return out.reshape(*lead, N).to(x.dtype)
