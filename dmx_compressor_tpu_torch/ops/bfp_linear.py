"""Fused BFP dequant + matmul (kernel B1).

Port of ``bfp_linear_ref`` / ``bfp_linear`` of
``dmx_compressor_tpu/ops/bfp_linear.py``.  BFP weights stay int8 mantissas +
per-block int8 exponents in device memory; the CUDA kernel
(``csrc/bfp_linear.cu``) dequantizes them in registers on their way into the
f32 products, so a decode step reads a quarter of the fp32 weight bytes.

``bfp_linear`` launches the kernel for CUDA tensors and runs the plain
version, ``bfp_linear_ref``, for CPU tensors; there is no other path.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .bfp_pack import PackedBFP, bfp_unpack


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
