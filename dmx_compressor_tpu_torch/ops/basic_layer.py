"""Decode-regime fused layer steps for BASIC mode (the OPT subset).

Port of ``layer_norm_surrogate_fp16``, ``resadd_fp16``, ``fused_ln_linear``,
``BasicLayerPlan``, ``_linear_basic_ok``, ``_fp16_io_ok``, ``BasicHeadPlan``,
``basic_head_plan`` and ``basic_layer_plan`` of
``dmx_compressor_tpu/ops/basic_layer.py``.  One fused OPT decode step
(models/opt.py ``OPTDecoderLayer._fused_basic_step``):

  LN1 surrogate + input BFP cast + merged-qkv matmul  (fused_ln_linear)
  fused BASIC SDPA                                    (ops/basic_attention)
  out_proj                                            (fused_basic_linear)
  resadd1 + LN2 surrogate + cast + fc1 + ReLU         (fused_ln_linear,
                                                       emits the next residual)
  fc2 + bias + resadd2 epilogue                       (fused_basic_linear
                                                       with ``res_out``)

Every folded op repeats the modular DmxModule pipeline op for op in f32:
the FLOAT16 boundaries and the BFP input casts through kernel T2, the
matmuls and their FLOAT16 / ResAdd epilogues through kernel T1, the
LAYER_NORM[vsimd] surrogate as functional/simd_ops.layer_norm (tile_size
None, the Newton-refined rsqrt) in plain torch, ReLU folded after fc1's
output cast (max(., 0) of fp16-grid values stays on the grid, so the ReLU
module's own FLOAT16 casts are identities).  The Llama, Gemma, Qwen3 and
GPT-2 plans of the JAX module are not ported: the port serves OPT.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..numerics.format import _FLOAT16_REPR, BlockFloatingPoint
from .basic_linear import _fp16_cast_f32, fused_basic_linear
from .bfp_pack import PackedBFP


def layer_norm_surrogate_fp16(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                              eps: float, on_grid: bool = False) -> torch.Tensor:
    """FLOAT16 input cast + LAYER_NORM[vsimd] surrogate + FLOAT16 output
    cast.  ``on_grid`` skips the input cast where the producer emitted
    fp16-grid values (the cast is an identity there)."""
    x16 = x.to(torch.float32)
    if not on_grid:
        x16 = _fp16_cast_f32(x16)
    mean = torch.mean(x16, dim=-1, keepdim=True)
    d = x16 - mean
    var = torch.mean(torch.square(d), dim=-1, keepdim=True)
    r0 = torch.rsqrt(var + eps)
    rr = r0 * (1.5 - 0.5 * (var + eps) * r0 * r0)  # one Newton step
    y = d * rr * ln_w.to(torch.float32) + ln_b.to(torch.float32)
    return _fp16_cast_f32(y)


def resadd_fp16(a: torch.Tensor, b: torch.Tensor, a_on_grid: bool = False,
                b_on_grid: bool = False) -> torch.Tensor:
    """ResAdd under the BASIC rule set: FLOAT16 casts on both inputs (each
    skipped when on the grid already), add, FLOAT16 output cast."""
    af = a.to(torch.float32)
    bf = b.to(torch.float32)
    if not a_on_grid:
        af = _fp16_cast_f32(af)
    if not b_on_grid:
        bf = _fp16_cast_f32(bf)
    return _fp16_cast_f32(af + bf)


def fused_ln_linear(
    x: torch.Tensor,
    *,
    packed: PackedBFP,
    bias: Optional[torch.Tensor],
    ln_w: torch.Tensor,
    ln_b: torch.Tensor,
    eps: float,
    wl: int,
    in_block: int,
    residual: Optional[torch.Tensor] = None,
    relu: bool = False,
    emit_pre: bool = False,
    input_on_grid: bool = False,
    residual_on_grid: bool = False,
):
    """[resadd ->] LN surrogate -> BFP cast -> dequant matmul -> bias ->
    FLOAT16 [-> ReLU].  With ``emit_pre`` also returns the resadd output
    (the next residual).  The JAX package's ``w_bf16`` weights are not
    ported: the port keeps the int8 payload only."""
    h = x
    on_grid = input_on_grid
    if residual is not None:
        h = resadd_fp16(h, residual, a_on_grid=input_on_grid, b_on_grid=residual_on_grid)
        on_grid = True  # resadd's FLOAT16 output cast just ran
    pre = h
    h = layer_norm_surrogate_fp16(h, ln_w, ln_b, eps, on_grid=on_grid)
    y = fused_basic_linear(h, packed=packed, bias=bias, in_wl=wl, in_block=in_block,
                           out_fp16=True)
    if relu:
        y = torch.clamp(y, min=0.0)
    if emit_pre:
        return y, pre.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# static shape detection
# ---------------------------------------------------------------------------


class BasicLayerPlan(NamedTuple):
    """Static parameters proving an OPT decoder layer is in the exact BASIC
    decode shape the fused step reproduces."""

    wl: int
    block: int
    ln1_eps: float
    ln2_eps: float


def _quiet(c) -> bool:
    return c.fake_quant_enabled and not c.observer_enabled and not c.pre_transform


def _linear_basic_ok(m, require_bias: bool = True) -> bool:
    """The PackedBFPLinear's pipeline folds into the fused path: a symmetric
    nearest BFP input cast along the last axis, a FLOAT16 output cast, no
    observer, pre-transform or stateful hook."""
    from .compress import PackedBFPLinear

    if not isinstance(m, PackedBFPLinear):
        return False
    ic = m.input_casts["input_cast"]
    oc = m.output_casts[m.output_cast_names[0]]
    fmt = ic.format
    if not (isinstance(fmt, BlockFloatingPoint) and fmt.symmetric
            and fmt.rounding == "nearest" and fmt.block_size > 1
            and ic.block_dim in (-1, 1) and m.in_features % fmt.block_size == 0
            and _quiet(ic)):
        return False
    if not (repr(oc.format) == _FLOAT16_REPR and _quiet(oc)):
        return False
    if m.smoothquant is not None or m.obc is not None or m.aft is not None:
        return False
    return m.bias is not None or not require_bias


def _fp16_io_ok(m, approx_name: Optional[str]) -> bool:
    """The module has pure FLOAT16 io casts and the expected approximation
    (``None``: none; else that surrogate, without wrapper or extra
    parameters)."""
    from ..functional.approximate import NoApproximation

    for c in [m.input_casts[n] for n in m.input_cast_names] + [
            m.output_casts[n] for n in m.output_cast_names]:
        if not (repr(c.format) == _FLOAT16_REPR and _quiet(c)):
            return False
    fn = m.approximator.function
    if approx_name is None:
        return isinstance(fn, NoApproximation)
    if isinstance(fn, NoApproximation):
        return False
    return (getattr(fn, "func_name", None) == approx_name
            and not dict(fn.wrapper_params) and not dict(fn.extra_params))


class BasicHeadPlan(NamedTuple):
    wl: int
    block: int
    ln_eps: float


def basic_head_plan(final_ln, lm_head) -> Optional[BasicHeadPlan]:
    """The plan for fusing the decoder's final LayerNorm into the LM head
    (the layer plan's checks; the head may be bias-free); None: the
    modular path."""
    from ..nn import modules as dmxnn
    from ..nn.core import DmxModule

    if not DmxModule.inference_mode or DmxModule.plugins:
        return None
    if not isinstance(final_ln, dmxnn.LayerNorm) or not _fp16_io_ok(final_ln, "layer_norm"):
        return None
    if final_ln.weight is None or final_ln.bias is None:
        return None
    if not _linear_basic_ok(lm_head, require_bias=False):
        return None
    ic = lm_head.input_casts["input_cast"]
    return BasicHeadPlan(wl=ic.format.precision, block=ic.format.block_size,
                         ln_eps=float(final_ln.eps))


def basic_layer_plan(layer) -> Optional[BasicLayerPlan]:
    """The fused step's plan when an OPTDecoderLayer (after
    compress_for_inference) is in the BASIC decode shape; None: the
    modular path."""
    from ..nn import modules as dmxnn
    from ..nn.core import DmxModule

    if not DmxModule.inference_mode or DmxModule.plugins:
        return None
    if not layer.do_layer_norm_before:
        return None
    attn = layer.self_attn
    merged = attn.qkv_merged
    if merged is None or not _linear_basic_ok(merged):
        return None
    if not all(_linear_basic_ok(m) for m in (layer.fc1, layer.fc2, attn.out_proj)):
        return None
    ln1, ln2 = layer.self_attn_layer_norm, layer.final_layer_norm
    for ln in (ln1, ln2):
        if not isinstance(ln, dmxnn.LayerNorm) or not _fp16_io_ok(ln, "layer_norm"):
            return None
        if ln.weight is None or ln.bias is None:
            return None
    for ra in (layer.resadd1, layer.resadd2):
        if not isinstance(ra, dmxnn.ResAdd) or not _fp16_io_ok(ra, None):
            return None
    if not isinstance(layer.activation_fn, dmxnn.ReLU) or not _fp16_io_ok(
            layer.activation_fn, None):
        return None
    ic = merged.input_casts["input_cast"]
    if (layer.fc1.input_casts["input_cast"].format != ic.format
            or layer.fc2.input_casts["input_cast"].format != ic.format):
        return None
    return BasicLayerPlan(wl=ic.format.precision, block=ic.format.block_size,
                          ln1_eps=float(ln1.eps), ln2_eps=float(ln2.eps))
