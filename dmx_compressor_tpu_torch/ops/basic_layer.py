"""Decode-regime fused layer steps for BASIC mode (OPT, GPT-2 and the
Llama-topology families: Llama, Qwen3, Gemma, Mistral).

Port of ``layer_norm_surrogate_fp16``, ``resadd_fp16``, ``fused_ln_linear``,
``rms_norm_surrogate_fp16``, ``silu_surrogate_fp16``, ``gelu_tanh_fp16``,
``rope_surrogate_fp16``, ``fused_rms_linear``, ``fused_llama_family_step``,
``BasicLayerPlan``, ``_linear_basic_ok``, ``_fp16_io_ok``, ``BasicHeadPlan``,
``basic_head_plan``, ``fused_rms_head``, ``basic_rms_head_plan``,
``BasicLlamaPlan``, ``_casts_same_ok``, ``_llama_family_plan``,
``basic_llama_layer_plan``, ``basic_gemma_layer_plan``,
``basic_qwen3_layer_plan``, ``basic_gpt2_block_plan`` and ``basic_layer_plan`` of
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
module's own FLOAT16 casts are identities).  One fused decode step of a
Llama-topology layer (:func:`fused_llama_family_step`): RMS1 + merged qkv /
[Qwen3: the per-head q / k RMS surrogates] / the RoPE surrogate / the
fused split-cache SDPA (GQA) / o_proj / resadd1 + RMS2 + merged gate-up /
SiLU (Gemma: tanh-GELU) * up / down_proj + resadd2, the RMS_NORM[vsimd]
and SILU[vsimd] surrogates in plain torch, Gemma's (1 + w) norm weights
folded as its module folds them.  GPT-2's fused block
(models/gpt2.py ``GPT2Block._fused_basic_step``, its plan
:func:`basic_gpt2_block_plan`) is OPT's step with the ReLU replaced by the
exact tanh-GELU between FLOAT16 casts (:func:`gelu_tanh_fp16`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import rawnn
from ..functional import simd_ops
from ..numerics.format import _FLOAT16_REPR, BlockFloatingPoint
from .basic_linear import _fp16_cast_f32, fused_basic_linear
from .bfp_pack import PackedBFP


def layer_norm_surrogate_fp16(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor,
                              eps: float, on_grid: bool = False,
                              out_cast: bool = True) -> torch.Tensor:
    """FLOAT16 input cast + LAYER_NORM[vsimd] surrogate + FLOAT16 output
    cast.  ``on_grid`` skips the input cast where the producer emitted
    fp16-grid values (the cast is an identity there); ``out_cast=False``
    leaves the output cast to the consumer (``fused_ln_linear``, whose BFP
    input cast takes it in the same launch)."""
    x16 = x.to(torch.float32)
    if not on_grid:
        x16 = _fp16_cast_f32(x16)
    mean = torch.mean(x16, dim=-1, keepdim=True)
    d = x16 - mean
    var = torch.mean(torch.square(d), dim=-1, keepdim=True)
    r0 = torch.rsqrt(var + eps)
    rr = r0 * (1.5 - 0.5 * (var + eps) * r0 * r0)  # one Newton step
    y = d * rr * ln_w.to(torch.float32) + ln_b.to(torch.float32)
    return _fp16_cast_f32(y) if out_cast else y


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
    (the next residual).  The LN's FLOAT16 output cast and the linear's BFP
    input cast run as one T2 launch (``bfp_cast(..., fp16_first=True)``).
    The JAX package's ``w_bf16`` weights are not ported: the port keeps the
    int8 payload only."""
    h = x
    on_grid = input_on_grid
    if residual is not None:
        h = resadd_fp16(h, residual, a_on_grid=input_on_grid, b_on_grid=residual_on_grid)
        on_grid = True  # resadd's FLOAT16 output cast just ran
    pre = h
    h = layer_norm_surrogate_fp16(h, ln_w, ln_b, eps, on_grid=on_grid, out_cast=False)
    y = fused_basic_linear(h, packed=packed, bias=bias, in_wl=wl, in_block=in_block,
                           out_fp16=True, in_fp16_first=True)
    if relu:
        y = torch.clamp(y, min=0.0)
    if emit_pre:
        return y, pre.to(x.dtype)
    return y


def rms_norm_surrogate_fp16(x: torch.Tensor, w: torch.Tensor, eps: float,
                            on_grid: bool = False, out_cast: bool = True) -> torch.Tensor:
    """FLOAT16 input cast + RMS_NORM[vsimd] surrogate (tile_size None, the
    Newton-refined rsqrt) + FLOAT16 output cast; ``on_grid`` and
    ``out_cast`` as in :func:`layer_norm_surrogate_fp16`."""
    x16 = x.to(torch.float32)
    if not on_grid:
        x16 = _fp16_cast_f32(x16)
    y = simd_ops.rms_norm(x16, x16.shape[-1:], w, eps)
    return _fp16_cast_f32(y) if out_cast else y


def silu_surrogate_fp16(x: torch.Tensor, kmax: int = 15, on_grid: bool = False) -> torch.Tensor:
    """FLOAT16 input cast + SILU[vsimd] surrogate (x * sigmoid(x) with the
    poly2 exponential, knorm 0) + FLOAT16 output cast."""
    x16 = x.to(torch.float32)
    if not on_grid:
        x16 = _fp16_cast_f32(x16)
    return _fp16_cast_f32(simd_ops.silu(x16, 0, kmax))


def gelu_tanh_fp16(x: torch.Tensor, on_grid: bool = False) -> torch.Tensor:
    """FLOAT16 input cast + the exact tanh-GELU + FLOAT16 output cast: the
    BASIC rule set leaves GELUBase at approximation NONE, so the module
    computes the raw function (``jax.nn.gelu``'s tanh form) between its
    FLOAT16 io casts (Gemma's ``gelu_pytorch_tanh`` MLP)."""
    x16 = x.to(torch.float32)
    if not on_grid:
        x16 = _fp16_cast_f32(x16)
    return _fp16_cast_f32(rawnn.gelu(x16, True))


def rope_surrogate_fp16(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                        qk_on_grid: bool = False):
    """ApplyRotaryPosEmb under the BASIC rule set: FLOAT16 casts on its four
    inputs (q and k skipped when on the grid), the APPLY_LLAMA_ROPE[vsimd]
    surrogate (rotate-half in f32, unsqueeze_dim 1), FLOAT16 casts on both
    outputs."""
    qf = q.to(torch.float32)
    kf = k.to(torch.float32)
    if not qk_on_grid:
        qf = _fp16_cast_f32(qf)
        kf = _fp16_cast_f32(kf)
    q_out, k_out = simd_ops.apply_rotary_pos_emb(qf, kf, _fp16_cast_f32(cos.to(torch.float32)),
                                                 _fp16_cast_f32(sin.to(torch.float32)))
    return _fp16_cast_f32(q_out).to(q.dtype), _fp16_cast_f32(k_out).to(k.dtype)


def fused_rms_linear(
    x: torch.Tensor,
    *,
    packed: PackedBFP,
    bias: Optional[torch.Tensor] = None,
    rms_w: torch.Tensor,
    eps: float,
    wl: int,
    in_block: int,
    residual: Optional[torch.Tensor] = None,
    emit_pre: bool = False,
    input_on_grid: bool = False,
    residual_on_grid: bool = False,
):
    """[resadd ->] RMS surrogate -> BFP cast -> dequant matmul [-> bias] ->
    FLOAT16: the RMSNorm analogue of :func:`fused_ln_linear` (the RMS
    output cast and the BFP input cast in one T2 launch).  With
    ``emit_pre`` also returns the resadd output (the next residual)."""
    h = x
    on_grid = input_on_grid
    if residual is not None:
        h = resadd_fp16(h, residual, a_on_grid=input_on_grid, b_on_grid=residual_on_grid)
        on_grid = True  # resadd's FLOAT16 output cast just ran
    pre = h
    h = rms_norm_surrogate_fp16(h, rms_w, eps, on_grid=on_grid, out_cast=False)
    y = fused_basic_linear(h, packed=packed, bias=bias, in_wl=wl, in_block=in_block,
                           out_fp16=True, in_fp16_first=True)
    if emit_pre:
        return y, pre.to(x.dtype)
    return y


def fused_llama_family_step(layer, x, cos, sin, attn_mask, cache, plan,
                            plain_causal: bool = True) -> torch.Tensor:
    """One fused BASIC decode step of a Llama-topology decoder layer (Llama,
    Qwen3, Gemma), driven by the family fields of ``plan``: RMS1 + qkv /
    [the per-head q / k RMS surrogates (Qwen3)] / RoPE surrogate / fused
    SDPA (split cache, GQA) / o_proj / resadd1 + RMS2 + gate-up / act * up
    / down_proj + resadd2, the modular pipeline's numerics up to the f32
    summation order of the RMS moments and the matmuls.  Gemma's (1 + w)
    norm weights fold here as its module's approximator_wrapper folds them
    (the weight through its casts, then 1 + w).  The mask is applied
    additively throughout, so a banded one fuses as a plain causal one
    does; ``plain_causal`` only steers ``cached_attend``'s flash-decode
    routing, which BASIC's sdpa never takes."""
    from .flash_decode import cached_attend

    def norm_w(ln):
        w = ln._weight
        return 1.0 + w.to(torch.float32) if plan.gemma_norm else w

    B, T, _ = x.shape
    attn, mlp = layer.self_attn, layer.mlp
    merged = attn.qkv_merged
    qkv = fused_rms_linear(x, packed=merged.packed, bias=merged.bias,
                           rms_w=norm_w(layer.input_layernorm), eps=plan.ln1_eps,
                           wl=plan.wl, in_block=plan.block)
    d = attn.num_heads * attn.head_dim
    kv = attn.num_kv_heads * attn.head_dim
    q = attn._split(qkv[..., :d], attn.num_heads)
    k = attn._split(qkv[..., d:d + kv], attn.num_kv_heads)
    v = attn._split(qkv[..., d + kv:], attn.num_kv_heads)
    if plan.qk_norm_eps is not None:
        # Qwen3's per-head q / k RMSNorm before RoPE (over head_dim, so the
        # layout does not matter); q, k: qkv's FLOAT16 output cast, on the
        # grid, so their input casts are identities and skipped, as RoPE's
        q = rms_norm_surrogate_fp16(q, attn.q_norm._weight, plan.qk_norm_eps, on_grid=True)
        k = rms_norm_surrogate_fp16(k, attn.k_norm._weight, plan.qk_norm_eps, on_grid=True)
    # q, k: on the grid (qkv's, or the q / k norms', FLOAT16 output cast)
    q, k = rope_surrogate_fp16(q, k, cos, sin, qk_on_grid=True)
    ctx = cached_attend(attn.sdpa, q, k, v, cache, attn_mask,
                        enable_gqa=attn.num_kv_heads != attn.num_heads,
                        plain_causal=plain_causal, transparent=attn._transparent())
    y = attn.o_proj(ctx.transpose(1, 2).reshape(B, T, d))  # PackedBFPLinear's fused path
    gateup = mlp.gateup_merged
    gu, r = fused_rms_linear(
        y, packed=gateup.packed, bias=gateup.bias,
        rms_w=norm_w(layer.post_attention_layernorm), eps=plan.ln2_eps, wl=plan.wl,
        in_block=plan.block, residual=x, emit_pre=True,
        input_on_grid=True,  # y: o_proj's FLOAT16 output cast
    )
    m = mlp.intermediate_size
    act = silu_surrogate_fp16 if plan.act == "silu" else gelu_tanh_fp16
    prod = act(gu[..., :m], on_grid=True) * gu[..., m:]  # Mul: SAME
    down = mlp.down_proj
    return fused_basic_linear(
        prod, packed=down.packed, bias=down.bias, in_wl=plan.wl, in_block=plan.block,
        out_fp16=True, res_out=r,
        res_on_grid=True,  # r: resadd's FLOAT16 output cast
    )


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

    if not isinstance(m, PackedBFPLinear) or m.tp_shard is not None:
        return False  # a tensor-parallel linear runs the modular path
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
    sq = m.smoothquant
    if sq is not None and (sq.dynamic or sq.calibrating or sq.input_maxabs_exists):
        return False
    if m.obc is not None or m.aft is not None:
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

    if not DmxModule.inference_mode or DmxModule.plugins or DmxModule.monitors:
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

    if not DmxModule.inference_mode or DmxModule.plugins or DmxModule.monitors:
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


def basic_gpt2_block_plan(block) -> Optional[BasicLayerPlan]:
    """The fused step's plan when a GPT2Block (after compress_for_inference)
    is in the BASIC decode shape; None: the modular path.  ``c_attn`` is
    born merged, so only the cast surface needs proving: LayerNorms with the
    LAYER_NORM[vsimd] surrogate, the tanh-GELU left at approximation NONE
    by the BASIC rules, biased PackedBFPLinears with one shared input
    format."""
    from ..nn import modules as dmxnn
    from ..nn.core import DmxModule

    if not DmxModule.inference_mode or DmxModule.plugins or DmxModule.monitors:
        return None
    attn, mlp = getattr(block, "attn", None), getattr(block, "mlp", None)
    linears = [getattr(attn, "c_attn", None), getattr(attn, "c_proj", None),
               getattr(mlp, "c_fc", None), getattr(mlp, "c_proj", None)]
    if not all(_linear_basic_ok(m) for m in linears):
        return None
    ln1, ln2 = block.ln_1, block.ln_2
    for ln in (ln1, ln2):
        if not isinstance(ln, dmxnn.LayerNorm) or not _fp16_io_ok(ln, "layer_norm"):
            return None
        if ln.weight is None or ln.bias is None:
            return None
    for ra in (block.resadd1, block.resadd2):
        if not isinstance(ra, dmxnn.ResAdd) or not _fp16_io_ok(ra, None):
            return None
    act = mlp.act
    if (not isinstance(act, dmxnn.GELUBase) or act.approximate != "tanh"
            or not _fp16_io_ok(act, None)):
        return None
    ic = linears[0].input_casts["input_cast"]
    if any(m.input_casts["input_cast"].format != ic.format for m in linears[1:]):
        return None
    return BasicLayerPlan(wl=ic.format.precision, block=ic.format.block_size,
                          ln1_eps=float(ln1.eps), ln2_eps=float(ln2.eps))


def fused_rms_head(h, final_norm, lm_head, plan, *, gemma_norm: bool = False):
    """The final (Gemma)RMSNorm and the LM head as one fused chain (the
    decode tail of the Llama-topology families), the modular
    ``lm_head(norm(h))``'s numerics; Gemma's (1 + w) folds as its module
    folds it."""
    w = final_norm._weight
    return fused_rms_linear(
        h, packed=lm_head.packed, bias=lm_head.bias,
        rms_w=1.0 + w.to(torch.float32) if gemma_norm else w,
        eps=plan.ln_eps, wl=plan.wl, in_block=plan.block,
        # h: the decoder's final residual, a FLOAT16 resadd output cast on
        # the fused and the modular layer paths
        input_on_grid=True,
    )


def basic_rms_head_plan(final_norm, lm_head, *, gemma_norm: bool = False
                        ) -> Optional[BasicHeadPlan]:
    """The RMSNorm analogue of :func:`basic_head_plan`: fuse the decoder's
    final (Gemma)RMSNorm into the LM head (an exact type match on the norm,
    so the (1 + w) variant never crosses with the plain one); None: the
    modular path."""
    from ..nn import modules as dmxnn
    from ..nn.core import DmxModule

    if not DmxModule.inference_mode or DmxModule.plugins or DmxModule.monitors:
        return None
    norm_t = dmxnn.GemmaRMSNorm if gemma_norm else dmxnn.RMSNorm
    if type(final_norm) is not norm_t or not _fp16_io_ok(final_norm, "rms_norm"):
        return None
    if final_norm.weight is None or not _linear_basic_ok(lm_head, require_bias=False):
        return None
    ic = lm_head.input_casts["input_cast"]
    return BasicHeadPlan(wl=ic.format.precision, block=ic.format.block_size,
                         ln_eps=float(final_norm.eps))


class BasicLlamaPlan(NamedTuple):
    """Static parameters proving a Llama-topology decoder layer is in the
    exact BASIC decode shape the fused step reproduces.  The families'
    deltas are fields: Gemma's ``gemma_norm`` ((1 + w) RMSNorm) and ``act``
    ("gelu_tanh"), Qwen3's ``qk_norm_eps`` (per-head q / k RMSNorm before
    RoPE)."""

    wl: int
    block: int
    ln1_eps: float
    ln2_eps: float
    gemma_norm: bool = False
    act: str = "silu"
    qk_norm_eps: Optional[float] = None


def _casts_same_ok(m) -> bool:
    """Every io cast SAME and no approximation (a module the BASIC rule set
    does not configure, such as Mul)."""
    from ..functional.approximate import NoApproximation
    from ..numerics.format import Same

    casts = [m.input_casts[n] for n in m.input_cast_names] + [
        m.output_casts[n] for n in m.output_cast_names]
    return (all(isinstance(c.format, Same) for c in casts)
            and isinstance(m.approximator.function, NoApproximation))


def _llama_family_plan(layer, *, gemma_norm: bool = False, act: str = "silu",
                       qk_norm: bool = False) -> Optional[BasicLlamaPlan]:
    """The plan check of a Llama-topology layer: :func:`basic_layer_plan`'s
    surface plus the family's modules: RMSNorms with the RMS_NORM[vsimd]
    surrogate (GemmaRMSNorm where ``gemma_norm``: an exact type match, so
    the two never cross), the gate activation (SiLU with SILU[vsimd], or
    tanh-GELU left at approximation NONE by the BASIC rules), Mul left
    SAME, RoPE with APPLY_LLAMA_ROPE[vsimd] and FLOAT16 io on its four
    inputs and two outputs, for Qwen3 the per-head q / k RMSNorms, merged
    bias-free qkv and gate-up linears with one shared input format."""
    from ..nn import modules as dmxnn
    from ..nn.core import DmxModule

    if not DmxModule.inference_mode or DmxModule.plugins or DmxModule.monitors:
        return None
    attn = getattr(layer, "self_attn", None)
    mlp = getattr(layer, "mlp", None)
    merged = getattr(attn, "qkv_merged", None)
    gateup = getattr(mlp, "gateup_merged", None)
    if not all(_linear_basic_ok(m, require_bias=False)
               for m in (merged, gateup, getattr(attn, "o_proj", None),
                         getattr(mlp, "down_proj", None))):
        return None
    norm_t = dmxnn.GemmaRMSNorm if gemma_norm else dmxnn.RMSNorm
    ln1, ln2 = layer.input_layernorm, layer.post_attention_layernorm
    for ln in (ln1, ln2):
        if type(ln) is not norm_t or not _fp16_io_ok(ln, "rms_norm") or ln.weight is None:
            return None
    for ra in (layer.resadd1, layer.resadd2):
        if not isinstance(ra, dmxnn.ResAdd) or not _fp16_io_ok(ra, None):
            return None
    if act == "silu":
        if not isinstance(mlp.act_fn, dmxnn.SiLU) or not _fp16_io_ok(mlp.act_fn, "silu"):
            return None
    elif act == "gelu_tanh":
        if (not isinstance(mlp.act_fn, dmxnn.GELUBase) or mlp.act_fn.approximate != "tanh"
                or not _fp16_io_ok(mlp.act_fn, None)):
            return None
    else:
        return None
    if not isinstance(mlp.mul, dmxnn.Mul) or not _casts_same_ok(mlp.mul):
        return None
    rope = attn.apply_rope
    if not isinstance(rope, dmxnn.ApplyRotaryPosEmb) or not _fp16_io_ok(
            rope, "apply_rotary_pos_emb"):
        return None
    qk_eps = None
    if qk_norm:
        qn, kn = getattr(attn, "q_norm", None), getattr(attn, "k_norm", None)
        for n in (qn, kn):
            if type(n) is not dmxnn.RMSNorm or not _fp16_io_ok(n, "rms_norm") or n.weight is None:
                return None
        if float(qn.eps) != float(kn.eps):
            return None
        qk_eps = float(qn.eps)
    ic = merged.input_casts["input_cast"]
    if any(m.input_casts["input_cast"].format != ic.format
           for m in (gateup, mlp.down_proj, attn.o_proj)):
        return None
    return BasicLlamaPlan(wl=ic.format.precision, block=ic.format.block_size,
                          ln1_eps=float(ln1.eps), ln2_eps=float(ln2.eps),
                          gemma_norm=gemma_norm, act=act, qk_norm_eps=qk_eps)


def basic_llama_layer_plan(layer) -> Optional[BasicLlamaPlan]:
    """The fused step's plan when a LlamaDecoderLayer (after
    compress_for_inference: merged qkv and gate-up) is in the BASIC decode
    shape; None: the modular path."""
    return _llama_family_plan(layer)


def basic_gemma_layer_plan(layer) -> Optional[BasicLlamaPlan]:
    """Gemma's: (1 + w) GemmaRMSNorms and the tanh-GELU gate activation
    (left at approximation NONE by the BASIC rules)."""
    return _llama_family_plan(layer, gemma_norm=True, act="gelu_tanh")


def basic_qwen3_layer_plan(layer) -> Optional[BasicLlamaPlan]:
    """Qwen3's: the Llama layer chain plus the per-head q / k RMSNorms
    before RoPE."""
    return _llama_family_plan(layer, qk_norm=True)
