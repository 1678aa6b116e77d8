"""Inference compression: freeze fake-quant Linears into packed BFP and SBFP
modules, and the serving configurations of the JAX bench built on them.

Port of ``PackedBFPLinear``, ``PackedSBFPLinear``, ``merge_parallel_linears``,
``compress_for_inference``, ``release_dead_originals``, ``inference_mode``
and ``set_inference_mode`` of ``dmx_compressor_tpu/ops/compress.py``, and of the
``weights``, ``sbfp``, ``basic`` and ``baseline`` recipes of
``bench.py:_build_host``.  Every Linear whose weight format is BFP becomes a
:class:`PackedBFPLinear` holding int8 mantissas + per-block exponents; it
runs kernel T1 (bf16 tensor cores) when its live input cast makes the
activations exact in bf16 (a BFP cast of <= 9 bits: BASIC mode), kernel B1
(f32) otherwise, and in the decode regime the fused BASIC linear
(``ops/basic_linear.py``: casts through T2, matmul through T1).  Every
Linear with weight format SAME and an SBFP weight storage format of at most
4 bits (any scale format) becomes a :class:`PackedSBFPLinear` holding int4
nibbles + per-block f32 scales, and runs kernel B5 (both payloads bit-exact
w.r.t. the fake-quant weight cast; kernels in ops/bfp_linear.py).

The JAX package keeps a bf16 dequant cache instead of the payload for most
layers (a TPU tuning choice, compress.py:73-77 and :310-315); the port keeps
the payload only, so a BFP16 linear reads half the bytes of a bf16 weight and
an SBFP12_16 one 0.375 of them.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional

import torch
from torch import nn

from ..nn import modules as dmxnn
from ..nn.core import DmxModule
from ..numerics.format import (
    _FLOAT16_REPR,
    BlockFloatingPoint,
    FloatingPoint,
    Same,
    ScaledBlockFloatingPoint,
)
from ..utils.tracing import eager, span
from .bfp_linear import bfp_linear, bfp_linear_bf16, sbfp_linear
from .bfp_pack import PackedBFP, PackedSBFP, bfp_pack, sbfp_pack

# the SBFP12_16 weight storage of the JAX bench's sbfp mode (bench.py:163-183),
# scale bias 16; the package's preset ``format.SBFP12_16`` is the JAX
# package's, scale bias 7 (``format.SBFP12_16_16`` is this one): neither
# replaces the other
SBFP12_16 = "SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{16}"


def _folded_bias(lin: dmxnn.Linear) -> Optional[torch.Tensor]:
    """The bias with its cast applied, detached; the cast is then set to SAME
    (folded: the cast downstream is the identity)."""
    if lin.bias is None:
        return None
    bias = lin.bias_cast(lin.bias) if lin.bias_cast is not None else lin.bias
    bias = bias.detach().clone()
    if lin.bias_cast is not None:
        lin.bias_cast.set_format("SAME")
    return bias


def _presparse_weight(lin: dmxnn.Linear) -> torch.Tensor:
    """The weight through the first stages of its pipeline, folded once
    before packing: sparsify, then the SmoothQuant scale unless it is fused
    into the weight already."""
    w = lin.weight
    if lin.weight_sparsifier is not None:
        w = lin.weight_sparsifier(w)
    if lin.smoothquant is not None and not lin.smoothquant.fused_to_weight:
        w = lin.smoothquant.scale_weight(w)
    return w


class _PackedLinear(DmxModule):
    """Inference-only Linear whose weight lives packed (no weight casts); the
    source Linear's live input/output/bias casts carry over."""

    ch_axis = -1
    win_ch_axis = -1
    wout_ch_axis = 0
    has_accum = False
    has_weight = False
    has_bias = True

    def __init__(self, bias: Optional[torch.Tensor], src: dmxnn.Linear):
        self.in_features = src.in_features
        self.out_features = src.out_features
        self.has_bias = bias is not None
        super().__init__()
        self.bias = nn.Parameter(bias, requires_grad=False) if bias is not None else None
        self.input_casts = src.input_casts
        self.output_casts = src.output_casts
        self.bias_cast = src.bias_cast
        self.input_casts["input_cast"].block_dim = -1

    def _matmul(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, input, *args, **kwargs):
        with span("dmx.linear"):
            return self._call(input, *args, **kwargs)

    def _call(self, input, *args, **kwargs):
        """The whole call, input and output casts included."""
        return super().forward(input, *args, **kwargs)

    def _forward(self, _input):
        tp = self.tp_shard
        if tp is None:
            return self._matmul(_input, self._bias)
        # tensor parallel (parallel/mesh.py): a row-parallel product is summed
        # over the group before its bias
        row = tp.role == "row"
        out = self._matmul(tp.enter(_input), None if row else self._bias)
        if row:
            out = tp.partial_sum(out)
            if self.bias is not None:
                out = out + self._bias.to(out.dtype)
        return tp.finish(out)


class PackedBFPLinear(_PackedLinear):
    """Inference-only Linear with packed BFP weights and a fused
    dequant-matmul kernel: T1 on bf16-exact activations, B1 otherwise."""

    def __init__(self, packed: PackedBFP, bias: Optional[torch.Tensor], src: dmxnn.Linear):
        super().__init__(bias, src)
        self.register_buffer("weight_mantissa", packed.mantissa)
        self.register_buffer("weight_exponent", packed.exponent)
        self.precision = packed.precision
        self.block_size = packed.block_size

    @property
    def packed(self) -> PackedBFP:
        if self.weight_mantissa is None:
            raise RuntimeError("this projection was merged into a fused one and released")
        return PackedBFP(self.weight_mantissa, self.weight_exponent, self.precision,
                         self.block_size)

    # ---- the fused fake-quant path: input cast + matmul + fp16 out ----

    def _fusable(self, x: torch.Tensor) -> bool:
        """The whole BASIC pipeline of this module folds into the fused path
        (ops/basic_linear.py): at most 256 rows (the decode regime), a
        symmetric nearest BFP input cast along the last axis, a SAME or
        FLOAT16 output cast, no observer or pre-transform, and no stateful
        hook at work (plugins, OBC, AFT, flop counting, a dynamic or
        calibrating SmoothQuant)."""
        if x.ndim < 1 or x.shape[-1] != self.in_features or x.numel() // x.shape[-1] > 256:
            return False
        if self.tp_shard is not None and self.tp_shard.role != "col":
            return False  # its collective sits between the matmul and the casts
        ic = self.input_casts["input_cast"]
        oc = self.output_casts[self.output_cast_names[0]]
        in_ok = (
            isinstance(ic.format, BlockFloatingPoint)
            and ic.format.symmetric
            and ic.format.rounding == "nearest"
            and ic.format.block_size > 1
            and ic.block_dim in (-1, x.ndim - 1)
            and self.in_features % ic.format.block_size == 0
            and ic.fake_quant_enabled
            and not ic.observer_enabled
            and not ic.pre_transform
        )
        out_ok = (
            (isinstance(oc.format, Same) or repr(oc.format) == _FLOAT16_REPR)
            and oc.fake_quant_enabled and not oc.observer_enabled and not oc.pre_transform
        )
        sq = self.smoothquant
        quiet = (
            not DmxModule.plugins
            and self.obc is None
            and self.aft is None
            and not (self.flop_counter_enabled and eager())
            and (sq is None or not (sq.dynamic or sq.calibrating))
        )
        return in_ok and out_ok and quiet

    def _call(self, input, *args, **kwargs):
        if not self._fusable(input):
            return super()._call(input, *args, **kwargs)
        from .basic_linear import fused_basic_linear

        x = input
        if self.smoothquant is not None:
            x = self.smoothquant.scale_input(x)
        ic = self.input_casts["input_cast"]
        oc = self.output_casts[self.output_cast_names[0]]
        out = fused_basic_linear(
            x.to(torch.float32), packed=self.packed, bias=self.bias,
            in_wl=ic.format.precision, in_block=ic.format.block_size,
            out_fp16=isinstance(oc.format, FloatingPoint),
        )
        return out.to(input.dtype) if self.align_boundary_dtype else out

    def _acts_exact_in_bf16(self) -> bool:
        """True when the live input cast makes the activations reaching
        ``_forward`` exact in bf16: BFP with <= 8 mantissa bits, fake-quant
        on (the quantized serving configurations)."""
        ic = self.input_casts["input_cast"]
        return (isinstance(ic.format, BlockFloatingPoint) and ic.format.precision <= 9
                and ic.fake_quant_enabled)

    def _matmul(self, x, bias):
        if self._acts_exact_in_bf16():
            return bfp_linear_bf16(x, self.packed, bias=bias).to(x.dtype)
        return bfp_linear(x, self.packed, bias=bias)

    @classmethod
    def from_linear(cls, lin: dmxnn.Linear) -> "PackedBFPLinear":
        fmt = lin.weight_format
        if not isinstance(fmt, BlockFloatingPoint):
            raise TypeError(f"PackedBFPLinear requires a BFP weight format, got {fmt!r}")
        with torch.no_grad():
            w = _presparse_weight(lin)
            if lin.weight_storage_cast is not None and not isinstance(
                lin.weight_storage_cast.format, Same
            ):
                w = lin.weight_storage_cast(w)
            packed = bfp_pack(w.to(torch.float32), fmt.precision, fmt.block_size)
            bias = _folded_bias(lin)
        return cls(packed, bias, lin)


class PackedSBFPLinear(_PackedLinear):
    """Inference-only Linear serving from SBFP payloads: two's-complement
    int4 mantissas packed two to a byte + one f32 scale per block (0.75
    bytes per weight for SBFP12_16, against 4 for f32), through the fused
    dequant-matmul kernel B5.  Covers weights-only SBFP serving: weight
    storage format SBFP with weight format SAME."""

    def __init__(self, packed: PackedSBFP, bias: Optional[torch.Tensor], src: dmxnn.Linear):
        super().__init__(bias, src)
        self.register_buffer("weight_nibbles", packed.nibbles)
        self.register_buffer("weight_block_scale", packed.scale)
        self.block_size = packed.block_size
        self.bf16_exact = packed.bf16_exact
        self.planes = packed.planes

    @property
    def packed(self) -> PackedSBFP:
        return PackedSBFP(self.weight_nibbles, self.weight_block_scale, self.block_size,
                          self.bf16_exact, self.planes)

    def _matmul(self, x, bias):
        return sbfp_linear(x, self.packed, bias=bias)

    @classmethod
    def from_linear(cls, lin: dmxnn.Linear) -> "PackedSBFPLinear":
        fmt = lin.weight_storage_format
        if not isinstance(fmt, ScaledBlockFloatingPoint) or not isinstance(
            lin.weight_format, Same
        ):
            raise TypeError("PackedSBFPLinear requires SBFP weight storage and weight "
                            f"format SAME, got {fmt!r} / {lin.weight_format!r}")
        with torch.no_grad():
            packed = sbfp_pack(_presparse_weight(lin).to(torch.float32), fmt)
            bias = _folded_bias(lin)
        return cls(packed, bias, lin)


def merge_parallel_linears(mods: List[nn.Module]) -> Optional[PackedBFPLinear]:
    """Concatenate sibling PackedBFPLinears that consume the same input (q/k/v)
    into one module: one kernel launch instead of three.  Bit-exact, since the
    matmul is row-independent.  None unless every module has the same static
    cast configuration."""
    if not mods or not all(isinstance(m, PackedBFPLinear) for m in mods):
        return None

    def sig(m):
        ic = m.input_casts["input_cast"]
        oc = m.output_casts[m.output_cast_names[0]]
        return (
            m.in_features, repr(ic.format), ic.block_dim, ic.fake_quant_enabled,
            ic.observer_enabled, bool(ic.pre_transform), repr(oc.format),
            oc.fake_quant_enabled, oc.observer_enabled, bool(oc.pre_transform),
            m.precision, m.block_size, m.bias is not None,
        )

    if len({sig(m) for m in mods}) != 1:
        return None
    if any(m.smoothquant is not None and (m.smoothquant.dynamic
                                          or m.smoothquant.input_maxabs_exists)
           for m in mods):
        return None
    packed = PackedBFP(
        torch.cat([m.weight_mantissa for m in mods], dim=0),
        torch.cat([m.weight_exponent for m in mods], dim=0),
        mods[0].precision,
        mods[0].block_size,
    )
    bias = torch.cat([m.bias for m in mods]) if mods[0].bias is not None else None
    # inherits mods[0]'s live casts: exactly the sharing wanted (same configs)
    merged = PackedBFPLinear(packed, bias, src=mods[0])
    merged.out_features = sum(m.out_features for m in mods)
    return merged


@contextmanager
def inference_mode():
    """Within this context, approximated ops compute only the surrogate
    (identical values, no gradient path)."""
    prev = DmxModule.inference_mode
    DmxModule.inference_mode = True
    try:
        yield
    finally:
        DmxModule.inference_mode = prev


def set_inference_mode(enabled: bool = True) -> None:
    DmxModule.inference_mode = enabled


def _replace_linears(parent: nn.Module) -> int:
    count = 0
    for name, child in list(parent.named_children()):
        fmt = getattr(child, "weight_format", None)
        store = getattr(child, "weight_storage_format", None)
        if (
            isinstance(child, dmxnn.Linear)
            and isinstance(fmt, BlockFloatingPoint)
            and fmt.block_size > 1
            and child.in_features % fmt.block_size == 0
        ):
            setattr(parent, name, PackedBFPLinear.from_linear(child))
            count += 1
        elif (
            isinstance(child, dmxnn.Linear)
            and isinstance(fmt, Same)
            and isinstance(store, ScaledBlockFloatingPoint)
            and store.block_format.precision <= 4
            and child.in_features % store.block_size == 0
        ):
            setattr(parent, name, PackedSBFPLinear.from_linear(child))
            count += 1
        else:
            count += _replace_linears(child)
    return count


def compress_for_inference(dm, keep_originals: bool = False) -> int:
    """Replace BFP-weight Linears of a DmxModel with PackedBFPLinear and
    SBFP-stored ones with PackedSBFPLinear, then let composite modules fuse
    their packed children (merged BFP q/k/v, and gate/up) and freeze their
    routing.  The merged originals' payloads are released unless
    ``keep_originals``.  Returns the number of modules converted."""
    model = dm.module if hasattr(dm, "module") else dm
    if getattr(model, "tp_placement", None) is not None:
        raise ValueError("compress_for_inference: the model is sharded (parallel.shard_state); "
                         "compress it first, then shard it")
    count = _replace_linears(model)
    for m in list(model.modules()):
        if hasattr(m, "fuse_for_inference"):
            m.fuse_for_inference()
    if not keep_originals:
        release_dead_originals(model)
    return count


# merged module -> the projections it supersedes
_MERGED = {"qkv_merged": ("q_proj", "k_proj", "v_proj"), "gateup_merged": ("gate_proj", "up_proj")}


def release_dead_originals(model: nn.Module) -> int:
    """Free the payloads of projections superseded by a merged module
    (``qkv_merged``, ``gateup_merged``).  The modules stay attached, but
    calling them raises.  Returns the number released."""
    released = 0
    for m in model.modules():
        for merged, names in _MERGED.items():
            if getattr(m, merged, None) is None:
                continue
            for name in names:
                p = getattr(m, name, None)
                if isinstance(p, PackedBFPLinear) and p.weight_mantissa is not None:
                    p.weight_mantissa = None
                    p.weight_exponent = None
                    released += 1
    return released


def weights_mode_rules(model: nn.Module):
    """The weights-mode configuration before compression:
    ``DmxModel.from_raw`` -> ``to_basic_mode`` -> every input/output cast SAME
    and every approximator ``NoApproximation`` (BFP16_64 weight casts on the
    Linears).  A PTQ recipe runs here, before ``compress_for_inference``
    packs the weights.  Returns the DmxModel; ``model`` is transformed in
    place."""
    from ..functional.approximate import NoApproximation
    from ..modeling.model import DmxModel

    dm = DmxModel.from_raw(model)
    dm.to_basic_mode()
    for _, m in dm.named_dmx_modules():
        m.input_casts.set_format(["SAME"] * len(m.input_casts))
        m.output_casts.set_format(["SAME"] * len(m.output_casts))
        m.approximator.function = NoApproximation()
    return dm


def build_weights_mode(model: nn.Module):
    """The weights-mode serving configuration (BFP16_64 packed weights,
    activations in their own precision): :func:`weights_mode_rules` ->
    ``compress_for_inference`` -> inference mode.  Returns the DmxModel;
    ``model`` is transformed in place."""
    dm = weights_mode_rules(model)
    compress_for_inference(dm)
    set_inference_mode(True)
    return dm


def build_basic_mode(model: nn.Module):
    """The BASIC fake-quant serving configuration (bench.py's basic mode):
    ``DmxModel.from_raw`` -> ``to_basic_mode`` (BFP16_64 Linear and
    ActActMatMul inputs, FLOAT16 module boundaries, the SOFTMAX and
    LAYER_NORM surrogates) -> ``compress_for_inference`` (packed BFP16_64
    weights, merged q/k/v) -> inference mode.  Serve it with a float16
    split cache (``init_cache(..., dtype=torch.float16, split_base_len=
    prompt)``) and ``ops/split_decode.prepare_split_decode`` between
    prefill and decode.  Returns the DmxModel; ``model`` is transformed in
    place."""
    from ..modeling.model import DmxModel

    dm = DmxModel.from_raw(model)
    dm.to_basic_mode()
    compress_for_inference(dm)
    set_inference_mode(True)
    return dm


def build_sbfp_mode(model: nn.Module, fmt: str = SBFP12_16):
    """The SBFP serving configuration (SBFP weight storage served from packed
    int4 payloads, activations in their own precision):
    ``DmxModel.from_raw`` -> every Linear (the tied LM head included) gets
    weight storage ``fmt`` (bench.py's SBFP12_16 by default, scale bias 16,
    not the bias-7 preset ``format.SBFP12_16`` that ``to_basic_mode(
    sbfp_weight_storage=True)`` stores) ->
    ``compress_for_inference`` -> inference mode.  Returns the DmxModel;
    ``model`` is transformed in place."""
    from ..modeling.model import DmxConfigRule, DmxModel

    dm = DmxModel.from_raw(model)
    dm.configure(None, DmxConfigRule(module_types=(dmxnn.Linear,),
                                     module_config=dict(weight_storage_format=fmt)))
    compress_for_inference(dm)
    set_inference_mode(True)
    return dm


def build_baseline_mode(model: nn.Module):
    """The fp32 baseline the JAX bench divides by: ``DmxModel.from_raw`` ->
    ``to_baseline_mode`` (every cast SAME, no surrogate; the Linears stay
    plain matmuls).  The attention modules' routing is frozen once here, as
    ``compress_for_inference`` does for the packed modes, so decode steps do
    not walk the casts.  Returns the DmxModel; ``model`` is transformed in
    place."""
    from ..modeling.model import DmxModel

    dm = DmxModel.from_raw(model)
    dm.to_baseline_mode()
    for m in dm.module.modules():
        if hasattr(m, "freeze_routing"):
            m.freeze_routing()
    return dm
