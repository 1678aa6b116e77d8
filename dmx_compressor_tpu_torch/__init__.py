"""dmx_compressor_tpu_torch: the PyTorch/CUDA port of dmx_compressor_tpu.

The package mirrors the JAX package's module paths and public names.  Plain
tensor code is PyTorch; every kernel of the JAX package's Pallas code on the
ported path is a CUDA kernel written for Hopper (``csrc/``), built with
``nvcc`` at first use and launched through ``ctypes``.  Entry points run on
the card unless the caller passes ``device="cpu"``; they never fall back to
the CPU on their own.  The package imports neither ``jax`` nor
``dmx_compressor_tpu``.

Top-level namespaces mirror the JAX package's: the ``format.*`` presets,
``sparseness.*`` (N:M block top-K), ``default_approx.*`` and ``config_rules.{BASELINE, FP8, BASIC,
SBFP_WEIGHT_STORAGE}`` (the JAX package's rules, row for row).

``format.SBFP12_16`` is the JAX package's preset, scale bias 7.  The serving
recipe ``ops.compress.build_sbfp_mode`` stores bench.py's SBFP12_16 instead,
scale bias 16 (``ops.compress.SBFP12_16``, ``format.SBFP12_16_16`` here);
neither replaces the other.
"""

from types import SimpleNamespace

from . import nn, utils
from .functional.approximate import ApproximationFunction
from .modeling.model import (
    DmxConfig,
    DmxConfigRule,
    DmxModel,
    DmxSimplePipeline,
    DmxTransformation,
    Model,
)
from .numerics.format import Format
from .sparse import Sparseness

__version__ = "0.1.0"

# the SIMD surrogate library ships in the package (functional/simd_ops.py),
# as in the JAX package
VSIMD_OP_REF_AVAILABLE = True
NUMERICS_UTILS_AVAILABLE = False

_F = Format.from_shorthand

format = SimpleNamespace(
    SAME=_F("SAME"),
    FLOAT32=_F("FP[1|8|23,127](_N)"),
    FLOAT16=_F("FP[1|5|10,15](FN)"),
    BFLOAT16=_F("FP[1|8|7,127](FN)"),
    AFLOAT8=_F("FP[1|4|3,7](_N)"),
    BFLOAT8=_F("FP[1|5|2,15](_N)"),
    INT8=_F("XP[8,0](CSN)"),
    INT4=_F("XP[4,0](CSN)"),
    BFP32_1=_F("BFP[24|8]{1}(SN)"),
)
for _p, _pname in ((16, "24"), (8, "16"), (6, "14"), (4, "12")):
    for _b in (128, 64, 32, 16):
        setattr(format, f"BFP{_pname}_{_b}", _F(f"BFP[{_p}|8]{{{_b}}}(SN)"))
for _pname, _p in (("16A", 8), ("14A", 6), ("12A", 4)):
    for _b in (128, 64, 32, 16):
        # the nominal precision for every A-variant, BFP16A_16 included, as
        # the JAX package has it
        setattr(format, f"BFP{_pname}_{_b}", _F(f"BFP[{_p}|8]{{{_b}}}(_N)"))
format.SBFP12_16 = _F("SBFP<XP[4,0](CSN)><FP[0|4|4,7](FN)>{16}")
for _bias in range(4, 19):
    setattr(format, f"SBFP12_16_{_bias}", _F(f"SBFP<XP[4,0](CSN)><FP[0|4|4,{_bias}](FN)>{{16}}"))
for _sh, _name in (("E4M3", "MXFP8"), ("E5M2", "MXFP8"), ("E2M3", "MXFP6"), ("E3M2", "MXFP6"),
                   ("E2M1", "MXFP4")):
    for _b in (128, 64, 32):
        setattr(format, f"{_name}_{_sh}K{_b}", _F(f"{_name}[{_sh}]{{{_b}}}"))
for _p in (8, 6, 4):
    for _b in (128, 64, 32):
        setattr(format, f"MXINT{_p}_K{_b}", _F(f"MXINT{_p}{{{_b}}}"))

# N:M sparseness presets
sparseness = SimpleNamespace(
    BTK8_4_LD=Sparseness.from_shorthand("BTOPK{4:8,-1}(U)"),
    BTK8_4_FD=Sparseness.from_shorthand("BTOPK{4:8,1}(U)"),
    BTK8_2_LD=Sparseness.from_shorthand("BTOPK{2:8,-1}(U)"),
    BTK8_2_FD=Sparseness.from_shorthand("BTOPK{2:8,1}(U)"),
)

_A = ApproximationFunction.from_shorthand

default_approx = SimpleNamespace(
    RELU=_A("NONE"),
    RELU6=_A("NONE"),
    SILU=_A("SILU[vsimd]{}()"),
    SOFTMAX=_A("SOFTMAX[vsimd]{input_clamp=-100}(max_adjust=0.1141)"),
    GELU=_A("NONE"),
    QUICK_GELU=_A("QUICK_GELU[vsimd]{}()"),
    TANH=_A("NONE"),
    BATCH_NORM_2D=_A("NONE"),
    LAYER_NORM=_A("LAYER_NORM[vsimd]{}()"),
    RMS_NORM=_A("RMS_NORM[vsimd]{}()"),
    GROUP_NORM=_A("NONE"),
    EXP=_A("EXP[vsimd]{}(knorm=0,kmax=15,use_exp_large=True)"),
    APPLY_LLAMA_ROPE=_A("APPLY_LLAMA_ROPE[vsimd]{}()"),
    NONE=_A("NONE"),
)


def _rules_for(io_fmt, linear_fmt, bias_fmt, out_fmt, approx):
    """Shared shape of the BASELINE and BASIC rule sets."""
    return [
        DmxConfigRule(
            module_types=(nn.Linear,),
            module_config=dict(
                input_formats=[linear_fmt],
                weight_format=linear_fmt,
                bias_format=bias_fmt,
                output_formats=[out_fmt],
            ),
        ),
        DmxConfigRule(
            module_types=(nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d),
            module_config=dict(
                input_formats=[linear_fmt],
                weight_format=linear_fmt,
                bias_format=bias_fmt,
                output_formats=[out_fmt],
            ),
        ),
        DmxConfigRule(
            module_types=(nn.ResAdd,),
            module_config=dict(input_formats=[io_fmt, io_fmt], output_formats=[io_fmt]),
        ),
        DmxConfigRule(
            module_types=(nn.ActActMatMul,),
            module_config=dict(input_formats=[linear_fmt, linear_fmt], output_formats=[out_fmt]),
        ),
        DmxConfigRule(module_types=(nn.Embedding,), module_config=dict(output_formats=[out_fmt])),
        DmxConfigRule(
            module_types=(nn.MaxPool2d, nn.AdaptiveAvgPool2d, nn.AvgPool2d),
            module_config=dict(input_formats=[io_fmt], output_formats=[io_fmt]),
        ),
    ] + [
        DmxConfigRule(
            module_types=types,
            module_config=dict(
                input_formats=[io_fmt] * n_in, output_formats=[io_fmt] * n_out,
                approximation_function=fn,
            ),
        )
        for types, fn, n_in, n_out in approx
    ]


config_rules = SimpleNamespace(
    BASELINE=_rules_for(
        format.SAME, format.SAME, format.SAME, format.SAME,
        approx=[((nn.ReLU, nn.ReLU6, nn.GELUBase, nn.SiLU, nn.Tanh, nn.Softmax, nn.LayerNorm,
                  nn.BatchNorm2d, nn.GroupNorm, nn.Exp), default_approx.NONE, 1, 1)],
    ),
    FP8=_rules_for(
        format.FLOAT16, format.AFLOAT8, format.FLOAT32, format.FLOAT16,
        approx=[
            ((nn.ReLU, nn.ReLU6, nn.GELUBase, nn.QuickGELU, nn.SiLU, nn.Tanh, nn.Softmax,
              nn.LayerNorm, nn.RMSNorm, nn.BatchNorm2d, nn.GroupNorm, nn.Exp),
             default_approx.NONE, 1, 1),
            ((nn.ApplyRotaryPosEmb,), default_approx.NONE, 4, 2),
        ],
    ),
    BASIC=_rules_for(
        format.FLOAT16, format.BFP16_64, format.BFP32_1, format.FLOAT16,
        approx=[
            ((nn.ReLU,), default_approx.RELU, 1, 1),
            ((nn.ReLU6,), default_approx.RELU6, 1, 1),
            ((nn.GELUBase,), default_approx.GELU, 1, 1),
            ((nn.QuickGELU,), default_approx.QUICK_GELU, 1, 1),
            ((nn.SiLU,), default_approx.SILU, 1, 1),
            ((nn.Tanh,), default_approx.TANH, 1, 1),
            ((nn.Softmax,), default_approx.SOFTMAX, 1, 1),
            ((nn.LayerNorm,), default_approx.LAYER_NORM, 1, 1),
            ((nn.RMSNorm,), default_approx.RMS_NORM, 1, 1),
            ((nn.BatchNorm2d,), default_approx.BATCH_NORM_2D, 1, 1),
            ((nn.GroupNorm,), default_approx.GROUP_NORM, 1, 1),
            ((nn.Exp,), default_approx.EXP, 1, 1),
            ((nn.ApplyRotaryPosEmb,), default_approx.APPLY_LLAMA_ROPE, 4, 2),
        ],
    ),
    SBFP_WEIGHT_STORAGE=[
        DmxConfigRule(module_types=(nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d),
                      module_config=dict(weight_storage_format=format.SBFP12_16)),
    ],
)

__all__ = [
    "Format",
    "Sparseness",
    "ApproximationFunction",
    "DmxModel",
    "DmxConfig",
    "DmxConfigRule",
    "DmxTransformation",
    "DmxSimplePipeline",
    "Model",
    "nn",
    "format",
    "sparseness",
    "default_approx",
    "config_rules",
]
