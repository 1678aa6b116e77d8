"""The Gemma family and the GELU family on the CPU: the port against the JAX
package.

The same seeded numpy inputs go through the JAX function and its port:

- the GELU family (GELU exact and tanh, NewGELU, FastGELU, QuickGELU,
  BloomGELU, ClippedGELU), Tanh and GemmaRMSNorm, raw and as Dmx modules
  under the BASIC rules (FLOAT16 io casts; QuickGELU's and GemmaRMSNorm's
  vsimd surrogates, with and without inference mode); the gelu and
  quick_gelu surrogates; ``gelu_tanh_fp16`` bit for bit; the substitution
  of the new raw types;
- bench.py's baseline, weights (int8 KV) and BASIC legs (tests/torch_family.py:
  tiny, head_dim 64 and head_dim 256 configs): greedy tokens identical,
  logits within the leg's tolerance; the packed weights bit for bit; the
  BASIC plan and the fused layer step ((1 + w) norms, tanh-GELU) against
  JAX; the kernel wrappers each leg calls;
- the raw model against HF torch's ``GemmaForCausalLM`` on random weights.

The JAX legs are built with ``DMX_DECODE_FUSED=1`` and run under
``nnx.jit``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dmx_compressor_tpu as jdmx
from dmx_compressor_tpu import rawnn as jrawnn
from dmx_compressor_tpu.functional import simd_ops as jsimd
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops import basic_layer as jbl
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode
from dmx_compressor_tpu.transform.substitute import RAW_OP_MAPPING as J_RAW_OP_MAPPING

import dmx_compressor_tpu_torch as tdmx
from dmx_compressor_tpu_torch import rawnn as trawnn
from dmx_compressor_tpu_torch.functional import simd_ops as tsimd
from dmx_compressor_tpu_torch.models.gemma import GemmaConfig, GemmaForCausalLM
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops import basic_layer as tbl
from dmx_compressor_tpu_torch.transform.substitute import RAW_OP_MAPPING
from test_torch_llama import SURROGATE_TOL, _call, bits_equal
import torch_family as fam

FAMILY = "gemma"


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


# ---------------------------------------------------------------------------
# modules and surrogates
# ---------------------------------------------------------------------------

MODULES = ["GELU", "GELU_tanh", "NewGELU", "FastGELU", "QuickGELU", "BloomGELU", "ClippedGELU",
           "Tanh", "GemmaRMSNorm"]


def _module_pair(name):
    """(JAX raw module, port raw module, numpy inputs), the port's
    parameters copied from the JAX module."""
    r = fam.rng(80)
    if name == "GemmaRMSNorm":
        jm, tm = jrawnn.GemmaRMSNorm(96, eps=1e-6), trawnn.GemmaRMSNorm(96, eps=1e-6)
        w = (0.1 * r.standard_normal(96)).astype(np.float32)
        jm.weight.value = jnp.asarray(w)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(w))
        return jm, tm, [(r.standard_normal((3, 5, 96)) * 2.0).astype(np.float32)]
    x = [(r.standard_normal((4, 160)) * 4).astype(np.float32)]
    if name == "GELU_tanh":
        return jrawnn.GELU(approximate="tanh"), trawnn.GELU(approximate="tanh"), x
    if name == "ClippedGELU":
        return jrawnn.ClippedGELU(-1.5, 2.5), trawnn.ClippedGELU(-1.5, 2.5), x
    return getattr(jrawnn, name)(), getattr(trawnn, name)(), x


@pytest.mark.parametrize("mode", ["raw", "basic", "basic_inference"])
@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(name, mode):
    """Each raw module, and its Dmx module under the BASIC rules (FLOAT16 io
    casts; GELUBase and Tanh at approximation NONE, QuickGELU with its
    QUICK_GELU[vsimd] surrogate, GemmaRMSNorm with RMS_NORM[vsimd] on 1 + w;
    with and without inference mode).  The FLOAT16-bounded outputs are held
    bit for bit, the raw ones to the surrogate tolerance."""
    jm, tm, args = _module_pair(name)
    if mode != "raw":
        j_set_inference_mode(mode == "basic_inference")
        DmxModule.inference_mode = mode == "basic_inference"
        jm = J_RAW_OP_MAPPING[type(jm)](jm)
        tm = RAW_OP_MAPPING[type(tm)](tm)
        for rule in jdmx.config_rules.BASIC:
            if isinstance(jm, rule.module_types):
                jm.configure(rule.module_config)
        for rule in tdmx.config_rules.BASIC:
            if isinstance(tm, rule.module_types):
                tm.configure(rule.module_config)
        assert type(tm).__name__ == type(jm).__name__
        assert repr(tm.approximation_function) == repr(jm.approximation_function)
        assert getattr(tm, "approximate", None) == getattr(jm, "approximate", None)
    got, want = _call(tm, args, True), _call(jm, args, False)
    for g, w in zip(got, want):
        if mode == "raw":
            np.testing.assert_allclose(g, w, **SURROGATE_TOL)
        else:
            bits_equal(g, w)


@pytest.mark.parametrize("case", ["gelu", "quick_gelu", "quick_gelu_knorm", "execute_quick_gelu",
                                  "execute_gelu"])
def test_surrogate_matches_jax(case):
    x = (fam.rng(81).standard_normal((4, 128)) * 4.0).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if case == "gelu":
        got, want = tsimd.gelu(xt), jsimd.gelu(xj)
    elif case == "quick_gelu":
        got, want = tsimd.quick_gelu(xt), jsimd.quick_gelu(xj)
    elif case == "quick_gelu_knorm":
        got, want = tsimd.quick_gelu(xt, knorm=1, kmax=6), jsimd.quick_gelu(xj, knorm=1, kmax=6)
    elif case == "execute_quick_gelu":
        got = tdmx.default_approx.QUICK_GELU.execute(xt)
        want = jdmx.default_approx.QUICK_GELU.execute(xj)
    else:
        fn = "GELU[vsimd]{}()"
        got = tdmx.ApproximationFunction.from_shorthand(fn).execute(xt)
        want = jdmx.ApproximationFunction.from_shorthand(fn).execute(xj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SURROGATE_TOL)


@pytest.mark.parametrize("on_grid", [False, True])
def test_gelu_tanh_fp16_matches_jax_bit_for_bit(on_grid):
    """The fused Gemma step's GELU between its FLOAT16 casts: every output
    lies on the fp16 grid and equals JAX's bit for bit, over inputs from
    fp16 subnormals to past the FLOAT16 range."""
    r = fam.rng(82)
    x = (r.standard_normal((64, 512)) * np.exp(2 * r.standard_normal((64, 512)))).astype(
        np.float32)
    if on_grid:
        x = np.clip(x, -6e4, 6e4).astype(np.float16).astype(np.float32)
    got = tbl.gelu_tanh_fp16(torch.from_numpy(x), on_grid=on_grid).numpy()
    want = np.asarray(jbl.gelu_tanh_fp16(jnp.asarray(x), on_grid=on_grid))
    assert np.array_equal(got.astype(np.float16).astype(np.float32), got)
    bits_equal(got, want)


def test_substitution_maps_the_new_raw_types_as_jax_does():
    """The GELU family, Tanh and GemmaRMSNorm map to the Dmx modules of the
    same names on both sides, and a substituted Gemma holds them where the
    JAX one does."""
    new = ["Tanh", "GELU", "NewGELU", "FastGELU", "QuickGELU", "BloomGELU", "ClippedGELU",
           "GemmaRMSNorm"]
    tnames = {t.__name__: f.__self__.__name__ for t, f in RAW_OP_MAPPING.items()}
    jnames = {t.__name__: f.__self__.__name__ for t, f in J_RAW_OP_MAPPING.items()}
    for n in new:
        assert tnames[n] == jnames[n] == n
    tm = GemmaForCausalLM(GemmaConfig.tiny(), device="cpu")
    dm = tdmx.DmxModel.from_raw(tm)
    layer = dm.module.model.layers[0]
    assert type(layer.mlp.act_fn).__name__ == "GELU" and layer.mlp.act_fn.approximate == "tanh"
    assert type(layer.input_layernorm).__name__ == "GemmaRMSNorm"
    assert type(dm.module.model.norm).__name__ == "GemmaRMSNorm"


# ---------------------------------------------------------------------------
# the legs, end to end, and the fused step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leg,kind", [("baseline", "tiny"), ("weights", "tiny"),
                                      ("basic", "d64"), ("baseline", "wide"),
                                      ("weights", "wide"), ("sbfp", "tiny"), ("sbfp", "wide")])
def test_leg_matches_jax(leg, kind):
    fam.leg_matches_jax(FAMILY, leg, kind)


@pytest.mark.parametrize("leg", ["weights", "sbfp", "basic"])
def test_packed_weights_equal_bit_for_bit(leg):
    fam.packed_weights_equal(FAMILY, leg)


def test_basic_plan_after_compress():
    fam.plan_after_compress(FAMILY)


def test_fused_layer_step_matches_jax():
    fam.fused_step_matches_jax(FAMILY)


@pytest.mark.parametrize("leg", ["weights", "baseline", "sbfp", "basic"])
def test_leg_calls_the_kernel_wrappers(monkeypatch, leg):
    fam.leg_calls_the_kernel_wrappers(monkeypatch, FAMILY, leg)


def test_gemma_builds_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    fam.builds_on_the_card_unless_asked_for_the_cpu(monkeypatch, FAMILY)


def test_bench_config_is_bench_pys():
    """``gemma_2b()`` is bench.py's gemma-2b (google/gemma-2b)."""
    c = GemmaConfig.gemma_2b()
    assert (c.num_hidden_layers, c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
            c.head_dim, c.intermediate_size, c.vocab_size) == (18, 2048, 8, 1, 256, 16384,
                                                               256000)


# ---------------------------------------------------------------------------
# HF torch
# ---------------------------------------------------------------------------


def test_raw_model_matches_hf_torch():
    """The raw port model against transformers' GemmaForCausalLM on the same
    random weights (no download): the state dicts share their names (HF's
    tied ``lm_head.weight`` is the embedding)."""
    transformers = pytest.importorskip("transformers")
    cfg = GemmaConfig.tiny()
    hf_cfg = transformers.GemmaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta, attention_dropout=0.0,
        hidden_act="gelu_pytorch_tanh")
    torch.manual_seed(0)
    hf = transformers.GemmaForCausalLM(hf_cfg).eval()
    with torch.no_grad():  # HF starts the (1 + w) weights at zero; move them off it
        for n, p in hf.named_parameters():
            if n.endswith("norm.weight"):
                p.normal_(0.0, 0.1)
    tm = GemmaForCausalLM(cfg, device="cpu")
    state = {k: v for k, v in hf.state_dict().items() if k != "lm_head.weight"}
    tm.load_state_dict(state, strict=True)
    x = torch.from_numpy(fam.rng(50).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        want = hf(x).logits.numpy()
        got = tm(x).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)  # tests/test_gemma_qwen3.py
