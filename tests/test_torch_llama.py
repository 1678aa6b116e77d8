"""The Llama family on the CPU: the port against the JAX package, module by
module, through the shared attention routing, and end to end.

The same seeded numpy inputs go through the JAX function and its port:

- RMSNorm, SiLU, ApplyRotaryPosEmb and RotaryEmbedding, raw and as Dmx
  modules under the BASIC rules; the rms_norm, silu and RoPE surrogates;
  their FLOAT16-bounded forms of the fused step (bit for bit: their outputs
  lie on the fp16 grid); ``fused_rms_linear``; the substitution of the five
  new raw types;
- ``flash_prefill``, ``flash_chunked_prefill``, ``cached_attend`` and
  ``_split_cache_attend`` on the cases of tests/test_cached_attend.py that
  concern Llama; an int8 prefill never reaches the flash kernel;
  ``SplitKVCache.merge_tail`` raises; ``quantized_sdpa`` groups GQA heads as
  the JAX package does;
- bench.py's baseline, weights (int8 KV), SBFP and BASIC legs on
  ``LlamaConfig.tiny()`` (head_dim 16) and on tests/test_llama_basic.py's
  config (head_dim 64, GQA 2:1, where the fused BASIC step and the
  split-cache decode attention engage), the JAX weights carried over with
  ``load_jax_params``: greedy tokens identical, logits within the stated
  tolerance; and the kernel wrappers each leg calls, counted as
  chip_smoke.py counts their launches on the card;
- the raw model against HF torch's ``LlamaForCausalLM`` on random weights.

The JAX side of a leg with packed linears is built with ``DMX_DECODE_FUSED=1``
so they compute in f32 from the int8 payload, as the port does; its
prefill and decode step run under ``nnx.jit`` (the values of eager calls,
in a fraction of the time).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import dmx_compressor_tpu as jdmx
from dmx_compressor_tpu import DmxConfigRule as JDmxConfigRule
from dmx_compressor_tpu import nn as jdmxnn
from dmx_compressor_tpu import rawnn as jrawnn
from dmx_compressor_tpu.functional import simd_ops as jsimd
from dmx_compressor_tpu.functional.approximate import NoApproximation as JNoApprox
from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.llama import LlamaConfig as JLlamaConfig
from dmx_compressor_tpu.models.llama import LlamaForCausalLM as JLlama
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops import basic_layer as jbl
from dmx_compressor_tpu.ops import flash_attention as jfa
from dmx_compressor_tpu.ops import flash_decode as jfd
from dmx_compressor_tpu.ops import kv_cache as jkv
from dmx_compressor_tpu.ops.bfp_pack import PackedBFP as JPackedBFP
from dmx_compressor_tpu.ops.compress import compress_for_inference as j_compress
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode
from dmx_compressor_tpu.ops.split_decode import prepare_split_decode as j_prepare
from dmx_compressor_tpu.transform.substitute import RAW_OP_MAPPING as J_RAW_OP_MAPPING

import dmx_compressor_tpu_torch as tdmx
from dmx_compressor_tpu_torch import rawnn as trawnn
from dmx_compressor_tpu_torch.functional import simd_ops as tsimd
from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models import llama as tllama
from dmx_compressor_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, load_jax_params
from dmx_compressor_tpu_torch.models.shared import greedy_decode, greedy_prefill
from dmx_compressor_tpu_torch.nn import modules as tdmxnn
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops import basic_attention as tba
from dmx_compressor_tpu_torch.ops import basic_layer as tbl
from dmx_compressor_tpu_torch.ops import basic_linear as tbli
from dmx_compressor_tpu_torch.ops import bfp_cast as T2
from dmx_compressor_tpu_torch.ops import compress as tcompress
from dmx_compressor_tpu_torch.ops import flash_attention as tfa
from dmx_compressor_tpu_torch.ops import flash_decode as tfd
from dmx_compressor_tpu_torch.ops import kv_cache as tkv
from dmx_compressor_tpu_torch.ops.bfp_pack import bfp_pack
from dmx_compressor_tpu_torch.ops.compress import (
    SBFP12_16,
    PackedBFPLinear,
    PackedSBFPLinear,
    build_baseline_mode,
    build_basic_mode,
    build_sbfp_mode,
    build_weights_mode,
    compress_for_inference,
)
from dmx_compressor_tpu_torch.ops.split_decode import prepare_split_decode
from dmx_compressor_tpu_torch.transform.substitute import RAW_OP_MAPPING
from test_torch_opt import flat_params, jgreedy

torch.set_num_threads(2)

WL, BLOCK = 8, 64  # BFP16_64
SURROGATE_TOL = dict(rtol=1e-6, atol=1e-6)  # the same f32 formulas, sums in another order
CHAIN_TOL = dict(rtol=2e-3, atol=2e-4)  # test_basic_layer.py:217, as test_torch_basic.py
ROUTE_TOL = dict(rtol=1e-4, atol=3e-5)  # tests/test_cached_attend.py:111
# end to end, port against JAX: the f32 leg differs in summation order only
# (LOGIT_TOL of tests/test_torch_legs.py); in the int8 legs a K/V entry may
# round one int8 step apart (its scale a few ulp apart, test_torch_opt.py),
# and the prefill already attends over the dequantized cache: one such
# entry moved a prefill logit by 0.0014 here, so these legs take
# chip_smoke.py's KV8_TOL; the BASIC leg's FLOAT16 and BFP casts may land
# one fp16 step apart (LEG_TOL of tests/test_torch_basic.py)
LEG_TOL = {"baseline": 1e-3, "weights": 1e-2, "sbfp": 1e-2, "basic": 4e-3}
STEPS = 6  # greedy tokens: the prefill's, then STEPS - 1 decode steps
B = 2
# (config, prompt, cache capacity): tiny (head_dim 16; the plain versions
# take any D) and tests/test_llama_basic.py's _cfg (head_dim 64 = the BFP
# block, GQA 2:1) with a prompt and a tail of 64, so the split cache's fused
# decode attention and the base casts engage
CONFIGS = {
    "tiny": (dict(vars(LlamaConfig.tiny())), 8, 32),
    "gqa64": (dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                   num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=256),
              64, 128),
}


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    """Both packages keep inference mode as a class flag, shared by the
    tests of one worker."""
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


def rng(seed):
    return np.random.default_rng(seed)


def configs(kind):
    base, prompt, cap = CONFIGS[kind]
    base = {k: v for k, v in base.items() if k != "dtype"}
    return JLlamaConfig(**base), LlamaConfig(**base), prompt, cap


def bits_equal(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# modules and surrogates
# ---------------------------------------------------------------------------


def _module_pair(name):
    """(JAX raw module, port raw module, numpy inputs) for one of the four
    Llama op wrappers, the port's parameters copied from the JAX module."""
    r = rng(30)
    if name == "RMSNorm":
        jm, tm = jrawnn.RMSNorm(96, eps=1e-5), trawnn.RMSNorm(96, eps=1e-5)
        w = (1.0 + 0.1 * r.standard_normal(96)).astype(np.float32)
        jm.weight.value = jnp.asarray(w)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(w))
        return jm, tm, [(r.standard_normal((3, 5, 96)) * 2.0).astype(np.float32)]
    if name == "SiLU":
        return jrawnn.SiLU(), trawnn.SiLU(), [(r.standard_normal((4, 160)) * 4).astype(np.float32)]
    if name == "ApplyRotaryPosEmb":
        jrot = jrawnn.RotaryEmbedding(32, 64)
        pos = np.arange(3, 10)[None]
        cos, sin = (np.asarray(a) for a in jrot(jnp.zeros((1,), jnp.float32), jnp.asarray(pos)))
        q = (r.standard_normal((2, 4, 7, 32)) * 2).astype(np.float32)
        k = (r.standard_normal((2, 2, 7, 32)) * 2).astype(np.float32)
        return jrawnn.ApplyRotaryPosEmb(), trawnn.ApplyRotaryPosEmb(), [q, k, cos, sin]
    jm, tm = jrawnn.RotaryEmbedding(32, 64, base=500.0), trawnn.RotaryEmbedding(32, 64, base=500.0)
    with torch.no_grad():
        tm.inv_freq.copy_(torch.from_numpy(np.asarray(jm.inv_freq.value)))
    return jm, tm, [np.zeros((1,), np.float32), np.array([[0, 1, 5, 17, 63]])]


def _call(m, args, port):
    if port:
        ts = [torch.from_numpy(a) for a in args]
        with torch.no_grad():
            out = m(*ts)
        return [o.numpy() for o in out] if isinstance(out, tuple) else [out.numpy()]
    out = m(*[jnp.asarray(a) for a in args])
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else [np.asarray(out)]


MODULES = ["RMSNorm", "SiLU", "ApplyRotaryPosEmb", "RotaryEmbedding"]


@pytest.mark.parametrize("mode", ["raw", "basic", "basic_inference"])
@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax(name, mode):
    """Each wrapper raw, and its Dmx module under the BASIC rules (FLOAT16
    io casts and the vsimd surrogate; with and without inference mode, where
    the exact op's value is replaced by the surrogate's); the FLOAT16
    bounded outputs are held bit for bit, the raw ones to the surrogate
    tolerance."""
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
        assert type(tm).__name__ == type(jm).__name__ == name
    got, want = _call(tm, args, True), _call(jm, args, False)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if mode == "raw" or name == "RotaryEmbedding":  # BASIC leaves its cos / sin uncast
            np.testing.assert_allclose(g, w, **SURROGATE_TOL)
        else:
            bits_equal(g, w)


@pytest.mark.parametrize("case", ["rms_norm", "rms_norm_tiled", "silu", "silu_knorm",
                                  "apply_rotary_pos_emb", "execute_rms_norm", "execute_silu",
                                  "execute_rope"])
def test_surrogate_matches_jax(case):
    x = (rng(31).standard_normal((4, 128)) * 4.0).astype(np.float32)
    w = (1.0 + 0.1 * rng(32).standard_normal(128)).astype(np.float32)
    q = (rng(33).standard_normal((2, 4, 5, 32))).astype(np.float32)
    k = (rng(34).standard_normal((2, 2, 5, 32))).astype(np.float32)
    ang = np.arange(5)[:, None] * np.geomspace(1.0, 1e-3, 16)[None]
    cos = np.cos(np.concatenate([ang, ang], -1)).astype(np.float32)[None]
    sin = np.sin(np.concatenate([ang, ang], -1)).astype(np.float32)[None]
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if case == "rms_norm":
        got = [tsimd.rms_norm(xt, (128,), torch.from_numpy(w), eps=1e-5)]
        want = [jsimd.rms_norm(xj, (128,), jnp.asarray(w), eps=1e-5)]
    elif case == "rms_norm_tiled":
        got = [tsimd.rms_norm(xt, (128,), None, tile_size=32, norm=0.5)]
        want = [jsimd.rms_norm(xj, (128,), None, tile_size=32, norm=0.5)]
    elif case == "silu":
        got, want = [tsimd.silu(xt)], [jsimd.silu(xj)]
    elif case == "silu_knorm":
        got, want = [tsimd.silu(xt, knorm=1, kmax=6)], [jsimd.silu(xj, knorm=1, kmax=6)]
    elif case == "apply_rotary_pos_emb":
        got = tsimd.apply_rotary_pos_emb(*map(torch.from_numpy, (q, k, cos, sin)))
        want = jsimd.apply_rotary_pos_emb(*map(jnp.asarray, (q, k, cos, sin)))
    elif case == "execute_rms_norm":
        got = [tdmx.default_approx.RMS_NORM.execute(xt, (128,), torch.from_numpy(w), 1e-5)]
        want = [jdmx.default_approx.RMS_NORM.execute(xj, (128,), jnp.asarray(w), 1e-5)]
    elif case == "execute_silu":
        got, want = [tdmx.default_approx.SILU.execute(xt)], [jdmx.default_approx.SILU.execute(xj)]
    else:
        got = tdmx.default_approx.APPLY_LLAMA_ROPE.execute(*map(torch.from_numpy,
                                                               (q, k, cos, sin)))
        want = jdmx.default_approx.APPLY_LLAMA_ROPE.execute(*map(jnp.asarray, (q, k, cos, sin)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **SURROGATE_TOL)


@pytest.mark.parametrize("case", ["rms", "rms_on_grid", "silu", "silu_on_grid", "rope",
                                  "rope_on_grid"])
def test_fp16_bounded_surrogate_matches_jax_bit_for_bit(case):
    """The fused step's FLOAT16-bounded surrogates: every output lies on the
    fp16 grid, and equals the JAX package's bit for bit."""
    r = rng(35)
    x = (r.standard_normal((6, 256)) * 3.0).astype(np.float32)
    on_grid = case.endswith("on_grid")
    if on_grid:
        x = x.astype(np.float16).astype(np.float32)
    if case.startswith("rms"):
        w = (1.0 + 0.1 * r.standard_normal(256)).astype(np.float32)
        got = [tbl.rms_norm_surrogate_fp16(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                                           on_grid=on_grid)]
        want = [jbl.rms_norm_surrogate_fp16(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                            on_grid=on_grid)]
    elif case.startswith("silu"):
        x[0, :4] = [-40.0, 40.0, 0.0, -0.0]  # the exponential's flush and both signs of 0
        got = [tbl.silu_surrogate_fp16(torch.from_numpy(x), on_grid=on_grid)]
        want = [jbl.silu_surrogate_fp16(jnp.asarray(x), on_grid=on_grid)]
    else:
        q = x.reshape(2, 4, 3, 64)
        k = (r.standard_normal((2, 2, 3, 64)) * 3.0).astype(np.float32)
        if on_grid:
            k = k.astype(np.float16).astype(np.float32)
        rot = jrawnn.RotaryEmbedding(64, 256)
        cos, sin = rot(jnp.zeros((1,), jnp.float32), jnp.arange(100, 103)[None])
        got = tbl.rope_surrogate_fp16(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(np.asarray(cos)),
                                      torch.from_numpy(np.asarray(sin)), qk_on_grid=on_grid)
        want = jbl.rope_surrogate_fp16(jnp.asarray(q), jnp.asarray(k), cos, sin,
                                       qk_on_grid=on_grid)
    for g, wv in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.float16).astype(np.float32), g.numpy())
        bits_equal(g.numpy(), wv)


def _packed(seed, N, K):
    w = torch.from_numpy((rng(seed).standard_normal((N, K)) * 0.05).astype(np.float32))
    p = bfp_pack(w, WL, BLOCK)
    jp = JPackedBFP(jnp.asarray(p.mantissa.numpy()), jnp.asarray(p.exponent.numpy()), WL, BLOCK)
    return p, jp


@pytest.mark.parametrize("variant", ["plain", "resadd", "on_grid", "bias"])
def test_fused_rms_linear_matches_jax(variant):
    K, N = 128, 320
    p, jp = _packed(36, N, K)
    x = (rng(37).standard_normal((2, 3, K)) * 1.5).astype(np.float32)
    res = rng(38).standard_normal((2, 3, K)).astype(np.float32)
    w = (1.0 + 0.1 * rng(39).standard_normal(K)).astype(np.float32)
    bias = (rng(40).standard_normal(N) * 0.1).astype(np.float32) if variant == "bias" else None
    if variant == "on_grid":
        x = x.astype(np.float16).astype(np.float32)
    kw = dict(eps=1e-5, wl=WL, in_block=BLOCK, input_on_grid=variant == "on_grid")
    if variant == "resadd":
        kw.update(emit_pre=True)
    got = tbl.fused_rms_linear(
        torch.from_numpy(x), packed=p, bias=None if bias is None else torch.from_numpy(bias),
        rms_w=torch.from_numpy(w),
        residual=torch.from_numpy(res) if variant == "resadd" else None, **kw)
    want = jbl.fused_rms_linear(
        jnp.asarray(x), packed=jp, bias=None if bias is None else jnp.asarray(bias),
        rms_w=jnp.asarray(w), residual=jnp.asarray(res) if variant == "resadd" else None, **kw)
    got, want = (got, want) if variant == "resadd" else ((got,), (want,))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **CHAIN_TOL)


def test_substitution_maps_the_llama_raw_types_as_jax_does():
    """The five new raw types map to the Dmx modules of the same names on
    both sides, and a substituted Llama holds them where the JAX one does."""
    new = ["Mul", "SiLU", "ApplyRotaryPosEmb", "RotaryEmbedding", "RMSNorm"]
    tnames = {t.__name__: f.__self__.__name__ for t, f in RAW_OP_MAPPING.items()}
    jnames = {t.__name__: f.__self__.__name__ for t, f in J_RAW_OP_MAPPING.items()}
    for n in new:
        assert tnames[n] == jnames[n] == ("Mul" if n == "Mul" else n)
    jcfg, tcfg, _, _ = configs("tiny")
    jdm = JDmxModel.from_raw(JLlama(jcfg, rngs=nnx.Rngs(0)))
    tdm = DmxModel.from_raw(LlamaForCausalLM(tcfg, device="cpu"))
    jmods = {n: type(m).__name__ for n, m in jdm.named_dmx_modules()}
    tmods = {n: type(m).__name__ for n, m in tdm.named_dmx_modules()}
    assert tmods == jmods
    assert {"RMSNorm", "SiLU", "Mul", "ApplyRotaryPosEmb", "RotaryEmbedding"} <= set(tmods.values())


# ---------------------------------------------------------------------------
# the shared attention routing
# ---------------------------------------------------------------------------


def _qkv(seed, H=4, Hkv=2, T=7, D=16):
    r = rng(seed)
    return [(r.standard_normal((B, h, T, D))).astype(np.float32) for h in (H, Hkv, Hkv)]


def _sdpas():
    return jdmxnn.ScaledDotProductAttention(), tdmxnn.ScaledDotProductAttention()


def test_quantized_sdpa_groups_gqa_heads_as_jax():
    r = rng(41)
    q = r.standard_normal((B, 6, 3, 16)).astype(np.float32)
    kq, vq = (r.integers(-127, 128, (B, 2, 9, 16)).astype(np.int8) for _ in range(2))
    ks, vs = (r.uniform(0.01, 0.1, (B, 2, 9)).astype(np.float32) for _ in range(2))
    mask = np.where(np.arange(9)[None] <= np.arange(3)[:, None] + 6, 0.0, -1e4).astype(np.float32)
    got = tkv.quantized_sdpa(torch.from_numpy(q), tkv.QuantKV(*map(torch.from_numpy,
                                                                  (kq, vq, ks, vs))),
                             attn_mask=torch.from_numpy(mask), enable_gqa=True)
    want = jkv.quantized_sdpa(jnp.asarray(q), jkv.QuantKV(*map(jnp.asarray, (kq, vq, ks, vs))),
                              attn_mask=jnp.asarray(mask), enable_gqa=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE_TOL)


@pytest.mark.parametrize("cache", ["none", "float", "split", "quantized"])
def test_flash_prefill_matches_jax(cache):
    """A GQA prefill from 0: the fresh K/V repeated to the query heads, the
    cache written; a quantized cache refused on both sides."""
    q, k, v = _qkv(42)
    jsd, tsd = _sdpas()
    caches = {
        "none": (None, None),
        "float": (jkv.KVCache(B, 2, 16, 16), tkv.KVCache(B, 2, 16, 16, device="cpu")),
        "split": (jkv.SplitKVCache(B, 2, 7, 9, 16),
                  tkv.SplitKVCache(B, 2, 7, 9, 16, device="cpu")),
        "quantized": (jkv.QuantizedKVCache(B, 2, 16, 16),
                      tkv.QuantizedKVCache(B, 2, 16, 16, device="cpu")),
    }[cache]
    want = jfa.flash_prefill(jsd, *map(jnp.asarray, (q, k, v)), cache=caches[0])
    got = tfa.flash_prefill(tsd, *map(torch.from_numpy, (q, k, v)), cache=caches[1])
    if cache == "quantized":
        assert want is None and got is None and caches[1].length == 0
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE_TOL)
    if cache == "float":
        assert caches[1].length == 7
        np.testing.assert_array_equal(caches[1].k[:, :, :7].numpy(), k)
    if cache == "split":
        np.testing.assert_array_equal(caches[1].base_k.numpy(), k)


def test_flash_chunked_prefill_matches_jax():
    """Chunks of 3 and 4 after a prefix of 5 on a float cache, each chunk's
    queries over the prefix and the chunk (the kernel's diagonal at S - L);
    a quantized or split cache refused."""
    q, k, v = _qkv(43, T=12)
    jsd, tsd = _sdpas()
    jc, tc = jkv.KVCache(B, 2, 16, 16), tkv.KVCache(B, 2, 16, 16, device="cpu")
    jfa.flash_prefill(jsd, *(jnp.asarray(a[:, :, :5]) for a in (q, k, v)), cache=jc)
    tfa.flash_prefill(tsd, *(torch.from_numpy(a[:, :, :5]) for a in (q, k, v)), cache=tc)
    for lo, hi in ((5, 8), (8, 12)):
        want = jfa.flash_chunked_prefill(jsd, *(jnp.asarray(a[:, :, lo:hi]) for a in (q, k, v)),
                                         cache=jc, offset=lo)
        got = tfa.flash_chunked_prefill(tsd, *(torch.from_numpy(a[:, :, lo:hi])
                                               for a in (q, k, v)), cache=tc, offset=lo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE_TOL)
    for c in (tkv.QuantizedKVCache(B, 2, 16, 16, device="cpu"),
              tkv.SplitKVCache(B, 2, 8, 8, 16, device="cpu")):
        assert tfa.flash_chunked_prefill(tsd, *(torch.from_numpy(a[:, :, :3]) for a in (q, k, v)),
                                         cache=c, offset=0) is None


@pytest.mark.parametrize("quantized", [False, True])
def test_cached_attend_decode_matches_jax_and_takes_the_decode_kernel(monkeypatch, quantized):
    """A GQA prefill then three T == 1 steps through cached_attend: the
    port's steps take B2 (int8) or B4 (f32) (their plain versions here)
    where the JAX package on the CPU runs its einsum paths; the same
    values."""
    q, k, v = _qkv(44, T=10)
    jsd, tsd = _sdpas()
    cls = "QuantizedKVCache" if quantized else "KVCache"
    jc, tc = getattr(jkv, cls)(B, 2, 16, 16), getattr(tkv, cls)(B, 2, 16, 16, device="cpu")
    calls = []
    for name in ("flash_decode", "flash_decode_int8"):
        fn = getattr(tfd, name)
        monkeypatch.setattr(tfd, name, lambda *a, _f=fn, _n=name, **kw: (calls.append(_n),
                                                                         _f(*a, **kw))[1])
    for t0, t1 in ((0, 7), (7, 8), (8, 9), (9, 10)):
        mask = np.where(np.arange(16)[None] <= np.arange(t0, t1)[:, None], 0.0,
                        -1e4).astype(np.float32)
        want = jfd.cached_attend(jsd, *(jnp.asarray(a[:, :, t0:t1]) for a in (q, k, v)), jc,
                                 jnp.asarray(mask), enable_gqa=True)
        got = tfd.cached_attend(tsd, *(torch.from_numpy(a[:, :, t0:t1]) for a in (q, k, v)), tc,
                                torch.from_numpy(mask), enable_gqa=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE_TOL)
    assert calls == ["flash_decode_int8" if quantized else "flash_decode"] * 3


def test_split_cache_attend_matches_jax_under_basic_casts():
    """The split cache under the BASIC casts (head_dim 64, GQA 2:1): the
    modular prefill over the base, then decode steps through the fused split
    decode attention, before and after the base casts are installed."""
    j_set_inference_mode(True)
    DmxModule.inference_mode = True
    jsd, tsd = _sdpas()
    for rule in jdmx.config_rules.BASIC:
        for m in (jsd.actmatmul, jsd.resadd, jsd.softmax, jsd.mul, jsd.dropout):
            if isinstance(m, rule.module_types):
                m.configure(rule.module_config)
    for rule in tdmx.config_rules.BASIC:
        for m in (tsd.actmatmul, tsd.resadd, tsd.softmax, tsd.mul, tsd.dropout):
            if isinstance(m, rule.module_types):
                m.configure(rule.module_config)
    assert tba.basic_sdpa_shape(tsd, 64, 64) is not None
    q, k, v = (a.astype(np.float16).astype(np.float32) for a in _qkv(45, H=2, Hkv=1, T=67, D=64))
    jc = jkv.SplitKVCache(B, 1, 64, 64, 64, dtype=jnp.float16)
    tc = tkv.SplitKVCache(B, 1, 64, 64, 64, dtype=torch.float16, device="cpu")
    scale = 64**-0.5
    for t0, t1 in ((0, 64), (64, 65), (65, 66), (66, 67)):
        if t0 == 65:  # the base casts, made once between prefill and decode
            tc.set_base_cast(tba.cast_k_rows(tc.base_k, WL, BLOCK),
                             tba.cast_v_sblocks(tc.base_v, BLOCK, WL), key=(WL, BLOCK))
            from dmx_compressor_tpu.ops import basic_attention as jba

            jc.set_base_cast(jba.cast_k_rows(jc.base_k.value, WL, BLOCK),
                             jba.cast_v_sblocks(jc.base_v.value, BLOCK, WL), key=(WL, BLOCK))
        mask = np.where(np.arange(128)[None] <= np.arange(t0, t1)[:, None], 0.0,
                        -1e4).astype(np.float32)
        want = jfd._split_cache_attend(jsd, *(jnp.asarray(a[:, :, t0:t1]) for a in (q, k, v)),
                                       jc, jnp.asarray(mask), scale, False, enable_gqa=True)
        got = tfd._split_cache_attend(tsd, *(torch.from_numpy(a[:, :, t0:t1]) for a in (q, k, v)),
                                      tc, torch.from_numpy(mask), scale, False, enable_gqa=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


def test_merge_tail_raises_as_in_jax():
    with pytest.raises(NotImplementedError):
        jkv.SplitKVCache(1, 1, 64, 64, 64).merge_tail()
    with pytest.raises(NotImplementedError, match="decode beyond tail_len"):
        tkv.SplitKVCache(1, 1, 64, 64, 64, device="cpu").merge_tail()


def test_int8_prefill_does_not_reach_the_flash_kernel(monkeypatch):
    """JAX's flash_prefill refuses a quantized cache, so an int8 prefill
    attends over the dequantized cache through quantized_sdpa: the weights
    leg launches no B3 at prefill, where the f32 cache's prefill does."""
    _, tcfg, _, _ = configs("tiny")
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    ids = torch.from_numpy(rng(46).integers(0, 512, (B, 8)))
    for quantized, want in ((True, 0), (False, tcfg.num_hidden_layers)):
        tm = LlamaForCausalLM(tcfg, device="cpu")
        build_weights_mode(tm)
        calls.clear()
        greedy_prefill(tm, tm.init_cache(B, 32, quantized=quantized, device="cpu"), ids)
        assert len(calls) == want


# ---------------------------------------------------------------------------
# the legs, end to end
# ---------------------------------------------------------------------------


def _j_build(leg, jm):
    jdm = JDmxModel.from_raw(jm)
    if leg == "baseline":
        jdm.to_baseline_mode()
        return
    if leg == "sbfp":
        jdm.configure(None, JDmxConfigRule(module_types=(jdmxnn.Linear,),
                                           module_config=dict(weight_storage_format=SBFP12_16)))
    else:
        jdm.to_basic_mode()
        if leg == "weights":
            for _, m in jdm.named_dmx_modules():
                m.input_casts.set_format(["SAME"] * len(m.input_casts))
                m.output_casts.set_format(["SAME"] * len(m.output_casts))
                m.approximator.function = JNoApprox()
    j_compress(jdm)


PORT_BUILD = {"baseline": build_baseline_mode, "weights": build_weights_mode,
              "sbfp": build_sbfp_mode, "basic": build_basic_mode}


def _cache_kw(leg, prompt):
    if leg == "basic":
        return dict(split_base_len=prompt)
    return dict(quantized=leg in ("weights", "sbfp"))


def _prompt(kind):
    jcfg, _, prompt, _ = configs(kind)
    return rng(47).integers(0, jcfg.vocab_size, (B, prompt)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_leg(leg, kind):
    """The JAX side of a leg: its params, the prefill logits, every step's
    last-position logits [STEPS, B, V] and the tokens [B, STEPS]."""
    jcfg, _, prompt, cap = configs(kind)
    prev = JDmxModule.inference_mode
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = JLlama(jcfg, rngs=nnx.Rngs(7))
        params = flat_params(jm)
        _j_build(leg, jm)
    j_set_inference_mode(leg != "baseline")
    kw = _cache_kw(leg, prompt)
    if leg == "basic":
        kw["dtype"] = jnp.float16
    caches = jm.init_cache(B, cap, **kw)
    prefill = nnx.jit(lambda m, x, c: m(x, caches=c, position_offset=0))
    step = nnx.jit(lambda m, x, c, off: m(x, caches=c, position_offset=off))
    lg = prefill(jm, jnp.asarray(_prompt(kind)), caches)
    if leg == "basic":
        j_prepare(jm, caches)
    rows, toks = [lg[:, -1]], [jgreedy(lg[:, -1])]
    for i in range(STEPS - 1):
        out = step(jm, toks[-1][:, None], caches, jnp.int32(prompt + i))
        rows.append(out[:, -1])
        toks.append(jgreedy(out[:, -1]))
    JDmxModule.inference_mode = prev
    return (params, np.asarray(lg), np.stack([np.asarray(r) for r in rows]),
            np.stack([np.asarray(t) for t in toks], 1))


def _port_leg(leg, kind):
    _, tcfg, prompt, cap = configs(kind)
    tm = LlamaForCausalLM(tcfg, device="cpu")
    load_jax_params(tm, _jax_leg(leg, kind)[0])
    PORT_BUILD[leg](tm)
    kw = _cache_kw(leg, prompt)
    if leg == "basic":
        kw["dtype"] = torch.float16
    return tm, tm.init_cache(B, cap, device="cpu", **kw)


def _run_port(tm, caches, leg, kind):
    prompt = configs(kind)[2]
    logits, tok = greedy_prefill(tm, caches, torch.from_numpy(_prompt(kind)))
    if leg == "basic":
        prepare_split_decode(tm, caches)
    toks, rows = greedy_decode(tm, caches, tok, prompt, STEPS - 1)
    return (logits.numpy(), torch.cat([logits[:, -1][None], rows]).numpy(),
            torch.cat([tok[:, None], toks], 1).numpy())


@pytest.mark.parametrize("kind", list(CONFIGS))
@pytest.mark.parametrize("leg", ["baseline", "weights", "sbfp", "basic"])
def test_leg_matches_jax(leg, kind):
    """Greedy tokens identical to the JAX package's (every JAX top-1/top-2
    margin exceeds the tolerance, so none is a near-tie), prefill logits and
    every step's logits within the leg's tolerance."""
    _, jlogits, jrows, jtoks = _jax_leg(leg, kind)
    tm, caches = _port_leg(leg, kind)
    if leg == "basic":
        assert all(isinstance(c, tkv.SplitKVCache) and c.base_k.dtype == torch.float16
                   for c in caches)
    logits, rows, toks = _run_port(tm, caches, leg, kind)
    tol = LEG_TOL[leg]
    top2 = np.sort(jrows, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > tol, "a near-tie in the JAX run"
    np.testing.assert_allclose(logits, jlogits, atol=tol, rtol=0)
    np.testing.assert_allclose(rows, jrows, atol=tol, rtol=0)
    np.testing.assert_array_equal(toks, jtoks)


@pytest.mark.parametrize("leg", ["weights", "sbfp", "basic"])
def test_packed_weights_equal_bit_for_bit(leg):
    """The packed payloads of both sides are equal bit for bit: merged q/k/v
    and gate/up under BFP (the originals released), unmerged under SBFP."""
    jcfg, tcfg, _, _ = configs("gqa64")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = JLlama(jcfg, rngs=nnx.Rngs(8))
        params = flat_params(jm)
        _j_build(leg, jm)
    tm = LlamaForCausalLM(tcfg, device="cpu")
    load_jax_params(tm, params)
    PORT_BUILD[leg](tm)
    if leg == "sbfp":
        names = ["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.o_proj",
                 "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"]
        fields = ("weight_nibbles", "weight_block_scale")
        cls = PackedSBFPLinear
    else:
        names = ["self_attn.qkv_merged", "self_attn.o_proj", "mlp.gateup_merged",
                 "mlp.down_proj"]
        fields = ("weight_mantissa", "weight_exponent")
        cls = PackedBFPLinear
    pairs = [(jm.lm_head, tm.lm_head)]
    for jl, tl in zip(jm.model.layers, tm.model.layers):
        for n in names:
            a, b = n.split(".")
            pairs.append((getattr(getattr(jl, a), b), getattr(getattr(tl, a), b)))
        if leg != "sbfp":
            assert tl.self_attn.qkv_merged.out_features == 128 + 2 * 64
            assert tl.mlp.gateup_merged.out_features == 2 * 256
            assert tl.self_attn.q_proj.weight_mantissa is None
            assert tl.mlp.up_proj.weight_mantissa is None
        else:
            assert tl.self_attn.qkv_merged is None and tl.mlp.gateup_merged is None
    for jp, tp in pairs:
        assert isinstance(tp, cls)
        for f in fields:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f).get_value()))


def test_basic_plan_after_compress_and_merged_projections_bit_exact():
    """basic_llama_layer_plan is not None after compress_for_inference, on
    both sides; merging q/k/v and gate/up changes no bit of the logits
    (tests/test_llama_basic.py:104's check on the port)."""
    jcfg, tcfg, _, _ = configs("gqa64")
    DmxModule.inference_mode = True
    j_set_inference_mode(True)
    jm = JLlama(jcfg, rngs=nnx.Rngs(0))
    jdm = JDmxModel.from_raw(jm)
    jdm.to_basic_mode()
    j_compress(jdm)
    jplan = jbl.basic_llama_layer_plan(jm.model.layers[0])
    models = []
    for keep in (False, True):
        tm = LlamaForCausalLM(tcfg, device="cpu", seed=1)
        dm = DmxModel.from_raw(tm)
        dm.to_basic_mode()
        compress_for_inference(dm, keep_originals=keep)
        models.append(tm)
    plan = tbl.basic_llama_layer_plan(models[0].model.layers[0])
    assert plan is not None and jplan is not None
    assert plan == tbl.BasicLlamaPlan(*jplan)
    assert tbl.basic_rms_head_plan(models[0].model.norm, models[0].lm_head) is not None
    for layer in models[1].model.layers:
        layer.self_attn.qkv_merged = None
        layer.mlp.gateup_merged = None
    assert tbl.basic_llama_layer_plan(models[1].model.layers[0]) is None
    ids = torch.from_numpy(rng(48).integers(0, 256, (2, 16)))
    with torch.no_grad():
        np.testing.assert_array_equal(models[0](ids).numpy(), models[1](ids).numpy())


def test_fused_layer_step_matches_jax():
    """One BASIC decoder layer's decode step on identical prefilled split
    caches, the base casts installed: the port's fused step against the
    JAX package's."""
    jcfg, tcfg, prompt, cap = configs("gqa64")
    params = _jax_leg("basic", "gqa64")[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = JLlama(jcfg, rngs=nnx.Rngs(7))
        _j_build("basic", jm)
    j_set_inference_mode(True)
    tm, tc = _port_leg("basic", "gqa64")
    ids = _prompt("gqa64")
    jc = jm.init_cache(B, cap, dtype=jnp.float16, split_base_len=prompt)
    nnx.jit(lambda m, x, c: m(x, caches=c, position_offset=0))(jm, jnp.asarray(ids), jc)
    j_prepare(jm, jc)
    with torch.no_grad():
        tm(torch.from_numpy(ids), caches=tc, position_offset=0)
    prepare_split_decode(tm, tc)
    x = rng(49).standard_normal((B, 1, jcfg.hidden_size)).astype(np.float32)
    mask = np.where(np.arange(cap) <= prompt, 0.0, -1e4).astype(np.float32)[None]
    jlayer, tlayer = jm.model.layers[0], tm.model.layers[0]
    assert jbl.basic_llama_layer_plan(jlayer) is not None
    assert tbl.basic_llama_layer_plan(tlayer) is not None
    pos = np.array([[prompt]])
    jcos, jsin = jm.model.rotary_emb(jnp.asarray(x), jnp.asarray(pos))
    want = nnx.jit(lambda lay, x_, c, s, m_, ca: lay(x_, c, s, attn_mask=m_, cache=ca))(
        jlayer, jnp.asarray(x), jcos, jsin, jnp.asarray(mask), jc[0])
    with torch.no_grad():
        tcos, tsin = tm.model.rotary_emb(torch.from_numpy(x), torch.from_numpy(pos))
        got = tlayer(torch.from_numpy(x), tcos, tsin, attn_mask=torch.from_numpy(mask),
                     cache=tc[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)
    np.testing.assert_array_equal(tc[0].tail_k[:, :, 0].numpy(),
                                  np.asarray(jc[0].tail_k.get_value()[:, :, 0]))


# ---------------------------------------------------------------------------
# which wrappers each leg calls, and how often
# ---------------------------------------------------------------------------


def _spy(monkeypatch, counts):
    def spy(mod, attr, key):
        fn = getattr(mod, attr)

        def wrapped(*a, **kw):
            counts[key] = counts.get(key, 0) + 1
            if kw.get("fp16_first"):
                counts["composed"] = counts.get("composed", 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)

    spy(tcompress, "bfp_linear", "b1")
    spy(tcompress, "bfp_linear_bf16", "t1")
    spy(tbli, "bfp_linear_bf16", "t1")
    spy(tcompress, "sbfp_linear", "b5")
    spy(T2, "bfp_cast", "t2")
    spy(T2, "fp16_cast", "t2")
    spy(tfa, "flash_attention", "b3")
    spy(tfd, "flash_decode", "b4")
    spy(tfd, "flash_decode_int8", "b2")
    spy(tllama, "fused_llama_family_step", "fused_step")


@pytest.mark.parametrize("leg", ["weights", "baseline", "sbfp", "basic"])
def test_leg_calls_the_kernel_wrappers(monkeypatch, leg):
    """The counts chip_smoke.py asserts on the card, on the gqa64 config (L
    layers): weights 4L+1 B1 and no B3 at prefill, 4L+1 B1 + L B2 a step;
    baseline L B3 / L B4; SBFP 7L+1 B5 (q/k/v and gate/up unmerged) and no
    B3 / 7L+1 B5 + L B2; BASIC 4L+1 T1 + 40L+5 T2 at prefill (the modular
    pipeline: 40 casts a layer, the embedding's, the final norm's 2 and the
    head's 2), where each linear takes one T2 fewer here (36L+4): this
    prefill's 128 rows are within the fused linear's 256, chip_smoke.py's
    1024 are not; 2L T2 in prepare_split_decode; 4L+1 T1 + 21L+2 T2 a step
    (24L+3 casts: 3L+1 launches are a FLOAT16 cast and the BFP cast of its
    output in one), every layer through the fused step."""
    tm, caches = _port_leg(leg, "gqa64")
    L = tm.cfg.num_hidden_layers
    prompt = configs("gqa64")[2]
    counts = {}
    _spy(monkeypatch, counts)
    _, tok = greedy_prefill(tm, caches, torch.from_numpy(_prompt("gqa64")))
    prefill = dict(counts)
    counts.clear()
    if leg == "basic":
        prepare_split_decode(tm, caches)
    prepare = dict(counts)
    counts.clear()
    greedy_decode(tm, caches, tok, prompt, 2)
    want = {
        "weights": ({"b1": 4 * L + 1}, {}, {"b1": 4 * L + 1, "b2": L}),
        "baseline": ({"b3": L}, {}, {"b4": L}),
        "sbfp": ({"b5": 7 * L + 1}, {}, {"b5": 7 * L + 1, "b2": L}),
        "basic": ({"t1": 4 * L + 1, "t2": 40 * L + 5 - (4 * L + 1)}, {"t2": 2 * L},
                  {"t1": 4 * L + 1, "t2": 21 * L + 2, "composed": 3 * L + 1, "fused_step": L}),
    }[leg]
    assert prefill == want[0]
    assert prepare == want[1]
    assert counts == {k: 2 * v for k, v in want[2].items()}
    if leg == "basic":
        assert all(c.base_cast_key == (WL, BLOCK) for c in caches)
        casts = counts["t2"] + counts["composed"]
        assert casts == 2 * (24 * L + 3)


def test_llama_builds_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaForCausalLM(LlamaConfig.tiny())
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 16)
    caches = m.init_cache(1, 16, quantized=True, device="cpu")
    assert caches[0].k_q.shape == (1, 2, 16, 16)  # the KV heads, not the query heads


# ---------------------------------------------------------------------------
# HF torch
# ---------------------------------------------------------------------------


def test_raw_model_matches_hf_torch():
    """The raw port model against transformers' LlamaForCausalLM on the same
    random weights (no download): the state dicts share their names."""
    transformers = pytest.importorskip("transformers")
    cfg = LlamaConfig.tiny()
    hf_cfg = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings, rms_norm_eps=cfg.rms_norm_eps,
        rope_theta=cfg.rope_theta, attention_bias=False, mlp_bias=False, attention_dropout=0.0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(hf.state_dict(), strict=True)
    x = torch.from_numpy(rng(50).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        want = hf(x).logits.numpy()
        got = tm(x).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-4)  # test_hf_torch_parity.py
