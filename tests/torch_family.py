"""What tests/test_torch_qwen3.py, test_torch_gemma.py,
test_torch_mistral.py and test_torch_gpt2.py share: the families of the
port held against the JAX package on the CPU (the JAX package is the
reference), end to end and through the fused BASIC step, as
tests/test_torch_llama.py holds Llama.

Each function takes the family ("qwen3", "gemma", "mistral"; the legs also
"gpt2"); the test files call them with their own.  Configs:

- "tiny": the family's ``tiny()`` (2 layers, head_dim 32 decoupled from
  hidden / heads), prompt 8 in 32 slots: the weights and baseline legs;
- "d64": head_dim 64 = the BFP block, GQA 2:1 (tests/test_gemma_qwen3_basic.py's
  config), prompt 64 and a tail of 64, so that the split cache's fused
  decode attention and the fused layer step engage: the BASIC leg;
- "wide": narrow width and 1 layer at the head_dim of the bench config
  (Qwen3 128, Gemma 256), prompt 16 in 32 slots: the weights and baseline
  legs, so that the plain versions of B2 (int8 decode), B3 (prefill) and
  B4 (f32 decode) and the routing around them run at that head_dim.

Mistral has no ``head_dim`` field (hidden / heads): its "tiny" is
``MistralConfig.tiny()`` (sliding window 16) with a prompt of 20 in 32
slots, and its "d64" tests/test_mistral_basic.py's config (128 wide, 2
heads of 64 over 1 KV head, window 16); the band is active in both.
GPT-2's "tiny" is ``GPT2Config.tiny()`` (head_dim 16) and its "d64"
tests/test_gpt2_basic.py's (128 wide, 2 heads of 64).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.models.gemma import GemmaConfig as JGemmaConfig
from dmx_compressor_tpu.models.gemma import GemmaForCausalLM as JGemma
from dmx_compressor_tpu.models.gpt2 import GPT2Config as JGPT2Config
from dmx_compressor_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from dmx_compressor_tpu.models.mistral import MistralConfig as JMistralConfig
from dmx_compressor_tpu.models.mistral import MistralForCausalLM as JMistral
from dmx_compressor_tpu.models.qwen3 import Qwen3Config as JQwen3Config
from dmx_compressor_tpu.models.qwen3 import Qwen3ForCausalLM as JQwen3
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops import basic_layer as jbl
from dmx_compressor_tpu.ops.compress import compress_for_inference as j_compress
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode
from dmx_compressor_tpu.ops.split_decode import prepare_split_decode as j_prepare

from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models import gpt2 as tgpt2
from dmx_compressor_tpu_torch.models.gemma import GemmaConfig, GemmaForCausalLM
from dmx_compressor_tpu_torch.models.llama import head_dim_of
from dmx_compressor_tpu_torch.models.mistral import MistralConfig, MistralForCausalLM
from dmx_compressor_tpu_torch.models.qwen3 import Qwen3Config, Qwen3ForCausalLM
from dmx_compressor_tpu_torch.models.shared import greedy_decode, greedy_prefill, load_jax_params
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops import basic_layer as tbl
from dmx_compressor_tpu_torch.ops import kv_cache as tkv
from dmx_compressor_tpu_torch.ops.compress import (
    PackedBFPLinear,
    PackedSBFPLinear,
    compress_for_inference,
)
from dmx_compressor_tpu_torch.ops.split_decode import prepare_split_decode
from test_torch_llama import CHAIN_TOL, LEG_TOL, PORT_BUILD, _cache_kw, _j_build, _spy
from test_torch_opt import flat_params, jgreedy

STEPS = 6  # greedy tokens: the prefill's, then STEPS - 1 decode steps
B = 2

# family -> (JAX config, JAX model, port config, port model, the plan
# function's name, the bench config's head_dim)
FAMILIES = {
    "qwen3": (JQwen3Config, JQwen3, Qwen3Config, Qwen3ForCausalLM, "basic_qwen3_layer_plan", 128),
    "gemma": (JGemmaConfig, JGemma, GemmaConfig, GemmaForCausalLM, "basic_gemma_layer_plan", 256),
    "mistral": (JMistralConfig, JMistral, MistralConfig, MistralForCausalLM,
                "basic_llama_layer_plan", 64),
    "gpt2": (JGPT2Config, JGPT2, tgpt2.GPT2Config, tgpt2.GPT2LMHeadModel,
             "basic_gpt2_block_plan", 64),
}
# the loader of a raw JAX model's weights into the port model, by family
LOADERS = {"gpt2": tgpt2.load_jax_params}


# the prompts' seed (47) by (family, leg) where another is taken: the JAX
# package's own Mistral run under SBFP12_16 has near-ties at prompt seed 47
# (top-1/top-2 margins 0.0082 at "tiny", 0.0032 at "d64", below the int8
# legs' 1e-2, where a token may follow either logit), while the port stays
# within 3.1e-6 of it with the same tokens; prompt seed 42 clears the guard
# at "tiny" (margin 0.055), so the tokens are held there
PROMPT_SEEDS = {("mistral", "sbfp"): 42}


def rng(seed):
    return np.random.default_rng(seed)


def _fields(family, kind):
    """(config fields, prompt, cache capacity) of a config kind."""
    tc, wide_d = FAMILIES[family][2], FAMILIES[family][5]
    if kind == "tiny":
        base = {k: v for k, v in vars(tc.tiny()).items() if k != "dtype"}
        return base, 20 if family == "mistral" else 8, 32
    if family == "gpt2":  # d64
        return dict(vocab_size=256, n_embd=128, n_layer=2, n_head=2, n_positions=256), 64, 128
    if family == "mistral":  # d64
        return dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                    num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=256,
                    sliding_window=16), 64, 128
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_attention_heads=2,
                num_key_value_heads=1, max_position_embeddings=256)
    if family == "qwen3":
        base["tie_word_embeddings"] = True
    if kind == "d64":
        return dict(base, num_hidden_layers=2, head_dim=64), 64, 128
    return dict(base, num_hidden_layers=1, head_dim=wide_d), 16, 32


def configs(family, kind):
    jc, _, tc, *_ = FAMILIES[family]
    fields, prompt, cap = _fields(family, kind)
    return jc(**fields), tc(**fields), prompt, cap


def prompt_ids(family, kind, leg=None):
    jcfg, _, prompt, _ = configs(family, kind)
    seed = PROMPT_SEEDS.get((family, leg), 47)
    return rng(seed).integers(0, jcfg.vocab_size, (B, prompt)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def jax_leg(family, leg, kind):
    """The JAX side of a leg (its model built with DMX_DECODE_FUSED=1, run
    under nnx.jit): its params, the prefill logits, every step's
    last-position logits [STEPS, B, V] and the tokens [B, STEPS]."""
    jcfg, _, prompt, cap = configs(family, kind)
    prev = JDmxModule.inference_mode
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = FAMILIES[family][1](jcfg, rngs=nnx.Rngs(7))
        params = flat_params(jm)
        _j_build(leg, jm)
    j_set_inference_mode(leg != "baseline")
    kw = _cache_kw(leg, prompt)
    if leg == "basic":
        kw["dtype"] = jnp.float16
    caches = jm.init_cache(B, cap, **kw)
    prefill = nnx.jit(lambda m, x, c: m(x, caches=c, position_offset=0))
    step = nnx.jit(lambda m, x, c, off: m(x, caches=c, position_offset=off))
    lg = prefill(jm, jnp.asarray(prompt_ids(family, kind, leg)), caches)
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


def port_leg(family, leg, kind):
    """The port's model of the leg on the CPU, the JAX leg's weights
    loaded, built as the leg builds it, and its caches."""
    _, tcfg, prompt, cap = configs(family, kind)
    tm = FAMILIES[family][3](tcfg, device="cpu")
    LOADERS.get(family, load_jax_params)(tm, jax_leg(family, leg, kind)[0])
    PORT_BUILD[leg](tm)
    kw = _cache_kw(leg, prompt)
    if leg == "basic":
        kw["dtype"] = torch.float16
    return tm, tm.init_cache(B, cap, device="cpu", **kw)


def leg_matches_jax(family, leg, kind):
    """Greedy tokens identical to the JAX package's (every JAX top-1/top-2
    margin exceeds the tolerance, so none is a near-tie), prefill logits and
    every step's logits within the leg's tolerance (LEG_TOL of
    tests/test_torch_llama.py: f32 1e-3, int8 KV 1e-2 (weights and SBFP),
    BASIC 4e-3)."""
    _, jlogits, jrows, jtoks = jax_leg(family, leg, kind)
    tm, caches = port_leg(family, leg, kind)
    prompt = configs(family, kind)[2]
    if leg == "basic":
        assert all(isinstance(c, tkv.SplitKVCache) and c.base_k.dtype == torch.float16
                   for c in caches)
    logits, tok = greedy_prefill(tm, caches, torch.from_numpy(prompt_ids(family, kind, leg)))
    if leg == "basic":
        prepare_split_decode(tm, caches)
    toks, rows = greedy_decode(tm, caches, tok, prompt, STEPS - 1)
    rows = torch.cat([logits[:, -1][None], rows]).numpy()
    toks = torch.cat([tok[:, None], toks], 1).numpy()
    tol = LEG_TOL[leg]
    top2 = np.sort(jrows, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > tol, "a near-tie in the JAX run"
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=tol, rtol=0)
    np.testing.assert_allclose(rows, jrows, atol=tol, rtol=0)
    np.testing.assert_array_equal(toks, jtoks)


def packed_weights_equal(family, leg):
    """The packed payloads of both sides are equal bit for bit at the d64
    config.  BFP: merged q/k/v (at the decoupled head_dim) and gate/up,
    o_proj, down_proj and the tied head, the merged originals released.
    SBFP: every projection unmerged (q, k, v, o_proj, gate, up, down_proj;
    GPT-2's c_attn, born merged, attn.c_proj, c_fc, mlp.c_proj) and the
    head, nibbles and scales."""
    jcfg, tcfg, _, _ = configs(family, "d64")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = FAMILIES[family][1](jcfg, rngs=nnx.Rngs(8))
        params = flat_params(jm)
        _j_build(leg, jm)
    tm = FAMILIES[family][3](tcfg, device="cpu")
    LOADERS.get(family, load_jax_params)(tm, params)
    PORT_BUILD[leg](tm)
    pairs = [(jm.lm_head, tm.lm_head)]
    if family == "gpt2":
        layers = zip(jm.transformer.h, tm.transformer.h)
        names = ["attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj"]
    else:
        layers = zip(jm.model.layers, tm.model.layers)
        names = (["self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                  "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj"]
                 if leg == "sbfp" else
                 ["self_attn.qkv_merged", "self_attn.o_proj", "mlp.gateup_merged",
                  "mlp.down_proj"])
    for jl, tl in layers:
        if family != "gpt2" and leg == "sbfp":
            assert tl.self_attn.qkv_merged is None and tl.mlp.gateup_merged is None
        elif family != "gpt2":
            H, Hkv, D = tcfg.num_attention_heads, tcfg.num_key_value_heads, head_dim_of(tcfg)
            assert tl.self_attn.qkv_merged.out_features == (H + 2 * Hkv) * D
            assert tl.mlp.gateup_merged.out_features == 2 * tcfg.intermediate_size
            assert tl.self_attn.q_proj.weight_mantissa is None
            assert tl.mlp.up_proj.weight_mantissa is None
        for n in names:
            a, b = n.split(".")
            pairs.append((getattr(getattr(jl, a), b), getattr(getattr(tl, a), b)))
    cls, fields = ((PackedSBFPLinear, ("weight_nibbles", "weight_block_scale")) if leg == "sbfp"
                   else (PackedBFPLinear, ("weight_mantissa", "weight_exponent")))
    for jp, tp in pairs:
        assert isinstance(tp, cls)
        for f in fields:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f).get_value()))


def plan_after_compress(family):
    """The family's plan holds after compress_for_inference on both sides
    and equals JAX's field for field (the family deltas included); the
    other family's plan refuses the layer; the head's plan holds in its
    (1 + w) form for Gemma only."""
    jcfg, tcfg, _, _ = configs(family, "d64")
    DmxModule.inference_mode = True
    j_set_inference_mode(True)
    jm = FAMILIES[family][1](jcfg, rngs=nnx.Rngs(0))
    jdm = JDmxModel.from_raw(jm)
    jdm.to_basic_mode()
    j_compress(jdm)
    tm = FAMILIES[family][3](tcfg, device="cpu", seed=1)
    dm = DmxModel.from_raw(tm)
    dm.to_basic_mode()
    compress_for_inference(dm)
    name = FAMILIES[family][4]
    jplan = getattr(jbl, name)(jm.model.layers[0])
    plan = getattr(tbl, name)(tm.model.layers[0])
    assert plan is not None and jplan is not None
    assert plan == tbl.BasicLlamaPlan(*jplan)
    assert plan.gemma_norm == (family == "gemma")
    assert plan.act == ("gelu_tanh" if family == "gemma" else "silu")
    assert (plan.qk_norm_eps is not None) == (family == "qwen3")
    other = "basic_gemma_layer_plan" if family == "qwen3" else "basic_qwen3_layer_plan"
    assert getattr(tbl, other)(tm.model.layers[0]) is None
    # Llama's plan takes what JAX's takes (a Qwen3 layer, not a Gemma one)
    assert (tbl.basic_llama_layer_plan(tm.model.layers[0]) is None) == (
        jbl.basic_llama_layer_plan(jm.model.layers[0]) is None) == (family == "gemma")
    gemma = family == "gemma"
    assert tbl.basic_rms_head_plan(tm.model.norm, tm.lm_head, gemma_norm=gemma) is not None
    assert tbl.basic_rms_head_plan(tm.model.norm, tm.lm_head, gemma_norm=not gemma) is None


def fused_step_matches_jax(family):
    """One BASIC decoder layer's decode step on identical prefilled split
    caches, the base casts installed: the port's fused step against the
    JAX package's, and the tail K row they write.  Both models hold the
    weights of ``nnx.Rngs(7)`` (the port's loaded from the JAX leg's)."""
    jcfg, _, prompt, cap = configs(family, "d64")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = FAMILIES[family][1](jcfg, rngs=nnx.Rngs(7))
        _j_build("basic", jm)
    j_set_inference_mode(True)
    tm, tc = port_leg(family, "basic", "d64")
    ids = prompt_ids(family, "d64")
    jc = jm.init_cache(B, cap, dtype=jnp.float16, split_base_len=prompt)
    nnx.jit(lambda m, x, c: m(x, caches=c, position_offset=0))(jm, jnp.asarray(ids), jc)
    j_prepare(jm, jc)
    with torch.no_grad():
        tm(torch.from_numpy(ids), caches=tc, position_offset=0)
    prepare_split_decode(tm, tc)
    x = rng(49).standard_normal((B, 1, jcfg.hidden_size)).astype(np.float32)
    mask = np.where(np.arange(cap) <= prompt, 0.0, -1e4).astype(np.float32)[None]
    jlayer, tlayer = jm.model.layers[0], tm.model.layers[0]
    name = FAMILIES[family][4]
    assert getattr(jbl, name)(jlayer) is not None
    assert getattr(tbl, name)(tlayer) is not None
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


def leg_calls_the_kernel_wrappers(monkeypatch, family, leg):
    """The counts chip_smoke.py asserts on the card, at the d64 config (L
    layers; the prefill's 128 rows are within the fused linear's 256, so
    each linear takes one T2 fewer than at chip_smoke.py's 1024): weights
    4L+1 B1 and no B3 / 4L+1 B1 + L B2; baseline L B3 / L B4; BASIC 4L+1
    T1 + (40 + q) L + 5 - (4L+1) T2 at prefill, 2L in prepare_split_decode,
    4L+1 T1 + (21 + q') L + 2 T2 a step (3L+1 of them composed), every layer
    through the fused step; Qwen3's q / k norms add q = 4 casts a layer at
    prefill and q' = 2 a step, Gemma's GELU takes SiLU's.  A banded Mistral
    launches no attention kernel: its weights leg 4L+1 B1 at prefill and a
    step, its SBFP leg 7L+1 B5, its baseline nothing, its BASIC leg Llama's
    counts."""
    tm, caches = port_leg(family, leg, "d64")
    L = tm.cfg.num_hidden_layers
    prompt = configs(family, "d64")[2]
    counts = {}
    _spy(monkeypatch, counts)
    _, tok = greedy_prefill(tm, caches, torch.from_numpy(prompt_ids(family, "d64", leg)))
    prefill = dict(counts)
    counts.clear()
    if leg == "basic":
        prepare_split_decode(tm, caches)
    prepare = dict(counts)
    counts.clear()
    greedy_decode(tm, caches, tok, prompt, 2)
    q, q1 = (4, 2) if family == "qwen3" else (0, 0)
    want = {
        "weights": ({"b1": 4 * L + 1}, {}, {"b1": 4 * L + 1, "b2": L}),
        "baseline": ({"b3": L}, {}, {"b4": L}),
        "sbfp": ({"b5": 7 * L + 1}, {}, {"b5": 7 * L + 1, "b2": L}),
        # a banded model: quantized_sdpa or the masked sdpa, no kernel
        "banded_weights": ({"b1": 4 * L + 1}, {}, {"b1": 4 * L + 1}),
        "banded_sbfp": ({"b5": 7 * L + 1}, {}, {"b5": 7 * L + 1}),
        "banded_baseline": ({}, {}, {}),
        "basic": ({"t1": 4 * L + 1, "t2": (40 + q) * L + 5 - (4 * L + 1)}, {"t2": 2 * L},
                  {"t1": 4 * L + 1, "t2": (21 + q1) * L + 2, "composed": 3 * L + 1,
                   "fused_step": L}),
    }[f"banded_{leg}" if family == "mistral" and leg != "basic" else leg]
    assert prefill == want[0]
    assert prepare == want[1]
    assert counts == {k: 2 * v for k, v in want[2].items()}


def builds_on_the_card_unless_asked_for_the_cpu(monkeypatch, family):
    _, _, tc, tmodel, _, _ = FAMILIES[family]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel(tc.tiny())
    m = tmodel(tc.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 16)
    caches = m.init_cache(1, 16, quantized=True, device="cpu")
    # the KV heads at the decoupled head_dim
    assert caches[0].k_q.shape == (1, tc.tiny().num_key_value_heads, 16, head_dim_of(tc.tiny()))
