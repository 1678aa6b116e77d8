"""GPT-2 on the CPU: the port against the JAX package.

The same seeded numpy inputs go through the JAX function and its port:

- the raw model without a cache, and ``load_jax_params`` over every
  parameter (LayerNorm scales and biases, Linear biases, ``wpe``, the tied
  ``wte``);
- bench.py's baseline, weights (int8 KV) and BASIC legs
  (tests/torch_family.py: ``GPT2Config.tiny()`` and
  tests/test_gpt2_basic.py's config, 128 wide, 2 heads of 64, where the
  fused BASIC block and the split cache's fused decode attention engage):
  greedy tokens identical, logits within the leg's tolerance; the packed
  weights bit for bit; ``basic_gpt2_block_plan`` and its None cases; the
  fused block step against JAX's; the kernel wrappers each leg calls;
- the configs (``from_hf``, bench.py's ``gpt2``), and the raw model against
  HF torch's ``GPT2LMHeadModel`` on random weights through
  ``hf_tensor_converter``.

The JAX legs are built with ``DMX_DECODE_FUSED=1`` and run under
``nnx.jit``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.modeling.model import DmxModel as JDmxModel
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops import basic_layer as jbl
from dmx_compressor_tpu.ops.compress import compress_for_inference as j_compress
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode
from dmx_compressor_tpu.ops.split_decode import prepare_split_decode as j_prepare

from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models import gpt2 as tgpt2
from dmx_compressor_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel, load_jax_params
from dmx_compressor_tpu_torch.models.shared import greedy_decode, greedy_prefill
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops import basic_layer as tbl
from dmx_compressor_tpu_torch.ops.compress import (
    PackedBFPLinear,
    PackedSBFPLinear,
    compress_for_inference,
)
from dmx_compressor_tpu_torch.ops.split_decode import prepare_split_decode
from test_torch_llama import CHAIN_TOL, _j_build, _spy
from test_torch_opt import flat_params
import torch_family as fam

FAMILY = "gpt2"
WL, BLOCK = 8, 64  # BFP16_64


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


def _raw_pair(kind="tiny", seed=3):
    jcfg, tcfg, _, _ = fam.configs(FAMILY, kind)
    jm = fam.FAMILIES[FAMILY][1](jcfg, rngs=nnx.Rngs(seed))
    tm = GPT2LMHeadModel(tcfg, device="cpu")
    load_jax_params(tm, flat_params(jm))
    return jm, tm


# ---------------------------------------------------------------------------
# the raw model and its weights
# ---------------------------------------------------------------------------


def test_raw_model_matches_jax():
    """No cache (the causal mask over T), and a prefill then 3 cached steps
    into a float cache."""
    jm, tm = _raw_pair()
    ids = fam.rng(50).integers(0, 512, (2, 12)).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(ids)))
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    wants = [np.asarray(jm(jnp.asarray(ids[:, :9]), caches=jc, position_offset=0))]
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
        gots = [tm(torch.from_numpy(ids[:, :9]), caches=tc, position_offset=0).numpy()]
        for s in range(9, 12):
            wants.append(np.asarray(jm(jnp.asarray(ids[:, s:s + 1]), caches=jc,
                                       position_offset=s)))
            gots.append(tm(torch.from_numpy(ids[:, s:s + 1]), caches=tc,
                           position_offset=s).numpy())
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for g, w in zip(gots, wants):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_load_jax_params_covers_every_parameter():
    """Every array of a raw JAX GPT-2 lands in the port model (kernels
    transposed, LayerNorm scales as weights, ``wpe``, the tied ``wte``), and
    every port parameter is covered; a missing or an unknown array raises."""
    jm, tm = _raw_pair()
    params = flat_params(jm)
    own = dict(tm.named_parameters())
    for path, arr in params.items():
        *mod, leaf = path.split(".")
        if mod == ["lm_head", "embed_ref"]:
            mod = ["transformer", "wte"]
        name = ".".join(mod + ["bias" if leaf == "bias" else "weight"])
        want = arr.T if leaf == "kernel" else arr
        np.testing.assert_array_equal(own[name].detach().numpy(), want)
    # nnx lists the tied table once, under the head
    assert {".".join(p.split(".")[:-1]) for p in params} >= {
        "transformer.wpe", "lm_head.embed_ref", "transformer.ln_f", "transformer.h.0.ln_1"}
    assert tm.lm_head.embed_ref.weight is own["transformer.wte.weight"]
    with pytest.raises(KeyError, match="parameters not in params"):
        load_jax_params(tm, {k: v for k, v in params.items() if k != "transformer.wpe.embedding"})
    with pytest.raises(KeyError, match="unknown leaf"):
        load_jax_params(tm, {**params, "transformer.ln_f.mean": params["transformer.ln_f.bias"]})


# ---------------------------------------------------------------------------
# the legs, end to end, and the fused block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leg,kind", [("baseline", "tiny"), ("weights", "tiny"),
                                      ("basic", "d64"), ("baseline", "d64"),
                                      ("weights", "d64"), ("sbfp", "tiny")])
def test_leg_matches_jax(leg, kind):
    fam.leg_matches_jax(FAMILY, leg, kind)


def _built_pair(leg, seed=8):
    jcfg, tcfg, _, _ = fam.configs(FAMILY, "d64")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = fam.FAMILIES[FAMILY][1](jcfg, rngs=nnx.Rngs(seed))
        params = flat_params(jm)
        _j_build(leg, jm)
    tm = GPT2LMHeadModel(tcfg, device="cpu")
    load_jax_params(tm, params)
    fam.PORT_BUILD[leg](tm)
    return jm, tm


@pytest.mark.parametrize("leg", ["weights", "sbfp", "basic"])
def test_packed_weights_equal_bit_for_bit(leg):
    """The packed payloads of both sides are equal bit for bit: c_attn (born
    merged), attn.c_proj, c_fc, mlp.c_proj and the tied head (N 256 here,
    50257 at bench.py's gpt2), BFP mantissas and exponents or SBFP nibbles
    and scales, and the biases."""
    jm, tm = _built_pair(leg)
    pairs = [(jm.lm_head, tm.lm_head)]
    for jb, tb in zip(jm.transformer.h, tm.transformer.h):
        pairs += [(jb.attn.c_attn, tb.attn.c_attn), (jb.attn.c_proj, tb.attn.c_proj),
                  (jb.mlp.c_fc, tb.mlp.c_fc), (jb.mlp.c_proj, tb.mlp.c_proj)]
        assert tb.attn.c_attn.out_features == 3 * 128
    cls, fields = ((PackedSBFPLinear, ("weight_nibbles", "weight_block_scale")) if leg == "sbfp"
                   else (PackedBFPLinear, ("weight_mantissa", "weight_exponent")))
    for jp, tp in pairs:
        assert isinstance(tp, cls)
        for f in fields:
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f).get_value()))
        if tp.bias is not None:
            np.testing.assert_array_equal(tp.bias.numpy(), np.asarray(jp.bias.get_value()))


def _basic_pair():
    """Both models in BASIC mode after compress_for_inference, inference
    mode on (tests/test_gpt2_basic.py's _basic_model)."""
    DmxModule.inference_mode = True
    j_set_inference_mode(True)
    jcfg, tcfg, _, _ = fam.configs(FAMILY, "d64")
    jm = fam.FAMILIES[FAMILY][1](jcfg, rngs=nnx.Rngs(0))
    jdm = JDmxModel.from_raw(jm)
    jdm.to_basic_mode()
    j_compress(jdm)
    tm = GPT2LMHeadModel(tcfg, device="cpu", seed=1)
    dm = DmxModel.from_raw(tm)
    dm.to_basic_mode()
    compress_for_inference(dm)
    return jm, tm


def _plans(jm, tm):
    j = jbl.basic_gpt2_block_plan(jm.transformer.h[0])
    t = tbl.basic_gpt2_block_plan(tm.transformer.h[0])
    return j, t


def test_basic_block_plan_after_compress():
    """basic_gpt2_block_plan holds after compress_for_inference on both
    sides and equals JAX's field for field; basic_head_plan holds for the
    tied head."""
    jm, tm = _basic_pair()
    jplan, plan = _plans(jm, tm)
    assert plan is not None and jplan is not None
    assert plan == tbl.BasicLayerPlan(*jplan)
    assert (plan.wl, plan.block) == (WL, BLOCK)
    assert tbl.basic_head_plan(tm.transformer.ln_f, tm.lm_head) is not None
    assert jbl.basic_head_plan(jm.transformer.ln_f, jm.lm_head) is not None


@pytest.mark.parametrize("case", ["inference_off", "exact_gelu", "relu_act", "other_format",
                                  "no_ln_bias", "weights_mode", "not_a_block"])
def test_basic_block_plan_is_none_where_jax_s_is(case):
    """The plan refuses what JAX's refuses: inference mode off, the exact
    (erf) GELU or another activation, one linear with another input format,
    a LayerNorm without bias, weights mode's SAME casts, an OPT layer."""
    from dmx_compressor_tpu import nn as jdmxnn
    from dmx_compressor_tpu_torch.nn import modules as tdmxnn

    jm, tm = _basic_pair()
    jb, tb = jm.transformer.h[0], tm.transformer.h[0]
    if case == "inference_off":
        DmxModule.inference_mode = False
        j_set_inference_mode(False)
    elif case == "exact_gelu":
        jb.mlp.act.approximate = tb.mlp.act.approximate = "none"
    elif case == "relu_act":
        jb.mlp.act, tb.mlp.act = jdmxnn.ReLU(), tdmxnn.ReLU()
    elif case == "other_format":
        for b in (jb, tb):
            b.mlp.c_fc.input_casts["input_cast"].set_format("BFP[8|8]{16}(SN)")
    elif case == "no_ln_bias":
        jb.ln_2.bias = None
        tb.ln_2.bias = None
    elif case == "weights_mode":
        jm, tm = _built_pair("weights")
        DmxModule.inference_mode = True
        j_set_inference_mode(True)
    elif case == "not_a_block":
        from dmx_compressor_tpu.models.opt import OPTConfig as JOPTConfig
        from dmx_compressor_tpu.models.opt import OPTForCausalLM as JOPT
        from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM

        jo = JOPT(JOPTConfig.tiny(), rngs=nnx.Rngs(0))
        jdm = JDmxModel.from_raw(jo)
        jdm.to_basic_mode()
        j_compress(jdm)
        to = OPTForCausalLM(OPTConfig.tiny(), device="cpu")
        dm = DmxModel.from_raw(to)
        dm.to_basic_mode()
        compress_for_inference(dm)
        assert jbl.basic_gpt2_block_plan(jo.model.decoder.layers[0]) is None
        assert tbl.basic_gpt2_block_plan(to.model.decoder.layers[0]) is None
        return
    jplan, plan = _plans(jm, tm)
    assert jplan is None and plan is None


def test_fused_block_step_matches_jax():
    """One BASIC block's decode step on identical prefilled split caches,
    the base casts installed (tests/test_gpt2_basic.py's config: 128 wide, 2
    heads of 64): the port's fused step against JAX's, and the tail K row
    they write."""
    jcfg, _, prompt, cap = fam.configs(FAMILY, "d64")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = fam.FAMILIES[FAMILY][1](jcfg, rngs=nnx.Rngs(7))
        _j_build("basic", jm)
    j_set_inference_mode(True)
    tm, tc = fam.port_leg(FAMILY, "basic", "d64")
    ids = fam.prompt_ids(FAMILY, "d64")
    jc = jm.init_cache(fam.B, cap, dtype=jnp.float16, split_base_len=prompt)
    nnx.jit(lambda m, x, c: m(x, caches=c, position_offset=0))(jm, jnp.asarray(ids), jc)
    j_prepare(jm, jc)
    with torch.no_grad():
        tm(torch.from_numpy(ids), caches=tc, position_offset=0)
    prepare_split_decode(tm, tc)
    x = fam.rng(49).standard_normal((fam.B, 1, jcfg.n_embd)).astype(np.float32)
    mask = np.where(np.arange(cap) <= prompt, 0.0, -1e4).astype(np.float32)[None]
    jblock, tblock = jm.transformer.h[0], tm.transformer.h[0]
    assert jbl.basic_gpt2_block_plan(jblock) is not None
    assert tbl.basic_gpt2_block_plan(tblock) is not None
    want = nnx.jit(lambda b, x_, m_, ca: b(x_, attn_mask=m_, cache=ca))(
        jblock, jnp.asarray(x), jnp.asarray(mask), jc[0])
    with torch.no_grad():
        got = tblock(torch.from_numpy(x), attn_mask=torch.from_numpy(mask), cache=tc[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)
    np.testing.assert_array_equal(tc[0].tail_k[:, :, 0].numpy(),
                                  np.asarray(jc[0].tail_k.get_value()[:, :, 0]))


@pytest.mark.parametrize("leg", ["weights", "baseline", "sbfp", "basic"])
def test_leg_calls_the_kernel_wrappers(monkeypatch, leg):
    """The counts chip_smoke.py asserts on the card, at the d64 config (L
    blocks; the prefill's 128 rows are within the fused linear's 256, so
    each linear takes one T2 fewer than at chip_smoke.py's 1024): weights
    4L+1 B1 and no B3 (an int8 prefill attends through quantized_sdpa) /
    4L+1 B1 + L B2; baseline L B3 / L B4; SBFP 4L+1 B5 (c_attn born merged)
    and no B3 / 4L+1 B5 + L B2; BASIC 4L+1 T1 + 34L+6 - (4L+1) T2
    at prefill (OPT's casts, GELU's pair for ReLU's, two embeddings), 2L in
    prepare_split_decode, 4L+1 T1 + 17L+3 T2 a step (3L+1 of them
    composed: OPT's 16L+3 and the GELU's output cast), every block through
    the fused step."""
    tm, caches = fam.port_leg(FAMILY, leg, "d64")
    L = tm.cfg.n_layer
    prompt = fam.configs(FAMILY, "d64")[2]
    counts = {}
    _spy(monkeypatch, counts)
    step = tgpt2.GPT2Block._fused_basic_step

    def fused(*a, **kw):
        counts["fused_step"] = counts.get("fused_step", 0) + 1
        return step(*a, **kw)

    monkeypatch.setattr(tgpt2.GPT2Block, "_fused_basic_step", fused)
    _, tok = greedy_prefill(tm, caches, torch.from_numpy(fam.prompt_ids(FAMILY, "d64")))
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
        "sbfp": ({"b5": 4 * L + 1}, {}, {"b5": 4 * L + 1, "b2": L}),
        "basic": ({"t1": 4 * L + 1, "t2": 34 * L + 6 - (4 * L + 1)}, {"t2": 2 * L},
                  {"t1": 4 * L + 1, "t2": 17 * L + 3, "composed": 3 * L + 1,
                   "fused_step": L}),
    }[leg]
    assert prefill == want[0]
    assert prepare == want[1]
    assert counts == {k: 2 * v for k, v in want[2].items()}


def test_gpt2_builds_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT2LMHeadModel(GPT2Config.tiny())
    m = GPT2LMHeadModel(GPT2Config.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.init_cache(1, 16)
    caches = m.init_cache(1, 16, quantized=True, device="cpu")
    assert caches[0].k_q.shape == (1, 4, 16, 16)


# ---------------------------------------------------------------------------
# configs, HF torch
# ---------------------------------------------------------------------------


def test_configs_match_jax_and_bench():
    """``from_hf`` reads a config.json as the JAX package does, and
    ``gpt2()`` is bench.py's ``gpt2`` (GPT-2 124M)."""
    import bench
    from dmx_compressor_tpu.models.gpt2 import GPT2Config as JGPT2Config

    def fields(c):
        return {k: v for k, v in vars(c).items() if k != "dtype"}

    j = dict(vocab_size=50257, n_embd=1024, n_layer=24, n_head=16, n_positions=1024,
             layer_norm_epsilon=1e-5)
    assert fields(GPT2Config.from_hf(j)) == fields(JGPT2Config.from_hf(j))
    assert fields(GPT2Config.tiny()) == fields(JGPT2Config.tiny())
    assert fields(GPT2Config.gpt2()) == fields(bench.model_config("gpt2"))
    c = GPT2Config.gpt2()
    assert (c.n_layer, c.n_embd, c.n_head, c.vocab_size) == (12, 768, 12, 50257)


def test_raw_model_matches_hf_torch():
    """The raw port model against transformers' GPT2LMHeadModel on the same
    random weights (no download), loaded through ``hf_tensor_converter``
    (Conv1D [in, out] transposed; HF's tied ``lm_head.weight`` is ``wte``),
    as tests/test_hf_torch_parity.py:71 does for JAX."""
    transformers = pytest.importorskip("transformers")
    cfg = GPT2Config.tiny()
    hf_cfg = transformers.GPT2Config(
        vocab_size=cfg.vocab_size, n_embd=cfg.n_embd, n_layer=cfg.n_layer, n_head=cfg.n_head,
        n_positions=cfg.n_positions, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        activation_function="gelu_new")
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    tm = GPT2LMHeadModel(cfg, device="cpu")
    state = GPT2LMHeadModel.hf_tensor_converter(
        {k: v for k, v in hf.state_dict().items() if k != "lm_head.weight"})
    tm.load_state_dict(state, strict=True)
    x = torch.from_numpy(fam.rng(50).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        want = hf(x).logits.numpy()
        got = tm(x).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-4)  # test_hf_torch_parity.py
