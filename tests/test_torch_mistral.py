"""The Mistral family on the CPU: the port against the JAX package.

The same seeded numpy inputs go through the JAX function and its port:

- bench.py's baseline, weights (int8 KV) and BASIC legs
  (tests/torch_family.py: ``MistralConfig.tiny()`` and
  tests/test_mistral_basic.py's config, the sliding window of 16 active in
  both): greedy tokens identical, logits within the leg's tolerance; the
  packed weights bit for bit; the BASIC plan, and the fused layer step with
  the banded mask and without a window, against JAX; the kernel wrappers
  each leg calls (a banded model calls no attention kernel);
- the band: a banded prefill against the unbanded one, and the split-cache
  prefill of a transparent sdpa, which ignores the band in both packages;
- ``load_jax_params`` over every parameter, the configs (``from_hf``,
  bench.py's ``mistral-1b``), and the raw model against HF torch's
  ``MistralForCausalLM`` on random weights.

The JAX legs are built with ``DMX_DECODE_FUSED=1`` and run under
``nnx.jit``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.models import positions as jpos
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.ops import basic_layer as jbl
from dmx_compressor_tpu.ops.compress import set_inference_mode as j_set_inference_mode
from dmx_compressor_tpu.ops.split_decode import prepare_split_decode as j_prepare

from dmx_compressor_tpu_torch.models import positions as tpos
from dmx_compressor_tpu_torch.models.mistral import MistralConfig, MistralForCausalLM
from dmx_compressor_tpu_torch.models.shared import load_jax_params
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops import basic_layer as tbl
from dmx_compressor_tpu_torch.ops.compress import build_baseline_mode
from dmx_compressor_tpu_torch.ops.split_decode import prepare_split_decode
from test_torch_llama import CHAIN_TOL, _j_build
from test_torch_opt import flat_params
import torch_family as fam

FAMILY = "mistral"


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


# ---------------------------------------------------------------------------
# the legs, end to end, and the fused step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leg,kind", [("baseline", "tiny"), ("weights", "tiny"),
                                      ("basic", "d64"), ("baseline", "d64"),
                                      ("weights", "d64"), ("sbfp", "tiny")])
def test_leg_matches_jax(leg, kind):
    fam.leg_matches_jax(FAMILY, leg, kind)


@pytest.mark.parametrize("leg", ["weights", "sbfp", "basic"])
def test_packed_weights_equal_bit_for_bit(leg):
    fam.packed_weights_equal(FAMILY, leg)


def test_basic_plan_after_compress():
    fam.plan_after_compress(FAMILY)


@pytest.mark.parametrize("window", [16, None])
def test_fused_layer_step_matches_jax(window):
    """One BASIC decoder layer's first decode step on identical prefilled
    split caches, under the model's own mask: banded by 16 (the step sees
    the base's last 15 keys and its own) or plain causal, the port's fused
    step against JAX's, and the tail K row they write."""
    jcfg, tcfg, prompt, cap = fam.configs(FAMILY, "d64")
    jcfg.sliding_window = tcfg.sliding_window = window
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DMX_DECODE_FUSED", "1")
        jm = fam.FAMILIES[FAMILY][1](jcfg, rngs=nnx.Rngs(7))
        params = flat_params(jm)
        _j_build("basic", jm)
    j_set_inference_mode(True)
    tm = MistralForCausalLM(tcfg, device="cpu")
    load_jax_params(tm, params)
    fam.PORT_BUILD["basic"](tm)
    ids = fam.prompt_ids(FAMILY, "d64")
    jc = jm.init_cache(fam.B, cap, dtype=jnp.float16, split_base_len=prompt)
    tc = tm.init_cache(fam.B, cap, dtype=torch.float16, split_base_len=prompt, device="cpu")
    nnx.jit(lambda m, x, c: m(x, caches=c, position_offset=0))(jm, jnp.asarray(ids), jc)
    j_prepare(jm, jc)
    with torch.no_grad():
        tm(torch.from_numpy(ids), caches=tc, position_offset=0)
    prepare_split_decode(tm, tc)
    jlayer, tlayer = jm.model.layers[0], tm.model.layers[0]
    assert jbl.basic_llama_layer_plan(jlayer) is not None
    assert tbl.basic_llama_layer_plan(tlayer) is not None
    pos = prompt
    x = fam.rng(49).standard_normal((fam.B, 1, jcfg.hidden_size)).astype(np.float32)
    mask = np.asarray(jpos.causal_mask(1, cap, pos, jnp.float32, sliding_window=window))
    np.testing.assert_array_equal(
        tpos.causal_mask(1, cap, pos, torch.float32, sliding_window=window).numpy(), mask)
    if window is not None:
        assert (mask[0, :pos - window + 1] < 0).all() and (mask[0, pos - window + 1:pos + 1] == 0).all()
    jcos, jsin = jm.model.rotary_emb(jnp.asarray(x), jnp.asarray([[pos]]))
    want = nnx.jit(lambda lay, x_, c, s, m_, ca: lay(x_, c, s, attn_mask=m_, cache=ca,
                                                      plain_causal=window is None))(
        jlayer, jnp.asarray(x), jcos, jsin, jnp.asarray(mask), jc[0])
    with torch.no_grad():
        tcos, tsin = tm.model.rotary_emb(torch.from_numpy(x), torch.tensor([[pos]]))
        got = tlayer(torch.from_numpy(x), tcos, tsin, attn_mask=torch.from_numpy(mask),
                     cache=tc[0], plain_causal=window is None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)
    np.testing.assert_array_equal(tc[0].tail_k[:, :, 0].numpy(),
                                  np.asarray(jc[0].tail_k.get_value()[:, :, 0]))


@pytest.mark.parametrize("leg", ["weights", "baseline", "sbfp", "basic"])
def test_leg_calls_the_kernel_wrappers(monkeypatch, leg):
    fam.leg_calls_the_kernel_wrappers(monkeypatch, FAMILY, leg)


def test_mistral_builds_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    fam.builds_on_the_card_unless_asked_for_the_cpu(monkeypatch, FAMILY)


# ---------------------------------------------------------------------------
# the band
# ---------------------------------------------------------------------------


def _raw_pair(window, seed=3):
    jcfg, tcfg, _, _ = fam.configs(FAMILY, "tiny")
    jcfg.sliding_window = tcfg.sliding_window = window
    jm = fam.FAMILIES[FAMILY][1](jcfg, rngs=nnx.Rngs(seed))
    tm = MistralForCausalLM(tcfg, device="cpu")
    load_jax_params(tm, flat_params(jm))
    return jm, tm


def test_band_masks_the_prefill_and_the_decode():
    """A raw prefill of 24 tokens and 6 cached decode steps with a window of
    5, against the JAX model; against the same weights without a window,
    the logits agree where the band cuts nothing (the first 5 positions)
    and differ after it."""
    jm, tm = _raw_pair(5)
    ids = fam.rng(50).integers(0, 512, (2, 30)).astype(np.int32)
    assert not tm.model._plain_causal()
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32, device="cpu")
    want = [np.asarray(jm(jnp.asarray(ids[:, :24]), caches=jc, position_offset=0))]
    with torch.no_grad():
        got = [tm(torch.from_numpy(ids[:, :24]), caches=tc, position_offset=0).numpy()]
        for s in range(24, 30):
            want.append(np.asarray(jm(jnp.asarray(ids[:, s:s + 1]), caches=jc,
                                      position_offset=s)))
            got.append(tm(torch.from_numpy(ids[:, s:s + 1]), caches=tc,
                          position_offset=s).numpy())
        tm.model.cfg = dataclasses.replace(tm.cfg, sliding_window=None)
        assert tm.model._plain_causal()
        plain = tm(torch.from_numpy(ids[:, :24])).numpy()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(plain[:, :5], got[0][:, :5], atol=1e-5, rtol=1e-5)
    assert np.abs(plain[:, 5:] - got[0][:, 5:]).min(axis=-1).max() > 1e-3


def test_split_cache_prefill_of_a_transparent_sdpa_ignores_the_band_in_both():
    """A JAX quirk that the port mirrors: over a split cache, a transparent
    sdpa's T > 1 prefill runs ``flash_attention(causal=True)`` whatever the
    mask (JAX ops/flash_decode.py ``_split_cache_attend``), so a banded
    model's prefill there attends as if unbanded.  Both packages give the
    same logits, equal to the unbanded model's and away from the banded
    one's."""
    jm, tm = _raw_pair(5, seed=4)
    _j_build("baseline", jm)
    build_baseline_mode(tm)
    ids = fam.rng(51).integers(0, 512, (2, 12)).astype(np.int32)
    jc = jm.init_cache(2, 16, split_base_len=12)
    tc = tm.init_cache(2, 16, split_base_len=12, device="cpu")
    want = np.asarray(jm(jnp.asarray(ids), caches=jc, position_offset=0))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), caches=tc, position_offset=0).numpy()
        banded = tm(torch.from_numpy(ids)).numpy()
        tm.model.cfg = dataclasses.replace(tm.cfg, sliding_window=None)
        unbanded = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, unbanded, atol=1e-4, rtol=1e-4)
    assert np.abs(got[:, 5:] - banded[:, 5:]).max() > 1e-3


# ---------------------------------------------------------------------------
# weights, configs, HF torch
# ---------------------------------------------------------------------------


def test_load_jax_params_covers_every_parameter():
    """Every array of a raw JAX Mistral lands in the port model (the rotary
    table's ``inv_freq`` in its buffer), and every port parameter is
    covered; a missing or an unknown array raises."""
    jm, tm = _raw_pair(16)
    params = flat_params(jm)
    own = {**dict(tm.named_parameters()), **dict(tm.named_buffers())}
    for path, arr in params.items():
        *mod, leaf = path.split(".")
        name = path if leaf == "inv_freq" else ".".join(mod + ["weight"])
        want = arr.T if leaf == "kernel" else arr
        np.testing.assert_array_equal(own[name].detach().numpy(), want)
    assert len(params) == len(dict(tm.named_parameters())) + 1  # + inv_freq
    with pytest.raises(KeyError, match="parameters not in params"):
        load_jax_params(tm, {k: v for k, v in params.items() if "down_proj" not in k})
    with pytest.raises(KeyError, match="unknown leaf"):
        load_jax_params(tm, {**params, "model.norm.scale": params["model.norm.weight"]})


def test_configs_match_jax_and_bench():
    """``from_hf`` reads a config.json as the JAX package does (the defaults
    Mistral-7B's), and ``mistral_1b()`` is bench.py's ``mistral-1b``."""
    import bench
    from dmx_compressor_tpu.models.mistral import MistralConfig as JMistralConfig

    def fields(c):
        return {k: v for k, v in vars(c).items() if k != "dtype"}

    j = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
             num_attention_heads=32, num_key_value_heads=8, sliding_window=4096)
    assert fields(MistralConfig.from_hf(j)) == fields(JMistralConfig.from_hf(j))
    assert fields(MistralConfig()) == fields(JMistralConfig())
    assert fields(MistralConfig.mistral_1b()) == fields(bench.model_config("mistral-1b"))
    c = MistralConfig.mistral_1b()
    assert (c.num_hidden_layers, c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
            c.sliding_window) == (16, 2048, 32, 8, 128)


def test_raw_model_matches_hf_torch():
    """The raw port model against transformers' MistralForCausalLM on the
    same random weights (no download), 32 tokens past the window of 16, so
    the band matters (tests/test_hf_torch_parity.py:131)."""
    transformers = pytest.importorskip("transformers")
    cfg = MistralConfig.tiny()
    hf_cfg = transformers.MistralConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_key_value_heads,
        max_position_embeddings=cfg.max_position_embeddings, sliding_window=cfg.sliding_window,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta, attention_dropout=0.0,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    hf = transformers.MistralForCausalLM(hf_cfg).eval()
    tm = MistralForCausalLM(cfg, device="cpu")
    tm.load_state_dict(hf.state_dict(), strict=True)
    x = torch.from_numpy(fam.rng(50).integers(0, cfg.vocab_size, (2, 32)))
    with torch.no_grad():
        want = hf(x).logits.numpy()
        got = tm(x).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-4)  # test_hf_torch_parity.py
