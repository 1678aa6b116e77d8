"""The Qwen3 family on the CPU: the port against the JAX package.

The same seeded numpy inputs go through the JAX function and its port:

- ``causal_mask`` with its sliding-window band (shared and per-row
  offsets), and a banded Qwen3 (no flash routing) prefilled and decoded;
- the plain versions of B3 (``flash_attention``), B4 (``flash_decode``) and
  B2 (``flash_decode_int8``) at head_dim 128 and 256 (the port's wrappers
  on CPU tensors) against the JAX package's ``flash_attention_ref``,
  ``flash_decode_ref`` and ``flash_decode_int8_ref``, and ``flash_prefill``
  with its GQA repeat at those dims;
- bench.py's baseline, weights (int8 KV) and BASIC legs (tests/torch_family.py:
  tiny, head_dim 64 and head_dim 128 configs): greedy tokens identical,
  logits within the leg's tolerance; the packed weights bit for bit; the
  BASIC plan and the fused layer step (the per-head q / k RMS surrogates
  between RoPE's casts) against JAX; the kernel wrappers each leg calls;
- the raw model against HF torch's ``Qwen3ForCausalLM`` on random weights.

The JAX legs are built with ``DMX_DECODE_FUSED=1`` and run under
``nnx.jit``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.models import positions as jpos
from dmx_compressor_tpu.ops import flash_attention as jfa
from dmx_compressor_tpu.ops import flash_decode as jfd
from dmx_compressor_tpu.ops import kv_cache as jkv

from dmx_compressor_tpu_torch.models import positions as tpos
from dmx_compressor_tpu_torch.models.qwen3 import Qwen3Config, Qwen3ForCausalLM
from dmx_compressor_tpu_torch.models.shared import load_jax_params
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops import flash_attention as tfa
from dmx_compressor_tpu_torch.ops import flash_decode as tfd
from dmx_compressor_tpu_torch.ops import kv_cache as tkv
from test_torch_llama import ROUTE_TOL, _sdpas
from test_torch_opt import flat_params
import torch_family as fam

FAMILY = "qwen3"


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule

    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


# ---------------------------------------------------------------------------
# the sliding-window band
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 1, 3, 100])
@pytest.mark.parametrize("offset", [0, 5, "rows"])
def test_causal_mask_band_matches_jax(window, offset):
    T, S = 4, 12
    off = np.array([0, 3, 8], np.int32) if offset == "rows" else offset
    want = np.asarray(jpos.causal_mask(T, S, jnp.asarray(off) if offset == "rows" else off,
                                       jnp.float32, sliding_window=window))
    got = tpos.causal_mask(T, S, torch.from_numpy(off) if offset == "rows" else off,
                           torch.float32, sliding_window=window).numpy()
    np.testing.assert_array_equal(got, want)


def test_banded_model_matches_jax():
    """Qwen3 tiny with a sliding window of 5: a raw prefill of 9 tokens, then
    4 cached decode steps past the window, against the JAX model.  The band
    keeps the flash routing away (``plain_causal`` is False)."""
    jcfg, tcfg, _, _ = fam.configs(FAMILY, "tiny")
    jcfg.sliding_window = tcfg.sliding_window = 5
    jm = fam.FAMILIES[FAMILY][1](jcfg, rngs=nnx.Rngs(3))
    tm = Qwen3ForCausalLM(tcfg, device="cpu")
    load_jax_params(tm, flat_params(jm))
    assert not tm.model._plain_causal()
    ids = fam.rng(50).integers(0, jcfg.vocab_size, (2, 13)).astype(np.int32)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16, device="cpu")
    want = [np.asarray(jm(jnp.asarray(ids[:, :9]), caches=jc, position_offset=0))]
    with torch.no_grad():
        got = [tm(torch.from_numpy(ids[:, :9]), caches=tc, position_offset=0).numpy()]
        for s in range(9, 13):
            want.append(np.asarray(jm(jnp.asarray(ids[:, s:s + 1]), caches=jc,
                                      position_offset=s)))
            got.append(tm(torch.from_numpy(ids[:, s:s + 1]), caches=tc,
                          position_offset=s).numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the kernels' plain versions at head_dim 128 and 256
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [128, 256])
def test_attention_plain_versions_match_jax_at_head_dim(D):
    """B3's plain version (causal at L < S, and with a bias), B4's and B2's
    over ragged lengths with GQA, each against the JAX package's reference
    at this head_dim (tests/test_cached_attend.py's tolerance: the same f32
    formulas summed in another order)."""
    r = fam.rng(60 + D)
    q = r.standard_normal((2, 4, 5, D)).astype(np.float32)
    k, v = (r.standard_normal((2, 4, 9, D)).astype(np.float32) for _ in range(2))
    bias = r.standard_normal((2, 4, 5, 9)).astype(np.float32)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    want = jfa.flash_attention_ref(*map(jnp.asarray, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE_TOL)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v, bias)))
    want = jfa.flash_attention_ref(*map(jnp.asarray, (q, k, v)), bias=jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE_TOL)
    q1 = r.standard_normal((3, 4, 1, D)).astype(np.float32)
    kc, vc = (r.standard_normal((3, 2, 20, D)).astype(np.float32) for _ in range(2))
    le = np.array([20, 1, 13], np.int32)
    got = tfd.flash_decode(*map(torch.from_numpy, (q1, kc, vc, le)))
    want = jfd.flash_decode_ref(*map(jnp.asarray, (q1, kc, vc, le)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE_TOL)
    kq, vq = (r.integers(-127, 128, (3, 2, 20, D)).astype(np.int8) for _ in range(2))
    ks, vs = (r.uniform(0.01, 0.1, (3, 2, 20)).astype(np.float32) for _ in range(2))
    got = tfd.flash_decode_int8(torch.from_numpy(q1),
                                tkv.QuantKV(*map(torch.from_numpy, (kq, vq, ks, vs))),
                                torch.from_numpy(le))
    want = jfd.flash_decode_int8_ref(jnp.asarray(q1),
                                     jkv.QuantKV(*map(jnp.asarray, (kq, vq, ks, vs))),
                                     jnp.asarray(le))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE_TOL)


@pytest.mark.parametrize("D", [128, 256])
def test_flash_prefill_matches_jax_at_head_dim(D):
    """A GQA prefill from 0 (8 query heads over one KV head, Gemma's
    grouping) into a float cache, at this head_dim."""
    r = fam.rng(70 + D)
    q = r.standard_normal((2, 8, 7, D)).astype(np.float32)
    k, v = (r.standard_normal((2, 1, 7, D)).astype(np.float32) for _ in range(2))
    jsd, tsd = _sdpas()
    jc, tc = jkv.KVCache(2, 1, 16, D), tkv.KVCache(2, 1, 16, D, device="cpu")
    want = jfa.flash_prefill(jsd, *map(jnp.asarray, (q, k, v)), cache=jc)
    got = tfa.flash_prefill(tsd, *map(torch.from_numpy, (q, k, v)), cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROUTE_TOL)
    np.testing.assert_array_equal(tc.k[:, :, :7].numpy(), k)


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


def test_qwen3_builds_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    fam.builds_on_the_card_unless_asked_for_the_cpu(monkeypatch, FAMILY)


def test_bench_config_is_bench_pys():
    """``qwen3_0_6b()`` is bench.py's qwen3-0.6b (Qwen/Qwen3-0.6B)."""
    c = Qwen3Config.qwen3_0_6b()
    assert (c.num_hidden_layers, c.hidden_size, c.num_attention_heads, c.num_key_value_heads,
            c.head_dim, c.intermediate_size, c.vocab_size, c.tie_word_embeddings,
            c.rope_theta, c.sliding_window) == (28, 1024, 16, 8, 128, 3072, 151936, True,
                                                 1e6, None)


# ---------------------------------------------------------------------------
# HF torch
# ---------------------------------------------------------------------------


def test_raw_model_matches_hf_torch():
    """The raw port model against transformers' Qwen3ForCausalLM on the same
    random weights (no download): the state dicts share their names (HF's
    tied ``lm_head.weight`` is the embedding)."""
    transformers = pytest.importorskip("transformers")
    cfg = Qwen3Config.tiny()
    hf_cfg = transformers.Qwen3Config(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.num_key_value_heads,
        head_dim=cfg.head_dim, max_position_embeddings=cfg.max_position_embeddings,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta, attention_dropout=0.0,
        attention_bias=False, tie_word_embeddings=True, use_sliding_window=False)
    torch.manual_seed(0)
    hf = transformers.Qwen3ForCausalLM(hf_cfg).eval()
    tm = Qwen3ForCausalLM(cfg, device="cpu")
    state = {k: v for k, v in hf.state_dict().items() if k != "lm_head.weight"}
    tm.load_state_dict(state, strict=True)
    x = torch.from_numpy(fam.rng(50).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        want = hf(x).logits.numpy()
        got = tm(x).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)  # tests/test_gemma_qwen3.py
