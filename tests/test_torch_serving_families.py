"""The port's continuous-batching engine over every family but OPT, against
the JAX package's engine, on the CPU.

The configurations and prompts are tests/test_serving.py's
(``_family_engine_check``: three prompts of 5, 9 and 3 tokens through two
slots, buckets 4 / 8 / 16, 48 positions): Llama with grouped-query attention
(per-row RoPE), Mistral with a sliding window of 6 (per-row banded masks),
GPT-2 (per-row learned positions) and the int8 row cache over Llama; then
Qwen3 (its q / k norms, tied head) and Gemma (one KV head of 64, decoupled
from hidden / heads).  Each JAX model of seed 0 carries its weights into the
port, both engines take the same submissions and are stepped in lockstep
(tests/test_torch_serving.py's ``lockstep``: every step's results and
counters equal), at bursts of 1 and 3; the port's tokens also equal its own
isolated generation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.models.gemma import GemmaConfig as JGemmaConfig
from dmx_compressor_tpu.models.gemma import GemmaForCausalLM as JGemma
from dmx_compressor_tpu.models.gpt2 import GPT2Config as JGPT2Config
from dmx_compressor_tpu.models.gpt2 import GPT2LMHeadModel as JGPT2
from dmx_compressor_tpu.models.llama import LlamaConfig as JLlamaConfig
from dmx_compressor_tpu.models.llama import LlamaForCausalLM as JLlama
from dmx_compressor_tpu.models.mistral import MistralConfig as JMistralConfig
from dmx_compressor_tpu.models.mistral import MistralForCausalLM as JMistral
from dmx_compressor_tpu.models.qwen3 import Qwen3Config as JQwen3Config
from dmx_compressor_tpu.models.qwen3 import Qwen3ForCausalLM as JQwen3

from dmx_compressor_tpu_torch.models import gpt2 as tgpt2
from dmx_compressor_tpu_torch.models.gemma import GemmaConfig, GemmaForCausalLM
from dmx_compressor_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from dmx_compressor_tpu_torch.models.mistral import MistralConfig, MistralForCausalLM
from dmx_compressor_tpu_torch.models.qwen3 import Qwen3Config, Qwen3ForCausalLM
from dmx_compressor_tpu_torch.models.shared import load_jax_params
from dmx_compressor_tpu_torch.ops import kv_cache as tkv
from test_torch_opt import flat_params
from test_torch_serving import check_isolated, lockstep, prompts

torch.set_num_threads(2)

LLAMA = dict(vocab_size=97, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64)
# family -> (JAX config, JAX model, port config, port model, config fields,
# the port's loader of the JAX weights)
FAMILIES = {
    "llama": (JLlamaConfig, JLlama, LlamaConfig, LlamaForCausalLM, LLAMA, load_jax_params),
    "mistral": (JMistralConfig, JMistral, MistralConfig, MistralForCausalLM,
                dict(LLAMA, sliding_window=6), load_jax_params),
    "gpt2": (JGPT2Config, JGPT2, tgpt2.GPT2Config, tgpt2.GPT2LMHeadModel,
             dict(vocab_size=97, n_embd=64, n_layer=2, n_head=4, n_positions=64),
             tgpt2.load_jax_params),
    "qwen3": (JQwen3Config, JQwen3, Qwen3Config, Qwen3ForCausalLM,
              dict(LLAMA, head_dim=16, tie_word_embeddings=True), load_jax_params),
    "gemma": (JGemmaConfig, JGemma, GemmaConfig, GemmaForCausalLM,
              dict(LLAMA, num_key_value_heads=1, head_dim=64), load_jax_params),
}
KW = dict(max_slots=2, max_len=48, prompt_buckets=(4, 8, 16))


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, port model) per family, the port's weights the JAX
    model's (seed 0)."""
    out = {}
    for family, (jc, jm_cls, tc, tm_cls, fields, load) in FAMILIES.items():
        jm = jm_cls(jc(**fields), rngs=nnx.Rngs(0))
        tm = tm_cls(tc(**fields), device="cpu")
        load(tm, flat_params(jm))
        out[family] = (jm, tm)
    return out


@pytest.mark.parametrize("burst", [1, 3])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_in_lockstep_with_jax(pairs, family, burst):
    ps = prompts(5, 9, 3)
    te, res, _ = lockstep(pairs[family], [dict(prompt_ids=p, max_new_tokens=4) for p in ps],
                          burst=burst, **KW)
    assert sorted(res) == [0, 1, 2]
    check_isolated(pairs[family][1], res, range(3), ps, [4, 4, 4])


@pytest.mark.parametrize("burst", [1, 3])
def test_int8_row_cache_over_llama_in_lockstep_with_jax(pairs, burst):
    """The quantized row cache over Llama's two KV heads: the engine's
    int8 payloads and scales, tokens equal to the JAX engine's step for
    step and to isolated generation over an int8 cache."""
    ps = prompts(5, 9)
    te, res, _ = lockstep(pairs["llama"], [dict(prompt_ids=p, max_new_tokens=4) for p in ps],
                          burst=burst, quantized_kv=True, max_slots=2, max_len=48,
                          prompt_buckets=(8, 16))
    assert isinstance(te.caches[0], tkv.RowQuantizedKVCache)
    assert te.caches[0].k_q.shape[1] == LLAMA["num_key_value_heads"]
    check_isolated(pairs["llama"][1], res, range(2), ps, [4, 4], quantized=True)


def test_gpt2_idle_row_past_the_position_table_gives_nan_in_its_row_only(pairs):
    """One GPT-2 decode step over a row cache with per-row offsets, one row
    past the 64-entry position table: its logits are NaN on both sides; the
    other rows' logits match JAX and are those of a step where that row is
    in range (tests/test_torch_serving.py holds OPT so)."""
    jm, tm = pairs["gpt2"]
    B, S = 3, 48
    toks = np.array([[3], [-1], [17]], np.int32)  # -1: a NaN row's argmax
    out = {}
    for far in (20, 64):
        lens = np.array([5, far, 12], np.int32)
        jc = jm.init_cache(B, S, per_row=True)
        tc = tm.init_cache(B, S, per_row=True, device="cpu")
        for c in jc:
            c.lengths.value = jnp.asarray(lens)
        for c in tc:
            c.lengths.copy_(torch.from_numpy(lens))
        jl = np.asarray(jm(jnp.asarray(toks), caches=jc, position_offset=jnp.asarray(lens)))
        with torch.no_grad():
            tl = tm(torch.from_numpy(toks), caches=tc,
                    position_offset=tc[0].lengths.clone()).numpy()
        np.testing.assert_allclose(tl, jl, atol=1e-4)  # NaN where JAX has NaN
        out[far] = tl
    assert np.isnan(out[64][1]).all() and np.isfinite(out[20]).all()
    np.testing.assert_array_equal(out[64][[0, 2]], out[20][[0, 2]])
