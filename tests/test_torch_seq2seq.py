"""The port's ``Seq2SeqBatchingEngine`` against the JAX package's, on the CPU.

The configurations and inputs are tests/test_serving.py's seq2seq cases:
T5 (vocab 97, 64 wide, 4 heads of 16, 2 + 2 layers) with ragged token-id
encoder inputs of 6, 9 and 4 tokens padded to ``enc_capacity`` 12 and
masked, and ``WhisperConfig.tiny()`` with fixed-shape features [16, 100];
three requests of 5 new tokens through two slots, buckets 2 / 4, 24
positions.  Each JAX model of seed 0 carries its weights into the port, both
engines take the same submissions and are stepped in lockstep (every step's
results and counters equal), at bursts of 1 and 2, over the f32 and the int8
row cache; the port's tokens also equal its own isolated ``generate``.
Chunked prefill is refused.
"""

import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.models.t5 import T5Config as JT5Config
from dmx_compressor_tpu.models.t5 import T5ForConditionalGeneration as JT5
from dmx_compressor_tpu.models.whisper import WhisperConfig as JWhisperConfig
from dmx_compressor_tpu.models.whisper import WhisperForConditionalGeneration as JWhisper
from dmx_compressor_tpu.serving import Seq2SeqBatchingEngine as JEngine

from dmx_compressor_tpu_torch.models import t5 as tt5
from dmx_compressor_tpu_torch.models import whisper as tw
from dmx_compressor_tpu_torch.serving import Seq2SeqBatchingEngine
from test_torch_opt import flat_params
from test_torch_serving import busy, results

torch.set_num_threads(2)

T5_CFG = dict(vocab_size=97, d_model=64, d_kv=16, d_ff=128, num_layers=2,
              num_decoder_layers=2, num_heads=4)
ENGINE = dict(max_slots=2, max_len=24, prompt_buckets=(2, 4))


@pytest.fixture(scope="module")
def pairs():
    """(JAX model, port model) per family, the JAX weights of seed 0
    carried, and each family's encoder inputs."""
    rng = np.random.default_rng(1)
    jt = JT5(JT5Config(**T5_CFG), rngs=nnx.Rngs(0))
    tt = tt5.T5ForConditionalGeneration(tt5.T5Config(**T5_CFG), device="cpu")
    tt5.load_jax_params(tt, flat_params(jt))
    t5_inputs = [rng.integers(1, 97, (n,)).astype(np.int32) for n in (6, 9, 4)]
    wcfg = JWhisperConfig.tiny()
    jw = JWhisper(wcfg, rngs=nnx.Rngs(0))
    tww = tw.WhisperForConditionalGeneration(tw.WhisperConfig.tiny(), device="cpu")
    tw.load_jax_params(tww, flat_params(jw))
    feats = [rng.standard_normal((wcfg.num_mel_bins, wcfg.max_source_positions * 2))
             .astype(np.float32) for _ in range(3)]
    return {"t5": (jt, tt, t5_inputs, dict(enc_capacity=12)),
            "whisper": (jw, tww, feats, {})}


def lockstep(jm, tm, subs, burst, **kw):
    """Both engines built with ``kw``, the same submissions, stepped in
    lockstep: every step's results and admission counters equal.  Returns
    the port's results by request id."""
    je, te = JEngine(jm, **kw), Seq2SeqBatchingEngine(tm, **kw)
    for s in subs:
        assert je.submit(**s) == te.submit(**s)
    i = 0
    while busy(je) or busy(te):
        assert busy(je) == busy(te), f"step {i}"
        want, got = results(je.step(burst)), results(te.step(burst))
        assert got == want, f"step {i}"
        assert te.last_step_admissions == je.last_step_admissions, f"step {i}"
        i += 1
        assert i < 200
    return {r.request_id: r for r in te.finished}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("burst", [1, 2])
@pytest.mark.parametrize("family", ["t5", "whisper"])
def test_engine_in_lockstep_with_jax_and_isolated(pairs, family, burst, quantized):
    jm, tm, inputs, extra = pairs[family]
    res = lockstep(jm, tm, [dict(encoder_input=x, max_new_tokens=5) for x in inputs], burst,
                   quantized_kv=quantized, **ENGINE, **extra)
    assert sorted(res) == [0, 1, 2]
    for rid, x in enumerate(inputs):
        iso = tm.generate(x[None], np.zeros((1, 1), np.int32), max_new_tokens=5,
                          quantized_cache=quantized)
        assert res[rid].tokens == iso[0, 1:].tolist(), f"request {rid}"
        assert res[rid].finish_reason == "length"


def test_engine_start_tokens_and_warmup(pairs):
    """Whisper's four start tokens as the decoder prompt, after warmup():
    the tokens of isolated generation; warmup leaves no result."""
    _, tm, feats, _ = pairs["whisper"]
    start = np.array([5, 7, 11, 13], np.int32)
    eng = Seq2SeqBatchingEngine(tm, **ENGINE)
    eng.warmup(2, feats[0])
    assert not eng.finished
    rids = [eng.submit(f, decoder_start_ids=start, max_new_tokens=6) for f in feats]
    res = {r.request_id: r.tokens for r in eng.run(burst=2)}
    for rid, f in zip(rids, feats):
        assert res[rid] == tm.generate(f[None], start[None], max_new_tokens=6)[0, 4:].tolist()


def test_prefill_chunk_is_refused(pairs):
    with pytest.raises(ValueError, match="chunked prefill"):
        Seq2SeqBatchingEngine(pairs["t5"][1], prefill_chunk=4, **ENGINE)


def test_ragged_input_past_capacity_and_feature_warmup_are_refused(pairs):
    _, tm, _, _ = pairs["t5"]
    eng = Seq2SeqBatchingEngine(tm, enc_capacity=4, **ENGINE)
    with pytest.raises(AssertionError, match="enc_capacity"):
        eng.submit(np.ones((5,), np.int32))
    with pytest.raises(AssertionError, match="example encoder_input"):
        Seq2SeqBatchingEngine(pairs["whisper"][1], **ENGINE).warmup(1)
