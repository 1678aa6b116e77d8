"""T5 on the CPU: the port (dmx_compressor_tpu_torch/models/t5.py) against
the JAX package's, on the same seeded inputs and carried weights
(tests/torch_seq2seq.py):

- the relative-position buckets bit for bit over [-512, 512], bidirectional
  and causal, at the default 32 buckets and distance 128 (and two other
  settings), the card's table route included; HF's is the third witness;
- ``T5Config.tiny()`` logits, ReLU and v1.1's gated GELU, within 1e-5 of
  JAX; a cached decode equal to the full forward; ``generate``'s tokens
  identical to JAX's; the raw model against HF torch's T5;
- bench.py's weights (int8 cache), basic and baseline legs within MODE_TOL
  (4e-3) with identical tokens; the packed weights bit for bit; the shared
  table one Parameter at every site, the tied head packing it, the
  ``d_model**-0.5`` rescale before the head;
- the kernel wrappers each leg calls, counted as chip_smoke.py counts their
  launches on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.models import t5 as jt5
from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule

from dmx_compressor_tpu_torch.modeling.model import DmxModel
from dmx_compressor_tpu_torch.models import t5 as tt5
from dmx_compressor_tpu_torch.nn import modules as tdmxnn
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.ops.compress import PackedBFPLinear
import torch_seq2seq as s2s

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


@pytest.mark.parametrize("buckets,distance", [(32, 128), (64, 256), (16, 32)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_buckets_bit_for_bit(bidirectional, buckets, distance):
    """Every relative position in [-512, 512]: the port's f32 formula and its
    table route (what the card indexes) equal the JAX package's ids; HF's
    torch formula agrees."""
    from transformers.models.t5.modeling_t5 import T5Attention as HFT5Attention

    rel = np.arange(-512, 513, dtype=np.int32)
    want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), bidirectional, buckets,
                                                   distance))
    got = tt5.relative_position_bucket(torch.from_numpy(rel), bidirectional, buckets, distance)
    table = tt5.position_buckets(torch.from_numpy(rel), bidirectional, buckets, distance)
    hf = HFT5Attention._relative_position_bucket(torch.from_numpy(rel).long(), bidirectional,
                                                 buckets, distance)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(table.numpy(), want)
    np.testing.assert_array_equal(hf.numpy(), want)


@pytest.mark.parametrize("gated", [False, True])
def test_logits_match_jax(gated):
    """The raw tiny model's logits (encoder over 12 tokens, decoder over 5)
    within 1e-5 of JAX's."""
    fields = dict(is_gated_act=True) if gated else {}
    jm, params = s2s.jax_model("t5", **fields)
    tm = s2s.port_model("t5", params, **fields)
    x = s2s.encoder_input("t5", tm.cfg)
    d = np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (s2s.B, 5)).astype(np.int32)
    want = np.asarray(jm(jnp.asarray(x), jnp.asarray(d)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, atol=s2s.RAW_TOL, rtol=0)


def test_cached_decode_equals_full_forward():
    """Prefill + single-token steps over a cache give the full forward's
    logits, position by position (f32, 1e-5)."""
    _, params = s2s.jax_model("t5")
    tm = s2s.port_model("t5", params)
    x = torch.from_numpy(s2s.encoder_input("t5", tm.cfg))
    d = torch.from_numpy(np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (s2s.B, 6))
                         .astype(np.int32))
    with torch.no_grad():
        full = tm(x, d)
        enc = tm.encode(x)
        caches = tm.init_cache(s2s.B, 8, device="cpu")
        rows = [tm.decode(d[:, :2], enc, caches=caches, position_offset=0)]
        rows += [tm.decode(d[:, i:i + 1], enc, caches=caches, position_offset=i)
                 for i in range(2, 6)]
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), full.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("gated", [False, True])
def test_generate_matches_jax(gated):
    fields = dict(is_gated_act=True) if gated else {}
    jm, params = s2s.jax_model("t5", **fields)
    tm = s2s.port_model("t5", params, **fields)
    x = s2s.encoder_input("t5", tm.cfg)
    start = np.zeros((s2s.B, 1), np.int32)
    want = np.asarray(jm.generate(jnp.asarray(x), start, max_new_tokens=8))
    got = tm.generate(x, start, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (s2s.B, 9) and len(set(got[:, 1:].flatten().tolist())) > 2


def test_generate_stops_at_eos_as_jax_does():
    """With ``eos_token_id`` (the third token JAX generates for row 0) a row
    repeats it once emitted: the same tokens as JAX's ``generate``."""
    jm, params = s2s.jax_model("t5", is_gated_act=True)
    tm = s2s.port_model("t5", params, is_gated_act=True)
    x = s2s.encoder_input("t5", tm.cfg)
    start = np.zeros((s2s.B, 1), np.int32)
    eos = int(np.asarray(jm.generate(jnp.asarray(x), start, max_new_tokens=8))[0, 3])
    want = np.asarray(jm.generate(jnp.asarray(x), start, max_new_tokens=8, eos_token_id=eos))
    got = tm.generate(x, start, max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 3:] == eos).all()


@pytest.mark.parametrize("gated", [False, True])
def test_raw_model_matches_hf_torch(gated):
    """HF torch's T5 (random weights, HF's names) through
    ``hf_tensor_converter`` into the port: the same logits (the gated
    form's head untied, as v1.1)."""
    from transformers import T5Config as HFT5Config
    from transformers import T5ForConditionalGeneration as HFT5

    cfg = tt5.T5Config.tiny()
    cfg.is_gated_act = gated
    cfg.tie_word_embeddings = not gated
    hf_cfg = HFT5Config(vocab_size=cfg.vocab_size, d_model=cfg.d_model, d_kv=cfg.d_kv,
                        d_ff=cfg.d_ff, num_layers=cfg.num_layers,
                        num_decoder_layers=cfg.num_decoder_layers, num_heads=cfg.num_heads,
                        dropout_rate=0.0,
                        feed_forward_proj="gated-gelu" if gated else "relu",
                        tie_word_embeddings=not gated)
    torch.manual_seed(0)
    hf = HFT5(hf_cfg).eval()
    tm = tt5.T5ForConditionalGeneration(cfg, device="cpu")
    tensors = tt5.T5ForConditionalGeneration.hf_tensor_converter(hf.state_dict())
    missing, unexpected = tm.load_state_dict(tensors, strict=False)
    assert missing == [] and unexpected == ([] if gated else ["lm_head.weight"])
    x = s2s.encoder_input("t5", cfg).astype(np.int64)
    d = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 7))
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(x), decoder_input_ids=torch.from_numpy(d)).logits
        got = tm(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("leg", ["raw", "weights", "sbfp", "basic", "baseline"])
def test_leg_matches_jax(leg):
    s2s.leg_matches_jax("t5", leg)


def test_packed_weights_equal_bit_for_bit():
    """Every packed linear of the weights leg, the tied head (the shared
    table's packing) included, bit for bit against JAX's."""
    tm = s2s.packed_weights_equal("t5")
    assert isinstance(tm.lm_head, PackedBFPLinear)
    assert tm.lm_head.out_features == tm.cfg.vocab_size


def test_the_shared_table_is_one_parameter_everywhere():
    """Substitution converts each site of the shared table into its own Dmx
    Embedding (as the JAX package does), all on one Parameter, which the
    tied head's Linear reads too; the BASIC weight cast of the head casts
    that table, and the embeddings read it uncast; the packed head of the
    weights leg is the table's packing."""
    _, params = s2s.jax_model("t5")
    tm = s2s.port_model("t5", params)
    table = tm.shared.weight.detach().clone()
    dm = DmxModel.from_raw(tm)
    embeds = [tm.shared, tm.encoder.embed_tokens, tm.decoder.embed_tokens]
    assert all(isinstance(e, tdmxnn.Embedding) for e in embeds)
    assert len({id(e) for e in embeds}) == 3
    assert isinstance(tm.lm_head, tdmxnn.Linear)
    assert all(e.weight is tm.lm_head.weight for e in embeds)
    assert len([p for p in tm.parameters() if p.shape == table.shape]) == 1
    dm.to_basic_mode()
    from dmx_compressor_tpu_torch import format as fmts

    np.testing.assert_array_equal(tm.lm_head._weight.detach().numpy(),
                                  fmts.BFP16_64.cast(table).numpy())
    np.testing.assert_array_equal(tm.shared._weight.detach().numpy(), table.numpy())


def test_head_rescale_before_the_tied_head():
    """A tied head reads h * d_model**-0.5 (the f32 constant); an untied one
    reads h."""
    _, params = s2s.jax_model("t5")
    tm = s2s.port_model("t5", params)
    x = torch.from_numpy(s2s.encoder_input("t5", tm.cfg))
    d = torch.zeros((s2s.B, 1), dtype=torch.int32)
    with torch.no_grad():
        enc = tm.encode(x)
        h = tm.decoder(d, enc=enc)
        np.testing.assert_array_equal(
            tm.decode(d, enc).numpy(),
            (h * np.float32(tm.cfg.d_model ** -0.5)) @ tm.shared.weight.T)


def test_unscaled_attention_is_not_read_as_no_scale():
    """``scale=1.0`` multiplies by 1 in the raw and the modular SDPA (the
    default would be 1/sqrt(d_kv))."""
    from dmx_compressor_tpu_torch import rawnn

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 3, 16, generator=g) for _ in range(3))
    want = torch.softmax(q @ k.transpose(-1, -2), -1) @ v
    for sdpa in (rawnn.ScaledDotProductAttention(), tdmxnn.ScaledDotProductAttention()):
        np.testing.assert_allclose(sdpa(q, k, v, scale=1.0).numpy(), want.numpy(), atol=1e-6)
        assert not torch.allclose(sdpa(q, k, v), want, atol=1e-3)


@pytest.mark.parametrize("leg", ["weights", "basic", "baseline"])
def test_leg_calls_the_kernel_wrappers(monkeypatch, leg):
    """The counts chip_smoke.py asserts on the card (L layers a stack, a
    ReLU feed-forward): weights 16L+1 B1 at a prefill (the encoder's 6 a
    layer, the decoder's 10, the head) and 10L+1 a step, no B2 / B3 / B4
    (T5's attention is modular); baseline nothing; basic 16L+1 / 10L+1 T1
    (every linear's input rows here <= 256: the fused linear) and the T2
    casts of the modular pipeline (chip_smoke.py's formulas at its shapes)."""
    _, params = s2s.jax_model("t5")
    tm = s2s.port_model("t5", params, leg)
    L = tm.cfg.num_layers
    counts = {}
    s2s.spy(monkeypatch, counts)
    caches = tm.init_cache(s2s.B, 8, quantized=leg == "weights", device="cpu")
    with torch.no_grad():
        enc = tm.encode(torch.from_numpy(s2s.encoder_input("t5", tm.cfg)))
        tm.decode(torch.zeros((s2s.B, 1), dtype=torch.int32), enc, caches=caches)
        prefill = dict(counts)
        counts.clear()
        tm.decode(torch.zeros((s2s.B, 1), dtype=torch.int32), enc, caches=caches,
                  position_offset=1)
    assert "b2" not in counts and "b3" not in prefill and "b4" not in counts
    if leg == "weights":
        assert prefill == {"b1": 16 * L + 1} and counts == {"b1": 10 * L + 1}
    elif leg == "baseline":
        assert prefill == {} and counts == {}
    else:
        assert prefill["t1"] == 16 * L + 1 and counts["t1"] == 10 * L + 1
        assert set(prefill) == set(counts) == {"t1", "t2"}
