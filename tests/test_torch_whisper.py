"""Whisper on the CPU: the port (dmx_compressor_tpu_torch/models/whisper.py
and nn/experimental.py's Conv1dUnfold) against the JAX package's, on the
same seeded inputs and carried weights (tests/torch_seq2seq.py):

- ``Conv1dUnfold`` against JAX's and against ``torch.nn.functional.conv1d``
  at strides 1 and 2 (1e-5), and under the BASIC casts against JAX's (the
  same cast values: 1e-5 on the f32 GEMM); its patch axis channel-major and
  tap-minor, HF's conv weight ``reshape(out, -1)``;
- ``WhisperConfig.tiny()`` logits within 1e-5 of JAX; a cached decode equal
  to the full forward; ``generate``'s tokens identical to JAX's (an f32 and
  an int8 cache); the raw model against HF torch's Whisper through
  ``hf_tensor_converter``;
- bench.py's weights (int8 cache), basic and baseline legs within MODE_TOL
  (4e-3) with identical tokens; the packed weights bit for bit;
- the kernel wrappers each leg calls, counted as chip_smoke.py counts their
  launches on the card: B3 at the baseline leg's 4-token prefill, B4 / B2 at
  each step, none on the encoder's self-attention.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from dmx_compressor_tpu.nn.core import DmxModule as JDmxModule
from dmx_compressor_tpu.nn.experimental import Conv1dUnfold as JConv1dUnfold

from dmx_compressor_tpu_torch.models import whisper as tw
from dmx_compressor_tpu_torch.nn.core import DmxModule
from dmx_compressor_tpu_torch.nn.experimental import Conv1dUnfold
from dmx_compressor_tpu_torch.nn.modules import _im2col
import torch_seq2seq as s2s

torch.set_num_threads(2)

BASIC_CONV = dict(input_formats=["BFP[8|8]{64}(SN)"], weight_format="BFP[8|8]{64}(SN)",
                  output_formats=["FP[1|5|10,15](FN)"])


@pytest.fixture(autouse=True)
def _restore_inference_mode():
    prev = (DmxModule.inference_mode, JDmxModule.inference_mode)
    yield
    DmxModule.inference_mode, JDmxModule.inference_mode = prev


def _conv_pair(C, O, k, stride, padding, dilation=1, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((O, C * k)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((O,)) * 0.1).astype(np.float32)
    jc = JConv1dUnfold(C, O, k, stride=stride, padding=padding, dilation=dilation,
                       rngs=nnx.Rngs(0))
    jc.weight.value, jc.bias.value = jnp.asarray(w), jnp.asarray(b)
    tc = Conv1dUnfold(C, O, k, stride=stride, padding=padding, dilation=dilation, device="cpu")
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(w))
        tc.bias.copy_(torch.from_numpy(b))
    return jc, tc, w, b


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 1, 1), (2, 3, 2)])
def test_conv1d_unfold_matches_jax_and_conv1d(stride, padding, dilation):
    C, O, k = 16, 24, 3
    jc, tc, w, b = _conv_pair(C, O, k, stride, padding, dilation)
    x = np.random.default_rng(1).standard_normal((2, C, 37)).astype(np.float32)
    want = np.asarray(jc(jnp.asarray(x)))
    got = tc(torch.from_numpy(x)).detach()
    conv = torch.nn.functional.conv1d(torch.from_numpy(x), torch.from_numpy(w).reshape(O, C, k),
                                      torch.from_numpy(b), stride=stride, padding=padding,
                                      dilation=dilation)
    assert got.shape == conv.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), conv.numpy(), atol=1e-5, rtol=0)


def test_im2col_is_channel_major_tap_minor():
    x = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    p = _im2col(x, (2,), (1,), (0,), (1,))  # [B, C * k, L]
    assert p.shape == (2, 6, 4)
    # channel c, tap t at row c * k + t; column l reads x[:, c, l + t]
    for c in range(3):
        for t in range(2):
            np.testing.assert_array_equal(p[:, c * 2 + t].numpy(), x[:, c, t:t + 4].numpy())


@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d_unfold_under_basic_casts_matches_jax(stride):
    """BFP16_64 input and weight casts along the patch axis (K = 64 x 3) and
    a FLOAT16 output cast: the cast values equal JAX's."""
    C, O, k = 64, 32, 3
    jc, tc, _, _ = _conv_pair(C, O, k, stride, 1, seed=2)
    jc.configure(BASIC_CONV)
    tc.configure(BASIC_CONV)
    x = np.random.default_rng(3).standard_normal((2, C, 20)).astype(np.float32)
    want = np.asarray(jc(jnp.asarray(x)))
    got = tc(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not np.allclose(got, np.asarray(JConv1dUnfold.__call__(
        _conv_pair(C, O, k, stride, 1, seed=2)[0], jnp.asarray(x))), atol=1e-6)


def test_logits_match_jax():
    jm, params = s2s.jax_model("whisper")
    tm = s2s.port_model("whisper", params)
    f = s2s.encoder_input("whisper", tm.cfg)
    d = s2s.start_ids("whisper", tm.cfg)
    want = np.asarray(jm(jnp.asarray(f), jnp.asarray(d)))
    with torch.no_grad():
        got = tm(torch.from_numpy(f), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, atol=s2s.RAW_TOL, rtol=0)


def test_cached_decode_equals_full_forward():
    _, params = s2s.jax_model("whisper")
    tm = s2s.port_model("whisper", params)
    f = torch.from_numpy(s2s.encoder_input("whisper", tm.cfg))
    d = torch.from_numpy(np.random.default_rng(6).integers(0, tm.cfg.vocab_size, (s2s.B, 7))
                         .astype(np.int32))
    with torch.no_grad():
        full = tm(f, d)
        enc = tm.encode(f)
        caches = tm.init_cache(s2s.B, 8, device="cpu")
        rows = [tm.decode(d[:, :4], enc, caches=caches, position_offset=0)]
        rows += [tm.decode(d[:, i:i + 1], enc, caches=caches, position_offset=i)
                 for i in range(4, 7)]
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), full.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_generate_matches_jax(quantized):
    jm, params = s2s.jax_model("whisper")
    tm = s2s.port_model("whisper", params)
    f = s2s.encoder_input("whisper", tm.cfg)
    d = s2s.start_ids("whisper", tm.cfg)
    want = np.asarray(jm.generate(jnp.asarray(f), d, max_new_tokens=8, quantized_cache=quantized))
    got = tm.generate(f, d, max_new_tokens=8, quantized_cache=quantized)
    np.testing.assert_array_equal(got.numpy(), want)


def test_raw_model_matches_hf_torch():
    """HF torch's Whisper (random weights) through ``hf_tensor_converter``:
    every tensor of HF's state dict but the tied ``proj_out.weight`` loads
    under its own name (the convs reshaped to [out, in * 3]); the same
    logits."""
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration as HFWhisper

    cfg = tw.WhisperConfig.tiny()
    hf_cfg = HFWhisperConfig(
        vocab_size=cfg.vocab_size, num_mel_bins=cfg.num_mel_bins, d_model=cfg.d_model,
        encoder_layers=cfg.encoder_layers, decoder_layers=cfg.decoder_layers,
        encoder_attention_heads=cfg.encoder_attention_heads,
        decoder_attention_heads=cfg.decoder_attention_heads,
        encoder_ffn_dim=cfg.encoder_ffn_dim, decoder_ffn_dim=cfg.decoder_ffn_dim,
        max_source_positions=cfg.max_source_positions,
        max_target_positions=cfg.max_target_positions, dropout=0.0, activation_dropout=0.0,
        attention_dropout=0.0, activation_function="gelu", pad_token_id=0, bos_token_id=0,
        eos_token_id=1, decoder_start_token_id=1, begin_suppress_tokens=None,
        suppress_tokens=None)
    torch.manual_seed(0)
    hf = HFWhisper(hf_cfg).eval()
    tm = tw.WhisperForConditionalGeneration(cfg, device="cpu")
    tensors = tw.WhisperForConditionalGeneration.hf_tensor_converter(hf.state_dict())
    missing, unexpected = tm.load_state_dict(tensors, strict=False)
    # the convs' cast and SmoothQuant state is no weight
    assert all((".conv1." in m or ".conv2." in m) and ("cast" in m or ".smoothquant." in m)
               for m in missing)
    assert unexpected == ["proj_out.weight"]
    assert tm.model.encoder.conv2.weight.shape == (cfg.d_model, 3 * cfg.d_model)
    f = s2s.encoder_input("whisper", cfg)
    d = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 7))
    with torch.no_grad():
        want = hf(input_features=torch.from_numpy(f),
                  decoder_input_ids=torch.from_numpy(d)).logits
        got = tm(torch.from_numpy(f), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("leg", ["raw", "weights", "sbfp", "basic", "baseline"])
def test_leg_matches_jax(leg):
    s2s.leg_matches_jax("whisper", leg)


def test_packed_weights_equal_bit_for_bit():
    """Every packed linear of the weights leg (q / k / v unmerged, as in
    JAX; the tied head N = vocab), bit for bit; the convs stay plain."""
    tm = s2s.packed_weights_equal("whisper")
    assert tm.proj_out.out_features == tm.cfg.vocab_size
    assert isinstance(tm.model.encoder.conv1, Conv1dUnfold)


@pytest.mark.parametrize("leg", ["weights", "basic", "baseline"])
def test_leg_calls_the_kernel_wrappers(monkeypatch, leg):
    """The counts chip_smoke.py asserts on the card (L layers a stack):
    weights 16L+1 B1 at a prefill (the encoder's q, k, v, out, fc1, fc2;
    the decoder's self and cross q, k, v, out, fc1, fc2; the head) and no B3
    (an int8 prefill attends through quantized_sdpa), 10L+1 B1 + L B2 a
    step; baseline L B3 (the 4 start tokens over the f32 cache) and L B4 a
    step, no packed linear; basic 16L+1 / 10L+1 T1 and T2 casts, no
    attention kernel.  The encoder's self-attention and the
    cross-attention never reach one."""
    _, params = s2s.jax_model("whisper")
    tm = s2s.port_model("whisper", params, leg)
    L = tm.cfg.decoder_layers
    counts = {}
    s2s.spy(monkeypatch, counts)
    caches = tm.init_cache(s2s.B, 8, quantized=leg == "weights", device="cpu")
    with torch.no_grad():
        enc = tm.encode(torch.from_numpy(s2s.encoder_input("whisper", tm.cfg)))
        tm.decode(torch.from_numpy(s2s.start_ids("whisper", tm.cfg)), enc, caches=caches)
        prefill = dict(counts)
        counts.clear()
        tm.decode(torch.zeros((s2s.B, 1), dtype=torch.int32), enc, caches=caches,
                  position_offset=4)
    if leg == "weights":
        assert prefill == {"b1": 16 * L + 1} and counts == {"b1": 10 * L + 1, "b2": L}
    elif leg == "baseline":
        assert prefill == {"b3": L} and counts == {"b4": L}
    else:
        assert prefill["t1"] == 16 * L + 1 and counts["t1"] == 10 * L + 1
        assert set(prefill) == set(counts) == {"t1", "t2"}
