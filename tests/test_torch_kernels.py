"""The three kernel modules of the port against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; these tests hold it
to the JAX function run as the JAX package's own CPU tests run it (Pallas in
interpret mode, or the JAX plain reference).  tests/test_torch_gpu.py holds
each CUDA kernel to its plain version on the card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dmx_compressor_tpu.ops import bfp_linear as jbl
from dmx_compressor_tpu.ops import bfp_pack as jpack
from dmx_compressor_tpu.ops import flash_attention as jfa
from dmx_compressor_tpu.ops import flash_decode as jfd
from dmx_compressor_tpu.ops import kv_cache as jkv

from dmx_compressor_tpu_torch import kernels
from dmx_compressor_tpu_torch.ops import bfp_linear as tbl
from dmx_compressor_tpu_torch.ops import bfp_pack as tpack
from dmx_compressor_tpu_torch.ops import flash_attention as tfa
from dmx_compressor_tpu_torch.ops import flash_decode as tfd
from dmx_compressor_tpu_torch.ops import kv_cache as tkv

torch.set_num_threads(2)


def rand(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def packed_pair(w, block):
    jp = jpack.bfp_pack(jnp.asarray(w), 8, block)
    tp = tpack.bfp_pack(torch.from_numpy(w), 8, block)
    return jp, tp


# ---------------------------------------------------------------------------
# B1: bfp_linear
# ---------------------------------------------------------------------------

# the odd shapes of tests/test_ops.py:61-78 and :311-331 (M, N, K, block),
# each with the atol of the JAX test it comes from (rtol 1e-6 throughout):
# 1e-4 for the multi-tile cases, whose f32 sums run over up to 4096 terms
B1_CASES = [(8, 300, 128, 64, 1e-5), (8, 40, 1024, 16, 1e-4), (8, 256, 4096, 64, 1e-4),
            (8, 33, 80, 16, 1e-4), (5, 200, 192, 64, 1e-5)]
B1_SHAPES = [c[:4] for c in B1_CASES]


@pytest.mark.parametrize("M,N,K,B,atol", B1_CASES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_bfp_linear_matches_jax_pallas_interpret(M, N, K, B, atol, with_bias):
    rs = np.random.RandomState(0)
    w = rand(rs, N, K, scale=0.3)
    x = rand(rs, M, K)
    b = rand(rs, N) if with_bias else None
    jp, tp = packed_pair(w, B)
    want = np.asarray(jbl.bfp_linear(
        jnp.asarray(x), jp, None if b is None else jnp.asarray(b),
        use_pallas=True, interpret=True,
    ))
    got = tbl.bfp_linear(torch.from_numpy(x), tp, None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=atol)
    # the JAX plain reference agrees too
    ref = np.asarray(jbl.bfp_linear_ref(jnp.asarray(x), jp, None if b is None else jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=atol)


def test_bfp_linear_leading_dims_and_cpu_dispatch():
    rs = np.random.RandomState(1)
    w = rand(rs, 48, 128)
    x = rand(rs, 2, 3, 128)
    jp, tp = packed_pair(w, 64)
    before = dict(kernels.LAUNCHES)
    got = tbl.bfp_linear(torch.from_numpy(x), tp)
    assert got.shape == (2, 3, 48)
    assert kernels.LAUNCHES == before  # the plain version launches nothing
    want = np.asarray(jbl.bfp_linear_ref(jnp.asarray(x), jp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        tbl.bfp_linear(torch.from_numpy(x).to("meta"), tp)


# ---------------------------------------------------------------------------
# B2: flash_decode_int8
# ---------------------------------------------------------------------------


def quant_pair(rs, B, Hkv, S, D):
    k, v = rand(rs, B, Hkv, S, D), rand(rs, B, Hkv, S, D)
    jk, jks = jkv.QuantizedKVCache._quantize(jnp.asarray(k))
    jv, jvs = jkv.QuantizedKVCache._quantize(jnp.asarray(v))
    tk, tks = tkv.QuantizedKVCache._quantize(torch.from_numpy(k))
    tv, tvs = tkv.QuantizedKVCache._quantize(torch.from_numpy(v))
    # the int8 quantizer is bit-exact
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tks.numpy().view(np.uint32), np.asarray(jks).view(np.uint32))
    return jkv.QuantKV(jk, jv, jks, jvs), tkv.QuantKV(tk, tv, tks, tvs)


@pytest.mark.parametrize("rep", [1, 2])
def test_flash_decode_int8_matches_jax(rep):
    """tests/test_flash_decode.py:57-77: the interpret-mode kernel and
    quantized_sdpa, per-row lengths."""
    rs = np.random.RandomState(2)
    B, H, S, D = 2, 8, 256, 64
    q = rand(rs, B, H, 1, D)
    jq, tq = quant_pair(rs, B, H // rep, S, D)
    lengths = np.array([255, 64], np.int32)
    got = tfd.flash_decode_int8(torch.from_numpy(q), tq, torch.from_numpy(lengths)).numpy()
    want = np.asarray(jfd.flash_decode_int8(jnp.asarray(q), jq, jnp.asarray(lengths),
                                            use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    mask = jnp.where(jnp.arange(S)[None, None, None, :] < jnp.asarray(lengths)[:, None, None, None],
                     0.0, -1e30)
    sdpa = np.asarray(jkv.quantized_sdpa(jnp.asarray(q), jq, attn_mask=mask, enable_gqa=rep > 1))
    np.testing.assert_allclose(got, sdpa, atol=2e-6, rtol=1e-5)
    # the port's quantized_sdpa is the same function
    tmask = torch.tensor(np.asarray(mask, np.float32))
    tsdpa = tkv.quantized_sdpa(torch.from_numpy(q), tq, attn_mask=tmask, enable_gqa=rep > 1)
    np.testing.assert_allclose(tsdpa.numpy(), sdpa, atol=2e-6, rtol=1e-5)


def test_flash_decode_int8_scalar_full_length_and_ragged_s():
    rs = np.random.RandomState(3)
    for B, H, S, D, length in [(1, 4, 128, 64, 128), (3, 4, 191, 32, 100)]:
        q = rand(rs, B, H, 1, D)
        jq, tq = quant_pair(rs, B, H, S, D)
        got = tfd.flash_decode_int8(torch.from_numpy(q), tq, length, scale=0.2).numpy()
        want = np.asarray(jfd.flash_decode_int8_ref(jnp.asarray(q), jq, length, scale=0.2))
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        tfd.flash_decode_int8(torch.zeros(1, 4, 2, 64), tq, 3)


# ---------------------------------------------------------------------------
# B3: flash_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,S,causal,with_bias", [
    (128, 128, True, False), (100, 100, True, False), (64, 192, True, False),
    (72, 200, False, True), (37, 37, False, False), (16, 80, True, True),
])
def test_flash_attention_matches_jax_ref(L, S, causal, with_bias):
    """tests/test_flash_attention.py:42: against flash_attention_ref."""
    rs = np.random.RandomState(4)
    B, H, D = 2, 3, 64
    q, k, v = rand(rs, B, H, L, D), rand(rs, B, H, S, D), rand(rs, B, H, S, D)
    bias = rand(rs, B, H, L, S) if with_bias else None
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              None if bias is None else torch.from_numpy(bias),
                              causal=causal, scale=0.11).numpy()
    want = np.asarray(jfa.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), scale=0.11, causal=causal,
    ))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_flash_attention_rejects_causal_with_fewer_keys():
    with pytest.raises(ValueError):
        tfa.flash_attention(torch.zeros(1, 8, 64), torch.zeros(1, 4, 64),
                            torch.zeros(1, 4, 64), causal=True)


def test_quantized_cache_update_returns_dequantized_buffers():
    """QuantizedKVCache.update (the non-transparent path) dequantizes its
    full buffers exactly as the JAX cache does (JAX stores [B, H, D, S])."""
    rs = np.random.RandomState(5)
    B, H, S, D, T = 2, 3, 16, 8, 5
    jc = jkv.QuantizedKVCache(B, H, S, D)
    tc = tkv.QuantizedKVCache(B, H, S, D, device="cpu")
    for _ in range(2):
        k, v = rand(rs, B, H, T, D), rand(rs, B, H, T, D)
        jk, jv, jlen = jc.update(jnp.asarray(k), jnp.asarray(v))
        tk, tv, tlen = tc.update(torch.from_numpy(k), torch.from_numpy(v))
        assert tlen == int(jlen) and tc.lengths.tolist() == [tlen] * B
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    with pytest.raises(ValueError):
        tc.update(torch.zeros(B, H, 7, D), torch.zeros(B, H, 7, D))
