"""The kernel modules of the port (B1-B5) against the JAX package.

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

from dmx_compressor_tpu.numerics.format import Format as JFormat

from dmx_compressor_tpu_torch import kernels
from dmx_compressor_tpu_torch.numerics.format import Format as TFormat
from dmx_compressor_tpu_torch.ops import bfp_linear as tbl
from dmx_compressor_tpu_torch.ops import bfp_pack as tpack
from dmx_compressor_tpu_torch.ops import flash_attention as tfa
from dmx_compressor_tpu_torch.ops import flash_decode as tfd
from dmx_compressor_tpu_torch.ops import kv_cache as tkv
from dmx_compressor_tpu_torch.ops.compress import SBFP12_16

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


# B1's wgmma path splits x into three bf16 planes (csrc/bfp_wgmma.cuh); its
# plain transcription split_bf16x3_ref is held here, and the three-plane
# product, summed in f32, against bfp_linear_ref and the JAX bfp_linear

_LOW_NAN = (0x7F800001, -8388607, 0x7FC00000)  # low-payload NaNs (+, -), a quiet NaN


def _floats(bits):
    return torch.tensor(bits, dtype=torch.int32).view(torch.float32)


def test_split_bf16x3_reproduces_x_bit_for_bit():
    """(h + m) + l == x bit for bit over random values at every exponent
    down to 2^-110, +-FLT_MAX and +-0.0; h is x truncated (never rounded up,
    so FLT_MAX does not overflow); each plane is exact in bf16."""
    rs = np.random.RandomState(8)
    with np.errstate(over="ignore"):
        x = (rs.standard_normal(200000) * np.exp2(rs.uniform(-110, 128, 200000))).astype(np.float32)
    fmax = np.finfo(np.float32).max
    x = x[np.isfinite(x) & (np.abs(x) >= 2.0**-110)]
    x = np.concatenate([x, np.array([fmax, -fmax, np.nextafter(fmax, 0), 0.0, -0.0,
                                     2.0**-110, -(2.0**-110)], np.float32)])
    t = torch.from_numpy(x)
    h, m, l = tbl.split_bf16x3_ref(t)
    assert h.dtype == m.dtype == l.dtype == torch.bfloat16
    total = (h.float() + m.float()) + l.float()
    assert torch.equal(total.view(torch.int32), t.view(torch.int32))
    assert torch.equal(h.float().view(torch.int32), t.view(torch.int32) & -65536)
    assert torch.isfinite(h.float()).all()
    for p in (h, m, l):  # exact in bf16: the f32 round trip keeps the bits
        assert torch.equal(p.float().to(torch.bfloat16).view(torch.int16), p.view(torch.int16))


def test_split_bf16x3_subnormals_and_non_finite():
    """Below 2^-110, f32 subnormals included, the planes lose less than
    2^-133 (bf16's last subnormal bit); +-inf keeps h and zeroes m and l; a
    NaN stays a NaN in h, also one whose payload lies only in the low 16
    bits, with m = l = 0 (as the kernel's loader does)."""
    rs = np.random.RandomState(9)
    x = (rs.standard_normal(50000) * np.exp2(rs.uniform(-150, -110, 50000))).astype(np.float32)
    assert (np.abs(x) < 2.0**-126).sum() > 1000  # subnormals among them
    t = torch.from_numpy(x)
    h, m, l = tbl.split_bf16x3_ref(t)
    lost = (t.double() - ((h.float() + m.float()) + l.float()).double()).abs()
    assert lost.max().item() < 2.0**-133
    special = torch.cat([torch.tensor([float("inf"), -float("inf"), float("nan")]),
                         _floats(list(_LOW_NAN))])
    h, m, l = tbl.split_bf16x3_ref(special)
    assert h[0].item() == float("inf") and h[1].item() == -float("inf")
    assert torch.isnan(h[2:].float()).all()
    assert not m.float().any() and not l.float().any()


@pytest.mark.parametrize("M,N,K,B,atol", B1_CASES)
def test_bfp_linear_three_plane_product_matches_ref_and_jax(M, N, K, B, atol):
    """h.W^T + m.W^T + l.W^T + bias, each product in f32, is B1's product:
    within B1's tolerance (rtol 1e-5, atol 1e-4) of bfp_linear_ref and of
    the JAX bfp_linear (Pallas, interpret mode) on the same numpy inputs;
    a seventh of x is scaled by 1e-3, so that the planes span more
    exponents."""
    rs = np.random.RandomState(10)
    w = rand(rs, N, K, scale=0.3)
    x = rand(rs, M, K)
    x[:, ::7] *= 1e-3
    b = rand(rs, N)
    jp, tp = packed_pair(w, B)
    wd = tpack.bfp_unpack(tp)
    h, m, l = tbl.split_bf16x3_ref(torch.from_numpy(x))
    assert m.float().abs().max() > 0 and l.float().abs().max() > 0
    y = (h.float() @ wd.T + m.float() @ wd.T) + l.float() @ wd.T + torch.from_numpy(b)
    ref = tbl.bfp_linear_ref(torch.from_numpy(x), tp, torch.from_numpy(b))
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-4)
    want = np.asarray(jbl.bfp_linear(jnp.asarray(x), jp, jnp.asarray(b),
                                     use_pallas=True, interpret=True))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-4)


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


# B2 splits S into chunks of B2_CHUNK = 256 keys, one CUDA block each, and
# merges the chunks' (m, l, acc) in chunk order (csrc/flash_decode_int8.cu);
# flash_decode_int8_split_ref transcribes that arithmetic.  (B, H, Hkv, S,
# D, lengths): every row a single key, every row full over three chunks,
# ragged rows on either side of a chunk edge, an S that is no multiple of
# the chunk, GQA with 12 query heads on 4 KV heads, the main path's shape
B2_SPLIT_CASES = [(3, 4, 4, 256, 64, [1, 1, 1]), (2, 4, 4, 768, 64, [768] * 2),
                  (4, 4, 4, 600, 32, [1, 256, 257, 600]), (2, 4, 4, 700, 64, [700, 513]),
                  (2, 12, 4, 520, 64, [520, 300]), (2, 12, 4, 520, 128, [517, 260]),
                  (8, 12, 12, 256, 64, [160] * 8)]


@pytest.mark.parametrize("B,H,Hkv,S,D,lengths", B2_SPLIT_CASES)
def test_flash_decode_int8_split_matches_refs(B, H, Hkv, S, D, lengths):
    """The split-and-merge transcription against flash_decode_int8_ref and
    the JAX flash_decode_int8_ref at B2's card tolerance (rtol 1e-5, atol
    2e-5); on the CPU the wrapper runs the plain version."""
    rs = np.random.RandomState(24)
    q = rand(rs, B, H, 1, D)
    jq, tq = quant_pair(rs, B, Hkv, S, D)
    le = np.array(lengths, np.int32)
    got = tfd.flash_decode_int8_split_ref(torch.from_numpy(q), tq, torch.from_numpy(le))
    ref = tfd.flash_decode_int8(torch.from_numpy(q), tq, torch.from_numpy(le))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=2e-5)
    want = np.asarray(jfd.flash_decode_int8_ref(jnp.asarray(q), jq, jnp.asarray(le)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)
    # a single-key row is its value row, dequantized
    for b in np.flatnonzero(le == 1):
        v0 = tq.v_q[b, :, 0].float() * tq.v_scale[b, :, 0, None]
        torch.testing.assert_close(got[b, :, 0], v0.repeat_interleave(H // Hkv, 0),
                                   rtol=1e-6, atol=1e-6)


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


# B3's kernel takes each of its two products (q k^T and P v) as six exact
# bf16 plane products (csrc/flash_attention.cu); flash_attention_planes_ref
# transcribes that arithmetic, held here against the JAX reference at the
# card test's tolerance.  (L, S, D, causal, with_bias, c): q and k are
# scaled by c, so that at c = 2 |q . k| reaches ~100.
B3_PLANE_CASES = [(128, 128, 64, True, False, 1.0), (64, 192, 64, True, False, 1.0),
                  (72, 200, 64, False, True, 1.0), (90, 130, 32, True, False, 1.0),
                  (33, 33, 32, False, True, 1.0), (128, 128, 64, True, False, 2.0),
                  (100, 160, 32, True, True, 2.0)]


@pytest.mark.parametrize("L,S,D,causal,with_bias,c", B3_PLANE_CASES)
def test_flash_attention_plane_products_match_jax_ref(L, S, D, causal, with_bias, c):
    rs = np.random.RandomState(14)
    B, H = 2, 3
    q, k, v = rand(rs, B, H, L, D, scale=c), rand(rs, B, H, S, D, scale=c), rand(rs, B, H, S, D)
    bias = rand(rs, B, H, L, S) if with_bias else None
    got = tfa.flash_attention_planes_ref(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v),
                                         None if bias is None else torch.from_numpy(bias),
                                         causal=causal)
    if c > 1:
        assert np.abs(np.einsum("bhld,bhsd->bhls", q, k)).max() > 90
    want = np.asarray(jfa.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), causal=causal,
    ))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-5)


def test_flash_attention_rejects_causal_with_fewer_keys():
    with pytest.raises(ValueError):
        tfa.flash_attention(torch.zeros(1, 8, 64), torch.zeros(1, 4, 64),
                            torch.zeros(1, 4, 64), causal=True)


# K/V of fewer heads than q (GQA): query head h reads KV head h // (H / Hkv),
# what the kernel's wgmma route reads per KV head and its other routes after
# the repeat.  (H, Hkv, L, S, causal): groups of 1, 2 and 8, a chunk with L
# < S, a non-causal call
GQA_CASES = [(4, 4, 33, 33, True), (4, 2, 40, 40, True), (8, 1, 24, 24, True),
             (4, 2, 16, 48, True), (6, 3, 20, 30, False)]


def _gqa_inputs(H, Hkv, L, S, D=128):
    rs = np.random.RandomState(21)
    return (torch.from_numpy(rand(rs, 2, H, L, D)), torch.from_numpy(rand(rs, 2, Hkv, S, D)),
            torch.from_numpy(rand(rs, 2, Hkv, S, D)))


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_ref",
                                "flash_attention_planes_ref"])
@pytest.mark.parametrize("H,Hkv,L,S,causal", GQA_CASES)
def test_attention_over_kv_heads_equals_the_repeated_call(fn, H, Hkv, L, S, causal):
    """flash_attention's plain path and both plain versions over Hkv KV heads
    give the call over K/V repeated to the H query heads, bit for bit."""
    q, k, v = _gqa_inputs(H, Hkv, L, S)
    f = getattr(tfa, fn)
    got = f(q, k, v, causal=causal)
    rep = H // Hkv
    want = f(q, k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1), causal=causal)
    assert got.shape == q.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("H,Hkv,chunk", [(4, 2, False), (8, 1, False), (4, 4, False),
                                         (4, 2, True), (8, 1, True)])
def test_flash_prefill_skips_the_repeat(H, Hkv, chunk):
    """flash_prefill and flash_chunked_prefill hand B3 the KV heads as they
    are (no repeat): the output equals flash_attention over the repeated
    K/V, and the cache holds the KV heads."""
    L = 24
    q, k, v = _gqa_inputs(H, Hkv, L, L)
    rep = H // Hkv
    cache = tkv.KVCache(2, Hkv, 64, 128, device="cpu")
    if chunk:  # a chunk at offset 16 over the prefix already in the cache
        pk, pv = (torch.from_numpy(rand(np.random.RandomState(5), 2, Hkv, 16, 128))
                  for _ in range(2))
        cache.update(pk, pv)
        got = tfa.flash_chunked_prefill(None, q, k, v, cache=cache, offset=16, transparent=True)
        kf, vf = torch.cat([pk, k], dim=2), torch.cat([pv, v], dim=2)
    else:
        got = tfa.flash_prefill(None, q, k, v, cache=cache, transparent=True)
        kf, vf = k, v
    want = tfa.flash_attention(q, kf.repeat_interleave(rep, dim=1),
                               vf.repeat_interleave(rep, dim=1), causal=True)
    assert torch.equal(got, want)
    assert torch.equal(cache.k[:, :, :kf.shape[2]], kf)


def test_wgmma_route_reads_kv_in_place():
    """The wgmma route's K/V view (``_per_kv_head``): v as the transposed
    view of a merged q/k/v projection is read in place through its strides;
    a view whose d is not contiguous, or whose rows leave 16-byte
    alignment, is copied."""
    B, T, H, Hkv, D = 2, 40, 4, 2, 128
    qkv = torch.randn(B, T, (H + 2 * Hkv) * D)
    v = qkv[..., (H + Hkv) * D:].reshape(B, T, Hkv, D).transpose(1, 2)
    v4, st = tfa._per_kv_head(v, Hkv)
    assert v4.data_ptr() == v.data_ptr() and st == (T * (H + 2 * Hkv) * D, D, (H + 2 * Hkv) * D)
    assert torch.equal(v4, v)
    for t in (v.transpose(-1, -2).contiguous().transpose(-1, -2),  # d strided
              qkv[..., 1:1 + Hkv * D].reshape(B, T, Hkv, D).transpose(1, 2)):  # off by 4 bytes
        t4, st = tfa._per_kv_head(t, Hkv)
        assert t4.is_contiguous() and torch.equal(t4, t)
        assert st == (Hkv * T * D, T * D, D)


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


@pytest.mark.parametrize("quantized", [False, True])
def test_cache_overflow_raises_where_jax_clamps(quantized):
    """A difference from the JAX package kept on purpose: an append past the
    capacity.  JAX writes through dynamic_update_slice, which clamps the
    start, so the new rows overwrite the last slots and its length runs past
    the capacity; the port raises ValueError before writing and keeps its
    buffers and length, so a decode loop that outgrows its cache stops
    instead of attending over overwritten keys."""
    rs = np.random.RandomState(23)
    B, H, S, D = 2, 3, 8, 4
    jcls, tcls = ((jkv.QuantizedKVCache, tkv.QuantizedKVCache) if quantized
                  else (jkv.KVCache, tkv.KVCache))
    jc, tc = jcls(B, H, S, D), tcls(B, H, S, D, device="cpu")
    first = rand(rs, B, H, 6, D)
    jc.update(jnp.asarray(first), jnp.asarray(first))
    tc.update(torch.from_numpy(first), torch.from_numpy(first))
    before = [t.clone() for t in ((tc.k_q, tc.k_scale) if quantized else (tc.k,))]
    extra = rand(rs, B, H, 4, D)
    jk, _, jlen = jc.update(jnp.asarray(extra), jnp.asarray(extra))
    assert int(jlen) == 10 > S  # JAX: the length runs past the capacity
    if not quantized:  # and the last 4 slots hold the new rows
        np.testing.assert_array_equal(np.asarray(jk)[:, :, S - 4:], extra)
    with pytest.raises(ValueError, match="cache overflow"):
        tc.update(torch.from_numpy(extra), torch.from_numpy(extra))
    assert tc.length == 6 and tc.lengths.tolist() == [6] * B
    after = (tc.k_q, tc.k_scale) if quantized else (tc.k,)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


# ---------------------------------------------------------------------------
# B5: sbfp_pack / sbfp_linear
# ---------------------------------------------------------------------------

SBFP = SBFP12_16


def sbfp_pair(w):
    jp = jpack.sbfp_pack(jnp.asarray(w), JFormat.from_shorthand(SBFP))
    tp = tpack.sbfp_pack(torch.from_numpy(w), TFormat.from_shorthand(SBFP))
    return jp, tp


def test_sbfp_pack_bit_exact_against_jax_and_the_cast():
    """tests/test_ops.py:200-215: an all-zero block and a x100 block.  The
    nibbles and scales equal the JAX package's bit for bit; unpacking gives
    the simulated cast's values.  The only bit difference from the cast is
    the sign of a zero: a mantissa that rounds to -0.0 in the cast packs as
    the integer 0 (no -0 in two's complement), in the JAX package too."""
    rs = np.random.RandomState(0)
    w = rand(rs, 32, 64, scale=0.3)
    w[0, :16] = 0.0
    w[1, 16:32] *= 100.0
    jp, tp = sbfp_pair(w)
    assert tp.nibbles.dtype == torch.uint8 and tp.nibbles.shape == (32, 32)
    assert tp.scale.shape == (32, 4) and tp.block_size == 16
    np.testing.assert_array_equal(tp.nibbles.numpy(), np.asarray(jp.nibbles))
    np.testing.assert_array_equal(tp.scale.numpy().view(np.uint32),
                                  np.asarray(jp.scale).view(np.uint32))
    assert not tp.scale[0, 0] and not tp.nibbles[0, :8].any()  # the all-zero block
    got = tpack.sbfp_unpack(tp).numpy()
    cast = TFormat.from_shorthand(SBFP).cast(torch.from_numpy(w), -1).numpy()
    np.testing.assert_array_equal(got, cast)
    np.testing.assert_array_equal((got + 0.0).view(np.uint32), (cast + 0.0).view(np.uint32))
    np.testing.assert_array_equal(got, np.asarray(jpack.sbfp_unpack(jp)))


def test_sbfp_nibble_order_and_sign_asymmetric():
    """Low nibble = even index, two's complement; every nibble 0..15 decodes
    (-8 included, though the packer never makes it), and the order is not
    symmetric, so a swapped pair would fail."""
    nib = np.arange(256, dtype=np.uint8).reshape(8, 32)
    want = np.asarray(jbl.sbfp_unpack_mantissa_int8(jnp.asarray(nib)))
    got = tbl.sbfp_unpack_mantissa_int8(torch.from_numpy(nib)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8 and got.shape == (8, 64)
    assert got[0, :6].tolist() == [0, 0, 1, 0, 2, 0] and got[0, 30:32].tolist() == [-1, 0]
    assert got[7, -2:].tolist() == [-1, -1] and got.min() == -8 and got.max() == 7
    # a ramp of weights packs to mantissas in index order
    w = np.tile(np.linspace(-1.0, 1.0, 16, dtype=np.float32), (2, 2))
    _, tp = sbfp_pair(w)
    man = tbl.sbfp_unpack_mantissa_int8(tp.nibbles).numpy()
    assert (np.diff(man[0, :16].astype(int)) >= 0).all() and man[0, 0] == -7 and man[0, 15] == 7


# tests/test_ops.py:301's shapes (M, N, K), then the SBFP leg's head shape cut
# to a small vocabulary, and a K that is not a multiple of 32
B5_SHAPES = [(8, 48, 80), (3, 33, 48), (130, 256, 160), (8, 100, 768), (5, 48, 80)]


@pytest.mark.parametrize("M,N,K", B5_SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_sbfp_linear_matches_jax_pallas_interpret(M, N, K, with_bias):
    """tests/test_ops.py:292-309, at its tolerance (atol 1e-5, rtol 1e-6)."""
    rs = np.random.RandomState(0)
    w = rand(rs, N, K, scale=0.3)
    x = rand(rs, M, K)
    b = rand(rs, N) if with_bias else None
    jp, tp = sbfp_pair(w)
    want = np.asarray(jbl.sbfp_linear(jnp.asarray(x), jp, None if b is None else jnp.asarray(b),
                                      use_pallas=True, interpret=True))
    before = dict(kernels.LAUNCHES)
    got = tbl.sbfp_linear(torch.from_numpy(x), tp, None if b is None else torch.from_numpy(b))
    assert kernels.LAUNCHES == before  # the plain version launches nothing
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    ref = np.asarray(jbl.sbfp_linear_ref(jnp.asarray(x), jp, None if b is None else jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_sbfp12_16_weights_are_exact_in_bfloat16():
    """B5's wgmma path stores the dequantized weight as bf16: an SBFP12_16
    weight (a mantissa in [-7, 7] times a scale of <= 5 significant bits)
    survives the round trip bit for bit, on random blocks at four scales,
    blocks at the scale format's largest and smallest values, all +-7
    blocks and an all-zero block.  The packer records that (bf16_exact); a
    scale format of 5 mantissa bits packs too, as in the JAX package, but
    is recorded as not exact, so B5 serves it from its f32 GEMM."""
    fmt = TFormat.from_shorthand(SBFP)
    rs = np.random.RandomState(12)
    blocks = [rand(rs, 64, 16, scale=s) for s in (1e-4, 0.05, 1.0, 300.0)]
    sweep = fmt.scaler_format.cast(torch.exp2(torch.arange(-60.0, 60.0)))
    big, small = sweep.max().item(), sweep[sweep > 0].min().item()
    for s in (big, small):
        blocks += [(rs.randint(-7, 8, (8, 16)) * s).astype(np.float32),
                   np.full((1, 16), 7 * s, np.float32), np.full((1, 16), -7 * s, np.float32)]
    blocks.append(np.zeros((1, 16), np.float32))
    w = np.concatenate(blocks)
    _, tp = sbfp_pair(w)
    assert tp.scale.max().item() == big and tp.scale[tp.scale > 0].min().item() == small
    deq = tpack.sbfp_unpack(tp)
    assert torch.equal(deq.bfloat16().float().view(torch.int32), deq.view(torch.int32))
    man = tbl.sbfp_unpack_mantissa_int8(tp.nibbles)
    assert man.max() == 7 and man.min() == -7 and not deq[-1].any()
    assert tp.bf16_exact and tbl.sbfp_tensor_cores(tp, w.shape[1])
    wide = tpack.sbfp_pack(torch.from_numpy(w), TFormat.from_shorthand(SBFP_WIDE_SCALE))
    assert not wide.bf16_exact and not tbl.sbfp_tensor_cores(wide, w.shape[1])
    wdeq = tpack.sbfp_unpack(wide)
    assert not torch.equal(wdeq.bfloat16().float().view(torch.int32), wdeq.view(torch.int32))


# the SBFP formats that the JAX package packs and serves beyond SBFP12_16:
# a scale of 5 mantissa bits (its dequantized weight is not exact in bf16),
# blocks of 8 and 24 (no multiple of 16), each at a K that the block divides
SBFP_WIDE_SCALE = "SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}"
SBFP_OTHER_FORMATS = [(SBFP_WIDE_SCALE, 64), (SBFP_WIDE_SCALE, 80),
                      ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{8}", 40),
                      ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{24}", 72)]


@pytest.mark.parametrize("fmt,K", SBFP_OTHER_FORMATS)
@pytest.mark.parametrize("M", [8, 130])
def test_sbfp_other_formats_pack_and_serve_as_in_jax(fmt, K, M):
    """The port packs what the JAX sbfp_pack packs, bit for bit (an all-zero
    block and a x100 block among them), records the payload as not served
    by B5's tensor cores, and its sbfp_linear (the plain version here, the
    f32 GEMM on the card) is within rtol 1e-5, atol 1e-4 of the JAX
    sbfp_linear_ref and of the JAX kernel in interpret mode."""
    rs = np.random.RandomState(22)
    N = 48
    w = rand(rs, N, K, scale=0.3)
    w[0, :8] = 0.0
    w[1, 8:16] *= 100.0
    x = rand(rs, M, K)
    b = rand(rs, N)
    jp = jpack.sbfp_pack(jnp.asarray(w), JFormat.from_shorthand(fmt))
    tp = tpack.sbfp_pack(torch.from_numpy(w), TFormat.from_shorthand(fmt))
    np.testing.assert_array_equal(tp.nibbles.numpy(), np.asarray(jp.nibbles))
    np.testing.assert_array_equal(tp.scale.numpy().view(np.uint32),
                                  np.asarray(jp.scale).view(np.uint32))
    assert tp.block_size == jp.block_size and not tbl.sbfp_tensor_cores(tp, K)
    got = tbl.sbfp_linear(torch.from_numpy(x), tp, torch.from_numpy(b)).numpy()
    ref = tbl.sbfp_linear_ref(torch.from_numpy(x), tp, torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    want = np.asarray(jbl.sbfp_linear_ref(jnp.asarray(x), jp, jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    kern = np.asarray(jbl.sbfp_linear(jnp.asarray(x), jp, jnp.asarray(b),
                                      use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("M,N,K", B5_SHAPES)
def test_sbfp_linear_three_plane_product_matches_ref_and_jax(M, N, K):
    """B5's product on the wgmma path: the three bf16 planes of x times the
    bf16 dequantized weight, each product exact, summed in f32 (+ bias),
    within rtol 1e-5, atol 1e-4 of sbfp_linear_ref and of the JAX
    sbfp_linear_ref; a seventh of x is scaled by 1e-3, so that the planes
    span more exponents."""
    rs = np.random.RandomState(13)
    w = rand(rs, N, K, scale=0.3)
    x = rand(rs, M, K)
    x[:, ::7] *= 1e-3
    b = rand(rs, N)
    jp, tp = sbfp_pair(w)
    wb = tpack.sbfp_unpack(tp).bfloat16().float()
    h, m, l = tbl.split_bf16x3_ref(torch.from_numpy(x))
    assert m.float().abs().max() > 0 and l.float().abs().max() > 0
    y = (h.float() @ wb.T + m.float() @ wb.T) + l.float() @ wb.T + torch.from_numpy(b)
    ref = tbl.sbfp_linear_ref(torch.from_numpy(x), tp, torch.from_numpy(b))
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-4)
    want = np.asarray(jbl.sbfp_linear_ref(jnp.asarray(x), jp, jnp.asarray(b)))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-4)


# B5's f32 route on the card: up to 16 rows a split-K f32 GEMV (the plain
# version's arithmetic, summed in another order); above, where K % 32 == 0
# and the block is a multiple of 16, the wgmma mainloop on three exact bf16
# planes of x times the weight's own exact bf16 planes (two up to a 12-bit
# scale mantissa, three beyond, six of the nine products kept); else the
# SIMT GEMM.  SBFP_PLANES_FORMATS: (shorthand, the planes the packer records)
SBFP_SCALE13 = "SBFP<XP[4,0](CSN)><FP[0|4|13,16](FN)>{16}"
SBFP_PLANES_FORMATS = [(SBFP_WIDE_SCALE, 2), ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{8}", 1),
                       ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{24}", 1),
                       ("SBFP<XP[4,0](CSN)><FP[0|5|12,16](FN)>{16}", 2), (SBFP_SCALE13, 3),
                       ("SBFP<XP[4,0](CSN)><FP[0|5|20,16](FN)>{32}", 3)]


@pytest.mark.parametrize("fmt,planes", SBFP_PLANES_FORMATS)
def test_sbfp_w_planes_sum_to_the_weight(fmt, planes):
    """The packer records the plane count that the format gives, and the
    weight's bf16 planes sum to sbfp_unpack(w) bit for bit (a zero block, a
    x100 block and blocks at 1e-3 among them), in f32, in plane order; with
    two planes recorded, a third would be zero everywhere."""
    rs = np.random.RandomState(25)
    N, K = 32, 96
    w = rand(rs, N, K, scale=0.3)
    w[0, :48] = 0.0
    w[1] *= 100.0
    w[2] *= 1e-3
    jp = jpack.sbfp_pack(jnp.asarray(w), JFormat.from_shorthand(fmt))
    tp = tpack.sbfp_pack(torch.from_numpy(w), TFormat.from_shorthand(fmt))
    np.testing.assert_array_equal(tp.nibbles.numpy(), np.asarray(jp.nibbles))
    np.testing.assert_array_equal(tp.scale.numpy().view(np.uint32),
                                  np.asarray(jp.scale).view(np.uint32))
    assert tp.planes == planes
    deq = tpack.sbfp_unpack(tp)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jpack.sbfp_unpack(jp)))
    pl = [p.float() for p in tbl.sbfp_w_planes_ref(tp, 3)]
    total = pl[0]
    for p in pl[1:max(2, planes)]:
        total = total + p
    assert torch.equal(total.view(torch.int32), (deq + 0.0).view(torch.int32))
    if planes <= 2:
        assert not pl[2].any()
    else:
        assert pl[2].any()


@pytest.mark.parametrize("fmt", [SBFP_WIDE_SCALE, "SBFP<XP[4,0](CSN)><FP[0|5|12,16](FN)>{32}",
                                 SBFP_SCALE13])
@pytest.mark.parametrize("M,N,K", [(40, 48, 64), (130, 100, 192)])
def test_sbfp_planes_product_matches_jax(fmt, M, N, K):
    """The planes route's product: each of x's three bf16 planes times each
    of the weight's (sbfp_weight_planes: 2, or 3 with the three products
    below 2^-20 |x| |w| dropped), summed in f32 (+ bias), against the JAX
    sbfp_linear_ref and the JAX kernel in interpret mode at B5's tolerance
    (rtol 1e-5, atol 1e-4); a seventh of x is scaled by 1e-3."""
    rs = np.random.RandomState(26)
    w = rand(rs, N, K, scale=0.3)
    x = rand(rs, M, K)
    x[:, ::7] *= 1e-3
    b = rand(rs, N)
    jp = jpack.sbfp_pack(jnp.asarray(w), JFormat.from_shorthand(fmt))
    tp = tpack.sbfp_pack(torch.from_numpy(w), TFormat.from_shorthand(fmt))
    P = tbl.sbfp_weight_planes(tp, K)
    assert P == max(2, tp.planes) and tbl.sbfp_route(tp, M, K) == "planes"
    xs = [p.float() for p in tbl.split_bf16x3_ref(torch.from_numpy(x))]
    ws = [p.float() for p in tbl.sbfp_w_planes_ref(tp, P)]
    y = torch.zeros(M, N)
    for i, xp in enumerate(xs):
        for j, wp in enumerate(ws):
            if P < 3 or i + j <= 2:
                y = y + xp @ wp.T
    y = y + torch.from_numpy(b)
    want = np.asarray(jbl.sbfp_linear_ref(jnp.asarray(x), jp, jnp.asarray(b)))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-4)
    kern = np.asarray(jbl.sbfp_linear(jnp.asarray(x), jp, jnp.asarray(b),
                                      use_pallas=True, interpret=True))
    np.testing.assert_allclose(y.numpy(), kern, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(y, tbl.sbfp_linear(torch.from_numpy(x), tp, torch.from_numpy(b)),
                               rtol=1e-5, atol=1e-4)


# (shorthand, plane count): bf16-exact (1; blocks of 8 and 24 too, which
# the tensor cores do not take), 5- and 12-bit scales (2), 13- and 23-bit
# (3); none where the scale grid falls below bf16's last subnormal bit
# (2^-133) or the scale cast never clips (8 exponent bits: 7 x the largest
# scale is not finite)
PLANE_COUNTS = [(SBFP, 1), (SBFP_OTHER_FORMATS[2][0], 1), (SBFP_OTHER_FORMATS[3][0], 1),
                (SBFP_WIDE_SCALE, 2), ("SBFP<XP[4,0](CSN)><FP[0|4|12,16](FN)>{16}", 2),
                (SBFP_SCALE13, 3), ("SBFP<XP[4,0](CSN)><FP[0|7|23,63](FN)>{16}", 3),
                ("SBFP<XP[3,0](CSN)><FP[0|4|5,16](FN)>{16}", 1),
                ("SBFP<XP[4,0](CSN)><FP[0|7|20,120](FN)>{16}", 0),
                ("SBFP<XP[4,0](CSN)><FP[0|8|5,127](FN)>{16}", 0)]


@pytest.mark.parametrize("fmt,planes", PLANE_COUNTS)
def test_sbfp_plane_count_and_route(fmt, planes):
    """sbfp_bf16_planes decides the plane count from the format; the route
    follows from it, M, K and the block: SBFP12_16 keeps its tensor-core
    kernels; any other payload takes the f32 GEMV up to 16 rows, the planes
    route above (K % 32 == 0, block of 16; one plane served as two) and the
    SIMT GEMM where neither applies (K % 32 != 0, a block of 8 or 24, no
    exact split).  K 96 and 48: multiples of every block here."""
    f = TFormat.from_shorthand(fmt)
    assert tpack.sbfp_bf16_planes(f) == planes
    w = tpack.sbfp_pack(torch.from_numpy(rand(np.random.RandomState(27), 8, 96)), f)
    assert w.planes == planes and w.bf16_exact == tpack.sbfp_bf16_exact(f)
    route = tbl.sbfp_route
    if tbl.sbfp_tensor_cores(w, 96):
        assert route(w, 8, 96) == "tensor_cores" and route(w, 17, 96) == "tensor_cores"
        assert route(w, 17, 48) == "simt" and tbl.sbfp_weight_planes(w, 96) == 0
        return
    assert route(w, 1, 96) == route(w, 16, 48) == "gemv"
    assert route(w, 17, 48) == "simt"
    if planes and w.block_size % 16 == 0:
        assert route(w, 17, 96) == "planes"
        assert tbl.sbfp_weight_planes(w, 96) == max(2, planes)
    else:
        assert route(w, 17, 96) == "simt" and tbl.sbfp_weight_planes(w, 96) == 0


def test_sbfp_linear_leading_dims_and_cpu_dispatch():
    rs = np.random.RandomState(1)
    jp, tp = sbfp_pair(rand(rs, 40, 64))
    x = rand(rs, 2, 3, 64)
    got = tbl.sbfp_linear(torch.from_numpy(x), tp)
    assert got.shape == (2, 3, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(jbl.sbfp_linear_ref(jnp.asarray(x), jp)),
                               rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        tbl.sbfp_linear(torch.from_numpy(x).to("meta"), tp)


# ---------------------------------------------------------------------------
# B4: flash_decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rep", [1, 4])
def test_flash_decode_matches_jax_pallas_interpret(rep):
    """tests/test_flash_decode.py:26-35: per-row lengths, GQA by rep."""
    rs = np.random.RandomState(6)
    B, H, S, D = 3, 8, 256, 64
    q = rand(rs, B, H, 1, D)
    k, v = rand(rs, B, H // rep, S, D), rand(rs, B, H // rep, S, D)
    lengths = np.array([17, 256, 130], np.int32)
    got = tfd.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(lengths)).numpy()
    want = np.asarray(jfd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(lengths), use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    ref = np.asarray(jfd.flash_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(lengths)))
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)


# B4 splits S into chunks of B4_CHUNK keys, one CUDA block each, and merges
# the chunks' (m, l, acc) in chunk order (csrc/flash_decode.cu);
# flash_decode_split_ref transcribes that arithmetic.  (B, H, Hkv, S, D,
# lengths): GQA with rep 4 and ragged rows (a single key, a multiple of the
# chunk, the full cache of three chunks), rows on either side of a chunk
# edge at D 32, a row of one chunk beside one of three at D 128, the
# baseline path's shape (lengths 160 in 256 slots, one chunk) at batch 3
_C = tfd.B4_CHUNK
B4_SPLIT_CASES = [(3, 8, 2, 3 * _C, 64, [1, _C, 3 * _C]),
                  (3, 4, 4, _C + 44, 32, [_C - 1, _C + 1, _C + 44]),
                  (2, 4, 1, 2 * _C + 60, 128, [77, 2 * _C + 60]),
                  (3, 12, 12, 256, 64, [160] * 3)]


@pytest.mark.parametrize("B,H,Hkv,S,D,lengths", B4_SPLIT_CASES)
def test_flash_decode_split_matches_jax(B, H, Hkv, S, D, lengths):
    """The split-and-merge transcription against the JAX flash_decode_ref and
    the JAX kernel in interpret mode (rtol 1e-5, atol 2e-6); on the CPU the
    port's wrapper runs the plain version, held the same way."""
    rs = np.random.RandomState(29)
    q = rand(rs, B, H, 1, D)
    k, v = rand(rs, B, Hkv, S, D), rand(rs, B, Hkv, S, D)
    le = np.array(lengths, np.int32)
    args = [jnp.asarray(a) for a in (q, k, v, le)]
    got = tfd.flash_decode_split_ref(*(torch.from_numpy(a) for a in (q, k, v, le))).numpy()
    ref = np.asarray(jfd.flash_decode_ref(*args))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-6)
    kern = np.asarray(jfd.flash_decode(*args, use_pallas=True, interpret=True))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=2e-6)
    plain = tfd.flash_decode(*(torch.from_numpy(a) for a in (q, k, v, le))).numpy()
    np.testing.assert_allclose(plain, ref, rtol=1e-5, atol=2e-6)
    # a single-key row is its value row
    for b in np.flatnonzero(le == 1):
        np.testing.assert_allclose(got[b, :, 0], np.repeat(v[b, :, 0], H // Hkv, 0),
                                   rtol=1e-6, atol=1e-6)


def test_flash_decode_scalar_length_d32():
    """tests/test_flash_decode.py:38-43: a scalar length at D 32, block 64."""
    rs = np.random.RandomState(7)
    B, H, S, D = 2, 4, 192, 32
    q, k, v = rand(rs, B, H, 1, D), rand(rs, B, H, S, D), rand(rs, B, H, S, D)
    got = tfd.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 100,
                           scale=0.3).numpy()
    want = np.asarray(jfd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 100,
                                       scale=0.3, use_pallas=True, interpret=True, block_k=64))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        tfd.flash_decode(torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 8, 32),
                         torch.zeros(1, 4, 8, 32), 3)
