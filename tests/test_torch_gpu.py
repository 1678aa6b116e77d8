"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need a CUDA device and skip without one.  They import neither
jax nor the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import pytest
import torch

from dmx_compressor_tpu_torch import kernels
from dmx_compressor_tpu_torch.ops import bfp_cast as T2
from dmx_compressor_tpu_torch.ops import bfp_linear as tbl
from dmx_compressor_tpu_torch.ops import bfp_pack as tpack
from dmx_compressor_tpu_torch.ops import flash_attention as tfa
from dmx_compressor_tpu_torch.ops import flash_decode as tfd
from dmx_compressor_tpu_torch.ops import kv_cache as tkv
from dmx_compressor_tpu_torch.numerics.format import Format
from dmx_compressor_tpu_torch.ops.compress import SBFP12_16

torch.set_num_threads(2)

# (M, N, K, block): odd shapes (block 8 takes the byte-load path), then
# OPT-125m's prefill fc1 and decode head; then the wgmma path's tile edges
# (M 17, 63, 64, 65, 129 about its 128-row tile; N 127 and 129 about its
# 128-feature tile), its K split (fc2 at M 1024, 3 splits; out_proj, 2), the
# fc2 decode shape and the decode kernel's second batch tile (M 9-16)
B1_SHAPES = [(8, 300, 128, 64), (8, 40, 1024, 16), (8, 256, 4096, 64), (8, 33, 80, 16),
             (5, 200, 192, 64), (3, 17, 72, 8), (1024, 3072, 768, 64), (8, 50272, 768, 64),
             (37, 96, 80, 16), (12, 10, 24, 8),
             (17, 127, 768, 64), (63, 129, 192, 64), (64, 768, 768, 64), (65, 129, 3072, 64),
             (129, 127, 256, 16), (8, 768, 3072, 64), (1024, 768, 3072, 64),
             (1024, 768, 768, 64), (16, 768, 3072, 64), (12, 129, 96, 32)]

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,B", B1_SHAPES)
def test_bfp_linear_kernel_matches_plain_on_card(cuda, M, N, K, B):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = tpack.bfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05, 8, B)
    x = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    n0 = kernels.LAUNCHES["bfp_linear"]
    got = tbl.bfp_linear(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bfp_linear"] == n0 + 1
    torch.testing.assert_close(got, tbl.bfp_linear_ref(x, w, b), rtol=1e-5, atol=1e-4)


def _extreme_x(g, M, K, device):
    """x near +-FLT_MAX (one per row, so no sum overflows against weights
    below 1), f32 subnormals, +-0.0, and a row each with an inf, a NaN and
    a NaN whose payload lies in its low bits."""
    x = torch.randn(M, K, generator=g, device=device)
    rows = torch.arange(M, device=device)
    fmax = torch.finfo(torch.float32).max
    x[rows, (7 * rows) % K] = torch.where(rows % 2 == 0, fmax, -fmax)
    x[:, 1::5] *= 1e-39
    x[:, 2::7] = -0.0
    x[1, 3], x[2, 9] = float("inf"), float("nan")
    x[3, 11] = torch.tensor(0x7F800001, dtype=torch.int32).view(torch.float32)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 200])
def test_bfp_linear_kernel_extreme_x_on_card(cuda, M):
    """_extreme_x: the three-plane decode kernel (M 8) and wgmma path (M
    200) give what the plain version gives."""
    N, K = 136, 768
    g = torch.Generator(device=cuda).manual_seed(5)
    w = tpack.bfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05, 8, 64)
    x = _extreme_x(g, M, K, cuda)
    got = tbl.bfp_linear(x, w)
    want = tbl.bfp_linear_ref(x, w)
    assert torch.isnan(got[2]).all() and torch.isnan(got[3]).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4, equal_nan=True)


# (B, H, Hkv, S, D, lengths): the first three with random lengths; then the
# main path's shape, bench.py's long shape (S 2048, lengths near 2016), every
# row a single key, GQA (12 query heads on 4 KV heads) with ragged rows, and
# rows of several 256-key chunks at each head_dim
B2_SHAPES = [(8, 12, 12, 200, 64, None), (2, 8, 4, 77, 128, None), (3, 4, 4, 33, 32, None),
             (8, 12, 12, 256, 64, [160] * 8), (8, 12, 12, 2048, 64, [2016 - i for i in range(8)]),
             (8, 12, 12, 256, 64, [1] * 8), (4, 12, 4, 300, 64, [1, 129, 256, 300]),
             (2, 32, 1, 1000, 128, [999, 513]), (4, 12, 4, 600, 64, [1, 200, 599, 600]),
             (2, 8, 8, 520, 128, [520, 64]), (3, 4, 2, 600, 32, [600, 257, 3]),
             (8, 16, 8, 256, 128, [160] * 8), (8, 8, 1, 256, 256, [160] * 8),
             (3, 8, 1, 600, 256, None), (2, 16, 1, 300, 256, [300, 1])]


def _b2_inputs(cuda, B, H, Hkv, S, D, lengths):
    g = torch.Generator(device=cuda).manual_seed(0)
    kq, ks = tkv.QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g, device=cuda))
    vq, vs = tkv.QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g, device=cuda))
    q = torch.randn(B, H, 1, D, generator=g, device=cuda)
    le = (torch.randint(1, S + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
          if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=cuda))
    return q, tkv.QuantKV(kq, vq, ks, vs), le


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D,lengths", B2_SHAPES)
def test_flash_decode_int8_kernel_matches_plain_on_card(cuda, B, H, Hkv, S, D, lengths):
    """Held to the plain version and to the split transcription; the merge
    tickets are left at zero."""
    q, kv, le = _b2_inputs(cuda, B, H, Hkv, S, D, lengths)
    n0 = kernels.LAUNCHES["flash_decode_int8"]
    got = tfd.flash_decode_int8(q, kv, le)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode_int8"] == n0 + 1
    torch.testing.assert_close(got, tfd.flash_decode_int8_ref(q, kv, le), rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(got, tfd.flash_decode_int8_split_ref(q, kv, le), rtol=1e-5,
                               atol=2e-5)
    # the chunks merge in chunk order: the same inputs give the same bits
    assert torch.equal(tfd.flash_decode_int8(q, kv, le), got)
    tickets = tfd._TICKETS.get(torch.device("cuda", torch.cuda.current_device()))
    assert tickets is None or not tickets.any()


# (B, H, L, S, D, causal, with_bias, c): ragged and bias cases, the main
# path's prefill (8 x 12 heads, L = S = 128, D 64), L and S no multiples of
# 16 or 64 (one key tile, one ragged 8-key group), and q, k scaled by c = 2
# so that |q . k| reaches ~100; then the wide kernel (head_dim 128 and 256):
# the Qwen3 and Gemma prefills (BH 128 and 64, L = S = 128), ragged, biased,
# non-causal and scaled cases
B3_SHAPES = [(4, 3, 128, 128, 64, True, False, 1.0), (4, 3, 48, 200, 64, True, True, 1.0),
             (4, 3, 70, 70, 64, False, False, 1.0), (4, 3, 90, 130, 32, True, False, 1.0),
             (4, 3, 33, 33, 32, False, True, 1.0), (8, 12, 128, 128, 64, True, False, 1.0),
             (2, 3, 7, 9, 64, True, False, 1.0), (2, 3, 13, 61, 32, False, True, 1.0),
             (2, 3, 77, 77, 64, True, True, 1.0), (8, 12, 128, 128, 64, True, False, 2.0),
             (2, 3, 100, 160, 32, True, True, 2.0),
             (8, 16, 128, 128, 128, True, False, 1.0), (8, 8, 128, 128, 256, True, False, 1.0),
             (2, 3, 7, 9, 128, True, False, 1.0), (2, 3, 77, 130, 256, True, True, 2.0),
             (2, 3, 50, 50, 128, False, False, 1.0), (1, 2, 200, 333, 256, False, True, 1.0),
             (2, 3, 90, 130, 128, True, True, 2.0), (8, 8, 128, 128, 256, True, False, 2.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,L,S,D,causal,with_bias,c", B3_SHAPES)
def test_flash_attention_kernel_matches_plain_on_card(cuda, B, H, L, S, D, causal, with_bias, c):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, H, L, D, generator=g, device=cuda) * c
    k = torch.randn(B, H, S, D, generator=g, device=cuda) * c
    v = torch.randn(B, H, S, D, generator=g, device=cuda)
    bias = torch.randn(B, H, L, S, generator=g, device=cuda) if with_bias else None
    n0 = kernels.LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == n0 + 1
    want = tfa.flash_attention_ref(q, k, v, bias, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


# B3's wgmma route (head_dim 128, f32, no bias; from WGMMA_MIN_KEYS keys, or
# WGMMA_MIN_KEYS_GQA over fewer KV heads): (B, H, Hkv, L, S, causal, c,
# route): Qwen3's scoring shape (one batch row: 16 heads over 8, L = S =
# 4096); L no multiple of 128 or of the 64-key tile; chunked prefills (L <
# S); non-causal; groups of 1, 2 and 8; q, k scaled by c = 2; then each
# threshold's two sides (S 143 / 144 over as many KV heads, 127 / 128 over
# fewer), the side below on today's wide kernel
WGMMA_SHAPES = [(1, 16, 8, 4096, 4096, True, 1.0, "wgmma"),
                (2, 4, 2, 1000, 1000, True, 1.0, "wgmma"),
                (2, 4, 4, 333, 333, True, 1.0, "wgmma"),
                (2, 8, 1, 96, 700, True, 1.0, "wgmma"),
                (2, 4, 2, 200, 1030, True, 2.0, "wgmma"),
                (2, 4, 2, 500, 777, False, 1.0, "wgmma"),
                (1, 16, 16, 1, 300, False, 1.0, "wgmma"),
                (2, 4, 2, 300, 300, True, 2.0, "wgmma"),
                (2, 4, 4, 143, 143, True, 1.0, None), (2, 4, 4, 144, 144, True, 1.0, "wgmma"),
                (2, 4, 2, 127, 127, True, 1.0, None), (2, 4, 2, 128, 128, True, 1.0, "wgmma")]


def _attention_ref_by_row(q, k, v, causal):
    """flash_attention_ref one batch row at a time (the [H, L, S] logits of
    Qwen3's 4096 positions are 1 GB a row)."""
    return torch.cat([tfa.flash_attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal)
                      for i in range(q.shape[0])])


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,L,S,causal,c,route", WGMMA_SHAPES)
def test_flash_attention_wgmma_route_matches_plain_on_card(cuda, B, H, Hkv, L, S, causal, c,
                                                           route):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, H, L, 128, generator=g, device=cuda) * c
    k = torch.randn(B, Hkv, S, 128, generator=g, device=cuda) * c
    v = torch.randn(B, Hkv, S, 128, generator=g, device=cuda)
    assert tfa.attention_route("flash_attention", H, Hkv, 128, (torch.float32,) * 3,
                               S=S) == route
    n0 = kernels.LAUNCHES["flash_attention"]
    r0 = kernels.ROUTE_LAUNCHES.get("flash_attention/wgmma", 0)
    got = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == n0 + 1
    assert kernels.ROUTE_LAUNCHES.get("flash_attention/wgmma", 0) == r0 + (route == "wgmma")
    torch.testing.assert_close(got, _attention_ref_by_row(q, k, v, causal), rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
def test_flash_attention_wgmma_route_reads_views_of_the_projection_on_card(cuda):
    """K and V as Qwen3's forward hands them (views of a merged q/k/v
    projection, heads transposed) are read in place through their strides,
    and a prefill chunk over a cache's prefix (a slice along S) too."""
    B, T, H, Hkv, D = 2, 300, 4, 2, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(B, T, (H + 2 * Hkv) * D, generator=g, device=cuda)
    q = qkv[..., :H * D].reshape(B, T, H, D).transpose(1, 2)
    k = qkv[..., H * D:(H + Hkv) * D].reshape(B, T, Hkv, D).transpose(1, 2)
    v = qkv[..., (H + Hkv) * D:].reshape(B, T, Hkv, D).transpose(1, 2)
    cache = torch.randn(2, B, Hkv, 512, D, generator=g, device=cuda)
    for kk, vv, L in ((k, v, T), (cache[0, :, :, :T], cache[1, :, :, :T], 100)):
        r0 = kernels.ROUTE_LAUNCHES.get("flash_attention/wgmma", 0)
        got = tfa.flash_attention(q[:, :, :L], kk, vv, causal=True)
        torch.cuda.synchronize()
        assert kernels.ROUTE_LAUNCHES["flash_attention/wgmma"] == r0 + 1
        want = tfa.flash_attention_ref(q[:, :, :L], kk, vv, causal=True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


def _hold_to_plain(got, want, dtype):
    """The kernels' tolerance (rtol 1e-5, atol 2e-5) on an f32 output; an
    output in a 16-bit dtype is the f32 result rounded once, so two f32
    results within that tolerance may land one step of the dtype apart:
    rtol its eps."""
    rtol = 1e-5 if dtype == torch.float32 else torch.finfo(dtype).eps
    assert got.dtype == want.dtype == dtype
    torch.testing.assert_close(got, want, rtol=rtol, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D", [(torch.float32, 100), (torch.bfloat16, 64),
                                     (torch.float16, 64), (torch.float32, 512), (None, 64)])
def test_flash_attention_kernel_raises_rather_than_falling_back(cuda, dtype, D):
    """Never the plain version on the card: a head_dim that is no multiple
    of 8 (100, zero-padded to 128), one above 256 (512, the generic kernel)
    and fp16 / bf16 q/k/v (f32 copies) launch the kernel once, by the route
    ``attention_route`` names, within the plain version's values in q's
    dtype; causal attention with S < L (dtype None here), which JAX does
    not compute either, raises before a launch."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q = torch.randn(2, 4, 16, D, generator=g, device=cuda).to(dtype or torch.float32)
    k, v = (torch.randn(2, 4, 16 if dtype else 8, D, generator=g, device=cuda).to(q.dtype)
            for _ in range(2))
    n0 = kernels.LAUNCHES["flash_attention"]
    if dtype is None:
        with pytest.raises(ValueError):
            tfa.flash_attention(q, k, v, causal=True)
        assert kernels.LAUNCHES["flash_attention"] == n0
        return
    route = tfa.attention_route("flash_attention", 1, 1, D, (dtype,) * 3)
    r0 = kernels.ROUTE_LAUNCHES.get(f"flash_attention/{route}", 0)
    got = tfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == n0 + 1
    if route is not None:
        assert kernels.ROUTE_LAUNCHES[f"flash_attention/{route}"] == r0 + 1
    _hold_to_plain(got, tfa.flash_attention_ref(q, k, v, causal=True), dtype)


# (M, N, K): ragged shapes (K = 48 and 80 are not multiples of 32: decode
# kernel below 17 rows, the f32 GEMM above), the SBFP leg's decode shapes
# and its head, fc1 at prefill; then the wgmma path's tile edges (M 17, 63,
# 64, 65, 129; N 127, 129), its K split (out_proj at M 1024, 2 splits; fc2,
# 3), the decode kernel's second batch tile (M 9-16), and K % 32 == 16 (the
# f32 GEMM) beside K % 32 == 0 at M > 16
B5_SHAPES = [(3, 33, 48), (130, 256, 160), (5, 48, 80), (8, 768, 768), (8, 3072, 768),
             (8, 768, 3072), (8, 50272, 768), (1024, 768, 3072),
             (17, 127, 768), (63, 129, 192), (64, 768, 768), (65, 129, 3072), (129, 127, 256),
             (1024, 768, 768), (1024, 3072, 768), (9, 768, 3072), (16, 768, 3072),
             (12, 129, 96), (40, 130, 208), (40, 130, 224)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", B5_SHAPES)
def test_sbfp_linear_kernel_matches_plain_on_card(cuda, M, N, K):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = tpack.sbfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05,
                        Format.from_shorthand(SBFP12_16))
    x = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    n0 = kernels.LAUNCHES["sbfp_linear"]
    got = tbl.sbfp_linear(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sbfp_linear"] == n0 + 1
    torch.testing.assert_close(got, tbl.sbfp_linear_ref(x, w, b), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 200])
def test_sbfp_linear_kernel_extreme_x_on_card(cuda, M):
    """B5's twin of the B1 test: _extreme_x through the three-plane decode
    kernel (M 8) and wgmma path (M 200) with the SBFP weight format."""
    N, K = 136, 768
    g = torch.Generator(device=cuda).manual_seed(6)
    w = tpack.sbfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05,
                        Format.from_shorthand(SBFP12_16))
    x = _extreme_x(g, M, K, cuda)
    got = tbl.sbfp_linear(x, w)
    want = tbl.sbfp_linear_ref(x, w)
    assert torch.isnan(got[2]).all() and torch.isnan(got[3]).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4, equal_nan=True)


# the SBFP formats beyond SBFP12_16 that the JAX package serves (a 5-bit
# scale: not exact in bf16, two weight planes; a 13-bit scale, three; blocks
# of 8 and 24): B5's f32 route, the GEMV up to 16 rows, the weight planes
# above where K % 32 == 0 and the block is a multiple of 16, else the SIMT
# GEMM; then K no multiple of 8 (one-byte loads) and K > 8192 (x tiled along
# K in the GEMV)
SBFP_OTHER = [("SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}", 768, 768),
              ("SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}", 3072, 768),
              ("SBFP<XP[4,0](CSN)><FP[0|4|13,16](FN)>{16}", 768, 768),
              ("SBFP<XP[4,0](CSN)><FP[0|4|13,16](FN)>{32}", 3072, 200),
              ("SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}", 80, 130),
              ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{8}", 40, 48),
              ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{24}", 72, 200),
              ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{8}", 768, 300),
              ("SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{2}", 46, 70),
              ("SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}", 9216, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,K,N", SBFP_OTHER)
@pytest.mark.parametrize("M", [1, 8, 16, 17, 1024])
def test_sbfp_linear_f32_route_other_formats_on_card(cuda, fmt, K, N, M):
    g = torch.Generator(device=cuda).manual_seed(7)
    w = tpack.sbfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05,
                        Format.from_shorthand(fmt))
    assert not tbl.sbfp_tensor_cores(w, K)
    route = tbl.sbfp_route(w, M, K)
    assert route == ("gemv" if M <= 16 else "planes" if tbl.sbfp_weight_planes(w, K) else "simt")
    x = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    n0 = kernels.LAUNCHES["sbfp_linear"]
    got = tbl.sbfp_linear(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sbfp_linear"] == n0 + 1
    torch.testing.assert_close(got, tbl.sbfp_linear_ref(x, w, b), rtol=1e-5, atol=1e-4)
    # the GEMV's K splits meet in rank order: the same bits again
    assert torch.equal(tbl.sbfp_linear(x, w, b), got)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", [(8, 768, 768), (8, 3072, 768), (8, 768, 3072),
                                   (1024, 768, 768), (1024, 768, 3072), (17, 127, 768)])
def test_sbfp12_16_keeps_its_tensor_core_routes_on_card(cuda, M, N, K):
    """SBFP12_16 stays on the tensor-core decode GEMV and wgmma mainloop
    (route 0) at the sbfp path's shapes, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(8)
    w = tpack.sbfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05,
                        Format.from_shorthand(SBFP12_16))
    assert w.bf16_exact and w.planes == 1 and tbl.sbfp_route(w, M, K) == "tensor_cores"
    x = torch.randn(M, K, generator=g, device=cuda)
    n0 = kernels.LAUNCHES["sbfp_linear"]
    got = tbl.sbfp_linear(x, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sbfp_linear"] == n0 + 1
    torch.testing.assert_close(got, tbl.sbfp_linear_ref(x, w), rtol=1e-5, atol=1e-4)


def _b4_inputs(cuda, B, H, Hkv, S, D, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn(B, H, 1, D, generator=g, device=cuda),
            torch.randn(B, Hkv, S, D, generator=g, device=cuda),
            torch.randn(B, Hkv, S, D, generator=g, device=cuda), g)


def _check_b4(q, k, v, lengths):
    """One launch, within rtol 1e-5 / atol 2e-5 of the plain version and
    of the split transcription, the same bits on a second call (the chunks
    merge in chunk order), the merge tickets left at zero."""
    n0 = kernels.LAUNCHES["flash_decode"]
    got = tfd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode"] == n0 + 1
    torch.testing.assert_close(got, tfd.flash_decode_ref(q, k, v, lengths), rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(got, tfd.flash_decode_split_ref(q, k, v, lengths), rtol=1e-5,
                               atol=2e-5)
    assert torch.equal(tfd.flash_decode(q, k, v, lengths), got)
    tickets = tfd._TICKETS.get(torch.device("cuda", torch.cuda.current_device()))
    assert tickets is None or not tickets.any()
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D,scalar", [
    (8, 12, 12, 256, 64, False), (3, 8, 2, 256, 64, False), (2, 4, 4, 192, 32, True),
    (2, 8, 8, 200, 128, False), (3, 12, 4, 77, 128, True), (2, 6, 6, 33, 32, False),
    (2, 64, 1, 300, 64, False), (2, 24, 1, 2500, 128, True), (3, 12, 4, 2500, 32, False),
    (2, 8, 2, 3000, 64, False), (8, 16, 8, 256, 128, False), (8, 8, 1, 256, 256, False),
    (3, 16, 1, 2500, 256, True), (2, 6, 3, 77, 256, False),
])
def test_flash_decode_kernel_matches_plain_on_card(cuda, B, H, Hkv, S, D, scalar):
    """Ragged rows, GQA (rep 3, 4, 24 and 64), scalar lengths, every
    head_dim, caches of one chunk and of three."""
    q, k, v, g = _b4_inputs(cuda, B, H, Hkv, S, D)
    lengths = (S * 2 // 3 if scalar else
               torch.randint(1, S + 1, (B,), generator=g, device=cuda, dtype=torch.int32))
    _check_b4(q, k, v, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_flash_decode_kernel_chunk_edges_and_long_on_card(cuda, D):
    """Rows ending at the chunk edges (CHUNK - 1, CHUNK, CHUNK + 1) and at S,
    then bench.py's long shape (batch 8, 12 heads, S 2048, lengths 2016) and
    one row of 8000 keys in 8192 slots."""
    C = tfd.B4_CHUNK
    S = 3 * C + 5
    q, k, v, _ = _b4_inputs(cuda, 4, 8, 4, S, D, seed=1)
    _check_b4(q, k, v, torch.tensor([C - 1, C, C + 1, S], dtype=torch.int32, device=cuda))
    q, k, v, _ = _b4_inputs(cuda, 8, 12, 12, 2048, D, seed=2)
    _check_b4(q, k, v, torch.full((8,), 2016, dtype=torch.int32, device=cuda))
    q, k, v, _ = _b4_inputs(cuda, 1, 12, 12, 8192, D, seed=4)
    _check_b4(q, k, v, torch.full((1,), 8000, dtype=torch.int32, device=cuda))


@pytest.mark.gpu
def test_flash_decode_b2_and_b4_interleaved_share_the_tickets_on_card(cuda):
    """B2 and B4 take their merge tickets from one buffer per device;
    launches of the two interleaved on one stream, each merging chunks,
    leave every result right and the tickets at zero."""
    B, H, Hkv, S, D = 4, 12, 4, 2 * tfd.B4_CHUNK + 100, 64
    le = torch.tensor([S, tfd.B4_CHUNK + 1, 257, 3], dtype=torch.int32, device=cuda)
    q, k, v, _ = _b4_inputs(cuda, B, H, Hkv, S, D, seed=3)
    q8, kv, le8 = _b2_inputs(cuda, B, H, Hkv, S, D, [S, 600, 255, 999])
    outs = []
    for _ in range(3):
        outs.append((tfd.flash_decode(q, k, v, le), tfd.flash_decode_int8(q8, kv, le8)))
    torch.cuda.synchronize()
    want, want8 = tfd.flash_decode_ref(q, k, v, le), tfd.flash_decode_int8_ref(q8, kv, le8)
    for got, got8 in outs:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
        torch.testing.assert_close(got8, want8, rtol=1e-5, atol=2e-5)
        assert torch.equal(got, outs[0][0]) and torch.equal(got8, outs[0][1])
    assert not tfd._TICKETS[torch.device("cuda", torch.cuda.current_device())].any()


@pytest.mark.gpu
@pytest.mark.parametrize("D,H,Hkv", [(100, 4, 1), (256, 32, 1), (136, 32, 1), (64, 5, 2)])
def test_flash_decode_int8_kernel_raises_outside_its_head_dims(cuda, D, H, Hkv):
    """Outside the main kernel's head dims and head groups, the kernel still
    launches once: a head_dim that is no multiple of 8 on the generic route,
    more than 16 query heads a KV head above head_dim 128 (the chunk's
    shared memory at 256, the width 136 runs at) on the grouped route,
    within the plain version's values; H % Hkv != 0, which JAX does not
    compute either, raises before a launch."""
    q, kv, le = _b2_inputs(cuda, 2, H, Hkv, 40, D, [40, 7])
    n0 = kernels.LAUNCHES["flash_decode_int8"]
    if H % Hkv:
        with pytest.raises(ValueError):
            tfd.flash_decode_int8(q, kv, le)
        assert kernels.LAUNCHES["flash_decode_int8"] == n0
        return
    route = tfa.attention_route("flash_decode_int8", H, Hkv, D)
    assert route == ("generic" if D % 8 else "grouped")
    r0 = kernels.ROUTE_LAUNCHES.get(f"flash_decode_int8/{route}", 0)
    got = tfd.flash_decode_int8(q, kv, le)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode_int8"] == n0 + 1
    assert kernels.ROUTE_LAUNCHES[f"flash_decode_int8/{route}"] == r0 + 1
    torch.testing.assert_close(got, tfd.flash_decode_int8_ref(q, kv, le), rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D,Hkv", [(torch.float16, 64, 4), (torch.float32, 84, 4),
                                         (torch.float32, 512, 4), (torch.float32, 64, 3)])
def test_flash_decode_kernel_raises_rather_than_falling_back(cuda, dtype, D, Hkv):
    """Never the plain version on the card: an fp16 cache (read as stored),
    a head_dim that is no multiple of 8 and one above 256 (the generic
    route) launch the kernel once, within the plain version's values; 4
    query heads over 3 KV heads, which JAX does not compute either, raises
    before a launch."""
    q = torch.randn(2, 4, 1, D, device=cuda)
    k = torch.randn(2, Hkv, 16, D, device=cuda, dtype=dtype)
    v = torch.randn(2, Hkv, 16, D, device=cuda, dtype=dtype)
    n0 = kernels.LAUNCHES["flash_decode"]
    if 4 % Hkv:
        with pytest.raises(ValueError):
            tfd.flash_decode(q, k, v, 8)
        assert kernels.LAUNCHES["flash_decode"] == n0
        return
    route = tfa.attention_route("flash_decode", 4, Hkv, D, (q.dtype, dtype, dtype))
    assert route == ("f16" if dtype == torch.float16 else "generic")
    got = tfd.flash_decode(q, k, v, 8)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode"] == n0 + 1
    torch.testing.assert_close(got, tfd.flash_decode_ref(q, k, v, 8), rtol=1e-5, atol=2e-5)


# head dims off the kernels' instantiated widths (32 / 64 / 128 / 256):
# OPT-2.7b's 80, 96 and 40 (below 64 and not a multiple of 16)
OFF_HEAD_DIMS = [80, 96, 40]


@pytest.mark.gpu
@pytest.mark.parametrize("D", OFF_HEAD_DIMS)
def test_flash_attention_kernel_takes_any_head_dim_multiple_of_8_on_card(cuda, D):
    """B3 over q, k, v zero-padded to the next width: one launch each, the
    plain version's values; causal at OPT-2.7b's prefill shape (32 heads,
    L = S = 128), and L < S with a bias."""
    g = torch.Generator(device=cuda).manual_seed(D)
    for B, H, L, S, with_bias in [(2, 32, 128, 128, False), (2, 3, 50, 90, True)]:
        q = torch.randn(B, H, L, D, generator=g, device=cuda)
        k, v = (torch.randn(B, H, S, D, generator=g, device=cuda) for _ in range(2))
        bias = torch.randn(B, H, L, S, generator=g, device=cuda) if with_bias else None
        n0 = kernels.LAUNCHES["flash_attention"]
        got = tfa.flash_attention(q, k, v, bias, causal=True)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["flash_attention"] == n0 + 1
        assert got.shape == q.shape
        torch.testing.assert_close(got, tfa.flash_attention_ref(q, k, v, bias, causal=True),
                                   rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("D", OFF_HEAD_DIMS)
def test_flash_decode_kernels_take_any_head_dim_multiple_of_8_on_card(cuda, D):
    """B4 and B2 with D taken at run time: one launch each, the plain
    versions' values, the same bits on a second call, the tickets left at
    zero; rows over one chunk and over several, GQA 4:1."""
    for B, H, Hkv, S, lengths in [(8, 32, 32, 256, [160] * 8),
                                  (3, 16, 4, 2500, [2500, 1025, 7])]:
        q, k, v, _ = _b4_inputs(cuda, B, H, Hkv, S, D, seed=D)
        _check_b4(q, k, v, torch.tensor(lengths, dtype=torch.int32, device=cuda))
        q8, kv, le8 = _b2_inputs(cuda, B, H, Hkv, S, D, lengths)
        n0 = kernels.LAUNCHES["flash_decode_int8"]
        got = tfd.flash_decode_int8(q8, kv, le8)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["flash_decode_int8"] == n0 + 1
        torch.testing.assert_close(got, tfd.flash_decode_int8_ref(q8, kv, le8), rtol=1e-5,
                                   atol=2e-5)
        assert torch.equal(tfd.flash_decode_int8(q8, kv, le8), got)
        assert not tfd._TICKETS[torch.device("cuda", torch.cuda.current_device())].any()


# (B, H, Hkv, S, D, lengths): the OPT path's decode shape, the Llama
# path's GQA, rows over several chunks, a head_dim off the widths (80, D
# at run time) and each width
HALF_B4_SHAPES = [(8, 12, 12, 256, 64, [160] * 8), (8, 32, 4, 256, 64, [160] * 8),
                  (3, 16, 4, 2500, 128, [2500, 1025, 7]), (2, 8, 8, 300, 80, [300, 1]),
                  (2, 4, 4, 200, 32, [200, 17]), (2, 8, 1, 1100, 256, [1100, 1024])]


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,lengths", HALF_B4_SHAPES)
def test_flash_decode_kernel_reads_a_16_bit_cache_on_card(cuda, kv_dtype, B, H, Hkv, S, D,
                                                          lengths):
    """B4 over an fp16 / bf16 cache read as stored: each launch by the f16 /
    bf16 route; an f32 q's output within rtol 1e-5 / atol 2e-5 of the plain
    version and of the split transcription (widening is exact, the sums
    f32), the same bits again, the tickets at zero; a q in the cache's dtype
    gets the plain version's output in that dtype."""
    q, k, v, _ = _b4_inputs(cuda, B, H, Hkv, S, D, seed=D)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    le = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    key = "flash_decode/" + ("f16" if kv_dtype == torch.float16 else "bf16")
    r0 = kernels.ROUTE_LAUNCHES.get(key, 0)
    _check_b4(q, k, v, le)
    assert kernels.ROUTE_LAUNCHES[key] == r0 + 2
    qh = q.to(kv_dtype)
    _hold_to_plain(tfd.flash_decode(qh, k, v, le), tfd.flash_decode_ref(qh, k, v, le), kv_dtype)


# (B, H, Hkv, S, D, lengths) of B2's grouped route: StarCoder's 48 query
# heads over 1 at D 128 (two groups of 24), 64 over 1 at D 64 (two of 32),
# Falcon-7B's 71 over 1 (24, 24, 23), 24 over 1 at D 256 (two of 12) and
# 40 over 2 at D 136 (14, 14, 12 a KV head); rows over one chunk
# and several
GROUPED_B2_SHAPES = [(2, 48, 1, 600, 128, [600, 255]), (8, 64, 1, 256, 64, [160] * 8),
                     (2, 64, 1, 600, 64, [599, 7]), (2, 71, 1, 300, 64, [300, 256]),
                     (2, 24, 1, 300, 256, [300, 1]), (3, 80, 2, 520, 136, [520, 64, 257])]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D,lengths", GROUPED_B2_SHAPES)
def test_flash_decode_int8_grouped_route_on_card(cuda, B, H, Hkv, S, D, lengths):
    """More query heads a KV head than one block of B2 takes: one launch by
    the grouped route, within rtol 1e-5 / atol 2e-5 of the plain version and
    of the split transcription, the same bits again, the tickets at zero."""
    q, kv, le = _b2_inputs(cuda, B, H, Hkv, S, D, lengths)
    assert tfa.attention_route("flash_decode_int8", H, Hkv, D) == "grouped"
    r0 = kernels.ROUTE_LAUNCHES.get("flash_decode_int8/grouped", 0)
    got = tfd.flash_decode_int8(q, kv, le)
    torch.cuda.synchronize()
    assert kernels.ROUTE_LAUNCHES["flash_decode_int8/grouped"] == r0 + 1
    torch.testing.assert_close(got, tfd.flash_decode_int8_ref(q, kv, le), rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(got, tfd.flash_decode_int8_split_ref(q, kv, le), rtol=1e-5,
                               atol=2e-5)
    assert torch.equal(tfd.flash_decode_int8(q, kv, le), got)
    assert not tfd._TICKETS[torch.device("cuda", torch.cuda.current_device())].any()


# head dims the decode kernels take on their generic route: 100 and 84 (a
# row 4-byte aligned in f32), 99 (a bf16 row 2-byte aligned, an int8 row
# byte aligned) and 512
GENERIC_HEAD_DIMS = [100, 84, 99, 512]


@pytest.mark.gpu
@pytest.mark.parametrize("D", GENERIC_HEAD_DIMS)
def test_decode_kernels_generic_route_on_card(cuda, D):
    """B4 over f32 and bf16 caches and B2 on the generic route: one launch
    each by the generic route, within rtol 1e-5 / atol 2e-5 of the plain
    versions, the same bits again, the tickets at zero; rows over one chunk
    and several, 32 heads and GQA 12:1 (each KV head's 12 query heads in
    groups of 8 and 4)."""
    for B, H, Hkv, S, lengths in [(8, 32, 32, 256, [160] * 8),
                                  (3, 24, 2, 700, [700, 257, 3])]:
        q, k, v, _ = _b4_inputs(cuda, B, H, Hkv, S, D, seed=D)
        le = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        for dt in (torch.float32, torch.bfloat16):
            r0 = kernels.ROUTE_LAUNCHES.get("flash_decode/generic", 0)
            _check_b4(q, k.to(dt), v.to(dt), le)
            assert kernels.ROUTE_LAUNCHES["flash_decode/generic"] == r0 + 2
        q8, kv, le8 = _b2_inputs(cuda, B, H, Hkv, S, D, lengths)
        r0 = kernels.ROUTE_LAUNCHES.get("flash_decode_int8/generic", 0)
        got = tfd.flash_decode_int8(q8, kv, le8)
        torch.cuda.synchronize()
        assert kernels.ROUTE_LAUNCHES["flash_decode_int8/generic"] == r0 + 1
        torch.testing.assert_close(got, tfd.flash_decode_int8_ref(q8, kv, le8), rtol=1e-5,
                                   atol=2e-5)
        assert torch.equal(tfd.flash_decode_int8(q8, kv, le8), got)
        assert not tfd._TICKETS[torch.device("cuda", torch.cuda.current_device())].any()


@pytest.mark.gpu
@pytest.mark.parametrize("D", [512, 300, 257])
def test_flash_attention_generic_kernel_on_card(cuda, D):
    """B3 above head_dim 256: one launch by the generic route, within rtol
    1e-5 / atol 2e-5 of the plain version; causal at L = S over two key
    tiles, L < S with a bias, non-causal and ragged."""
    g = torch.Generator(device=cuda).manual_seed(D)
    for B, H, L, S, causal, with_bias in [(2, 4, 128, 128, True, False),
                                          (2, 3, 50, 90, True, True),
                                          (1, 2, 33, 70, False, True)]:
        q = torch.randn(B, H, L, D, generator=g, device=cuda)
        k, v = (torch.randn(B, H, S, D, generator=g, device=cuda) for _ in range(2))
        bias = torch.randn(B, H, L, S, generator=g, device=cuda) if with_bias else None
        r0 = kernels.ROUTE_LAUNCHES.get("flash_attention/generic", 0)
        got = tfa.flash_attention(q, k, v, bias, causal=causal)
        torch.cuda.synchronize()
        assert kernels.ROUTE_LAUNCHES["flash_attention/generic"] == r0 + 1
        torch.testing.assert_close(got, tfa.flash_attention_ref(q, k, v, bias, causal=causal),
                                   rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 80, 128, 512])
@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.bfloat16, torch.bfloat16),
                                              (torch.float16, torch.float16),
                                              (torch.float32, torch.bfloat16),
                                              (torch.float32, torch.float16)])
def test_flash_attention_16_bit_operands_on_card(cuda, D, q_dtype, kv_dtype):
    """B3 with 16-bit operands: 16-bit q/k/v, and an f32 q over 16-bit K/V
    (a chunked prefill over a 16-bit cache: 32 queries over 96 keys,
    causal), with a bias in q's dtype: one launch, the plain version's
    output in q's dtype (_hold_to_plain)."""
    g = torch.Generator(device=cuda).manual_seed(D)
    q = torch.randn(2, 4, 32, D, generator=g, device=cuda).to(q_dtype)
    k, v = (torch.randn(2, 4, 96, D, generator=g, device=cuda).to(kv_dtype) for _ in range(2))
    bias = torch.randn(2, 4, 32, 96, generator=g, device=cuda).to(q_dtype)
    n0 = kernels.LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, bias, causal=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == n0 + 1
    _hold_to_plain(got, tfa.flash_attention_ref(q, k, v, bias, causal=True), q_dtype)


@pytest.mark.gpu
def test_checkpoint_written_by_torch_save_loads_on_card_bit_for_bit(cuda, tmp_path):
    """A local HF checkpoint (OPT, ``pytorch_model.bin`` by torch.save) loads
    through ``model_from_checkpoint`` onto the card: no key unmatched, every
    parameter its tensor bit for bit."""
    import json

    from dmx_compressor_tpu_torch.modeling.hf import model_from_checkpoint

    cfg = dict(model_type="opt", vocab_size=512, hidden_size=160, ffn_dim=320,
               num_hidden_layers=2, num_attention_heads=2, max_position_embeddings=64)
    g = torch.Generator().manual_seed(3)
    tensors = {"model.decoder.embed_tokens.weight": torch.randn(512, 160, generator=g),
               "model.decoder.embed_positions.weight": torch.randn(66, 160, generator=g),
               "model.decoder.final_layer_norm.weight": torch.randn(160, generator=g),
               "model.decoder.final_layer_norm.bias": torch.randn(160, generator=g)}
    for i in range(2):
        p = f"model.decoder.layers.{i}"
        for name, shape in [("self_attn.q_proj", (160, 160)), ("self_attn.k_proj", (160, 160)),
                            ("self_attn.v_proj", (160, 160)), ("self_attn.out_proj", (160, 160)),
                            ("fc1", (320, 160)), ("fc2", (160, 320))]:
            tensors[f"{p}.{name}.weight"] = torch.randn(*shape, generator=g)
            tensors[f"{p}.{name}.bias"] = torch.randn(shape[0], generator=g)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            tensors[f"{p}.{name}.weight"] = torch.randn(160, generator=g)
            tensors[f"{p}.{name}.bias"] = torch.randn(160, generator=g)
    torch.save(tensors, str(tmp_path / "pytorch_model.bin"))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    model, missed = model_from_checkpoint(str(tmp_path))
    assert missed == []
    own = dict(model.named_parameters())
    assert set(own) == set(tensors)
    for k, v in tensors.items():
        assert own[k].is_cuda and torch.equal(own[k].cpu(), v), k


# T1 (M, N, K, block): the BASIC path's decode and prefill shapes, T1's own
# TPU shapes at M = 8 (K 8192 and N 50272 among them), a ragged tile on the
# prefill path, and K or block no multiple of 16 (the scalar-load path); then
# the tile edges of the wgmma path (M 17, 63, 64, 65, 129; N 127, 129), the
# decode kernel's second batch tile (M 9-16) and its K split at fc2 (8 x 3072
# x 768: 6 splits) beside the prefill's (1024 x 3072 x 768: 3 splits)
T1_SHAPES = [(8, 2304, 768, 64), (8, 768, 3072, 64), (8, 50272, 768, 64), (1024, 3072, 768, 64),
             (1024, 768, 3072, 64), (8, 2048, 8192, 64), (8, 50272, 2048, 64),
             (130, 200, 192, 64), (17, 96, 80, 16), (3, 40, 72, 8), (37, 130, 72, 8),
             (17, 127, 768, 64), (63, 129, 192, 64), (64, 768, 768, 64), (65, 2304, 768, 64),
             (129, 127, 3072, 64), (16, 768, 3072, 64), (12, 129, 96, 32), (1, 127, 768, 64),
             (1024, 768, 768, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,B", T1_SHAPES)
def test_bfp_linear_bf16_kernel_matches_plain_on_card(cuda, M, N, K, B):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = tpack.bfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05, 8, B)
    x = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    n0 = kernels.LAUNCHES["bfp_linear_bf16"]
    got = tbl.bfp_linear_bf16(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bfp_linear_bf16"] == n0 + 1
    torch.testing.assert_close(got, tbl.bfp_linear_bf16_ref(x, w, b), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K,B", [(8, 768, 3072, 64), (1024, 768, 768, 64), (37, 130, 72, 8)])
def test_bfp_linear_bf16_epilogues_on_card(cuda, M, N, K, B):
    """The FLOAT16 output and ResAdd-FLOAT16 epilogues: where the f32 sums
    differ in their last bit at a rounding boundary, the FLOAT16 output lands
    one fp16 step of itself apart, and the ResAdd output one fp16 step of
    the largest product output (the residual may cancel it)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    w = tpack.bfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05, 8, B)
    x = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    res = torch.randn(M, N, generator=g, device=cuda).half().float()
    y16 = tbl.bfp_linear_bf16_ref(x, w, b, out_fp16=True)
    step = 2.0 ** (torch.floor(torch.log2(y16.abs().max())).item() - 10)
    for kw, tol in (({"out_fp16": True}, dict(rtol=2.0**-10, atol=2.0**-14)),
                    ({"out_fp16": True, "residual": res}, dict(rtol=0, atol=step))):
        got = tbl.bfp_linear_bf16(x, w, b, **kw)
        assert torch.equal(got, got.half().float())  # on the fp16 grid
        torch.testing.assert_close(got, tbl.bfp_linear_bf16_ref(x, w, b, **kw), **tol)


@pytest.mark.gpu
def test_bfp_linear_bf16_keeps_subnormal_weights_on_card(cuda):
    """A weight row of f32 subnormals (man * 2^-133 and up, bf16 subnormals
    too): the tensor cores must not flush it."""
    g = torch.Generator(device=cuda).manual_seed(2)
    wf = torch.randn(64, 256, generator=g, device=cuda) * 0.05
    wf[5] *= 2e-38
    w = tpack.bfp_pack(wf, 8, 64)
    x = torch.randn(8, 256, generator=g, device=cuda) * 1e3
    got, want = tbl.bfp_linear_bf16(x, w), tbl.bfp_linear_bf16_ref(x, w)
    assert int(w.exponent[5].min()) == -127 and (want[:, 5] != 0).all()
    torch.testing.assert_close(got[:, 5], want[:, 5], rtol=1e-5, atol=0)


def _special_blocks():
    """Ten blocks of 64: random at four scales, zero, +-0.0, f32 subnormals,
    one whose max rounds up to 2^(e+1) and clamps, one at the clamp edge,
    one whose max is 2^126 (the rebase constant overflows to inf: NaN out,
    as in the plain version)."""
    g = torch.Generator().manual_seed(3)
    blocks = [torch.randn(64, generator=g) * s for s in (1.0, 1e-3, 3e4, 1e-30)]
    blocks += [torch.zeros(64), torch.zeros(64).index_fill_(0, torch.arange(0, 64, 2), -0.0),
               torch.randn(64, generator=g) * 1e-39]
    for i, v in ((5, 1.9999), (9, -(2 - 2.0**-7)), (0, 2.0**126)):
        b = torch.rand(64, generator=g) * 2 - 1
        b[i] = v
        blocks.append(b)
    return torch.cat(blocks)


def _same_bits(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


# (shape, axis): the BASIC path's cast sites, an S-blocked V, a k^T view
# blocked along its rows, blocks of 32 and 256, and the special blocks; an
# inner axis of 512 (a 256-block is taller than the tile kernel keeps in
# registers) and an operand that is not on a 16-byte boundary (the scalar
# paths)
T2_SITES = [((8, 768), -1), ((8, 3072), -1), ((8, 12, 1, 64), -1), ((8, 12, 64, 64), -1),
            ((8, 12, 1, 192), -1), ((8, 12, 64, 64), -2), ((1024, 768), -1),
            ((8, 12, 128, 128), -1), ((3, 5, 64, 7), -2), ("kT", -2), ("special", -1),
            ("special_inner", -2), ((2, 3, 512, 8), -2), ("unaligned", -1)]


@pytest.mark.gpu
@pytest.mark.parametrize("site", range(len(T2_SITES)))
@pytest.mark.parametrize("block", [64, 32, 256])
def test_bfp_cast_kernel_matches_plain_bit_for_bit_on_card(cuda, site, block):
    shape, axis = T2_SITES[site]
    g = torch.Generator(device=cuda).manual_seed(site)
    if shape == "kT":
        x = torch.randn(8, 12, 64, 256, generator=g, device=cuda).transpose(-1, -2)
    elif shape == "special":
        x = _special_blocks().to(cuda).reshape(5, 128)
    elif shape == "special_inner":
        x = _special_blocks().to(cuda).reshape(2, 5, 64).transpose(1, 2).contiguous()
    elif shape == "unaligned":
        x = torch.randn(8 * 768 + 1, generator=g, device=cuda)[1:].view(8, 768)
    else:
        x = torch.randn(shape, generator=g, device=cuda) * torch.exp(
            3 * torch.randn(shape, generator=g, device=cuda))
    if x.shape[axis] % block:
        pytest.skip(f"axis of {x.shape[axis]} is no multiple of the block {block}")
    n0 = kernels.LAUNCHES["bfp_cast"]
    got = T2.bfp_cast(x, 8, block, axis)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bfp_cast"] == n0 + 1
    _same_bits(got, T2.bfp_cast_ref(x, 8, block, axis))
    _same_bits(T2.fp16_cast(x), T2.fp16_cast_ref(x))


@pytest.mark.gpu
@pytest.mark.parametrize("probe", list("abcdefgh"))
def test_bfp_cast_probe_matches_plain_bit_for_bit_on_card(cuda, probe):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(8, 768, generator=g, device=cuda) * (8.0 if probe == "d" else 3.0)
    if probe == "h":
        x = x[:, :12].contiguous()
    _same_bits(T2.probe(probe, x), T2.probe_ref(probe, x))


# (shape, axis): the composed FLOAT16-then-BFP cast at the fused decode
# step's sites (LN output -> qkv / fc1 input, softmax output -> weights),
# the prefill's scores, the tile kernel at tail v, the special blocks along
# both axes and an inner axis that is no multiple of 4
T2_COMPOSED = [((8, 768), -1), ((8, 12, 1, 192), -1), ((8, 12, 128, 128), -1),
               ((8, 12, 64, 64), -2), ("special", -1), ("special_inner", -2),
               ((3, 5, 64, 7), -2), ((8, 3072), -1)]


@pytest.mark.gpu
@pytest.mark.parametrize("site", range(len(T2_COMPOSED)))
def test_bfp_cast_composed_matches_plain_bit_for_bit_on_card(cuda, site):
    shape, axis = T2_COMPOSED[site]
    g = torch.Generator(device=cuda).manual_seed(10 + site)
    if shape == "special":
        x = _special_blocks().to(cuda).reshape(5, 128) * 3e4
    elif shape == "special_inner":
        x = _special_blocks().to(cuda).reshape(2, 5, 64).transpose(1, 2).contiguous()
    else:
        x = torch.randn(shape, generator=g, device=cuda) * torch.exp(
            3 * torch.randn(shape, generator=g, device=cuda))
    n0 = kernels.LAUNCHES["bfp_cast"]
    got = T2.bfp_cast(x, 8, 64, axis, fp16_first=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bfp_cast"] == n0 + 1
    _same_bits(got, T2.bfp_cast_ref(T2.fp16_cast_ref(x), 8, 64, axis))
    _same_bits(got, T2.bfp_cast(T2.fp16_cast(x), 8, 64, axis))


# ---------------------------------------------------------------------------
# the continuous-batching engine on the card
# ---------------------------------------------------------------------------

# a tiny OPT whose head_dim (64) the decode and prefill kernels take
ENGINE_CFG = dict(vocab_size=512, hidden_size=128, ffn_dim=256, num_hidden_layers=2,
                  num_attention_heads=2, max_position_embeddings=256)
# tokens are held where isolated generation's top-1/top-2 margin exceeds
# this: the engine's bucket prefill and batched decode sum in another order,
# and an int8 cache entry that rounds one step apart moves later logits
ENGINE_TOL = 1e-2


def _isolated_on_card(model, prompt, n_new, quantized, max_len, dev):
    from dmx_compressor_tpu_torch.models.opt import greedy_decode, greedy_prefill

    caches = model.init_cache(1, max_len, quantized=quantized, device=dev)
    logits, tok = greedy_prefill(model, caches, torch.from_numpy(prompt[None]).to(dev))
    toks, rows = greedy_decode(model, caches, tok, int(prompt.size), n_new - 1)
    top2 = torch.cat([logits[:, -1], rows[:, 0]]).topk(2, dim=-1).values
    return [int(tok[0])] + toks[0].tolist(), (top2[:, 0] - top2[:, 1]).tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("mode,chunk", [("raw", None), ("weights", None), ("weights", 8)])
def test_engine_matches_isolated_generation_on_card(cuda, mode, chunk):
    """A tiny engine on the card (3 slots, bursts of 4, mixed prompt
    lengths, slot reuse, idle rows past max_len) against isolated generation
    on the card; its kernels launched, and a steady dispatch makes no host
    sync."""
    import numpy as np
    from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode
    from dmx_compressor_tpu_torch.serving import ContinuousBatchingEngine

    with torch.no_grad():
        model = OPTForCausalLM(OPTConfig(**ENGINE_CFG), device=cuda, seed=0)
        if mode == "weights":
            build_weights_mode(model)
    quantized = mode == "weights"
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 512, (n,)).astype(np.int32), g)
            for n, g in ((5, 58), (30, 6), (17, 4), (9, 8), (24, 5))]
    max_len = 64
    eng = ContinuousBatchingEngine(model, max_slots=3, max_len=max_len, prompt_buckets=(16, 32),
                                   quantized_kv=quantized, prefill_chunk=chunk)
    real, synced = eng._dispatch, []

    def dispatch(burst, sampling):
        if synced or eng.last_step_admissions or eng.last_step_chunks:
            return real(burst, sampling)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(burst, sampling)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            synced.append(True)

    eng._dispatch = dispatch
    kernels.reset_launches()
    rids = [eng.submit(p, max_new_tokens=g) for p, g in reqs]
    res = {r.request_id: r for r in eng.run(burst=4)}
    assert synced
    decode = "flash_decode_int8" if quantized else "flash_decode"
    assert kernels.LAUNCHES[decode] > 0 and kernels.LAUNCHES["flash_attention"] > 0
    assert (kernels.LAUNCHES["bfp_linear"] > 0) == quantized
    assert max(eng.caches[0].lengths.tolist()) > max_len  # an idle row ran past the cache
    for rid, (p, g) in zip(rids, reqs):
        want, margins = _isolated_on_card(model, p, g, quantized, max_len, cuda)
        assert res[rid].finish_reason == "length" and len(res[rid].tokens) == g
        for s, (a, b) in enumerate(zip(res[rid].tokens, want)):
            if margins[s] <= ENGINE_TOL:
                break
            assert a == b, f"request {rid}, token {s}"


# ---------------------------------------------------------------------------
# 16-bit float caches on the card
# ---------------------------------------------------------------------------

# tiny OPT (4 heads of 32) and Llama (4 query heads over 2 KV heads of 32)
HALF_CFG = {"opt": dict(vocab_size=512, hidden_size=128, ffn_dim=256, num_hidden_layers=2,
                        num_attention_heads=4, max_position_embeddings=256),
            "llama": dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=256)}
# logits, card against CPU over a 16-bit cache: f32 sums in another order,
# and a K/V entry whose f32 values, a few ulp apart on the two devices, round
# one 16-bit step apart (as an int8 entry one step apart: ENGINE_TOL)
HALF_TOL = 1e-2


def _half_model(family, device, **cfg):
    from dmx_compressor_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM

    cls, cfg_cls = {"opt": (OPTForCausalLM, OPTConfig),
                    "llama": (LlamaForCausalLM, LlamaConfig)}[family]
    with torch.no_grad():
        return cls(cfg_cls(**HALF_CFG[family], **cfg), device=device, seed=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("family", ["opt", "llama"])
def test_half_cache_model_on_card_matches_cpu(cuda, family, kv_dtype):
    """A tiny f32 model over a 16-bit float cache (``init_cache(dtype=...)``,
    the cache ``model_from_checkpoint(dtype=...)`` gives) on the card: a
    prefill of 24 (one B3 a layer), a second chunk of 8 (Llama's through
    ``flash_chunked_prefill``: one B3 a layer over the cache's 16-bit K/V,
    by the upcast route; OPT's through its modular sdpa) and 4 greedy steps
    (one B4 a layer each, by the f16 / bf16 route).  Its logits within
    HALF_TOL of the same model's on the CPU (the plain versions) over the
    card's tokens, and each token the CPU's where the CPU's top-2 margin
    exceeds HALF_TOL."""
    from dmx_compressor_tpu_torch.models.shared import greedy_token

    model = _half_model(family, cuda)
    L = model.cfg.num_hidden_layers
    B, P, C, steps = 2, 24, 8, 4
    ids = torch.randint(0, 512, (B, P + C), generator=torch.Generator().manual_seed(5))

    def run(dev, toks=None):
        caches = model.init_cache(B, 64, dtype=kv_dtype, device=dev)
        assert caches[0].k.dtype == kv_dtype
        rows, chosen = [], []
        with torch.no_grad():
            model(ids[:, :P].to(dev), caches=caches, position_offset=0)
            rows.append(model(ids[:, P:].to(dev), caches=caches, position_offset=P)[:, -1])
            for i in range(steps):
                tok = greedy_token(rows[-1]) if toks is None else toks[:, i].to(dev)
                chosen.append(tok.cpu())
                rows.append(model(tok[:, None].to(torch.int32), caches=caches,
                                  position_offset=P + C + i)[:, -1])
        return torch.stack(rows).float().cpu(), torch.stack(chosen, 1)

    kernels.reset_launches()
    got, toks = run(cuda)
    launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
    assert launched == {"flash_attention": L * (2 if family == "llama" else 1),
                        "flash_decode": L * steps}
    b4 = "flash_decode/" + ("f16" if kv_dtype == torch.float16 else "bf16")
    assert kernels.ROUTE_LAUNCHES.get(b4) == L * steps
    assert kernels.ROUTE_LAUNCHES.get("flash_attention/upcast", 0) == (
        L if family == "llama" else 0)
    model.to("cpu")
    want, _ = run("cpu", toks)
    assert (got - want).abs().max().item() <= HALF_TOL
    top2 = want[:-1].topk(2, dim=-1).values  # the rows each token was chosen from
    clear = top2[..., 0] - top2[..., 1] > HALF_TOL  # [steps, B]
    choice = torch.stack([greedy_token(r) for r in want[:-1]])
    assert not (clear & (choice != toks.T)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_over_bf16_row_caches_on_card(cuda, chunk):
    """The engine over bf16 row caches (a config whose dtype is bf16: f32
    weights, the caches' default dtype) on the card: its decode steps through
    B4's bf16 route; each request's tokens those of isolated generation on
    the card over a bf16 cache, up to the first step whose top-1/top-2
    margin is within ENGINE_TOL."""
    import numpy as np
    from dmx_compressor_tpu_torch.serving import ContinuousBatchingEngine

    model = _half_model("opt", cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 512, (n,)).astype(np.int32), g)
            for n, g in ((5, 20), (30, 6), (17, 4), (9, 8))]
    max_len = 64
    eng = ContinuousBatchingEngine(model, max_slots=3, max_len=max_len, prompt_buckets=(16, 32),
                                   prefill_chunk=chunk)
    assert eng.caches[0].k.dtype == torch.bfloat16
    kernels.reset_launches()
    rids = [eng.submit(p, max_new_tokens=g) for p, g in reqs]
    res = {r.request_id: r for r in eng.run(burst=4)}
    assert kernels.ROUTE_LAUNCHES.get("flash_decode/bf16", 0) == kernels.LAUNCHES["flash_decode"]
    assert kernels.LAUNCHES["flash_decode"] > 0
    for rid, (p, g) in zip(rids, reqs):
        want, margins = _isolated_on_card(model, p, g, False, max_len, cuda)
        assert len(res[rid].tokens) == g
        for s, (a, b) in enumerate(zip(res[rid].tokens, want)):
            if margins[s] <= ENGINE_TOL:
                break
            assert a == b, f"request {rid}, token {s}"


# ---------------------------------------------------------------------------
# the Llama family on the card
# ---------------------------------------------------------------------------

# (M, N, K): TinyLlama-1.1B's linears (merged q/k/v at GQA widths, o_proj,
# merged gate/up, down_proj, the 32000-wide head) at decode and prefill
LLAMA_LINEARS = [(M, N, K) for M in (8, 1024)
                 for N, K in ((2560, 2048), (2048, 2048), (11264, 2048), (2048, 5632),
                              (32000, 2048))]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["B1", "T1"])
@pytest.mark.parametrize("M,N,K", LLAMA_LINEARS)
def test_llama_linears_match_plain_on_card(cuda, kind, M, N, K):
    g = torch.Generator(device=cuda).manual_seed(1)
    w = tpack.bfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05, 8, 64)
    x = torch.randn(M, K, generator=g, device=cuda)
    name, kern, plain = (("bfp_linear", tbl.bfp_linear, tbl.bfp_linear_ref) if kind == "B1" else
                         ("bfp_linear_bf16", tbl.bfp_linear_bf16, tbl.bfp_linear_bf16_ref))
    n0 = kernels.LAUNCHES[name]
    got = kern(x, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 1
    torch.testing.assert_close(got, plain(x, w), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["BFP16_64", SBFP12_16, "SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}"])
def test_prefill_mainloop_keeps_the_small_products_at_large_k_on_card(cuda, fmt):
    """The shared wgmma mainloop at Llama's down_proj prefill (M 1024, K
    5632, N 2048): the products of x's low planes (and of the weight's,
    for a format off bf16) accumulate apart from the largest one, so the
    tensor cores' truncating adds do not drop their low bits every K step
    (one accumulator moved B1's outputs by up to 4e-4)."""
    g = torch.Generator(device=cuda).manual_seed(6)
    wf = torch.randn(2048, 5632, generator=g, device=cuda) * 0.05
    x = torch.randn(1024, 5632, generator=g, device=cuda)
    if fmt == "BFP16_64":
        w = tpack.bfp_pack(wf, 8, 64)
        got, want = tbl.bfp_linear(x, w), tbl.bfp_linear_ref(x, w)
    else:
        w = tpack.sbfp_pack(wf, Format.from_shorthand(fmt))
        assert tbl.sbfp_route(w, 1024, 5632) in ("tensor_cores", "planes")
        got, want = tbl.sbfp_linear(x, w), tbl.sbfp_linear_ref(x, w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["B1", "T1", SBFP12_16])
def test_prefill_mainloop_splits_a_long_k_on_card(cuda, kind):
    """Gemma's down_proj prefill (M 1024, K 16384, N 2048): one block's
    accumulators take at most 6144 of K (``ACC_CHUNKS``), the rest split
    over the cluster, so the truncating adds of one accumulator stay within
    the tolerance (K 16384 in one block was 4.7e-4 off)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    wf = torch.randn(2048, 16384, generator=g, device=cuda) * 0.05
    x = torch.randn(1024, 16384, generator=g, device=cuda)
    if kind == "B1":
        w = tpack.bfp_pack(wf, 8, 64)
        got, want = tbl.bfp_linear(x, w), tbl.bfp_linear_ref(x, w)
    elif kind == "T1":
        w = tpack.bfp_pack(wf, 8, 64)
        got, want = tbl.bfp_linear_bf16(x, w), tbl.bfp_linear_bf16_ref(x, w)
    else:
        w = tpack.sbfp_pack(wf, Format.from_shorthand(kind))
        got, want = tbl.sbfp_linear(x, w), tbl.sbfp_linear_ref(x, w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", [[160] * 8, None])
def test_llama_decode_attention_matches_plain_on_card(cuda, lengths):
    """B2 and B4 at the Llama paths' shape: 32 query heads over 4 KV heads
    (8 a KV head, read without a repeat), 256 slots, head_dim 64; the
    paths' mean fill and ragged lengths."""
    q, kv, le = _b2_inputs(cuda, 8, 32, 4, 256, 64, lengths)
    n0 = kernels.LAUNCHES["flash_decode_int8"]
    got = tfd.flash_decode_int8(q, kv, le)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode_int8"] == n0 + 1
    torch.testing.assert_close(got, tfd.flash_decode_int8_ref(q, kv, le), rtol=1e-5, atol=2e-5)
    q, k, v, _ = _b4_inputs(cuda, 8, 32, 4, 256, 64, seed=2)
    _check_b4(q, k, v, le)


@pytest.mark.gpu
def test_llama_prefill_attention_matches_plain_on_card(cuda):
    """B3 at the llama_baseline prefill: K/V of 4 heads repeated to the 32
    query heads by flash_prefill (BH 256, L = S = 128, D 64)."""
    from dmx_compressor_tpu_torch.nn.modules import ScaledDotProductAttention

    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(8, 32, 128, 64, generator=g, device=cuda)
    k = torch.randn(8, 4, 128, 64, generator=g, device=cuda)
    v = torch.randn(8, 4, 128, 64, generator=g, device=cuda)
    n0 = kernels.LAUNCHES["flash_attention"]
    got = tfa.flash_prefill(ScaledDotProductAttention(), q, k, v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == n0 + 1
    want = tfa.flash_attention_ref(q, torch.repeat_interleave(k, 8, dim=1),
                                   torch.repeat_interleave(v, 8, dim=1), causal=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


# a Llama whose head_dim (64) the decode and prefill kernels take, GQA 4:1
LLAMA_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=1, max_position_embeddings=256)
# the legs' logits and tokens, card against CPU: f32 sums in another order
# (1e-3), an int8 K/V entry one step apart (1e-2), and BASIC's casts landing
# a step apart (chip_smoke.py's LLAMA_BASIC_LOGIT_TOL, measured at
# TinyLlama-1.1B's width by tools/order_sensitivity.py)
LLAMA_TOL = {"weights": 1e-2, "baseline": 1e-3, "basic": 0.4}


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["weights", "baseline", "basic"])
def test_llama_leg_on_card_matches_cpu(cuda, leg):
    """A small Llama's weights, baseline and BASIC legs on the card against
    the same model on the CPU, the CPU fed the card's tokens: prefill logits
    and every decode step's logits within the leg's tolerance, each greedy
    token equal to the CPU's choice on the same inputs where the CPU's
    top-1/top-2 margin exceeds it; the leg's kernels launched, and BASIC
    decode through the fused step."""
    from dmx_compressor_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dmx_compressor_tpu_torch.ops.basic_layer import basic_llama_layer_plan

    _leg_on_card_matches_cpu(cuda, leg, LlamaForCausalLM(LlamaConfig(**LLAMA_CFG), device=cuda,
                                                         seed=0),
                             basic_llama_layer_plan, LLAMA_TOL)


# a small Qwen3 (head_dim 128, GQA 2:1, tied) and Gemma (head_dim 256, MQA):
# the widths at which the prefill and decode kernels run the families'
# bench configs; the BASIC tolerance is chip_smoke.py's for the family
# (tools/order_sensitivity.py at the family's width)
FAMILY_CFG = {
    "qwen3": dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=128,
                  max_position_embeddings=256, tie_word_embeddings=True),
    "gemma": dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                  num_attention_heads=2, num_key_value_heads=1, head_dim=256,
                  max_position_embeddings=256),
}
FAMILY_BASIC_TOL = {"qwen3": 0.25, "gemma": 0.5}


def _family(family):
    """(model class, config class, the fused step's plan function)."""
    from dmx_compressor_tpu_torch.models import gemma, qwen3
    from dmx_compressor_tpu_torch.ops import basic_layer

    if family == "qwen3":
        return qwen3.Qwen3ForCausalLM, qwen3.Qwen3Config, basic_layer.basic_qwen3_layer_plan
    return gemma.GemmaForCausalLM, gemma.GemmaConfig, basic_layer.basic_gemma_layer_plan


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["weights", "baseline", "basic"])
@pytest.mark.parametrize("family", ["qwen3", "gemma"])
def test_qwen3_gemma_leg_on_card_matches_cpu(cuda, family, leg):
    """As test_llama_leg_on_card_matches_cpu, for small Qwen3 and Gemma
    models at the head dims of their bench configs (the wide prefill kernel,
    the decode kernels at 128 and 256)."""
    model_cls, cfg_cls, plan = _family(family)
    model = model_cls(cfg_cls(**FAMILY_CFG[family]), device=cuda, seed=0)
    _leg_on_card_matches_cpu(cuda, leg, model, plan,
                             dict(LLAMA_TOL, basic=FAMILY_BASIC_TOL[family]))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["qwen3", "gemma"])
def test_qwen3_gemma_build_on_the_card_by_default(cuda, family):
    """Built, and their caches made, on the card unless asked for the CPU."""
    model_cls, cfg_cls, _ = _family(family)
    model = model_cls(cfg_cls.tiny())
    assert all(p.is_cuda for p in model.parameters())
    caches = model.init_cache(1, 16, quantized=True)
    assert caches[0].k_q.is_cuda
    assert not next(model_cls(cfg_cls.tiny(), device="cpu").parameters()).is_cuda


def _leg_on_card_matches_cpu(cuda, leg, model, plan, tols, layers=None, banded=False):
    """A leg of ``model`` (built on the card) against the same model on the
    CPU; see test_llama_leg_on_card_matches_cpu.  ``layers(model)``: the
    blocks the BASIC plan must hold for (default ``model.model.layers``);
    ``banded``: a sliding-window model, which launches no attention
    kernel."""
    from dmx_compressor_tpu_torch.models.shared import greedy_decode, greedy_prefill, greedy_token
    from dmx_compressor_tpu_torch.ops import compress as tc
    from dmx_compressor_tpu_torch.ops.split_decode import prepare_split_decode

    B, P, steps = 5, 64, 6  # 320 prefill rows: the BASIC linears' modular path
    build = {"weights": tc.build_weights_mode, "baseline": tc.build_baseline_mode,
             "basic": tc.build_basic_mode}[leg]
    cache_kw = {"weights": dict(quantized=True), "baseline": {},
                "basic": dict(dtype=torch.float16, split_base_len=P)}[leg]
    build(model)
    if leg == "basic":
        assert all(plan(layer) is not None
                   for layer in (layers(model) if layers else model.model.layers))
    vocab = model.cfg.vocab_size
    ids = torch.randint(0, vocab, (B, P), generator=torch.Generator().manual_seed(4))

    def prefill(dev):
        caches = model.init_cache(B, P + 64, device=dev, **cache_kw)
        logits, tok = greedy_prefill(model, caches, ids.to(dev))
        if leg == "basic":
            prepare_split_decode(model, caches)
        return caches, logits, tok

    kernels.reset_launches()
    caches, logits, tok = prefill(cuda)
    toks, rows = greedy_decode(model, caches, tok, P, steps - 1)
    got_logits, got_rows = logits.float().cpu(), rows.float().cpu()
    got_toks = torch.cat([tok[:, None], toks], 1).cpu()
    want_kernels = {"weights": ("bfp_linear", "flash_decode_int8"),
                    "baseline": ("flash_attention", "flash_decode"),
                    "basic": ("bfp_linear_bf16", "bfp_cast")}[leg]
    attention = ("flash_attention", "flash_decode", "flash_decode_int8")
    if banded:
        assert all(kernels.LAUNCHES[k] == 0 for k in attention), kernels.LAUNCHES
        want_kernels = tuple(k for k in want_kernels if k not in attention)
    assert all(kernels.LAUNCHES[k] > 0 for k in want_kernels), kernels.LAUNCHES
    model.to("cpu")
    caches, want_logits, _ = prefill("cpu")
    with torch.no_grad():
        want_rows = torch.stack([model(got_toks[:, s:s + 1], caches=caches,
                                       position_offset=P + s)[:, -1]
                                 for s in range(steps - 1)])
    tol = tols[leg]
    assert (got_logits - want_logits).abs().max().item() <= tol
    assert (got_rows - want_rows).abs().max().item() <= tol
    step_rows = torch.cat([want_logits[:, -1][None], want_rows])  # [steps, B, V]
    top2 = step_rows.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > tol).T  # [B, steps]
    choice = torch.stack([greedy_token(r) for r in step_rows], dim=1)
    assert not (clear & (choice != got_toks)).any(), (leg, (clear & (choice != got_toks)))


# ---------------------------------------------------------------------------
# GPT-2 and Mistral on the card
# ---------------------------------------------------------------------------

# (M, N, K): GPT-2's tied head (N 50257, odd: the scalar epilogue, rows of
# 201028 bytes off 16-byte alignment, the last tile's weight rows out of
# bounds) at decode, prefill and a ragged M; Mistral-1b's merged q/k/v (N
# 3072 at 8 KV heads of 64)
ODD_HEAD_LINEARS = [(8, 50257, 768), (1024, 50257, 768), (3, 50257, 768), (8, 3072, 2048),
                    (1024, 3072, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["B1", "T1"])
@pytest.mark.parametrize("M,N,K", ODD_HEAD_LINEARS)
def test_gpt2_head_and_mistral_linears_match_plain_on_card(cuda, kind, M, N, K):
    g = torch.Generator(device=cuda).manual_seed(8)
    w = tpack.bfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05, 8, 64)
    x = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    name, kern, plain = (("bfp_linear", tbl.bfp_linear, tbl.bfp_linear_ref) if kind == "B1" else
                         ("bfp_linear_bf16", tbl.bfp_linear_bf16, tbl.bfp_linear_bf16_ref))
    n0 = kernels.LAUNCHES[name]
    got = kern(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 1
    torch.testing.assert_close(got, plain(x, w, b), rtol=1e-5, atol=1e-4)


# a small GPT-2 (heads of 64, as gpt2's) and a small Mistral (heads of 64,
# GQA 2:1, a window of 16 within the 64-token prompt); the BASIC tolerance
# is chip_smoke.py's for the family
GPT2_CFG = dict(vocab_size=509, n_embd=256, n_layer=2, n_head=4, n_positions=256)
MISTRAL_CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
                   sliding_window=16)
GPT2_MISTRAL_BASIC_TOL = {"gpt2": 0.25, "mistral": 0.5}


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["weights", "baseline", "basic"])
def test_gpt2_leg_on_card_matches_cpu(cuda, leg):
    """As test_llama_leg_on_card_matches_cpu, for a small GPT-2 with an odd
    vocabulary (its tied head's N off 4, as gpt2's 50257), every BASIC
    block through the fused step."""
    from dmx_compressor_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
    from dmx_compressor_tpu_torch.ops.basic_layer import basic_gpt2_block_plan

    model = GPT2LMHeadModel(GPT2Config(**GPT2_CFG), device=cuda, seed=0)
    _leg_on_card_matches_cpu(cuda, leg, model, basic_gpt2_block_plan,
                             dict(LLAMA_TOL, basic=GPT2_MISTRAL_BASIC_TOL["gpt2"]),
                             layers=lambda m: m.transformer.h)


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["weights", "baseline", "basic"])
def test_mistral_leg_on_card_matches_cpu(cuda, leg):
    """As test_llama_leg_on_card_matches_cpu, for a small banded Mistral:
    no B2, B3 or B4 launches on any leg (the band keeps the flash kernels
    away, as in the JAX package), the BASIC decode through the fused step
    with the banded mask."""
    from dmx_compressor_tpu_torch.models.mistral import MistralConfig, MistralForCausalLM
    from dmx_compressor_tpu_torch.ops.basic_layer import basic_llama_layer_plan

    model = MistralForCausalLM(MistralConfig(**MISTRAL_CFG), device=cuda, seed=0)
    _leg_on_card_matches_cpu(cuda, leg, model, basic_llama_layer_plan,
                             dict(LLAMA_TOL, basic=GPT2_MISTRAL_BASIC_TOL["mistral"]),
                             banded=True)


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [True, False])
def test_banded_mistral_decode_launches_no_attention_kernel_on_card(cuda, quantized):
    """A raw banded Mistral prefilled and decoded past its window over an
    int8 or an f32 cache: no B2, B3 or B4 launch; with the window removed,
    the same model's decode launches B2 or B4."""
    import dataclasses

    from dmx_compressor_tpu_torch.models.mistral import MistralConfig, MistralForCausalLM
    from dmx_compressor_tpu_torch.models.shared import greedy_decode, greedy_prefill

    cfg = MistralConfig(**MISTRAL_CFG)
    model = MistralForCausalLM(cfg, device=cuda, seed=0)
    ids = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda)
    attention = ("flash_attention", "flash_decode", "flash_decode_int8")
    kernels.reset_launches()
    caches = model.init_cache(2, 64, quantized=quantized)
    _, tok = greedy_prefill(model, caches, ids)
    greedy_decode(model, caches, tok, 24, 4)
    torch.cuda.synchronize()
    assert all(kernels.LAUNCHES[k] == 0 for k in attention), kernels.LAUNCHES
    model.model.cfg = dataclasses.replace(cfg, sliding_window=None)
    caches = model.init_cache(2, 64, quantized=quantized)
    _, tok = greedy_prefill(model, caches, ids)
    greedy_decode(model, caches, tok, 24, 4)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode_int8" if quantized else "flash_decode"] == 4 * 2


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["gpt2", "mistral"])
def test_gpt2_mistral_build_on_the_card_by_default(cuda, family):
    """Built, and their caches made, on the card unless asked for the CPU."""
    from dmx_compressor_tpu_torch.models import gpt2, mistral

    model_cls, cfg_cls = ((gpt2.GPT2LMHeadModel, gpt2.GPT2Config) if family == "gpt2" else
                          (mistral.MistralForCausalLM, mistral.MistralConfig))
    model = model_cls(cfg_cls.tiny())
    assert all(p.is_cuda for p in model.parameters())
    caches = model.init_cache(1, 16, quantized=True)
    assert caches[0].k_q.is_cuda
    assert not next(model_cls(cfg_cls.tiny(), device="cpu").parameters()).is_cuda


# the float formats of ROADMAP Queue C fault 4 (tests/test_torch_numerics.py
# holds them against the JAX package on the CPU)
NAN_SHORTHANDS = ["FP[1|4|3,7](_N)", "FP[1|5|2,15](_N)", "FP[0|4|4,7](FN)", "FP[1|4|3,7](FU)",
                  "FP[1|4|3,7](FD)", "FP[1|3|2,3](FN)", "FP[1|5|10,15](_U)"]


@pytest.mark.gpu
@pytest.mark.parametrize("sh", NAN_SHORTHANDS)
@pytest.mark.parametrize("mode", ["N", "U", "D"])
def test_float_cast_keeps_nan_and_inf_on_card(cuda, sh, mode):
    """``Format.cast`` of NaN, -NaN, +-inf, 2.5 and a value past the
    format's largest on the card: NaN where the CPU (and JAX) keep NaN, and
    every other element bit for bit the CPU's, along both block dims.  The
    card's arithmetic makes its own NaN payload, so NaN is held by
    position."""
    fmt = Format.from_shorthand(sh[:-2] + mode + ")")
    nan = float("nan")
    x = torch.tensor([[1.0, nan, -nan, float("inf"), float("-inf"), 2.5, 3.0e38]] * 4)
    for block_dim, xx in ((-1, x), (0, x.T.contiguous())):
        want = fmt.cast(xx, block_dim)
        got = fmt.cast(xx.to(cuda), block_dim).cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert int(torch.isnan(want).sum()) == 8
        keep = ~torch.isnan(want)
        assert torch.equal(got[keep].view(torch.int32), want[keep].view(torch.int32))


# ---------------------------------------------------------------------------
# bench.py's sbfp leg of the families, and the engine over Llama, on the card
# ---------------------------------------------------------------------------

# (M, N, K): B5 (SBFP12_16) at the families' shapes where trouble is likely:
# Gemma's down_proj (K 16384, split over the cluster beyond 6144) at decode,
# prefill and a ragged M; GPT-2's tied head (N 50257, odd: the scalar
# epilogue) at M 3, 8 and 1024; the GQA k/v projections below a tile's width
# (Gemma's N 256, Mistral's 512)
FAMILY_SBFP_LINEARS = [(8, 2048, 16384), (1024, 2048, 16384), (130, 2048, 16384),
                       (3, 50257, 768), (8, 50257, 768), (1024, 50257, 768),
                       (8, 256, 2048), (1024, 256, 2048), (8, 512, 2048), (1024, 512, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,N,K", FAMILY_SBFP_LINEARS)
def test_sbfp_linear_at_family_shapes_on_card(cuda, M, N, K):
    g = torch.Generator(device=cuda).manual_seed(9)
    w = tpack.sbfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05,
                        Format.from_shorthand(SBFP12_16))
    x = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    assert tbl.sbfp_route(w, M, K) == "tensor_cores"
    n0 = kernels.LAUNCHES["sbfp_linear"]
    got = tbl.sbfp_linear(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sbfp_linear"] == n0 + 1
    torch.testing.assert_close(got, tbl.sbfp_linear_ref(x, w, b), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_engine_over_llama_on_card_matches_cpu(cuda):
    """One burst-decoding engine run over a 2-layer Llama (GQA 2:1, heads of
    64) in weights mode with int8 row caches, on the card and on the CPU:
    B1 at every admission and forward, B2 over the GQA row caches, no B3 (an
    int8 prefill attends through quantized_sdpa); tokens equal where the
    CPU engine's isolated generation has a top-1/top-2 margin above
    ENGINE_TOL."""
    import numpy as np
    from dmx_compressor_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode
    from dmx_compressor_tpu_torch.serving import ContinuousBatchingEngine

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(1, 512, (n,)).astype(np.int32), g)
            for n, g in ((5, 20), (30, 6), (17, 9), (9, 12), (24, 5))]
    with torch.no_grad():
        model = LlamaForCausalLM(cfg, device=cuda, seed=0)
        build_weights_mode(model)

    def run(dev):
        eng = ContinuousBatchingEngine(model, max_slots=3, max_len=64, prompt_buckets=(16, 32),
                                       quantized_kv=True)
        rids = [eng.submit(p, max_new_tokens=g) for p, g in reqs]
        res = {r.request_id: r.tokens for r in eng.run(burst=4)}
        return [res[r] for r in rids]

    kernels.reset_launches()
    card = run(cuda)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bfp_linear"] > 0 and kernels.LAUNCHES["flash_decode_int8"] > 0
    assert kernels.LAUNCHES["flash_attention"] == 0
    model.to("cpu")
    cpu = run("cpu")
    for i, ((p, g), a, b) in enumerate(zip(reqs, card, cpu)):
        _, margins = _isolated_on_card(model, p, g, True, 64, "cpu")
        assert len(a) == len(b) == g
        for s in range(g):
            if margins[s] <= ENGINE_TOL:
                break
            assert a[s] == b[s], f"request {i}, token {s}"


# (M, N, K) of the encoder-decoder paths' packed linears that no other case
# takes: whisper-small's cross-attention K/V and encoder q/k/v/o (M 8 x 1500
# = 12000, 768 x 768) and its fc1 / fc2 there, its tied head (N 51865, odd)
# at decode and at the 4-token prefill (M 32), t5-small's tied head (N
# 32128, K 512) at decode and its encoder's M 1024 x 512 x 2048
SEQ2SEQ_LINEARS = [(12000, 768, 768), (12000, 3072, 768), (12000, 768, 3072), (8, 51865, 768),
                   (32, 51865, 768), (8, 32128, 512), (1024, 2048, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["B1", "T1"])
@pytest.mark.parametrize("M,N,K", SEQ2SEQ_LINEARS)
def test_seq2seq_linears_match_plain_on_card(cuda, kind, M, N, K):
    g = torch.Generator(device=cuda).manual_seed(9)
    w = tpack.bfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05, 8, 64)
    x = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    name, kern, plain = (("bfp_linear", tbl.bfp_linear, tbl.bfp_linear_ref) if kind == "B1" else
                         ("bfp_linear_bf16", tbl.bfp_linear_bf16, tbl.bfp_linear_bf16_ref))
    n0 = kernels.LAUNCHES[name]
    got = kern(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == n0 + 1
    torch.testing.assert_close(got, plain(x, w, b), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_whisper_prefill_attention_matches_plain_on_card(cuda):
    """B3 at whisper_baseline's decoder prefill: its 4 start tokens (BH 96,
    L = S = 4, D 64) through flash_prefill."""
    from dmx_compressor_tpu_torch.nn.modules import ScaledDotProductAttention

    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(8, 12, 4, 64, generator=g, device=cuda) for _ in range(3))
    n0 = kernels.LAUNCHES["flash_attention"]
    got = tfa.flash_prefill(ScaledDotProductAttention(), q, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == n0 + 1
    torch.testing.assert_close(got, tfa.flash_attention_ref(q, k, v, causal=True, scale=0.125),
                               rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("lengths", [[36] * 8, None])
def test_whisper_decode_attention_matches_plain_on_card(cuda, lengths):
    """B2 and B4 at whisper-small's decode step: 12 heads of 64, a cache of
    4 start tokens + 64 slots, its mean fill and ragged lengths."""
    q, kv, le = _b2_inputs(cuda, 8, 12, 12, 68, 64, lengths)
    n0 = kernels.LAUNCHES["flash_decode_int8"]
    got = tfd.flash_decode_int8(q, kv, le, scale=0.125)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode_int8"] == n0 + 1
    torch.testing.assert_close(got, tfd.flash_decode_int8_ref(q, kv, le, scale=0.125),
                               rtol=1e-5, atol=2e-5)
    q, k, v, _ = _b4_inputs(cuda, 8, 12, 12, 68, 64, seed=5)
    _check_b4(q, k, v, le)


@pytest.mark.gpu
@pytest.mark.parametrize("bidirectional", [True, False])
def test_t5_buckets_on_card_equal_the_cpu(cuda, bidirectional):
    """T5's relative-position buckets over [-512, 512] (32 buckets, distance
    128) and a per-row bias (offsets on the card), card against CPU, bit
    for bit."""
    from dmx_compressor_tpu_torch.models.t5 import (
        T5Attention,
        T5Config,
        position_buckets,
        relative_position_bucket,
    )

    rel = torch.arange(-512, 513, dtype=torch.int32)
    want = relative_position_bucket(rel, bidirectional, 32, 128)
    assert torch.equal(position_buckets(rel.to(cuda), bidirectional, 32, 128).cpu(),
                       want.long())
    cfg = T5Config.tiny()
    att = T5Attention(cfg, has_relative_attention_bias=True, bidirectional=bidirectional,
                      device="cpu")
    off = torch.tensor([0, 7, 130, 600], dtype=torch.int32)
    cpu = att.compute_bias(1, 700, off)
    card = att.to(cuda).compute_bias(1, 700, off.to(cuda))
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["t5", "whisper"])
def test_seq2seq_engine_on_card_matches_cpu(cuda, family):
    """One burst-decoding seq2seq engine run over a 2-layer T5 (heads of 64;
    ragged encoder inputs padded to 32) or Whisper (heads of 64, 4 start
    tokens) in weights mode with int8 row caches, on the card and on the
    CPU: B1 at every admission and forward, B2 (Whisper) over the row
    caches' per-row lengths, no B3; tokens equal where the CPU's isolated
    generation has a top-1/top-2 margin above ENGINE_TOL."""
    import numpy as np

    from dmx_compressor_tpu_torch.models.shared import seq2seq_greedy
    from dmx_compressor_tpu_torch.models.t5 import T5Config, T5ForConditionalGeneration
    from dmx_compressor_tpu_torch.models.whisper import (
        WhisperConfig,
        WhisperForConditionalGeneration,
    )
    from dmx_compressor_tpu_torch.ops.compress import build_weights_mode
    from dmx_compressor_tpu_torch.serving import Seq2SeqBatchingEngine

    rng = np.random.default_rng(2)
    if family == "t5":
        cfg = T5Config(vocab_size=512, d_model=256, d_kv=64, d_ff=512, num_layers=2,
                       num_decoder_layers=2, num_heads=4)
        model_cls, start, cap = T5ForConditionalGeneration, np.zeros(1, np.int32), 32
        inputs = [rng.integers(1, 512, (n,)).astype(np.int32) for n in (9, 32, 17, 5)]
    else:
        cfg = WhisperConfig(vocab_size=509, num_mel_bins=80, d_model=256, encoder_layers=2,
                            decoder_layers=2, encoder_attention_heads=4,
                            decoder_attention_heads=4, encoder_ffn_dim=512, decoder_ffn_dim=512,
                            max_source_positions=100, max_target_positions=64)
        model_cls, start, cap = WhisperForConditionalGeneration, np.arange(4, dtype=np.int32), None
        inputs = [rng.standard_normal((80, 200)).astype(np.float32) for _ in range(4)]
    gens = [12, 5, 9, 7]
    with torch.no_grad():
        model = model_cls(cfg, device=cuda, seed=0)
        build_weights_mode(model)

    def run():
        eng = Seq2SeqBatchingEngine(model, max_slots=3, max_len=start.size + 16,
                                    prompt_buckets=(start.size,), quantized_kv=True,
                                    enc_capacity=cap)
        rids = [eng.submit(x, start, max_new_tokens=g) for x, g in zip(inputs, gens)]
        res = {r.request_id: r.tokens for r in eng.run(burst=4)}
        return [res[r] for r in rids]

    kernels.reset_launches()
    card = run()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bfp_linear"] > 0 and kernels.LAUNCHES["flash_attention"] == 0
    assert (kernels.LAUNCHES["flash_decode_int8"] > 0) == (family == "whisper")
    model.to("cpu")
    cpu = run()
    for i, (x, g, a, b) in enumerate(zip(inputs, gens, card, cpu)):
        caches = model.init_cache(1, start.size + g, quantized=True, device="cpu")
        with torch.no_grad():
            _, rows = seq2seq_greedy(model, caches, model.encode(torch.from_numpy(x[None])),
                                     torch.from_numpy(start[None]), g)
        top2 = rows[:, 0].topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).tolist()
        assert len(a) == len(b) == g
        for s in range(g):
            if margins[s] <= ENGINE_TOL:
                break
            assert a[s] == b[s], f"request {i}, token {s}"


# the op zoo's modules on the card against the CPU (the same weights and
# input): each at a small shape, its casts SAME and in its type's BASIC
# rule; f32 sums in another order, and under BASIC a FLOAT16 output one
# fp16 step (2^-10 relative) apart at most
ZOO_TOL = {"same": dict(rtol=1e-5, atol=1e-4), "basic": dict(rtol=2e-3, atol=1e-4)}


def _zoo_module(name):
    from dmx_compressor_tpu_torch.nn import modules as m

    g = torch.Generator().manual_seed(3)
    return {
        "Conv1d": lambda: m.Conv1d(64, 32, 3, stride=2, padding=1, device="cpu", generator=g),
        "Conv2d": lambda: m.Conv2d(64, 32, 3, padding=2, dilation=2, device="cpu",
                                   generator=g),
        "Conv2d groups": lambda: m.Conv2d(128, 64, 3, padding=1, groups=2, device="cpu",
                                          generator=g),
        "ConvTranspose2d": lambda: m.ConvTranspose2d(64, 64, 3, stride=2, padding=1,
                                                     output_padding=1, device="cpu",
                                                     generator=g),
        "MaxPool2d": lambda: m.MaxPool2d(3, 2, 1),
        "AvgPool2d": lambda: m.AvgPool2d(3, 2, 1),
        "AdaptiveAvgPool2d": lambda: m.AdaptiveAvgPool2d((3, 5)),
        "BatchNorm2d": lambda: m.BatchNorm2d(64, device="cpu"),
        "GroupNorm": lambda: m.GroupNorm(8, 64, device="cpu"),
        "ReLU6": lambda: m.ReLU6(),
        "Exp": lambda: m.Exp(),
    }[name]()


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["same", "basic"])
@pytest.mark.parametrize("name", ["Conv1d", "Conv2d", "Conv2d groups", "ConvTranspose2d",
                                  "MaxPool2d", "AvgPool2d", "AdaptiveAvgPool2d", "BatchNorm2d",
                                  "GroupNorm", "ReLU6", "Exp"])
def test_zoo_module_on_card_matches_cpu(cuda, name, fmt):
    import copy

    import dmx_compressor_tpu_torch as tdmx

    mod = _zoo_module(name)
    if fmt == "basic":
        for rule in tdmx.config_rules.BASIC:
            if isinstance(mod, rule.module_types):
                mod.configure(rule.module_config)
    C = 128 if name == "Conv2d groups" else 64
    shape = (4, C, 300) if name == "Conv1d" else (4, C, 17, 19)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = mod(x)
        got = copy.deepcopy(mod).to(cuda)(x.to(cuda))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, **ZOO_TOL[fmt])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["Conv2d", "ConvTranspose2d"])
def test_zoo_conv_is_f32_with_tf32_left_on(cuda, name):
    """With ``torch.backends.cudnn.allow_tf32`` on, as a library user has
    it, a Dmx conv still computes in f32 (TF32's 10-bit mantissas would
    miss this tolerance by far), and the flag is left as it was."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        mod = _zoo_module(name)
        x = torch.randn(4, 64, 33, 35, generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            want = mod(x)
            got = mod.to(cuda)(x.to(cuda))
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32
        torch.testing.assert_close(got.cpu(), want, **ZOO_TOL["same"])
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.gpu
@pytest.mark.parametrize("cls", ["Conv1dUnfold", "Conv1dScatter", "Conv2dUnfold",
                                 "Conv2dGather"])
def test_experimental_conv_on_card_matches_cpu(cuda, cls):
    from dmx_compressor_tpu_torch.nn import experimental as ex

    nd = 1 if cls.startswith("Conv1d") else 2
    raw = getattr(torch.nn, f"Conv{nd}d")(16, 32, 4, stride=2, padding=1)
    mod = getattr(ex, cls).from_raw(raw)
    mod.configure(dict(input_formats=["BFP[8|8]{64}(SN)"], weight_format="BFP[8|8]{64}(SN)",
                       output_formats=["FP[1|5|10,15](FN)"]))
    x = torch.randn((2, 16) + (40,) * nd, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        want = mod(x)
        kernels.reset_launches()
        got = mod.to(cuda)(x.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bfp_cast"] == 3  # the patches', the weight's and the output cast
    torch.testing.assert_close(got.cpu(), want, **ZOO_TOL["basic"])


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["weights", "baseline", "basic"])
def test_clip_leg_on_card_matches_cpu(cuda, leg):
    """A 2-layer CLIP with heads of 64 (every linear's K a multiple of 64),
    its zero-shot probabilities on the card against the CPU: B1 (weights)
    or T1 and T2 (basic) launched, no attention kernel."""
    import numpy as np

    from dmx_compressor_tpu_torch.models import clip as tc
    from dmx_compressor_tpu_torch.ops.compress import (
        build_baseline_mode,
        build_basic_mode,
        build_weights_mode,
    )

    cfg = tc.CLIPConfig(
        vision=tc.CLIPVisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                                   num_attention_heads=2, image_size=64, patch_size=16),
        text=tc.CLIPTextConfig(vocab_size=300, hidden_size=128, intermediate_size=256,
                               num_hidden_layers=2, num_attention_heads=2,
                               max_position_embeddings=16), projection_dim=128)
    build = {"weights": build_weights_mode, "baseline": build_baseline_mode,
             "basic": build_basic_mode}[leg]
    model = tc.CLIPModel(cfg, device=cuda, seed=0)
    build(model)
    rng = np.random.default_rng(7)
    px = torch.from_numpy(rng.standard_normal((20, 3, 64, 64), np.float32))
    ids = torch.from_numpy(rng.integers(0, 300, (20, 16)).astype(np.int32))
    kernels.reset_launches()
    with torch.no_grad():
        card = model.zero_shot_classify(px.to(cuda), ids.to(cuda))
    torch.cuda.synchronize()
    want = {"weights": {"bfp_linear": 26}, "baseline": {},
            "basic": {"bfp_linear_bf16": 26, "bfp_cast": 149}}[leg]
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == want
    model.to("cpu")
    with torch.no_grad():
        cpu = model.zero_shot_classify(px, ids)
    tol = 1e-3 if leg != "basic" else 2e-2
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["baseline", "basic"])
def test_lenet_leg_on_card_matches_cpu(cuda, leg):
    from dmx_compressor_tpu_torch.models.lenet import LeNet5
    from dmx_compressor_tpu_torch.ops.compress import build_baseline_mode, build_basic_mode

    model = LeNet5(device=cuda, seed=0)
    (build_basic_mode if leg == "basic" else build_baseline_mode)(model)
    x = torch.randn(32, 1, 28, 28, generator=torch.Generator().manual_seed(8))
    kernels.reset_launches()
    with torch.no_grad():
        card = model(x.to(cuda))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bfp_cast"] == (17 if leg == "basic" else 0)
    model.to("cpu")
    with torch.no_grad():
        cpu = model(x)
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# the PTQ recipes on the card against the CPU
# ---------------------------------------------------------------------------


def _both(cuda, fn):
    """``fn(device)`` on the card (moved to the CPU) and on the CPU."""
    got = fn(cuda)
    got = [t.cpu() for t in got] if isinstance(got, (tuple, list)) else got.cpu()
    return got, fn(torch.device("cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("observer", ["minmax", "histogram", "percentile"])
def test_observer_qparams_on_card_equal_the_cpu(cuda, observer):
    """Each observer's qparams over two batches, bit for bit: the
    histogram's bins are searchsorted against the same f32 edges on both."""
    from dmx_compressor_tpu_torch.numerics.observer import OBSERVERS

    int8 = Format.from_shorthand("XP[8,0](CSN)")

    def run(device):
        g = torch.Generator().manual_seed(0)
        o = OBSERVERS[observer](int8)
        for s in (1.0, 3.0):
            o((torch.randn(8, 128, 768, generator=g) * s).to(device))
        return o.calculate_qparams()

    (cs, cz), (ps, pz) = _both(cuda, run)
    assert torch.equal(cs, ps) and torch.equal(cz, pz)


@pytest.mark.gpu
def test_group_calibrated_int8_cast_on_card_equals_the_cpu(cuda):
    from dmx_compressor_tpu_torch.numerics.cast import CastTo
    from dmx_compressor_tpu_torch.numerics.observer import MinMaxObserver

    def run(device):
        w = torch.randn(768, 768, generator=torch.Generator().manual_seed(1)).to(device)
        c = CastTo(format="XP[8,0](CSN)")
        c.enable_calibration(True, observer_cls=MinMaxObserver,
                             qscheme_to_overload="per_tensor_symmetric", group_size=64, ch_axis=-1)
        c(w)
        c.enable_calibration(False)
        return c.scale, c.zero_point, c(w)

    got, want = _both(cuda, run)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_masks_and_int_group_pack_on_card_equal_the_cpu(cuda):
    import dmx_compressor_tpu_torch as tdmx

    def run(device):
        s = torch.randint(0, 3, (768, 3072), generator=torch.Generator().manual_seed(2)).float()
        s = s.to(device)  # ties at every threshold
        out = [getattr(tdmx.sparseness, n).get_mask(s) for n in
               ("BTK8_4_LD", "BTK8_4_FD", "BTK8_2_LD", "BTK8_2_FD")]
        return out + list(tpack.int_group_pack(s * 0.37 - 0.5, 8, 64, symmetric=False))

    got, want = _both(cuda, run)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_smoothquant_and_gptq_on_card_follow_the_cpu(cuda):
    """SmoothQuant's scale within 1e-5 (powf on both), GPTQ's weights on
    BFP16_64's grid, none more than one step from the CPU's, one T2 launch
    a microblock."""
    from dmx_compressor_tpu_torch import nn as dmxnn
    from dmx_compressor_tpu_torch.advanced_recipe import (
        DmxModuleGPTQHyperparams,
        DmxModuleSmoothQuantHyperparams,
    )

    def run(device):
        g = torch.Generator().manual_seed(3)
        m = dmxnn.Linear(768, 256, device=device)
        with torch.no_grad():
            m.weight.copy_((torch.randn(256, 768, generator=g) * 0.05).to(device))
        x = torch.randn(4, 64, 768, generator=g)
        x[..., :3] *= 30
        x = x.to(device)
        with m.calibrating_smoothquant(DmxModuleSmoothQuantHyperparams(fuse_to_weight=True)):
            with torch.no_grad():
                m(x)
        m.configure(dict(weight_format="BFP[8|8]{64}(SN)"))
        n0 = kernels.LAUNCHES["bfp_cast"]
        with m.optimal_brain_compressing(DmxModuleGPTQHyperparams(64, 128)), torch.no_grad():
            m(x)
        return m.smoothquant.scale, m.weight.detach(), torch.tensor(
            kernels.LAUNCHES["bfp_cast"] - n0)

    (cs, cw, cn), (ps, pw, _) = _both(cuda, run)
    torch.testing.assert_close(cs, ps, rtol=1e-5, atol=0)
    p = tpack.bfp_pack(pw, 8, 64)
    step = torch.exp2(p.exponent.float().repeat_interleave(64, dim=-1) + 2 - 8)
    assert ((cw - pw).abs() <= step).all()
    assert torch.equal(tpack.bfp_unpack(tpack.bfp_pack(cw, 8, 64)), cw)
    assert int(cn) == 768 // 64


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["sbfp"])
def test_clip_sbfp_leg_on_card_matches_cpu(cuda, leg):
    """CLIP's sbfp build at a test width: B5 on every linear, the logits
    within 1e-3 of the CPU's (the same payloads, f32 sums in another
    order)."""
    from dmx_compressor_tpu_torch.models import clip as tc
    from dmx_compressor_tpu_torch.ops.compress import build_sbfp_mode

    cfg = tc.CLIPConfig.tiny()
    model = tc.CLIPModel(cfg, device=cuda, seed=0)
    build_sbfp_mode(model)
    g = torch.Generator().manual_seed(3)
    px = torch.randn(4, 3, cfg.vision.image_size, cfg.vision.image_size, generator=g)
    ids = torch.randint(0, cfg.text.vocab_size, (4, cfg.text.max_position_embeddings),
                        generator=g)
    n0 = kernels.LAUNCHES["sbfp_linear"]
    with torch.no_grad():
        got = model(ids.to(cuda), px.to(cuda))[0].cpu()
    assert kernels.LAUNCHES["sbfp_linear"] > n0
    model.to("cpu")
    with torch.no_grad():
        want = model(ids, px)[0]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_qat_step_with_t2_equals_its_plain_version_on_card(cuda, monkeypatch):
    """One QAT step of OPT tiny through the modular BASIC forward on the
    card, T2 against its plain version on the same card: the loss and every
    gradient bit for bit; the forward launches T2, the backward none."""
    from dmx_compressor_tpu_torch.modeling.model import DmxModel
    from dmx_compressor_tpu_torch.models import loss_fn
    from dmx_compressor_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
    from dmx_compressor_tpu_torch.nn.core import DmxModule

    monkeypatch.setattr(DmxModule, "inference_mode", False)
    cfg = OPTConfig.tiny()
    ids = torch.randint(0, cfg.vocab_size, (4, 16),
                        generator=torch.Generator().manual_seed(0)).to(cuda)

    def step():
        model = OPTForCausalLM(cfg, device=cuda, seed=0)
        dm = DmxModel.from_raw(model).to_basic_mode()
        n0 = kernels.LAUNCHES["bfp_cast"]
        loss = loss_fn(dm(ids), ids)
        n1 = kernels.LAUNCHES["bfp_cast"]
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        return loss.detach(), grads, n1 - n0, kernels.LAUNCHES["bfp_cast"] - n1

    loss, grads, fwd, bwd = step()
    with monkeypatch.context() as mp:
        mp.setattr(T2, "bfp_cast", lambda x, wl, block, axis=-1, fp16_first=False:
                   T2.bfp_cast_ref(T2.fp16_cast_ref(x) if fp16_first else x, wl, block, axis))
        mp.setattr(T2, "fp16_cast", T2.fp16_cast_ref)
        want_loss, want_grads, plain_fwd, _ = step()
    assert fwd > 0 and bwd == 0 and plain_fwd == 0
    assert torch.equal(loss, want_loss)
    assert grads.keys() == want_grads.keys()
    for n, g in grads.items():
        assert torch.equal(g, want_grads[n]), n


@pytest.mark.gpu
def test_basic_linear_graph_equals_its_module_on_card(cuda):
    """A BASIC Linear's compiler graph evaluated on the card: the module's
    output bit for bit, with the module's T2 launches (input, weight and
    output casts); the ONNX bytes of the card module its CPU copy's."""
    import copy

    from dmx_compressor_tpu_torch import nn as tnn
    from dmx_compressor_tpu_torch.transform import onnx_export, qdq

    mod = tnn.Linear(768, 256, device=cuda)
    mod.configure(dict(input_formats=["BFP[8|8]{64}(SN)"], weight_format="BFP[8|8]{64}(SN)",
                       bias_format="BFP[24|8]{1}(SN)", output_formats=["FP[1|5|10,15](FN)"]))
    x = torch.randn(8, 128, 768, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    g = mod.to_compiler_graph()
    with torch.no_grad():
        n0 = kernels.LAUNCHES["bfp_cast"]
        want = mod(x)
        n1 = kernels.LAUNCHES["bfp_cast"]
        got = qdq.evaluate_graph(g, mod, x)
        torch.cuda.synchronize()
    assert n1 - n0 == kernels.LAUNCHES["bfp_cast"] - n1 == 3
    assert torch.equal(got, want)
    assert (onnx_export.dmx_graph_to_onnx(g, mod, "linear")
            == onnx_export.dmx_graph_to_onnx(g, copy.deepcopy(mod).to("cpu"), "linear"))


@pytest.mark.gpu
def test_export_program_holds_t2_as_an_operator_on_card(cuda):
    """torch.export of a BASIC Linear on the card: each cast's T2 launch is
    the operator dmx_compressor_tpu_torch::bfp_cast of the program (no
    launch while tracing); the program's module runs as eager, bit for bit,
    with eager's T2 launches."""
    from dmx_compressor_tpu_torch import nn as tnn
    from dmx_compressor_tpu_torch.transform import qdq

    mod = tnn.Linear(768, 256, device=cuda)
    mod.configure(dict(input_formats=["BFP[8|8]{64}(SN)"], weight_format="BFP[8|8]{64}(SN)",
                       output_formats=["FP[1|5|10,15](FN)"]))
    x = torch.randn(16, 768, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    n0 = kernels.LAUNCHES["bfp_cast"]
    ep = qdq.exported_program(mod, x)
    assert kernels.LAUNCHES["bfp_cast"] == n0
    assert str(ep).count("torch.ops.dmx_compressor_tpu_torch.bfp_cast") == 3
    with torch.no_grad():
        want = mod(x)
        n1 = kernels.LAUNCHES["bfp_cast"]
        got = ep.module()(x)
        torch.cuda.synchronize()
    assert n1 - n0 == kernels.LAUNCHES["bfp_cast"] - n1 == 3
    assert torch.equal(got, want)
