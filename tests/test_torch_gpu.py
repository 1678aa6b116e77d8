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
             (2, 8, 8, 520, 128, [520, 64]), (3, 4, 2, 600, 32, [600, 257, 3])]


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
# so that |q . k| reaches ~100
B3_SHAPES = [(4, 3, 128, 128, 64, True, False, 1.0), (4, 3, 48, 200, 64, True, True, 1.0),
             (4, 3, 70, 70, 64, False, False, 1.0), (4, 3, 90, 130, 32, True, False, 1.0),
             (4, 3, 33, 33, 32, False, True, 1.0), (8, 12, 128, 128, 64, True, False, 1.0),
             (2, 3, 7, 9, 64, True, False, 1.0), (2, 3, 13, 61, 32, False, True, 1.0),
             (2, 3, 77, 77, 64, True, True, 1.0), (8, 12, 128, 128, 64, True, False, 2.0),
             (2, 3, 100, 160, 32, True, True, 2.0)]


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D", [(torch.float32, 128), (torch.bfloat16, 64),
                                     (torch.float16, 64)])
def test_flash_attention_kernel_raises_rather_than_falling_back(cuda, dtype, D):
    q = torch.randn(2, 4, 16, D, device=cuda).to(dtype)
    n0 = kernels.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q.clone(), q.clone(), causal=True)
    assert kernels.LAUNCHES["flash_attention"] == n0


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
# scale: not exact in bf16; blocks of 8 and 24): B5's f32 GEMM at every M
SBFP_OTHER = [("SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}", 768, 768),
              ("SBFP<XP[4,0](CSN)><FP[0|4|5,16](FN)>{16}", 80, 130),
              ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{8}", 40, 48),
              ("SBFP<XP[4,0](CSN)><FP[0|4|4,16](FN)>{24}", 72, 200)]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,K,N", SBFP_OTHER)
@pytest.mark.parametrize("M", [8, 1024])
def test_sbfp_linear_f32_route_other_formats_on_card(cuda, fmt, K, N, M):
    g = torch.Generator(device=cuda).manual_seed(7)
    w = tpack.sbfp_pack(torch.randn(N, K, generator=g, device=cuda) * 0.05,
                        Format.from_shorthand(fmt))
    assert not tbl.sbfp_tensor_cores(w, K)
    x = torch.randn(M, K, generator=g, device=cuda)
    b = torch.randn(N, generator=g, device=cuda)
    n0 = kernels.LAUNCHES["sbfp_linear"]
    got = tbl.sbfp_linear(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sbfp_linear"] == n0 + 1
    torch.testing.assert_close(got, tbl.sbfp_linear_ref(x, w, b), rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D,scalar", [
    (8, 12, 12, 256, 64, False), (3, 8, 2, 256, 64, False), (2, 4, 4, 192, 32, True),
    (2, 8, 8, 200, 128, False), (3, 12, 4, 77, 128, True), (2, 6, 6, 33, 32, False),
])
def test_flash_decode_kernel_matches_plain_on_card(cuda, B, H, Hkv, S, D, scalar):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(B, H, 1, D, generator=g, device=cuda)
    k = torch.randn(B, Hkv, S, D, generator=g, device=cuda)
    v = torch.randn(B, Hkv, S, D, generator=g, device=cuda)
    lengths = (S * 2 // 3 if scalar else
               torch.randint(1, S + 1, (B,), generator=g, device=cuda, dtype=torch.int32))
    n0 = kernels.LAUNCHES["flash_decode"]
    got = tfd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_decode"] == n0 + 1
    torch.testing.assert_close(got, tfd.flash_decode_ref(q, k, v, lengths), rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.float32, 80)])
def test_flash_decode_kernel_raises_rather_than_falling_back(cuda, dtype, D):
    q = torch.randn(2, 4, 1, D, device=cuda)
    k = torch.randn(2, 4, 16, D, device=cuda, dtype=dtype)
    n0 = kernels.LAUNCHES["flash_decode"]
    with pytest.raises(ValueError):
        tfd.flash_decode(q, k, k.clone(), 8)
    assert kernels.LAUNCHES["flash_decode"] == n0


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
