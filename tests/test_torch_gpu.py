"""Each CUDA kernel of the port against its plain PyTorch version, on the card.

These tests need a CUDA device and skip without one.  They import neither
jax nor the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import pytest
import torch

from dmx_compressor_tpu_torch import kernels
from dmx_compressor_tpu_torch.ops import bfp_linear as tbl
from dmx_compressor_tpu_torch.ops import bfp_pack as tpack
from dmx_compressor_tpu_torch.ops import flash_attention as tfa
from dmx_compressor_tpu_torch.ops import flash_decode as tfd
from dmx_compressor_tpu_torch.ops import kv_cache as tkv
from dmx_compressor_tpu_torch.numerics.format import Format
from dmx_compressor_tpu_torch.ops.compress import SBFP12_16

torch.set_num_threads(2)

# (M, N, K, block): odd shapes (block 8 takes the byte-load path), then
# OPT-125m's prefill fc1 and decode head
B1_SHAPES = [(8, 300, 128, 64), (8, 40, 1024, 16), (8, 256, 4096, 64), (8, 33, 80, 16),
             (5, 200, 192, 64), (3, 17, 72, 8), (1024, 3072, 768, 64), (8, 50272, 768, 64),
             (37, 96, 80, 16), (12, 10, 24, 8)]

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


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,Hkv,S,D", [(8, 12, 12, 200, 64), (2, 8, 4, 77, 128), (3, 4, 4, 33, 32)])
def test_flash_decode_int8_kernel_matches_plain_on_card(cuda, B, H, Hkv, S, D):
    g = torch.Generator(device=cuda).manual_seed(0)
    kq, ks = tkv.QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g, device=cuda))
    vq, vs = tkv.QuantizedKVCache._quantize(torch.randn(B, Hkv, S, D, generator=g, device=cuda))
    kv = tkv.QuantKV(kq, vq, ks, vs)
    q = torch.randn(B, H, 1, D, generator=g, device=cuda)
    lengths = torch.randint(1, S + 1, (B,), generator=g, device=cuda, dtype=torch.int32)
    got = tfd.flash_decode_int8(q, kv, lengths)
    torch.testing.assert_close(got, tfd.flash_decode_int8_ref(q, kv, lengths), rtol=1e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("L,S,D,causal,with_bias", [
    (128, 128, 64, True, False), (48, 200, 64, True, True), (70, 70, 64, False, False),
    (90, 130, 32, True, False), (33, 33, 32, False, True),
])
def test_flash_attention_kernel_matches_plain_on_card(cuda, L, S, D, causal, with_bias):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(4, 3, L, D, generator=g, device=cuda)
    k = torch.randn(4, 3, S, D, generator=g, device=cuda)
    v = torch.randn(4, 3, S, D, generator=g, device=cuda)
    bias = torch.randn(4, 3, L, S, generator=g, device=cuda) if with_bias else None
    got = tfa.flash_attention(q, k, v, bias, causal=causal)
    want = tfa.flash_attention_ref(q, k, v, bias, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)


# (M, N, K): ragged shapes (K = 48 and 80 are not multiples of 32 and take
# the 8-byte loads), the SBFP leg's decode shapes and its head
B5_SHAPES = [(3, 33, 48), (130, 256, 160), (5, 48, 80), (8, 768, 768), (8, 3072, 768),
             (8, 768, 3072), (8, 50272, 768), (1024, 768, 3072)]


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
