// B5: SBFP dequant-matmul for Hopper (sm_90a), y = x . W^T + bias, in f32.
//
// Replaces: dmx_compressor_tpu/ops/bfp_linear.py:_sbfp_matmul_pallas (the
// TPU Pallas kernel behind sbfp_linear).
//
// W[n, k] = man[n, k] * scale[n, k / B]: int4 mantissas in [-7, 7] packed two
// to a byte (two's complement, low nibble = even k), one f32 scale per block
// of B along K.  A mantissa has at most 3 significant bits and the scale at
// most 5 (sbfp_pack checks), so the dequantized weight is exact in bf16 and
// the only difference from the plain PyTorch version (ops/bfp_linear.py:
// sbfp_linear_ref) is the order of the f32 sums.
//
// What bounds it on the card, and what the design does about it (the three
// kernels are chosen by shape in the C entry point):
// - Decode (M <= 16): the tensor-core GEMV of bfp_wgmma.cuh
//   (bfp_decode_kernel with the SBFP weight format, shared with B1 and T1),
//   three bf16 planes of x, K split over a cluster: bound by launch and
//   cluster-reduction latency at OPT-125m's shapes, not by the 0.75 bytes
//   per weight it streams.
// - Prefill (M > 16) with K a multiple of 32: the wgmma mainloop of
//   bfp_wgmma.cuh with the SBFP weight format and three bf16 planes of x
//   (the pre-pass writes them into the wrapper's scratch), so B5's f32
//   product runs on the bf16 tensor cores: its floor is 3 x 2MNK at 989
//   TFLOP/s.  The nibble decode (SbfpW::deq4) takes half of BFP's
//   instructions per weight, and the weight tile half its bytes.
// - M > 16 with K % 32 == 16 (a row of nibbles is then no multiple of 16
//   bytes, which TMA needs; sbfp_gemm_kernel): a plain shared-memory-tiled
//   f32 FMA GEMM (64x64 tile, 4x4 per thread), weight tiles dequantized on
//   their way into shared memory.
// K and B must be multiples of 16 (the wrapper checks); M and N are
// arbitrary.  The launch error is returned to the caller (cudaGetLastError).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp_wgmma.cuh"

namespace {

constexpr int TILE = 64;
constexpr int TILE_K = 16;

// the signed value of nibble j (0..7) of a 32-bit word of packed mantissas
__device__ __forceinline__ float nibble(uint32_t word, int j) {
  const int v = (int)((word >> (4 * j)) & 0xfu);
  return (float)(v - ((v > 7) << 4));
}

__global__ void __launch_bounds__(256)
sbfp_gemm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ nib,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int K, int block_size) {
  __shared__ __align__(16) float As[TILE_K][TILE];  // x tile, k-major
  __shared__ __align__(16) float Bs[TILE_K][TILE];  // dequantized W tile, k-major
  const int tx = threadIdx.x % 16;  // output columns tx*4 .. +3
  const int ty = threadIdx.x / 16;  // output rows ty*4 .. +3
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;
  const int nblk = K / block_size;
  const int row_bytes = K / 2;
  // loader coordinates: row li of the tile, k offset lk .. lk+3 (two bytes)
  const int li = threadIdx.x / 4;
  const int lk = (threadIdx.x % 4) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TILE_K) {
    const int m = m0 + li;
    const int n = n0 + li;
    const int k = k0 + lk;  // K % 16 == 0: k .. k+3 are all in range
#pragma unroll
    for (int j = 0; j < 4; ++j) As[lk + j][li] = m < M ? x[(size_t)m * K + k + j] : 0.f;
    if (n < N) {
      const uint8_t* rp = nib + (size_t)n * row_bytes + k / 2;
      const uint32_t word = (uint32_t)rp[0] | ((uint32_t)rp[1] << 8);
      const float s = scale[(size_t)n * nblk + k / block_size];  // B % 16 == 0
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[lk + j][li] = nibble(word, j) * s;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[lk + j][li] = 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE_K; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
    }
  }
}

}  // namespace

// planes: bf16 scratch of [3, M, K rounded up to 64] for M > 16 with K % 32
// == 0 (else unused)
extern "C" int dmx_sbfp_linear(const void* x, const void* nibbles, const void* scale,
                               const void* bias, void* out, void* planes, int M, int N, int K,
                               int block_size, void* stream) {
  if (K % 16 != 0 || block_size % 16 != 0 || K % block_size != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  cudaError_t err = cudaSuccess;
  if (M <= 16) {
    err = bfp_wgmma::launch_decode<3, bfp_wgmma::SbfpW>(xf, nibbles, sp, bp, nullptr, op, M, N,
                                                        K, block_size, 0, 0, s);
  } else if (K % 32 == 0) {
    err = bfp_wgmma::launch_prefill<3, bfp_wgmma::SbfpW>(xf, nibbles, sp, bp, nullptr, op, planes,
                                                         M, N, K, block_size, 0, 0, s);
  } else {
    const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
    sbfp_gemm_kernel<<<grid, 256, 0, s>>>(xf, static_cast<const uint8_t*>(nibbles), sp, bp, op, M,
                                          N, K, block_size);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
