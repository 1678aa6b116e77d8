// B1: BFP dequant-matmul for Hopper (sm_90a), y = x . W^T + bias, in f32.
//
// Replaces: dmx_compressor_tpu/ops/bfp_linear.py:_bfp_matmul_pallas (the
// TPU Pallas kernel behind bfp_linear).
//
// W[n, k] = man[n, k] * 2^(exp[n, k / B] + 2 - precision): int8 mantissas,
// one int8 exponent per block of B along K.  The scale is a power of two,
// so the dequantized weight is exact and the only difference from the
// plain PyTorch version (ops/bfp_linear.py:bfp_linear_ref) is the order of
// the f32 sums.
//
// What bounds it on the card, and what the design does about it (the three
// kernels are chosen by shape in the C entry point):
// - Decode (M <= 16) with K and B multiples of 16: the tensor-core GEMV of
//   bfp_wgmma.cuh (bfp_decode_kernel, shared with T1) with three bf16 planes
//   of x (x = h + m + l exactly, each product with the exact bf16 weight
//   exact in f32): bound by the int8 weight stream (N*K bytes) and, at
//   OPT-125m's shapes, by launch and cluster-reduction latency (on an H100
//   0.007-0.009 ms at the layer shapes against a 0.0002-0.0008 ms byte
//   floor, 0.049 ms at the 768 x 50272 head against 0.012).
// - Prefill (M > 16) with K and B multiples of 16: the wgmma mainloop of
//   bfp_wgmma.cuh with three bf16 planes of x, so B1's f32 product runs on
//   the bf16 tensor cores, 128-token tiles.  Its floor is now 3 x 2MNK at
//   989 TFLOP/s (0.24 ms at the 1024 x 768 x 50272 head, where it takes
//   0.48 ms on an H100, against the f32 SIMT floor of 1.18 ms that bounded
//   the FMA GEMM); at the layer shapes it sits at 3-4x that floor, held by
//   the per-stage latency of a 12-48-stage K loop.
// - K or B not a multiple of 16, at any M (bfp_gemm_kernel): a plain
//   shared-memory-tiled f32 FMA GEMM (64x64 tile, 4x4 per thread), weight
//   tiles dequantized on their way into shared memory with scalar loads.
// Ragged M, N and K are masked or zero-filled (TMA).  The launch error is
// returned to the caller (cudaGetLastError).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp_wgmma.cuh"

namespace {

constexpr int TILE = 64;
constexpr int TILE_K = 16;

__device__ __forceinline__ float block_scale(const int8_t* exp, int n, int nblk, int k,
                                             int block_size, int precision) {
  return ldexpf(1.0f, (int)exp[(size_t)n * nblk + k / block_size] + 2 - precision);
}

__global__ void __launch_bounds__(256)
bfp_gemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ man,
                const int8_t* __restrict__ exp, const float* __restrict__ bias,
                float* __restrict__ out, int M, int N, int K, int block_size,
                int precision) {
  __shared__ __align__(16) float As[TILE_K][TILE];  // x tile, k-major
  __shared__ __align__(16) float Bs[TILE_K][TILE];  // dequantized W tile, k-major
  const int tx = threadIdx.x % 16;  // output columns tx*4 .. +3
  const int ty = threadIdx.x / 16;  // output rows ty*4 .. +3
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;
  const int nblk = K / block_size;
  // loader coordinates: row li of the tile, k offset lk .. lk+3
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + lk + j;
      As[lk + j][li] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
      Bs[lk + j][li] = (n < N && k < K)
                           ? (float)man[(size_t)n * K + k] *
                                 block_scale(exp, n, nblk, k, block_size, precision)
                           : 0.f;
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

// planes: bf16 scratch of [3, M, K rounded up to 64] for M > 16 (else unused)
extern "C" int dmx_bfp_linear(const void* x, const void* man, const void* exp,
                              const void* bias, void* out, void* planes, int M, int N, int K,
                              int block_size, int precision, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* mp = static_cast<const int8_t*>(man);
  const int8_t* ep = static_cast<const int8_t*>(exp);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  cudaError_t err = cudaSuccess;
  if (K % 16 != 0 || block_size % 16 != 0) {
    const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
    bfp_gemm_kernel<<<grid, 256, 0, s>>>(xf, mp, ep, bp, op, M, N, K, block_size, precision);
  } else if (M <= 16) {
    err = bfp_wgmma::launch_decode<3>(xf, mp, ep, bp, nullptr, op, M, N, K, block_size,
                                      precision, 0, s);
  } else {
    err = bfp_wgmma::launch_prefill<3>(xf, mp, ep, bp, nullptr, op, planes, M, N, K, block_size,
                                       precision, 0, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
