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
// What bounds it on the card, and what the design does about it:
// - Decode (M <= 8, bfp_gemv_kernel): bound by the int8 weight stream
//   (N*K bytes against 2*M*N*K flops).  x (at most 8 rows) is staged in
//   shared memory in chunks of 1024 columns, padded every 16 floats so that
//   the lanes' 16-float reads fall in distinct banks.  Each warp owns two
//   output rows; a lane reads 16 mantissa bytes of a row with one 16-byte
//   load, dequantizes them once in registers (one exponent per 16 bytes,
//   since blocks are multiples of 16) and reuses them for every row of x.
//   The warp sums its lanes with shuffles at the end.
// - Prefill (M > 8, bfp_gemm_kernel): bound by f32 operations.  A plain
//   shared-memory-tiled f32 FMA GEMM (64x64 tile, 4x4 per thread), weight
//   tiles dequantized on their way into shared memory.  wgmma, TMA,
//   split-K and tensor cores are later work.
// Ragged M, N and K are masked (K or B not a multiple of 16 takes byte
// loads).  The launch error is returned to the caller (cudaGetLastError).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GEMV_WARPS = 4;
constexpr int GEMV_ROWS = 2;    // output features per warp
constexpr int GEMV_MT = 8;      // rows of x per block
constexpr int GEMV_KC = 1024;   // columns of x per staged chunk
constexpr int GEMV_XS = GEMV_KC / 16 * 20;  // a staged x row, 16 floats + 4 pad per chunk

constexpr int TILE = 64;
constexpr int TILE_K = 16;

__device__ __forceinline__ float block_scale(const int8_t* exp, int n, int nblk, int k,
                                             int block_size, int precision) {
  return ldexpf(1.0f, (int)exp[(size_t)n * nblk + k / block_size] + 2 - precision);
}

template <bool VEC>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
bfp_gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ man,
                const int8_t* __restrict__ exp, const float* __restrict__ bias,
                float* __restrict__ out, int M, int N, int K, int block_size,
                int precision) {
  __shared__ __align__(16) float xs[GEMV_MT * GEMV_XS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * GEMV_WARPS + warp) * GEMV_ROWS;
  const int m0 = blockIdx.y * GEMV_MT;
  const int nblk = K / block_size;
  float acc[GEMV_ROWS][GEMV_MT];
#pragma unroll
  for (int r = 0; r < GEMV_ROWS; ++r)
#pragma unroll
    for (int m = 0; m < GEMV_MT; ++m) acc[r][m] = 0.f;

  for (int kc = 0; kc < K; kc += GEMV_KC) {
    __syncthreads();  // the previous chunk of x is consumed
    for (int i = threadIdx.x; i < GEMV_MT * GEMV_KC / 4; i += GEMV_WARPS * 32) {
      const int m = i / (GEMV_KC / 4);
      const int kk = (i % (GEMV_KC / 4)) * 4;
      const int k = kc + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + m < M && k < K) {
        const float* xp = x + (size_t)(m0 + m) * K + k;
        if (VEC) {
          v = __ldg(reinterpret_cast<const float4*>(xp));
        } else {
          v.x = xp[0];
          v.y = k + 1 < K ? xp[1] : 0.f;
          v.z = k + 2 < K ? xp[2] : 0.f;
          v.w = k + 3 < K ? xp[3] : 0.f;
        }
      }
      *reinterpret_cast<float4*>(&xs[m * GEMV_XS + (kk >> 4) * 20 + (kk & 15)]) = v;
    }
    __syncthreads();

    const int kend = min(GEMV_KC, K - kc);
    for (int c = lane; c * 16 < kend; c += 32) {
      const int k = kc + c * 16;
      float w[GEMV_ROWS][16];
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r) {
        const int n = n0 + r;
        if (n < N && VEC) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(man + (size_t)n * K + k));
          const float s = block_scale(exp, n, nblk, k, block_size, precision);
          const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            w[r][j] = (float)(int8_t)((words[j >> 2] >> (8 * (j & 3))) & 0xff) * s;
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j)
            w[r][j] = (n < N && k + j < K)
                          ? (float)man[(size_t)n * K + k + j] *
                                block_scale(exp, n, nblk, k + j, block_size, precision)
                          : 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < GEMV_MT; ++m) {
        if (m0 + m < M) {
          const float4* xp = reinterpret_cast<const float4*>(&xs[m * GEMV_XS + c * 20]);
          float xv[16];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 f = xp[q];
            xv[4 * q] = f.x;
            xv[4 * q + 1] = f.y;
            xv[4 * q + 2] = f.z;
            xv[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int r = 0; r < GEMV_ROWS; ++r)
#pragma unroll
            for (int j = 0; j < 16; ++j) acc[r][m] = fmaf(xv[j], w[r][j], acc[r][m]);
        }
      }
    }
  }

  // each warp sums its lanes; lane 0 writes the warp's rows
#pragma unroll
  for (int r = 0; r < GEMV_ROWS; ++r)
#pragma unroll
    for (int m = 0; m < GEMV_MT; ++m) {
      float v = acc[r][m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int n = n0 + r;
      if (lane == 0 && n < N && m0 + m < M)
        out[(size_t)(m0 + m) * N + n] = v + (bias != nullptr ? bias[n] : 0.f);
    }
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

extern "C" int dmx_bfp_linear(const void* x, const void* man, const void* exp,
                              const void* bias, void* out, int M, int N, int K,
                              int block_size, int precision, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* mp = static_cast<const int8_t*>(man);
  const int8_t* ep = static_cast<const int8_t*>(exp);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  if (M <= GEMV_MT) {
    const int rows_per_block = GEMV_WARPS * GEMV_ROWS;
    const dim3 grid((N + rows_per_block - 1) / rows_per_block, 1);
    if (K % 16 == 0 && block_size % 16 == 0)
      bfp_gemv_kernel<true><<<grid, GEMV_WARPS * 32, 0, s>>>(xf, mp, ep, bp, op, M, N, K,
                                                             block_size, precision);
    else
      bfp_gemv_kernel<false><<<grid, GEMV_WARPS * 32, 0, s>>>(xf, mp, ep, bp, op, M, N, K,
                                                              block_size, precision);
  } else {
    const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
    bfp_gemm_kernel<<<grid, 256, 0, s>>>(xf, mp, ep, bp, op, M, N, K, block_size, precision);
  }
  return (int)cudaGetLastError();
}
