// B5: SBFP dequant-matmul for Hopper (sm_90a), y = x . W^T + bias, in f32.
//
// Replaces: dmx_compressor_tpu/ops/bfp_linear.py:_sbfp_matmul_pallas (the
// TPU Pallas kernel behind sbfp_linear).
//
// W[n, k] = man[n, k] * scale[n, k / B]: int4 mantissas in [-7, 7] packed two
// to a byte (two's complement, low nibble = even k), one f32 scale per block
// of B along K.  A mantissa has at most 3 significant bits and an SBFP12_16
// scale at most 5, so the dequantized weight is exact in f32 and the only
// difference from the plain PyTorch version (ops/bfp_linear.py:
// sbfp_linear_ref) is the order of the f32 sums.
//
// What bounds it on the card, and what the design does about it:
// - Decode (M <= 8, sbfp_gemv_kernel): bound by the weight stream, 0.75
//   bytes per weight (half a byte of nibbles, a quarter of f32 scale at
//   B = 16) against 2*M flops per weight.  x (at most 8 rows) is staged in
//   shared memory in chunks of 1024 columns, padded by 4 floats every 32 so
//   that the lanes' float4 reads of their 32 columns fall in distinct banks.
//   Each warp owns two output rows; a lane reads 32 mantissas of a row with
//   one 16-byte load (two 8-byte loads when K is not a multiple of 32, where
//   a row's start is only 8-byte aligned), applies the two blocks' scales
//   once in registers and reuses the weights for every row of x.  The warp
//   sums its lanes with shuffles at the end.
// - Prefill (M > 8, sbfp_gemm_kernel): bound by f32 operations.  A plain
//   shared-memory-tiled f32 FMA GEMM (64x64 tile, 4x4 per thread), weight
//   tiles dequantized on their way into shared memory, as in B1.  wgmma, TMA
//   and tensor cores are later work.
// K and B must be multiples of 16 (the wrapper checks); M and N are
// arbitrary.  The launch error is returned to the caller (cudaGetLastError).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GEMV_WARPS = 4;
constexpr int GEMV_ROWS = 2;    // output features per warp
constexpr int GEMV_MT = 8;      // rows of x per block
constexpr int GEMV_KC = 1024;   // columns of x per staged chunk
constexpr int GEMV_XS = GEMV_KC / 32 * 36;  // a staged x row, 32 floats + 4 pad per group

constexpr int TILE = 64;
constexpr int TILE_K = 16;

// the signed value of nibble j (0..7) of a 32-bit word of packed mantissas
__device__ __forceinline__ float nibble(uint32_t word, int j) {
  const int v = (int)((word >> (4 * j)) & 0xfu);
  return (float)(v - ((v > 7) << 4));
}

template <bool VEC16>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
sbfp_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ nib,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int K, int block_size) {
  __shared__ __align__(16) float xs[GEMV_MT * GEMV_XS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * GEMV_WARPS + warp) * GEMV_ROWS;
  const int m0 = blockIdx.y * GEMV_MT;
  const int nblk = K / block_size;
  const int row_bytes = K / 2;
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
      if (m0 + m < M && k < K)  // K % 16 == 0: a float4 never straddles K
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(m0 + m) * K + k));
      *reinterpret_cast<float4*>(&xs[m * GEMV_XS + (kk >> 5) * 36 + (kk & 31)]) = v;
    }
    __syncthreads();

    const int kend = min(GEMV_KC, K - kc);
    for (int c = lane; c * 32 < kend; c += 32) {
      const int k = kc + c * 32;
      const bool hi_half = k + 16 < K;  // false only at a row's end when K % 32 == 16
      float w[GEMV_ROWS][32];
#pragma unroll
      for (int r = 0; r < GEMV_ROWS; ++r) {
        const int n = n0 + r;
        uint32_t words[4] = {0u, 0u, 0u, 0u};
        float s0 = 0.f, s1 = 0.f;
        if (n < N) {
          const uint8_t* rp = nib + (size_t)n * row_bytes + k / 2;
          if (VEC16) {
            const uint4 u = __ldg(reinterpret_cast<const uint4*>(rp));
            words[0] = u.x;
            words[1] = u.y;
            words[2] = u.z;
            words[3] = u.w;
          } else {
            const uint2 a = __ldg(reinterpret_cast<const uint2*>(rp));
            words[0] = a.x;
            words[1] = a.y;
            if (hi_half) {
              const uint2 b = __ldg(reinterpret_cast<const uint2*>(rp + 8));
              words[2] = b.x;
              words[3] = b.y;
            }
          }
          const float* sp = scale + (size_t)n * nblk;
          s0 = sp[k / block_size];
          s1 = hi_half ? sp[(k + 16) / block_size] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 32; ++j)
          w[r][j] = nibble(words[j >> 3], j & 7) * (j < 16 ? s0 : s1);
      }
#pragma unroll
      for (int m = 0; m < GEMV_MT; ++m) {
        if (m0 + m < M) {
          const float4* xp = reinterpret_cast<const float4*>(&xs[m * GEMV_XS + c * 36]);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float4 f = xp[q];
#pragma unroll
            for (int r = 0; r < GEMV_ROWS; ++r) {
              acc[r][m] = fmaf(f.x, w[r][4 * q], acc[r][m]);
              acc[r][m] = fmaf(f.y, w[r][4 * q + 1], acc[r][m]);
              acc[r][m] = fmaf(f.z, w[r][4 * q + 2], acc[r][m]);
              acc[r][m] = fmaf(f.w, w[r][4 * q + 3], acc[r][m]);
            }
          }
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

extern "C" int dmx_sbfp_linear(const void* x, const void* nibbles, const void* scale,
                               const void* bias, void* out, int M, int N, int K,
                               int block_size, void* stream) {
  if (K % 16 != 0 || block_size % 16 != 0 || K % block_size != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* np_ = static_cast<const uint8_t*>(nibbles);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  if (M <= GEMV_MT) {
    const int rows_per_block = GEMV_WARPS * GEMV_ROWS;
    const dim3 grid((N + rows_per_block - 1) / rows_per_block, 1);
    if (K % 32 == 0)
      sbfp_gemv_kernel<true><<<grid, GEMV_WARPS * 32, 0, s>>>(xf, np_, sp, bp, op, M, N, K,
                                                              block_size);
    else
      sbfp_gemv_kernel<false><<<grid, GEMV_WARPS * 32, 0, s>>>(xf, np_, sp, bp, op, M, N, K,
                                                               block_size);
  } else {
    const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
    sbfp_gemm_kernel<<<grid, 256, 0, s>>>(xf, np_, sp, bp, op, M, N, K, block_size);
  }
  return (int)cudaGetLastError();
}
