// T1: BFP dequant-matmul on bf16 tensor cores for Hopper (sm_90a):
//   y = bf16(x) . bf16(W)^T + bias, f32 accumulation,
// with optional FLOAT16 output and ResAdd-FLOAT16 epilogues.
//
// Replaces: dmx_compressor_tpu/tools/diag_bfpkernel_ab.py:bfp_matmul_variant
// in its "expand_full" form (the Pallas kernel that runs the main product in
// bf16), which is the matmul of the BASIC fused linear
// (ops/basic_linear.py:fused_basic_linear: "bf16 operands, lossless for <= 8
// quantized mantissa bits, f32 accumulation").
//
// W[n, k] = man[n, k] * 2^(exp[n, k / B] + 2 - precision): an int8 mantissa
// (at most 7 significant bits) times a power of two is exact in bf16,
// subnormals included down to 2^-133.  x is rounded to bf16 (RNE) on its way
// into shared memory; after a BFP cast of <= 8 bits (the only inputs the
// port routes here, PackedBFPLinear._acts_exact_in_bf16) that rounding is
// exact.  The plain version (ops/bfp_linear.py:bfp_linear_bf16_ref) is
// bf16(x).float() @ deq(W).T in f32, so the two differ only in the order of
// the f32 sums.
//
// Epilogue, in this order: + bias; FLOAT16 cast (clamp +-65504, RNE to the
// fp16 grid, flush below 2^-14) when out_fp16; then, when res is given,
// FLOAT16(y + res) (the ResAdd of a residual already on the fp16 grid).
//
// What bounds it on the card, and what the design does about it:
// - Decode (M <= 16): the int8 weight stream (N*K bytes).  A 16 x 32 output
//   tile per CUDA block of two warps (M padded to 16 with zero rows), 16-byte
//   mantissa loads, one exponent per 16 mantissas.
// - Prefill (M > 16): bf16 tensor-core operations.  A 64 x 128 tile per
//   CUDA block of four warps, each warp 32 x 64 as 2 x 4 wmma 16x16x16 bf16
//   fragments with f32 accumulators; K in steps of 64 staged in shared
//   memory as bf16 (x converted, W dequantized on the way in).  No double
//   buffering, cp.async, TMA or wgmma yet: later work.
// Ragged M, N and K are masked (K or B not a multiple of 16 takes scalar
// loads).  The launch error is returned to the caller (cudaGetLastError).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BK = 64;
constexpr int LDS = BK + 8;  // bf16 row pitch of the staged tiles (144 bytes)

// exact 2^k as f32, subnormals included; 0 below 2^-149
__device__ __forceinline__ float pow2_exact(int k) {
  if (k >= -126) return __int_as_float((k + 127) << 23);
  return k >= -149 ? __int_as_float(1 << (k + 149)) : 0.f;
}

__device__ __forceinline__ float fp16_cast(float y) {
  y = y > 65504.f ? 65504.f : (y < -65504.f ? -65504.f : y);
  const float r = __half2float(__float2half_rn(y));
  return fabsf(r) < 6.103515625e-05f ? 0.0f : r;
}

template <int BM, int BN, int WM, int WN, bool VEC>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32)
bfp_bf16_kernel(const float* __restrict__ x, const int8_t* __restrict__ man,
                const int8_t* __restrict__ exp, const float* __restrict__ bias,
                const float* __restrict__ res, float* __restrict__ out, int M, int N, int K,
                int block, int precision, int out_fp16) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NT = (BM / WM) * WARPS_N * 32;
  constexpr int FM = WM / 16;
  constexpr int FN = WN / 16;
  constexpr int LDC = BN + 4;
  constexpr int TILE_BYTES = (BM + BN) * LDS * 2;
  constexpr int C_BYTES = BM * LDC * 4;
  constexpr int SMEM = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;
  // the staged tiles, reused for the f32 output tile after the K loop
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int nblk = K / block;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x: BM x BK f32 -> bf16, 4 values per step
    for (int idx = threadIdx.x; idx < BM * BK / 4; idx += NT) {
      const int r = idx / (BK / 4);
      const int c = (idx % (BK / 4)) * 4;
      const int m = m0 + r;
      const int k = k0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M) {
        const float* xp = x + (size_t)m * K + k;
        if (VEC) {
          if (k < K) v = __ldg(reinterpret_cast<const float4*>(xp));
        } else {
          v.x = k < K ? xp[0] : 0.f;
          v.y = k + 1 < K ? xp[1] : 0.f;
          v.z = k + 2 < K ? xp[2] : 0.f;
          v.w = k + 3 < K ? xp[3] : 0.f;
        }
      }
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(As + r * LDS + c);
      dst[0] = __floats2bfloat162_rn(v.x, v.y);
      dst[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    // W: BN x BK int8 mantissas -> bf16 man * 2^(e + 2 - precision), exact
    for (int idx = threadIdx.x; idx < BN * BK / 16; idx += NT) {
      const int r = idx / (BK / 16);
      const int c = (idx % (BK / 16)) * 16;
      const int n = n0 + r;
      const int k = k0 + c;
      float w[16];
      if (VEC) {
        if (n < N && k < K) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(man + (size_t)n * K + k));
          const float s = pow2_exact((int)exp[(size_t)n * nblk + k / block] + 2 - precision);
          const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int j = 0; j < 16; ++j)
            w[j] = (float)(int8_t)((words[j >> 2] >> (8 * (j & 3))) & 0xff) * s;
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) w[j] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int kk = k + j;
          w[j] = (n < N && kk < K)
                     ? (float)man[(size_t)n * K + kk] *
                           pow2_exact((int)exp[(size_t)n * nblk + kk / block] + 2 - precision)
                     : 0.f;
        }
      }
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(Bs + r * LDS + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = __floats2bfloat162_rn(w[2 * j], w[2 * j + 1]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * WM + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * WN + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are consumed before the next stage (or Cs)
  }

#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * WM + i * 16) * LDC + wn * WN + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * BN; idx += NT) {
    const int r = idx / BN;
    const int c = idx % BN;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m < M && n < N) {
      float y = Cs[r * LDC + c];
      if (bias != nullptr) y = __fadd_rn(y, bias[n]);
      if (out_fp16) y = fp16_cast(y);
      if (res != nullptr) y = fp16_cast(__fadd_rn(y, res[(size_t)m * N + n]));
      out[(size_t)m * N + n] = y;
    }
  }
}

template <int BM, int BN, int WM, int WN>
void launch_tiles(const float* x, const int8_t* man, const int8_t* exp, const float* bias,
                  const float* res, float* out, int M, int N, int K, int block, int precision,
                  int out_fp16, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int threads = (BM / WM) * (BN / WN) * 32;
  if (K % 16 == 0 && block % 16 == 0)
    bfp_bf16_kernel<BM, BN, WM, WN, true><<<grid, threads, 0, s>>>(
        x, man, exp, bias, res, out, M, N, K, block, precision, out_fp16);
  else
    bfp_bf16_kernel<BM, BN, WM, WN, false><<<grid, threads, 0, s>>>(
        x, man, exp, bias, res, out, M, N, K, block, precision, out_fp16);
}

}  // namespace

extern "C" int dmx_bfp_linear_bf16(const void* x, const void* man, const void* exp,
                                   const void* bias, const void* res, void* out, int M, int N,
                                   int K, int block_size, int precision, int out_fp16,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* mp = static_cast<const int8_t*>(man);
  const int8_t* ep = static_cast<const int8_t*>(exp);
  const float* bp = static_cast<const float*>(bias);
  const float* rp = static_cast<const float*>(res);
  float* op = static_cast<float*>(out);
  if (M <= 16)
    launch_tiles<16, 32, 16, 16>(xf, mp, ep, bp, rp, op, M, N, K, block_size, precision,
                                 out_fp16, s);
  else
    launch_tiles<64, 128, 32, 64>(xf, mp, ep, bp, rp, op, M, N, K, block_size, precision,
                                  out_fp16, s);
  return (int)cudaGetLastError();
}
