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
// subnormals included down to 2^-133.  x is rounded to bf16 (RNE); after a
// BFP cast of <= 8 bits (the only inputs the port routes here,
// PackedBFPLinear._acts_exact_in_bf16) that rounding is exact.  The plain
// version (ops/bfp_linear.py:bfp_linear_bf16_ref) is bf16(x).float() @
// deq(W).T in f32, so the two differ only in the order of the f32 sums.
//
// Epilogue, in this order: + bias; FLOAT16 cast (clamp +-65504, RNE to the
// fp16 grid, flush below 2^-14) when out_fp16; then, when res is given,
// FLOAT16(y + res) (the ResAdd of a residual already on the fp16 grid).  It
// runs once per output, on the full sum.
//
// Three kernels, chosen by shape in the C entry point (the decode and the
// prefill kernels take K and the block size as multiples of 16; the rest,
// at any M, take the ragged kernel):
// - Decode, M <= 16: the tensor-core GEMV of bfp_wgmma.cuh
//   (bfp_decode_kernel, shared with B1) with one bf16 plane of x: yT = W .
//   xT on mma.sync m16n8k16, 16 output features on the MMA's rows and the
//   batch of 8 (two tiles of 8 for M <= 16) on its columns, so nothing is
//   padded; W straight from global memory in each lane's k order, K split
//   over the warps of a block and, where the 16-feature tiles do not give
//   two blocks per SM (N = 768: 48 tiles), over a thread block cluster of
//   up to 8 blocks, summed in a fixed order.  Bound by the int8 weight
//   stream (N*K bytes); at OPT-125m's layer shapes it takes 0.005-0.006 ms
//   on an H100 against a 0.0002-0.0008 ms byte floor: launch and reduction
//   latency; at the 768 x 50272 head 0.026 ms against 0.012.
// - Prefill, M > 16: the wgmma mainloop of bfp_wgmma.cuh with one bf16
//   plane of x (P = 1), 256-token tiles where they fill the card (the
//   head), else 128.  At the head (1024 x 768 x 50272, 0.28 ms on an H100
//   against a 0.08 ms tensor-core floor) it is bound by the weight dequant
//   (ALU, ~0.18 ms of mainloop) and the 206 MB f32 output; at the layer
//   shapes (0.018-0.038 ms against 0.002-0.005 ms of bytes) by the
//   per-stage latency of a short K loop.
// - K or the block size not a multiple of 16 (no 16-byte mantissa loads, no
//   TMA strides), at any M: bfp_bf16_ragged_kernel, 64 x 128 tiles of wmma
//   16x16x16 fragments staged through shared memory with scalar loads.
// Ragged M, N and K tails are masked or zero-filled (TMA) in all three.
// The launch error is returned to the caller (cudaGetLastError).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "bfp_wgmma.cuh"

using namespace nvcuda;
using bfp_wgmma::epilogue;
using bfp_wgmma::pow2_exact;

namespace {

// ---------------------------------------------------------------------------
// K or block not a multiple of 16: wmma on tiles staged with scalar loads
// ---------------------------------------------------------------------------

constexpr int RBM = 64, RBN = 128, RWM = 32, RWN = 64;
constexpr int RBK = 64;
constexpr int RLDS = RBK + 8;  // bf16 row pitch of the staged tiles (144 bytes)
constexpr int RWARPS_N = RBN / RWN;
constexpr int RNT = (RBM / RWM) * RWARPS_N * 32;

__global__ void __launch_bounds__(RNT)
bfp_bf16_ragged_kernel(const float* __restrict__ x, const int8_t* __restrict__ man,
                       const int8_t* __restrict__ ex, const float* __restrict__ bias,
                       const float* __restrict__ res, float* __restrict__ out, int M, int N,
                       int K, int block, int precision, int out_fp16) {
  constexpr int FM = RWM / 16;
  constexpr int FN = RWN / 16;
  constexpr int LDC = RBN + 4;
  constexpr int TILE_BYTES = (RBM + RBN) * RLDS * 2;
  constexpr int C_BYTES = RBM * LDC * 4;
  constexpr int SMEM = TILE_BYTES > C_BYTES ? TILE_BYTES : C_BYTES;
  // the staged tiles, reused for the f32 output tile after the K loop
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + RBM * RLDS;
  float* Cs = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x >> 5;
  const int wm = warp / RWARPS_N;
  const int wn = warp % RWARPS_N;
  const int m0 = blockIdx.y * RBM;
  const int n0 = blockIdx.x * RBN;
  const int nblk = K / block;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += RBK) {
    // x: RBM x RBK f32 -> bf16 (RNE)
    for (int idx = threadIdx.x; idx < RBM * RBK; idx += RNT) {
      const int r = idx / RBK, c = idx % RBK;
      const int m = m0 + r, k = k0 + c;
      As[r * RLDS + c] = __float2bfloat16_rn(m < M && k < K ? x[(size_t)m * K + k] : 0.f);
    }
    // W: RBN x RBK int8 mantissas -> bf16 man * 2^(e + 2 - precision), exact
    for (int idx = threadIdx.x; idx < RBN * RBK; idx += RNT) {
      const int r = idx / RBK, c = idx % RBK;
      const int n = n0 + r, k = k0 + c;
      const float w = (n < N && k < K) ? (float)man[(size_t)n * K + k] *
                                             pow2_exact((int)ex[(size_t)n * nblk + k / block] +
                                                        2 - precision)
                                       : 0.f;
      Bs[r * RLDS + c] = __float2bfloat16_rn(w);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < RBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * RWM + i * 16) * RLDS + kk, RLDS);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * RWN + j * 16) * RLDS + kk, RLDS);
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
      wmma::store_matrix_sync(Cs + (wm * RWM + i * 16) * LDC + wn * RWN + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < RBM * RBN; idx += RNT) {
    const int r = idx / RBN, c = idx % RBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      out[(size_t)m * N + n] = epilogue(Cs[r * LDC + c], bias, res, out_fp16, m, n, N);
  }
}

}  // namespace

// planes: bf16 scratch of [M, K rounded up to 64] for M > 16 (else unused)
extern "C" int dmx_bfp_linear_bf16(const void* x, const void* man, const void* exp,
                                   const void* bias, const void* res, void* out, void* planes,
                                   int M, int N, int K, int block_size, int precision,
                                   int out_fp16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int8_t* mp = static_cast<const int8_t*>(man);
  const int8_t* ep = static_cast<const int8_t*>(exp);
  const float* bp = static_cast<const float*>(bias);
  const float* rp = static_cast<const float*>(res);
  float* op = static_cast<float*>(out);
  cudaError_t err;
  if (K % 16 != 0 || block_size % 16 != 0) {
    const dim3 grid((N + RBN - 1) / RBN, (M + RBM - 1) / RBM);
    bfp_bf16_ragged_kernel<<<grid, RNT, 0, s>>>(xf, mp, ep, bp, rp, op, M, N, K, block_size,
                                                precision, out_fp16);
    err = cudaGetLastError();
  } else if (M <= 16) {
    err = bfp_wgmma::launch_decode<1>(xf, mp, ep, bp, rp, op, M, N, K, block_size, precision,
                                      out_fp16, s);
  } else {
    err = bfp_wgmma::launch_prefill<1>(xf, mp, ep, bp, rp, op, planes, M, N, K, block_size,
                                       precision, out_fp16, s);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
