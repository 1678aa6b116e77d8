// B5: SBFP dequant-matmul for Hopper (sm_90a), y = x . W^T + bias, in f32.
//
// Replaces: dmx_compressor_tpu/ops/bfp_linear.py:_sbfp_matmul_pallas (the
// TPU Pallas kernel behind sbfp_linear).
//
// W[n, k] = man[n, k] * scale[n, k / B]: int4 mantissas in [-7, 7] packed two
// to a byte (two's complement, low nibble = even k), one f32 scale per block
// of B along K.  The packer (ops/bfp_pack.py:sbfp_pack) takes any scale
// format, as the JAX package's does, and records from the format whether the
// dequantized weight is exact in bf16 (a 3-bit mantissa times a scale of at
// most 5 significant bits inside bf16's normal range: SBFP12_16 is) and how
// many exact bf16 planes it splits into otherwise (2 up to a 12-bit scale
// mantissa, 3 beyond).
//
// The wrapper (ops/bfp_linear.py:sbfp_route) picks the kernel from M, K,
// the block and those two records, never from the scales, and passes it as
// `route`:
// 0 Tensor cores, bf16-exact weights with K and B multiples of 16.  Up to 16
//   rows the tensor-core GEMV of bfp_wgmma.cuh (bfp_decode_kernel, shared
//   with B1 and T1), three bf16 planes of x, K split over a cluster; above,
//   where K % 32 == 0, the wgmma mainloop of bfp_wgmma.cuh on three planes
//   of x (the pre-pass writes them into the wrapper's scratch): 3 x 2MNK at
//   989 TFLOP/s.
// 1 The f32 GEMV (sbfp_gemv_kernel): every other payload up to 16 rows.  At
//   8 x 768 x 768 it moves 0.47 MB for 9.4 MFLOP, so it is bound by bytes
//   and launch latency, and tensor cores would buy nothing.  The first f32
//   route, a 64 x 64 SIMT tile, idled 56 of its 64 rows there and decoded
//   the nibbles again per tile (11.7x torch.addmm on the dequantized
//   weight).  Now: x is staged once per block in shared memory (its K range;
//   tiled along K where that does not fit), rows padded so that the lanes'
//   16-byte reads hit distinct banks; each warp owns two output columns and
//   streams their nibble rows with 16-, 4- or 1-byte loads (as K and the
//   block allow: one scale per load, two per 16-byte load for B = 16),
//   issued for two words a lane before any is used; each weight is decoded
//   in registers (no conversion instruction), multiplied by its block's
//   scale with __fmul_rn as sbfp_unpack rounds it, and accumulated for every
//   row with fmaf in f32: no plane split, no tensor-core rounding.  The
//   lanes' sums meet in a fixed butterfly; where the column blocks leave the
//   SMs idle, K is split over a thread block cluster of up to 8 blocks whose
//   sums rank 0 adds in rank (K) order from distributed shared memory: the
//   same bits on every run, and no scratch.  Large N loops a block over
//   several column groups with x staged once.
// 2 The planes route: every other payload above 16 rows with K % 32 == 0
//   and B % 16 == 0 whose format splits exactly (PackedSBFP.planes): the
//   wgmma mainloop of bfp_wgmma.cuh with SbfpPlanesW<PW>, each weight
//   dequantized in f32 and split into PW = 2 or 3 bf16 planes beside the
//   three of x: 6 plane products a K step, all exact for PW = 2 (only the
//   summation order differs from sbfp_linear_ref), the 6 largest of 9 for
//   PW = 3 (the dropped terms lie below 2^-20 |x| |w|, bfp_wgmma.cuh).  Its
//   floor is 6 x 2MNK at 989 TFLOP/s.
// 3 What is left (sbfp_gemm_kernel): M > 16 with K % 32 == 16 (a row of
//   nibbles is then no multiple of 16 bytes, which TMA needs) or with a
//   block that is no multiple of 16 (8, 24), or a format without an exact
//   split: a plain shared-memory-tiled f32 FMA GEMM, each weight dequantized
//   in f32 on its way into shared memory, 64 x 64 tiles or, where those
//   would leave three SMs in four idle, 16 x 64, 64 deep in K with every
//   load of a K tile in flight at once.  A K that is no multiple of its 64-wide tile
//   is masked, not padded (padding as the TPU kernel does would copy x and W
//   on every call); the block may be any divisor of K.
// No route reads a scale through bf16.  K must be even and a multiple of B
// (the wrapper checks); M and N are arbitrary.  The launch error is returned
// to the caller (cudaGetLastError).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp_wgmma.cuh"
#include "decode_split.cuh"

namespace {

using bfp_wgmma::nibble_f32;

// ---------------------------------------------------------------------------
// route 1: the f32 GEMV, M <= 16
// ---------------------------------------------------------------------------

constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_COLS = 2;                       // output columns per warp
constexpr int GV_BLOCK_COLS = GV_WARPS * GV_COLS;
constexpr int GV_MAX_SPLIT = 8;                  // a portable cluster
constexpr int GV_UNROLL = 2;                     // words in flight per lane and column

// a lane's load: W nibbles (W = 32: 16 bytes, 8: 4 bytes, 2: one byte)
template <int W>
struct Word;
template <>
struct Word<32> {
  using T = uint4;
  __device__ static uint32_t part(const T& w, int i) {
    return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
  }
};
template <>
struct Word<8> {
  using T = uint32_t;
  __device__ static uint32_t part(const T& w, int) { return w; }
};
template <>
struct Word<2> {
  using T = uint8_t;
  __device__ static uint32_t part(const T& w, int) { return w; }
};

// x's K tile in shared memory: row m at m * xrow, k (tile-relative) at k +
// PAD * (k / W): a lane's words sit W + PAD floats apart, which moves each
// lane's 16-byte reads four banks on
template <int W>
struct XTile {
  static constexpr int PAD = W == 2 ? 2 : 4;
  static constexpr int VEC = W == 2 ? 2 : 4;  // floats a read
  __host__ __device__ static int row(int kt) { return kt + PAD * (kt / W); }
};

// grid (column groups, K splits), cluster (1, K splits); W nibbles a load
// with NS scales a load (one per W / NS nibbles, each inside one block); MR
// rows of x computed (M <= MR, the rest zero); kt_max the K tile
template <int W, int NS, int MR>
__global__ void __launch_bounds__(GV_THREADS, 2)
sbfp_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ nib,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int K, int block, int per_split,
                 int kt_max) {
  namespace cg = cooperative_groups;
  using WT = typename Word<W>::T;
  using XT = XTile<W>;
  constexpr int G = W / NS;  // nibbles under one scale
  extern __shared__ __align__(16) float xs[];
  __shared__ float red[GV_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nblk = K / block;
  const size_t row_bytes = (size_t)K / 2;
  const int ks = gridDim.y;
  const int kb = blockIdx.y * per_split;
  const int ke = min(K, kb + per_split);
  const int xrow = XT::row(kt_max);
  const bool one_tile = ke - kb <= kt_max;

  // stage x[:, k0 .. k1) (tile-relative from k0) and zero the rows past M
  auto stage = [&](int k0, int k1) {
    const int kt = k1 - k0;
    if constexpr (W >= 8) {  // K % 8 == 0: 16-byte rows pieces
      for (int i = threadIdx.x; i < M * (kt / 4); i += GV_THREADS) {
        const int m = i / (kt / 4), kk = (i % (kt / 4)) * 4;
        decode_split::cp_async16(xs + m * xrow + XT::row(kk), x + (size_t)m * K + k0 + kk);
      }
    } else {
      for (int i = threadIdx.x; i < M * kt; i += GV_THREADS) {
        const int m = i / kt, kk = i % kt;
        decode_split::cp_async4(xs + m * xrow + XT::row(kk), x + (size_t)m * K + k0 + kk);
      }
    }
    decode_split::cp_async_commit();
    for (int i = threadIdx.x; i < (MR - M) * kt; i += GV_THREADS) {
      const int m = M + i / kt, kk = i % kt;
      xs[m * xrow + XT::row(kk)] = 0.f;
    }
    decode_split::cp_async_wait<0>();
    __syncthreads();
  };
  if (one_tile) stage(kb, ke);

  const int ncg = (N + GV_BLOCK_COLS - 1) / GV_BLOCK_COLS;
  for (int cgi = blockIdx.x; cgi < ncg; cgi += gridDim.x) {
    const int n0 = cgi * GV_BLOCK_COLS + warp * GV_COLS;  // this warp's columns
    float acc[GV_COLS][MR];
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c)
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[c][m] = 0.f;

    for (int k0 = kb; k0 < ke; k0 += kt_max) {
      const int k1 = min(ke, k0 + kt_max);
      if (!one_tile) {
        __syncthreads();  // every warp is done with the last tile
        stage(k0, k1);
      }
      const int nw = (k1 - k0) / W;  // words of this tile
      for (int w0 = lane; w0 < nw; w0 += 32 * GV_UNROLL) {
        // every load of the step first: the words and their scales
        WT wd[GV_UNROLL][GV_COLS];
        float sc[GV_UNROLL][GV_COLS][NS];
#pragma unroll
        for (int u = 0; u < GV_UNROLL; ++u) {
          const int wi = w0 + 32 * u;
          const int k = k0 + wi * W;
#pragma unroll
          for (int c = 0; c < GV_COLS; ++c) {
            const int n = n0 + c;
            const bool in = wi < nw && n < N;
            wd[u][c] = in ? __ldg(reinterpret_cast<const WT*>(nib + n * row_bytes + k / 2))
                          : WT{};
#pragma unroll
            for (int h = 0; h < NS; ++h)
              sc[u][c][h] = in ? __ldg(scale + (size_t)n * nblk + (k + h * G) / block) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < GV_UNROLL; ++u) {
          const int wi = w0 + 32 * u;
          if (wi >= nw) break;
          const float* xw = xs + XT::row(wi * W);
#pragma unroll
          for (int j = 0; j < W; j += XT::VEC) {
            float xv[MR][XT::VEC];
#pragma unroll
            for (int m = 0; m < MR; ++m) {
              if constexpr (XT::VEC == 4) {
                const float4 f = *reinterpret_cast<const float4*>(xw + m * xrow + j);
                xv[m][0] = f.x;
                xv[m][1] = f.y;
                xv[m][2] = f.z;
                xv[m][3] = f.w;
              } else {
                const float2 f = *reinterpret_cast<const float2*>(xw + m * xrow + j);
                xv[m][0] = f.x;
                xv[m][1] = f.y;
              }
            }
#pragma unroll
            for (int c = 0; c < GV_COLS; ++c) {
              const uint32_t part = Word<W>::part(wd[u][c], j / 8);
#pragma unroll
              for (int e = 0; e < XT::VEC; ++e) {
                const int jj = j + e;
                const float wv =
                    __fmul_rn(nibble_f32(part >> (4 * (jj % 8))), sc[u][c][jj / G]);
#pragma unroll
                for (int m = 0; m < MR; ++m) acc[c][m] = fmaf(xv[m][e], wv, acc[c][m]);
              }
            }
          }
        }
      }
    }

    // the lanes' sums: a butterfly, the same bits in every lane
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c)
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[c][m] += __shfl_xor_sync(0xffffffffu, acc[c][m], o);
    // lane c * MR + m keeps (column c, row m)
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < GV_COLS; ++c)
#pragma unroll
      for (int m = 0; m < MR; ++m)
        if (lane == c * MR + m) v = acc[c][m];
    if (ks > 1) {
      // the cluster's sums, in rank (K) order, in rank 0
      cg::cluster_group cluster = cg::this_cluster();
      red[warp][lane] = v;
      cluster.sync();
      if (blockIdx.y == 0)
        for (int r = 1; r < ks; ++r) v += cluster.map_shared_rank(&red[0][0], r)[warp * 32 + lane];
      cluster.sync();  // the other ranks' sums are read before they move on
      if (blockIdx.y != 0) continue;
    }
    if (lane < GV_COLS * MR) {
      const int c = lane / MR, m = lane % MR, n = n0 + c;
      if (m < M && n < N) out[(size_t)m * N + n] = bias != nullptr ? __fadd_rn(v, bias[n]) : v;
    }
  }
}

// K splits and tile of the GEMV: the x tile (MR rows) must fit 96 KB of
// shared memory, so that two blocks share an SM; where the column groups
// give fewer than two blocks an SM, K splits over up to 8 blocks of at
// least 32 words each
template <int W, int NS, int MR>
cudaError_t launch_gemv(const float* x, const uint8_t* nib, const float* sc, const float* bias,
                        float* out, int M, int N, int K, int block, cudaStream_t s) {
  using XT = XTile<W>;
  constexpr int KT_MAX = MR == 8 ? 2048 : 1024;
  const int nw = K / W;
  const int ncg = (N + GV_BLOCK_COLS - 1) / GV_BLOCK_COLS;
  int ks = (K + KT_MAX - 1) / KT_MAX;
  int fill = (2 * bfp_wgmma::SMS + ncg - 1) / ncg;
  fill = fill < nw / 32 ? fill : nw / 32;
  ks = ks > fill ? ks : fill;
  ks = ks < GV_MAX_SPLIT ? (ks < 1 ? 1 : ks) : GV_MAX_SPLIT;
  const int per_words = (nw + ks - 1) / ks;
  ks = (nw + per_words - 1) / per_words;
  const int per = per_words * W;
  const int kt = per < KT_MAX ? per : KT_MAX;
  const size_t smem = (size_t)MR * XT::row(kt) * sizeof(float);
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        sbfp_gemv_kernel<W, NS, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MR * XT::row(KT_MAX) * sizeof(float)));
    if (err != cudaSuccess) return err;
    opted_in = MR * XT::row(KT_MAX) * sizeof(float);
  }
  int grid_x = 4 * bfp_wgmma::SMS / ks;
  grid_x = ncg < grid_x ? ncg : grid_x;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, ks, 1);
  cfg.blockDim = dim3(GV_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, sbfp_gemv_kernel<W, NS, MR>, x, nib, sc, bias, out, M, N, K,
                            block, per, kt);
}

template <int MR>
cudaError_t gemv(const float* x, const uint8_t* nib, const float* sc, const float* bias,
                 float* out, int M, int N, int K, int block, cudaStream_t s) {
  if (K % 32 == 0 && block % 32 == 0)
    return launch_gemv<32, 1, MR>(x, nib, sc, bias, out, M, N, K, block, s);
  if (K % 32 == 0 && block % 16 == 0)
    return launch_gemv<32, 2, MR>(x, nib, sc, bias, out, M, N, K, block, s);
  if (K % 8 == 0 && block % 8 == 0)
    return launch_gemv<8, 1, MR>(x, nib, sc, bias, out, M, N, K, block, s);
  // any other even K and block: one byte a load, a scale per nibble
  return launch_gemv<2, 2, MR>(x, nib, sc, bias, out, M, N, K, block, s);
}

// ---------------------------------------------------------------------------
// route 3: the SIMT f32 GEMM
// ---------------------------------------------------------------------------

constexpr int TILE_N = 64;
constexpr int TILE_K = 64;
constexpr int TILE_PAD = 4;  // shared rows of TM + 4 floats: transposed stores 4-way at most

// a TM x 64 output tile, 256 threads, TM / 16 x 4 outputs each.  Each K
// tile's loads (x and the nibbles and scales of W) are all issued before
// any is used, so a tile costs one memory latency; a thread loads one k of
// the tile (one scale index, one division) for every fourth row.
template <int TM>
__global__ void __launch_bounds__(256)
sbfp_gemm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ nib,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 float* __restrict__ out, int M, int N, int K, int block_size) {
  constexpr int RM = TM / 16;
  constexpr int XL = TM * TILE_K / 256;      // x loads a thread a tile
  constexpr int WL = TILE_N * TILE_K / 256;  // weights a thread a tile
  __shared__ __align__(16) float As[TILE_K][TM + TILE_PAD];      // x tile, k-major
  __shared__ __align__(16) float Bs[TILE_K][TILE_N + TILE_PAD];  // dequantized W, k-major
  const int tx = threadIdx.x % 16;  // output columns tx*4 .. +3
  const int ty = threadIdx.x / 16;  // output rows ty*RM .. +RM-1
  const int lk = threadIdx.x % TILE_K;  // the k this thread loads
  const int lr = threadIdx.x / TILE_K;  // its rows lr, lr + 4, ...
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TILE_N;
  const int nblk = K / block_size;
  const size_t row_bytes = (size_t)K / 2;

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TILE_K) {
    // past K (a ragged last tile): a zero term
    const int k = k0 + lk;
    const bool in_k = k < K;
    const int kb = in_k ? k / block_size : 0;
    float xv[XL], sv[WL];
    uint32_t bv[WL];
#pragma unroll
    for (int j = 0; j < XL; ++j) {
      const int m = m0 + lr + 4 * j;
      xv[j] = m < M && in_k ? x[(size_t)m * K + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < WL; ++j) {
      const int n = n0 + lr + 4 * j;
      const bool ok = n < N && in_k;
      bv[j] = ok ? nib[(size_t)n * row_bytes + k / 2] : 0u;
      sv[j] = ok ? scale[(size_t)n * nblk + kb] : 0.f;
    }
    __syncthreads();  // the last tile's products are done
#pragma unroll
    for (int j = 0; j < XL; ++j) As[lk][lr + 4 * j] = xv[j];
#pragma unroll
    for (int j = 0; j < WL; ++j)
      Bs[lk][lr + 4 * j] = __fmul_rn(nibble_f32((k & 1) ? bv[j] >> 4 : bv[j]), sv[j]);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TILE_K; ++kk) {
      float av[RM];
      if constexpr (RM == 4) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        av[0] = a.x;
        av[1] = a.y;
        av[2] = a.z;
        av[3] = a.w;
      } else {
        av[0] = As[kk][ty];
      }
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty * RM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j] + (bias != nullptr ? bias[n] : 0.f);
    }
  }
}

}  // namespace

// route: 0 tensor cores, 1 f32 GEMV, 2 weight planes (wplanes 2 or 3), 3
// SIMT GEMM (ops/bfp_linear.py:SBFP_ROUTES); planes: bf16 scratch of [3, M,
// K rounded up to 64] for the wgmma mainloop (routes 0 and 2 above 16 rows;
// else unused)
extern "C" int dmx_sbfp_linear(const void* x, const void* nibbles, const void* scale,
                               const void* bias, void* out, void* planes, int M, int N, int K,
                               int block_size, int route, int wplanes, void* stream) {
  if (K % 2 != 0 || block_size <= 0 || K % block_size != 0) return (int)cudaErrorInvalidValue;
  if (route == 0 && (K % 16 != 0 || block_size % 16 != 0)) return (int)cudaErrorInvalidValue;
  if (route == 1 && M > 16) return (int)cudaErrorInvalidValue;
  if (route == 2 && (M <= 16 || K % 32 != 0 || block_size % 16 != 0 ||
                     (wplanes != 2 && wplanes != 3)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const uint8_t* nb = static_cast<const uint8_t*>(nibbles);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  cudaError_t err = cudaSuccess;
  if (route == 0 && M <= 16) {
    err = bfp_wgmma::launch_decode<3, bfp_wgmma::SbfpW>(xf, nibbles, sp, bp, nullptr, op, M, N,
                                                        K, block_size, 0, 0, s);
  } else if (route == 0 && K % 32 == 0) {
    err = bfp_wgmma::launch_prefill<3, bfp_wgmma::SbfpW>(xf, nibbles, sp, bp, nullptr, op, planes,
                                                         M, N, K, block_size, 0, 0, s);
  } else if (route == 1) {
    err = M <= 8 ? gemv<8>(xf, nb, sp, bp, op, M, N, K, block_size, s)
                 : gemv<16>(xf, nb, sp, bp, op, M, N, K, block_size, s);
  } else if (route == 2 && wplanes == 2) {
    err = bfp_wgmma::launch_prefill<3, bfp_wgmma::SbfpPlanesW<2>>(
        xf, nibbles, sp, bp, nullptr, op, planes, M, N, K, block_size, 0, 0, s);
  } else if (route == 2) {
    err = bfp_wgmma::launch_prefill<3, bfp_wgmma::SbfpPlanesW<3>>(
        xf, nibbles, sp, bp, nullptr, op, planes, M, N, K, block_size, 0, 0, s);
  } else {
    // 64-row tiles unless they leave three SMs in four idle (measured on
    // the H100: 16-row ones lose to them from a quarter of the SMs up)
    const int tiles64 = (N + TILE_N - 1) / TILE_N * ((M + 63) / 64);
    const dim3 block(256);
    if (tiles64 >= bfp_wgmma::SMS / 4)
      sbfp_gemm_kernel<64><<<dim3((N + TILE_N - 1) / TILE_N, (M + 63) / 64), block, 0, s>>>(
          xf, nb, sp, bp, op, M, N, K, block_size);
    else
      sbfp_gemm_kernel<16><<<dim3((N + TILE_N - 1) / TILE_N, (M + 15) / 16), block, 0, s>>>(
          xf, nb, sp, bp, op, M, N, K, block_size);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}
