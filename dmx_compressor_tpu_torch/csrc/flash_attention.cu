// B3: blockwise (flash) attention for Hopper (sm_90a), f32 in and out, on the
// bf16 tensor cores over exact planes.
//
// Replaces: dmx_compressor_tpu/ops/flash_attention.py:_flash_pallas (the
// TPU Pallas kernel behind flash_attention).
//
// out = softmax(q . k^T * scale + bias) . v over [BH, L, D] queries and
// [BH, S, D] keys/values, D 32, 64, 128 or 256 (any D above 256 on the
// generic kernel below), optionally causal with the diagonal at
// offset S - L (row i sees keys j <= i + S - L), optional additive bias
// [BH, L, S].
//
// Numerics.  Every f32 operand is split into three bf16 planes x = h + m +
// l (as split_x of bfp_wgmma.cuh: truncation, exact), and each product of two
// operands is taken as the six plane products hh, hm, mh, hl, lh, mm on
// mma.sync m16n8k16 with f32 accumulators: every plane product is exact in
// f32, and the three dropped ones (ml, lm, ll) lie below 2^-21 of |a||b|
// per term, at the level of f32 rounding.  So q . k^T and P . v keep the
// f32 contract of the plain version (ops/flash_attention.py:
// flash_attention_ref, held at rtol 1e-5, atol 2e-5); one bf16 pass, or
// TF32, would not.  flash_attention_planes_ref transcribes this arithmetic
// for the CPU tests.
//
// What bounds it on the card, and what the design does about it: at the
// prefill's shape (BH 96, L = S = 128, D 64, causal) the whole call is a
// few microseconds of tensor work over 12.6 MB, so latency and occupancy,
// not the tensor rate, are the limit (its byte floor is 0.0038 ms on an
// H100).  FlashAttention-2's shape: a block of 8 warps owns 128 queries of
// one (b, h), each warp 16 rows whose q planes sit in registers as MMA A
// fragments (8 warps measured faster than 4 or 2 at that shape on an H100:
// each K/V tile is split into planes once for twice the rows, at one block
// of ~220 registers a thread per SM).  Key/value tiles of 64 rows are
// copied with cp.async into an f32 staging buffer (the next tile's copy
// overlaps this tile's products), split once into bf16 planes in shared
// memory (rows padded by 8 elements, so ldmatrix reads hit distinct banks)
// and read as B fragments with ldmatrix (K) and ldmatrix.trans (V).  Online softmax in f32 on the
// accumulator fragments (row max by quad shuffles, row sums per thread,
// summed at the end); the m16n8 accumulator layout is the A fragment of the
// P . v product, so P is split into planes in registers and never touches
// shared memory.  Causal key tiles past the block's last row are skipped,
// and a warp skips the 8-key column groups and 16-key steps past its own
// last row.  The output is divided by max(l, 1e-30).
//
// Head dims 128 and 256 (Qwen3, Gemma) take flash_attention_wide_kernel:
// the q planes of a warp in registers would take 96 (D 128) or 192 (D 256)
// registers a thread on top of the output accumulator's 64 / 128, and the
// f32 staging and planes of 64-key tiles 333 KB of shared memory at D 256.
// So the wide kernel keeps the block's q planes in shared memory (read as
// A fragments with ldmatrix at each k16 step), takes 32-key tiles split
// straight from global memory into planes (no f32 staging, no cp.async;
// each thread issues all of its K and V loads of a tile before its first
// split, which took 28-30 % off the kernel on an H100 against a load, split
// and store per float4 (PERF.md); keeping the next tile's rows in
// registers through the products as well gained 0-4 % more at 255
// registers, and was left out), and gives each warp 128 output columns: at D 256 two warps share a
// group of 16 query rows, each computing the group's logits and softmax
// (the same values) and half of P . v.  A block is 8 warps over 128 (D 128)
// or 64 (D 256) queries, 153 or 198 KB of shared memory, one block an SM.
// Over 16 k16 steps (D 256) the largest plane product (hh) accumulates
// apart from the five smaller ones: the tensor cores truncate each add
// into an f32 accumulator, and the small products' sum carries that loss
// only at 2^-8 of the logit's size (the wgmma mainloop's repair, ROADMAP
// Queue C fault 2).
//
// Head dims above 256 take flash_attention_generic_kernel: simple and right
// first, in f32 on the CUDA cores (no planes): a block of 8 warps owns 8
// query rows of one (b, h), one warp a row, and walks 64-key tiles.  A warp
// takes its row's logits of the tile key by key, its lanes over D (the
// sums across the warp), and its online softmax; then one thread a (row,
// dim) rescales its output, kept in `out` itself (each thread's own
// elements; no shared-memory accumulator, so any D fits), and adds the
// tile's P v in key order; the last pass divides by the row sum.  It reads
// each K/V tile once per block from L2 (8 rows a read), so it is bound by
// L2 traffic and the dependent shuffles, not by HBM; its times are in
// PERF.md.  A head_dim below 256 that is no multiple of 8 is zero-padded by
// the wrapper to the next of 32, 64, 128, 256 (exact, as D 80).  q, k, v and
// the bias are float32 here: the wrapper makes f32 contiguous copies of
// fp16 / bf16 operands (a prefill runs once a request; the copies' cost is
// in PERF.md beside the kernel's time).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bfp_wgmma.cuh"

namespace {

using bfp_wgmma::mma_m16n8k16;
using bfp_wgmma::smem_u32;
using bfp_wgmma::split_x;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = 16 * WARPS;  // queries per block, 16 per warp
constexpr int BKEY = 64;        // keys per tile
constexpr int PAD = 8;          // bf16 elements beyond D in a plane row

template <int D>
struct Smem {
  static constexpr int ROW = D + PAD;             // bf16 per plane row
  static constexpr int PLANE = BKEY * ROW;        // bf16 per plane
  static constexpr int STAGE = BKEY * D;          // f32 per staged K or V tile
  static constexpr int BYTES = 2 * STAGE * 4 + 6 * PLANE * 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the three bf16 planes of two finite f32 values as three bf16 pairs (a
// low): h = x truncated, r = x - h and l = r - m exact, m = r truncated, l
// of <= 8 significant bits (bf16-exact down to 2^-133, as in split_x).  It
// differs from split_x only in the sign of a zero m or l, which no sum
// here can see.  Softmax weights (>= 0, finite, or NaN where the row's
// output is NaN anyway) take it directly.
__device__ __forceinline__ void split_finite_pair(float a, float b, uint32_t (&o)[3]) {
  const uint32_t ha = __float_as_uint(a) & 0xffff0000u, hb = __float_as_uint(b) & 0xffff0000u;
  const float ra = __fsub_rn(a, __uint_as_float(ha)), rb = __fsub_rn(b, __uint_as_float(hb));
  const uint32_t ma = __float_as_uint(ra) & 0xffff0000u, mb = __float_as_uint(rb) & 0xffff0000u;
  const float la = __fsub_rn(ra, __uint_as_float(ma)), lb = __fsub_rn(rb, __uint_as_float(mb));
  o[0] = __byte_perm(ha, hb, 0x7632);
  o[1] = __byte_perm(ma, mb, 0x7632);
  o[2] = __byte_perm(__float_as_uint(la), __float_as_uint(lb), 0x7632);
}

// the same for any two f32 values (q, k, v): an inf or NaN keeps h and
// zeroes m and l, as split_x does
__device__ __forceinline__ void split_pair(float a, float b, uint32_t (&o)[3]) {
  if (__builtin_expect(fabsf(a) < INFINITY && fabsf(b) < INFINITY, 1)) {
    split_finite_pair(a, b, o);
    return;
  }
  uint16_t pa[3], pb[3];
  split_x<3>(a, pa);
  split_x<3>(b, pb);
#pragma unroll
  for (int p = 0; p < 3; ++p) o[p] = pa[p] | ((uint32_t)pb[p] << 16);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ bias,
                       float* __restrict__ out, int L, int S, float scale, int causal,
                       int offset) {
  using Sm = Smem<D>;
  constexpr int KD = D / 16;  // k16 steps over the head dim
  constexpr int ND = D / 8;   // n8 tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem[];
  float* kst = reinterpret_cast<float*>(smem);
  float* vst = kst + Sm::STAGE;
  // the planes: K h, m, l, then V h, m, l
  uint16_t* pl = reinterpret_cast<uint16_t*>(smem + 2 * Sm::STAGE * 4);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  // keys the block's rows and this warp's rows can see (none where all of
  // the warp's rows lie past L)
  const int kend = causal ? min(S, min(q0 + BQ, L) + offset) : S;
  const int wkend = q0 + 16 * warp >= L ? 0
                    : causal            ? min(S, min(q0 + 16 * warp + 16, L) + offset)
                                        : S;

  // cp.async of key/value rows t0 .. t0 + 63 into the staging buffer (zero
  // beyond S)
  auto stage = [&](int t0) {
    for (int i = threadIdx.x; i < BKEY * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool in = t0 + r < S;
      const size_t off = (size_t)(in ? t0 + r : 0) * D + c;
      cp_async16(kst + r * D + c, kb + off, in);
      cp_async16(vst + r * D + c, vb + off, in);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  stage(0);

  // this warp's q rows as A fragments of its three planes: qa[p][kk] holds
  // rows g and g + 8, head dims 16kk + 2t, +1 and 16kk + 8 + 2t, +1
  uint32_t qa[3][KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i & 1];
      const int col = 16 * kk + 8 * (i >> 1) + 2 * t;
      float2 f = make_float2(0.f, 0.f);
      if (row < L) f = *reinterpret_cast<const float2*>(q + ((size_t)bh * L + row) * D + col);
      uint32_t o[3];
      split_pair(f.x, f.y, o);
#pragma unroll
      for (int p = 0; p < 3; ++p) qa[p][kk][i] = o[p];
    }

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  for (int t0 = 0; t0 < kend; t0 += BKEY) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // the tile has landed; the last tile's planes are read
    for (int i = threadIdx.x; i < BKEY * D / 4; i += THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const float4 kf = *reinterpret_cast<const float4*>(kst + r * D + c);
      const float4 vf = *reinterpret_cast<const float4*>(vst + r * D + c);
      uint32_t k01[3], k23[3], v01[3], v23[3];
      split_pair(kf.x, kf.y, k01);
      split_pair(kf.z, kf.w, k23);
      split_pair(vf.x, vf.y, v01);
      split_pair(vf.z, vf.w, v23);
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        *reinterpret_cast<uint2*>(pl + p * Sm::PLANE + r * Sm::ROW + c) =
            make_uint2(k01[p], k23[p]);
        *reinterpret_cast<uint2*>(pl + (3 + p) * Sm::PLANE + r * Sm::ROW + c) =
            make_uint2(v01[p], v23[p]);
      }
    }
    __syncthreads();
    if (t0 + BKEY < kend) stage(t0 + BKEY);  // overlaps this tile's products
    const int nk = min(BKEY, wkend - t0);     // keys of this tile this warp can see
    if (nk <= 0) continue;                    // warp-uniform

    // s = q . k^T over this tile's keys: column group j holds keys t0 + 8j ..
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const int mi = lane >> 3;  // the 8x8 matrix whose row address this lane gives
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
#pragma unroll
      for (int kp = 0; kp < 3; ++kp) {  // k's plane
        uint32_t b[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < nk)
            ldsm_x4(b[j], pl + kp * Sm::PLANE + (8 * j + (lane & 7)) * Sm::ROW +
                              16 * (kk + (mi >> 1)) + 8 * (mi & 1));
#pragma unroll
        for (int qp = 0; qp + kp < 3; ++qp) {  // q's plane: hh, hm, hl, mh, mm, lh
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (8 * j < nk) mma_m16n8k16(s[j], qa[qp][kk], b[j][0], b[j][1]);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (8 * j < nk) mma_m16n8k16(s[j], qa[qp][kk + 1], b[j][2], b[j][3]);
        }
      }
    }

    // online softmax: logits, masks, the rows' new maxima (quad shuffles)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int col = t0 + 8 * j + 2 * t + (e & 1);
        const bool ok = col < S && (!causal || col <= row + offset);
        float x = __fmul_rn(s[j][e], scale);
        if (bias != nullptr && ok && row < L)
          x = __fadd_rn(x, bias[((size_t)bh * L + row) * S + col]);
        s[j][e] = ok ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(mrow[r], mx[r]);
      ms[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key so far
      alpha[r] = expf(mrow[r] - ms[r]);
      mrow[r] = m_new;
      lrow[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - ms[e >> 1]);
        lrow[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // o += P . v: key step kk's A fragment is column groups 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < BKEY / 16; ++kk) {
      if (16 * kk >= nk) continue;
      uint32_t pa[3][4];
      {
        uint32_t w[4][3];
        split_finite_pair(s[2 * kk][0], s[2 * kk][1], w[0]);
        split_finite_pair(s[2 * kk][2], s[2 * kk][3], w[1]);
        split_finite_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], w[2]);
        split_finite_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], w[3]);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[p][i] = w[i][p];
      }
#pragma unroll
      for (int vp = 0; vp < 3; ++vp) {  // v's plane
        uint32_t b[ND / 2][4];
#pragma unroll
        for (int j = 0; j < ND / 2; ++j)
          ldsm_x4_trans(b[j], pl + (3 + vp) * Sm::PLANE +
                                  (16 * kk + 8 * (mi & 1) + (lane & 7)) * Sm::ROW +
                                  8 * (2 * j + (mi >> 1)));
#pragma unroll
        for (int pp = 0; pp + vp < 3; ++pp) {  // P's plane
#pragma unroll
          for (int j = 0; j < ND / 2; ++j) {
            mma_m16n8k16(o[2 * j], pa[pp], b[j][0], b[j][1]);
            mma_m16n8k16(o[2 * j + 1], pa[pp], b[j][2], b[j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    const float inv = 1.f / fmaxf(lrow[r], 1e-30f);
    float* op = out + ((size_t)bh * L + rows[r]) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(op + 8 * j) =
          make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// head dims 128 and 256
// ---------------------------------------------------------------------------

constexpr int WBKEY = 32;  // keys per tile

template <int D>
struct Wide {
  static constexpr int DS = D / 128;            // warps sharing a group of 16 rows
  static constexpr int DO = D / DS;             // output columns a warp: 128
  static constexpr int BQ = 16 * WARPS / DS;    // queries a block
  static constexpr int ROW = D + PAD;           // bf16 per plane row
  static constexpr int QPLANE = BQ * ROW;       // bf16 per q plane
  static constexpr int KPLANE = WBKEY * ROW;    // bf16 per K or V plane
  static constexpr int BYTES = (3 * QPLANE + 6 * KPLANE) * 2;
};

// rows n0 .. n0 + ROWS - 1 of each of the N sources src[n] [*, D] f32
// (zero at and beyond `limit`) split into their three planes at dst[n]
// (planes `plane` bf16 apart, rows ROW apart)
template <int D, int ROWS, int N>
__device__ __forceinline__ void split_rows(const float* const (&src)[N], int n0, int limit,
                                           uint16_t* const (&dst)[N], int plane) {
  constexpr int ROW = D + PAD;
  constexpr int PER = ROWS * D / 4 / THREADS;  // float4 a thread and source
  static_assert(ROWS * D / 4 % THREADS == 0, "whole float4 a thread");
  // every load first, so that all of a thread's rows are in flight at once
  // (a shared-memory store between two loads would order them: the
  // compiler cannot tell the generic pointers apart)
  float4 f[N][PER];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      f[n][it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + r < limit)
        f[n][it] = __ldg(reinterpret_cast<const float4*>(src[n] + (size_t)(n0 + r) * D + c));
    }
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int it = 0; it < PER; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      uint32_t a[3], b[3];
      split_pair(f[n][it].x, f[n][it].y, a);
      split_pair(f[n][it].z, f[n][it].w, b);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(dst[n] + p * plane + r * ROW + c) = make_uint2(a[p], b[p]);
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            float* __restrict__ out, int L, int S, float scale, int causal,
                            int offset) {
  using W = Wide<D>;
  constexpr int KD = D / 16;      // k16 steps over the head dim
  constexpr int NO = W::DO / 8;   // n8 output tiles of a warp
  constexpr int ROW = W::ROW;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* qpl = reinterpret_cast<uint16_t*>(smem);  // q h, m, l
  uint16_t* kvpl = qpl + 3 * W::QPLANE;                 // K h, m, l, then V h, m, l

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * W::BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3;
  const int rg = warp / W::DS;      // the warp's group of 16 rows in the block
  const int c0 = (warp % W::DS) * W::DO;  // the warp's first output column
  const int r0 = q0 + 16 * rg;
  const int rows[2] = {r0 + g, r0 + g + 8};
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  const int kend = causal ? min(S, min(q0 + W::BQ, L) + offset) : S;
  const int wkend = r0 >= L ? 0 : causal ? min(S, min(r0 + 16, L) + offset) : S;

  {
    const float* const qs[1] = {q + (size_t)bh * L * D};
    uint16_t* const qd[1] = {qpl};
    split_rows<D, W::BQ>(qs, q0, L, qd, W::QPLANE);
  }
  // the warp's q rows: A fragments of plane p at k16 step kk from here
  const uint16_t* qa_base = qpl + (16 * rg + (lane & 15)) * ROW + 8 * (lane >> 4);

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  for (int t0 = 0; t0 < kend; t0 += WBKEY) {
    __syncthreads();  // the last tile's planes are read (and the q planes written)
    {
      const float* const kvs[2] = {kb, vb};
      uint16_t* const kvd[2] = {kvpl, kvpl + 3 * W::KPLANE};
      split_rows<D, WBKEY>(kvs, t0, S, kvd, W::KPLANE);
    }
    __syncthreads();
    const int nk = min(WBKEY, wkend - t0);  // keys of this tile this warp can see
    if (nk <= 0) continue;                  // warp-uniform

    // s = q . k^T: hh in sh, the five smaller products in sl
    float sh[4][4], sl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[j][e] = sl[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
      uint32_t a[3][2][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        ldsm_x4(a[p][0], qa_base + p * W::QPLANE + 16 * kk);
        ldsm_x4(a[p][1], qa_base + p * W::QPLANE + 16 * (kk + 1));
      }
#pragma unroll
      for (int kp = 0; kp < 3; ++kp) {  // k's plane
        uint32_t b[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (8 * j < nk)
            ldsm_x4(b[j], kvpl + kp * W::KPLANE + (8 * j + (lane & 7)) * ROW +
                              16 * (kk + (mi >> 1)) + 8 * (mi & 1));
#pragma unroll
        for (int qp = 0; qp + kp < 3; ++qp) {  // q's plane
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (8 * j >= nk) continue;
            if (qp + kp == 0) {
              mma_m16n8k16(sh[j], a[qp][0], b[j][0], b[j][1]);
              mma_m16n8k16(sh[j], a[qp][1], b[j][2], b[j][3]);
            } else {
              mma_m16n8k16(sl[j], a[qp][0], b[j][0], b[j][1]);
              mma_m16n8k16(sl[j], a[qp][1], b[j][2], b[j][3]);
            }
          }
        }
      }
    }

    // online softmax, as flash_attention_kernel's
    float s[4][4];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rows[e >> 1];
        const int col = t0 + 8 * j + 2 * t + (e & 1);
        const bool ok = col < S && (!causal || col <= row + offset);
        float x = __fmul_rn(__fadd_rn(sl[j][e], sh[j][e]), scale);
        if (bias != nullptr && ok && row < L)
          x = __fadd_rn(x, bias[((size_t)bh * L + row) * S + col]);
        s[j][e] = ok ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(mrow[r], mx[r]);
      ms[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key so far
      alpha[r] = expf(mrow[r] - ms[r]);
      mrow[r] = m_new;
      lrow[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - ms[e >> 1]);
        lrow[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];

    // o += P . v over this warp's output columns
#pragma unroll
    for (int kk = 0; kk < WBKEY / 16; ++kk) {
      if (16 * kk >= nk) continue;
      uint32_t pa[3][4];
      {
        uint32_t w[4][3];
        split_finite_pair(s[2 * kk][0], s[2 * kk][1], w[0]);
        split_finite_pair(s[2 * kk][2], s[2 * kk][3], w[1]);
        split_finite_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], w[2]);
        split_finite_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], w[3]);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[p][i] = w[i][p];
      }
#pragma unroll
      for (int vp = 0; vp < 3; ++vp) {  // v's plane
#pragma unroll
        for (int j = 0; j < NO / 2; ++j) {
          uint32_t b[4];
          ldsm_x4_trans(b, kvpl + (3 + vp) * W::KPLANE +
                               (16 * kk + 8 * (mi & 1) + (lane & 7)) * ROW + c0 +
                               8 * (2 * j + (mi >> 1)));
#pragma unroll
          for (int pp = 0; pp + vp < 3; ++pp) {  // P's plane
            mma_m16n8k16(o[2 * j], pa[pp], b[0], b[1]);
            mma_m16n8k16(o[2 * j + 1], pa[pp], b[2], b[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
    lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    const float inv = 1.f / fmaxf(lrow[r], 1e-30f);
    float* op = out + ((size_t)bh * L + rows[r]) * D + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<float2*>(op + 8 * j) =
          make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// any head_dim (the wrapper sends those above 256)
// ---------------------------------------------------------------------------

constexpr int GQB = WARPS;  // query rows a block, one warp each
constexpr int GTK = 64;     // keys a tile

__global__ void __launch_bounds__(THREADS)
flash_attention_generic_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               float* __restrict__ out, int L, int S, int D, float scale,
                               int causal, int offset) {
  __shared__ float sp[GQB][GTK];
  __shared__ float s_alpha[GQB], s_l[GQB];
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * GQB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = q0 + warp;
  const bool live = row < L;  // warp-uniform
  const float* qr = q + ((size_t)bh * L + (live ? row : 0)) * D;
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;
  float* ob = out + ((size_t)bh * L + q0) * D;  // the block's rows
  const int nrows = min(GQB, L - q0);
  const int kend = causal ? min(S, min(q0 + GQB, L) + offset) : S;
  float m = -INFINITY, l = 0.f;  // this warp's row, the same in every lane

  for (int t0 = 0; t0 < kend; t0 += GTK) {
    const int nk = min(GTK, kend - t0);
    float mx = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      const int col = t0 + j;
      float x = -INFINITY;
      if (live && (!causal || col <= row + offset)) {  // warp-uniform
        const float* kr = kb + (size_t)col * D;
        float dot = 0.f;
        for (int d = lane; d < D; d += 32) dot = fmaf(__ldg(qr + d), __ldg(kr + d), dot);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        x = __fmul_rn(dot, scale);
        if (bias != nullptr) x = __fadd_rn(x, bias[((size_t)bh * L + row) * S + col]);
      }
      if (lane == 0) sp[warp][j] = x;
      mx = fmaxf(mx, x);
    }
    __syncwarp();
    const float m_new = fmaxf(m, mx);
    const float ms = m_new == -INFINITY ? 0.f : m_new;  // a row with no key so far
    const float alpha = expf(m - ms);
    float psum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float p = expf(sp[warp][j] - ms);
      sp[warp][j] = p;
      psum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
    if (lane == 0) s_alpha[warp] = alpha;
    __syncthreads();
    for (int o = threadIdx.x; o < nrows * D; o += THREADS) {
      const int r = o / D, d = o - r * D;
      float a = t0 == 0 ? 0.f : ob[o] * s_alpha[r];
      const float* vc = vb + (size_t)t0 * D + d;
      for (int j = 0; j < nk; ++j) a = fmaf(sp[r][j], vc[(size_t)j * D], a);
      ob[o] = a;
    }
    __syncthreads();
  }
  if (lane == 0) s_l[warp] = l;
  __syncthreads();
  for (int o = threadIdx.x; o < nrows * D; o += THREADS) ob[o] /= fmaxf(s_l[o / D], 1e-30f);
}

cudaError_t launch_generic(const float* q, const float* k, const float* v, const float* bias,
                           float* out, int BH, int L, int S, int D, float scale, int causal,
                           int offset, cudaStream_t s) {
  const dim3 grid((L + GQB - 1) / GQB, BH);
  flash_attention_generic_kernel<<<grid, THREADS, 0, s>>>(q, k, v, bias, out, L, S, D, scale,
                                                          causal, offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wide(const float* q, const float* k, const float* v, const float* bias,
                        float* out, int BH, int L, int S, float scale, int causal, int offset,
                        cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_attention_wide_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Wide<D>::BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((L + Wide<D>::BQ - 1) / Wide<D>::BQ, BH);
  flash_attention_wide_kernel<D><<<grid, THREADS, Wide<D>::BYTES, s>>>(q, k, v, bias, out, L, S,
                                                                        scale, causal, offset);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, float* out,
                   int BH, int L, int S, float scale, int causal, int offset, cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((L + BQ - 1) / BQ, BH);
  flash_attention_kernel<D><<<grid, THREADS, Smem<D>::BYTES, s>>>(q, k, v, bias, out, L, S,
                                                                   scale, causal, offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dmx_flash_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int BH, int L, int S, int D,
                                   float scale, int causal, int offset, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  if (L <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return (int)launch<32>(qp, kp, vp, bp, op, BH, L, S, scale, causal, offset, s);
    case 64:
      return (int)launch<64>(qp, kp, vp, bp, op, BH, L, S, scale, causal, offset, s);
    case 128:
      return (int)launch_wide<128>(qp, kp, vp, bp, op, BH, L, S, scale, causal, offset, s);
    case 256:
      return (int)launch_wide<256>(qp, kp, vp, bp, op, BH, L, S, scale, causal, offset, s);
    default:  // the wrapper pads any D up to 256 to one of the above
      if (D <= 256) return (int)cudaErrorInvalidValue;
      return (int)launch_generic(qp, kp, vp, bp, op, BH, L, S, D, scale, causal, offset, s);
  }
}
