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
// Head dim 128 over long key ranges takes the wgmma route (the wrapper's
// attention_route: f32, no bias, from 144 keys, 128 where K/V hold fewer
// heads than q), where the wide kernel's limits are its own: every block
// splits each K/V tile again (at L = S = 4096 causal each K/V row ~16 times
// a (b, h), and twice more over heads repeated 16:8), and mma.sync leaves
// the copies unoverlapped.  flash_attention_kernel_split_kv writes K and V
// of each KV head once as their three planes into a scratch the wrapper
// allocates (V transposed, so that both products read K-major tiles), and
// flash_attention_kernel_wgmma runs B1's Hopper shape over them: a producer
// thread keeps a ring of K and V^T plane tiles in flight with TMA on
// mbarriers, two consumer warpgroups (64 query rows each, setmaxnreg) issue
// wgmma, query head h reading KV head h // (H / Hkv) (no repeat).  The
// arithmetic is the wide kernel's: the same planes (split_pair), the same
// six products with hh apart from the rest in q . k^T, the same softmax;
// only the f32 sums' order differs.  At Qwen3's scoring shape (BH 64 over
// 32 KV heads, L = S = 4096) it runs its six bf16 products at ~67 % of
// the tensor cores' peak, 2.6x the wide kernel (PERF.md).
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

using bfp_wgmma::desc_sw128;
using bfp_wgmma::mbar_arrive;
using bfp_wgmma::mbar_expect_tx;
using bfp_wgmma::mbar_init;
using bfp_wgmma::mbar_wait;
using bfp_wgmma::mma_m16n8k16;
using bfp_wgmma::pin;
using bfp_wgmma::smem_u32;
using bfp_wgmma::split_x;
using bfp_wgmma::tma_load_3d;
using bfp_wgmma::warpgroup_sync;
using bfp_wgmma::wgmma_commit;
using bfp_wgmma::wgmma_fence;
using bfp_wgmma::wgmma_wait0;

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
// head_dim 128 on wgmma and TMA (the wgmma route)
// ---------------------------------------------------------------------------

namespace wg {
constexpr int D = 128;
constexpr int BQ = 128;  // queries a work item: 64 per consumer warpgroup
constexpr int BK = 64;   // keys a tile
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 24;   // setmaxnreg: 128 x 24 + 256 x 240 <= 64K
constexpr int CONSUMER_REGS = 240;
constexpr int SUB = 64 * 128;                     // bytes of a 64-row tile of 64 bf16 (128 B rows)
constexpr int Q_BYTES = CONSUMERS * 3 * 2 * SUB;  // q planes: [warpgroup][plane][half of D]
constexpr int SLOT = 3 * 2 * SUB;  // a K tile [half of D][plane][key] or a V^T tile [plane][d]
constexpr int SMEM = Q_BYTES + 2 * SLOT + 1024;   // + alignment: 193 KB
constexpr int SPLIT_KEYS = 16;                    // keys a block of the pre-pass
// the planes of a and b in KEPT_PLANE_PRODUCTS' i-th product (0 = h, 1 = m,
// 2 = l): hh, hm, mh, hl, lh, mm
__device__ constexpr int kept_a(int i) { return i == 2 || i == 5 ? 1 : i == 4 ? 2 : 0; }
__device__ constexpr int kept_b(int i) { return i == 1 || i == 5 ? 1 : i == 3 ? 2 : 0; }
}  // namespace wg

// The pre-pass: K and V of each KV head n = b * Hkv + hk (read through their
// strides, d contiguous) as their three exact planes, split_pair's
// arithmetic: K into kpl [n][plane][S][128] (pairs along d, as the wide
// kernel splits them), V transposed into vpl [n][plane][128][Sp] (pairs
// along keys; zero at keys S .. Sp - 1).  Grid (Sp / 16, B * Hkv), 128
// threads: a warp takes 4 keys of K (a lane 4 of d), a thread one column d
// of V's 16 keys (a warp reads 32 consecutive floats of a key row).
__global__ void __launch_bounds__(128)
flash_attention_kernel_split_kv(const float* __restrict__ k, const float* __restrict__ v,
                                uint16_t* __restrict__ kpl, uint16_t* __restrict__ vpl, int S,
                                int Sp, int Hkv, long long ksb, long long ksh, long long kss,
                                long long vsb, long long vsh, long long vss) {
  const int n = blockIdx.y, s0 = blockIdx.x * wg::SPLIT_KEYS;
  const int b = n / Hkv, hk = n % Hkv;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float4 f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * warp + i;
    f[i] = s < S ? __ldg(reinterpret_cast<const float4*>(kb + s * kss + 4 * lane))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float x[wg::SPLIT_KEYS];
#pragma unroll
  for (int i = 0; i < wg::SPLIT_KEYS; ++i)
    x[i] = s0 + i < S ? __ldg(vb + (s0 + i) * vss + tid) : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * warp + i;
    if (s >= S) continue;
    uint32_t a[3], c[3];
    split_pair(f[i].x, f[i].y, a);
    split_pair(f[i].z, f[i].w, c);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(kpl + ((size_t)(n * 3 + p) * S + s) * wg::D + 4 * lane) =
          make_uint2(a[p], c[p]);
  }
  uint32_t w[3][wg::SPLIT_KEYS / 2];
#pragma unroll
  for (int i = 0; i < wg::SPLIT_KEYS / 2; ++i) {
    uint32_t o[3];
    split_pair(x[2 * i], x[2 * i + 1], o);
#pragma unroll
    for (int p = 0; p < 3; ++p) w[p][i] = o[p];
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    uint4* dst = reinterpret_cast<uint4*>(vpl + ((size_t)(n * 3 + p) * wg::D + tid) * Sp + s0);
    dst[0] = make_uint4(w[p][0], w[p][1], w[p][2], w[p][3]);
    dst[1] = make_uint4(w[p][4], w[p][5], w[p][6], w[p][7]);
  }
}

// d[64 x 64] (+)= a . b^T, both bf16 K-major tiles in shared memory
// (desc_sw128); acc false: d = a . b^T (wgmma's scale-d)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, bool acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"((int)acc));
}

// d[64 x 128] += a . b^T, a a 64 x 16 bf16 A fragment in registers (mma.sync's
// m16n8k16 A layout in each warp's 16 rows), b a K-major tile in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 0;"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The main kernel.  A work item is 128 query rows of one query head bh (KV
// head bh / group); the items run heaviest first (the last query tiles of
// every head, then the ones before), a persistent block taking items
// blockIdx.x, + gridDim.x, ...  Two shared-memory slots form the ring: slot
// 0 holds a K tile (3 planes x 64 keys x 128 d, two TMA boxes of 64 d),
// slot 1 a V^T tile (3 planes x 128 d x 64 keys); the producer thread loads
// K(j) into slot 0 and V(j) into slot 1 as each frees, running on into the
// next item.  Each consumer warpgroup owns 64 query rows: it splits them
// into its q planes in shared memory at the item's start, then per key tile
// issues S(j) = q . K(j)^T (48 wgmma m64n64k16 from shared memory: hh in
// sh, the five smaller products in sl) and waits for it, takes the online
// softmax on the accumulators, splits P into three planes in registers
// (split_finite_pair) and issues o += P . V(j) (24 wgmma m64n128k16, P from
// registers) and waits for that; the two warpgroups' products interleave on
// the tensor cores.  Issuing S(j + 1) behind P . V(j) before waiting made
// ptxas serialize every wgmma (C7515: the softmax defines S's accumulators
// inside that pipeline stage) and was 16 % slower on an H100 (PERF.md).
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const float* __restrict__ q, float* __restrict__ out, int BH, int L,
                             int S, int group, float scale, int causal, int offset) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[2];
  __shared__ __align__(8) uint64_t empty[2];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* kslot = smem + wg::Q_BYTES;
  unsigned char* vslot = kslot + wg::SLOT;
  const int nq = (L + wg::BQ - 1) / wg::BQ;
  const int items = nq * BH;
  const int wgi = threadIdx.x / 128;
  // the keys that rows [r0, r1) see (r1 clipped to L)
  auto keys_end = [&](int r0, int r1) { return causal ? min(S, min(r1, L) + offset) : S; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], wg::CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == wg::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(wg::PRODUCER_REGS));
    if (threadIdx.x == wg::CONSUMERS * 128) {
      int c = 0;  // tiles loaded: K(c) the c-th use of slot 0, V(c) of slot 1
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int q0 = (nq - 1 - w / BH) * wg::BQ, kv = (w % BH) / group;
        const int nt = (keys_end(q0, q0 + wg::BQ) + wg::BK - 1) / wg::BK;
        for (int j = 0; j < nt; ++j, ++c) {
          mbar_wait(&empty[0], (c & 1) ^ 1);
          mbar_expect_tx(&full[0], wg::SLOT);
          tma_load_3d(kslot, &kmap, &full[0], 0, j * wg::BK, 3 * kv);
          tma_load_3d(kslot + 3 * wg::SUB, &kmap, &full[0], 64, j * wg::BK, 3 * kv);
          mbar_wait(&empty[1], (c & 1) ^ 1);
          mbar_expect_tx(&full[1], wg::SLOT);
          tma_load_3d(vslot, &vmap, &full[1], j * wg::BK, 0, 3 * kv);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(wg::CONSUMER_REGS));
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* qw = smem + wgi * 3 * 2 * wg::SUB;  // this warpgroup's q planes [plane][half]

  float sh[32] = {}, sl[32] = {};  // S's accumulators: hh, the five smaller products
  int c = 0;  // tiles consumed
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    const int q0 = (nq - 1 - w / BH) * wg::BQ, bh = w % BH;
    const int r0 = q0 + 64 * wgi;  // the warpgroup's first row
    const int nt = (keys_end(q0, q0 + wg::BQ) + wg::BK - 1) / wg::BK;
    // keys this warpgroup's rows see: tiles past them are waited for and
    // released, not computed
    const int wkend = r0 >= L ? 0 : keys_end(r0, r0 + 64);
    const int rows[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};

    // the q planes of the warpgroup's 64 rows, in the 128-byte swizzle
    // wgmma reads (16-byte chunk ch of row r at chunk ch ^ (r % 8))
    warpgroup_sync(wgi);  // every warp's last products (which read q) are done
    {
      float4 f[16];
#pragma unroll
      for (int it = 0; it < 16; ++it) {
        const int i = tid + 128 * it, row = r0 + (i >> 5);
        f[it] = row < L ? __ldg(reinterpret_cast<const float4*>(
                              q + ((size_t)bh * L + row) * wg::D + 4 * (i & 31)))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int it = 0; it < 16; ++it) {
        const int i = tid + 128 * it, r = i >> 5, d = 4 * (i & 31);
        uint32_t a[3], b[3];
        split_pair(f[it].x, f[it].y, a);
        split_pair(f[it].z, f[it].w, b);
        const int off = r * 128 + ((((d & 63) >> 3) ^ (r & 7)) << 4) + (d & 7) * 2;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint2*>(qw + (p * 2 + (d >> 6)) * wg::SUB + off) =
              make_uint2(a[p], b[p]);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    warpgroup_sync(wgi);

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
    uint32_t pa[4][3][4];

    for (int j = 0; j < nt; ++j) {
      const int cj = c + j, t0 = j * wg::BK;
      const bool act = t0 < wkend;  // warpgroup-uniform
      mbar_wait(&full[0], cj & 1);
      if (act) {
        // S(j) over the K tile in slot 0: k16 step kk reads half kk / 4 of
        // D, 32 bytes further into each 128-byte row per step
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < wg::D / 16; ++kk) {
          const int hf = kk >> 2, ko = 2 * (kk & 3);
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const uint64_t a = desc_sw128(qw + (wg::kept_a(i) * 2 + hf) * wg::SUB) + ko;
            const uint64_t b = desc_sw128(kslot + (hf * 3 + wg::kept_b(i)) * wg::SUB) + ko;
            if (i == 0)
              wgmma_ss_n64(sh, a, b, kk > 0);
            else
              wgmma_ss_n64(sl, a, b, kk > 0 || i > 1);
          }
        }
        wgmma_commit();
        wgmma_wait0();
        pin(sh);
        pin(sl);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[0]);  // K(j) is read
      if (act) {
        // online softmax, as flash_attention_wide_kernel's; s in sh
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = rows[e >> 1];
            const int col = t0 + 8 * jj + 2 * t + (e & 1);
            const bool ok = col < S && (!causal || col <= row + offset);
            const float x = __fmul_rn(__fadd_rn(sl[4 * jj + e], sh[4 * jj + e]), scale);
            sh[4 * jj + e] = ok ? x : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], sh[4 * jj + e]);
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
        for (int i = 0; i < 32; ++i) {
          sh[i] = expf(sh[i] - ms[(i >> 1) & 1]);
          lrow[(i >> 1) & 1] += sh[i];
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
        // P's A fragments: k16 step kk holds key groups 2kk and 2kk + 1
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t w4[4][3];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_finite_pair(sh[8 * kk + 2 * i], sh[8 * kk + 2 * i + 1], w4[i]);
#pragma unroll
          for (int p = 0; p < 3; ++p)
#pragma unroll
            for (int i = 0; i < 4; ++i) pa[kk][p][i] = w4[i][p];
        }
      }
      mbar_wait(&full[1], cj & 1);
      if (act) {
        pin(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 6; ++i)  // (P, V) planes
            wgmma_rs_n128(o, pa[kk][wg::kept_a(i)],
                          desc_sw128(vslot + wg::kept_b(i) * 2 * wg::SUB) + 2 * kk);
        wgmma_commit();
        wgmma_wait0();
        pin(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[1]);  // V(j) is read
    }
    c += nt;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 1);
      lrow[r] += __shfl_xor_sync(0xffffffffu, lrow[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= L) continue;
      const float inv = 1.f / fmaxf(lrow[r], 1e-30f);
      float* op = out + ((size_t)bh * L + rows[r]) * wg::D + 2 * t;
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        *reinterpret_cast<float2*>(op + 8 * jj) =
            make_float2(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
    }
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

// the wgmma route: the pre-pass into `planes` (K planes [B * Hkv][3][S][128],
// then V^T planes [B * Hkv][3][128][Sp], Sp = S rounded up to 64), then the
// main kernel over one persistent block an SM
cudaError_t launch_wgmma(const float* q, const float* k, const float* v, float* out,
                         uint16_t* planes, int BH, int L, int S, float scale, int causal,
                         int offset, int Hkv, int group, const long long (&ks)[3],
                         const long long (&vs)[3], cudaStream_t stream) {
  if (group < 1 || BH % group || (BH / group) % Hkv) return cudaErrorInvalidValue;
  const int BHkv = BH / group;
  const int Sp = (S + wg::BK - 1) / wg::BK * wg::BK;
  uint16_t* kpl = planes;
  uint16_t* vpl = planes + (size_t)BHkv * 3 * S * wg::D;
  flash_attention_kernel_split_kv<<<dim3(Sp / wg::SPLIT_KEYS, BHkv), 128, 0, stream>>>(
      k, v, kpl, vpl, S, Sp, Hkv, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bfp_wgmma::EncodeTiled encode = bfp_wgmma::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap kmap, vmap;
  const cuuint32_t el[3] = {1, 1, 1};
  {
    const cuuint64_t dims[3] = {(cuuint64_t)wg::D, (cuuint64_t)S, (cuuint64_t)3 * BHkv};
    const cuuint64_t strides[2] = {(cuuint64_t)wg::D * 2, (cuuint64_t)S * wg::D * 2};
    const cuuint32_t box[3] = {64, wg::BK, 3};
    if (encode(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, kpl, dims, strides, box, el,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Sp, (cuuint64_t)wg::D, (cuuint64_t)3 * BHkv};
    const cuuint64_t strides[2] = {(cuuint64_t)Sp * 2, (cuuint64_t)Sp * wg::D * 2};
    const cuuint32_t box[3] = {wg::BK, wg::D, 3};
    if (encode(&vmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, vpl, dims, strides, box, el,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  static bool attr_set = false;
  static int sms = 0;
  if (!attr_set) {
    err = cudaFuncSetAttribute(flash_attention_kernel_wgmma,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, wg::SMEM);
    if (err != cudaSuccess) return err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long items = (long long)(L + wg::BQ - 1) / wg::BQ * BH;
  const int grid = (int)(items < sms ? items : sms);
  flash_attention_kernel_wgmma<<<grid, wg::THREADS, wg::SMEM, stream>>>(
      kmap, vmap, q, out, BH, L, S, group, scale, causal, offset);
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
                                   float scale, int causal, int offset, void* planes, int Hkv,
                                   int group, long long ksb, long long ksh, long long kss,
                                   long long vsb, long long vsh, long long vss, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  if (L <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  // the wgmma route: the wrapper passes the planes' scratch (D 128, no bias;
  // K / V of B * Hkv heads through their strides, query head bh reading KV
  // head bh / group); every other route takes K / V [BH, S, D] contiguous
  if (planes != nullptr) {
    if (D != 128 || bias != nullptr) return (int)cudaErrorInvalidValue;
    const long long ks[3] = {ksb, ksh, kss}, vs[3] = {vsb, vsh, vss};
    return (int)launch_wgmma(qp, kp, vp, op, static_cast<uint16_t*>(planes), BH, L, S, scale,
                             causal, offset, Hkv, group, ks, vs, s);
  }
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
