// The Hopper (sm_90a) kernels shared by T1 (bfp_linear_bf16.cu, one bf16
// plane of x), B1 (bfp_linear.cu, three bf16 planes of x) and B5
// (sbfp_linear.cu, three planes): y[M, N] = x[M, K] . W[N, K]^T + bias (+
// T1's FLOAT16 epilogues), with the weight kept packed in device memory in
// one of two formats, a template policy of every kernel here (BfpW, SbfpW,
// SbfpPlanesW): the BFP weight W[n, k] = man[n, k] * 2^(exp[n, k / B] + 2 -
// precision), int8 mantissas and int8 exponents, or the SBFP weight W[n, k]
// = man[n, k] * scale[n, k / B], int4 mantissas two to a byte and f32
// scales.  BfpW and SbfpW dequantize exactly into one bf16 plane;
// SbfpPlanesW (B5's f32 route: SBFP formats whose weights bf16 does not
// hold, up to 24 significant bits) dequantizes in f32 and splits each
// weight into PW = 2 or 3 exact bf16 planes, the policy's PLANES.  Up to 16
// rows of x, a tensor-core GEMV (bfp_decode_kernel, its note below; one
// plane only); above, the wgmma mainloop this note describes.
//
// x planes.  A pre-pass kernel (split_planes_kernel, launched by the same C
// entry point) writes x as P bf16 planes into a scratch buffer the wrapper
// allocates ([P, M, Kp], Kp = K rounded up to 64, zero beyond K):
// - P = 1 (T1): bf16(x), round to nearest even, as the plain version rounds.
// - P = 3 (B1): x = h + m + l exactly, each plane the high half of an f32:
//   h = x with its low 16 bits cleared (truncation: RNE could round x near
//   FLT_MAX up to inf), r = x - h (exact), m = r truncated the same way,
//   l = r - m (exact) truncated to bf16.  h + m + l == x bit for bit where
//   |x| >= 2^-110; below that the part of l under bf16's last subnormal bit
//   (2^-133) is lost.  A non-finite x keeps h (a NaN stays a NaN: its
//   quiet bit is set, since its payload may lie in the low half) and zeroes
//   m and l.  W is exact in bf16 (BFP: <= 7 significant bits times a power
//   of two, down to 2^-133; SBFP: a 3-bit mantissa times a scale of <= 5
//   significant bits, which sbfp_pack records), so every product h.w, m.w,
//   l.w is exact in f32 and three tensor-core products per K step give B1's
//   and B5's f32 products, differing from their plain versions only in how
//   the f32 sums are taken.
// - Weight planes (SbfpPlanesW<PW>): the f32 weight w = man * scale
//   (__fmul_rn, as sbfp_unpack rounds it) splits the same way into w = hw
//   + mw (+ lw), exact where w has <= 8 PW significant bits and none below
//   2^-133, which sbfp_pack decides from the format (PackedSBFP.planes).
//   Each x plane meets each weight plane: for PW = 2 all 6 products are
//   exact and kept (the sum differs from sbfp_linear_ref only in its
//   order); for PW = 3 the 6 largest of 9, as B3 takes them: the dropped
//   mx.lw, lx.mw and lx.lw lie below 2^-20 |x| |w| a term (|m| < 2^-7 |v|,
//   |l| < 2^-14 |v| of the value v they split).
//
// Where the dequant goes.  A and B are swapped: W is wgmma's A operand
// (output features on its 64 rows per warpgroup), x's tokens its N.  Each
// consumer thread dequantizes its 16 mantissas of two weight rows per
// stage (no conversion instruction: the format's deq4) and stores them as
// bf16 into its warpgroup's 64 x 64 A tile in shared memory (one tile per
// weight plane), in the 128-byte swizzle wgmma reads, then
// `fence.proxy.async`.  One dequant serves all P planes and all BM tokens.  A tile in shared memory rather than in registers:
// ptxas serializes every wgmma (C7513) when registers that wgmma reads are
// written while another wgmma is in flight, so register-sourced A cannot
// overlap the next stage's dequant with the current products; two A tiles
// per warpgroup can.
//
// Shape.  A block is 3 warpgroups: two consumers (64 weight rows each, a
// 128-feature tile; BM / 2 f32 accumulators per thread, twice that where x
// or the weight has more than one plane: the largest product in one set,
// the smaller ones in the other; 232 registers by setmaxnreg) and a producer whose one thread keeps a ring of STAGES tiles
// in flight with TMA (x planes: BM x 64 bf16 each, 128-byte swizzle; W:
// 128 rows of 64 int8 (BFP) or 32 bytes of nibbles (SBFP)), completed on
// mbarriers.  A consumer issues a stage's P x PW x 4 wgmmas (PW = 3: 6 x 4),
// then waits for the
// previous stage's (`wgmma.wait_group 1`) and releases its tiles, so each
// stage's dequant overlaps the last stage's products.  Exponents and
// scales (one per thread and row per stage: B is a multiple of 16) are
// loaded EXP_AHEAD stages before their use.  BM is 256 tokens where those
// tiles alone fill the card (T1's head: the dequant per product halves),
// else 128 (three 256-row planes leave no room for a ring).  Blocks are
// persistent, one per SM, walking the tiles with M fastest, so the tiles
// that share a weight tile run together and W streams
// from device memory about once; the producer runs on into the next tile
// while the consumers store the last one, each warp through a small buffer
// that turns its fragments into 16-byte row stores.  Where the tiles do not
// fill the card (out_proj and fc2 at M = 1024: 48 tiles) K is split over a
// thread block cluster of up to 8 blocks, one tile each; rank 0 sums the
// others' accumulator tiles from distributed shared memory in rank order
// (the same sum on every run) and runs the epilogue once.
//
// What bounds it: at T1's head the dequant (ALU, ~0.18 ms of mainloop on an
// H100 measured with the epilogue removed) and the 206 MB f32 output; at
// B1's head the 3 x 2MNK bf16 tensor-core operations (989 TFLOP/s); at the
// narrow shapes the per-stage latency of a ring that is only 6-12 stages
// deep per tile.  The pre-pass moves M x K x (4 + 2P) bytes.  Needs the
// block size as a multiple of 16 (one exponent or scale per 16 mantissas)
// and K as a multiple of 16 (BFP) or 32 (SBFP: a row of nibbles is K / 2
// bytes, and a TMA stride is a multiple of 16 bytes); the callers keep
// their plain-load kernels for the rest.

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bfp_wgmma {

constexpr int BN = 128;  // weight rows (output features) per block, 64 per consumer
constexpr int BK = 64;   // K per stage
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and one producer warpgroup
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: the producer gives its registers
constexpr int CONSUMER_REGS = 232;  // to the consumers (128 x 40 + 256 x 232 <= 64K)
constexpr int SMS = 132;  // H100 SXM
constexpr int MAX_CLUSTER = 8;
constexpr int EXP_AHEAD = 4;  // stages ahead that a consumer loads its exponents
// the most K chunks (of BK) that one block's accumulators take: the tensor
// cores truncate every add into an accumulator, so its error grows with the
// adds it takes (at Gemma's down_proj prefill, K 16384 in one block, B1 was
// 4.7e-4 off its plain version against 1e-4 + 1e-5 |y|); a longer K is
// split over the cluster, whose partial tiles are summed in rounded f32
// adds.  96 chunks (K 6144) leave every OPT, Llama and Qwen3 shape as it was
constexpr int ACC_CHUNKS = 96;
// each consumer warp's epilogue buffer: 8 tokens x 16 features, rows padded
// to 20 floats (the lanes' writes fall in distinct banks, rows stay 16-byte
// aligned)
constexpr int OUT_PITCH = 20;
constexpr int OUT_BYTES = CONSUMERS * 4 * 8 * OUT_PITCH * 4;

// P planes of x; BM x rows (tokens) per block, the wgmma's N: 256 where the
// tiles fill the card (T1's head), so that a weight tile's dequant serves
// twice the products, else 128; W the weight format (BfpW, SbfpW)
template <int P, int BM_, class W>
struct Cfg {
  static constexpr int BM = BM_;
  static constexpr int ACC = BM / 2;  // f32 accumulators per consumer thread
  static constexpr int X_BYTES = P * BM * BK * 2;
  static constexpr int W_ROW = BK / 16 * W::BYTES16;  // a weight row's bytes per stage
  static constexpr int W_BYTES = BN * W_ROW;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static_assert(STAGE_BYTES % 1024 == 0, "each stage's x tiles 1024-byte aligned");
  // each consumer warpgroup's dequantized weight tiles, bf16 64 x 64, one
  // per weight plane, two sets
  static constexpr int A_BYTES = 64 * BK * 2;
  static constexpr int A_SET = W::PLANES * A_BYTES;
  // as many stages as shared memory holds (227 KB) beside the A tiles and
  // the epilogue buffers, at most 8: 7 x 24 KB (P 1, BM 128), 4 x 40 KB
  // (BM 256), 3 x 56 KB (P 3, BFP), 3 x 52 KB (P 3, SBFP and two weight
  // planes), 2 x 52 KB (three weight planes)
  static constexpr int FIT =
      (232448 - 1024 - 256 - CONSUMERS * 2 * A_SET - OUT_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int A_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int OUT_OFFSET = A_OFFSET + CONSUMERS * 2 * A_SET;
  static constexpr int SMEM = OUT_OFFSET + OUT_BYTES + 1024;  // + alignment
  static_assert(STAGES * STAGE_BYTES >= BM * BN * 4, "the ring holds the f32 tile");
};

// ---------------------------------------------------------------------------
// numerics shared with the callers
// ---------------------------------------------------------------------------

// exact 2^k as f32, subnormals included; 0 below 2^-149
__device__ __forceinline__ float pow2_exact(int k) {
  if (k >= -126) return __int_as_float((k + 127) << 23);
  return k >= -149 ? __int_as_float(1 << (k + 149)) : 0.f;
}

// FLOAT16: clamp +-65504, RNE to the fp16 grid, flush below 2^-14
__device__ __forceinline__ float fp16_cast(float y) {
  y = y > 65504.f ? 65504.f : (y < -65504.f ? -65504.f : y);
  const float r = __half2float(__float2half_rn(y));
  return fabsf(r) < 6.103515625e-05f ? 0.0f : r;
}

// + bias; FLOAT16 when out_fp16; FLOAT16(y + res) when res is given
__device__ __forceinline__ float epilogue(float y, const float* bias, const float* res,
                                          int out_fp16, int m, int n, int N) {
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  if (out_fp16) y = fp16_cast(y);
  if (res != nullptr) y = fp16_cast(__fadd_rn(y, res[(size_t)m * N + n]));
  return y;
}

// int8 mantissas to exact f32 and bf16 without the conversion unit: byte j
// of w ^ 0x80808080 is the mantissa + 128, placed under the exponent of 2^23
// it reads 2^23 + 128 + man, and a subtraction leaves man exactly
__device__ __forceinline__ float deq_byte(uint32_t w, int j, float s) {
  const uint32_t biased = __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 | j);
  return (__uint_as_float(biased) - 8388736.0f) * s;
}

// mantissas j and j + 1 of w times s as a bf16 pair, the lower k in the low
// half: each product is exact in bf16 (<= 7 significant bits), so its bf16
// bits are the high half of its f32 bits (subnormals included)
__device__ __forceinline__ uint32_t deq_pair(uint32_t w, int j, float s) {
  return __byte_perm(__float_as_uint(deq_byte(w, j, s)), __float_as_uint(deq_byte(w, j + 1, s)),
                     0x7632);
}

// d = a * b + c on bf16 pairs, rounded once to nearest
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// ---------------------------------------------------------------------------
// the weight formats: how 16 consecutive weights of a row are stored (Word,
// BYTES16 bytes), the per-block scale kept beside them (Scale; scale() gives
// it as an f32 factor), and deq4, which turns weights 4q .. 4q+3 of the 16
// into two bf16 pairs, each holding the lower k in its low half
// ---------------------------------------------------------------------------

// BFP (B1, T1): int8 mantissas times 2^(exponent + 2 - precision), one int8
// exponent per block
struct BfpW {
  using Scale = int8_t;
  using Word = uint4;
  static constexpr int BYTES16 = 16;
  static constexpr int PLANES = 1;
  __device__ static float scale(Scale e, int precision) {
    return pow2_exact((int)e + 2 - precision);
  }
  __device__ static void deq4(const Word w, int q, float s, uint32_t& lo, uint32_t& hi) {
    const uint32_t v = q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
    lo = deq_pair(v, 0, s);
    hi = deq_pair(v, 2, s);
  }
};

// SBFP (B5): int4 two's-complement mantissas in [-8, 7], two to a byte (the
// low nibble the even k), times one f32 scale per block.  The product of a
// 3-bit mantissa and a scale of <= 5 significant bits is exact in bf16, so
// the decode runs on bf16 pairs without a conversion instruction: a byte
// permute puts the two nibbles of a byte at bits 0 and 16, (nib ^ 8) under
// the exponent of 128 reads 136 + man in bf16, one pair FMA subtracts 136
// and one multiplies by the scale (the high half of its f32 bits), both
// exact.
struct SbfpW {
  using Scale = float;
  using Word = uint2;
  static constexpr int BYTES16 = 8;
  static constexpr int PLANES = 1;
  __device__ static float scale(Scale s, int) { return s; }
  // byte i of v (its two nibbles) as a bf16 pair times s2
  __device__ static uint32_t byte_pair(uint32_t v, int i, uint32_t s2) {
    const uint32_t b = (__byte_perm(v, v >> 4, i | ((4 + i) << 8)) & 0x000F000Fu) ^ 0x43084308u;
    return fma_bf16x2(fma_bf16x2(b, 0x3F803F80u, 0xC308C308u), s2, 0x80008000u);
  }
  __device__ static void deq4(const Word w, int q, float s, uint32_t& lo, uint32_t& hi) {
    const uint32_t sh = __float_as_uint(s) >> 16;
    const uint32_t s2 = sh | (sh << 16);
    const uint32_t v = q < 2 ? w.x : w.y;
    lo = byte_pair(v, 2 * (q & 1), s2);
    hi = byte_pair(v, 2 * (q & 1) + 1, s2);
  }
};

// the x plane values of one f32 (bf16 bit patterns); P = 2 (weights only:
// finite, <= 16 significant bits) keeps h and m
template <int P>
__device__ __forceinline__ void split_x(float x, uint16_t (&out)[P]) {
  if constexpr (P == 1) {
    const __nv_bfloat16 b = __float2bfloat16_rn(x);
    out[0] = *reinterpret_cast<const uint16_t*>(&b);
  } else if constexpr (P == 2) {
    const uint32_t bits = __float_as_uint(x);
    const uint32_t h = bits & 0xffff0000u;
    const float r = __fsub_rn(x, __uint_as_float(h));
    out[0] = (uint16_t)(h >> 16);
    out[1] = (uint16_t)(((__float_as_uint(r) & 0xffff0000u) | (bits & 0x80000000u)) >> 16);
  } else {
    const uint32_t bits = __float_as_uint(x);
    uint32_t h = bits & 0xffff0000u, m = 0, l = 0;
    if (isnan(x)) {
      h |= 0x00400000u;
    } else if (isfinite(x)) {
      // m and l carry x's sign where they are zero too, so that -0.0
      // splits into three -0.0 and h + m + l keeps the sign of a zero
      const uint32_t sign = bits & 0x80000000u;
      const float r = __fsub_rn(x, __uint_as_float(h));
      m = (__float_as_uint(r) & 0xffff0000u) | sign;
      l = (__float_as_uint(__fsub_rn(r, __uint_as_float(m))) & 0xffff0000u) | sign;
    }
    out[0] = (uint16_t)(h >> 16);
    out[1] = (uint16_t)(m >> 16);
    out[2] = (uint16_t)(l >> 16);
  }
}

// an int4 two's-complement nibble (in the low 4 bits of v) as an exact f32
// without the conversion unit: (v ^ 8) = man + 8 under the exponent of 2^23
// reads 2^23 + 8 + man, and one exact subtraction leaves man
__device__ __forceinline__ float nibble_f32(uint32_t v) {
  return __uint_as_float(((v & 0xFu) ^ 8u) | 0x4B000000u) - 8388616.0f;
}

// SBFP weights that bf16 does not hold (B5's f32 route): SbfpW's payload,
// each weight dequantized in f32 as sbfp_unpack rounds it (__fmul_rn) and
// split into PW exact bf16 planes (split_x: h + m (+ l))
template <int PW>
struct SbfpPlanesW {
  using Scale = float;
  using Word = uint2;
  static constexpr int BYTES16 = 8;
  static constexpr int PLANES = PW;
  __device__ static float scale(Scale s, int) { return s; }
  // the 16 weights as 8 bf16 pairs per plane, pair i holding k = 2i, 2i + 1
  __device__ static void deq16(const Word w, float s, uint32_t (&o)[PW][8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t byte = (i < 4 ? w.x : w.y) >> (8 * (i & 3));
      uint16_t lo[PW], hi[PW];
      split_x<PW>(__fmul_rn(nibble_f32(byte), s), lo);
      split_x<PW>(__fmul_rn(nibble_f32(byte >> 4), s), hi);
#pragma unroll
      for (int p = 0; p < PW; ++p) o[p][i] = lo[p] | ((uint32_t)hi[p] << 16);
    }
  }
};

// all 16 weights of a Word as 8 bf16 pairs per weight plane, pair i holding
// k = 2i and 2i + 1
template <class W>
__device__ __forceinline__ void deq16(const typename W::Word w, float s,
                                      uint32_t (&o)[W::PLANES][8]) {
  if constexpr (W::PLANES == 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) W::deq4(w, q, s, o[0][2 * q], o[0][2 * q + 1]);
  } else {
    W::deq16(w, s, o);
  }
}

// One thread per (row m, group of 16 columns): reads x[m, 16q .. 16q+15]
// and writes its P planes there.
template <int P>
__global__ void __launch_bounds__(256)
split_planes_kernel(const float* __restrict__ x, uint16_t* __restrict__ planes, int M, int K,
                    int Kp) {
  const int groups = Kp / 16;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)M * groups) return;
  const int m = (int)(idx / groups);
  const int q = (int)(idx % groups);
  const int k = 16 * q;
  float v[16];
  if (k < K) {
    const float4* xp = reinterpret_cast<const float4*>(x + (size_t)m * K + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = __ldg(xp + i);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = 0.f;
  }
  uint16_t pl[16][P];
#pragma unroll
  for (int i = 0; i < 16; ++i) split_x<P>(v[i], pl[i]);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = pl[2 * i][p] | ((uint32_t)pl[2 * i + 1][p] << 16);
    uint4* dst = reinterpret_cast<uint4*>(planes + ((size_t)p * M + m) * Kp + k);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a K-major bf16 tile of 64-element (128-byte) rows in the 128-byte swizzle
// TMA writes, 1024-byte aligned: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// A compiler fence on the accumulators, which wgmma writes asynchronously:
// no access to them moves across it (around the wgmma fence and waits)
template <int A>
__device__ __forceinline__ void pin(float (&d)[A]) {
#pragma unroll
  for (int i = 0; i < A; i += 16)
    asm volatile("" : "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),
                 "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7]), "+f"(d[i + 8]), "+f"(d[i + 9]),
                 "+f"(d[i + 10]), "+f"(d[i + 11]), "+f"(d[i + 12]), "+f"(d[i + 13]),
                 "+f"(d[i + 14]), "+f"(d[i + 15])::"memory");
}

// the 128 threads of one warpgroup meet (barrier id 1 + warpgroup)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// d[64 x N] += a[64 x 16] . b[N x 16]^T, N = 128 or 256 (d: N / 2 floats a
// thread), both bf16 K-major tiles in shared memory (desc_sw128)
__device__ __forceinline__ void wgmma_m64k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 0;"
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
      : "l"(a), "l"(b));
}

__device__ __forceinline__ void wgmma_m64k16(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "%128, %129, 1, 1, 1, 0, 0;"
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
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(a), "l"(b));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// the epilogue of one tile from a consumer thread's accumulators: acc[4j + e]
// is weight row `row` (acc[4j + 2 + e]: row + 8) and token 8j + 2t + e.  A
// warp's 16 features x 8 tokens of each j pass through its buffer `buf`, so
// that a lane stores 4 consecutive features of one token with one 16-byte
// store (N a multiple of 4; else, and at the ragged edge, one at a time).
template <int A>
__device__ __forceinline__ void store_tile(const float (&acc)[A], float* buf, const float* bias,
                                           const float* res, float* out, int M, int N,
                                           int out_fp16, int m0, int n0, int row, int t) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int tm = lane >> 2, tc = lane & 3;  // the token and the 4 features this lane stores
  const int n = n0 + (row - g) + 4 * tc;    // row - g: the warp's first feature
  const bool vec = (N & 3) == 0 && n + 3 < N;
  float4 b4 = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr && vec) b4 = *reinterpret_cast<const float4*>(bias + n);
#pragma unroll
  for (int j = 0; j < A / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      buf[(2 * t + e) * OUT_PITCH + g] = acc[4 * j + e];
      buf[(2 * t + e) * OUT_PITCH + g + 8] = acc[4 * j + 2 + e];
    }
    __syncwarp();
    float4 v = *reinterpret_cast<const float4*>(buf + tm * OUT_PITCH + 4 * tc);
    __syncwarp();  // read before the next j writes
    const int m = m0 + 8 * j + tm;
    if (m >= M) continue;
    if (vec) {
      if (bias != nullptr) {
        v.x = __fadd_rn(v.x, b4.x);
        v.y = __fadd_rn(v.y, b4.y);
        v.z = __fadd_rn(v.z, b4.z);
        v.w = __fadd_rn(v.w, b4.w);
      }
      if (out_fp16) {
        v.x = fp16_cast(v.x);
        v.y = fp16_cast(v.y);
        v.z = fp16_cast(v.z);
        v.w = fp16_cast(v.w);
      }
      if (res != nullptr) {
        const float4 r4 = *reinterpret_cast<const float4*>(res + (size_t)m * N + n);
        v.x = fp16_cast(__fadd_rn(v.x, r4.x));
        v.y = fp16_cast(__fadd_rn(v.y, r4.y));
        v.z = fp16_cast(__fadd_rn(v.z, r4.z));
        v.w = fp16_cast(__fadd_rn(v.w, r4.w));
      }
      __stcs(reinterpret_cast<float4*>(out + (size_t)m * N + n), v);
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n + i < N)
          out[(size_t)m * N + n + i] = epilogue(vs[i], bias, res, out_fp16, m, n + i, N);
    }
  }
}

// grid (workers, 1, K splits); cluster (1, 1, K splits).  With one K split
// a block is persistent: it walks the tiles blockIdx.x, + gridDim.x, ...
// (M tiles fastest), its producer running ahead into the next tile while
// the consumers store the last one.  With K split, gridDim.x is the number
// of tiles: one tile per block, summed over the cluster.
template <int P, int BM_, class W>
__global__ void __launch_bounds__(THREADS, 1)
bfp_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const typename W::Scale* __restrict__ ex, const float* __restrict__ bias,
                 const float* __restrict__ res, float* __restrict__ out, int M, int N, int K,
                 int block, int precision, int out_fp16, int chunks_per_split) {
  using C = Cfg<P, BM_, W>;
  constexpr int BM = C::BM;
  namespace cg = cooperative_groups;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[C::STAGES];
  __shared__ __align__(8) uint64_t empty[C::STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int mt = (M + BM - 1) / BM;
  const int tiles = mt * ((N + BN - 1) / BN);
  const int nchunks = (K + BK - 1) / BK;
  const int c0 = blockIdx.z * chunks_per_split;
  const int nk = max(0, min(nchunks, c0 + chunks_per_split) - c0);
  const int ks = gridDim.z;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int row = wg * 64 + warp * 16 + g;  // this thread's weight rows: row, row + 8

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer warpgroup: it hands its registers to the consumers, and one
    // thread keeps the ring full, across the block's tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % C::STAGES;
          mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * C::STAGE_BYTES;
          mbar_expect_tx(&full[s], C::STAGE_BYTES);
          tma_load_3d(st, &xmap, &full[s], (c0 + kc) * BK, m0, 0);
          tma_load_2d(st + C::X_BYTES, &wmap, &full[s], (c0 + kc) * C::W_ROW, n0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  // acc takes the largest product (x's high plane by the weight's); acc_lo
  // the smaller ones, where there are any.  The tensor cores add each
  // product into the accumulator truncated to the accumulator's precision,
  // so products 2^-8 and 2^-16 the size of the sum, added into it, lose
  // their low bits every K step, all the same way (at K 5632, the three
  // planes' 1056 steps moved B1's outputs by up to 4e-4 of |y| ~ 10); in
  // acc_lo, whose magnitude is theirs, they keep them.  acc += acc_lo once,
  // after a tile's last stage.
  constexpr bool LO = P * W::PLANES > 1;
  float acc[C::ACC];
  float acc_lo[C::ACC];
  float* obuf =
      reinterpret_cast<float*>(smem + C::OUT_OFFSET) + (threadIdx.x >> 5) * 8 * OUT_PITCH;
  {
    // A stage: this thread dequantizes its 16 mantissas of rows r and r + 8
    // of the warpgroup's 64 (16 k each, one 16-byte (BFP) or 8-byte (SBFP)
    // load per row from the TMA'd tile) and stores them as bf16 into the
    // warpgroup's A tiles (one per weight plane) in the 128-byte swizzle
    // that wgmma reads; the warpgroup syncs and issues the stage's wgmmas
    // (P x PW, PW = 3: 6, each 4 deep), then waits for the previous stage's
    // (`wgmma.wait_group 1`) and releases its x and W tiles.  The two A
    // tiles alternate, so a stage's dequant overlaps the previous stage's
    // products, and no register that a wgmma in flight reads is written
    // (ptxas would serialize the wgmmas).  Each warp's tensor core reads
    // only its own 16 rows of A, which that warp writes.
    const int r = warp * 16 + g;  // row r and r + 8 of the warpgroup's tile
    unsigned char* atile = smem + C::A_OFFSET + wg * 2 * C::A_SET;
    int it = 0;
    auto stage = [&](float sa, float sb) {
      const int s = it % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      const unsigned char* st = smem + s * C::STAGE_BYTES;
      const unsigned char* wt = st + C::X_BYTES + W::BYTES16 * t;
      constexpr int PW = W::PLANES;
      uint32_t oa[PW][8], ob[PW][8];
      deq16<W>(*reinterpret_cast<const typename W::Word*>(wt + row * C::W_ROW), sa, oa);
      deq16<W>(*reinterpret_cast<const typename W::Word*>(wt + (row + 8) * C::W_ROW), sb, ob);
      unsigned char* at = atile + (it & 1) * C::A_SET;
      // k 16t .. 16t+15 are the 16-byte chunks 2t and 2t + 1 of a 128-byte
      // row; chunk c of row r sits at chunk c ^ (r % 8)
#pragma unroll
      for (int pw = 0; pw < PW; ++pw)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * t + h;
          unsigned char* ap = at + pw * C::A_BYTES;
          *reinterpret_cast<uint4*>(ap + r * 128 + ((c ^ (r & 7)) << 4)) = make_uint4(
              oa[pw][4 * h], oa[pw][4 * h + 1], oa[pw][4 * h + 2], oa[pw][4 * h + 3]);
          *reinterpret_cast<uint4*>(ap + (r + 8) * 128 + ((c ^ ((r + 8) & 7)) << 4)) =
              make_uint4(ob[pw][4 * h], ob[pw][4 * h + 1], ob[pw][4 * h + 2],
                         ob[pw][4 * h + 3]);
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      warpgroup_sync(wg);
      pin(acc);
      if constexpr (LO) pin(acc_lo);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const uint64_t bdesc = desc_sw128(st + p * (BM * BK * 2));
#pragma unroll
        for (int pw = 0; pw < PW; ++pw) {
          if (PW == 3 && p + pw > 2) continue;  // the three smallest products
          const uint64_t adesc = desc_sw128(at + pw * C::A_BYTES);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (p + pw == 0)
              wgmma_m64k16(acc, adesc + 2 * q, bdesc + 2 * q);
            else
              wgmma_m64k16(acc_lo, adesc + 2 * q, bdesc + 2 * q);
          }
        }
      }
      wgmma_commit();
      wgmma_wait1();
      pin(acc);
      if constexpr (LO) pin(acc_lo);
      ++it;
    };
    auto release = [&](int done) {  // the stage of iteration `done`
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[done % C::STAGES]);
    };
    // the exponents or scales of this thread's rows (row, row + 8) for
    // stage kc of a tile, loaded EXP_AHEAD stages before their use: slot u
    // serves the stages kc with kc % EXP_AHEAD == u, in this tile and then
    // the next
    using Scale = typename W::Scale;
    const int nblk = K / block;
    auto exps = [&](int tile, int kc, Scale& ea, Scale& eb) {
      ea = eb = Scale(0);
      const int k = (c0 + kc) * BK + 16 * t;
      if (tile >= tiles || kc >= nk || k >= K) return;
      const int n = (tile / mt) * BN + row;
      if (n < N) ea = ex[(size_t)n * nblk + k / block];
      if (n + 8 < N) eb = ex[(size_t)(n + 8) * nblk + k / block];
    };
    Scale ea[EXP_AHEAD], eb[EXP_AHEAD];
#pragma unroll
    for (int u = 0; u < EXP_AHEAD; ++u) exps(blockIdx.x, u, ea[u], eb[u]);
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % mt) * BM, n0 = (tile / mt) * BN;
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[i] = acc_lo[i] = 0.f;
      for (int kc = 0; kc < nk; kc += EXP_AHEAD) {
#pragma unroll
        for (int u = 0; u < EXP_AHEAD; ++u) {
          if (kc + u >= nk) break;
          const float sa = W::scale(ea[u], precision);
          const float sb = W::scale(eb[u], precision);
          if (kc + u + EXP_AHEAD < nk)
            exps(tile, kc + u + EXP_AHEAD, ea[u], eb[u]);
          else
            exps(tile + gridDim.x, u, ea[u], eb[u]);
          stage(sa, sb);
          if (kc + u > 0) release(it - 2);
        }
      }
      wgmma_wait0();
      pin(acc);
      if constexpr (LO) {
        pin(acc_lo);
#pragma unroll
        for (int i = 0; i < C::ACC; ++i) acc[i] += acc_lo[i];
      }
      if (nk > 0) release(it - 1);
      if (ks == 1) store_tile(acc, obuf, bias, res, out, M, N, out_fp16, m0, n0, row, t);
    }
  }
  if (ks == 1) return;

  // K split: this block's one tile (blockIdx.x) is summed over the cluster.
  // The consumers meet first (the producer has left): the ring is consumed
  // and may hold the f32 tile.
  asm volatile("bar.sync 3, %0;" ::"n"(CONSUMERS * 128) : "memory");
  cg::cluster_group cluster = cg::this_cluster();
  float* part = reinterpret_cast<float*>(smem);
  const int ct = threadIdx.x;  // consumer thread 0..255
#pragma unroll
  for (int i = 0; i < C::ACC; ++i) part[i * (CONSUMERS * 128) + ct] = acc[i];
  cluster.sync();
  if (blockIdx.z == 0) {
    for (int q = 1; q < ks; ++q) {
      const float* other = cluster.map_shared_rank(part, q);
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) acc[i] += other[i * (CONSUMERS * 128) + ct];
    }
  }
  cluster.sync();  // the other ranks' tiles are read before they exit
  if (blockIdx.z != 0) return;
  const int tile = blockIdx.x;
  store_tile(acc, obuf, bias, res, out, M, N, out_fp16, (tile % mt) * BM, (tile / mt) * BN, row,
             t);
}

// ---------------------------------------------------------------------------
// decode (M <= 16): the tensor-core GEMV of T1 (P = 1), B1 and B5 (P = 3)
// ---------------------------------------------------------------------------

constexpr int DEC_WARPS = 4;
constexpr int DEC_UNROLL = 2;  // 64-wide K chunks in flight per warp

__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// yT = W . xT on mma.sync m16n8k16: 16 output features on the MMA's rows,
// NB tiles of 8 batch rows on its columns (M <= 8 NB), P bf16 planes of x
// (split_x), one product each against the same A fragment.  A lane loads
// the 16 contiguous mantissas 16t..16t+15 of its rows g and g + 8 with one
// 16-byte (BFP) or 8-byte (SBFP) load each and feeds the A fragment in its
// own k order (slots 2t, 2t+1 of k16 step q hold k = 16t + 4q + {0, 1},
// slots 2t+8, 2t+9 hold
// 16t + 4q + {2, 3}), reading x's 16 matching values of its batch row for
// the B fragment in the same order: no shared memory for either operand.
// A block of 4 warps owns 16 features and splits its K range over the
// warps; grid (N / 16, K splits), cluster (1, K splits): the warps' sums
// meet in shared memory and the cluster's in rank 0's, read from the other
// ranks' distributed shared memory in rank order.  Needs K % 16 == 0 and
// block % 16 == 0.
template <int P, int NB, class W>
__global__ void __launch_bounds__(DEC_WARPS * 32)
bfp_decode_kernel(const float* __restrict__ x, const unsigned char* __restrict__ man,
                  const typename W::Scale* __restrict__ ex, const float* __restrict__ bias,
                  const float* __restrict__ res, float* __restrict__ out, int M, int N, int K,
                  int block, int precision, int out_fp16, int chunks_per_split) {
  namespace cg = cooperative_groups;
  using Word = typename W::Word;
  __shared__ float red[DEC_WARPS][NB * 4][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int na = blockIdx.x * 16 + g, nb = na + 8;
  const int nblk = K / block;
  const size_t row_bytes = (size_t)K / 16 * W::BYTES16;
  const int nchunks = (K + 63) / 64;
  const int c0 = blockIdx.y * chunks_per_split;
  const int c1 = min(nchunks, c0 + chunks_per_split);

  float d[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) d[i][j] = 0.f;

  for (int c = c0 + warp; c < c1; c += DEC_WARPS * DEC_UNROLL) {
    Word ua[DEC_UNROLL], ub[DEC_UNROLL];
    float sa[DEC_UNROLL], sb[DEC_UNROLL];
    float xv[DEC_UNROLL][NB][16];
    // every load of the step first, then the products
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const int k = (c + u * DEC_WARPS) * 64 + 16 * t;
      const bool in = c + u * DEC_WARPS < c1 && k < K;
      ua[u] = ub[u] = Word{};
      sa[u] = sb[u] = 0.f;
      const size_t kb = (size_t)(k / 16) * W::BYTES16;
      if (in && na < N) {
        ua[u] = __ldg(reinterpret_cast<const Word*>(man + na * row_bytes + kb));
        sa[u] = W::scale(ex[(size_t)na * nblk + k / block], precision);
      }
      if (in && nb < N) {
        ub[u] = __ldg(reinterpret_cast<const Word*>(man + nb * row_bytes + kb));
        sb[u] = W::scale(ex[(size_t)nb * nblk + k / block], precision);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int m = g + 8 * i;
        const float4* xp = reinterpret_cast<const float4*>(x + (size_t)m * K + k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 f = (in && m < M) ? __ldg(xp + q) : make_float4(0.f, 0.f, 0.f, 0.f);
          xv[u][i][4 * q] = f.x;
          xv[u][i][4 * q + 1] = f.y;
          xv[u][i][4 * q + 2] = f.z;
          xv[u][i][4 * q + 3] = f.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t a[4];
        W::deq4(ua[u], q, sa[u], a[0], a[2]);
        W::deq4(ub[u], q, sb[u], a[1], a[3]);
#pragma unroll
        for (int i = 0; i < NB; ++i) {
          uint16_t v[4][P];
#pragma unroll
          for (int j = 0; j < 4; ++j) split_x<P>(xv[u][i][4 * q + j], v[j]);
#pragma unroll
          for (int p = 0; p < P; ++p)
            mma_m16n8k16(d[i], a, v[0][p] | ((uint32_t)v[1][p] << 16),
                         v[2][p] | ((uint32_t)v[3][p] << 16));
        }
      }
    }
  }

  // the warps' sums, in warp order
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][4 * i + j][lane] = d[i][j];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = red[0][4 * i + j][lane];
#pragma unroll
        for (int w = 1; w < DEC_WARPS; ++w) v += red[w][4 * i + j][lane];
        d[i][j] = v;
      }
  }
  // the cluster's sums, in rank order, in rank 0
  const int ks = gridDim.y;
  if (ks > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < NB; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) red[0][4 * i + j][lane] = d[i][j];
    }
    cluster.sync();
    if (blockIdx.y == 0 && warp == 0) {
      for (int r = 1; r < ks; ++r) {
        const float* other = cluster.map_shared_rank(&red[0][0][0], r);
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) d[i][j] += other[(4 * i + j) * 32 + lane];
      }
    }
    cluster.sync();  // the other ranks' sums are read before they exit
    if (blockIdx.y != 0) return;
  }
  if (warp != 0) return;

  // d[i][j]: feature g (j < 2) or g + 8, batch row 8i + 2t + (j & 1)
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = j < 2 ? na : nb;
      const int m = 8 * i + 2 * t + (j & 1);
      if (m < M && n < N) out[(size_t)m * N + n] = epilogue(d[i][j], bias, res, out_fp16, m, n, N);
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: fetched once through the
// runtime, so the library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// K splits for a grid of `tiles` output tiles over `nchunks` stages: fill
// the SMs in one wave where the tiles alone do not, each split >= 2 stages
inline int k_splits(int tiles, int nchunks, int per_wave) {
  int ks = per_wave / tiles;
  ks = ks < 1 ? 1 : (ks > MAX_CLUSTER ? MAX_CLUSTER : ks);
  const int most = nchunks / 2 < 1 ? 1 : nchunks / 2;
  return ks < most ? ks : most;
}

// the decode kernel for M <= 16 rows; K % 16 == 0 and block % 16 == 0
template <int P, class W = BfpW>
cudaError_t launch_decode(const float* x, const void* man, const typename W::Scale* ex,
                          const float* bias, const float* res, float* out, int M, int N, int K,
                          int block, int precision, int out_fp16, cudaStream_t s) {
  const unsigned char* wq = static_cast<const unsigned char*>(man);
  const int tiles = (N + 15) / 16;
  const int nchunks = (K + 63) / 64;
  // two blocks per SM where the feature tiles alone give fewer, each split
  // at least one chunk per warp
  int ks = (2 * SMS + tiles - 1) / tiles;
  ks = ks > MAX_CLUSTER ? MAX_CLUSTER : ks;
  const int most = nchunks / DEC_WARPS < 1 ? 1 : nchunks / DEC_WARPS;
  ks = ks < most ? ks : most;
  const int per = (nchunks + ks - 1) / ks;
  ks = (nchunks + per - 1) / per;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, ks, 1);
  cfg.blockDim = dim3(DEC_WARPS * 32);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = ks;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (M <= 8)
    return cudaLaunchKernelEx(&cfg, bfp_decode_kernel<P, 1, W>, x, wq, ex, bias, res, out, M, N,
                              K, block, precision, out_fp16, per);
  return cudaLaunchKernelEx(&cfg, bfp_decode_kernel<P, 2, W>, x, wq, ex, bias, res, out, M, N, K,
                            block, precision, out_fp16, per);
}

// the main kernel at token tile BM, on the planes the pre-pass wrote
template <int P, int BM, class W>
cudaError_t launch_main(EncodeTiled encode, const void* man, const typename W::Scale* ex,
                        const float* bias, const float* res, float* out, uint16_t* pl, int M,
                        int N, int K, int Kp, int block, int precision, int out_fp16,
                        cudaStream_t stream) {
  using C = Cfg<P, BM, W>;
  CUtensorMap xmap, wmap;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)Kp, (cuuint64_t)M, (cuuint64_t)P};
    const cuuint64_t strides[2] = {(cuuint64_t)Kp * 2, (cuuint64_t)M * Kp * 2};
    const cuuint32_t box[3] = {BK, BM, P};
    const cuuint32_t el[3] = {1, 1, 1};
    if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, pl, dims, strides, box, el,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  {
    // a weight row: K / 16 groups of BYTES16 bytes; a stage's box: W_ROW
    // bytes of BN rows
    const cuuint64_t row = (cuuint64_t)K / 16 * W::BYTES16;
    const cuuint64_t dims[2] = {row, (cuuint64_t)N};
    const cuuint64_t strides[1] = {row};
    const cuuint32_t box[2] = {C::W_ROW, BN};
    const cuuint32_t el[2] = {1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(man), dims, strides,
               box, el, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }

  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        bfp_wgmma_kernel<P, BM, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  const int nchunks = Kp / BK;
  int ks = k_splits(tiles, nchunks, SMS);
  const int acc_splits = (nchunks + ACC_CHUNKS - 1) / ACC_CHUNKS;
  if (acc_splits > MAX_CLUSTER) return cudaErrorInvalidValue;
  ks = ks > acc_splits ? ks : acc_splits;
  const int per = (nchunks + ks - 1) / ks;
  ks = (nchunks + per - 1) / per;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ks > 1 || tiles < SMS ? tiles : SMS, 1, ks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bfp_wgmma_kernel<P, BM, W>, xmap, wmap, ex, bias, res, out, M,
                            N, K, block, precision, out_fp16, per);
}

// y = x . W^T (+ epilogue) through the pre-pass and the wgmma mainloop;
// needs block % 16 == 0 and K % 16 == 0 (BFP) or K % 32 == 0 (SBFP);
// planes: P * M * Kp bf16 scratch
template <int P, class W = BfpW>
cudaError_t launch_prefill(const float* x, const void* man, const typename W::Scale* ex,
                           const float* bias, const float* res, float* out, void* planes,
                           int M, int N, int K, int block, int precision, int out_fp16,
                           cudaStream_t stream) {
  const int Kp = (K + BK - 1) / BK * BK;
  uint16_t* pl = static_cast<uint16_t*>(planes);
  const long long work = (long long)M * (Kp / 16);
  split_planes_kernel<P><<<(unsigned)((work + 255) / 256), 256, 0, stream>>>(x, pl, M, K, Kp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // 256-token tiles where they alone fill the card (one plane only: three
  // planes of 256 rows leave no room for a ring)
  if (P == 1 && (M + 255) / 256 * ((N + BN - 1) / BN) >= SMS)
    return launch_main<P, (P == 1 ? 256 : 128), W>(encode, man, ex, bias, res, out, pl, M, N, K,
                                                     Kp, block, precision, out_fp16, stream);
  return launch_main<P, 128, W>(encode, man, ex, bias, res, out, pl, M, N, K, Kp, block,
                                precision, out_fp16, stream);
}

}  // namespace bfp_wgmma
