// B2: single-query attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces: dmx_compressor_tpu/ops/flash_decode.py:_decode_grid_call, int8
// branch (the TPU Pallas kernel behind flash_decode_int8, via
// _decode_int8_pallas / _decode_int8_pallas_T).
//
// For each batch row b and query head h (KV head h / rep):
//   logit[s] = (q . k_q[s]) * (k_scale[s] * scale),   s < lengths[b]
//   out      = sum_s softmax(logit)[s] * v_scale[s] * v_q[s]
// the factorization of ops/kv_cache.py:quantized_sdpa (the per-key scale
// commutes out of the QK dot; the per-value scale folds into the
// probabilities).  Payloads are [B, Hkv, S, D] int8, scales [B, Hkv, S] f32.
//
// What bounds it on the card: the int8 K/V stream of the filled slots (2 *
// lengths[b] * D bytes + 8 bytes of scales per key and KV head) -- a few
// hundred KB at a decode step, so the floor is well under a microsecond and
// the kernel is bound by the latency of its dependent steps.  The first
// version (one block per (b, KV head) walking all of its keys, 96 blocks at
// batch 8) spent 12x its byte floor on that walk.  The design:
// - Split S across blocks (flash-decoding): grid (Hkv, B, ceil(S / CHUNK)),
//   sized from the capacity S, which the host knows; a block whose chunk
//   starts at or past lengths[b] exits at once, so the host never reads the
//   lengths.
// - Each block stages its chunk in shared memory with cp.async, all of it
//   in flight at once, in two groups: the rep query rows of its KV head,
//   the int8 K rows (padded by 16 bytes, so a quarter-warp's 16-byte reads
//   of eight rows hit distinct banks) and both f32 scales; then the V rows,
//   which land while the logits are computed.  From shared memory: the rep
//   x n logits (one thread per (head, key), a D-long dot in four partial
//   sums), one warp's softmax per query head (m, l; p * v_scale kept for
//   the PV sum; all eight warps on one head measured slower on the H100:
//   two more barriers), and the PV sums with each thread on four dims of a
//   slice of the keys, the slices summed in order.  int8 becomes f32 by a
//   byte permute and an exact add, not a conversion instruction.  All rep
//   query heads of the KV head share the staged chunk: K/V are read once
//   per KV head.
// - A row of one chunk is finished by its block.  Otherwise each block
//   writes its chunk's (m, l, acc[D]) and the last block of the row to
//   finish (an atomic ticket) merges the chunks in chunk order
//   (decode_split.cuh): one launch.  A merge by a second launch was
//   measured beside it on the H100 and was slower at the main path's shape
//   (PERF.md), so it was removed.
// head_dim 32, 64, 128 or 256 (at 256 at most 16 query heads a KV head in
// a block: the chunk's K and V rows take 139 KB of shared memory there, and
// each query head 3 KB more; more heads take the grouped route below).  Any other multiple of 8 up to 256 (OPT-2.7b's
// 80, say) runs the kernel of the next of those widths, DP, with D taken
// at run time: the K and V rows are staged D bytes each in 8-byte copies
// (a row starts on an 8-byte boundary), the query rows D floats each with
// zeros to DP, so the padded dims add nothing to q . k (the staged bytes
// past D are finite int8, times a zero), and only the D real dims are
// written; at most 16 query heads a KV head in a block above D 128.  The
// cache keeps its D: padding its payload would copy all of it at every
// step, and the per-position int8 scale over D is the unpadded head's.
// CHUNK = 256 keys, chosen by measurement on the H100 (PERF.md: 64 and 128
// were slower at every shape timed), mirrored by the wrapper's B2_CHUNK.  lengths[b] must be >= 1 (a decode step always
// has its own key).  The launch error is returned to the caller
// (cudaGetLastError).
//
// More query heads a KV head than the shared memory and sm_m / sm_l take
// (32, or 16 above head_dim 128: Falcon-7B's 71 over 1, StarCoder's 48)
// run on the grouped route: the grid's x axis is (KV head, group), the rep
// query heads split into ceil(rep / 32) (or / 16) groups of at most that
// many, and each block stages its chunk's K/V rows for its own group.  So
// the K/V bytes are read once per group, twice at rep 48 or 64 (the second
// read mostly from L2: the groups of a chunk run together); the bound
// counts them once.  One launch; each group merges its chunks on its own
// ticket.  A head_dim that is no multiple of 8, or above 256, takes the
// generic route of decode_split.cuh.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int WARPS = NT / 32;
constexpr int CHUNK = 256;  // keys per block

// the most query heads a block takes at width DP: its shared memory (at
// 256, 139 KB of K/V rows and 3 KB a head) and sm_m / sm_l
__host__ __device__ constexpr int max_group(int DP) { return DP > 128 ? 16 : 32; }

// shared memory of one block, in bytes, laid out in this order
template <int D>
struct Smem {  // D: the instantiated width (DP)
  static constexpr int KROW = D + 16;  // a padded int8 row
  static constexpr int K = 0;
  static constexpr int V = K + CHUNK * KROW;
  static constexpr int KS = V + CHUNK * KROW;
  static constexpr int VS = KS + CHUNK * 4;
  // then q [rep, D], p [rep, CHUNK] and the PV slices' sums, G x rep x D
  // with G x rep x D / 4 <= NT, or rep x D where G is 1
  static constexpr int Q = VS + CHUNK * 4;
  static size_t bytes(int rep) {
    const size_t red = rep * D > NT * 4 ? (size_t)rep * D * 4 : (size_t)NT * 16;
    return (size_t)Q + (size_t)rep * (D + CHUNK) * 4 + red;
  }
};

// the four int8 of a word as exact floats without a conversion instruction
// (I2F runs at a quarter of the FP32 rate): byte v ^ 0x80 = v + 128 under
// the exponent of 2^23 reads 2^23 + v + 128, and one exact add removes
// 2^23 + 128
__device__ __forceinline__ float4 i8x4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float BIAS = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - BIAS,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - BIAS,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - BIAS,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - BIAS);
}

// DP: the instantiated width; PAD: the head's D (a multiple of 8 below DP)
// comes at run time in Dr, else D = DP; GROUPED: the grouped route
template <int DP, bool PAD, bool GROUPED>
__global__ void __launch_bounds__(NT)
flash_decode_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                         const int8_t* __restrict__ vq, const float* __restrict__ ks,
                         const float* __restrict__ vs, const int* __restrict__ lengths,
                         float* __restrict__ out, float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int* __restrict__ tickets, int H, int Hkv,
                         int S, int Dr, float scale) {
  using L = Smem<DP>;
  constexpr int C16 = DP / 16;  // 16-byte pieces of a staged K/V row
  const int D = PAD ? Dr : DP;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sk = reinterpret_cast<int8_t*>(smem + L::K);
  int8_t* sv = reinterpret_cast<int8_t*>(smem + L::V);
  float* sks = reinterpret_cast<float*>(smem + L::KS);
  float* svs = reinterpret_cast<float*>(smem + L::VS);
  // the grid's x axis: (KV head, group of at most GH query heads); one
  // group (GH = H / Hkv) but on the grouped route; rep: this block's query
  // heads
  int hkv = blockIdx.x, grp = 0, GH = H / Hkv, rep = GH;
  if constexpr (GROUPED) {
    const int groups = gridDim.x / Hkv;
    hkv = blockIdx.x / groups;
    grp = blockIdx.x - hkv * groups;
    GH = (GH + groups - 1) / groups;
    rep = min(GH, H / Hkv - grp * GH);
    if (rep <= 0) return;  // uniform: every block of an empty group
  }
  float* sq = reinterpret_cast<float*>(smem + L::Q);
  float* sp = sq + GH * DP;
  float* red = sp + GH * CHUNK;
  __shared__ float sm_m[32], sm_l[32];  // GH <= max_group(DP) <= 32

  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int len = min(lengths[b], S);
  const int s0 = c * CHUNK;
  if (s0 >= len) return;  // uniform: the whole block
  const int n = min(CHUNK, len - s0);
  const int nact = (len + CHUNK - 1) / CHUNK;
  const int tid = threadIdx.x;
  const size_t row0 = ((size_t)b * Hkv + hkv) * S + s0;  // the chunk's first key
  // the block's first query head
  const size_t bh0 = (size_t)b * H + (size_t)hkv * (H / Hkv) + (size_t)grp * GH;

  // stage the chunk in two groups, both in flight at once: the query rows,
  // K rows and both scales, which the logits need; then the V rows, which
  // land while the logits are computed
  const float* qp = q + bh0 * D;
  if constexpr (PAD) {
    const int Q4 = D / 4, C8 = D / 8, DZ = DP - D;
    for (int i = tid; i < rep * Q4; i += NT) {
      const int r = i / Q4, col = (i - r * Q4) * 4;
      decode_split::cp_async16(sq + r * DP + col, qp + r * D + col);
    }
    for (int i = tid; i < rep * DZ; i += NT) sq[(i / DZ) * DP + D + i % DZ] = 0.f;
    for (int i = tid; i < n * C8; i += NT) {
      const int r = i / C8, p = i - r * C8;
      decode_split::cp_async8(sk + r * L::KROW + p * 8, kq + (row0 + r) * D + p * 8);
    }
  } else {
    for (int i = tid; i < rep * D / 4; i += NT) decode_split::cp_async16(sq + 4 * i, qp + 4 * i);
    for (int i = tid; i < n * C16; i += NT) {
      const int r = i / C16, p = i % C16;
      decode_split::cp_async16(sk + r * L::KROW + p * 16, kq + (row0 + r) * D + p * 16);
    }
  }
  for (int i = tid; i < n; i += NT) {
    decode_split::cp_async4(sks + i, ks + row0 + i);
    decode_split::cp_async4(svs + i, vs + row0 + i);
  }
  decode_split::cp_async_commit();
  if constexpr (PAD) {
    const int C8 = D / 8;
    for (int i = tid; i < n * C8; i += NT) {
      const int r = i / C8, p = i - r * C8;
      decode_split::cp_async8(sv + r * L::KROW + p * 8, vq + (row0 + r) * D + p * 8);
    }
  } else {
    for (int i = tid; i < n * C16; i += NT) {
      const int r = i / C16, p = i % C16;
      decode_split::cp_async16(sv + r * L::KROW + p * 16, vq + (row0 + r) * D + p * 16);
    }
  }
  decode_split::cp_async_commit();
  decode_split::cp_async_wait<1>();
  __syncthreads();

  // logits: one thread per (query head, key), four partial sums over the
  // dims d % 4
  for (int p = tid; p < rep * n; p += NT) {
    const int r = p / n, s = p - r * n;
    const float4* qr = reinterpret_cast<const float4*>(sq + r * DP);
    const int8_t* kr = sk + s * L::KROW;
    float4 dot = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int piece = 0; piece < C16; ++piece) {
      const uint4 kw = *reinterpret_cast<const uint4*>(kr + piece * 16);
      const uint32_t w4[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 k4 = i8x4(w4[j]);
        const float4 q4 = qr[piece * 4 + j];
        dot.x = fmaf(q4.x, k4.x, dot.x);
        dot.y = fmaf(q4.y, k4.y, dot.y);
        dot.z = fmaf(q4.z, k4.z, dot.z);
        dot.w = fmaf(q4.w, k4.w, dot.w);
      }
    }
    sp[r * CHUNK + s] = ((dot.x + dot.y) + (dot.z + dot.w)) * (sks[s] * scale);
  }
  decode_split::cp_async_wait<0>();  // the V rows
  __syncthreads();

  // softmax over the chunk's n keys, one warp per query head
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < rep; r += WARPS) {
    float* pr = sp + r * CHUNK;
    float m = -INFINITY;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, pr[s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float p = expf(pr[s] - m);
      l += p;
      pr[s] = p * svs[s];  // v_scale folded into the probability
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      sm_m[r] = m;
      sm_l[r] = l;
    }
  }
  __syncthreads();

  // PV: output group oi = (head, 4 dims); G key slices summed in order
  // (over the DP staged dims: those past D are left unwritten)
  const int O = rep * DP / 4;
  const int G = max(1, NT / O);
  for (int it = tid; it < G * O; it += NT) {
    const int g = it / O, oi = it - g * O;
    const int r = oi / (DP / 4), d4 = (oi % (DP / 4)) * 4;
    const float* pr = sp + r * CHUNK;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int s = g; s < n; s += G) {
      const float p = pr[s];
      const float4 v4 = i8x4(*reinterpret_cast<const uint32_t*>(sv + s * L::KROW + d4));
      a0 = fmaf(p, v4.x, a0);
      a1 = fmaf(p, v4.y, a1);
      a2 = fmaf(p, v4.z, a2);
      a3 = fmaf(p, v4.w, a3);
    }
    *reinterpret_cast<float4*>(red + (size_t)g * rep * DP + r * DP + d4) =
        make_float4(a0, a1, a2, a3);
  }
  __syncthreads();

  const int nchunks = gridDim.z;
  for (int o = tid; o < rep * D; o += NT) {
    const int r = o / D, d = o - r * D;
    float a = 0.f;
    for (int g = 0; g < G; ++g) a += red[(size_t)g * rep * DP + r * DP + d];
    if (nact == 1)
      out[(bh0 + r) * D + d] = a / fmaxf(sm_l[r], 1e-30f);
    else
      part_acc[((bh0 + r) * nchunks + c) * D + d] = a;
  }
  if (nact == 1) return;
  for (int r = tid; r < rep; r += NT) {
    part_ml[((bh0 + r) * nchunks + c) * 2] = sm_m[r];
    part_ml[((bh0 + r) * nchunks + c) * 2 + 1] = sm_l[r];
  }
  if (!decode_split::last_to_arrive(tickets + (size_t)b * gridDim.x + blockIdx.x, nact)) return;
  for (int o = tid; o < rep * D; o += NT) {
    const int r = o / D, d = o - r * D;
    out[(bh0 + r) * D + d] = decode_split::merge_chunks(
        part_acc + (bh0 + r) * nchunks * D, part_ml + (bh0 + r) * nchunks * 2, nact, D, d);
  }
}

template <int DP, bool PAD, bool GROUPED>
cudaError_t launch(const float* q, const int8_t* kq, const int8_t* vq, const float* ks,
                   const float* vs, const int* lengths, float* out, float* part_acc,
                   float* part_ml, int* tickets, int B, int H, int Hkv, int S, int D, float scale,
                   cudaStream_t s) {
  const int rep = H / Hkv;
  const int groups = (rep + max_group(DP) - 1) / max_group(DP);
  const size_t smem = Smem<DP>::bytes((rep + groups - 1) / groups);
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(flash_decode_int8_kernel<DP, PAD, GROUPED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const int nchunks = (S + CHUNK - 1) / CHUNK;
  flash_decode_int8_kernel<DP, PAD, GROUPED><<<dim3(Hkv * groups, B, nchunks), NT, smem, s>>>(
      q, kq, vq, ks, vs, lengths, out, part_acc, part_ml, tickets, H, Hkv, S, D, scale);
  return cudaSuccess;
}

// the grouped route where the KV head's query heads exceed one block
template <int DP, bool PAD>
cudaError_t launch_g(const float* q, const int8_t* kq, const int8_t* vq, const float* ks,
                     const float* vs, const int* lengths, float* out, float* part_acc,
                     float* part_ml, int* tickets, int B, int H, int Hkv, int S, int D,
                     float scale, cudaStream_t s) {
  if (H / Hkv > max_group(DP))
    return launch<DP, PAD, true>(q, kq, vq, ks, vs, lengths, out, part_acc, part_ml, tickets, B,
                                 H, Hkv, S, D, scale, s);
  return launch<DP, PAD, false>(q, kq, vq, ks, vs, lengths, out, part_acc, part_ml, tickets, B, H,
                                Hkv, S, D, scale, s);
}

template <int DP>
cudaError_t launch_w(const float* q, const int8_t* kq, const int8_t* vq, const float* ks,
                     const float* vs, const int* lengths, float* out, float* part_acc,
                     float* part_ml, int* tickets, int B, int H, int Hkv, int S, int D,
                     float scale, cudaStream_t s) {
  if (D == DP)
    return launch_g<DP, false>(q, kq, vq, ks, vs, lengths, out, part_acc, part_ml, tickets, B, H,
                               Hkv, S, D, scale, s);
  return launch_g<DP, true>(q, kq, vq, ks, vs, lengths, out, part_acc, part_ml, tickets, B, H,
                            Hkv, S, D, scale, s);
}

}  // namespace

// part_acc [B, H, ceil(S / 256), D] and part_ml [B, H, ceil(S / 256), 2]
// f32 scratch; tickets int32 [B * Hkv * groups], zero (and left zero), with
// groups = ceil(rep / 32) (ceil(rep / 16) above head_dim 128; ceil(rep /
// GEN_HEADS) on the generic route); where S <= 256 no block touches them,
// and they may be null.  D: any; a multiple of 8 up to 256 takes the main
// kernel, any other the generic route
extern "C" int dmx_flash_decode_int8(const void* q, const void* k_q, const void* v_q,
                                     const void* k_scale, const void* v_scale,
                                     const void* lengths, void* out, void* part_acc,
                                     void* part_ml, void* tickets, int B, int H, int Hkv, int S,
                                     int D, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const int8_t* kp = static_cast<const int8_t*>(k_q);
  const int8_t* vp = static_cast<const int8_t*>(v_q);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* lp = static_cast<const int*>(lengths);
  float* op = static_cast<float*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* tk = static_cast<int*>(tickets);
  if (D % 8 != 0 || D > 256)
    return (int)decode_split::launch_generic<int8_t>(qp, kp, vp, ksp, vsp, lp, op, pa, pm, tk, B,
                                                     H, Hkv, S, D, scale, s);
  // the instantiated width: the next of 32, 64, 128, 256
  cudaError_t err;
  if (D <= 32)
    err = launch_w<32>(qp, kp, vp, ksp, vsp, lp, op, pa, pm, tk, B, H, Hkv, S, D, scale, s);
  else if (D <= 64)
    err = launch_w<64>(qp, kp, vp, ksp, vsp, lp, op, pa, pm, tk, B, H, Hkv, S, D, scale, s);
  else if (D <= 128)
    err = launch_w<128>(qp, kp, vp, ksp, vsp, lp, op, pa, pm, tk, B, H, Hkv, S, D, scale, s);
  else
    err = launch_w<256>(qp, kp, vp, ksp, vsp, lp, op, pa, pm, tk, B, H, Hkv, S, D, scale, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
