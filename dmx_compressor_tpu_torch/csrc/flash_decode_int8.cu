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
// head_dim 32, 64 or 128; CHUNK = 256 keys, chosen by measurement on the
// H100 (PERF.md: 64 and 128 were slower at every shape timed), mirrored by
// the wrapper's B2_CHUNK.  lengths[b] must be >= 1 (a decode step always
// has its own key).  The launch error is returned to the caller
// (cudaGetLastError).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int WARPS = NT / 32;
constexpr int CHUNK = 256;  // keys per block

// shared memory of one block, in bytes, laid out in this order
template <int D>
struct Smem {
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

template <int D>
__global__ void __launch_bounds__(NT)
flash_decode_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                         const int8_t* __restrict__ vq, const float* __restrict__ ks,
                         const float* __restrict__ vs, const int* __restrict__ lengths,
                         float* __restrict__ out, float* __restrict__ part_acc,
                         float* __restrict__ part_ml, int* __restrict__ tickets, int H, int Hkv,
                         int S, float scale) {
  using L = Smem<D>;
  constexpr int C16 = D / 16;  // 16-byte pieces of a K/V row
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sk = reinterpret_cast<int8_t*>(smem + L::K);
  int8_t* sv = reinterpret_cast<int8_t*>(smem + L::V);
  float* sks = reinterpret_cast<float*>(smem + L::KS);
  float* svs = reinterpret_cast<float*>(smem + L::VS);
  const int rep = H / Hkv;
  float* sq = reinterpret_cast<float*>(smem + L::Q);
  float* sp = sq + rep * D;
  float* red = sp + rep * CHUNK;
  __shared__ float sm_m[32], sm_l[32];  // rep <= 32 (the wrapper checks)

  const int hkv = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int len = min(lengths[b], S);
  const int s0 = c * CHUNK;
  if (s0 >= len) return;  // uniform: the whole block
  const int n = min(CHUNK, len - s0);
  const int nact = (len + CHUNK - 1) / CHUNK;
  const int tid = threadIdx.x;
  const size_t row0 = ((size_t)b * Hkv + hkv) * S + s0;  // the chunk's first key

  // stage the chunk in two groups, both in flight at once: the query rows,
  // K rows and both scales, which the logits need; then the V rows, which
  // land while the logits are computed
  const float* qp = q + ((size_t)b * H + (size_t)hkv * rep) * D;
  for (int i = tid; i < rep * D / 4; i += NT) decode_split::cp_async16(sq + 4 * i, qp + 4 * i);
  for (int i = tid; i < n * C16; i += NT) {
    const int r = i / C16, p = i % C16;
    decode_split::cp_async16(sk + r * L::KROW + p * 16, kq + (row0 + r) * D + p * 16);
  }
  for (int i = tid; i < n; i += NT) {
    decode_split::cp_async4(sks + i, ks + row0 + i);
    decode_split::cp_async4(svs + i, vs + row0 + i);
  }
  decode_split::cp_async_commit();
  for (int i = tid; i < n * C16; i += NT) {
    const int r = i / C16, p = i % C16;
    decode_split::cp_async16(sv + r * L::KROW + p * 16, vq + (row0 + r) * D + p * 16);
  }
  decode_split::cp_async_commit();
  decode_split::cp_async_wait<1>();
  __syncthreads();

  // logits: one thread per (query head, key), four partial sums over the
  // dims d % 4
  for (int p = tid; p < rep * n; p += NT) {
    const int r = p / n, s = p - r * n;
    const float4* qr = reinterpret_cast<const float4*>(sq + r * D);
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
  const int O = rep * D / 4;
  const int G = max(1, NT / O);
  for (int it = tid; it < G * O; it += NT) {
    const int g = it / O, oi = it - g * O;
    const int r = oi / (D / 4), d4 = (oi % (D / 4)) * 4;
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
    *reinterpret_cast<float4*>(red + (size_t)g * rep * D + r * D + d4) =
        make_float4(a0, a1, a2, a3);
  }
  __syncthreads();

  const size_t bh0 = (size_t)b * H + (size_t)hkv * rep;  // the first query head's row
  const int nchunks = gridDim.z;
  for (int o = tid; o < rep * D; o += NT) {
    float a = 0.f;
    for (int g = 0; g < G; ++g) a += red[(size_t)g * rep * D + o];
    const int r = o / D, d = o - r * D;
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
  if (!decode_split::last_to_arrive(tickets + (size_t)b * Hkv + hkv, nact)) return;
  for (int o = tid; o < rep * D; o += NT) {
    const int r = o / D, d = o - r * D;
    out[(bh0 + r) * D + d] = decode_split::merge_chunks(
        part_acc + (bh0 + r) * nchunks * D, part_ml + (bh0 + r) * nchunks * 2, nact, D, d);
  }
}

template <int D>
cudaError_t launch(const float* q, const int8_t* kq, const int8_t* vq, const float* ks,
                   const float* vs, const int* lengths, float* out, float* part_acc,
                   float* part_ml, int* tickets, int B, int H, int Hkv, int S, float scale,
                   cudaStream_t s) {
  const size_t smem = Smem<D>::bytes(H / Hkv);
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_int8_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const int nchunks = (S + CHUNK - 1) / CHUNK;
  flash_decode_int8_kernel<D><<<dim3(Hkv, B, nchunks), NT, smem, s>>>(
      q, kq, vq, ks, vs, lengths, out, part_acc, part_ml, tickets, H, Hkv, S, scale);
  return cudaSuccess;
}

}  // namespace

// part_acc [B, H, ceil(S / 256), D] and part_ml [B, H, ceil(S / 256), 2]
// f32 scratch; tickets int32 [B * Hkv], zero (and left zero); where S <= 256
// no block touches them, and they may be null
extern "C" int dmx_flash_decode_int8(const void* q, const void* k_q, const void* v_q,
                                     const void* k_scale, const void* v_scale,
                                     const void* lengths, void* out, void* part_acc,
                                     void* part_ml, void* tickets, int B, int H, int Hkv, int S,
                                     int D, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > 32) return (int)cudaErrorInvalidValue;
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
  cudaError_t err;
  switch (D) {
    case 32:
      err = launch<32>(qp, kp, vp, ksp, vsp, lp, op, pa, pm, tk, B, H, Hkv, S, scale, s);
      break;
    case 64:
      err = launch<64>(qp, kp, vp, ksp, vsp, lp, op, pa, pm, tk, B, H, Hkv, S, scale, s);
      break;
    case 128:
      err = launch<128>(qp, kp, vp, ksp, vsp, lp, op, pa, pm, tk, B, H, Hkv, S, scale, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
