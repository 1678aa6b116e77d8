// The split-S machinery of the decode attention kernels (flash-decoding):
// each CUDA block serves one chunk of keys of one (batch row, KV head) and
// leaves its chunk's softmax state per query head, (m, l, acc[D]) with acc
// not yet divided by l; the last block of a row to finish (an atomic
// ticket) merges the row's chunks in chunk order (never in the order the
// blocks finish), so a result does not change from run to run.  Nothing
// here depends on the element type of K and V: B2 (flash_decode_int8.cu,
// int8 K/V) and B4 (flash_decode.cu, f32, fp16 or bf16 K/V) use it.
//
// Scratch, allocated by the wrapper: acc [B, H, nchunks, D] and ml [B, H,
// nchunks, 2] (m, l) f32, written only by rows with more than one chunk; and
// tickets, int32 [B * Hkv], zero before the launch and zero again after it
// (the merging block resets its own).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_split {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// output d of one (batch row, query head) from its nact chunks' states, in
// chunk order; reads through L2 (the other blocks' writes are not in this
// SM's L1)
__device__ __forceinline__ float merge_chunks(const float* __restrict__ acc,
                                              const float* __restrict__ ml, int nact, int D,
                                              int d) {
  float gm = -INFINITY;
  for (int c = 0; c < nact; ++c) gm = fmaxf(gm, __ldcg(ml + 2 * c));
  float gl = 0.f, o = 0.f;
  for (int c = 0; c < nact; ++c) {
    const float w = expf(__ldcg(ml + 2 * c) - gm);
    gl = fmaf(__ldcg(ml + 2 * c + 1), w, gl);
    o = fmaf(__ldcg(acc + (size_t)c * D + d), w, o);
  }
  return o / fmaxf(gl, 1e-30f);
}

// true in the block that finishes last among the `n` blocks sharing
// *ticket (after all of them have made their partials visible), which then
// resets the ticket to zero for the next launch; every thread of the block
// must call it
__device__ __forceinline__ bool last_to_arrive(int* ticket, int n) {
  __shared__ int s_last;
  __threadfence();  // this block's partials before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    s_last = t == n - 1;
    if (s_last) *ticket = 0;  // every other block has taken its ticket
  }
  __syncthreads();
  if (s_last) __threadfence();  // the others' partials after their tickets
  return s_last;
}

// ---------------------------------------------------------------------------
// The generic route of B2 and B4: any head_dim (one that is no multiple of
// 8, or above 256, where the main kernels' 16-byte lanes of 16 dims do not
// fit) and any number of query heads a KV head.  Simple and right first:
// - grid (Hkv * groups, B, ceil(S / GEN_CHUNK)); a block serves GEN_HEADS
//   query heads of one KV head (groups = ceil(rep / GEN_HEADS)) over one
//   chunk of GEN_CHUNK keys, so the K/V rows of a chunk are read once per
//   group: ceil(rep / 8) times (the later reads mostly from L2, as the
//   groups of a chunk run together).  The bound counts them once.
// - logits: one warp a key, its lanes over D with scalar loads (a row of
//   D elements need not start on a 16-byte boundary), every query head of
//   the group from one read of the key, q read through L1; summed across
//   the warp, times the key's scale (int8) and the softmax scale, into
//   shared memory [GEN_HEADS][GEN_CHUNK].
// - softmax over the chunk, one warp a query head (m, l; p times the
//   value's scale for int8); then one thread a (query head, dim) sums p v
//   over the chunk's keys in key order (neighbouring threads read
//   neighbouring dims of a value row).
// - the chunks merge as the main kernels' do (last_to_arrive,
//   merge_chunks), one ticket per (b, KV head, group).
// What bounds it: the latency of a warp's walk over its keys (each key D /
// 32 dependent loads a lane, then a five-step shuffle per query head), not
// the K/V bytes; its times are in PERF.md.
// ---------------------------------------------------------------------------

constexpr int GEN_NT = 256;     // threads a block
constexpr int GEN_CHUNK = 256;  // keys a block (the wrapper's GENERIC_CHUNK)
constexpr int GEN_HEADS = 8;    // query heads a block (the wrapper's GENERIC_HEADS)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// T: the K/V element (float, __half, __nv_bfloat16 for B4; int8_t for B2,
// whose per-position scales ks / vs [B, Hkv, S] are then given, else null)
template <typename T>
__global__ void __launch_bounds__(GEN_NT)
generic_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ ks,
                      const float* __restrict__ vs, const int* __restrict__ lengths,
                      float* __restrict__ out, float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int* __restrict__ tickets, int H, int Hkv,
                      int S, int D, float scale) {
  __shared__ float sp[GEN_HEADS][GEN_CHUNK];
  __shared__ float sm_m[GEN_HEADS], sm_l[GEN_HEADS];
  const int groups = gridDim.x / Hkv;
  const int hkv = blockIdx.x / groups, grp = blockIdx.x - hkv * groups;
  const int b = blockIdx.y, c = blockIdx.z;
  const int rep = H / Hkv;
  const int nh = min(GEN_HEADS, rep - grp * GEN_HEADS);  // this block's query heads
  const int len = min(lengths[b], S);
  const int s0 = c * GEN_CHUNK;
  if (s0 >= len) return;  // uniform: the whole block
  const int n = min(GEN_CHUNK, len - s0);
  const int nact = (len + GEN_CHUNK - 1) / GEN_CHUNK;
  const int nchunks = gridDim.z;
  const size_t row0 = ((size_t)b * Hkv + hkv) * S + s0;  // the chunk's first key
  const size_t bh0 = (size_t)b * H + (size_t)hkv * rep + grp * GEN_HEADS;  // first query head
  const float* qb = q + bh0 * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int s = warp; s < n; s += GEN_NT / 32) {
    const T* kr = k + (row0 + s) * D;
    float dot[GEN_HEADS];
#pragma unroll
    for (int r = 0; r < GEN_HEADS; ++r) dot[r] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float kf = to_f32(kr[d]);
#pragma unroll
      for (int r = 0; r < GEN_HEADS; ++r)
        if (r < nh) dot[r] = fmaf(__ldg(qb + (size_t)r * D + d), kf, dot[r]);
    }
#pragma unroll
    for (int r = 0; r < GEN_HEADS; ++r)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
    if (lane == 0) {
      const float sc = ks != nullptr ? ks[row0 + s] * scale : scale;
#pragma unroll
      for (int r = 0; r < GEN_HEADS; ++r)
        if (r < nh) sp[r][s] = dot[r] * sc;
    }
  }
  __syncthreads();

  for (int r = warp; r < nh; r += GEN_NT / 32) {
    float m = -INFINITY;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, sp[r][s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float p = expf(sp[r][s] - m);
      l += p;
      sp[r][s] = vs != nullptr ? p * vs[row0 + s] : p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      sm_m[r] = m;
      sm_l[r] = l;
    }
  }
  __syncthreads();

  for (int o = tid; o < nh * D; o += GEN_NT) {
    const int r = o / D, d = o - r * D;
    const T* vc = v + row0 * D + d;
    float a = 0.f;
    for (int s = 0; s < n; ++s) a = fmaf(sp[r][s], to_f32(vc[(size_t)s * D]), a);
    if (nact == 1)
      out[(bh0 + r) * D + d] = a / fmaxf(sm_l[r], 1e-30f);
    else
      part_acc[((bh0 + r) * nchunks + c) * D + d] = a;
  }
  if (nact == 1) return;
  for (int r = tid; r < nh; r += GEN_NT) {
    part_ml[((bh0 + r) * nchunks + c) * 2] = sm_m[r];
    part_ml[((bh0 + r) * nchunks + c) * 2 + 1] = sm_l[r];
  }
  if (!last_to_arrive(tickets + (size_t)b * gridDim.x + blockIdx.x, nact)) return;
  for (int o = tid; o < nh * D; o += GEN_NT) {
    const int r = o / D, d = o - r * D;
    out[(bh0 + r) * D + d] = merge_chunks(part_acc + (bh0 + r) * nchunks * D,
                                          part_ml + (bh0 + r) * nchunks * 2, nact, D, d);
  }
}

// one launch of the generic route; scratch as the main kernels' (part_acc
// [B, H, ceil(S / GEN_CHUNK), D], part_ml, tickets int32 [B * Hkv * groups])
template <typename T>
cudaError_t launch_generic(const float* q, const T* k, const T* v, const float* ks,
                           const float* vs, const int* lengths, float* out, float* part_acc,
                           float* part_ml, int* tickets, int B, int H, int Hkv, int S, int D,
                           float scale, cudaStream_t s) {
  const int groups = (H / Hkv + GEN_HEADS - 1) / GEN_HEADS;
  const dim3 grid(Hkv * groups, B, (S + GEN_CHUNK - 1) / GEN_CHUNK);
  generic_decode_kernel<T><<<grid, GEN_NT, 0, s>>>(q, k, v, ks, vs, lengths, out, part_acc,
                                                   part_ml, tickets, H, Hkv, S, D, scale);
  return cudaGetLastError();
}

}  // namespace decode_split
