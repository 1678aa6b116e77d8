// The split-S machinery of the decode attention kernels (flash-decoding):
// each CUDA block serves one chunk of keys of one (batch row, KV head) and
// leaves its chunk's softmax state per query head, (m, l, acc[D]) with acc
// not yet divided by l; the last block of a row to finish (an atomic
// ticket) merges the row's chunks in chunk order (never in the order the
// blocks finish), so a result does not change from run to run.  Nothing
// here depends on the element type of K and V: B2 (flash_decode_int8.cu,
// int8 K/V) uses it, and B4's f32 K/V can.
//
// Scratch, allocated by the wrapper: acc [B, H, nchunks, D] and ml [B, H,
// nchunks, 2] (m, l) f32, written only by rows with more than one chunk; and
// tickets, int32 [B * Hkv], zero before the launch and zero again after it
// (the merging block resets its own).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode_split {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
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

}  // namespace decode_split
