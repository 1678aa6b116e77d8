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
// What bounds it on the card, and what the design does about it: the int8
// K/V stream of the filled slots (2 * lengths[b] * D bytes per KV head) --
// the kernel reads keys only below lengths[b], so the unfilled capacity of
// the cache costs nothing.  One block per (b, KV head), eight warps; a key
// row of D int8 values is read as D/16 16-byte loads by D/16 neighbouring
// lanes, so a warp covers 32*16/D keys per step.  Each warp keeps its own
// online softmax in f32 (max, sum, accumulator) and the warps merge at the
// end through shared memory.  With B*Hkv blocks (96 at OPT-125m batch 8)
// the card is not full and each block walks its keys in sequence, so the
// kernel is latency-bound at short context; splitting S across blocks
// (flash-decoding) is later work.  Rows need no divisibility of S.
// lengths[b] must be >= 1 (a decode step always has its own key).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

template <int D>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ kq,
                         const int8_t* __restrict__ vq, const float* __restrict__ ks,
                         const float* __restrict__ vs, const int* __restrict__ lengths,
                         float* __restrict__ out, int H, int Hkv, int S, float scale) {
  constexpr int LPK = D / 16;      // lanes per key row
  constexpr int KPW = 32 / LPK;    // keys per warp step
  constexpr int KPB = KPW * WARPS; // keys per block step
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];

  const int hkv = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPK;  // dims sub*16 .. sub*16+15
  const int grp = lane / LPK;  // key within the warp step
  const int len = min(lengths[b], S);
  const size_t kv_row0 = ((size_t)b * Hkv + hkv) * S;

  for (int r = 0; r < rep; ++r) {
    const int h = hkv * rep + r;
    const float* qp = q + ((size_t)b * H + h) * D + sub * 16;
    float qv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) qv[j] = qp[j];

    float m = -INFINITY, l = 0.f;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;

    for (int s0 = warp * KPW; s0 < len; s0 += KPB) {
      const int s = s0 + grp;
      const bool valid = s < len;
      float dot = 0.f;
      uint4 vraw = make_uint4(0, 0, 0, 0);
      if (valid) {
        const uint4 kraw =
            __ldg(reinterpret_cast<const uint4*>(kq + (kv_row0 + s) * D + sub * 16));
        vraw = __ldg(reinterpret_cast<const uint4*>(vq + (kv_row0 + s) * D + sub * 16));
        const uint32_t kw[4] = {kraw.x, kraw.y, kraw.z, kraw.w};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dot = fmaf(qv[j], (float)(int8_t)((kw[j >> 2] >> (8 * (j & 3))) & 0xff), dot);
      }
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float logit = valid ? dot * (ks[kv_row0 + s] * scale) : -INFINITY;
      float mx = logit;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // the first key of every step is valid, so m_new is finite
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      const float p = valid ? expf(logit - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l = l * alpha + psum;
      const float pv = valid ? p * vs[kv_row0 + s] : 0.f;
      const uint32_t vw[4] = {vraw.x, vraw.y, vraw.z, vraw.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc[j] = fmaf(pv, (float)(int8_t)((vw[j >> 2] >> (8 * (j & 3))) & 0xff), acc[j] * alpha);
      m = m_new;
    }
    // sum the accumulators of the key groups (they share the warp's max)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) sm_acc[warp][sub * 16 + j] = acc[j];
    }
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
    __syncthreads();
    if (threadIdx.x < D) {
      float gm = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) gm = fmaxf(gm, sm_m[w]);
      float gl = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        // a warp that saw no key has m = -inf and weight 0
        const float wt = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - gm);
        gl = fmaf(sm_l[w], wt, gl);
        o = fmaf(sm_acc[w][threadIdx.x], wt, o);
      }
      out[((size_t)b * H + h) * D + threadIdx.x] = o / fmaxf(gl, 1e-30f);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dmx_flash_decode_int8(const void* q, const void* k_q, const void* v_q,
                                     const void* k_scale, const void* v_scale,
                                     const void* lengths, void* out, int B, int H, int Hkv,
                                     int S, int D, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hkv, B);
  const float* qp = static_cast<const float*>(q);
  const int8_t* kp = static_cast<const int8_t*>(k_q);
  const int8_t* vp = static_cast<const int8_t*>(v_q);
  const float* ksp = static_cast<const float*>(k_scale);
  const float* vsp = static_cast<const float*>(v_scale);
  const int* lp = static_cast<const int*>(lengths);
  float* op = static_cast<float*>(out);
  switch (D) {
    case 32:
      flash_decode_int8_kernel<32><<<grid, WARPS * 32, 0, s>>>(qp, kp, vp, ksp, vsp, lp, op,
                                                               H, Hkv, S, scale);
      break;
    case 64:
      flash_decode_int8_kernel<64><<<grid, WARPS * 32, 0, s>>>(qp, kp, vp, ksp, vsp, lp, op,
                                                               H, Hkv, S, scale);
      break;
    case 128:
      flash_decode_int8_kernel<128><<<grid, WARPS * 32, 0, s>>>(qp, kp, vp, ksp, vsp, lp, op,
                                                                H, Hkv, S, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
