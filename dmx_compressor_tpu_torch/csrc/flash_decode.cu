// B4: single-query attention over a float (f32) KV cache, for Hopper (sm_90a).
//
// Replaces: dmx_compressor_tpu/ops/flash_decode.py:_decode_grid_call, float
// branch (the TPU Pallas kernel behind flash_decode, via _decode_pallas /
// _decode_pallas_T).  The float twin of B2 (csrc/flash_decode_int8.cu).
//
// For each batch row b and query head h (KV head h / rep):
//   logit[s] = (q . k[s]) * scale,   s < lengths[b]
//   out      = sum_s softmax(logit)[s] * v[s]
// K/V are the port's D-minor cache, [B, Hkv, S, D] f32; q and out [B, H, D].
//
// What bounds it on the card, and what the design does about it: the f32
// K/V stream of the filled slots (8 * lengths[b] * D bytes per KV head) --
// the kernel reads keys only below lengths[b], so the unfilled capacity of
// the cache costs nothing.  One block per (b, KV head), eight warps; a key
// row of D floats is read as D/16 lanes x four 16-byte loads, so a warp
// covers 32*16/D keys per step.  All rep = H / Hkv query heads of the KV head
// are served from one read of each key and value (R of them per pass, R = 4,
// 2 or 1, the largest that divides rep).  Each warp keeps its own online
// softmax in f32 (max, sum, accumulator) per query head, and the warps merge
// at the end through shared memory.  With B*Hkv blocks (96 at OPT-125m batch
// 8) the card is not full and each block walks its keys in sequence, so the
// kernel is latency-bound at short context; splitting S across blocks
// (flash-decoding) is later work.  lengths[b] must be >= 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ void load16(const float* p, float* dst) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    dst[4 * i] = f.x;
    dst[4 * i + 1] = f.y;
    dst[4 * i + 2] = f.z;
    dst[4 * i + 3] = f.w;
  }
}

template <int D, int R>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ out, int H, int Hkv, int S, float scale) {
  constexpr int LPK = D / 16;      // lanes per key row
  constexpr int KPW = 32 / LPK;    // keys per warp step
  constexpr int KPB = KPW * WARPS; // keys per block step
  __shared__ float sm_m[WARPS][R];
  __shared__ float sm_l[WARPS][R];
  __shared__ float sm_acc[WARPS][R][D];

  const int hkv = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = H / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPK;  // dims sub*16 .. sub*16+15
  const int grp = lane / LPK;  // key within the warp step
  const int len = min(lengths[b], S);
  const size_t kv_row0 = ((size_t)b * Hkv + hkv) * S;

  for (int r0 = 0; r0 < rep; r0 += R) {
    const int h0 = hkv * rep + r0;  // first query head of this pass
    float qv[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r) load16(q + ((size_t)b * H + h0 + r) * D + sub * 16, qv[r]);

    float m[R], l[R], acc[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
    }

    for (int s0 = warp * KPW; s0 < len; s0 += KPB) {
      const int s = s0 + grp;
      const bool valid = s < len;
      float kr[16], vr[16];
      if (valid) {
        load16(k + (kv_row0 + s) * D + sub * 16, kr);
        load16(v + (kv_row0 + s) * D + sub * 16, vr);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) kr[j] = vr[j] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) dot = fmaf(qv[r][j], kr[j], dot);
#pragma unroll
        for (int o = 1; o < LPK; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const float logit = valid ? dot * scale : -INFINITY;
        float mx = logit;
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        // the first key of every step is valid, so m_new is finite
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        const float p = valid ? expf(logit - m_new) : 0.f;
        float psum = p;
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
        l[r] = l[r] * alpha + psum;
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[r][j] = fmaf(p, vr[j], acc[r][j] * alpha);
        m[r] = m_new;
      }
    }
    // sum the accumulators of the key groups (they share the warp's max)
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1) acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
      if (grp == 0) {
#pragma unroll
        for (int j = 0; j < 16; ++j) sm_acc[warp][r][sub * 16 + j] = acc[r][j];
      }
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < R * D; i += WARPS * 32) {
      const int r = i / D;
      const int d = i % D;
      float gm = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) gm = fmaxf(gm, sm_m[w][r]);
      float gl = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        // a warp that saw no key has m = -inf and weight 0
        const float wt = sm_m[w][r] == -INFINITY ? 0.f : expf(sm_m[w][r] - gm);
        gl = fmaf(sm_l[w][r], wt, gl);
        o = fmaf(sm_acc[w][r][d], wt, o);
      }
      out[((size_t)b * H + h0 + r) * D + d] = o / fmaxf(gl, 1e-30f);
    }
    __syncthreads();
  }
}

template <int D>
void launch_d(dim3 grid, cudaStream_t s, int rep, const float* q, const float* k,
              const float* v, const int* le, float* out, int H, int Hkv, int S, float scale) {
  if (rep % 4 == 0)
    flash_decode_kernel<D, 4><<<grid, WARPS * 32, 0, s>>>(q, k, v, le, out, H, Hkv, S, scale);
  else if (rep % 2 == 0)
    flash_decode_kernel<D, 2><<<grid, WARPS * 32, 0, s>>>(q, k, v, le, out, H, Hkv, S, scale);
  else
    flash_decode_kernel<D, 1><<<grid, WARPS * 32, 0, s>>>(q, k, v, le, out, H, Hkv, S, scale);
}

}  // namespace

extern "C" int dmx_flash_decode(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, int B, int H, int Hkv,
                                int S, int D, float scale, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hkv, B);
  const int rep = H / Hkv;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const int* lp = static_cast<const int*>(lengths);
  float* op = static_cast<float*>(out);
  switch (D) {
    case 32:
      launch_d<32>(grid, s, rep, qp, kp, vp, lp, op, H, Hkv, S, scale);
      break;
    case 64:
      launch_d<64>(grid, s, rep, qp, kp, vp, lp, op, H, Hkv, S, scale);
      break;
    case 128:
      launch_d<128>(grid, s, rep, qp, kp, vp, lp, op, H, Hkv, S, scale);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
