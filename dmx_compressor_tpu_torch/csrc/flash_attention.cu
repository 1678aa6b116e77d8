// B3: blockwise (flash) attention for Hopper (sm_90a), in f32.
//
// Replaces: dmx_compressor_tpu/ops/flash_attention.py:_flash_pallas (the
// TPU Pallas kernel behind flash_attention).
//
// out = softmax(q . k^T * scale + bias) . v over [BH, L, D] queries and
// [BH, S, D] keys/values, optionally causal with the diagonal at offset
// S - L (row i sees keys j <= i + S - L), optional additive bias [BH, L, S].
//
// What bounds it on the card, and what the design does about it: f32
// operations (4*L*S*D per head, about half of that under the causal mask).
// One block per (bh, tile of 64 queries), one thread per query row holding
// its q and its output accumulator in registers; key and value tiles of 32
// rows are staged in shared memory, where every thread of the block reads
// the same element (a broadcast).  Online softmax in f32 per row; key tiles
// past the block's last causal column are skipped.  Tensor cores would
// change the tolerance, so they are a later, stated choice.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;  // queries per block (one per thread)
constexpr int BK = 32;  // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(BQ)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ bias,
                       float* __restrict__ out, int L, int S, float scale, int causal,
                       int offset) {
  __shared__ __align__(16) float Ks[BK][D];
  __shared__ __align__(16) float Vs[BK][D];
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int row = q0 + threadIdx.x;
  const bool row_ok = row < L;
  const float* kb = k + (size_t)bh * S * D;
  const float* vb = v + (size_t)bh * S * D;

  float qv[D];
  float acc[D];
  {
    const float* qp = q + ((size_t)bh * L + (row_ok ? row : 0)) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      qv[d] = qp[d];
      acc[d] = 0.f;
    }
  }
  float m = -INFINITY, l = 0.f;

  // keys past the last row's causal diagonal contribute nothing
  const int kend = causal ? min(S, min(q0 + BQ, L) - 1 + offset + 1) : S;
  for (int t0 = 0; t0 < kend; t0 += BK) {
    for (int i = threadIdx.x; i < BK * D / 4; i += BQ) {
      const int r = (i * 4) / D;
      const int c = (i * 4) % D;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (t0 + r < S) {
        kv4 = *reinterpret_cast<const float4*>(kb + (size_t)(t0 + r) * D + c);
        vv4 = *reinterpret_cast<const float4*>(vb + (size_t)(t0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&Ks[r][c]) = kv4;
      *reinterpret_cast<float4*>(&Vs[r][c]) = vv4;
    }
    __syncthreads();

    float s[BK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int col = t0 + j;
      const bool ok = col < S && (!causal || col <= row + offset);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qv[d], Ks[j][d], dot);
      float logit = dot * scale;
      if (bias != nullptr && ok && row_ok) logit += bias[((size_t)bh * L + row) * S + col];
      s[j] = ok ? logit : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    if (m_new != -INFINITY) {  // else: no key of this row so far
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        s[j] = s[j] == -INFINITY ? 0.f : expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float a = acc[d] * alpha;
#pragma unroll
        for (int j = 0; j < BK; ++j) a = fmaf(s[j], Vs[j][d], a);
        acc[d] = a;
      }
      m = m_new;
    }
    __syncthreads();
  }

  if (row_ok) {
    float* op = out + ((size_t)bh * L + row) * D;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] * inv;
  }
}

}  // namespace

extern "C" int dmx_flash_attention(const void* q, const void* k, const void* v,
                                   const void* bias, void* out, int BH, int L, int S, int D,
                                   float scale, int causal, int offset, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + BQ - 1) / BQ, BH);
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  switch (D) {
    case 32:
      flash_attention_kernel<32><<<grid, BQ, 0, s>>>(qp, kp, vp, bp, op, L, S, scale, causal,
                                                     offset);
      break;
    case 64:
      flash_attention_kernel<64><<<grid, BQ, 0, s>>>(qp, kp, vp, bp, op, L, S, scale, causal,
                                                     offset);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
