// B4: single-query attention over a float KV cache (f32, fp16 or bf16), for
// Hopper (sm_90a).
//
// Replaces: dmx_compressor_tpu/ops/flash_decode.py:_decode_grid_call, float
// branch (the TPU Pallas kernel behind flash_decode, via _decode_pallas /
// _decode_pallas_T).  The float twin of B2 (csrc/flash_decode_int8.cu).
//
// For each batch row b and query head h (KV head h / rep):
//   logit[s] = (q . k[s]) * scale,   s < lengths[b]
//   out      = sum_s softmax(logit)[s] * v[s]
// K/V are the port's D-minor cache, [B, Hkv, S, D] f32, fp16 or bf16 (both
// one dtype); q and out [B, H, D] f32.
//
// What bounds it on the card: the f32 K/V stream of the filled slots (8 *
// lengths[b] * D bytes per KV head): 0.0024 ms at the baseline path's shape
// (batch 8, 12 heads, lengths 160 in 256 slots), 0.0296 ms at bench.py's
// long one (lengths 2016 in 2048).  The first version launched one block of
// 8 warps per (b, KV head), 96 blocks at batch 8: each warp streams its
// keys with __ldg and keeps an online softmax, and a block's keys of a row
// arrive at the memory parallelism of 8 warps, a memory latency a step of
// 64 keys (on an H100: 0.0067 ms at the path's shape, 0.0403 at the long
// one).  Measured beside it (PERF.md): B2's design (a block per 256-key
// chunk staged whole with cp.async, then its phases in sequence) ties it at
// the path's shape and loses a third at the long one (one block an SM: 139
// KB of f32 K/V), a ring of 64-key tiles streamed through each block does
// no better, and a thread block cluster a row (2-8 blocks, merged through
// distributed shared memory) loses at the path's shape: at ~115 registers
// two blocks fit an SM, so its blocks run in waves.  The design keeps the
// streaming warps, keeps the next step's rows in flight, and adds B2's
// split:
// - Split S across blocks (flash-decoding): grid (Hkv, B, ceil(S / CHUNK)),
//   sized from the capacity S, which the host knows; a block whose chunk
//   starts at or past lengths[b] exits at once, so the host never reads the
//   lengths.  At long context a row's keys stream through ceil(S / CHUNK)
//   blocks at once; a cache of at most CHUNK slots (the baseline path's)
//   keeps one block a row and no merge.
// - In a block, eight warps; a key row of D floats is read as D/16 lanes x
//   four 16-byte loads, so a warp covers 32*16/D keys a step, and loads the
//   next step's K and V rows before it uses this step's (H100: 0.0066 -> 0.0063
//   ms at the path's shape, 0.0101 -> 0.0085 with GQA).  All rep = H /
//   Hkv query heads of the KV head are served from one read of each key and
//   value (R of them a pass, R = 4, 2 or 1, the largest that divides rep).
//   Each warp keeps its own online softmax in f32 (max, sum, accumulator)
//   per query head, and the warps merge at the end through shared memory,
//   in warp order.
// - A row of one chunk is finished by its block.  Otherwise each block
//   writes its chunk's (m, l, acc[D]) per query head and the last block of
//   the row to finish (an atomic ticket) merges the chunks in chunk order
//   (decode_split.cuh): one launch, the same bits on every run.
// head_dim 32, 64, 128 or 256 (a lane always holds 16 dims of a row, so
// the registers a thread do not grow with D; at 256 a warp step covers 2
// keys).  Any other multiple of 8 up to 256 (OPT-2.7b's 80, say) runs the
// kernel of the next of those widths, DP, with D taken at run time: a
// lane's float4 loads past D are not issued and read as zeros, so q's
// padded dims are zero and add nothing to q . k, and only the D real dims
// are written (the arithmetic of the unpadded head; at D 80 the lanes of
// dims 80-127 idle).  Padding the cache instead would copy all of it at
// every step.  CHUNK keys a block, chosen by measurement on the
// H100 (PERF.md), mirrored by the wrapper's B4_CHUNK.  lengths[b] must be >=
// 1 (a decode step always has its own key).  The launch error is returned to
// the caller (cudaGetLastError).
//
// A 16-bit cache (fp16 or bf16: half the bytes of f32, the usual way to
// serve) is read as it is stored: a lane's 16 dims are two 16-byte loads
// of 8 elements each instead of four of 4, widened to f32 in registers,
// which is exact (every fp16 and bf16 value is an f32 value); all the
// arithmetic stays f32.  Widening the cache in the wrapper instead would
// read all of it and write twice its bytes at every step.  The bound over
// a 16-bit cache is half the f32 cache's bytes.
//
// A head_dim that is no multiple of 8, or above 256, takes the generic
// route of decode_split.cuh (scalar loads, any D; simple, its times in
// PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decode_split.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int CHUNK = 1024;  // keys per block

__device__ __forceinline__ float2 widen2(uint32_t w, const __half*) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

__device__ __forceinline__ float2 widen2(uint32_t w, const __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// the 16 elements at p (float, __half or __nv_bfloat16) as floats, of which
// the first `nvalid` exist (PAD: a lane past the head's D dims; D is a
// multiple of 8, so a float4, or a 16-byte piece of 8 halves, is whole or
// absent); zeros for the rest
template <bool PAD, typename T>
__device__ __forceinline__ void load16(const T* p, float* dst, int nvalid) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!PAD || 4 * i < nvalid) f = __ldg(reinterpret_cast<const float4*>(p) + i);
      dst[4 * i] = f.x;
      dst[4 * i + 1] = f.y;
      dst[4 * i + 2] = f.z;
      dst[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (!PAD || 8 * i < nvalid) u = __ldg(reinterpret_cast<const uint4*>(p) + i);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = widen2(w[j], p);
        dst[8 * i + 2 * j] = f.x;
        dst[8 * i + 2 * j + 1] = f.y;
      }
    }
  }
}

// this lane's 16 dims of key and value row `row`, zeros where !valid
template <bool PAD, typename T>
__device__ __forceinline__ void load_kv(const T* k, const T* v, size_t row, bool valid,
                                       int nvalid, float* kr, float* vr) {
  if (valid) {
    load16<PAD>(k + row, kr, nvalid);
    load16<PAD>(v + row, vr, nvalid);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) kr[j] = vr[j] = 0.f;
  }
}

// T: the K/V element (float, __half, __nv_bfloat16); DP: the instantiated
// width; PAD: the head's D (a multiple of 8 below DP) comes at run time in
// Dr, else D = DP
template <typename T, int DP, int R, bool PAD>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ out, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int* __restrict__ tickets, int H, int Hkv, int S,
                    int Dr, float scale) {
  constexpr int LPK = DP / 16;     // lanes per key row
  constexpr int KPW = 32 / LPK;    // keys per warp step
  constexpr int KPB = KPW * WARPS; // keys per block step
  const int D = PAD ? Dr : DP;
  __shared__ float sm_m[WARPS][R];
  __shared__ float sm_l[WARPS][R];
  __shared__ float sm_acc[WARPS][R][DP];

  const int hkv = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int rep = H / Hkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPK;  // dims sub*16 .. sub*16+15
  const int grp = lane / LPK;  // key within the warp step
  const int len = min(lengths[b], S);
  const int s0 = c * CHUNK;
  if (s0 >= len) return;  // uniform: the whole block
  const int s1 = min(len, s0 + CHUNK);
  const int nact = (len + CHUNK - 1) / CHUNK;
  const int nchunks = gridDim.z;
  const size_t kv_row0 = ((size_t)b * Hkv + hkv) * S;
  const size_t bh0 = (size_t)b * H + (size_t)hkv * rep;  // the first query head's row
  const int w0 = s0 + warp * KPW + grp;  // this lane's first key
  const int nvalid = D - sub * 16;       // this lane's dims that exist (PAD)

  for (int r0 = 0; r0 < rep; r0 += R) {
    float qv[R][16], kr[16], vr[16];
#pragma unroll
    for (int r = 0; r < R; ++r) load16<PAD>(q + (bh0 + r0 + r) * D + sub * 16, qv[r], nvalid);
    load_kv<PAD, T>(k, v, (kv_row0 + w0) * D + sub * 16, w0 < s1, nvalid, kr, vr);

    float m[R], l[R], acc[R][16];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[r][j] = 0.f;
    }

    // the next step's K and V rows are in flight while this step's are used
    for (int st = s0 + warp * KPW; st < s1; st += KPB) {
      const int s = st + grp;
      const bool valid = s < s1;
      float kn[16], vn[16];
      load_kv<PAD, T>(k, v, (kv_row0 + s + KPB) * D + sub * 16, s + KPB < s1, nvalid, kn, vn);
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
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        kr[j] = kn[j];
        vr[j] = vn[j];
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
    // the chunk: the warps' states merged in warp order
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
      const size_t row = bh0 + r0 + r;
      if (nact == 1) {
        out[row * D + d] = o / fmaxf(gl, 1e-30f);
      } else {
        part_acc[(row * nchunks + c) * D + d] = o;
        if (d == 0) {
          part_ml[(row * nchunks + c) * 2] = gm;
          part_ml[(row * nchunks + c) * 2 + 1] = gl;
        }
      }
    }
    __syncthreads();
  }
  if (nact == 1) return;
  if (!decode_split::last_to_arrive(tickets + (size_t)b * Hkv + hkv, nact)) return;
  for (int o = threadIdx.x; o < rep * D; o += WARPS * 32) {
    const int r = o / D, d = o - r * D;
    out[(bh0 + r) * D + d] = decode_split::merge_chunks(
        part_acc + (bh0 + r) * nchunks * D, part_ml + (bh0 + r) * nchunks * 2, nact, D, d);
  }
}

template <typename T, int DP, bool PAD>
void launch_d(dim3 grid, cudaStream_t s, int rep, const float* q, const T* k, const T* v,
              const int* le, float* out, float* pa, float* pm, int* tk, int H, int Hkv, int S,
              int D, float scale) {
  if (rep % 4 == 0)
    flash_decode_kernel<T, DP, 4, PAD><<<grid, WARPS * 32, 0, s>>>(q, k, v, le, out, pa, pm, tk,
                                                                   H, Hkv, S, D, scale);
  else if (rep % 2 == 0)
    flash_decode_kernel<T, DP, 2, PAD><<<grid, WARPS * 32, 0, s>>>(q, k, v, le, out, pa, pm, tk,
                                                                   H, Hkv, S, D, scale);
  else
    flash_decode_kernel<T, DP, 1, PAD><<<grid, WARPS * 32, 0, s>>>(q, k, v, le, out, pa, pm, tk,
                                                                   H, Hkv, S, D, scale);
}

template <typename T, int DP>
void launch_w(dim3 grid, cudaStream_t s, int rep, const float* q, const T* k, const T* v,
              const int* le, float* out, float* pa, float* pm, int* tk, int H, int Hkv, int S,
              int D, float scale) {
  if (D == DP)
    launch_d<T, DP, false>(grid, s, rep, q, k, v, le, out, pa, pm, tk, H, Hkv, S, D, scale);
  else
    launch_d<T, DP, true>(grid, s, rep, q, k, v, le, out, pa, pm, tk, H, Hkv, S, D, scale);
}

// one launch over K/V of element T
template <typename T>
cudaError_t launch_t(const float* q, const void* k, const void* v, const int* le, float* out,
                     float* pa, float* pm, int* tk, int B, int H, int Hkv, int S, int D,
                     float scale, cudaStream_t s) {
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  if (D % 8 != 0 || D > 256)
    return decode_split::launch_generic<T>(q, kp, vp, nullptr, nullptr, le, out, pa, pm, tk, B,
                                           H, Hkv, S, D, scale, s);
  const dim3 grid(Hkv, B, (S + CHUNK - 1) / CHUNK);
  const int rep = H / Hkv;
  // the instantiated width: the next of 32, 64, 128, 256
  if (D <= 32)
    launch_w<T, 32>(grid, s, rep, q, kp, vp, le, out, pa, pm, tk, H, Hkv, S, D, scale);
  else if (D <= 64)
    launch_w<T, 64>(grid, s, rep, q, kp, vp, le, out, pa, pm, tk, H, Hkv, S, D, scale);
  else if (D <= 128)
    launch_w<T, 128>(grid, s, rep, q, kp, vp, le, out, pa, pm, tk, H, Hkv, S, D, scale);
  else
    launch_w<T, 256>(grid, s, rep, q, kp, vp, le, out, pa, pm, tk, H, Hkv, S, D, scale);
  return cudaGetLastError();
}

}  // namespace

// part_acc [B, H, n, D] and part_ml [B, H, n, 2] f32 scratch, n = ceil(S /
// CHUNK) (ceil(S / GEN_CHUNK) on the generic route); tickets int32 [B * Hkv]
// ([B * Hkv * ceil(H / Hkv / GEN_HEADS)] on the generic route), zero (and
// left zero); where one chunk covers S no block touches them, and they may
// be null.  kv_dtype: 0 float32, 1 float16, 2 bfloat16.  D: any; a multiple
// of 8 up to 256 takes the main kernel, any other the generic route
extern "C" int dmx_flash_decode(const void* q, const void* k, const void* v,
                                const void* lengths, void* out, void* part_acc, void* part_ml,
                                void* tickets, int B, int H, int Hkv, int S, int D, float scale,
                                int kv_dtype, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qp = static_cast<const float*>(q);
  const int* lp = static_cast<const int*>(lengths);
  float* op = static_cast<float*>(out);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* tk = static_cast<int*>(tickets);
  switch (kv_dtype) {
    case 0:
      return (int)launch_t<float>(qp, k, v, lp, op, pa, pm, tk, B, H, Hkv, S, D, scale, s);
    case 1:
      return (int)launch_t<__half>(qp, k, v, lp, op, pa, pm, tk, B, H, Hkv, S, D, scale, s);
    case 2:
      return (int)launch_t<__nv_bfloat16>(qp, k, v, lp, op, pa, pm, tk, B, H, Hkv, S, D, scale,
                                          s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
