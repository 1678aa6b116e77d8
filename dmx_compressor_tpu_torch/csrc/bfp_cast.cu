// T2: the BASIC fake-quant casts for Hopper (sm_90a), f32 in, f32 out.
//
// Replaces: dmx_compressor_tpu/tools/probe_fused_cast.py:run (the Pallas
// probes (a)-(h) of the fused BASIC-linear kernel's building blocks) and the
// casts those blocks make up in ops/basic_linear.py: the symmetric nearest
// BFP cast (_bfp_cast_with_exponents after cast_blocked_lastdim) and the
// FLOAT16 cast (_fp16_cast_f32).
//
// Ops (the `op` argument of dmx_bfp_cast):
// - 0, BFP: a tensor viewed as [outer, len, inner], blocks of `block`
//   consecutive positions along len (inner == 1: the last axis; inner > 1:
//   an inner axis, e.g. the S-blocked V cast, without a transpose copy).
//   Per block, e = floor(log2 max|x|) from the bits of the max (a bit-level
//   zero block passes through), then the reference rebase-add
//       t = x + 1.5 * 2^(e+2)   (rounded in f32: the double rounding)
//       q = rne(t * 2^(wl-2-e)) * 2^(e+2-wl) - 1.5 * 2^(e+2)
//   clamped to +-(2 - 2^-(wl-2)) * 2^e where |q| reached 2^(e+1).  Powers of
//   two are built from bits and applied in the two steps of rounding.py's
//   _mul_pow2, so |k| up to 252 stays exact; every add and multiply is an
//   explicit round-to-nearest intrinsic, so nvcc contracts nothing into an
//   FMA.  Bit for bit the plain version (ops/bfp_cast.py:bfp_cast_ref).
// - 1, FLOAT16: clamp to +-65504, round to the fp16 grid (RNE), flush
//   |y| < 2^-14 to +0, back to f32.  Bit for bit fp16_cast_ref.
// - 2..9: the probes (a)-(h) of probe_fused_cast.py on a [rows, cols]
//   input (outer = rows, len = cols, blocks of `block` along cols).
//
// What bounds it on the card: bytes (4 read + 4 written per element); the
// work per element is a dozen f32 operations.  Design: one warp per block
// of the last axis (two elements per lane for a 64-block, the block max by
// one warp reduction of the magnitudes' bits), one thread per column for
// an inner-axis block (coalesced across the inner axis, the block read
// twice, the second time from L1/L2), one thread per element otherwise.
// The launch error is returned to the caller (cudaGetLastError).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_BFP = 0;
constexpr int OP_FP16 = 1;
constexpr int OP_PROBE_A = 2;  // (a) .. (h) are OP_PROBE_A + 0 .. 7

constexpr int ROW_WARPS = 8;     // blocks per CUDA block on the last-axis path
constexpr int MAX_PER_LANE = 8;  // last-axis blocks up to 256 elements
constexpr int THREADS = 256;

__device__ __forceinline__ float pow2f(int k) {  // exact 2^k, k in [-126, 127]
  return __int_as_float((k + 127) << 23);
}

// x * 2^k for |k| <= 252: the remainder first, so a result in the subnormal
// range is rounded once (rounding.py:_mul_pow2)
__device__ __forceinline__ float mul_pow2(float x, int k) {
  const int k1 = min(max(k, -126), 126);
  return __fmul_rn(__fmul_rn(x, pow2f(k - k1)), pow2f(k1));
}

__device__ __forceinline__ unsigned abs_bits(float x) {
  return __float_as_uint(x) & 0x7fffffffu;
}

// floor(log2 |amax|) from its bits (a NaN's bits order above inf, as
// torch.amax propagates it); -128 marks a bit-level zero block
__device__ __forceinline__ int block_exponent(unsigned amax_bits) {
  return amax_bits == 0u ? -128 : (int)((amax_bits >> 23) & 0xffu) - 127;
}

__device__ __forceinline__ float bfp_elem(float x, int e, int wl, float max_mant) {
  if (e == -128) return x;
  const float base = mul_pow2(1.5f, e + 2);
  const float t = __fadd_rn(x, base);
  const float q = __fsub_rn(mul_pow2(rintf(mul_pow2(t, wl - 2 - e)), e + 2 - wl), base);
  const float lim = mul_pow2(1.0f, e + 1);
  if (fabsf(q) >= lim) {
    const float maxv = __fmul_rn(max_mant, mul_pow2(1.0f, e));
    return q > 0.f ? maxv : -maxv;
  }
  return q;
}

// comparisons keep a NaN, as torch.clamp does
__device__ __forceinline__ float fp16_elem(float x) {
  const float y = x > 65504.f ? 65504.f : (x < -65504.f ? -65504.f : x);
  const float r = __half2float(__float2half_rn(y));
  return fabsf(r) < 6.103515625e-05f ? 0.0f : r;
}

__global__ void __launch_bounds__(ROW_WARPS * 32)
bfp_rows_kernel(const float* __restrict__ x, float* __restrict__ out, long long nblocks,
                int block, int wl, float max_mant) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
  if (b >= nblocks) return;  // uniform across the warp
  const float* xp = x + b * block;
  float v[MAX_PER_LANE];
  unsigned m = 0u;
#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < block ? xp[j] : 0.f;
    m = max(m, abs_bits(v[i]));
  }
  const int e = block_exponent(__reduce_max_sync(0xffffffffu, m));
  float* op = out + b * block;
#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) {
    const int j = lane + 32 * i;
    if (j < block) op[j] = bfp_elem(v[i], e, wl, max_mant);
  }
}

__global__ void __launch_bounds__(THREADS)
bfp_cols_kernel(const float* __restrict__ x, float* __restrict__ out, long long ncols,
                int block, int inner, int wl, float max_mant) {
  const long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (c >= ncols) return;
  // c enumerates (outer, block index, inner position), the last fastest
  const long long start = (c / inner) * block * inner + c % inner;
  const float* xp = x + start;
  unsigned m = 0u;
  for (int j = 0; j < block; ++j) m = max(m, abs_bits(xp[(long long)j * inner]));
  const int e = block_exponent(m);
  float* op = out + start;
  for (int j = 0; j < block; ++j)
    op[(long long)j * inner] = bfp_elem(xp[(long long)j * inner], e, wl, max_mant);
}

__global__ void __launch_bounds__(THREADS)
fp16_kernel(const float* __restrict__ x, float* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS)
    out[i] = fp16_elem(x[i]);
}

// max |x| over the block of row r that holds column c (probes b and g)
__device__ __forceinline__ float block_amax(const float* x, int cols, int block, int r, int c) {
  const float* xp = x + (long long)r * cols + (c / block) * block;
  unsigned m = 0u;
  for (int j = 0; j < block; ++j) m = max(m, abs_bits(xp[j]));
  return __uint_as_float(m);
}

__global__ void __launch_bounds__(THREADS)
probe_kernel(const float* __restrict__ x, float* __restrict__ out, int probe, int rows,
             int cols, int block) {
  const int nb = cols / block;
  const long long n_out = (long long)rows * (probe == 1 ? nb : cols);
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_out) return;
  switch (probe) {
    case 0:  // (a) block reshape and back: the identity
      out[i] = x[i];
      break;
    case 1:  // (b) per-block max|x|, [rows, nb]
      out[i] = block_amax(x, cols, block, (int)(i / nb), (int)(i % nb) * block);
      break;
    case 2:  // (c) the exponent field by bitcast
      out[i] = (float)((int)((__float_as_uint(x[i]) >> 23) & 0xffu) - 127);
      break;
    case 3: {  // (d) 2^k by shift and bitcast, k = clip(trunc(x), -10, 10)
      const int k = min(max((int)x[i], -10), 10);
      out[i] = pow2f(k);
      break;
    }
    case 4:  // (e) round half to even
      out[i] = rintf(__fmul_rn(x[i], 3.7f));
      break;
    case 5:  // (f) the FLOAT16 epilogue
      out[i] = fp16_elem(x[i]);
      break;
    case 6:  // (g) the block max broadcast over its block
      out[i] = block_amax(x, cols, block, (int)(i / cols), (int)(i % cols));
      break;
    default:  // (h) per-block values [rows, nb] expanded to [rows, cols]
      out[i] = x[(i / cols) * nb + (i % cols) / block];
      break;
  }
}

inline unsigned grid_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" int dmx_bfp_cast(const void* x, void* out, int op, int outer, int len, int inner,
                            int block, int wl, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const long long n = (long long)outer * len * inner;
  if (op == OP_BFP) {
    const float max_mant = (float)(2.0 - 1.0 / (double)(1LL << (wl - 2)));
    if (inner == 1) {
      const long long nblocks = n / block;
      bfp_rows_kernel<<<grid_for(nblocks, ROW_WARPS), ROW_WARPS * 32, 0, s>>>(
          xf, of, nblocks, block, wl, max_mant);
    } else {
      const long long ncols = n / block;
      bfp_cols_kernel<<<grid_for(ncols, THREADS), THREADS, 0, s>>>(xf, of, ncols, block, inner,
                                                                   wl, max_mant);
    }
  } else if (op == OP_FP16) {
    const long long blocks = grid_for(n, THREADS);
    fp16_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536), THREADS, 0, s>>>(xf, of, n);
  } else {
    const int probe = op - OP_PROBE_A;
    const long long n_out = (long long)outer * (probe == 1 ? len / block : len);
    probe_kernel<<<grid_for(n_out, THREADS), THREADS, 0, s>>>(xf, of, probe, outer, len, block);
  }
  return (int)cudaGetLastError();
}
