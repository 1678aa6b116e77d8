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
// - 10, FLOAT16 then BFP: op 1 applied to each element as it is loaded,
//   then op 0 on the result, in one launch: bit for bit the two launches
//   (the same two functions in sequence), as the BASIC pipeline makes them
//   where a module's FLOAT16 output cast feeds the next one's BFP input cast.
//
// What bounds it on the card: bytes (4 read + 4 written per element); the
// work per element is a dozen f32 operations.  At a decode step's shapes
// (a few thousand elements) a launch costs more than its bytes, so the
// composed op 10 saves whole launches.  Design:
// - The last axis (bfp_rows_vec_kernel): blocks of 4 * 2^i elements up to
//   256 are read and written with 16-byte loads and stores, block / 4
//   lanes of a warp to a block (up to 32; a 256-block takes two float4 a
//   lane), the block max one shuffle reduction over those lanes of the
//   magnitudes' bits.  Other blocks up to 256, or operands not on a 16-byte
//   boundary, take bfp_rows_kernel: one warp per block, scalar loads.
// - An inner axis (bfp_tile_kernel): one CUDA block per tile of `block`
//   rows x 16 columns (4 lanes x float4 when inner % 4 == 0, else 16 lanes
//   x 1 float), all of the tile's loads in flight together into registers
//   (up to 4 rows a thread: blocks up to 256 rows, or 64 on the scalar
//   path; a taller block is read a second time from L2), a partial column
//   max per thread over its rows, finished by shuffles and through shared
//   memory, then the cast from registers.  At the S-blocked V cast of a
//   BASIC decode step ([8, 12, 64, 64] along S) that is 384 CUDA blocks of
//   4 KB, each read once.
// - FLOAT16 (fp16_vec_kernel): 16-byte loads and stores, a grid-stride loop;
//   fp16_kernel (scalar) where an operand is not on a 16-byte boundary.
// The launch error is returned to the caller (cudaGetLastError).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_BFP = 0;
constexpr int OP_FP16 = 1;
constexpr int OP_PROBE_A = 2;  // (a) .. (h) are OP_PROBE_A + 0 .. 7
constexpr int OP_FP16_BFP = 10;

constexpr int ROW_WARPS = 8;     // blocks per CUDA block on the scalar last-axis path
constexpr int MAX_PER_LANE = 8;  // last-axis blocks up to 256 elements
constexpr int THREADS = 256;
constexpr int TILE_COLS = 16;    // columns of an inner-axis tile (4 float4 or 16 float lanes)
constexpr int TILE_ROWS = 4;     // rows of an inner-axis tile a thread keeps in registers

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

// an element as the BFP cast reads it: FLOAT16-cast first for op 10
template <bool FP16_FIRST>
__device__ __forceinline__ float bfp_in(float x) {
  return FP16_FIRST ? fp16_elem(x) : x;
}

template <bool FP16_FIRST>
__device__ __forceinline__ float4 bfp_in4(float4 v) {
  return make_float4(bfp_in<FP16_FIRST>(v.x), bfp_in<FP16_FIRST>(v.y), bfp_in<FP16_FIRST>(v.z),
                     bfp_in<FP16_FIRST>(v.w));
}

__device__ __forceinline__ unsigned max4_bits(float4 v) {
  return max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w)));
}

__device__ __forceinline__ float4 bfp_elem4(float4 v, int e, int wl, float max_mant) {
  return make_float4(bfp_elem(v.x, e, wl, max_mant), bfp_elem(v.y, e, wl, max_mant),
                     bfp_elem(v.z, e, wl, max_mant), bfp_elem(v.w, e, wl, max_mant));
}

// the last axis, blocks of LPB * VPL * 4 elements: LPB lanes per block, VPL
// float4 per lane, 256 / LPB blocks per CUDA block
template <int LPB, int VPL, bool FP16_FIRST>
__global__ void __launch_bounds__(THREADS)
bfp_rows_vec_kernel(const float4* __restrict__ x, float4* __restrict__ out, long long nblocks,
                    int wl, float max_mant) {
  const long long b = (long long)blockIdx.x * (THREADS / LPB) + threadIdx.x / LPB;
  const int sub = threadIdx.x % LPB;
  const bool live = b < nblocks;  // every lane takes part in the shuffles
  const float4* xp = x + b * (LPB * VPL) + sub;
  float4 v[VPL];
  unsigned m = 0u;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    v[i] = live ? bfp_in4<FP16_FIRST>(xp[i * LPB]) : make_float4(0.f, 0.f, 0.f, 0.f);
    m = max(m, max4_bits(v[i]));
  }
#pragma unroll
  for (int o = LPB / 2; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (!live) return;
  const int e = block_exponent(m);
  float4* op = out + b * (LPB * VPL) + sub;
#pragma unroll
  for (int i = 0; i < VPL; ++i) op[i * LPB] = bfp_elem4(v[i], e, wl, max_mant);
}

// the last axis, any block up to 256: one warp per block, scalar loads
template <bool FP16_FIRST>
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
    v[i] = j < block ? bfp_in<FP16_FIRST>(xp[j]) : 0.f;
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

// V floats, loaded and stored as one (float4 for V = 4)
template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ float get(const T& v, int j) {
    return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
  }
  template <bool F>
  static __device__ __forceinline__ T in(T v) { return bfp_in4<F>(v); }
  static __device__ __forceinline__ T cast(T v, const int* e, int wl, float mm) {
    return make_float4(bfp_elem(v.x, e[0], wl, mm), bfp_elem(v.y, e[1], wl, mm),
                       bfp_elem(v.z, e[2], wl, mm), bfp_elem(v.w, e[3], wl, mm));
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float get(const T& v, int) { return v; }
  template <bool F>
  static __device__ __forceinline__ T in(T v) { return bfp_in<F>(v); }
  static __device__ __forceinline__ T cast(T v, const int* e, int wl, float mm) {
    return bfp_elem(v, e[0], wl, mm);
  }
};

// an inner axis: x viewed as [outer * nblk, block, inner], one CUDA block
// per (outer, block index, column tile); CL column lanes x V floats wide,
// RG = 256 / CL row groups, row r of the tile on row group r % RG; a
// column's max over the row groups by shuffles within each warp, then over
// the 8 warps through shared memory
template <int V, bool FP16_FIRST>
__global__ void __launch_bounds__(THREADS)
bfp_tile_kernel(const float* __restrict__ x, float* __restrict__ out, int block, int inner,
                int col_tiles, int wl, float max_mant) {
  using VT = typename Vec<V>::T;
  constexpr int CL = TILE_COLS / V;
  constexpr int RG = THREADS / CL;
  __shared__ __align__(16) unsigned red[THREADS / 32][TILE_COLS];
  const int ct = blockIdx.x % col_tiles;
  const size_t base = (size_t)(blockIdx.x / col_tiles) * block * inner;
  const int lane_c = threadIdx.x % CL;
  const int rg = threadIdx.x / CL;
  const int c = (ct * CL + lane_c) * V;  // inner % V == 0: c .. c+V-1 all in or all out
  const bool col_ok = c < inner;
  const bool cached = block <= RG * TILE_ROWS;
  const float* xp = x + base + c;
  auto load = [&](int r) {  // row r of the tile, FLOAT16-cast first for op 10
    return Vec<V>::template in<FP16_FIRST>(*reinterpret_cast<const VT*>(xp + (size_t)r * inner));
  };

  VT v[TILE_ROWS];
  unsigned m[V];
#pragma unroll
  for (int j = 0; j < V; ++j) m[j] = 0u;
  if (cached) {
#pragma unroll
    for (int i = 0; i < TILE_ROWS; ++i) {
      const int r = rg + RG * i;
      v[i] = col_ok && r < block ? load(r) : Vec<V>::zero();
    }
#pragma unroll
    for (int i = 0; i < TILE_ROWS; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) m[j] = max(m[j], abs_bits(Vec<V>::get(v[i], j)));
  } else if (col_ok) {
    for (int r = rg; r < block; r += RG) {
      const VT w = load(r);
#pragma unroll
      for (int j = 0; j < V; ++j) m[j] = max(m[j], abs_bits(Vec<V>::get(w, j)));
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int o = CL; o < 32; o <<= 1) m[j] = max(m[j], __shfl_xor_sync(0xffffffffu, m[j], o));
    if (lane < CL) red[warp][lane_c * V + j] = m[j];
  }
  __syncthreads();
  int e[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    unsigned mm = 0u;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) mm = max(mm, red[w][lane_c * V + j]);
    e[j] = block_exponent(mm);
  }
  if (!col_ok) return;
  float* op = out + base + c;
  if (cached) {
#pragma unroll
    for (int i = 0; i < TILE_ROWS; ++i) {
      const int r = rg + RG * i;
      if (r < block)
        *reinterpret_cast<VT*>(op + (size_t)r * inner) = Vec<V>::cast(v[i], e, wl, max_mant);
    }
  } else {
    for (int r = rg; r < block; r += RG)
      *reinterpret_cast<VT*>(op + (size_t)r * inner) = Vec<V>::cast(load(r), e, wl, max_mant);
  }
}

__global__ void __launch_bounds__(THREADS)
fp16_vec_kernel(const float4* __restrict__ x, float4* __restrict__ out, long long n4) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    const float4 v = x[i];
    out[i] = make_float4(fp16_elem(v.x), fp16_elem(v.y), fp16_elem(v.z), fp16_elem(v.w));
  }
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

inline unsigned capped(long long blocks) { return (unsigned)(blocks < 65536 ? blocks : 65536); }

template <int LPB, int VPL>
void launch_rows_vec(const float* x, float* out, long long nblocks, int wl,
                            float max_mant, bool fp16_first, cudaStream_t s) {
  const unsigned grid = grid_for(nblocks, THREADS / LPB);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (fp16_first)
    bfp_rows_vec_kernel<LPB, VPL, true><<<grid, THREADS, 0, s>>>(x4, o4, nblocks, wl, max_mant);
  else
    bfp_rows_vec_kernel<LPB, VPL, false><<<grid, THREADS, 0, s>>>(x4, o4, nblocks, wl, max_mant);
}

// the last axis; false where the block or the alignment needs the scalar path
bool launch_rows(const float* x, float* out, long long nblocks, int block, int wl,
                 float max_mant, bool fp16_first, bool aligned, cudaStream_t s) {
  if (!aligned) return false;
  switch (block) {
    case 4: launch_rows_vec<1, 1>(x, out, nblocks, wl, max_mant, fp16_first, s); return true;
    case 8: launch_rows_vec<2, 1>(x, out, nblocks, wl, max_mant, fp16_first, s); return true;
    case 16: launch_rows_vec<4, 1>(x, out, nblocks, wl, max_mant, fp16_first, s); return true;
    case 32: launch_rows_vec<8, 1>(x, out, nblocks, wl, max_mant, fp16_first, s); return true;
    case 64: launch_rows_vec<16, 1>(x, out, nblocks, wl, max_mant, fp16_first, s); return true;
    case 128: launch_rows_vec<32, 1>(x, out, nblocks, wl, max_mant, fp16_first, s); return true;
    case 256: launch_rows_vec<32, 2>(x, out, nblocks, wl, max_mant, fp16_first, s); return true;
    default: return false;
  }
}

template <int V>
void launch_tile(const float* x, float* out, long long tiles, int block, int inner, int wl,
                 float max_mant, bool fp16_first, cudaStream_t s) {
  const int col_tiles = (inner + TILE_COLS - 1) / TILE_COLS;
  const unsigned grid = (unsigned)(tiles * col_tiles);
  if (fp16_first)
    bfp_tile_kernel<V, true><<<grid, THREADS, 0, s>>>(x, out, block, inner, col_tiles, wl,
                                                       max_mant);
  else
    bfp_tile_kernel<V, false><<<grid, THREADS, 0, s>>>(x, out, block, inner, col_tiles, wl,
                                                        max_mant);
}

}  // namespace

extern "C" int dmx_bfp_cast(const void* x, void* out, int op, int outer, int len, int inner,
                            int block, int wl, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  const long long n = (long long)outer * len * inner;
  const bool aligned = (((uintptr_t)x | (uintptr_t)out) & 15u) == 0;
  if (op == OP_BFP || op == OP_FP16_BFP) {
    const bool fp16_first = op == OP_FP16_BFP;
    const float max_mant = (float)(2.0 - 1.0 / (double)(1LL << (wl - 2)));
    if (inner == 1) {
      if (block > MAX_PER_LANE * 32) return (int)cudaErrorInvalidValue;
      const long long nblocks = n / block;
      if (!launch_rows(xf, of, nblocks, block, wl, max_mant, fp16_first, aligned, s)) {
        const unsigned grid = grid_for(nblocks, ROW_WARPS);
        if (fp16_first)
          bfp_rows_kernel<true><<<grid, ROW_WARPS * 32, 0, s>>>(xf, of, nblocks, block, wl,
                                                                max_mant);
        else
          bfp_rows_kernel<false><<<grid, ROW_WARPS * 32, 0, s>>>(xf, of, nblocks, block, wl,
                                                                 max_mant);
      }
    } else {
      const long long tiles = (long long)outer * (len / block);
      if (aligned && inner % 4 == 0)
        launch_tile<4>(xf, of, tiles, block, inner, wl, max_mant, fp16_first, s);
      else
        launch_tile<1>(xf, of, tiles, block, inner, wl, max_mant, fp16_first, s);
    }
  } else if (op == OP_FP16) {
    if (aligned) {
      const long long n4 = n / 4;
      if (n4 > 0)
        fp16_vec_kernel<<<capped(grid_for(n4, THREADS)), THREADS, 0, s>>>(
            reinterpret_cast<const float4*>(xf), reinterpret_cast<float4*>(of), n4);
      if (n % 4)  // the last n % 4 elements
        fp16_kernel<<<1, THREADS, 0, s>>>(xf + 4 * n4, of + 4 * n4, n % 4);
    } else {
      fp16_kernel<<<capped(grid_for(n, THREADS)), THREADS, 0, s>>>(xf, of, n);
    }
  } else if (op >= OP_PROBE_A && op < OP_PROBE_A + 8) {
    const int probe = op - OP_PROBE_A;
    const long long n_out = (long long)outer * (probe == 1 ? len / block : len);
    probe_kernel<<<grid_for(n_out, THREADS), THREADS, 0, s>>>(xf, of, probe, outer, len, block);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
