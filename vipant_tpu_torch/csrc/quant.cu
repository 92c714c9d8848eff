// rowquant / layernorm_rowquant: per-row (per-token) symmetric int8
// quantization, alone and fused behind LayerNorm.
//
//   scale[r] = max_k |x[r, k]| / 127 + 1e-12              (fp32)
//   q[r, k]  = clip(round_half_even(x[r, k] / scale[r]), -127, 127)
//
// Replaces: the in-kernel activation quantizations of the Pallas int8 kernels
//   vipant_tpu/ops/fused_attn.py::_fwd_int8_kernel (of LN(x), lines 137-140;
//     of the fp32 attention context, lines 156-158) and
//   vipant_tpu/ops/fused_mlp.py::_fwd_int8_kernel (of LN(x), lines 110-111;
//     of the fp32 act(a), line 115),
// which are `quantize_rows` of vipant_tpu/ops/quant.py on VMEM-resident
// tiles. The same kernel quantizes the projection weights per output column
// (`quantize_cols` there): in the torch [out, in] layout an output column is
// a row.
//
// On the TPU the tensors to quantize never left VMEM. A per-token scale
// spans the whole row (all heads of the context, all 4C columns of the MLP
// activation), which no single tile of the product before it holds, so here
// the quantization is its own pass over rows that the producer wrote to
// device memory in the type the Pallas kernel quantized from (fp32 for the
// context and act(a)); only LayerNorm, whose kernel already owns whole rows,
// is fused with it.
//
// Bound: memory. One read of the row (4 or 2 bytes an element) and one
// 1-byte write of its codes. At the paths' widths a value costs about 20
// instructions besides (the LayerNorm, the maximum, the code), which is
// why neither kernel reaches the bound: an IEEE division per value would
// cost as much again.
//
// Design: a warp per row (2 or 4 warps for the widest rows) on a persistent
// grid of 4-warp blocks, the row read once into registers, and up to 8
// vectors a lane the warp's next row in flight while this one is
// quantized. rowquant: each lane holds its share of the row as 16-byte
// vectors (8 bf16 or 4 fp32 values; lane l of the row's 32 w lanes takes
// vectors l, l + 32 w, ...; kVecs of them, a template parameter, all issued
// before any arithmetic). The row's maximum magnitude is an xor-shuffle
// butterfly of the lanes' maxima (with 2 or 4 warps a row, then one
// exchange of the warps' maxima through shared memory, double buffered,
// one barrier of the row's warps). The codes come from the registers
// (`put_codes`): the division's codes, taken from the product by the IEEE
// reciprocal where that provably gives the same code (`code_by_product`),
// by IEEE division where it does not (`__fdiv_rn`, as the Pallas kernel
// divides: multiplying by a reciprocal alone flips codes); the codes of one
// vector go out in one store (8 bytes for bf16, 4 for fp32), and one lane
// writes the scale. A row that is no whole number of 16-byte vectors takes
// the same kernel with scalar loads (a vector of one value), and a row too
// wide for the registers (kVecs = 0: past 3,072 fp32 or 6,144 bf16 values,
// on no path) is read twice, the maximum, then the codes. The host picks
// the instance and the grid (kernels.rowquant_plan, which mirrors kShapes
// and RowSchedule below); the entry point launches what it is given.
//
// layernorm_rowquant: layernorm_fwd's kernel (layernorm.cu) with another
// output. The statistics come from rows.cuh's `warp_row_stats` of the
// registers, so they are layernorm_fwd's bits; each value goes through the
// same affine step and is rounded to bf16 (two values an instruction, the
// same rounding) in place of x in the registers; then the maximum and the
// codes as in rowquant. The normalised row makes no trip through device
// memory, and the result is bitwise rowquant(layernorm_fwd(x)). Its wrapper
// keeps layernorm_fwd's contract (C % 8 == 0, C <= 2048, x 16-byte
// aligned).
//
// No shared-memory copy of the row and no block-wide barrier in either row
// loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int kBlockWarps = 4;  // warps a block of either kernel (kernels.ROWQUANT_BLOCK_WARPS)

__device__ __forceinline__ float scale_of(float amax) {
  return __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
}

// The int8 code of v is rint(v / s) clipped to +-127, v / s by IEEE
// division (`__fdiv_rn`, the Pallas kernel's), rint half to even: this is
// `code_by_division`, in the low byte. `code_by_product` gets the same code
// from r = 1 / s (IEEE) where it can prove it. Every v of a row has
// |v / s| <= 127.00001 (s >= max |v| / 127 rounded down by at most half an
// ulp), so the product p = v * r, two roundings of 2^-24, lies within
// 127.00001 * 2^-23 < 2^-16 of v / s, and the IEEE quotient within 2^-17.
// Where p is further than 0.5 - 2^-14 from its nearest integer t, v / s and
// the quotient are both within 0.5 - 2^-14 + 2^-16 + 2^-17 < 0.5 of t, so
// the quotient rounds to t as well, and t is within +-127. t comes from
// p + 1.5 * 2^23, which rounds half to even at the units and holds t in its
// low mantissa bits, two's complement: no conversion instruction. Where
// that fails (about one value in 8,000, and NaN or inf), `proven` is
// cleared and the caller takes the division.
__device__ __forceinline__ unsigned code_by_product(float v, float r, bool& proven) {
  constexpr float kUnits = 12582912.f;  // 1.5 * 2^23
  const float p = __fmul_rn(v, r), m = __fadd_rn(p, kUnits);
  proven &= fabsf(__fsub_rn(p, __fsub_rn(m, kUnits))) < 0.5f - 0x1p-14f;
  return __float_as_uint(m);
}

__device__ __forceinline__ unsigned code_by_division(float v, float s) {
  return static_cast<unsigned>(__float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f)));
}

// the low bytes of four codes, in order, as one word
__device__ __forceinline__ unsigned pack4(const unsigned* c) {
  return __byte_perm(__byte_perm(c[0], c[1], 0x0040), __byte_perm(c[2], c[3], 0x0040), 0x5410);
}

// How a lane reads its share of a row of T: kN values a load, held in `Raw`,
// and how the kN codes of a load go out (one store).
template <typename T, bool kVector>
struct Load;

template <>
struct Load<__nv_bfloat16, true> {  // 16 bytes: 8 bf16
  static constexpr int kN = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ Raw get(const __nv_bfloat16* r, int j) {
    return reinterpret_cast<const uint4*>(r)[j];
  }
  static __device__ __forceinline__ void values(const Raw& v, float (&f)[kN]) { rows::unpack8(v, f); }
  static __device__ __forceinline__ void put(signed char* q, int j, const unsigned (&c)[kN]) {
    reinterpret_cast<uint2*>(q)[j] = make_uint2(pack4(c), pack4(c + 4));
  }
};

template <>
struct Load<float, true> {  // 16 bytes: 4 fp32
  static constexpr int kN = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ Raw get(const float* r, int j) {
    return reinterpret_cast<const float4*>(r)[j];
  }
  static __device__ __forceinline__ void values(const Raw& v, float (&f)[kN]) {
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
  static __device__ __forceinline__ void put(signed char* q, int j, const unsigned (&c)[kN]) {
    reinterpret_cast<unsigned*>(q)[j] = pack4(c);
  }
};

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) { v = __ushort_as_bfloat16(0); }

template <typename T>
struct Load<T, false> {  // one value a load: rows that are no whole number of 16-byte vectors
  static constexpr int kN = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw zero() {
    T v;
    set_zero(v);
    return v;
  }
  static __device__ __forceinline__ Raw get(const T* r, int j) { return r[j]; }
  static __device__ __forceinline__ void values(const Raw& v, float (&f)[kN]) { f[0] = as_float(v); }
  static __device__ __forceinline__ void put(signed char* q, int j, const unsigned (&c)[kN]) {
    q[j] = static_cast<signed char>(c[0]);
  }
};

// rowquant's schedule by the loads a lane holds (kVecs; 0: the row read
// twice from memory): whether the next row is in flight while this one is
// quantized, and the blocks an SM holds at once (the register budget);
// kernels.rowquant_plan plans its grid with the same numbers.
template <int kVecs>
struct RowSchedule {
  static constexpr bool kPrefetch = kVecs > 0 && kVecs <= 8;
  static constexpr int kBlocksPerSM = kVecs <= 2 ? 8 : kVecs <= 4 ? 6 : 4;
};

// the (warps a row, loads a lane) instances, smallest first:
// kernels.ROWQUANT_SHAPES, which rowquant_plan takes the first of whose
// 32 * warps * loads hold the row, or else the last (the row read twice)
struct Shape {
  int warps, vecs;
};
constexpr Shape kShapes[] = {{1, 2}, {1, 3}, {1, 4}, {1, 6}, {2, 8}, {4, 6}, {4, 0}};
constexpr int kNumShapes = sizeof(kShapes) / sizeof(kShapes[0]);

// the row's maximum over the kWarps warps that hold it: an xor butterfly,
// then (kWarps > 1) the warps' maxima through `red`, indexed by the parity
// of the row's turn so that one barrier of those warps a row suffices (a
// warp writes a slot again only after every warp of its row has passed the
// next row's barrier, so after each has read it)
template <int kWarps>
__device__ __forceinline__ float row_max(float m, float (&red)[2][kBlockWarps], int parity) {
  m = rows::warp_max(m);
  if constexpr (kWarps > 1) {
    const int warp = threadIdx.x >> 5, first = warp - warp % kWarps;
    if ((threadIdx.x & 31) == 0) red[parity][warp] = m;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / kWarps), "r"(32 * kWarps) : "memory");
    m = red[parity][first];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[parity][first + w]);
  }
  return m;
}

template <typename L, int kVecs, typename T>
__device__ __forceinline__ void load_share(const T* __restrict__ xr, int n, int lane, int stride,
                                           bool valid, typename L::Raw (&v)[kVecs]) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + stride * i;
    v[i] = valid && j < n ? L::get(xr, j) : L::zero();
  }
}

// the codes of this lane's loads v[i] (i < kVecs, lane + stride i < n) of
// a row of scale s, r = 1 / s, stored into the row's codes qr: a load's
// codes from the products, and only where one of them is not proven (about
// one load in 1,000 at the paths' widths) all of that load's by the
// division
template <typename L, int kVecs>
__device__ __forceinline__ void put_codes(const typename L::Raw (&v)[kVecs], signed char* qr, int n,
                                          int lane, int stride, float s, float r) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int j = lane + stride * i;
    if (j < n) {
      float f[L::kN];
      L::values(v[i], f);
      unsigned c[L::kN];
      bool proven = true;
#pragma unroll
      for (int k = 0; k < L::kN; ++k) c[k] = code_by_product(f[k], r, proven);
      if (!proven) {
#pragma unroll
        for (int k = 0; k < L::kN; ++k) c[k] = code_by_division(f[k], s);
      }
      L::put(qr, j, c);
    }
  }
}

// codes and scale of rows [0, n_rows) of x [n_rows, K]; a row is n = K / kN
// loads, taken by the kWarps warps of its group, lane l of the group taking
// loads l, l + 32 kWarps, ...
template <typename T, bool kVector, int kWarps, int kVecs>
__global__ void __launch_bounds__(kBlockWarps * 32, RowSchedule<kVecs>::kBlocksPerSM)
rowquant_kernel(const T* __restrict__ x, signed char* __restrict__ q, float* __restrict__ scale,
                long long n_rows, int K) {
  using L = Load<T, kVector>;
  using Raw = typename L::Raw;
  constexpr int kStride = 32 * kWarps, kGroups = kBlockWarps / kWarps;
  __shared__ float red[2][kBlockWarps];
  const int lane = threadIdx.x % kStride, n = K / L::kN;
  const long long step = static_cast<long long>(gridDim.x) * kGroups;
  long long row = static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / kStride;
  int parity = 0;
  if constexpr (kVecs > 0) {
    Raw v[kVecs];
    load_share<L>(x + row * K, n, lane, kStride, row < n_rows, v);
    for (; row < n_rows; row += step, parity ^= 1) {
      Raw next[kVecs];  // the next row, in flight while this one is quantized
      if constexpr (RowSchedule<kVecs>::kPrefetch)
        load_share<L>(x + (row + step) * K, n, lane, kStride, row + step < n_rows, next);
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        if (lane + kStride * i < n) {
          float f[L::kN];
          L::values(v[i], f);
#pragma unroll
          for (int k = 0; k < L::kN; ++k) m = fmaxf(m, fabsf(f[k]));
        }
      }
      const float s = scale_of(row_max<kWarps>(m, red, parity)), r = __frcp_rn(s);
      if (lane == 0) scale[row] = s;
      put_codes<L>(v, q + row * K, n, lane, kStride, s, r);
      if constexpr (RowSchedule<kVecs>::kPrefetch) {
#pragma unroll
        for (int i = 0; i < kVecs; ++i) v[i] = next[i];
      } else {
        load_share<L>(x + (row + step) * K, n, lane, kStride, row + step < n_rows, v);
      }
    }
  } else {  // the row read twice: the maximum, then the codes
    for (; row < n_rows; row += step, parity ^= 1) {
      const T* xr = x + row * K;
      float m = 0.f;
      for (int j = lane; j < n; j += kStride) {
        float f[L::kN];
        L::values(L::get(xr, j), f);
#pragma unroll
        for (int k = 0; k < L::kN; ++k) m = fmaxf(m, fabsf(f[k]));
      }
      const float s = scale_of(row_max<kWarps>(m, red, parity)), r = __frcp_rn(s);
      if (lane == 0) scale[row] = s;
      for (int j = lane; j < n; j += kStride) {
        const Raw one[1] = {L::get(xr, j)};
        put_codes<L>(one, q + row * K, n, j, 0, s, r);
      }
    }
  }
}

template <typename T, bool kVector, int I = 0>
cudaError_t launch_rowquant(int warps, int vecs, int blocks, const void* x, void* q, void* scale,
                            long long n_rows, int K, cudaStream_t s) {
  if constexpr (I == kNumShapes) {
    return cudaErrorInvalidValue;  // no such instance
  } else {
    constexpr Shape sh = kShapes[I];
    if (sh.warps != warps || sh.vecs != vecs)
      return launch_rowquant<T, kVector, I + 1>(warps, vecs, blocks, x, q, scale, n_rows, K, s);
    rowquant_kernel<T, kVector, sh.warps, sh.vecs><<<static_cast<unsigned>(blocks), kBlockWarps * 32, 0, s>>>(
        static_cast<const T*>(x), static_cast<signed char*>(q), static_cast<float*>(scale), n_rows, K);
    return cudaGetLastError();
  }
}

// q [n_rows, C] int8 and scale [n_rows] of LayerNorm(x) rounded to bf16:
// layernorm_fwd_kernel's row loop, with the codes in place of y
template <int kVecs>
__global__ void __launch_bounds__(kBlockWarps * 32)
layernorm_rowquant_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, signed char* __restrict__ q,
                          float* __restrict__ scale, long long n_rows, int C, float eps) {
  const int lane = threadIdx.x & 31, nv = C >> 3;
  float wl[kVecs][8], bl[kVecs][8];  // w and b of this lane's columns
  rows::load_affine(w, b, C, lane, wl, bl);
  const long long stride = static_cast<long long>(gridDim.x) * kBlockWarps;
  long long row = static_cast<long long>(blockIdx.x) * kBlockWarps + (threadIdx.x >> 5);
  uint4 v[kVecs];
  rows::load_row(x + row * C, C, lane, row < n_rows, v);
  for (; row < n_rows; row += stride) {
    uint4 next[kVecs];  // the warp's next row, in flight while this one is quantized
    rows::load_row(x + (row + stride) * C, C, lane, row + stride < n_rows, next);
    const float2 st = rows::warp_row_stats(v, C, lane, eps);
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {  // LN(x) rounded to bf16, in place of x; zero past the row
      if (lane + 32 * i < nv) {
        float f[8];
        rows::unpack8(v[i], f);
        unsigned u[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // two values rounded to bf16 in one instruction, as ln_affine rounds
          const __nv_bfloat162 h =
              __floats2bfloat162_rn(rows::ln_affine_f32(f[2 * k], st, wl[i][2 * k], bl[i][2 * k]),
                                    rows::ln_affine_f32(f[2 * k + 1], st, wl[i][2 * k + 1], bl[i][2 * k + 1]));
          u[k] = reinterpret_cast<const unsigned&>(h);
        }
        v[i] = make_uint4(u[0], u[1], u[2], u[3]);
        rows::unpack8(v[i], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) m = fmaxf(m, fabsf(f[k]));
      }
    }
    const float s = scale_of(rows::warp_max(m)), r = __frcp_rn(s);
    if (lane == 0) scale[row] = s;
    put_codes<Load<__nv_bfloat16, true>>(v, q + row * C, nv, lane, 32, s, r);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) v[i] = next[i];
  }
}

template <int kVecs>
cudaError_t launch_ln_rowquant(const void* x, const void* w, const void* b, void* q, void* scale,
                               long long n_rows, int C, float eps, cudaStream_t s) {
  static int slots[64];
  const int cap = rows::resident_blocks(slots, layernorm_rowquant_kernel<kVecs>, kBlockWarps * 32);
  if (cap < 0) return cudaErrorInvalidDevice;
  const long long need = (n_rows + kBlockWarps - 1) / kBlockWarps;
  const unsigned grid = static_cast<unsigned>(need < cap ? need : cap);
  layernorm_rowquant_kernel<kVecs><<<grid, kBlockWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<signed char*>(q), static_cast<float*>(scale), n_rows,
      C, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q [rows, K] int8 and scale [rows] fp32 of x [rows, K], fp32 (is_f32) or
// bf16, as kernels.rowquant_plan gives the launch: `per_load` values a load
// (16 / itemsize: 16-byte vectors, x and q 16-byte aligned and K a whole
// number of them; 1: scalar loads), `warps` a row, `vecs` loads a lane (0:
// the row read twice), `blocks` blocks of 4 warps
extern "C" int vt_rowquant(const void* x, int is_f32, void* q, void* scale, long long rows_n, int K,
                           int per_load, int warps, int vecs, int blocks, void* stream) {
  if (rows_n <= 0 || K <= 0) return 0;
  const int itemsize = is_f32 ? 4 : 2;
  const bool vector = per_load != 1;
  if (blocks <= 0 || vecs < 0 ||
      (vector && (per_load != 16 / itemsize || (K * itemsize) % 16 != 0 || !aligned16(x) ||
                  !aligned16(q))) ||
      (vecs > 0 && 32LL * warps * vecs < K / per_load))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_f32)
    err = vector ? launch_rowquant<float, true>(warps, vecs, blocks, x, q, scale, rows_n, K, s)
                 : launch_rowquant<float, false>(warps, vecs, blocks, x, q, scale, rows_n, K, s);
  else
    err = vector ? launch_rowquant<__nv_bfloat16, true>(warps, vecs, blocks, x, q, scale, rows_n, K, s)
                 : launch_rowquant<__nv_bfloat16, false>(warps, vecs, blocks, x, q, scale, rows_n, K, s);
  return static_cast<int>(err);
}

// q [rows, C] int8 and scale [rows] fp32 of LayerNorm(x) rounded to bf16;
// layernorm_fwd's contract on C and alignment
extern "C" int vt_layernorm_rowquant(const void* x, const void* w, const void* b, void* q,
                                     void* scale, long long rows_n, int C, float eps,
                                     void* stream) {
  if (rows_n <= 0) return 0;
  if (C <= 0 || C % 8 != 0 || C > rows::kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((C + 255) / 256) {  // 16-byte vectors a lane holds
    case 1: err = launch_ln_rowquant<1>(x, w, b, q, scale, rows_n, C, eps, s); break;
    case 2: err = launch_ln_rowquant<2>(x, w, b, q, scale, rows_n, C, eps, s); break;
    case 3: err = launch_ln_rowquant<3>(x, w, b, q, scale, rows_n, C, eps, s); break;
    case 4: err = launch_ln_rowquant<4>(x, w, b, q, scale, rows_n, C, eps, s); break;
    case 5: err = launch_ln_rowquant<5>(x, w, b, q, scale, rows_n, C, eps, s); break;
    case 6: err = launch_ln_rowquant<6>(x, w, b, q, scale, rows_n, C, eps, s); break;
    case 7: err = launch_ln_rowquant<7>(x, w, b, q, scale, rows_n, C, eps, s); break;
    default: err = launch_ln_rowquant<8>(x, w, b, q, scale, rows_n, C, eps, s); break;
  }
  return static_cast<int>(err);
}
