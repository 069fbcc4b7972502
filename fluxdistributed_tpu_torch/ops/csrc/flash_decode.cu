// Flash decode for Hopper (sm_90a): one query row per slot against the
// slot KV cache, dense or paged.
//
// Replaces the TPU kernel fluxdistributed_tpu/ops/pallas_decode.py:
// _decode_kernel in both its forms: the dense slot cache (launched by
// _flash_decode_impl's pl.pallas_call) and the paged block pool
// (_flash_decode_paged_impl's pl.pallas_call).  It computes, for every
// slot b and query head h,
//
//   out[b, h] = softmax(q[b, h] . K[b, rows, h / G]^T / sqrt(D)) . V[...]
//
// over the allowed rows: rows <= idx[b] for a plain cache; for a
// windowed ring, rows whose slot_pos p satisfies
// p >= 0 && p <= idx[b] && (p > idx[b] - window || p < sinks).  All
// G = H / Hkv query heads of a group attend the shared K/V rows.  int8
// and fp8 (e4m3) rows are multiplied by their f32 per-row-per-head scale
// after loading.  Softmax is the f32 online softmax of
// ops/attention.py:online_softmax_update, and the result is
// acc / max(l, 1e-30), so a slot with nothing attendable gets exactly 0.
// The output is written in q's dtype.
//
// Paged form (flash_decode_paged_kernel).  K/V live in a shared pool
// [NB, bs, Hkv, D] (the scales in [NB, bs, Hkv]); logical row r of slot b
// lives at block page_table[b, r / bs], offset r % bs.  A row on an
// unbound page (-1, or an id outside the pool) is masked and never read.
// The CTA reads its page ids itself (the TPU's scalar prefetch has no
// counterpart here) while it builds each tile's row mask, and keeps each
// row's physical row index in shared memory for the loads.  Any block
// size bs >= 1 works: addressing is per row.  The dense form keeps a
// kernel of its own: one template for both changed the dense code's
// register allocation and slowed it by ~30 % in the decode step.
//
// Bound.  Decode is memory-bound: each step reads the live K/V rows (and
// their scales) once and does 4 * rows * H * D flops on them, far below
// the card's ~295 flops/byte balance point.  The least time is the live
// K/V bytes over the HBM rate.
//
// Design.  One CTA per (slot, KV head): a loop inside the CTA walks the
// row tiles, taking the place of the TPU's sequential KV grid axis
// (nothing carries between CTAs on Hopper).  The plain cache walks only
// up to the cursor's tile; a tile with no allowed row (past the cursor,
// out of band, unwritten, or on unbound pages) is skipped before any of
// its K/V bytes are read, and inside a live tile the paged walk loads
// only allowed rows, so cost follows the live tokens.  K/V rows load 16
// bytes per thread along D, dequantise to f32 in shared memory, and scores,
// probabilities and the accumulator stay in f32.  At lm_small with 8
// slots that is B * Hkv = 96 CTAs, less than one wave on 132 SMs, with no
// overlap of loads and math inside a CTA.  Split-KV, cp.async/TMA
// pipelining, page-granular tiles and tensor-core scores are left for a
// later change.
//
// The launchers run on the caller's stream, allocate nothing, and
// return cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// dtype codes shared with ops/flash_decode.py
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// One 16-byte load of a K/V row segment, widened to f32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ static void load(const int8_t* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
  }
};

template <>
struct Vec16<__nv_fp8_e4m3> {
  static constexpr int N = 16;
  __device__ static void load(const __nv_fp8_e4m3* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_fp8_e4m3* c = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows per tile: a tile of K in f32 is about 16 KB whatever D is.
__host__ __device__ inline int tile_rows(int d) {
  return d <= 64 ? 64 : (d <= 128 ? 32 : 16);
}

__host__ inline size_t smem_bytes(int g, int d, bool paged) {
  const int t = tile_rows(d);
  const size_t floats = static_cast<size_t>(t) * (d + 1)  // K tile (padded)
                        + static_cast<size_t>(t) * d      // V tile
                        + 2 * static_cast<size_t>(g) * d  // q, acc
                        + static_cast<size_t>(g) * t      // scores / p
                        + 3 * static_cast<size_t>(g);     // m, l, corr
  // per tile row: allowed flag (and, paged, the physical row index)
  return floats * sizeof(float) + (paged ? 2 : 1) * static_cast<size_t>(t) * sizeof(int);
}

template <typename TQ, typename TKV, bool kWindowed, bool kQuant>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const TQ* __restrict__ q,            // [B, H, D]
    const TKV* __restrict__ k,           // [B, R, Hkv, D]
    const TKV* __restrict__ v,           // [B, R, Hkv, D]
    const int32_t* __restrict__ idx,     // [B]
    const int32_t* __restrict__ slot_pos,  // [B, R] (windowed only)
    const float* __restrict__ k_scale,   // [B, R, Hkv] (quantised only)
    const float* __restrict__ v_scale,   // [B, R, Hkv] (quantised only)
    TQ* __restrict__ out,                // [B, H, D]
    int R, int H, int Hkv, int D, int window, int sinks, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int tile = tile_rows(D);
  const int ks_stride = D + 1;  // pad: lanes on consecutive rows hit distinct banks
  float* Ks = smem;
  float* Vs = Ks + tile * ks_stride;
  float* Qs = Vs + tile * D;
  float* Acc = Qs + G * D;
  float* S = Acc + G * D;
  float* M = S + G * tile;
  float* L = M + G;
  float* Corr = L + G;
  int* allow = reinterpret_cast<int*>(Corr + G);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int cursor = idx[b];
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const TKV* kb = k + static_cast<size_t>(b) * R * row_stride + static_cast<size_t>(hk) * D;
  const TKV* vb = v + static_cast<size_t>(b) * R * row_stride + static_cast<size_t>(hk) * D;
  const size_t qo = (static_cast<size_t>(b) * H + static_cast<size_t>(hk) * G) * D;

  for (int i = tid; i < G * D; i += kThreads) {
    Qs[i] = to_f32(q[qo + i]) * scale;
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    M[g] = kNegInf;
    L[g] = 0.f;
  }

  // the plain cache walks only up to the cursor's tile
  const int rows = kWindowed ? R : min(max(cursor + 1, 0), R);
  const int ntiles = (rows + tile - 1) / tile;
  constexpr int kVec = Vec16<TKV>::N;
  const int vec_per_row = D / kVec;
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    const int r0 = t * tile;
    const int nrows = min(tile, R - r0);
    int any = 0;
    for (int r = tid; r < tile; r += kThreads) {
      int ok = 0;
      if (r < nrows) {
        const int row = r0 + r;
        if (kWindowed) {
          const int p = slot_pos[static_cast<size_t>(b) * R + row];
          ok = p >= 0 && p <= cursor && (p > cursor - window || p < sinks);
        } else {
          ok = row <= cursor;
        }
      }
      allow[r] = ok;
      any |= ok;
    }
    // dead tile (out of band / unwritten ring slots): no K/V bytes read
    if (!__syncthreads_or(any)) continue;

    for (int i = tid; i < nrows * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row;
      const int c = (i - r * vec_per_row) * kVec;
      const size_t off = static_cast<size_t>(r0 + r) * row_stride + c;
      float kf[kVec], vf[kVec];
      Vec16<TKV>::load(kb + off, kf);
      Vec16<TKV>::load(vb + off, vf);
      float ks = 1.f, vs = 1.f;
      if (kQuant) {
        const size_t so = (static_cast<size_t>(b) * R + r0 + r) * Hkv + hk;
        ks = k_scale[so];
        vs = v_scale[so];
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        Ks[r * ks_stride + c + j] = kf[j] * ks;
        Vs[r * D + c + j] = vf[j] * vs;
      }
    }
    __syncthreads();

    // scores: one (query head, row) pair per thread
    for (int i = tid; i < G * tile; i += kThreads) {
      const int g = i / tile;
      const int r = i - g * tile;
      float s = kNegInf;
      if (allow[r]) {
        const float* kr = Ks + r * ks_stride;
        const float* qr = Qs + g * D;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc;
      }
      S[g * tile + r] = s;
    }
    __syncthreads();

    // online softmax update: one warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sg = S + g * tile;
      float mx = kNegInf;
      for (int r = lane; r < tile; r += 32) mx = fmaxf(mx, sg[r]);
      mx = warp_max(mx);
      const float m_old = M[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < tile; r += 32) {
        // masked rows are zeroed explicitly: while nothing is allowed,
        // m_new is still kNegInf and exp(s - m_new) would be 1
        const float p = allow[r] ? expf(sg[r] - m_new) : 0.f;
        sg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Corr[g] = corr;
        L[g] = L[g] * corr + sum;
        M[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V, one (query head, feature) pair per thread
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = S + g * tile;
      float a = Acc[i] * Corr[g];
      for (int r = 0; r < nrows; ++r) a = fmaf(pg[r], Vs[r * D + d], a);
      Acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const float l = fmaxf(L[i / D], 1e-30f);
    out[qo + i] = from_f32<TQ>(Acc[i] / l);
  }
}

// The paged form: the same computation, each row addressed through the
// page table.  A kernel of its own, so that the dense kernel's code stays
// as it was.
template <typename TQ, typename TKV, bool kWindowed, bool kQuant>
__global__ void __launch_bounds__(kThreads) flash_decode_paged_kernel(
    const TQ* __restrict__ q,            // [B, H, D]
    const TKV* __restrict__ k,           // [NB, bs, Hkv, D]
    const TKV* __restrict__ v,           // [NB, bs, Hkv, D]
    const int32_t* __restrict__ page_table,  // [B, P]
    const int32_t* __restrict__ idx,     // [B]
    const int32_t* __restrict__ slot_pos,  // [B, R = P * bs] (windowed only)
    const float* __restrict__ k_scale,   // [NB, bs, Hkv] (quantised only)
    const float* __restrict__ v_scale,   // [NB, bs, Hkv] (quantised only)
    TQ* __restrict__ out,                // [B, H, D]
    int R, int P, int bs, int NB, int H, int Hkv, int D, int window,
    int sinks, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int tile = tile_rows(D);
  const int ks_stride = D + 1;  // pad: lanes on consecutive rows hit distinct banks
  float* Ks = smem;
  float* Vs = Ks + tile * ks_stride;
  float* Qs = Vs + tile * D;
  float* Acc = Qs + G * D;
  float* S = Acc + G * D;
  float* M = S + G * tile;
  float* L = M + G;
  float* Corr = L + G;
  int* allow = reinterpret_cast<int*>(Corr + G);
  int* prow = allow + tile;  // each tile row's physical pool row

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int cursor = idx[b];
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const TKV* kb = k + static_cast<size_t>(hk) * D;
  const TKV* vb = v + static_cast<size_t>(hk) * D;
  const size_t qo = (static_cast<size_t>(b) * H + static_cast<size_t>(hk) * G) * D;

  for (int i = tid; i < G * D; i += kThreads) {
    Qs[i] = to_f32(q[qo + i]) * scale;
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    M[g] = kNegInf;
    L[g] = 0.f;
  }

  // the plain cache walks only up to the cursor's tile
  const int rows = kWindowed ? R : min(max(cursor + 1, 0), R);
  const int ntiles = (rows + tile - 1) / tile;
  constexpr int kVec = Vec16<TKV>::N;
  const int vec_per_row = D / kVec;
  __syncthreads();

  for (int t = 0; t < ntiles; ++t) {
    const int r0 = t * tile;
    const int nrows = min(tile, R - r0);
    int any = 0;
    for (int r = tid; r < tile; r += kThreads) {
      int ok = 0;
      if (r < nrows) {
        const int row = r0 + r;
        // the page-table walk: this row's block, read by the CTA itself
        const int blk = page_table[static_cast<size_t>(b) * P + row / bs];
        ok = blk >= 0 && blk < NB;
        prow[r] = blk * bs + row % bs;
        if (kWindowed) {
          const int p = slot_pos[static_cast<size_t>(b) * R + row];
          ok = ok && p >= 0 && p <= cursor && (p > cursor - window || p < sinks);
        } else {
          ok = ok && row <= cursor;
        }
      }
      allow[r] = ok;
      any |= ok;
    }
    // dead tile (past the cursor / out of band / unwritten / unbound
    // pages): no K/V bytes read
    if (!__syncthreads_or(any)) continue;

    for (int i = tid; i < nrows * vec_per_row; i += kThreads) {
      const int r = i / vec_per_row;
      const int c = (i - r * vec_per_row) * kVec;
      float kf[kVec], vf[kVec];
      float ks = 1.f, vs = 1.f;
      if (!allow[r]) {
        // a masked row may sit on an unbound page: never read it; zeros
        // keep P.V clear of stale shared memory
#pragma unroll
        for (int j = 0; j < kVec; ++j) kf[j] = vf[j] = 0.f;
      } else {
        const size_t row = static_cast<size_t>(prow[r]);
        const size_t off = row * row_stride + c;
        Vec16<TKV>::load(kb + off, kf);
        Vec16<TKV>::load(vb + off, vf);
        if (kQuant) {
          const size_t so = row * Hkv + hk;
          ks = k_scale[so];
          vs = v_scale[so];
        }
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        Ks[r * ks_stride + c + j] = kf[j] * ks;
        Vs[r * D + c + j] = vf[j] * vs;
      }
    }
    __syncthreads();

    // scores: one (query head, row) pair per thread
    for (int i = tid; i < G * tile; i += kThreads) {
      const int g = i / tile;
      const int r = i - g * tile;
      float s = kNegInf;
      if (allow[r]) {
        const float* kr = Ks + r * ks_stride;
        const float* qr = Qs + g * D;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc;
      }
      S[g * tile + r] = s;
    }
    __syncthreads();

    // online softmax update: one warp per query head
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sg = S + g * tile;
      float mx = kNegInf;
      for (int r = lane; r < tile; r += 32) mx = fmaxf(mx, sg[r]);
      mx = warp_max(mx);
      const float m_old = M[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < tile; r += 32) {
        // masked rows are zeroed explicitly: while nothing is allowed,
        // m_new is still kNegInf and exp(s - m_new) would be 1
        const float p = allow[r] ? expf(sg[r] - m_new) : 0.f;
        sg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Corr[g] = corr;
        L[g] = L[g] * corr + sum;
        M[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V, one (query head, feature) pair per thread
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = S + g * tile;
      float a = Acc[i] * Corr[g];
      for (int r = 0; r < nrows; ++r) a = fmaf(pg[r], Vs[r * D + d], a);
      Acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const float l = fmaxf(L[i / D], 1e-30f);
    out[qo + i] = from_f32<TQ>(Acc[i] / l);
  }
}

// Everything a launch needs besides the template arguments.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* page_table;
  const int32_t* idx;
  const int32_t* slot_pos;
  const float* k_scale;
  const float* v_scale;
  void* out;
  int B, R, P, bs, NB, H, Hkv, D, window, sinks;
  float scale;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, bool kWindowed, bool kQuant, bool kPaged>
cudaError_t launch(const Args& a) {
  const size_t smem = smem_bytes(a.H / a.Hkv, a.D, kPaged);
  const dim3 grid(a.B * a.Hkv);
  if constexpr (kPaged) {
    auto kernel = flash_decode_paged_kernel<TQ, TKV, kWindowed, kQuant>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
        static_cast<const TKV*>(a.v), a.page_table, a.idx, a.slot_pos,
        a.k_scale, a.v_scale, static_cast<TQ*>(a.out), a.R, a.P, a.bs, a.NB,
        a.H, a.Hkv, a.D, a.window, a.sinks, a.scale);
  } else {
    auto kernel = flash_decode_kernel<TQ, TKV, kWindowed, kQuant>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
        static_cast<const TKV*>(a.v), a.idx, a.slot_pos, a.k_scale,
        a.v_scale, static_cast<TQ*>(a.out), a.R, a.H, a.Hkv, a.D, a.window,
        a.sinks, a.scale);
  }
  return cudaGetLastError();
}

template <typename TQ, typename TKV, bool kQuant>
cudaError_t dispatch_mode(int windowed, int paged, const Args& a) {
  if (paged) {
    return windowed ? launch<TQ, TKV, true, kQuant, true>(a)
                    : launch<TQ, TKV, false, kQuant, true>(a);
  }
  return windowed ? launch<TQ, TKV, true, kQuant, false>(a)
                  : launch<TQ, TKV, false, kQuant, false>(a);
}

cudaError_t dispatch(int q_dtype, int kv_dtype, int windowed, int paged,
                     const Args& a) {
  if (a.B == 0 || a.Hkv == 0) return cudaSuccess;
  if (a.H % a.Hkv != 0 || a.D % 16 != 0 || a.D > 256 || a.R < 1) {
    return cudaErrorInvalidValue;
  }
  const int quant = kv_dtype == kI8 || kv_dtype == kFP8;
  if (quant && (a.k_scale == nullptr || a.v_scale == nullptr)) return cudaErrorInvalidValue;
  if (windowed && a.slot_pos == nullptr) return cudaErrorInvalidValue;
  if (paged && (a.page_table == nullptr || a.bs < 1 || a.NB < 1)) return cudaErrorInvalidValue;
  if (q_dtype == kF32) {
    switch (kv_dtype) {
      case kF32: return dispatch_mode<float, float, false>(windowed, paged, a);
      case kI8: return dispatch_mode<float, int8_t, true>(windowed, paged, a);
      case kFP8: return dispatch_mode<float, __nv_fp8_e4m3, true>(windowed, paged, a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (q_dtype == kBF16) {
    switch (kv_dtype) {
      case kBF16: return dispatch_mode<__nv_bfloat16, __nv_bfloat16, false>(windowed, paged, a);
      case kI8: return dispatch_mode<__nv_bfloat16, int8_t, true>(windowed, paged, a);
      case kFP8: return dispatch_mode<__nv_bfloat16, __nv_fp8_e4m3, true>(windowed, paged, a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points, bound with ctypes by ops/flash_decode.py.  Every
// pointer is a device pointer (slot_pos, k_scale and v_scale may be
// null when unused); stream is a cudaStream_t.  Each returns a
// cudaError_t.

// Dense slot cache: k/v [B, R, Hkv, D], scales [B, R, Hkv].
extern "C" int flash_decode_launch(
    int q_dtype, int kv_dtype, int windowed, const void* q, const void* k,
    const void* v, const void* idx, const void* slot_pos, const void* k_scale,
    const void* v_scale, void* out, int B, int R, int H, int Hkv, int D,
    int window, int sinks, float scale, void* stream) {
  const Args a{q, k, v, nullptr, static_cast<const int32_t*>(idx),
               static_cast<const int32_t*>(slot_pos),
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), out, B, R, 0, 0, 0, H, Hkv,
               D, window, sinks, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(q_dtype, kv_dtype, windowed, 0, a);
}

// Paged block pool: k/v [NB, bs, Hkv, D], scales [NB, bs, Hkv], page
// table [B, P], slot_pos [B, P * bs].
extern "C" int flash_decode_paged_launch(
    int q_dtype, int kv_dtype, int windowed, const void* q, const void* k_pool,
    const void* v_pool, const void* page_table, const void* idx,
    const void* slot_pos, const void* k_scale, const void* v_scale, void* out,
    int B, int P, int bs, int NB, int H, int Hkv, int D, int window, int sinks,
    float scale, void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const int32_t*>(page_table),
               static_cast<const int32_t*>(idx),
               static_cast<const int32_t*>(slot_pos),
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), out, B, P * bs, P, bs, NB, H,
               Hkv, D, window, sinks, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(q_dtype, kv_dtype, windowed, 1, a);
}

// cudaGetErrorString for the wrapper's error message.
extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
