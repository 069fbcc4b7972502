// Flash decode for Hopper (sm_90a): one query row per slot against a
// dense slot KV cache.
//
// Replaces the TPU kernel fluxdistributed_tpu/ops/pallas_decode.py:
// _decode_kernel (dense form, launched by _flash_decode_impl's
// pl.pallas_call).  It computes, for every slot b and query head h,
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
// Bound.  Decode is memory-bound: each step reads the live K/V rows (and
// their scales) once and does 4 * rows * H * D flops on them, far below
// the card's ~295 flops/byte balance point.  The least time is the live
// K/V bytes over the HBM rate.
//
// Design.  One CTA per (slot, KV head): a loop inside the CTA walks the
// row tiles, taking the place of the TPU's sequential KV grid axis
// (nothing carries between CTAs on Hopper).  The plain cache walks only
// up to the cursor's tile, and the ring skips every tile with no allowed
// row before touching its K/V bytes, so cost follows the live tokens.
// K/V tiles load 16 bytes per thread along D, dequantise to f32 in
// shared memory, and scores, probabilities and the accumulator stay in
// f32.  At lm_small with 8 slots that is B * Hkv = 96 CTAs, less than one
// wave on 132 SMs, with no overlap of loads and math inside a CTA.
// Split-KV, cp.async/TMA pipelining and tensor-core scores are left for
// a later change.
//
// The launcher runs on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

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

__host__ inline size_t smem_bytes(int g, int d) {
  const int t = tile_rows(d);
  const size_t floats = static_cast<size_t>(t) * (d + 1)  // K tile (padded)
                        + static_cast<size_t>(t) * d      // V tile
                        + 2 * static_cast<size_t>(g) * d  // q, acc
                        + static_cast<size_t>(g) * t      // scores / p
                        + 3 * static_cast<size_t>(g);     // m, l, corr
  return floats * sizeof(float) + static_cast<size_t>(t) * sizeof(int);
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

template <typename TQ, typename TKV, bool kWindowed, bool kQuant>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* idx, const int32_t* slot_pos,
                   const float* k_scale, const float* v_scale, void* out,
                   int B, int R, int H, int Hkv, int D, int window, int sinks,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<TQ, TKV, kWindowed, kQuant>;
  const size_t smem = smem_bytes(H / Hkv, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), idx, slot_pos, k_scale, v_scale,
      static_cast<TQ*>(out), R, H, Hkv, D, window, sinks, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_mode(int windowed, int quant, const void* q, const void* k,
                          const void* v, const int32_t* idx, const int32_t* sp,
                          const float* ks, const float* vs, void* out, int B,
                          int R, int H, int Hkv, int D, int window, int sinks,
                          float scale, cudaStream_t st) {
  if (windowed) {
    return quant ? launch<TQ, TKV, true, true>(q, k, v, idx, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st)
                 : launch<TQ, TKV, true, false>(q, k, v, idx, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st);
  }
  return quant ? launch<TQ, TKV, false, true>(q, k, v, idx, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st)
               : launch<TQ, TKV, false, false>(q, k, v, idx, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st);
}

}  // namespace

// C entry point, bound with ctypes by ops/flash_decode.py.  Every
// pointer is a device pointer (slot_pos, k_scale and v_scale may be
// null when unused); stream is a cudaStream_t.  Returns a cudaError_t.
extern "C" int flash_decode_launch(
    int q_dtype, int kv_dtype, int windowed, const void* q, const void* k,
    const void* v, const void* idx, const void* slot_pos, const void* k_scale,
    const void* v_scale, void* out, int B, int R, int H, int Hkv, int D,
    int window, int sinks, float scale, void* stream) {
  if (B == 0 || Hkv == 0) return cudaSuccess;
  if (H % Hkv != 0 || D % 16 != 0 || D > 256 || R < 1) return cudaErrorInvalidValue;
  const int quant = kv_dtype == kI8 || kv_dtype == kFP8;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) return cudaErrorInvalidValue;
  if (windowed && slot_pos == nullptr) return cudaErrorInvalidValue;
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* sp = static_cast<const int32_t*>(slot_pos);
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32) {
    switch (kv_dtype) {
      case kF32: return dispatch_mode<float, float>(windowed, 0, q, k, v, ix, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st);
      case kI8: return dispatch_mode<float, int8_t>(windowed, 1, q, k, v, ix, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st);
      case kFP8: return dispatch_mode<float, __nv_fp8_e4m3>(windowed, 1, q, k, v, ix, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (q_dtype == kBF16) {
    switch (kv_dtype) {
      case kBF16: return dispatch_mode<__nv_bfloat16, __nv_bfloat16>(windowed, 0, q, k, v, ix, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st);
      case kI8: return dispatch_mode<__nv_bfloat16, int8_t>(windowed, 1, q, k, v, ix, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st);
      case kFP8: return dispatch_mode<__nv_bfloat16, __nv_fp8_e4m3>(windowed, 1, q, k, v, ix, sp, ks, vs, out, B, R, H, Hkv, D, window, sinks, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

// cudaGetErrorString for the wrapper's error message.
extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
