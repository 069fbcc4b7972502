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
// Paged form (flash_decode_paged_kernel, then flash_decode_combine_kernel).
// K/V live in a shared pool [NB, bs, Hkv, D] (the scales in [NB, bs,
// Hkv]); logical row r of slot b lives at block page_table[b, r / bs],
// offset r % bs.  A row on an unbound page (-1, or an id outside the
// pool) is masked and never read.  Any block size bs >= 1 works.
//
// Bound.  Decode is memory-bound: each step reads the live K/V rows (and
// their scales) once and does 4 * rows * H * D flops on them, far below
// the card's ~295 flops/byte balance point.  The least time is the live
// K/V bytes over the HBM rate.
//
// Both forms are split-KV: a grid of (B * Hkv, S) CTAs, each taking one
// run of a (slot, KV head)'s rows and writing its f32 partial softmax
// state to a workspace, then flash_decode_combine_kernel merging the S
// partials in split order.  One CTA per (slot, KV head) was B * Hkv = 96
// CTAs at lm_small with 8 slots, less than one wave on 132 SMs; S is
// chosen on the host from the row (or page) count and the SM count so
// that about four CTAs run on each SM.  The dense form runs
// flash_decode_split_kernel, the paged form flash_decode_paged_kernel:
// one template for both changed the dense code's register allocation and
// slowed it by ~30 % in the decode step, so they share only the helpers
// and the combine.  Each CTA moves its K/V rows global -> shared by
// cp.async in their stored dtype through a two-stage ring, so the next
// tile's loads overlap this tile's math.
//
// The launchers run on the caller's stream, allocate nothing, and
// return a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 4;  // feature pairs a lane owns in P.V: D <= 256
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

// Rows per tile (ops/flash_decode.py:decode_tile_rows): a tile of K in
// f32 is about 16 KB whatever D is.
__host__ __device__ inline int tile_rows(int d) {
  return d <= 64 ? 64 : (d <= 128 ? 32 : 16);
}

// padded bytes of a K/V row in shared memory: 16 bytes of padding put the
// rows that a quarter-warp's 16-byte loads read in distinct banks
__host__ __device__ inline int kv_ld(int d, int esize) { return d * esize + 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 8 and 2 stored K/V values from shared memory, widened to f32
template <typename T>
struct Widen;

template <>
struct Widen<float> {
  __device__ static void load8(const unsigned char* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 16);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
  __device__ static float2 load2(const unsigned char* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <>
struct Widen<__nv_bfloat16> {
  __device__ static void load8(const unsigned char* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static float2 load2(const unsigned char* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

template <>
struct Widen<int8_t> {
  __device__ static void load8(const unsigned char* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
  }
  __device__ static float2 load2(const unsigned char* p) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
  }
};

template <>
struct Widen<__nv_fp8_e4m3> {
  __device__ static void load8(const unsigned char* p, float* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_fp8_e4m3* c = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
  }
  __device__ static float2 load2(const unsigned char* p) {
    const __nv_fp8_e4m3* c = reinterpret_cast<const __nv_fp8_e4m3*>(p);
    return make_float2(static_cast<float>(c[0]), static_cast<float>(c[1]));
  }
};

// ------------------------------------------------------- the dense form
//
// Split-KV over runs of whole tiles of T = tile_rows(D) rows.  The grid
// is (B * Hkv, S), S chosen on the host from R and the SM count, never
// from the cursors, so the grid is fixed on the host.  The cursor, read
// on the device, sets the runs: a plain cache cuts slot b's live rows
// [0, min(idx[b] + 1, R)) into nt_b = ceil(rows / T) tiles, and CTA
// (bhk, s) takes tiles [s * L_b, min((s + 1) * L_b, nt_b)) with
// L_b = ceil(nt_b / S), so every slot's live rows spread over its S CTAs
// whatever its cursor.  A CTA whose run is empty writes m = -inf, l = 0
// and stops.  A windowed ring keeps all R rows (ring slots do not follow
// the cursor), so its runs are cut from R alone, and a tile with no
// allowed row (out of band, unwritten) is skipped before any of its K/V
// bytes are read.  A (slot, head)'s rows lie Hkv * D values apart; they
// move global -> shared by 16-byte cp.async copies in their stored dtype
// into a two-stage ring (int8/fp8 scales by 4-byte copies), rows past
// the cursor are zero-filled and never read, and values are widened (and
// scaled) in registers.  Each warp owns a quarter of a tile's rows and
// keeps its own online softmax state, so a tile costs two barriers; the
// CTA merges its four warps' states in warp order into its partial.

__host__ inline size_t split_smem_bytes(int g, int d, int esize) {
  const size_t t = tile_rows(d);
  return 4 * t * kv_ld(d, esize)                          // K and V, two stages
         + (static_cast<size_t>(g) * d                    // q
            + static_cast<size_t>(kWarps) * g * d         // each warp's acc
            + 2 * static_cast<size_t>(kWarps) * g         // each warp's m, l
            + 4 * t) * sizeof(float)                      // K/V scales, two stages
         + 2 * t * sizeof(int);                           // ring row flags, two stages
}

template <typename TQ, typename TKV, bool kWindowed, bool kQuant>
__global__ void __launch_bounds__(kThreads) flash_decode_split_kernel(
    const TQ* __restrict__ q,              // [B, H, D]
    const TKV* __restrict__ k,             // [B, R, Hkv, D]
    const TKV* __restrict__ v,             // [B, R, Hkv, D]
    const int32_t* __restrict__ idx,       // [B]
    const int32_t* __restrict__ slot_pos,  // [B, R] (windowed only)
    const float* __restrict__ k_scale,     // [B, R, Hkv] (quantised only)
    const float* __restrict__ v_scale,     // [B, R, Hkv] (quantised only)
    float* __restrict__ part,              // [B * Hkv, S, G, D + 2]
    int R, int H, int Hkv, int D, int window, int sinks, float scale) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  constexpr int kEs = sizeof(TKV);
  const int G = H / Hkv;
  const int T = tile_rows(D);     // rows a tile
  const int RW = T / kWarps;      // rows a warp
  const int TPR = 32 / RW;        // lanes a row in the scores
  const int LDB = kv_ld(D, kEs);
  unsigned char* Kr = dsmem;              // [2][T][LDB]
  unsigned char* Vr = Kr + 2 * T * LDB;   // [2][T][LDB]
  float* Qs = reinterpret_cast<float*>(Vr + 2 * T * LDB);  // [G][D], scaled
  float* Acc = Qs + G * D;                // [kWarps][G][D]
  float* Mw = Acc + kWarps * G * D;       // [kWarps][G]
  float* Lw = Mw + kWarps * G;            // [kWarps][G]
  float* Ksc = Lw + kWarps * G;           // [2][T]
  float* Vsc = Ksc + 2 * T;               // [2][T]
  int* allow = reinterpret_cast<int*>(Vsc + 2 * T);  // [2][T] (ring only)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int cursor = idx[b];
  // this CTA's run of tiles, [t0, t1)
  const int rows = kWindowed ? R : min(max(cursor + 1, 0), R);
  const int nt = (rows + T - 1) / T;
  const int per = (nt + S - 1) / S;
  const int t0 = min(split * per, nt);
  const int t1 = min(t0 + per, nt);
  float* pb = part + (static_cast<size_t>(bhk) * S + split) * G * (D + 2);
  if (t0 == t1) {  // an empty run: m = -inf, l = 0, acc = 0
    for (int i = tid; i < G * (D + 2); i += kThreads) pb[i] = i % (D + 2) == 0 ? kNegInf : 0.f;
    return;
  }

  const size_t rstride = static_cast<size_t>(Hkv) * D * kEs;  // bytes a cache row
  const size_t head0 = (static_cast<size_t>(b) * R * Hkv + hk) * D * kEs;
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(k) + head0;
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(v) + head0;
  const int chunks = D * kEs / 16;  // 16-byte copies a row
  // Ring only: the row flags of tile t into stage st; does any row live?
  auto build = [&](int t, int st) {
    int any = 0;
    for (int r = tid; r < T; r += kThreads) {
      const int row = t * T + r;
      int ok = 0;
      if (row < R) {
        const int sp = slot_pos[static_cast<size_t>(b) * R + row];
        ok = sp >= 0 && sp <= cursor && (sp > cursor - window || sp < sinks);
      }
      allow[st * T + r] = ok;
      any |= ok;
    }
    return any;
  };
  // Is row r of tile t (in stage st) attended?
  auto live = [&](int t, int st, int r) -> int {
    if (kWindowed) return allow[st * T + r];
    return t * T + r < rows;
  };
  // The live rows of tile t, global -> stage st; dead rows are
  // zero-filled and never read.
  auto fetch = [&](int t, int st) {
    for (int i = tid; i < T * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 16;
      const int ok = live(t, st, r);
      const size_t off = static_cast<size_t>(t * T + r) * rstride + c;
      cp_async16(Kr + (st * T + r) * LDB + c, ok ? kg + off : kg, ok ? 16 : 0);
      cp_async16(Vr + (st * T + r) * LDB + c, ok ? vg + off : vg, ok ? 16 : 0);
    }
    if (kQuant) {
      for (int r = tid; r < T; r += kThreads) {
        if (live(t, st, r)) {
          const size_t so = (static_cast<size_t>(b) * R + t * T + r) * Hkv + hk;
          cp_async4(Ksc + st * T + r, k_scale + so);
          cp_async4(Vsc + st * T + r, v_scale + so);
        } else {
          Ksc[st * T + r] = 0.f;
          Vsc[st * T + r] = 0.f;
        }
      }
    }
  };

  int t = t0;
  if (kWindowed) {
    while (t < t1 && !__syncthreads_or(build(t, 0))) ++t;
  }
  if (t < t1) fetch(t, 0);
  cp_async_commit();
  // q and the warps' states while the first tile is in flight
  const size_t qo = (static_cast<size_t>(b) * H + static_cast<size_t>(hk) * G) * D;
  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_f32(q[qo + i]) * scale;
  for (int i = tid; i < kWarps * G * D; i += kThreads) Acc[i] = 0.f;
  for (int i = tid; i < kWarps * G; i += kThreads) {
    Mw[i] = kNegInf;
    Lw[i] = 0.f;
  }

  const int rl = lane / TPR;      // this lane's row in its warp's rows
  const int part_id = lane - rl * TPR;
  const int r = warp * RW + rl;   // this lane's tile row
  for (int st = 0; t < t1; st ^= 1) {
    int tn = t + 1;
    if (kWindowed) {
      while (tn < t1 && !__syncthreads_or(build(tn, st ^ 1))) ++tn;
    }
    if (tn < t1) fetch(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();

    const int ok = live(t, st, r);
    const unsigned char* krow = Kr + (st * T + r) * LDB;
    const float ks = kQuant ? Ksc[st * T + r] : 1.f;
    const float vs = kQuant ? Vsc[st * T + r] : 1.f;
    for (int g = 0; g < G; ++g) {
      // the score of this lane's row: TPR lanes take 8-feature chunks in turn
      float dot = 0.f;
      for (int c = part_id; c < D / 8; c += TPR) {
        float kf[8];
        Widen<TKV>::load8(krow + c * 8 * kEs, kf);
        const float* qg = Qs + g * D + c * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qg[i], kf[i], dot);
      }
      for (int o = 1; o < TPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float s = kQuant ? dot * ks : dot;

      // this warp's online softmax update over its RW rows
      float* mg = Mw + warp * G + g;
      float* lg = Lw + warp * G + g;
      const float m_old = *mg;
      const float m_new = fmaxf(m_old, warp_max(ok ? s : kNegInf));
      // masked rows are zeroed by the select: while nothing is allowed,
      // m_new is still kNegInf and exp(s - m_new) would be 1
      const float p = ok ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(part_id == 0 ? p : 0.f);
      const float corr = expf(m_old - m_new);
      __syncwarp();
      if (lane == 0) {
        *lg = *lg * corr + sum;
        *mg = m_new;
      }
      const float pv = kQuant ? p * vs : p;

      // acc = acc * corr + P . V; this lane owns features 2 lane + 64 c (+1)
      float* ag = Acc + (warp * G + g) * D;
      float a[kMaxPairs][2];
#pragma unroll
      for (int c = 0; c < kMaxPairs; ++c) {
        const int d = 2 * lane + 64 * c;
        if (d < D) {
          a[c][0] = ag[d] * corr;
          a[c][1] = ag[d + 1] * corr;
        }
      }
      for (int j = 0; j < RW; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j * TPR);
        const unsigned char* vrow = Vr + (st * T + warp * RW + j) * LDB;
#pragma unroll
        for (int c = 0; c < kMaxPairs; ++c) {
          const int d = 2 * lane + 64 * c;
          if (d < D) {
            const float2 vv = Widen<TKV>::load2(vrow + d * kEs);
            a[c][0] = fmaf(pj, vv.x, a[c][0]);
            a[c][1] = fmaf(pj, vv.y, a[c][1]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxPairs; ++c) {
        const int d = 2 * lane + 64 * c;
        if (d < D) {
          ag[d] = a[c][0];
          ag[d + 1] = a[c][1];
        }
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this stage
    t = tn;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the CTA's partial: its four warps' states merged in warp order
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, Mw[w * G + g]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(Mw[w * G + g] - m);
      acc = fmaf(Acc[(w * G + g) * D + d], c, acc);
      l = fmaf(Lw[w * G + g], c, l);
    }
    float* pg = pb + g * (D + 2);
    pg[2 + d] = acc;
    if (d == 0) {
      pg[0] = m;
      pg[1] = l;
    }
  }
}

// ------------------------------------------------------- the paged form
//
// Split-KV over whole pages.  The grid is (B * Hkv, splits): CTA (bhk, s)
// takes the contiguous run of pages [s * pps, (s + 1) * pps) of its slot
// (pps pages a split, chosen on the host from the page count and the SM
// count, never from the cursors) and writes the f32 partial (m, l,
// acc[G, D]) of its rows to a workspace; flash_decode_combine_kernel then
// merges each (slot, KV head)'s partials in split order, so the result is
// deterministic.  The CTA reads each of its page ids once, into shared
// memory, and walks its rows in tiles of tile_rows(D) rows that may span
// pages.  A tile whose rows are all dead (past the cursor, out of band,
// unwritten, or on unbound pages) is skipped before any of its K/V bytes
// are read; inside a live tile, only live rows are copied and the rest
// are zero-filled.  K/V rows move global -> shared by 16-byte cp.async
// copies in their stored dtype into a two-stage ring, so the next tile's
// loads overlap this tile's math, and are widened (and, int8/fp8, scaled)
// in registers.  Each warp owns a quarter of a tile's rows and keeps its
// own online softmax state, so a tile needs no block-wide reduction; the
// CTA merges its four warps' states at the end.

__host__ inline size_t paged_smem_bytes(int g, int d, int esize, int pps) {
  const size_t t = tile_rows(d);
  return 4 * t * kv_ld(d, esize)                          // K and V, two stages
         + (static_cast<size_t>(g) * d                    // q
            + static_cast<size_t>(kWarps) * g * d         // each warp's acc
            + 2 * static_cast<size_t>(kWarps) * g         // each warp's m, l
            + 4 * t) * sizeof(float)                      // K/V scales, two stages
         + (4 * t + static_cast<size_t>(pps)) * sizeof(int);  // row flags and
                                                              // pool rows; page ids
}

template <typename TQ, typename TKV, bool kWindowed, bool kQuant>
__global__ void __launch_bounds__(kThreads) flash_decode_paged_kernel(
    const TQ* __restrict__ q,                // [B, H, D]
    const TKV* __restrict__ k,               // [NB, bs, Hkv, D]
    const TKV* __restrict__ v,               // [NB, bs, Hkv, D]
    const int32_t* __restrict__ page_table,  // [B, P]
    const int32_t* __restrict__ idx,         // [B]
    const int32_t* __restrict__ slot_pos,    // [B, P * bs] (windowed only)
    const float* __restrict__ k_scale,       // [NB, bs, Hkv] (quantised only)
    const float* __restrict__ v_scale,       // [NB, bs, Hkv] (quantised only)
    float* __restrict__ part,                // [B * Hkv, splits, G, D + 2]
    int P, int bs, int NB, int H, int Hkv, int D, int window, int sinks,
    float scale, int pps) {
  extern __shared__ __align__(16) unsigned char dsmem[];
  constexpr int kEs = sizeof(TKV);
  const int G = H / Hkv;
  const int T = tile_rows(D);     // rows a tile
  const int RW = T / kWarps;      // rows a warp
  const int TPR = 32 / RW;        // lanes a row in the scores
  const int LDB = kv_ld(D, kEs);
  unsigned char* Kr = dsmem;              // [2][T][LDB]
  unsigned char* Vr = Kr + 2 * T * LDB;   // [2][T][LDB]
  float* Qs = reinterpret_cast<float*>(Vr + 2 * T * LDB);  // [G][D], scaled
  float* Acc = Qs + G * D;                // [kWarps][G][D]
  float* Mw = Acc + kWarps * G * D;       // [kWarps][G]
  float* Lw = Mw + kWarps * G;            // [kWarps][G]
  float* Ksc = Lw + kWarps * G;           // [2][T]
  float* Vsc = Ksc + 2 * T;               // [2][T]
  int* allow = reinterpret_cast<int*>(Vsc + 2 * T);  // [2][T]
  int* prow = allow + 2 * T;              // [2][T] each row's pool row
  int* pid = prow + 2 * T;                // [pps] the split's page ids

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const int split = blockIdx.y;
  const int cursor = idx[b];
  const int p0 = split * pps;
  int p1 = min(P, p0 + pps);
  // the plain cache walks only up to the cursor's page
  if (!kWindowed) p1 = min(p1, cursor < 0 ? p0 : cursor / bs + 1);
  const int np = max(p1 - p0, 0);
  const size_t qo = (static_cast<size_t>(b) * H + static_cast<size_t>(hk) * G) * D;

  for (int i = tid; i < np; i += kThreads) pid[i] = page_table[static_cast<size_t>(b) * P + p0 + i];
  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_f32(q[qo + i]) * scale;
  for (int i = tid; i < kWarps * G * D; i += kThreads) Acc[i] = 0.f;
  for (int i = tid; i < kWarps * G; i += kThreads) {
    Mw[i] = kNegInf;
    Lw[i] = 0.f;
  }
  __syncthreads();

  const int nrows = np * bs;  // the split's rows, from logical row p0 * bs
  const int ntiles = (nrows + T - 1) / T;
  const int chunks = D * kEs / 16;  // 16-byte copies a row
  const size_t row_bytes = static_cast<size_t>(D) * kEs;
  // Row flags and pool rows of tile t into stage st; does any row live?
  auto build = [&](int t, int st) {
    int any = 0;
    for (int r = tid; r < T; r += kThreads) {
      const int lr = t * T + r;
      int ok = 0, pr = 0;
      if (lr < nrows) {
        const int blk = pid[lr / bs];
        ok = blk >= 0 && blk < NB;
        pr = blk * bs + lr % bs;
        const int row = p0 * bs + lr;  // logical row
        if (kWindowed) {
          const int sp = slot_pos[static_cast<size_t>(b) * P * bs + row];
          ok = ok && sp >= 0 && sp <= cursor && (sp > cursor - window || sp < sinks);
        } else {
          ok = ok && row <= cursor;
        }
      }
      allow[st * T + r] = ok;
      prow[st * T + r] = pr;
      any |= ok;
    }
    return any;
  };
  // The live rows of a stage's tile, global -> shared; dead rows are
  // zero-filled and never read.
  auto fetch = [&](int st) {
    for (int i = tid; i < T * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = (i - r * chunks) * 16;
      const int ok = allow[st * T + r];
      const size_t off = (static_cast<size_t>(prow[st * T + r]) * Hkv + hk) * row_bytes + c;
      const unsigned char* kg = reinterpret_cast<const unsigned char*>(k);
      const unsigned char* vg = reinterpret_cast<const unsigned char*>(v);
      cp_async16(Kr + (st * T + r) * LDB + c, ok ? kg + off : kg, ok ? 16 : 0);
      cp_async16(Vr + (st * T + r) * LDB + c, ok ? vg + off : vg, ok ? 16 : 0);
    }
    if (kQuant) {
      for (int r = tid; r < T; r += kThreads) {
        if (allow[st * T + r]) {
          const size_t so = static_cast<size_t>(prow[st * T + r]) * Hkv + hk;
          cp_async4(Ksc + st * T + r, k_scale + so);
          cp_async4(Vsc + st * T + r, v_scale + so);
        } else {
          Ksc[st * T + r] = 0.f;
          Vsc[st * T + r] = 0.f;
        }
      }
    }
  };

  int t = 0;
  while (t < ntiles && !__syncthreads_or(build(t, 0))) ++t;
  if (t < ntiles) fetch(0);
  cp_async_commit();

  const int rl = lane / TPR;      // this lane's row in its warp's rows
  const int part_id = lane - rl * TPR;
  for (int st = 0; t < ntiles; st ^= 1) {
    int tn = t + 1;
    while (tn < ntiles && !__syncthreads_or(build(tn, st ^ 1))) ++tn;
    if (tn < ntiles) fetch(st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();

    const int r = warp * RW + rl;  // this lane's tile row
    const int ok = allow[st * T + r];
    const unsigned char* krow = Kr + (st * T + r) * LDB;
    const float ks = kQuant ? Ksc[st * T + r] : 1.f;
    const float vs = kQuant ? Vsc[st * T + r] : 1.f;
    for (int g = 0; g < G; ++g) {
      // the score of this lane's row: TPR lanes take 8-feature chunks in turn
      float dot = 0.f;
      for (int c = part_id; c < D / 8; c += TPR) {
        float kf[8];
        Widen<TKV>::load8(krow + c * 8 * kEs, kf);
        const float* qg = Qs + g * D + c * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(qg[i], kf[i], dot);
      }
      for (int o = 1; o < TPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const float s = kQuant ? dot * ks : dot;

      // this warp's online softmax update over its RW rows
      float* mg = Mw + warp * G + g;
      float* lg = Lw + warp * G + g;
      const float m_old = *mg;
      const float m_new = fmaxf(m_old, warp_max(ok ? s : kNegInf));
      // masked rows are zeroed by the select: while nothing is allowed,
      // m_new is still kNegInf and exp(s - m_new) would be 1
      const float p = ok ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(part_id == 0 ? p : 0.f);
      const float corr = expf(m_old - m_new);
      __syncwarp();
      if (lane == 0) {
        *lg = *lg * corr + sum;
        *mg = m_new;
      }
      const float pv = kQuant ? p * vs : p;

      // acc = acc * corr + P . V; this lane owns features 2 lane + 64 c (+1)
      float* ag = Acc + (warp * G + g) * D;
      float a[kMaxPairs][2];
#pragma unroll
      for (int c = 0; c < kMaxPairs; ++c) {
        const int d = 2 * lane + 64 * c;
        if (d < D) {
          a[c][0] = ag[d] * corr;
          a[c][1] = ag[d + 1] * corr;
        }
      }
      for (int j = 0; j < RW; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j * TPR);
        const unsigned char* vrow = Vr + (st * T + warp * RW + j) * LDB;
#pragma unroll
        for (int c = 0; c < kMaxPairs; ++c) {
          const int d = 2 * lane + 64 * c;
          if (d < D) {
            const float2 vv = Widen<TKV>::load2(vrow + d * kEs);
            a[c][0] = fmaf(pj, vv.x, a[c][0]);
            a[c][1] = fmaf(pj, vv.y, a[c][1]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxPairs; ++c) {
        const int d = 2 * lane + 64 * c;
        if (d < D) {
          ag[d] = a[c][0];
          ag[d + 1] = a[c][1];
        }
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this stage
    t = tn;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the CTA's partial: its four warps' states merged in warp order
  float* pb = part + (static_cast<size_t>(bhk) * gridDim.y + split) * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, Mw[w * G + g]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(Mw[w * G + g] - m);
      acc = fmaf(Acc[(w * G + g) * D + d], c, acc);
      l = fmaf(Lw[w * G + g], c, l);
    }
    float* pg = pb + g * (D + 2);
    pg[2 + d] = acc;
    if (d == 0) {
      pg[0] = m;
      pg[1] = l;
    }
  }
}

// The merge of each (slot, KV head)'s split partials, in split order:
// M = max m_s, w_s = exp(m_s - M), l = sum l_s w_s, acc = sum acc_s w_s,
// out = acc / max(l, 1e-30).  Each op is rounded once, as the plain
// split-and-merge version (ops/flash_decode.py) computes it.  A slot with
// nothing attendable has every m_s = kNegInf, l = 0 and gets exactly 0.
template <typename TQ>
__global__ void __launch_bounds__(kThreads) flash_decode_combine_kernel(
    const float* __restrict__ part, TQ* __restrict__ out, int S, int H, int Hkv, int D) {
  // launched as a programmatic dependent of the split kernel: wait until
  // it has completed and its partials are visible (a no-op otherwise)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int G = H / Hkv;
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const size_t stride = static_cast<size_t>(G) * (D + 2);  // one split's partial
  const float* base = part + static_cast<size_t>(bhk) * S * stride;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float m = kNegInf;
    for (int s = 0; s < S; ++s) m = fmaxf(m, base[s * stride + g * (D + 2)]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* ps = base + s * stride + g * (D + 2);
      const float w = expf(__fsub_rn(ps[0], m));
      l = __fadd_rn(l, __fmul_rn(ps[1], w));
      acc = __fadd_rn(acc, __fmul_rn(ps[2 + d], w));
    }
    out[(static_cast<size_t>(b) * H + static_cast<size_t>(hk) * G + g) * D + d] =
        from_f32<TQ>(__fdiv_rn(acc, fmaxf(l, 1e-30f)));
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
  float* part;  // the split partials' workspace
  int B, R, P, bs, NB, H, Hkv, D, window, sinks;
  float scale;
  int splits, pps;  // splits; paged: pages a split
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) cudaGetLastError();  // reported here, not by the next launch
  return e;
}

template <typename TQ, typename TKV, bool kWindowed, bool kQuant, bool kPaged>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.B * a.Hkv, a.splits);
  cudaError_t e;
  if constexpr (kPaged) {
    const size_t smem = paged_smem_bytes(a.H / a.Hkv, a.D, sizeof(TKV), a.pps);
    auto kernel = flash_decode_paged_kernel<TQ, TKV, kWindowed, kQuant>;
    e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
        static_cast<const TKV*>(a.v), a.page_table, a.idx, a.slot_pos,
        a.k_scale, a.v_scale, a.part, a.P, a.bs, a.NB, a.H, a.Hkv, a.D,
        a.window, a.sinks, a.scale, a.pps);
  } else {
    const size_t smem = split_smem_bytes(a.H / a.Hkv, a.D, sizeof(TKV));
    auto kernel = flash_decode_split_kernel<TQ, TKV, kWindowed, kQuant>;
    e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
        static_cast<const TKV*>(a.v), a.idx, a.slot_pos, a.k_scale,
        a.v_scale, a.part, a.R, a.H, a.Hkv, a.D, a.window, a.sinks, a.scale);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // The combine is a programmatic dependent launch: the card may start
  // it while the split kernel's last CTAs run, and its griddepcontrol.wait
  // holds it until the split kernel has finished and its partials are
  // visible (~1.8 us a call at lm_small's decode shape).
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.Hkv);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = a.stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_decode_combine_kernel<TQ>,
                         static_cast<const float*>(a.part), static_cast<TQ*>(a.out),
                         a.splits, a.H, a.Hkv, a.D);
  if (e != cudaSuccess) return e;
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
  if (a.part == nullptr || a.splits < 1 || a.splits > 65535) return cudaErrorInvalidValue;
  if (paged && (a.page_table == nullptr || a.bs < 1 || a.NB < 1 || a.pps < 1 ||
                static_cast<long long>(a.splits) * a.pps < a.P ||
                static_cast<long long>(a.splits - 1) * a.pps >= a.P))
    return cudaErrorInvalidValue;
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
// null when unused); stream is a cudaStream_t.  Each makes two launches,
// the split kernel and then the combine, and returns a cudaError_t.
// ``workspace`` holds B * H * splits * (D + 2) f32 on the stream.

// Dense slot cache: k/v [B, R, Hkv, D], scales [B, R, Hkv]; ``splits``
// runs of tiles, cut from each slot's cursor on the device.
extern "C" int flash_decode_launch(
    int q_dtype, int kv_dtype, int windowed, const void* q, const void* k,
    const void* v, const void* idx, const void* slot_pos, const void* k_scale,
    const void* v_scale, void* out, int B, int R, int H, int Hkv, int D,
    int window, int sinks, float scale, int splits, void* workspace,
    void* stream) {
  const Args a{q, k, v, nullptr, static_cast<const int32_t*>(idx),
               static_cast<const int32_t*>(slot_pos),
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), out,
               static_cast<float*>(workspace), B, R, 0, 0, 0, H, Hkv, D,
               window, sinks, scale, splits, 0, static_cast<cudaStream_t>(stream)};
  return dispatch(q_dtype, kv_dtype, windowed, 0, a);
}

// Paged block pool: k/v [NB, bs, Hkv, D], scales [NB, bs, Hkv], page
// table [B, P], slot_pos [B, P * bs].  ``splits`` runs of ``pps`` pages
// each (the last may be shorter, none empty).
extern "C" int flash_decode_paged_launch(
    int q_dtype, int kv_dtype, int windowed, const void* q, const void* k_pool,
    const void* v_pool, const void* page_table, const void* idx,
    const void* slot_pos, const void* k_scale, const void* v_scale, void* out,
    int B, int P, int bs, int NB, int H, int Hkv, int D, int window, int sinks,
    float scale, int splits, int pps, void* workspace, void* stream) {
  const Args a{q, k_pool, v_pool, static_cast<const int32_t*>(page_table),
               static_cast<const int32_t*>(idx),
               static_cast<const int32_t*>(slot_pos),
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), out,
               static_cast<float*>(workspace), B, P * bs, P, bs, NB, H, Hkv, D,
               window, sinks, scale, splits, pps, static_cast<cudaStream_t>(stream)};
  return dispatch(q_dtype, kv_dtype, windowed, 1, a);
}

// cudaGetErrorString for the wrapper's error message.
extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
