// Flash attention for Hopper (sm_90a): the training kernels, forward and
// backward, over q [B, Tq, H, D] and k/v [B, Tk, Hkv, D].
//
// Replaces the three TPU kernels of fluxdistributed_tpu/ops/
// pallas_attention.py:
//
//   B1 _flash_kernel     (pl.pallas_call in _flash_fwd_impl)  -> flash_fwd_kernel
//   B2 _flash_dq_kernel  (first pl.pallas_call in _flash_bwd_impl) -> flash_bwd_dq_kernel
//   B3 _flash_dkv_kernel (second pl.pallas_call in _flash_bwd_impl) -> flash_bwd_dkv_kernel
//
// What they compute, with s = scale * q . k^T in f32 (the scale multiplies
// the f32 scores, never the inputs) and the attend mask of _band_mask:
// key k < Tk, and, causal, k <= q + (Tk - Tq) (end-aligned), and, with a
// window, k >= q + (Tk - Tq) - (window - 1) unless k < sinks.
//
//   B1: the f32 online softmax over key tiles (online_softmax_update): p is
//       zeroed at masked keys, the row sum l takes p in f32, and P.V takes p
//       rounded to v's dtype, as the Pallas body does.  O = acc / max(l,
//       1e-30) in q's dtype, LSE = m + log(max(l, 1e-30)) in f32 [B, H, Tq].
//       A row with nothing attendable gives O = 0 and LSE ~ -1e30.
//   B2: per query row, p = exp(s - LSE) zeroed at masked keys (a select, not
//       NEG_INF before the exp: with LSE ~ -1e30 the exp overflows),
//       ds = p * (dO . V^T - delta), dQ = scale * (ds in k's dtype) . K.
//   B3: per key row, summed over every query head of its KV group and every
//       query tile: dV = (p in dO's dtype)^T . dO, dK = scale * (ds in q's
//       dtype)^T . Q.
// delta = rowsum(dO * O) (minus the LSE cotangent, when there is one) is
// computed outside, in f32, as _flash_bwd_impl does.
//
// Bound.  At the training shapes (T = 1024, D = 64) the work is about
// 4 (B1), 6 (B2) and 8 (B3) flops per live (query, key, feature) triple
// over ~50 MB of q/k/v/o: far past the card's ~295 flops per byte, so the
// kernels are bound by operations, and the bound is the bf16 tensor-core
// rate.
//
// Design.  These first kernels are simple and SIMT: every product is an
// f32 FMA on the CUDA cores (bf16 inputs widen exactly to f32, so the
// products equal the MXU's bf16 x bf16 -> f32 ones).  Tensor cores (mma /
// wgmma), cp.async or TMA pipelining are left for a later change.  One CTA
// of 256 threads owns a 64-row tile: a (b, h, query tile) for B1 and B2, a
// (b, KV head, key tile) for B3.  A loop inside the CTA takes the place of
// the TPU's sequential grid axis (nothing carries between CTAs here): over
// key tiles for B1/B2, over (group member, query tile) for B3, in the
// Pallas order t = member * nq + qi.  Each output is accumulated in
// registers and written once: no atomics, so the gradients are
// deterministic.  Tiles are staged in shared memory as f32, rows padded to
// D + 1 floats so that the 16 x 16 thread grid's column reads fall in
// distinct banks; each thread keeps a 4 x 4 block of the score tile and a
// 4 x D/16 block of its output in registers.  The GQA map is h / (H /
// Hkv), so grouped K/V are never repeated.  Tiles outside the causal /
// window band are skipped before any byte of them is read
// (_block_relevant at this kernel's 64 x 64 tiles).  Ragged T needs no
// padding: rows past Tq or Tk load as zeros, are masked, and are never
// written.  Inputs are read through their strides (last dim contiguous,
// 16-byte aligned rows), so a [B, T, H, D] view of a fused QKV projection
// needs no copy.
//
// The launcher runs on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // a 16 x 16 grid over a 64 x 64 score tile
constexpr int kSLD = kTile + 1;  // padded row stride of a score tile
constexpr float kNegInf = -1e30f;
constexpr float kLsePad = 1e30f;  // LSE of rows past Tq: exp(s - 1e30) = 0

// dtype codes shared with ops/flash_attention.py
enum DType { kF32 = 0, kBF16 = 1 };
// which kernel a launch runs
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

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

// x rounded to T and widened back (the Pallas .astype before a product)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// One 16-byte load of a row segment, widened to f32.
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

// A [B, T, H, D] tensor read through its strides (elements); D is
// contiguous.
struct View {
  void* p;
  long long sb, st, sh;
};

struct Params {
  View q, k, v, o, dout, dq, dk, dv;
  float* lse;          // [B, H, Tq]: written by B1, read by B2/B3
  const float* delta;  // [B, H, Tq]
  int B, Tq, Tk, H, Hkv, causal, window, sinks;  // window <= 0: none
  float scale;
};

// The attend mask (_band_mask) and the live-tile test (_block_relevant).
struct Mask {
  int Tq, Tk, off, causal, window, sinks;

  __device__ __forceinline__ bool allowed(int qp, int kp) const {
    if (qp >= Tq || kp >= Tk) return false;
    if (!causal) return true;
    const int lim = qp + off;
    if (kp > lim) return false;
    // out of the band, and not a sink
    if (window > 0 && kp < lim - (window - 1) && kp >= sinks) return false;
    return true;
  }

  // does the key tile at k0 meet the query tile at q0's band at all?
  __device__ __forceinline__ bool tile_live(int q0, int k0) const {
    if (!causal) return true;
    bool live = k0 <= q0 + kTile - 1 + off;
    if (window > 0) {
      bool band = k0 + kTile - 1 >= q0 + off - (window - 1);
      if (sinks > 0) band = band || k0 < sinks;
      live = live && band;
    }
    return live;
  }
};

__device__ __forceinline__ Mask make_mask(const Params& p) {
  return Mask{p.Tq, p.Tk, p.Tk - p.Tq, p.causal, p.window, p.sinks};
}

// Rows t0 .. t0 + 63 of head h of batch b into dst [64][ld] as f32; rows
// at or past nvalid are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const View& x,
                                          int b, int h, int t0, int nvalid) {
  constexpr int kVec = Vec16<T>::N;
  constexpr int kPerRow = D / kVec;
  const T* base = static_cast<const T*>(x.p) + static_cast<long long>(b) * x.sb +
                  static_cast<long long>(h) * x.sh;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i - r * kPerRow) * kVec;
    float f[kVec];
    if (r < nvalid) {
      Vec16<T>::load(base + static_cast<long long>(t0 + r) * x.st + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * ld + c + e] = f[e];
  }
}

// s[i][j] = sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d] over two [64][D + 1]
// tiles: this thread's 4 x 4 block of a 64 x 64 product.
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int ty, int tx, float (&s)[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
  }
}

// ---------------------------------------------------------------- B1

template <int D>
__host__ __device__ constexpr size_t fwd_smem_floats() {
  // Q, K (padded), V, the score tile, and the m / l / corr rows
  return 2 * kTile * (D + 1) + kTile * D + kTile * kSLD + 3 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [64][LD]
  float* Ks = Qs + kTile * LD;   // [64][LD]
  float* Vs = Ks + kTile * LD;   // [64][D]
  float* Ss = Vs + kTile * D;    // [64][kSLD] scores, then p
  float* Ms = Ss + kTile * kSLD;  // running row max
  float* Ls = Ms + kTile;         // running row sum
  float* Cs = Ls + kTile;         // this tile's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);  // the GQA map
  const Mask mk = make_mask(p);

  load_rows<T, D>(Qs, LD, p.q, b, h, q0, min(kTile, p.Tq - q0));
  if (tid < kTile) {
    Ms[tid] = kNegInf;
    Ls[tid] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (p.Tk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!mk.tile_live(q0, k0)) continue;  // uniform over the CTA
    __syncthreads();  // the last tile's reads are done
    const int kv = min(kTile, p.Tk - k0);
    load_rows<T, D>(Ks, LD, p.k, b, hk, k0, kv);
    load_rows<T, D>(Vs, D, p.v, b, hk, k0, kv);
    __syncthreads();

    float s[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        Ss[r * kSLD + c] = mk.allowed(q0 + r, k0 + c) ? p.scale * s[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax update: four threads per row, 16 keys each
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* sr = Ss + r * kSLD + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, sr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        // masked keys are zeroed explicitly: while nothing is allowed,
        // m_new is still kNegInf and exp(s - m_new) would be 1
        const float e = mk.allowed(q0 + r, k0 + part * 16 + c) ? expf(sr[c] - m_new) : 0.f;
        sum += e;
        sr[c] = round_to<T>(e);  // P.V takes p in v's dtype
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {  // the other lanes read Ms[r] before the shuffles
        const float corr = expf(m_old - m_new);
        Cs[r] = corr;
        Ls[r] = Ls[r] * corr + sum;
        Ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = Cs[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pr[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ss[(ty + 16 * i) * kSLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = static_cast<T*>(p.o.p) + static_cast<long long>(b) * p.o.sb +
          static_cast<long long>(h) * p.o.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= p.Tq) continue;
    const float l = fmaxf(Ls[r], 1e-30f);
    T* orow = ob + static_cast<long long>(q0 + r) * p.o.st;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
  if (tid < kTile && q0 + tid < p.Tq) {
    p.lse[static_cast<long long>(bh) * p.Tq + q0 + tid] =
        Ms[tid] + logf(fmaxf(Ls[tid], 1e-30f));
  }
}

// ---------------------------------------------------------------- B2

template <int D>
__host__ __device__ constexpr size_t dq_smem_floats() {
  // Q, dO, K, V (all padded), the ds tile, and the LSE / delta rows
  return 4 * kTile * (D + 1) + kTile * kSLD + 2 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // [64][LD]
  float* Gs = Qs + kTile * LD;    // dO [64][LD]
  float* Ks = Gs + kTile * LD;    // [64][LD]
  float* Vs = Ks + kTile * LD;    // [64][LD]
  float* DSs = Vs + kTile * LD;   // [64][kSLD] ds in k's dtype
  float* LSEs = DSs + kTile * kSLD;
  float* DELs = LSEs + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const Mask mk = make_mask(p);

  const int nq = min(kTile, p.Tq - q0);
  load_rows<T, D>(Qs, LD, p.q, b, h, q0, nq);
  load_rows<T, D>(Gs, LD, p.dout, b, h, q0, nq);
  if (tid < kTile) {
    const bool ok = tid < nq;
    const long long row = static_cast<long long>(bh) * p.Tq + q0 + tid;
    LSEs[tid] = ok ? p.lse[row] : kLsePad;
    DELs[tid] = ok ? p.delta[row] : 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (p.Tk + kTile - 1) / kTile;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (!mk.tile_live(q0, k0)) continue;
    __syncthreads();
    const int kv = min(kTile, p.Tk - k0);
    load_rows<T, D>(Ks, LD, p.k, b, hk, k0, kv);
    load_rows<T, D>(Vs, LD, p.v, b, hk, k0, kv);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(Gs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float ds = 0.f;
        if (mk.allowed(q0 + r, k0 + c)) {
          const float pr = expf(p.scale * s[i][j] - LSEs[r]);
          ds = pr * (dp[i][j] - DELs[r]);
        }
        DSs[r * kSLD + c] = round_to<T>(ds);
      }
    }
    __syncthreads();

    // dQ += ds . K
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dv[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[i] = DSs[(ty + 16 * i) * kSLD + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(dv[i], kk[j], acc[i][j]);
    }
  }

  T* qb = static_cast<T*>(p.dq.p) + static_cast<long long>(b) * p.dq.sb +
          static_cast<long long>(h) * p.dq.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    T* row = qb + static_cast<long long>(q0 + r) * p.dq.st;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = from_f32<T>(p.scale * acc[i][j]);
  }
}

// ---------------------------------------------------------------- B3

template <int D>
__host__ __device__ constexpr size_t dkv_smem_floats() {
  // K, V, Q, dO (all padded), the p and ds tiles, and the LSE / delta rows
  return 4 * kTile * (D + 1) + 2 * kTile * kSLD + 2 * kTile;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // [64][LD]
  float* Vs = Ks + kTile * LD;    // [64][LD]
  float* Qs = Vs + kTile * LD;    // [64][LD]
  float* Gs = Qs + kTile * LD;    // dO [64][LD]
  float* Ps = Gs + kTile * LD;    // [64 q][kSLD] p in dO's dtype
  float* DSs = Ps + kTile * kSLD;  // [64 q][kSLD] ds in q's dtype
  float* LSEs = DSs + kTile * kSLD;
  float* DELs = LSEs + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kTile;
  const int bhk = blockIdx.y;
  const int b = bhk / p.Hkv;
  const int hk = bhk - b * p.Hkv;
  const int G = p.H / p.Hkv;
  const Mask mk = make_mask(p);

  const int nkv = min(kTile, p.Tk - k0);
  load_rows<T, D>(Ks, LD, p.k, b, hk, k0, nkv);
  load_rows<T, D>(Vs, LD, p.v, b, hk, k0, nkv);
  // rows: this thread's keys ty + 16 i; columns: features tx + 16 j
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int nqt = (p.Tq + kTile - 1) / kTile;
  // t = member * nq + qi: every query tile of every head of the group
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const long long lrow = (static_cast<long long>(b) * p.H + h) * p.Tq;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * kTile;
      if (!mk.tile_live(q0, k0)) continue;
      __syncthreads();  // the last tile's reads are done (and K/V visible)
      const int nq = min(kTile, p.Tq - q0);
      load_rows<T, D>(Qs, LD, p.q, b, h, q0, nq);
      load_rows<T, D>(Gs, LD, p.dout, b, h, q0, nq);
      if (tid < kTile) {
        const bool ok = tid < nq;
        LSEs[tid] = ok ? p.lse[lrow + q0 + tid] : kLsePad;
        DELs[tid] = ok ? p.delta[lrow + q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<D>(Qs, Ks, ty, tx, s);   // rows: queries, columns: keys
      tile_dot<D>(Gs, Vs, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          float pr = 0.f, ds = 0.f;
          if (mk.allowed(q0 + r, k0 + c)) {
            pr = expf(p.scale * s[i][j] - LSEs[r]);
            ds = pr * (dp[i][j] - DELs[r]);
          }
          Ps[r * kSLD + c] = round_to<T>(pr);
          DSs[r * kSLD + c] = round_to<T>(ds);
        }
      }
      __syncthreads();

      // dV += p^T . dO, dK += ds^T . Q, contracted over the tile's queries
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float pc[4], dc[4], gv[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pc[i] = Ps[r * kSLD + ty + 16 * i];
          dc[i] = DSs[r * kSLD + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          gv[j] = Gs[r * LD + tx + 16 * j];
          qv[j] = Qs[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] = fmaf(pc[i], gv[j], dv[i][j]);
            dk[i][j] = fmaf(dc[i], qv[j], dk[i][j]);
          }
      }
    }
  }

  T* kb = static_cast<T*>(p.dk.p) + static_cast<long long>(b) * p.dk.sb +
          static_cast<long long>(hk) * p.dk.sh;
  T* vb = static_cast<T*>(p.dv.p) + static_cast<long long>(b) * p.dv.sb +
          static_cast<long long>(hk) * p.dv.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nkv) continue;
    T* krow = kb + static_cast<long long>(k0 + r) * p.dk.st;
    T* vrow = vb + static_cast<long long>(k0 + r) * p.dv.st;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      krow[tx + 16 * j] = from_f32<T>(p.scale * dk[i][j]);
      vrow[tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, size_t floats,
                          cudaStream_t stream, const Params& p) {
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run(int which, const Params& p, cudaStream_t stream) {
  const unsigned nq = (p.Tq + kTile - 1) / kTile;
  const unsigned nk = (p.Tk + kTile - 1) / kTile;
  switch (which) {
    case kFwd:
      return launch_kernel(flash_fwd_kernel<T, D>, dim3(nq, p.B * p.H),
                           fwd_smem_floats<D>(), stream, p);
    case kDq:
      return launch_kernel(flash_bwd_dq_kernel<T, D>, dim3(nq, p.B * p.H),
                           dq_smem_floats<D>(), stream, p);
    case kDkv:
      return launch_kernel(flash_bwd_dkv_kernel<T, D>, dim3(nk, p.B * p.Hkv),
                           dkv_smem_floats<D>(), stream, p);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int which, int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 32: return run<T, 32>(which, p, stream);
    case 64: return run<T, 64>(which, p, stream);
    case 128: return run<T, 128>(which, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

View view(const void* ptr, const long long* strides, int i) {
  return View{const_cast<void*>(ptr), strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace

// C entry point, bound with ctypes by ops/flash_attention.py.  ``which``
// picks the kernel: 0 = B1 (writes o and lse), 1 = B2 (writes dq), 2 = B3
// (writes dk and dv).  Pointers are device pointers; the ones a kernel
// does not use may be null.  ``strides`` is a host array of 24 element
// strides, (batch, seq, head) for q, k, v, o, dout, dq, dk, dv in that
// order (the feature dim is contiguous).  lse and delta are contiguous
// [B, H, Tq] f32.  window <= 0 means no window.  Returns a cudaError_t.
extern "C" int flash_attention_launch(
    int which, int dtype, int D, const void* q, const void* k, const void* v,
    void* o, const void* dout, void* dq, void* dk, void* dv, void* lse,
    const void* delta, const long long* strides, int B, int Tq, int Tk, int H,
    int Hkv, int causal, int window, int sinks, float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || H % Hkv != 0) return cudaErrorInvalidValue;
  if (static_cast<long long>(B) * H > 65535) return cudaErrorInvalidValue;
  if (q == nullptr || k == nullptr || v == nullptr || lse == nullptr) return cudaErrorInvalidValue;
  if (which == kFwd && o == nullptr) return cudaErrorInvalidValue;
  if (which != kFwd && (dout == nullptr || delta == nullptr)) return cudaErrorInvalidValue;
  if (which == kDq && dq == nullptr) return cudaErrorInvalidValue;
  if (which == kDkv && (dk == nullptr || dv == nullptr)) return cudaErrorInvalidValue;
  Params p;
  p.q = view(q, strides, 0);
  p.k = view(k, strides, 1);
  p.v = view(v, strides, 2);
  p.o = view(o, strides, 3);
  p.dout = view(dout, strides, 4);
  p.dq = view(dq, strides, 5);
  p.dk = view(dk, strides, 6);
  p.dv = view(dv, strides, 7);
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.B = B; p.Tq = Tq; p.Tk = Tk; p.H = H; p.Hkv = Hkv;
  p.causal = causal; p.window = window; p.sinks = sinks;
  p.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_dim<float>(which, D, p, st);
  if (dtype == kBF16) return dispatch_dim<__nv_bfloat16>(which, D, p, st);
  return cudaErrorInvalidValue;
}

// cudaGetErrorString for the wrapper's error message.
extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
