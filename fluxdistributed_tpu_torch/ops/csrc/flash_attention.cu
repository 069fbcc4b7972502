// Flash attention for Hopper (sm_90a): the training kernels, forward and
// backward, over q [B, Tq, H, D] and k/v [B, Tk, Hkv, D].
//
// Replaces the three TPU kernels of fluxdistributed_tpu/ops/
// pallas_attention.py:
//
//   B1 _flash_kernel     (pl.pallas_call in _flash_fwd_impl)
//        bf16: flash_fwd_tc_kernel        f32: flash_fwd_kernel
//   B2 _flash_dq_kernel  (first pl.pallas_call in _flash_bwd_impl)
//        bf16: flash_bwd_dq_tc_kernel     f32: flash_bwd_dq_kernel
//   B3 _flash_dkv_kernel (second pl.pallas_call in _flash_bwd_impl)
//        bf16: flash_bwd_dkv_tc_kernel    f32: flash_bwd_dkv_kernel
//
// What they compute, with s = scale * q . k^T in f32 (the scale multiplies
// the f32 scores, never the inputs) and the attend mask of _band_mask:
// key k < Tk, and, causal, k <= q + (Tk - Tq) (end-aligned), and, with a
// window, k >= q + (Tk - Tq) - (window - 1) unless k < sinks.
//
//   B1: the f32 online softmax over key tiles (online_softmax_update): p is
//       zeroed at masked keys by a select, the row sum l takes p in f32,
//       and P.V takes p rounded to v's dtype, as the Pallas body does.
//       O = acc / max(l, 1e-30) in q's dtype, LSE = m + log(max(l, 1e-30))
//       in f32 [B, H, Tq].  A row with nothing attendable gives O = 0 and
//       LSE ~ -1e30.
//   B2: per query row, p = exp(s - LSE) zeroed at masked keys (a select, not
//       NEG_INF before the exp: with LSE ~ -1e30 the exp overflows),
//       ds = p * (dO . V^T - delta), dQ = scale * (ds in k's dtype) . K,
//       scaled once at the end.  p and ds take the plain version's
//       roundings (p_of, ds_of); p stays f32 inside ds.
//   B3: per key row, summed over every query head of its KV group and every
//       query tile in the Pallas order t = member * nq + qi: dV = (p in
//       dO's dtype)^T . dO, dK = scale * (ds in q's dtype)^T . Q, scaled
//       once at the end.  Rows past Tq take LSE 1e30 and delta 0.
// delta = rowsum(dO * O) (minus the LSE cotangent, when there is one) is
// computed outside, in f32, as _flash_bwd_impl does.
//
// Bound on this card.  At the training shape (B = 8, T = 1024, H = 12,
// D = 64, causal) there are 50.4 M live (query, key) pairs and the work is
// 4 (B1), 6 (B2) and 8 (B3) flops per live pair and feature: 12.9, 19.4 and
// 25.8 GFLOP over ~50 MB of q/k/v/o/dO.  That is far past the H100's ~295
// bf16 flops per byte of HBM, so the kernels are bound by operations, and
// only the tensor cores (989 TFLOP/s bf16) reach the bound: even at the
// full 67 TFLOP/s of f32 SIMT, B1 could not go below 0.19 ms and B3 below
// 0.39 ms.  On the tensor cores the products are cheap, and what bounds
// the kernels below is the issue of their element-wise instructions (the
// softmax; B3's p, ds and rounding checks), so fully live tiles take a
// path without mask code.
//
// Design by dtype.
//
// bf16, the training path's type, runs B1 and B3 on the tensor cores, the
// FlashAttention-2 schedule on mma.sync (m16n8k16, bf16 x bf16 -> f32: the
// products are exact, as the MXU's are; only the f32 summation order
// differs from the plain versions).  One CTA of 4 warps owns a 64-row
// tile and each warp 16 of its rows.  Tiles move global -> shared by
// 16-byte cp.async copies into a two-stage ring, stored as bf16 with rows
// padded to D + 8 elements so that ldmatrix (.trans where an operand is
// needed k-major) reads them without bank conflicts.  Score tiles stay in
// registers: the m16n8 accumulator layout is the m16k16 A-operand layout,
// so p (and ds) become bf16 A fragments in place and never touch shared
// memory.
//   B1: a (b, h, query tile) per CTA; Q fragments are loaded once; K/V
//       tiles of 64 keys stream through the ring; S = Q.K^T (16 x 64 per
//       warp), scale, mask and the online softmax run on registers (row
//       max and sum by quad shuffles), then acc += P.V.  The grid is
//       (B*H, query tiles), walked last tile first, so the heaviest causal
//       tiles start first.
//   B2: a (b, h, query tile) per CTA, walked last tile first as B1; each
//       warp's 16 rows of Q and dO stay in registers as A fragments (D <=
//       64; at D = 80 and 128 they are re-read from shared memory, and the
//       keys of a tile taken 32 at a time); K/V tiles of 64 keys stream through
//       the ring; S = Q.K^T and dP = dO.V^T stay in registers, dS becomes
//       a bf16 A fragment in place, and dQ += dS.K reads K through
//       ldmatrix.trans.  dQ accumulates in registers and is written once.
//       ds rounds to bf16 exactly as the plain version's (see "B2 bf16").
//   B3: a (b, KV head, key tile) per CTA; each warp's 16 key rows of K and
//       V stay in registers (D <= 64; at D = 80 and 128 they are re-read
//       from shared memory, and the 64 queries of a tile are taken in two
//       halves of 32, so that the dK/dV accumulators fit the 255
//       registers, with a few bytes spilled at 128).
//
// Head dims: 32, 64, 80 (ViT-H/14) and 128.  Every loop over the features
// runs D / 16 k-steps or D / 8 n-tiles (5 and 10 at D = 80), and a row is
// D / 8 16-byte copies, so no count needs to be a power of two.
//       The CTA loops over (group member, query tile) with each Q/dO tile
//       and its LSE/delta rows in the ring; each warp forms S^T = K_w.Q^T
//       and dP^T = V_w.dO^T, then P^T and dS^T, and accumulates dV_w +=
//       P^T.dO and dK_w += dS^T.Q (dO and Q through ldmatrix.trans).  The
//       sums stay in registers, with no atomics, so they are deterministic.
//       p and ds round to bf16 exactly as the plain version's: the few
//       pairs whose rounding its f32 sums could decide otherwise are
//       summed again in its order (see "B3 bf16" below).
//
// f32 keeps simple SIMT kernels: every product an f32 FMA on the CUDA
// cores, 256 threads on a 16 x 16 grid over a 64 x 64 score tile, tiles
// staged in shared memory as f32 (rows padded to D + 1).  The f32 path
// holds the card to the CPU and to the JAX reference in full f32, and the
// tensor cores' only f32 input type, TF32, keeps 10 mantissa bits.
//
// Common to all: a loop inside the CTA takes the place of the TPU's
// sequential grid axis (nothing carries between CTAs here).  The GQA map
// is h / (H / Hkv), so grouped K/V are never repeated.  Tiles outside the
// causal / window band are skipped before any byte of them is read
// (_block_relevant at 64 x 64 tiles, Mask::tile_live); fully live tiles
// skip the per-element mask.  Ragged T needs no padding: rows past Tq or
// Tk load as zeros, are masked, and are never written.  Inputs are read
// through their strides (last dim contiguous, 16-byte aligned rows), so a
// [B, T, H, D] view of a fused QKV projection needs no copy.
//
// The launcher runs on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // SIMT: a 16 x 16 grid over a 64 x 64 tile
constexpr int kTcThreads = 128;  // tensor cores: 4 warps of 16 rows each
constexpr int kSLD = kTile + 1;  // padded row stride of a score tile
constexpr float kNegInf = -1e30f;
constexpr float kLsePad = 1e30f;  // LSE of rows past Tq: exp(s - 1e30) = 0

// dtype codes shared with ops/flash_attention.py
enum DType { kF32 = 0, kBF16 = 1 };
// which kernel a launch runs
enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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
struct Vec16<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float* out) {
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
  unsigned long long* audit;  // the bf16 B2/B3 rounding audit's counts, or null
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

  // is every (query, key) pair of the two tiles allowed?  (Then the
  // per-element mask can be skipped.)
  __device__ __forceinline__ bool tile_full(int q0, int k0) const {
    if (q0 + kTile > Tq || k0 + kTile > Tk) return false;
    if (!causal) return true;
    if (k0 + kTile - 1 > q0 + off) return false;  // past the diagonal
    // the last query's band must reach the first key, or all are sinks
    if (window > 0 && k0 < q0 + kTile - 1 + off - (window - 1) &&
        k0 + kTile > sinks)
      return false;
    return true;
  }
};

__device__ __forceinline__ Mask make_mask(const Params& p) {
  return Mask{p.Tq, p.Tk, p.Tk - p.Tq, p.causal, p.window, p.sinks};
}

// The backward's p = exp(scale s - lse) and ds = p (dp - delta), each op
// rounded once in the plain version's order.  nvcc would contract scale s
// - lse into one FMA, and where scale is not a power of two (D = 32, 128)
// that moves p by an ulp, enough to round ds to the other bf16 neighbour.
__device__ __forceinline__ float p_of(float s, float scale, float lse) {
  return expf(__fsub_rn(__fmul_rn(scale, s), lse));
}
__device__ __forceinline__ float ds_of(float pv, float dp, float delta) {
  return __fmul_rn(pv, __fsub_rn(dp, delta));
}

// =========================================================== SIMT kernels

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

// ---------------------------------------------------------------- B1 f32

template <int D>
__host__ __device__ constexpr size_t fwd_smem_floats() {
  // Q, K (padded), V, the score tile, and the m / l / corr rows
  return 2 * kTile * (D + 1) + kTile * D + kTile * kSLD + 3 * kTile;
}

template <int D>
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

  load_rows<float, D>(Qs, LD, p.q, b, h, q0, min(kTile, p.Tq - q0));
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
    load_rows<float, D>(Ks, LD, p.k, b, hk, k0, kv);
    load_rows<float, D>(Vs, D, p.v, b, hk, k0, kv);
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
        sr[c] = e;
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

  float* ob = static_cast<float*>(p.o.p) + static_cast<long long>(b) * p.o.sb +
              static_cast<long long>(h) * p.o.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= p.Tq) continue;
    const float l = fmaxf(Ls[r], 1e-30f);
    float* orow = ob + static_cast<long long>(q0 + r) * p.o.st;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = acc[i][j] / l;
  }
  if (tid < kTile && q0 + tid < p.Tq) {
    p.lse[static_cast<long long>(bh) * p.Tq + q0 + tid] =
        Ms[tid] + logf(fmaxf(Ls[tid], 1e-30f));
  }
}

// ---------------------------------------------------------------- B2 f32

template <int D>
__host__ __device__ constexpr size_t dq_smem_floats() {
  // Q, dO, K, V (all padded), the ds tile, and the LSE / delta rows
  return 4 * kTile * (D + 1) + kTile * kSLD + 2 * kTile;
}

template <int D>
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
  load_rows<float, D>(Qs, LD, p.q, b, h, q0, nq);
  load_rows<float, D>(Gs, LD, p.dout, b, h, q0, nq);
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
    load_rows<float, D>(Ks, LD, p.k, b, hk, k0, kv);
    load_rows<float, D>(Vs, LD, p.v, b, hk, k0, kv);
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
        if (mk.allowed(q0 + r, k0 + c))
          ds = ds_of(p_of(s[i][j], p.scale, LSEs[r]), dp[i][j], DELs[r]);
        DSs[r * kSLD + c] = ds;
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

  float* qb = static_cast<float*>(p.dq.p) + static_cast<long long>(b) * p.dq.sb +
              static_cast<long long>(h) * p.dq.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    float* row = qb + static_cast<long long>(q0 + r) * p.dq.st;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[tx + 16 * j] = p.scale * acc[i][j];
  }
}

// ---------------------------------------------------------------- B3 f32

template <int D>
__host__ __device__ constexpr size_t dkv_smem_floats() {
  // K, V, Q, dO (all padded), the p and ds tiles, and the LSE / delta rows
  return 4 * kTile * (D + 1) + 2 * kTile * kSLD + 2 * kTile;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // [64][LD]
  float* Vs = Ks + kTile * LD;    // [64][LD]
  float* Qs = Vs + kTile * LD;    // [64][LD]
  float* Gs = Qs + kTile * LD;    // dO [64][LD]
  float* Ps = Gs + kTile * LD;    // [64 q][kSLD] p
  float* DSs = Ps + kTile * kSLD;  // [64 q][kSLD] ds
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
  load_rows<float, D>(Ks, LD, p.k, b, hk, k0, nkv);
  load_rows<float, D>(Vs, LD, p.v, b, hk, k0, nkv);
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
      load_rows<float, D>(Qs, LD, p.q, b, h, q0, nq);
      load_rows<float, D>(Gs, LD, p.dout, b, h, q0, nq);
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
          Ps[r * kSLD + c] = pr;
          DSs[r * kSLD + c] = ds;
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

  float* kb = static_cast<float*>(p.dk.p) + static_cast<long long>(b) * p.dk.sb +
              static_cast<long long>(hk) * p.dk.sh;
  float* vb = static_cast<float*>(p.dv.p) + static_cast<long long>(b) * p.dv.sb +
              static_cast<long long>(hk) * p.dv.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nkv) continue;
    float* krow = kb + static_cast<long long>(k0 + r) * p.dk.st;
    float* vrow = vb + static_cast<long long>(k0 + r) * p.dv.st;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      krow[tx + 16 * j] = p.scale * dk[i][j];
      vrow[tx + 16 * j] = dv[i][j];
    }
  }
}

// ================================================== tensor-core kernels
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with r = lane / 4 and c = 2 * (lane % 4):
//   A (16 x 16, row-major) regs {0, 1, 2, 3} hold rows {r, r + 8, r, r + 8}
//     at columns {c, c, c + 8, c + 8} (+0, +1 in the two halves of a reg);
//   B (16 x 8, k x n) regs {0, 1} hold k = {c, c + 8} (+0, +1) at n = r;
//   C (16 x 8, f32) elements {0, 1, 2, 3} sit at rows {r, r, r + 8, r + 8},
//     columns {c, c + 1, c, c + 1}.
// So the C tiles of columns 16j .. 16j + 15 (n-tiles 2j, 2j + 1), packed
// to bf16 pairs, are the A fragment of k-step j.

// bf16 row stride of a shared-memory tile: 16 bytes of padding put the 8
// rows an ldmatrix phase reads in distinct banks.  At D = 80 a row is 176
// bytes (44 words), so the 8 rows start at words 0, 12, 24, 4, 16, 28, 8,
// 20 mod 32: distinct 4-word groups, no conflict (an XOR swizzle over 10
// chunks of 16 bytes would not be closed).
template <int D>
__host__ __device__ constexpr int tc_ld() { return D + 8; }

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

// four 8 x 8 bf16 matrices; lane i gives the shared address of row i % 8
// of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a . b: bf16 x bf16 -> f32 on the tensor cores
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of k-step j from the f32 C tiles of columns 16j .. 16j + 15.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Byte offset of element (row, col) of a [rows][LD] bf16 tile: constant
// at every call site, so it folds into the ldmatrix's immediate offset.
template <int LD>
__host__ __device__ constexpr uint32_t at(int row, int col) {
  return static_cast<uint32_t>((row * LD + col) * 2);
}

// This lane's part of an ldmatrix.x4 address (bytes), for the three ways a
// 16 x 16 block of a tile is read.  Add at(row0, col0) of the block.
template <int LD>
struct LdsmLane {
  // A operand, [m][k] rows: matrices (m 0-7, k 0-7), (8-15, 0-7), (0-7,
  // 8-15), (8-15, 8-15) -> regs 0-3 of the A fragment
  uint32_t a;
  // B operand stored [n][k] (K for Q.K^T): matrices (n 0-7, k 0-7), (0-7,
  // 8-15), (8-15, 0-7), (8-15, 8-15) -> {b0, b1} of n-tiles n0 and n0 + 8
  uint32_t bn;
  // B operand stored [k][n] (V for P.V), read .trans: matrices (k 0-7, n
  // 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15) -> the same
  uint32_t bk;
  __device__ explicit LdsmLane(int lane)
      : a(at<LD>(lane & 15, (lane >> 4) * 8)),
        bn(at<LD>((lane & 7) + (lane >> 4) * 8, ((lane >> 3) & 1) * 8)),
        bk(at<LD>((lane & 7) + ((lane >> 3) & 1) * 8, (lane >> 4) * 8)) {}
};

// Rows t0 .. t0 + 63 of head h of batch b into dst [64][D + 8] (bf16) by
// 16-byte cp.async copies; rows at or past nvalid are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const View& x, int b, int h,
                                                int t0, int nvalid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row: 4, 8, 10 or 16
  const bf16* base = static_cast<const bf16*>(x.p) + static_cast<long long>(b) * x.sb +
                     static_cast<long long>(h) * x.sh;
  static_assert(kTile * kChunks % kTcThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kTcThreads; ++it) {
    const int i = it * kTcThreads + threadIdx.x;
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const bool ok = r < nvalid;
    const bf16* src = ok ? base + static_cast<long long>(t0 + r) * x.st + c : base;
    cp_async16(dst + r * tc_ld<D>() + c, src, ok ? 16 : 0);
  }
}

// ---------------------------------------------------------------- B1 bf16

// The online softmax update of a warp's 16 x 64 score tile s (rows fr and
// fr + 8 of this thread, keys 8 j + fc (+1)): scale, mask (kFull: the tiles
// are fully live, no mask), the new row max m, the rescale of acc and l,
// and p = exp(s - m) in place of s.  A quad of lanes holds a row.  q and k
// are the positions of this thread's first row and key.
template <bool kFull, int ND>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&acc)[ND][4],
                                             float (&m_run)[2], float (&l_run)[2],
                                             const Mask& mk, int q, int k, float scale) {
  unsigned live = ~0u;  // one bit per element
  if (!kFull) {
    live = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        live |= mk.allowed(q + 8 * (e >> 1), k + 8 * j + (e & 1)) ? 1u << (4 * j + e) : 0u;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = kFull || (live >> (4 * j + e)) & 1u ? scale * s[j][e] : kNegInf;
        mx = fmaxf(mx, s[j][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        // masked keys are zeroed by the select: while nothing is allowed,
        // m_new is still kNegInf and exp(s - m_new) would be 1
        s[j][e] = kFull || (live >> (4 * j + e)) & 1u ? expf(s[j][e] - m_new) : 0.f;
        sum += s[j][e];  // l takes p unrounded
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float corr = expf(m_run[r] - m_new);
    l_run[r] = l_run[r] * corr + sum;
    m_run[r] = m_new;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][2 * r] *= corr;
      acc[n][2 * r + 1] *= corr;
    }
  }
}

template <int D>
__host__ __device__ constexpr size_t fwd_tc_smem_bytes() {
  // Q, then K and V in two stages, bf16
  return 5 * kTile * tc_ld<D>() * sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(Params p) {
  constexpr int LD = tc_ld<D>();
  constexpr int KD = D / 16;  // k-steps over the features
  constexpr int ND = D / 8;   // n-tiles over the features
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [64][LD]
  bf16* Ks = Qs + kTile * LD;                   // [2][64][LD]
  bf16* Vs = Ks + 2 * kTile * LD;               // [2][64][LD]

  const int lane = threadIdx.x & 31;
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's rows in the tile
  const int fr = lane >> 2, fc = 2 * (lane & 3);
  const LdsmLane<LD> ln(lane);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);  // the GQA map
  const Mask mk = make_mask(p);
  const int nk = (p.Tk + kTile - 1) / kTile;
  auto next_live = [&](int kt) {
    while (kt < nk && !mk.tile_live(q0, kt * kTile)) ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kTile, n = min(kTile, p.Tk - k0);
    load_tile_async<D>(Ks + stage * kTile * LD, p.k, b, hk, k0, n);
    load_tile_async<D>(Vs + stage * kTile * LD, p.v, b, hk, k0, n);
  };

  load_tile_async<D>(Qs, p.q, b, h, q0, min(kTile, p.Tq - q0));
  cp_async_commit();
  int kt = next_live(0);
  if (kt < nk) load_kv(kt, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) ldsm_x4(qa[kk], smem_addr(Qs) + ln.a + at<LD>(m0, 16 * kk));

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows m0 + fr (index 0) and m0 + fr + 8 (index 1) of the tile
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int stage = 0; kt < nk; stage ^= 1) {
    const int kn = next_live(kt + 1);
    if (kn < nk) load_kv(kn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const uint32_t kst = smem_addr(Ks) + stage * at<LD>(kTile, 0) + ln.bn;
    const uint32_t vst = smem_addr(Vs) + stage * at<LD>(kTile, 0) + ln.bk;
    const int k0 = kt * kTile;

    // S = Q . K^T: 16 x 64 per warp, n-tile j holds keys 8j .. 8j + 7
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kb[4];
        ldsm_x4(kb, kst + at<LD>(16 * j, 16 * kk));
        mma_bf16(s[2 * j], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * j + 1], qa[kk], kb[2], kb[3]);
      }

    // scale, mask and the online softmax; p replaces s
    const int qrow = q0 + m0 + fr, kcol = k0 + fc;
    if (mk.tile_full(q0, k0))
      softmax_tile<true>(s, acc, m_run, l_run, mk, qrow, kcol, p.scale);
    else
      softmax_tile<false>(s, acc, m_run, l_run, mk, qrow, kcol, p.scale);

    // acc += P . V, p rounded to bf16 in registers
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vst + at<LD>(16 * c, 16 * j));
        mma_bf16(acc[2 * j], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * j + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage
    kt = kn;
  }
  cp_async_wait<0>();

  bf16* ob = static_cast<bf16*>(p.o.p) + static_cast<long long>(b) * p.o.sb +
             static_cast<long long>(h) * p.o.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + m0 + fr + 8 * r;
    if (qp >= p.Tq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
    bf16* orow = ob + static_cast<long long>(qp) * p.o.st;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + fc) =
          __floats2bfloat162_rn(acc[n][2 * r] / l, acc[n][2 * r + 1] / l);
    if (fc == 0) p.lse[static_cast<long long>(bh) * p.Tq + qp] = m_run[r] + logf(l);
  }
}

// ---------------------------------------------------------------- B3 bf16
//
// B3 rounds p to bf16 before dV += P^T.dO and ds before dK += dS^T.Q, as
// the plain version does.  Its S^T and dP^T come from the tensor cores,
// which sum in another order than the plain version's f32 FMAs (first
// feature to last), so a p or ds next to a bf16 rounding midpoint can
// round to the other neighbour: one bf16 ulp of a large p moves a dV entry
// by ~2^-9 |dO|, far more than its own last bit.  Those pairs are
// summed again in the plain version's order before their products, so
// that the kernel rounds p and ds as the plain version does.  (The plain
// version's sums on the card are cuBLAS f32 products, whose order the
// plain f32 FMA chain reproduces, as the SIMT kernels' agreement shows.)
//
// The flag's slack (DotSlack) is ~7 standard deviations of a random-walk
// model of two summation orders, not their worst-case gap, so exactness
// is measured, not proven.  The audit instantiations (kAudit) sum every
// live pair in the plain order and count the flag's misses: on an H100,
// over 8 random seeds at the training shape (0.4-0.5 % of pairs flagged)
// and over every layer of an lm_small train step (3.5-3.6 % flagged,
// 6.4 % in the last layer), no unflagged pair rounded otherwise in B2 or
// B3 (PERF.md).

// How far two f32 sums of a D-term dot product a . b taken in different
// orders can lie apart, with margin: partial sums of magnitude up to |x| +
// |a| |b| / sqrt(D) (the sum x, and the random walk of the products), and
// D roundings of 2^-26 of them each, a quarter of an ulp or less.  The
// sums' own rounding errors are random walks of D half-ulp steps, ~sqrt(D
// / 12) ulps each: at D = 64 the slack is ~7 of those.  With the row norms
// |a|, |b| the slack follows the operands' scale (training's dO is ~1e-5).
// dot_slack = kSlope * (|x| + |a| |b| / sqrt(D)).
template <int D>
struct DotSlack {
  static constexpr float kSlope = D * 0x1p-26f;
};

// The 2-norm of a row of D bf16 values in shared memory.
template <int D>
__device__ __forceinline__ float row_norm(const bf16* row) {
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 8) {
    float f[8];
    Vec16<bf16>::load(row + d, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(f[i], f[i], ss);
  }
  return sqrtf(ss);
}

// Do x - slack and x + slack round to different bf16 values?  Then a value
// within slack of x, such as the plain version's, may round the other way.
__device__ __forceinline__ bool bf16_rounding_ambiguous(float x, float slack) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - slack, x + slack);
  return __bfloat16_as_ushort(r.x) != __bfloat16_as_ushort(r.y);
}

// The per-row values p_ds_tile needs, each pointing at this thread's first
// query column (LSE, delta, and the norms of its Q and dO rows), and the
// norms of its key rows fr and fr + 8 in K and V.
struct RowStats {
  const float *lse, *delta, *qn, *gn;
  float kn[2], vn[2];
};

// P^T and dS^T of a warp's 16 keys x 8J queries in place of S^T (s) and
// dP^T (dp): p = exp(scale s - LSE[q]) and ds = p (dp - delta[q]), zeroed
// by a select where masked (kFull: the tiles are fully live, no mask).
// q and k are the positions of this thread's first query column and key
// row.  Returns the bits 4 j + e of the pairs whose p or ds the plain
// version's sums might round to the other bf16 neighbour.
template <bool kFull, int D, int J>
__device__ __forceinline__ unsigned p_ds_tile(float (&s)[J][4], float (&dp)[J][4],
                                              const RowStats& st, const Mask& mk, int q,
                                              int k, float scale, unsigned& live) {
  // scale = 1 / sqrt(D): the norms' product over sqrt(D)
  const float c_s = DotSlack<D>::kSlope * scale;
  unsigned redo = 0u;
  live = kFull ? (J == 8 ? ~0u : (1u << (4 * J)) - 1u) : 0u;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(st.lse + 8 * j);
    const float2 d2 = *reinterpret_cast<const float2*>(st.delta + 8 * j);
    const float2 q2 = *reinterpret_cast<const float2*>(st.qn + 8 * j);
    const float2 g2 = *reinterpret_cast<const float2*>(st.gn + 8 * j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float t = __fsub_rn(__fmul_rn(scale, s[j][e]), e & 1 ? l2.y : l2.x);
      float pv = expf(t);
      float ds = ds_of(pv, dp[j][e], e & 1 ? d2.y : d2.x);
      // p's relative slack: the scores' sums apart by scale * dot_slack,
      // and t's own rounding; ds adds the dP sums' slack
      const float s_slack = fmaf(DotSlack<D>::kSlope, fabsf(s[j][e]),
                                 c_s * (e & 1 ? q2.y : q2.x) * st.kn[e >> 1]);
      const float rel = fmaf(scale, s_slack, 0x1p-23f * fabsf(t));
      const float dp_slack = fmaf(DotSlack<D>::kSlope, fabsf(dp[j][e]),
                                  c_s * (e & 1 ? g2.y : g2.x) * st.vn[e >> 1]);
      bool again = bf16_rounding_ambiguous(pv, pv * rel) |
                   bf16_rounding_ambiguous(ds, fmaf(fabsf(ds), rel, pv * dp_slack));
      if (!kFull) {
        const bool ok = mk.allowed(q + 8 * j + (e & 1), k + 8 * (e >> 1));
        pv = ok ? pv : 0.f;
        ds = ok ? ds : 0.f;
        again = again && ok;
        live |= ok ? 1u << (4 * j + e) : 0u;
      }
      s[j][e] = pv;
      dp[j][e] = ds;
      redo |= again ? 1u << (4 * j + e) : 0u;
    }
  }
  return redo;
}

// s = q . k and dp = dO . v of one (query, key) pair from the shared tiles,
// in the plain version's order: f32 FMAs from the first feature to the last.
template <int D>
__device__ __forceinline__ void plain_dots(const bf16* q, const bf16* k, const bf16* g,
                                           const bf16* v, float& s, float& dp) {
  s = 0.f;
  dp = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 8) {
    float qf[8], kf[8], gf[8], vf[8];
    Vec16<bf16>::load(q + d, qf);
    Vec16<bf16>::load(k + d, kf);
    Vec16<bf16>::load(g + d, gf);
    Vec16<bf16>::load(v + d, vf);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s = fmaf(qf[i], kf[i], s);
      dp = fmaf(gf[i], vf[i], dp);
    }
  }
}

// The rounding audit (kAudit instantiations, reached only when Params.audit
// is set): every live pair is summed again in the plain order, and four
// counts are kept: pairs flagged, flagged pairs whose bf16 rounding the
// re-sum changed, unflagged pairs whose bf16 rounding differs from the
// plain order's (the flag's misses), and live pairs.
enum AuditCount { kFlagged = 0, kFlaggedChanged = 1, kUnflaggedDiffer = 2, kLive = 3 };

struct Audit {
  unsigned long long n[4] = {0, 0, 0, 0};

  // one re-summed pair: was it flagged, and does the tensor cores' bf16
  // rounding differ from the plain order's?
  __device__ __forceinline__ void add(bool flagged, bool differs) {
    n[kFlagged] += flagged;
    n[kFlaggedChanged] += flagged && differs;
    n[kUnflaggedDiffer] += !flagged && differs;
    n[kLive] += 1;
  }

  __device__ __forceinline__ void flush(unsigned long long* out) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n[i]) atomicAdd(out + i, n[i]);
  }
};

// do a and b round to different bf16 values?
__device__ __forceinline__ bool bf16_differs(float a, float b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return __bfloat16_as_ushort(r.x) != __bfloat16_as_ushort(r.y);
}

template <int D>
__host__ __device__ constexpr size_t dkv_tc_smem_bytes() {
  // K, V, then Q and dO in two stages (bf16); the LSE, delta and Q and dO
  // row norms in two stages, and the K and V row norms (f32)
  return 6 * kTile * tc_ld<D>() * sizeof(bf16) + 10 * kTile * sizeof(float);
}

template <int D, bool kAudit>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkv_tc_kernel(Params p) {
  constexpr int LD = tc_ld<D>();
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  // D <= 64: each warp keeps its K and V rows as A fragments in registers
  // and takes a query tile's 64 columns at once.  D = 80 and 128: the
  // dK/dV accumulators alone take 80 or 128 registers, so K/V are re-read
  // from shared memory and the queries taken 32 at a time.
  constexpr bool kKeepKV = D <= 64;
  constexpr int QN = D <= 64 ? 64 : 32;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);  // [64][LD]
  bf16* Vs = Ks + kTile * LD;                   // [64][LD]
  bf16* Qs = Vs + kTile * LD;                   // [2][64][LD]
  bf16* Gs = Qs + 2 * kTile * LD;               // dO [2][64][LD]
  float* Lse = reinterpret_cast<float*>(Gs + 2 * kTile * LD);  // [2][64]
  float* Del = Lse + 2 * kTile;                                 // [2][64]
  float* Qn = Del + 2 * kTile;  // [2][64] row norms of Q
  float* Gn = Qn + 2 * kTile;   // [2][64] row norms of dO
  float* Kn = Gn + 2 * kTile;   // [64] row norms of K
  float* Vn = Kn + kTile;       // [64] row norms of V

  const int lane = threadIdx.x & 31;
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's key rows
  const int fr = lane >> 2, fc = 2 * (lane & 3);
  const LdsmLane<LD> ln(lane);
  const uint32_t ka_s = smem_addr(Ks) + ln.a + at<LD>(m0, 0);
  const uint32_t va_s = smem_addr(Vs) + ln.a + at<LD>(m0, 0);
  const int bhk = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int b = bhk / p.Hkv;
  const int hk = bhk - b * p.Hkv;
  const int G = p.H / p.Hkv;
  const Mask mk = make_mask(p);
  const int nkv = min(kTile, p.Tk - k0);
  const int nqt = (p.Tq + kTile - 1) / kTile;
  const int nt = G * nqt;  // steps t = member * nqt + qi, the Pallas order
  auto next_live = [&](int t) {
    while (t < nt && !mk.tile_live((t % nqt) * kTile, k0)) ++t;
    return t;
  };
  auto load_q = [&](int t, int stage) {
    const int member = t / nqt;
    const int q0 = (t - member * nqt) * kTile;
    const int h = hk * G + member;
    const int n = min(kTile, p.Tq - q0);
    load_tile_async<D>(Qs + stage * kTile * LD, p.q, b, h, q0, n);
    load_tile_async<D>(Gs + stage * kTile * LD, p.dout, b, h, q0, n);
    if (threadIdx.x < 2 * kTile) {  // one LSE or delta entry a thread
      const int r = threadIdx.x & (kTile - 1);
      const bool is_lse = threadIdx.x < kTile;
      float* dst = (is_lse ? Lse : Del) + stage * kTile + r;
      if (r < n) {
        const long long row = (static_cast<long long>(b) * p.H + h) * p.Tq + q0 + r;
        cp_async4(dst, is_lse ? p.lse + row : p.delta + row);
      } else {
        *dst = is_lse ? kLsePad : 0.f;
      }
    }
  };

  load_tile_async<D>(Ks, p.k, b, hk, k0, nkv);
  load_tile_async<D>(Vs, p.v, b, hk, k0, nkv);
  cp_async_commit();
  int t = next_live(0);
  if (t < nt) load_q(t, 0);
  cp_async_commit();
  cp_async_wait<1>();  // K and V have landed
  __syncthreads();
  {
    const int r = threadIdx.x & (kTile - 1);
    if (threadIdx.x < kTile)
      Kn[r] = row_norm<D>(Ks + r * LD);
    else
      Vn[r] = row_norm<D>(Vs + r * LD);
  }
  uint32_t ka[kKeepKV ? KD : 1][4], va[kKeepKV ? KD : 1][4];
  if constexpr (kKeepKV) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm_x4(ka[kk], ka_s + at<LD>(0, 16 * kk));
      ldsm_x4(va[kk], va_s + at<LD>(0, 16 * kk));
    }
  }

  // dK and dV of rows m0 + fr and m0 + fr + 8, features 8n + fc (+1)
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  Audit audit;

  for (int stage = 0; t < nt; stage ^= 1) {
    const int tn = next_live(t + 1);
    if (tn < nt) load_q(tn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const bf16* Qst = Qs + stage * kTile * LD;
    const bf16* Gst = Gs + stage * kTile * LD;
    const uint32_t qst = smem_addr(Qst), gst = smem_addr(Gst);
    {  // the row norms of this stage's Q and dO, for the slack
      const int r = threadIdx.x & (kTile - 1);
      if (threadIdx.x < kTile)
        Qn[stage * kTile + r] = row_norm<D>(Qst + r * LD);
      else
        Gn[stage * kTile + r] = row_norm<D>(Gst + r * LD);
    }
    __syncthreads();
    const float* Lst = Lse + stage * kTile;
    const float* Dst = Del + stage * kTile;
    const int q0 = (t % nqt) * kTile;
    const bool full = mk.tile_full(q0, k0);

#pragma unroll
    for (int qb = 0; qb < kTile; qb += QN) {
      // S^T = K_w . Q^T and dP^T = V_w . dO^T: 16 keys x QN queries,
      // n-tile j holds queries qb + 8j .. qb + 8j + 7
      float s[QN / 8][4], dp[QN / 8][4];
#pragma unroll
      for (int j = 0; j < QN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a_k[4], a_v[4];
        if constexpr (kKeepKV) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a_k[i] = ka[kk][i];
            a_v[i] = va[kk][i];
          }
        } else {
          ldsm_x4(a_k, ka_s + at<LD>(0, 16 * kk));
          ldsm_x4(a_v, va_s + at<LD>(0, 16 * kk));
        }
#pragma unroll
        for (int j = 0; j < QN / 16; ++j) {
          uint32_t qf[4], gf[4];
          ldsm_x4(qf, qst + ln.bn + at<LD>(qb + 16 * j, 16 * kk));
          ldsm_x4(gf, gst + ln.bn + at<LD>(qb + 16 * j, 16 * kk));
          mma_bf16(s[2 * j], a_k, qf[0], qf[1]);
          mma_bf16(s[2 * j + 1], a_k, qf[2], qf[3]);
          mma_bf16(dp[2 * j], a_v, gf[0], gf[1]);
          mma_bf16(dp[2 * j + 1], a_v, gf[2], gf[3]);
        }
      }

      // P^T and dS^T in place of S^T and dP^T; where the tensor cores'
      // sums might round p or ds to another bf16 neighbour than the plain
      // version's sums would, bit 4 j + e of redo is set
      const RowStats rs{Lst + qb + fc,
                        Dst + qb + fc,
                        Qn + stage * kTile + qb + fc,
                        Gn + stage * kTile + qb + fc,
                        {Kn[m0 + fr], Kn[m0 + fr + 8]},
                        {Vn[m0 + fr], Vn[m0 + fr + 8]}};
      const int qrow = q0 + qb + fc, krow = k0 + m0 + fr;
      unsigned live;
      const unsigned flag =
          full ? p_ds_tile<true, D>(s, dp, rs, mk, qrow, krow, p.scale, live)
               : p_ds_tile<false, D>(s, dp, rs, mk, qrow, krow, p.scale, live);
      // ... and those pairs (in the audit, every live pair) are summed
      // again in the plain version's order, one per lane per round, so
      // that the lanes' FMA chains run side by side
      unsigned redo = kAudit ? live : flag;
      while (__any_sync(0xffffffffu, redo != 0u)) {
        if (redo != 0u) {
          const int i = __ffs(redo) - 1;
          redo &= redo - 1u;
          const int qc = qb + 8 * (i >> 2) + fc + (i & 1);
          const int kr = m0 + fr + 8 * ((i >> 1) & 1);
          float ss, dd;
          plain_dots<D>(Qst + qc * LD, Ks + kr * LD, Gst + qc * LD, Vs + kr * LD, ss, dd);
          const float pv = p_of(ss, p.scale, Lst[qc]);
          const float ds = ds_of(pv, dd, Dst[qc]);
#pragma unroll
          for (int j = 0; j < QN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (i == 4 * j + e) {
                if constexpr (kAudit)
                  audit.add((flag >> i) & 1u,
                            bf16_differs(s[j][e], pv) || bf16_differs(dp[j][e], ds));
                s[j][e] = pv;
                dp[j][e] = ds;
              }
        }
      }

      // dV_w += P^T . dO (p in dO's dtype), dK_w += dS^T . Q (ds in q's
      // dtype), contracted over the queries through ldmatrix.trans
#pragma unroll
      for (int c = 0; c < QN / 16; ++c) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * c], s[2 * c + 1]);
        c_to_a(da, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          uint32_t gf[4], qf[4];
          ldsm_x4_t(gf, gst + ln.bk + at<LD>(qb + 16 * c, 16 * j));
          ldsm_x4_t(qf, qst + ln.bk + at<LD>(qb + 16 * c, 16 * j));
          mma_bf16(dv[2 * j], pa, gf[0], gf[1]);
          mma_bf16(dv[2 * j + 1], pa, gf[2], gf[3]);
          mma_bf16(dk[2 * j], da, qf[0], qf[1]);
          mma_bf16(dk[2 * j + 1], da, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    t = tn;
  }
  cp_async_wait<0>();

  bf16* kb = static_cast<bf16*>(p.dk.p) + static_cast<long long>(b) * p.dk.sb +
             static_cast<long long>(hk) * p.dk.sh;
  bf16* vb = static_cast<bf16*>(p.dv.p) + static_cast<long long>(b) * p.dv.sb +
             static_cast<long long>(hk) * p.dv.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kr = m0 + fr + 8 * r;
    if (kr >= nkv) continue;
    bf16* krow = kb + static_cast<long long>(k0 + kr) * p.dk.st;
    bf16* vrow = vb + static_cast<long long>(k0 + kr) * p.dv.st;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      // dK is scaled once, here
      *reinterpret_cast<__nv_bfloat162*>(krow + 8 * n + fc) = __floats2bfloat162_rn(
          p.scale * dk[n][2 * r], p.scale * dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * n + fc) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
  if constexpr (kAudit) audit.flush(p.audit);
}

// ---------------------------------------------------------------- B2 bf16
//
// B2 rounds only ds to bf16, before dQ += dS.K (p stays f32 inside ds), so
// only ds needs the ambiguity flag.  The roles are B3's transposed: a
// thread's two query rows are fixed for the whole CTA (their LSE, delta
// and Q and dO row norms are taken once), and the K and V row norms are
// per key tile.

// dS of a warp's 16 queries x 8J keys in place of dP (dp), from S (s):
// p = exp(scale s - LSE[q]) and ds = p (dp - delta[q]), zeroed by a select
// where masked (kFull: the tiles are fully live, no mask).  lse, del, qn
// and gn belong to this thread's rows fr and fr + 8; kn and vn point at
// the K and V row norms of its first key column.  q and k are the
// positions of its first query row and key column.  Returns the bits
// 4 j + e of the pairs whose ds the plain version's sums might round to
// the other bf16 neighbour, and sets live to the bits of the live pairs.
template <bool kFull, int D, int J>
__device__ __forceinline__ unsigned ds_tile(const float (&s)[J][4], float (&dp)[J][4],
                                            const float (&lse)[2], const float (&del)[2],
                                            const float (&qn)[2], const float (&gn)[2],
                                            const float* kn, const float* vn, const Mask& mk,
                                            int q, int k, float scale, unsigned& live) {
  const float c_s = DotSlack<D>::kSlope * scale;
  unsigned redo = 0u;
  live = kFull ? (J == 8 ? ~0u : (1u << (4 * J)) - 1u) : 0u;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float2 k2 = *reinterpret_cast<const float2*>(kn + 8 * j);
    const float2 v2 = *reinterpret_cast<const float2*>(vn + 8 * j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float t = __fsub_rn(__fmul_rn(scale, s[j][e]), lse[r]);
      const float pv = expf(t);
      float ds = ds_of(pv, dp[j][e], del[r]);
      const float s_slack = fmaf(DotSlack<D>::kSlope, fabsf(s[j][e]),
                                 c_s * qn[r] * (e & 1 ? k2.y : k2.x));
      const float rel = fmaf(scale, s_slack, 0x1p-23f * fabsf(t));
      const float dp_slack = fmaf(DotSlack<D>::kSlope, fabsf(dp[j][e]),
                                  c_s * gn[r] * (e & 1 ? v2.y : v2.x));
      bool again = bf16_rounding_ambiguous(ds, fmaf(fabsf(ds), rel, pv * dp_slack));
      if (!kFull) {
        const bool ok = mk.allowed(q + 8 * r, k + 8 * j + (e & 1));
        ds = ok ? ds : 0.f;
        again = again && ok;
        live |= ok ? 1u << (4 * j + e) : 0u;
      }
      dp[j][e] = ds;
      redo |= again ? 1u << (4 * j + e) : 0u;
    }
  }
  return redo;
}

template <int D>
__host__ __device__ constexpr size_t dq_tc_smem_bytes() {
  // Q and dO, then K and V in two stages (bf16); the K and V row norms in
  // two stages, and the Q and dO row norms (f32)
  return 6 * kTile * tc_ld<D>() * sizeof(bf16) + 6 * kTile * sizeof(float);
}

template <int D, bool kAudit>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_tc_kernel(Params p) {
  constexpr int LD = tc_ld<D>();
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  // D <= 64: each warp keeps its Q and dO rows as A fragments in
  // registers and takes a key tile's 64 columns at once.  D = 80 and 128:
  // the dQ accumulators take 40 or 64 registers, so Q and dO are re-read
  // from shared memory and the keys taken 32 at a time.
  constexpr bool kKeepQ = D <= 64;
  constexpr int KN = D <= 64 ? 64 : 32;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);  // [64][LD]
  bf16* Gs = Qs + kTile * LD;                   // dO [64][LD]
  bf16* Ks = Gs + kTile * LD;                   // [2][64][LD]
  bf16* Vs = Ks + 2 * kTile * LD;               // [2][64][LD]
  float* Kn = reinterpret_cast<float*>(Vs + 2 * kTile * LD);  // [2][64] K row norms
  float* Vn = Kn + 2 * kTile;                                  // [2][64] V row norms
  float* Qn = Vn + 2 * kTile;                                  // [64] Q row norms
  float* Gn = Qn + kTile;                                      // [64] dO row norms

  const int lane = threadIdx.x & 31;
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's query rows
  const int fr = lane >> 2, fc = 2 * (lane & 3);
  const LdsmLane<LD> ln(lane);
  const uint32_t qs_a = smem_addr(Qs) + ln.a + at<LD>(m0, 0);
  const uint32_t gs_a = smem_addr(Gs) + ln.a + at<LD>(m0, 0);
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const Mask mk = make_mask(p);
  const int nq = min(kTile, p.Tq - q0);
  const int nk = (p.Tk + kTile - 1) / kTile;
  auto next_live = [&](int kt) {
    while (kt < nk && !mk.tile_live(q0, kt * kTile)) ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kTile, n = min(kTile, p.Tk - k0);
    load_tile_async<D>(Ks + stage * kTile * LD, p.k, b, hk, k0, n);
    load_tile_async<D>(Vs + stage * kTile * LD, p.v, b, hk, k0, n);
  };

  load_tile_async<D>(Qs, p.q, b, h, q0, nq);
  load_tile_async<D>(Gs, p.dout, b, h, q0, nq);
  cp_async_commit();
  int kt = next_live(0);
  if (kt < nk) load_kv(kt, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();
  {
    const int r = threadIdx.x & (kTile - 1);
    if (threadIdx.x < kTile)
      Qn[r] = row_norm<D>(Qs + r * LD);
    else
      Gn[r] = row_norm<D>(Gs + r * LD);
  }
  // rows m0 + fr (index 0) and m0 + fr + 8 (index 1): LSE and delta (rows
  // past Tq take 1e30 and 0)
  float lse[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + fr + 8 * r;
    const long long i = static_cast<long long>(bh) * p.Tq + q0 + row;
    lse[r] = row < nq ? p.lse[i] : kLsePad;
    del[r] = row < nq ? p.delta[i] : 0.f;
  }
  uint32_t qa[kKeepQ ? KD : 1][4], ga[kKeepQ ? KD : 1][4];
  if constexpr (kKeepQ) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      ldsm_x4(qa[kk], qs_a + at<LD>(0, 16 * kk));
      ldsm_x4(ga[kk], gs_a + at<LD>(0, 16 * kk));
    }
  }
  __syncthreads();  // the Q and dO norms are visible
  const float qn[2] = {Qn[m0 + fr], Qn[m0 + fr + 8]};
  const float gn[2] = {Gn[m0 + fr], Gn[m0 + fr + 8]};

  // dQ of rows m0 + fr and m0 + fr + 8, features 8n + fc (+1)
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  Audit audit;

  for (int stage = 0; kt < nk; stage ^= 1) {
    const int kn = next_live(kt + 1);
    if (kn < nk) load_kv(kn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this stage has landed
    __syncthreads();
    const bf16* Kst = Ks + stage * kTile * LD;
    const bf16* Vst = Vs + stage * kTile * LD;
    {  // the row norms of this stage's K and V, for the slack
      const int r = threadIdx.x & (kTile - 1);
      if (threadIdx.x < kTile)
        Kn[stage * kTile + r] = row_norm<D>(Kst + r * LD);
      else
        Vn[stage * kTile + r] = row_norm<D>(Vst + r * LD);
    }
    __syncthreads();
    const uint32_t kst = smem_addr(Kst), vst = smem_addr(Vst);
    const int k0 = kt * kTile;
    const bool full = mk.tile_full(q0, k0);

#pragma unroll
    for (int kb = 0; kb < kTile; kb += KN) {
      // S = Q . K^T and dP = dO . V^T: 16 queries x KN keys, n-tile j
      // holds keys kb + 8j .. kb + 8j + 7
      float s[KN / 8][4], dp[KN / 8][4];
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a_q[4], a_g[4];
        if constexpr (kKeepQ) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a_q[i] = qa[kk][i];
            a_g[i] = ga[kk][i];
          }
        } else {
          ldsm_x4(a_q, qs_a + at<LD>(0, 16 * kk));
          ldsm_x4(a_g, gs_a + at<LD>(0, 16 * kk));
        }
#pragma unroll
        for (int j = 0; j < KN / 16; ++j) {
          uint32_t kf[4], vf[4];
          ldsm_x4(kf, kst + ln.bn + at<LD>(kb + 16 * j, 16 * kk));
          ldsm_x4(vf, vst + ln.bn + at<LD>(kb + 16 * j, 16 * kk));
          mma_bf16(s[2 * j], a_q, kf[0], kf[1]);
          mma_bf16(s[2 * j + 1], a_q, kf[2], kf[3]);
          mma_bf16(dp[2 * j], a_g, vf[0], vf[1]);
          mma_bf16(dp[2 * j + 1], a_g, vf[2], vf[3]);
        }
      }

      // dS in place of dP; where the tensor cores' sums might round ds to
      // another bf16 neighbour than the plain version's sums would, bit
      // 4 j + e of flag is set ...
      const float* knp = Kn + stage * kTile + kb + fc;
      const float* vnp = Vn + stage * kTile + kb + fc;
      const int qrow = q0 + m0 + fr, kcol = k0 + kb + fc;
      unsigned live;
      const unsigned flag =
          full ? ds_tile<true, D>(s, dp, lse, del, qn, gn, knp, vnp, mk, qrow, kcol, p.scale, live)
               : ds_tile<false, D>(s, dp, lse, del, qn, gn, knp, vnp, mk, qrow, kcol, p.scale,
                                   live);
      // ... and those pairs (in the audit, every live pair) are summed
      // again in the plain version's order, one per lane per round
      unsigned redo = kAudit ? live : flag;
      while (__any_sync(0xffffffffu, redo != 0u)) {
        if (redo != 0u) {
          const int i = __ffs(redo) - 1;
          redo &= redo - 1u;
          const int r = (i >> 1) & 1;
          const int qr = m0 + fr + 8 * r;
          const int kc = kb + 8 * (i >> 2) + fc + (i & 1);
          float ss, dd;
          plain_dots<D>(Qs + qr * LD, Kst + kc * LD, Gs + qr * LD, Vst + kc * LD, ss, dd);
          const float ds = ds_of(p_of(ss, p.scale, lse[r]), dd, del[r]);
#pragma unroll
          for (int j = 0; j < KN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (i == 4 * j + e) {
                if constexpr (kAudit) audit.add((flag >> i) & 1u, bf16_differs(dp[j][e], ds));
                dp[j][e] = ds;
              }
        }
      }

      // dQ += dS . K (ds in k's dtype), contracted over the keys through
      // ldmatrix.trans
#pragma unroll
      for (int c = 0; c < KN / 16; ++c) {
        uint32_t da[4];
        c_to_a(da, dp[2 * c], dp[2 * c + 1]);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          uint32_t kf[4];
          ldsm_x4_t(kf, kst + ln.bk + at<LD>(kb + 16 * c, 16 * j));
          mma_bf16(dq[2 * j], da, kf[0], kf[1]);
          mma_bf16(dq[2 * j + 1], da, kf[2], kf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    kt = kn;
  }
  cp_async_wait<0>();

  bf16* qb = static_cast<bf16*>(p.dq.p) + static_cast<long long>(b) * p.dq.sb +
             static_cast<long long>(h) * p.dq.sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + fr + 8 * r;
    if (row >= nq) continue;
    bf16* qrow = qb + static_cast<long long>(q0 + row) * p.dq.st;
#pragma unroll
    for (int n = 0; n < ND; ++n)  // dQ is scaled once, here
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * n + fc) =
          __floats2bfloat162_rn(p.scale * dq[n][2 * r], p.scale * dq[n][2 * r + 1]);
  }
  if constexpr (kAudit) audit.flush(p.audit);
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// B1-B3 take the tensor cores in bf16 and SIMT FMAs in f32.  The bf16
// backward kernels run their audit instantiation when p.audit is set.
template <typename T, int D>
cudaError_t run(int which, const Params& p, cudaStream_t stream) {
  const unsigned nq = (p.Tq + kTile - 1) / kTile;
  const unsigned nk = (p.Tk + kTile - 1) / kTile;
  const unsigned bh = p.B * p.H, bhk = p.B * p.Hkv;
  if constexpr (std::is_same<T, float>::value) {
    if (p.audit != nullptr) return cudaErrorInvalidValue;
    if (which == kFwd)
      return launch_kernel(flash_fwd_kernel<D>, dim3(nq, bh), kThreads,
                           fwd_smem_floats<D>() * sizeof(float), stream, p);
    if (which == kDq)
      return launch_kernel(flash_bwd_dq_kernel<D>, dim3(nq, bh), kThreads,
                           dq_smem_floats<D>() * sizeof(float), stream, p);
    if (which == kDkv)
      return launch_kernel(flash_bwd_dkv_kernel<D>, dim3(nk, bhk), kThreads,
                           dkv_smem_floats<D>() * sizeof(float), stream, p);
  } else {
    // the tile index is the grid's y axis here
    if (nq > 65535 || nk > 65535) return cudaErrorInvalidValue;
    const bool audit = p.audit != nullptr;
    if (which == kFwd)
      return audit ? cudaErrorInvalidValue
                   : launch_kernel(flash_fwd_tc_kernel<D>, dim3(bh, nq), kTcThreads,
                                   fwd_tc_smem_bytes<D>(), stream, p);
    if (which == kDq)
      return launch_kernel(audit ? flash_bwd_dq_tc_kernel<D, true>
                                 : flash_bwd_dq_tc_kernel<D, false>,
                           dim3(bh, nq), kTcThreads, dq_tc_smem_bytes<D>(), stream, p);
    if (which == kDkv)
      return launch_kernel(audit ? flash_bwd_dkv_tc_kernel<D, true>
                                 : flash_bwd_dkv_tc_kernel<D, false>,
                           dim3(bhk, nk), kTcThreads, dkv_tc_smem_bytes<D>(), stream, p);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dim(int which, int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 32: return run<T, 32>(which, p, stream);
    case 64: return run<T, 64>(which, p, stream);
    case 80: return run<T, 80>(which, p, stream);  // ViT-H/14: 1280 / 16
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
// [B, H, Tq] f32.  window <= 0 means no window.  ``audit`` is null on
// the training path; for the bf16 B2 or B3 it may point at four zeroed
// u64 counts (AuditCount), and the kernel then runs its rounding audit.
// Returns a cudaError_t.
extern "C" int flash_attention_launch(
    int which, int dtype, int D, const void* q, const void* k, const void* v,
    void* o, const void* dout, void* dq, void* dk, void* dv, void* lse,
    const void* delta, const long long* strides, int B, int Tq, int Tk, int H,
    int Hkv, int causal, int window, int sinks, float scale, void* audit,
    void* stream) {
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
  p.audit = static_cast<unsigned long long*>(audit);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_dim<float>(which, D, p, st);
  if (dtype == kBF16) return dispatch_dim<bf16>(which, D, p, st);
  return cudaErrorInvalidValue;
}

// cudaGetErrorString for the wrapper's error message.
extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
