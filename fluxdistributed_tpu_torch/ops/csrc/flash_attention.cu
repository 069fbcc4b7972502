// Flash attention for Hopper (sm_90a): the training kernels, forward and
// backward, over q [B, Tq, H, D] and k/v [B, Tk, Hkv, D].
//
// Replaces the three TPU kernels of fluxdistributed_tpu/ops/
// pallas_attention.py:
//
//   B1 _flash_kernel     (pl.pallas_call in _flash_fwd_impl)
//        bf16: flash_fwd_wg_kernel (D = 64, 80, 128), flash_fwd_tc_kernel
//        (D = 32)                          f32: flash_fwd_kernel
//   B2 _flash_dq_kernel  (first pl.pallas_call in _flash_bwd_impl)
//        bf16: flash_bwd_dq_wg_kernel (D = 64, 80, 128),
//        flash_bwd_dq_tc_kernel (D = 32)  f32: flash_bwd_dq_kernel
//   B3 _flash_dkv_kernel (second pl.pallas_call in _flash_bwd_impl)
//        bf16: flash_bwd_dkv_wg_kernel (D = 64, 80, 128),
//        flash_bwd_dkv_tc_kernel (D = 32) f32: flash_bwd_dkv_kernel
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
// bf16, the training path's type, runs on the tensor cores.  The products
// are exact (bf16 x bf16 -> f32, as the MXU's are); only the f32
// summation order differs from the plain versions.
//
// B1 at D = 64, 80 and 128 (kHopperFwd) is a Hopper kernel (section "B1
// bf16, Hopper" below): TMA loads into a ring of stages signalled by full
// / empty mbarriers, a producer warp and two consumer warpgroups of 64
// queries each.  At the measured shapes its bound is bytes, with
// operations close behind: q, k, v and O moved once take 0.0151 ms at
// the training shape, and ~4 flops a live (query, key) pair and feature
// (S = Q.K^T and O += P.V), 12.9 GFLOP, 0.013 ms at 989 TFLOP/s.  Beside
// the products each pair costs an ex2 on the MUFU pipe (16 a clock an SM)
// and a few FMAs, which at D = 64 take as many cycles as the tensor cores.
// Its design: both products on wgmma (S from shared memory, P.V with p in
// registers, so p never touches shared memory), the scale folded into the
// exp2's one FMA, the mask only on tiles that are not fully live, tiles
// outside the band never loaded, and (D = 64, 80) a persistent grid whose
// producer loads the next work tile while the consumers finish the last.
// At D = 80 each row is two TMA boxes, 64 features with the 128-byte
// swizzle and 16 with the 32-byte one (RowBoxes).  A warpgroup's chain a
// tile (S, softmax, P.V) is serial: forming S a tile ahead, and the two
// warpgroups taking turns through named barriers, were both slower on the
// card (PERF.md §6).
//
// B2 and B3 at D = 64, 80 and 128 (kHopperBwd) are Hopper kernels: wgmma,
// TMA, mbarriers and warp specialisation (section "Hopper backward
// kernels" below).  A CTA is two consumer warpgroups of 64 rows each and
// one producer warpgroup.  One warp of the producer loads: TMA boxes of
// 64 rows (RowBoxes: 64 features with the 128-byte swizzle, and at D = 80
// a 16-feature box with the 32-byte one) from descriptors built on the
// host from each tensor's own strides, into a ring of stages signalled by
// full / empty mbarriers.  The consumers form S and dP with wgmma from shared
// memory, the element-wise p / ds / flag code on the accumulators (a
// warp's slice of a wgmma accumulator is the m16n8 C layout), and store
// p and ds as bf16 tiles in shared memory.  The producer's three other
// warps (the helpers) take each stage's K/V (B2) or Q/dO (B3) row norms a
// stage ahead, and sum the flagged pairs again in the plain order,
// storing the plain version's roundings over the tensor cores' (a B2
// consumer warp leaves them at most kQueued pairs a tile and sums the rest
// itself, as a B3 one does at D = 80 with kDkvQueued: training data flag
// up to 6 % of pairs on lm_small and 8-23 % in most layers of ViT-H/14,
// and the helpers alone would hold the consumers up).  One tile later the consumers form dQ += dS.K
// (B2) or dV += P^T.dO and dK += dS^T.Q (B3) with wgmma from those tiles,
// and release the stage.  The sums stay in registers and are written
// once.  setmaxnreg gives the producer warpgroup 96 registers and the
// consumers the rest; the compiler holds every role to the launch's 168 a
// thread (384 threads, one CTA an SM), so the consumers' register budget
// is that.  At D = 80 (ViT-H/14) a 160-byte row is B1's two boxes: S and
// dP contract over 4 k-steps of the atom and 1 of the tail, and each
// product whose N is D (dQ, dV, dK) is an n = 64 wgmma over the atom and
// an n = 16 one over the tail, so the rows are read in place and no
// product is padded to 128 features.  At ViT-H/14's shapes (batch 32, 16
// heads, 256 or 257 tokens, non-causal) B2 and B3 are bound by bytes:
// moving q, k, v, dO and their outputs once takes 0.0316 and 0.0379 ms on
// an H100, the products 0.016 and 0.022 ms at 989 TFLOP/s.  A short
// sequence gives each CTA only 4 or 5 tiles to stream, so the ring's
// first loads and the last tile's products are a large part of its time.
//
// B1 and B2/B3 at D = 32 keep the FlashAttention-2 schedule on mma.sync
// (m16n8k16): one CTA of 4 warps owns a 64-row tile and each warp 16 of
// its rows.  Tiles move global -> shared by 16-byte cp.async copies into a
// two-stage ring, stored as bf16 with rows padded to D + 8 elements so
// that ldmatrix (.trans where an operand is needed k-major) reads them
// without bank conflicts.  Score tiles stay in registers: the m16n8
// accumulator layout is the m16k16 A-operand layout, so p (and ds) become
// bf16 A fragments in place and never touch shared memory.  D = 32's
// 64-byte rows need the 64-byte TMA swizzle, which no Hopper kernel takes.
//   B1: a (b, h, query tile) per CTA; Q fragments are loaded once; K/V
//       tiles of 64 keys stream through the ring; S = Q.K^T (16 x 64 per
//       warp), scale, mask and the online softmax run on registers (row
//       max and sum by quad shuffles), then acc += P.V.  The grid is
//       (B*H, query tiles), walked last tile first, so the heaviest causal
//       tiles start first.
//   B2: a (b, h, query tile) per CTA, walked last tile first as B1; each
//       warp's 16 rows of Q and dO stay in registers as A fragments; K/V
//       tiles of 64 keys stream through the ring; S = Q.K^T and dP =
//       dO.V^T stay in registers, dS becomes a bf16 A fragment in place,
//       and dQ += dS.K reads K through ldmatrix.trans.  dQ accumulates in
//       registers and is written once.  ds rounds to bf16 exactly as the
//       plain version's (see "B2 bf16").
//   B3: a (b, KV head, key tile) per CTA; each warp's 16 key rows of K and
//       V stay in registers.  The CTA loops over (group member, query
//       tile) with each Q/dO tile and its LSE/delta rows in the ring; each
//       warp forms S^T = K_w.Q^T and dP^T = V_w.dO^T, then P^T and dS^T,
//       and accumulates dV_w += P^T.dO and dK_w += dS^T.Q (dO and Q through
//       ldmatrix.trans).  The sums stay in registers, with no atomics, so
//       they are deterministic.  p and ds round to bf16 exactly as the
//       plain version's: the few pairs whose rounding its f32 sums could
//       decide otherwise are summed again in its order (see "B3 bf16").
//
// Head dims: 32, 64, 80 (ViT-H/14) and 128.  Every loop over the features
// runs D / 16 k-steps or D / 8 n-tiles (5 and 10 at D = 80), and a row is
// D / 8 16-byte copies, so no count needs to be a power of two.
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
// returns cudaGetLastError() (0 on success).  The Hopper kernels' TMA
// descriptors are encoded on the host for each launch with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: the
// library does not link libcuda, and builds with the other kernels' nvcc
// line.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
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
  // each warp keeps its K and V rows as A fragments in registers and
  // takes a query tile's 64 columns at once (the other head dims run the
  // Hopper kernel, kHopperBwd)
  static_assert(D == 32, "mma.sync B3 runs D = 32 only");
  constexpr int QN = 64;
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
  uint32_t ka[KD][4], va[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(ka[kk], ka_s + at<LD>(0, 16 * kk));
    ldsm_x4(va[kk], va_s + at<LD>(0, 16 * kk));
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
#pragma unroll
        for (int j = 0; j < QN / 16; ++j) {
          uint32_t qf[4], gf[4];
          ldsm_x4(qf, qst + ln.bn + at<LD>(qb + 16 * j, 16 * kk));
          ldsm_x4(gf, gst + ln.bn + at<LD>(qb + 16 * j, 16 * kk));
          mma_bf16(s[2 * j], ka[kk], qf[0], qf[1]);
          mma_bf16(s[2 * j + 1], ka[kk], qf[2], qf[3]);
          mma_bf16(dp[2 * j], va[kk], gf[0], gf[1]);
          mma_bf16(dp[2 * j + 1], va[kk], gf[2], gf[3]);
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
  // each warp keeps its Q and dO rows as A fragments in registers and
  // takes a key tile's 64 columns at once (the other head dims run the
  // Hopper kernel, kHopperBwd)
  static_assert(D == 32, "mma.sync B2 runs D = 32 only");
  constexpr int KN = 64;
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
  uint32_t qa[KD][4], ga[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    ldsm_x4(qa[kk], qs_a + at<LD>(0, 16 * kk));
    ldsm_x4(ga[kk], gs_a + at<LD>(0, 16 * kk));
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
#pragma unroll
        for (int j = 0; j < KN / 16; ++j) {
          uint32_t kf[4], vf[4];
          ldsm_x4(kf, kst + ln.bn + at<LD>(kb + 16 * j, 16 * kk));
          ldsm_x4(vf, vst + ln.bn + at<LD>(kb + 16 * j, 16 * kk));
          mma_bf16(s[2 * j], qa[kk], kf[0], kf[1]);
          mma_bf16(s[2 * j + 1], qa[kk], kf[2], kf[3]);
          mma_bf16(dp[2 * j], ga[kk], vf[0], vf[1]);
          mma_bf16(dp[2 * j + 1], ga[kk], vf[2], vf[3]);
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

// ======================================== Hopper backward kernels (bf16)
//
// B2 and B3 at D = 64, 80 and 128 (the header's "Design by dtype").  What
// they compute is the mma.sync kernels' to the bit of every rounding: the
// same p_of / ds_of, the same DotSlack flag (p_ds_tile, ds_tile), and the
// flagged pairs summed again in the plain order, here by the helpers;
// only the f32 order of the products' sums differs.  The audit
// instantiations (kAudit) sum every live pair again in the consumer
// (resum_spread) and count as the mma.sync ones do.
//
// A tile of R rows lies in shared memory as RowBoxes lays it out: D / 64
// atoms of [R][64] bf16, each row 128 bytes with its 16-byte chunk c
// stored at c ^ (row % 8) (TMA's CU_TENSOR_MAP_SWIZZLE_128B on a
// 1024-byte-aligned base; wgmma's layout type 1), then, at D = 80, its
// tail of [R][16], each row 32 bytes with chunk c at c ^ (row / 4 % 2)
// (CU_TENSOR_MAP_SWIZZLE_32B; layout type 3).  A box of 64 rows is one TMA
// load.  The p / ds tiles the consumers store are one atom of 64 keys or
// queries whatever D is, as the A operands of the products.
//
// Bound on this card: as the header says, operations; but what holds the
// kernels back is the latency of each warpgroup's chain (products, the
// element-wise p / ds / flag code, its stores) at 8 consumer warps an SM,
// which the helpers shorten by taking the norms and the re-sums off it.

constexpr int kAtom = 64;  // bf16 columns of a 128-byte atom

// The Hopper kernels' shape: two consumer warpgroups (64 rows each) and
// one producer warpgroup a CTA, one CTA an SM, ring stages and p / ds tile
// slots, and the registers each role takes with setmaxnreg: the launch
// gives every thread kLaunchRegs (65536 / threads, a multiple of 8); the
// producer warpgroup (its loading warp and the helpers) keeps 96 and the
// consumers take the rest, up to 240.  ptxas holds the consumers' code to
// the launch's count all the same (168 here), so a consumer's sums, tiles
// and element-wise code must fit 168 registers: hence B3's 32 queries a
// product, and B3 at D = 128 spills.
template <int D>
struct WgCfg {
  static constexpr int kNwg = 2;
  // a tile's products are formed one tile after it (once the helpers are
  // done with it) and its stage released then: the stages hold that tile,
  // the current one and those loading; kSlots tiles of p / ds are kept.
  // At D = 80 (ViT-H/14) 4 and 3 stages ran within 2 % of each other and
  // 2 was 7-11 % slower on an H100 (PERF.md); D = 128 fits 2.
  static constexpr int kStages = D == 128 ? 2 : 4;
  static constexpr int kSlots = 2;
  static constexpr int kMinBlocks = 1;
  static constexpr int kThreads = 128 * (kNwg + 1);
  static constexpr int kFit = 65536 / (kThreads * kMinBlocks);
  static constexpr int kLaunchRegs = (kFit > 255 ? 255 : kFit) & ~7;
  static constexpr int kProducerRegs = 96;
  static constexpr int kShare = (kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * kNwg) & ~7;
  static constexpr int kConsumerRegs = kShare > 240 ? 240 : kShare;
};

// which head dims B2 and B3 run on the Hopper kernels (D = 32 on the
// mma.sync kernels above)
template <int D>
constexpr bool kHopperBwd = D == 64 || D == 80 || D == 128;

// B3's queries a product, and the flagged pairs a consumer warp leaves to
// the helpers a product (-1: all; it sums any beyond these itself), by head
// dim.  On ViT-H/14's training data (D = 80) 8-23 % of the pairs of most
// layers are flagged, and three helper warps an SM cannot keep up: there
// 16 queries a product, whose registers leave room for the consumer's own
// re-sum without a spill, and 8 pairs to the helpers ran fastest on an H100
// (PERF.md).  At 64 and 128 every flagged pair goes to the helpers.
template <int D>
constexpr int kDkvQueries = D == 80 ? 16 : 32;
template <int D>
constexpr int kDkvQueued = D == 80 ? 8 : -1;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects bytes more of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that outlasts
// ~10 s of device clock traps: a lost arrival ends the launch with an
// error rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  if (done) return;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000ll) __trap();
  } while (!done);
}

// The 64 x 64 box at (column c, row t, head h, batch b) of a [B, T, H, D]
// tensor into shared memory; rows past T arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int t, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c), "r"(t), "r"(h), "r"(b)
      : "memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the 128 threads of a consumer warpgroup, on named barrier id
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving an accumulator while a wgmma owns it
template <int J>
__device__ __forceinline__ void pin(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// A wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile:
// start address, leading and stride byte offsets (multiples of 16).
// K-major (the contraction contiguous): stride = 1024 bytes between 8-row
// groups, leading unused.  MN-major (transposed): stride = 1024 bytes
// between 8-row groups of the contraction, leading = the atom stride.
// layout: 1 the 128-byte swizzle, 3 the 32-byte one (8-row groups of
// 256 bytes: stride 256).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lead, uint32_t stride,
                                            uint64_t layout = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lead >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3FFFu) << 32 | layout << 62;
}

// A row's TMA boxes (row_boxes in ops/flash_attention.py): kWide boxes of
// 64 features with the 128-byte swizzle, then, where D is not a whole
// number of 128-byte atoms (D = 80: 160-byte rows), one box of kTail = 16
// features with the 32-byte swizzle.  A tile of `rows` rows lies in shared
// memory as its kWide atoms of [rows][64], then its tail [rows][16].  B1,
// B2 and B3 read every head dim through it.
template <int D>
struct RowBoxes {
  static constexpr int kWide = D / kAtom;
  static constexpr int kTail = D % kAtom;
  static_assert(kWide >= 1 && (kTail == 0 || kTail == 16), "no TMA split takes this head dim");
  static constexpr uint64_t kSw32 = 3;  // wgmma's layout type of the 32-byte swizzle

  // The boxes of rows t .. t + 63 (head h, batch b) into rows row0 ..
  // row0 + 63 of a tile of `rows` rows at `at`, completing on bar.
  __device__ static void load(void* at, int rows, int row0, const CUtensorMap* wide,
                              const CUtensorMap* tail, uint64_t* bar, int t, int h, int b) {
    unsigned char* tile = static_cast<unsigned char*>(at);
#pragma unroll
    for (int a = 0; a < kWide; ++a)
      tma_load(tile + (a * rows + row0) * (kAtom * 2), wide, bar, a * kAtom, t, h, b);
    if constexpr (kTail > 0)
      tma_load(tile + kWide * rows * (kAtom * 2) + row0 * (kTail * 2), tail, bar, kWide * kAtom, t, h,
               b);
  }

  // The element offset of 16-byte chunk ch (features 8 ch .. 8 ch + 7) of
  // row r in a tile of R rows: an atom's chunk at ch ^ (r % 8), the tail's
  // (ch = 8 kWide, 8 kWide + 1) at ch ^ (r / 4 % 2), the two swizzles
  template <int R>
  __device__ static int chunk(int r, int ch) {
    if (ch < 8 * kWide) return (ch >> 3) * (R * kAtom) + r * kAtom + (((ch & 7) ^ (r & 7)) << 3);
    return kWide * R * kAtom + r * kTail + (((ch & 1) ^ ((r >> 2) & 1)) << 3);
  }

  // k-step kk (features 16 kk .. 16 kk + 15) of rows row0 .. row0 + 63
  // of a K-major tile of `rows` rows: an atom's, or the tail's
  __device__ static uint64_t k_major(uint32_t tile, int rows, int row0, int kk) {
    if (kk < 4 * kWide)
      return wg_desc(tile + ((kk >> 2) * rows + row0) * (kAtom * 2) + (kk & 3) * 32, 16, 1024);
    return wg_desc(tile + kWide * rows * (kAtom * 2) + row0 * (kTail * 2), 16, 8 * kTail * 2, kSw32);
  }

  // rows 16 c .. 16 c + 15 of a tile of `rows` rows read MN-major
  // (transposed): the atoms' 64 kWide columns, then the tail's 16
  __device__ static uint64_t mn_wide(uint32_t tile, int rows, int c) {
    return wg_desc(tile + 16 * c * (kAtom * 2), rows * (kAtom * 2), 1024);
  }
  __device__ static uint64_t mn_tail(uint32_t tile, int rows, int c) {
    return wg_desc(tile + kWide * rows * (kAtom * 2) + 16 * c * (kTail * 2), rows * kTail * 2,
                   8 * kTail * 2, kSw32);
  }
};

// The TMA descriptors of a [B, T, H, D] view's row boxes (RowBoxes).
struct RowMaps {
  CUtensorMap wide, tail;
};

// The TMA descriptors of q, k, v and dO (B2, B3), built on the host.
struct TmaMaps {
  RowMaps q, k, v, g;
};

template <int N>
__device__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b);

// d[64 x 16] += A (shared, K-major) . B (shared, K-major)
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[2][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 32] += A (shared, K-major) . B (shared, K-major)
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[4][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A (shared, K-major) . B (shared, K-major)
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ void wgmma_ss_t(float (*d)[4], uint64_t a, uint64_t b);

// d[64 x 16] += A (shared, K-major) . B (shared, MN-major: transposed)
template <>
__device__ __forceinline__ void wgmma_ss_t<16>(float (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 64] += A (shared, K-major) . B (shared, MN-major: transposed)
template <>
__device__ __forceinline__ void wgmma_ss_t<64>(float (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 128] += A (shared, K-major) . B (shared, MN-major: transposed)
template <>
__device__ __forceinline__ void wgmma_ss_t<128>(float (*d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ void wgmma_rs_t(float (*d)[4], const uint32_t (&a)[4], uint64_t b);

// d[64 x 16] += A (registers: a warp's m16k16 fragment of its 16 rows) . B
// (shared, MN-major: transposed)
template <>
__device__ __forceinline__ void wgmma_rs_t<16>(float (*d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A (registers: a warp's m16k16 fragment of its 16 rows) . B
// (shared, MN-major: transposed)
template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (*d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 128] += A (registers: a warp's m16k16 fragment of its 16 rows) . B
// (shared, MN-major: transposed)
template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float (*d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int J>
__device__ __forceinline__ void zero(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
}

// The 2-norm of row r of a swizzled tile of R rows (RowBoxes).
template <int D, int R>
__device__ __forceinline__ float row_norm_swz(const bf16* tile, int r) {
  float ss = 0.f;
#pragma unroll
  for (int ch = 0; ch < D / 8; ++ch) {
    float f[8];
    Vec16<bf16>::load(tile + RowBoxes<D>::template chunk<R>(r, ch), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss = fmaf(f[i], f[i], ss);
  }
  return sqrtf(ss);
}

// plain_dots through the swizzles: s = q . k and dp = dO . v of query row
// qr (tiles of RQ rows) and key row kr (tiles of RK rows), f32 FMAs from
// the first feature to the last (at D = 80 across the atom into the tail).
template <int D, int RQ, int RK>
__device__ __forceinline__ void plain_dots_swz(const bf16* qt, const bf16* gt, int qr, const bf16* kt,
                                               const bf16* vt, int kr, float& s, float& dp) {
  s = 0.f;
  dp = 0.f;
#pragma unroll 2
  for (int ch = 0; ch < D / 8; ++ch) {
    using RB = RowBoxes<D>;
    float qf[8], kf[8], gf[8], vf[8];
    Vec16<bf16>::load(qt + RB::template chunk<RQ>(qr, ch), qf);
    Vec16<bf16>::load(kt + RB::template chunk<RK>(kr, ch), kf);
    Vec16<bf16>::load(gt + RB::template chunk<RQ>(qr, ch), gf);
    Vec16<bf16>::load(vt + RB::template chunk<RK>(kr, ch), vf);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s = fmaf(qf[i], kf[i], s);
      dp = fmaf(gf[i], vf[i], dp);
    }
  }
}

// The position of the k-th (from 0) set bit of m.
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// Slots of a warp's re-sum buffer: pairs re-summed between two passes
// that take results back into the accumulator registers.
constexpr int kResumSlots = 128;

// The re-sum of a warp's flagged pairs, spread over its 32 lanes.  Bit i
// of lane L's redo names element (i / 4, i % 4) of its accumulator tiles.
// Each lane writes its pairs, in order, into the warp's slots (lane << 5
// | i) after the pairs of the lanes before it; lane l then sums slots l,
// l + 32, ... again in the plain order from the swizzled Q / dO tile
// (rows RQ) and K / V tile (rows RK), with the LSE and delta of the
// pair's query row (lse, del: by row of the Q tile); and each lane takes
// its pairs' results back: p into s and ds into dp in B3 (kB3), ds into
// dp in B2.  In B3 a warp's 16 rows are keys (m0 in the K tile) and its
// columns queries (from qb); in B2 the reverse.  slot and res are this
// warp's kResumSlots entries; the audit counts each re-summed pair.
template <int D, int RQ, int RK, bool kB3, bool kAudit, int J>
__device__ __forceinline__ void resum_spread(unsigned redo, unsigned flag, float (&s)[J][4],
                                             float (&dp)[J][4], const bf16* qt, const bf16* gt,
                                             const bf16* kt, const bf16* vt, const float* lse,
                                             const float* del, int m0, int qb, float scale,
                                             int* slot, float2* res, int lane, Audit& audit) {
  if (__ballot_sync(0xffffffffu, redo != 0u) == 0u) return;
  const int n = __popc(redo);
  int incl = n;  // pairs of lanes 0 .. lane
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    incl += lane >= o ? y : 0;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  const int excl = incl - n;
  for (int base = 0; base < total; base += kResumSlots) {
    int k = excl - base;
    for (unsigned r = redo; r != 0u && k < kResumSlots; r &= r - 1u, ++k)
      if (k >= 0) slot[k] = lane << 5 | (__ffs(r) - 1);
    __syncwarp();
    const int count = min(total - base, kResumSlots);
    for (int g = lane; g < count; g += 32) {
      const int o = slot[g] >> 5, i = slot[g] & 31;
      // the owner's row (fr) and column (fc) of element i
      const int row = (o >> 2) + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (o & 3) + (i & 1);
      const int qr = kB3 ? qb + col : m0 + row;
      const int kr = kB3 ? m0 + row : qb + col;
      float ss, dd;
      plain_dots_swz<D, RQ, RK>(qt, gt, qr, kt, vt, kr, ss, dd);
      const float pv = p_of(ss, scale, lse[qr]);
      res[g] = make_float2(pv, ds_of(pv, dd, del[qr]));
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int g = excl + __popc(redo & ((1u << i) - 1u)) - base;
        if ((redo >> i) & 1u && g >= 0 && g < kResumSlots) {
          const float2 r = res[g];
          if constexpr (kAudit)
            audit.add((flag >> i) & 1u, bf16_differs(dp[j][e], r.y) ||
                                            (kB3 && bf16_differs(s[j][e], r.x)));
          if constexpr (kB3) s[j][e] = r.x;
          dp[j][e] = r.y;
        }
      }
    __syncwarp();
  }
}

// The asynchronous re-sum.  A consumer warp writes the tensor cores'
// bf16 roundings of a tile's p or ds into shared memory (store_tile, as
// the A operand of the next product) with one 32-bit mask a lane of its
// flagged pairs, and goes on; the three spare warps of the producer
// warpgroup (the helpers) sum each flagged pair again in the plain order
// and store the plain version's rounding over the tensor cores'.  The
// consumer forms the products of a tile one tile later, after the helpers
// are done with it: their roundings are the plain version's, their sums
// deterministic.
constexpr int kHelpers = 96;  // warps 1-3 of the producer warpgroup
// flagged pairs a B2 consumer warp leaves to the helpers a tile; it sums
// any beyond these itself (where the data flag many pairs, the helpers
// alone would hold every consumer up).  B3 leaves them all at D = 64 and
// 128 (kDkvQueued): summing them itself cost B3 more than the wait there.
constexpr int kQueued = 32;

// Split a warp's flagged pairs (bits of flag, lanes in order): the first
// `limit` stay in flag for the helpers, the rest are returned for the warp
// to sum again itself.
__device__ __forceinline__ unsigned split_flagged(unsigned& flag, int limit, int lane) {
  const int n = __popc(flag);
  if (__reduce_add_sync(0xffffffffu, static_cast<unsigned>(n)) <= static_cast<unsigned>(limit))
    return 0u;
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    incl += lane >= o ? y : 0;
  }
  const int keep = max(0, min(n, limit - (incl - n)));
  const unsigned kept =
      keep == n ? flag : keep == 0 ? 0u : flag & ((1u << nth_bit(flag, keep)) - 1u);
  const unsigned rest = flag & ~kept;
  flag = kept;
  return rest;
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A tile whose products are pending: its stage and that stage's use
// parity, its p / ds tile slot, whether this warpgroup forms its products
// (its tile met the band), and their 16-wide steps.  stage < 0: none.
struct Pending {
  int stage = -1;
  unsigned phase = 0;
  int slot = 0;
  bool mine = false;
  int steps = 0;
};

// A warp's 16 x 8J accumulator tile d, rounded to bf16, into rows m0 ..
// m0 + 15 (and columns from qb) of a 128-byte-swizzled tile of 64 columns.
template <int J>
__device__ __forceinline__ void store_tile(bf16* tile, const float (&d)[J][4], int m0, int qb,
                                           int lane) {
  const int r0 = m0 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      *reinterpret_cast<__nv_bfloat162*>(tile + r * kAtom + ((((qb >> 3) + j) ^ (r & 7)) << 3) + c) =
          __floats2bfloat162_rn(d[j][2 * h], d[j][2 * h + 1]);
    }
}

// A helper's share of a stage's flagged pairs: the NW x 32 masks (warp
// w, lane l at w * 32 + l) hold the pairs in order; each helper thread
// takes a run of them.  Each helper warp counts the pairs of all masks
// (NW a lane) itself, so the helpers need no barrier among them.  fn(f,
// i) gets mask f's bit i.
template <int NW, typename Fn>
__device__ __forceinline__ void helper_pairs(const unsigned* masks, int ht, Fn fn) {
  const int hl = ht & 31;
  int n = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) n += __popc(masks[hl * NW + i]);
  int incl = n;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    incl += hl >= o ? y : 0;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  // thread ht takes pairs ht * per .. ht * per + per - 1: the lanes of a
  // helper warp work on pairs of different masks (rows), whose swizzled
  // rows spread over the banks, where pairs of one mask would not
  const int per = (total + kHelpers - 1) / kHelpers;
  for (int it = 0; it < per; ++it) {
    const int g = ht * per + it;
    int o = 0;  // the lane whose masks hold pair g: the first with incl > g
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      const int v = __shfl_sync(0xffffffffu, incl, o + step - 1);
      o += v <= g ? step : 0;
    }
    int r = g - (__shfl_sync(0xffffffffu, incl, o) - __shfl_sync(0xffffffffu, n, o));
    int f = -1, bit = 0;
    for (int i = 0; i < NW && g < total; ++i) {
      const unsigned m = masks[o * NW + i];
      const int c = __popc(m);
      if (r < c) {
        f = o * NW + i;
        bit = nth_bit(m, r);
        break;
      }
      r -= c;
    }
    // the pair's sums after the search, where the lanes have met again
    // (inside it, a warp would run them once for each mask its lanes stop at)
    if (f >= 0) fn(f, bit);
  }
}

// Where a helper stores a pair's value: element (r, c) of a swizzled tile
// of 64 columns.
__device__ __forceinline__ int tile_at(int r, int c) {
  return r * kAtom + ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

// acc += A (a warpgroup's 64 x 16 steps tile at a, K-major) . B (16 steps
// rows of a stage's 64-row tile at b, transposed): one product over the
// 128-byte atoms and, at D = 80, an n = 16 one over the tail; issued and
// committed, not waited for.  A ragged last tile takes fewer steps.
template <int D>
__device__ __forceinline__ void product_ss_t(float (&acc)[D / 8][4], uint32_t a, uint32_t b,
                                             int steps) {
  using RB = RowBoxes<D>;
  pin(acc);
  wg_fence();
#pragma unroll
  for (int c = 0; c < kTile / 16; ++c)
    if (c < steps) {
      const uint64_t da = wg_desc(a + c * 32, 16, 1024);
      wgmma_ss_t<kAtom * RB::kWide>(acc, da, RB::mn_wide(b, kTile, c));
      if constexpr (RB::kTail > 0)
        wgmma_ss_t<RB::kTail>(acc + 8 * RB::kWide, da, RB::mn_tail(b, kTile, c));
    }
  wg_commit();
}

// B3's dV += P^T . dO (p in dO's dtype) and dK += dS^T . Q (ds in q's) of
// a pending tile, once the helpers have stored their roundings,
// contracted over its queries: issued, not waited for.
template <int D, int R>
__device__ __forceinline__ void dkv_products(float (&dv)[D / 8][4], float (&dk)[D / 8][4],
                                             const Pending& t, uint64_t* fixed, const bf16* Pt,
                                             const bf16* Dt, const bf16* Qs, const bf16* Gs,
                                             int wg) {
  mbar_wait(fixed + t.stage, t.phase);
  const uint32_t rows = (t.slot * R + kTile * wg) * kAtom * 2;
  product_ss_t<D>(dv, smem_addr(Pt) + rows, smem_addr(Gs + t.stage * kTile * D), t.steps);
  product_ss_t<D>(dk, smem_addr(Dt) + rows, smem_addr(Qs + t.stage * kTile * D), t.steps);
}

// ------------------------------------------------------ B3 bf16, Hopper
//
// One CTA per (b, KV head, 64 kNwg keys).  The producer warp loads the K
// and V tiles once, then streams the (member, query tile) stages t =
// member * nq + qi that meet the band: Q and dO by TMA, the LSE / delta
// rows by its lanes' loads (rows past Tq take 1e30 and 0).  Each consumer
// warpgroup owns 64 keys: S^T = K.Q^T and dP^T = V.dO^T (wgmma, both
// operands from shared memory), the queries taken QN at a time; P^T and
// dS^T in registers, stored as bf16 for the helpers to correct; one stage
// later dV += P^T.dO and dK += dS^T.Q (wgmma, from shared memory, dO and Q
// transposed), and the stage is released.

template <int D>
__host__ __device__ constexpr size_t dkv_wg_smem_bytes() {
  using C = WgCfg<D>;
  constexpr int R = kTile * C::kNwg, S = C::kStages, NW = 4 * C::kNwg;
  // K, V; Q and dO a stage; P^T and dS^T a slot; the barriers; the in-place re-sum
  // buffers (the audit); the flag masks a stage; LSE, delta, Q and dO
  // norms a stage; K and V norms
  return 1024 + 2 * R * D * 2 + 2 * S * kTile * D * 2 + 2 * C::kSlots * R * kAtom * 2 +
         8 * (5 * S + 1) + 12 * NW * kResumSlots + 4 * S * NW * 32 + 4 * (4 * S * kTile + 2 * R);
}

template <int D, bool kAudit>
__global__ void __launch_bounds__(WgCfg<D>::kThreads, WgCfg<D>::kMinBlocks)
    flash_bwd_dkv_wg_kernel(const __grid_constant__ Params p, const __grid_constant__ TmaMaps m) {
  using C = WgCfg<D>;
  using RB = RowBoxes<D>;
  constexpr int NWG = C::kNwg, S = C::kStages;
  constexpr int R = kTile * NWG;  // key rows of the CTA
  constexpr int NW = 4 * NWG;     // consumer warps
  constexpr int QN = kDkvQueries<D>;  // queries a product takes
  constexpr int J = QN / 8;
  constexpr int ND = D / 8;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = align1024(wg_smem);
  bf16* Ks = reinterpret_cast<bf16*>(sm);  // [R rows] (RowBoxes)
  bf16* Vs = Ks + R * D;                   // [R rows]
  bf16* Qs = Vs + R * D;                   // [S][64 rows]
  bf16* Gs = Qs + S * kTile * D;           // dO [S][64 rows]
  bf16* Pt = Gs + S * kTile * D;             // [kSlots][R][64] P^T in dO's dtype
  bf16* Dt = Pt + C::kSlots * R * kAtom;     // [kSlots][R][64] dS^T in q's dtype
  uint64_t* full = reinterpret_cast<uint64_t*>(Dt + C::kSlots * R * kAtom);  // [S] Q, dO, rows
  uint64_t* empty = full + S;   // [S] the stage is free
  uint64_t* ready = empty + S;  // [S] its P^T, dS^T tiles and flags are stored
  uint64_t* fixed = ready + S;  // [S] the helpers are done with them
  uint64_t* normed = fixed + S;  // [S] the helpers took its Q and dO row norms
  uint64_t* kv_full = normed + S;
  float2* res = reinterpret_cast<float2*>(kv_full + 1);                    // [NW][kResumSlots]
  int* slot = reinterpret_cast<int*>(res + NW * kResumSlots);              // [NW][kResumSlots]
  unsigned* flags = reinterpret_cast<unsigned*>(slot + NW * kResumSlots);  // [S][NW][32]
  float* Lse = reinterpret_cast<float*>(flags + S * NW * 32);              // [S][64]
  float* Del = Lse + S * kTile;                                            // [S][64]
  float* Qn = Del + S * kTile;  // [S][64] row norms of Q
  float* Gn = Qn + S * kTile;   // [S][64] row norms of dO
  float* Kn = Gn + S * kTile;   // [R]
  float* Vn = Kn + R;           // [R]

  const int tid = threadIdx.x;
  // a broadcast, so that ptxas sees it warp-uniform: a product in a path it
  // cannot prove uniform serialises every wgmma of the kernel (C7520)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), lane = tid & 31;
  const int bhk = blockIdx.x;
  const int b = bhk / p.Hkv;
  const int hk = bhk - b * p.Hkv;
  const int k0 = blockIdx.y * R;
  const int G = p.H / p.Hkv;
  const Mask mk = make_mask(p);
  const int nqt = (p.Tq + kTile - 1) / kTile;
  const int nt = G * nqt;  // steps t = member * nqt + qi, the Pallas order
  // does warpgroup w's key tile meet the query tile at q0?
  auto live_for = [&](int q0, int w) {
    return k0 + kTile * w < p.Tk && mk.tile_live(q0, k0 + kTile * w);
  };
  auto next_live = [&](int t) {
    for (; t < nt; ++t) {
      bool live = false;
#pragma unroll
      for (int w = 0; w < NWG; ++w) live = live || live_for((t % nqt) * kTile, w);
      if (live) break;
    }
    return t;
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 2);  // the TMA bytes' arrival and the rows' arrival
      mbar_init(empty + s, 128 * NWG);
      mbar_init(ready + s, 128 * NWG);
      mbar_init(fixed + s, kHelpers);
      mbar_init(normed + s, kHelpers);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {  // ---------------------------- producer and helpers
    reg_dealloc<C::kProducerRegs>();
    if (tid - 128 * NWG < 32) {  // the producer warp
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * R * D * 2);
#pragma unroll
        for (int w = 0; w < NWG; ++w) {
          RB::load(Ks, R, w * kTile, &m.k.wide, &m.k.tail, kv_full, k0 + w * kTile, hk, b);
          RB::load(Vs, R, w * kTile, &m.v.wide, &m.v.tail, kv_full, k0 + w * kTile, hk, b);
        }
      }
      int stage = 0;
      unsigned phase = 0;
      for (int t = next_live(0); t < nt; t = next_live(t + 1)) {
        const int member = t / nqt;
        const int q0 = (t - member * nqt) * kTile;
        const int h = hk * G + member;
        const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Tq + q0;
        float lr[kTile / 32], dr[kTile / 32];  // the rows, read before the wait
#pragma unroll
        for (int i = 0; i < kTile / 32; ++i) {
          const int r = lane + 32 * i;
          const bool ok = q0 + r < p.Tq;
          lr[i] = ok ? p.lse[row0 + r] : kLsePad;
          dr[i] = ok ? p.delta[row0 + r] : 0.f;
        }
        mbar_wait(empty + stage, phase ^ 1u);
        if (lane == 0) {
          mbar_expect_tx(full + stage, 2 * kTile * D * 2);
          RB::load(Qs + stage * kTile * D, kTile, 0, &m.q.wide, &m.q.tail, full + stage, q0, h, b);
          RB::load(Gs + stage * kTile * D, kTile, 0, &m.g.wide, &m.g.tail, full + stage, q0, h, b);
        }
#pragma unroll
        for (int i = 0; i < kTile / 32; ++i) {
          Lse[stage * kTile + lane + 32 * i] = lr[i];
          Del[stage * kTile + lane + 32 * i] = dr[i];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full + stage);
        if (++stage == S) {
          stage = 0;
          phase ^= 1u;
        }
      }
    } else {  // the helpers: row norms a stage ahead, then the flagged pairs
      const int ht = tid - 128 * NWG - 32;
      // the Q and dO row norms of a stage, for the consumers' slack
      auto norms = [&](int st, unsigned ph) {
        mbar_wait(full + st, ph);
        for (int r = ht; r < 2 * kTile; r += kHelpers) {
          const bf16* tile = (r < kTile ? Qs : Gs) + st * kTile * D;
          (r < kTile ? Qn : Gn)[st * kTile + (r & (kTile - 1))] =
              row_norm_swz<D, kTile>(tile, r & (kTile - 1));
        }
        mbar_arrive(normed + st);
      };
      mbar_wait(kv_full, 0);
      int stage = 0, slot_t = 0;
      unsigned phase = 0;
      int t = next_live(0);
      if (t < nt) norms(0, 0);
      for (; t < nt;) {
        const int tn = next_live(t + 1);
        const int sn = stage + 1 == S ? 0 : stage + 1;
        if (tn < nt) norms(sn, sn == 0 ? phase ^ 1u : phase);
        mbar_wait(ready + stage, phase);
        const bf16* Qst = Qs + stage * kTile * D;
        const bf16* Gst = Gs + stage * kTile * D;
        const float* Lst = Lse + stage * kTile;
        const float* Dst = Del + stage * kTile;
        bf16* pt = Pt + slot_t * R * kAtom;
        bf16* dt = Dt + slot_t * R * kAtom;
        // bit i of warp w, lane l: key row 16 w + l / 4 (+ 8), query column
        // 8 (i / 4) + 2 (l % 4) (+ 1) of the CTA's P^T and dS^T tiles
        helper_pairs<NW>(flags + stage * NW * 32, ht, [&](int f, int i) {
          const int kr = 16 * (f >> 5) + ((f & 31) >> 2) + 8 * ((i >> 1) & 1);
          const int qc = 8 * (i >> 2) + 2 * (f & 3) + (i & 1);
          float ss, dd;
          plain_dots_swz<D, kTile, R>(Qst, Gst, qc, Ks, Vs, kr, ss, dd);
          const float pv = p_of(ss, p.scale, Lst[qc]);
          pt[tile_at(kr, qc)] = __float2bfloat16_rn(pv);
          dt[tile_at(kr, qc)] = __float2bfloat16_rn(ds_of(pv, dd, Dst[qc]));
        });
        fence_async_smem();
        mbar_arrive(fixed + stage);
        stage = sn;
        phase = sn == 0 ? phase ^ 1u : phase;
        slot_t = slot_t + 1 == C::kSlots ? 0 : slot_t + 1;
        t = tn;
      }
    }
  } else {  // ------------------------------------------------- consumers
    reg_alloc<C::kConsumerRegs>();
    const int wt = tid & 127;
    const int m0 = kTile * wg + 16 * (wt >> 5);  // this warp's key rows
    const int fr = lane >> 2, fc = 2 * (lane & 3);
    const int bar_id = 1 + wg;
    const int warp = tid >> 5;
    float2* wres = res + warp * kResumSlots;
    int* wslot = slot + warp * kResumSlots;
    const uint32_t ks_a = smem_addr(Ks), vs_a = smem_addr(Vs);

    // dK and dV of rows m0 + fr and m0 + fr + 8, features 8n + fc (+1)
    float dk[ND][4], dv[ND][4];
    zero(dk);
    zero(dv);
    Audit audit;

    mbar_wait(kv_full, 0);
    {  // this warpgroup's K and V row norms, for the slack
      const int r = kTile * wg + (wt & (kTile - 1));
      if (wt < kTile)
        Kn[r] = row_norm_swz<D, R>(Ks, r);
      else
        Vn[r] = row_norm_swz<D, R>(Vs, r);
    }
    wg_sync(bar_id);
    const float kn0 = Kn[m0 + fr], kn1 = Kn[m0 + fr + 8];
    const float vn0 = Vn[m0 + fr], vn1 = Vn[m0 + fr + 8];

    int stage = 0, slot_t = 0;
    unsigned phase = 0;
    Pending last;  // the tile before this one
    for (int t = next_live(0); t < nt; t = next_live(t + 1)) {
      mbar_wait(full + stage, phase);
      const int q0 = (t % nqt) * kTile;
      const int nq = min(kTile, p.Tq - q0);
      const bool mine = live_for(q0, wg);
      unsigned flags_t = 0u;
      if (mine) {
        const bf16* Qst = Qs + stage * kTile * D;
        const bf16* Gst = Gs + stage * kTile * D;
        const uint32_t qst = smem_addr(Qst), gst = smem_addr(Gst);
        const float* Lst = Lse + stage * kTile;
        const float* Dst = Del + stage * kTile;
        const float* qn = Qn + stage * kTile;
        const float* gn = Gn + stage * kTile;
        const bool full_tile = mk.tile_full(q0, k0 + kTile * wg);
#pragma unroll
        for (int qb = 0; qb < kTile; qb += QN) {
          if (qb >= nq) continue;  // a ragged last tile's empty half
          // S^T = K_wg . Q^T and dP^T = V_wg . dO^T: 64 keys x QN queries
          float s[J][4], dp[J][4];
          zero(s);
          zero(dp);
          pin(s);
          pin(dp);
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {  // this warpgroup's key rows
            wgmma_ss<QN>(s, RB::k_major(ks_a, R, kTile * wg, kk), RB::k_major(qst, kTile, qb, kk));
            wgmma_ss<QN>(dp, RB::k_major(vs_a, R, kTile * wg, kk), RB::k_major(gst, kTile, qb, kk));
          }
          wg_commit();
          if (qb == 0) mbar_wait(normed + stage, phase);  // the stage's Q and dO norms
          wg_wait_all();
          pin(s);
          pin(dp);

          // P^T and dS^T in place of S^T and dP^T; flag holds the pairs
          // whose rounding the plain version's sums might decide
          // otherwise, left to the helpers up to kDkvQueued a warp (at
          // D = 80; the rest summed again here) or all of them (the audit:
          // every live pair summed again here, and none left)
          const RowStats rs{Lst + qb + fc, Dst + qb + fc, qn + qb + fc, gn + qb + fc,
                            {kn0, kn1}, {vn0, vn1}};
          const int qrow = q0 + qb + fc, krow = k0 + m0 + fr;
          unsigned live;
          unsigned flag =
              full_tile ? p_ds_tile<true, D>(s, dp, rs, mk, qrow, krow, p.scale, live)
                        : p_ds_tile<false, D>(s, dp, rs, mk, qrow, krow, p.scale, live);
          if constexpr (kAudit) {
            resum_spread<D, kTile, R, true, true>(live, flag, s, dp, Qst, Gst, Ks, Vs, Lst, Dst,
                                                  m0, qb, p.scale, wslot, wres, lane, audit);
            flag = 0u;
          } else if constexpr (kDkvQueued<D> >= 0) {
            const unsigned rest = split_flagged(flag, kDkvQueued<D>, lane);
            resum_spread<D, kTile, R, true, false>(rest, 0u, s, dp, Qst, Gst, Ks, Vs, Lst, Dst,
                                                   m0, qb, p.scale, wslot, wres, lane, audit);
          }
          store_tile(Pt + slot_t * R * kAtom, s, m0, qb, lane);
          store_tile(Dt + slot_t * R * kAtom, dp, m0, qb, lane);
          flags_t |= flag << (qb / 2);  // a product's bits from qb / 2
        }
        fence_async_smem();
      }
      flags[(stage * NW + warp) * 32 + lane] = flags_t;
      mbar_arrive(ready + stage);

      // the last tile's products, waited for; then its stage is released
      if (last.stage >= 0) {
        if (last.mine) dkv_products<D, R>(dv, dk, last, fixed, Pt, Dt, Qs, Gs, wg);
        wg_wait_all();
        mbar_arrive(empty + last.stage);
      }
      last = Pending{stage, phase, slot_t, mine, (nq + 15) / 16};
      slot_t = slot_t + 1 == C::kSlots ? 0 : slot_t + 1;
      if (++stage == S) {
        stage = 0;
        phase ^= 1u;
      }
    }
    if (last.stage >= 0) {
      if (last.mine) dkv_products<D, R>(dv, dk, last, fixed, Pt, Dt, Qs, Gs, wg);
      wg_wait_all();
      mbar_arrive(empty + last.stage);
    }
    pin(dv);
    pin(dk);

    const int nkv = min(R, p.Tk - k0);
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
}

// B2's dQ += dS . K (ds in k's dtype) of a pending tile, once the helpers
// have stored their roundings, contracted over its keys: issued, not
// waited for.
template <int D, int R>
__device__ __forceinline__ void dq_product(float (&dq)[D / 8][4], const Pending& t,
                                           uint64_t* fixed, const bf16* Ds, const bf16* Ks,
                                           int wg) {
  mbar_wait(fixed + t.stage, t.phase);
  product_ss_t<D>(dq, smem_addr(Ds + (t.slot * R + kTile * wg) * kAtom),
                  smem_addr(Ks + t.stage * kTile * D), t.steps);
}

// ------------------------------------------------------ B2 bf16, Hopper
//
// One CTA per (b, head, 64 kNwg queries), walked last tile first.  The
// producer warp loads the Q and dO tiles once, then streams the K and V
// tiles that meet the band.  Each consumer warpgroup owns 64 queries: S =
// Q.K^T and dP = dO.V^T (wgmma, shared memory), dS in registers, stored
// as bf16 for the helpers to correct; one tile later dQ += dS.K (wgmma, dS
// and K, transposed, from shared memory), and the stage is released.

template <int D>
__host__ __device__ constexpr size_t dq_wg_smem_bytes() {
  using C = WgCfg<D>;
  constexpr int R = kTile * C::kNwg, S = C::kStages, NW = 4 * C::kNwg;
  // Q, dO; K, V a stage; the dS tiles a slot; the barriers; the in-place
  // re-sum buffers (the audit); the flag masks a stage; K and V norms a
  // stage; Q and dO norms, LSE and delta of the rows
  return 1024 + 2 * R * D * 2 + 2 * S * kTile * D * 2 + C::kSlots * R * kAtom * 2 +
         8 * (5 * S + 1) + 12 * NW * kResumSlots + 4 * S * NW * 32 + 4 * (2 * S * kTile + 4 * R);
}

template <int D, bool kAudit>
__global__ void __launch_bounds__(WgCfg<D>::kThreads, WgCfg<D>::kMinBlocks)
    flash_bwd_dq_wg_kernel(const __grid_constant__ Params p, const __grid_constant__ TmaMaps m) {
  using C = WgCfg<D>;
  using RB = RowBoxes<D>;
  constexpr int NWG = C::kNwg, S = C::kStages;
  constexpr int R = kTile * NWG;  // query rows of the CTA
  constexpr int NW = 4 * NWG;     // consumer warps
  constexpr int J = kTile / 8;    // a key tile's n-tiles
  constexpr int ND = D / 8;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = align1024(wg_smem);
  bf16* Qs = reinterpret_cast<bf16*>(sm);  // [R rows] (RowBoxes)
  bf16* Gs = Qs + R * D;                   // dO [R rows]
  bf16* Ks = Gs + R * D;                   // [S][64 rows]
  bf16* Vs = Ks + S * kTile * D;           // [S][64 rows]
  bf16* Ds = Vs + S * kTile * D;           // [kSlots][R][64] dS in k's dtype
  uint64_t* full = reinterpret_cast<uint64_t*>(Ds + C::kSlots * R * kAtom);  // [S] K, V landed
  uint64_t* empty = full + S;    // [S] the stage is free
  uint64_t* ready = empty + S;   // [S] its dS tile and flags are stored
  uint64_t* fixed = ready + S;   // [S] the helpers are done with them
  uint64_t* normed = fixed + S;  // [S] the helpers took its K and V row norms
  uint64_t* q_full = normed + S;
  float2* res = reinterpret_cast<float2*>(q_full + 1);                 // [NW][kResumSlots]
  int* slot = reinterpret_cast<int*>(res + NW * kResumSlots);          // [NW][kResumSlots]
  unsigned* flags = reinterpret_cast<unsigned*>(slot + NW * kResumSlots);  // [S][NW][32]
  float* Kn = reinterpret_cast<float*>(flags + S * NW * 32);           // [S][64]
  float* Vn = Kn + S * kTile;                                          // [S][64]
  float* Qn = Vn + S * kTile;        // [R]
  float* Gn = Qn + R;                // [R]
  float* Lq = Gn + R;                // [R] LSE of the rows
  float* Dq = Lq + R;                // [R] delta of the rows

  const int tid = threadIdx.x;
  // a broadcast, as B3's (C7520)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), lane = tid & 31;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * R;  // heaviest first
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / (p.H / p.Hkv);
  const Mask mk = make_mask(p);
  const int nk = (p.Tk + kTile - 1) / kTile;
  // does warpgroup w's query tile meet the key tile at k0?
  auto live_for = [&](int k0, int w) {
    return q0 + kTile * w < p.Tq && mk.tile_live(q0 + kTile * w, k0);
  };
  auto next_live = [&](int kt) {
    for (; kt < nk; ++kt) {
      bool live = false;
#pragma unroll
      for (int w = 0; w < NWG; ++w) live = live || live_for(kt * kTile, w);
      if (live) break;
    }
    return kt;
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * NWG);
      mbar_init(ready + s, 128 * NWG);
      mbar_init(fixed + s, kHelpers);
      mbar_init(normed + s, kHelpers);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {  // ---------------------------- producer and helpers
    reg_dealloc<C::kProducerRegs>();
    if (tid - 128 * NWG < 32) {  // the producer: one lane issues the loads
      if (lane != 0) return;
      mbar_expect_tx(q_full, 2 * R * D * 2);
#pragma unroll
      for (int w = 0; w < NWG; ++w) {
        RB::load(Qs, R, w * kTile, &m.q.wide, &m.q.tail, q_full, q0 + w * kTile, h, b);
        RB::load(Gs, R, w * kTile, &m.g.wide, &m.g.tail, q_full, q0 + w * kTile, h, b);
      }
      int stage = 0;
      unsigned phase = 0;
      for (int kt = next_live(0); kt < nk; kt = next_live(kt + 1)) {
        mbar_wait(empty + stage, phase ^ 1u);
        mbar_expect_tx(full + stage, 2 * kTile * D * 2);
        RB::load(Ks + stage * kTile * D, kTile, 0, &m.k.wide, &m.k.tail, full + stage, kt * kTile,
                 hk, b);
        RB::load(Vs + stage * kTile * D, kTile, 0, &m.v.wide, &m.v.tail, full + stage, kt * kTile,
                 hk, b);
        if (++stage == S) {
          stage = 0;
          phase ^= 1u;
        }
      }
    } else {  // the helpers: row norms a stage ahead, then the flagged pairs
      const int ht = tid - 128 * NWG - 32;
      // the K and V row norms of a stage, for the consumers' slack
      auto norms = [&](int st, unsigned ph) {
        mbar_wait(full + st, ph);
        for (int r = ht; r < 2 * kTile; r += kHelpers) {
          const bf16* tile = (r < kTile ? Ks : Vs) + st * kTile * D;
          (r < kTile ? Kn : Vn)[st * kTile + (r & (kTile - 1))] =
              row_norm_swz<D, kTile>(tile, r & (kTile - 1));
        }
        mbar_arrive(normed + st);
      };
      mbar_wait(q_full, 0);
      int stage = 0, slot_t = 0;
      unsigned phase = 0;
      int kt = next_live(0);
      if (kt < nk) norms(0, 0);
      for (; kt < nk;) {
        const int kn = next_live(kt + 1);
        const int sn = stage + 1 == S ? 0 : stage + 1;
        if (kn < nk) norms(sn, sn == 0 ? phase ^ 1u : phase);
        mbar_wait(ready + stage, phase);
        const bf16* Kst = Ks + stage * kTile * D;
        const bf16* Vst = Vs + stage * kTile * D;
        bf16* ds = Ds + slot_t * R * kAtom;
        // bit i of warp w, lane l: row 16 w + l / 4 (+ 8), column 8 (i / 4)
        // + 2 (l % 4) (+ 1) of the CTA's dS tile
        helper_pairs<NW>(flags + stage * NW * 32, ht, [&](int f, int i) {
          const int q = 16 * (f >> 5) + ((f & 31) >> 2) + 8 * ((i >> 1) & 1);
          const int k = 8 * (i >> 2) + 2 * (f & 3) + (i & 1);
          float ss, dd;
          plain_dots_swz<D, R, kTile>(Qs, Gs, q, Kst, Vst, k, ss, dd);
          ds[tile_at(q, k)] = __float2bfloat16_rn(ds_of(p_of(ss, p.scale, Lq[q]), dd, Dq[q]));
        });
        fence_async_smem();
        mbar_arrive(fixed + stage);
        stage = sn;
        phase = sn == 0 ? phase ^ 1u : phase;
        slot_t = slot_t + 1 == C::kSlots ? 0 : slot_t + 1;
        kt = kn;
      }
    }
  } else {  // ------------------------------------------------- consumers
    reg_alloc<C::kConsumerRegs>();
    const int wt = tid & 127;
    const int m0 = kTile * wg + 16 * (wt >> 5);  // this warp's query rows
    const int fr = lane >> 2, fc = 2 * (lane & 3);
    const int bar_id = 1 + wg;
    const int warp = tid >> 5;
    float2* wres = res + warp * kResumSlots;
    int* wslot = slot + warp * kResumSlots;
    const uint32_t qs_a = smem_addr(Qs), gs_a = smem_addr(Gs);

    // rows m0 + fr (index 0) and m0 + fr + 8 (index 1): LSE and delta
    // (rows past Tq take 1e30 and 0), kept for the re-sums too
    float lse[2], del[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + fr + 8 * r;
      const bool ok = q0 + row < p.Tq;
      const long long i = static_cast<long long>(bh) * p.Tq + q0 + row;
      lse[r] = ok ? p.lse[i] : kLsePad;
      del[r] = ok ? p.delta[i] : 0.f;
      if (fc == 0) {
        Lq[row] = lse[r];
        Dq[row] = del[r];
      }
    }
    float dq[ND][4];
    zero(dq);
    Audit audit;

    mbar_wait(q_full, 0);
    {  // this warpgroup's Q and dO row norms, for the slack
      const int r = kTile * wg + (wt & (kTile - 1));
      if (wt < kTile)
        Qn[r] = row_norm_swz<D, R>(Qs, r);
      else
        Gn[r] = row_norm_swz<D, R>(Gs, r);
    }
    wg_sync(bar_id);
    const float qn[2] = {Qn[m0 + fr], Qn[m0 + fr + 8]};
    const float gn[2] = {Gn[m0 + fr], Gn[m0 + fr + 8]};

    int stage = 0, slot_t = 0;
    unsigned phase = 0;
    Pending last;  // the tile before this one
    for (int kt = next_live(0); kt < nk; kt = next_live(kt + 1)) {
      mbar_wait(full + stage, phase);
      const int k0 = kt * kTile;
      const bool mine = live_for(k0, wg);
      unsigned flag = 0u;
      if (mine) {
        const bf16* Kst = Ks + stage * kTile * D;
        const bf16* Vst = Vs + stage * kTile * D;
        const uint32_t kst = smem_addr(Kst), vst = smem_addr(Vst);
        const float* kn = Kn + stage * kTile;
        const float* vn = Vn + stage * kTile;
        const bool full_tile = mk.tile_full(q0 + kTile * wg, k0);

        // S = Q_wg . K^T and dP = dO_wg . V^T: 64 queries x 64 keys
        float s[J][4], dp[J][4];
        zero(s);
        zero(dp);
        pin(s);
        pin(dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // this warpgroup's query rows
          wgmma_ss<kTile>(s, RB::k_major(qs_a, R, kTile * wg, kk), RB::k_major(kst, kTile, 0, kk));
          wgmma_ss<kTile>(dp, RB::k_major(gs_a, R, kTile * wg, kk), RB::k_major(vst, kTile, 0, kk));
        }
        wg_commit();
        mbar_wait(normed + stage, phase);  // the stage's K and V norms
        wg_wait_all();
        pin(s);
        pin(dp);

        // dS in place of dP; flag holds the pairs whose rounding the plain
        // version's sums might decide otherwise, left to the helpers up to
        // kQueued a warp and the rest summed again here (the audit: every
        // live pair summed again here, and none left)
        const int qrow = q0 + m0 + fr;
        unsigned live;
        flag = full_tile ? ds_tile<true, D>(s, dp, lse, del, qn, gn, kn + fc, vn + fc, mk, qrow,
                                            k0 + fc, p.scale, live)
                         : ds_tile<false, D>(s, dp, lse, del, qn, gn, kn + fc, vn + fc, mk, qrow,
                                             k0 + fc, p.scale, live);
        if constexpr (kAudit) {
          resum_spread<D, R, kTile, false, true>(live, flag, s, dp, Qs, Gs, Kst, Vst, Lq, Dq, m0,
                                                 0, p.scale, wslot, wres, lane, audit);
          flag = 0u;
        } else {
          const unsigned rest = split_flagged(flag, kQueued, lane);
          resum_spread<D, R, kTile, false, false>(rest, 0u, s, dp, Qs, Gs, Kst, Vst, Lq, Dq, m0,
                                                  0, p.scale, wslot, wres, lane, audit);
        }
        store_tile(Ds + slot_t * R * kAtom, dp, m0, 0, lane);
        fence_async_smem();
      }
      flags[(stage * NW + warp) * 32 + lane] = flag;
      mbar_arrive(ready + stage);

      // the last tile's dQ += dS . K (ds in k's dtype) with the helpers'
      // roundings, contracted over its keys, waited for; then its stage is
      // released
      if (last.stage >= 0) {
        if (last.mine) dq_product<D, R>(dq, last, fixed, Ds, Ks, wg);
        wg_wait_all();
        mbar_arrive(empty + last.stage);
      }
      last = Pending{stage, phase, slot_t, mine, (min(kTile, p.Tk - k0) + 15) / 16};
      slot_t = slot_t + 1 == C::kSlots ? 0 : slot_t + 1;
      if (++stage == S) {
        stage = 0;
        phase ^= 1u;
      }
    }
    if (last.stage >= 0) {
      if (last.mine) dq_product<D, R>(dq, last, fixed, Ds, Ks, wg);
      wg_wait_all();
      mbar_arrive(empty + last.stage);
    }
    pin(dq);

    bf16* qb = static_cast<bf16*>(p.dq.p) + static_cast<long long>(b) * p.dq.sb +
               static_cast<long long>(h) * p.dq.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + fr + 8 * r;
      if (q0 + row >= p.Tq) continue;
      bf16* qrow = qb + static_cast<long long>(q0 + row) * p.dq.st;
#pragma unroll
      for (int n = 0; n < ND; ++n)  // dQ is scaled once, here
        *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * n + fc) =
            __floats2bfloat162_rn(p.scale * dq[n][2 * r], p.scale * dq[n][2 * r + 1]);
    }
    if constexpr (kAudit) audit.flush(p.audit);
  }
}

// ------------------------------------------------------ B1 bf16, Hopper
//
// A work tile is (b, head, 128 queries); the grid walks the heaviest
// causal tiles first.  The producer warpgroup's first thread loads a work
// tile's Q rows once by TMA, then streams the K and V tiles that meet the
// band into a ring of kFwdStages stages (full / empty mbarriers); its other
// threads leave.  Each consumer warpgroup owns 64 queries: S = Q.K^T by
// wgmma from shared memory (64 keys), then the scale, the mask (only on
// tiles that are not fully live) and the online softmax on the accumulator
// registers, p rounded to bf16 into register A fragments (the
// accumulator's m16n8 C layout is the m16k16 A layout), and O += P.V by
// wgmma with A from registers and V read MN-major; the stage is released
// once P.V is formed.  A warpgroup whose rows do not meet a tile skips its
// products and still releases the stage.  The sums stay in registers, in a
// fixed order, with no atomics: two calls give the same bits.  With a
// persistent grid (kFwdPersist) a CTA stays on its SM and walks
// several work tiles; the producer loads the next tile's Q as soon as
// every S of the last one is formed (q_empty), so its loads overlap the
// last tile's softmax, P.V and stores.

struct FwdMaps {
  RowMaps q, k, v;
};

// which head dims bf16 B1 runs on the Hopper kernel (the others on
// flash_fwd_tc_kernel)
template <int D>
constexpr bool kHopperFwd = D == 64 || D == 80 || D == 128;

// ring stages of K and V tiles
constexpr int kFwdStages = 4;

// which head dims run B1 on a persistent grid (one CTA an SM): faster at
// 64 and 80, slower at 128 on an H100 (PERF.md §6)
template <int D>
constexpr bool kFwdPersist = D != 128;

template <int D>
__host__ __device__ constexpr size_t fwd_wg_smem_bytes() {
  // Q; K and V a stage; the barriers
  return 1024 + 2 * kTile * D * 2 + kFwdStages * 2 * kTile * D * 2 + 8 * (2 * kFwdStages + 2);
}

// 2^x (ex2.approx, flushing denormals): one MUFU op
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// B1's online softmax on a warp's 16 x 64 slice of a wgmma score tile s of
// raw q . k (rows fr and fr + 8 of this thread, keys 8j + fc (+1); q and
// k the positions of its first row and key): the mask (kFull: the tile is
// fully live, no mask), the new row max m of scale s, p = exp(scale s - m)
// in place of s as one FMA and an ex2, the row sums l (of p unrounded),
// and corr, the factor the sums so far take.  A row with nothing live
// keeps m = kNegInf and p = 0.
template <bool kFull>
__device__ __forceinline__ void softmax_wg(float (&s)[8][4], float (&m_run)[2], float (&l_run)[2],
                                           float (&corr)[2], const Mask& mk, int q, int k,
                                           float scale) {
  constexpr float kLog2e = 1.4426950408889634f;
  unsigned live = ~0u;  // one bit per element
  if (!kFull) {
    live = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        live |= mk.allowed(q + 8 * (e >> 1), k + 8 * j + (e & 1)) ? 1u << (4 * j + e) : 0u;
  }
  const float sl = scale * kLog2e;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e)
        mx = fmaxf(mx, kFull || (live >> (4 * j + e)) & 1u ? s[j][e] : kNegInf);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx == kNegInf ? kNegInf : scale * mx);
    const float mb = m_new * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = kFull || (live >> (4 * j + e)) & 1u ? ex2(fmaf(s[j][e], sl, -mb)) : 0.f;
        sum += s[j][e];  // l takes p unrounded
      }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    corr[r] = ex2((m_run[r] - m_new) * kLog2e);
    l_run[r] = l_run[r] * corr[r] + sum;
    m_run[r] = m_new;
  }
}

template <int D>
__global__ void __launch_bounds__(WgCfg<D>::kThreads, WgCfg<D>::kMinBlocks)
    flash_fwd_wg_kernel(const __grid_constant__ Params p, const __grid_constant__ FwdMaps m) {
  using C = WgCfg<D>;
  using RB = RowBoxes<D>;
  constexpr int NWG = C::kNwg, S = kFwdStages;
  constexpr int R = kTile * NWG;             // query rows of a work tile
  constexpr int kTileBytes = kTile * D * 2;  // a K or V tile
  constexpr int J = kTile / 8;               // a score tile's n-tiles
  constexpr int ND = D / 8;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* sm = align1024(wg_smem);
  unsigned char* Qs = sm;              // [R rows]
  unsigned char* KV = Qs + R * D * 2;  // [S][K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(KV + S * 2 * kTileBytes);  // [S] K, V landed
  uint64_t* empty = full + S;      // [S] the stage is free
  uint64_t* q_full = empty + S;    // the work tile's Q rows landed
  uint64_t* q_empty = q_full + 1;  // every S product of the work tile is formed

  const int tid = threadIdx.x;
  // warp-uniform as far as the compiler can tell (a broadcast): ptxas
  // serialises every wgmma of a kernel where one sits in a path it cannot
  // prove uniform (C7520), and a test of wg guards each product here
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), lane = tid & 31;
  // work tiles t = blockIdx.x, + gridDim.x, ... (one a CTA unless the grid
  // is persistent): query block nq - 1 - t / (B H), the heaviest causal
  // blocks first, of (b, h) = t % (B H)
  const int nbh = p.B * p.H, nq = (p.Tq + R - 1) / R, ntiles = nbh * nq;
  int bh = 0, q0 = 0, b = 0, h = 0, hk = 0;
  auto take = [&](int t) {
    bh = t % nbh;
    q0 = (nq - 1 - t / nbh) * R;
    b = bh / p.H;
    h = bh - b * p.H;
    hk = h / (p.H / p.Hkv);  // the GQA map
  };
  const Mask mk = make_mask(p);
  const int nk = (p.Tk + kTile - 1) / kTile;
  // does warpgroup w's query tile meet the key tile at k0?
  auto live_for = [&](int k0, int w) {
    return q0 + kTile * w < p.Tq && mk.tile_live(q0 + kTile * w, k0);
  };
  auto next_live = [&](int kt) {
    for (; kt < nk; ++kt) {
      bool live = false;
#pragma unroll
      for (int w = 0; w < NWG; ++w) live = live || live_for(kt * kTile, w);
      if (live) break;
    }
    return kt;
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * NWG);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 128 * NWG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {  // ------------------------------------------ producer
    reg_dealloc<C::kProducerRegs>();
    if (tid != 128 * NWG) return;  // one thread issues the loads
    int stage = 0;
    unsigned phase = 0, qph = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, qph ^= 1u) {
      take(t);
      mbar_wait(q_empty, qph ^ 1u);  // the last work tile's S products are formed
      mbar_expect_tx(q_full, R * D * 2);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
        RB::load(Qs, R, kTile * w, &m.q.wide, &m.q.tail, q_full, q0 + kTile * w, h, b);
      for (int kt = next_live(0); kt < nk; kt = next_live(kt + 1)) {
        mbar_wait(empty + stage, phase ^ 1u);
        mbar_expect_tx(full + stage, 2 * kTileBytes);
        unsigned char* kst = KV + stage * 2 * kTileBytes;
        RB::load(kst, kTile, 0, &m.k.wide, &m.k.tail, full + stage, kt * kTile, hk, b);
        RB::load(kst + kTileBytes, kTile, 0, &m.v.wide, &m.v.tail, full + stage, kt * kTile, hk,
                 b);
        if (++stage == S) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }
  // ------------------------------------------------------------ consumers
  reg_alloc<C::kConsumerRegs>();
  const int m0 = 16 * ((tid & 127) >> 5);  // this warp's rows in its warpgroup's 64
  const int fr = lane >> 2, fc = 2 * (lane & 3);
  const uint32_t qs = smem_addr(Qs), kv = smem_addr(KV);
  int qw = 0;  // this warpgroup's first query in the work tile

  // O of rows qw + m0 + fr (index 0) and + 8 (index 1), features 8n + fc
  // (+1); their running max (of scale s) and sum; p in bf16 as the A
  // fragments of keys 16c .. 16c + 15
  float o[ND][4];
  float m_run[2], l_run[2];
  uint32_t pa[kTile / 16][4];

  // S = Q_wg . K^T of the stage at kst: issued, not committed
  auto product_s = [&](float (&s)[J][4], uint32_t kst) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kTile>(s, RB::k_major(qs, R, kTile * wg, kk), RB::k_major(kst, kTile, 0, kk));
  };
  // O += P . V of the V tile at vst: issued, not committed
  auto product_pv = [&](uint32_t vst) {
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) {
      wgmma_rs_t<kAtom * RB::kWide>(o, pa[c], RB::mn_wide(vst, kTile, c));
      if constexpr (RB::kTail > 0)
        wgmma_rs_t<RB::kTail>(o + 8 * RB::kWide, pa[c], RB::mn_tail(vst, kTile, c));
    }
  };
  // the softmax of this warpgroup's score tile of the keys at k0; then,
  // once O is free, O takes corr and p becomes the A fragments
  auto softmax = [&](float (&s)[J][4], int k0, float (&corr)[2]) {
    const int qrow = qw + m0 + fr, kcol = k0 + fc;
    if (mk.tile_full(qw, k0))
      softmax_wg<true>(s, m_run, l_run, corr, mk, qrow, kcol, p.scale);
    else
      softmax_wg<false>(s, m_run, l_run, corr, mk, qrow, kcol, p.scale);
  };
  auto rescale_to_a = [&](float (&s)[J][4], const float (&corr)[2]) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int c = 0; c < kTile / 16; ++c) c_to_a(pa[c], s[2 * c], s[2 * c + 1]);
  };
  int stage = 0;
  unsigned phase = 0, qph = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, qph ^= 1u) {
    take(t);
    qw = q0 + kTile * wg;
    zero(o);
    m_run[0] = m_run[1] = kNegInf;
    l_run[0] = l_run[1] = 0.f;
    mbar_wait(q_full, qph);
    for (int kt = next_live(0); kt < nk;) {
      const int kn = next_live(kt + 1);
      mbar_wait(full + stage, phase);
      const int k0 = kt * kTile;
      const bool mine = live_for(k0, wg);
      const uint32_t kst = kv + stage * 2 * kTileBytes;
      float s[J][4], corr[2];
      zero(s);
      pin(s);
      wg_fence();
      if (mine) product_s(s, kst);
      wg_commit();
      wg_wait<0>();
      pin(s);
      if (mine) {
        softmax(s, k0, corr);
        rescale_to_a(s, corr);
      }
      pin(o);
      wg_fence();
      if (mine) product_pv(kst + kTileBytes);
      wg_commit();
      wg_wait<0>();
      pin(o);
      mbar_arrive(empty + stage);
      if (++stage == S) {
        stage = 0;
        phase ^= 1u;
      }
      kt = kn;
    }
    mbar_arrive(q_empty);  // this warpgroup's S products are formed

    // O = acc / max(l, 1e-30) in bf16 through O's strides, LSE = m +
    // log(max(l, 1e-30)); rows past Tq are not written
    bf16* ob = static_cast<bf16*>(p.o.p) + static_cast<long long>(b) * p.o.sb +
               static_cast<long long>(h) * p.o.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = qw + m0 + fr + 8 * r;
      if (qp >= p.Tq) continue;
      const float l = fmaxf(l_run[r], 1e-30f), inv = __frcp_rn(l);
      bf16* orow = ob + static_cast<long long>(qp) * p.o.st;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + fc) =
            __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      if (fc == 0) p.lse[static_cast<long long>(bh) * p.Tq + qp] = m_run[r] + logf(l);
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                          cudaStream_t stream, const Args&... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (the library does not link libcuda), or null.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 13000
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// The TMA descriptor of a [B, T, H, D] bf16 view read through its strides
// (elements, D contiguous): dims (D, T, H, B), 64 x 64 boxes, the 128-byte
// swizzle, rows past T read as zeros.  A dim of extent 1 takes a stride of
// 128 bytes (its coordinate is always 0).  The wrapper's tma_geometry
// (ops/flash_attention.py) is this map, and refuses what it cannot take
// before a launch; here a misaligned view is cudaErrorMisalignedAddress.
cudaError_t encode_view(CUtensorMap* map, const View& x, int B, int T, int H, int D,
                        int cols = kAtom, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const long long es = sizeof(bf16);
  const long long st = T == 1 ? 128 : x.st * es;
  const long long sh = H == 1 ? 128 : x.sh * es;
  const long long sb = B == 1 ? 128 : x.sb * es;
  if (reinterpret_cast<uintptr_t>(x.p) % 16 != 0 || st <= 0 || sh <= 0 || sb <= 0 ||
      st % 16 != 0 || sh % 16 != 0 || sb % 16 != 0)
    return cudaErrorMisalignedAddress;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st), static_cast<cuuint64_t>(sh),
                                 static_cast<cuuint64_t>(sb)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), kTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x.p, dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The descriptors of a view's row boxes (RowBoxes): 64-feature boxes with
// the 128-byte swizzle and, at D = 80, the 16-feature box at column 64
// with the 32-byte swizzle.
template <int D>
cudaError_t encode_rows(RowMaps* m, const View& x, int B, int T, int H) {
  const cudaError_t e = encode_view(&m->wide, x, B, T, H, D);
  if (e != cudaSuccess || RowBoxes<D>::kTail == 0) return e;
  return encode_view(&m->tail, x, B, T, H, D, RowBoxes<D>::kTail, CU_TENSOR_MAP_SWIZZLE_32B);
}

// B1 on the Hopper kernel: q, k and v's descriptors, then the launch: a
// CTA a work tile, or (kFwdPersist) one an SM.
template <int D>
cudaError_t run_fwd_wg(const Params& p, cudaStream_t stream) {
  FwdMaps m;
  cudaError_t e;
  if ((e = encode_rows<D>(&m.q, p.q, p.B, p.Tq, p.H)) != cudaSuccess ||
      (e = encode_rows<D>(&m.k, p.k, p.B, p.Tk, p.Hkv)) != cudaSuccess ||
      (e = encode_rows<D>(&m.v, p.v, p.B, p.Tk, p.Hkv)) != cudaSuccess)
    return e;
  constexpr int R = kTile * WgCfg<D>::kNwg;
  long long grid = static_cast<long long>(p.B) * p.H * ((p.Tq + R - 1) / R);
  if (kFwdPersist<D>) {
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    grid = std::min(grid, static_cast<long long>(sms));
  }
  return launch_kernel(flash_fwd_wg_kernel<D>, dim3(static_cast<unsigned>(grid)),
                       WgCfg<D>::kThreads, fwd_wg_smem_bytes<D>(), stream, p, m);
}

// B2 (which == kDq) or B3 on the Hopper kernels: q, k, v and dO's TMA
// descriptors, then the launch.
template <int D>
cudaError_t run_bwd_wg(int which, const Params& p, cudaStream_t stream) {
  TmaMaps m;
  cudaError_t e;
  if ((e = encode_rows<D>(&m.q, p.q, p.B, p.Tq, p.H)) != cudaSuccess ||
      (e = encode_rows<D>(&m.k, p.k, p.B, p.Tk, p.Hkv)) != cudaSuccess ||
      (e = encode_rows<D>(&m.v, p.v, p.B, p.Tk, p.Hkv)) != cudaSuccess ||
      (e = encode_rows<D>(&m.g, p.dout, p.B, p.Tq, p.H)) != cudaSuccess)
    return e;
  const bool audit = p.audit != nullptr;
  if (which == kDq) {
    using C = WgCfg<D>;
    constexpr int R = kTile * C::kNwg;
    return launch_kernel(audit ? flash_bwd_dq_wg_kernel<D, true> : flash_bwd_dq_wg_kernel<D, false>,
                         dim3(p.B * p.H, (p.Tq + R - 1) / R), C::kThreads, dq_wg_smem_bytes<D>(),
                         stream, p, m);
  }
  using C = WgCfg<D>;
  constexpr int R = kTile * C::kNwg;
  return launch_kernel(audit ? flash_bwd_dkv_wg_kernel<D, true> : flash_bwd_dkv_wg_kernel<D, false>,
                       dim3(p.B * p.Hkv, (p.Tk + R - 1) / R), C::kThreads, dkv_wg_smem_bytes<D>(),
                       stream, p, m);
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
    if (which == kFwd) {
      // B1: the Hopper kernel at D = 64, 80 and 128, mma.sync at 32
      // (kHopperFwd)
      if (audit) return cudaErrorInvalidValue;
      if constexpr (kHopperFwd<D>)
        return run_fwd_wg<D>(p, stream);
      else
        return launch_kernel(flash_fwd_tc_kernel<D>, dim3(bh, nq), kTcThreads,
                             fwd_tc_smem_bytes<D>(), stream, p);
    }
    if (which != kDq && which != kDkv) return cudaErrorInvalidValue;
    // B2 and B3: the Hopper kernels at D = 64, 80 and 128, the mma.sync
    // ones at D = 32 (kHopperBwd)
    if constexpr (kHopperBwd<D>) {
      return run_bwd_wg<D>(which, p, stream);
    } else {
      if (which == kDq)
        return launch_kernel(audit ? flash_bwd_dq_tc_kernel<D, true>
                                   : flash_bwd_dq_tc_kernel<D, false>,
                             dim3(bh, nq), kTcThreads, dq_tc_smem_bytes<D>(), stream, p);
      return launch_kernel(audit ? flash_bwd_dkv_tc_kernel<D, true>
                                 : flash_bwd_dkv_tc_kernel<D, false>,
                           dim3(bhk, nk), kTcThreads, dkv_tc_smem_bytes<D>(), stream, p);
    }
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

// The design a kernel runs (Design in ops/flash_attention.py): 0 SIMT (f32),
// 1 mma.sync (bf16 B1 outside kHopperFwd, bf16 B2/B3 outside kHopperBwd), 2
// wgmma + TMA, warp-specialised (bf16 B1, B2 and B3 at D = 64, 80 and
// 128).
template <int D>
int design_of(int which, int dtype) {
  if (dtype == kF32) return 0;
  return (which == kFwd ? kHopperFwd<D> : kHopperBwd<D>) ? 2 : 1;
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

// Which design ``which`` runs for (dtype, D): 0 SIMT, 1 mma.sync, 2 wgmma
// + TMA, warp-specialised; -1 where the kernels do not take it.
extern "C" int flash_attention_design(int which, int dtype, int D) {
  if (which < kFwd || which > kDkv || (dtype != kF32 && dtype != kBF16)) return -1;
  switch (D) {
    case 32: return design_of<32>(which, dtype);
    case 64: return design_of<64>(which, dtype);
    case 80: return design_of<80>(which, dtype);
    case 128: return design_of<128>(which, dtype);
    default: return -1;
  }
}

// cudaGetErrorString for the wrapper's error message.
extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
