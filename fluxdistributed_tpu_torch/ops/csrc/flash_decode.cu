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
// Any block size bs >= 1 works.
//
// Bound.  Decode is memory-bound: each step reads the live K/V rows (and
// their scales) once and does 4 * rows * H * D flops on them, about one
// flop a byte at G = 1, far below the card's ~295 flops/byte balance
// point, so no tensor core is used.  The least time is the live K/V bytes
// over the HBM rate.  At the serving shapes a call moves a few MB, so what
// sets its time is latency: the launch, the dependent loads before the
// first K/V byte is asked for, the round trip of those bytes, and the
// merge of the split partials.
//
// Design.  Both forms are split-KV: the S CTAs of one (slot, KV head)
// each take one run of its rows and compute that run's f32 partial
// softmax state (m, l, acc[G, D]), and the partials are merged in split
// order.  S is chosen on the host from the row (or page) count and the SM
// count (about four CTAs an SM at lm_small) and is at most kMaxSplits.
// The design has three parts:
//
// * One launch a call.  The S CTAs of a (slot, KV head) form a thread
//   block cluster of dims (1, S, 1) (cudaLaunchKernelEx with the cluster
//   dimension, S being a run-time count).  CTA rank r of cluster x takes
//   run (r + x) % S: a slot's first runs hold most of its rows (its later
//   ones are short or empty), and the card appears to place a cluster's
//   CTAs on SMs by rank: rotating the runs spreads the long ones over the
//   SMs (the paged forms were 5-14 % slower unrotated at lm_small on an
//   H100).
//   The G * D outputs of the (slot, KV head) are cut into S slices, one a
//   rank.  Each CTA merges its warps' states into its partial output by
//   output, in registers, and stores each output's (m, l, acc) by
//   st.async into the shared memory of the CTA whose slice holds it,
//   completing on that CTA's merge mbarrier; each CTA waits for its slice
//   from all S runs and merges it in run order with each op rounded once,
//   as the plain split-and-merge versions (ops/flash_decode.py) compute
//   it.  No CTA reads a peer's shared memory or waits for a peer to
//   leave, and the only cluster barrier is the one a CTA arrives on at
//   its start (its merge mbarrier initialised) and waits on before its
//   first store.  No workspace, no second kernel.
// * K/V through the copy engine, the run in flight at once.  A tile's
//   K and V rows move global -> shared by tensor copies
//   (cp.async.bulk.tensor, TMA) completing on the tile's stage mbarrier
//   (expect_tx): in the dense form one box (D, 1, T) a tile over the cache
//   viewed as (D, Hkv, B * R), in the paged form one box a page's piece
//   of the tile over the pool viewed as (D, Hkv, NB * bs), both maps
//   encoded on the host for each launch and prefetched into the copy
//   engine when a CTA starts.  (At lm_small's shapes on an H100, one
//   cp.async.bulk a row, with no map, was 9-40 % slower, and the paged
//   bf16, f32 and int8 rows by 16-byte cp.async 4-12 % slower.)  A CTA
//   issues every tile of its run before its first wait when the run
//   fits its stages (the launcher, plan_stages, sizes the ring to the
//   longest run, up to kMaxStages and what lets every CTA be resident
//   at once); a longer run cycles the ring.  The int8/fp8 scales (4 bytes a
//   row, below a copy's 16) move by cp.async and arrive on the same
//   mbarrier (cp.async.mbarrier.arrive.noinc).  A tile (a paged box) with
//   no allowed row (out of band, unwritten, past the cursor, on unbound
//   pages) is skipped before any of its bytes are read; the dead rows a
//   live box brings add nothing to P.V.
// * State in registers.  Each warp owns a quarter of a tile's rows and
//   keeps its online softmax state (m, l, and the acc features its lanes
//   own) in registers across the run.  The template argument kHeads,
//   chosen on the host from G = H / Hkv, sizes that state: 1 (G = 1, no
//   GQA: the fewest registers, so that five or more CTAs fit an SM), 4
//   (G <= 4 at D <= 128: at most 128 registers, no spill), or 0 for the
//   rest, whose warps keep their state in shared memory.  The CTA merges
//   its four warps' states in warp order into its partial.
//
// The dense form runs flash_decode_kernel, the paged form
// flash_decode_paged_kernel: one template for both changed the dense
// code's register allocation and slowed it by ~30 % in the decode step,
// so they share only the helpers and the merge.
//
// The launchers run on the caller's stream, allocate nothing, and
// return a cudaError_t (0 on success).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPairs = 4;    // feature pairs a lane owns in P.V: D <= 256
constexpr int kRegHeads = 4;    // the most query heads kept in registers (kHeads)
constexpr int kRegHeadsD = 128; // the largest D whose state kHeads = 4 keeps in registers
constexpr int kMaxSplits = 16;  // the largest cluster (non-portable size)
constexpr int kMaxStages = 8;   // K/V tiles a CTA keeps in flight at most
constexpr int kBarBytes = 128;  // the mbarriers (tensor copies land 128-byte aligned)
// CTAs an SM the registers must allow (at most 128 registers a thread:
// the f32 and kHeads = 4 forms reach it; the kHeads = 1 forms take 48-96)
constexpr int kMinBlocks = 4;
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

// Rows of a paged box: the largest power of two dividing bs, at most t
// (tile_rows).  A tile's rows then fall in whole boxes, each inside one
// page: 16 at the serving layout's 16-row blocks.
__host__ __device__ inline int page_box(int bs, int t) {
  int pb = 1;
  while (pb < t && bs % (2 * pb) == 0) pb *= 2;
  return pb;
}

// Where a tile's rows sit in a stage: boxes of pb rows of `row` bytes,
// each box 128-byte aligned (where a tensor copy lands it), so row r is
// at (r / pb) * box_stride + (r % pb) * row; rows are contiguous unless a
// box is shorter than 128 bytes or not a multiple of them.
struct Rows {
  int pb, row, box_stride, shift;
  bool dense;  // rows contiguous: box_stride == pb * row
  __host__ __device__ Rows(int pb_, int row_)
      : pb(pb_), row(row_), box_stride((pb_ * row_ + 127) / 128 * 128), shift(0),
        dense(box_stride == pb_ * row_) {
    while ((1 << shift) < pb) ++shift;  // pb is a power of two
  }
  __host__ __device__ int offset(int r) const {
    return dense ? r * row : (r >> shift) * box_stride + (r & (pb - 1)) * row;
  }
  __host__ __device__ int stage(int t) const { return (t / pb) * box_stride; }  // t rows
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------- async copies

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` more of bulk-copy traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` more of bulk-copy traffic expected, with no arrival
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// one plain arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Has the phase of parity `parity` completed?  kCluster: with acquire at
// cluster scope (the peers' st.async stores land before it completes).
template <bool kCluster>
__device__ __forceinline__ uint32_t mbar_done(uint32_t a, unsigned parity) {
  uint32_t done;
  if constexpr (kCluster) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } else {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
  return done;
}

// Wait for the phase of parity `parity` to complete.  A wait that outlasts
// ~10 s of device clock traps: a lost copy ends the launch with an error
// rather than hanging the card.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  if (mbar_done<kCluster>(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_done<kCluster>(a, parity)) {
    if (clock64() - t0 > 20000000000ll) __trap();
  }
}

// Start fetching a tensor map into the copy engine's descriptor cache, so
// that the first copy does not wait for it.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box at (feature c, KV head h, cache row `row`) of a K/V map (see
// encode_kv) global -> this CTA's shared memory (128-byte aligned) by the
// copy engine, completing on `bar`; rows past the tensor arrive as zeros.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c, int h, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c), "r"(h), "r"(row)
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// an arrival on `bar` once this thread's cp.async copies so far have landed
// (counted in the barrier's init count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// generic-proxy accesses of shared memory ordered before the copy
// engine's next writes to it
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------- the cluster

// the address of `p` in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// 16 bytes into a peer's shared memory (`addr`, from peer_addr), counted
// on the peer's mbarrier `bar` (also from peer_addr) as they land
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b, float c, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(0.f), "r"(bar)
      : "memory");
}

// ---------------------------------------------------- stored values

// Stored K/V values widened to f32 with as few instructions as the
// scores allow (decode runs on the SMs' issue rate once its bytes are
// in): bf16 by a shift, int8 by a byte permute into a float's mantissa
// and one subtraction, fp8 e4m3 by moving its bits into a float's and
// one multiplication; each widening is exact.  dot16 adds the products
// of one 16-byte chunk with the matching q values (read as float4) to
// `acc` in feature order; load2 widens the 2 values at p.
__device__ __forceinline__ float4 ld4(const float* q, int i) {
  return reinterpret_cast<const float4*>(q)[i];
}

// the int8 in byte k of w (already xor-ed with 0x80808080): 2^23 + 128 +
// v as a float, less 2^23 + 128
__device__ __forceinline__ float i8_at(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650u | k)) - 8388736.f;
}

// the e4m3 in the low byte of b: its sign, exponent and mantissa moved
// to a float's top bits (a value 2^-120 of it, subnormals included),
// scaled back
__device__ __forceinline__ float e4m3_at(uint32_t b) {
  return __uint_as_float(((b & 0x80u) << 24) | ((b & 0x7Fu) << 20)) * 0x1p120f;
}

template <typename T>
struct Widen;

template <>
struct Widen<float> {
  static constexpr int kVals = 4;
  __device__ static float dot16(const unsigned char* p, const float* q, float acc) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = ld4(q, 0);
    acc = fmaf(b.x, a.x, acc);
    acc = fmaf(b.y, a.y, acc);
    acc = fmaf(b.z, a.z, acc);
    return fmaf(b.w, a.w, acc);
  }
  __device__ static float2 load2(const unsigned char* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <>
struct Widen<__nv_bfloat16> {
  static constexpr int kVals = 8;
  __device__ static float dot16(const unsigned char* p, const float* q, float acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float4 b = ld4(q, i);
      acc = fmaf(b.x, __uint_as_float(w[2 * i] << 16), acc);
      acc = fmaf(b.y, __uint_as_float(w[2 * i] & 0xFFFF0000u), acc);
      acc = fmaf(b.z, __uint_as_float(w[2 * i + 1] << 16), acc);
      acc = fmaf(b.w, __uint_as_float(w[2 * i + 1] & 0xFFFF0000u), acc);
    }
    return acc;
  }
  __device__ static float2 load2(const unsigned char* p) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
  }
};

template <>
struct Widen<int8_t> {
  static constexpr int kVals = 16;
  __device__ static float dot16(const unsigned char* p, const float* q, float acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                           raw.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 b = ld4(q, i);
      acc = fmaf(b.x, i8_at(w[i], 0), acc);
      acc = fmaf(b.y, i8_at(w[i], 1), acc);
      acc = fmaf(b.z, i8_at(w[i], 2), acc);
      acc = fmaf(b.w, i8_at(w[i], 3), acc);
    }
    return acc;
  }
  __device__ static float2 load2(const unsigned char* p) {
    const uint32_t w = *reinterpret_cast<const unsigned short*>(p) ^ 0x8080u;
    return make_float2(i8_at(w, 0), i8_at(w, 1));
  }
};

template <>
struct Widen<__nv_fp8_e4m3> {
  static constexpr int kVals = 16;
  __device__ static float dot16(const unsigned char* p, const float* q, float acc) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 b = ld4(q, i);
      acc = fmaf(b.x, e4m3_at(w[i]), acc);
      acc = fmaf(b.y, e4m3_at(w[i] >> 8), acc);
      acc = fmaf(b.z, e4m3_at(w[i] >> 16), acc);
      acc = fmaf(b.w, e4m3_at(w[i] >> 24), acc);
    }
    return acc;
  }
  __device__ static float2 load2(const unsigned char* p) {
    const uint32_t w = *reinterpret_cast<const unsigned short*>(p);
    return make_float2(e4m3_at(w), e4m3_at(w >> 8));
  }
};

// ---------------------------------------------------- shared memory

// The G * D outputs of a (slot, KV head) are merged in S slices of
// `per` outputs, CTA s taking slice s.
__host__ __device__ inline int merge_slice(int outputs, int splits) {
  return (outputs + splits - 1) / splits;
}

// Byte offsets of a CTA's shared memory, on the host (the launch's size)
// and the device alike.  The mbarriers come first (the stages', then the
// merge's), then K [NST][T] and V [NST][T] rows as the tensor copies land
// them; then each warp's (m, l, acc), which with the state in registers
// reuses the K/V stages (free by then) and with it in shared memory
// (kHeads = 0) lives beside them for the whole run; then the merge's
// receive buffer [S][per] of (m, l, acc, 0), written by the peers while
// this CTA may still be computing.
struct Layout {
  uint32_t k, v, mw, lw, acc, recv, ksc, vsc, q, allow, sp, pid, total;
};

__host__ __device__ inline Layout make_layout(int g, int d, int es, int nst, bool quant,
                                              bool smem_state, bool windowed, int splits,
                                              int pps, int pb) {
  Layout L;
  const uint32_t t = tile_rows(d);
  const uint32_t stage = Rows(pb, d * es).stage(t);
  L.k = kBarBytes;
  L.v = L.k + nst * stage;
  const uint32_t kv_end = L.v + nst * stage;
  L.mw = smem_state ? kv_end : kBarBytes;
  L.lw = L.mw + kWarps * g * 4;
  L.acc = L.lw + kWarps * g * 4;
  uint32_t o = L.acc + kWarps * g * d * 4;
  o = o > kv_end ? o : kv_end;
  o = (o + 15) & ~15u;
  L.recv = o;
  o += splits * merge_slice(g * d, splits) * 16;
  L.ksc = o;
  o += quant ? nst * t * 4 : 0;
  L.vsc = o;
  o += quant ? nst * t * 4 : 0;
  o = (o + 15) & ~15u;  // q is read as float4
  L.q = o;
  o += g * d * 4;
  L.allow = o;  // the stages' row flags (paged, and the dense ring)
  o += windowed || pps > 0 ? nst * t * 4 : 0;
  L.sp = o;  // ring: the first stages' slot_pos
  o += windowed ? nst * t * 4 : 0;
  L.pid = o;  // paged: the run's page ids
  o += pps * 4;
  L.total = o;
  return L;
}

// ---------------------------------------------------- shared helpers

// Everything a kernel needs besides its template arguments.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* page_table;
  const int32_t* idx;
  const int32_t* slot_pos;
  const float* k_scale;
  const float* v_scale;
  void* out;
  int R, P, bs, NB, H, Hkv, D, window, sinks, pps, stages;
  float scale;
};

__device__ __forceinline__ int ring_allows(int sp, int cursor, int window, int sinks) {
  return sp >= 0 && sp <= cursor && (sp > cursor - window || sp < sinks);
}

// One query head's step over one tile: the score of this lane's row
// (TPR lanes take its 16-byte chunks in turn), this warp's online softmax
// update over its RW rows, and acc = acc * corr + P . V over the warp's
// live rows (bit j * TPR of `live`; a dead row adds an exact 0), this lane
// owning features 2 lane + 64 c (+1).
template <typename TKV, bool kQuant, int kPairs>
__device__ __forceinline__ void head_step(const float* qg, const unsigned char* krow,
                                          const unsigned char* vstage, const Rows& rows,
                                          int D, int RW, int TPR, int part_id, int lane, int ok,
                                          unsigned live, float ks, float vs, float& m, float& l,
                                          float (&a)[kPairs][2]) {
  constexpr int kEs = sizeof(TKV);
  constexpr int kV = Widen<TKV>::kVals;
  const int chunks = D * kEs / 16;
  float dot = 0.f;
#pragma unroll 4
  for (int c = part_id; c < chunks; c += TPR) {
    dot = Widen<TKV>::dot16(krow + c * 16, qg + c * kV, dot);
  }
  for (int o = 1; o < TPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
  const float s = kQuant ? dot * ks : dot;
  const float m_new = fmaxf(m, warp_max(ok ? s : kNegInf));
  // masked rows are zeroed by the select: while nothing is allowed, m_new
  // is still kNegInf and exp(s - m_new) would be 1
  const float p = ok ? expf(s - m_new) : 0.f;
  const float sum = warp_sum(part_id == 0 ? p : 0.f);
  const float corr = expf(m - m_new);
  l = l * corr + sum;
  m = m_new;
  const float pv = kQuant ? p * vs : p;
#pragma unroll
  for (int c = 0; c < kPairs; ++c) {
    if (2 * lane + 64 * c < D) {
      a[c][0] *= corr;
      a[c][1] *= corr;
    }
  }
  // branch-free, so that the rows' shuffles and loads overlap: a dead
  // row's p and V (bytes never copied) are selected to 0 and add nothing
  const int r0 = (threadIdx.x >> 5) * RW;  // this warp's first row
#pragma unroll 4
  for (int j = 0; j < RW; ++j) {
    const bool lj = (live >> (j * TPR)) & 1u;
    const float pr = __shfl_sync(0xffffffffu, pv, j * TPR);
    const float pj = lj ? pr : 0.f;
    const unsigned char* vrow = vstage + rows.offset(r0 + j);
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int d = 2 * lane + 64 * c;
      if (d < D) {
        float2 vv = Widen<TKV>::load2(vrow + d * kEs);
        if (!lj) vv = make_float2(0.f, 0.f);
        a[c][0] = fmaf(pj, vv.x, a[c][0]);
        a[c][1] = fmaf(pj, vv.y, a[c][1]);
      }
    }
  }
}

// Each warp's running state: in registers for up to kHeads query heads
// (the first G used; kHeads = 4 up to D = kRegHeadsD), or in shared
// memory (kHeads = 0) for any G.
template <int kHeads>
struct WarpState {
  static constexpr bool kSmemState = kHeads == 0;
  static constexpr int kN = kSmemState ? 1 : kHeads;  // heads in registers
  // feature pairs a lane owns
  static constexpr int kPairs = kHeads == kRegHeads ? kRegHeadsD / 64 : kMaxPairs;
  float m[kN], l[kN], a[kN][kPairs][2];
  float *Mw, *Lw, *Acc;  // [kWarps][G](, [D]): the shared-memory state
  int G, D, warp, lane;

  __device__ __forceinline__ void init(unsigned char* smem, const Layout& L, int g, int d, int w, int ln,
                       int tid) {
    Mw = reinterpret_cast<float*>(smem + L.mw);
    Lw = reinterpret_cast<float*>(smem + L.lw);
    Acc = reinterpret_cast<float*>(smem + L.acc);
    G = g;
    D = d;
    warp = w;
    lane = ln;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int c = 0; c < kPairs; ++c) a[j][c][0] = a[j][c][1] = 0.f;
    }
    if (kSmemState) {
      for (int i = tid; i < kWarps * G * D; i += kThreads) Acc[i] = 0.f;
      for (int i = tid; i < kWarps * G; i += kThreads) {
        Mw[i] = kNegInf;
        Lw[i] = 0.f;
      }
    }
  }

  // every query head's step over one tile whose K row of this lane is
  // `krow` and whose V rows sit in `vstage` as `rows` places them
  template <typename TKV, bool kQuant>
  __device__ __forceinline__ void step(const float* Qs, const unsigned char* krow,
                                       const unsigned char* vstage, const Rows& rows, int RW,
                                       int TPR, int part_id, int ok, unsigned live, float ks,
                                       float vs) {
    if constexpr (!kSmemState) {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        if (j < G) {
          head_step<TKV, kQuant>(Qs + j * D, krow, vstage, rows, D, RW, TPR, part_id, lane, ok,
                                 live, ks, vs, m[j], l[j], a[j]);
        }
      }
      return;
    }
    for (int g = 0; g < G; ++g) {
      float* ag = Acc + (warp * G + g) * D;
      float mg = Mw[warp * G + g], lg = Lw[warp * G + g];
      float r[kMaxPairs][2];
#pragma unroll
      for (int c = 0; c < kMaxPairs; ++c) {
        const int d = 2 * lane + 64 * c;
        if (d < D) {
          r[c][0] = ag[d];
          r[c][1] = ag[d + 1];
        }
      }
      head_step<TKV, kQuant>(Qs + g * D, krow, vstage, rows, D, RW, TPR, part_id, lane, ok,
                             live, ks, vs, mg, lg, r);
#pragma unroll
      for (int c = 0; c < kMaxPairs; ++c) {
        const int d = 2 * lane + 64 * c;
        if (d < D) {
          ag[d] = r[c][0];
          ag[d + 1] = r[c][1];
        }
      }
      __syncwarp();
      if (lane == 0) {
        Mw[warp * G + g] = mg;
        Lw[warp * G + g] = lg;
      }
      __syncwarp();
    }
  }

  // the registers' state into shared memory (the K/V stages are free)
  __device__ __forceinline__ void spill() {
    if (kSmemState) return;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      if (j < G) {
        float* ag = Acc + (warp * G + j) * D;
#pragma unroll
        for (int c = 0; c < kPairs; ++c) {
          const int d = 2 * lane + 64 * c;
          if (d < D) {
            ag[d] = a[j][c][0];
            ag[d + 1] = a[j][c][1];
          }
        }
        if (lane == 0) {
          Mw[warp * G + j] = m[j];
          Lw[warp * G + j] = l[j];
        }
      }
    }
  }
};

// The merge's mbarrier: complete once every split's piece of this CTA's
// slice has landed.
__device__ __forceinline__ uint64_t* merge_bar(unsigned char* smem) {
  return reinterpret_cast<uint64_t*>(smem) + kMaxStages;
}

// Called by every thread once the barriers are initialised and visible
// to the CTA: the merge's mbarrier expects this CTA's slice from all S
// splits, and this CTA arrives on the cluster barrier, which its peers
// wait on before their first store into its shared memory.
__device__ __forceinline__ void merge_begin(unsigned char* smem, int G, int D, int rank, int S,
                                            int tid) {
  if (tid == 0) {
    const int per = merge_slice(G * D, S);
    const int n = max(min(G * D - rank * per, per), 0);
    mbar_expect_tx(merge_bar(smem), static_cast<unsigned>(S * n * 16));
  }
  cluster_arrive_relaxed();
}

// The end of a CTA.  Its four warps' states (in shared memory) are merged
// in warp order into its partial, output by output in registers, and each
// output's (m, l, acc) is stored by st.async into the receive buffer of
// the CTA whose slice holds it (split * per + tid, stepping kThreads).
// Each CTA then waits for its slice from all S splits and merges it in
// split order: M = max m_s, w_s = exp(m_s - M), l = sum l_s w_s, acc =
// sum acc_s w_s, out = acc / max(l, 1e-30), each op rounded once, as the
// plain split-and-merge version (ops/flash_decode.py) computes it.  No CTA
// reads a peer's shared memory and none waits for a peer to leave: a
// CTA's stores land in its peers' receive buffers (never reused during a
// launch), and a CTA leaves once its own slice is merged.  A slot with
// nothing attendable has every m_s = kNegInf, l = 0 and gets exactly 0.
template <typename TQ>
__device__ __forceinline__ void merge_and_write(unsigned char* smem, const Layout& L, TQ* out,
                                                int b, int hk, int H, int G, int D, int split,
                                                int rank, int S, int tid) {
  const float* Mw = reinterpret_cast<const float*>(smem + L.mw);
  const float* Lw = reinterpret_cast<const float*>(smem + L.lw);
  const float* Acc = reinterpret_cast<const float*>(smem + L.acc);
  const float4* recv = reinterpret_cast<const float4*>(smem + L.recv);  // [S][per]
  uint64_t* bar = merge_bar(smem);
  const int per = merge_slice(G * D, S);
  __syncthreads();  // every warp's state is in place
  cluster_wait();   // every peer has initialised its merge barrier
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
    const int owner = i / per;
    st_async4(peer_addr(recv + split * per + (i - owner * per), owner), m, l, acc,
              peer_addr(bar, owner));
  }
  const int lo = rank * per;
  const int n = min(G * D - lo, per);
  if (tid >= n) return;
  mbar_wait<true>(bar, 0);
  for (int j = tid; j < n; j += kThreads) {
    float m = kNegInf;
    for (int s = 0; s < S; ++s) m = fmaxf(m, recv[s * per + j].x);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const float4 r = recv[s * per + j];
      const float w = expf(__fsub_rn(r.x, m));
      l = __fadd_rn(l, __fmul_rn(r.y, w));
      acc = __fadd_rn(acc, __fmul_rn(r.z, w));
    }
    const int i = lo + j;
    const int g = i / D;
    const int d = i - g * D;
    out[(static_cast<size_t>(b) * H + static_cast<size_t>(hk) * G + g) * D + d] =
        from_f32<TQ>(__fdiv_rn(acc, fmaxf(l, 1e-30f)));
  }
}

// ------------------------------------------------------- the dense form
//
// Runs of whole tiles of T = tile_rows(D) rows.  The grid is
// (B * Hkv, S), one cluster of S CTAs a (slot, KV head); S is chosen on
// the host from R and the SM count, never from the cursors, so the grid
// is fixed on the host.  The cursor, read on the device, sets the runs: a
// plain cache cuts slot b's live rows [0, min(idx[b] + 1, R)) into
// nt_b = ceil(rows / T) tiles, and CTA (bhk, s) takes tiles
// [s * L_b, min((s + 1) * L_b, nt_b)) with L_b = ceil(nt_b / S), so every
// slot's live rows spread over its S CTAs whatever its cursor.  A CTA
// whose run is empty keeps m = -inf, l = 0 and joins the merge.  A tile
// is one tensor copy a K and a V box (D, 1, T) of the cache viewed as
// (D, Hkv, B * R): for a plain cache one thread issues the run's tiles
// with no barrier (rows past the cursor in the last tile arrive and are
// masked).  A windowed ring keeps all R rows (ring slots do not follow
// the cursor), so its runs are cut from R alone; its first stages'
// slot_pos are read together before any tile is issued, and a tile with
// no allowed row is skipped before any of its bytes are read.

template <typename TQ, typename TKV, bool kWindowed, bool kQuant, int kHeads>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_decode_kernel(const Params p, const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  constexpr int kEs = sizeof(TKV);
  const int H = p.H, Hkv = p.Hkv, D = p.D, R = p.R, NST = p.stages;
  const int G = H / Hkv;
  const int T = tile_rows(D);     // rows a tile
  const int RW = T / kWarps;      // rows a warp
  const int TPR = 32 / RW;        // lanes a row in the scores
  const int VLD = D * kEs;        // bytes a K or V row
  const Rows rws(T, VLD);  // a tile is one box
  const int SB = rws.stage(T);    // bytes a stage of K (or V)
  const Layout L = make_layout(G, D, kEs, NST, kQuant, kHeads == 0, kWindowed, gridDim.y, 0, T);
  uint64_t* bar = reinterpret_cast<uint64_t*>(dsmem);  // [NST]
  unsigned char* Ks = dsmem + L.k;
  unsigned char* Vs = dsmem + L.v;
  float* Ksc = reinterpret_cast<float*>(dsmem + L.ksc);
  float* Vsc = reinterpret_cast<float*>(dsmem + L.vsc);
  float* Qs = reinterpret_cast<float*>(dsmem + L.q);  // [G][D], scaled
  int* allow = reinterpret_cast<int*>(dsmem + L.allow);  // [NST][T] (ring)
  int* spb = reinterpret_cast<int*>(dsmem + L.sp);       // [NST][T] (ring)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const int rank = blockIdx.y;  // this CTA's rank in its (1, S, 1) cluster
  const int S = gridDim.y;
  const int split = (rank + bhk) % S;  // its run
  if (tid == 0) {
    prefetch_map(&kmap);
    prefetch_map(&vmap);
  }
  const int cursor = p.idx[b];
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(bar + s, kQuant ? 1 + kThreads : 1);
    mbar_init(merge_bar(dsmem), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // q while the cursor loads
  const TQ* q = static_cast<const TQ*>(p.q);
  const size_t qo = (static_cast<size_t>(b) * H + static_cast<size_t>(hk) * G) * D;
  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_f32(q[qo + i]) * p.scale;
  // this CTA's run of tiles, [t0, t1)
  const int rows = kWindowed ? R : min(max(cursor + 1, 0), R);
  const int nt = (rows + T - 1) / T;
  const int per = (nt + S - 1) / S;
  const int t0 = min(split * per, nt);
  const int t1 = min(t0 + per, nt);
  if (kWindowed) {  // the first stages' slot_pos, all at once
    const int n = min(NST, t1 - t0) * T;
    for (int i = tid; i < n; i += kThreads) {
      const int row = t0 * T + i;
      if (row < R) cp_async4(spb + i, p.slot_pos + static_cast<size_t>(b) * R + row);
    }
    cp_async_wait_all();
  }
  WarpState<kHeads> ws;
  ws.init(dsmem, L, G, D, warp, lane, tid);
  __syncthreads();  // barriers initialised; q, slot_pos and the state in place
  merge_begin(dsmem, G, D, rank, S, tid);

  // Is row tid of tile t attended?  (`pre`: its slot_pos was read ahead)
  auto row_ok = [&](int t, bool pre) -> int {
    const int row = t * T + tid;
    if (tid >= T || row >= rows) return 0;
    if (!kWindowed) return 1;
    const int sp = pre ? spb[(t - t0) * T + tid] : p.slot_pos[static_cast<size_t>(b) * R + row];
    return ring_allows(sp, cursor, p.window, p.sinks);
  };
  // Tile t into stage st: one tensor copy a K and a V box, and the live
  // rows' scales by cp.async, all on the stage's barrier.  Every thread
  // calls it; a plain cache's tile always has a live row.  A ring's tile
  // with none is skipped (false) before any of its bytes are read.
  auto issue = [&](int t, int st, int ok) -> bool {
    if constexpr (kWindowed) {
      if (tid < T) allow[st * T + tid] = ok;
      if (__syncthreads_count(ok) == 0) return false;
    }
    if (tid == 0) {
      mbar_expect_tx(bar + st, 2u * T * VLD);
      tma_load3(Ks + st * SB, &kmap, bar + st, 0, hk, b * R + t * T);
      tma_load3(Vs + st * SB, &vmap, bar + st, 0, hk, b * R + t * T);
    }
    if constexpr (kQuant) {
      if (ok) {
        const size_t so = (static_cast<size_t>(b) * R + t * T + tid) * Hkv + hk;
        cp_async4(Ksc + st * T + tid, p.k_scale + so);
        cp_async4(Vsc + st * T + tid, p.v_scale + so);
      }
      cp_async_arrive(bar + st);
    }
    return true;
  };

  // the whole run in flight when it fits the stages
  int next = t0, issued = 0;
  for (; next < t1 && next - t0 < NST; ++next) {
    if (issue(next, issued, row_ok(next, true))) ++issued;
  }
  for (; next < t1 && issued < NST; ++next) {
    if (issue(next, issued, row_ok(next, false))) ++issued;
  }

  const int rl = lane / TPR;  // this lane's row in its warp's rows
  const int part_id = lane - rl * TPR;
  const int r = warp * RW + rl;  // this lane's tile row
  for (int used = 0; used < issued;) {
    const int st = used % NST;
    mbar_wait(bar + st, (used / NST) & 1);
    // a plain cache's tiles come in order, none skipped
    const int ok = kWindowed ? allow[st * T + r] : (t0 + used) * T + r < rows;
    const unsigned live = __ballot_sync(0xffffffffu, ok);
    const float ks = kQuant ? Ksc[st * T + r] : 1.f;
    const float vs = kQuant ? Vsc[st * T + r] : 1.f;
    ws.template step<TKV, kQuant>(Qs, Ks + st * SB + rws.offset(r), Vs + st * SB, rws, RW, TPR,
                                  part_id, ok, live, ks, vs);
    ++used;
    if (next < t1) {  // a longer run: refill the stage just used
      __syncthreads();
      fence_async_smem();
      for (; next < t1 && issued < used + NST; ++next) {
        if (issue(next, issued % NST, row_ok(next, false))) ++issued;
      }
    }
  }
  __syncthreads();  // every warp is done with the stages
  ws.spill();
  merge_and_write<TQ>(dsmem, L, static_cast<TQ*>(p.out), b, hk, H, G, D, split, rank, S, tid);
}

// ------------------------------------------------------- the paged form
//
// Runs of whole pages.  The grid is (B * Hkv, S), one cluster of S CTAs
// a (slot, KV head): CTA (bhk, s) takes the contiguous run of pages
// [s * pps, (s + 1) * pps) of its slot (pps pages a split, chosen on the
// host from the page count and the SM count, never from the cursors).
// The CTA reads its page ids (all of the run's, whatever the cursor, so
// they load beside the cursor) into shared memory, and walks its rows in
// tiles of tile_rows(D) rows that may span pages.  A tile's rows fall in
// boxes of PB = page_box(bs, T) rows, each inside one page, and each box
// is one K and one V tensor copy (D, 1, PB) of the pool viewed as
// (D, Hkv, NB * bs), issued with its own expect_tx by lane 0 of warp
// j % 4 (box j) when the box has a live row; none of the bytes of a box
// with none
// (past the cursor, out of band, unwritten, or on an unbound page) are
// read.  Each row's flag is written by its own thread and each warp
// arrives once on the stage's barrier, so no thread waits for another to
// issue and the run's first stages are asked for at once.

template <typename TQ, typename TKV, bool kWindowed, bool kQuant, int kHeads>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_decode_paged_kernel(const Params p, const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap) {
  extern __shared__ __align__(128) unsigned char dsmem[];
  constexpr int kEs = sizeof(TKV);
  const int H = p.H, Hkv = p.Hkv, D = p.D, P = p.P, bs = p.bs, NST = p.stages, pps = p.pps;
  const int G = H / Hkv;
  const int T = tile_rows(D);     // rows a tile
  const int RW = T / kWarps;      // rows a warp
  const int TPR = 32 / RW;        // lanes a row in the scores
  const int VLD = D * kEs;        // bytes a K or V row
  const int PB = page_box(bs, T);  // rows a box
  const int NBT = T / PB;          // boxes a tile
  const Rows rws(PB, VLD);
  const int SB = rws.stage(T);     // bytes a stage of K (or V)
  const Layout L = make_layout(G, D, kEs, NST, kQuant, kHeads == 0, kWindowed, gridDim.y, pps, PB);
  uint64_t* bar = reinterpret_cast<uint64_t*>(dsmem);  // [NST]
  unsigned char* Ks = dsmem + L.k;
  unsigned char* Vs = dsmem + L.v;
  float* Ksc = reinterpret_cast<float*>(dsmem + L.ksc);
  float* Vsc = reinterpret_cast<float*>(dsmem + L.vsc);
  float* Qs = reinterpret_cast<float*>(dsmem + L.q);
  int* allow = reinterpret_cast<int*>(dsmem + L.allow);  // [NST][T]
  int* spb = reinterpret_cast<int*>(dsmem + L.sp);       // [NST][T] (ring)
  int* pid = reinterpret_cast<int*>(dsmem + L.pid);      // [pps] the run's page ids

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bhk = blockIdx.x;
  const int b = bhk / Hkv;
  const int hk = bhk - b * Hkv;
  const int rank = blockIdx.y;  // this CTA's rank in its (1, S, 1) cluster
  const int S = gridDim.y;
  const int split = (rank + bhk) % S;  // its run
  if (tid == 0) {
    prefetch_map(&kmap);
    prefetch_map(&vmap);
  }
  const int cursor = p.idx[b];
  const int p0 = split * pps;
  const int np_all = max(min(P, p0 + pps) - p0, 0);
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(bar + s, kWarps + (kQuant ? kThreads : 0));
    mbar_init(merge_bar(dsmem), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the page ids (and a ring's first stages' slot_pos) by cp.async, so
  // that they load beside the cursor and q
  for (int i = tid; i < np_all; i += kThreads) {
    cp_async4(pid + i, p.page_table + static_cast<size_t>(b) * P + p0 + i);
  }
  if (kWindowed) {
    const int n = min(NST * T, np_all * bs);
    for (int i = tid; i < n; i += kThreads) {
      cp_async4(spb + i, p.slot_pos + static_cast<size_t>(b) * P * bs + p0 * bs + i);
    }
  }
  const TQ* q = static_cast<const TQ*>(p.q);
  const size_t qo = (static_cast<size_t>(b) * H + static_cast<size_t>(hk) * G) * D;
  for (int i = tid; i < G * D; i += kThreads) Qs[i] = to_f32(q[qo + i]) * p.scale;
  cp_async_wait_all();
  // the plain cache walks only up to the cursor's page
  const int np = kWindowed ? np_all
                           : min(np_all, cursor < 0 ? 0 : max(cursor / bs + 1 - p0, 0));
  const int nrows = np * bs;  // the run's rows, from logical row p0 * bs
  const int ntiles = (nrows + T - 1) / T;
  WarpState<kHeads> ws;
  ws.init(dsmem, L, G, D, warp, lane, tid);
  __syncthreads();  // barriers initialised; page ids, q, slot_pos, the state in place
  merge_begin(dsmem, G, D, rank, S, tid);

  // Is row lr of the run attended, and its pool row?  (Its page by a
  // shift where bs is a power of two, as the serving pools' are.)
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  auto row_ok = [&](int lr, int& prow) -> int {
    prow = 0;
    if (lr >= nrows) return 0;
    const int pg = bs_shift >= 0 ? lr >> bs_shift : lr / bs;
    const int blk = pid[pg];
    if (blk < 0 || blk >= p.NB) return 0;
    prow = blk * bs + (lr - pg * bs);
    const int row = p0 * bs + lr;  // logical row
    if (!kWindowed) return row <= cursor;
    const int sp = lr < NST * T ? spb[lr] : p.slot_pos[static_cast<size_t>(b) * P * bs + row];
    return ring_allows(sp, cursor, p.window, p.sinks);
  };
  // Tile t into stage t % NST: thread r < T writes row r's flag (and
  // copies its scales by cp.async), lane 0 of warp j % 4 copies box j if
  // any of its rows is live (a plain cache's box is live from its first
  // row: the rows of a box share a page and run up to the cursor), and
  // each warp then arrives once on the stage's barrier.  Every thread
  // calls it.
  auto issue = [&](int t) {
    const int st = t % NST;
    if (tid < T) {
      int prow;
      const int ok = row_ok(t * T + tid, prow);
      allow[st * T + tid] = ok;
      if (kQuant && ok) {
        const size_t so = static_cast<size_t>(prow) * Hkv + hk;
        cp_async4(Ksc + st * T + tid, p.k_scale + so);
        cp_async4(Vsc + st * T + tid, p.v_scale + so);
      }
    }
    for (int j = warp; j < NBT && lane == 0; j += kWarps) {
      const int lr = t * T + j * PB;  // the box's first row
      int prow = 0, live = row_ok(lr, prow);
      if constexpr (kWindowed) {  // any live row; prow: the box's first
        for (int r = 1; r < PB && !live; ++r) {
          live = row_ok(lr + r, prow);
          prow -= r;
        }
      }
      if (live) {
        mbar_expect(bar + st, 2u * PB * VLD);
        tma_load3(Ks + st * SB + j * rws.box_stride, &kmap, bar + st, 0, hk, prow);
        tma_load3(Vs + st * SB + j * rws.box_stride, &vmap, bar + st, 0, hk, prow);
      }
    }
    if constexpr (kQuant) cp_async_arrive(bar + st);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar + st);
  };

  int next = 0;
  for (; next < ntiles && next < NST; ++next) issue(next);

  const int rl = lane / TPR;  // this lane's row in its warp's rows
  const int part_id = lane - rl * TPR;
  const int r = warp * RW + rl;  // this lane's tile row
  for (int used = 0; used < ntiles;) {
    const int st = used % NST;
    mbar_wait(bar + st, (used / NST) & 1);
    const int ok = allow[st * T + r];
    const unsigned live = __ballot_sync(0xffffffffu, ok);
    const float ks = kQuant ? Ksc[st * T + r] : 1.f;
    const float vs = kQuant ? Vsc[st * T + r] : 1.f;
    ws.template step<TKV, kQuant>(Qs, Ks + st * SB + rws.offset(r), Vs + st * SB, rws, RW, TPR,
                                  part_id, ok, live, ks, vs);
    ++used;
    if (next < ntiles) {  // a longer run: refill the stage just used
      __syncthreads();
      fence_async_smem();
      issue(next++);
    }
  }
  __syncthreads();  // every warp is done with the stages
  ws.spill();
  merge_and_write<TQ>(dsmem, L, static_cast<TQ*>(p.out), b, hk, H, G, D, split, rank, S, tid);
}

// ---------------------------------------------------- launch

// A call's shape besides the template arguments.
struct Args {
  Params p;
  int B, splits;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, int splits) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  }
  if (e == cudaSuccess && splits > 8) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e != cudaSuccess) cudaGetLastError();  // reported here, not by the next launch
  return e;
}

// The current device's SM count, shared memory an SM and shared memory
// the card reserves a CTA, asked once a device.
struct Card {
  int sms, smem_sm, reserved;
};

cudaError_t card(Card* c) {
  static Card cards[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= 64) return e != cudaSuccess ? e : cudaErrorInvalidDevice;
  if (cards[dev].sms == 0) {
    Card k{};
    e = cudaDeviceGetAttribute(&k.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&k.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&k.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cards[dev] = k;
  }
  *c = cards[dev];
  return cudaSuccess;
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

// The tensor map of a K or V cache whose `rows` rows hold Hkv heads of D
// values of es bytes ([B, R, Hkv, D] dense, [NB, bs, Hkv, D] paged), seen
// as (D, Hkv, rows) with boxes (D, 1, box_rows), no swizzle; rows past
// the tensor arrive as zeros.  Encoded on the host for each launch (a
// captured graph keeps it with the cache's address).
cudaError_t encode_kv(CUtensorMap* map, const void* x, int es, long long rows, int Hkv, int D,
                      int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  const CUtensorMapDataType ty = es == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(Hkv),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * es,
                                 static_cast<cuuint64_t>(Hkv) * D * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), 1, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, ty, 3, const_cast<void*>(x), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launches since the library was loaded (each one CUDA launch), and the
// K/V stages of the last.
unsigned long long g_launches = 0;
int g_last_stages = 0;

// The K/V tiles a CTA keeps in flight: its longest run (a dense run is
// cut from the cache's R rows, its cursor being read on the device; a
// paged run holds pps pages), so that the run is asked for whole before
// the first wait, at most kMaxStages, and no more than lets every CTA of
// the grid be resident at once on the card (a second wave of CTAs costs
// more than the stages save: lm_small's 576 CTAs on 132 SMs are 5 an
// SM, 2 bf16 tiles of 16 KB each).
template <bool kQuant, int kHeads, bool kWindowed, bool kPaged>
int plan_stages(const Params& p, int es, int B, int splits, const Card& c) {
  const int G = p.H / p.Hkv;
  const int t = tile_rows(p.D);
  const int rows = kPaged ? p.pps * p.bs : ((p.R + t - 1) / t + splits - 1) / splits * t;
  const int pb = kPaged ? page_box(p.bs, t) : t;
  const long long ctas = static_cast<long long>(B) * p.Hkv * splits;
  const long long per_sm = (ctas + c.sms - 1) / c.sms;
  int st = min(max((rows + t - 1) / t, 1), kMaxStages);
  for (; st > 1; --st) {
    const long long smem = make_layout(G, p.D, es, st, kQuant, kHeads == 0, kWindowed, splits,
                                       kPaged ? p.pps : 0, pb)
                               .total;
    if (per_sm * (smem + c.reserved) <= c.smem_sm) break;
  }
  return st;
}

template <typename TQ, typename TKV, bool kWindowed, bool kQuant, int kHeads, bool kPaged>
cudaError_t launch(const Args& a) {
  Params p = a.p;
  const int G = p.H / p.Hkv;
  const int t = tile_rows(p.D);
  Card c;
  cudaError_t e = card(&c);
  if (e != cudaSuccess) return e;
  p.stages = plan_stages<kQuant, kHeads, kWindowed, kPaged>(p, sizeof(TKV), a.B, a.splits, c);
  const size_t smem = make_layout(G, p.D, sizeof(TKV), p.stages, kQuant, kHeads == 0, kWindowed,
                                  a.splits, kPaged ? p.pps : 0, kPaged ? page_box(p.bs, t) : t)
                          .total;
  void (*kernel)(const Params, const CUtensorMap, const CUtensorMap);
  if constexpr (kPaged) {
    kernel = flash_decode_paged_kernel<TQ, TKV, kWindowed, kQuant, kHeads>;
  } else {
    kernel = flash_decode_kernel<TQ, TKV, kWindowed, kQuant, kHeads>;
  }
  e = prepare(kernel, smem, a.splits);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.splits;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * p.Hkv, a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // dense: a box a tile of a slot's rows; paged: a box a page's piece
  CUtensorMap km, vm;
  const long long rows = kPaged ? static_cast<long long>(p.NB) * p.bs
                                : static_cast<long long>(a.B) * p.R;
  const int box = kPaged ? page_box(p.bs, t) : t;
  e = encode_kv(&km, p.k, sizeof(TKV), rows, p.Hkv, p.D, box);
  if (e == cudaSuccess) e = encode_kv(&vm, p.v, sizeof(TKV), rows, p.Hkv, p.D, box);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kernel, p, km, vm);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) {
    ++g_launches;
    g_last_stages = p.stages;
  }
  return e;
}

template <typename TQ, typename TKV, bool kQuant, int kHeads>
cudaError_t dispatch_form(int windowed, int paged, const Args& a) {
  if (paged) {
    return windowed ? launch<TQ, TKV, true, kQuant, kHeads, true>(a)
                    : launch<TQ, TKV, false, kQuant, kHeads, true>(a);
  }
  return windowed ? launch<TQ, TKV, true, kQuant, kHeads, false>(a)
                  : launch<TQ, TKV, false, kQuant, kHeads, false>(a);
}

// the state's instantiation from G (and D): one head, up to kRegHeads,
// or shared
template <typename TQ, typename TKV, bool kQuant>
cudaError_t dispatch_mode(int windowed, int paged, const Args& a) {
  const int G = a.p.H / a.p.Hkv;
  if (G == 1) return dispatch_form<TQ, TKV, kQuant, 1>(windowed, paged, a);
  if (G <= kRegHeads && a.p.D <= kRegHeadsD)
    return dispatch_form<TQ, TKV, kQuant, kRegHeads>(windowed, paged, a);
  return dispatch_form<TQ, TKV, kQuant, 0>(windowed, paged, a);
}

cudaError_t dispatch(int q_dtype, int kv_dtype, int windowed, int paged, const Args& a) {
  const Params& p = a.p;
  if (a.B == 0 || p.Hkv == 0) return cudaSuccess;
  if (p.H % p.Hkv != 0 || p.D % 16 != 0 || p.D > 256 || p.R < 1) {
    return cudaErrorInvalidValue;
  }
  const int quant = kv_dtype == kI8 || kv_dtype == kFP8;
  if (quant && (p.k_scale == nullptr || p.v_scale == nullptr)) return cudaErrorInvalidValue;
  if (windowed && p.slot_pos == nullptr) return cudaErrorInvalidValue;
  if (a.splits < 1 || a.splits > kMaxSplits) return cudaErrorInvalidValue;
  if (paged && (p.page_table == nullptr || p.bs < 1 || p.NB < 1 || p.pps < 1 ||
                static_cast<long long>(a.splits) * p.pps < p.P ||
                static_cast<long long>(a.splits - 1) * p.pps >= p.P))
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
// null when unused); stream is a cudaStream_t.  Each makes one CUDA
// launch, a grid of clusters of ``splits`` CTAs (at most 16), and
// returns a cudaError_t.

// Dense slot cache: k/v [B, R, Hkv, D], scales [B, R, Hkv]; ``splits``
// runs of tiles, cut from each slot's cursor on the device.
extern "C" int flash_decode_launch(
    int q_dtype, int kv_dtype, int windowed, const void* q, const void* k,
    const void* v, const void* idx, const void* slot_pos, const void* k_scale,
    const void* v_scale, void* out, int B, int R, int H, int Hkv, int D,
    int window, int sinks, float scale, int splits, void* stream) {
  const Params p{q, k, v, nullptr, static_cast<const int32_t*>(idx),
                 static_cast<const int32_t*>(slot_pos),
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), out, R, 0, 0, 0, H, Hkv, D,
                 window, sinks, 0, 0, scale};
  return dispatch(q_dtype, kv_dtype, windowed, 0,
                  Args{p, B, splits, static_cast<cudaStream_t>(stream)});
}

// Paged block pool: k/v [NB, bs, Hkv, D], scales [NB, bs, Hkv], page
// table [B, P], slot_pos [B, P * bs].  ``splits`` runs of ``pps`` pages
// each (the last may be shorter, none empty).
extern "C" int flash_decode_paged_launch(
    int q_dtype, int kv_dtype, int windowed, const void* q, const void* k_pool,
    const void* v_pool, const void* page_table, const void* idx,
    const void* slot_pos, const void* k_scale, const void* v_scale, void* out,
    int B, int P, int bs, int NB, int H, int Hkv, int D, int window, int sinks,
    float scale, int splits, int pps, void* stream) {
  const Params p{q, k_pool, v_pool, static_cast<const int32_t*>(page_table),
                 static_cast<const int32_t*>(idx),
                 static_cast<const int32_t*>(slot_pos),
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale), out, P * bs, P, bs, NB, H, Hkv, D,
                 window, sinks, pps, 0, scale};
  return dispatch(q_dtype, kv_dtype, windowed, 1,
                  Args{p, B, splits, static_cast<cudaStream_t>(stream)});
}

// Launches this library made since it was loaded.
extern "C" unsigned long long flash_decode_cuda_launches() { return g_launches; }

// The K/V tiles a CTA kept in flight in this library's last launch.
extern "C" int flash_decode_last_stages() { return g_last_stages; }

// cudaGetErrorString for the wrapper's error message.
extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
