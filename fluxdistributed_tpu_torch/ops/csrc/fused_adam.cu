// Fused Adam update for Hopper (sm_90a): one streaming pass over flat f32
// buffers.
//
// Replaces the TPU kernel fluxdistributed_tpu/parallel/zero1_fused.py:
// _adam_kernel (launched by _fused_adam_impl's pl.pallas_call).  For every
// element i of a rank's ZeRO-1 shard it computes, in the op order of
// optim.adam,
//
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * (g * g)
//   p' = p - eta * (m' / c1) / (sqrt(v' / c2) + eps)
//
// with the step's scalars sc = [eta, c1, c2] = [lr, 1 - b1^t, 1 - b2^t]
// read from device memory, so a learning-rate schedule changes data and
// not the launch.  (1 - b1) and (1 - b2) come in as f32 values that the
// caller rounded from doubles, as PyTorch rounds a Python scalar.
//
// Rounding.  Every operation is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never contracts into an FMA, and each matches one eager PyTorch op of
// the plain version, so the kernel equals it bit for bit, on the card
// and on the CPU.
//
// Bound.  Seven f32 streams: p, g, m, v read once, p', m', v' written
// once, 28 bytes per element and ~12 flops: far below the card's ~20
// flops/byte f32 balance point.  The least time is 28 n bytes over the
// HBM rate (0.916 ms at lm_small's 109.6 M packed elements on a 3.35 TB/s
// H100 SXM).
//
// Design.  A grid-stride loop over float4s: each thread moves 16 bytes
// per stream per iteration, neighbouring threads on neighbouring
// addresses.  The TPU kernel tiles the buffer into [block, 128] VMEM
// blocks; here nothing carries between elements, so the buffer is one
// flat stream and the grid is a few waves of 256-thread CTAs over the
// SMs.  n is a multiple of 1024 (the packed layout's tile), so there is
// no ragged tail; the caller checks that n % 4 == 0 and every pointer is
// 16-byte aligned, and the launcher checks both again.  The outputs are
// separate buffers: nothing is updated in place.
//
// The launcher runs on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct AdamConsts {
  float b1, b2, omb1, omb2, eps;
};

__device__ __forceinline__ void adam_one(float p, float g, float m, float v,
                                         float eta, float c1, float c2,
                                         const AdamConsts& k, float* po,
                                         float* mo, float* vo) {
  const float m2 = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.omb1, g));
  const float v2 =
      __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.omb2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m2, c1);
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, c2)), k.eps);
  *po = __fsub_rn(p, __fdiv_rn(__fmul_rn(eta, mhat), den));
  *mo = m2;
  *vo = v2;
}

__global__ void __launch_bounds__(256)
    fused_adam_kernel(const float4* __restrict__ p,
                      const float4* __restrict__ g,
                      const float4* __restrict__ m,
                      const float4* __restrict__ v,
                      const float* __restrict__ sc, float4* __restrict__ po,
                      float4* __restrict__ mo, float4* __restrict__ vo,
                      int64_t n4, AdamConsts k) {
  const float eta = sc[0], c1 = sc[1], c2 = sc[2];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 pp = p[i], gg = g[i], mm = m[i], vv = v[i];
    float4 a, b, c;
    adam_one(pp.x, gg.x, mm.x, vv.x, eta, c1, c2, k, &a.x, &b.x, &c.x);
    adam_one(pp.y, gg.y, mm.y, vv.y, eta, c1, c2, k, &a.y, &b.y, &c.y);
    adam_one(pp.z, gg.z, mm.z, vv.z, eta, c1, c2, k, &a.z, &b.z, &c.z);
    adam_one(pp.w, gg.w, mm.w, vv.w, eta, c1, c2, k, &a.w, &b.w, &c.w);
    po[i] = a;
    mo[i] = b;
    vo[i] = c;
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

}  // namespace

extern "C" int fused_adam_launch(const void* p, const void* g, const void* m,
                                 const void* v, const void* scalars, void* p_out,
                                 void* m_out, void* v_out, int64_t n, float b1,
                                 float b2, float omb1, float omb2, float eps,
                                 void* stream) {
  if (n < 0 || n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {p, g, m, v, p_out, m_out, v_out};
  for (const void* ptr : ptrs) {
    if (!aligned16(ptr)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (reinterpret_cast<uintptr_t>(scalars) & 3u)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t n4 = n / 4;
  if (n4 == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 256;
  int64_t blocks = (n4 + threads - 1) / threads;
  // a few waves of resident CTAs; the grid-stride loop covers the rest
  const int64_t cap = (int64_t)(sms > 0 ? sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  AdamConsts k{b1, b2, omb1, omb2, eps};
  fused_adam_kernel<<<(unsigned)blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(p), static_cast<const float4*>(g),
      static_cast<const float4*>(m), static_cast<const float4*>(v),
      static_cast<const float*>(scalars), static_cast<float4*>(p_out),
      static_cast<float4*>(m_out), static_cast<float4*>(v_out), n4, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
