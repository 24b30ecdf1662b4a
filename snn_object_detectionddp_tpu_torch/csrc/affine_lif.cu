// Fused per-(t, b, c) affine (GroupNorm normalize) + LIF scan over T, forward.
//
// Replaces the JAX package's Pallas kernel
// snn_object_detectionddp_tpu/kernels/affine_lif_pallas.py::_fwd_kernel
// (the inference forward of every spiking block).
//
// Computes, per element of the channels-last conv output x (T*B, H, W, C),
// time-major:
//   cur = x * a[t, b, c] + b[t, b, c]          (fp32)
//   v'  = decay * v + cur
//   s   = (v' >= threshold)
//   v   = v' - s * threshold  (soft)   |   v' * (1 - s)  (hard)
//   readout = v + s * threshold        (optional, per step)
// and writes spikes and readouts in x's dtype, v_final in fp32.
//
// Bound: memory bytes. Each element moves x and s once per step (2 B each
// in bf16), the readout once per step when asked (2 B), and v0/v_final once
// (4 B each): (4 + 2*[readouts]) * T + 8 bytes per element in bf16, against
// ~10 flops per element-step. Design for that bound: one thread owns a
// vector of VEC consecutive channels at one (b, h, w) and runs the whole T
// loop with the membrane in registers, so x is read once and nothing but
// the outputs is written; loads and stores are VEC-wide (16 bytes for x)
// and coalesced along C; a and b are read per (t, b, c) and stay in L1/L2.
// Arithmetic uses the _rn intrinsics so no multiply-add is contracted: the
// result is bit-identical to the plain PyTorch version's separate ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC, bool HARD, bool READS>
__global__ void affine_lif_fwd_kernel(const T* __restrict__ x,
                                      const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      const float* __restrict__ v0,
                                      T* __restrict__ s,
                                      float* __restrict__ vfin,
                                      T* __restrict__ reads,
                                      int64_t t_steps, int64_t bsz, int64_t hw,
                                      int64_t c, float decay, float theta) {
  const int64_t per_step = bsz * hw * c;  // elements of one timestep
  const int64_t n_vec = per_step / VEC;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_vec;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i * VEC;  // first element of this vector
    const int64_t ch = e % c;
    const int64_t bi = e / (hw * c);
    Vec<float, VEC> v = *reinterpret_cast<const Vec<float, VEC>*>(v0 + e);
    for (int64_t t = 0; t < t_steps; ++t) {
      const int64_t off = t * per_step + e;
      const int64_t ab = (t * bsz + bi) * c + ch;
      const Vec<T, VEC> xv = *reinterpret_cast<const Vec<T, VEC>*>(x + off);
      const Vec<float, VEC> av = *reinterpret_cast<const Vec<float, VEC>*>(a + ab);
      const Vec<float, VEC> bv = *reinterpret_cast<const Vec<float, VEC>*>(b + ab);
      Vec<T, VEC> sv;
      Vec<T, VEC> rv;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float cur = __fadd_rn(__fmul_rn(to_f32(xv.v[k]), av.v[k]), bv.v[k]);
        const float v_pre = __fadd_rn(__fmul_rn(decay, v.v[k]), cur);
        const float sp = (v_pre >= theta) ? 1.0f : 0.0f;
        const float v_next = HARD ? __fmul_rn(v_pre, __fsub_rn(1.0f, sp))
                                  : __fsub_rn(v_pre, __fmul_rn(sp, theta));
        v.v[k] = v_next;
        sv.v[k] = from_f32<T>(sp);
        if (READS) rv.v[k] = from_f32<T>(__fadd_rn(v_next, __fmul_rn(sp, theta)));
      }
      *reinterpret_cast<Vec<T, VEC>*>(s + off) = sv;
      if (READS) *reinterpret_cast<Vec<T, VEC>*>(reads + off) = rv;
    }
    *reinterpret_cast<Vec<float, VEC>*>(vfin + e) = v;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* a, const void* b, const void* v0, void* s,
            void* vfin, void* reads, int64_t t_steps, int64_t bsz, int64_t hw,
            int64_t c, float decay, float theta, int hard, cudaStream_t stream) {
  const int threads = 256;
  const int64_t n_vec = bsz * hw * c / VEC;
  int64_t blocks = (n_vec + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
#define LIF_ARGS                                                                  \
  static_cast<const T*>(x), static_cast<const float*>(a),                          \
      static_cast<const float*>(b), static_cast<const float*>(v0),                 \
      static_cast<T*>(s), static_cast<float*>(vfin), static_cast<T*>(reads),       \
      t_steps, bsz, hw, c, decay, theta
  const bool with_reads = reads != nullptr;
  if (hard) {
    if (with_reads)
      affine_lif_fwd_kernel<T, VEC, true, true><<<blocks, threads, 0, stream>>>(LIF_ARGS);
    else
      affine_lif_fwd_kernel<T, VEC, true, false><<<blocks, threads, 0, stream>>>(LIF_ARGS);
  } else {
    if (with_reads)
      affine_lif_fwd_kernel<T, VEC, false, true><<<blocks, threads, 0, stream>>>(LIF_ARGS);
    else
      affine_lif_fwd_kernel<T, VEC, false, false><<<blocks, threads, 0, stream>>>(LIF_ARGS);
  }
#undef LIF_ARGS
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. reads may be null (no readouts).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int affine_lif_fwd(const void* x, const void* a, const void* b,
                              const void* v0, void* s, void* vfin, void* reads,
                              int64_t t_steps, int64_t bsz, int64_t hw, int64_t c,
                              float decay, float theta, int hard, int dtype_code,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The vector paths need every pointer aligned to the widest vector they
  // load (8 floats = 32 bytes); a view with an odd storage offset takes the
  // scalar path instead.
  const uintptr_t any = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(v0) |
                        reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(vfin) |
                        reinterpret_cast<uintptr_t>(reads);
  const bool aligned = (any % 32) == 0;
  if (dtype_code == 1) {
    if (c % 8 == 0 && aligned)
      launch<__nv_bfloat16, 8>(x, a, b, v0, s, vfin, reads, t_steps, bsz, hw, c, decay, theta, hard, st);
    else
      launch<__nv_bfloat16, 1>(x, a, b, v0, s, vfin, reads, t_steps, bsz, hw, c, decay, theta, hard, st);
  } else if (dtype_code == 0) {
    if (c % 4 == 0 && aligned)
      launch<float, 4>(x, a, b, v0, s, vfin, reads, t_steps, bsz, hw, c, decay, theta, hard, st);
    else
      launch<float, 1>(x, a, b, v0, s, vfin, reads, t_steps, bsz, hw, c, decay, theta, hard, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
