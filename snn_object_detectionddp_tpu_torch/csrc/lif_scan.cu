// Plain LIF scan over a leading time axis: inference forward, forward
// saving the v_pre residual, and the reverse-time surrogate-gradient
// backward.
//
// Replaces the JAX package's Pallas kernels in
// snn_object_detectionddp_tpu/kernels/lif_pallas.py:
//   lif_scan_fwd      <- _fwd_kernel      (inference forward)
//   lif_scan_fwd_res  <- _fwd_res_kernel  (forward under differentiation)
//   lif_scan_bwd      <- _bwd_kernel      (BPTT backward)
//
// The input is a contiguous (T, N) array of currents x (any (T, ...) shape
// flattened; fp32 or bf16) and an fp32 membrane v0 of N elements.
//
// ---- forward, per element, t = 0 .. T-1 ----
//   v'  = decay * v + x[t]                     (fp32)
//   s   = (v' >= threshold)
//   v   = v' - s * threshold  (soft)   |   v' * (1 - s)  (hard)
// writing s[t] in x's dtype, v_final = v in fp32 and, in the residual
// variant, v'[t] rounded to x's dtype.
//
// ---- backward, per element, t = T-1 .. 0, gv = g_vfinal at the start ----
//   shifted = v'[t] - threshold                (v' = the saved residual)
//   sur     = 1 / (slope * |shifted| + 1)^2
//   dpost   = 1 - threshold * sur  (soft)  |  (1 - H(shifted)) - v' * sur  (hard)
//   g       = gv * dpost + g_s[t] * sur
//   g_x[t]  = g                                (x's dtype)
//   gv      = decay * g
// and g_v0 = gv after t = 0. Every element is independent: there is no
// reduction across threads.
//
// Bound: memory bytes. Per element in bf16 the forward moves 4*T + 8 bytes
// (x and s per step, v0 and v_final once), the residual forward and the
// backward 6*T + 8, against ~6 (forward) and ~15 (backward, one division)
// flops per element-step. Design for that bound: one thread owns VEC
// consecutive elements (16 bytes of x: 8 bf16 or 4 fp32) through all T
// steps with the membrane (or gv) in registers, so every input is read
// once and nothing but the outputs is written; neighbouring threads touch
// neighbouring 16-byte words, and the next step's loads are issued before
// the current step's arithmetic. Nothing is padded or copied: when N is
// not a multiple of the widest vector, or a pointer is not aligned to it,
// the launcher takes the widest vector that keeps every row of (T, N)
// aligned (down to single elements), and for T = 1 the elements past the
// last whole vector go to scalar work items of the same launch.
// Arithmetic uses the _rn intrinsics and an IEEE division so that no
// multiply-add is contracted: every output equals the plain PyTorch
// version's separate ops bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "lif_common.cuh"

namespace {

using lifk::Vec;
using lifk::to_f32;
using lifk::from_f32;

constexpr int THREADS = 128;

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Vec<T, VEC>& v) {
  *reinterpret_cast<Vec<T, VEC>*>(p) = v;
}

// The T loop of VEC consecutive elements starting at element e.
template <typename T, int VEC, bool HARD, bool RES>
__device__ __forceinline__ void fwd_item(const T* __restrict__ x,
                                         const float* __restrict__ v0,
                                         T* __restrict__ s, T* __restrict__ vpre,
                                         float* __restrict__ vfin, int64_t t_steps,
                                         int64_t n, int64_t e, float decay, float theta) {
  Vec<float, VEC> v = load<float, VEC>(v0 + e);
  Vec<T, VEC> xv = load<T, VEC>(x + e);
  for (int64_t t = 0; t < t_steps; ++t) {
    const int64_t off = t * n + e;
    Vec<T, VEC> x_next = xv;
    if (t + 1 < t_steps) x_next = load<T, VEC>(x + off + n);
    Vec<T, VEC> sv, pv;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v_pre = __fadd_rn(__fmul_rn(decay, v.v[k]), to_f32(xv.v[k]));
      const float sp = (v_pre >= theta) ? 1.0f : 0.0f;
      v.v[k] = HARD ? __fmul_rn(v_pre, __fsub_rn(1.0f, sp))
                    : __fsub_rn(v_pre, __fmul_rn(sp, theta));
      sv.v[k] = from_f32<T>(sp);
      if (RES) pv.v[k] = from_f32<T>(v_pre);
    }
    store<T, VEC>(s + off, sv);
    if (RES) store<T, VEC>(vpre + off, pv);
    xv = x_next;
  }
  store<float, VEC>(vfin + e, v);
}

// Work items [0, n_vec) are vectors of VEC elements; items past them are
// the single elements after the last whole vector.
template <typename T, int VEC, bool HARD, bool RES>
__global__ void lif_scan_fwd_kernel(const T* __restrict__ x, const float* __restrict__ v0,
                                    T* __restrict__ s, T* __restrict__ vpre,
                                    float* __restrict__ vfin, int64_t t_steps, int64_t n,
                                    int64_t n_vec, float decay, float theta) {
  const int64_t items = n_vec + (n - n_vec * VEC);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < items;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i < n_vec) {
      fwd_item<T, VEC, HARD, RES>(x, v0, s, vpre, vfin, t_steps, n, i * VEC, decay, theta);
    } else {
      fwd_item<T, 1, HARD, RES>(x, v0, s, vpre, vfin, t_steps, n,
                                n_vec * VEC + (i - n_vec), decay, theta);
    }
  }
}

template <typename T, int VEC, bool HARD>
__device__ __forceinline__ void bwd_item(const T* __restrict__ vpre,
                                         const T* __restrict__ gs,
                                         const float* __restrict__ gvfin,
                                         T* __restrict__ gx, float* __restrict__ gv0,
                                         int64_t t_steps, int64_t n, int64_t e,
                                         float decay, float theta, float slope) {
  Vec<float, VEC> gv = load<float, VEC>(gvfin + e);
  int64_t off = (t_steps - 1) * n + e;
  Vec<T, VEC> vp = load<T, VEC>(vpre + off);
  Vec<T, VEC> gsv = load<T, VEC>(gs + off);
  for (int64_t t = t_steps - 1; t >= 0; --t, off -= n) {
    Vec<T, VEC> vp_next = vp, gs_next = gsv;
    if (t > 0) {
      vp_next = load<T, VEC>(vpre + off - n);
      gs_next = load<T, VEC>(gs + off - n);
    }
    Vec<T, VEC> gxv;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v_pre = to_f32(vp.v[k]);
      const float shifted = __fsub_rn(v_pre, theta);
      const float z = __fadd_rn(__fmul_rn(slope, fabsf(shifted)), 1.0f);
      const float sur = __fdiv_rn(1.0f, __fmul_rn(z, z));
      float dpost;
      if (HARD) {
        const float sp = (shifted >= 0.0f) ? 1.0f : 0.0f;
        dpost = __fsub_rn(__fsub_rn(1.0f, sp), __fmul_rn(v_pre, sur));
      } else {
        dpost = __fsub_rn(1.0f, __fmul_rn(theta, sur));
      }
      const float g = __fadd_rn(__fmul_rn(gv.v[k], dpost),
                                __fmul_rn(to_f32(gsv.v[k]), sur));
      gxv.v[k] = from_f32<T>(g);
      gv.v[k] = __fmul_rn(decay, g);
    }
    store<T, VEC>(gx + off, gxv);
    vp = vp_next;
    gsv = gs_next;
  }
  store<float, VEC>(gv0 + e, gv);
}

template <typename T, int VEC, bool HARD>
__global__ void lif_scan_bwd_kernel(const T* __restrict__ vpre, const T* __restrict__ gs,
                                    const float* __restrict__ gvfin, T* __restrict__ gx,
                                    float* __restrict__ gv0, int64_t t_steps, int64_t n,
                                    int64_t n_vec, float decay, float theta, float slope) {
  const int64_t items = n_vec + (n - n_vec * VEC);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < items;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (i < n_vec) {
      bwd_item<T, VEC, HARD>(vpre, gs, gvfin, gx, gv0, t_steps, n, i * VEC, decay, theta,
                             slope);
    } else {
      bwd_item<T, 1, HARD>(vpre, gs, gvfin, gx, gv0, t_steps, n,
                           n_vec * VEC + (i - n_vec), decay, theta, slope);
    }
  }
}

bool aligned_to(std::initializer_list<const void*> ptrs, size_t bytes) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return (any % bytes) == 0;
}

// The widest vector (elements) that keeps every row of the (T, N) arrays
// and the fp32 state arrays aligned: the per-step pointers to
// vec * sizeof(T) bytes, the state pointers to vec * 4 bytes, and the row
// length a multiple of vec unless there is one row only.
template <typename T>
int pick_vec(std::initializer_list<const void*> step_ptrs,
             std::initializer_list<const void*> state_ptrs, int64_t t_steps, int64_t n) {
  for (int vec = 16 / (int)sizeof(T); vec > 1; vec >>= 1) {
    if ((t_steps == 1 || n % vec == 0) && aligned_to(step_ptrs, vec * sizeof(T)) &&
        aligned_to(state_ptrs, vec * sizeof(float)))
      return vec;
  }
  return 1;
}

unsigned grid_for(int64_t items) {
  int64_t blocks = (items + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // the grid-stride loop covers the rest
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <typename T, int VEC>
void launch_fwd(const void* x, const void* v0, void* s, void* vpre, void* vfin,
                int64_t t_steps, int64_t n, float decay, float theta, int hard,
                cudaStream_t stream) {
  const int64_t n_vec = n / VEC;
  const unsigned blocks = grid_for(n_vec + (n - n_vec * VEC));
#define LIF_LAUNCH(HARD_, RES_)                                                       \
  lif_scan_fwd_kernel<T, VEC, HARD_, RES_><<<blocks, THREADS, 0, stream>>>(           \
      static_cast<const T*>(x), static_cast<const float*>(v0), static_cast<T*>(s),    \
      static_cast<T*>(vpre), static_cast<float*>(vfin), t_steps, n, n_vec, decay, theta)
  if (hard) {
    if (vpre) LIF_LAUNCH(true, true);
    else LIF_LAUNCH(true, false);
  } else {
    if (vpre) LIF_LAUNCH(false, true);
    else LIF_LAUNCH(false, false);
  }
#undef LIF_LAUNCH
}

template <typename T>
int forward_t(const void* x, const void* v0, void* s, void* vpre, void* vfin,
              int64_t t_steps, int64_t n, float decay, float theta, int hard,
              cudaStream_t stream) {
  const int vec = pick_vec<T>({x, s, vpre}, {v0, vfin}, t_steps, n);
#define LIF_FWD(VEC_) \
  launch_fwd<T, VEC_>(x, v0, s, vpre, vfin, t_steps, n, decay, theta, hard, stream)
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) { LIF_FWD(8); break; }
      return static_cast<int>(cudaErrorInvalidValue);
    case 4: LIF_FWD(4); break;
    case 2: LIF_FWD(2); break;
    default: LIF_FWD(1); break;
  }
#undef LIF_FWD
  return static_cast<int>(cudaGetLastError());
}

int forward(const void* x, const void* v0, void* s, void* vpre, void* vfin,
            int64_t t_steps, int64_t n, float decay, float theta, int hard,
            int dtype_code, void* stream) {
  if (t_steps < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return forward_t<__nv_bfloat16>(x, v0, s, vpre, vfin, t_steps, n, decay, theta, hard, st);
  if (dtype_code == 0)
    return forward_t<float>(x, v0, s, vpre, vfin, t_steps, n, decay, theta, hard, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int VEC>
void launch_bwd(const void* vpre, const void* gs, const void* gvfin, void* gx, void* gv0,
                int64_t t_steps, int64_t n, float decay, float theta, float slope,
                int hard, cudaStream_t stream) {
  const int64_t n_vec = n / VEC;
  const unsigned blocks = grid_for(n_vec + (n - n_vec * VEC));
#define LIF_LAUNCH(HARD_)                                                             \
  lif_scan_bwd_kernel<T, VEC, HARD_><<<blocks, THREADS, 0, stream>>>(                 \
      static_cast<const T*>(vpre), static_cast<const T*>(gs),                         \
      static_cast<const float*>(gvfin), static_cast<T*>(gx), static_cast<float*>(gv0), \
      t_steps, n, n_vec, decay, theta, slope)
  if (hard) LIF_LAUNCH(true);
  else LIF_LAUNCH(false);
#undef LIF_LAUNCH
}

template <typename T>
int backward_t(const void* vpre, const void* gs, const void* gvfin, void* gx, void* gv0,
               int64_t t_steps, int64_t n, float decay, float theta, float slope, int hard,
               cudaStream_t stream) {
  const int vec = pick_vec<T>({vpre, gs, gx}, {gvfin, gv0}, t_steps, n);
#define LIF_BWD(VEC_) \
  launch_bwd<T, VEC_>(vpre, gs, gvfin, gx, gv0, t_steps, n, decay, theta, slope, hard, stream)
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) { LIF_BWD(8); break; }
      return static_cast<int>(cudaErrorInvalidValue);
    case 4: LIF_BWD(4); break;
    case 2: LIF_BWD(2); break;
    default: LIF_BWD(1); break;
  }
#undef LIF_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. x, s, vpre, gs, gx are contiguous
// (T, N) arrays of that dtype; v0, vfin, gvfin, gv0 hold N floats. Every
// entry point returns cudaGetLastError() after its launch (0 on success).

// Inference forward.
extern "C" int lif_scan_fwd(const void* x, const void* v0, void* s, void* vfin,
                            int64_t t_steps, int64_t n, float decay, float theta,
                            int hard, int dtype_code, void* stream) {
  return forward(x, v0, s, nullptr, vfin, t_steps, n, decay, theta, hard, dtype_code, stream);
}

// Forward that also stores the pre-reset membrane of every step, rounded
// to x's dtype: the residual the backward runs on.
extern "C" int lif_scan_fwd_res(const void* x, const void* v0, void* s, void* vpre,
                                void* vfin, int64_t t_steps, int64_t n, float decay,
                                float theta, int hard, int dtype_code, void* stream) {
  if (vpre == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward(x, v0, s, vpre, vfin, t_steps, n, decay, theta, hard, dtype_code, stream);
}

// Reverse-time backward.
extern "C" int lif_scan_bwd(const void* vpre, const void* gs, const void* gvfin, void* gx,
                            void* gv0, int64_t t_steps, int64_t n, float decay, float theta,
                            float slope, int hard, int dtype_code, void* stream) {
  if (t_steps < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return backward_t<__nv_bfloat16>(vpre, gs, gvfin, gx, gv0, t_steps, n, decay, theta,
                                     slope, hard, st);
  if (dtype_code == 0)
    return backward_t<float>(vpre, gs, gvfin, gx, gv0, t_steps, n, decay, theta, slope,
                             hard, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
