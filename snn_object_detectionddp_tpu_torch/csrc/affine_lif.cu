// Fused per-(t, b, c) affine (GroupNorm normalize) + LIF scan over T:
// inference forward, forward saving the v_pre residual, and the
// reverse-time surrogate-gradient backward.
//
// Replaces the JAX package's Pallas kernels in
// snn_object_detectionddp_tpu/kernels/affine_lif_pallas.py:
//   affine_lif_fwd      <- _fwd_kernel      (inference forward)
//   affine_lif_fwd_res  <- _fwd_res_kernel  (forward under differentiation)
//   affine_lif_bwd      <- _bwd_kernel      (BPTT backward)
//
// ---- forward ----
// Computes, per element of the channels-last conv output x (T*B, H, W, C),
// time-major:
//   cur = x * a[t, b, c] + b[t, b, c]          (fp32)
//   v'  = decay * v + cur
//   s   = (v' >= threshold)
//   v   = v' - s * threshold  (soft)   |   v' * (1 - s)  (hard)
//   readout = v + s * threshold        (optional, per step)
//   residual = v'                      (optional, per step, rounded to x's dtype)
// and writes spikes, readouts and residuals in x's dtype, v_final in fp32.
//
// Bound: memory bytes. Each element moves x and s once per step (2 B each
// in bf16), the readout or the residual once per step when asked (2 B), and
// v0/v_final once (4 B each): (4 + 2*[aux]) * T + 8 bytes per element in bf16, against
// ~10 flops per element-step. Design for that bound: one thread owns a
// vector of VEC consecutive channels at one (b, h, w) and runs the whole T
// loop with the membrane in registers, so x is read once and nothing but
// the outputs is written; loads and stores are VEC-wide (16 bytes for x)
// and coalesced along C; a and b are read per (t, b, c) and stay in L1/L2.
// Arithmetic uses the _rn intrinsics so no multiply-add is contracted: the
// result is bit-identical to the plain PyTorch version's separate ops.
//
// ---- backward ----
// Per element, walking t from T-1 down to 0 with gv = g_vfinal at the start:
//   shifted = v' - threshold                    (v' = the saved residual)
//   sur     = 1 / (slope * |shifted| + 1)^2
//   dpost   = 1 - threshold * sur  (soft)  |  (1 - H(shifted)) - v' * sur  (hard)
//   g_cur   = gv * dpost + g_s * sur
//   g_x     = g_cur * a[t, b, c]                (x's dtype)
//   da[t, b, c] += g_cur * x ;  db[t, b, c] += g_cur      (summed over H, W)
//   gv      = decay * g_cur
// and g_v0 = gv after t = 0.
//
// Bound: memory bytes. v', x, g_s are read and g_x written once per step
// (2 B each in bf16), g_vfinal read and g_v0 written once (4 B each):
// 8 * T + 8 bytes per element in bf16, against ~20 flops and one division
// per element-step. Design: a block owns a run of pixels of ONE batch
// sample and a tile of channels; thread (x, y) owns VEC consecutive
// channels (x) of BWD_PPT pixels (y, y + ny, ...), so every pixel of a
// block sees the same thread -> channel map whatever C/VEC is (6 for the
// C=48 stem). gv of its pixels stays in registers over the T loop; loads
// are VEC-wide and a block reads whole contiguous pixel rows. The da/db
// sums cross blocks, which run in no order, so they are taken in two
// stages with a fixed order and no atomics: per step each thread sums its
// own pixels, the block sums over y through shared memory (rows padded to
// VEC+1 floats per thread against bank conflicts) and writes one partial
// row into a (P, T, B, C) fp32 scratch; the caller folds P with a plain
// sum. Two launches on the same inputs give bitwise-equal results. g_x and
// g_v0 use only per-element _rn operations and an IEEE division, so they
// equal the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "lif_common.cuh"

namespace {

using lifk::Vec;
using lifk::to_f32;
using lifk::from_f32;

// AUX selects the optional per-step output: none, the readouts
// (v_next + s*theta) or the residual (v_pre).
enum { AUX_NONE = 0, AUX_READS = 1, AUX_VPRE = 2 };

template <typename T, int VEC, bool HARD, int AUX>
__global__ void affine_lif_fwd_kernel(const T* __restrict__ x,
                                      const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      const float* __restrict__ v0,
                                      T* __restrict__ s,
                                      float* __restrict__ vfin,
                                      T* __restrict__ aux,
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
      Vec<T, VEC> xv_out;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float cur = __fadd_rn(__fmul_rn(to_f32(xv.v[k]), av.v[k]), bv.v[k]);
        const float v_pre = __fadd_rn(__fmul_rn(decay, v.v[k]), cur);
        const float sp = (v_pre >= theta) ? 1.0f : 0.0f;
        const float v_next = HARD ? __fmul_rn(v_pre, __fsub_rn(1.0f, sp))
                                  : __fsub_rn(v_pre, __fmul_rn(sp, theta));
        v.v[k] = v_next;
        sv.v[k] = from_f32<T>(sp);
        if (AUX == AUX_READS) xv_out.v[k] = from_f32<T>(__fadd_rn(v_next, __fmul_rn(sp, theta)));
        if (AUX == AUX_VPRE) xv_out.v[k] = from_f32<T>(v_pre);
      }
      *reinterpret_cast<Vec<T, VEC>*>(s + off) = sv;
      if (AUX != AUX_NONE) *reinterpret_cast<Vec<T, VEC>*>(aux + off) = xv_out;
    }
    *reinterpret_cast<Vec<float, VEC>*>(vfin + e) = v;
  }
}

template <typename T, int VEC>
void launch(const void* x, const void* a, const void* b, const void* v0, void* s,
            void* vfin, void* aux, int aux_kind, int64_t t_steps, int64_t bsz,
            int64_t hw, int64_t c, float decay, float theta, int hard,
            cudaStream_t stream) {
  const int threads = 256;
  const int64_t n_vec = bsz * hw * c / VEC;
  int64_t blocks = (n_vec + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
#define LIF_LAUNCH(HARD_, AUX_)                                                    \
  affine_lif_fwd_kernel<T, VEC, HARD_, AUX_><<<blocks, threads, 0, stream>>>(      \
      static_cast<const T*>(x), static_cast<const float*>(a),                      \
      static_cast<const float*>(b), static_cast<const float*>(v0),                 \
      static_cast<T*>(s), static_cast<float*>(vfin), static_cast<T*>(aux),         \
      t_steps, bsz, hw, c, decay, theta)
  if (hard) {
    if (aux_kind == AUX_READS) LIF_LAUNCH(true, AUX_READS);
    else if (aux_kind == AUX_VPRE) LIF_LAUNCH(true, AUX_VPRE);
    else LIF_LAUNCH(true, AUX_NONE);
  } else {
    if (aux_kind == AUX_READS) LIF_LAUNCH(false, AUX_READS);
    else if (aux_kind == AUX_VPRE) LIF_LAUNCH(false, AUX_VPRE);
    else LIF_LAUNCH(false, AUX_NONE);
  }
#undef LIF_LAUNCH
}

// The vector paths need every pointer aligned to the widest vector they
// load (8 floats = 32 bytes); a view with an odd storage offset takes the
// scalar path instead.
bool aligned32(std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return (any % 32) == 0;
}

int forward(const void* x, const void* a, const void* b, const void* v0, void* s,
            void* vfin, void* aux, int aux_kind, int64_t t_steps, int64_t bsz,
            int64_t hw, int64_t c, float decay, float theta, int hard,
            int dtype_code, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned32({x, a, b, v0, s, vfin, aux});
#define LIF_FWD(T_, VEC_) \
  launch<T_, VEC_>(x, a, b, v0, s, vfin, aux, aux_kind, t_steps, bsz, hw, c, decay, theta, hard, st)
  if (dtype_code == 1) {
    if (c % 8 == 0 && aligned) LIF_FWD(__nv_bfloat16, 8);
    else LIF_FWD(__nv_bfloat16, 1);
  } else if (dtype_code == 0) {
    if (c % 4 == 0 && aligned) LIF_FWD(float, 4);
    else LIF_FWD(float, 1);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LIF_FWD
  return static_cast<int>(cudaGetLastError());
}

// Pixels per thread of the backward kernel (the Python wrapper sizes the
// partial-sum scratch with the same constant).
constexpr int BWD_PPT = 4;

template <typename T, int VEC, bool HARD>
__global__ void affine_lif_bwd_kernel(const T* __restrict__ vpre,
                                      const T* __restrict__ x,
                                      const T* __restrict__ gs,
                                      const float* __restrict__ a,
                                      const float* __restrict__ gvfin,
                                      T* __restrict__ gx,
                                      float* __restrict__ gv0,
                                      float* __restrict__ da_part,
                                      float* __restrict__ db_part,
                                      int64_t t_steps, int64_t bsz, int64_t hw,
                                      int64_t c, float decay, float theta,
                                      float slope) {
  extern __shared__ float smem[];
  const int cvt = blockDim.x;  // channel vectors per block
  const int ny = blockDim.y;   // pixel lanes per block
  const int64_t ch0 = (int64_t)blockIdx.y * cvt * VEC;  // first channel of the tile
  const int64_t ch = ch0 + (int64_t)threadIdx.x * VEC;
  const bool ch_ok = ch < c;
  const int64_t bi = blockIdx.z;
  const int64_t pix0 = (int64_t)blockIdx.x * ny * BWD_PPT;
  const int row = cvt * (VEC + 1);
  float* sm_da = smem;             // [ny][row]
  float* sm_db = smem + ny * row;  // [ny][row]
  const int64_t per_step = bsz * hw * c;

  Vec<float, VEC> gv[BWD_PPT];
  int64_t e[BWD_PPT];
  bool ok[BWD_PPT];
#pragma unroll
  for (int j = 0; j < BWD_PPT; ++j) {
    const int64_t pix = pix0 + (int64_t)j * ny + threadIdx.y;
    ok[j] = ch_ok && pix < hw;
    e[j] = (bi * hw + pix) * c + ch;
    if (ok[j]) {
      gv[j] = *reinterpret_cast<const Vec<float, VEC>*>(gvfin + e[j]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) gv[j].v[k] = 0.0f;
    }
  }

  const int64_t tile_c = (c - ch0) < (int64_t)cvt * VEC ? (c - ch0) : (int64_t)cvt * VEC;
  const int n_out = static_cast<int>(tile_c);  // channels this block covers
  const int tid = threadIdx.y * cvt + threadIdx.x;
  const int n_threads = cvt * ny;
  const int sm_base = threadIdx.y * row + threadIdx.x * (VEC + 1);

  for (int64_t t = t_steps - 1; t >= 0; --t) {
    Vec<float, VEC> av;
    if (ch_ok) {
      av = *reinterpret_cast<const Vec<float, VEC>*>(a + (t * bsz + bi) * c + ch);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) av.v[k] = 0.0f;
    }
    float acc_a[VEC], acc_b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      acc_a[k] = 0.0f;
      acc_b[k] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BWD_PPT; ++j) {
      if (!ok[j]) continue;
      const int64_t off = t * per_step + e[j];
      const Vec<T, VEC> vp = *reinterpret_cast<const Vec<T, VEC>*>(vpre + off);
      const Vec<T, VEC> xv = *reinterpret_cast<const Vec<T, VEC>*>(x + off);
      const Vec<T, VEC> gsv = *reinterpret_cast<const Vec<T, VEC>*>(gs + off);
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
        const float g_cur = __fadd_rn(__fmul_rn(gv[j].v[k], dpost),
                                      __fmul_rn(to_f32(gsv.v[k]), sur));
        gxv.v[k] = from_f32<T>(__fmul_rn(g_cur, av.v[k]));
        acc_a[k] = __fadd_rn(acc_a[k], __fmul_rn(g_cur, to_f32(xv.v[k])));
        acc_b[k] = __fadd_rn(acc_b[k], g_cur);
        gv[j].v[k] = __fmul_rn(decay, g_cur);
      }
      *reinterpret_cast<Vec<T, VEC>*>(gx + off) = gxv;
    }
    // Stage 1 of the da/db reduction: this block's pixels, in y order.
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sm_da[sm_base + k] = acc_a[k];
      sm_db[sm_base + k] = acc_b[k];
    }
    __syncthreads();
    const int64_t part_row = (((int64_t)blockIdx.x * t_steps + t) * bsz + bi) * c + ch0;
    for (int o = tid; o < 2 * n_out; o += n_threads) {
      const int which = o / n_out;
      const int cc = o - which * n_out;
      const float* src = (which ? sm_db : sm_da) + cc + cc / VEC;
      float sum = 0.0f;
      for (int y = 0; y < ny; ++y) sum = __fadd_rn(sum, src[y * row]);
      (which ? db_part : da_part)[part_row + cc] = sum;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < BWD_PPT; ++j) {
    if (ok[j]) *reinterpret_cast<Vec<float, VEC>*>(gv0 + e[j]) = gv[j];
  }
}

template <typename T, int VEC>
int launch_bwd(const void* vpre, const void* x, const void* gs, const void* a,
               const void* gvfin, void* gx, void* gv0, void* da_part, void* db_part,
               int64_t t_steps, int64_t bsz, int64_t hw, int64_t c, float decay,
               float theta, float slope, int hard, int cvt, int ny, int64_t n_parts,
               cudaStream_t stream) {
  const int64_t cv = c / VEC;
  const int64_t c_tiles = (cv + cvt - 1) / cvt;
  if (c % VEC != 0 || cvt < 1 || ny < 1 || cvt * ny > 1024 || bsz > 65535 ||
      c_tiles > 65535 || n_parts != (hw + (int64_t)ny * BWD_PPT - 1) / ((int64_t)ny * BWD_PPT))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(cvt, ny, 1);
  const dim3 grid(static_cast<unsigned>(n_parts), static_cast<unsigned>(c_tiles),
                  static_cast<unsigned>(bsz));
  const size_t smem = sizeof(float) * 2 * ny * cvt * (VEC + 1);
#define LIF_BWD(HARD_)                                                             \
  affine_lif_bwd_kernel<T, VEC, HARD_><<<grid, block, smem, stream>>>(             \
      static_cast<const T*>(vpre), static_cast<const T*>(x),                       \
      static_cast<const T*>(gs), static_cast<const float*>(a),                     \
      static_cast<const float*>(gvfin), static_cast<T*>(gx),                       \
      static_cast<float*>(gv0), static_cast<float*>(da_part),                      \
      static_cast<float*>(db_part), t_steps, bsz, hw, c, decay, theta, slope)
  if (hard) LIF_BWD(true);
  else LIF_BWD(false);
#undef LIF_BWD
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Every entry point returns
// cudaGetLastError() after its launch (0 on success).

// Inference forward. reads may be null (no readouts).
extern "C" int affine_lif_fwd(const void* x, const void* a, const void* b,
                              const void* v0, void* s, void* vfin, void* reads,
                              int64_t t_steps, int64_t bsz, int64_t hw, int64_t c,
                              float decay, float theta, int hard, int dtype_code,
                              void* stream) {
  return forward(x, a, b, v0, s, vfin, reads, reads ? AUX_READS : AUX_NONE, t_steps,
                 bsz, hw, c, decay, theta, hard, dtype_code, stream);
}

// Forward that also stores the pre-reset membrane of every step, rounded
// to x's dtype: the residual the backward runs on.
extern "C" int affine_lif_fwd_res(const void* x, const void* a, const void* b,
                                  const void* v0, void* s, void* vpre, void* vfin,
                                  int64_t t_steps, int64_t bsz, int64_t hw, int64_t c,
                                  float decay, float theta, int hard, int dtype_code,
                                  void* stream) {
  if (vpre == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward(x, a, b, v0, s, vfin, vpre, AUX_VPRE, t_steps, bsz, hw, c, decay,
                 theta, hard, dtype_code, stream);
}

// Backward. vec is the channel vector width the caller planned (8 bf16 /
// 4 fp32 when C divides and every pointer is 32-byte aligned, else 1);
// a block is (cvt channel vectors) x (ny pixel lanes), each thread owning
// BWD_PPT pixels, and da_part/db_part are (n_parts, T, B, C) fp32 with
// n_parts = ceil(hw / (ny * BWD_PPT)).
extern "C" int affine_lif_bwd(const void* vpre, const void* x, const void* gs,
                              const void* a, const void* gvfin, void* gx, void* gv0,
                              void* da_part, void* db_part, int64_t t_steps,
                              int64_t bsz, int64_t hw, int64_t c, float decay,
                              float theta, float slope, int hard, int dtype_code,
                              int vec, int cvt, int ny, int64_t n_parts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec != 1 && !aligned32({vpre, x, gs, a, gvfin, gx, gv0}))
    return static_cast<int>(cudaErrorInvalidValue);
#define LIF_BWD_CALL(T_, VEC_)                                                      \
  launch_bwd<T_, VEC_>(vpre, x, gs, a, gvfin, gx, gv0, da_part, db_part, t_steps,   \
                       bsz, hw, c, decay, theta, slope, hard, cvt, ny, n_parts, st)
  if (dtype_code == 1 && vec == 8) return LIF_BWD_CALL(__nv_bfloat16, 8);
  if (dtype_code == 1 && vec == 1) return LIF_BWD_CALL(__nv_bfloat16, 1);
  if (dtype_code == 0 && vec == 4) return LIF_BWD_CALL(float, 4);
  if (dtype_code == 0 && vec == 1) return LIF_BWD_CALL(float, 1);
#undef LIF_BWD_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int affine_lif_bwd_pixels_per_thread() { return BWD_PPT; }
