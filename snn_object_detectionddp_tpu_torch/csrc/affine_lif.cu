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
// v0/v_final once (4 B each): (4 + 2*[aux]) * T + 8 bytes per element in
// bf16, against ~10 flops per element-step. At T = 1 on one sample the
// small late-stage shapes move less than a microsecond's worth of bytes,
// so what is left to win there is latency: few dependent operations
// before the first load and every load of a thread in flight at once.
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
// per element-step.
//
// ---- the geometry all three kernels share ----
// A block owns a narrow tile of channels (cvt vectors of VEC channels: a
// 32-128 byte segment of a pixel, 64-128 wherever a power of two of
// vectors divides C so) and a run of pixels of ONE sample. Thread
// i of a block owns channel vector i % cvt of the tile at the pixels
// py, py + ny, ... (py = i / cvt, ny = threads / cvt; 1, 2 or 4 pixels in
// the forwards, one in the backward), for the whole T loop, with the
// membrane (or gv) in registers. So the channel index is a thread
// constant: there is no division or modulo per work item, a[t, b, c..] and
// b[t, b, c..] are loaded once per thread and step and shared by its
// pixels, and element offsets are 32-bit (the launcher refuses
// B*H*W*C >= 2^31). Blocks are numbered channel tile fastest, so
// the blocks that run together read one contiguous range of memory. The
// narrow tile is what fills the card on the small late-stage shapes:
// 2 x 8 x 10 x 1024 in bf16 is 160 blocks of 128 threads for 132 SMs.
// Bytes are kept in flight without a barrier in the recurrence. The
// forwards start every load of the next step (all of a thread's pixels,
// and a/b) before the arithmetic of the current one, in registers. The
// backward's three streams of a step go through a per-thread ring of
// asynchronous 16-byte copies (cp.async) in shared memory, RING_DEPTH
// steps deep: a thread reads back only what it copied itself, so the ring
// needs no barrier either, and the steps in flight cost no registers. On
// the card (H100) the shallowest ring, 2 steps, was the fastest (5 and 3
// steps deep were 9% and 4% slower over the 20 main-path shapes) and beat
// the register prefetch by about a tenth: what pays is occupancy, which the ring's
// shared memory and the registers bound, not a deeper look-ahead. For the
// same reason several pixels a thread, held at once or walked in turn by
// fewer, longer-lived blocks, were slower in the backward and are not
// kept; the forwards hold 2 or 4 where the shape is large. A ring of
// contiguous tiles filled by cp.async.bulk does not fit this geometry (a
// narrow channel tile is not contiguous) and was not built. x, the
// cotangent streams and the per-step outputs are touched once and carry
// the streaming (evict-first) hint or bypass L1.
// Arithmetic uses the _rn intrinsics so no multiply-add is contracted, and
// an IEEE division: every per-element output is bit-identical to the plain
// PyTorch version's separate ops.
//
// ---- the backward's sums ----
// da/db sum over the pixels of a sample, which cross threads and blocks.
// The reduction is out of the recurrence: per step the lanes of a warp
// that share a channel vector
// (cvt is a power of two <= 32) add up with __shfl_xor_sync in a fixed
// order, and lanes 0..cvt-1 park the warp's sums in a shared-memory slot
// [step][warp]; no barrier. After the loop (or after every t_chunk steps
// when T is large) one barrier, the warps' slots are added in warp order
// and the block writes one partial row per step into a (runs, T, B, C)
// fp32 scratch. The partial rows of a (sample, channel tile) are then added
// by a tree of fixed shape inside the same launch: runs are grouped `fan`
// at a time; a block that has written its row takes a ticket of its group
// (__threadfence() and one atomicAdd), and the block that draws a group's
// last ticket adds the group's rows IN RUN ORDER into one row of the next
// level, resets the ticket and goes on as that row's owner, until a single
// row is left, which it writes to da/db. The atomics only elect who adds;
// they add nothing to a sum, so two launches on the same inputs give
// bitwise-equal da/db. A tree rather than one last block because the stem
// shapes have few channel tiles and hundreds of runs: one block adding 600
// rows would be a tail as long as the kernel. A thread of the adding block
// takes four neighbouring channels (one 16-byte load a row) and two such
// sums at a time, so that its loads overlap. There is no second launch and
// no fold in the wrapper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "lif_common.cuh"

namespace {

using lifk::Vec;
using lifk::to_f32;
using lifk::from_f32;

// Sums that one thread of the backward's tree adds at a time.
constexpr int FOLD_BATCH = 2;

// AUX selects the optional per-step output: none, the readouts
// (v_next + s*theta) or the residual (v_pre).
enum { AUX_NONE = 0, AUX_READS = 1, AUX_VPRE = 2 };

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}
template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Vec<T, VEC>& v) {
  *reinterpret_cast<Vec<T, VEC>*>(p) = v;
}

// Loads and stores of data that is touched once: the streaming hint where
// the vector is a whole number of 16-byte words.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_once(const T* p) {
  if constexpr (sizeof(Vec<T, VEC>) % 16 == 0) {
    Vec<T, VEC> out;
    const int4* src = reinterpret_cast<const int4*>(p);
    int4* dst = reinterpret_cast<int4*>(&out);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Vec<T, VEC>) / 16); ++i) dst[i] = __ldcs(src + i);
    return out;
  } else {
    return load<T, VEC>(p);
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void store_once(T* p, const Vec<T, VEC>& v) {
  if constexpr (sizeof(Vec<T, VEC>) % 16 == 0) {
    const int4* src = reinterpret_cast<const int4*>(&v);
    int4* dst = reinterpret_cast<int4*>(p);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Vec<T, VEC>) / 16); ++i) __stcs(dst + i, src[i]);
  } else {
    store<T, VEC>(p, v);
  }
}

// Which pixels and channels a thread owns (see the geometry note above).
// e[j] is the element offset of pixel j's channel vector inside one step.
template <int PPT>
struct Owned {
  uint32_t e[PPT];
  bool ok[PPT];
  uint32_t ch;     // first channel of the thread's vector
  uint32_t tile;   // channel tile of the block
  uint32_t run;    // pixel run of the block
  bool ch_ok;
};

template <int VEC, int PPT>
__device__ __forceinline__ Owned<PPT> owned(int hw, int c, int cvt, int c_tiles) {
  Owned<PPT> o;
  const uint32_t ny = blockDim.x / cvt;
  const uint32_t cx = threadIdx.x % cvt;
  const uint32_t py = threadIdx.x / cvt;
  o.tile = blockIdx.x % c_tiles;
  o.run = blockIdx.x / c_tiles;
  o.ch = (o.tile * cvt + cx) * VEC;
  o.ch_ok = py < ny && o.ch < (uint32_t)c;
  const uint32_t bi = blockIdx.y;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const uint32_t pix = (o.run * PPT + j) * ny + py;
    o.ok[j] = o.ch_ok && pix < (uint32_t)hw;
    o.e[j] = (bi * hw + pix) * c + o.ch;
  }
  return o;
}

template <typename T, int VEC, int PPT, bool HARD, int AUX>
__global__ void __launch_bounds__(256)
affine_lif_fwd_kernel(const T* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ b, const float* __restrict__ v0,
                      T* __restrict__ s, float* __restrict__ vfin, T* __restrict__ aux,
                      int t_steps, int bsz, int hw, int c, int cvt, int c_tiles,
                      float decay, float theta) {
  const Owned<PPT> o = owned<VEC, PPT>(hw, c, cvt, c_tiles);
  if (!o.ch_ok) return;
  const size_t per_step = (size_t)bsz * hw * c;
  const uint32_t ab_step = (uint32_t)bsz * c;
  const float* ap = a + blockIdx.y * c + o.ch;
  const float* bp = b + blockIdx.y * c + o.ch;

  Vec<T, VEC> xv[PPT];
  Vec<float, VEC> v[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    if (o.ok[j]) xv[j] = load_once<T, VEC>(x + o.e[j]);
  }
  Vec<float, VEC> av = load<float, VEC>(ap);
  Vec<float, VEC> bv = load<float, VEC>(bp);
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    if (o.ok[j]) v[j] = load<float, VEC>(v0 + o.e[j]);
  }

  for (int t = 0; t < t_steps; ++t) {
    // The next step's loads go out before this step's arithmetic.
    Vec<T, VEC> xn[PPT];
    Vec<float, VEC> an = av, bn = bv;
#pragma unroll
    for (int j = 0; j < PPT; ++j) xn[j] = xv[j];
    if (t + 1 < t_steps) {
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        if (o.ok[j]) xn[j] = load_once<T, VEC>(x + per_step + o.e[j]);
      }
      an = load<float, VEC>(ap + ab_step);
      bn = load<float, VEC>(bp + ab_step);
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      if (!o.ok[j]) continue;
      Vec<T, VEC> sv, out;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float cur = __fadd_rn(__fmul_rn(to_f32(xv[j].v[k]), av.v[k]), bv.v[k]);
        const float v_pre = __fadd_rn(__fmul_rn(decay, v[j].v[k]), cur);
        const float sp = (v_pre >= theta) ? 1.0f : 0.0f;
        const float v_next = HARD ? __fmul_rn(v_pre, __fsub_rn(1.0f, sp))
                                  : __fsub_rn(v_pre, __fmul_rn(sp, theta));
        v[j].v[k] = v_next;
        sv.v[k] = from_f32<T>(sp);
        if (AUX == AUX_READS) out.v[k] = from_f32<T>(__fadd_rn(v_next, __fmul_rn(sp, theta)));
        if (AUX == AUX_VPRE) out.v[k] = from_f32<T>(v_pre);
      }
      store_once<T, VEC>(s + o.e[j], sv);
      if (AUX != AUX_NONE) store_once<T, VEC>(aux + o.e[j], out);
    }
#pragma unroll
    for (int j = 0; j < PPT; ++j) xv[j] = xn[j];
    av = an;
    bv = bn;
    x += per_step;
    s += per_step;
    if (AUX != AUX_NONE) aux += per_step;
    ap += ab_step;
    bp += ab_step;
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    if (o.ok[j]) store<float, VEC>(vfin + o.e[j], v[j]);
  }
}

// The vector paths need every pointer aligned to the widest vector they
// load (8 floats = 32 bytes); a view with an odd storage offset takes the
// scalar path instead.
bool aligned32(std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return (any % 32) == 0;
}

// The grid of a plan, or false when the plan or the sizes cannot be
// launched: grid.x = channel tiles x pixel runs, grid.y = samples.
bool plan_grid(int64_t t_steps, int64_t bsz, int64_t hw, int64_t c, int vec, int cvt,
               int ppt, int threads, dim3* grid, int* c_tiles, int64_t* n_runs) {
  if (t_steps < 1 || bsz < 1 || hw < 1 || c < 1 || vec < 1 || c % vec != 0) return false;
  // 32-bit offsets inside one step and inside the (T, B, C) rows
  if (t_steps > INT32_MAX || bsz * hw * c > INT32_MAX || t_steps * bsz * c > INT32_MAX)
    return false;
  if (cvt < 1 || ppt < 1 || threads < cvt || threads > 256 || bsz > 65535) return false;
  const int64_t cv = c / vec;
  const int64_t tiles = (cv + cvt - 1) / cvt;
  const int64_t per_block = (int64_t)(threads / cvt) * ppt;
  const int64_t runs = (hw + per_block - 1) / per_block;
  if (tiles * runs > INT32_MAX) return false;
  *grid = dim3(static_cast<unsigned>(tiles * runs), static_cast<unsigned>(bsz), 1);
  *c_tiles = static_cast<int>(tiles);
  *n_runs = runs;
  return true;
}

template <typename T, int VEC, int PPT>
void launch_fwd(const void* x, const void* a, const void* b, const void* v0, void* s,
                void* vfin, void* aux, int aux_kind, int t_steps, int bsz, int hw, int c,
                int cvt, int c_tiles, float decay, float theta, int hard, dim3 grid,
                int threads, cudaStream_t stream) {
#define LIF_LAUNCH(HARD_, AUX_)                                                         \
  affine_lif_fwd_kernel<T, VEC, PPT, HARD_, AUX_><<<grid, threads, 0, stream>>>(        \
      static_cast<const T*>(x), static_cast<const float*>(a),                           \
      static_cast<const float*>(b), static_cast<const float*>(v0),                      \
      static_cast<T*>(s), static_cast<float*>(vfin), static_cast<T*>(aux),              \
      t_steps, bsz, hw, c, cvt, c_tiles, decay, theta)
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

// vec is the channel vector width the caller planned: 8 bf16 / 4 fp32 when
// C divides and every pointer is 32-byte aligned, else 1.
int forward(const void* x, const void* a, const void* b, const void* v0, void* s,
            void* vfin, void* aux, int aux_kind, int64_t t_steps, int64_t bsz,
            int64_t hw, int64_t c, float decay, float theta, int hard,
            int dtype_code, int vec, int cvt, int ppt, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid;
  int c_tiles;
  int64_t n_runs;
  if (!plan_grid(t_steps, bsz, hw, c, vec, cvt, ppt, threads, &grid, &c_tiles, &n_runs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec != 1 && !aligned32({x, a, b, v0, s, vfin, aux}))
    return static_cast<int>(cudaErrorInvalidValue);
#define LIF_FWD(T_, VEC_, PPT_)                                                          \
  launch_fwd<T_, VEC_, PPT_>(x, a, b, v0, s, vfin, aux, aux_kind, (int)t_steps, (int)bsz, \
                             (int)hw, (int)c, cvt, c_tiles, decay, theta, hard, grid,    \
                             threads, st)
#define LIF_FWD_PPT(T_, VEC_)                              \
  if (ppt == 1) LIF_FWD(T_, VEC_, 1);                      \
  else if (ppt == 2) LIF_FWD(T_, VEC_, 2);                 \
  else if (ppt == 4) LIF_FWD(T_, VEC_, 4);                 \
  else return static_cast<int>(cudaErrorInvalidValue)
  if (dtype_code == 1 && vec == 8) { LIF_FWD_PPT(__nv_bfloat16, 8); }
  else if (dtype_code == 0 && vec == 4) { LIF_FWD_PPT(float, 4); }
  else if (dtype_code == 1 && vec == 1 && ppt == 1) LIF_FWD(__nv_bfloat16, 1, 1);
  else if (dtype_code == 0 && vec == 1 && ppt == 1) LIF_FWD(float, 1, 1);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef LIF_FWD_PPT
#undef LIF_FWD
  return static_cast<int>(cudaGetLastError());
}

// Steps of the backward's three input streams that a thread keeps in
// flight in its shared-memory ring.
constexpr int RING_DEPTH = 2;

__device__ __forceinline__ void async_copy16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <int W>
__device__ __forceinline__ Vec<float, W> load_l2(const float* p) {
  if constexpr (W == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    return Vec<float, 4>{{v.x, v.y, v.z, v.w}};
  } else {
    return Vec<float, 1>{{__ldcg(p)}};
  }
}

// At most 85 registers a thread, so that three blocks of 256 fit an SM.
template <typename T, int VEC, bool HARD>
__global__ void __launch_bounds__(256, 3)
affine_lif_bwd_kernel(const T* __restrict__ vpre, const T* __restrict__ x,
                      const T* __restrict__ gs, const float* __restrict__ a,
                      const float* __restrict__ gvfin, T* __restrict__ gx,
                      float* __restrict__ gv0, float* __restrict__ da,
                      float* __restrict__ db, float* __restrict__ part,
                      int* __restrict__ tickets, int t_steps, int bsz, int hw, int c,
                      int cvt, int c_tiles, int n_runs, int t_chunk, int fan, float decay,
                      float theta, float slope) {
  // With 16-byte vectors the three streams come through a ring of
  // asynchronous copies; the scalar path prefetches one step in registers.
  constexpr bool RING = sizeof(Vec<T, VEC>) == 16;
  extern __shared__ int4 shared[];  // ring [RING_DEPTH][3][threads], then the slots
  __shared__ int folds;             // this block drew its group's last ticket
  const int tid = threadIdx.x;
  int4* ring = shared + tid;
  float* slots =  // [t_chunk][warps][2][VEC][cvt]
      reinterpret_cast<float*>(shared + (RING ? RING_DEPTH * 3 * blockDim.x : 0));
  const Owned<1> o = owned<VEC, 1>(hw, c, cvt, c_tiles);
  const bool ok = o.ok[0];
  const uint32_t e = o.e[0];
  const int bi = blockIdx.y;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int slot_floats = 2 * VEC * cvt;  // one warp's sums of one step
  const int tile_c = cvt * VEC;           // channels of a full tile: a power of two
  const int lg_tile_c = __ffs(tile_c) - 1;
  const int ch0 = o.tile * tile_c;        // first channel of this block's tile
  const size_t per_step = (size_t)bsz * hw * c;
  const uint32_t ab_step = (uint32_t)bsz * c;
  const size_t tbc = (size_t)t_steps * ab_step;  // floats of one (T, B, C) row

  // Everything below walks back from the last step: the i-th step from
  // the end lies i * per_step before these.
  const size_t last = (size_t)(t_steps - 1) * per_step + e;
  vpre += last;
  x += last;
  gs += last;
  gx += last;
  const float* ap = a + (size_t)(t_steps - 1) * ab_step + bi * c + o.ch;

  // Copies of the i-th step from the end into ring slot i % RING_DEPTH.
  auto fetch = [&](int i) {
    if (ok && i < t_steps) {
      int4* dst = ring + (i % RING_DEPTH) * 3 * blockDim.x;
      const size_t back = (size_t)i * per_step;
      async_copy16(dst, vpre - back);
      async_copy16(dst + blockDim.x, gs - back);
      async_copy16(dst + 2 * blockDim.x, x - back);
    }
    async_commit();  // one group per call, empty or not: the waits count groups
  };
  Vec<T, VEC> vp, xv, gsv;
  if constexpr (RING) {
#pragma unroll
    for (int i = 0; i < RING_DEPTH; ++i) fetch(i);
  } else if (ok) {
    vp = load<T, VEC>(vpre);
    gsv = load<T, VEC>(gs);
    xv = load<T, VEC>(x);
  }
  Vec<float, VEC> gv, av;
  if (o.ch_ok) av = load<float, VEC>(ap);
  if (ok) {
    gv = load<float, VEC>(gvfin + e);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) gv.v[k] = 0.0f;
  }

  int in_chunk = 0;  // steps parked in the slots since the last flush
  for (int i = 0; i < t_steps; ++i) {
    const int t = t_steps - 1 - i;
    // Step t-1's loads go out before step t's arithmetic.
    Vec<T, VEC> vpn = vp, xn = xv, gsn = gsv;
    Vec<float, VEC> an = av;
    if (t > 0) {
      if (!RING && ok) {
        const size_t back = (size_t)(i + 1) * per_step;
        vpn = load<T, VEC>(vpre - back);
        gsn = load<T, VEC>(gs - back);
        xn = load<T, VEC>(x - back);
      }
      if (o.ch_ok) an = load<float, VEC>(ap - ab_step);
    }
    if constexpr (RING) {
      async_wait<RING_DEPTH - 1>();  // this thread's copies of step t have landed
      if (ok) {
        const int4* src = ring + (i % RING_DEPTH) * 3 * blockDim.x;
        *reinterpret_cast<int4*>(&vp) = src[0];
        *reinterpret_cast<int4*>(&gsv) = src[blockDim.x];
        *reinterpret_cast<int4*>(&xv) = src[2 * blockDim.x];
      }
    }
    float acc_a[VEC], acc_b[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      acc_a[k] = 0.0f;
      acc_b[k] = 0.0f;
    }
    if (ok) {
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
        const float g_cur = __fadd_rn(__fmul_rn(gv.v[k], dpost),
                                      __fmul_rn(to_f32(gsv.v[k]), sur));
        gxv.v[k] = from_f32<T>(__fmul_rn(g_cur, av.v[k]));
        acc_a[k] = __fmul_rn(g_cur, to_f32(xv.v[k]));
        acc_b[k] = g_cur;
        gv.v[k] = __fmul_rn(decay, g_cur);
      }
      store_once<T, VEC>(gx - (size_t)i * per_step, gxv);
    }
    // The ring slot is free once its values are in registers and used.
    if constexpr (RING) fetch(i + RING_DEPTH);
    // The lanes of this warp that share a channel vector, in a fixed order.
    for (int m = cvt; m < 32; m <<= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        acc_a[k] = __fadd_rn(acc_a[k], __shfl_xor_sync(0xffffffffu, acc_a[k], m));
        acc_b[k] = __fadd_rn(acc_b[k], __shfl_xor_sync(0xffffffffu, acc_b[k], m));
      }
    }
    if (lane < cvt) {
      float* slot = slots + (in_chunk * n_warps + warp) * slot_floats + lane;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        slot[k * cvt] = acc_a[k];
        slot[(VEC + k) * cvt] = acc_b[k];
      }
    }
    ++in_chunk;
    if (in_chunk == t_chunk || t == 0) {
      // The warps' slots, added in warp order: one partial row per step.
      __syncthreads();
      const int t_first = t + in_chunk - 1;  // the step parked in slot 0
      for (int n = tid; n < 2 * tile_c; n += blockDim.x) {
        const int cc = n & (tile_c - 1);
        const int which = n >> lg_tile_c;
        if (ch0 + cc >= c) continue;
        const float* src = slots + (which * VEC + cc % VEC) * cvt + cc / VEC;
        float* dst = part + ((size_t)which * n_runs + o.run) * tbc + bi * c + ch0 + cc;
        for (int step = 0; step < in_chunk; ++step) {
          float sum = 0.0f;
          for (int w = 0; w < n_warps; ++w)
            sum = __fadd_rn(sum, src[(step * n_warps + w) * slot_floats]);
          dst[(t_first - step) * ab_step] = sum;
        }
      }
      __syncthreads();
      in_chunk = 0;
    }
    vp = vpn;
    xv = xn;
    gsv = gsn;
    av = an;
    ap -= ab_step;
  }
  if (ok) store<float, VEC>(gv0 + e, gv);

  // The tree over this (sample, channel tile)'s partial rows. Level 0 is
  // part[2][n_runs][T][B][C]; each level's rows follow the one before.
  constexpr int W = VEC % 4 == 0 ? 4 : 1;  // floats a thread adds side by side
  int idx = o.run;  // the row of this level that this block owns
  int n = n_runs;   // rows of this level
  float* src = part;
  int* level_tickets = tickets;
  while (true) {
    const int n_next = (n + fan - 1) / fan;
    const int group = idx / fan;
    const int first = group * fan;
    const int count = min(fan, n - first);
    int* ticket = level_tickets + (bi * c_tiles + o.tile) * n_next + group;
    __threadfence();
    __syncthreads();
    if (tid == 0) folds = (atomicAdd(ticket, 1) == count - 1);
    __syncthreads();
    if (!folds) return;
    __threadfence();
    float* dst = src + 2 * n * tbc;
    // FOLD_BATCH sums of W floats a thread at a time, so that their loads overlap.
    const int n_out = t_steps * 2 * tile_c / W;
    for (int base = tid; base < n_out; base += FOLD_BATCH * blockDim.x) {
      const float* rows[FOLD_BATCH];
      float* out[FOLD_BATCH];
      Vec<float, W> sum[FOLD_BATCH];
#pragma unroll
      for (int k = 0; k < FOLD_BATCH; ++k) {
        const int i = (base + k * blockDim.x) * W;
        const int cc = i & (tile_c - 1);
        const int which = (i >> lg_tile_c) & 1;
        const int t = i >> (lg_tile_c + 1);
        const uint32_t row = t * ab_step + bi * c + ch0 + cc;
        rows[k] = (i < n_out * W && ch0 + cc < c) ? src + ((size_t)which * n + first) * tbc + row
                                                  : nullptr;
        out[k] = n_next == 1 ? (which ? db : da) + row
                             : dst + ((size_t)which * n_next + group) * tbc + row;
#pragma unroll
        for (int w = 0; w < W; ++w) sum[k].v[w] = 0.0f;
      }
#pragma unroll 4
      for (int r = 0; r < count; ++r) {
#pragma unroll
        for (int k = 0; k < FOLD_BATCH; ++k) {
          if (!rows[k]) continue;
          const Vec<float, W> v = load_l2<W>(rows[k] + r * tbc);
#pragma unroll
          for (int w = 0; w < W; ++w) sum[k].v[w] = __fadd_rn(sum[k].v[w], v.v[w]);
        }
      }
#pragma unroll
      for (int k = 0; k < FOLD_BATCH; ++k) {
        if (rows[k]) store<float, W>(out[k], sum[k]);
      }
    }
    if (tid == 0) *ticket = 0;
    if (n_next == 1) return;
    level_tickets += bsz * c_tiles * n_next;
    src = dst;
    idx = group;
    n = n_next;
  }
}

template <typename T, int VEC>
int launch_bwd(const void* vpre, const void* x, const void* gs, const void* a,
               const void* gvfin, void* gx, void* gv0, void* da, void* db, void* part,
               void* tickets, int t_steps, int bsz, int hw, int c, int cvt, int c_tiles,
               int n_runs, int t_chunk, int fan, float decay, float theta, float slope,
               int hard, dim3 grid, int threads, size_t smem, cudaStream_t stream) {
#define LIF_BWD(HARD_)                                                                  \
  do {                                                                                  \
    auto kernel = affine_lif_bwd_kernel<T, VEC, HARD_>;                                 \
    if (smem > 48 * 1024) {                                                             \
      const cudaError_t err = cudaFuncSetAttribute(                                     \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)); \
      if (err != cudaSuccess) return static_cast<int>(err);                             \
    }                                                                                   \
    kernel<<<grid, threads, smem, stream>>>(                                            \
        static_cast<const T*>(vpre), static_cast<const T*>(x),                          \
        static_cast<const T*>(gs), static_cast<const float*>(a),                        \
        static_cast<const float*>(gvfin), static_cast<T*>(gx),                          \
        static_cast<float*>(gv0), static_cast<float*>(da), static_cast<float*>(db),     \
        static_cast<float*>(part), static_cast<int*>(tickets), t_steps, bsz, hw, c,     \
        cvt, c_tiles, n_runs, t_chunk, fan, decay, theta, slope);                       \
  } while (0)
  if (hard) LIF_BWD(true);
  else LIF_BWD(false);
#undef LIF_BWD
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Every entry point returns
// cudaGetLastError() after its launch (0 on success). vec, cvt, ppt and
// threads are the launch plan (kernels/affine_lif.py): vec channels per
// thread, cvt channel vectors per block, ppt pixels per thread.

// Inference forward. reads may be null (no readouts).
extern "C" int affine_lif_fwd(const void* x, const void* a, const void* b,
                              const void* v0, void* s, void* vfin, void* reads,
                              int64_t t_steps, int64_t bsz, int64_t hw, int64_t c,
                              float decay, float theta, int hard, int dtype_code,
                              int vec, int cvt, int ppt, int threads, void* stream) {
  return forward(x, a, b, v0, s, vfin, reads, reads ? AUX_READS : AUX_NONE, t_steps,
                 bsz, hw, c, decay, theta, hard, dtype_code, vec, cvt, ppt, threads, stream);
}

// Forward that also stores the pre-reset membrane of every step, rounded
// to x's dtype: the residual the backward runs on.
extern "C" int affine_lif_fwd_res(const void* x, const void* a, const void* b,
                                  const void* v0, void* s, void* vpre, void* vfin,
                                  int64_t t_steps, int64_t bsz, int64_t hw, int64_t c,
                                  float decay, float theta, int hard, int dtype_code,
                                  int vec, int cvt, int ppt, int threads, void* stream) {
  if (vpre == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward(x, a, b, v0, s, vfin, vpre, AUX_VPRE, t_steps, bsz, hw, c, decay,
                 theta, hard, dtype_code, vec, cvt, ppt, threads, stream);
}

// Backward. da, db are the (T, B, C) fp32 results. part holds the partial
// rows of every level of the tree, 2 * T * B * C floats for each of
// n_runs + ceil(n_runs / fan) + ... rows (down to the last level with more
// than one row; written before they are read). tickets holds one int per
// group of every level for each (sample, channel tile), zero before the
// launch and zero again after it. A thread owns one pixel; cvt must be a
// power of two <= 32 and threads a multiple of 32; n_runs is checked
// against the plan's own count. smem_bytes is the dynamic shared memory
// the plan accounts for (the vector path's ring of ring_depth steps, then
// the slots of t_chunk steps' sums); a plan made for another ring depth
// than this build's is refused.
extern "C" int affine_lif_bwd(const void* vpre, const void* x, const void* gs,
                              const void* a, const void* gvfin, void* gx, void* gv0,
                              void* da, void* db, void* part, void* tickets,
                              int64_t t_steps, int64_t bsz, int64_t hw, int64_t c,
                              float decay, float theta, float slope, int hard,
                              int dtype_code, int vec, int cvt, int threads, int t_chunk,
                              int fan, int64_t n_runs, int ring_depth, int64_t smem_bytes,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid;
  int c_tiles;
  int64_t runs;
  if (!plan_grid(t_steps, bsz, hw, c, vec, cvt, 1, threads, &grid, &c_tiles, &runs))
    return static_cast<int>(cudaErrorInvalidValue);
  if (runs != n_runs || cvt > 32 || (cvt & (cvt - 1)) != 0 || threads % 32 != 0 ||
      t_chunk < 1 || t_chunk > t_steps || fan < 2 || ring_depth != RING_DEPTH ||
      smem_bytes < 0 || smem_bytes > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec != 1 && !aligned32({vpre, x, gs, a, gvfin, gx, gv0}))
    return static_cast<int>(cudaErrorInvalidValue);
#define LIF_BWD_CALL(T_, VEC_)                                                           \
  launch_bwd<T_, VEC_>(vpre, x, gs, a, gvfin, gx, gv0, da, db, part, tickets,            \
                       (int)t_steps, (int)bsz, (int)hw, (int)c, cvt, c_tiles, (int)runs, \
                       t_chunk, fan, decay, theta, slope, hard, grid, threads,           \
                       static_cast<size_t>(smem_bytes), st)
  if (dtype_code == 1 && vec == 8) return LIF_BWD_CALL(__nv_bfloat16, 8);
  if (dtype_code == 0 && vec == 4) return LIF_BWD_CALL(float, 4);
  if (dtype_code == 1 && vec == 1) return LIF_BWD_CALL(__nv_bfloat16, 1);
  if (dtype_code == 0 && vec == 1) return LIF_BWD_CALL(float, 1);
#undef LIF_BWD_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}

// A kernel that does nothing, launched like the others: what one launch
// costs the card when launches follow each other on a stream. Timing only.
extern "C" int affine_lif_empty_launch(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
