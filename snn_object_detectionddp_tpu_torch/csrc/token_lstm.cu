// The token-LSTM bottleneck's 2-layer recurrence over every token of a
// window in one launch: inference forward, forward saving the backward's
// residuals, and the reverse scan.
//
// Replaces no Pallas kernel. The JAX package runs this recurrence as a
// lax.scan inside one XLA program (snn_object_detectionddp_tpu/models/
// token_lstm.py, the jax.lax.scan over tokens); the port's plain version
// is a Python loop of about 16 launches a cell (models/token_lstm.py::
// token_lstm_forward_reference), 800 cells a T=5 window at 8x10, and its
// autograd walks the same graph back. These kernels replace that loop.
//
// Shapes: H hidden units, G = 4H gate columns in the order (i, f, g, o),
// B batch rows, NT = T*N tokens (N = h*w a frame); a token's rows lie at
// row(n, b) = ((n / N) * B + b) * N + n % N of the (T, B, N, ...) arrays.
//
// ---- forward, layer l, token n (fp32 unless named) ----
//   a   = xg0[n] (l = 0) + bf16(h0_{n-1}) @ bf16(W_hh0) + bias0
//   a   = bf16(h0_n) @ bf16(W_ih1) + bf16(h1_{n-1}) @ bf16(W_hh1) + bias1  (l = 1)
//   i, f, o = sigmoid(a_i, a_f, a_o) = 1 / (1 + expf(-x));  g = tanhf(a_g)
//   c   = f * c + i * g;   h = o * tanhf(c);   y_n = bf16(h1_n)
// Products take bf16 operands and sum in fp32 (mma.sync m16n8k16); every
// other step is an IEEE fp32 operation (the _rn intrinsics: nothing is
// contracted into a fused multiply-add), expf and tanhf without fast-math.
// The residual variant stores (i, f, g, o) and c of every cell, the bf16
// recurrent input of each layer and layer 0's bf16 output.
//
// ---- reverse scan, from dh = dL/dh and dc carried from the next token ----
//   tc = tanhf(c);  do = dh * tc;  dct = dc + (dh * o) * (1 - tc * tc)
//   df = dct * c_prev;  di = dct * g;  dg = dct * i;  dc_prev = dct * f
//   da_i = di * (1 - i) * i, da_f likewise, da_o likewise; da_g = dg * (1 - g * g)
// with dh1_n = y's gradient + bf16(da1_{n+1} @ W_hh1^T) and
// dh0_n = bf16(da1_n @ W_ih1^T) + bf16(da0_{n+1} @ W_hh0^T) (each product
// rounded to bf16 alone, as the plain loop's autograd rounds at each
// .to(bf16).float() pair; the last token's dh and dc take the final carry's
// gradients). da stays fp32 as an operand: each value is split exactly
// into three bf16 terms (hi + mid + lo) and the three products are summed
// in fp32. The state's gradients are bf16(da_0 @ W_hh^T) and dc_prev at the
// first token. The weight and bias gradients are not summed here: they are
// one fp32 product each over all NT*B rows, outside (kernels/token_lstm.py).
//
// Bound: neither bytes nor FLOPs. A T=5 B=16 H=1024 window is 161 GFLOP of
// gate products (0.16 ms at the bf16 peak) and a few hundred MB, but every
// token waits for the one before: a chain of NT+1 steps that all blocks
// must finish in turn. The design shortens that chain and each link:
// - persistent blocks, one per SM (cooperative launch, so all are
//   resident), each owning 8 hidden units: their 32 gate columns in the
//   forward, their 8 rows of each W in the backward;
// - the block's slices of W_hh0, W_ih1 and W_hh1 held in shared memory as
//   bf16 for the whole launch (3 x 64 KB at H = 1024), so no weight byte
//   crosses L2 after the prologue; stored in mma fragment order, one
//   conflict-free 8-byte load per lane and k-step;
// - a wavefront: phase p runs layer 0 of token p and layer 1 of token p-1,
//   both reading only what phase p-1 wrote, so the forward takes NT+1
//   grid barriers for NT tokens (not 2 NT) and the reverse scan NT+1;
// - layer 0's input products do not depend on the recurrence: one GEMM over
//   all tokens before the launch (xg0);
// - h crosses blocks through a double-buffered bf16 exchange buffer laid
//   out in A-fragment order (one 16-byte L2 load per lane and k-step).
// The reverse scan reads the whole fp32 da of both layers in each phase
// (512 KB a block at B=16, the same lines in every block): those reads
// from L2 are most of its phase, and set its floor.
// Results do not depend on timing: no atomics on data, sums in a fixed
// order, so a launch is bitwise repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int UNITS = 8;          // hidden units a block owns
constexpr int THREADS = 512;      // 16 warps
constexpr int FWD_KGROUPS = 8;    // forward warp = (k-group, half of the 4 gate tiles)
constexpr int BWD_KGROUPS = 16;   // backward warp = k-group
constexpr int FWD_RED_BYTES = FWD_KGROUPS * 2 * 16 * 32 * 4;
constexpr int BWD_RED_BYTES = BWD_KGROUPS * 3 * 16 * UNITS * 4;

struct FwdArgs {
  const float* xg0;                            // (T, B, N, G): layer 0's input products
  const bf16* w_hh0; const bf16* w_ih1; const bf16* w_hh1;  // (H, G)
  const float* bias0; const float* bias1;      // (G)
  const float* h_init; const float* c_init;    // (2, B, H)
  bf16* y;                                     // (T, B, N, H)
  float* h_state; float* c_state;              // (2, B, H): the carry, final on return
  float* act;                                  // (2, T, B, N, G) or null
  float* cseq;                                 // (2, T, B, N, H) or null
  bf16* hseq;                                  // (3, T, B, N, H) or null
  bf16* xbuf;                                  // (2, 2, MT, KS, 32, 8), zeroed
  unsigned int* bar;                           // grid barrier counter, zeroed
  int T, B, N, H, KS, MT;
};

struct BwdArgs {
  const float* act; const float* cseq;         // the forward's residuals
  const float* c_init;                         // (2, B, H)
  const bf16* w_hh0; const bf16* w_ih1; const bf16* w_hh1;
  const bf16* dy;                              // (T, B, N, H)
  const float* g_hfin; const float* g_cfin;    // (2, B, H)
  float* dg;                                   // (2, T, B, N, G)
  float* g_h0;                                 // (2, B, H)
  float* dc_state;                             // (2, B, H): dc, g_c0 on return
  unsigned int* bar;
  int T, B, N, H, MT;
};

__device__ __forceinline__ int64_t row_of(int n, int b, int B, int N) {
  return ((int64_t)(n / N) * B + b) * N + n % N;
}

// All blocks arrive before any leaves. `bar` counts arrivals over the
// launch; `target` is this block's count of barriers passed times the grid.
// A wait of over 10 s (a block that never arrives) traps, so a fault ends
// the launch with an error instead of hanging the card.
__device__ __forceinline__ void grid_barrier(unsigned int* bar, unsigned int& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned int seen, polls = 0;
    uint64_t start, now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(start));
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(bar) : "memory");
      if ((++polls & 1023u) == 0) {
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
        if (now - start > UINT64_C(10000000000)) __trap();
      }
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void mma(float (&d)[4], const uint4& a, const uint2& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ unsigned short bits(bf16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float sigm(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// x = hi + mid + lo exactly, each a bf16 (a float has 24 significant bits).
struct Split { uint32_t hi, mid, lo; };
__device__ __forceinline__ Split split_pair(float2 v) {
  const bf16 h0 = __float2bfloat16_rn(v.x), h1 = __float2bfloat16_rn(v.y);
  const float r0 = __fsub_rn(v.x, __bfloat162float(h0)), r1 = __fsub_rn(v.y, __bfloat162float(h1));
  const bf16 m0 = __float2bfloat16_rn(r0), m1 = __float2bfloat16_rn(r1);
  const bf16 l0 = __float2bfloat16_rn(__fsub_rn(r0, __bfloat162float(m0)));
  const bf16 l1 = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(m1)));
  return {bits(h0) | ((uint32_t)bits(h1) << 16), bits(m0) | ((uint32_t)bits(m1) << 16),
          bits(l0) | ((uint32_t)bits(l1) << 16)};
}

__device__ __forceinline__ float2 load_pair(const float* row, int j) {
  return row ? __ldcg(reinterpret_cast<const float2*>(row + j)) : make_float2(0.0f, 0.0f);
}

// ---------------------------------------------------------------- forward

// Shared memory: the three weight slices as B fragments, [w][gate][k-step]
// [lane] of uint2 (w = W_hh0, W_ih1, W_hh1; the n of a gate's tile is the
// block's unit), then the k-groups' partial gate sums [kg][layer][16][32].
template <bool RES>
__global__ void __launch_bounds__(THREADS, 1) token_lstm_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* wsm = reinterpret_cast<uint2*>(smem);
  const int H = a.H, G = 4 * H, KS = a.KS, B = a.B, N = a.N, MT = a.MT;
  float* red = reinterpret_cast<float*>(smem + (size_t)3 * 4 * KS * 32 * sizeof(uint2));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit0 = blockIdx.x * UNITS;
  const int NT = a.T * N;

  // Prologue: the weight slices, 16-byte rows of 8 units at a time.
  unsigned short* wsh = reinterpret_cast<unsigned short*>(smem);
  for (int i = tid; i < 3 * 4 * KS * 16; i += THREADS) {
    const int k = i % (KS * 16), q = (i / (KS * 16)) % 4, w = i / (KS * 16 * 4);
    const bf16* W = w == 0 ? a.w_hh0 : (w == 1 ? a.w_ih1 : a.w_hh1);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < H) v = *reinterpret_cast<const uint4*>(W + (int64_t)k * G + q * H + unit0);
    const unsigned short* e = reinterpret_cast<const unsigned short*>(&v);
    const int s = k >> 4, kk = k & 15, half = kk >> 3, t = (kk & 7) >> 1, pos = kk & 1;
    for (int g = 0; g < UNITS; ++g) {
      const int word = (((w * 4 + q) * KS + s) * 32 + g * 4 + t) * 2 + half;
      wsh[word * 2 + pos] = e[g];
    }
  }
  // The carry, and the first products' operands: h_init[0] is what phase 0
  // reads (slot 1), h_init[1] what phase 1 reads (slot 0).
  for (int i = tid; i < 2 * B * UNITS; i += THREADS) {
    const int u = i % UNITS, b = (i / UNITS) % B, layer = i / (UNITS * B);
    const int64_t off = ((int64_t)layer * B + b) * H + unit0 + u;
    const float h = a.h_init[off];
    a.h_state[off] = h;
    a.c_state[off] = a.c_init[off];
    const int kk = unit0 + u, mt = b >> 4, bl = b & 15, c = kk & 7;
    const int slot = layer == 0 ? 1 : 0;
    const int64_t frag = ((((int64_t)slot * 2 + layer) * MT + mt) * KS + (kk >> 4)) * 32
                         + (bl & 7) * 4 + (c >> 1);
    a.xbuf[frag * 8 + (((kk & 15) >> 3) * 2 + (bl >> 3)) * 2 + (c & 1)] = __float2bfloat16_rn(h);
  }
  unsigned int target = 0;
  grid_barrier(a.bar, target);

  const int kg = warp >> 1, nh = warp & 1;
  const int s_beg = kg * KS / FWD_KGROUPS, s_end = (kg + 1) * KS / FWD_KGROUPS;
  const int g = lane >> 2, t = lane & 3;
  // A cell thread owns (layer, row of the tile, unit) in every phase.
  const bool cell = tid < 2 * 16 * UNITS;
  const int layer = tid >> 7, bl = (tid >> 3) & 15, u = tid & 7, unit = unit0 + u;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = cell ? (layer == 0 ? a.bias0 : a.bias1)[q * H + unit] : 0.0f;
  for (int p = 0; p <= NT; ++p) {
    const bool do0 = p < NT, do1 = p >= 1;
    const int rslot = (p + 1) & 1, wslot = p & 1;
    for (int mt = 0; mt < MT; ++mt) {
      // The cell's own inputs first: their loads fly during the products.
      const int b = mt * 16 + bl;
      const bool live = cell && b < B && (layer == 0 ? do0 : do1);
      const int n = layer == 0 ? p : p - 1;
      const int64_t row = live ? row_of(n, b, B, N) : 0;
      const int64_t st = ((int64_t)layer * B + b) * H + unit;
      float xg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, h_old = 0.0f, c_old = 0.0f;
      if (live) {
        if (layer == 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) xg[q] = a.xg0[row * G + q * H + unit];
        }
        h_old = a.h_state[st];
        c_old = a.c_state[st];
      }
      float acc0[2][4] = {}, acc1[2][4] = {};
      const uint4* A0 = reinterpret_cast<const uint4*>(a.xbuf) + (((int64_t)rslot * 2 + 0) * MT + mt) * KS * 32;
      const uint4* A1 = reinterpret_cast<const uint4*>(a.xbuf) + (((int64_t)rslot * 2 + 1) * MT + mt) * KS * 32;
#pragma unroll 2
      for (int s = s_beg; s < s_end; ++s) {
        const uint4 a0 = __ldcg(A0 + s * 32 + lane);
        const uint4 a1 = do1 ? __ldcg(A1 + s * 32 + lane) : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = nh * 2 + j;
          if (do0) mma(acc0[j], a0, wsm[((0 * 4 + q) * KS + s) * 32 + lane]);
          if (do1) {
            mma(acc1[j], a0, wsm[((1 * 4 + q) * KS + s) * 32 + lane]);
            mma(acc1[j], a1, wsm[((2 * 4 + q) * KS + s) * 32 + lane]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = (nh * 2 + j) * 8 + t * 2;
        float* r0 = red + ((kg * 2 + 0) * 16) * 32;
        float* r1 = red + ((kg * 2 + 1) * 16) * 32;
        r0[g * 32 + col] = acc0[j][0];       r0[g * 32 + col + 1] = acc0[j][1];
        r0[(g + 8) * 32 + col] = acc0[j][2]; r0[(g + 8) * 32 + col + 1] = acc0[j][3];
        r1[g * 32 + col] = acc1[j][0];       r1[g * 32 + col + 1] = acc1[j][1];
        r1[(g + 8) * 32 + col] = acc1[j][2]; r1[(g + 8) * 32 + col + 1] = acc1[j][3];
      }
      __syncthreads();
      if (live) {
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float sum = 0.0f;
          for (int k = 0; k < FWD_KGROUPS; ++k)
            sum = __fadd_rn(sum, red[((k * 2 + layer) * 16 + bl) * 32 + q * 8 + u]);
          if (layer == 0) sum = __fadd_rn(xg[q], sum);
          gate[q] = __fadd_rn(sum, bias[q]);
        }
        const float si = sigm(gate[0]), sf = sigm(gate[1]), tg = tanhf(gate[2]),
                    so = sigm(gate[3]);
        const float c = __fadd_rn(__fmul_rn(sf, c_old), __fmul_rn(si, tg));
        const float h = __fmul_rn(so, tanhf(c));
        a.c_state[st] = c;
        a.h_state[st] = h;
        const bf16 hb = __float2bfloat16_rn(h);
        const int cc = unit & 7;
        const int64_t frag = ((((int64_t)wslot * 2 + layer) * MT + mt) * KS + (unit >> 4)) * 32
                             + (bl & 7) * 4 + (cc >> 1);
        a.xbuf[frag * 8 + (((unit & 15) >> 3) * 2 + (bl >> 3)) * 2 + (cc & 1)] = hb;
        if (layer == 1) a.y[row * H + unit] = hb;
        if (RES) {
          const int64_t R = (int64_t)NT * B;
          float* act = a.act + ((int64_t)layer * R + row) * G + unit;
          act[0] = si; act[H] = sf; act[2 * H] = tg; act[3 * H] = so;
          a.cseq[((int64_t)layer * R + row) * H + unit] = c;
          a.hseq[((int64_t)layer * R + row) * H + unit] = __float2bfloat16_rn(h_old);
          if (layer == 0) a.hseq[(2 * R + row) * H + unit] = hb;
        }
      }
      __syncthreads();
    }
    if (p < NT) grid_barrier(a.bar, target);
  }
}

// --------------------------------------------------------------- backward

// Shared memory: the block's 8 rows of W_hh1, W_ih1 and W_hh0 as B
// fragments [w][k-step][lane] of uint2 (k = gate column, n = unit), then
// the k-groups' partial products [kg][product][16][8].
__global__ void __launch_bounds__(THREADS, 1) token_lstm_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* wsm = reinterpret_cast<uint2*>(smem);
  const int H = a.H, G = 4 * H, KS = G / 16, B = a.B, N = a.N, MT = a.MT;
  float* red = reinterpret_cast<float*>(smem + (size_t)3 * KS * 32 * sizeof(uint2));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit0 = blockIdx.x * UNITS;
  const int NT = a.T * N;
  const int64_t R = (int64_t)NT * B;

  // Prologue: row unit0 + u of each W, 8 gate columns (two half k-steps of
  // one lane quad) at a time.
  uint32_t* wwords = reinterpret_cast<uint32_t*>(smem);
  for (int i = tid; i < 3 * UNITS * (G / 8); i += THREADS) {
    const int m = i % (G / 8), u = (i / (G / 8)) % UNITS, w = i / (UNITS * (G / 8));
    const bf16* W = w == 0 ? a.w_hh1 : (w == 1 ? a.w_ih1 : a.w_hh0);
    const uint4 v = *reinterpret_cast<const uint4*>(W + (int64_t)(unit0 + u) * G + m * 8);
    const uint32_t e[4] = {v.x, v.y, v.z, v.w};
    const int s = m >> 1, half = m & 1;
    for (int t = 0; t < 4; ++t) wwords[(((w * KS) + s) * 32 + u * 4 + t) * 2 + half] = e[t];
  }
  for (int i = tid; i < 2 * B * UNITS; i += THREADS) {
    const int u = i % UNITS, b = (i / UNITS) % B, layer = i / (UNITS * B);
    const int64_t off = ((int64_t)layer * B + b) * H + unit0 + u;
    a.dc_state[off] = a.g_cfin[off];
  }
  __syncthreads();

  const int s_beg = warp * KS / BWD_KGROUPS, s_end = (warp + 1) * KS / BWD_KGROUPS;
  const int g = lane >> 2, t = lane & 3;
  // A cell thread owns (layer, row of the tile, unit) in every phase.
  const bool cell = tid < 2 * 16 * UNITS;
  const int layer = tid >> 7, bl = (tid >> 3) & 15, u = tid & 7, unit = unit0 + u;
  unsigned int target = 0;
  for (int q = 0; q <= NT + 1; ++q) {
    if (q >= 1) grid_barrier(a.bar, target);
    const int t1 = NT - 1 - q, t0 = NT - q;      // this phase's layer-1 and layer-0 tokens
    const bool p12 = q >= 1 && q <= NT;           // da1 of token t0 -> P1 (W_hh1), P2 (W_ih1)
    const bool p3 = q >= 2;                       // da0 of token t0 + 1 -> P3 (W_hh0)
    const int n = layer == 1 ? t1 : t0;           // the cell thread's token
    for (int mt = 0; mt < MT; ++mt) {
      // The cell's own inputs first (the forward's residuals, the carried
      // dc, y's or the carry's gradient): their loads fly during the products.
      const int b = mt * 16 + bl;
      const bool live = cell && b < B && n >= 0 && n < NT;
      const int64_t st = ((int64_t)layer * B + b) * H + unit;
      const int64_t row = live ? row_of(n, b, B, N) : 0;
      float ac[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c = 0.0f, c_prev = 0.0f, dc = 0.0f;
      float dy = 0.0f, g_last = 0.0f;
      if (live) {
        const float* act = a.act + ((int64_t)layer * R + row) * G + unit;
#pragma unroll
        for (int k = 0; k < 4; ++k) ac[k] = act[k * H];
        c = a.cseq[((int64_t)layer * R + row) * H + unit];
        c_prev = n > 0 ? a.cseq[((int64_t)layer * R + row_of(n - 1, b, B, N)) * H + unit]
                       : a.c_init[st];
        dc = a.dc_state[st];
        if (n == NT - 1) g_last = a.g_hfin[st];
        if (layer == 1) dy = __bfloat162float(a.dy[row * H + unit]);
      }
      float acc[3][3][4] = {};                    // [P1, P2, P3][lo, mid, hi][fragment]
      const int b0 = mt * 16 + g, b1 = b0 + 8;
      const float* d1r0 = (p12 && b0 < B) ? a.dg + (R + row_of(t0, b0, B, N)) * G : nullptr;
      const float* d1r1 = (p12 && b1 < B) ? a.dg + (R + row_of(t0, b1, B, N)) * G : nullptr;
      const float* d0r0 = (p3 && b0 < B) ? a.dg + row_of(t0 + 1, b0, B, N) * G : nullptr;
      const float* d0r1 = (p3 && b1 < B) ? a.dg + row_of(t0 + 1, b1, B, N) * G : nullptr;
#pragma unroll 2
      for (int s = s_beg; s < s_end; ++s) {
        const int j = s * 16 + t * 2;
        if (p12) {
          const Split e0 = split_pair(load_pair(d1r0, j)), e1 = split_pair(load_pair(d1r1, j));
          const Split e2 = split_pair(load_pair(d1r0, j + 8)), e3 = split_pair(load_pair(d1r1, j + 8));
          const uint4 hi = make_uint4(e0.hi, e1.hi, e2.hi, e3.hi);
          const uint4 mid = make_uint4(e0.mid, e1.mid, e2.mid, e3.mid);
          const uint4 lo = make_uint4(e0.lo, e1.lo, e2.lo, e3.lo);
          const uint2 w_hh1 = wsm[(0 * KS + s) * 32 + lane], w_ih1 = wsm[(1 * KS + s) * 32 + lane];
          mma(acc[0][0], lo, w_hh1); mma(acc[0][1], mid, w_hh1); mma(acc[0][2], hi, w_hh1);
          mma(acc[1][0], lo, w_ih1); mma(acc[1][1], mid, w_ih1); mma(acc[1][2], hi, w_ih1);
        }
        if (p3) {
          const Split e0 = split_pair(load_pair(d0r0, j)), e1 = split_pair(load_pair(d0r1, j));
          const Split e2 = split_pair(load_pair(d0r0, j + 8)), e3 = split_pair(load_pair(d0r1, j + 8));
          const uint2 w_hh0 = wsm[(2 * KS + s) * 32 + lane];
          mma(acc[2][0], make_uint4(e0.lo, e1.lo, e2.lo, e3.lo), w_hh0);
          mma(acc[2][1], make_uint4(e0.mid, e1.mid, e2.mid, e3.mid), w_hh0);
          mma(acc[2][2], make_uint4(e0.hi, e1.hi, e2.hi, e3.hi), w_hh0);
        }
      }
#pragma unroll
      for (int pr = 0; pr < 3; ++pr) {
        float* r = red + (warp * 3 + pr) * 16 * UNITS;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __fadd_rn(__fadd_rn(acc[pr][0][e], acc[pr][1][e]), acc[pr][2][e]);
          r[(g + (e >> 1) * 8) * UNITS + t * 2 + (e & 1)] = v;
        }
      }
      __syncthreads();
      if (cell && b < B) {
        float prod[3];
#pragma unroll
        for (int pr = 0; pr < 3; ++pr) {
          float sum = 0.0f;
          for (int k = 0; k < BWD_KGROUPS; ++k)
            sum = __fadd_rn(sum, red[((k * 3 + pr) * 16 + bl) * UNITS + u]);
          prod[pr] = sum;
        }
        if (live) {
          // dh = y's gradient + the next token's recurrent product (layer 1);
          // layer 1's input product + the next token's recurrent product
          // (layer 0); at the last token the carry's gradient for the latter.
          const float dh = layer == 1 ? __fadd_rn(dy, n == NT - 1 ? g_last : bfr(prod[0]))
                                      : __fadd_rn(bfr(prod[1]), n == NT - 1 ? g_last : bfr(prod[2]));
          const float si = ac[0], sf = ac[1], tg = ac[2], so = ac[3];
          const float tc = tanhf(c);
          const float d_so = __fmul_rn(dh, tc);
          const float d_tc = __fmul_rn(dh, so);
          const float dct = __fadd_rn(dc, __fmul_rn(d_tc, __fsub_rn(1.0f, __fmul_rn(tc, tc))));
          const float d_sf = __fmul_rn(dct, c_prev);
          const float d_si = __fmul_rn(dct, tg);
          const float d_tg = __fmul_rn(dct, si);
          a.dc_state[st] = __fmul_rn(dct, sf);
          float* dg = a.dg + ((int64_t)layer * R + row) * G + unit;
          dg[0] = __fmul_rn(__fmul_rn(d_si, __fsub_rn(1.0f, si)), si);
          dg[H] = __fmul_rn(__fmul_rn(d_sf, __fsub_rn(1.0f, sf)), sf);
          dg[2 * H] = __fmul_rn(d_tg, __fsub_rn(1.0f, __fmul_rn(tg, tg)));
          dg[3 * H] = __fmul_rn(__fmul_rn(d_so, __fsub_rn(1.0f, so)), so);
        } else if (n == -1) {  // the initial state's h: its first-token product
          a.g_h0[st] = bfr(prod[layer == 1 ? 0 : 2]);
        }
      }
      __syncthreads();
    }
  }
}

int max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <typename Kernel, typename Args>
int launch(Kernel kernel, Args args, int blocks, int smem, void* stream) {
  if (smem > max_smem_optin()) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(blocks),
                                    dim3(THREADS), params, (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int64_t t_steps, int64_t batch, int64_t tokens, int64_t hidden) {
  return t_steps < 1 || batch < 1 || tokens < 1 || hidden < UNITS || hidden % UNITS != 0 ||
         t_steps * tokens * batch * 4 * hidden > INT64_C(1) << 40;
}

int forward(const void* xg0, const void* w_hh0, const void* w_ih1, const void* w_hh1,
            const void* bias0, const void* bias1, const void* h_init, const void* c_init, void* y,
            void* h_fin, void* c_fin, void* act, void* cseq, void* hseq, void* xbuf, void* bar,
            int64_t t_steps, int64_t batch, int64_t tokens, int64_t hidden, void* stream) {
  if (bad_shape(t_steps, batch, tokens, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a;
  a.xg0 = static_cast<const float*>(xg0);
  a.w_hh0 = static_cast<const bf16*>(w_hh0);
  a.w_ih1 = static_cast<const bf16*>(w_ih1);
  a.w_hh1 = static_cast<const bf16*>(w_hh1);
  a.bias0 = static_cast<const float*>(bias0);
  a.bias1 = static_cast<const float*>(bias1);
  a.h_init = static_cast<const float*>(h_init);
  a.c_init = static_cast<const float*>(c_init);
  a.y = static_cast<bf16*>(y);
  a.h_state = static_cast<float*>(h_fin);
  a.c_state = static_cast<float*>(c_fin);
  a.act = static_cast<float*>(act);
  a.cseq = static_cast<float*>(cseq);
  a.hseq = static_cast<bf16*>(hseq);
  a.xbuf = static_cast<bf16*>(xbuf);
  a.bar = static_cast<unsigned int*>(bar);
  a.T = (int)t_steps; a.B = (int)batch; a.N = (int)tokens; a.H = (int)hidden;
  a.KS = (int)((hidden + 15) / 16);
  a.MT = (int)((batch + 15) / 16);
  const int smem = 3 * 4 * a.KS * 32 * (int)sizeof(uint2) + FWD_RED_BYTES;
  const int blocks = (int)(hidden / UNITS);
  if (act) return launch(token_lstm_fwd_kernel<true>, a, blocks, smem, stream);
  return launch(token_lstm_fwd_kernel<false>, a, blocks, smem, stream);
}

}  // namespace

// Shapes (T, B, N, H); fp32 unless named. xg0 (T, B, N, 4H); the weights
// (H, 4H) bf16; bias0/1 (4H); h_init, c_init, h_fin, c_fin, g_hfin, g_cfin,
// g_h0, g_c0 (2, B, H); y, dy (T, B, N, H) bf16; act, dg (2, T, B, N, 4H);
// cseq (2, T, B, N, H); hseq (3, T, B, N, H) bf16 (layer 0's and layer 1's
// recurrent inputs, layer 0's output). xbuf holds 2*2*ceil(B/16)*
// ceil(H/16)*256 bf16 and bar one uint32, both zeroed before the launch.
// H is a multiple of 8 and H/8 blocks must be resident at once (one an
// SM). Every entry point returns the launch's CUDA error (0 on success).

// Inference forward.
extern "C" int token_lstm_fwd(const void* xg0, const void* w_hh0, const void* w_ih1,
                              const void* w_hh1, const void* bias0, const void* bias1,
                              const void* h_init, const void* c_init, void* y, void* h_fin,
                              void* c_fin, void* xbuf, void* bar, int64_t t_steps,
                              int64_t batch, int64_t tokens, int64_t hidden, void* stream) {
  return forward(xg0, w_hh0, w_ih1, w_hh1, bias0, bias1, h_init, c_init, y, h_fin, c_fin,
                 nullptr, nullptr, nullptr, xbuf, bar, t_steps, batch, tokens, hidden, stream);
}

// Forward that also stores the reverse scan's residuals.
extern "C" int token_lstm_fwd_res(const void* xg0, const void* w_hh0, const void* w_ih1,
                                  const void* w_hh1, const void* bias0, const void* bias1,
                                  const void* h_init, const void* c_init, void* y, void* h_fin,
                                  void* c_fin, void* act, void* cseq, void* hseq, void* xbuf,
                                  void* bar, int64_t t_steps, int64_t batch, int64_t tokens,
                                  int64_t hidden, void* stream) {
  if (!act || !cseq || !hseq) return static_cast<int>(cudaErrorInvalidValue);
  return forward(xg0, w_hh0, w_ih1, w_hh1, bias0, bias1, h_init, c_init, y, h_fin, c_fin, act,
                 cseq, hseq, xbuf, bar, t_steps, batch, tokens, hidden, stream);
}

// Reverse scan: the gate pre-activations' gradients da (2, T, B, N, 4H) and
// the initial state's (g_h0, g_c0).
extern "C" int token_lstm_bwd(const void* act, const void* cseq, const void* c_init,
                              const void* w_hh0, const void* w_ih1, const void* w_hh1,
                              const void* dy, const void* g_hfin, const void* g_cfin, void* dg,
                              void* g_h0, void* g_c0, void* bar, int64_t t_steps, int64_t batch,
                              int64_t tokens, int64_t hidden, void* stream) {
  if (bad_shape(t_steps, batch, tokens, hidden)) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.act = static_cast<const float*>(act);
  a.cseq = static_cast<const float*>(cseq);
  a.c_init = static_cast<const float*>(c_init);
  a.w_hh0 = static_cast<const bf16*>(w_hh0);
  a.w_ih1 = static_cast<const bf16*>(w_ih1);
  a.w_hh1 = static_cast<const bf16*>(w_hh1);
  a.dy = static_cast<const bf16*>(dy);
  a.g_hfin = static_cast<const float*>(g_hfin);
  a.g_cfin = static_cast<const float*>(g_cfin);
  a.dg = static_cast<float*>(dg);
  a.g_h0 = static_cast<float*>(g_h0);
  a.dc_state = static_cast<float*>(g_c0);
  a.bar = static_cast<unsigned int*>(bar);
  a.T = (int)t_steps; a.B = (int)batch; a.N = (int)tokens; a.H = (int)hidden;
  a.MT = (int)((batch + 15) / 16);
  const int smem = 3 * (4 * (int)hidden / 16) * 32 * (int)sizeof(uint2) + BWD_RED_BYTES;
  return launch(token_lstm_bwd_kernel, a, (int)(hidden / UNITS), smem, stream);
}
