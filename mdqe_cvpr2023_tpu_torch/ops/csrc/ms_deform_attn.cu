// Multi-scale deformable attention, forward and backward, for Hopper (sm_90a).
//
// The forward replaces two TPU (Pallas) kernels of the JAX package, which
// compute the same function in two TPU formulations:
//   - mdqe_cvpr2023_tpu/ops/deform_attn_pallas.py::_deform_attn_fused
//     (full-contraction "hat-matmul": decoder box-level and temporal
//     cross-attention);
//   - mdqe_cvpr2023_tpu/ops/deform_attn_pallas.py::_deform_attn_banded
//     (block-permuted banded patches: encoder self-attention, Q == N).
// The backward (msda_bwd_f32, and msda_bwd_bf16 for a bf16 value: the
// mixed-precision (AMP) training step) replaces the four Pallas backward
// kernels, which again compute one function in two formulations:
//   - _bwd_sample_kernel and _bwd_value_kernel (the transposed hat-matmul:
//     d(locations), d(weights), d(value), per level);
//   - the banded sample_kernel and value_kernel of _make_banded_bwd_kernels.
// The hat-matmuls and the banding exist because TPU gather is slow. On Hopper
// the natural form is the direct 4-tap bilinear gather of the original CUDA op,
// and its transpose, a 4-tap scatter with atomics.
//
// Semantics: grid_sample(bilinear, padding_mode="zeros", align_corners=False).
// Pixel coordinate = loc * size - 0.5 with loc's last axis (x, y) and level
// shapes (h, w); a corner outside [0, w) x [0, h) contributes zero, to the
// output and to every gradient. The product loc * size is rounded on its own
// (__fmul_rn, no FMA contraction) as the plain PyTorch version rounds it, so
// both pick the same corners where a coordinate sits on a pixel boundary.
//
// Layouts (all contiguous):
//   value       (B, N, H, D)        fp32 or bf16
//   level_meta  (L, 3) int32        h, w, start row of each level
//   loc         (B, Q, H, L, P, 2)  fp32
//   attw        (B, Q, H, L, P)     fp32
//   out         (B, Q, H * D)       fp32
//   grad_out    (B, Q, H * D)       fp32
//   grad_value  (B, N, H, D)        fp32 whatever the value's type, zeroed by
//                                   the caller (who casts it to bf16 after
//                                   msda_bwd_bf16)
//   grad_loc    (B, Q, H, L, P, 2)  fp32
//   grad_attw   (B, Q, H, L, P)     fp32
//
// Forward design: one thread per (b, q, head, group of 8 channels), so G = D / 8
// threads serve one (q, head) (4 at D = 32) and a 32-thread warp serves
// 32 / G pairs (8 at D = 32): the heads of one query, side by side (on the
// H100 this order was 1.6% faster at the VIS encoder's shape than
// neighbouring queries of one head, so it is the only one kept).
// Each tap of a thread is one 16-byte vector load of 8 channels (bf16: one
// uint4, widened to fp32 exactly by a shift; fp32: two float4), accumulated
// into 8 fp32 sums; the output is two float4 stores. Levels are the outer
// loop ((h, w, start) read once per level from shared memory, no division),
// points the inner loop, unrolled by 4 (bf16) or 2 (fp32) so that the 16 (8)
// taps' loads are issued before the FMAs that consume them. A (q, head)'s
// L*P locations and weights are contiguous: read as float4 / float2 vectors
// when P is a multiple of the unroll (the addresses are then 16- / 8-byte
// aligned), else point by point. An out-of-range corner gets weight 0 and no
// load (a predicated load, no branch: the lanes of a warp serve different
// (q, head), so a `continue` would diverge). Requires D % 8 == 0, D <= 64,
// and 16-byte aligned value, locations, weights and output (the wrapper
// checks); N * H * D < 2^31.
//
// Why: the earlier design (one warp per (b, q, head), lane = channel) repeated
// every point's coordinate work (shuffles, an integer division, clamps,
// floors, four bounds tests, weights and addresses: ~100 warp-instructions a
// point) on all 32 lanes for one 2-byte load and one FMA a lane, and walked
// a warp's points one after another; it ran at 3-6% of its byte bound,
// bf16 no faster than fp32 and block size no lever: bound by instruction
// issue and load latency, not bytes. Here the coordinate work per useful FMA
// falls by 32 / G (8x at D = 32) and each thread keeps 4-8 taps in flight.
//
// Backward design (msda_bwd_f32; msda_bwd_bf16 below): the forward's work unit, one
// thread per (b, q, head, 8 channels), the heads of a query side by side,
// 128 threads a block. The G = D / 8 threads of a (q, head) are rounded up to
// a power of two, Gp (1, 2, 4 or 8; at D = 48, G = 6 and Gp = 8, the two
// spare threads adding zeros), so that a group's sums reduce with log2(Gp)
// xor shuffles inside the warp. Thread g holds channels 4g .. 4g+3 and
// D/2 + 4g .. D/2 + 4g+3, so that the group's first (second) float4s form
// the first (second) half of a row. A thread loads its 8 channels of the
// output gradient g once and reads its points' (x, y, a) itself (as float4 /
// float2 when P is even, else point by point); levels are the outer loop
// ((h, w, start) from shared memory), points the inner one, 2 at a time with
// their 8 taps' loads issued before the arithmetic that uses them. Per point
// the coordinate work is done once for 8 channels: an out-of-range corner
// gets weight 0 and a predicated load, never a branch, since a warp mixes
// (q, head) pairs whose corners are in and out of range. Per tap the thread
// forms dot = sum_d g[d] v[d] over its channels and adds it into three
// partial sums: w_x w_y dot (d(weight)), dw_x/dx w_y dot and w_x dw_y/dy dot
// (d(x), d(y), times a * size after the reduction). The group reduces the
// six sums of a pair of points with 3 * log2(Gp) shuffles, and its thread 0
// stores the pair's gradients as one float2 and one float4. A thread past
// the last (b, q, head) stays in the loops on the last item's points and
// adds and stores nothing: the shuffles need every lane of the warp.
//
// d(value) is a scatter: per in-range tap, a * w_corner * g[d] into the 8
// channels of the corner's row, by 16-byte vector reductions
// (red.global.add.v4.f32, sm_90; SASS REDG.E.ADD.F32x4), a quarter of the
// atomic instructions of fp32 atomics for the same bytes. Two neighbouring
// groups of the warp swap halves with shuffles before it, so that each of a
// warp's reductions writes whole rows (a full 128-byte line at D = 32)
// rather than half rows: first the lower group's row, then the upper's. The
// atomics make d(value)'s summation order vary from run to run.
//
// msda_bwd_bf16 (the AMP step's backward; the TPU's Pallas backward gets a
// bf16 value there and computes in bf16, mdqe_cvpr2023_tpu/ops/deform_attn.py)
// is the same kernel over a bf16 value: its thread holds 8 contiguous
// channels, 8g .. 8g+7, loaded as one 16-byte vector and widened to fp32
// exactly by shifts; every product and sum is fp32, and so is d(value):
// it is scattered with the same red.global.add.v4.f32 (a thread's two
// float4s now 4 channels apart instead of D/2, and the pair swap still makes
// each reduction write whole rows) into an fp32 buffer that the wrapper casts
// to bf16 once, as the JAX backward sums in fp32 and casts once. No bf16
// atomics: their sums would round at every tap. grad_out, locations and
// weights stay fp32 (the forward returns fp32, so the incoming gradient is
// fp32). It reads half the value bytes of msda_bwd_f32 and sends the same
// scatter to L2, which limits both (below), so it is expected to take about
// fp32's time.
//
// Bound on this card. Bytes and flops give the least time: per (b, q, head)
// the backward reads 4 rows of D values per point, the locations, weights
// and output gradient, and writes d(value) in full (8 flops per tap and
// channel), far below the ~20 FLOP/byte ridge of fp32 on an H100, so its
// bound is those bytes over the 3.35 TB/s of HBM. What it must send to L2 is
// larger: one 16-byte reduction per 4 channels of every in-range tap, 4.2 GB
// at the training encoder, 10x the bytes of its bound. Measured on an H100
// (chip_smoke.py --bwd-split: this kernel built with the reductions turned
// into plain stores, and without them): without the scatter the kernel
// takes about a quarter of its time, with plain stores in its place about
// four fifths, so the scatter's traffic into L2, not the atomics as such and
// not the issue of instructions, is what limits it. The design's answers
// are the fewest instructions per tap and whole-row reductions; fewer bytes
// would need the taps of a row summed before they leave the SM, and
// shared-memory accumulation did not pay: fp32 atomics on shared memory are
// a compare-and-swap loop (ATOMS.CAST.SPIN) on this card, slower at the
// training encoder than the global reductions. The earlier design (one warp
// per (b, q, head), lane = channel: the shuffles and the whole coordinate
// computation on 32 lanes, 15 + 3 shuffles and four scalar atomic
// instructions per point) was bound by instruction issue instead: plain
// stores in place of its atomics left its time unchanged.
//
// Block size: the forward kernel is a template over its block size. The main
// paths launch 128 threads (msda_fwd_f32, msda_fwd_bf16): on the H100 that
// was the fastest or within 7% of it at every main-path site (the fp32
// encoders prefer 256-512), and ptxas fits it in 64-70 registers without
// spills; msda_fwd_*_block
// take 64, 128, 256 or 512 threads for the tuning sweep
// (mdqe_cvpr2023_tpu_torch/tools/tune_deform_kernel.py), the Hopper
// counterpart of the TPU kernel's query-tile sweep in
// tools/tune_deform_kernel.py::run_level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kFwdThreads = 128;  // the main paths' forward block size
constexpr int kBwdThreads = 128;  // the backward's block size

// 8 channels of one value row, as loaded.
template <typename T> struct Vec8;
template <> struct Vec8<float> { float4 lo, hi; };
template <> struct Vec8<__nv_bfloat16> { uint4 u; };

__device__ __forceinline__ void load8(Vec8<float>& v, const float* p) {
  v.lo = __ldg(reinterpret_cast<const float4*>(p));
  v.hi = __ldg(reinterpret_cast<const float4*>(p) + 1);
}
__device__ __forceinline__ void load8(Vec8<__nv_bfloat16>& v, const __nv_bfloat16* p) {
  v.u = __ldg(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void zero8(Vec8<float>& v) {
  v.lo = make_float4(0.f, 0.f, 0.f, 0.f);
  v.hi = v.lo;
}
__device__ __forceinline__ void zero8(Vec8<__nv_bfloat16>& v) { v.u = make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ void fma8(float (&acc)[8], float w, const Vec8<float>& v) {
  acc[0] += w * v.lo.x;
  acc[1] += w * v.lo.y;
  acc[2] += w * v.lo.z;
  acc[3] += w * v.lo.w;
  acc[4] += w * v.hi.x;
  acc[5] += w * v.hi.y;
  acc[6] += w * v.hi.z;
  acc[7] += w * v.hi.w;
}
// bf16 -> fp32 is exact: the bf16 bits are the fp32's high half.
__device__ __forceinline__ void fma_pair(float& a0, float& a1, float w, uint32_t bits) {
  a0 += w * __uint_as_float(bits << 16);
  a1 += w * __uint_as_float(bits & 0xffff0000u);
}
__device__ __forceinline__ void fma8(float (&acc)[8], float w, const Vec8<__nv_bfloat16>& v) {
  fma_pair(acc[0], acc[1], w, v.u.x);
  fma_pair(acc[2], acc[3], w, v.u.y);
  fma_pair(acc[4], acc[5], w, v.u.z);
  fma_pair(acc[6], acc[7], w, v.u.w);
}

// Points unrolled per step: 4 taps each, so 16 (bf16) or 8 (fp32) 16-byte
// loads are issued together; fp32 holds two float4 a tap.
template <typename T> struct PointUnroll { static constexpr int value = 4; };
template <> struct PointUnroll<float> { static constexpr int value = 2; };

template <typename T, int kBlock>
__global__ void __launch_bounds__(kBlock) msda_fwd_kernel(
    const T* __restrict__ value, const int* __restrict__ level_meta,
    const float* __restrict__ loc, const float* __restrict__ attw,
    float* __restrict__ out, int B, int N, int Q, int H, int D, int L, int P) {
  constexpr int kPU = PointUnroll<T>::value;
  __shared__ int s_meta[3 * kMaxLevels];  // h, w, start of each level
  for (int i = threadIdx.x; i < 3 * L; i += kBlock) s_meta[i] = level_meta[i];
  __syncthreads();

  const int G = D >> 3;  // threads per (b, q, head)
  const int64_t t = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  if (t >= (int64_t)B * Q * H * G) return;  // no barrier follows
  const int g = (int)(t % G);
  const int64_t item = t / G;  // (b, q, head): row of loc, attw and out
  const int h = (int)(item % H);
  const int64_t b = item / H / Q;
  const int LP = L * P;
  const int row_stride = H * D;  // elements between pixels
  const T* v_bh = value + b * (int64_t)N * row_stride + h * D + 8 * g;
  const float* loc_i = loc + item * LP * 2;
  const float* aw_i = attw + item * LP;
  const bool vec = P % kPU == 0;  // then the chunks' vectors are aligned

  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int hl = s_meta[3 * l];
    const int wl = s_meta[3 * l + 1];
    const T* v_l = v_bh + (int64_t)s_meta[3 * l + 2] * row_stride;
    for (int p0 = 0; p0 < P; p0 += kPU) {
      const float* lp = loc_i + 2 * (l * P + p0);
      const float* ap = aw_i + l * P + p0;
      float px[kPU], py[kPU], a[kPU];
      if (vec) {
#pragma unroll
        for (int u = 0; u < kPU; u += 2) {
          const float4 xy = __ldg(reinterpret_cast<const float4*>(lp + 2 * u));
          const float2 w2 = __ldg(reinterpret_cast<const float2*>(ap + u));
          px[u] = xy.x;
          py[u] = xy.y;
          px[u + 1] = xy.z;
          py[u + 1] = xy.w;
          a[u] = w2.x;
          a[u + 1] = w2.y;
        }
      } else {
#pragma unroll
        for (int u = 0; u < kPU; ++u) {
          // a point past P lands far outside the level: no corner is in range
          const bool in = p0 + u < P;
          px[u] = in ? __ldg(lp + 2 * u) : -1.f;
          py[u] = in ? __ldg(lp + 2 * u + 1) : -1.f;
          a[u] = in ? __ldg(ap + u) : 0.f;
        }
      }
      Vec8<T> v[kPU][4];
      float wc[kPU][4];
#pragma unroll
      for (int u = 0; u < kPU; ++u) {
        float x = __fmul_rn(px[u], (float)wl) - 0.5f;
        float y = __fmul_rn(py[u], (float)hl) - 0.5f;
        // Far outside the level every corner is out of range either way; the
        // clamp only keeps the int conversion below defined.
        x = fminf(fmaxf(x, -2.f), (float)wl + 1.f);
        y = fminf(fmaxf(y, -2.f), (float)hl + 1.f);
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        const float fx = x - x0f;
        const float fy = y - y0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cx = x0 + (c & 1);
          const int cy = y0 + (c >> 1);
          const bool ok = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
          wc[u][c] = ok ? a[u] * ((c & 1) ? fx : 1.f - fx) * ((c >> 1) ? fy : 1.f - fy)
                        : 0.f;
          if (ok) {
            load8(v[u][c], v_l + (cy * wl + cx) * row_stride);
          } else {
            zero8(v[u][c]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kPU; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) fma8(acc, wc[u][c], v[u][c]);
    }
  }

  float4* o = reinterpret_cast<float4*>(out + item * D + 8 * g);
  o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}


// The backward's 8 channels of a row: 4 at p and 4 at p + split, where
// (BwdChannels) fp32 takes channels 4g .. 4g+3 and D/2 + 4g .. (split = D/2)
// and bf16 the 8 contiguous 8g .. 8g+7 (split = 4, one 16-byte load).
__device__ __forceinline__ void load_split(Vec8<float>& v, const float* p, int split) {
  v.lo = __ldg(reinterpret_cast<const float4*>(p));
  v.hi = __ldg(reinterpret_cast<const float4*>(p + split));
}
__device__ __forceinline__ void load_split(Vec8<__nv_bfloat16>& v, const __nv_bfloat16* p,
                                           int) {
  v.u = __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T> struct BwdChannels;
template <> struct BwdChannels<float> {
  __device__ static int base(int g) { return 4 * g; }
  __device__ static int second(int D) { return D >> 1; }
};
template <> struct BwdChannels<__nv_bfloat16> {
  __device__ static int base(int g) { return 8 * g; }
  __device__ static int second(int) { return 4; }
};

// A loaded row as 8 fp32 channels (bf16 -> fp32 is exact: the high half).
__device__ __forceinline__ const Vec8<float>& widen(const Vec8<float>& v) { return v; }
__device__ __forceinline__ Vec8<float> widen(const Vec8<__nv_bfloat16>& v) {
  Vec8<float> r;
  r.lo = make_float4(__uint_as_float(v.u.x << 16), __uint_as_float(v.u.x & 0xffff0000u),
                     __uint_as_float(v.u.y << 16), __uint_as_float(v.u.y & 0xffff0000u));
  r.hi = make_float4(__uint_as_float(v.u.z << 16), __uint_as_float(v.u.z & 0xffff0000u),
                     __uint_as_float(v.u.w << 16), __uint_as_float(v.u.w & 0xffff0000u));
  return r;
}

// d(value) scatter: 4 contiguous fp32 added into global memory by one
// 16-byte vector reduction (sm_90, PTX ISA 8.1).
__device__ __forceinline__ void red_add4(float* p, float4 v) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(__cvta_generic_to_global(p)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(s * v.x, s * v.y, s * v.z, s * v.w);
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int lane_mask) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, lane_mask),
                     __shfl_xor_sync(0xffffffffu, v.y, lane_mask),
                     __shfl_xor_sync(0xffffffffu, v.z, lane_mask),
                     __shfl_xor_sync(0xffffffffu, v.w, lane_mask));
}

template <typename T, int kGp>
__global__ void __launch_bounds__(kBwdThreads) msda_bwd_kernel(
    const T* __restrict__ value, const int* __restrict__ level_meta,
    const float* __restrict__ loc, const float* __restrict__ attw,
    const float* __restrict__ grad_out, float* __restrict__ grad_value,
    float* __restrict__ grad_loc, float* __restrict__ grad_attw,
    int B, int N, int Q, int H, int D, int L, int P) {
  constexpr int kPU = 2;  // points per step: 8 taps' 16-byte loads in flight
  __shared__ int s_meta[3 * kMaxLevels];  // h, w, start of each level
  for (int i = threadIdx.x; i < 3 * L; i += kBwdThreads) s_meta[i] = level_meta[i];
  __syncthreads();

  const int64_t total = (int64_t)B * Q * H;
  const int64_t t = (int64_t)blockIdx.x * kBwdThreads + threadIdx.x;
  const int g = (int)(t & (kGp - 1));
  // Past the last (b, q, head) the group works on the last one's points and
  // adds and stores nothing; it must not return before the shuffles.
  const bool in_range = t / kGp < total;
  const int64_t item = in_range ? t / kGp : total - 1;  // (b, q, head)
  const bool live = in_range && g < (D >> 3);  // not a spare thread of the group
  // The warp's groups go in pairs (lane ^ kGp) for the d(value) scatter.
  const bool upper = (threadIdx.x & kGp) != 0;
  const int h = (int)(item % H);
  const int64_t b = item / H / Q;
  const int LP = L * P;
  const int row_stride = H * D;  // elements between pixels
  // this thread's channels: base .. base+3 and base+split .. base+split+3
  const int split = BwdChannels<T>::second(D);
  const int64_t bh_off = b * (int64_t)N * row_stride + h * D + BwdChannels<T>::base(g);
  const T* v_bh = value + bh_off;
  float* gv_bh = grad_value + bh_off;
  const float* loc_i = loc + item * LP * 2;
  const float* aw_i = attw + item * LP;
  float* gloc_i = grad_loc + item * LP * 2;
  float* gaw_i = grad_attw + item * LP;
  const bool vec = P % kPU == 0;  // then the pairs' vectors are aligned

  Vec8<float> go;  // this thread's 8 channels of the output gradient
  if (live) {
    load_split(go, grad_out + item * D + BwdChannels<T>::base(g), split);
  } else {
    zero8(go);
  }

  for (int l = 0; l < L; ++l) {
    const int hl = s_meta[3 * l];
    const int wl = s_meta[3 * l + 1];
    const int lvl = s_meta[3 * l + 2] * row_stride;
    for (int p0 = 0; p0 < P; p0 += kPU) {
      const int i0 = l * P + p0;  // the pair's first (level, point) slot
      float px[kPU], py[kPU], a[kPU];
      if (vec) {
        const float4 xy = __ldg(reinterpret_cast<const float4*>(loc_i + 2 * i0));
        const float2 w2 = __ldg(reinterpret_cast<const float2*>(aw_i + i0));
        px[0] = xy.x;
        py[0] = xy.y;
        px[1] = xy.z;
        py[1] = xy.w;
        a[0] = w2.x;
        a[1] = w2.y;
      } else {
#pragma unroll
        for (int u = 0; u < kPU; ++u) {
          // a point past P lands far outside the level: no corner is in range
          const bool in = p0 + u < P;
          px[u] = in ? __ldg(loc_i + 2 * (i0 + u)) : -1.f;
          py[u] = in ? __ldg(loc_i + 2 * (i0 + u) + 1) : -1.f;
          a[u] = in ? __ldg(aw_i + i0 + u) : 0.f;
        }
      }
      Vec8<T> v[kPU][4];
      int row[kPU][4];  // corner's offset from the level's first row; -1 out of range
      float fx[kPU], fy[kPU];
#pragma unroll
      for (int u = 0; u < kPU; ++u) {
        float x = __fmul_rn(px[u], (float)wl) - 0.5f;
        float y = __fmul_rn(py[u], (float)hl) - 0.5f;
        // Far outside the level every corner is out of range either way (no
        // contribution to any gradient); the clamp only keeps the int
        // conversion below defined.
        x = fminf(fmaxf(x, -2.f), (float)wl + 1.f);
        y = fminf(fmaxf(y, -2.f), (float)hl + 1.f);
        const float x0f = floorf(x);
        const float y0f = floorf(y);
        const int x0 = (int)x0f;
        const int y0 = (int)y0f;
        fx[u] = x - x0f;
        fy[u] = y - y0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cx = x0 + (c & 1);
          const int cy = y0 + (c >> 1);
          const bool ok = live && cx >= 0 && cx < wl && cy >= 0 && cy < hl;
          row[u][c] = ok ? lvl + (cy * wl + cx) * row_stride : -1;
          if (ok) {
            load_split(v[u][c], v_bh + row[u][c], split);
          } else {
            zero8(v[u][c]);
          }
        }
      }
      float s[kPU][3];  // per point: d(weight), and d(x), d(y) before a * size
#pragma unroll
      for (int u = 0; u < kPU; ++u) {
        s[u][0] = s[u][1] = s[u][2] = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wx = (c & 1) ? fx[u] : 1.f - fx[u];
          const float wy = (c >> 1) ? fy[u] : 1.f - fy[u];
          const Vec8<float> r = widen(v[u][c]);
          const float dot = go.lo.x * r.lo.x + go.lo.y * r.lo.y + go.lo.z * r.lo.z +
                            go.lo.w * r.lo.w + go.hi.x * r.hi.x + go.hi.y * r.hi.y +
                            go.hi.z * r.hi.z + go.hi.w * r.hi.w;
          s[u][0] += wx * wy * dot;
          s[u][1] += ((c & 1) ? wy : -wy) * dot;  // d(wx)/dx = +-1
          s[u][2] += ((c >> 1) ? wx : -wx) * dot;
          // d(value): the two groups of a pair swap halves, so that each
          // vector reduction of the warp writes whole rows: first the lower
          // group's row (its first half from the lower group's threads, its
          // second from the upper's), then the upper group's. Every lane runs
          // the shuffles; a corner out of range has no row and no reduction.
          const float wc = a[u] * wx * wy;
          const float4 lo = scale4(go.lo, wc);
          const float4 hi = scale4(go.hi, wc);
          float* mine = row[u][c] >= 0 ? gv_bh + row[u][c] : nullptr;
          float* theirs = reinterpret_cast<float*>(__shfl_xor_sync(
              0xffffffffu, reinterpret_cast<unsigned long long>(mine), kGp));
          const float4 got = shfl_xor4(upper ? lo : hi, kGp);
          float* first = upper ? theirs : mine;
          float* second = upper ? mine : theirs;
          const int col = upper ? split : 0;  // this lane's half of the row
          if (first) red_add4(first + col, upper ? got : lo);
          if (second) red_add4(second + col, upper ? hi : got);
        }
      }
#pragma unroll
      for (int off = kGp / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kPU; ++u)
#pragma unroll
          for (int k = 0; k < 3; ++k) s[u][k] += __shfl_xor_sync(0xffffffffu, s[u][k], off);
      }
      if (g == 0 && in_range) {
        const float gx0 = a[0] * s[0][1] * (float)wl;  // x = loc_x * w - 0.5
        const float gy0 = a[0] * s[0][2] * (float)hl;
        const float gx1 = a[1] * s[1][1] * (float)wl;
        const float gy1 = a[1] * s[1][2] * (float)hl;
        if (vec) {
          *reinterpret_cast<float2*>(gaw_i + i0) = make_float2(s[0][0], s[1][0]);
          *reinterpret_cast<float4*>(gloc_i + 2 * i0) = make_float4(gx0, gy0, gx1, gy1);
        } else {
          gaw_i[i0] = s[0][0];
          gloc_i[2 * i0] = gx0;
          gloc_i[2 * i0 + 1] = gy0;
          if (p0 + 1 < P) {
            gaw_i[i0 + 1] = s[1][0];
            gloc_i[2 * i0 + 2] = gx1;
            gloc_i[2 * i0 + 3] = gy1;
          }
        }
      }
    }
  }
}

template <typename T, int kBlock>
int launch_fwd(const T* v, const int* m, const float* lo, const float* aw, float* o,
               int B, int N, int Q, int H, int D, int L, int P, cudaStream_t s) {
  const int64_t total = (int64_t)B * Q * H * (D / 8);
  const int64_t blocks = (total + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  msda_fwd_kernel<T, kBlock><<<(unsigned)blocks, kBlock, 0, s>>>(
      v, m, lo, aw, o, B, N, Q, H, D, L, P);
  return (int)cudaGetLastError();
}

// threads: the block size, one of 64, 128, 256, 512.
template <typename T>
int launch(const void* value, const void* level_meta, const void* loc,
           const void* attw, void* out, int B, int N, int Q, int H, int D,
           int L, int P, int threads, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 8 || D > 64 || D % 8 != 0 || P < 1 ||
      (int64_t)N * H * D > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  if ((int64_t)B * Q * H == 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(value);
  const int* m = static_cast<const int*>(level_meta);
  const float* lo = static_cast<const float*>(loc);
  const float* aw = static_cast<const float*>(attw);
  float* o = static_cast<float*>(out);
  switch (threads) {
    case 64: return launch_fwd<T, 64>(v, m, lo, aw, o, B, N, Q, H, D, L, P, s);
    case 128: return launch_fwd<T, 128>(v, m, lo, aw, o, B, N, Q, H, D, L, P, s);
    case 256: return launch_fwd<T, 256>(v, m, lo, aw, o, B, N, Q, H, D, L, P, s);
    case 512: return launch_fwd<T, 512>(v, m, lo, aw, o, B, N, Q, H, D, L, P, s);
    default: return (int)cudaErrorInvalidConfiguration;
  }
}

template <typename T>
int launch_bwd(const void* value, const void* level_meta, const void* loc,
               const void* attw, const void* grad_out, void* grad_value,
               void* grad_loc, void* grad_attw, int B, int N, int Q, int H,
               int D, int L, int P, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 8 || D > 64 || D % 8 != 0 || P < 1 ||
      (int64_t)N * H * D > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t total = (int64_t)B * Q * H;
  if (total == 0) return (int)cudaSuccess;
  const int G = D / 8;
  const int Gp = G == 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : 8;  // threads per (b, q, head)
  const int64_t blocks = (total * Gp + kBwdThreads - 1) / kBwdThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(value);
  const int* m = static_cast<const int*>(level_meta);
  const float* lo = static_cast<const float*>(loc);
  const float* aw = static_cast<const float*>(attw);
  const float* go = static_cast<const float*>(grad_out);
  float* gv = static_cast<float*>(grad_value);
  float* gl = static_cast<float*>(grad_loc);
  float* ga = static_cast<float*>(grad_attw);
  const unsigned nb = (unsigned)blocks;
  switch (Gp) {
    case 1:
      msda_bwd_kernel<T, 1><<<nb, kBwdThreads, 0, s>>>(v, m, lo, aw, go, gv, gl, ga, B, N, Q,
                                                       H, D, L, P);
      break;
    case 2:
      msda_bwd_kernel<T, 2><<<nb, kBwdThreads, 0, s>>>(v, m, lo, aw, go, gv, gl, ga, B, N, Q,
                                                       H, D, L, P);
      break;
    case 4:
      msda_bwd_kernel<T, 4><<<nb, kBwdThreads, 0, s>>>(v, m, lo, aw, go, gv, gl, ga, B, N, Q,
                                                       H, D, L, P);
      break;
    default:
      msda_bwd_kernel<T, 8><<<nb, kBwdThreads, 0, s>>>(v, m, lo, aw, go, gv, gl, ga, B, N, Q,
                                                       H, D, L, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int msda_fwd_f32(const void* value, const void* level_meta, const void* loc,
                 const void* attw, void* out, int B, int N, int Q, int H, int D,
                 int L, int P, void* stream) {
  return launch<float>(value, level_meta, loc, attw, out, B, N, Q, H, D, L, P, kFwdThreads,
                       stream);
}

int msda_fwd_bf16(const void* value, const void* level_meta, const void* loc,
                  const void* attw, void* out, int B, int N, int Q, int H, int D,
                  int L, int P, void* stream) {
  return launch<__nv_bfloat16>(value, level_meta, loc, attw, out, B, N, Q, H, D, L, P,
                               kFwdThreads, stream);
}

int msda_fwd_f32_block(const void* value, const void* level_meta, const void* loc,
                       const void* attw, void* out, int B, int N, int Q, int H, int D,
                       int L, int P, int threads, void* stream) {
  return launch<float>(value, level_meta, loc, attw, out, B, N, Q, H, D, L, P, threads,
                       stream);
}

int msda_fwd_bf16_block(const void* value, const void* level_meta, const void* loc,
                        const void* attw, void* out, int B, int N, int Q, int H, int D,
                        int L, int P, int threads, void* stream) {
  return launch<__nv_bfloat16>(value, level_meta, loc, attw, out, B, N, Q, H, D, L, P,
                               threads, stream);
}

int msda_bwd_f32(const void* value, const void* level_meta, const void* loc,
                 const void* attw, const void* grad_out, void* grad_value,
                 void* grad_loc, void* grad_attw, int B, int N, int Q, int H,
                 int D, int L, int P, void* stream) {
  return launch_bwd<float>(value, level_meta, loc, attw, grad_out, grad_value, grad_loc,
                           grad_attw, B, N, Q, H, D, L, P, stream);
}

// value bf16; grad_value is fp32 (the wrapper casts it to bf16).
int msda_bwd_bf16(const void* value, const void* level_meta, const void* loc,
                  const void* attw, const void* grad_out, void* grad_value,
                  void* grad_loc, void* grad_attw, int B, int N, int Q, int H,
                  int D, int L, int P, void* stream) {
  return launch_bwd<__nv_bfloat16>(value, level_meta, loc, attw, grad_out, grad_value,
                                   grad_loc, grad_attw, B, N, Q, H, D, L, P, stream);
}

const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
