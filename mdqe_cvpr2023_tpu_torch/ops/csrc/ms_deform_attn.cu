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
//   grad_value  (B, N, H, D)        the value's type; fp32 zeroed by the
//                                   caller (msda_bwd_f32), bf16 written in
//                                   full (msda_bwd_bf16)
//   work        (B, N, H, D)        fp32 scratch of msda_bwd_bf16 (below)
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
// has kernels of its own; msda_bwd_f32 keeps the template above. Its thread
// holds 8 contiguous channels, 8g .. 8g+7, loaded as one 16-byte vector and
// widened to fp32 exactly by shifts; every product and sum is fp32, d(value)
// included, rounded to bf16 once (the JAX backward sums in fp32 and casts
// once). No bf16 atomics: their sums would round at every tap. The sample
// work (loads, dot products, the group's shuffle sums, d(locations) and
// d(weights) with the __fmul_rn coordinate and the corner rule) is
// msda_bwd_kernel's, in bf16_pair. The design differs in d(value):
//
// At the encoder (Q == N: the queries are the levels' pixels in order, the
// wrapper's `tiled`), msda_bwd_bf16_tiled_kernel: a block serves a 4x8 tile
// of query pixels of one level for one (b, head), the heads-of-a-query order
// given up, so that the block's taps of one sampled level land on few rows
// (the queries' reference points are neighbours, and so are their samples).
// Per sampled level and round of 4 points the block takes the taps'
// bounding box; if it spans at most kWindow (512) rows, each row gets
// 4 * 512 / (box rows) slots in shared memory, a shared int atomic gives each
// tap its rank in its row (the first lists the row), and one thread per
// (listed row, 4 channels) sums the row's taps, sum_t a w_corner g_q(t), g
// from the tile's output gradient staged in shared memory, and sends one
// red.global.add.v4.f32 into an fp32 scratch (zeroed first; one kernel casts
// it to bf16 after). A tap past its row's slots, and every tap of a wider
// box, sends its own. On chip_smoke.py's encoder inputs this sends 6.6x
// fewer reductions than one per tap (the count build of --bwd-split equals
// measure.msda_bf16_reds exactly). The 8x16 tile merges more (7.7x) but its
// 512-thread blocks and larger arrays ran slower on the H100, as did 8 slots
// a tap (fewer blocks a SM), a 256-row window, a sort of the taps by row
// (scan and place: twice the barriers) and taking the box from the
// locations first so that taps go to their slots as they are computed
// (shared atomics among the loads). What remains is the sample work, the
// merge's shared-memory reads (128 bytes of g a tap at D = 32) and the
// barriers; the reductions left take little (plain stores in their place
// save ~nothing).
//
// At the decoder sites (a few hundred queries spread over the levels:
// merging pays little), two kernels: msda_bwd_bf16_sample_kernel, the sample
// work with the levels split over threads (a thread per (b, q, head, level,
// 8 channels): four times the threads), and msda_bwd_bf16_value_kernel,
// where a block owns up to 2048 rows of a level of one (b, head), stages its
// queries' output gradient rows (and their taps in its rows, counting-sorted
// by row) in shared memory and writes every row once as bf16, zeros
// included: no zero fill, no scatter and no cast pass, which made the
// earlier kernel slower here than msda_bwd_f32 (the shared template over a
// bf16 value: its fp32 buffer's zero fill and cast moved 175 MB for 196
// queries at the box site).
//
// Bound on this card (both kernels; the measurements below are msda_bwd_f32's,
// PERF.md has msda_bwd_bf16's). Bytes and flops give the least time: per (b, q, head)
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
#include <limits.h>
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

// ---- msda_bwd_bf16 -----------------------------------------------------------
//
// A kernel of its own (the design note above): at the encoder (Q == N) a
// block serves a tile of kTileH x kTileW query pixels of one level for one
// (b, head) and merges its taps' d(value) rows on the SM, per round of
// kRoundP points of one sampled level, when the round's bounding box spans
// at most kWindow rows; at the decoder sites a sample kernel computes
// d(locations) and d(weights) and a value kernel owns d(value)'s rows.
constexpr int kTileH = 4;
constexpr int kTileW = 8;
constexpr int kRoundP = 4;
constexpr int kWindow = 512;
constexpr int kTileQ = kTileH * kTileW;
constexpr int kRoundTaps = kTileQ * kRoundP * 4;  // a round's taps, 4 a point
constexpr int kSlots = 4 * kRoundTaps;  // a round's merge slots: kSlots / (box rows) a row
static_assert(kSlots / kWindow >= 4, "at least 4 slots a row");
// The decoder's d(value) kernel: a block owns up to kValRows rows of one
// level for one (b, head); it takes the queries in segments of at most
// kValPoints points and kValQueries queries, their taps and output gradient
// rows staged in shared memory together.
constexpr int kValThreads = 512;
constexpr int kValRows = 2048;
constexpr int kValPoints = 1024;
constexpr int kValQueries = 256;
static_assert(4 * kValPoints <= 4096 && kValRows < (1 << 19), "keys: row << 12 | rank");

// Exclusive prefix sums of in[0, n) into out, by the block's kThreads threads
// (a multiple of 32); s_warp holds 32 ints. Callers synchronize before it
// (in is complete) and after it (before out is read).
template <int kThreads>
__device__ __forceinline__ void block_exclusive_scan(const int* in, int* out, int n,
                                                     int* s_warp) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += in[i];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += v;
    }
    if (lane < kWarps) s_warp[lane] = wi - w;
  }
  __syncthreads();
  int run = s_warp[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run += in[i];
  }
}

// The merged d(value) rows of msda_bwd_bf16: one 16-byte vector reduction
// per 4 channels of a row (sm_90, PTX ISA 8.1; .relaxed.gpu is red's
// default, spelled out).
#ifdef MSDA_COUNT_REDS
__device__ unsigned long long msda_red_count;  // debug builds: reductions sent
#endif
__device__ __forceinline__ void red_rows4(float* p, float4 v) {
#ifdef MSDA_COUNT_REDS
  atomicAdd(&msda_red_count, 1ull);
#endif
  asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(__cvta_generic_to_global(p)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// Two fp32 rounded to nearest even as bf16, the first in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void fma4(float4& acc, float c, float4 g) {
  acc.x += c * g.x;
  acc.y += c * g.y;
  acc.z += c * g.z;
  acc.w += c * g.w;
}

// A point pair's locations and weights (as float4 / float2 when P is even:
// the pair's vectors are then aligned); a point past P (`second` false) lands
// far outside the level, where no corner is in range.
__device__ __forceinline__ void load_pair(const float* __restrict__ loc_i,
                                          const float* __restrict__ aw_i, int i0, bool second,
                                          bool vec, float (&px)[2], float (&py)[2],
                                          float (&a)[2]) {
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
    px[0] = __ldg(loc_i + 2 * i0);
    py[0] = __ldg(loc_i + 2 * i0 + 1);
    a[0] = __ldg(aw_i + i0);
    px[1] = second ? __ldg(loc_i + 2 * i0 + 2) : -1.f;
    py[1] = second ? __ldg(loc_i + 2 * i0 + 3) : -1.f;
    a[1] = second ? __ldg(aw_i + i0 + 1) : 0.f;
  }
}

// A point's top-left corner (x0, y0) and fractions: pixel coordinate =
// loc * size - 0.5, the product rounded on its own. Far outside the level
// every corner is out of range either way; the clamp only keeps the int
// conversion defined.
__device__ __forceinline__ void corner(float px, float py, int hl, int wl, int& x0, int& y0,
                                       float& fx, float& fy) {
  float x = __fmul_rn(px, (float)wl) - 0.5f;
  float y = __fmul_rn(py, (float)hl) - 0.5f;
  x = fminf(fmaxf(x, -2.f), (float)wl + 1.f);
  y = fminf(fmaxf(y, -2.f), (float)hl + 1.f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  x0 = (int)x0f;
  y0 = (int)y0f;
  fx = x - x0f;
  fy = y - y0f;
}

// One point pair of one (b, q, head) group of msda_bwd_bf16 (the work of
// msda_bwd_kernel's inner loop without its scatter): the 8 taps' loads of
// the thread's 8 channels, their dot products with the output gradient, and
// the group's three sums per point reduced over its kGp threads (s: d(weight),
// d(x), d(y) before a * size). Per tap also its d(value) coefficient
// a * w_x * w_y and pixel, cy << 16 | cx, or -1 when the corner is out of
// range or `own` is false. `second`: the pair's second point exists.
template <int kGp>
__device__ __forceinline__ void bf16_pair(
    const __nv_bfloat16* __restrict__ v_l, const float* __restrict__ loc_i,
    const float* __restrict__ aw_i, int i0, bool second, bool vec, bool live, bool own,
    int hl, int wl, int row_stride, const Vec8<float>& go, float (&a)[2], float (&s)[2][3],
    float (&wc)[2][4], int (&pix)[2][4]) {
  float px[2], py[2];
  load_pair(loc_i, aw_i, i0, second, vec, px, py, a);
  Vec8<__nv_bfloat16> v[2][4];
  float fx[2], fy[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    int x0, y0;
    corner(px[u], py[u], hl, wl, x0, y0, fx[u], fy[u]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int cx = x0 + (c & 1);
      const int cy = y0 + (c >> 1);
      const bool ok = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
      pix[u][c] = ok && own ? (cy << 16) | cx : -1;
      if (ok && live) {
        load_split(v[u][c], v_l + (cy * wl + cx) * row_stride, 4);
      } else {
        zero8(v[u][c]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
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
      wc[u][c] = a[u] * wx * wy;
    }
  }
#pragma unroll
  for (int off = kGp / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int k = 0; k < 3; ++k) s[u][k] += __shfl_xor_sync(0xffffffffu, s[u][k], off);
  }
}

// The pair's d(weights) and d(locations), stored by the group's thread 0.
__device__ __forceinline__ void store_pair(const float (&s)[2][3], const float (&a)[2],
                                           bool vec, bool second, int i0, int hl, int wl,
                                           float* gloc_i, float* gaw_i) {
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
    if (second) {
      gaw_i[i0 + 1] = s[1][0];
      gloc_i[2 * i0 + 2] = gx1;
      gloc_i[2 * i0 + 3] = gy1;
    }
  }
}

// msda_bwd_bf16 at Q == N (the queries are the levels' pixels in order):
// block (tile, head, b), kTileQ * kGp threads, thread = (tile slot, g). Per
// sampled level and round of kRoundP points the threads record their taps
// (corner c by thread c % kGp of the group) in shared memory with the
// round's bounding box; then, when the box spans at most kWindow rows, each
// row of the box gets kSlots / (box rows) slots, a tap takes the next slot of
// its row (a shared int atomic gives its rank; the row's first tap lists the
// row), and one thread per (listed row, 4 channels) sums its row's taps,
// sum_t a w_corner g_q(t), and sends one vector reduction into the fp32
// `work`. A tap past its row's slots, and every tap of a wider box, sends
// its own.
template <int kGp>
__global__ void __launch_bounds__(kTileQ * kGp) msda_bwd_bf16_tiled_kernel(
    const __nv_bfloat16* __restrict__ value, const int* __restrict__ level_meta,
    const float* __restrict__ loc, const float* __restrict__ attw,
    const float* __restrict__ grad_out, float* __restrict__ work,
    float* __restrict__ grad_loc, float* __restrict__ grad_attw, int N, int H, int D, int L,
    int P) {
  constexpr int kThreads = kTileQ * kGp;
  constexpr int kSlotTaps = kRoundP * 4;
  __shared__ int s_meta[3 * kMaxLevels];  // h, w, start of each level
  __shared__ int s_tap[kRoundTaps];       // pixel (cy << 16 | cx) or -1
  __shared__ float s_coef[kRoundTaps];    // a * w_x * w_y
  __shared__ int s_cnt[kWindow];          // taps of each window row
  __shared__ int2 s_rows[kWindow];        // rows with taps: (window row, row of work)
  __shared__ int s_nrows;
  __shared__ int s_box[2][4];             // per round parity: min x, -max x, min y, -max y
  // dynamic: the merge slots, then the tile's output gradient (kTileQ x D, head h)
  extern __shared__ __align__(16) float2 s_slot[];  // (a * w_x * w_y, slot * D as int)
  float* s_g = reinterpret_cast<float*>(s_slot + kSlots);
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * L; i += kThreads) s_meta[i] = level_meta[i];
  for (int i = tid; i < kWindow; i += kThreads) s_cnt[i] = 0;
  if (tid < 8) (&s_box[0][0])[tid] = INT_MAX;
  if (tid == 0) s_nrows = 0;
  __syncthreads();

  // This block's tile: level ql, first pixel (ty0, tx0) (the host's plan,
  // deform_attn.py::bwd_bf16_plan, counts the same tiles).
  int t = blockIdx.x, ql = 0;
  for (; ql < L; ++ql) {
    const int n = ((s_meta[3 * ql] + kTileH - 1) / kTileH) *
                  ((s_meta[3 * ql + 1] + kTileW - 1) / kTileW);
    if (t < n) break;
    t -= n;
  }
  if (ql == L) return;  // block-uniform, before any further barrier
  const int qh = s_meta[3 * ql], qw = s_meta[3 * ql + 1];
  const int nx = (qw + kTileW - 1) / kTileW;
  const int ty0 = t / nx * kTileH, tx0 = t % nx * kTileW;
  const int slot = tid / kGp, g = tid % kGp;
  const int y = ty0 + slot / kTileW, x = tx0 + slot % kTileW;
  // A slot past the level's edge (a tail tile) works on the tile's first
  // query and records, adds and stores nothing: the shuffles and barriers
  // need every thread.
  const bool own = y < qh && x < qw;
  const int q = s_meta[3 * ql + 2] + (own ? y * qw + x : ty0 * qw + tx0);
  const bool live = own && g < (D >> 3);  // not a spare thread of the group
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t item = (b * N + q) * H + h;  // (b, q, head)
  const int LP = L * P;
  const int row_stride = H * D;
  const int64_t bh_off = b * (int64_t)N * row_stride + h * D;
  const __nv_bfloat16* v_bh = value + bh_off + 8 * g;
  float* w_bh = work + bh_off;
  const float* loc_i = loc + item * LP * 2;
  const float* aw_i = attw + item * LP;
  float* gloc_i = grad_loc + item * LP * 2;
  float* gaw_i = grad_attw + item * LP;
  const bool vec = P % 2 == 0;  // then the pairs' vectors are aligned
  // The scatter's threads: thread tid serves 4-channel piece k of rows
  // tid / C4, + step, ... (threads past step * C4 idle there).
  const int C4 = D >> 2;
  const int k4 = tid % C4, step = kThreads / C4;
  const bool scatters = tid < step * C4;

  Vec8<float> go;  // this thread's 8 channels (8g .. 8g+7) of the output gradient
  if (live) {
    load_split(go, grad_out + item * D + 8 * g, 4);
    float4* sg = reinterpret_cast<float4*>(s_g + slot * D + 8 * g);
    sg[0] = go.lo;
    sg[1] = go.hi;
  } else {
    zero8(go);
  }

  int round = 0;
  for (int l = 0; l < L; ++l) {
    const int hl = s_meta[3 * l];
    const int wl = s_meta[3 * l + 1];
    const int lstart = s_meta[3 * l + 2];
    const __nv_bfloat16* v_l = v_bh + (int64_t)lstart * row_stride;
    for (int pb = 0; pb < P; pb += kRoundP, ++round) {
      int box[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
#pragma unroll
      for (int pp = 0; pp < kRoundP; pp += 2) {
        const int p0 = pb + pp;
        float a[2], s[2][3], wc[2][4];
        int pix[2][4];
        if (p0 < P) {  // block-uniform
          bf16_pair<kGp>(v_l, loc_i, aw_i, l * P + p0, p0 + 1 < P, vec, live, own, hl, wl,
                         row_stride, go, a, s, wc, pix);
          if (g == 0 && own) store_pair(s, a, vec, p0 + 1 < P, l * P + p0, hl, wl, gloc_i, gaw_i);
        } else {
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c) pix[u][c] = -1, wc[u][c] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (c % kGp != g) continue;
            const int i = (slot * kRoundP + pp + u) * 4 + c;
            s_tap[i] = pix[u][c];
            s_coef[i] = wc[u][c];
            if (pix[u][c] >= 0) {
              const int cx = pix[u][c] & 0xffff, cy = pix[u][c] >> 16;
              box[0] = min(box[0], cx);
              box[1] = min(box[1], -cx);
              box[2] = min(box[2], cy);
              box[3] = min(box[3], -cy);
            }
          }
      }
      const int par = round & 1;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = __reduce_min_sync(0xffffffffu, box[k]);
        if ((tid & 31) == 0 && v != INT_MAX) atomicMin(&s_box[par][k], v);
      }
      __syncthreads();
      const int bx0 = s_box[par][0], bx1 = -s_box[par][1];
      const int by0 = s_box[par][2], by1 = -s_box[par][3];
      // the other parity's box was last read before this round's barrier
      if (tid < 4) s_box[par ^ 1][tid] = INT_MAX;
      if (bx0 <= bx1) {  // the round has taps (block-uniform)
        const int ww = bx1 - bx0 + 1;
        const int W = ww * (by1 - by0 + 1);
        if (W <= kWindow) {
          const int K = kSlots / W;  // slots a row
          for (int i = tid; i < kRoundTaps; i += kThreads) {
            const int p = s_tap[i];
            if (p < 0) continue;
            const int cx = p & 0xffff, cy = p >> 16;
            const int lr = (cy - by0) * ww + cx - bx0;
            const int rank = atomicAdd(&s_cnt[lr], 1);
            const int row = lstart + cy * wl + cx;
            if (rank == 0) s_rows[atomicAdd(&s_nrows, 1)] = make_int2(lr, row);
            const int gd = i / kSlotTaps * D;  // the tap's query in s_g
            if (rank < K) {
              s_slot[lr * K + rank] = make_float2(s_coef[i], __int_as_float(gd));
            } else {  // a crowded row past its slots: this tap's reductions go now
              for (int k = 0; k < C4; ++k) {
                red_rows4(w_bh + (int64_t)row * row_stride + 4 * k,
                          scale4(reinterpret_cast<const float4*>(s_g + gd)[k], s_coef[i]));
              }
            }
          }
          __syncthreads();
          const int nrows = s_nrows;
          if (scatters) {
            for (int r = tid / C4; r < nrows; r += step) {
              const int2 row = s_rows[r];
              const float2* e = s_slot + row.x * K;
              const int n = min(s_cnt[row.x], K);
              float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
              for (int j = 0; j < n; ++j) {
                const float2 tp = e[j];
                fma4(acc, tp.x, reinterpret_cast<const float4*>(s_g + __float_as_int(tp.y))[k4]);
              }
              red_rows4(w_bh + (int64_t)row.y * row_stride + 4 * k4, acc);
            }
          }
          __syncthreads();
          for (int r = tid; r < nrows; r += kThreads) s_cnt[s_rows[r].x] = 0;
          if (tid == 0) s_nrows = 0;
        } else if (scatters) {
          for (int i = tid / C4; i < kRoundTaps; i += step) {
            const int p = s_tap[i];
            if (p < 0) continue;
            const int row = lstart + (p >> 16) * wl + (p & 0xffff);
            red_rows4(w_bh + (int64_t)row * row_stride + 4 * k4,
                      scale4(reinterpret_cast<const float4*>(s_g + i / kSlotTaps * D)[k4],
                             s_coef[i]));
          }
        }
      }
      __syncthreads();  // s_tap, s_coef and s_cnt are free for the next round
    }
  }
}

// msda_bwd_bf16 at the decoder sites (Q != N): d(locations) and d(weights)
// in msda_bwd_kernel's work order with the levels split over threads, one
// thread per (b, q, head, level, 8 channels) (a few hundred queries give too
// few threads otherwise), without a scatter.
template <int kGp>
__global__ void __launch_bounds__(kBwdThreads) msda_bwd_bf16_sample_kernel(
    const __nv_bfloat16* __restrict__ value, const int* __restrict__ level_meta,
    const float* __restrict__ loc, const float* __restrict__ attw,
    const float* __restrict__ grad_out, float* __restrict__ grad_loc,
    float* __restrict__ grad_attw, int B, int N, int Q, int H, int D, int L, int P) {
  __shared__ int s_meta[3 * kMaxLevels];
  for (int i = threadIdx.x; i < 3 * L; i += kBwdThreads) s_meta[i] = level_meta[i];
  __syncthreads();

  const int64_t total = (int64_t)B * Q * H * L;  // (b, q, head, level)
  const int64_t t = (int64_t)blockIdx.x * kBwdThreads + threadIdx.x;
  const int g = (int)(t & (kGp - 1));
  // Past the last (b, q, head, level) the group works on the last one's
  // points and stores nothing; it must not return before the shuffles.
  const bool in_range = t / kGp < total;
  const int64_t pair = in_range ? t / kGp : total - 1;
  const int l = (int)(pair % L);
  const int64_t item = pair / L;  // (b, q, head)
  const bool live = in_range && g < (D >> 3);
  const int h = (int)(item % H);
  const int64_t b = item / H / Q;
  const int LP = L * P;
  const int row_stride = H * D;
  const int hl = s_meta[3 * l];
  const int wl = s_meta[3 * l + 1];
  const __nv_bfloat16* v_l =
      value + (b * (int64_t)N + s_meta[3 * l + 2]) * row_stride + h * D + 8 * g;
  const float* loc_i = loc + item * LP * 2;
  const float* aw_i = attw + item * LP;
  float* gloc_i = grad_loc + item * LP * 2;
  float* gaw_i = grad_attw + item * LP;
  const bool vec = P % 2 == 0;

  Vec8<float> go;
  if (live) {
    load_split(go, grad_out + item * D + 8 * g, 4);
  } else {
    zero8(go);
  }
  for (int p0 = 0; p0 < P; p0 += 2) {
    float a[2], s[2][3], wc[2][4];
    int pix[2][4];
    bf16_pair<kGp>(v_l, loc_i, aw_i, l * P + p0, p0 + 1 < P, vec, live, false, hl, wl,
                   row_stride, go, a, s, wc, pix);
    if (g == 0 && in_range) store_pair(s, a, vec, p0 + 1 < P, l * P + p0, hl, wl, gloc_i, gaw_i);
  }
}

// Dynamic shared memory of msda_bwd_bf16_value_kernel at D channels and P
// points: the sorted taps, keys and coefficients, the row counts and
// offsets, a segment's gradient rows.
__host__ __device__ int value_segment_queries(int P) {
  return kValPoints / P < kValQueries ? kValPoints / P : kValQueries;
}
size_t value_smem_bytes(int D, int P) {
  const int seg_q = value_segment_queries(P);
  return (size_t)4 * kValPoints * (sizeof(float2) + 2 * sizeof(int)) +
         2 * kValRows * sizeof(int) + (size_t)seg_q * D * sizeof(float);
}

// msda_bwd_bf16's d(value) at the decoder sites: block (row block, head, b)
// owns up to kValRows consecutive rows of one level (the host's plan counts
// the same blocks) and writes each once as bf16, zeros included: no zero
// fill, no scatter, no cast pass. Per segment of the queries (all of them at
// the decoder sites) it stages their output gradient rows in shared memory
// and walks their points of the level, one a thread, listing the taps that
// land in its rows (a shared int atomic gives each its rank in its row); a
// counting sort groups them by row and one thread per (row, 4 channels) sums
// its row's taps, sum_t a w_corner g_q(t), in registers. With several
// segments (more than kValQueries queries, or kValPoints points) the partial
// sums go through the fp32 `work` rows of the block, which no other block
// touches: plain loads and stores.
__global__ void __launch_bounds__(kValThreads) msda_bwd_bf16_value_kernel(
    const int* __restrict__ level_meta, const float* __restrict__ loc,
    const float* __restrict__ attw, const float* __restrict__ grad_out,
    __nv_bfloat16* __restrict__ grad_value, float* __restrict__ work, int N, int Q, int H,
    int D, int L, int P) {
  __shared__ int s_meta[3 * kMaxLevels];
  __shared__ int s_warp[32];
  extern __shared__ __align__(16) unsigned char s_dyn[];  // layout: value_smem_bytes
  float2* s_sorted = reinterpret_cast<float2*>(s_dyn);         // (a w_x w_y, q's offset in s_g)
  int* s_key = reinterpret_cast<int*>(s_sorted + 4 * kValPoints);  // row << 12 | rank, or -1
  float* s_coef = reinterpret_cast<float*>(s_key + 4 * kValPoints);
  int* s_cnt = reinterpret_cast<int*>(s_coef + 4 * kValPoints);    // taps of each row
  int* s_off = s_cnt + kValRows;                                   // their first place
  float* s_g = reinterpret_cast<float*>(s_off + kValRows);         // segment's gradient rows
  const int tid = threadIdx.x;
  for (int i = tid; i < 3 * L; i += kValThreads) s_meta[i] = level_meta[i];
  __syncthreads();
  int t = blockIdx.x, l = 0;
  for (; l < L; ++l) {
    const int n = (s_meta[3 * l] * s_meta[3 * l + 1] + kValRows - 1) / kValRows;
    if (t < n) break;
    t -= n;
  }
  if (l == L) return;  // block-uniform
  const int hl = s_meta[3 * l], wl = s_meta[3 * l + 1];
  const int r0 = t * kValRows;
  const int rows = min(kValRows, hl * wl - r0);
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int C4 = D >> 2;
  const int k4 = tid % C4, step = kValThreads / C4;  // as in the tiled kernel
  const bool sums = tid < step * C4;
  const int row_stride = H * D;
  const int seg_q = value_segment_queries(P);
  const int segs = (Q + seg_q - 1) / seg_q;
  const float* g_bh = grad_out + b * (int64_t)Q * row_stride + h * D;
  const int64_t out0 = ((b * N + s_meta[3 * l + 2] + r0) * H + h) * (int64_t)D;
  for (int i = tid; i < rows; i += kValThreads) s_cnt[i] = 0;
  for (int seg = 0; seg < segs; ++seg) {
    const int q0 = seg * seg_q;
    const int nq = min(seg_q, Q - q0);
    for (int i = tid; i < nq * C4; i += kValThreads) {
      const int qq = i / C4, kk = i - qq * C4;
      reinterpret_cast<float4*>(s_g + qq * D)[kk] =
          __ldg(reinterpret_cast<const float4*>(g_bh + (int64_t)(q0 + qq) * row_stride) + kk);
    }
    __syncthreads();  // s_cnt zeroed
    for (int i = tid; i < nq * P; i += kValThreads) {
      const int qq = i / P, p = i - qq * P;
      const int64_t pt = (((b * Q + q0 + qq) * H + h) * L + l) * P + p;
      const float2 xy = __ldg(reinterpret_cast<const float2*>(loc) + pt);
      const float a = __ldg(attw + pt);
      int x0, y0;
      float fx, fy;
      corner(xy.x, xy.y, hl, wl, x0, y0, fx, fy);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cx = x0 + (c & 1);
        const int cy = y0 + (c >> 1);
        const int lr = cy * wl + cx - r0;
        int key = -1;
        if (cx >= 0 && cx < wl && cy >= 0 && cy < hl && lr >= 0 && lr < rows) {
          key = (lr << 12) | atomicAdd(&s_cnt[lr], 1);
        }
        s_key[4 * i + c] = key;
        s_coef[4 * i + c] = a * ((c & 1) ? fx : 1.f - fx) * ((c >> 1) ? fy : 1.f - fy);
      }
    }
    __syncthreads();
    block_exclusive_scan<kValThreads>(s_cnt, s_off, rows, s_warp);
    __syncthreads();
    for (int j = tid; j < 4 * nq * P; j += kValThreads) {
      const int key = s_key[j];
      if (key >= 0) {
        s_sorted[s_off[key >> 12] + (key & 4095)] =
            make_float2(s_coef[j], __int_as_float(j / 4 / P * D));
      }
    }
    __syncthreads();
    if (sums) {
      for (int lr = tid / C4; lr < rows; lr += step) {
        const float2* e = s_sorted + s_off[lr];
        const int n = s_cnt[lr];
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const float2 tp = e[j];
          fma4(acc, tp.x, reinterpret_cast<const float4*>(s_g + __float_as_int(tp.y))[k4]);
        }
        const int64_t o = out0 + (int64_t)lr * row_stride + 4 * k4;
        if (seg > 0) {
          const float4 w = *reinterpret_cast<const float4*>(work + o);
          acc.x += w.x;
          acc.y += w.y;
          acc.z += w.z;
          acc.w += w.w;
        }
        if (seg + 1 < segs) {
          *reinterpret_cast<float4*>(work + o) = acc;
        } else {
          *reinterpret_cast<uint2*>(grad_value + o) =
              make_uint2(bf16x2(acc.x, acc.y), bf16x2(acc.z, acc.w));
        }
      }
    }
    __syncthreads();  // s_g, s_sorted and s_cnt are free for the next segment
    for (int i = tid; i < rows; i += kValThreads) s_cnt[i] = 0;
  }
}

// fp32 -> bf16, 8 values a thread, rounded to nearest even (as torch's cast).
__global__ void __launch_bounds__(256) msda_bwd_bf16_cast_kernel(
    const float* __restrict__ in, __nv_bfloat16* __restrict__ out, int64_t n8) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n8) return;
  const float4 a = __ldg(reinterpret_cast<const float4*>(in) + 2 * i);
  const float4 c = __ldg(reinterpret_cast<const float4*>(in) + 2 * i + 1);
  reinterpret_cast<uint4*>(out)[i] = make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w),
                                                bf16x2(c.x, c.y), bf16x2(c.z, c.w));
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

// The tiled kernel with sg bytes of dynamic shared memory (the merge slots
// and s_g), allowed past the 48 KB default.
template <int kGp>
cudaError_t launch_tiled(dim3 grid, size_t sg, cudaStream_t s, const __nv_bfloat16* v,
                         const int* m, const float* lo, const float* aw, const float* go,
                         float* w, float* gl, float* ga, int N, int H, int D, int L, int P) {
  cudaError_t err = cudaFuncSetAttribute(msda_bwd_bf16_tiled_kernel<kGp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sg);
  if (err != cudaSuccess) return err;
  msda_bwd_bf16_tiled_kernel<kGp><<<grid, kTileQ * kGp, sg, s>>>(v, m, lo, aw, go, w, gl, ga,
                                                                 N, H, D, L, P);
  return cudaGetLastError();
}

// tiled: the queries are the levels' pixels in order (Q == N), the
// encoder's call; blocks: the plan's count (tiles, or d(value) row blocks).
int launch_bwd_bf16(const void* value, const void* level_meta, const void* loc,
                    const void* attw, const void* grad_out, void* grad_value, void* grad_loc,
                    void* grad_attw, void* work, int B, int N, int Q, int H, int D, int L, int P,
                    int tiled, int blocks, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 8 || D > 64 || D % 8 != 0 || P < 1 ||
      (int64_t)N * H * D > 0x7fffffffLL || blocks < 1 || B > 65535 || H > 65535 ||
      (tiled && (Q != N || work == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t total = (int64_t)B * Q * H;
  if (total == 0) return (int)cudaSuccess;
  const int G = D / 8;
  const int Gp = G == 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : 8;  // threads per (b, q, head)
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(value);
  const int* m = static_cast<const int*>(level_meta);
  const float* lo = static_cast<const float*>(loc);
  const float* aw = static_cast<const float*>(attw);
  const float* go = static_cast<const float*>(grad_out);
  __nv_bfloat16* gv = static_cast<__nv_bfloat16*>(grad_value);
  float* gl = static_cast<float*>(grad_loc);
  float* ga = static_cast<float*>(grad_attw);
  const dim3 grid((unsigned)blocks, (unsigned)H, (unsigned)B);
  if (tiled) {
    float* w = static_cast<float*>(work);
    const int64_t n = (int64_t)B * N * H * D;
    cudaError_t err = cudaMemsetAsync(w, 0, n * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    const size_t sg = kSlots * sizeof(float2) + (size_t)kTileQ * D * sizeof(float);
    switch (Gp) {
      case 1:
        err = launch_tiled<1>(grid, sg, s, v, m, lo, aw, go, w, gl, ga, N, H, D, L, P);
        break;
      case 2:
        err = launch_tiled<2>(grid, sg, s, v, m, lo, aw, go, w, gl, ga, N, H, D, L, P);
        break;
      case 4:
        err = launch_tiled<4>(grid, sg, s, v, m, lo, aw, go, w, gl, ga, N, H, D, L, P);
        break;
      default:
        err = launch_tiled<8>(grid, sg, s, v, m, lo, aw, go, w, gl, ga, N, H, D, L, P);
    }
    if (err != cudaSuccess) return (int)err;
    const int64_t n8 = n / 8;
    msda_bwd_bf16_cast_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, s>>>(w, gv, n8);
    return (int)cudaGetLastError();
  }
  if (P > kValPoints || (Q > value_segment_queries(P) && work == nullptr)) {
    return (int)cudaErrorInvalidValue;  // the value kernel's segments need `work`
  }
  const int64_t sample_blocks = (total * L * Gp + kBwdThreads - 1) / kBwdThreads;
  if (sample_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned nb = (unsigned)sample_blocks;
  switch (Gp) {
    case 1:
      msda_bwd_bf16_sample_kernel<1><<<nb, kBwdThreads, 0, s>>>(v, m, lo, aw, go, gl, ga, B, N,
                                                                Q, H, D, L, P);
      break;
    case 2:
      msda_bwd_bf16_sample_kernel<2><<<nb, kBwdThreads, 0, s>>>(v, m, lo, aw, go, gl, ga, B, N,
                                                                Q, H, D, L, P);
      break;
    case 4:
      msda_bwd_bf16_sample_kernel<4><<<nb, kBwdThreads, 0, s>>>(v, m, lo, aw, go, gl, ga, B, N,
                                                                Q, H, D, L, P);
      break;
    default:
      msda_bwd_bf16_sample_kernel<8><<<nb, kBwdThreads, 0, s>>>(v, m, lo, aw, go, gl, ga, B, N,
                                                                Q, H, D, L, P);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = value_smem_bytes(D, P);
  err = cudaFuncSetAttribute(msda_bwd_bf16_value_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  msda_bwd_bf16_value_kernel<<<grid, kValThreads, smem, s>>>(m, lo, aw, go, gv,
                                                             static_cast<float*>(work), N, Q,
                                                             H, D, L, P);
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

// value and grad_value bf16; work: fp32 (B, N, H, D) scratch when tiled
// (zeroed here) or when the decoder sites' queries take several segments
// (Q > min(1024 / P, 256)), else unused (may be null).
int msda_bwd_bf16(const void* value, const void* level_meta, const void* loc,
                  const void* attw, const void* grad_out, void* grad_value,
                  void* grad_loc, void* grad_attw, void* work, int B, int N, int Q, int H,
                  int D, int L, int P, int tiled, int blocks, void* stream) {
  return launch_bwd_bf16(value, level_meta, loc, attw, grad_out, grad_value, grad_loc,
                         grad_attw, work, B, N, Q, H, D, L, P, tiled, blocks, stream);
}

#ifdef MSDA_COUNT_REDS
// Debug builds (chip_smoke.py --bwd-split): the vector reductions
// msda_bwd_bf16 sent since the last call; zeroes the count.
unsigned long long msda_red_count_take() {
  unsigned long long n = 0, zero = 0;
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(&n, msda_red_count, sizeof(n));
  cudaMemcpyToSymbol(msda_red_count, &zero, sizeof(zero));
  return n;
}
#endif

const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
