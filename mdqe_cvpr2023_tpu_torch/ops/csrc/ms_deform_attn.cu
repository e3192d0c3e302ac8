// Multi-scale deformable attention, forward and backward, for Hopper (sm_90a).
//
// The forward replaces two TPU (Pallas) kernels of the JAX package, which
// compute the same function in two TPU formulations:
//   - mdqe_cvpr2023_tpu/ops/deform_attn_pallas.py::_deform_attn_fused
//     (full-contraction "hat-matmul": decoder box-level and temporal
//     cross-attention);
//   - mdqe_cvpr2023_tpu/ops/deform_attn_pallas.py::_deform_attn_banded
//     (block-permuted banded patches: encoder self-attention, Q == N).
// The backward (msda_bwd_f32) replaces the four Pallas backward kernels, which
// again compute one function in two formulations:
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
//   value       (B, N, H, D)        fp32 or bf16 (backward: fp32 only)
//   level_meta  (L, 3) int32        h, w, start row of each level
//   loc         (B, Q, H, L, P, 2)  fp32
//   attw        (B, Q, H, L, P)     fp32
//   out         (B, Q, H * D)       fp32
//   grad_out    (B, Q, H * D)       fp32
//   grad_value  (B, N, H, D)        fp32, zeroed by the caller
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
// Backward design: one warp per (b, q, head), lane = channel (two channels
// per lane when 32 < D <= 64). Each tap reads one contiguous row of D
// channels of value (128 B in fp32): one coalesced transaction per warp. The
// lanes load the L*P (x, y, weight) triples of their query cooperatively, 32
// at a time, and broadcast them with warp shuffles. Sums are in fp32.
//
// Backward: per (level, point) the warp recomputes the four taps and forms,
// per lane, g[d] * v[d] for its channels; three warp reductions (xor shuffles)
// give d(weight) = sum_d g.sample and d(x), d(y) = a * sum_d g.d(sample)/d(x, y)
// from the corner weights' derivatives, and the lane whose index is the
// point's slot keeps them, so the gradients of 32 points are written by one
// coalesced store. d(value) is a scatter: each in-range corner row gets
// atomicAdd(a * w_corner * g[d]), one fp32 atomic per channel and tap. The
// atomics make d(value)'s summation order vary from run to run.
//
// Bound on this card: memory. Per (b, q, head) the forward does 4 taps x D
// multiply-adds per point for 2 + 1 fp32 words of location and weight read and
// 4 rows of D values, so it sits far below the ~20 FLOP/byte ridge of fp32 on
// an H100; its least time is the bytes it must move (value rows touched,
// locations, weights, output) over the 3.35 TB/s of HBM. The backward moves
// those rows twice (read, and atomically written into d(value)) and its atomics
// and replicated per-lane coordinate work may well be what limit it; it keeps
// the warp-per-(q, head) design for now.
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
constexpr int kThreads = 256;     // the backward's block size
constexpr int kWarpsPerBlock = kThreads / 32;

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


template <int kChunks>
__global__ void __launch_bounds__(kThreads) msda_bwd_kernel(
    const float* __restrict__ value, const int* __restrict__ level_meta,
    const float* __restrict__ loc, const float* __restrict__ attw,
    const float* __restrict__ grad_out, float* __restrict__ grad_value,
    float* __restrict__ grad_loc, float* __restrict__ grad_attw,
    int B, int N, int Q, int H, int D, int L, int P) {
  __shared__ int s_h[kMaxLevels];
  __shared__ int s_w[kMaxLevels];
  __shared__ int s_start[kMaxLevels];
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    s_h[i] = level_meta[3 * i];
    s_w[i] = level_meta[3 * i + 1];
    s_start[i] = level_meta[3 * i + 2];
  }
  __syncthreads();

  const int64_t item = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t total = (int64_t)B * Q * H;
  if (item >= total) return;  // whole warps exit; no barrier follows
  const int lane = threadIdx.x & 31;
  const int h = (int)(item % H);
  const int64_t b = item / H / Q;
  const int LP = L * P;
  const int64_t row_stride = (int64_t)H * D;

  const float* loc_i = loc + item * LP * 2;
  const float* aw_i = attw + item * LP;
  float* gloc_i = grad_loc + item * LP * 2;
  float* gaw_i = grad_attw + item * LP;
  const int64_t bh_off = b * (int64_t)N * row_stride + (int64_t)h * D;
  const float* v_bh = value + bh_off;
  float* gv_bh = grad_value + bh_off;

  float g[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int d = lane + 32 * k;
    g[k] = d < D ? grad_out[item * D + d] : 0.f;
  }

  for (int base = 0; base < LP; base += 32) {
    const int i = base + lane;
    float lx = 0.f, ly = 0.f, la = 0.f;
    if (i < LP) {
      lx = loc_i[2 * i];
      ly = loc_i[2 * i + 1];
      la = aw_i[i];
    }
    float my_ga = 0.f, my_gx = 0.f, my_gy = 0.f;
    const int n = min(32, LP - base);
    for (int j = 0; j < n; ++j) {
      const float px = __shfl_sync(0xffffffffu, lx, j);
      const float py = __shfl_sync(0xffffffffu, ly, j);
      const float a = __shfl_sync(0xffffffffu, la, j);
      const int l = (base + j) / P;
      const int hl = s_h[l];
      const int wl = s_w[l];
      float x = __fmul_rn(px, (float)wl) - 0.5f;
      float y = __fmul_rn(py, (float)hl) - 0.5f;
      // Far outside the level every corner is out of range either way (no
      // contribution to any gradient); the clamp only keeps the int
      // conversion below defined.
      x = fminf(fmaxf(x, -2.f), (float)wl + 1.f);
      y = fminf(fmaxf(y, -2.f), (float)hl + 1.f);
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const float fx = x - x0f;
      const float fy = y - y0f;
      const int64_t lvl_off = (int64_t)s_start[l] * row_stride;
      float s_a = 0.f, s_x = 0.f, s_y = 0.f;  // this lane's channels only
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cx = x0 + (c & 1);
        const int cy = y0 + (c >> 1);
        if (cx < 0 || cx >= wl || cy < 0 || cy >= hl) continue;  // warp-uniform
        const float wx = (c & 1) ? fx : 1.f - fx;
        const float wy = (c >> 1) ? fy : 1.f - fy;
        const float dwx = (c & 1) ? 1.f : -1.f;  // d(wx)/d(x)
        const float dwy = (c >> 1) ? 1.f : -1.f;  // d(wy)/d(y)
        const float wc = a * wx * wy;
        const int64_t row_off = lvl_off + ((int64_t)cy * wl + cx) * row_stride;
        const float* row = v_bh + row_off;
        float* grow = gv_bh + row_off;
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int d = lane + 32 * k;
          if (d < D) {
            const float gv = g[k] * row[d];
            s_a += wx * wy * gv;
            s_x += dwx * wy * gv;
            s_y += wx * dwy * gv;
            atomicAdd(grow + d, wc * g[k]);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s_a += __shfl_xor_sync(0xffffffffu, s_a, off);
        s_x += __shfl_xor_sync(0xffffffffu, s_x, off);
        s_y += __shfl_xor_sync(0xffffffffu, s_y, off);
      }
      if (lane == j) {
        my_ga = s_a;
        my_gx = a * s_x * (float)wl;  // x = loc_x * w - 0.5
        my_gy = a * s_y * (float)hl;
      }
    }
    if (i < LP) {
      gaw_i[i] = my_ga;
      gloc_i[2 * i] = my_gx;
      gloc_i[2 * i + 1] = my_gy;
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

int launch_bwd(const void* value, const void* level_meta, const void* loc,
               const void* attw, const void* grad_out, void* grad_value,
               void* grad_loc, void* grad_attw, int B, int N, int Q, int H,
               int D, int L, int P, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 64 || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t total = (int64_t)B * Q * H;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(value);
  const int* m = static_cast<const int*>(level_meta);
  const float* lo = static_cast<const float*>(loc);
  const float* aw = static_cast<const float*>(attw);
  const float* go = static_cast<const float*>(grad_out);
  float* gv = static_cast<float*>(grad_value);
  float* gl = static_cast<float*>(grad_loc);
  float* ga = static_cast<float*>(grad_attw);
  if (D <= 32) {
    msda_bwd_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(v, m, lo, aw, go, gv, gl, ga,
                                                             B, N, Q, H, D, L, P);
  } else {
    msda_bwd_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(v, m, lo, aw, go, gv, gl, ga,
                                                             B, N, Q, H, D, L, P);
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
  return launch_bwd(value, level_meta, loc, attw, grad_out, grad_value, grad_loc,
                    grad_attw, B, N, Q, H, D, L, P, stream);
}

const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
