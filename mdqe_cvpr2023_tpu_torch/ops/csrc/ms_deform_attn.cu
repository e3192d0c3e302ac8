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
// Design (both directions): one warp per (b, q, head), lane = channel (two
// channels per lane when 32 < D <= 64). Each tap reads one contiguous row of D
// channels of value (64 B in bf16, 128 B in fp32): one coalesced transaction
// per warp. The lanes load the L*P (x, y, weight) triples of their query
// cooperatively, 32 at a time, and broadcast them with warp shuffles. Sums are
// in fp32.
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
// may well be what limits it. Adjacent warps of a block serve the heads of one
// query, so their location reads are contiguous. TMA, wgmma, locality-ordered
// tiling and a deterministic segmented reduction for d(value) are left for
// later work.
//
// Block size: the forward kernel is a template over its block size. The main
// paths launch 256 threads (msda_fwd_f32, msda_fwd_bf16); msda_fwd_*_block
// take 64, 128, 256 or 512 threads for the tuning sweep
// (mdqe_cvpr2023_tpu_torch/tools/tune_deform_kernel.py), the Hopper
// counterpart of the TPU kernel's query-tile sweep in
// tools/tune_deform_kernel.py::run_level.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;  // the main paths' block size (and the backward's)
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int kChunks, int kBlock>
__global__ void __launch_bounds__(kBlock) msda_fwd_kernel(
    const T* __restrict__ value, const int* __restrict__ level_meta,
    const float* __restrict__ loc, const float* __restrict__ attw,
    float* __restrict__ out, int B, int N, int Q, int H, int D, int L, int P) {
  __shared__ int s_h[kMaxLevels];
  __shared__ int s_w[kMaxLevels];
  __shared__ int s_start[kMaxLevels];
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    s_h[i] = level_meta[3 * i];
    s_w[i] = level_meta[3 * i + 1];
    s_start[i] = level_meta[3 * i + 2];
  }
  __syncthreads();

  const int64_t item = (int64_t)blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  const int64_t total = (int64_t)B * Q * H;
  if (item >= total) return;  // whole warps exit; no barrier follows
  const int lane = threadIdx.x & 31;
  const int h = (int)(item % H);
  const int64_t b = item / H / Q;
  const int LP = L * P;
  const int64_t row_stride = (int64_t)H * D;  // elements between pixels

  const float* loc_i = loc + item * LP * 2;
  const float* aw_i = attw + item * LP;
  const T* v_bh = value + b * (int64_t)N * row_stride + (int64_t)h * D;

  float acc[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) acc[k] = 0.f;

  for (int base = 0; base < LP; base += 32) {
    const int i = base + lane;
    float lx = 0.f, ly = 0.f, la = 0.f;
    if (i < LP) {
      lx = loc_i[2 * i];
      ly = loc_i[2 * i + 1];
      la = aw_i[i];
    }
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
      const T* v_l = v_bh + (int64_t)s_start[l] * row_stride;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cx = x0 + (c & 1);
        const int cy = y0 + (c >> 1);
        if (cx < 0 || cx >= wl || cy < 0 || cy >= hl) continue;  // warp-uniform
        const float wc = a * ((c & 1) ? fx : 1.f - fx) * ((c >> 1) ? fy : 1.f - fy);
        const T* row = v_l + ((int64_t)cy * wl + cx) * row_stride;
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int d = lane + 32 * k;
          if (d < D) acc[k] += wc * to_float(row[d]);
        }
      }
    }
  }

  float* o = out + item * D;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int d = lane + 32 * k;
    if (d < D) o[d] = acc[k];
  }
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
  const int64_t total = (int64_t)B * Q * H;
  const int64_t blocks = (total + kBlock / 32 - 1) / (kBlock / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (D <= 32) {
    msda_fwd_kernel<T, 1, kBlock><<<(unsigned)blocks, kBlock, 0, s>>>(
        v, m, lo, aw, o, B, N, Q, H, D, L, P);
  } else {
    msda_fwd_kernel<T, 2, kBlock><<<(unsigned)blocks, kBlock, 0, s>>>(
        v, m, lo, aw, o, B, N, Q, H, D, L, P);
  }
  return (int)cudaGetLastError();
}

// threads: the block size, one of 64, 128, 256, 512.
template <typename T>
int launch(const void* value, const void* level_meta, const void* loc,
           const void* attw, void* out, int B, int N, int Q, int H, int D,
           int L, int P, int threads, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 64 || P < 1) {
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
  return launch<float>(value, level_meta, loc, attw, out, B, N, Q, H, D, L, P, kThreads,
                       stream);
}

int msda_fwd_bf16(const void* value, const void* level_meta, const void* loc,
                  const void* attw, void* out, int B, int N, int Q, int H, int D,
                  int L, int P, void* stream) {
  return launch<__nv_bfloat16>(value, level_meta, loc, attw, out, B, N, Q, H, D, L, P,
                               kThreads, stream);
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
