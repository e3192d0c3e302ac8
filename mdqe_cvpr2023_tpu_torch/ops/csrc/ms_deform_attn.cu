// Multi-scale deformable attention, forward, for Hopper (sm_90a).
//
// Replaces two TPU (Pallas) kernels of the JAX package, which compute the same
// function in two TPU formulations:
//   - mdqe_cvpr2023_tpu/ops/deform_attn_pallas.py::_deform_attn_fused
//     (full-contraction "hat-matmul": decoder box-level and temporal
//     cross-attention);
//   - mdqe_cvpr2023_tpu/ops/deform_attn_pallas.py::_deform_attn_banded
//     (block-permuted banded patches: encoder self-attention, Q == N).
// The hat-matmuls and the banding exist because TPU gather is slow. On Hopper
// the natural form is the direct 4-tap bilinear gather of the original CUDA op.
//
// Semantics: grid_sample(bilinear, padding_mode="zeros", align_corners=False).
// Pixel coordinate = loc * size - 0.5 with loc's last axis (x, y) and level
// shapes (h, w); a corner outside [0, w) x [0, h) contributes zero.
//
// Layouts (all contiguous):
//   value       (B, N, H, D)        fp32 or bf16
//   level_meta  (L, 3) int32        h, w, start row of each level
//   loc         (B, Q, H, L, P, 2)  fp32
//   attw        (B, Q, H, L, P)     fp32
//   out         (B, Q, H * D)       fp32
//
// Design: one warp per (b, q, head), lane = channel (two channels per lane
// when 32 < D <= 64). Each tap reads one contiguous row of D channels of value
// (64 B in bf16, 128 B in fp32): one coalesced transaction per warp. The lanes
// load the L*P (x, y, weight) triples of their query cooperatively, 32 at a
// time, and broadcast them with warp shuffles. Sums are in fp32.
//
// Bound on this card: memory. Per (b, q, head) the kernel does 4 taps x D
// multiply-adds per point for 2 + 1 fp32 words of location and weight read and
// 4 rows of D values, so it sits far below the ~20 FLOP/byte ridge of fp32 on
// an H100; its least time is the bytes it must move (value rows touched,
// locations, weights, output) over the 3.35 TB/s of HBM. Adjacent warps of a
// block serve the heads of one query, so their location reads are contiguous.
// TMA, wgmma and locality-ordered tiling are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads) msda_fwd_kernel(
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

  const int64_t item = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
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
      float x = px * (float)wl - 0.5f;
      float y = py * (float)hl - 0.5f;
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

template <typename T>
int launch(const void* value, const void* level_meta, const void* loc,
           const void* attw, void* out, int B, int N, int Q, int H, int D,
           int L, int P, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 64 || P < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t total = (int64_t)B * Q * H;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(value);
  const int* m = static_cast<const int*>(level_meta);
  const float* lo = static_cast<const float*>(loc);
  const float* aw = static_cast<const float*>(attw);
  float* o = static_cast<float*>(out);
  if (D <= 32) {
    msda_fwd_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, s>>>(v, m, lo, aw, o, B, N, Q, H, D, L, P);
  } else {
    msda_fwd_kernel<T, 2><<<(unsigned)blocks, kThreads, 0, s>>>(v, m, lo, aw, o, B, N, Q, H, D, L, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int msda_fwd_f32(const void* value, const void* level_meta, const void* loc,
                 const void* attw, void* out, int B, int N, int Q, int H, int D,
                 int L, int P, void* stream) {
  return launch<float>(value, level_meta, loc, attw, out, B, N, Q, H, D, L, P, stream);
}

int msda_fwd_bf16(const void* value, const void* level_meta, const void* loc,
                  const void* attw, void* out, int B, int N, int Q, int H, int D,
                  int L, int P, void* stream) {
  return launch<__nv_bfloat16>(value, level_meta, loc, attw, out, B, N, Q, H, D, L, P, stream);
}

const char* msda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
