// Tensor-core throughput against contraction depth, for Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel of tools/probe_mxu_kdepth.py (make_kernel,
// pallas_call in run): a chain of bf16 products accumulated in fp32,
//
//   out (M, N) fp32 = sum_{i < reps} bf16(A + i) @ B,
//
// A (M, K) fp32 row-major, offset by i and rounded to bf16 (nearest even) in
// the kernel; B (K, N) bf16 row-major; out (M, N) fp32 row-major. The TPU
// probe asks whether the matrix unit pads a shallow K; on Hopper the question
// is how the warp-level tensor-core rate falls with K when every product is
// only K deep.
//
// Design: one block of 4 warps per 64 x 64 output tile (M = N = 1024 gives
// 256 blocks, two per SM on the 132 SMs). The block stages a 64 x 32 slice of
// A (fp32) and a 32 x 64 slice of B (bf16, stored n-major so that a thread's
// two k-adjacent B values are one 32-bit word) in shared memory, then each
// warp computes its 32 x 32 quarter with mma.sync.aligned.m16n8k16 (bf16 in,
// fp32 accumulate): per 16-deep step it loads its A and B fragments once and
// runs the reps loop on them, adding i and rounding to bf16 in registers
// (cvt.rn.bf16x2.f32) before the 8 products of the step. The accumulators
// stay in registers for the whole kernel.
//
// Bound on this card: operations. 2 * M * N * K * reps flops against
// (M * K * 4 + K * N * 2 + M * N * 4) bytes; at M = N = 1024, K = 16,
// reps = 48 that is 1.6 GFLOP for 4.3 MB, far above the ~295 flop/byte ridge
// of bf16 on an H100, so the least time is flops over the 989 TFLOP/s dense
// bf16 peak. That peak needs wgmma (warpgroup products from shared memory);
// mma.sync reaches a fraction of it, and the per-rep fp32 add and bf16
// conversion of A compete with the products for the warp schedulers. wgmma and a
// persistent, pipelined tiling are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // block tile rows
constexpr int kBN = 64;   // block tile columns
constexpr int kBK = 32;   // K slice staged in shared memory
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads) tc_kdepth_kernel(
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    float* __restrict__ out, int M, int N, int K, int reps) {
  __shared__ __align__(16) float As[kBM][kBK + 4];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN][kBK + 8];  // [n][k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int wm = (warp >> 1) * 32;  // warp's rows within the tile
  const int wn = (warp & 1) * 32;   // warp's columns within the tile
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kc = min(kBK, K - k0);  // 16 or 32: K is a multiple of 16
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      As[r][c] = (m0 + r < M && c < kc) ? A[(int64_t)(m0 + r) * K + k0 + c] : 0.f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int k = idx / kBN, n = idx % kBN;  // consecutive threads: consecutive n
      Bs[n][k] = (k < kc && n0 + n < N) ? B[(int64_t)(k0 + k) * N + n0 + n]
                                        : __float2bfloat16(0.f);
    }
    __syncthreads();

    for (int kk = 0; kk < kc; kk += 16) {
      // A fragments (fp32, before the offset): rows grp and grp + 8 of each
      // 16-row tile, columns 2*tig, 2*tig + 1 and those + 8.
      float2 af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + grp;
        af[mt][0] = *reinterpret_cast<const float2*>(&As[r][kk + 2 * tig]);
        af[mt][1] = *reinterpret_cast<const float2*>(&As[r + 8][kk + 2 * tig]);
        af[mt][2] = *reinterpret_cast<const float2*>(&As[r][kk + 8 + 2 * tig]);
        af[mt][3] = *reinterpret_cast<const float2*>(&As[r + 8][kk + 8 + 2 * tig]);
      }
      // B fragments: column grp of each 8-column tile, rows 2*tig, 2*tig + 1
      // (one 32-bit word of the n-major tile) and those + 8.
      uint32_t bf[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wn + nt * 8 + grp;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 2 * tig]);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(&Bs[c][kk + 8 + 2 * tig]);
      }
      for (int i = 0; i < reps; ++i) {
        const float fi = (float)i;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            a[r] = pack_bf16(__fadd_rn(af[mt][r].x, fi), __fadd_rn(af[mt][r].y, fi));
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, bf[nt][0], bf[nt][1]);
        }
      }
    }
    __syncthreads();
  }

  // C fragment: rows grp and grp + 8, columns 2*tig and 2*tig + 1. N is a
  // multiple of 8, so an 8-column tile is wholly inside or outside.
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + 2 * tig;
      if (col >= N) continue;
      const int row = m0 + wm + mt * 16 + grp;
      if (row < M) {
        *reinterpret_cast<float2*>(&out[(int64_t)row * N + col]) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      }
      if (row + 8 < M) {
        *reinterpret_cast<float2*>(&out[(int64_t)(row + 8) * N + col]) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch; rejects K not a multiple of 16, N not
// a multiple of 8, and empty shapes, without launching.
int tc_kdepth_bf16(const void* A, const void* B, void* out, int M, int N, int K,
                   int reps, void* stream) {
  if (M < 1 || N < 8 || K < 16 || K % 16 != 0 || N % 8 != 0 || reps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  tc_kdepth_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(A),
                                              static_cast<const __nv_bfloat16*>(B),
                                              static_cast<float*>(out), M, N, K, reps);
  return (int)cudaGetLastError();
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
