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
// is how the tensor-core rate falls with K when every product is only K deep.
//
// Bound on this card: operations. 2 * M * N * K * reps flops against
// (M * K * 4 + K * N * 2 + M * N * 4) bytes; at M = N = 1024, K = 16,
// reps = 48 that is 1.6 GFLOP for 4.3 MB, far above the ~295 flop/byte ridge
// of bf16 on an H100, so the least time is flops over the 989 TFLOP/s dense
// bf16 peak. Only wgmma (warpgroup products, B read from shared memory by the
// tensor cores) reaches that peak; the warp-level mma.sync reaches about a
// third of it, and there the per-rep fp32 add and bf16 conversion of A
// compete with the products for the warp schedulers.
//
// Design: one block of two warpgroups (256 threads) per 64 x kN output tile,
// kN one of 64, 128, 192, chosen on the host so that the grid is about one
// wave of the card's SMs (M = 1024: kN = 128 at N = 1024 and kN = 192 at
// N = 1536 each give 128 blocks); a ragged N or M edge is masked (zeros
// staged, no stores). Both warpgroups compute the whole tile, warpgroup 0 over
// the even reps and 1 over the odd ones, each into its own fp32 accumulators
// (kN / 2 a thread, in registers for the whole kernel); at the end warpgroup
// 1's sums join warpgroup 0's through shared memory.
//   - B: a slice of up to 256 rows of K is staged once in shared memory in
//     wgmma's canonical K-major layout without swizzle: 8 x 8 "core matrices"
//     (8 columns n, 8 depths k, each 128 contiguous bytes), K-adjacent core
//     matrices kN * 16 bytes apart (the descriptor's leading byte offset),
//     N-adjacent ones 128 bytes apart (its stride byte offset). Each thread
//     reads 8 rows x 2 columns of B as 32-bit words (coalesced along N) and
//     writes two 16-byte rows of two core matrices. The stores are ordinary
//     (generic proxy) stores, so fence.proxy.async.shared::cta and a barrier
//     come before any wgmma reads them. K beyond 256 is walked slice by
//     slice; dynamic shared memory is up to 96 KB (kN = 192).
//   - A: from registers (wgmma's register-fragment form, m64nNk16): warp w of
//     a warpgroup holds rows 16w .. 16w + 15 in the m16n8k16 A layout. A
//     thread reads its fp32 A values of 4 consecutive 16-deep steps once,
//     then for each of its reps adds i (__fadd_rn), rounds pairs to bf16
//     (cvt.rn.bf16x2.f32) and issues the 4 steps' wgmma as one group:
//     wgmma.fence, 4 x wgmma.mma_async, commit_group, wait_group 0.
//   - Overlap comes from the two warpgroups: while one builds its next
//     fragments (a wgmma reads its register operands asynchronously, so they
//     may not change before its group completes), the other's products keep
//     the tensor cores busy. Double-buffering the fragments within one
//     warpgroup (wait_group 1) does not work: ptxas cannot tell the buffers
//     apart across the runtime rep loop, reports C7513 ("wgmma serialized
//     due to non wgmma instructions defining input registers") and waits
//     after every wgmma, which ran slower than this design.
// Ordering note: the products of each rep are summed by the tensor cores in
// fp32 in their own order, and the even and odd reps in two partial sums; the
// bf16 operands and products are exact, so the result differs from the plain
// version only in the order of the fp32 sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // block tile rows: one wgmma m64
constexpr int kThreads = 256;  // two warpgroups
constexpr int kSliceK = 256;   // rows of K staged in shared memory at a time
constexpr int kChunk = 4;      // 16-deep steps whose A stays in registers across reps

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving an accumulator register across the
// asynchronous products (the register must stay put while a wgmma owns it).
template <int kR>
__device__ __forceinline__ void pin(float (&d)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading byte offset
// (K-adjacent core matrices), stride byte offset (N-adjacent core matrices),
// all in 16-byte units; layout 0 (no swizzle), base offset 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d += a (64 x 16, registers) @ B (16 x kN, shared memory), fp32 accumulate.
template <int kN>
__device__ __forceinline__ void wgmma_rs(float (&d)[kN / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95},"
      " {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
        "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),
        "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// B rows [k0, k0 + kc) x columns [n0, n0 + kN) into the canonical layout;
// columns at or past N are zeros.
template <int kN>
__device__ __forceinline__ void stage_b(const __nv_bfloat16* __restrict__ B, uint8_t* smem,
                                        int k0, int kc, int n0, int N) {
  constexpr int kPairs = kN / 2;
  constexpr int kLbo = kN * 16;
  const int units = (kc / 8) * kPairs;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int kb = u / kPairs;
    const int n = 2 * (u % kPairs);
    uint32_t v[8];
    if (n0 + n < N) {  // N % 8 == 0: the pair is wholly inside or outside
      const __nv_bfloat16* src = B + (int64_t)(k0 + 8 * kb) * N + n0 + n;
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = __ldg(reinterpret_cast<const uint32_t*>(src + (int64_t)r * N));
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = 0u;
    }
    uint4 lo, hi;  // column n and n + 1, depths 8 kb .. 8 kb + 7
    lo.x = __byte_perm(v[0], v[1], 0x5410);
    lo.y = __byte_perm(v[2], v[3], 0x5410);
    lo.z = __byte_perm(v[4], v[5], 0x5410);
    lo.w = __byte_perm(v[6], v[7], 0x5410);
    hi.x = __byte_perm(v[0], v[1], 0x7632);
    hi.y = __byte_perm(v[2], v[3], 0x7632);
    hi.z = __byte_perm(v[4], v[5], 0x7632);
    hi.w = __byte_perm(v[6], v[7], 0x7632);
    uint4* dst = reinterpret_cast<uint4*>(smem + kb * kLbo + (n >> 3) * 128 + (n & 7) * 16);
    dst[0] = lo;
    dst[1] = hi;
  }
}

// One chunk of kSteps 16-deep steps (step s at depth k + 16 s of A, and at
// b_addr + s * 2 * kLbo of the staged slice), for this warpgroup's reps.
template <int kN, int kSteps>
__device__ __forceinline__ void run_chunk(float (&acc)[kN / 2], const float* __restrict__ a_r0,
                                          const float* __restrict__ a_r1, int k,
                                          uint32_t b_addr, int reps) {
  constexpr uint32_t kLbo = kN * 16;
  const int tig = threadIdx.x & 3;
  float2 af[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = k + 16 * s + 2 * tig;
    const float2 z = make_float2(0.f, 0.f);
    af[s][0] = a_r0 ? __ldg(reinterpret_cast<const float2*>(a_r0 + c)) : z;
    af[s][1] = a_r1 ? __ldg(reinterpret_cast<const float2*>(a_r1 + c)) : z;
    af[s][2] = a_r0 ? __ldg(reinterpret_cast<const float2*>(a_r0 + c + 8)) : z;
    af[s][3] = a_r1 ? __ldg(reinterpret_cast<const float2*>(a_r1 + c + 8)) : z;
  }
  uint64_t desc[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) desc[s] = smem_desc(b_addr + s * 2 * kLbo, kLbo, 128);

  // This warpgroup's reps (warpgroup 0 the even ones, 1 the odd ones): build
  // the fragments, issue the steps' products as one group, wait for it.
  uint32_t frag[kSteps][4];
  for (int i = threadIdx.x >> 7; i < reps; i += 2) {
    const float fi = (float)i;
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        frag[s][r] = pack_bf16(__fadd_rn(af[s][r].x, fi), __fadd_rn(af[s][r].y, fi));
    wgmma_fence();
    pin(acc);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) wgmma_rs<kN>(acc, frag[s], desc[s]);
    wgmma_commit();
    wgmma_wait_all();
    pin(acc);
  }
}

template <int kN>
__global__ void __launch_bounds__(kThreads, 1) tc_kdepth_kernel(
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ B,
    float* __restrict__ out, int M, int N, int K, int reps) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = (threadIdx.x >> 5) & 3;  // warp within its warpgroup
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kN;
  const int r0 = m0 + 16 * warp + grp;  // this thread's two rows
  const int r1 = r0 + 8;
  const float* a_r0 = r0 < M ? A + (int64_t)r0 * K : nullptr;
  const float* a_r1 = r1 < M ? A + (int64_t)r1 * K : nullptr;
  const uint32_t b_addr = (uint32_t)__cvta_generic_to_shared(smem);

  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kSliceK) {
    const int kc = min(kSliceK, K - k0);  // a multiple of 16
    if (k0 > 0) __syncthreads();  // every product of the last slice has completed
    stage_b<kN>(B, smem, k0, kc, n0, N);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    for (int kk = 0; kk < kc; kk += 16 * kChunk) {
      const uint32_t b_kk = b_addr + (kk / 8) * kN * 16;
      switch (min(kChunk, (kc - kk) / 16)) {
        case 4: run_chunk<kN, 4>(acc, a_r0, a_r1, k0 + kk, b_kk, reps); break;
        case 3: run_chunk<kN, 3>(acc, a_r0, a_r1, k0 + kk, b_kk, reps); break;
        case 2: run_chunk<kN, 2>(acc, a_r0, a_r1, k0 + kk, b_kk, reps); break;
        default: run_chunk<kN, 1>(acc, a_r0, a_r1, k0 + kk, b_kk, reps); break;
      }
    }
  }

  // Warpgroup 1's partial sums join warpgroup 0's through shared memory
  // (the staged B is no longer read: every group has completed).
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  const int lr0 = 16 * warp + grp;  // the thread's rows within the tile
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      *reinterpret_cast<float2*>(&part[lr0 * kN + c]) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(&part[(lr0 + 8) * kN + c]) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  if (wg == 1) return;
  // Accumulator layout (m64nNk16): per 8-column block j, acc[4j], acc[4j+1]
  // at row r0, columns 8j + 2 tig, + 1; acc[4j+2], acc[4j+3] at row r1.
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * tig;
    if (col >= N) continue;
    const float2 p0 = *reinterpret_cast<const float2*>(&part[lr0 * kN + 8 * j + 2 * tig]);
    const float2 p1 = *reinterpret_cast<const float2*>(&part[(lr0 + 8) * kN + 8 * j + 2 * tig]);
    if (r0 < M) {
      *reinterpret_cast<float2*>(&out[(int64_t)r0 * N + col]) =
          make_float2(acc[4 * j] + p0.x, acc[4 * j + 1] + p0.y);
    }
    if (r1 < M) {
      *reinterpret_cast<float2*>(&out[(int64_t)r1 * N + col]) =
          make_float2(acc[4 * j + 2] + p1.x, acc[4 * j + 3] + p1.y);
    }
  }
}

template <int kN>
int launch(const float* A, const __nv_bfloat16* B, float* out, int M, int N, int K,
           int reps, cudaStream_t s) {
  const int smem = max(min(kSliceK, K) * kN * 2, kBM * kN * 4);  // B slice, or partial sums
  static int configured = 0;  // the largest dynamic shared memory allowed so far
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        tc_kdepth_kernel<kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const dim3 grid((N + kN - 1) / kN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  tc_kdepth_kernel<kN><<<grid, kThreads, smem, s>>>(A, B, out, M, N, K, reps);
  return (int)cudaGetLastError();
}

// The tile width whose grid takes the fewest tile-columns of work per SM:
// waves(kN) * kN, waves counted over the card's SMs; ties go to the wider
// tile (fewer fragment builds and B stagings per product).
int pick_tile(int M, int N) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms < 1) {
      sms = 132;
    }
  }
  const int64_t rows = (M + kBM - 1) / kBM;
  int best = 192;
  int64_t best_cost = -1;
  const int widths[3] = {192, 128, 64};
  for (int n : widths) {
    const int64_t tiles = rows * ((N + n - 1) / n);
    const int64_t cost = (tiles + sms - 1) / sms * n;
    if (best_cost < 0 || cost < best_cost) {
      best = n;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch; rejects K not a multiple of 16, N not
// a multiple of 8, and empty shapes, without launching. A, B and out must be
// 16-byte aligned (the wrapper checks).
int tc_kdepth_bf16(const void* A, const void* B, void* out, int M, int N, int K,
                   int reps, void* stream) {
  if (M < 1 || N < 8 || K < 16 || K % 16 != 0 || N % 8 != 0 || reps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(B);
  float* o = static_cast<float*>(out);
  switch (pick_tile(M, N)) {
    case 192: return launch<192>(a, b, o, M, N, K, reps, s);
    case 128: return launch<128>(a, b, o, M, N, K, reps, s);
    default: return launch<64>(a, b, o, M, N, K, reps, s);
  }
}

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
