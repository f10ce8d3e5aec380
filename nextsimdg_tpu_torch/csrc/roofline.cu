// The ceiling probe on Hopper: a dependent float32 chain held in registers.
//
// Replaces the TPU kernel benchmarks/roofline.py:154 measure_vpu_peak
// (benchmarks/roofline.py::measure_vpu_peak, its pl.pallas_call at :190),
// which runs x = a*x + b, 16 links per loop iteration for 100,000
// iterations, over two (512, 512) float32 planes held in VMEM, and counts
// 2 operations per link: the ceiling of fused elementwise work. Here every
// element keeps x in a register for iters x unroll links and writes out
// once; the kernel is templated on the unroll (16, 64) and on the link:
//
//   fma      x = fma(a, x, b)             __fmaf_rn: stays fused under --fmad=false
//   mul_add  x = (a * x) + b              two roundings: what every port kernel issues
//   div      x = b / (x + a)              IEEE divide, as PyTorch's tensor/tensor `/`
//   sqrt     x = sqrt(x + a)              IEEE square root
//   shift0   x = (a * nb0(x)) + b         nb0: the -1 neighbour along axis 0 (rows)
//   shift1   x = (a * nb1(x)) + b         nb1: the -1 neighbour along axis 1 (columns)
//   fma_imm  x = fma(a, x, kChainImm)     b only starts the chain; the addend is an
//                                         immediate (1e-6f, the probe planes' b)
//
// The fma form's FFMA reads three registers (a, x and b differ per element,
// so the operand reuse cache never hits). On the H100 that issues at about
// 2/3 of the FFMA rate; the fma_imm form reads two and measures the FFMA
// ceiling itself (PERF.md). On the probe's planes (b = 1e-6 everywhere) the
// two forms compute the same numbers.
//
// Each element starts at x = b, as roofline.py:186 does. Shapes are any
// (nx, ny), row major; out-of-plane elements of an edge tile run the chain
// on a = 1, b = 0 (so x stays 0) and are never written.
//
// A block of 32 x 8 threads owns a kTileRows x kTileCols = 32 x 32 tile, and
// each thread carries kPerThread = 4 elements of one column, rows ty, ty + 8,
// ty + 16, ty + 24, interleaved link by link. At 512^2 the 65,536 threads
// are 15.5 warps per SM, each with 4 independent chains in flight against a
// dependent FMA latency of 4 cycles, and the loop's counter and branch are
// spread over 4 x unroll links. In a sweep on the H100 at 512^2-2048^2, 1
// or 2 elements a thread ran the fma form slower than 4, and 8 no faster.
//
// The shift links read the neighbour through shared memory within the
// block's tile: it is zero at the tile's edge (row 0 of the tile for shift0,
// column 0 for shift1), the counterpart of stencil.shift_m(x, axis,
// periodic=False) applied to each tile. Two tile buffers alternate link by
// link, so one __syncthreads per link orders the stores before the loads
// (and a buffer is rewritten only after the next link's barrier).
//
// What bounds it on the H100: operations. A call does 2 x unroll x iters
// operations per element (both forms count the mul and the add), 8.39e11 at
// 512^2, unroll 16 and 1e5 iterations: 12.5 ms at the data sheet's 67e12
// FP32 op/s. It moves 3 planes (3 MiB at 512^2), nothing against that. The
// fma forms issue one FFMA per link and the mul_add form an FMUL and an
// FADD, so the mul_add rate in op/s is about half the fma_imm one: the
// ceiling of the port's kernels, all built with --fmad=false.
#include <cuda_runtime.h>

namespace nst {

constexpr int kChainThreadsX = 32;  // columns of the tile, one per thread
constexpr int kChainThreadsY = 8;
constexpr int kPerThread = 4;  // elements per thread, interleaved
constexpr int kTileCols = kChainThreadsX;
constexpr int kTileRows = kChainThreadsY * kPerThread;

enum ChainLink { kFma = 0, kMulAdd = 1, kDiv = 2, kSqrt = 3, kShift0 = 4, kShift1 = 5, kFmaImm = 6 };
constexpr float kChainImm = 1e-6f;

template <int kLink>
__device__ __forceinline__ float chain_link(float x, float a, float b) {
  if constexpr (kLink == kFma) {
    return __fmaf_rn(a, x, b);
  } else if constexpr (kLink == kMulAdd) {
    return __fadd_rn(__fmul_rn(a, x), b);
  } else if constexpr (kLink == kFmaImm) {
    return __fmaf_rn(a, x, kChainImm);
  } else if constexpr (kLink == kDiv) {
    return __fdiv_rn(b, __fadd_rn(x, a));
  } else {
    return __fsqrt_rn(__fadd_rn(x, a));
  }
}

template <int kLink, int kUnroll>
__global__ void __launch_bounds__(kChainThreadsX * kChainThreadsY)
chain_kernel(const float* __restrict__ a_in, const float* __restrict__ b_in,
             float* __restrict__ out, int nx, int ny, int iters) {
  constexpr bool kShift = kLink == kShift0 || kLink == kShift1;
  __shared__ float tile[kShift ? 2 : 1][kTileRows][kTileCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kTileCols + tx;
  float a[kPerThread], b[kPerThread], x[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = blockIdx.y * kTileRows + ty + e * kChainThreadsY;
    const bool inside = i < nx && j < ny;
    const long idx = static_cast<long>(i) * ny + j;
    a[e] = inside ? a_in[idx] : 1.0f;
    b[e] = inside ? b_in[idx] : 0.0f;
    x[e] = b[e];
  }
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if constexpr (kShift) {
        float(*buf)[kTileCols] = tile[u & 1];
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) buf[ty + e * kChainThreadsY][tx] = x[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) {
          const int r = ty + e * kChainThreadsY;
          float nb;
          if constexpr (kLink == kShift0) {
            nb = r > 0 ? buf[r > 0 ? r - 1 : 0][tx] : 0.0f;
          } else {
            nb = tx > 0 ? buf[r][tx > 0 ? tx - 1 : 0] : 0.0f;
          }
          x[e] = __fadd_rn(__fmul_rn(a[e], nb), b[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kPerThread; ++e) x[e] = chain_link<kLink>(x[e], a[e], b[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = blockIdx.y * kTileRows + ty + e * kChainThreadsY;
    if (i < nx && j < ny) out[static_cast<long>(i) * ny + j] = x[e];
  }
}

template <int kUnroll>
inline cudaError_t launch_chain(int link, const float* a, const float* b, float* out, int nx,
                                int ny, int iters, cudaStream_t stream) {
  const dim3 grid((ny + kTileCols - 1) / kTileCols, (nx + kTileRows - 1) / kTileRows);
  const dim3 block(kChainThreadsX, kChainThreadsY);
  switch (link) {
    case kFma: chain_kernel<kFma, kUnroll><<<grid, block, 0, stream>>>(a, b, out, nx, ny, iters); break;
    case kMulAdd: chain_kernel<kMulAdd, kUnroll><<<grid, block, 0, stream>>>(a, b, out, nx, ny, iters); break;
    case kDiv: chain_kernel<kDiv, kUnroll><<<grid, block, 0, stream>>>(a, b, out, nx, ny, iters); break;
    case kSqrt: chain_kernel<kSqrt, kUnroll><<<grid, block, 0, stream>>>(a, b, out, nx, ny, iters); break;
    case kShift0: chain_kernel<kShift0, kUnroll><<<grid, block, 0, stream>>>(a, b, out, nx, ny, iters); break;
    case kShift1: chain_kernel<kShift1, kUnroll><<<grid, block, 0, stream>>>(a, b, out, nx, ny, iters); break;
    case kFmaImm: chain_kernel<kFmaImm, kUnroll><<<grid, block, 0, stream>>>(a, b, out, nx, ny, iters); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace nst

extern "C" {

// The tile of one block (rows, columns): the shift links' zero edges.
int nst_chain_tile_rows() { return nst::kTileRows; }
int nst_chain_tile_cols() { return nst::kTileCols; }

// out = the chain of `link` (0 fma, 1 mul_add, 2 div, 3 sqrt, 4 shift0,
// 5 shift1, 6 fma_imm) over iters x unroll links (unroll 16 or 64) from x = b, on
// (nx, ny) planes a, b. Launches on `stream` and returns cudaGetLastError();
// does not synchronise.
int nst_chain(const float* a, const float* b, float* out, int nx, int ny, int link, int unroll,
              int iters, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || ny < 1 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (unroll == 16) return static_cast<int>(nst::launch_chain<16>(link, a, b, out, nx, ny, iters, s));
  if (unroll == 64) return static_cast<int>(nst::launch_chain<64>(link, a, b, out, nx, ny, iters, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
