// combine_max: the masked outer-sum max over windows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ipk_tpu/core/pallas_kernels.py:combine_max
// (kernel body _combine_kernel). Plain version: combine_max_ref in
// ipk_tpu_torch/core/dense.py; wrapper: ipk_tpu_torch/core/kernels.py.
//
// For every ghost g:
//   A[g, i, j] = max_w (L[g, w, i] + R[g, w, j]),  then -inf where <= eps
//   counts[g] += #{(w, i, j) : L[g, w, i] + R[g, w, j] > eps}
// L: [G, W, nl], R: [G, W, nr], A: [G, nl, nr], all f32 row-major and
// contiguous; counts: [G] zero-initialised 64-bit.
//
// What bounds it on this card: FP32 ALU issue, not memory. Each candidate
// (w, i, j) costs about four ALU ops (add, max, compare, count) and no tensor
// core can help (it is an outer *sum*). The halves are read once per tile
// (nl + nr floats per window for nl * nr candidates), so at nl = nr = 256 a
// window's 65,536 candidates need 2 KB of input.
// What the design does about it: a register-tiled accumulator. A block owns
// a 32 x 64 tile of (i, j) for one ghost and walks all W windows; each of its
// 256 threads keeps 2 x 4 accumulators in registers and reads, per window,
// one float2 of L and one float4 of R from shared memory (two shared loads
// for eight candidates). Windows are staged TW at a time with coalesced loads
// along the contiguous last axis. Ragged i, j and W edges are filled with
// -inf in shared memory, which is inert under max and never counts.
//
// The mask is applied once, after the max: masking is monotone, so it
// commutes with the max over windows. The count is taken per window as the
// reference's explored-tuple counter is; per-thread counts are summed in the
// block and added once to counts[g] with an integer atomic, so the total is
// deterministic, and 64-bit, so it does not wrap where W * sigma^k > 2^31.
// eps arrives as a C float and all arithmetic is exactly rounded f32
// (no fast-math), so A is bit-equal to the plain version.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int TI = 32;        // rows (i) of a block's tile
constexpr int TJ = 64;        // columns (j) of a block's tile
constexpr int TW = 32;        // windows staged in shared memory per chunk
constexpr int RI = 2;         // rows per thread
constexpr int RJ = 4;         // columns per thread
constexpr int THREADS = (TI / RI) * (TJ / RJ);   // 16 x 16 = 256
constexpr int WARPS = THREADS / 32;

static_assert(TI / RI == 16 && TJ / RJ == 16, "16 x 16 thread layout");

__global__ void __launch_bounds__(THREADS)
combine_max_kernel(const float* __restrict__ L, const float* __restrict__ R,
                   float eps, float* __restrict__ A,
                   unsigned long long* __restrict__ counts,
                   int W, int nl, int nr, int tiles_i, int tiles_j) {
  __shared__ __align__(16) float Ls[TW][TI];
  __shared__ __align__(16) float Rs[TW][TJ];
  __shared__ unsigned long long warp_sums[WARPS];

  const float NEG_INF = __int_as_float(0xff800000);
  long long b = blockIdx.x;
  const int tj = static_cast<int>(b % tiles_j);
  b /= tiles_j;
  const int ti = static_cast<int>(b % tiles_i);
  const long long g = b / tiles_i;
  const int i0 = ti * TI;
  const int j0 = tj * TJ;
  const int tid = threadIdx.x;
  const int ty = tid / (TJ / RJ);
  const int tx = tid % (TJ / RJ);

  const float* Lg = L + g * static_cast<long long>(W) * nl;
  const float* Rg = R + g * static_cast<long long>(W) * nr;

  float acc[RI][RJ];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) acc[r][c] = NEG_INF;
  unsigned int cnt = 0;

  for (int w0 = 0; w0 < W; w0 += TW) {
#pragma unroll
    for (int e = tid; e < TW * TI; e += THREADS) {
      const int w = e / TI, i = e % TI;
      const int gw = w0 + w, gi = i0 + i;
      Ls[w][i] = (gw < W && gi < nl)
                     ? Lg[static_cast<long long>(gw) * nl + gi] : NEG_INF;
    }
#pragma unroll
    for (int e = tid; e < TW * TJ; e += THREADS) {
      const int w = e / TJ, j = e % TJ;
      const int gw = w0 + w, gj = j0 + j;
      Rs[w][j] = (gw < W && gj < nr)
                     ? Rg[static_cast<long long>(gw) * nr + gj] : NEG_INF;
    }
    __syncthreads();
    const int tw = min(TW, W - w0);
#pragma unroll 4
    for (int w = 0; w < tw; ++w) {
      const float2 l = *reinterpret_cast<const float2*>(&Ls[w][ty * RI]);
      const float4 r = *reinterpret_cast<const float4*>(&Rs[w][tx * RJ]);
      const float lv[RI] = {l.x, l.y};
      const float rv[RJ] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int rr = 0; rr < RI; ++rr)
#pragma unroll
        for (int cc = 0; cc < RJ; ++cc) {
          const float t = __fadd_rn(lv[rr], rv[cc]);
          acc[rr][cc] = fmaxf(acc[rr][cc], t);
          cnt += (t > eps) ? 1u : 0u;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < RI; ++rr) {
    const int gi = i0 + ty * RI + rr;
    if (gi >= nl) continue;
    float* row = A + (g * nl + gi) * static_cast<long long>(nr);
#pragma unroll
    for (int cc = 0; cc < RJ; ++cc) {
      const int gj = j0 + tx * RJ + cc;
      if (gj < nr) row[gj] = acc[rr][cc] > eps ? acc[rr][cc] : NEG_INF;
    }
  }

  unsigned long long sum = cnt;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = sum;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) total += warp_sums[k];
    if (total) atomicAdd(&counts[g], total);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success). Allocates nothing and does not
// synchronise.
int ipk_combine_max(const float* L, const float* R, float eps, float* A,
                    unsigned long long* counts, long long G, long long W,
                    long long nl, long long nr, int device,
                    cudaStream_t stream) {
  if (G < 0 || W < 0 || nl < 0 || nr < 0 || W > INT_MAX || nl > INT_MAX ||
      nr > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_i = (nl + TI - 1) / TI;
  const long long tiles_j = (nr + TJ - 1) / TJ;
  const long long blocks = G * tiles_i * tiles_j;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  combine_max_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0,
                       stream>>>(L, R, eps, A, counts, static_cast<int>(W),
                                 static_cast<int>(nl), static_cast<int>(nr),
                                 static_cast<int>(tiles_i),
                                 static_cast<int>(tiles_j));
  return static_cast<int>(cudaGetLastError());
}

const char* ipk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
