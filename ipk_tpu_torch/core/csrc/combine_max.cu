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
//
// Positions mode (kPositions, entry ipk_combine_max_positions) replaces the
// jnp function ipk_tpu/core/dense.py:combine_max_with_positions (the aa-pos
// build's accumulator; plain version combine_max_with_positions_ref). Each
// accumulator keeps an int window beside it and is replaced only when
// t > acc: windows run in ascending order in every thread, so the earliest
// window of the maximum wins. After the loop a cell with acc <= eps is
// written (-inf, 0). One seam stays: ipk_tpu takes the maximum per block of
// 32 windows (the last block clamped to end at W) with XLA's max, which
// keeps the bits of the last window tied at the maximum. That differs from
// the first window's bits only where the maximum is a zero reached as both
// -0.0 and +0.0, so a live cell whose maximum is zero rescans the rest of
// its block from global memory and takes the last zero's bits. No real
// build reaches it; the check costs nothing on the hot loop.

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

constexpr int POS_BLOCK = 32;  // ipk_tpu's window block (builder block_w)

template <bool kPositions>
__global__ void __launch_bounds__(THREADS)
combine_max_kernel(const float* __restrict__ L, const float* __restrict__ R,
                   float eps, float* __restrict__ A, int* __restrict__ pos,
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
  int win[RI][RJ];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      acc[r][c] = NEG_INF;
      win[r][c] = 0;
    }
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
          if constexpr (kPositions) {
            if (t > acc[rr][cc]) {
              acc[rr][cc] = t;
              win[rr][cc] = w0 + w;
            }
          } else {
            acc[rr][cc] = fmaxf(acc[rr][cc], t);
          }
          cnt += (t > eps) ? 1u : 0u;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < RI; ++rr) {
    const int gi = i0 + ty * RI + rr;
    if (gi >= nl) continue;
    const long long cell0 = (g * nl + gi) * static_cast<long long>(nr);
#pragma unroll
    for (int cc = 0; cc < RJ; ++cc) {
      const int gj = j0 + tx * RJ + cc;
      if (gj >= nr) continue;
      const bool live = acc[rr][cc] > eps;
      float a = live ? acc[rr][cc] : NEG_INF;
      if constexpr (kPositions) {
        const int p = live ? win[rr][cc] : 0;
        if (live && a == 0.0f) {
          // the zero seam: the last zero of p's block gives the bits
          const int bw = min(POS_BLOCK, W);
          const int nb = (W + bw - 1) / bw;
          const int ib = min(p / bw, nb - 1);
          const int end = min(ib * bw, W - bw) + bw;
          for (int w = p + 1; w < end; ++w) {
            const float t =
                __fadd_rn(Lg[static_cast<long long>(w) * nl + gi],
                          Rg[static_cast<long long>(w) * nr + gj]);
            if (t == 0.0f) a = t;
          }
        }
        pos[cell0 + gj] = p;
      }
      A[cell0 + gj] = a;
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

template <bool kPositions>
int launch(const float* L, const float* R, float eps, float* A, int* pos,
           unsigned long long* counts, long long G, long long W, long long nl,
           long long nr, int device, cudaStream_t stream) {
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
  combine_max_kernel<kPositions>
      <<<static_cast<unsigned int>(blocks), THREADS, 0, stream>>>(
          L, R, eps, A, pos, counts, static_cast<int>(W),
          static_cast<int>(nl), static_cast<int>(nr),
          static_cast<int>(tiles_i), static_cast<int>(tiles_j));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry launches the kernel on `stream` of CUDA device `device` and
// returns cudaGetLastError() (0 on success). Allocates nothing and does not
// synchronise.
int ipk_combine_max(const float* L, const float* R, float eps, float* A,
                    unsigned long long* counts, long long G, long long W,
                    long long nl, long long nr, int device,
                    cudaStream_t stream) {
  return launch<false>(L, R, eps, A, nullptr, counts, G, W, nl, nr, device,
                       stream);
}

// Positions mode: pos [G, nl, nr] int32 gets the earliest window of each
// cell's maximum (0 where the cell is dead).
int ipk_combine_max_positions(const float* L, const float* R, float eps,
                              float* A, int* pos, unsigned long long* counts,
                              long long G, long long W, long long nl,
                              long long nr, int device, cudaStream_t stream) {
  return launch<true>(L, R, eps, A, pos, counts, G, W, nl, nr, device,
                      stream);
}

const char* ipk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
