// extract_columns: a dense key batch's accumulator to finished database
// columns with their float64 mif0 filter values, for Hopper (sm_90a).
//
// Replaces no TPU kernel. It takes over host work: the extraction of a key
// batch's survivors (host._extract_compact over A's finite cells) and the
// mif0 filter over them
// (native/mif0_filter.cpp::run_range), which together took 41-55% of a
// dense DNA k=8 build on one host core while the card stood idle. Plain
// version: extract_columns_ref in ipk_tpu_torch/core/dense.py; wrapper:
// ipk_tpu_torch/core/kernels.py.
//
// A: [B, chunk] f32 row-major, -inf where pruned (group rows ascending, key
// columns). For every key column c:
//   counts[c]  = #{b : A[b, c] finite}    (1 or 0 with merge)
//   fv[c]      = mif0 of the column's entries, in float64:
//     lin_b = min(10^A[b, c], 1),  S = sum_b lin_b + (N - cnt) * thr,
//     tt = shannon(thr / S),  tv = sum_b shannon(lin_b / S),
//     fv = S * ((N * tt + (tv - cnt * tt)) - log2 N),
//   with shannon(x) = -x * log2(x); 0 where the column is dead.
//   offsets    = the exclusive scan of counts, [chunk + 1] int64;
//   branches[offsets[c] + j] = gid[b_j], scores[...] = A[b_j, c] for the
//   column's j-th live row b_j: key-major, groups ascending within a key
//   (the database's entry order).
// With merge only each column's first strict maximum (ties to the lowest
// row) is an entry, and mif0 runs over that one entry.
//
// The filter values follow the host's arithmetic step by step: one thread a
// column walks the rows in ascending order, so every sum is taken in the
// host's order, and every add, multiply and divide is an explicitly rounded
// __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn, which nvcc never contracts
// into an FMA (the host's build contracts nothing either). They differ from
// the host's only through exp10 and log2 rounding (CUDA's are within 1 ulp,
// the host's libm within 1 ulp), a few ulps of fv at most.
//
// What bounds it: bytes. A is read once for the counts and the sums, once
// more for the shannon sum and once by the emit pass (33.4 MB each at the
// main path's [510, 16384]), and 8 bytes are written an entry (6.4M entries
// a batch there: 51 MB), about 25 us at 3.35 TB/s with A read once. The
// column pass also does about 2 x 40 float64 operations an entry (exp10,
// log2, a divide), which the card's float64 units take in well under a
// millisecond a batch. Both passes read A with consecutive threads on
// consecutive columns, so every row's load is coalesced; the emit pass
// writes each column's run from its own thread.
//
// Entries: ipk_extract_columns (the column pass, then a one-block scan of
// the counts into offsets), ipk_extract_emit (entries at the offsets).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 128;      // columns a block
constexpr int SCAN_THREADS = 1024;

__device__ __forceinline__ double lin_score(float a) {
  return fmin(exp10(static_cast<double>(a)), 1.0);
}

__device__ __forceinline__ double shannon(double x) {
  return __dmul_rn(-x, log2(x));
}

// The row of the column's first strict maximum, or -1 where it is dead.
__device__ __forceinline__ int best_row(const float* __restrict__ col, int B,
                                        long long chunk) {
  int best = -1;
  float top = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float a = col[b * chunk];
    if (isfinite(a) && (best < 0 || a > top)) {
      best = b;
      top = a;
    }
  }
  return best;
}

template <bool kMerge, bool kMif0>
__global__ void __launch_bounds__(THREADS)
    columns_kernel(const float* __restrict__ A, int B, long long chunk,
                   double N, double thr, double log2N,
                   int* __restrict__ counts, double* __restrict__ fv) {
  const long long c = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (c >= chunk) return;
  const float* col = A + c;
  int cnt = 0;
  int best = -1;
  double ssum = 0.0;
  if constexpr (kMerge) {
    best = best_row(col, B, chunk);
    cnt = best >= 0;
    if (kMif0 && cnt) ssum = __dadd_rn(ssum, lin_score(col[best * chunk]));
  } else {
#pragma unroll 4
    for (int b = 0; b < B; ++b) {
      const float a = col[b * chunk];
      if (isfinite(a)) {
        ++cnt;
        if constexpr (kMif0) ssum = __dadd_rn(ssum, lin_score(a));
      }
    }
  }
  counts[c] = cnt;
  if constexpr (kMif0) {
    if (cnt == 0) {
      fv[c] = 0.0;
      return;
    }
    const double dcnt = static_cast<double>(cnt);
    const double S = __dadd_rn(ssum, __dmul_rn(__dsub_rn(N, dcnt), thr));
    const double tt = shannon(__ddiv_rn(thr, S));
    double tv = 0.0;
    if constexpr (kMerge) {
      tv = __dadd_rn(tv, shannon(__ddiv_rn(lin_score(col[best * chunk]), S)));
    } else {
#pragma unroll 4
      for (int b = 0; b < B; ++b) {
        const float a = col[b * chunk];
        if (isfinite(a))
          tv = __dadd_rn(tv, shannon(__ddiv_rn(lin_score(a), S)));
      }
    }
    const double H =
        __dadd_rn(__dmul_rn(N, tt), __dsub_rn(tv, __dmul_rn(dcnt, tt)));
    fv[c] = __dmul_rn(S, __dsub_rn(H, log2N));
  }
}

// offsets[i] = counts[0] + ... + counts[i - 1] for i <= n, in one block:
// each thread sums a run of counts, the block scans the run sums.
__global__ void __launch_bounds__(SCAN_THREADS)
    scan_kernel(const int* __restrict__ counts, long long n,
                long long* __restrict__ offsets) {
  __shared__ long long part[SCAN_THREADS];
  const int t = threadIdx.x;
  const long long per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
  const long long i0 = t * per < n ? t * per : n;
  const long long i1 = i0 + per < n ? i0 + per : n;
  long long sum = 0;
  for (long long i = i0; i < i1; ++i) sum += counts[i];
  part[t] = sum;
  __syncthreads();
  for (int d = 1; d < SCAN_THREADS; d <<= 1) {
    const long long v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  long long run = t ? part[t - 1] : 0;
  for (long long i = i0; i < i1; ++i) {
    offsets[i] = run;
    run += counts[i];
  }
  if (t == SCAN_THREADS - 1) offsets[n] = part[t];
}

template <bool kMerge>
__global__ void __launch_bounds__(THREADS)
    emit_kernel(const float* __restrict__ A, const int* __restrict__ gid,
                int B, long long chunk, const long long* __restrict__ offsets,
                int* __restrict__ branches, float* __restrict__ scores) {
  const long long c = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (c >= chunk) return;
  const float* col = A + c;
  long long o = offsets[c];
  if constexpr (kMerge) {
    const int best = best_row(col, B, chunk);
    if (best >= 0) {
      branches[o] = __ldg(gid + best);
      scores[o] = col[best * chunk];
    }
  } else {
    for (int b = 0; b < B; ++b) {
      const float a = col[b * chunk];
      if (isfinite(a)) {
        branches[o] = __ldg(gid + b);
        scores[o] = a;
        ++o;
      }
    }
  }
}

// The grid of a pass over `chunk` columns, or -1 where the shape is out of
// range (rows index as int, blocks as unsigned int).
long long column_blocks(long long B, long long chunk) {
  if (B < 0 || chunk < 0 || B > INT_MAX) return -1;
  const long long blocks = (chunk + THREADS - 1) / THREADS;
  return blocks > INT_MAX ? -1 : blocks;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success). Allocates nothing and does not
// synchronise.

// The column pass and the scan: counts [chunk] int32, fv [chunk] float64
// (only with mif0; may be null otherwise), offsets [chunk + 1] int64.
int ipk_extract_columns(const float* A, long long B, long long chunk,
                        double N, double thr, double log2N, int mif0,
                        int merge, int* counts, double* fv,
                        long long* offsets, int device,
                        cudaStream_t stream) {
  const long long blocks = column_blocks(B, chunk);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    const dim3 grid(static_cast<unsigned int>(blocks));
    const int b = static_cast<int>(B);
    if (merge && mif0)
      columns_kernel<true, true><<<grid, THREADS, 0, stream>>>(
          A, b, chunk, N, thr, log2N, counts, fv);
    else if (merge)
      columns_kernel<true, false><<<grid, THREADS, 0, stream>>>(
          A, b, chunk, N, thr, log2N, counts, fv);
    else if (mif0)
      columns_kernel<false, true><<<grid, THREADS, 0, stream>>>(
          A, b, chunk, N, thr, log2N, counts, fv);
    else
      columns_kernel<false, false><<<grid, THREADS, 0, stream>>>(
          A, b, chunk, N, thr, log2N, counts, fv);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(counts, chunk, offsets);
  return static_cast<int>(cudaGetLastError());
}

// The emit pass: branches [offsets[chunk]] int32 (the group ids' uint32
// bits) and scores [offsets[chunk]] f32 from A and gid [B] int32.
int ipk_extract_emit(const float* A, const int* gid, long long B,
                     long long chunk, int merge, const long long* offsets,
                     int* branches, float* scores, int device,
                     cudaStream_t stream) {
  const long long blocks = column_blocks(B, chunk);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned int>(blocks));
  if (merge)
    emit_kernel<true><<<grid, THREADS, 0, stream>>>(
        A, gid, static_cast<int>(B), chunk, offsets, branches, scores);
  else
    emit_kernel<false><<<grid, THREADS, 0, stream>>>(
        A, gid, static_cast<int>(B), chunk, offsets, branches, scores);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
