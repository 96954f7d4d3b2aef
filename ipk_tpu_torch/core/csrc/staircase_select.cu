// staircase_select: the capacity-bounded threshold combine of two survivor
// lists, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ipk_tpu/core/pallas_kernels.py:staircase_select_wide (kernel body
// _select_wide_kernel, helpers _bitonic_sublanes and _cumsum_sublanes_mxu).
// Plain version: staircase_select_ref in ipk_tpu_torch/core/sparse.py;
// wrapper: ipk_tpu_torch/core/kernels.py.
//
// For every window n (one of N = G * W):
//   1. sort R's (score, code) pairs, and L's when sort_l, by score
//      descending, then code ascending as unsigned 32-bit; scores compare
//      with IEEE > and ==, so -0.0 and +0.0 tie and the code decides;
//   2. cnt[i] = #{j : fl(sL[i] + sR[j]) > eps[n]}. fl(a + b) is monotone in
//      b, so the survivors of row i are a prefix of sorted R and cnt[i] is
//      found by a binary search;
//   3. off = inclusive prefix sum of cnt (int32: CL * CR <= 2^26);
//   4. slot t < min(total, cap) holds row i = first i with off[i] > t and
//      j = t - off[i - 1]: (cL[i], cR[j], fl(fl(sL[i] + sR[j]) + 0.0)). The
//      + 0.0 turns a -0.0 sum into +0.0 and changes nothing else: the TPU
//      kernel extracts each score as a masked sum starting from +0.0, and
//      emits +0.0 there too. Slots from there to cap are (0, 0, -inf);
//      totals[n] = total, even above cap.
// sL, sR: [N, CL], [N, CR] f32; cL, cR: the same shapes as int64 holding
// codes in [0, 2^32); eps: [N] f32; out_cl, out_cr: [N, cap] int64; out_s:
// [N, cap] f32; totals: [N] int32. All row-major and contiguous.
//
// What bounds it on this card: per window it reads (CL + CR) * 12 bytes and
// writes cap * 20 bytes; the work is the two sorts (O(C log^2 C) compares)
// and CL + cap binary searches, all in shared memory. With a few hundred
// entries per list and caps of a few thousand slots, writing the slots is
// the largest device-memory term.
// What the design does about it: one block per window, the lists staged once
// in dynamic shared memory (padded to a power of two with (-inf,
// 0xFFFFFFFF), which sinks), a bitonic network in shared memory, per-row
// binary searches instead of a CL x CR compare, one warp-shuffle block scan,
// and slot writes strided by the block so neighbouring threads write
// neighbouring addresses. At CL = CR = 8192 the staging takes 160 KB, above
// the default 48 KB, so the launch opts in to the larger carve-out.
// eps arrives per window as f32 and every sum is __fadd_rn (no fast-math),
// so values are bit-equal to the plain version.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int MAX_WIDTH = 8192;   // CL, CR and cap; the wrapper enforces it
constexpr int MAX_THREADS = 512;
// sL, cL, sR, cR padded to MAX_WIDTH, plus the row offsets
constexpr int MAX_SMEM = (4 * MAX_WIDTH + MAX_WIDTH) * 4;

__device__ __forceinline__ bool before(float sa, unsigned ca, float sb,
                                       unsigned cb) {
  return sa > sb || (sa == sb && ca < cb);
}

// Sorts n (a power of two) pairs in shared memory so that before() holds
// between neighbours. Ends with a barrier.
__device__ void bitonic_sort(float* s, unsigned* c, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));   // bit j clear
        const int l = i + j;
        const float si = s[i], sl = s[l];
        const unsigned ci = c[i], cl = c[l];
        const bool up = (i & k) == 0;
        if (up ? before(sl, cl, si, ci) : before(si, ci, sl, cl)) {
          s[i] = sl;
          s[l] = si;
          c[i] = cl;
          c[l] = ci;
        }
      }
      __syncthreads();
    }
  }
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32);
// *total receives the block's sum. Contains barriers.
__device__ int block_exclusive_scan(int v, int* buf /* [33] */, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? buf[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) buf[lane] = w;
    if (lane == 31) buf[32] = w;
  }
  __syncthreads();
  *total = buf[32];
  return (warp > 0 ? buf[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(MAX_THREADS)
staircase_select_kernel(const float* __restrict__ sL_g,
                        const long long* __restrict__ cL_g,
                        const float* __restrict__ sR_g,
                        const long long* __restrict__ cR_g,
                        const float* __restrict__ eps_g,
                        long long* __restrict__ out_cl,
                        long long* __restrict__ out_cr,
                        float* __restrict__ out_s, int* __restrict__ totals,
                        int CL, int CR, int CLp, int CRp, int cap,
                        int sort_l) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sL = reinterpret_cast<float*>(smem);
  unsigned* cL = reinterpret_cast<unsigned*>(sL + CLp);
  float* sR = reinterpret_cast<float*>(cL + CLp);
  unsigned* cR = reinterpret_cast<unsigned*>(sR + CRp);
  int* off = reinterpret_cast<int*>(cR + CRp);
  __shared__ int scan_buf[33];

  const float NEG_INF = __int_as_float(0xff800000);
  const long long n = blockIdx.x;
  const float eps = eps_g[n];
  const int tid = threadIdx.x;
  const int T = blockDim.x;

  // 0. stage both lists; pads sink under before()
  const float* sLn = sL_g + n * CL;
  const long long* cLn = cL_g + n * CL;
  for (int i = tid; i < CLp; i += T) {
    const bool in = i < CL;
    sL[i] = in ? sLn[i] : NEG_INF;
    cL[i] = in ? static_cast<unsigned>(cLn[i]) : 0xFFFFFFFFu;
  }
  const float* sRn = sR_g + n * CR;
  const long long* cRn = cR_g + n * CR;
  for (int j = tid; j < CRp; j += T) {
    const bool in = j < CR;
    sR[j] = in ? sRn[j] : NEG_INF;
    cR[j] = in ? static_cast<unsigned>(cRn[j]) : 0xFFFFFFFFu;
  }
  __syncthreads();

  // 1. sorts
  if (sort_l) bitonic_sort(sL, cL, CLp);
  bitonic_sort(sR, cR, CRp);
  __syncthreads();

  // 2. per-row counts, each thread owning a contiguous run of rows
  const int per = (CL + T - 1) / T;
  const int i0 = min(CL, tid * per);
  const int i1 = min(CL, i0 + per);
  const float r0 = sR[0];
  int local = 0;
  for (int i = i0; i < i1; ++i) {
    const float a = sL[i];
    int cnt = 0;
    if (__fadd_rn(a, r0) > eps) {
      int lo = 1, hi = CR;            // the predicate holds at j = 0
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__fadd_rn(a, sR[mid]) > eps) lo = mid + 1; else hi = mid;
      }
      cnt = lo;
    }
    off[i] = cnt;
    local += cnt;
  }

  // 3. inclusive row offsets
  int total;
  int run = block_exclusive_scan(local, scan_buf, &total);
  for (int i = i0; i < i1; ++i) {
    run += off[i];
    off[i] = run;
  }
  __syncthreads();

  // 4. emission, row-major over the staircase
  const int live = min(total, cap);
  long long* ocl = out_cl + n * cap;
  long long* ocr = out_cr + n * cap;
  float* os = out_s + n * cap;
  for (int t = tid; t < cap; t += T) {
    if (t < live) {
      int lo = 0, hi = CL - 1;        // off[CL - 1] = total > t
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (off[mid] > t) hi = mid; else lo = mid + 1;
      }
      const int j = t - (lo > 0 ? off[lo - 1] : 0);
      os[t] = __fadd_rn(__fadd_rn(sL[lo], sR[j]), 0.0f);
      ocl[t] = static_cast<long long>(cL[lo]);
      ocr[t] = static_cast<long long>(cR[j]);
    } else {
      os[t] = NEG_INF;
      ocl[t] = 0;
      ocr[t] = 0;
    }
  }
  if (tid == 0) totals[n] = total;
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for widths
// outside [1, 8192] or a cap outside [1, 8192]. Allocates nothing and does
// not synchronise.
int ipk_staircase_select(const float* sL, const long long* cL, const float* sR,
                         const long long* cR, const float* eps,
                         long long* out_cl, long long* out_cr, float* out_s,
                         int* totals, long long N, long long CL, long long CR,
                         long long cap, int sort_l, int device,
                         cudaStream_t stream) {
  if (N < 0 || N > INT_MAX || CL < 1 || CL > MAX_WIDTH || CR < 1 ||
      CR > MAX_WIDTH || cap < 1 || cap > MAX_WIDTH)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0) return static_cast<int>(cudaSuccess);
  const int CLp = next_pow2(static_cast<int>(CL));
  const int CRp = next_pow2(static_cast<int>(CR));
  const int widest = CLp > CRp ? CLp : CRp;
  int threads = widest / 2;
  if (threads < 64) threads = 64;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  const size_t smem = static_cast<size_t>(2 * CLp + 2 * CRp + CL) * 4;
  err = cudaFuncSetAttribute(staircase_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  staircase_select_kernel<<<static_cast<unsigned int>(N), threads, smem,
                            stream>>>(
      sL, cL, sR, cR, eps, out_cl, out_cr, out_s, totals,
      static_cast<int>(CL), static_cast<int>(CR), CLp, CRp,
      static_cast<int>(cap), sort_l);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
