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
// What bounds it on this card: instruction issue and the ALU pipe. A
// candidate (w, i, j) needs an add (FADD, FMA pipe) and a max (FMNMX, ALU
// pipe, half the FMA pipe's lanes a clock); no tensor core helps an outer
// *sum*. The halves are read once per tile, so the bytes (inputs once, A
// once) bound it below the operations at every dense shape.
//
// What the design does about it:
// * The hot loop is one __fadd_rn and one fmaxf per candidate, nothing else.
//   A block owns a TI x TJ = 64 x 256 tile of (i, j) for one ghost (a whole
//   row of the main path's key batch) and walks all W windows; each of its
//   256 threads keeps 8 x 8 accumulators in registers and reads, per window,
//   two float4 of L and two of R from shared memory (four shared loads for
//   64 candidates), at a stride that keeps the loads free of bank conflicts.
// * Windows are staged TW = 32 at a time, double-buffered: cp.async copies
//   the next 32 windows (16-byte copies where nl and nr are multiples of 4
//   and the halves are 16-byte aligned, 4-byte otherwise) while the block
//   works on the current ones. Ragged i, j and W edges are filled with -inf
//   in shared memory, which is inert under max and never counts.
// * The explored count is out of the hot loop. A -inf never counts, and a
//   real build's masked halves are mostly -inf (about 18% of each side is
//   live at DNA k=8), so per staged window one warp compacts the live
//   (> -inf) values of the tile's L and R rows into its own shared lists
//   (ballots and popcounts) and counts only live pairs, before the block's
//   max loop over the same staged windows.
//   Short lists are counted pair by pair. Otherwise the shorter list (at
//   most 64 values) is sorted, a bitonic network in registers with warp
//   shuffles padded with -inf, and each value of the other list
//   binary-searches it: for a fixed a, fl(a + b) is non-decreasing in b
//   (round-to-nearest is monotone; the halves hold only finite values and
//   -inf), so the b with fl(a + b) > eps are a suffix of the sorted list.
//   Every test is the exact predicate __fadd_rn(s, o) > eps; addition
//   commutes exactly, so either side may be the sorted one, and ±0.0 ties in
//   the sort do not change the predicate. Per-thread counts are summed in
//   the block and added once to counts[g] with a 64-bit integer atomic:
//   deterministic, and it does not wrap where W * sigma^k > 2^31.
//
// The mask is applied once, after the max: masking is monotone, so it
// commutes with the max over windows. eps arrives as a C float and all
// arithmetic is exactly rounded f32 (no fast-math), so A is bit-equal to the
// plain version.
//
// Positions mode (kPositions, entry ipk_combine_max_positions) replaces the
// jnp function ipk_tpu/core/dense.py:combine_max_with_positions (the aa-pos
// build's accumulator; plain version combine_max_with_positions_ref). It
// keeps the earliest window of each cell's maximum in two levels. Within a
// staged block of 32 windows each cell takes the plain fmaxf (one ALU op a
// candidate, as above). Once per block, a cell replaces acc only where its
// block maximum is strictly greater, so the earliest block of the maximum
// wins; acc starts at eps, since a maximum <= eps leaves the cell dead
// whatever its window. A replaced cell's window is the earliest w of the
// block with fl(L + R) == block maximum, which is the earliest window
// overall. Nearly every cell of a real build is live and is replaced a few
// times, so these rescans are queued per warp (cell, block maximum) and
// drained 32 at a time, one lane a cell, over the block's windows still in
// shared memory: the warp waits for one scan a round, not one a cell. The
// windows live in shared memory ([TI][TJ] int); the tile is 64 x 128 with 4
// x 8 cells a thread. After the loop a cell with acc <= eps is written
// (-inf, 0). One seam stays: ipk_tpu takes the maximum per block of 32
// windows (the last block clamped to end at W) with XLA's max, which keeps
// the bits of the last window tied at the maximum. That differs from the
// first window's bits only where the maximum is a zero reached as both -0.0
// and +0.0, so a live cell whose maximum is zero rescans the rest of its
// block from global memory and takes the last zero's bits. No real build
// reaches it; it costs nothing on the hot loop.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TW = 32;          // windows per staged block
constexpr int POS_BLOCK = 32;   // ipk_tpu's window block (builder block_w)
constexpr int TI = 64;          // rows (i) of a block's tile
constexpr int PAD = 8;          // -inf slots after a warp's short list
constexpr unsigned FULL = 0xffffffffu;
// at most this many predicate evaluations per lane count a window's pairs
// one by one; longer lists take the sort and the search
constexpr int DIRECT_STEPS = 64;

template <bool kPositions>
struct Cfg {
  static constexpr int TJ = kPositions ? 128 : 256; // columns of the tile
  static constexpr int RI = kPositions ? 4 : 8;     // rows a thread
  static constexpr int RJ = 8;                      // columns a thread
  static constexpr int CI = RI / 4;                 // float4 groups of rows
  static constexpr int CJ = RJ / 4;                 // and of columns
  static constexpr int NTY = TI / RI;               // thread rows
  static constexpr int NTX = TJ / RJ;               // thread columns
  static constexpr int THREADS = NTY * NTX;         // 256 both modes
  static constexpr int WARPS = THREADS / 32;
  static constexpr int MIN_BLOCKS = 2;
  // rescans a warp may hold: fewer than 32 left over plus one row of slots
  static constexpr int QUEUE = kPositions ? 32 + 32 * RJ : 0;
  // shared memory, in 4-byte words: two staging buffers, each warp's count
  // lists, then (positions) the windows and the rescan queues
  static constexpr int STAGE = TW * (TI + TJ);
  static constexpr int SCRATCH = TI + PAD + TJ + PAD;
  static constexpr int WIN = kPositions ? TI * TJ : 0;
  static constexpr size_t SMEM =
      (2 * STAGE + WARPS * SCRATCH + WIN + WARPS * 2 * QUEUE) * 4 +
      WARPS * sizeof(unsigned long long);
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage TW windows from w0 of one half (width n, tile columns c0 .. c0 + TC)
// into dst [TW][TC]; out-of-range entries become -inf.
template <int TC, int THREADS>
__device__ __forceinline__ void stage_half(float* dst, const float* src,
                                           int w0, int W, int n, int c0,
                                           bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int e = tid; e < TW * TC / 4; e += THREADS) {
      const int w = e / (TC / 4), c = (e % (TC / 4)) * 4;
      float* d = dst + w * TC + c;
      if (w0 + w < W && c0 + c < n)
        cp_async16(d, src + static_cast<long long>(w0 + w) * n + c0 + c);
      else
        *reinterpret_cast<float4*>(d) =
            make_float4(neg_inf(), neg_inf(), neg_inf(), neg_inf());
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < TW * TC; e += THREADS) {
      const int w = e / TC, c = e % TC;
      float* d = dst + w * TC + c;
      if (w0 + w < W && c0 + c < n)
        cp_async4(d, src + static_cast<long long>(w0 + w) * n + c0 + c);
      else
        *d = neg_inf();
    }
  }
}

// One compare-exchange step of a bitonic network for element e (value v,
// partner value p): keep the min where e is the lower element of an
// ascending pair or the upper of a descending one.
__device__ __forceinline__ float bitonic_step(float v, float p, int e, int j,
                                              int k) {
  const bool lower = (e & j) == 0;
  const bool ascending = (e & k) == 0;
  return lower == ascending ? fminf(v, p) : fmaxf(v, p);
}

// The live values of one side's tile row: N / 32 values a lane, their live
// masks, and their compaction into out (in order); returns how many.
template <int N>
__device__ __forceinline__ int compact_live(const float* row, float* out,
                                            int lane) {
  float v[N / 32];
  unsigned m[N / 32];
#pragma unroll
  for (int k = 0; k < N / 32; ++k) v[k] = row[k * 32 + lane];
#pragma unroll
  for (int k = 0; k < N / 32; ++k)
    m[k] = __ballot_sync(FULL, v[k] > neg_inf());
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int k = 0; k < N / 32; ++k) {
    if (v[k] > neg_inf()) out[n + __popc(m[k] & below)] = v[k];
    n += __popc(m[k]);
  }
  return n;
}

// #{(i, j) : fl(Lrow[i] + Rrow[j]) > eps} over one staged window of a tile
// (Lrow [TI], Rrow [TJ] in shared memory), counted by one warp through its
// scratch lists sl [TI + PAD] and sr [TJ + PAD]; the lane's share of it is
// returned (the lanes' shares sum to the window's count).
template <int TJ>
__device__ unsigned count_window(const float* Lrow, const float* Rrow,
                                 float eps, float* sl, float* sr, int lane) {
  __syncwarp();   // the previous window's reads of sl / sr are done
  const int n_l = compact_live<TI>(Lrow, sl, lane);
  if (n_l == 0) return 0;
  const int n_r = compact_live<TJ>(Rrow, sr, lane);
  if (n_r == 0) return 0;
  float* S = n_l <= n_r ? sl : sr;
  const float* O = n_l <= n_r ? sr : sl;
  const int ns = min(n_l, n_r);   // <= TI = 64
  const int no = max(n_l, n_r);
  unsigned c = 0;
  if (((no + 31) / 32) * ns <= DIRECT_STEPS) {
    // pair by pair, eight values of S a step: S is padded with -inf,
    // whose sums never pass
    if (lane < PAD) S[ns + lane] = neg_inf();
    __syncwarp();
    for (int t = lane; t < no; t += 32) {
      const float o = O[t];
      for (int m = 0; m < ns; m += 8) {   // S is 16-byte aligned
        const float4 a = *reinterpret_cast<const float4*>(S + m);
        const float4 b = *reinterpret_cast<const float4*>(S + m + 4);
        c += (__fadd_rn(a.x, o) > eps ? 1u : 0u) +
             (__fadd_rn(a.y, o) > eps ? 1u : 0u) +
             (__fadd_rn(a.z, o) > eps ? 1u : 0u) +
             (__fadd_rn(a.w, o) > eps ? 1u : 0u) +
             (__fadd_rn(b.x, o) > eps ? 1u : 0u) +
             (__fadd_rn(b.y, o) > eps ? 1u : 0u) +
             (__fadd_rn(b.z, o) > eps ? 1u : 0u) +
             (__fadd_rn(b.w, o) > eps ? 1u : 0u);
      }
    }
    return c;
  }
  // sort S ascending: P = 32 or 64 slots, lane holds elements lane and
  // lane + 32, padded with -inf (which never counts)
  __syncwarp();
  const int P = ns <= 32 ? 32 : 64;
  float v0 = lane < ns ? S[lane] : neg_inf();
  float v1 = lane + 32 < ns ? S[lane + 32] : neg_inf();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {            // k = 64: the partner is the lane's other value
        const float lo = fminf(v0, v1), hi = fmaxf(v0, v1);
        v0 = lo;
        v1 = hi;
      } else {
        const float p0 = __shfl_xor_sync(FULL, v0, j);
        v0 = bitonic_step(v0, p0, lane, j, k);
        if (P == 64) {
          const float p1 = __shfl_xor_sync(FULL, v1, j);
          v1 = bitonic_step(v1, p1, lane + 32, j, k);
        }
      }
    }
  }
  __syncwarp();
  S[lane] = v0;
  if (P == 64) S[lane + 32] = v1;
  __syncwarp();
  const float top = S[P - 1];
  for (int t = lane; t < no; t += 32) {
    const float o = O[t];
    if (!(__fadd_rn(top, o) > eps)) continue;
    // first index whose sum passes: the leading falses, found by halving
    int f = 0;
    for (int step = P >> 1; step > 0; step >>= 1)
      if (!(__fadd_rn(S[f + step - 1], o) > eps)) f += step;
    c += static_cast<unsigned>(P - f);
  }
  return c;
}

// Positions mode: lanes below n take the queued rescans first .. first + n
// (cell li * TJ + lj of the tile, block maximum b) and write the earliest
// window of the staged block whose sum equals b into win.
template <int TJ>
__device__ __forceinline__ void drain_rescans(const int* qc, const float* qv,
                                              int first, int n,
                                              const float* Ls,
                                              const float* Rs, int w0,
                                              int* win, int lane) {
  if (lane < n) {
    const int cell = qc[first + lane];
    const float b = qv[first + lane];
    const float* lp = Ls + cell / TJ;
    const float* rp = Rs + cell % TJ;
    // windows past tw are -inf in the buffer, and b is finite: the scan
    // stops inside the block
    int w = 0;
    for (; w < TW; w += 4) {
      const float t0 = __fadd_rn(lp[w * TI], rp[w * TJ]);
      const float t1 = __fadd_rn(lp[(w + 1) * TI], rp[(w + 1) * TJ]);
      const float t2 = __fadd_rn(lp[(w + 2) * TI], rp[(w + 2) * TJ]);
      const float t3 = __fadd_rn(lp[(w + 3) * TI], rp[(w + 3) * TJ]);
      if (t0 == b) break;
      if (t1 == b) { w += 1; break; }
      if (t2 == b) { w += 2; break; }
      if (t3 == b) { w += 3; break; }
    }
    win[cell] = w0 + w;
  }
}

template <bool kPositions, bool kCount>
__global__ void __launch_bounds__(Cfg<kPositions>::THREADS,
                                  Cfg<kPositions>::MIN_BLOCKS)
combine_max_kernel(const float* __restrict__ L, const float* __restrict__ R,
                   float eps, float* __restrict__ A, int* __restrict__ pos,
                   unsigned long long* __restrict__ counts, int W, int nl,
                   int nr, int tiles_i, int tiles_j, bool vec) {
  using C = Cfg<kPositions>;
  constexpr int TJ = C::TJ, RI = C::RI, RJ = C::RJ;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  float* const bufs = smem;                                   // [2][STAGE]
  float* const sl = smem + 2 * C::STAGE + warp * C::SCRATCH;  // [TI + PAD]
  float* const sr = sl + TI + PAD;                            // [TJ + PAD]
  int* const win = reinterpret_cast<int*>(
      smem + 2 * C::STAGE + C::WARPS * C::SCRATCH);           // [TI * TJ]
  int* const qc = win + C::WIN + warp * 2 * C::QUEUE;         // [QUEUE]
  float* const qv = reinterpret_cast<float*>(qc + C::QUEUE);  // [QUEUE]
  unsigned long long* const warp_sums = reinterpret_cast<unsigned long long*>(
      win + C::WIN + C::WARPS * 2 * C::QUEUE);

  const float NEG_INF = neg_inf();
  long long b = blockIdx.x;
  const int tj = static_cast<int>(b % tiles_j);
  b /= tiles_j;
  const int ti = static_cast<int>(b % tiles_i);
  const long long g = b / tiles_i;
  const int i0 = ti * TI;
  const int j0 = tj * TJ;
  const int ty = tid / C::NTX;
  const int tx = tid % C::NTX;

  const float* Lg = L + g * static_cast<long long>(W) * nl;
  const float* Rg = R + g * static_cast<long long>(W) * nr;

  // the thread's rows are ty * 4 + r in each of CI groups of TI / CI rows,
  // its columns tx * 4 + c in each of CJ groups of TJ / CJ columns
  float acc[RI][RJ];
  float bmax[kPositions ? RI : 1][kPositions ? RJ : 1];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      // in positions mode acc starts at eps: a block maximum <= eps can
      // never be a live cell's maximum, so it neither replaces nor rescans
      acc[r][c] = kPositions ? eps : NEG_INF;
      if constexpr (kPositions) bmax[r][c] = NEG_INF;
    }
  unsigned long long cnt = 0;

  const int nstages = (W + TW - 1) / TW;
  if (nstages > 0) {
    stage_half<TI, C::THREADS>(bufs, Lg, 0, W, nl, i0, vec, tid);
    stage_half<TJ, C::THREADS>(bufs + TW * TI, Rg, 0, W, nr, j0, vec, tid);
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait_all();
    __syncthreads();   // stage s landed; every thread is done with s - 1
    if (s + 1 < nstages) {
      float* nb = bufs + ((s + 1) & 1) * C::STAGE;
      stage_half<TI, C::THREADS>(nb, Lg, (s + 1) * TW, W, nl, i0, vec, tid);
      stage_half<TJ, C::THREADS>(nb + TW * TI, Rg, (s + 1) * TW, W, nr, j0,
                                 vec, tid);
      cp_async_commit();
    }
    const float* Ls = bufs + (s & 1) * C::STAGE;   // [TW][TI]
    const float* Rs = Ls + TW * TI;                // [TW][TJ]
    const int w0 = s * TW;
    const int tw = min(TW, W - w0);

    if constexpr (kCount) {
      unsigned c = 0;
      for (int w = warp; w < tw; w += C::WARPS)
        c += count_window<TJ>(Ls + w * TI, Rs + w * TJ, eps, sl, sr, lane);
      cnt += c;
    }

#pragma unroll 2
    for (int w = 0; w < tw; ++w) {
      float lv[RI], rv[RJ];
#pragma unroll
      for (int q = 0; q < C::CI; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            Ls + w * TI + q * (TI / C::CI) + ty * 4);
        lv[4 * q] = v.x; lv[4 * q + 1] = v.y;
        lv[4 * q + 2] = v.z; lv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < C::CJ; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            Rs + w * TJ + q * (TJ / C::CJ) + tx * 4);
        rv[4 * q] = v.x; rv[4 * q + 1] = v.y;
        rv[4 * q + 2] = v.z; rv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          const float t = __fadd_rn(lv[r], rv[c]);
          if constexpr (kPositions)
            bmax[r][c] = fmaxf(bmax[r][c], t);
          else
            acc[r][c] = fmaxf(acc[r][c], t);
        }
    }

    if constexpr (kPositions) {
      // once per block: a strictly greater block maximum replaces, and the
      // cell is queued for the rescan of this block
      const unsigned below = (1u << lane) - 1u;
      int qn = 0;   // queued, warp-uniform
#pragma unroll
      for (int r = 0; r < RI; ++r) {
#pragma unroll
        for (int c = 0; c < RJ; ++c) {
          const bool need = bmax[r][c] > acc[r][c];
          const unsigned m = __ballot_sync(FULL, need);
          if (need) {
            const int li = (r / 4) * (TI / C::CI) + ty * 4 + (r % 4);
            const int lj = (c / 4) * (TJ / C::CJ) + tx * 4 + (c % 4);
            const int k = qn + __popc(m & below);
            qc[k] = li * TJ + lj;
            qv[k] = bmax[r][c];
            acc[r][c] = bmax[r][c];
          }
          qn += __popc(m);
          bmax[r][c] = NEG_INF;
        }
        if (qn >= 32) {
          __syncwarp();
          int done = 0;
          for (; qn - done >= 32; done += 32)
            drain_rescans<TJ>(qc, qv, done, 32, Ls, Rs, w0, win, lane);
          // move the remainder (< 32) to the front of the queue
          __syncwarp();
          int cell = 0;
          float val = 0.0f;
          if (lane < qn - done) {
            cell = qc[done + lane];
            val = qv[done + lane];
          }
          __syncwarp();
          if (lane < qn - done) {
            qc[lane] = cell;
            qv[lane] = val;
          }
          qn -= done;
        }
      }
      __syncwarp();
      drain_rescans<TJ>(qc, qv, 0, qn, Ls, Rs, w0, win, lane);
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int li = (r / 4) * (TI / C::CI) + ty * 4 + (r % 4);
    const int gi = i0 + li;
    if (gi >= nl) continue;
    const long long cell0 = (g * nl + gi) * static_cast<long long>(nr);
#pragma unroll
    for (int c = 0; c < RJ; ++c) {
      const int lj = (c / 4) * (TJ / C::CJ) + tx * 4 + (c % 4);
      const int gj = j0 + lj;
      if (gj >= nr) continue;
      const bool live = acc[r][c] > eps;
      float a = live ? acc[r][c] : NEG_INF;
      if constexpr (kPositions) {
        const int p = live ? win[li * TJ + lj] : 0;
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

  if constexpr (kCount) {
    unsigned long long sum = cnt;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(FULL, sum, off);
    if (lane == 0) warp_sums[warp] = sum;
    __syncthreads();
    if (tid == 0) {
      unsigned long long total = 0;
#pragma unroll
      for (int k = 0; k < C::WARPS; ++k) total += warp_sums[k];
      if (total) atomicAdd(&counts[g], total);
    }
  }
}

template <bool kPositions, bool kCount>
int launch(const float* L, const float* R, float eps, float* A, int* pos,
           unsigned long long* counts, long long G, long long W, long long nl,
           long long nr, int device, cudaStream_t stream) {
  using C = Cfg<kPositions>;
  if (G < 0 || W < 0 || nl < 0 || nr < 0 || W > INT_MAX || nl > INT_MAX ||
      nr > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles_i = (nl + TI - 1) / TI;
  const long long tiles_j = (nr + C::TJ - 1) / C::TJ;
  const long long blocks = G * tiles_i * tiles_j;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need every row start and tile edge on a 16-byte boundary
  const bool vec = nl % 4 == 0 && nr % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(L) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(R) % 16 == 0;
  err = cudaFuncSetAttribute(combine_max_kernel<kPositions, kCount>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_max_kernel<kPositions, kCount>
      <<<static_cast<unsigned int>(blocks), C::THREADS, C::SMEM, stream>>>(
          L, R, eps, A, pos, counts, static_cast<int>(W),
          static_cast<int>(nl), static_cast<int>(nr),
          static_cast<int>(tiles_i), static_cast<int>(tiles_j), vec);
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
  return launch<false, true>(L, R, eps, A, nullptr, counts, G, W, nl, nr,
                             device, stream);
}

// Positions mode: pos [G, nl, nr] int32 gets the earliest window of each
// cell's maximum (0 where the cell is dead).
int ipk_combine_max_positions(const float* L, const float* R, float eps,
                              float* A, int* pos, unsigned long long* counts,
                              long long G, long long W, long long nl,
                              long long nr, int device, cudaStream_t stream) {
  return launch<true, true>(L, R, eps, A, pos, counts, G, W, nl, nr, device,
                            stream);
}

// The kernel of ipk_combine_max without the explored count (counts is left
// as it is): only for measuring the count's share of the kernel's time.
int ipk_combine_max_uncounted(const float* L, const float* R, float eps,
                              float* A, unsigned long long* counts,
                              long long G, long long W, long long nl,
                              long long nr, int device, cudaStream_t stream) {
  return launch<false, false>(L, R, eps, A, nullptr, counts, G, W, nl, nr,
                              device, stream);
}

const char* ipk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
