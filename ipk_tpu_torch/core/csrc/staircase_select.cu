// staircase_select: the capacity-bounded threshold combine of two survivor
// lists, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ipk_tpu/core/pallas_kernels.py:staircase_select_wide (kernel body
// _select_wide_kernel, helpers _bitonic_sublanes and _cumsum_sublanes_mxu),
// and, for the shapes above its VMEM budget, ipk_tpu's XLA route
// (sparse._sort_desc + sparse._staircase_xla). Plain version:
// staircase_select_ref in ipk_tpu_torch/core/sparse.py; wrapper:
// ipk_tpu_torch/core/kernels.py.
//
// For every window n (one of N = G * W):
//   1. sort R's (score, code) pairs, and L's when sort_l, by score
//      descending, then code ascending as unsigned 32-bit; scores compare
//      with IEEE > and ==, so -0.0 and +0.0 tie and the code decides;
//   2. cnt[i] = #{j : fl(sL[i] + sR[j]) > eps[n]}. fl(a + b) is monotone in
//      b, so the survivors of row i are a prefix of sorted R and cnt[i] is
//      found by a binary search;
//   3. off = inclusive prefix sum of cnt (int32: the wrapper holds
//      CL * CR < 2^31);
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
// What bounds it on this card: bytes. Per window it must read the CL + CR
// scores (4 bytes each), the code of each live (> -inf) entry (8 bytes; a
// dead entry's code is never needed) and eps, and write cap * 20 + 4 bytes;
// the work between is small. On the DNA k=12 build's three launches (64 x
// 64 lists, caps 512 and 384; 512 x 384, cap 1280) the lists hold a few
// dozen live entries each, so that is at most 11,784 / 9,224 / 36,360 bytes
// a window and less on the build's data. Most written bytes are the dead
// tail of each window's slots (about three quarters at cap 1280).
//
// What the design does about it: the work follows the live sizes, not the
// padded widths.
//   * The warp pass: one warp per window, eight windows to a block, with
//     __syncwarp only. The warp reads each list's scores with 16-byte loads,
//     keeps the live entries in input order (a popcount and a shuffle scan
//     across the warp) and stages them, codes as u32, in its own slice of
//     shared memory: L's order is the row order when sort_l is off, and
//     dropping a dead row drops a row of count 0, so the slots do not move.
//     A -inf never counts and never emits (eps is finite), and sorted R puts
//     its -inf entries last, so dropping them changes no index either.
//   * Each live list is sorted in registers by a warp bitonic network over
//     32 * E entries, E = 1 (shuffles only), 2, 4 or 8 a lane, the smallest
//     that holds it; pads (-inf, 0xFFFFFFFF) sink.
//   * Counts over live rows only: a binary search per row, bounded by the
//     count of the lane's previous row when L is sorted (counts then do not
//     rise), offsets by a warp scan.
//   * Live slots are written by lanes on consecutive slots, each finding its
//     row by a binary search that starts at its previous slot's row; the
//     dead tail is written with 16-byte stores (float4 of -inf, longlong2
//     of zeros), 512 contiguous bytes a warp store, scalar at the unaligned
//     ends.
// Where a window has more than WARP_LIST live entries in a list (rare on the
// build's launches, the rule for dense lists under a large --max-candidates),
// its warp appends it to a deferred queue in the scratch, and a second
// launch, the block pass, gives each deferred window a block (256 to 1024
// threads, a quarter of the padded width), the grid as wide as the SMs
// hold, striding over the queue. Only calls whose lists may hold more than
// WARP_LIST entries make it. A block-pass block stages in dynamic shared
// memory when both lists, padded to powers of two, and the offsets fit
// there (any CL, CR <= 8192), otherwise in the scratch (the wide path: one
// staging a block, the grid cut so the staging stays within 256 MB). The
// staging is read by warp segments: each warp counts its segment's live
// entries, and after one block scan writes them in order. It sorts by a
// block bitonic network
// over next_pow2(live) entries of both lists at once (one barrier a stage),
// counts by per-thread row runs and a block scan, and emits as above,
// strided by the block.
// eps arrives per window as f32 and every sum is __fadd_rn (no fast-math),
// so values are bit-equal to the plain version.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int WARPS = 8;                    // windows a warp-pass block
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_THREADS = 1024;         // most threads a block-pass block
constexpr int WARP_LIST = 256;              // live entries a warp sorts
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned PAD_CODE = 0xffffffffu;
constexpr long long SCRATCH_BUDGET = 256LL << 20;

struct Args {
  const float* __restrict__ sL;
  const long long* __restrict__ cL;
  const float* __restrict__ sR;
  const long long* __restrict__ cR;
  const float* __restrict__ eps;
  long long* __restrict__ out_cl;
  long long* __restrict__ out_cr;
  float* __restrict__ out_s;
  int* __restrict__ totals;
  int* n_deferred;          // the deferred queue's count (in the scratch)
  long long* deferred;      // the deferred queue: window indices
  unsigned char* scratch;   // the wide path's staging, or null
  long long N;
  int CL, CR, cap, sort_l;
  int LW, RW;               // a warp's list capacities (live entries)
  int PL, PR;               // the block path's staged widths (powers of 2)
  long long stage_bytes;    // the block path's staging
  int stage_in_smem;
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ bool before(float sa, unsigned ca, float sb,
                                       unsigned cb) {
  return sa > sb || (sa == sb && ca < cb);
}

// Elements from p to the next 16-byte boundary (p is element-aligned).
template <typename T>
__device__ __forceinline__ long long to_16(const T* p, long long count) {
  const long long h =
      static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) &
                             15) / static_cast<long long>(sizeof(T));
  return h < count ? h : count;
}

// ---------------------------------------------------------------------------
// staging: live entries of one list, in input order

// Appends each lane's up-to-4 candidates (flags in `m`, consecutive indices
// from i0) to (ds, dc) at warp-prefix offsets. Returns the warp's new count.
__device__ __forceinline__ int warp_append(const float v[4], unsigned m,
                                           long long i0,
                                           const long long* __restrict__ c,
                                           float* ds, unsigned* dc, int n,
                                           int cap, int lane) {
  const int cnt = __popc(m);
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  int pos = n + x - cnt;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if ((m >> e) & 1) {
      if (pos < cap) {
        ds[pos] = v[e];
        dc[pos] = static_cast<unsigned>(c[i0 + e]);
      }
      ++pos;
    }
  }
  return n + __shfl_sync(FULL, x, 31);
}

// Stages the live entries of s[0, C) / c[0, C) into (ds, dc) in order.
// Returns their number, or -1 as soon as more than cap are live.
__device__ __forceinline__ int warp_stage(const float* __restrict__ s,
                          const long long* __restrict__ c, long long C,
                          float* ds, unsigned* dc, int cap, int lane) {
  const float NEG_INF = neg_inf();
  const long long head = to_16(s, C);
  const long long nvec = (C - head) >> 2;
  const long long tail0 = head + 4 * nvec;
  int n = 0;
  float v[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
  // in order: the head (at most 3 scalars, up to a 16-byte boundary), the
  // body in float4s, the tail (at most 3 scalars)
  v[0] = lane < head ? s[lane] : NEG_INF;
  n = warp_append(v, v[0] > NEG_INF ? 1u : 0u, lane, c, ds, dc, n, cap,
                  lane);
  const float4* q = reinterpret_cast<const float4*>(s + head);
  for (long long b = 0; b < nvec; b += 32) {
    const long long k = b + lane;
    unsigned m = 0;
    if (k < nvec) {
      const float4 x = q[k];
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      m = (x.x > NEG_INF ? 1u : 0u) | (x.y > NEG_INF ? 2u : 0u) |
          (x.z > NEG_INF ? 4u : 0u) | (x.w > NEG_INF ? 8u : 0u);
    }
    n = warp_append(v, m, head + 4 * k, c, ds, dc, n, cap, lane);
    if (n > cap) return -1;
  }
  const long long i = tail0 + lane;
  v[0] = i < C ? s[i] : NEG_INF;
  n = warp_append(v, v[0] > NEG_INF ? 1u : 0u, i, c, ds, dc, n, cap, lane);
  return n > cap ? -1 : n;
}

// The block pass's staging: each warp owns a contiguous segment of the list,
// counts its live entries (four loads a lane in flight), and after one block
// scan writes them at its offset, in order. Two barriers a list. `red` holds
// a count a warp.
__device__ __forceinline__ int block_stage(const float* __restrict__ s,
                           const long long* __restrict__ c, long long C,
                           float* ds, unsigned* dc, int* red) {
  const float NEG_INF = neg_inf();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const long long seg = ((C + nw - 1) / nw + 127) & ~127LL;
  const long long b0 = warp * seg < C ? warp * seg : C;
  const long long b1 = b0 + seg < C ? b0 + seg : C;
  int cnt = 0;
  for (long long b = b0; b < b1; b += 128) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long i = b + e * 32 + lane;
      v[e] = i < b1 ? s[i] : NEG_INF;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) cnt += v[e] > NEG_INF ? 1 : 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(FULL, cnt, o);
  if (lane == 0) red[warp] = cnt;
  __syncthreads();
  int pos = 0, n = 0;
  for (int w = 0; w < nw; ++w) {
    if (w < warp) pos += red[w];
    n += red[w];
  }
  const unsigned below = (1u << lane) - 1;
  for (long long b = b0; b < b1; b += 128) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long i = b + e * 32 + lane;
      v[e] = i < b1 ? s[i] : NEG_INF;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool live = v[e] > NEG_INF;
      const unsigned bal = __ballot_sync(FULL, live);
      if (live) {
        const int at = pos + __popc(bal & below);
        ds[at] = v[e];
        dc[at] = static_cast<unsigned>(c[b + e * 32 + lane]);
      }
      pos += __popc(bal);
    }
  }
  __syncthreads();
  return n;
}

// ---------------------------------------------------------------------------
// sorts

// Sorts n <= 32 * E staged pairs by before(): the warp holds entry e * 32 +
// lane in register e of lane `lane`; stages with j < 32 exchange across
// lanes by shuffles, the others inside a lane. A pair swaps only when
// strictly out of order, so no entry is lost to a tie.
template <int E>
__device__ __forceinline__
void warp_sort_regs(float* s, unsigned* c, int n, int lane) {
  constexpr int LOG = 5 + (E == 1 ? 0 : E == 2 ? 1 : E == 4 ? 2 : 3);
  float v[E];
  unsigned k[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    v[e] = i < n ? s[i] : neg_inf();
    k[e] = i < n ? c[i] : PAD_CODE;
  }
#pragma unroll
  for (int lk = 1; lk <= LOG; ++lk) {
    const int kk = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (lj >= 5) {
        const int je = j >> 5;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & je) == 0) {
            const int f = e | je;
            const bool up = (((e << 5) | lane) & kk) == 0;
            const bool sw = up ? before(v[f], k[f], v[e], k[e])
                               : before(v[e], k[e], v[f], k[f]);
            if (sw) {
              const float tv = v[e];
              const unsigned tk = k[e];
              v[e] = v[f];
              k[e] = k[f];
              v[f] = tv;
              k[f] = tk;
            }
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float ov = __shfl_xor_sync(FULL, v[e], j);
          const unsigned ok = __shfl_xor_sync(FULL, k[e], j);
          const bool up = (((e << 5) | lane) & kk) == 0;
          const bool lower = (lane & j) == 0;
          // the lower index keeps the first of the pair when up
          const bool keep = (lower == up) ? !before(ov, ok, v[e], k[e])
                                          : !before(v[e], k[e], ov, ok);
          if (!keep) {
            v[e] = ov;
            k[e] = ok;
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = e * 32 + lane;
    if (i < n) {
      s[i] = v[e];
      c[i] = k[e];
    }
  }
}

__device__ __forceinline__
void warp_sort(float* s, unsigned* c, int n, int lane) {
  if (n <= 1) return;
  if (n <= 32)
    warp_sort_regs<1>(s, c, n, lane);
  else if (n <= 64)
    warp_sort_regs<2>(s, c, n, lane);
  else if (n <= 128)
    warp_sort_regs<4>(s, c, n, lane);
  else
    warp_sort_regs<8>(s, c, n, lane);
}

// Sorts two staged lists of na and nb (each a power of two, or 0) pairs at
// once, the block's threads over the union of both lists' pairs, one barrier
// a stage. Ends with a barrier.
__device__ __forceinline__
void block_sort2(float* sa, unsigned* ca, int na, float* sb, unsigned* cb,
                 int nb) {
  const int top = na > nb ? na : nb;
  for (int kk = 2; kk <= top; kk <<= 1) {
    const int ha = kk <= na ? na >> 1 : 0;
    const int hb = kk <= nb ? nb >> 1 : 0;
    for (int j = kk >> 1; j > 0; j >>= 1) {
      for (int q = threadIdx.x; q < ha + hb; q += blockDim.x) {
        float* s = q < ha ? sa : sb;
        unsigned* c = q < ha ? ca : cb;
        const int p = q < ha ? q : q - ha;
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));   // bit j clear
        const int l = i + j;
        const float si = s[i], sl = s[l];
        const unsigned ci = c[i], cl = c[l];
        const bool up = (i & kk) == 0;
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

// ---------------------------------------------------------------------------
// counts, offsets and emission

// Survivors of row score a: the j in [0, hi) of sorted R with
// fl(a + sR[j]) > eps, a prefix.
__device__ __forceinline__ int row_count(float a, const float* sR, int hi,
                                         float eps) {
  if (hi == 0 || !(__fadd_rn(a, sR[0]) > eps)) return 0;
  int lo = 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__fadd_rn(a, sR[mid]) > eps) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Inclusive row offsets into off[0, nL), rows strided over the lanes;
// returns the total.
__device__ __forceinline__
int warp_offsets(const float* sL, int nL, const float* sR, int nR, float eps,
                 bool sorted_l, int* off, int lane) {
  int carry = 0, prev = nR;
  for (int b = 0; b < nL; b += 32) {
    const int i = b + lane;
    int cnt = 0;
    if (i < nL) {
      cnt = row_count(sL[i], sR, sorted_l ? prev : nR, eps);
      prev = cnt;
    }
    int x = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (i < nL) off[i] = carry + x;
    carry += __shfl_sync(FULL, x, 31);
  }
  return carry;
}

// Exclusive prefix sum of v over the block; *total receives the block's
// sum. Contains barriers.
__device__ __forceinline__
int block_exclusive_scan(int v, int* buf /* [33] */, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int w = lane < nw ? buf[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) buf[lane] = w;
    if (lane == 31) buf[32] = w;
  }
  __syncthreads();
  *total = buf[32];
  return (warp > 0 ? buf[warp - 1] : 0) + x - v;
}

// Inclusive row offsets, each thread owning a contiguous run of rows;
// returns the total. Contains barriers.
__device__ __forceinline__
int block_offsets(const float* sL, int nL, const float* sR, int nR, float eps,
                  bool sorted_l, int* off, int* buf) {
  const int T = blockDim.x;
  const int per = (nL + T - 1) / T;
  const int i0 = min(nL, static_cast<int>(threadIdx.x) * per);
  const int i1 = min(nL, i0 + per);
  int local = 0, prev = nR;
  for (int i = i0; i < i1; ++i) {
    const int cnt = row_count(sL[i], sR, sorted_l ? prev : nR, eps);
    prev = cnt;
    off[i] = cnt;
    local += cnt;
  }
  int total;
  int run = block_exclusive_scan(local, buf, &total);
  for (int i = i0; i < i1; ++i) {
    run += off[i];
    off[i] = run;
  }
  __syncthreads();
  return total;
}

// Live slots [0, live) of window n, slots rank, rank + size, ...; each
// finds its row from the previous one's.
__device__ __forceinline__ void emit_live(const Args& p, long long n,
                                          const float* sL,
                                          const unsigned* cL, int nL,
                                          const float* sR,
                                          const unsigned* cR, const int* off,
                                          int live, int rank, int size) {
  long long* ocl = p.out_cl + n * p.cap;
  long long* ocr = p.out_cr + n * p.cap;
  float* os = p.out_s + n * p.cap;
  int row = 0;
  for (int t = rank; t < live; t += size) {
    int hi = nL - 1;                       // off[nL - 1] = total > t
    while (row < hi) {
      const int mid = (row + hi) >> 1;
      if (off[mid] > t) hi = mid; else row = mid + 1;
    }
    const int j = t - (row > 0 ? off[row - 1] : 0);
    os[t] = __fadd_rn(__fadd_rn(sL[row], sR[j]), 0.0f);
    ocl[t] = static_cast<long long>(cL[row]);
    ocr[t] = static_cast<long long>(cR[j]);
  }
}

template <typename T, typename V>
__device__ __forceinline__ void fill(T* p, long long count, T x, V xv,
                                     int rank, int size) {
  constexpr int PER = sizeof(V) / sizeof(T);
  const long long head = to_16(p, count);
  const long long nvec = (count - head) / PER;
  const long long tail0 = head + nvec * PER;
  if (rank < head) p[rank] = x;
  if (rank < count - tail0) p[tail0 + rank] = x;
  V* q = reinterpret_cast<V*>(p + head);
  for (long long k = rank; k < nvec; k += size) q[k] = xv;
}

// Dead slots [live, cap) of window n: (0, 0, -inf), 16-byte stores.
__device__ __forceinline__ void emit_dead(const Args& p, long long n,
                                          int live, int rank, int size) {
  const long long at = n * p.cap + live;
  const long long count = p.cap - live;
  const float NEG_INF = neg_inf();
  fill(p.out_s + at, count, NEG_INF,
       make_float4(NEG_INF, NEG_INF, NEG_INF, NEG_INF), rank, size);
  fill(p.out_cl + at, count, 0LL, make_longlong2(0, 0), rank, size);
  fill(p.out_cr + at, count, 0LL, make_longlong2(0, 0), rank, size);
}

// ---------------------------------------------------------------------------
// one window

// STOP: 0 runs the whole window; 1 stops after staging and sorting, 2 after
// counts and offsets (measuring entries only: totals then hold a checksum).

// One window by one warp in its slice of shared memory. Returns false,
// having written nothing, when a list has more than the slice holds.
template <int STOP>
__device__ __forceinline__
bool warp_window(const Args& p, long long n, float* sL, unsigned* cL,
                 float* sR, unsigned* cR, int* off, int lane) {
  const int nL = warp_stage(p.sL + n * p.CL, p.cL + n * p.CL, p.CL, sL, cL,
                            p.LW, lane);
  if (nL < 0) return false;
  const int nR = warp_stage(p.sR + n * p.CR, p.cR + n * p.CR, p.CR, sR, cR,
                            p.RW, lane);
  if (nR < 0) return false;
  __syncwarp();
  if (p.sort_l) warp_sort(sL, cL, nL, lane);
  warp_sort(sR, cR, nR, lane);
  __syncwarp();
  if (STOP == 1) {
    if (lane == 0) p.totals[n] = nL + nR;
    return true;
  }
  const int total = nR == 0 ? 0 : warp_offsets(sL, nL, sR, nR, p.eps[n],
                                                p.sort_l, off, lane);
  __syncwarp();
  if (lane == 0) p.totals[n] = total;
  if (STOP == 2) return true;
  const int live = min(total, p.cap);
  emit_live(p, n, sL, cL, nL, sR, cR, off, live, lane, 32);
  emit_dead(p, n, live, lane, 32);
  return true;
}

// One window by the whole block, staged in `stage` (shared or global).
template <int STOP>
__device__ __forceinline__
void block_window(const Args& p, long long n, unsigned char* stage, int* buf) {
  float* sL = reinterpret_cast<float*>(stage);
  unsigned* cL = reinterpret_cast<unsigned*>(sL + p.PL);
  float* sR = reinterpret_cast<float*>(cL + p.PL);
  unsigned* cR = reinterpret_cast<unsigned*>(sR + p.PR);
  int* off = reinterpret_cast<int*>(cR + p.PR);
  const int nL = block_stage(p.sL + n * p.CL, p.cL + n * p.CL, p.CL, sL, cL,
                             buf);
  const int nR = block_stage(p.sR + n * p.CR, p.cR + n * p.CR, p.CR, sR, cR,
                             buf);
  int pL = 1, pR = 1;
  while (pL < nL) pL <<= 1;
  while (pR < nR) pR <<= 1;
  if (!p.sort_l) pL = 0;
  const float NEG_INF = neg_inf();
  for (int i = nL + threadIdx.x; i < pL; i += blockDim.x) {
    sL[i] = NEG_INF;
    cL[i] = PAD_CODE;
  }
  for (int j = nR + threadIdx.x; j < pR; j += blockDim.x) {
    sR[j] = NEG_INF;
    cR[j] = PAD_CODE;
  }
  __syncthreads();
  block_sort2(sL, cL, pL, sR, cR, pR);
  if (STOP == 1) {
    if (threadIdx.x == 0) p.totals[n] = nL + nR;
    return;
  }
  const int total = block_offsets(sL, nL, sR, nR, p.eps[n], p.sort_l, off,
                                  buf);
  if (threadIdx.x == 0) p.totals[n] = total;
  if (STOP == 2) return;
  const int live = min(total, p.cap);
  emit_live(p, n, sL, cL, nL, sR, cR, off, live, threadIdx.x, blockDim.x);
  emit_dead(p, n, live, threadIdx.x, blockDim.x);
}

// The warp pass: window n = block * WARPS + warp by its warp. A window the
// warp's slice cannot hold is appended to the deferred queue instead.
template <int STOP>
__global__ void __launch_bounds__(THREADS)
staircase_warp_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (n >= p.N) return;
  // this warp's slice: sL[LW], cL[LW], sR[RW], cR[RW], off[LW]
  float* sL = reinterpret_cast<float*>(smem) +
              static_cast<size_t>(warp) * (3 * p.LW + 2 * p.RW);
  unsigned* cL = reinterpret_cast<unsigned*>(sL + p.LW);
  float* sR = reinterpret_cast<float*>(cL + p.LW);
  unsigned* cR = reinterpret_cast<unsigned*>(sR + p.RW);
  int* off = reinterpret_cast<int*>(cR + p.RW);
  if (!warp_window<STOP>(p, n, sL, cL, sR, cR, off, lane) && lane == 0)
    p.deferred[atomicAdd(p.n_deferred, 1)] = n;
}

// The block pass: the deferred windows, one a block at a time, the blocks
// striding over the queue. SMEM (staging in shared memory) is a template
// flag so that the compiler addresses the staging as shared memory.
template <int STOP, bool SMEM>
__global__ void __launch_bounds__(BLOCK_THREADS)
staircase_block_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int buf[33];
  unsigned char* stage =
      SMEM ? smem : p.scratch + blockIdx.x * p.stage_bytes;
  const int nd = *p.n_deferred;
  for (int d = blockIdx.x; d < nd; d += gridDim.x) {
    block_window<STOP>(p, p.deferred[d], stage, buf);
    __syncthreads();
  }
}

int next_pow2(long long x) {
  long long q = 1;
  while (q < x) q <<= 1;
  return static_cast<int>(q);
}

long long round_256(long long x) { return (x + 255) & ~255LL; }

// The launch's shapes: slices, staging, grids and scratch. The scratch, when
// a window may be deferred, holds the queue's count (256 bytes), the queue
// (N window indices) and, on the wide path, one staging a block-pass block.
struct Plan {
  Args a;
  bool may_defer;
  size_t smem_warp, smem_block;
  long long grid_warp, grid_block;
  int threads_block;
  long long scratch;
};

cudaError_t plan(long long N, long long CL, long long CR, int device,
                 Plan* out) {
  int optin = 0, sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long max_smem = optin - 1024;   // room for the static arrays
  Args& a = out->a;
  a = Args{};
  a.N = N;
  a.CL = static_cast<int>(CL);
  a.CR = static_cast<int>(CR);
  a.LW = static_cast<int>(CL < WARP_LIST ? CL : WARP_LIST);
  a.RW = static_cast<int>(CR < WARP_LIST ? CR : WARP_LIST);
  out->smem_warp = static_cast<size_t>(4LL * WARPS * (3 * a.LW + 2 * a.RW));
  out->grid_warp = (N + WARPS - 1) / WARPS;
  out->may_defer = CL > a.LW || CR > a.RW;
  out->smem_block = 0;
  out->grid_block = 0;
  out->scratch = 0;
  if (!out->may_defer) return cudaSuccess;
  a.PL = next_pow2(CL);
  a.PR = next_pow2(CR);
  const long long stage = round_256(4LL * (2LL * a.PL + 2LL * a.PR + CL));
  a.stage_bytes = stage;
  a.stage_in_smem = stage <= max_smem;
  out->smem_block = a.stage_in_smem ? static_cast<size_t>(stage) : 0;
  // threads a block: a quarter of the wider padded list, in [256, 1024]
  // (wide lists, whose staging leaves room for one or two blocks an SM, run
  // fastest at 1024; lists of 1024 at 256, where more windows share an SM);
  // as many blocks as the SMs hold, fewer on the wide path if their staging
  // would pass the budget
  const int widest = a.PL > a.PR ? a.PL : a.PR;
  out->threads_block = widest / 4 < 256 ? 256
                       : widest / 4 > BLOCK_THREADS ? BLOCK_THREADS
                                                    : widest / 4;
  long long grid = static_cast<long long>(sms) * (2048 / out->threads_block);
  if (!a.stage_in_smem) {
    const long long fit = SCRATCH_BUDGET / stage;
    grid = fit < grid ? (fit < 1 ? 1 : fit) : grid;
  }
  out->grid_block = N < grid ? N : grid;
  out->scratch = 256 + round_256(8 * N) +
                 (a.stage_in_smem ? 0 : out->grid_block * stage);
  return cudaSuccess;
}

template <int STOP, bool SMEM>
int launch_block(const Plan& pl, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      staircase_block_kernel<STOP, SMEM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pl.smem_block));
  if (err != cudaSuccess) return static_cast<int>(err);
  staircase_block_kernel<STOP, SMEM>
      <<<static_cast<unsigned int>(pl.grid_block), pl.threads_block,
         pl.smem_block, stream>>>(pl.a);
  return static_cast<int>(cudaGetLastError());
}

template <int STOP>
int launch(const float* sL, const long long* cL, const float* sR,
           const long long* cR, const float* eps, long long* out_cl,
           long long* out_cr, float* out_s, int* totals, void* scratch,
           long long N, long long CL, long long CR, long long cap, int sort_l,
           int device, cudaStream_t stream) {
  if (N < 0 || CL < 1 || CR < 1 || cap < 1 || cap > INT_MAX ||
      CL * CR >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0) return static_cast<int>(cudaSuccess);
  Plan pl;
  err = plan(N, CL, CR, device, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pl.scratch > 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args& a = pl.a;
  a.sL = sL;
  a.cL = cL;
  a.sR = sR;
  a.cR = cR;
  a.eps = eps;
  a.out_cl = out_cl;
  a.out_cr = out_cr;
  a.out_s = out_s;
  a.totals = totals;
  a.cap = static_cast<int>(cap);
  a.sort_l = sort_l;
  if (pl.may_defer) {
    unsigned char* base = static_cast<unsigned char*>(scratch);
    a.n_deferred = reinterpret_cast<int*>(base);
    a.deferred = reinterpret_cast<long long*>(base + 256);
    a.scratch = base + 256 + round_256(8 * N);
    err = cudaMemsetAsync(a.n_deferred, 0, sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(staircase_warp_kernel<STOP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pl.smem_warp));
  if (err != cudaSuccess) return static_cast<int>(err);
  // most shared memory an SM can give, so several blocks' slices fit on it
  err = cudaFuncSetAttribute(staircase_warp_kernel<STOP>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  staircase_warp_kernel<STOP>
      <<<static_cast<unsigned int>(pl.grid_warp), THREADS, pl.smem_warp,
         stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !pl.may_defer) return static_cast<int>(err);
  return a.stage_in_smem ? launch_block<STOP, true>(pl, stream)
                         : launch_block<STOP, false>(pl, stream);
}

}  // namespace

extern "C" {

// Bytes of global scratch the launch needs for N windows of CL x CR lists
// on CUDA device `device` (0 when no list is wider than a warp's slice, so
// no window is deferred), or -1 on a CUDA error.
long long ipk_staircase_scratch_bytes(long long N, long long CL,
                                      long long CR, int device) {
  if (N <= 0 || CL < 1 || CR < 1) return 0;
  Plan pl;
  if (plan(N, CL, CR, device, &pl) != cudaSuccess) return -1;
  return pl.scratch;
}

// Launches the kernel on `stream` of CUDA device `device` and returns
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for empty lists,
// cap outside [1, 2^31), CL * CR >= 2^31, or a missing scratch of
// ipk_staircase_scratch_bytes bytes. Allocates nothing and does not
// synchronise: one or two kernels (the warp pass, and the block pass where a
// window may be deferred) after a 4-byte memset of the scratch.
int ipk_staircase_select(const float* sL, const long long* cL, const float* sR,
                         const long long* cR, const float* eps,
                         long long* out_cl, long long* out_cr, float* out_s,
                         int* totals, void* scratch, long long N,
                         long long CL, long long CR, long long cap,
                         int sort_l, int device, cudaStream_t stream) {
  return launch<0>(sL, cL, sR, cR, eps, out_cl, out_cr, out_s, totals,
                   scratch, N, CL, CR, cap, sort_l, device, stream);
}

// Measurement only (the build never calls it): the same launch, stopped
// after staging and sorting (stop = 1) or after counts and offsets (stop =
// 2); stop = 0 runs it whole. Outputs other than totals are left unwritten.
int ipk_staircase_select_stages(const float* sL, const long long* cL,
                                const float* sR, const long long* cR,
                                const float* eps, long long* out_cl,
                                long long* out_cr, float* out_s, int* totals,
                                void* scratch, long long N, long long CL,
                                long long CR, long long cap, int sort_l,
                                int device, cudaStream_t stream, int stop) {
  if (stop == 1)
    return launch<1>(sL, cL, sR, cR, eps, out_cl, out_cr, out_s, totals,
                     scratch, N, CL, CR, cap, sort_l, device, stream);
  if (stop == 2)
    return launch<2>(sL, cL, sR, cR, eps, out_cl, out_cr, out_s, totals,
                     scratch, N, CL, CR, cap, sort_l, device, stream);
  return launch<0>(sL, cL, sR, cR, eps, out_cl, out_cr, out_s, totals,
                   scratch, N, CL, CR, cap, sort_l, device, stream);
}

}  // extern "C"
