// Partitioned-subtree range-mark matching: the SpliDT subtree lookup.
//
// Replaces the Pallas TPU kernel `dt_traverse_pallas`
// (src/repro/kernels/dt_traverse.py, `_kernel`).  Plain versions:
// `dt_traverse_flows_ref` (one SID a flow) and `dt_traverse_blocks_ref`
// (one SID a block of flows) in repro_torch.kernels.dt_traverse, which
// this kernel must equal bit for bit.
//
//   row     = the flow's SID, -1 wrapped to S - 1 as a negative index
//             reads it in the plain version (anything else outside
//             [0, S) clamped into it, so nothing is read out of bounds)
//   marks_j = #{ t : thr[row, j, t] < reg_j }                per slot
//   hit(l)  = valid[row, l] and lo[row, l, j] <= marks_j <= hi[row, l, j]
//             for all j
//   action  = act[row, first hit l], or -1 when no leaf hits
//
// What bounds it on the H100: device memory.  Per flow it reads k f32
// registers and one int32 SID and writes one int32 action (24 bytes at
// k = 4); the engine's tables are 13 KB at S = 30, T = L = 8.  At 2^20
// flows that is ~25 MB, 7.5 us at 3.35 TB/s; the compares (k*T + L*k a
// flow) are far below the ALU rate.
//
// No SID dispatch.  The Pallas kernel staged one subtree a grid step, so
// the TPU port grouped flows into SID-homogeneous blocks first (an
// argsort, a scan, a scatter and a gather around every launch: 45 device
// kernels, 1.35 ms at 2^20 flows).  Here each flow reads its own SID and
// matches against its own subtree, so a CTA serves whatever SIDs its
// flows hold.  What a flow of random SID then costs is its scattered
// table reads: read through the cache one leaf bound at a time, a warp's
// 32 flows touch up to 32 lines a load, and L1 wavefronts set the time
// (0.070 ms at 2^20, the form measured first).  Two paths:
//
// * staged (L <= 32 and the staged tables within 48 KB, as the engine's
//   are): one CTA of 1,024 threads an SM stages every subtree once, in
//   the form the match wants.  For each (subtree, slot, mark m) a 32-bit
//   mask of the leaves whose [lo, hi] holds m (each leaf's bound range
//   OR-ed in with shared atomics), for each subtree the mask of its valid
//   leaves, the actions, and the thresholds (row strides odd, so random
//   rows spread over the banks).  A flow's first hit is then
//       __ffs(valid[row] & AND_j mask[row, j, marks_j]) - 1,
//   the serial scan's first valid hit on any table, in k + 2 shared
//   loads.  The marks count by binary search when every threshold row
//   ascends (the count of a sorted row's elements below the register:
//   the same integer; NaN fails the check), else by the linear count.
//   The CTAs loop over the flows, each thread loading its next flow's
//   SID and (at k = 4) its registers before it matches the current one.
// * cached (deeper tables): a CTA owns 256 consecutive flows, walks their
//   registers in order (coalesced) and marks each against its slot's
//   thresholds (marks_below_vec), then matches each flow with one thread
//   (first_hit_leaf) or, at L >= engine_hop.WARP_MATCH_MIN_LEAVES, one
//   warp (warp_first_hit_leaf), reading the tables through the cache as
//   the hop kernel does.
// The host picks the path (kernels/dt_traverse.py, `kernel_path`).  The
// block form (the counterpart of the Pallas kernel's signature) reads a
// flow's SID as block_sid[b / block_b] and is otherwise the same kernel.
//
// Limits: none on S, T or L.  The cached path keeps flows * k marks in
// dynamic shared memory, at most 48 KB: `flows` is 256 up to k = 48 and
// falls to 12,288 / k above, so k <= 12,288 (one flow a CTA); the wrapper
// raises above that.  The match of the cached path lives in fold.cuh,
// shared with the tick and hop kernels.
#include <cuda_runtime.h>

#include "fold.cuh"

namespace {

using namespace splidt;

constexpr int kThreads = 256;               // cached path
constexpr int kStagedThreads = 1024;        // staged path
constexpr int kMarkInts = 12288;            // at most 48 KB of marks a CTA

struct Tables {
  const float* thr;           // (S, k, T), +inf padded
  const int* leaf_lo;         // (S, L, k)
  const int* leaf_hi;         // (S, L, k)
  const int* leaf_action;     // (S, L)
  const int* leaf_valid;      // (S, L)
  int S, k, T, L;
};

// -1 wraps to S - 1; anything else outside [0, S) is clamped into it.
__device__ __forceinline__ long long table_row(int sid, int S) {
  const long long row = sid < 0 ? (long long)sid + S : (long long)sid;
  return row < 0 ? 0 : (row >= S ? S - 1 : row);
}

// `block_b` 0: `sid` holds one SID a flow; otherwise one a block of
// `block_b` flows.
__device__ __forceinline__ int flow_sid(const int* __restrict__ sid,
                                        long long b, int block_b) {
  return __ldg(sid + (block_b ? b / block_b : b));
}

// The staged tables in shared memory (4-byte words): thresholds
// (S, k, Tp), leaf masks (S, k, Mp), valid masks (S,), actions (S, L),
// and the flag "every threshold row ascends".
struct Staged {
  int Tp, Mp;                 // odd row strides: T | 1, (T + 1) | 1
  float* thr;
  unsigned* mask;
  unsigned* valid;
  int* act;
  int* ascends;
};

// kernels/dt_traverse.py `staged_bytes` is 4x this
__host__ __device__ __forceinline__ long long staged_words(int S, int k,
                                                           int T, int L) {
  return (long long)S * k * (T | 1) + (long long)S * k * ((T + 1) | 1) + S
         + (long long)S * L + 1;
}

__device__ Staged stage_tables(const Tables& tb, void* smem) {
  const int S = tb.S, k = tb.k, T = tb.T, L = tb.L;
  Staged s;
  s.Tp = T | 1;
  s.Mp = (T + 1) | 1;
  s.thr = reinterpret_cast<float*>(smem);
  s.mask = reinterpret_cast<unsigned*>(s.thr + S * k * s.Tp);
  s.valid = s.mask + S * k * s.Mp;
  s.act = reinterpret_cast<int*>(s.valid + S);
  s.ascends = s.act + S * L;
  if (threadIdx.x == 0) *s.ascends = 1;
  for (int i = threadIdx.x; i < S * k * s.Mp; i += blockDim.x)
    s.mask[i] = 0u;
  for (int i = threadIdx.x; i < S; i += blockDim.x) s.valid[i] = 0u;
  for (int i = threadIdx.x; i < S * k * T; i += blockDim.x) {
    const int rj = i / T;
    s.thr[rj * s.Tp + i - rj * T] = __ldg(tb.thr + i);
  }
  for (int i = threadIdx.x; i < S * L; i += blockDim.x)
    s.act[i] = __ldg(tb.leaf_action + i);
  __syncthreads();
  for (int i = threadIdx.x; i < S * k * T; i += blockDim.x) {
    const int rj = i / T, t = i - rj * T;
    if (t + 1 < T && !(s.thr[rj * s.Tp + t] <= s.thr[rj * s.Tp + t + 1]))
      *s.ascends = 0;
  }
  for (int i = threadIdx.x; i < S * L; i += blockDim.x) {
    const int row = i / L;
    if (__ldg(tb.leaf_valid + i) > 0)
      atomicOr(s.valid + row, 1u << (i - row * L));
  }
  // leaf l of subtree `row` holds mark m of slot j for m in [lo, hi]
  for (int q = threadIdx.x; q < S * L * k; q += blockDim.x) {
    const int row = q / (L * k), rem = q - row * L * k;
    const int l = rem / k, j = rem - l * k;
    const int lo = max(__ldg(tb.leaf_lo + q), 0);
    const int hi = min(__ldg(tb.leaf_hi + q), T);
    unsigned* m = s.mask + (row * k + j) * s.Mp;
    for (int v = lo; v <= hi; ++v) atomicOr(m + v, 1u << l);
  }
  __syncthreads();
  return s;
}

// marks_below on a staged threshold row: where the rows ascend, a binary
// search for the first t with !(v > thr[t]), which is the count; else
// the count itself.
__device__ __forceinline__ int staged_marks(float v, const float* thr,
                                            int T, bool ascends) {
  if (!ascends) {
    int m = 0;
    for (int t = 0; t < T; ++t) m += (v > thr[t]) ? 1 : 0;
    return m;
  }
  int lo = 0, hi = T;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v > thr[mid]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// k4: k = 4 with 16-byte aligned registers, read 16 bytes at a time and
// the next flow's loaded ahead; otherwise any k, a float at a time.
template <bool k4>
__global__ void __launch_bounds__(kStagedThreads) dt_traverse_staged(
    const float* __restrict__ regs, const int* __restrict__ sid,
    int block_b, long long B, Tables tb, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Staged s = stage_tables(tb, smem);
  const bool ascends = *s.ascends != 0;
  const int k = tb.k;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int sid_next = flow_sid(sid, b, block_b);
  float4 v_next = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k4) v_next = __ldg(reinterpret_cast<const float4*>(regs) + b);
  for (; b < B; b += stride) {
    const long long row = table_row(sid_next, tb.S);
    const float4 v4 = v_next;
    const long long bn = b + stride;
    if (bn < B) {
      sid_next = flow_sid(sid, bn, block_b);
      if (k4) v_next = __ldg(reinterpret_cast<const float4*>(regs) + bn);
    }
    unsigned hit = s.valid[row];
    const float* thr = s.thr + row * k * s.Tp;
    const unsigned* mask = s.mask + row * k * s.Mp;
    if (k4) {
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hit &= mask[j * s.Mp + staged_marks(v[j], thr + j * s.Tp, tb.T,
                                            ascends)];
    } else {
      for (int j = 0; j < k; ++j)
        hit &= mask[j * s.Mp + staged_marks(__ldg(regs + b * k + j),
                                            thr + j * s.Tp, tb.T,
                                            ascends)];
    }
    out[b] = hit ? s.act[row * tb.L + __ffs(hit) - 1] : -1;
  }
}

template <bool kWarpMatch>
__global__ void __launch_bounds__(kThreads) dt_traverse_cached(
    const float* __restrict__ regs, const int* __restrict__ sid,
    int block_b, long long B, int flows, Tables tb,
    int* __restrict__ out) {
  extern __shared__ int s_marks[];    // flows * k
  const int k = tb.k;
  const long long b0 = (long long)blockIdx.x * flows;
  const int n = (int)min((long long)flows, B - b0);
  // 1. marks: element i of the CTA's n * k registers is flow i / k, slot
  //    i % k
  const float* r0 = regs + b0 * k;
  for (int i = threadIdx.x; i < n * k; i += kThreads) {
    const int f = i / k;
    const int j = i - f * k;
    const long long row = table_row(flow_sid(sid, b0 + f, block_b), tb.S);
    s_marks[i] = marks_below_vec(__ldg(r0 + i),
                                 tb.thr + (row * k + j) * tb.T, tb.T);
  }
  __syncthreads();
  // 2. the first hit leaf of each flow
  if constexpr (kWarpMatch) {
    for (int f = threadIdx.x / 32; f < n; f += kThreads / 32) {
      const long long row = table_row(flow_sid(sid, b0 + f, block_b), tb.S);
      const long long lk = row * tb.L * k;
      const int a = warp_first_hit_leaf(
          s_marks + f * k, tb.leaf_lo + lk, tb.leaf_hi + lk,
          tb.leaf_action + row * tb.L, tb.leaf_valid + row * tb.L, k, tb.L);
      if ((threadIdx.x & 31) == 0) out[b0 + f] = a;
    }
  } else {
    for (int f = threadIdx.x; f < n; f += kThreads) {
      const long long row = table_row(flow_sid(sid, b0 + f, block_b), tb.S);
      const long long lk = row * tb.L * k;
      const int* marks = s_marks + f * k;
      out[b0 + f] = first_hit_leaf(
          [&](int j) { return marks[j]; }, tb.leaf_lo + lk, tb.leaf_hi + lk,
          tb.leaf_action + row * tb.L, tb.leaf_valid + row * tb.L, k, tb.L);
    }
  }
}

int cached_flows(int k) {
  if (k <= 0 || k > kMarkInts) return 0;
  return k * kThreads <= kMarkInts ? kThreads : kMarkInts / k;
}

}  // namespace

// `block_b` 0: `sid` (B,) holds a SID a flow; otherwise `sid` holds one
// a block of `block_b` flows (B a multiple of it).  `path`: 0 cached with
// one thread a flow's leaves, 1 cached with a warp, 2 staged (L <= 32,
// at most 48 KB, at most `sms` CTAs).  Returns a cudaError_t.
extern "C" int dt_traverse_launch(
    const float* regs, const int* sid, int block_b, long long B,
    const float* thr, const int* leaf_lo, const int* leaf_hi,
    const int* leaf_action, const int* leaf_valid, int S, int k, int T,
    int L, int path, int sms, int* out, void* stream) {
  if (B == 0) return 0;
  if (S <= 0 || k <= 0 || block_b < 0) return (int)cudaErrorInvalidValue;
  const Tables tb{thr, leaf_lo, leaf_hi, leaf_action, leaf_valid, S, k, T,
                  L};
  const cudaStream_t st = (cudaStream_t)stream;
  if (path == 2) {
    const long long bytes = 4 * staged_words(S, k, T, L);
    if (L > 32 || bytes > 48 * 1024 || sms <= 0)
      return (int)cudaErrorInvalidValue;
    long long blocks = (B + kStagedThreads - 1) / kStagedThreads;
    if (blocks > sms) blocks = sms;
    const bool k4 = k == 4 && (reinterpret_cast<size_t>(regs) & 15) == 0;
    auto* kernel = k4 ? dt_traverse_staged<true>
                      : dt_traverse_staged<false>;
    kernel<<<(unsigned)blocks, kStagedThreads, (size_t)bytes, st>>>(
        regs, sid, block_b, B, tb, out);
    return (int)cudaGetLastError();
  }
  const int flows = cached_flows(k);
  if (flows == 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (B + flows - 1) / flows;
  auto* kernel = path == 1 ? dt_traverse_cached<true>
                           : dt_traverse_cached<false>;
  kernel<<<(unsigned)blocks, kThreads, sizeof(int) * (size_t)flows * k,
           st>>>(regs, sid, block_b, B, flows, tb, out);
  return (int)cudaGetLastError();
}

extern "C" const char* dt_traverse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
