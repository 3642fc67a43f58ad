// Per-slot row math shared by the serving kernels: the one-packet fold,
// the finalize, the blank state, and the range match of a subtree.
//
// feature_update.cu (the fold kernels) and tick_step.cu (the tick kernel)
// fold with fold_slot/finalize_slot; dt_traverse.cu (kernel B),
// tick_step.cu and engine_hop.cu match with marks_below/first_hit_leaf,
// and engine_hop.cu on deep subtrees with warp_first_hit_leaf.  Keeping
// one copy keeps the kernels bit-equal to each other and to the plain
// versions in src/repro_torch/kernels/ref.py (`feature_update_ref`,
// `feature_finalize_ref`, `feature_state_init`, `dt_traverse_ref`).
// Products and adds are spelled __fmul_rn/__fadd_rn ((v*v)*m, then
// acc + term) and the build passes -fmad=false, so nothing is contracted
// into an FMA.  kernels/_build.py hashes every *.cuh here into the build
// key.
#pragma once

#include <math.h>

#include "packet_fields.cuh"

namespace splidt {

// Fold one packet into one slot's (acc, seen): `m` is the packet's
// predicate bit for the slot, `v` its field value.  COUNT/SUM/SUMSQ add
// their term, MAX/MIN take the NaN-propagating max/min, FIRST latches on
// the incoming seen == 0, LAST overwrites; seen gains the predicate bit.
__device__ __forceinline__ void fold_slot(int op, bool m, float v,
                                          float& acc, int& seen) {
  const float mf = m ? 1.0f : 0.0f;
  const float a = acc;
  float out = a;
  switch (op) {
    case OP_COUNT: out = __fadd_rn(a, mf); break;
    case OP_SUM: out = __fadd_rn(a, __fmul_rn(v, mf)); break;
    case OP_SUMSQ: out = __fadd_rn(a, __fmul_rn(__fmul_rn(v, v), mf)); break;
    case OP_MAX: if (m) out = nan_max(a, v); break;
    case OP_MIN: if (m) out = nan_min(a, v); break;
    case OP_FIRST: if (m && seen == 0) out = v; break;  // the incoming seen
    case OP_LAST: if (m) out = v; break;
    default: break;
  }
  acc = out;
  seen = seen | (m ? 1 : 0);
}

// The register a slot's folded state gives: the state itself, with the
// empty-window fallbacks (MAX, FIRST, LAST -> 0, MIN -> init) where no
// packet matched.
__device__ __forceinline__ float finalize_slot(int op, float init, float acc,
                                               int seen) {
  if (seen == 0) {
    if (op == OP_MAX || op == OP_FIRST || op == OP_LAST) return 0.0f;
    if (op == OP_MIN) return init;
  }
  return acc;
}

// A blank slot's acc: MIN at +inf, MAX at -inf, every other op at 0.
__device__ __forceinline__ float blank_acc(int op) {
  if (op == OP_MIN) return INFINITY;
  if (op == OP_MAX) return -INFINITY;
  return 0.0f;
}

// Range mark of one register: the number of the subtree's thresholds
// (one slot's row of T, +inf padded) below it.
__device__ __forceinline__ int marks_below(float v,
                                           const float* __restrict__ thr,
                                           int T) {
  int m = 0;
  for (int t = 0; t < T; ++t) m += (v > thr[t]) ? 1 : 0;
  return m;
}

// The action of the first valid leaf whose every slot's mark lies in
// [lo, hi], or -1 when none does.  `mark(j)` gives slot j's mark; `lo`,
// `hi` are the subtree's (L, k) bounds, `action`, `valid` its (L,) rows.
template <class Mark>
__device__ __forceinline__ int first_hit_leaf(
    Mark mark, const int* __restrict__ lo, const int* __restrict__ hi,
    const int* __restrict__ action, const int* __restrict__ valid, int k,
    int L) {
  for (int l = 0; l < L; ++l) {
    if (valid[l] <= 0) continue;
    bool hit = true;
    for (int j = 0; j < k && hit; ++j) {
      const int m = mark(j);
      hit = (m >= lo[l * k + j]) && (m <= hi[l * k + j]);
    }
    if (hit) return action[l];
  }
  return -1;
}

// marks_below with the row read 16 bytes at a time where the row allows
// it (T a multiple of 4, the row 16-byte aligned): a lane's T loads touch
// as many cache lines as its 32 neighbours' rows together, so on deep
// tables (T up to 64, a different subtree a flow) the one-float loads
// were most of a hop's L1 traffic.  The count is the same integer in any
// order.
__device__ __forceinline__ int marks_below_vec(float v,
                                               const float* __restrict__ thr,
                                               int T) {
  if ((T & 3) != 0 || (reinterpret_cast<size_t>(thr) & 15) != 0)
    return marks_below(v, thr, T);
  const float4* t4 = reinterpret_cast<const float4*>(thr);
  int m = 0;
  for (int t = 0; t < (T >> 2); ++t) {
    const float4 q = __ldg(t4 + t);
    m += (v > q.x ? 1 : 0) + (v > q.y ? 1 : 0) + (v > q.z ? 1 : 0)
         + (v > q.w ? 1 : 0);
  }
  return m;
}

// Whether every slot's mark lies in its leaf's [lo, hi], the bounds read
// V ints at a time (V = 4 or 2 where k and the rows' alignment allow it,
// else 1): a lane's loads then touch k / V times fewer cache lines.
template <int V>
__device__ __forceinline__ bool marks_within(const int* marks,
                                             const int* __restrict__ lo,
                                             const int* __restrict__ hi,
                                             int k) {
  bool ok = true;
  for (int j = 0; j < k; j += V) {
    if constexpr (V == 4) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(lo + j));
      const int4 b = __ldg(reinterpret_cast<const int4*>(hi + j));
      ok &= (marks[j] >= a.x) & (marks[j] <= b.x) & (marks[j + 1] >= a.y)
            & (marks[j + 1] <= b.y) & (marks[j + 2] >= a.z)
            & (marks[j + 2] <= b.z) & (marks[j + 3] >= a.w)
            & (marks[j + 3] <= b.w);
    } else if constexpr (V == 2) {
      const int2 a = __ldg(reinterpret_cast<const int2*>(lo + j));
      const int2 b = __ldg(reinterpret_cast<const int2*>(hi + j));
      ok &= (marks[j] >= a.x) & (marks[j] <= b.x) & (marks[j + 1] >= a.y)
            & (marks[j + 1] <= b.y);
    } else {
      ok &= (marks[j] >= __ldg(lo + j)) & (marks[j] <= __ldg(hi + j));
    }
  }
  return ok;
}

// first_hit_leaf by the 32 lanes of a warp together, for deep subtrees
// (the DSE's models: L up to 704 leaves).  Every lane of the warp calls
// it with the same flow; `marks` (shared memory) holds the flow's k
// marks.  Round r tests leaves 32 r .. 32 r + 31, lane i leaf 32 r + i,
// so a round reads 32 consecutive leaves' (k,) rows of `lo` and `hi`;
// __ballot_sync gathers the hits and __ffs takes the lowest, and the
// first round with a hit ends the scan.  That is the serial scan's first
// valid hit on any table, overlapping boxes included.  A lane loads its
// leaf's `valid` word and bounds unconditionally (a lane past L reads
// leaf 0 and counts no hit), so a round's loads are in flight together.
template <int V>
__device__ __forceinline__ int warp_scan_leaves(
    const int* marks, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ action,
    const int* __restrict__ valid, int k, int L) {
  const int lane = threadIdx.x & 31;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int l = l0 + lane;
    const int r = l < L ? l : 0;
    const bool hit = (l < L) & (__ldg(valid + r) > 0)
                     & marks_within<V>(marks, lo + (long long)r * k,
                                       hi + (long long)r * k, k);
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (ballot != 0u) return __ldg(action + l0 + __ffs(ballot) - 1);
  }
  return -1;
}

__device__ __forceinline__ int warp_first_hit_leaf(
    const int* marks, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ action,
    const int* __restrict__ valid, int k, int L) {
  const size_t a = reinterpret_cast<size_t>(lo) | reinterpret_cast<size_t>(hi);
  if ((k & 3) == 0 && (a & 15) == 0)
    return warp_scan_leaves<4>(marks, lo, hi, action, valid, k, L);
  if ((k & 1) == 0 && (a & 7) == 0)
    return warp_scan_leaves<2>(marks, lo, hi, action, valid, k, L);
  return warp_scan_leaves<1>(marks, lo, hi, action, valid, k, L);
}

}  // namespace splidt
