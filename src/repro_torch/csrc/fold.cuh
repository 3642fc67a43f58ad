// Per-slot row math shared by the serving kernels: the one-packet fold,
// the finalize, the blank state, and the range match of a subtree.
//
// feature_update.cu (the fold kernels) and tick_step.cu (the tick kernel)
// fold with fold_slot/finalize_slot; dt_traverse.cu (kernel B) and
// tick_step.cu match with marks_below/first_hit_leaf.  Keeping one copy
// keeps the kernels bit-equal to each other and to the plain versions in
// src/repro_torch/kernels/ref.py (`feature_update_ref`,
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

}  // namespace splidt
