// Packet-field predicates and slot selects shared by the feature kernels
// (feature_window.cu, feature_update.cu, tick_step.cu, engine_hop.cu).
//
// The codes mirror src/repro_torch/core/features.py.  Both kernels must
// make the same per-packet decisions as the plain versions
// `_pred_mask` / `_field_vals` in src/repro_torch/kernels/ref.py, so the
// decisions live here once.  kernels/_build.py hashes every *.cuh in
// this directory into the build key: an edit here rebuilds every kernel.
#pragma once

#include <math.h>

namespace splidt {

constexpr int OP_COUNT = 1, OP_SUM = 2, OP_MAX = 3, OP_MIN = 4, OP_LAST = 5,
              OP_SUMSQ = 6, OP_FIRST = 7;
constexpr int PRED_TRUE = 0, PRED_FWD = 1, PRED_BWD = 2, PRED_SYN = 3,
              PRED_ACK = 4, PRED_FIN = 5, PRED_RST = 6, PRED_PSH = 7,
              PRED_URG = 8;
constexpr int PKT_DIR = 2, PKT_FLAGS = 3, PKT_IAT = 4, PKT_VALID = 5,
              PKT_NFIELDS = 6;

// Does packet `pk` (PKT_NFIELDS floats) match predicate code `pred`?
// Invalid packets (valid <= 0) and unknown codes match nothing.
__device__ __forceinline__ bool pred_mask(const float* __restrict__ pk,
                                          int pred) {
  if (!(pk[PKT_VALID] > 0.0f)) return false;
  const float direc = pk[PKT_DIR];
  const int flags = (int)pk[PKT_FLAGS];  // float -> int32 truncation
  switch (pred) {
    case PRED_TRUE: return true;
    case PRED_FWD: return direc == 0.0f;
    case PRED_BWD: return direc == 1.0f;
    case PRED_SYN: return (flags & 1) > 0;
    case PRED_ACK: return (flags & 2) > 0;
    case PRED_FIN: return (flags & 4) > 0;
    case PRED_RST: return (flags & 8) > 0;
    case PRED_PSH: return (flags & 16) > 0;
    case PRED_URG: return (flags & 32) > 0;
    default: return false;
  }
}

// The slot's packet field, 0.0 for a code outside 0..PKT_NFIELDS-1.
__device__ __forceinline__ float field_value(const float* __restrict__ pk,
                                             int field) {
  return (field >= 0 && field < PKT_NFIELDS) ? pk[field] : 0.0f;
}

// field_value for a packet held in registers: the compare-and-select
// over the six fields keeps the array's indices compile-time, so it stays
// in registers (a dynamic index would put it in local memory).
__device__ __forceinline__ float select_field(const float (&pk)[PKT_NFIELDS],
                                              int f) {
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < PKT_NFIELDS; ++i)
    if (f == i) v = pk[i];
  return v;
}

// torch.maximum / torch.minimum: NaN if either side is NaN (fmaxf and
// fminf would return the other operand instead).
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a || b != b) return NAN;
  return a > b ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a || b != b) return NAN;
  return a < b ? a : b;
}

}  // namespace splidt
