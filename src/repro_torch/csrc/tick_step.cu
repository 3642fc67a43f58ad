// One fused serving tick of the live flow table, in one launch.
//
// Replaces, on the fused tick engine's card route, the per-rank launches
// of the Pallas TPU kernels `feature_update_finalize_pallas`
// (src/repro/kernels/feature_window.py) and the per-hop-round
// `dt_traverse_pallas` (src/repro/kernels/dt_traverse.py) that the JAX
// `tick_step` (src/repro/kernels/tick_step.py) runs once per packet rank
// and drain round.  Plain version: the rank loop of
// src/repro_torch/kernels/tick_step.py (`tick_step(..., cuda=False)`),
// which this kernel must equal bit for bit on rows [:N] of every state
// field and on the four verdict buffers (docs/PARITY.md §5).
//
// What the tick computes: the tick's packets come rank-major, (R, C)
// slots and (R, C, 6) packets, rank r holding the r-th packet of each
// flow.  The fused pack gives each flow ONE column, the same at every
// rank, and a slot appears in no other column.  So one thread owns one
// column and walks its ranks in order, with the slot's row (acc, seen,
// sid, part, win_lo, win_hi, pkts_seen, recircs, retired) in registers:
// skip the dummy slot and a retired slot; zero the IAT where
// pkts_seen == win_lo (the window-boundary reset); fold the packet under
// the current SID's slot rows; count it; where pkts_seen reaches win_hi,
// finalize, range-match against the subtree, and apply the walk's hop
// (`kernels/ref.py::hop_update` and the tick engine's `_hop_round`):
// an exit or a fall off the last partition writes the four verdict
// buffers once and retires the slot, anything else advances part and
// the window from `bounds`; every hop blanks acc/seen for the new SID.
// While the flow advanced into an empty window it hops again on the
// finalized blank registers, at most P times (the drain rounds).  A
// column that holds a second slot at a later rank (not the fused pack's
// layout, but allowed) writes the first row back and loads the second.
//
// What bounds it on the H100: launch latency and the dependent chain of
// ranks, not memory.  A steady-state tick (R = 64, C = 16,384, ~32 k live
// packets, k = 4) moves ~4 MB of slot indices, ~0.8 MB of live packets,
// ~1 MB of state rows each way and the 4 MB of verdict buffers the
// wrapper fills: a few microseconds at 3.35 TB/s.  Each thread runs R
// dependent fold steps.  The design:
// - one thread per column, CTAs of 64 threads, so C = 16,384 spreads
//   over all 132 SMs;
// - slot indices and packets are read coalesced across a warp at each
//   rank (a packet as three 8-byte loads), and rank r + 1's slot and
//   packet are loaded before rank r is folded; padding cells read no
//   packet;
// - the tables are read through the read-only data cache, not staged in
//   shared memory: the fold reads the current SID's slot rows (op,
//   field, pred, init: 16 k bytes) once per hop into registers, and a hop
//   reads one subtree's k*T thresholds and L*(2k + 2) leaf words.  At
//   S = 30, k = 4, T = L = 8 the whole tables are 15,360 bytes (slot rows
//   1,920, thresholds 3,840, leaf bounds 7,680, actions and validity
//   1,920), resident in L1/L2 after the first hops;
// - the per-thread state is templated on k: for k = 1..kExactK every
//   register array has compile-time indices and stays in registers; for
//   k = 9..kMaxK (= N_FEATURES, 41, the most the JAX server serves) the
//   arrays are sized to a capacity (16, 32, 41) with a runtime k below it,
//   so their loops run k times with dynamic indices and the row lives in
//   local memory (cached in L1), which ptxas reports as stack.
// The row math is fold.cuh's, shared with feature_update.cu and
// dt_traverse.cu; -fmad=false and __fmul_rn/__fadd_rn keep it bit-equal.
// The kernel writes nothing to the dummy row N and allocates nothing: the
// wrapper allocates the verdict buffers.
#include <cuda_runtime.h>

#include "fold.cuh"

namespace {

using namespace splidt;

constexpr int kExactK = 8;    // k held in registers: 1..kExactK
constexpr int kMaxK = 41;     // kernels/tick_step.py K_MAX (N_FEATURES)
constexpr int kThreads = 64;

struct State {                 // (N + 1)-row TickState, in place
  float* acc;                  // (N+1, k)
  int* seen;                   // (N+1, k)
  int* sid;                    // (N+1,) each
  int* part;
  int* win_lo;
  int* win_hi;
  int* pkts_seen;
  int* recircs;
  int* retired;
  const int* bounds;           // (N+1, P, 2)
  int dummy;                   // N
  int P;
};

struct Tables {                // DeviceTables
  const int* slot_op;          // (S, k)
  const int* slot_field;       // (S, k)
  const int* slot_pred;        // (S, k)
  const float* slot_init;      // (S, k)
  const float* thr;            // (S, k, T), +inf padded
  const int* leaf_lo;          // (S, L, k)
  const int* leaf_hi;          // (S, L, k)
  const int* leaf_action;      // (S, L)
  const int* leaf_valid;       // (S, L)
  int S, T, L, n_subtrees;
};

struct Verdicts {              // (N+1,) each, filled by the wrapper
  int* mask;
  int* label;
  int* recirc;
  int* exit;
};

// One cell's packet: three 8-byte loads where the cell is live, zeros
// where it is padding.
__device__ __forceinline__ void load_packet(const float* __restrict__ pkt_rc,
                                            long long cell, bool live,
                                            float (&pk)[PKT_NFIELDS]) {
  if (live) {
    const float2* p =
        reinterpret_cast<const float2*>(pkt_rc + cell * PKT_NFIELDS);
    const float2 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
    pk[0] = a.x; pk[1] = a.y; pk[2] = b.x;
    pk[3] = b.y; pk[4] = c.x; pk[5] = c.y;
  } else {
#pragma unroll
    for (int i = 0; i < PKT_NFIELDS; ++i) pk[i] = 0.0f;
  }
}

// One slot's row, held in registers (or, above kExactK, local memory)
// between its load and its store.  CAP is the arrays' size; kExact says
// that k == CAP, which makes every loop's trip count a constant.
template <int CAP, bool kExact>
struct Flow {
  float acc[CAP];
  int seen[CAP];
  int op[CAP], field[CAP], pred[CAP];   // the current SID's slot rows
  float init[CAP];
  int sid, part, lo, hi, pkts, recircs, retired;
  int k;                          // the slots a subtree has, <= CAP

  // `#pragma unroll` unrolls a loop fully where this is a constant and
  // leaves it rolled where it is not
  __device__ __forceinline__ int n() const { return kExact ? CAP : k; }

  // table row of a SID: -1 (no leaf matched at the last hop) reads row
  // S - 1, as a negative index does in the plain version
  __device__ __forceinline__ long long table_row(const Tables& tb) const {
    return sid < 0 ? (long long)sid + tb.S : (long long)sid;
  }

  __device__ __forceinline__ void load_slot_rows(const Tables& tb) {
    const long long base = table_row(tb) * n();
#pragma unroll
    for (int j = 0; j < n(); ++j) {
      op[j] = __ldg(tb.slot_op + base + j);
      field[j] = __ldg(tb.slot_field + base + j);
      pred[j] = __ldg(tb.slot_pred + base + j);
      init[j] = __ldg(tb.slot_init + base + j);
    }
  }

  __device__ __forceinline__ void load(const State& st, const Tables& tb,
                                       int slot) {
    const long long base = (long long)slot * n();
#pragma unroll
    for (int j = 0; j < n(); ++j) {
      acc[j] = st.acc[base + j];
      seen[j] = st.seen[base + j];
    }
    sid = st.sid[slot];
    part = st.part[slot];
    lo = st.win_lo[slot];
    hi = st.win_hi[slot];
    pkts = st.pkts_seen[slot];
    recircs = st.recircs[slot];
    retired = st.retired[slot];
    load_slot_rows(tb);
  }

  __device__ __forceinline__ void store(const State& st, int slot) const {
    const long long base = (long long)slot * n();
#pragma unroll
    for (int j = 0; j < n(); ++j) {
      st.acc[base + j] = acc[j];
      st.seen[base + j] = seen[j];
    }
    st.sid[slot] = sid;
    st.part[slot] = part;
    st.win_lo[slot] = lo;
    st.win_hi[slot] = hi;
    st.pkts_seen[slot] = pkts;
    st.recircs[slot] = recircs;
    st.retired[slot] = retired;
  }

  __device__ __forceinline__ void fold(const float (&pk)[PKT_NFIELDS]) {
#pragma unroll
    for (int j = 0; j < n(); ++j)
      fold_slot(op[j], pred_mask(pk, pred[j]), select_field(pk, field[j]),
                acc[j], seen[j]);
  }

  // Finalize, range-match against subtree `sid` and hop.  Returns whether
  // the flow advanced into an empty window (a drain round follows).
  __device__ __forceinline__ bool hop(const State& st, const Tables& tb,
                                      const Verdicts& vd, int slot) {
    const long long s = table_row(tb);
    int marks[CAP];
#pragma unroll
    for (int j = 0; j < n(); ++j)
      marks[j] = marks_below(finalize_slot(op[j], init[j], acc[j], seen[j]),
                             tb.thr + (s * n() + j) * tb.T, tb.T);
    const int action = first_hit_leaf(
        [&](int j) { return marks[j]; }, tb.leaf_lo + s * tb.L * n(),
        tb.leaf_hi + s * tb.L * n(), tb.leaf_action + s * tb.L,
        tb.leaf_valid + s * tb.L, n(), tb.L);
    bool adv = false;
    if (action >= tb.n_subtrees) {              // exit with a class
      vd.mask[slot] = 1;
      vd.label[slot] = action - tb.n_subtrees;
      vd.recirc[slot] = recircs;
      vd.exit[slot] = part;
      retired = 1;
    } else {                                    // recirculate to `action`
      recircs += 1;
      sid = action;
      if (part == st.P - 1) {                   // fell off the last window
        vd.mask[slot] = 1;
        vd.label[slot] = -1;
        vd.recirc[slot] = recircs;
        vd.exit[slot] = -1;
        retired = 1;
      } else {
        adv = true;
        part += 1;
        const int* b = st.bounds + ((long long)slot * st.P + part) * 2;
        lo = b[0];
        hi = b[1];
      }
    }
    load_slot_rows(tb);                         // blank state, new SID
#pragma unroll
    for (int j = 0; j < n(); ++j) {
      acc[j] = blank_acc(op[j]);
      seen[j] = 0;
    }
    return adv && lo == hi;
  }
};

template <int CAP, bool kExact>
__global__ void __launch_bounds__(kThreads) tick_step_kernel(
    const int* __restrict__ slots_rc,    // (R, C)
    const float* __restrict__ pkt_rc,    // (R, C, 6)
    int R, int C, int k, State st, Tables tb, Verdicts vd) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  Flow<CAP, kExact> f;
  if constexpr (!kExact) f.k = k;       // k == CAP: n() never reads it
  int slot = -1;                                // no row loaded yet
  int next = slots_rc[c];
  float next_pk[PKT_NFIELDS];
  load_packet(pkt_rc, c, next != st.dummy, next_pk);
  for (int r = 0; r < R; ++r) {
    const int cur = next;
    float pk[PKT_NFIELDS];
#pragma unroll
    for (int i = 0; i < PKT_NFIELDS; ++i) pk[i] = next_pk[i];
    if (r + 1 < R) {                            // prefetch rank r + 1
      const long long cell = (long long)(r + 1) * C + c;
      next = slots_rc[cell];
      load_packet(pkt_rc, cell, next != st.dummy, next_pk);
    }
    if (cur == st.dummy) continue;
    if (cur != slot) {
      if (slot >= 0) f.store(st, slot);
      f.load(st, tb, cur);
      slot = cur;
    }
    // a flow that finished earlier this tick folds none of its late
    // packets (malformed flow_len)
    if (f.retired) continue;
    if (f.pkts == f.lo) pk[PKT_IAT] = 0.0f;     // window boundary
    f.fold(pk);
    f.pkts += 1;
    if (f.pkts != f.hi) continue;
    bool again = f.hop(st, tb, vd, slot);
    // empty windows drain on the blank registers, at most P rounds
    for (int d = 0; d < st.P && again; ++d) again = f.hop(st, tb, vd, slot);
  }
  if (slot >= 0) f.store(st, slot);
}

template <int CAP, bool kExact>
int launch(const int* slots_rc, const float* pkt_rc, int R, int C, int k,
           const State& st, const Tables& tb, const Verdicts& vd,
           cudaStream_t stream) {
  const int blocks = (C + kThreads - 1) / kThreads;
  tick_step_kernel<CAP, kExact><<<blocks, kThreads, 0, stream>>>(
      slots_rc, pkt_rc, R, C, k, st, tb, vd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tick_step_k_max() { return kMaxK; }

// Returns a cudaError_t: 0, the launch's error, or cudaErrorInvalidValue
// for k outside 1..kMaxK.
extern "C" int tick_step_launch(
    const int* slots_rc, const float* pkt_rc, int R, int C,
    float* acc, int* seen, int* sid, int* part, int* win_lo, int* win_hi,
    int* pkts_seen, int* recircs, int* retired, const int* bounds, int N,
    int P, const int* slot_op, const int* slot_field, const int* slot_pred,
    const float* slot_init, const float* thr, const int* leaf_lo,
    const int* leaf_hi, const int* leaf_action, const int* leaf_valid,
    int S, int k, int T, int L, int n_subtrees, int* v_mask, int* v_label,
    int* v_recirc, int* v_exit, void* stream) {
  if (R == 0 || C == 0) return 0;
  const State st{acc, seen, sid, part, win_lo, win_hi, pkts_seen, recircs,
                 retired, bounds, N, P};
  const Tables tb{slot_op, slot_field, slot_pred, slot_init, thr, leaf_lo,
                  leaf_hi, leaf_action, leaf_valid, S, T, L, n_subtrees};
  const Verdicts vd{v_mask, v_label, v_recirc, v_exit};
  cudaStream_t s = (cudaStream_t)stream;
#define SPLIDT_TICK(CAP, EXACT) \
  launch<CAP, EXACT>(slots_rc, pkt_rc, R, C, k, st, tb, vd, s)
  switch (k) {
    case 1: return SPLIDT_TICK(1, true);
    case 2: return SPLIDT_TICK(2, true);
    case 3: return SPLIDT_TICK(3, true);
    case 4: return SPLIDT_TICK(4, true);
    case 5: return SPLIDT_TICK(5, true);
    case 6: return SPLIDT_TICK(6, true);
    case 7: return SPLIDT_TICK(7, true);
    case 8: return SPLIDT_TICK(8, true);
    default: break;
  }
  static_assert(kExactK == 8, "the switch above covers 1..kExactK");
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (k <= 16) return SPLIDT_TICK(16, false);
  if (k <= 32) return SPLIDT_TICK(32, false);
  return SPLIDT_TICK(kMaxK, false);
#undef SPLIDT_TICK
}

extern "C" const char* tick_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
