// The per-packet register fold of live flow-table serving.
//
// Replaces the Pallas TPU kernels `feature_update_pallas`
// (`_update_kernel`) and `feature_update_finalize_pallas`
// (`_update_finalize_kernel`) in src/repro/kernels/feature_window.py.
// Plain versions: `feature_update_ref` and `feature_update_finalize_ref`
// in src/repro_torch/kernels/ref.py (the row forms) and
// `feature_update_table_ref` / `feature_update_finalize_table_ref` in
// src/repro_torch/kernels/feature_window.py (the table forms), which
// these kernels must equal bit for bit (docs/PARITY.md §5).
//
// Each row folds ONE packet into its running window state (acc, seen):
// COUNT/SUM/SUMSQ add their term to acc, MAX/MIN take the NaN-propagating
// max/min, FIRST latches on the incoming seen == 0, LAST overwrites, and
// seen gains the packet's predicate bit.  The FINALIZE form also emits
// the registers the window would have if it ended here (the empty-window
// fallbacks MAX -> 0, MIN -> init, FIRST/LAST -> 0 from the new seen).
//
// One template, two forms:
//   * the row form (the Pallas kernels' signatures): dense (n, k) slot
//     rows and state in, new (n, k) state out;
//   * the table form: the state lives in the resident (N, k) tables and
//     row r's state is table row slots[r], folded IN PLACE; the slot rows
//     are either pre-gathered (n, k) rows (`sid` null) or the SID-keyed
//     (S, k) tables read at row sid[r] (-1 wrapped to S - 1, as a
//     negative index reads it).  That is one launch where the gather,
//     fold and scatter around the Pallas kernel were ~8 device ops.
//
// Duplicate rows in the table form.  The JAX route gathers every row
// before it writes any, so two entries of `slots` naming one row both
// fold the old state.  In place, a later duplicate may read an earlier
// one's write and compute fold(fold(x)).  The flow table's ranks address
// each real row at most once and pad with duplicates of the dummy row
// that carry an invalid packet (valid = 0, finite fields).  Folding such
// a packet is idempotent on every bit (fold.cuh's fold_slot): its
// predicate bit is 0, so COUNT, SUM and SUMSQ add +0.0 (or -0.0 when
// v * 0 is), which turns -0.0 into +0.0 once and then holds, and keeps
// a NaN a NaN; MAX, MIN, FIRST and LAST leave acc alone; seen gains 0.
// So fold(fold(x)) == fold(x) for those duplicates, and the in-place
// result equals the gather-then-scatter one.  The kernel relies on that:
// duplicates carrying a valid packet are outside its contract, as they
// are outside JAX's `feature_update_at`'s ("UNIQUE row indices").  The
// CPU tests pin it on -0.0 and NaN states.
//
// What bounds it on the H100: launch latency at serving widths, device
// memory above.  The work is elementwise: a row reads its packet (24
// bytes), its slot and SID (8) and its state (8 k), and writes its state
// (8 k): ~96 bytes at k = 4, a few MB at the serving rank width of a few
// tens of thousands of rows, about a microsecond at 3.35 TB/s and below
// the few microseconds a launch costs.  So the design is the plainest
// one: one thread per (row, slot), no shared memory, every input read
// once and every output written once; the k threads of a row are
// adjacent, so they share the row's packet, slot and SID in one load
// each.  The slot rows (a few hundred bytes of SID-keyed tables) stay in
// L1.  The row math (fold_slot, finalize_slot) lives in fold.cuh, shared
// with the tick kernel (tick_step.cu).
#include <cuda_runtime.h>

#include "fold.cuh"

namespace {

using namespace splidt;

struct FoldArgs {
  const float* pkt;         // (n, 6), one packet per row
  const int* slots;         // (n,) table rows; null: row r is state row r
  const int* sid;           // (n,) SID rows of the slot tables; null: r
  const int* slot_op;       // (S, k), or (n, k) when sid is null
  const int* slot_field;
  const int* slot_pred;
  const float* slot_init;   // read if FINALIZE
  const float* acc;         // state in: (N, k), or (n, k) when slots null
  const int* seen;
  float* acc_out;           // state out; == acc in the table form
  int* seen_out;
  float* regs_out;          // (n, k), written if FINALIZE
  long long n_slots;        // n * k
  long long n_table;        // N: rows outside [0, N) are skipped
  int k, S;
};

// -1 wraps to S - 1; anything else outside [0, S) is clamped into it.
__device__ __forceinline__ long long table_row(int sid, int S) {
  const long long row = sid < 0 ? (long long)sid + S : (long long)sid;
  return row < 0 ? 0 : (row >= S ? S - 1 : row);
}

template <bool FINALIZE>
__global__ void feature_update_kernel(FoldArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_slots) return;
  const long long r = i / a.k;
  const int j = (int)(i - r * a.k);
  long long st = i;                       // state element
  if (a.slots != nullptr) {
    const long long row = __ldg(a.slots + r);
    if (row < 0 || row >= a.n_table) return;
    st = row * a.k + j;
  }
  const long long sr = a.sid != nullptr
      ? table_row(__ldg(a.sid + r), a.S) * a.k + j : i;   // slot-row element
  const float* pk = a.pkt + r * PKT_NFIELDS;
  const int op = __ldg(a.slot_op + sr);
  float acc = a.acc[st];
  int seen = a.seen[st];
  fold_slot(op, pred_mask(pk, __ldg(a.slot_pred + sr)),
            field_value(pk, __ldg(a.slot_field + sr)), acc, seen);
  a.acc_out[st] = acc;
  a.seen_out[st] = seen;
  if (FINALIZE)
    a.regs_out[i] = finalize_slot(op, __ldg(a.slot_init + sr), acc, seen);
}

template <bool FINALIZE>
int launch(const FoldArgs& a, void* stream) {
  if (a.n_slots == 0) return 0;
  const int threads = 256;
  const long long blocks = (a.n_slots + threads - 1) / threads;
  feature_update_kernel<FINALIZE><<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

FoldArgs row_args(const float* pkt, const int* slot_op,
                  const int* slot_field, const int* slot_pred,
                  const float* slot_init, const float* acc, const int* seen,
                  float* acc_out, int* seen_out, float* regs_out,
                  long long n_rows, int k) {
  return FoldArgs{pkt, nullptr, nullptr, slot_op, slot_field, slot_pred,
                  slot_init, acc, seen, acc_out, seen_out, regs_out,
                  n_rows * k, n_rows, k, (int)n_rows};
}

}  // namespace

// The row forms: (n, k) slot rows and state in, (n, k) state out.
extern "C" int feature_update_launch(
    const float* pkt, const int* slot_op, const int* slot_field,
    const int* slot_pred, const float* acc, const int* seen, float* acc_out,
    int* seen_out, long long n_rows, int k, void* stream) {
  return launch<false>(row_args(pkt, slot_op, slot_field, slot_pred,
                                nullptr, acc, seen, acc_out, seen_out,
                                nullptr, n_rows, k), stream);
}

extern "C" int feature_update_finalize_launch(
    const float* pkt, const int* slot_op, const int* slot_field,
    const int* slot_pred, const float* slot_init, const float* acc,
    const int* seen, float* acc_out, int* seen_out, float* regs_out,
    long long n_rows, int k, void* stream) {
  return launch<true>(row_args(pkt, slot_op, slot_field, slot_pred,
                               slot_init, acc, seen, acc_out, seen_out,
                               regs_out, n_rows, k), stream);
}

// The table forms: the (N, k) state tables folded in place at `slots`;
// `sid` null reads the slot rows as (n, k) rows, else as the (S, k)
// tables at each row's SID.  `slot_init` and `regs_out` are read and
// written when `finalize` is nonzero.
extern "C" int feature_update_table_launch(
    float* acc_tab, int* seen_tab, long long n_table, const int* slots,
    const int* sid, const float* pkt, const int* slot_op,
    const int* slot_field, const int* slot_pred, const float* slot_init,
    int S, float* regs_out, int finalize, long long n_rows, int k,
    void* stream) {
  const FoldArgs a{pkt, slots, sid, slot_op, slot_field, slot_pred,
                   slot_init, acc_tab, seen_tab, acc_tab, seen_tab,
                   regs_out, n_rows * k, n_table, k, S};
  return finalize ? launch<true>(a, stream) : launch<false>(a, stream);
}

extern "C" const char* feature_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
