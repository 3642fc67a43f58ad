// The per-packet register fold of live flow-table serving.
//
// Replaces the Pallas TPU kernels `feature_update_pallas`
// (`_update_kernel`) and `feature_update_finalize_pallas`
// (`_update_finalize_kernel`) in src/repro/kernels/feature_window.py.
// Plain versions: `feature_update_ref` and `feature_update_finalize_ref`
// in src/repro_torch/kernels/ref.py, which these kernels must equal bit
// for bit (docs/PARITY.md §5).
//
// Each row folds ONE packet into its running window state (acc, seen):
// COUNT/SUM/SUMSQ add their term to acc, MAX/MIN take the NaN-propagating
// max/min, FIRST latches on the incoming seen == 0, LAST overwrites, and
// seen gains the packet's predicate bit.  The FINALIZE form also emits
// the registers the window would have if it ended here (the empty-window
// fallbacks MAX -> 0, MIN -> init, FIRST/LAST -> 0 from the new seen).
//
// What bounds it on the H100: launch latency.  The work is elementwise,
// ~136 bytes per row at k = 4 (~168 with FINALIZE): at the serving rank
// width of a few tens of thousands of rows that is a few MB, about a
// microsecond at 3.35 TB/s, far below the few microseconds a launch
// costs.  So the design is the plainest one: one thread per (row, slot),
// no shared memory, every input read once and every output written once.
// The k threads of a row are adjacent, so they share the row's packet
// bytes in one load.  The row math (fold_slot, finalize_slot) lives in
// fold.cuh, shared with the tick kernel (tick_step.cu).
#include <cuda_runtime.h>

#include "fold.cuh"

namespace {

using namespace splidt;

template <bool FINALIZE>
__global__ void feature_update_kernel(
    const float* __restrict__ pkt,        // (n, 6), one packet per row
    const int* __restrict__ slot_op,      // (n, k)
    const int* __restrict__ slot_field,   // (n, k)
    const int* __restrict__ slot_pred,    // (n, k)
    const float* __restrict__ slot_init,  // (n, k), read if FINALIZE
    const float* __restrict__ acc,        // (n, k)
    const int* __restrict__ seen,         // (n, k)
    float* __restrict__ acc_out,          // (n, k)
    int* __restrict__ seen_out,           // (n, k)
    float* __restrict__ regs_out,         // (n, k), written if FINALIZE
    long long n_slots, int k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const float* pk = pkt + (i / k) * PKT_NFIELDS;
  const int op = slot_op[i];
  float a = acc[i];
  int s = seen[i];
  fold_slot(op, pred_mask(pk, slot_pred[i]), field_value(pk, slot_field[i]),
            a, s);
  acc_out[i] = a;
  seen_out[i] = s;
  if (FINALIZE) regs_out[i] = finalize_slot(op, slot_init[i], a, s);
}

template <bool FINALIZE>
int launch(const float* pkt, const int* slot_op, const int* slot_field,
           const int* slot_pred, const float* slot_init, const float* acc,
           const int* seen, float* acc_out, int* seen_out, float* regs_out,
           long long n_rows, int k, void* stream) {
  const long long n_slots = n_rows * k;
  if (n_slots == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_slots + threads - 1) / threads;
  feature_update_kernel<FINALIZE><<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
      pkt, slot_op, slot_field, slot_pred, slot_init, acc, seen, acc_out,
      seen_out, regs_out, n_slots, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int feature_update_launch(
    const float* pkt, const int* slot_op, const int* slot_field,
    const int* slot_pred, const float* acc, const int* seen, float* acc_out,
    int* seen_out, long long n_rows, int k, void* stream) {
  return launch<false>(pkt, slot_op, slot_field, slot_pred, nullptr, acc,
                       seen, acc_out, seen_out, nullptr, n_rows, k, stream);
}

extern "C" int feature_update_finalize_launch(
    const float* pkt, const int* slot_op, const int* slot_field,
    const int* slot_pred, const float* slot_init, const float* acc,
    const int* seen, float* acc_out, int* seen_out, float* regs_out,
    long long n_rows, int k, void* stream) {
  return launch<true>(pkt, slot_op, slot_field, slot_pred, slot_init, acc,
                      seen, acc_out, seen_out, regs_out, n_rows, k, stream);
}

extern "C" const char* feature_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
