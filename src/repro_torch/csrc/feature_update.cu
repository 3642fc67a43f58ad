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
// bytes in one load.  Products and adds are spelled __fmul_rn/__fadd_rn
// ((v*v)*m, then acc + term) and the build passes -fmad=false, so nothing
// is contracted into an FMA.
#include <cuda_runtime.h>

#include "packet_fields.cuh"

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
  const bool m = pred_mask(pk, slot_pred[i]);
  const float v = field_value(pk, slot_field[i]);
  const float mf = m ? 1.0f : 0.0f;
  const float a = acc[i];
  const int s = seen[i];

  float out = a;
  switch (op) {
    case OP_COUNT: out = __fadd_rn(a, mf); break;
    case OP_SUM: out = __fadd_rn(a, __fmul_rn(v, mf)); break;
    case OP_SUMSQ: out = __fadd_rn(a, __fmul_rn(__fmul_rn(v, v), mf)); break;
    case OP_MAX: if (m) out = nan_max(a, v); break;
    case OP_MIN: if (m) out = nan_min(a, v); break;
    case OP_FIRST: if (m && s == 0) out = v; break;  // the incoming seen
    case OP_LAST: if (m) out = v; break;
    default: break;
  }
  const int s2 = s | (m ? 1 : 0);
  acc_out[i] = out;
  seen_out[i] = s2;
  if (FINALIZE) {
    float r = out;
    if (s2 == 0) {
      if (op == OP_MAX || op == OP_FIRST || op == OP_LAST) r = 0.0f;
      else if (op == OP_MIN) r = slot_init[i];
    }
    regs_out[i] = r;
  }
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
