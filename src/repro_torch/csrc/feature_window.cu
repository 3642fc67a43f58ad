// Windowed stateful feature accumulation: the SpliDT register fill.
//
// Replaces the Pallas TPU kernel `feature_window_pallas`
// (src/repro/kernels/feature_window.py, `_kernel`).  Plain version:
// `repro_torch.kernels.ref.feature_window_ref`, which this kernel must
// equal bit for bit (docs/PARITY.md §1).
//
// What bounds it on the H100: device memory.  Each flow's packet window
// (W packets x 6 f32 fields) is read once and every slot's register is
// a handful of compares and adds per packet; at B = 2^20 flows, W = 65,
// k = 4 that is 1.64 GB of packets for ~0.5 ms at 3.35 TB/s.
//
// Design:
//  * one thread per (flow, slot); the k threads of one flow are adjacent
//    in the warp, so they read the same packet bytes in the same
//    instruction and the load is served once;
//  * the window is walked in order, w = 0 .. W-1, keeping count, sum,
//    sum of squares, max, min, first and last in registers -- no window
//    tensor and no (B, W, k) intermediate ever reaches memory;
//  * the packet tensor is read in place through its flow stride, so the
//    engine's per-hop view `win_pkts[:, p]` needs no copy;
//  * COUNT/SUM/SUMSQ are the strict left-to-right chains of
//    `ordered_wsum`: they start at the term of packet 0 (not at 0.0) and
//    every product and add is spelled __fmul_rn/__fadd_rn, so the
//    compiler can neither contract v*v + acc into an FMA nor reorder.
//    The build also passes -fmad=false.
#include <cuda_runtime.h>
#include <math.h>

#include "packet_fields.cuh"

namespace {

using namespace splidt;

__global__ void feature_window_kernel(
    const float* __restrict__ pkts,     // (B, W, 6), flow stride in floats
    long long flow_stride,
    const int* __restrict__ slot_op,    // (B, k)
    const int* __restrict__ slot_field, // (B, k)
    const int* __restrict__ slot_pred,  // (B, k)
    const float* __restrict__ slot_init,// (B, k)
    float* __restrict__ out,            // (B, k)
    long long n_slots, int W, int k) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const long long b = i / k;
  const int op = slot_op[i];
  const int field = slot_field[i];
  const int pred = slot_pred[i];
  const float* row = pkts + b * flow_stride;

  float count = 0.0f, total = 0.0f, sumsq = 0.0f;
  float mx = -INFINITY, mn = INFINITY, first = 0.0f, last = 0.0f;
  bool any = false;
  for (int w = 0; w < W; ++w) {
    const float* pk = row + (long long)w * PKT_NFIELDS;
    const bool m = pred_mask(pk, pred);
    const float v = field_value(pk, field);
    const float mf = m ? 1.0f : 0.0f;
    const float tv = __fmul_rn(v, mf);
    const float sv = __fmul_rn(__fmul_rn(v, v), mf);
    if (w == 0) {
      count = mf; total = tv; sumsq = sv;
    } else {
      count = __fadd_rn(count, mf);
      total = __fadd_rn(total, tv);
      sumsq = __fadd_rn(sumsq, sv);
    }
    if (m) {
      // NaN propagates, as in the reference's max/min reductions
      if (v > mx || v != v) mx = (mx != mx) ? mx : v;
      if (v < mn || v != v) mn = (mn != mn) ? mn : v;
      if (!any) first = v;
      last = v;
      any = true;
    }
  }
  float r = 0.0f;
  switch (op) {
    case OP_COUNT: r = count; break;
    case OP_SUM: r = total; break;
    case OP_MAX: r = isfinite(mx) ? mx : 0.0f; break;
    case OP_MIN: r = isfinite(mn) ? mn : slot_init[i]; break;
    case OP_LAST: r = any ? last : 0.0f; break;
    case OP_FIRST: r = any ? first : 0.0f; break;
    case OP_SUMSQ: r = sumsq; break;
    default: r = 0.0f; break;
  }
  out[i] = r;
}

}  // namespace

extern "C" int feature_window_launch(
    const float* pkts, long long flow_stride, const int* slot_op,
    const int* slot_field, const int* slot_pred, const float* slot_init,
    float* out, long long n_flows, int W, int k, void* stream) {
  const long long n_slots = n_flows * k;
  if (n_slots == 0) return 0;
  const int threads = 256;
  const long long blocks = (n_slots + threads - 1) / threads;
  feature_window_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      pkts, flow_stride, slot_op, slot_field, slot_pred, slot_init, out,
      n_slots, W, k);
  return (int)cudaGetLastError();
}

extern "C" const char* feature_window_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
