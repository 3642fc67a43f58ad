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
// k = 4 that is 1.64 GB of packets for ~0.5 ms at 3.35 TB/s.  On the
// training features (`window_features`, k = 41) one launch covers every
// window of the call, n flows x p windows as n * p flows of the
// contiguous (n, p, W, 6) tensor, all under one shared slot row: at the
// design-space search's 2^17 flows that is ~0.43 GB of windows, ~0.13 ms,
// but there the walk is bound by instruction issue, 41 lanes a flow each
// stepping through W packets (~0.65 ms on the H100, PERF.md).
//
// Design: the window walk of window.cuh, shared with the hop kernel
// (engine_hop.cu).  A CTA stages the windows of its 256 / k flows in
// shared memory, chunk by chunk with 8-byte cp.async copies, double
// buffered, so the next chunk is in flight while this one is walked; each
// packet's predicates are decoded once, and each thread walks one
// (flow, slot) pair from shared memory.  The packet tensor is read in
// place through its flow stride, so the engine's per-hop view
// `win_pkts[:, p]` needs no copy.  Here the slot rows come pre-gathered:
// (B, k) each, one row a flow (`run_looped`, row stride k), or (1, k),
// one row every flow shares (`window_features`, row stride 0, so no
// (B, k) copies are made); the hop kernel reads them from the SID-keyed
// tables.  At k = 41 a CTA's 6 flows use 246 of its 256 threads; a CTA
// of 246 measured the same (PERF.md), so every CTA has kWindowThreads.
#include <cuda_runtime.h>

#include "window.cuh"

namespace {

using namespace splidt;

__global__ void __launch_bounds__(kWindowThreads) feature_window_kernel(
    const float* __restrict__ pkts,     // (B, W, 6), flow stride in floats
    long long flow_stride,
    const int* __restrict__ slot_op,    // (B, k) or (1, k)
    const int* __restrict__ slot_field, // the same
    const int* __restrict__ slot_pred,  // the same
    const float* __restrict__ slot_init,// the same
    long long row_stride,               // k, or 0 for one shared row
    float* __restrict__ out,            // (B, k)
    long long B, int W, int k, int flows, int chunk, int stride) {
  extern __shared__ __align__(16) float smem[];
  const long long b0 = (long long)blockIdx.x * flows;
  const int f = threadIdx.x / k;
  const int j = threadIdx.x - f * k;
  const WindowTile t{pkts, flow_stride, b0,
                     (int)min((long long)flows, B - b0), W, chunk, stride,
                     nullptr, B, nullptr};
  const bool active = f < t.n_flows;
  const long long i = (b0 + f) * row_stride + j;  // the pair's slot row
  const int field = active ? __ldg(slot_field + i) : 0;
  const int pred = active ? __ldg(slot_pred + i) : 0;
  const WindowStats st =
      walk_windows(t, flows, active, f, pred, field, smem);
  if (active)
    out[(b0 + f) * k + j] = st.reg(__ldg(slot_op + i), __ldg(slot_init + i));
}

}  // namespace

// `flows`, `chunk`, `stride`, `smem_bytes` and `carveout` (percent) come
// from kernels/window.py's window_geometry.  `row_stride` is k (a slot
// row a flow) or 0 (one row for all).  Returns a cudaError_t.
extern "C" int feature_window_launch(
    const float* pkts, long long flow_stride, const int* slot_op,
    const int* slot_field, const int* slot_pred, const float* slot_init,
    long long row_stride, float* out, long long B, int W, int k, int flows,
    int chunk, int stride, int smem_bytes, int carveout, void* stream) {
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      feature_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(feature_window_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               carveout);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (B + flows - 1) / flows;
  feature_window_kernel<<<(unsigned)blocks, kWindowThreads, smem_bytes,
                          (cudaStream_t)stream>>>(
      pkts, flow_stride, slot_op, slot_field, slot_pred, slot_init,
      row_stride, out, B, W, k, flows, chunk, stride);
  return (int)cudaGetLastError();
}

extern "C" int window_threads() { return kWindowThreads; }

extern "C" const char* feature_window_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
