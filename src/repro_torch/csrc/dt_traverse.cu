// Partitioned-subtree range-mark matching: the SpliDT subtree lookup.
//
// Replaces the Pallas TPU kernel `dt_traverse_pallas`
// (src/repro/kernels/dt_traverse.py, `_kernel`).  Plain version:
// `repro_torch.kernels.dt_traverse.dt_traverse_blocks_ref`, which this
// kernel must equal exactly.
//
//   marks_j = #{ t : thr[s, j, t] < reg_j }                  per slot
//   hit(l)  = valid[s, l] and lo[s, l, j] <= marks_j <= hi[s, l, j] for all j
//   action  = act[s, first hit l], or -1 when no leaf hits
//
// What bounds it on the H100: device memory, and barely.  Per flow it
// reads k f32 registers and writes one int32 action (20 bytes at k = 4);
// the per-subtree tables are a few hundred bytes.  At 2^20 flows that is
// ~21 MB, a few microseconds at 3.35 TB/s; the compares (k*T + L*k per
// flow) are far below the ALU rate.
//
// Design: flows arrive grouped into SID-homogeneous blocks of `block_b`
// rows (torch glue in kernels/dispatch.py).  One thread block of
// `block_b` threads serves one flow block: it reads its own SID from
// `block_sid[blockIdx.x]` (the Pallas kernel had it scalar-prefetched),
// stages that subtree's thresholds (k, T), leaf bounds (L, k) x 2,
// actions (L) and validity (L) in dynamic shared memory, and then every
// thread matches one flow against the staged tables.  Each flow's marks
// live in shared memory too (k per thread, strided by block_b so the
// threads of a warp hit distinct banks), which keeps k a runtime value.
// The match itself (marks_below, first_hit_leaf) lives in fold.cuh,
// shared with the tick kernel (tick_step.cu).
#include <cuda_runtime.h>

#include "fold.cuh"

namespace {

__global__ void dt_traverse_kernel(
    const int* __restrict__ block_sid,   // (nb,)
    const float* __restrict__ regs,      // (nb * block_b, k)
    const float* __restrict__ thr,       // (S, k, T)
    const int* __restrict__ leaf_lo,     // (S, L, k)
    const int* __restrict__ leaf_hi,     // (S, L, k)
    const int* __restrict__ leaf_action, // (S, L)
    const int* __restrict__ leaf_valid,  // (S, L)
    int* __restrict__ out,               // (nb * block_b,)
    int k, int T, int L) {
  extern __shared__ int smem[];
  float* s_thr = reinterpret_cast<float*>(smem);   // k*T
  int* s_lo = smem + k * T;                         // L*k
  int* s_hi = s_lo + L * k;                         // L*k
  int* s_act = s_hi + L * k;                        // L
  int* s_valid = s_act + L;                         // L
  int* s_marks = s_valid + L;                       // k * blockDim.x

  const int tid = threadIdx.x;
  const int bb = blockDim.x;
  const long long s = block_sid[blockIdx.x];
  for (int i = tid; i < k * T; i += bb) s_thr[i] = thr[s * k * T + i];
  for (int i = tid; i < L * k; i += bb) {
    s_lo[i] = leaf_lo[s * L * k + i];
    s_hi[i] = leaf_hi[s * L * k + i];
  }
  for (int i = tid; i < L; i += bb) {
    s_act[i] = leaf_action[s * L + i];
    s_valid[i] = leaf_valid[s * L + i];
  }
  __syncthreads();

  const long long row = (long long)blockIdx.x * bb + tid;
  const float* r = regs + row * k;
  for (int j = 0; j < k; ++j)
    s_marks[j * bb + tid] = splidt::marks_below(r[j], s_thr + j * T, T);
  const int action = splidt::first_hit_leaf(
      [&](int j) { return s_marks[j * bb + tid]; }, s_lo, s_hi, s_act,
      s_valid, k, L);
  out[row] = action;
}

// dynamic shared memory of one block: the layout of dt_traverse_kernel
long long smem_bytes(int k, int T, int L, int block_b) {
  return 4LL * ((long long)k * T + 2LL * L * k + 2LL * L +
                (long long)k * block_b);
}

}  // namespace

extern "C" int dt_traverse_launch(
    const int* block_sid, const float* regs, const float* thr,
    const int* leaf_lo, const int* leaf_hi, const int* leaf_action,
    const int* leaf_valid, int* out, int n_blocks, int block_b, int k,
    int T, int L, void* stream) {
  if (n_blocks == 0) return 0;
  const long long smem = smem_bytes(k, T, L, block_b);
  // above 227 KB this fails with cudaErrorInvalidValue, returned below
  cudaError_t err = cudaFuncSetAttribute(
      dt_traverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dt_traverse_kernel<<<n_blocks, block_b, (size_t)smem,
                       (cudaStream_t)stream>>>(
      block_sid, regs, thr, leaf_lo, leaf_hi, leaf_action, leaf_valid, out,
      k, T, L);
  return (int)cudaGetLastError();
}

extern "C" const char* dt_traverse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
