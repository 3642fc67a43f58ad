// One hop of the engine's partition walk, in one launch: the register
// fill, the range match and the walk's recirculation bookkeeping.
//
// Replaces, on `Engine.run`'s card route, the per-hop pair of the Pallas
// TPU kernels `feature_window_pallas` (src/repro/kernels/feature_window.py)
// and `dt_traverse_pallas` (src/repro/kernels/dt_traverse.py) that the JAX
// walk runs behind the in-jit SID dispatch (`pallas_step`), together with
// `_hop_update` (src/repro/core/inference.py).  Plain version:
// `repro_torch.kernels.ref.engine_hop_ref` (`fused_step` then
// `hop_update`), which this kernel must equal bit for bit on the
// registers and on every carry field (docs/PARITY.md §1-§3).
//
// For each flow b of the hop's window view `pkts` (B, W, 6):
//   row   = sid[b], -1 wrapped to S - 1 as a negative index is in the
//           plain version, clamped into [0, S) as a JAX gather clamps, so
//           nothing is read out of bounds;
//   regs  = the window walk (window.cuh) under the slot rows of `row`,
//           read from the (S, k) tables: no (B, k) gather tensors exist;
//   action= the first valid leaf of subtree `row` whose every slot's
//           range mark lies in [lo, hi], else -1 (fold.cuh's marks_below
//           and first_hit_leaf, shared with kernel B and the tick kernel);
//   and, unless done[b]: an action >= n_subtrees exits (labels, exit_p,
//   done), any other recirculates (recircs + 1, sid = action).
// In the dense walk done flows still compute their registers with their
// frozen SID, because the trace holds them.  When `trace` is given the
// registers are written there, row p of the (P, B, k) trace inside the
// walk's fetch buffer.  When `survivors` is given (the dense hop only)
// the launch subtracts from it the flows done after the hop: the walk
// starts the word at B, so it then holds the flows still walking when the
// next hop starts.  Each CTA counts its own done flows with
// __syncthreads_count and subtracts them with one atomic, so no reduction
// kernel follows the hop.
//
// Survivor mode (early-exit compaction, kernels/compaction.py): with
// `rows`, the survivor-first permutation of the walk's `done` flags, and
// `n_active`, the survivor count, both on the device, position i < *n_active
// of the launch is flow rows[i] and every later position is empty; a
// count above B reads as B and a row outside [0, B) leaves its position
// empty, so no input makes the kernel read or write out of bounds.  The
// grid stays the dense one and CTAs past the survivors return at once, so
// no host sync sizes the launch and the walk can be captured in a CUDA
// graph.  A survivor's window is read in place through its flow stride:
// it is one dense run of W x 6 floats wherever the flow lies, so the
// cp.async staging is unchanged and no window is gathered into a new
// buffer.  Only the named flows' carry fields and trace rows are written
// (rows and n_active are compact_perm of the carry's done flags, so those
// are the survivors); every other trace row is left as it is.  The walk
// zeroes the trace rows once before the hops, so a hop's row holds zeros
// for the flows done before it, as the plain compacted walk writes them.  Every step is per flow, so this equals the plain compacted walk
// (and the dense walk's verdicts) bit for bit.
//
// What bounds it on the H100: device memory.  At B = 2^20, W = 65, k = 4 a
// hop reads 1.64 GB of windows and ~21 MB of carry and writes ~13 MB of
// carry and 17 MB of registers: ~0.5 ms at 3.35 TB/s.  The subtree tables
// (15,360 bytes at S = 30, T = L = 8) are read through the read-only data
// cache and stay in L1.  No SID dispatch: each CTA matches whatever SIDs
// its flows hold, since a flow's match reads only its own subtree's rows.
// In survivor mode a hop reads the survivors' windows and carry only; the
// empty CTAs cost a launch slot and one load of the count each.
//
// Design: a CTA owns 256 / k consecutive flows and walks them as window.cuh
// sets out (8-byte cp.async staging, double buffered, one thread per
// (flow, slot)).  Then each thread marks its own register against its
// slot's T thresholds, the marks meet in shared memory, and one thread per
// flow finds the first hit leaf and updates the flow's carry in place.
#include <cuda_runtime.h>

#include "fold.cuh"
#include "window.cuh"

namespace {

using namespace splidt;

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

struct Carry {                 // (B,) each, updated in place
  int* sid;
  unsigned char* done;         // torch.bool
  int* labels;
  int* recircs;
  int* exit_p;
};

__global__ void __launch_bounds__(kWindowThreads) engine_hop_kernel(
    const float* __restrict__ pkts, long long flow_stride, long long B,
    int W, int k, int flows, int chunk, int stride, int p, Tables tb,
    Carry cy, float* __restrict__ trace, const int* __restrict__ rows,
    const int* __restrict__ n_active, int* __restrict__ survivors) {
  extern __shared__ __align__(16) float smem[];
  const long long b0 = (long long)blockIdx.x * flows;
  // survivor mode: only the first *n_active positions (at most B) may
  // hold a flow
  const long long n = rows != nullptr ? min((long long)*n_active, B) : B;
  if (b0 >= n) return;                    // the whole CTA, before a barrier
  const int f = threadIdx.x / k;
  const int j = threadIdx.x - f * k;
  const WindowTile t{pkts, flow_stride, b0,
                     (int)min((long long)flows, n - b0), W, chunk, stride,
                     rows, B};
  const long long b = f < t.n_flows ? t.flow(f) : -1;
  const bool active = b >= 0;
  int* s_marks = reinterpret_cast<int*>(smem + window_smem_floats(t, flows));
  long long row = 0;
  int field = 0, pred = 0;
  if (active) {
    const int sid = cy.sid[b];
    row = sid < 0 ? (long long)sid + tb.S : (long long)sid;
    row = row < 0 ? 0 : (row >= tb.S ? tb.S - 1 : row);
    field = __ldg(tb.slot_field + row * k + j);
    pred = __ldg(tb.slot_pred + row * k + j);
  }
  const WindowStats st =
      walk_windows(t, flows, active, f, pred, field, smem);
  if (active) {
    const float reg = st.reg(__ldg(tb.slot_op + row * k + j),
                             __ldg(tb.slot_init + row * k + j));
    if (trace != nullptr) trace[b * k + j] = reg;
    s_marks[threadIdx.x] = marks_below(reg, tb.thr + (row * k + j) * tb.T,
                                       tb.T);
  }
  __syncthreads();
  bool done_after = false;                // set by lane 0 of each flow
  if (active && j == 0) {
    const int* marks = s_marks + f * k;
    const int action = first_hit_leaf(
        [&](int jj) { return marks[jj]; }, tb.leaf_lo + row * tb.L * k,
        tb.leaf_hi + row * tb.L * k, tb.leaf_action + row * tb.L,
        tb.leaf_valid + row * tb.L, k, tb.L);
    done_after = cy.done[b];
    if (!done_after) {
      if (action >= tb.n_subtrees) {      // exit with a class
        cy.labels[b] = action - tb.n_subtrees;
        cy.exit_p[b] = p;
        cy.done[b] = 1;
        done_after = true;
      } else {                            // recirculate to `action`
        cy.recircs[b] += 1;
        cy.sid[b] = action;
      }
    }
  }
  // uniform across the CTA, so every thread reaches the barrier
  if (survivors != nullptr) {
    const int n_done = __syncthreads_count(done_after);
    if (threadIdx.x == 0 && n_done != 0) atomicSub(survivors, n_done);
  }
}

}  // namespace

// The geometry comes from kernels/window.py's window_geometry; its shared
// memory holds the staging ring, the predicate words and flows * k marks,
// and `carveout` (percent) leaves L1 room for the copies in flight.
// `trace` may be null; `rows` and `n_active` are both null (the dense hop)
// or both set (survivor mode); `survivors` may be set on a dense hop
// only.  Returns a cudaError_t.
extern "C" int engine_hop_launch(
    const float* pkts, long long flow_stride, long long B, int W, int k,
    int flows, int chunk, int stride, int smem_bytes, int carveout, int p,
    const int* slot_op, const int* slot_field, const int* slot_pred,
    const float* slot_init, const float* thr, const int* leaf_lo,
    const int* leaf_hi, const int* leaf_action, const int* leaf_valid, int S,
    int T, int L, int n_subtrees, int* sid, unsigned char* done, int* labels,
    int* recircs, int* exit_p, float* trace, const int* rows,
    const int* n_active, int* survivors, void* stream) {
  if (B == 0) return 0;
  if ((rows == nullptr) != (n_active == nullptr)
      || (rows != nullptr && survivors != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      engine_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(engine_hop_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               carveout);
  if (err != cudaSuccess) return (int)err;
  const Tables tb{slot_op, slot_field, slot_pred, slot_init, thr, leaf_lo,
                  leaf_hi, leaf_action, leaf_valid, S, T, L, n_subtrees};
  const Carry cy{sid, done, labels, recircs, exit_p};
  const long long blocks = (B + flows - 1) / flows;
  engine_hop_kernel<<<(unsigned)blocks, kWindowThreads, smem_bytes,
                      (cudaStream_t)stream>>>(
      pkts, flow_stride, B, W, k, flows, chunk, stride, p, tb, cy, trace,
      rows, n_active, survivors);
  return (int)cudaGetLastError();
}

extern "C" const char* engine_hop_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
