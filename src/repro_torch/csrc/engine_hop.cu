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
//           range mark lies in [lo, hi], else -1 (fold.cuh's marks_below,
//           then first_hit_leaf, shared with kernel B and the tick
//           kernel, or on deep subtrees warp_first_hit_leaf);
//   and, unless done[b]: an action >= n_subtrees exits (labels, exit_p,
//   done), any other recirculates (recircs + 1, sid = action).
// When `trace` is given the registers are written there, row p of the
// (P, B, k) trace inside the walk's fetch buffer, and done flows still
// compute their registers with their frozen SID, because the trace holds
// them.  Without a trace a flow done before the hop is not walked at
// all: its window is not staged, it is not matched, its carry is left as
// it is, and it counts as done for `survivors`; a CTA whose flows are
// all done returns after one barrier.  When `survivors` is given (the dense hop only)
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
// carry and 17 MB of registers: ~0.5 ms at 3.35 TB/s.  On `Engine.run`'s
// model the subtree tables (15,360 bytes at S = 30, T = L = 8) are read
// through the read-only data cache and stay in L1.  No SID dispatch: each
// CTA matches whatever SIDs its flows hold, since a flow's match reads
// only its own subtree's rows.  In survivor mode a hop reads the
// survivors' windows and carry only; the empty CTAs cost a launch slot
// and one load of the count each.
//
// The design-space search's models are deep (S <= 1,282, T <= 64,
// L <= 704 at k <= 6): one flow's subtree holds up to 704 x 6 x 8 = 33.8
// KB of leaf bounds, a CTA's flows read as many different subtrees, and
// past hop 0 the tables do not fit L1.  There a scan by one lane a flow
// is a chain of up to L dependent, scattered loads at L2 latency, and it
// set the hop's time (25x its bound on the DSE fleet).  So on deep tables
// the warps take the CTA's flows in turn and match each with the warp's
// 32 lanes together (fold.cuh's warp_first_hit_leaf): a round tests 32
// consecutive leaves, a lane reading its leaf's bounds up to 16 bytes
// at a time (int4 or int2 where k and the rows' alignment allow), so a
// load touches up to four times fewer cache lines.  The host picks the
// match from the table's L (kernels/engine_hop.py,
// WARP_MATCH_MIN_LEAVES).
// The marks read each slot's T thresholds 16 bytes at a time where T
// allows (marks_below_vec): with a different subtree a flow, one-float
// loads made each of a warp's T loads touch 32 cache lines.
//
// Design: a CTA owns 256 / k consecutive flows and walks them as window.cuh
// sets out (8-byte cp.async staging, double buffered, one thread per
// (flow, slot)).  Then each thread marks its own register against its
// slot's T thresholds and the marks meet in shared memory; the flow's
// first hit leaf is found by one thread a flow (kWarpMatch false) or by
// a warp a flow (true), and one thread per flow updates its carry in
// place.
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

// The table row of a SID: -1 wraps to S - 1 as a negative index does in
// the plain version, and anything else outside [0, S) is clamped into it
// as a JAX gather clamps, so nothing is read out of bounds.
__device__ __forceinline__ long long table_row(int sid, int S) {
  const long long row = sid < 0 ? (long long)sid + S : (long long)sid;
  return row < 0 ? 0 : (row >= S ? S - 1 : row);
}

struct Carry {                 // (B,) each, updated in place
  int* sid;
  unsigned char* done;         // torch.bool
  int* labels;
  int* recircs;
  int* exit_p;
};

template <bool kWarpMatch>
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
  // without a trace, flows done before the hop are not walked
  const WindowTile t{pkts, flow_stride, b0,
                     (int)min((long long)flows, n - b0), W, chunk, stride,
                     rows, B, trace == nullptr ? cy.done : nullptr};
  const long long b = f < t.n_flows ? t.flow(f) : -1;
  const bool active = b >= 0;
  // a flow of the tile that is not walked is done already
  const bool skipped = !active && f < t.n_flows && t.at(f) >= 0;
  int* s_marks = reinterpret_cast<int*>(smem + window_smem_floats(t, flows));
  long long row = 0;
  int field = 0, pred = 0;
  if (active) {
    row = table_row(cy.sid[b], tb.S);
    field = __ldg(tb.slot_field + row * k + j);
    pred = __ldg(tb.slot_pred + row * k + j);
  }
  bool done_after = skipped && j == 0;    // set by lane 0 of each flow
  // uniform across the CTA: a CTA with no flow to walk skips to the count
  if (__syncthreads_or(active)) {
    const WindowStats st =
        walk_windows(t, flows, active, f, pred, field, smem);
    if (active) {
      const float reg = st.reg(__ldg(tb.slot_op + row * k + j),
                               __ldg(tb.slot_init + row * k + j));
      if (trace != nullptr) trace[b * k + j] = reg;
      s_marks[threadIdx.x] = marks_below_vec(
          reg, tb.thr + (row * k + j) * tb.T, tb.T);
    }
    __syncthreads();
    int action = -1;
    if constexpr (kWarpMatch) {
      // warp w matches flows w, w + 8, ...; its lane 0 leaves the action
      // in the flow's first mark, which no other warp reads
      for (int ff = threadIdx.x / 32; ff < t.n_flows;
           ff += kWindowThreads / 32) {
        const long long bb = t.flow(ff);  // uniform across the warp
        if (bb < 0) continue;
        const long long r = table_row(cy.sid[bb], tb.S);
        const int a = warp_first_hit_leaf(
            s_marks + ff * k, tb.leaf_lo + r * tb.L * k,
            tb.leaf_hi + r * tb.L * k, tb.leaf_action + r * tb.L,
            tb.leaf_valid + r * tb.L, k, tb.L);
        __syncwarp();                     // every lane has read the marks
        if ((threadIdx.x & 31) == 0) s_marks[ff * k] = a;
      }
      __syncthreads();
      if (active && j == 0) action = s_marks[f * k];
    } else if (active && j == 0) {
      const int* marks = s_marks + f * k;
      action = first_hit_leaf(
          [&](int jj) { return marks[jj]; }, tb.leaf_lo + row * tb.L * k,
          tb.leaf_hi + row * tb.L * k, tb.leaf_action + row * tb.L,
          tb.leaf_valid + row * tb.L, k, tb.L);
    }
    if (active && j == 0) {
      done_after = cy.done[b];
      if (!done_after) {
        if (action >= tb.n_subtrees) {    // exit with a class
          cy.labels[b] = action - tb.n_subtrees;
          cy.exit_p[b] = p;
          cy.done[b] = 1;
          done_after = true;
        } else {                          // recirculate to `action`
          cy.recircs[b] += 1;
          cy.sid[b] = action;
        }
      }
    }
  }
  // uniform across the CTA, so every thread reaches the barrier
  if (survivors != nullptr) {
    const int n_done = __syncthreads_count(done_after);
    if (threadIdx.x == 0 && n_done != 0) atomicSub(survivors, n_done);
  }
}

template <bool kWarpMatch>
cudaError_t launch(const float* pkts, long long flow_stride, long long B,
                   int W, int k, int flows, int chunk, int stride,
                   int smem_bytes, int carveout, int p, const Tables& tb,
                   const Carry& cy, float* trace, const int* rows,
                   const int* n_active, int* survivors,
                   cudaStream_t stream) {
  auto* kernel = engine_hop_kernel<kWarpMatch>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  if (err != cudaSuccess) return err;
  const long long blocks = (B + flows - 1) / flows;
  kernel<<<(unsigned)blocks, kWindowThreads, smem_bytes, stream>>>(
      pkts, flow_stride, B, W, k, flows, chunk, stride, p, tb, cy, trace,
      rows, n_active, survivors);
  return cudaGetLastError();
}

}  // namespace

// The geometry comes from kernels/window.py's window_geometry; its shared
// memory holds the staging ring, the predicate words and flows * k marks,
// and `carveout` (percent) leaves L1 room for the copies in flight.
// `warp_match` picks the match: nonzero, a warp a flow (deep subtrees);
// zero, one thread a flow.  `trace` may be null; `rows` and `n_active`
// are both null (the dense hop) or both set (survivor mode); `survivors`
// may be set on a dense hop only.  Returns a cudaError_t.
extern "C" int engine_hop_launch(
    const float* pkts, long long flow_stride, long long B, int W, int k,
    int flows, int chunk, int stride, int smem_bytes, int carveout, int p,
    int warp_match, const int* slot_op, const int* slot_field,
    const int* slot_pred, const float* slot_init, const float* thr,
    const int* leaf_lo, const int* leaf_hi, const int* leaf_action,
    const int* leaf_valid, int S, int T, int L, int n_subtrees, int* sid,
    unsigned char* done, int* labels, int* recircs, int* exit_p,
    float* trace, const int* rows, const int* n_active, int* survivors,
    void* stream) {
  if (B == 0) return 0;
  if ((rows == nullptr) != (n_active == nullptr)
      || (rows != nullptr && survivors != nullptr))
    return (int)cudaErrorInvalidValue;
  const Tables tb{slot_op, slot_field, slot_pred, slot_init, thr, leaf_lo,
                  leaf_hi, leaf_action, leaf_valid, S, T, L, n_subtrees};
  const Carry cy{sid, done, labels, recircs, exit_p};
  auto* go = warp_match ? &launch<true> : &launch<false>;
  return (int)go(pkts, flow_stride, B, W, k, flows, chunk, stride,
                 smem_bytes, carveout, p, tb, cy, trace, rows, n_active,
                 survivors, (cudaStream_t)stream);
}

extern "C" const char* engine_hop_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
