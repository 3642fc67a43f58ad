// The window walk shared by kernel A (feature_window.cu) and the hop
// kernel (engine_hop.cu): a CTA stages its flows' packet windows in
// shared memory and each thread walks one (flow, slot) pair's window, in
// order, into that slot's register.
//
// The math is `feature_window_ref`'s (src/repro_torch/kernels/ref.py),
// which both kernels must equal bit for bit (docs/PARITY.md §1):
// COUNT/SUM/SUMSQ are the strict left-to-right `ordered_wsum` chains,
// MAX/MIN propagate NaN and fall back to 0 / the slot's init where no
// finite value was seen, FIRST/LAST fall back to 0 on an empty window.
// The chains are spelled __fmul_rn/__fadd_rn and the build passes
// -fmad=false, so nothing is contracted into an FMA.  They start at -0.0,
// the additive identity: -0.0 + x is x for every x, so the chain equals
// `ordered_wsum`'s, which starts at packet 0's term.  A chain started at
// +0.0 would not: a first term of -0.0 (a SUM over packets whose field is
// -0.0, or a masked negative value) would turn into +0.0.
//
// The staging.  A CTA of kWindowThreads threads owns `flows` consecutive
// flows and walks their windows in chunks of `chunk` packets (about 12 KB
// a chunk of the tile).  Chunks are copied with cp.async into a ring of
// kStages shared buffers, kStages - 1 chunks ahead of the one being
// walked.  The copies are 8 bytes wide because the engine reads each
// hop's windows through a strided view: at W = 65 and 3 windows a flow the
// flow stride is 4,680 bytes, so every other flow's window starts at 8 mod
// 16, where a 16-byte copy (or a TMA bulk copy) needs an unaligned head
// and tail.  Each flow gets `tpf` = blockDim.x / flows copying threads, so
// a warp's copy instruction moves one run of tpf 8-byte words per flow
// (whole 32-byte sectors at k = 4) and no thread divides.  On the H100, at
// the main path's view, neither 16-byte L2-only copies (with the head and
// tail copied apart), nor a ring of three or four buffers, nor larger
// chunks read the windows faster than this.  8-byte copies pass through
// L1 and slow down when the CTAs' shared memory leaves L1 too little, so
// the launchers ask for a carveout that keeps L1 room (kernels/window.py).
// In shared memory a flow's chunk takes `stride` floats, 6 * chunk padded
// to an odd number of 8-byte words, so neighbouring flows start in
// different banks.  The geometry (flows,
// chunk, stride, bytes) is computed on the host by kernels/window.py's
// `window_geometry`, which the tests check on the CPU.
//
// The walk.  Once a chunk has landed, each staged packet's predicate codes
// are decoded once into a word of bits (pred_bits), shared by the k lanes
// of its flow.  Thread t owns the pair (flow t / k, slot t % k), so a warp
// covers 32 / k flows at k <= 32, and a lane's step per packet is two
// shared-memory loads (the bits, its field) and the statistics' few
// compares and adds, with no branch that depends on the slot.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "packet_fields.cuh"

namespace splidt {

constexpr int kWindowThreads = 256;  // kernels/window.py WINDOW_THREADS
constexpr int kStages = 2;           // kernels/window.py STAGES

// A packet's predicate bits: bit `pred` is set where pred_mask(pk, pred)
// holds, for every code 0..PRED_URG (unknown codes match nothing).
// Decoded once per staged packet and shared by the k lanes of its flow.
__device__ __forceinline__ unsigned pred_bits(const float* __restrict__ pk) {
  if (!(pk[PKT_VALID] > 0.0f)) return 0u;
  const float direc = pk[PKT_DIR];
  const int flags = (int)pk[PKT_FLAGS];  // float -> int32 truncation
  // PRED_SYN .. PRED_URG test the flag bits 1, 2, 4, .., 32 in order
  static_assert(PRED_URG - PRED_SYN == 5, "six flag predicates");
  return (1u << PRED_TRUE) | (direc == 0.0f ? 1u << PRED_FWD : 0u) |
         (direc == 1.0f ? 1u << PRED_BWD : 0u) |
         ((unsigned)(flags & 63) << PRED_SYN);
}

// One slot's running window statistics.
struct WindowStats {
  float count, total, sumsq, mx, mn, first, last;
  bool any;

  __device__ __forceinline__ void init() {
    count = total = sumsq = -0.0f;  // the identity: see the file comment
    mx = -INFINITY;
    mn = INFINITY;
    first = last = 0.0f;
    any = false;
  }

  // packet w of the window: predicate bit m, field value v
  __device__ __forceinline__ void step(bool m, float v) {
    const float mf = m ? 1.0f : 0.0f;
    count = __fadd_rn(count, mf);
    total = __fadd_rn(total, __fmul_rn(v, mf));
    sumsq = __fadd_rn(sumsq, __fmul_rn(__fmul_rn(v, v), mf));
    if (m) {
      // NaN propagates, as in the reference's max/min reductions
      if (v > mx || v != v) mx = (mx != mx) ? mx : v;
      if (v < mn || v != v) mn = (mn != mn) ? mn : v;
      if (!any) first = v;
      last = v;
      any = true;
    }
  }

  __device__ __forceinline__ float reg(int op, float init) const {
    switch (op) {
      case OP_COUNT: return count;
      case OP_SUM: return total;
      case OP_MAX: return isfinite(mx) ? mx : 0.0f;
      case OP_MIN: return isfinite(mn) ? mn : init;
      case OP_LAST: return any ? last : 0.0f;
      case OP_FIRST: return any ? first : 0.0f;
      case OP_SUMSQ: return sumsq;
      default: return 0.0f;
    }
  }
};

__device__ __forceinline__ void cp_async8(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The CTA's flows and how they are staged: positions [b0, b0 + n_flows)
// of the launch, which are the flows themselves, or with `rows` the flows
// rows[b0], rows[b0 + 1], ... (the hop kernel's survivor mode, where rows
// is the survivor-first permutation of kernels/compaction.py).  A row
// outside [0, n_rows) names no flow: its position stays empty, so nothing
// is read or written out of bounds.  With `skip` (the hop kernel's done
// flags, when no trace is asked for) a flow whose flag is set is not
// walked: its window is neither staged nor read.
struct WindowTile {
  const float* pkts;     // (B, W, 6) f32, the (W, 6) block of a flow dense
  long long flow_stride; // floats between two flows' windows (even)
  long long b0;          // first position of the tile
  int n_flows;           // positions of the tile that may hold a flow
  int W, chunk, stride;  // packets a window, a chunk; floats a staged flow
  const int* rows;       // position -> flow, or null for the identity
  long long n_rows;      // with rows: the flows B it may name
  const unsigned char* skip;  // (B,) flags of flows not walked, or null

  // the flow at position b0 + f (f < n_flows), or -1 for an empty one
  __device__ __forceinline__ long long at(int f) const {
    if (rows == nullptr) return b0 + f;
    const long long r = rows[b0 + f];
    return r >= 0 && r < n_rows ? r : -1;
  }

  // the flow walked at position b0 + f, or -1 where none is
  __device__ __forceinline__ long long flow(int f) const {
    const long long r = at(f);
    return r >= 0 && skip != nullptr && skip[r] ? -1 : r;
  }
};

// Floats walk_windows uses at the start of its shared memory.
__device__ __forceinline__ int window_smem_floats(const WindowTile& t,
                                                  int flows) {
  const int n_chunks = (t.W + t.chunk - 1) / t.chunk;
  return min(n_chunks, kStages) * flows * t.stride + flows * (t.chunk | 1);
}

// Walk the tile's windows.  Every thread of the CTA calls this (it
// synchronises); a thread with `active` walks flow `f` of the tile (a
// position that holds a flow) under the slot's predicate and field and
// returns its statistics.  `smem`
// (16-byte aligned) holds the ring, min(chunks, kStages) buffers of
// flows * stride floats, then flows rows of `chunk | 1` predicate words
// (an odd row, so the flows of a warp read distinct banks).
__device__ __forceinline__ WindowStats walk_windows(const WindowTile& t,
                                                    int flows, bool active,
                                                    int f, int pred,
                                                    int field, float* smem) {
  const int n_chunks = (t.W + t.chunk - 1) / t.chunk;
  const int buf = flows * t.stride;       // floats a staging buffer
  unsigned* bits = reinterpret_cast<unsigned*>(
      smem + window_smem_floats(t, flows) - flows * (t.chunk | 1));
  const int brow = t.chunk | 1;           // words a flow's predicate row
  // the copies and the decode: flow sf of the tile, thread sr of its tpf
  const int tpf = blockDim.x / flows;
  const int sf = threadIdx.x / tpf;
  const int sr = threadIdx.x - sf * tpf;
  const long long sflow = sf < t.n_flows ? t.flow(sf) : -1;
  const bool stager = sflow >= 0;
  // a window is one dense run of W x 6 floats wherever its flow lies,
  // so the copies are the same in survivor mode
  const float* src = t.pkts + (stager ? sflow : t.b0) * t.flow_stride;
  float* const srow = smem + sf * t.stride;
  auto stage = [&](int c) {               // issue chunk c's copies
    if (stager) {
      const int w0 = c * t.chunk;
      const int nf = PKT_NFIELDS * min(t.chunk, t.W - w0);
      const float* from = src + (long long)w0 * PKT_NFIELDS;
      float* dst = srow + (c % kStages) * buf;
      for (int o = 2 * sr; o < nf; o += 2 * tpf) cp_async8(dst + o, from + o);
    }
    cp_async_commit();
  };
  // the lane: its predicate bit, its field (an out-of-range code reads
  // field 0 and gives 0.0)
  const unsigned pbit = (pred >= 0 && pred <= PRED_URG) ? 1u << pred : 0u;
  const bool field_ok = field >= 0 && field < PKT_NFIELDS;
  const int lrow = f * t.stride + (field_ok ? field : 0);
  WindowStats st;
  st.init();
  // one commit group a chunk, empty past the last, so that after the
  // group of chunk c + kStages - 1 at most kStages - 1 are pending
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) stage(c); else cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    // its buffer held chunk c - 1, walked by every thread before the
    // barrier that ended the last round
    if (c + kStages - 1 < n_chunks) stage(c + kStages - 1);
    else cp_async_commit();
    cp_async_wait<kStages - 1>();         // chunk c has landed
    __syncthreads();                      // ... for every thread's copies
    const float* cur = smem + (c % kStages) * buf;
    const int n = min(t.chunk, t.W - c * t.chunk);
    if (stager)
      for (int w = sr; w < n; w += tpf)
        bits[sf * brow + w] = pred_bits(srow + (c % kStages) * buf +
                                        w * PKT_NFIELDS);
    __syncthreads();                      // the predicate words are in
    if (active) {
      const float* s = cur + lrow;
      const unsigned* b = bits + f * brow;
      for (int w = 0; w < n; ++w) {
        const float v = s[w * PKT_NFIELDS];
        st.step((b[w] & pbit) != 0u, field_ok ? v : 0.0f);
      }
    }
    __syncthreads();                      // buffer and bits are free
  }
  return st;
}

}  // namespace splidt
