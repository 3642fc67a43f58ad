// The chunked gated linear recurrence of the LM prototype (RWKV6 time-mix).
//
// Replaces the Pallas TPU kernel `chunk_scan_pallas` (`_kernel`) in
// src/repro/kernels/chunk_scan.py.  Plain version:
// `chunk_scan_chunked_ref` in src/repro_torch/kernels/ref.py, which this
// kernel must match within the tolerances of tests/test_kernels.py (o within
// 2e-4 * max(|o|, 1), the state within 3e-4); it is not held to bits.
//
// Per head row bh, with chunks of C steps:
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t
//   GLA form:   o_t = q_t S_t
//   bonus form: o_t = q_t (S_{t-1} + diag(u) k_t^T v_t)      (RWKV6)
// Each chunk c computes, as the TPU kernel does:
//   cum   = inclusive prefix of log(max(w, 1e-38)) over the chunk,
//   m     = cum[C/2] (the mid-chunk reference), cum_q = cum - log w with
//           the bonus, cum without,
//   att   = (q exp(clip(cum_q - m, +-45))) (k exp(clip(m - cum, +-45)))^T,
//           causal (strictly causal with the bonus),
//   o     = att v [+ (q.u.k) v] + (q exp(cum_q)) S_in[c],
//   S_in[c+1] = exp(total_c) S_in[c] + dS_c,
//   dS_c  = (k exp(total_c - cum))^T v,  total_c = cum[C-1].
// The +-45 clip is kept exactly: it is part of the reference's numbers.
//
// Only the (dk x dv) state recurrence is sequential across chunks, so a
// call of C >= 2 is three launches on one stream, with every intermediate
// in one scratch tensor the wrapper allocates (torch.empty; nothing is
// allocated or synchronised here, so a call can be captured in a CUDA
// graph):
//   A  chunk_prep_kernel, one CTA per (head row, chunk, dv tile): cum once;
//      the output kernel's operands q_in, q exp(cum_q), k_in and q.u.k;
//      total_c and dS_c;
//   B  state_pass_kernel, one thread per 4 state elements: walks the
//      chunks in order, S_in[c] over dS_c in place, and the final state;
//   C  chunk_out_kernel, one CTA per (head row, chunk, 64-row tile, dv
//      tile): att once for all dv columns, then o = att v + (q exp(cum_q))
//      S_in[c] + (q.u.k) v.
// A and C are not one launch: C reads S_in[c], which needs every earlier
// chunk's A, and a grid-wide barrier would need all CTAs resident.  A
// decode step (C == 1) is one launch of step_kernel, the chunked
// arithmetic at C = 1 on the CUDA cores: o = q S_0 + (q.u.k) v (bonus) or
// (q exp(log w)) S_0 + (q.k) v (GLA), S_1 = exp(log w) S_0 + k^T v.
//
// What bounds it on the H100: at rwkv6-1.6b's prefill shape (B*H = 32,
// T = 1024, dk = dv = 64, C = 128) the four products are 1.08 GFLOP and
// the traffic 43 MB, so bytes (0.0128 ms) lead split-TF32 operations
// (0.0066 ms).  What holds it back in practice is latency and
// instruction throughput within each CTA: staging a chunk (cp.async,
// 16-byte copies, into 104 KiB of shared memory, so that two CTAs of 16
// warps share an SM), the prefix scan and the exponentials, each phase
// behind a barrier.
//
// The products run on the tensor cores, mma.sync.m16n8k8 with TF32
// operands, in split TF32 ("3xTF32"): each f32 operand x = hi + lo, hi
// being x cut to TF32's 10 mantissa bits and lo = x - hi exactly, and a
// product is lo*hi + hi*lo + hi*hi accumulated in f32: about 2^-20 of
// each operand, close to f32.  1xTF32 alone misses the tolerance (o error
// ~4e-4 of scale, state ~4e-3); tests/test_torch_lm.py emulates both on
// the CPU.  Causal tiles above the diagonal are skipped, the diagonal
// tiles masked.  Deterministic: no atomics and fixed orders, so equal
// inputs give equal bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // chunk-parallel kernels: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPassThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kMaxDk = 128;
constexpr int kRowTile = 64;   // rows of o per CTA of chunk_out_kernel
constexpr int kMaxDvTile = 64; // columns of v, o and S per CTA
constexpr int kStepRows = 8;   // row groups of step_kernel

__device__ __forceinline__ float clip45(float x) {
  return fminf(fmaxf(x, -45.0f), 45.0f);
}

__device__ __forceinline__ float log_decay(float w) {
  return logf(fmaxf(w, 1e-38f));
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// row strides of shared-memory operands: ld4 rows are read by the 8 lane
// groups of an mma fragment at 4 consecutive columns (stride = 4 mod 32),
// ld8 rows at 8 consecutive columns by 4 lanes (stride = 8 mod 32), so a
// fragment load touches 32 banks
__host__ __device__ inline int ld4(int n) {
  return n + ((4 - n) % 32 + 32) % 32;
}
__host__ __device__ inline int ld8(int n) {
  return n + ((8 - n) % 32 + 32) % 32;
}

// ---------------------------------------------------------------------------
// split-TF32 mma.sync
// ---------------------------------------------------------------------------
// x = hi + lo exactly: hi is x cut to TF32's 10 mantissa bits; lo, the
// rest, goes to the tensor core whole and is read there as TF32 (within
// 2^-10 of lo, so within 2^-20 of x)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x 8) split into hi and lo.
struct FragA {
  uint32_t hi[4], lo[4];
};

// the A fragment at (m0, k0) of a row-major array
__device__ __forceinline__ FragA load_a(const float* s, int ld, int m0,
                                        int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = s + (m0 + g) * ld + k0 + t;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * ld], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * ld + 4], f.hi[3], f.lo[3]);
  return f;
}

// the A fragment at (m0, k0) of the transpose of a row-major array
// (A[m][k] = s[k][m])
__device__ __forceinline__ FragA load_at(const float* s, int ld, int m0,
                                         int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = s + (k0 + t) * ld + m0 + g;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8], f.hi[1], f.lo[1]);
  split(p[4 * ld], f.hi[2], f.lo[2]);
  split(p[4 * ld + 8], f.hi[3], f.lo[3]);
  return f;
}

// acc[j] += A B_j for the first nv of N B fragments (b[j] = its two
// elements), in 3xTF32: lo*hi, then hi*lo, then hi*hi, each pass over all
// fragments so that the dependent products of one accumulator are apart
template <int N>
__device__ __forceinline__ void mma3(float (&acc)[N][4], const FragA& a,
                                     const float (&b)[N][2], int nv) {
  uint32_t bh[N][2], bl[N][2];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    split(b[j][0], bh[j][0], bl[j][0]);
    split(b[j][1], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < nv) mma_tf32(acc[j], a.lo, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < nv) mma_tf32(acc[j], a.hi, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < nv) mma_tf32(acc[j], a.hi, bh[j][0], bh[j][1]);
}

// ---------------------------------------------------------------------------
// staging and the prefix scan
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [0, rows_p) x columns [0, cols_p) of s (stride ld) from g (row
// stride gld): g's element where r < rows and c < cols, else 0.  vec: g
// and gld allow 16-byte copies (cols_p is a multiple of 4).
__device__ __forceinline__ void stage(float* s, int ld, const float* g,
                                      long long gld, int rows, int cols,
                                      int rows_p, int cols_p, bool vec) {
  const int nq = cols_p / 4;
  for (int idx = threadIdx.x; idx < rows_p * nq; idx += kThreads) {
    const int r = idx / nq, c = 4 * (idx % nq);
    float* d = s + r * ld + c;
    if (vec && r < rows && c + 4 <= cols) {
      cp_async16(d, g + r * gld + c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = r < rows && c + e < cols ? g[r * gld + c + e] : 0.0f;
    }
  }
}

// s (rows x dk, stride ld) holds decays; replace them by the inclusive
// prefix over rows of log(max(w, 1e-38)).  The logs are taken in parallel
// (rows [r0, r1) also keep theirs in lw, stride ldl, row r - r0); then
// one thread per column and segment of rows sums its segment through
// registers and adds the totals of the segments before it.  Ends with
// __syncthreads.
__device__ void log_prefix(float* s, int ld, int rows, int dk, float* lw,
                           int ldl, int r0, int r1) {
  const int tid = threadIdx.x;
  const int rstep = kThreads / dk;
  const int i = tid % dk;
  if (tid < rstep * dk) {
    for (int t = tid / dk; t < rows; t += rstep) {
      const float l = log_decay(s[t * ld + i]);
      s[t * ld + i] = l;
      if (lw != nullptr && t >= r0 && t < r1) lw[(t - r0) * ldl + i] = l;
    }
  }
  __syncthreads();
  const int nseg = max(1, min(rstep, rows));
  const int seg_len = (rows + nseg - 1) / nseg;
  const int sg = tid / dk;
  const bool active = sg < nseg;
  const int t_lo = sg * seg_len, t_hi = min(rows, t_lo + seg_len);
  if (active) {
    float acc = 0.0f;
    for (int t = t_lo; t < t_hi; t += 8) {
      float x[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        x[e] = t + e < t_hi ? s[(t + e) * ld + i] : 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc += x[e];
        if (t + e < t_hi) s[(t + e) * ld + i] = acc;
      }
    }
  }
  __syncthreads();
  float off = 0.0f;
  if (active) {
    for (int p = 0; p < sg; ++p) {
      const int te = min(rows, (p + 1) * seg_len) - 1;
      if (te >= p * seg_len) off += s[te * ld + i];
    }
  }
  __syncthreads();
  if (active && sg > 0) {
    for (int t = t_lo; t < t_hi; ++t) s[t * ld + i] += off;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// A: per (row, chunk, dv tile) -- cum once; the output kernel's operands
// q_in, q exp(cum_q), k_in and the bonus diagonal; total_c and dS_c
// ---------------------------------------------------------------------------
struct PrepLayout {
  int ldk, ldv, cum, k, v, floats;
};

// region v holds log w, then the terms of q.u.k, then v
__host__ __device__ inline PrepLayout prep_layout(int C, int dkp, int dvt) {
  PrepLayout L;
  const int C8 = round_up(C, 8);
  L.ldk = ld8(dkp);
  L.ldv = ld8(dvt);
  L.cum = 0;
  L.k = L.cum + C * dkp;
  L.v = L.k + C8 * L.ldk;
  L.floats = L.v + max(C8 * L.ldv, C * dkp);
  return L;
}

template <bool BONUS>
__global__ void __launch_bounds__(kThreads, 2) chunk_prep_kernel(
    const float* __restrict__ q,    // (BH, T, dk)
    const float* __restrict__ k,    // (BH, T, dk)
    const float* __restrict__ v,    // (BH, T, dv)
    const float* __restrict__ w,    // (BH, T, dk)
    const float* __restrict__ u,    // (BH, dk), read if BONUS
    float* __restrict__ q_in,       // (BH, T, dk) out: q exp(clip(cum_q - m))
    float* __restrict__ q_st,       // (BH, T, dk) out: q exp(cum_q)
    float* __restrict__ k_in,       // (BH, T, dk) out: k exp(clip(m - cum))
    float* __restrict__ diag,       // (BH, T) out: q.u.k, if BONUS
    float* __restrict__ ds,         // (BH, nC, dk, dv) out: dS_c
    float* __restrict__ tot,        // (BH, nC, dk) out: total_c
    int T, int dk, int dv, int C, int dkp, int dvt, int vec_k, int vec_v) {
  extern __shared__ __align__(16) float smem[];
  const long long bc = blockIdx.x;  // bh * nC + c
  const long long bh = bc / (T / C);
  const int j0 = blockIdx.y * dvt;
  const int nj = min(dvt, dv - j0);
  const bool first = blockIdx.y == 0;  // the dv tile that writes operands
  const int C8 = round_up(C, 8);
  const PrepLayout L = prep_layout(C, dkp, dvt);
  float* sCum = smem + L.cum;
  float* sK = smem + L.k;
  float* sL = smem + L.v;
  float* sV = smem + L.v;
  const long long row0 = bc * C;  // (bh * T + c * C)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage(sCum, dkp, w + row0 * dk, dk, C, dk, C, dkp, vec_k);
  stage(sK, L.ldk, k + row0 * dk, dk, C, dk, C8, dkp, vec_k);
  cp_async_wait();
  __syncthreads();

  log_prefix(sCum, dkp, C, dk, BONUS ? sL : nullptr, dkp, 0, C);

  // one column per thread: the operands and the terms of q.u.k (first dv
  // tile only) and, in place of k, kd = k exp(total - cum)
  {
    const int rstep = kThreads / dkp, i = tid % dkp;
    if (tid < rstep * dkp) {
      const bool col = i < dk;
      const float m = col ? sCum[(C / 2) * dkp + i] : 0.0f;
      const float total = col ? sCum[(C - 1) * dkp + i] : 0.0f;
      const float u_i = BONUS && first && col ? u[bh * dk + i] : 0.0f;
      for (int t = tid / dkp; t < C8; t += rstep) {
        float* pk = sK + t * L.ldk + i;
        if (t < C && col) {
          const float cum = sCum[t * dkp + i];
          const float kv = *pk;
          if (first) {
            const long long g = (row0 + t) * dk + i;
            const float qv = q[g];
            float cum_q = cum;
            if (BONUS) {
              // log w is read, then its slot takes (q u k)'s term
              cum_q = cum - sL[t * dkp + i];
              sL[t * dkp + i] = (qv * u_i) * kv;
            }
            q_in[g] = qv * expf(clip45(cum_q - m));
            q_st[g] = qv * expf(cum_q);
            k_in[g] = kv * expf(clip45(m - cum));
          }
          *pk = kv * expf(total - cum);
        } else {
          *pk = 0.0f;
        }
      }
      if (first && col && tid < dkp)
        tot[bc * dk + i] = total;
    }
  }
  __syncthreads();
  // the bonus diagonal q.u.k: a warp per row sums the row's terms
  if (BONUS && first) {
    for (int t = warp; t < C; t += kWarps) {
      float d = 0.0f;
      for (int i = lane; i < dk; i += 32) d += sL[t * dkp + i];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (lane == 0) diag[row0 + t] = d;
    }
    __syncthreads();
  }
  stage(sV, L.ldv, v + row0 * dv + j0, dv, C, nj, C8, dvt, vec_v);
  cp_async_wait();
  __syncthreads();

  // dS (dkp x dvt) = kd^T v: a warp takes one 16-row tile and two 8-column
  // tiles
  const int g = lane >> 2, tq = lane & 3;
  const int nmt = dkp / 16, nnt = dvt / 8, ngrp = (nnt + 1) / 2;
  float* dsb = ds + bc * dk * dv;
  for (int p = warp; p < nmt * ngrp; p += kWarps) {
    const int m0 = (p / ngrp) * 16, nt0 = (p % ngrp) * 2;
    const int nv = min(2, nnt - nt0);
    float acc[2][4] = {};
    for (int k0 = 0; k0 < C8; k0 += 8) {
      const FragA a = load_at(sK, L.ldk, m0, k0);
      float b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* bp =
            sV + (k0 + tq) * L.ldv + min(nt0 + j, nnt - 1) * 8 + g;
        b[j][0] = bp[0];
        b[j][1] = bp[4 * L.ldv];
      }
      mma3<2>(acc, a, b, nv);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nv) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = m0 + g + (e >= 2 ? 8 : 0);
        const int jj = (nt0 + j) * 8 + 2 * tq + (e & 1);
        if (ii < dk && jj < nj) dsb[(long long)ii * dv + j0 + jj] = acc[j][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B: S_in[c] = S_{c-1} over dS_c, in chunk order; the final state
// ---------------------------------------------------------------------------
// One thread per 4 consecutive state elements (dk % 4 == 0, so dk dv is a
// multiple of 4 and ds, a 16-byte aligned slice of the scratch, takes
// 16-byte loads), with
// kAhead chunks' loads in flight before the dependent chain.
__global__ void __launch_bounds__(kPassThreads) state_pass_kernel(
    const float* __restrict__ s0,   // (BH, dk, dv)
    float* __restrict__ ds,         // (BH, nC, dk, dv): dS_c in, S_in[c] out
    const float* __restrict__ tot,  // (BH, nC, dk)
    float* __restrict__ s_out,      // (BH, dk, dv)
    int nC, int dk, int dv) {
  constexpr int kAhead = 8;
  const long long bh = blockIdx.x;
  const int e = 4 * (blockIdx.y * kPassThreads + threadIdx.x);
  const int n = dk * dv;
  if (e >= n) return;
  int ti[4];
  float S[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    ti[a] = (e + a) / dv;
    S[a] = s0[bh * n + e + a];
  }
  float4* x = reinterpret_cast<float4*>(ds + bh * nC * (long long)n + e);
  const float* tt = tot + bh * nC * dk;
  const long long xs = n / 4;
  for (int c0 = 0; c0 < nC; c0 += kAhead) {
    float4 d[kAhead];
    float gt[kAhead][4];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (c0 + a < nC) {
        d[a] = x[(c0 + a) * xs];
#pragma unroll
        for (int b = 0; b < 4; ++b) gt[a][b] = tt[(long long)(c0 + a) * dk + ti[b]];
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (c0 + a < nC) {
        x[(c0 + a) * xs] = make_float4(S[0], S[1], S[2], S[3]);
        S[0] = expf(gt[a][0]) * S[0] + d[a].x;
        S[1] = expf(gt[a][1]) * S[1] + d[a].y;
        S[2] = expf(gt[a][2]) * S[2] + d[a].z;
        S[3] = expf(gt[a][3]) * S[3] + d[a].w;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) s_out[bh * n + e + a] = S[a];
}

// ---------------------------------------------------------------------------
// C: o of one 64-row tile of one chunk
// ---------------------------------------------------------------------------
struct OutLayout {
  int lda, ldq, ldk, ldv, lds, p, q, qs, k, diag, floats;
};

// one layout for every CTA of a launch, sized for the largest tile
__host__ __device__ inline OutLayout out_layout(int C, int dkp, int dvt) {
  OutLayout L;
  const int rp = min(kRowTile, round_up(C, 16)), C8 = round_up(C, 8);
  L.lda = ld4(C8);
  L.ldq = ld4(dkp);
  L.ldk = ld4(dkp);
  L.ldv = ld8(dvt);
  L.lds = ld8(dvt);
  // region p: att; q: q_in, then S_in; qs: q exp(cum_q); k: k_in, then v
  L.p = 0;
  L.q = L.p + rp * L.lda;
  L.qs = L.q + max(rp * L.ldq, dkp * L.lds);
  L.k = L.qs + rp * L.ldq;
  L.diag = L.k + max(C8 * L.ldk, C8 * L.ldv);
  L.floats = L.diag + kRowTile;
  return L;
}

template <bool BONUS>
__global__ void __launch_bounds__(kThreads, 2) chunk_out_kernel(
    const float* __restrict__ q_in,  // (BH, T, dk) from chunk_prep_kernel
    const float* __restrict__ q_st,  // (BH, T, dk)
    const float* __restrict__ k_in,  // (BH, T, dk)
    const float* __restrict__ diag,  // (BH, T), read if BONUS
    const float* __restrict__ v,     // (BH, T, dv)
    const float* __restrict__ s_in,  // (BH, nC, dk, dv)
    float* __restrict__ o,           // (BH, T, dv)
    int T, int dk, int dv, int C, int dkp, int dvt, int vec_v) {
  extern __shared__ __align__(16) float smem[];
  const int nR = (C + kRowTile - 1) / kRowTile;
  const long long bc = blockIdx.x / nR;  // bh * nC + c
  const int t0 = (blockIdx.x % nR) * kRowTile;
  const int j0 = blockIdx.y * dvt;
  const int nj = min(dvt, dv - j0);
  const int rt = min(kRowTile, C - t0), rp = round_up(rt, 16);
  const int send = t0 + rt, send8 = round_up(send, 8);
  const OutLayout L = out_layout(C, dkp, dvt);
  float* sAtt = smem + L.p;
  float* sQ = smem + L.q;
  float* sS = smem + L.q;
  float* sQS = smem + L.qs;
  float* sK = smem + L.k;
  float* sV = smem + L.k;
  float* sDiag = smem + L.diag;
  const long long row0 = bc * C;  // (bh * T + c * C)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;

  // 1. stage this tile's q_in and q exp(cum_q) rows, the k_in rows up to
  //    the tile's last (the scratch is a fresh allocation: 16-byte copies
  //    whenever dk % 4 == 0, which the launch requires) and the diagonal
  stage(sQ, L.ldq, q_in + (row0 + t0) * dk, dk, rt, dk, rp, dkp, true);
  stage(sQS, L.ldq, q_st + (row0 + t0) * dk, dk, rt, dk, rp, dkp, true);
  stage(sK, L.ldk, k_in + row0 * dk, dk, send, dk, send8, dkp, true);
  if (BONUS) {
    for (int r = tid; r < rt; r += kThreads) sDiag[r] = diag[row0 + t0 + r];
  }
  cp_async_wait();
  __syncthreads();

  // 2. att = q_in k_in^T over the causal tiles, masked: warp (16-row tile
  //    mt, 8-column tiles nt = ng + 4 j)
  const int nmt = rp / 16;
  const int mt = warp % 4, ng = warp / 4;
  if (mt < nmt) {
    const int m0 = mt * 16, tmax = t0 + m0 + 15;
    // the tiles that reach the causal side: a prefix of j
    const int ncol = min(send8, (tmax / 8 + 1) * 8) / 8;
    const int nv = max(0, (ncol - ng + 3) / 4);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < dkp; k0 += 8) {
      const FragA a = load_a(sQ, L.ldq, m0, k0);
      float b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n0 = min(ng + 4 * j, ncol - 1) * 8;
        const float* bp = sK + (n0 + g) * L.ldk + k0 + tq;
        b[j][0] = bp[0];
        b[j][1] = bp[4];
      }
      mma3<4>(acc, a, b, nv);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= nv) continue;
      const int n0 = (ng + 4 * j) * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + g + (e >= 2 ? 8 : 0);
        const int s = n0 + 2 * tq + (e & 1);
        const int t = t0 + r;
        const bool keep = t < C && s < send && (BONUS ? s < t : s <= t);
        sAtt[r * L.lda + s] = keep ? acc[j][e] : 0.0f;
      }
    }
  }
  __syncthreads();

  // 3. stage v (over k_in) and S_in[c] (over q_in)
  stage(sV, L.ldv, v + row0 * dv + j0, dv, send, nj, send8, dvt, vec_v);
  stage(sS, L.lds, s_in + bc * dk * dv + j0, dv, dk, nj, dkp, dvt, vec_v);
  cp_async_wait();
  __syncthreads();

  // 4. o = att v + (q exp(cum_q)) S_in [+ diag v]: warp (mt, nt = ng +
  //    4 j), the att product only up to the tile's last row
  if (mt < nmt) {
    const int m0 = mt * 16, nnt = dvt / 8;
    const int nv = max(0, (nnt - ng + 3) / 4);
    const int kend = min(send8, t0 + m0 + 16);
    float acc[2][4] = {};
    if (nv > 0) {
      for (int k0 = 0; k0 < kend; k0 += 8) {
        const FragA a = load_a(sAtt, L.lda, m0, k0);
        float b[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* bp =
              sV + (k0 + tq) * L.ldv + min(ng + 4 * j, nnt - 1) * 8 + g;
          b[j][0] = bp[0];
          b[j][1] = bp[4 * L.ldv];
        }
        mma3<2>(acc, a, b, nv);
      }
      for (int k0 = 0; k0 < dkp; k0 += 8) {
        const FragA a = load_a(sQS, L.ldq, m0, k0);
        float b[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* bp =
              sS + (k0 + tq) * L.lds + min(ng + 4 * j, nnt - 1) * 8 + g;
          b[j][0] = bp[0];
          b[j][1] = bp[4 * L.lds];
        }
        mma3<2>(acc, a, b, nv);
      }
    }
    float* ob = o + (row0 + t0) * dv + j0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nv) continue;
      const int nt = ng + 4 * j;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + g + (e >= 2 ? 8 : 0);
        const int jj = nt * 8 + 2 * tq + (e & 1);
        if (r < rt && jj < nj) {
          float x = acc[j][e];
          if (BONUS) x += sDiag[r] * sV[(t0 + r) * L.ldv + jj];
          ob[(long long)r * dv + jj] = x;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C == 1: one step at a time, f32 on the CUDA cores
// ---------------------------------------------------------------------------
template <bool BONUS>
__global__ void __launch_bounds__(32 * kStepRows) step_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ s_out, int T, int dk,
    int dv) {
  constexpr int kR = kMaxDk / kStepRows;  // state rows a thread
  __shared__ float sq[kMaxDk], sk[kMaxDk], sl[kMaxDk], sv[32];
  __shared__ float part[kStepRows][33];
  __shared__ float sdiag;
  const long long bh = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + tx;
  const int j = blockIdx.y * 32 + tx;
  const bool jv = j < dv;
  float S[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = ty + kStepRows * r;
    S[r] = jv && i < dk ? s0[(bh * dk + i) * dv + j] : 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    const long long row = bh * T + t;
    for (int i = tid; i < dk; i += 32 * kStepRows) {
      sq[i] = q[row * dk + i];
      sk[i] = k[row * dk + i];
      sl[i] = log_decay(w[row * dk + i]);
    }
    if (ty == 0) sv[tx] = jv ? v[row * dv + j] : 0.0f;
    __syncthreads();
    if (ty == 0) {
      // bonus: q.u.k; GLA: att = q_in . k_in = q . k at C = 1
      float d = 0.0f;
      for (int i = tx; i < dk; i += 32)
        d += BONUS ? (sq[i] * u[bh * dk + i]) * sk[i] : sq[i] * sk[i];
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (tx == 0) sdiag = d;
    }
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ty + kStepRows * r;
      if (i < dk) {
        const float g = expf(sl[i]);
        // q exp(cum_q): cum_q = 0 with the bonus, log w without
        const float qs = BONUS ? sq[i] : sq[i] * g;
        acc = fmaf(qs, S[r], acc);
        S[r] = g * S[r] + sk[i] * sv[tx];
      }
    }
    part[ty][tx] = acc;
    __syncthreads();
    if (ty == 0 && jv) {
      float x = 0.0f;
#pragma unroll
      for (int y = 0; y < kStepRows; ++y) x += part[y][tx];
      o[row * dv + j] = sdiag * sv[tx] + x;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = ty + kStepRows * r;
    if (jv && i < dk) s_out[(bh * dk + i) * dv + j] = S[r];
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
// The dynamic shared-memory ceiling is raised once per kernel to the
// largest size asked for (one card per process), so a launch makes no CUDA
// call besides the launches themselves and can be captured in a CUDA graph;
// above 227 KB this fails with cudaErrorInvalidValue, returned below.
// The carveout asks for the SM's whole shared memory, so that two CTAs fit.
template <typename Kernel>
cudaError_t smem_ceiling(Kernel kernel, long long& set, long long bytes) {
  if (bytes <= set) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) set = bytes;
  return err;
}

template <bool BONUS>
int launch(const float* q, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* o, float* s_out,
           float* scratch, int BH, int T, int dk, int dv, int C,
           cudaStream_t stream, int* launched) {
  cudaError_t err;
  if (C == 1) {
    const dim3 grid((unsigned)BH, (unsigned)((dv + 31) / 32));
    step_kernel<BONUS><<<grid, dim3(32, kStepRows), 0, stream>>>(
        q, k, v, w, u, s0, o, s_out, T, dk, dv);
    if ((err = cudaGetLastError()) == cudaSuccess) ++*launched;
    return (int)err;
  }
  const int nC = T / C;
  const int dkp = round_up(dk, 16);
  const int dvt = min(kMaxDvTile, round_up(dv, 8));
  const unsigned ntile = (unsigned)((dv + dvt - 1) / dvt);
  // scratch (chunk_scan_scratch_floats): q_in, q exp(cum_q), k_in, the
  // diagonal, dS_c / S_in[c], total_c
  const long long nqk = (long long)BH * T * dk;
  float* q_in = scratch;
  float* q_st = q_in + nqk;
  float* k_in = q_st + nqk;
  float* diag = k_in + nqk;
  float* ds = diag + ((long long)BH * T + 3) / 4 * 4;
  float* tot = ds + (long long)BH * nC * dk * dv;
  auto aligned = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec_k = aligned(q) && aligned(k) && aligned(w);  // dk % 4 == 0
  const int vec_v = dv % 4 == 0 && aligned(v) && aligned(scratch);

  static long long set_a = 48 * 1024, set_c = 48 * 1024;
  const long long smem_a = 4LL * prep_layout(C, dkp, dvt).floats;
  const long long smem_c = 4LL * out_layout(C, dkp, dvt).floats;
  err = smem_ceiling(chunk_prep_kernel<BONUS>, set_a, smem_a);
  if (err == cudaSuccess)
    err = smem_ceiling(chunk_out_kernel<BONUS>, set_c, smem_c);
  if (err != cudaSuccess) return (int)err;

  const unsigned nbc = (unsigned)((long long)BH * nC);
  chunk_prep_kernel<BONUS><<<dim3(nbc, ntile), kThreads, (size_t)smem_a,
                             stream>>>(q, k, v, w, u, q_in, q_st, k_in, diag,
                                       ds, tot, T, dk, dv, C, dkp, dvt,
                                       vec_k, vec_v);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  const unsigned nel =
      (unsigned)((dk * dv / 4 + kPassThreads - 1) / kPassThreads);
  state_pass_kernel<<<dim3((unsigned)BH, nel), kPassThreads, 0, stream>>>(
      s0, ds, tot, s_out, nC, dk, dv);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ++*launched;
  const unsigned nR = (unsigned)((C + kRowTile - 1) / kRowTile);
  chunk_out_kernel<BONUS><<<dim3(nbc * nR, ntile), kThreads, (size_t)smem_c,
                            stream>>>(q_in, q_st, k_in, diag, v, ds, o, T,
                                      dk, dv, C, dkp, dvt, vec_v);
  if ((err = cudaGetLastError()) == cudaSuccess) ++*launched;
  return (int)err;
}

}  // namespace

// Floats of scratch one call needs (0 for a decode step): q_in, q
// exp(cum_q) and k_in (BH, T, dk) each, the diagonal (BH, T, rounded up to
// 4), dS_c / S_in[c] (BH, T/C, dk, dv) and total_c (BH, T/C, dk).
extern "C" long long chunk_scan_scratch_floats(int BH, int T, int dk, int dv,
                                               int C) {
  if (C <= 1) return 0;
  const long long nC = T / C;
  return 3LL * BH * T * dk + ((long long)BH * T + 3) / 4 * 4 +
         BH * nC * dk * dv + BH * nC * dk;
}

// scratch: chunk_scan_scratch_floats(...) floats, 16-byte aligned, unread
// when C == 1.  *launched goes up by one at each kernel launch that
// succeeded (3 for C >= 2, 1 for C == 1; fewer if a later one failed).
extern "C" int chunk_scan_launch(
    const float* q, const float* k, const float* v, const float* w,
    const float* u, const float* s0, float* o, float* s_out, float* scratch,
    int BH, int T, int dk, int dv, int C, int use_bonus, void* stream,
    int* launched) {
  if (BH == 0) return 0;
  if (C < 1 || C > kMaxChunk || T < C || T % C != 0 || dk < 4 ||
      dk % 4 != 0 || dk > kMaxDk || dv < 1 ||
      (long long)BH * (T / C) * ((C + kRowTile - 1) / kRowTile) >
          0x7fffffffLL ||
      (C > 1 && (uintptr_t)scratch % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return use_bonus ? launch<true>(q, k, v, w, u, s0, o, s_out, scratch, BH,
                                  T, dk, dv, C, st, launched)
                   : launch<false>(q, k, v, w, u, s0, o, s_out, scratch, BH,
                                   T, dk, dv, C, st, launched);
}

// Dynamic shared memory (bytes) and resident CTAs per SM of the prep
// kernel (out[0], out[2]) and the output kernel (out[1], out[3]) at one
// shape; the occupancy reads the ceiling a launch at that shape has set.
extern "C" int chunk_scan_resources(int C, int dk, int dv, int use_bonus,
                                    int* out) {
  const int dkp = round_up(dk, 16), dvt = min(kMaxDvTile, round_up(dv, 8));
  out[0] = 4 * prep_layout(C, dkp, dvt).floats;
  out[1] = 4 * out_layout(C, dkp, dvt).floats;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2],
      use_bonus ? chunk_prep_kernel<true> : chunk_prep_kernel<false>,
      kThreads, (size_t)out[0]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[3],
        use_bonus ? chunk_out_kernel<true> : chunk_out_kernel<false>,
        kThreads, (size_t)out[1]);
  return (int)err;
}

extern "C" const char* chunk_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
