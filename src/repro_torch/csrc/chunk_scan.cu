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
// Each chunk computes, as the TPU kernel does:
//   cum   = inclusive prefix of log(max(w, 1e-38)) over the chunk,
//   m     = cum[C/2] (the mid-chunk reference), cum_q = cum - log w with
//           the bonus, cum without,
//   att   = (q exp(clip(cum_q - m, +-45))) (k exp(clip(m - cum, +-45)))^T,
//           causal (strictly causal with the bonus),
//   o     = att v [+ (q.u.k) v] + (q exp(cum_q)) S,
//   S     = exp(cum[C-1]) S + (k exp(cum[C-1] - cum))^T v.
// The +-45 clip is kept exactly: it is part of the reference's numbers.
//
// What bounds it on the H100: operations.  At rwkv6-1.6b's prefill shape
// (32 head rows per request, dk = dv = 64, C = 128) the four products are
// ~1.08 GFLOP per 1,024 tokens (the causal triangle only) against ~43 MB
// of traffic.  This first
// design is simple, f32 on the CUDA cores (no TF32, no tensor cores): one
// CTA of 256 threads per (head row, 16-wide column tile of v and S), so the
// 32 rows of one request fill 128 CTAs.  Each CTA walks its chunks in order
// with its (dk x 16) state tile, the chunk's cum, transformed q and k, the
// (C x C) att and the v tile in dynamic shared memory (180 KB at C = 128,
// dk = 64).  att is recomputed by each column tile of a row; the causal
// half above the diagonal is skipped.  q rows are read as float4
// broadcasts, k rows with an odd stride so the 32 lanes hit 32 banks.
// Deterministic: no atomics, every sum in a fixed order, so equal inputs
// give equal bits on every launch.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDvTile = 16;   // columns of v, o and S per CTA
constexpr int kRows = 4;      // att rows per warp step
constexpr int kColB = 4;      // att column blocks of 32 per lane
constexpr int kMaxChunk = 32 * kColB;
constexpr int kGroups = kThreads / kDvTile;  // row groups of o and S
constexpr int kORows = kMaxChunk / kGroups;    // o rows a thread
constexpr int kSRows = 8;                      // S rows a thread
constexpr int kMaxDk = kGroups * kSRows;

__device__ __forceinline__ float clip45(float x) {
  return fminf(fmaxf(x, -45.0f), 45.0f);
}

__device__ __forceinline__ float log_decay(float w) {
  return logf(fmaxf(w, 1e-38f));
}

// shared-memory row strides: q rows stay 16-byte aligned (float4 loads),
// k and cum rows are odd so that 32 lanes reading 32 rows hit 32 banks
__host__ __device__ inline int ld_q(int dk) { return dk + 4; }
__host__ __device__ inline int ld_k(int dk) { return dk + 1; }
__host__ __device__ inline int ld_att(int C) { return C + 1; }

long long smem_floats(int C, int dk) {
  return (long long)C * ld_q(dk) + 2LL * C * ld_k(dk) +
         (long long)C * ld_att(C) + (long long)C * kDvTile +
         (long long)dk * kDvTile + C;
}

template <bool BONUS>
__global__ void __launch_bounds__(kThreads) chunk_scan_kernel(
    const float* __restrict__ q,    // (BH, T, dk)
    const float* __restrict__ k,    // (BH, T, dk)
    const float* __restrict__ v,    // (BH, T, dv)
    const float* __restrict__ w,    // (BH, T, dk) decay in (0, 1]
    const float* __restrict__ u,    // (BH, dk), read if BONUS
    const float* __restrict__ s0,   // (BH, dk, dv)
    float* __restrict__ o,          // (BH, T, dv)
    float* __restrict__ s_out,      // (BH, dk, dv)
    int T, int dk, int dv, int C) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = ld_q(dk), ldk = ld_k(dk), ldc = ld_att(C);
  float* sQ = smem;                    // (C, ldq): q_in, then q exp(cum_q)
  float* sK = sQ + C * ldq;            // (C, ldk): k_in, then k_out
  float* sCum = sK + C * ldk;          // (C, ldk)
  float* sAtt = sCum + C * ldk;        // (C, ldc)
  float* sV = sAtt + C * ldc;          // (C, kDvTile)
  float* sS = sV + C * kDvTile;        // (dk, kDvTile)
  float* sDiag = sS + dk * kDvTile;    // (C,)

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long bh = blockIdx.x;
  const int j0 = blockIdx.y * kDvTile;
  const int nj = min(kDvTile, dv - j0);
  const float* qb = q + bh * T * dk;
  const float* kb = k + bh * T * dk;
  const float* wb = w + bh * T * dk;
  const float* vb = v + bh * T * dv;
  float* ob = o + bh * T * dv;
  const int mid = C / 2;

  for (int idx = tid; idx < dk * kDvTile; idx += kThreads) {
    const int i = idx / kDvTile, jj = idx % kDvTile;
    sS[idx] = jj < nj ? s0[(bh * dk + i) * dv + j0 + jj] : 0.0f;
  }

  for (int c0 = 0; c0 < T; c0 += C) {
    // 1. log-decay and the v tile of this chunk
    for (int idx = tid; idx < C * dk; idx += kThreads) {
      const int t = idx / dk, i = idx % dk;
      sCum[t * ldk + i] = log_decay(wb[(long long)(c0 + t) * dk + i]);
    }
    for (int idx = tid; idx < C * kDvTile; idx += kThreads) {
      const int t = idx / kDvTile, jj = idx % kDvTile;
      sV[idx] = jj < nj ? vb[(long long)(c0 + t) * dv + j0 + jj] : 0.0f;
    }
    __syncthreads();

    // 2. inclusive prefix over t, one column per thread and nseg segments
    //    per column: each segment scans itself, then adds the totals of
    //    the segments before it
    {
      const int nseg = max(1, min(kThreads / dk, C));
      const int seg_len = (C + nseg - 1) / nseg;
      const int i = tid % dk, s = tid / dk;
      const bool active = s < nseg;
      const int t_lo = s * seg_len, t_hi = min(C, t_lo + seg_len);
      if (active) {
        float acc = 0.0f;
        for (int t = t_lo; t < t_hi; ++t) {
          acc += sCum[t * ldk + i];
          sCum[t * ldk + i] = acc;
        }
      }
      __syncthreads();
      float off = 0.0f;
      if (active) {
        for (int p = 0; p < s; ++p) {
          const int te = min(C, (p + 1) * seg_len) - 1;
          if (te >= p * seg_len) off += sCum[te * ldk + i];
        }
      }
      __syncthreads();
      if (active && s > 0) {
        for (int t = t_lo; t < t_hi; ++t) sCum[t * ldk + i] += off;
      }
      __syncthreads();
    }

    // 3. centred q_in and k_in; the bonus diagonal q.u.k
    for (int idx = tid; idx < C * dk; idx += kThreads) {
      const int t = idx / dk, i = idx % dk;
      const long long g = (long long)(c0 + t) * dk + i;
      const float cum = sCum[t * ldk + i];
      const float m = sCum[mid * ldk + i];
      const float cum_q = BONUS ? cum - log_decay(wb[g]) : cum;
      sQ[t * ldq + i] = qb[g] * expf(clip45(cum_q - m));
      sK[t * ldk + i] = kb[g] * expf(clip45(m - cum));
    }
    if (BONUS) {
      for (int t = tid; t < C; t += kThreads) {
        const float* qr = qb + (long long)(c0 + t) * dk;
        const float* kr = kb + (long long)(c0 + t) * dk;
        float d = 0.0f;
        for (int i = 0; i < dk; ++i) d += (qr[i] * u[bh * dk + i]) * kr[i];
        sDiag[t] = d;
      }
    }
    __syncthreads();

    // 4. att = q_in k_in^T on the causal side: a warp takes kRows rows,
    //    lane l the columns l + 32 b, only the blocks that reach the rows
    {
      const int ngroups = (C + kRows - 1) / kRows;
      const int ncolb = (C + 31) / 32;
      for (int g = warp; g < ngroups; g += kThreads / 32) {
        const int t0 = g * kRows;
        const int nb = min(ncolb, (min(t0 + kRows, C) - 1) / 32 + 1);
        float acc[kRows][kColB];
        const float* qrow[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          qrow[r] = sQ + min(t0 + r, C - 1) * ldq;
#pragma unroll
          for (int b = 0; b < kColB; ++b) acc[r][b] = 0.0f;
        }
        int krow[kColB];
#pragma unroll
        for (int b = 0; b < kColB; ++b)
          krow[b] = min(lane + 32 * b, C - 1) * ldk;
        for (int i = 0; i < dk; i += 4) {
          float4 qv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            qv[r] = *reinterpret_cast<const float4*>(qrow[r] + i);
#pragma unroll
          for (int b = 0; b < kColB; ++b) {
            if (b < nb) {
              const float* kr = sK + krow[b] + i;
              const float k0 = kr[0], k1 = kr[1], k2 = kr[2], k3 = kr[3];
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                float a = acc[r][b];
                a = fmaf(qv[r].x, k0, a);
                a = fmaf(qv[r].y, k1, a);
                a = fmaf(qv[r].z, k2, a);
                a = fmaf(qv[r].w, k3, a);
                acc[r][b] = a;
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int t = t0 + r;
#pragma unroll
          for (int b = 0; b < kColB; ++b) {
            const int s = lane + 32 * b;
            const bool keep = BONUS ? s < t : s <= t;
            if (b < nb && t < C && keep) sAtt[t * ldc + s] = acc[r][b];
          }
        }
      }
    }
    __syncthreads();

    // 5. the uncentred inter-chunk read and the state-update keys
    for (int idx = tid; idx < C * dk; idx += kThreads) {
      const int t = idx / dk, i = idx % dk;
      const long long g = (long long)(c0 + t) * dk + i;
      const float cum = sCum[t * ldk + i];
      const float total = sCum[(C - 1) * ldk + i];
      const float cum_q = BONUS ? cum - log_decay(wb[g]) : cum;
      sQ[t * ldq + i] = qb[g] * expf(cum_q);
      sK[t * ldk + i] = kb[g] * expf(total - cum);
    }
    __syncthreads();

    // 6. o = att v [+ diag v] + q_state S: thread (rows of group g, jj)
    {
      const int jj = tid % kDvTile, g = tid / kDvTile;
      const int rows = (C + kGroups - 1) / kGroups;
      const int r0 = g * rows;
      float intra[kORows], inter[kORows];
#pragma unroll
      for (int r = 0; r < kORows; ++r) intra[r] = inter[r] = 0.0f;
      const int s_end = min(C, r0 + rows);
      for (int s = 0; s < s_end; ++s) {
        const float vv = sV[s * kDvTile + jj];
#pragma unroll
        for (int r = 0; r < kORows; ++r) {
          const int t = r0 + r;
          const bool keep = BONUS ? s < t : s <= t;
          if (r < rows && t < C && keep)
            intra[r] = fmaf(sAtt[t * ldc + s], vv, intra[r]);
        }
      }
      for (int i = 0; i < dk; ++i) {
        const float sv = sS[i * kDvTile + jj];
#pragma unroll
        for (int r = 0; r < kORows; ++r) {
          const int t = min(r0 + r, C - 1);
          inter[r] = fmaf(sQ[t * ldq + i], sv, inter[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kORows; ++r) {
        const int t = r0 + r;
        if (r < rows && t < C && jj < nj) {
          float x = intra[r];
          if (BONUS) x = x + sDiag[t] * sV[t * kDvTile + jj];
          ob[(long long)(c0 + t) * dv + j0 + jj] = x + inter[r];
        }
      }
    }
    __syncthreads();

    // 7. S = exp(total) S + k_out^T v: thread (rows i = ig + kGroups r, jj)
    {
      const int jj = tid % kDvTile, ig = tid / kDvTile;
      const int nrows = (dk - ig + kGroups - 1) / kGroups;  // rows of ig
      float acc[kSRows];
#pragma unroll
      for (int r = 0; r < kSRows; ++r) acc[r] = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float vv = sV[t * kDvTile + jj];
#pragma unroll
        for (int r = 0; r < kSRows; ++r) {
          if (r < nrows)
            acc[r] = fmaf(sK[t * ldk + ig + kGroups * r], vv, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kSRows; ++r) {
        if (r < nrows) {
          const int i = ig + kGroups * r;
          const float total = sCum[(C - 1) * ldk + i];
          sS[i * kDvTile + jj] = expf(total) * sS[i * kDvTile + jj] + acc[r];
        }
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < dk * kDvTile; idx += kThreads) {
    const int i = idx / kDvTile, jj = idx % kDvTile;
    if (jj < nj) s_out[(bh * dk + i) * dv + j0 + jj] = sS[idx];
  }
}

template <bool BONUS>
int launch(const float* q, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* o, float* s_out, int BH,
           int T, int dk, int dv, int C, void* stream) {
  const long long smem = 4LL * smem_floats(C, dk);
  // raised once to the largest size asked for (one card per process), so
  // a launch makes no CUDA call besides the launch itself and can be
  // captured in a CUDA graph; above 227 KB this fails with
  // cudaErrorInvalidValue, returned below
  static long long smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        chunk_scan_kernel<BONUS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid((unsigned)BH, (unsigned)((dv + kDvTile - 1) / kDvTile));
  chunk_scan_kernel<BONUS><<<grid, kThreads, (size_t)smem,
                             (cudaStream_t)stream>>>(
      q, k, v, w, u, s0, o, s_out, T, dk, dv, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chunk_scan_launch(
    const float* q, const float* k, const float* v, const float* w,
    const float* u, const float* s0, float* o, float* s_out, int BH, int T,
    int dk, int dv, int C, int use_bonus, void* stream) {
  if (BH == 0) return 0;
  if (C < 1 || C > kMaxChunk || T < C || T % C != 0 || dk < 4 ||
      dk % 4 != 0 || dk > kMaxDk || dv < 1)
    return (int)cudaErrorInvalidValue;
  return use_bonus
             ? launch<true>(q, k, v, w, u, s0, o, s_out, BH, T, dk, dv, C,
                            stream)
             : launch<false>(q, k, v, w, u, s0, o, s_out, BH, T, dk, dv, C,
                             stream);
}

extern "C" const char* chunk_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
