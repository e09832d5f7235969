// Cold-ring flush plus view-query select for Hopper (sm_90a).
//
// Replaces the TPU kernel of swim_tpu/ops/coldsel.py (`_call` ->
// `_kernel`).  Computes, in place over cold[RW, N] (u32, word-major):
//
//   cold[flush_rows[w], i] = flush_vals[w, i]        for w < OW, in order
//   sel[q, i] = cold[q_rows[q, i], i]  if 0 <= q_rows[q, i] < RW, else 0
//
// where the query reads the flushed matrix.
//
// Bound on this card: bytes.  The TPU kernel streamed all RW rows of
// cold through VMEM (about 1 GB per period at N = 1,000,000) because its
// block walk had to; the function itself needs only the OW flushed rows
// and the Q queried words of each column: OW*N*4 read + OW*N*4 written
// (flush), Q*N*4 of q_rows, Q*N*4 of sel, and of cold the queried words.
// The card moves device memory in 32-byte sectors, so a queried word
// costs its sector unless a neighbouring column (of the same 8) queries
// the same row: with a row per column drawn at random that is 32 bytes
// per query, about 176 MB in all at OW = 2, Q = 4, where 64 MB would do
// if words could be fetched alone.  On the ring's period nearly every
// query names the same row (a subject without a rumour asks for slot -1,
// which clamps to row 0), so there the reads coalesce and the streamed
// arrays are what is left.
//
// Lanes: a batched study (the reference's vmap over `pallas_call`)
// passes P lanes in one launch, cold[P, RW, N] and sel[P, Q, N] with one
// lane each in the grid's y axis; flush_rows, flush_vals and q_rows
// carry a lane stride, 0 where the lanes share one copy, so a shared
// operand is never copied P times.  Each lane is the one-lane kernel on
// its own slices.
//
// Design: a thread owns 4 consecutive columns (one when N % 4 != 0 or a
// pointer is not 16-byte aligned), so flush_vals, q_rows and sel move as
// coalesced 16-byte accesses, marked evict-first because each is
// touched once; cold keeps the default policy, so the queried sectors
// are what L2 holds.  flush_rows is staged once per block in shared
// memory.  Queries go four at a time: all their row indices are loaded
// and resolved first (out of range: no load; a flushed row: answered
// from flush_vals, the last matching w winning as in the reference's
// where-chain), then every cold load of the group is issued before any
// value is used, so a thread has up to 16 scattered loads in flight.
// When the four columns of a query name one row they share one 16-byte
// load.  Because a query on a flushed row never reads cold, no load
// depends on a store, and the flush itself goes last: it streams
// flush_vals into the flushed rows.  Column i is touched by one thread
// only, so the update is race-free in place.
//
// Scattered reads cost more than their sectors on this card: with rows
// in aligned runs of 8 columns (one sector each) the kernel takes 1.25
// times as long as with runs of 16 (two adjacent sectors each) although
// both need the same sectors, which is what a 64-byte fetch per missed
// sector gives (80 MB against 64 MB).  On the random input that is
// about 296 MB, not 176 MB, and every variant timed there (this one,
// one column per thread, a block's tile staged through shared memory, a
// per-warp vote between the two layouts) lands at 0.121-0.138 ms, at or
// a little under the rate a plain copy reaches.  This layout is the
// fastest of them on the ring's own inputs and within 8% of the best on
// the random one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // queries resolved and loaded together

template <int VEC> struct Vec;
template <> struct Vec<4> {
  static __device__ __forceinline__ void ld_rows(const int32_t* p, int* r) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  }
  static __device__ __forceinline__ void st_once(uint32_t* p,
                                                 const uint32_t* v) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
  }
  static __device__ __forceinline__ void copy_row(uint32_t* dst,
                                                  const uint32_t* src) {
    *reinterpret_cast<uint4*>(dst) =
        __ldcs(reinterpret_cast<const uint4*>(src));
  }
};
template <> struct Vec<1> {
  static __device__ __forceinline__ void ld_rows(const int32_t* p, int* r) {
    r[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void st_once(uint32_t* p,
                                                 const uint32_t* v) {
    __stcs(p, v[0]);
  }
  static __device__ __forceinline__ void copy_row(uint32_t* dst,
                                                  const uint32_t* src) {
    *dst = __ldcs(src);
  }
};

// Thread j of the grid owns columns [j * VEC, j * VEC + VEC).  LANES:
// the grid's y axis runs lanes; without it (one study) the kernel is
// the one-lane code, the lane offsets compiled out.
template <int VEC, bool LANES>
__global__ void __launch_bounds__(kThreads)
coldsel_kernel(uint32_t* __restrict__ cold,
               const int32_t* __restrict__ flush_rows,
               const uint32_t* __restrict__ flush_vals,
               const int32_t* __restrict__ q_rows,
               uint32_t* __restrict__ sel,
               long long n, int rw, int ow, int nq, long long ls_fr,
               long long ls_fv, long long ls_qr) {
  extern __shared__ int32_t s_fr[];  // flush_rows, -1 where out of range
  if constexpr (LANES) {
    const long long lane = blockIdx.y;
    cold += lane * rw * n;
    sel += lane * nq * n;
    flush_rows += lane * ls_fr;
    flush_vals += lane * ls_fv;
    q_rows += lane * ls_qr;
  }
  for (int w = threadIdx.x; w < ow; w += blockDim.x) {
    const int r = flush_rows[w];
    s_fr[w] = (r >= 0 && r < rw) ? r : -1;
  }
  __syncthreads();
  const long long i0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (i0 >= n) return;

  for (int q0 = 0; q0 < nq; q0 += kGroup) {
    int row[kGroup][VEC];
    uint32_t val[kGroup][VEC];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (q0 + u < nq)
        Vec<VEC>::ld_rows(q_rows + (long long)(q0 + u) * n + i0, row[u]);
    // resolve: -1 = no load, -2 - w = flush_vals row w, else the cold row
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (q0 + u >= nq) continue;
#pragma unroll
      for (int c = 0; c < VEC; ++c) {
        const int r = row[u][c];
        int hit = -1;  // the last matching w wins
        for (int w = 0; w < ow; ++w)
          if (s_fr[w] == r) hit = w;
        row[u][c] = (r < 0 || r >= rw) ? -1 : hit >= 0 ? -2 - hit : r;
      }
    }
    // every load of the group, before any use
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      if (q0 + u >= nq) continue;
      bool one_row = VEC == 4 && row[u][0] >= 0;
#pragma unroll
      for (int c = 1; c < VEC; ++c) one_row &= row[u][c] == row[u][0];
      if constexpr (VEC == 4) {
        if (one_row) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              cold + (long long)row[u][0] * n + i0);
          val[u][0] = v.x; val[u][1] = v.y; val[u][2] = v.z; val[u][3] = v.w;
        }
      }
      if (!one_row) {
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const int r = row[u][c];
          uint32_t v = 0;
          if (r >= 0)
            v = cold[(long long)r * n + i0 + c];
          else if (r < -1)
            v = __ldg(flush_vals + (long long)(-2 - r) * n + i0 + c);
          val[u][c] = v;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (q0 + u < nq)
        Vec<VEC>::st_once(sel + (long long)(q0 + u) * n + i0, val[u]);
  }

  // the flush, last: no query above read a flushed row of cold
  for (int w = 0; w < ow; ++w) {
    const int r = s_fr[w];
    if (r >= 0)
      Vec<VEC>::copy_row(cold + (long long)r * n + i0,
                         flush_vals + (long long)w * n + i0);
  }
}

template <int VEC>
int launch(uint32_t* cold, const int32_t* fr, const uint32_t* fv,
           const int32_t* qr, uint32_t* sel, long long n, int rw, int ow,
           int nq, int lanes, long long ls_fr, long long ls_fv,
           long long ls_qr, cudaStream_t stream) {
  const long long work = (n + VEC - 1) / VEC;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)blocks, (unsigned)lanes);
  const size_t smem = (size_t)ow * sizeof(int32_t);
  if (lanes > 1)
    coldsel_kernel<VEC, true><<<grid, kThreads, smem, stream>>>(
        cold, fr, fv, qr, sel, n, rw, ow, nq, ls_fr, ls_fv, ls_qr);
  else
    coldsel_kernel<VEC, false><<<grid, kThreads, smem, stream>>>(
        cold, fr, fv, qr, sel, n, rw, ow, nq, ls_fr, ls_fv, ls_qr);
  return (int)cudaGetLastError();
}

}  // namespace

// lanes >= 1; ls_* are the lane strides, in elements, of flush_rows,
// flush_vals and q_rows (0: shared by every lane).  cold and sel are
// lane-contiguous, RW*N and Q*N elements a lane.
extern "C" int coldsel_launch(void* cold, const void* flush_rows,
                              const void* flush_vals, const void* q_rows,
                              void* sel, long long n, int rw, int ow, int nq,
                              int lanes, long long ls_fr, long long ls_fv,
                              long long ls_qr, void* stream) {
  if (n <= 0 || lanes <= 0) return (int)cudaGetLastError();
  if (lanes > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && (uintptr_t)cold % 16 == 0 &&
                   (uintptr_t)flush_vals % 16 == 0 &&
                   (uintptr_t)q_rows % 16 == 0 && (uintptr_t)sel % 16 == 0;
  auto* c = (uint32_t*)cold;
  auto* fr = (const int32_t*)flush_rows;
  auto* fv = (const uint32_t*)flush_vals;
  auto* qr = (const int32_t*)q_rows;
  auto* s = (uint32_t*)sel;
  auto st = (cudaStream_t)stream;
  return vec ? launch<4>(c, fr, fv, qr, s, n, rw, ow, nq, lanes, ls_fr,
                         ls_fv, ls_qr, st)
             : launch<1>(c, fr, fv, qr, s, n, rw, ow, nq, lanes, ls_fr,
                         ls_fv, ls_qr, st);
}
