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
// (flush), Q*N*4 of q_rows, Q*N*4 of cold and Q*N*4 of sel, 64 MB at
// OW = 2, Q = 4.
//
// Design: one thread per node column.  It writes its OW flushed words,
// then answers each query from flush_vals when the query row was
// flushed (the last matching w wins, as the reference's where-chain
// does), else from cold.  Column i is touched by thread i only, so the
// update is race-free in place.  Flushed-row writes and q_rows / sel
// accesses are coalesced; the cold reads of a query are one word per
// column at that column's own row.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void coldsel_kernel(uint32_t* __restrict__ cold,
                               const int32_t* __restrict__ flush_rows,
                               const uint32_t* __restrict__ flush_vals,
                               const int32_t* __restrict__ q_rows,
                               uint32_t* __restrict__ sel,
                               long long n, int rw, int ow, int nq) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  for (int w = 0; w < ow; ++w) {
    int r = flush_rows[w];
    if (r >= 0 && r < rw) cold[(long long)r * n + i] = flush_vals[(long long)w * n + i];
  }
  for (int q = 0; q < nq; ++q) {
    int r = q_rows[(long long)q * n + i];
    uint32_t v = 0;
    if (r >= 0 && r < rw) {
      int hit = -1;
      for (int w = 0; w < ow; ++w)
        if (flush_rows[w] == r) hit = w;
      v = hit >= 0 ? flush_vals[(long long)hit * n + i]
                   : cold[(long long)r * n + i];
    }
    sel[(long long)q * n + i] = v;
  }
}

extern "C" int coldsel_launch(void* cold, const void* flush_rows,
                              const void* flush_vals, const void* q_rows,
                              void* sel, long long n, int rw, int ow, int nq,
                              void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    coldsel_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)cold, (const int32_t*)flush_rows,
        (const uint32_t*)flush_vals, (const int32_t*)q_rows, (uint32_t*)sel,
        n, rw, ow, nq);
  }
  return (int)cudaGetLastError();
}
