// First-B piggyback selection for Hopper (sm_90a).
//
// Replaces the TPU kernel of swim_tpu/ops/selb.py (`_call` ->
// `_make_kernel` -> `_first_b_math`).  Computes, for each node row of
// the window win[N, WW] (u32, newest word = last column), the mask of
// the first `b` set bits: newest word first, LSB first within a word.
//
// Bound on this card: bytes.  The function reads N*WW*4 bytes and
// writes as many (96 MB at N = 1,000,000, WW = 12) and does a few
// integer operations per word, far below the card's rate.
//
// Design: one thread per node row walks its WW words from the newest,
// carrying the row's remaining budget.  A word whose popcount fits the
// budget is kept whole; otherwise its lowest `budget` bits are peeled
// off one at a time (budget < popcount <= 32).  The rows are node-major,
// so the 32 threads of a warp cover one contiguous run of 32*WW*4
// bytes; each word load touches lines the neighbouring loads of the
// same walk reuse from L1.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void selb_kernel(const uint32_t* __restrict__ win,
                            uint32_t* __restrict__ out,
                            long long n, int ww, int b) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* row = win + i * ww;
  uint32_t* orow = out + i * ww;
  int budget = b;
  for (int w = ww - 1; w >= 0; --w) {
    uint32_t m = row[w];
    uint32_t keep = 0;
    if (budget > 0) {
      if (__popc(m) <= budget) {
        keep = m;
      } else {
        for (int j = 0; j < budget; ++j) {
          uint32_t low = m & (0u - m);
          keep |= low;
          m ^= low;
        }
      }
      budget -= __popc(keep);
    }
    orow[w] = keep;
  }
}

extern "C" int selb_launch(const void* win, void* out, long long n, int ww,
                           int b, void* stream) {
  if (n > 0 && ww > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    selb_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)win, (uint32_t*)out, n, ww, b);
  }
  return (int)cudaGetLastError();
}
