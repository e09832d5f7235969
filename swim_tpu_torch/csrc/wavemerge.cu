// Fused multi-wave window OR-merge for Hopper (sm_90a).
//
// Replaces the TPU kernel of swim_tpu/ops/wavemerge.py (`_call` ->
// `_make_kernel`).  Computes, in place over win[N, WW] (u32):
//
//   win[i, c] |= OR_w  (oks[w, i] ? sel[(i + offs[w]) mod N, c] : 0)
//              | OR_q  (bcol[q, i] == c ? bval[q, i] : 0)
//
// for V waves (V <= 32) and VB forced-bit rows (VB may be 0).
//
// Bound on this card: bytes.  win is read and written once (2*N*WW*4),
// sel read once (N*WW*4), oks read once (V*N bytes) and the VB rows
// once: about 158 MB at N = 1,000,000, WW = 12, V = 14, VB = 0.
//
// Design: one thread per (node, word), word fastest, so a warp's win,
// sel and output accesses are contiguous.  Offsets are read from the
// device and normalised once per block into shared memory to [0, N)
// with floor semantics, so any sign or magnitude works and the wrap is
// a single compare (no block size needs to divide N).  A wave's sel
// reads are a shifted copy of the receivers' contiguous run; sel
// (48 MB here) mostly stays in the 50 MB L2 across the V waves.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void wavemerge_kernel(uint32_t* __restrict__ win,
                                 const uint32_t* __restrict__ sel,
                                 const uint8_t* __restrict__ oks,
                                 const int32_t* __restrict__ offs,
                                 const int32_t* __restrict__ bcol,
                                 const uint32_t* __restrict__ bval,
                                 long long n, int ww, int v, int vb) {
  __shared__ long long soff[32];
  if ((int)threadIdx.x < v) {
    long long o = (long long)offs[threadIdx.x] % n;
    soff[threadIdx.x] = o < 0 ? o + n : o;
  }
  __syncthreads();
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * ww) return;
  long long i = e / ww;
  int c = (int)(e - i * ww);
  uint32_t acc = win[e];
  for (int w = 0; w < v; ++w) {
    if (oks[(long long)w * n + i]) {
      long long src = i + soff[w];
      if (src >= n) src -= n;
      acc |= sel[src * ww + c];
    }
  }
  for (int q = 0; q < vb; ++q) {
    if (bcol[(long long)q * n + i] == c) acc |= bval[(long long)q * n + i];
  }
  win[e] = acc;
}

extern "C" int wavemerge_launch(void* win, const void* sel, const void* oks,
                                const void* offs, const void* bcol,
                                const void* bval, long long n, int ww, int v,
                                int vb, void* stream) {
  if (n > 0 && ww > 0) {
    const int threads = 256;  // >= 32 >= v: the offset preload needs it
    long long blocks = (n * ww + threads - 1) / threads;
    wavemerge_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)win, (const uint32_t*)sel, (const uint8_t*)oks,
        (const int32_t*)offs, (const int32_t*)bcol, (const uint32_t*)bval,
        n, ww, v, vb);
  }
  return (int)cudaGetLastError();
}
