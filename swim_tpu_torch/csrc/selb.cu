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
// Design: a block of R threads (R = 128) owns R consecutive rows, one
// contiguous run of R*WW words.  It stages the run into shared memory
// with coalesced 16-byte loads, scattering the words to a row stride
// padded to an odd word count (WW | 1), so that the 32 threads of a
// warp, each walking its own row, hit 32 different banks.  Each thread
// walks its row newest word first with the running budget: a word that
// fits is kept whole, the one that overflows keeps its low bits up to
// the budget-th set bit, found by a five-step binary ascent over
// popcounts (the TPU kernel's `_first_b_math` ascent), and the rest are
// zero.  Results go back to the same shared row and leave with
// coalesced 16-byte stores.  Both streams are touched once and marked
// evict-first.  The word -> (row, column) map of the staging loops is
// divided once per thread and then stepped, so no loop divides per
// element.  WW and b stay runtime arguments.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;           // rows (and threads) per block
constexpr int kSmemDefault = 48 * 1024;

// (row, column) of the word this thread touches at each step of a
// block-strided walk over the tile's words, `step` words per step:
// word j = r*ww + c lives at s[r*stride + c].  One division up front,
// then additions.
struct Cursor {
  int r, c, dr, dc, ww;
  __device__ Cursor(int j, int step, int ww_) : ww(ww_) {
    r = j / ww;
    c = j - r * ww;
    dr = step / ww;
    dc = step - dr * ww;
  }
  __device__ __forceinline__ void advance() {
    r += dr;
    c += dc;
    if (c >= ww) { c -= ww; ++r; }
  }
  __device__ __forceinline__ int at(int stride) const {
    return r * stride + c;
  }
};

// Global run g[0, nwords) <-> padded shared tile s (dir: true = load).
template <bool LOAD>
__device__ __forceinline__ void copy_tile(uint32_t* g, uint32_t* s,
                                          int nwords, int ww, int stride,
                                          bool vec) {
  const int t = threadIdx.x, nt = blockDim.x;
  int done = 0;
  if (vec) {
    const int nvec = nwords >> 2;
    uint4* g4 = reinterpret_cast<uint4*>(g);
    Cursor cur(4 * t, 4 * nt, ww);
    for (int k = t; k < nvec; k += nt, cur.advance()) {
      int r = cur.r, c = cur.c;
      uint32_t x[4];
      if (LOAD) {
        uint4 v = __ldcs(g4 + k);  // read once, write once: evict-first
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (LOAD) s[r * stride + c] = x[i];
        else x[i] = s[r * stride + c];
        if (++c == ww) { c = 0; ++r; }
      }
      if (!LOAD) __stcs(g4 + k, make_uint4(x[0], x[1], x[2], x[3]));
    }
    done = nvec << 2;
  }
  if (done + t < nwords) {
    Cursor cur(done + t, nt, ww);
    for (int j = done + t; j < nwords; j += nt, cur.advance()) {
      if (LOAD) s[cur.at(stride)] = g[j];
      else g[j] = s[cur.at(stride)];
    }
  }
}

// The first `budget` set bits of m, LSB first (0 < budget < popc(m)):
// t ends as the position of the budget-th set bit.
__device__ __forceinline__ uint32_t low_bits_upto(uint32_t m, int budget) {
  int t = 0;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    if (__popc(m & ((1u << (t + step)) - 1u)) < budget) t += step;
  }
  return m & ((2u << t) - 1u);
}

__global__ void selb_kernel(const uint32_t* __restrict__ win,
                            uint32_t* __restrict__ out, long long n,
                            int ww, int b, bool vec) {
  extern __shared__ uint32_t tile[];
  const int stride = ww | 1;
  const long long row0 = (long long)blockIdx.x * blockDim.x;
  const int rows = (int)min((long long)blockDim.x, n - row0);
  const int nwords = rows * ww;
  const long long base = row0 * ww;

  copy_tile<true>(const_cast<uint32_t*>(win) + base, tile, nwords, ww,
                  stride, vec);
  __syncthreads();

  if ((int)threadIdx.x < rows) {
    uint32_t* row = tile + threadIdx.x * stride;
    int budget = b;
    for (int w = ww - 1; w >= 0; --w) {
      const uint32_t m = row[w];
      const int pc = __popc(m);
      uint32_t keep = m;
      if (pc > budget) {
        keep = budget > 0 ? low_bits_upto(m, budget) : 0u;
        budget = 0;
      } else {
        budget -= pc;
      }
      row[w] = keep;
    }
  }
  __syncthreads();

  copy_tile<false>(out + base, tile, nwords, ww, stride, vec);
}

}  // namespace

extern "C" int selb_launch(const void* win, void* out, long long n, int ww,
                           int b, void* stream) {
  if (n <= 0 || ww <= 0) return (int)cudaGetLastError();
  const int stride = ww | 1;
  // fewer rows per block when a wide row would overflow the default
  // shared memory; beyond that, opt in to more (up to the card's limit)
  int rows = kRows;
  while (rows > 32 && (long long)rows * stride * 4 > kSmemDefault) rows /= 2;
  const size_t smem = (size_t)rows * stride * 4;
  if (smem > kSmemDefault) {
    cudaError_t e = cudaFuncSetAttribute(
        selb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte accesses need both bases aligned; every tile starts at a
  // multiple of 32 rows, so its offset keeps that alignment
  const bool vec = ((uintptr_t)win % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long blocks = (n + rows - 1) / rows;
  selb_kernel<<<(unsigned)blocks, rows, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)win, (uint32_t*)out, n, ww, b, vec);
  return (int)cudaGetLastError();
}
