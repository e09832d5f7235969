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
// oks read once (V*N bytes), the VB rows once, and of sel the rows that
// some delivering wave needs: at most all of it (N*WW*4).  At
// N = 1,000,000, WW = 12, V = 14, VB = 0 that is at most 158 MB.  sel
// (48 MB) does not stay in the 50 MB L2 across the waves: win, oks and
// the output stream through the same cache, and the V offsets are
// spread over N, so the waves read regions of sel far apart in time.
// Each wave that delivers to a receiver reads that receiver's source
// row from device memory, so the traffic follows the delivering
// (wave, receiver) pairs.  On the ring's period the two direct waves
// deliver to nearly every node and the 4k indirect waves only to nodes
// whose probe failed (well under 1% of them): on inputs captured from
// a 1M-node period the kernel takes the time of win, oks and two full
// sel passes (206 MB) at about 2.7 TB/s, not of one sel pass.
//
// Lanes: a batched study (the reference's vmap over `pallas_call`)
// passes P lanes in one launch, win[P, N, WW] with one lane each in the
// grid's y axis; sel, oks, offs, bcol and bval carry a lane stride, 0
// where the lanes share one copy.  Each lane is the one-lane kernel on
// its own slices, so its rolls wrap inside its own N rows.
//
// Design: a block of about 256 threads owns a tile of T consecutive
// receivers (T = 85 at WW = 12), one contiguous run of T*WW words of
// win; the tile's base is 64-bit and everything inside it is 32-bit.
// Each thread owns one fixed chunk of the run: 4 consecutive words with
// 16-byte accesses when WW % 4 == 0 (and win, sel 16-byte aligned),
// else 1 word.  A chunk lies in one receiver's row; the thread finds
// that receiver once.  Wave w's source is the contiguous run starting
// at row (start + offs[w]) mod N, so a chunk's source is at the same
// word offset in that run, split in at most two pieces at the wrap.
// The block first packs the ok bytes of its receivers into bit words
// in shared memory (the TPU kernel's `okbits`): its threads, in groups
// of T, each read every groups-th wave's byte of one receiver,
// coalesced, so every byte is read once and all threads share the
// reads.  Each warp ORs its lanes' ok words; a wave that no receiver of
// the warp takes is skipped with no sel load at all, and in a wave it
// does take, only lanes whose receiver takes it load.  Up to four
// waves' loads are in flight per thread before they are ORed into the
// register accumulator.  The forced-bit rows are staged through shared
// memory, one row at a time, read once per receiver.  win is read once
// and written once, with vector accesses marked evict-first, so it does
// not push sel out of L2.  Offsets are read on the device and wrapped
// with floor semantics, so any sign or magnitude works.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWaves = 32;
constexpr int kTargetThreads = 256;
constexpr int kMaxTile = kTargetThreads;  // T when a row is one chunk
constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;

template <int VEC> struct Vec;
template <> struct Vec<4> {
  using T = uint4;
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ T ld(const uint32_t* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  // win is touched once: read and write it evict-first
  static __device__ __forceinline__ T ld_once(const uint32_t* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void st(uint32_t* p, T v) {
    __stcs(reinterpret_cast<uint4*>(p), v);
  }
  static __device__ __forceinline__ void orr(T& a, T b) {
    a.x |= b.x; a.y |= b.y; a.z |= b.z; a.w |= b.w;
  }
  // OR v into the word of column col, if the chunk from column c0 has it
  static __device__ __forceinline__ void force(T& a, int col, int c0,
                                               uint32_t v) {
    a.x |= col == c0 ? v : 0u;
    a.y |= col == c0 + 1 ? v : 0u;
    a.z |= col == c0 + 2 ? v : 0u;
    a.w |= col == c0 + 3 ? v : 0u;
  }
};
template <> struct Vec<1> {
  using T = uint32_t;
  static __device__ __forceinline__ T zero() { return 0u; }
  static __device__ __forceinline__ T ld(const uint32_t* p) { return *p; }
  static __device__ __forceinline__ T ld_once(const uint32_t* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void st(uint32_t* p, T v) {
    __stcs(p, v);
  }
  static __device__ __forceinline__ void orr(T& a, T b) { a |= b; }
  static __device__ __forceinline__ void force(T& a, int col, int c0,
                                               uint32_t v) {
    a |= col == c0 ? v : 0u;
  }
};

// blockDim.x is a multiple of 32 and >= tile * (ww / VEC); thread j owns
// chunk j of the tile's run (none when j >= tile * (ww / VEC)).  LANES:
// the grid's y axis runs lanes; without it (one study) the kernel is the
// one-lane code, the lane offsets compiled out.
template <int VEC, bool LANES>
__global__ void wavemerge_kernel(uint32_t* __restrict__ win,
                                 const uint32_t* __restrict__ sel,
                                 const uint8_t* __restrict__ oks,
                                 const int32_t* __restrict__ offs,
                                 const int32_t* __restrict__ bcol,
                                 const uint32_t* __restrict__ bval,
                                 long long n, int ww, int v, int vb,
                                 int tile, long long ls_sel,
                                 long long ls_oks, long long ls_offs,
                                 long long ls_bcol, long long ls_bval) {
  using V = Vec<VEC>;
  if constexpr (LANES) {
    const long long lane = blockIdx.y;
    win += lane * n * ww;
    sel += lane * ls_sel;
    oks += lane * ls_oks;
    offs += lane * ls_offs;
    bcol += lane * ls_bcol;
    bval += lane * ls_bval;
  }
  __shared__ uint32_t s_ok[kMaxThreads];  // [groups][tile] partial ok words
  __shared__ int32_t s_bcol[kMaxTile];
  __shared__ uint32_t s_bval[kMaxTile];
  __shared__ long long s_src[kMaxWaves];  // first source word of the run
  __shared__ int s_rem[kMaxWaves];        // receivers before the wrap

  const long long start = (long long)blockIdx.x * tile;
  const int nt = (int)min((long long)tile, n - start);
  const int j = threadIdx.x;
  const int cw = ww / VEC;          // chunks per row
  const int r = j / cw;             // this chunk's receiver in the tile
  const int c0 = (j - r * cw) * VEC;  // its first column
  const int lw = j * VEC;           // its word offset in the run
  const bool have = r < nt;
  uint32_t* const out = win + start * ww + lw;

  typename V::T acc = have ? V::ld_once(out) : V::zero();

  if (j < v) {
    long long o = (long long)offs[j] % n;
    if (o < 0) o += n;
    long long s0 = start + o;
    if (s0 >= n) s0 -= n;
    const long long rem = n - s0;
    s_src[j] = s0 * ww;
    s_rem[j] = rem < tile ? (int)rem : tile;
  }
  // pack the ok bytes: the block's threads form `groups` groups of
  // `tile`; group g reads waves g, g + groups, ... of every receiver
  const int groups = blockDim.x / tile;
  const int g = j / tile;
  if (g < groups) {
    const int i = j - g * tile;
    uint32_t bits = 0;
    if (i < nt) {
      const uint8_t* ok = oks + start + i;
      for (int w = g; w < v; w += groups)
        bits |= (uint32_t)(ok[(long long)w * n] != 0) << w;
    }
    s_ok[j] = bits;
  }
  __syncthreads();

  uint32_t mine = 0;
  if (have)
    for (int h = 0; h < groups; ++h) mine |= s_ok[h * tile + r];
  uint32_t todo = __reduce_or_sync(0xffffffffu, mine);
  while (todo) {
    typename V::T got[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      got[u] = V::zero();
      if (todo) {
        const int w = __ffs(todo) - 1;
        todo &= todo - 1;
        if ((mine >> w) & 1u) {
          const int rem = s_rem[w];
          got[u] = V::ld(r < rem ? sel + s_src[w] + lw
                                 : sel + (lw - rem * ww));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) V::orr(acc, got[u]);
  }

  for (int q = 0; q < vb; ++q) {
    __syncthreads();
    if (j < nt) {
      s_bcol[j] = bcol[(long long)q * n + start + j];
      s_bval[j] = bval[(long long)q * n + start + j];
    }
    __syncthreads();
    if (have) V::force(acc, s_bcol[r], c0, s_bval[r]);
  }

  if (have) V::st(out, acc);
}

template <int VEC>
int launch(uint32_t* win, const uint32_t* sel, const uint8_t* oks,
           const int32_t* offs, const int32_t* bcol, const uint32_t* bval,
           long long n, int ww, int v, int vb, int lanes, long long ls_sel,
           long long ls_oks, long long ls_offs, long long ls_bcol,
           long long ls_bval, cudaStream_t stream) {
  const int cw = ww / VEC;
  if (cw > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int tile = cw >= kTargetThreads ? 1 : kTargetThreads / cw;
  const int threads = (tile * cw + 31) / 32 * 32;
  const long long blocks = (n + tile - 1) / tile;
  const dim3 grid((unsigned)blocks, (unsigned)lanes);
  if (lanes > 1)
    wavemerge_kernel<VEC, true><<<grid, threads, 0, stream>>>(
        win, sel, oks, offs, bcol, bval, n, ww, v, vb, tile, ls_sel, ls_oks,
        ls_offs, ls_bcol, ls_bval);
  else
    wavemerge_kernel<VEC, false><<<grid, threads, 0, stream>>>(
        win, sel, oks, offs, bcol, bval, n, ww, v, vb, tile, ls_sel, ls_oks,
        ls_offs, ls_bcol, ls_bval);
  return (int)cudaGetLastError();
}

}  // namespace

// lanes >= 1; ls_* are the lane strides, in elements, of sel, oks, offs,
// bcol and bval (0: shared by every lane).  win is lane-contiguous, N*WW
// elements a lane.
extern "C" int wavemerge_launch(void* win, const void* sel, const void* oks,
                                const void* offs, const void* bcol,
                                const void* bval, long long n, int ww, int v,
                                int vb, int lanes, long long ls_sel,
                                long long ls_oks, long long ls_offs,
                                long long ls_bcol, long long ls_bval,
                                void* stream) {
  if (n <= 0 || ww <= 0 || lanes <= 0) return (int)cudaGetLastError();
  if (v > kMaxWaves || lanes > 65535) return (int)cudaErrorInvalidValue;
  const bool vec = ww % 4 == 0 && (uintptr_t)win % 16 == 0 &&
                   (uintptr_t)sel % 16 == 0;
  auto* w = (uint32_t*)win;
  auto* s = (const uint32_t*)sel;
  auto* o = (const uint8_t*)oks;
  auto* f = (const int32_t*)offs;
  auto* bc = (const int32_t*)bcol;
  auto* bv = (const uint32_t*)bval;
  auto st = (cudaStream_t)stream;
  return vec ? launch<4>(w, s, o, f, bc, bv, n, ww, v, vb, lanes, ls_sel,
                         ls_oks, ls_offs, ls_bcol, ls_bval, st)
             : launch<1>(w, s, o, f, bc, bv, n, ww, v, vb, lanes, ls_sel,
                         ls_oks, ls_offs, ls_bcol, ls_bval, st);
}
