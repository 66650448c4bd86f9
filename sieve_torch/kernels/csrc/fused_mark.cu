// Fused mark+reduce of one sieve segment, for Hopper (sm_90a).
//
// Replaces the TPU kernel of sieve/kernels/pallas_mark.py:
// _make_fused_kernel with its body _mark_tile (run by mark_pallas_fused),
// need_bits false and true. It computes the same function of the same
// host tables (sieve_torch/kernels/cuda_mark.py prepares them array for
// array as the reference does): every bit b of the segment with
// b % m == rK % m is cleared for every live spec of groups A-D, then the
// flat clears, then the self-mark corrections, then the validity mask at
// nbits; the result is the popcount, the pair count, the first word and
// the last 32 flag bits, and with NEED_BITS the final words.
//
// What bounds it. The inputs are a few spec tables and the outputs a few
// scalars (plus the words with NEED_BITS), so it moves almost no bytes: it
// is bound by integer operations. The function needs one clear per hit:
// 32*Wpad/m for a spec of stride m (one pattern AND per word for group
// A), plus the popcounts and pair splices per word. This kernel does
// more: groups A-C test every (word, spec), (SA+SB+SC) per word; group D
// walks its hits, but pays one % per (tile, live spec).
//
// What the design does about it.
//  - One block per (128 x 128)-word tile, the tile's 16,384 words in 64 KB
//    of dynamic shared memory. The TPU walked tiles in order and carried
//    the sums and the edge pair from tile to tile; here blocks run in
//    parallel, each writes an 8-word partial, and a one-block combine
//    kernel adds the partials and the pairs across tile edges.
//  - Groups A-C: each thread keeps its 16 words in registers. The TPU had
//    no integer divide and used an f32-reciprocal mod; here an exact
//    integer % finds the first hit of the thread's first word, and the
//    thread's next word (32 * 1024 bits further) steps the hit by one
//    subtract and one conditional add, so the % runs twice per (thread,
//    spec) instead of once per (word, spec).
//  - Group D: the TPU had no scatter and placed each row's hit by a
//    128-step lane roll. Here one thread per spec walks the spec's hits in
//    the tile (at most one per 4096-bit row) and clears each with a
//    shared-memory atomicAnd.
//  - Flat clears (atomicAnd) and corrections (atomicOr) walk only the
//    tile's own entries, through the per-tile cursors.

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kTileWords = 16384;           // R_ROWS (128) x 128 lanes
constexpr int kTileBits = kTileWords * 32;
constexpr int kThreads = 1024;
constexpr int kWordsPerThread = kTileWords / kThreads;
constexpr int kGroupA = 16;                 // NA_PAD

struct Tables {
  const int* a_m; const int* a_rk; const unsigned* a_act;
  const int* b_m; const int* b_rk; const unsigned* b_act; int sb;
  const int* c_m; const int* c_rk; const unsigned* c_act; int sc;
  const int* d_m; const int* d_rk; const unsigned* d_act; int nd;
  const int* corr_idx; const unsigned* corr_mask; const int* coff;
  const int* flat_idx; const unsigned* flat_mask; const int* foff;
  int nbits;
  unsigned pair_mask;
  int shift;                                // 0: no pair count
};

__device__ __forceinline__ int floor_div32(int x) {
  return x >= 0 ? x / 32 : -((31 - x) / 32);
}

__device__ __forceinline__ unsigned splice(unsigned w, unsigned nxt, int shift) {
  const unsigned low = (1u << shift) - 1u;
  return (w >> shift) | ((nxt & low) << (32 - shift));
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Sums v over the block into thread 0's return value.
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();                          // scratch may still be read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < (kThreads / 32) ? scratch[threadIdx.x] : 0u;
  return warp < 1 ? warp_sum(v) : 0u;
}

// Groups A-C on the thread's words; SINGLE is false for group A, whose
// strides m < 32 hit a word several times.
template <bool SINGLE>
__device__ __forceinline__ void mark_group(unsigned (&w)[kWordsPerThread],
                                           const int* ms, const int* rks,
                                           const unsigned* acts, int n,
                                           int first_bit) {
  for (int i = 0; i < n; ++i) {
    const unsigned act = acts[i];
    if (!act) continue;                     // padding: uniform over the block
    const int m = ms[i];
    const int step = (32 * kThreads) % m;
    int t = (rks[i] - first_bit) % m;       // rK > 32 * Wpad > first_bit
    unsigned pat = 1u;
    if (!SINGLE)
      for (int b = m; b < 32; b += m) pat |= 1u << b;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      if (SINGLE) {
        if (t < 32) w[k] &= ~((1u << t) & act);
      } else {
        w[k] &= ~((pat << t) & act);        // bits t, t+m, ... < 32
      }
      t -= step;
      if (t < 0) t += m;
    }
  }
}

template <bool NEED_BITS>
__global__ void __launch_bounds__(kThreads)
fused_mark_kernel(Tables tb, unsigned* __restrict__ words_out,
                  unsigned* __restrict__ partials) {
  extern __shared__ unsigned tile[];
  __shared__ unsigned scratch[kThreads / 32];
  const int t = blockIdx.x;
  const int base = t * kTileWords;
  const int tid = threadIdx.x;

  // --- groups A, B, C in registers: word k of this thread is
  // base + tid + k * kThreads
  unsigned w[kWordsPerThread];
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) w[k] = 0xFFFFFFFFu;
  const int first_bit = 32 * (base + tid);
  mark_group<false>(w, tb.a_m, tb.a_rk, tb.a_act, kGroupA, first_bit);
  mark_group<true>(w, tb.b_m, tb.b_rk, tb.b_act, tb.sb, first_bit);
  mark_group<true>(w, tb.c_m, tb.c_rk, tb.c_act, tb.sc, first_bit);
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) tile[tid + k * kThreads] = w[k];
  __syncthreads();

  // --- group D: each spec walks its hits in the tile
  const int tile_bit = 32 * base;
  for (int i = tid; i < tb.nd; i += kThreads) {
    if (!tb.d_act[i]) continue;
    const int m = tb.d_m[i];
    for (int b = (tb.d_rk[i] - tile_bit) % m; b < kTileBits; b += m)
      atomicAnd(&tile[b >> 5], ~(1u << (b & 31)));
  }
  __syncthreads();

  // --- patches: flat clears before corrections (a flat class can cross
  // its own seed's bit, which the correction re-sets)
  for (int i = tb.foff[t] + tid; i < tb.foff[t + 1]; i += kThreads)
    atomicAnd(&tile[tb.flat_idx[i] - base], ~tb.flat_mask[i]);
  __syncthreads();
  for (int i = tb.coff[t] + tid; i < tb.coff[t + 1]; i += kThreads)
    atomicOr(&tile[tb.corr_idx[i] - base], tb.corr_mask[i]);
  __syncthreads();

  // --- validity mask: no flag at or past nbits survives
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int li = tid + k * kThreads;
    int valid = tb.nbits - 32 * (base + li);
    valid = valid < 0 ? 0 : (valid > 32 ? 32 : valid);
    unsigned x = tile[li];
    if (valid < 32) x &= (1u << valid) - 1u;
    w[k] = x;
    tile[li] = x;
    if (NEED_BITS) words_out[base + li] = x;
  }
  __syncthreads();

  // --- in-tile reduction; the tile's last word pairs with the next
  // tile's first, which the combine kernel handles
  unsigned cnt = 0, prs = 0;
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int li = tid + k * kThreads;
    cnt += __popc(w[k]);
    if (tb.shift && li + 1 < kTileWords)
      prs += __popc(w[k] & splice(w[k], tile[li + 1], tb.shift) & tb.pair_mask);
  }
  cnt = block_sum(cnt, scratch);
  prs = block_sum(prs, scratch);
  if (tid == 0) {
    const int wl = floor_div32(tb.nbits - 32);
    unsigned* p = partials + 8 * t;
    p[0] = cnt;
    p[1] = prs;
    p[2] = tile[0];
    p[3] = tile[kTileWords - 1];
    p[4] = (wl >= base && wl < base + kTileWords) ? tile[wl - base] : 0u;
    p[5] = (wl + 1 >= base && wl + 1 < base + kTileWords) ? tile[wl + 1 - base] : 0u;
    p[6] = 0u;
    p[7] = 0u;
  }
}

// One block: adds the G tile partials and the pairs across tile edges,
// and builds the last-boundary splice from the words at wl and wl+1.
__global__ void __launch_bounds__(kThreads)
combine_kernel(const unsigned* __restrict__ partials, int G, int nbits,
               unsigned pair_mask, int shift, unsigned* __restrict__ result) {
  __shared__ unsigned scratch[kThreads / 32];
  unsigned cnt = 0, prs = 0, at_wl = 0, at_wl1 = 0;
  for (int t = threadIdx.x; t < G; t += kThreads) {
    const unsigned* p = partials + 8 * t;
    cnt += p[0];
    prs += p[1];
    at_wl |= p[4];                          // one tile holds each word,
    at_wl1 |= p[5];                         // the others hold 0
    if (shift && t + 1 < G) {
      const unsigned last = p[3], first = partials[8 * (t + 1) + 2];
      prs += __popc(last & splice(last, first, shift) & pair_mask);
    }
  }
  cnt = block_sum(cnt, scratch);
  prs = block_sum(prs, scratch);
  at_wl = block_sum(at_wl, scratch);
  at_wl1 = block_sum(at_wl1, scratch);
  if (threadIdx.x == 0) {
    const int off = nbits - 32;
    const int sh = off - 32 * floor_div32(off);
    result[0] = cnt;
    result[1] = prs;
    result[2] = partials[2];
    result[3] = (at_wl >> sh) | (sh == 0 ? 0u : at_wl1 << (32 - sh));
  }
}

constexpr int kMaxDevices = 64;

// The 64 KB shared-memory opt-in is set once per (variant, device); a
// repeated set from a racing caller is harmless.
template <bool NEED_BITS>
cudaError_t launch_mark(const Tables& tb, int G, unsigned* words_out,
                        unsigned* partials, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  const size_t smem = kTileWords * sizeof(unsigned);
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[device].load(std::memory_order_acquire)) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_mark_kernel<NEED_BITS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_set[device].store(true, std::memory_order_release);
  }
  fused_mark_kernel<NEED_BITS><<<G, kThreads, smem, stream>>>(tb, words_out,
                                                               partials);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the mark kernel (G blocks) and the combine kernel on `stream`.
// Every pointer is device memory; words_out may be null (no NEED_BITS).
// Allocates nothing and does not synchronise. Returns the CUDA error code.
int sieve_fused_mark(
    const int* a_m, const int* a_rk, const unsigned* a_act,
    const int* b_m, const int* b_rk, const unsigned* b_act, int sb,
    const int* c_m, const int* c_rk, const unsigned* c_act, int sc,
    const int* d_m, const int* d_rk, const unsigned* d_act, int nd,
    const int* corr_idx, const unsigned* corr_mask, const int* coff,
    const int* flat_idx, const unsigned* flat_mask, const int* foff,
    int G, int nbits, unsigned pair_mask, int shift,
    unsigned* words_out, unsigned* partials, unsigned* result,
    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const Tables tb{a_m, a_rk, a_act, b_m, b_rk, b_act, sb,
                  c_m, c_rk, c_act, sc, d_m, d_rk, d_act, nd,
                  corr_idx, corr_mask, coff, flat_idx, flat_mask, foff,
                  nbits, pair_mask, shift};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = words_out ? launch_mark<true>(tb, G, words_out, partials, device, s)
                : launch_mark<false>(tb, G, words_out, partials, device, s);
  if (e != cudaSuccess) return e;
  combine_kernel<<<1, kThreads, 0, s>>>(partials, G, nbits, pair_mask, shift,
                                        result);
  return cudaGetLastError();
}

const char* sieve_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
