// Mark+reduce of one sieve segment, fused and split, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of sieve/kernels/pallas_mark.py, which
// share their marking body _mark_tile:
//  - fused_mark_kernel: _make_fused_kernel (run by mark_pallas_fused),
//    need_bits false and true. Every bit b of the segment with
//    b % m == rK % m is cleared for every live spec of groups A-D, then the
//    flat clears, then the self-mark corrections, then the validity mask at
//    nbits; the result is the popcount, the pair count, the first word and
//    the last 32 flag bits, and with NEED_BITS the final words.
//  - split_mark_kernel: _make_kernel (run by mark_pallas_split and the
//    mesh's split step). Marking only: every live A-D spec clears its bits
//    in every tile, padding past nbits included, and the raw words go to
//    device memory; the flat clears, corrections, mask and reductions are
//    the postlude's (sieve_torch/kernels/reduce.py), as in the reference.
// Both compute the same functions of the same host tables
// (sieve_torch/kernels/cuda_mark.py prepares them array for array as the
// reference does) and share the marking phase, mark_tile.
//
// What bounds them. The inputs are spec tables of a few hundred KB and the
// outputs a few scalars (the split kernel and NEED_BITS add one store of
// 4*Wpad bytes), so they move almost no bytes: they are bound by 32-bit
// integer operations. The function needs one clear per hit: 32*Wpad/m
// for a spec of stride m (one pattern AND per word for group A), plus the
// popcounts and pair splices per word. A kernel that tests every (word,
// spec) does ~10-30x that work, since a word holds a hit of group B or C
// for only ~26 of its 553 specs.
//
// What the design does about it.
//  - One block per (128 x 128)-word tile, the tile's 16,384 words in 64 KB
//    of dynamic shared memory, two 1,024-thread blocks per SM. The TPU
//    walked tiles in order and carried the sums and the edge pair from
//    tile to tile; here blocks run in parallel, each writes an 8-word
//    partial, and a one-block combine kernel adds the partials and the
//    pairs across tile edges.
//  - Group A (m < 32, several hits per word) keeps a register pattern:
//    each thread ANDs a shifted m-periodic mask into its 16 words. The
//    TPU had no integer divide and used an f32-reciprocal mod; here one
//    exact % per (tile, spec) finds the tile's first hit, the thread's
//    offset from it takes a multiply-high by a per-tile constant, and the
//    next word's offset one subtract and one conditional add. The densest
//    B specs (m < kRegisterMaxM, a hit every 1-3 words) take the same
//    pass with a one-bit mask: there it costs less than one atomic per hit
//    (PERF.md has the measured threshold).
//  - The other B specs and groups C and D walk their hits in the tile
//    instead of testing words: one % per (tile, spec) finds the first hit,
//    each next hit is m bits further, and each hit is one shared-memory
//    atomicAnd. The work is cut into items that warps take from a shared
//    counter, largest first: a B spec (512-5,700 hits) is one item walked
//    by the whole warp, lane l taking hits l, l+32, ...; 32 consecutive
//    specs of group C or D are one item, a spec per lane (at most 512 hits
//    each). The TPU had no scatter and placed group D's hits by a 128-step
//    lane roll.
//  - Flat clears (atomicAnd) and corrections (atomicOr) walk only the
//    tile's own entries, through the per-tile cursors.
//  - The split kernel stores the marked tile with coalesced 4-byte writes,
//    thread i on word i of each 1024-word stripe.

#include <atomic>

#include <cuda_runtime.h>

namespace {

constexpr int kTileWords = 16384;           // R_ROWS (128) x 128 lanes
constexpr int kTileBits = kTileWords * 32;
constexpr int kThreads = 1024;
constexpr int kWordsPerThread = kTileWords / kThreads;
constexpr int kGroupA = 16;                 // NA_PAD
// B specs of the first kRegisterB slots with m < kRegisterMaxM hit a word
// often enough that testing every word in registers beats walking them
// (measured on the H100 against 0, 64, 128 and every B spec; PERF.md)
constexpr int kRegisterB = 32;
constexpr int kRegisterMaxM = 96;

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

// Clears every stride-th bit of the tile from bit b on, one shared-memory
// atomicAnd each: the hits of one spec, or every 32nd of them.
__device__ __forceinline__ void walk(unsigned* tile, int b, int stride) {
  for (; b < kTileBits; b += stride)
    atomicAnd(&tile[b >> 5], ~(1u << (b & 31)));
}

// Clears the hits of spec i of a C or D table in the tile.
__device__ __forceinline__ void walk_spec(unsigned* tile, int tile_bit,
                                          const int* ms, const int* rks,
                                          const unsigned* acts, int i) {
  const unsigned act = acts[i];             // the three loads at once
  const int m = ms[i], rk = rks[i];
  if (act) walk(tile, (rk - tile_bit) % m, m);
}

// Whether B slot i takes the register pass instead of the hit walk.
__device__ __forceinline__ bool in_registers(int i, int m) {
  return i < kRegisterB && m < kRegisterMaxM;
}

// The marking phase shared by both kernels (the reference's _mark_tile):
// group A and the densest B specs in registers, stored to the tile in
// shared memory, then the hit walks of groups B, C and D on the tile.
// Leaves tile t's marked words in `tile` and ends synchronised.
__device__ __forceinline__ void mark_tile(const Tables& tb, int t,
                                         unsigned* tile) {
  // per-tile constants of the register pass: slot i < kGroupA is A spec i,
  // slot kGroupA + j is B spec j
  __shared__ int r_off[kGroupA + kRegisterB];       // first hit in the tile
  __shared__ unsigned r_magic[kGroupA + kRegisterB];  // x/m = umulhi(x, magic)
  __shared__ int r_step[kGroupA + kRegisterB];      // (32 * kThreads) % m
  __shared__ unsigned a_pat[kGroupA];               // bits 0, m, 2m, ... < 32
  __shared__ int next_item;
  const int tid = threadIdx.x, lane = tid & 31;
  const int tile_bit = 32 * t * kTileWords;  // rK > 32 * Wpad > tile_bit

  // --- one % and one divide per (tile, spec) of the register pass
  if (tid < kGroupA + kRegisterB) {
    const bool is_a = tid < kGroupA;
    const int i = is_a ? tid : tid - kGroupA;
    if (is_a ? tb.a_act[i] != 0u
             : i < tb.sb && tb.b_act[i] && in_registers(i, tb.b_m[i])) {
      const int m = (is_a ? tb.a_m : tb.b_m)[i];
      r_off[tid] = ((is_a ? tb.a_rk : tb.b_rk)[i] - tile_bit) % m;
      r_magic[tid] = 0xFFFFFFFFu / m + 1u;  // exact while x * m < 2^32
      r_step[tid] = (32 * kThreads) % m;
      if (is_a) {
        unsigned pat = 0u;
        for (int b = 0; b < 32; b += m) pat |= 1u << b;
        a_pat[i] = pat;
      }
    }
  }
  if (tid == 0) next_item = 0;
  __syncthreads();

  // --- the register pass: word k of this thread is tile word
  // tid + k * kThreads, at bit x + k * 32 * kThreads of the tile, and
  // s is (rK - its first bit) % m
  unsigned w[kWordsPerThread];
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) w[k] = 0xFFFFFFFFu;
  const unsigned x = 32u * tid;
  for (int i = 0; i < kGroupA; ++i) {       // group A: several bits a word
    if (!tb.a_act[i]) continue;             // padding: uniform over the block
    const int m = tb.a_m[i], step = r_step[i];
    const unsigned pat = a_pat[i];
    int s = r_off[i] - static_cast<int>(x - __umulhi(x, r_magic[i]) * m);
    if (s < 0) s += m;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      w[k] &= ~(pat << s);                  // bits s, s+m, ... < 32
      s -= step;
      if (s < 0) s += m;
    }
  }
  const int nr = min(tb.sb, kRegisterB);
  for (int i = 0; i < nr; ++i) {            // dense B specs: one bit or none
    if (!tb.b_act[i]) continue;             // uniform over the block
    const int m = tb.b_m[i];
    if (!in_registers(i, m)) continue;
    const int j = kGroupA + i, step = r_step[j];
    int s = r_off[j] - static_cast<int>(x - __umulhi(x, r_magic[j]) * m);
    if (s < 0) s += m;
#pragma unroll
    for (int k = 0; k < kWordsPerThread; ++k) {
      w[k] &= ~__funnelshift_lc(0u, 1u, s);  // 1 << s, 0 past bit 31
      s -= step;
      if (s < 0) s += m;
    }
  }
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) tile[tid + k * kThreads] = w[k];
  __syncthreads();

  // --- the hit walks, in items that warps take from a shared counter,
  // largest first: one per B spec (lane l takes its hits l, l+32, ...),
  // then one per 32 C specs and one per 32 D specs (a spec per lane). A
  // warp takes its next item before walking this one, so the counter's
  // latency hides behind the walk.
  const int nb = tb.sb;
  const int nc = nb + (tb.sc + 31) / 32;
  const int items = nc + (tb.nd + 31) / 32;
  int item = 0;
  if (lane == 0) item = atomicAdd(&next_item, 1);
  item = __shfl_sync(0xFFFFFFFFu, item, 0);
  while (item < items) {
    int next = 0;
    if (lane == 0) next = atomicAdd(&next_item, 1);
    if (item < nb) {
      const unsigned act = tb.b_act[item];
      const int m = tb.b_m[item], rk = tb.b_rk[item];
      if (act && !in_registers(item, m))
        walk(tile, (rk - tile_bit) % m + lane * m, 32 * m);
    } else if (item < nc) {
      const int i = 32 * (item - nb) + lane;
      if (i < tb.sc) walk_spec(tile, tile_bit, tb.c_m, tb.c_rk, tb.c_act, i);
    } else {
      const int i = 32 * (item - nc) + lane;
      if (i < tb.nd) walk_spec(tile, tile_bit, tb.d_m, tb.d_rk, tb.d_act, i);
    }
    item = __shfl_sync(0xFFFFFFFFu, next, 0);
  }
  __syncthreads();
}

// Marking only: the raw words of tile t, padding past nbits included.
__global__ void __launch_bounds__(kThreads, 2)
split_mark_kernel(Tables tb, unsigned* __restrict__ words_out) {
  extern __shared__ unsigned tile[];
  const int t = blockIdx.x;
  mark_tile(tb, t, tile);
  unsigned* out = words_out + t * kTileWords;
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k)
    out[threadIdx.x + k * kThreads] = tile[threadIdx.x + k * kThreads];
}

template <bool NEED_BITS>
__global__ void __launch_bounds__(kThreads, 2)
fused_mark_kernel(Tables tb, unsigned* __restrict__ words_out,
                  unsigned* __restrict__ partials) {
  extern __shared__ unsigned tile[];
  __shared__ unsigned scratch[kThreads / 32];
  const int t = blockIdx.x;
  const int base = t * kTileWords;
  const int tid = threadIdx.x;
  mark_tile(tb, t, tile);
  unsigned w[kWordsPerThread];

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
constexpr size_t kTileBytes = kTileWords * sizeof(unsigned);

// The 64 KB shared-memory opt-in is set once per (kernel, device); a
// repeated set from a racing caller is harmless.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, std::atomic<bool>* done, int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device].load(std::memory_order_acquire)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kTileBytes));
    if (e != cudaSuccess) return e;
    done[device].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

template <bool NEED_BITS>
cudaError_t launch_mark(const Tables& tb, int G, unsigned* words_out,
                        unsigned* partials, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  const cudaError_t e =
      opt_in_smem(fused_mark_kernel<NEED_BITS>, smem_set, device);
  if (e != cudaSuccess) return e;
  fused_mark_kernel<NEED_BITS><<<G, kThreads, kTileBytes, stream>>>(
      tb, words_out, partials);
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

// Launches the split marking kernel (G blocks) on `stream`: the raw
// marked words of the G tiles go to words_out (G * 16384 words). Every
// pointer is device memory. Allocates nothing and does not synchronise.
// Returns the CUDA error code.
int sieve_split_mark(
    const int* a_m, const int* a_rk, const unsigned* a_act,
    const int* b_m, const int* b_rk, const unsigned* b_act, int sb,
    const int* c_m, const int* c_rk, const unsigned* c_act, int sc,
    const int* d_m, const int* d_rk, const unsigned* d_act, int nd,
    int G, unsigned* words_out, int device, void* stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = opt_in_smem(split_mark_kernel, smem_set, device);
  if (e != cudaSuccess) return e;
  const Tables tb{a_m, a_rk, a_act, b_m, b_rk, b_act, sb,
                  c_m, c_rk, c_act, sc, d_m, d_rk, d_act, nd,
                  nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  0, 0u, 0};
  split_mark_kernel<<<G, kThreads, kTileBytes,
                      static_cast<cudaStream_t>(stream)>>>(tb, words_out);
  return cudaGetLastError();
}

const char* sieve_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
