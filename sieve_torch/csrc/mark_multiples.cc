// Native CPU mark_multiples: the segmented-sieve hot loop in C++.
//
// A word-wise strided bit-clear over a packed uint64 segment, popcount via
// __builtin_popcountll. The interface is the packing-agnostic marking spec
// of sieve_torch/kernels/specs.py: spec (m, r, s) clears flag bits
// {b : b == s (mod m), b >= s}, which every packing's composite-marking
// reduces to. Exposed through a C ABI for ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// Initialize a segment: all candidate flags set, tail bits beyond nbits 0.
void sieve_init(uint64_t* words, int64_t nwords, int64_t nbits) {
  memset(words, 0xFF, static_cast<size_t>(nwords) * 8);
  int64_t tail = nbits & 63;
  int64_t full = nbits >> 6;
  if (tail) {
    words[full] &= (1ULL << tail) - 1;
    ++full;
  }
  for (int64_t w = full; w < nwords; ++w) words[w] = 0;
}

// The hot loop: strided composite-marking for every spec.
void mark_multiples(uint64_t* words, int64_t nbits, const int64_t* m,
                    const int64_t* s, int64_t nspecs) {
  for (int64_t i = 0; i < nspecs; ++i) {
    const int64_t stride = m[i];
    for (int64_t b = s[i]; b < nbits; b += stride) {
      words[b >> 6] &= ~(1ULL << (b & 63));
    }
  }
}

int64_t popcount_words(const uint64_t* words, int64_t nwords) {
  int64_t total = 0;
  for (int64_t w = 0; w < nwords; ++w) {
    total += __builtin_popcountll(words[w]);
  }
  return total;
}

// Pairs (b, b+shift) with both flags set, left member's position allowed
// by pair_mask (a 64-bit mask whose period-8 pattern encodes the wheel30
// pairable residue classes; all-ones for plain/odds). Tail bits beyond
// nbits are already 0, so out-of-range pairs self-exclude.
int64_t twin_count(const uint64_t* words, int64_t nwords, int shift,
                   uint64_t pair_mask) {
  int64_t total = 0;
  for (int64_t w = 0; w < nwords; ++w) {
    uint64_t right = words[w] >> shift;
    if (w + 1 < nwords) {
      right |= words[w + 1] << (64 - shift);
    }
    total += __builtin_popcountll(words[w] & right & pair_mask);
  }
  return total;
}

}  // extern "C"
