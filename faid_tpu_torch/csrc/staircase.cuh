// The quantile channel's per-bit device code, shared by kernel A (the
// ModCalErr counts) and kernel C (the ModCalErr map) in
// quantile_channel.cu.  Both kernels include this one copy, so for the
// same (seed, round, frame, bit) they draw the same Philox word and push
// it through the same staircase: the replay's LLRs are the sweep's, bit
// for bit.  The plain PyTorch version is ops/cuda_channel.py `staircase`
// on the words of ops/philox.py `channel_words`.
#pragma once

#include <cstdint>

#include "philox.cuh"

namespace faid {

constexpr int kMaxParams = 63;  // 2L+1 for the 6-bit quantizer (L = 31)

// The stream words of bits 4g .. 4g+3 of one frame.
__device__ __forceinline__ uint4 channel_words4(int g, uint32_t frame, uint32_t round_lo,
                                                uint32_t round_hi, uint2 key) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(g), frame, round_lo, round_hi),
                       key);
}

// One bit through the 2L-step strict-compare staircase.  `ix` is the
// stream word as int32, `mask` 0 for a sent 0-bit and -1 for a 1-bit
// (it mirrors the grid), `sp` the thresholds [A_1..A_L, B_1..B_L, H].
// Returns the int8 LLR; `*err` is the pre-decoder error indicator
// ix_e > H.
__device__ __forceinline__ int staircase_bit(int ix, int mask, const int32_t* sp, int L,
                                             int clip_lo, int clip_hi, int* err) {
  const int ixe = ix ^ mask;
  int q = 0;
  for (int i = 0; i < L; ++i) {
    q += ixe > sp[i];
    q -= ixe < sp[L + i];
  }
  q = (q ^ mask) - mask;               // restore the bit's sign
  q = min(max(q, clip_lo), clip_hi);   // asymmetric 3/5-bit clip
  *err = ixe > sp[2 * L];
  return q;
}

}  // namespace faid
