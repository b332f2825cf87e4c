// Philox4x32-10 counter-based generator (Random123; Salmon et al., SC'11).
//
// The device half of the stream contract written out in
// faid_tpu_torch/ops/philox.py, in two of its domains.  The channel's: the
// word for (seed, round, frame, bit) is word[bit % 4] of
// philox4x32_10((bit / 4, frame, round_lo, round_hi), (seed_lo, seed_hi))
// (kernels A, C, F and G).  The message domain's: message bit j of a frame
// is bit j % 32 of word (j / 32) % 4 of philox4x32_10((2^31 | (j / 128),
// frame, round_lo, round_hi), (seed_lo, seed_hi)) (message_stream.cu).
// The plain PyTorch version in ops/philox.py gives the same words bit for
// bit; chip_smoke.py and tests/test_torch_message_stream.py compare the
// two on the card.
#pragma once

#include <cstdint>

namespace faid {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k.x += kW0;
      k.y += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

}  // namespace faid
