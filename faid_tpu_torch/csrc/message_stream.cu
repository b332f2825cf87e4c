// The message stream: the message bits [batch, n_bits] int8 0/1 of a round
// with real codewords, in one launch.
//
// Replaces no TPU kernel: the JAX pipeline draws its messages with
// jax.random (`_random_message_bits`) inside its jitted round.  The port
// draws them from the message domain of the Philox stream (ops/philox.py,
// "Stream contract"), whose plain PyTorch version, `message_bits_plain`,
// runs the generator as int64 tensor ops: some 235 small launches a round,
// each paced by the host.  This kernel writes the same bits, bit for bit.
//
//   counter = (2^31 | (j / 128), frame0 + b, round_lo, round_hi)
//   key     = (seed_lo, seed_hi)
//   bit j   = (w[(j / 32) % 4] >> (j % 32)) & 1
//
// Read as little-endian bytes, a call's four words are its 128 bits in
// order: byte m holds bits 8m .. 8m+7 of the call.  So a row's message is
// the bits of its calls' words laid end to end, one output byte a bit.
//
// What bounds it on the H100: bytes.  At batch 2048 and 14,592 bits a row
// it writes 29.9 MB of int8 (8.9 us at 3.35 TB/s) against 233 K Philox
// calls (~16 M int32 operations, ~1 us).  The design:
//   - one warp a tile of 32 consecutive calls of one row (4,096 bits);
//     each lane makes one call and puts its 16 bytes in the warp's slice of
//     shared memory, so no call is made twice;
//   - each lane then takes 16 bits (one uint16 of the slice) at a time and
//     expands them into 16 bytes, four bits to four bytes with a multiply
//     and a mask, and stores them as one 16-byte vector: a warp's store
//     covers 512 consecutive bytes of the row;
//   - rows whose length is not a multiple of 16 bytes (toy codes) take the
//     byte-wise store of the same bits, and the last call of a row may be
//     made for fewer than 128 bits.
#include <cuda_runtime.h>

#include <cstdint>

#include "philox.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a block, one tile each
constexpr int kCallsPerTile = 32;         // one call a lane
constexpr int kBitsPerTile = kCallsPerTile * 128;
constexpr uint32_t kMessageDomain = 0x80000000u;  // counter word 0's top bit

// Four bits -> four bytes 0/1, bit k in byte k (little-endian): the multiply
// puts copies of the nibble at bits 0, 7, 14 and 21, which do not overlap,
// so bit k of the nibble lands on bit 8k.
__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

template <bool kVector>
__global__ void __launch_bounds__(kWarps * 32)
message_bits_kernel(int8_t* __restrict__ out, long long items, int tiles, int n_bits,
                    uint2 key, uint32_t round_lo, uint32_t round_hi, uint32_t frame0) {
  __shared__ uint4 packed[kWarps][kCallsPerTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (item >= items) return;                      // the whole warp
  const int b = static_cast<int>(item / tiles);
  const int tile = static_cast<int>(item % tiles);

  const int calls = (n_bits + 127) >> 7;
  const int call = tile * kCallsPerTile + lane;
  if (call < calls) {
    packed[warp][lane] = faid::philox4x32_10(
        make_uint4(kMessageDomain | static_cast<uint32_t>(call),
                   frame0 + static_cast<uint32_t>(b), round_lo, round_hi),
        key);
  }
  __syncwarp();

  // uint16 v of the slice is bits 16v .. 16v+15 of the tile
  const uint16_t* halves = reinterpret_cast<const uint16_t*>(packed[warp]);
  const int bit0 = tile * kBitsPerTile;
  const int vecs = (min(kBitsPerTile, n_bits - bit0) + 15) >> 4;
  int8_t* row = out + static_cast<size_t>(b) * n_bits + bit0;
  for (int v = lane; v < vecs; v += 32) {
    const uint32_t h = halves[v];
    if constexpr (kVector) {
      *reinterpret_cast<uint4*>(row + 16 * v) =
          make_uint4(spread4(h & 0xFu), spread4((h >> 4) & 0xFu),
                     spread4((h >> 8) & 0xFu), spread4(h >> 12));
    } else {
      const int left = n_bits - bit0 - 16 * v;
      for (int k = 0; k < 16 && k < left; ++k) {
        row[16 * v + k] = static_cast<int8_t>((h >> k) & 1u);
      }
    }
  }
}

}  // namespace

// The message bits of frames frame0 .. frame0 + batch - 1 of round `round`
// into `out`, a contiguous int8 [batch, n_bits] on the current device.
extern "C" int faid_message_bits(void* out, int batch, int n_bits,
                                 unsigned long long seed, unsigned long long round,
                                 unsigned int frame0, void* stream) {
  if (batch <= 0 || n_bits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n_bits + kBitsPerTile - 1) / kBitsPerTile;
  const long long items = static_cast<long long>(batch) * tiles;
  const long long blocks = (items + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  const bool vector = n_bits % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto kernel = vector ? message_bits_kernel<true> : message_bits_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(out), items, tiles, n_bits, key,
      static_cast<uint32_t>(round), static_cast<uint32_t>(round >> 32), frame0);
  return static_cast<int>(cudaGetLastError());
}
