// Kernels A and C: the fused quantile channel.
//
// Kernel A replaces faid_tpu/ops/pallas_channel.py `_kernel_stats` (built
// by `build_fused_channel_stats`): one uniform word per bit, XORed with
// the sent bit's mask, pushed through the 2L-step strict-compare
// staircase (`staircase`) into the int8 LLR, and the pre-decoder error
// indicator `ix_e > H` reduced per frame over the first n_info bits into
// bit and QPSK-symbol counts (`mod_stats_tile`).
//
// Kernel C replaces `_kernel` (built by `build_fused_channel`), the
// replay variant: the same draw and staircase, with the indicator
// written out as an int8 [B, n] map instead of reduced.
//
// Both are one template over `kStats`, and both take the draw and the
// staircase from staircase.cuh, so C's LLRs equal A's bit for bit for
// the same (seed, round, frame0).  The TPU's hardware PRNG becomes the
// Philox stream of philox.cuh.  The punctured tail is NOT zeroed here:
// the LLR is the channel's output as in the JAX package, and the
// decoder's ingest zeroes the tail (stats_decoder.cu).
//
// What bounds it on the H100: per bit, a quarter of one Philox4x32-10
// call (10 rounds of two 32x32 multiplies) and 2L+1 compares, against one
// int8 store (two for C; 17.6 KB per frame and map, plus 1 byte read per
// bit when a codeword is given).  At batch 2048 that is 36 MB (C: 72 MB)
// written against ~9 M Philox calls, so it is bound by integer issue
// rate, not by memory.
//
// First design: one block per frame (2048 blocks), 256 threads; each
// thread takes 4 consecutive bits per Philox call (one counter), so one
// call feeds 4 LLRs and a QPSK pair never straddles two threads.  A's
// counts go through warp shuffles and one shared-memory add per warp.
// The thresholds live in shared memory.
#include <cuda_runtime.h>

#include <cstdint>

#include "staircase.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kStats>
__global__ void __launch_bounds__(kThreads)
quantile_channel_kernel(const int8_t* __restrict__ cw, int8_t* __restrict__ llr,
                        int8_t* __restrict__ err_map, int32_t* __restrict__ bits,
                        int32_t* __restrict__ syms, const int32_t* __restrict__ params,
                        int n_var, int n_info, int mod_type, int L, int clip_lo,
                        int clip_hi, uint2 key, uint32_t round_lo, uint32_t round_hi,
                        uint32_t frame0) {
  __shared__ int32_t sp[faid::kMaxParams];
  __shared__ int32_t s_bits, s_syms;
  const int f = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * L + 1; i += blockDim.x) sp[i] = params[i];
  if (kStats && threadIdx.x == 0) {
    s_bits = 0;
    s_syms = 0;
  }
  __syncthreads();

  const size_t row = static_cast<size_t>(f) * n_var;
  const int groups = (n_var + 3) / 4;
  int nb = 0, ns = 0;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const uint4 w = faid::channel_words4(g, frame0 + f, round_lo, round_hi, key);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    int e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bit = 4 * g + j;
      e[j] = 0;
      if (bit < n_var) {
        const int mask = cw ? -static_cast<int>(cw[row + bit] != 0) : 0;
        int err;
        llr[row + bit] = static_cast<int8_t>(faid::staircase_bit(
            static_cast<int>(ws[j]), mask, sp, L, clip_lo, clip_hi, &err));
        if constexpr (kStats) {
          e[j] = (bit < n_info) & err;
        } else {
          err_map[row + bit] = static_cast<int8_t>(err);
        }
      }
    }
    nb += e[0] + e[1] + e[2] + e[3];
    ns += (e[0] | e[1]) + (e[2] | e[3]);          // QPSK: (even, odd) pairs
  }
  if constexpr (kStats) {
    nb = __reduce_add_sync(0xffffffffu, nb);
    ns = __reduce_add_sync(0xffffffffu, ns);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&s_bits, nb);
      atomicAdd(&s_syms, ns);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      bits[f] = s_bits;
      syms[f] = mod_type == 2 ? s_syms : s_bits;  // BPSK: symbol == bit
    }
  }
}

template <bool kStats>
int launch(const void* cw, void* llr, void* err_map, void* bits, void* syms,
           const void* params, int batch, int n_var, int n_info, int mod_type, int L,
           int clip_lo, int clip_hi, unsigned long long seed, unsigned long long round,
           unsigned int frame0, void* stream) {
  if (2 * L + 1 > faid::kMaxParams) return static_cast<int>(cudaErrorInvalidValue);
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  quantile_channel_kernel<kStats>
      <<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(cw), static_cast<int8_t*>(llr),
          static_cast<int8_t*>(err_map), static_cast<int32_t*>(bits),
          static_cast<int32_t*>(syms), static_cast<const int32_t*>(params), n_var, n_info,
          mod_type, L, clip_lo, clip_hi, key, static_cast<uint32_t>(round),
          static_cast<uint32_t>(round >> 32), frame0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel A: LLRs and per-frame ModCalErr bit / symbol counts.
extern "C" int faid_quantile_channel(const void* cw, void* llr, void* bits, void* syms,
                                     const void* params, int batch, int n_var,
                                     int n_info, int mod_type, int L, int clip_lo,
                                     int clip_hi, unsigned long long seed,
                                     unsigned long long round, unsigned int frame0,
                                     void* stream) {
  return launch<true>(cw, llr, nullptr, bits, syms, params, batch, n_var, n_info,
                      mod_type, L, clip_lo, clip_hi, seed, round, frame0, stream);
}

// Kernel C: LLRs and the ModCalErr map.
extern "C" int faid_quantile_channel_map(const void* cw, void* llr, void* err_map,
                                         const void* params, int batch, int n_var, int L,
                                         int clip_lo, int clip_hi,
                                         unsigned long long seed,
                                         unsigned long long round, unsigned int frame0,
                                         void* stream) {
  return launch<false>(cw, llr, err_map, nullptr, nullptr, params, batch, n_var, n_var,
                       0, L, clip_lo, clip_hi, seed, round, frame0, stream);
}

extern "C" const char* faid_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
