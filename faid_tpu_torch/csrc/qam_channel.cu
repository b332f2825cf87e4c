// Kernel G: the 16/64/256-QAM quantile channel.
//
// Replaces faid_tpu/ops/pallas_channel.py `_qam_kernel` (the pallas_call of
// `_build_fused_channel_qam`) together with its wrapper's interleave and
// deinterleave.  The folded max-log demap makes a rail's mod/2 LLRs
// functions of one noise draw, so each I/Q rail of the interleaved
// codeword draws ONE Philox word (the channel's stream, philox.cuh: rail r
// takes word r of the frame, exactly as bit r would in kernel A), mirrors
// it by the rail's sign bit, selects the threshold row of the rail's Gray
// magnitude index m, and evaluates every level's staircase on it as a
// union of intervals: the exact joint law of the rail's LLRs.  Level 0
// gets its sign back; every level takes the quantizer's asymmetric 3/5-bit
// clip.  The ModCalErr map is level 0's hard decision (the mirror makes it
// the error indicator), and hard[l] ^ bit for l >= 1.
//
// The plan is data, not code, because --scale is a runtime float and the
// plan's shape depends on it (ops/qam_plan.py `plan_table`):
//   plan = [3h + 1 segment starts, h bases, entries]
// level l's intervals lie in the segments starts[3l .. 3l + 3]: its pos
// events' (each adds 1 to q), its neg events' (each subtracts 1) and its
// hard decision's.  An entry packs (lo + 1) | (hi + 1) << 16, endpoint
// indices into the [nmag, nparam] threshold rows, -1 for an infinite end:
// the interval is {ix_e > T[lo]} and {ix_e < T[hi]}.
//
// Mapping: one block per frame, 256 threads; a thread takes the 4 rails of
// one Philox call (two symbols: rails 2s and 2s + 1 are symbol s's I and
// Q), so a call feeds 4 rails, as a call feeds 4 bits in kernel A.  Its
// ids come from (frame, rail) alone, never from the launch geometry.  The
// thresholds and the plan live in shared memory (8 x 331 + 310 words for
// 256-QAM at 6 bits and scale 13).  The kernel reads the codeword and
// writes the LLRs and the map through the depth-D interleaver's index map
// (interleaved position k is decoder position (k % D) * (n / D) + k / D),
// so the interleave and the two deinterleave passes of the JAX wrapper
// are not separate passes over [B, n].
//
// What bounds it on the H100: per rail a quarter of one Philox call and
// the walk over the plan's intervals (38 for 16-QAM at 4 bits, 293 for
// 256-QAM at 6, at scale 13), a compare or two and an add each, against 2
// bytes written (and 1 read with a codeword) per bit: integer issue rate.
// A binary search of the word among row m's sorted thresholds, then a
// per-row table of each level's (q, hard), would do the same function in
// far fewer operations (chip_smoke.py `qam_rail_ops`).
#include <cuda_runtime.h>

#include <cstdint>

#include "staircase.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShared = 4096;  // int32 words of thresholds + plan

__device__ __forceinline__ int decoder_pos(int k, int depth, int seg) {
  return (k % depth) * seg + k / depth;
}

// Level l's interval count in the segment [b, e) of the plan's entries.
__device__ __forceinline__ int count_in(const int32_t* __restrict__ ent, int b, int e,
                                        int ixe, const int32_t* __restrict__ row) {
  int n = 0;
  for (int i = b; i < e; ++i) {
    const uint32_t v = static_cast<uint32_t>(ent[i]);
    const int lo = static_cast<int>(v & 0xFFFFu) - 1;
    const int hi = static_cast<int>(v >> 16) - 1;
    bool in = true;
    if (lo >= 0) in = ixe > row[lo];
    if (hi >= 0) in = in && ixe < row[hi];
    n += in;
  }
  return n;
}

// kLevels = mod_type / 2: 2, 3 or 4 (16, 64, 256-QAM).
template <int kLevels>
__global__ void __launch_bounds__(kThreads)
qam_channel_kernel(const int8_t* __restrict__ cw, int8_t* __restrict__ llr,
                   int8_t* __restrict__ err, const int32_t* __restrict__ thr,
                   const int32_t* __restrict__ plan, int n_thr, int n_plan, int nparam,
                   int n_var, int depth, int clip_lo, int clip_hi, uint2 key,
                   uint32_t round_lo, uint32_t round_hi, uint32_t frame0) {
  __shared__ int32_t smem[kMaxShared];
  for (int i = threadIdx.x; i < n_thr + n_plan; i += blockDim.x)
    smem[i] = i < n_thr ? thr[i] : plan[i - n_thr];
  __syncthreads();
  constexpr int kMod = 2 * kLevels;
  const int32_t* s_thr = smem;
  const int32_t* starts = smem + n_thr;
  const int32_t* bases = starts + 3 * kLevels + 1;
  const int32_t* ent = bases + kLevels;

  const int f = blockIdx.x;
  const size_t row = static_cast<size_t>(f) * n_var;
  const int rails = 2 * (n_var / kMod);
  const int groups = (rails + 3) / 4;
  const int seg = n_var / depth;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const uint4 w = faid::channel_words4(g, frame0 + f, round_lo, round_hi, key);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * g + j;
      if (r >= rails) break;
      const int k0 = (r >> 1) * kMod + (r & 1);  // level 0's interleaved position
      int pos[kLevels], bits[kLevels];
      int m = 0;
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        pos[l] = decoder_pos(k0 + 2 * l, depth, seg);
        bits[l] = cw ? cw[row + pos[l]] != 0 : 0;
        if (l) m = 2 * m + bits[l];           // the first magnitude bit is m's MSB
      }
      const int mask0 = -bits[0];
      const int ixe = static_cast<int>(ws[j]) ^ mask0;
      const int32_t* trow = s_thr + m * nparam;
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        const int32_t* s = starts + 3 * l;
        int q = bases[l] + count_in(ent, s[0], s[1], ixe, trow) -
                count_in(ent, s[1], s[2], ixe, trow);
        const int hard = count_in(ent, s[2], s[3], ixe, trow);
        if (l == 0) q = (q ^ mask0) - mask0;  // restore the sign
        q = min(max(q, clip_lo), clip_hi);    // asymmetric 3/5-bit clip
        llr[row + pos[l]] = static_cast<int8_t>(q);
        err[row + pos[l]] = static_cast<int8_t>(l == 0 ? hard : hard ^ bits[l]);
      }
    }
  }
}

template <int kLevels>
void launch(const void* cw, void* llr, void* err, const void* thr, const void* plan,
            int n_thr, int n_plan, int nparam, int batch, int n_var, int depth,
            int clip_lo, int clip_hi, uint2 key, unsigned long long round,
            unsigned int frame0, void* stream) {
  qam_channel_kernel<kLevels><<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(cw), static_cast<int8_t*>(llr),
      static_cast<int8_t*>(err), static_cast<const int32_t*>(thr),
      static_cast<const int32_t*>(plan), n_thr, n_plan, nparam, n_var, depth, clip_lo,
      clip_hi, key, static_cast<uint32_t>(round), static_cast<uint32_t>(round >> 32),
      frame0);
}

}  // namespace

// Kernel G: the QAM LLRs and the ModCalErr map, [batch, n_var] int8 each, in
// decoder order.
extern "C" int faid_qam_channel(const void* cw, void* llr, void* err, const void* thr,
                                const void* plan, int n_thr, int n_plan, int nparam,
                                int batch, int n_var, int mod_type, int depth, int clip_lo,
                                int clip_hi, unsigned long long seed,
                                unsigned long long round, unsigned int frame0,
                                void* stream) {
  if ((mod_type != 4 && mod_type != 6 && mod_type != 8) || n_thr + n_plan > kMaxShared ||
      depth < 1 || n_var % mod_type || n_var % depth)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint2 key = make_uint2(static_cast<uint32_t>(seed),
                               static_cast<uint32_t>(seed >> 32));
  switch (mod_type) {
    case 4:
      launch<2>(cw, llr, err, thr, plan, n_thr, n_plan, nparam, batch, n_var, depth,
                clip_lo, clip_hi, key, round, frame0, stream);
      break;
    case 6:
      launch<3>(cw, llr, err, thr, plan, n_thr, n_plan, nparam, batch, n_var, depth,
                clip_lo, clip_hi, key, round, frame0, stream);
      break;
    case 8:
      launch<4>(cw, llr, err, thr, plan, n_thr, n_plan, nparam, batch, n_var, depth,
                clip_lo, clip_hi, key, round, frame0, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
