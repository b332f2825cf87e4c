// The decoder kernels B, D, E and F: one template over the output, the
// check-node style, the BF post-processor and the stop mode.
//
// The template replaces faid_tpu/ops/pallas_decoder.py `_make_kernel`:
// LLR ingest, up to max_iter layered iterations each opened by the
// early-stop syndrome sweep (`syndrome_sweep`, `row_update`), and the
// BF tail (`bf_tail`).  Its four outputs are four kernels:
//   kStats  kernel B, `make_stats_decoder` (`fuse_stats`): the per-frame
//           count of info-bit errors against a reference word (`ref`,
//           or the all-zero word, `fake_ref`), mp_iters and bf_rounds,
//           [B] int32 (stats_decoder.cu);
//   kHard   kernel D, `make_full_decoder` (`fuse_bf`): the final hard
//           decisions, [B, n_var] int8 0/1, mp_iters and bf_rounds
//           (full_decoder.cu);
//   kEn     kernel E, `make_mp_decoder`: MP only, the final en, [B,
//           n_var] int8, and mp_iters (mp_decoder.cu);
//   kSim    kernel F, `build_fused_sim` (`chan=...`): kernel B with the
//           quantile channel as its prologue.  Each bit's Philox word
//           goes through staircase.cuh straight into the working en
//           (the ingest, punctured tail zeroed), each frame's ModCalErr
//           bit and symbol errors are reduced on the way, and the error
//           count runs against the codeword `cw` (fused_sim.cu).  Its
//           stream is kernel A's, so F's five counters equal A then B's.
// The JAX kernels' [C, B, Z] becomes build_decoder's [B, n_var] layout.
//
// Stop modes (compile time, kFrame): group mode stops a 32-frame word
// when all its frames are clean, and every frame of a dirty word keeps
// updating; frame mode (`active`, pallas_decoder.py:384-393, :639-673,
// :442-449) freezes each frame once it is clean: a frozen frame is
// neither read nor written again, mp_iters and bf_rounds count each
// frame's own active iterations and rounds, and the word loops while
// any frame is active.  A frozen frame's state no longer changes, so it
// stays clean: the sweeps skip it.  s_act holds the word's per-frame
// flags in shared memory.
//
// Styles (compile time): kNms (raw magnitudes, (min * factor) >> 5),
// kOmsSel (magnitudes clipped to 7, selective offsets), kFaid (LUT
// magnitudes, EF 0) and kFaidEf1 (the per-check swap to the error-floor
// row).  The two map-keeping styles, kOmsSel and kFaidEf1, need the
// word's whole unsatisfied-check map and each frame's count at the
// iteration top; kNms and kFaid need only "is the word dirty", which
// the sweep answers with an early exit.  BF kinds (compile time): none,
// static (every column votes; threshold min(max vote, cap)), DTBF and
// 2B1C-DTBF.  stop_early is a runtime flag: NMS runs every iteration.
//
// What bounds it on the H100: operations, then bytes.  An MP iteration
// touches every edge twice: it reads en and the message (2 bytes) and
// writes both back (2 bytes), 70,400 edges per frame, plus the syndrome
// sweep's 70,400 hard reads.  At batch 2048 one iteration moves ~0.7 GB.
// The decoder state of a 32-frame word (2.25 MB of messages, 0.56 MB of
// en) does not fit in one SM's 227 KB of shared memory, so it lives in
// global memory and is served from L2 (50 MB) and HBM.
// Kernel F is bound as B is: its prologue adds kernel A's operations
// (about an eightieth of B's at 4.0 dB) and saves the 36 MB LLR write
// and read and one launch.  It draws on the word's block, so on 64 SMs
// where kernel A spreads over all 132.
//
// First design, simple and right:
//  * one block per 32-frame word, so the group stop flag is one
//    __syncthreads_or (the TPU's bt=32 tile made it free in the same way);
//    64 blocks at batch 2048, i.e. 64 of the 132 SMs busy;
//  * 1024 threads mapped on (frame, z); within a block row each VN is
//    touched by exactly one check (a column appears once per row and
//    z -> (z + s) mod Z is a bijection), so a row update needs no atomics,
//    only a __syncthreads() before the next row;
//  * the roll by s becomes the index (z + s) mod Z;
//  * state (en, messages, hard bits) in global memory, allocated by the
//    wrapper; the word's unsatisfied-check map in shared memory (32 x
//    rows x Z bytes, 96 KB for 50G-PON), written by the map-keeping
//    styles' sweeps and by the BF tail's;
//  * code tables as runtime arguments (row pointers, entry columns and
//    shifts, the voting columns' adjacency, the LUT rows), so the same
//    kernel also runs a toy code; kMaxDeg bounds the per-thread register
//    array of one row's contributions and the wrapper checks it.
// All arithmetic is int32 with the reference's int8 saturations kept
// explicit; there is no floating point in the kernel.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "staircase.cuh"

namespace faid {

constexpr int kGroup = 32;      // frames per stop word == frames per block
constexpr int kThreads = 1024;
constexpr int kMaxDeg = 24;     // 50G-PON rows have degree 22-23
constexpr int kSatVar = 31;
constexpr int kSatMsg = 7;

// The ids the Python wrappers pass (ops/cuda_decoder.py).
enum Out { kStats = 0, kHard = 1, kEn = 2, kSim = 3 };
enum Style { kNms = 0, kOmsSel = 1, kFaid = 2, kFaidEf1 = 3 };
enum Bf { kBfNone = 0, kBfStatic = 1, kBfDtbf = 2, kBf2b1c = 3 };

// Field for field utils/kernels.py `DecoderArgs`.
struct CodeArgs {
  const int32_t* row_ptr;     // [n_rows + 1] first entry of each block row
  const int32_t* ent_col;     // [n_entries] block column of each entry
  const int32_t* ent_shift;   // [n_entries] circulant shift of each entry
  const int32_t* vote_col;    // [n_vote] block columns the BF tail flips
  const int32_t* vote_ptr;    // [n_vote + 1] first adjacency entry of each
  const int32_t* vote_row;    // their block rows
  const int32_t* vote_shift;  // and shifts
  const int32_t* lut;         // [max_iter * 8] FAID magnitude rows
  const int32_t* lut_ef;      // [max_iter * 8] FAID error-floor rows
  int n_var, n_info, z, n_rows, n_entries, punct_start, max_iter, stop_early;
  int factor_1, factor_2, offset, sign_backtrack, floor_err_count, floor_iter_thresh;
  int n_vote, gamma, bf_max_iter, delta, l0_max, l1_max, alpha, vote_cap, reliability;
};

struct Buffers {
  const int8_t* llr;   // [B, n_var] channel LLRs (not kernel F)
  int8_t* en;          // [B, n_var] scratch; kernel E's output
  int8_t* msg;         // [B, n_entries, z] scratch
  int8_t* hard;        // [B, n_var] BF scratch; kernel D's output
  int8_t* hard2;       // [B, n_var] the 2B1C reliability bits (2B1C only)
  int32_t* err;        // [B] kernels B and F
  int32_t* iters;      // [B]
  int32_t* rounds;     // [B] kernels B, D and F
  const int8_t* ref;   // [B, ref_stride] the reference word, or null for
  int ref_stride;      //   the all-zero word (kernels B and F)
};

// Kernel F's channel: kernel A's arguments (quantile_channel.cu).
struct ChanArgs {
  const int32_t* params;   // [2L+1] thresholds
  int32_t* mod_bits;       // [B] ModCalErr info-bit errors
  int32_t* mod_syms;       // [B] and symbol errors
  int L, clip_lo, clip_hi, mod_type;
  uint32_t key_lo, key_hi, round_lo, round_hi, frame0;
};

template <int kStyle>
constexpr bool kKeepsMap = kStyle == kOmsSel || kStyle == kFaidEf1;
template <int kStyle>
constexpr bool kIsFaid = kStyle == kFaid || kStyle == kFaidEf1;

__device__ __forceinline__ int wrap(int i, int z) { return i >= z ? i - z : i; }
__device__ __forceinline__ int sat8(int x) { return min(max(x, -128), 127); }

// Any unsatisfied check in the word, computed from en > 0 (MP) with an
// early exit per thread once one is found.
__device__ inline bool word_dirty(const int8_t* en, const CodeArgs& a) {
  const int z = a.z;
  const int n_checks = kGroup * a.n_rows * z;
  int found = 0;
  for (int i = threadIdx.x; i < n_checks && !found; i += blockDim.x) {
    const int zz = i % z, rest = i / z;
    const int r = rest % a.n_rows, f = rest / a.n_rows;
    const int8_t* enf = en + static_cast<size_t>(f) * a.n_var;
    int acc = 0;
    for (int e = a.row_ptr[r]; e < a.row_ptr[r + 1]; ++e)
      acc ^= enf[a.ent_col[e] * z + wrap(zz + a.ent_shift[e], z)] > 0;
    found = acc;
  }
  return __syncthreads_or(found);
}

// The word's whole unsatisfied-check map from en > 0 into `unsat`, and
// each frame's count of unsatisfied checks into s_cnt; true when any
// check is unsatisfied.  Frame mode sweeps the active frames only and
// leaves each frame's new flag (count > 0) in s_act.
template <bool kFrame>
__device__ inline bool word_map(const int8_t* en, uint8_t* unsat, int* s_cnt,
                                int* s_act, const CodeArgs& a) {
  const int z = a.z, per_frame = a.n_rows * z;
  if (threadIdx.x < kGroup) s_cnt[threadIdx.x] = 0;
  __syncthreads();
  int found = 0;
  for (int f = 0; f < kGroup; ++f) {
    if (kFrame && !s_act[f]) continue;
    const int8_t* enf = en + static_cast<size_t>(f) * a.n_var;
    int cnt = 0;
    for (int j = threadIdx.x; j < per_frame; j += blockDim.x) {
      const int zz = j % z, r = j / z;
      int acc = 0;
      for (int e = a.row_ptr[r]; e < a.row_ptr[r + 1]; ++e)
        acc ^= enf[a.ent_col[e] * z + wrap(zz + a.ent_shift[e], z)] > 0;
      unsat[f * per_frame + j] = static_cast<uint8_t>(acc);
      cnt += acc;
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&s_cnt[f], cnt);
    found |= cnt;
  }
  found = __syncthreads_or(found);
  if (kFrame && threadIdx.x < kGroup) s_act[threadIdx.x] = s_cnt[threadIdx.x] > 0;
  return found;
}

// Frame mode's sweep for the styles without a map (FAID/EF 0, NMS): each
// active frame's "any unsatisfied check" into s_act, with an early exit
// per frame once one is found; true when any frame is dirty.
__device__ inline bool frame_flags(const int8_t* en, int* s_act, int* s_dirty,
                                   const CodeArgs& a) {
  const int z = a.z, per_frame = a.n_rows * z;
  if (threadIdx.x < kGroup) s_dirty[threadIdx.x] = 0;
  __syncthreads();
  volatile int* dirty = s_dirty;
  for (int i = threadIdx.x; i < kGroup * per_frame; i += blockDim.x) {
    const int f = i / per_frame;
    if (!s_act[f] || dirty[f]) continue;
    const int j = i - f * per_frame, zz = j % z, r = j / z;
    const int8_t* enf = en + static_cast<size_t>(f) * a.n_var;
    int acc = 0;
    for (int e = a.row_ptr[r]; e < a.row_ptr[r + 1]; ++e)
      acc ^= enf[a.ent_col[e] * z + wrap(zz + a.ent_shift[e], z)] > 0;
    if (acc) dirty[f] = 1;
  }
  __syncthreads();
  const int mine = threadIdx.x < kGroup ? s_dirty[threadIdx.x] : 0;
  if (threadIdx.x < kGroup) s_act[threadIdx.x] = mine;
  return __syncthreads_or(mine);
}

// The selective-OMS offset of a minimum: raised toward the factor
// thresholds in the error-floor window, lowered by 1-2 elsewhere.
__device__ __forceinline__ int offsel(int m, bool eff, int f1, int f2) {
  if (eff) {
    const int up = m + (m < f2);
    return up + (up <= f1);
  }
  const int down = m - (m > f1);
  return down - (down >= f2);
}

// Block row r of one layered iteration for every frame of the word.
// in_floor, s_lme (per frame: few unsatisfied checks) and the check map
// open the error-floor window of the map-keeping styles.
// Frame mode skips the frozen frames (s_act 0): not a byte of their state
// is read or written.
template <int kStyle, bool kFrame>
__device__ void row_update(int8_t* en, int8_t* msg, const int* s_lut,
                           const int* s_lut_ef, const uint8_t* unsat,
                           const int* s_lme, const int* s_act, bool in_floor,
                           int r, const CodeArgs& a) {
  const int z = a.z;
  const int e0 = a.row_ptr[r], deg = a.row_ptr[r + 1] - e0;
  const int odd = deg & 1;
  for (int i = threadIdx.x; i < kGroup * z; i += blockDim.x) {
    const int zz = i % z, f = i / z;
    if (kFrame && !s_act[f]) continue;
    int8_t* enf = en + static_cast<size_t>(f) * a.n_var;
    int8_t* msgf = msg + static_cast<size_t>(f) * a.n_entries * z;
    bool eff = false;
    if constexpr (kKeepsMap<kStyle>)
      eff = in_floor && s_lme[f] && unsat[(f * a.n_rows + r) * z + zz];
    const int* lut = s_lut;
    if constexpr (kStyle == kFaidEf1) lut = eff ? s_lut_ef : s_lut;
    // the contributions, four int8 to a register (each is within
    // [-31, 127]): a row's 24 then take 6 of the 64 registers
    uint32_t vcp[kMaxDeg / 4] = {};
    uint32_t negs = 0;
    int parity = 0, min1 = kSatVar, min2 = kSatVar;
    // pass 1: contributions, signs, magnitudes, min1/min2
#pragma unroll
    for (int e = 0; e < kMaxDeg; ++e) {
      if (e < deg) {
        const int vn = enf[a.ent_col[e0 + e] * z + wrap(zz + a.ent_shift[e0 + e], z)];
        const int m = msgf[(e0 + e) * z + zz];
        int v, neg, mag;
        if constexpr (kIsFaid<kStyle>) {
          // clipped to +-31; a zero contribution may borrow En's sign
          v = min(max(max(vn - m, -128), -kSatVar), kSatVar);
          neg = (a.sign_backtrack && v == 0 ? vn : v) < 0;
          mag = lut[min(abs(v), 7)];
        } else {
          // the int8 saturation, then only the lower clip: up to 31 + 7
          v = max(min(vn - m, 127), -kSatVar);
          neg = v < 0;
          mag = kStyle == kNms ? abs(v) : min(abs(v), kSatMsg);
        }
        vcp[e >> 2] |= static_cast<uint32_t>(v & 0xff) << (8 * (e & 3));
        negs |= static_cast<uint32_t>(neg) << e;
        parity ^= neg;
        min2 = min(min2, max(min1, mag));
        min1 = min(mag, min1);
      }
    }
    int cste1, cste2;
    if constexpr (kStyle == kNms) {
      // arithmetic >> as the reference's int16 lanes and JAX's int32
      cste1 = min(sat8((min2 * a.factor_2) >> 5), kSatMsg);
      cste2 = min(sat8((min1 * a.factor_1) >> 5), kSatMsg);
    } else if constexpr (kStyle == kOmsSel) {
      cste1 = min(offsel(min2, eff, a.factor_1, a.factor_2), kSatMsg);
      cste2 = min(offsel(min1, eff, a.factor_1, a.factor_2), kSatMsg);
    } else {
      cste1 = min(min2 - a.offset, kSatMsg);
      cste2 = min(min1 - a.offset, kSatMsg);
    }
    // pass 2: new messages and en.  FAID compares the mapped magnitude
    // with min1, NMS and OMS the raw |contribution|.
#pragma unroll
    for (int e = 0; e < kMaxDeg; ++e) {
      if (e < deg) {
        const int v = static_cast<int8_t>(vcp[e >> 2] >> (8 * (e & 3)));
        int cmp;
        if constexpr (kIsFaid<kStyle>) cmp = lut[min(abs(v), 7)];
        else cmp = abs(v);
        const int vres = cmp == min1 ? cste1 : cste2;
        const int neg = parity ^ static_cast<int>((negs >> e) & 1u) ^ odd;
        const int nm = neg ? -vres : vres;
        msgf[(e0 + e) * z + zz] = static_cast<int8_t>(nm);
        enf[a.ent_col[e0 + e] * z + wrap(zz + a.ent_shift[e0 + e], z)] =
            static_cast<int8_t>(min(max(v + nm, -kSatVar), kSatVar));
      }
    }
  }
}

// Votes of the voting column k, bit zz, from frame f's check map.
__device__ __forceinline__ int col_votes(const uint8_t* unsat, int f, int k, int zz,
                                         const CodeArgs& a) {
  const int z = a.z;
  const uint8_t* uf = unsat + f * a.n_rows * z;
  int votes = 0;
  for (int j = a.vote_ptr[k]; j < a.vote_ptr[k + 1]; ++j)
    votes += uf[a.vote_row[j] * z + wrap(zz - a.vote_shift[j] + z, z)];
  return votes;
}

// Kernel F's prologue, the counterpart of pallas_decoder.py:581-626:
// frame f of the word draws its Philox words (stream frame c.frame0 +
// frame0 + f), pushes each through the staircase, mirrored by the
// codeword bit, into en (the punctured tail zeroed), and adds its
// ModCalErr info-bit errors and (even, odd) symbol errors into s_mb and
// s_ms.  The per-bit code is kernel A's (staircase.cuh), and the bits
// of a group of four stay in one thread, as in A, so the counts agree.
__device__ inline void channel_ingest(int8_t* en, const int8_t* cw, size_t frame0,
                                      const int32_t* sp, int* s_mb, int* s_ms,
                                      const ChanArgs& c, const CodeArgs& a) {
  const int n = a.n_var, groups = (n + 3) / 4;
  const uint2 key = make_uint2(c.key_lo, c.key_hi);
  for (int f = 0; f < kGroup; ++f) {
    const size_t row = (frame0 + f) * static_cast<size_t>(n);
    int8_t* enf = en + static_cast<size_t>(f) * n;
    int nb = 0, ns = 0;
    for (int g = threadIdx.x; g < groups; g += blockDim.x) {
      const uint4 w = channel_words4(g, c.frame0 + static_cast<uint32_t>(frame0) + f,
                                     c.round_lo, c.round_hi, key);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
      int e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bit = 4 * g + j;
        e[j] = 0;
        if (bit < n) {
          const int mask = cw ? -static_cast<int>(cw[row + bit] != 0) : 0;
          int err;
          const int q = staircase_bit(static_cast<int>(ws[j]), mask, sp, c.L, c.clip_lo,
                                      c.clip_hi, &err);
          enf[bit] = static_cast<int8_t>(bit >= a.punct_start ? 0 : q);
          e[j] = (bit < a.n_info) & err;
        }
      }
      nb += e[0] + e[1] + e[2] + e[3];
      ns += (e[0] | e[1]) + (e[2] | e[3]);          // QPSK: (even, odd) pairs
    }
    nb = __reduce_add_sync(0xffffffffu, nb);
    ns = __reduce_add_sync(0xffffffffu, ns);
    if ((threadIdx.x & 31) == 0 && (nb | ns)) {
      atomicAdd(&s_mb[f], nb);
      atomicAdd(&s_ms[f], ns);
    }
  }
}

// The buffers are separate __restrict__ parameters, so the compiler may
// keep the row update's loads ahead of its stores; with the qualifiers
// and the packed contributions the FAID_DTBF instance of kernel B runs
// as fast as before the template was widened (scripts/decoder_variants.py).
template <int kOut, int kStyle, int kBf, bool kFrame>
__global__ void __launch_bounds__(kThreads, 1)
decoder_kernel(const int8_t* __restrict__ llr, int8_t* __restrict__ en_g,
               int8_t* __restrict__ msg_g, int8_t* __restrict__ hard_g,
               int8_t* __restrict__ hard2_g, int32_t* __restrict__ err_out,
               int32_t* __restrict__ iters_out, int32_t* __restrict__ bf_out,
               const int8_t* __restrict__ ref, int ref_stride, CodeArgs a,
               ChanArgs c) {
  extern __shared__ uint8_t unsat[];   // [kGroup][n_rows][z] check map
  __shared__ int s_lut[8], s_lut_ef[8];
  __shared__ int s_cnt[kGroup], s_lme[kGroup];
  __shared__ int s_th[kGroup], s_l0[kGroup], s_l1[kGroup], s_t[kGroup];
  __shared__ int s_flip[kGroup], s_err[kGroup];
  __shared__ int s_act[kGroup], s_dirty[kGroup];   // frame mode

  const int z = a.z, n = a.n_var;
  const size_t frame0 = static_cast<size_t>(blockIdx.x) * kGroup;
  int8_t* en = en_g + frame0 * n;
  int8_t* hard = hard_g + frame0 * n;
  int8_t* msg = msg_g + frame0 * a.n_entries * z;

  // ---- ingest: en = LLR with the punctured tail zeroed; messages = 0
  if constexpr (kOut == kSim) {
    // kernel F: en from the channel (`ref` is the codeword)
    __shared__ int32_t sp[kMaxParams];
    __shared__ int s_mb[kGroup], s_ms[kGroup];
    for (int i = threadIdx.x; i < 2 * c.L + 1; i += blockDim.x) sp[i] = c.params[i];
    if (threadIdx.x < kGroup) {
      s_mb[threadIdx.x] = 0;
      s_ms[threadIdx.x] = 0;
    }
    __syncthreads();
    channel_ingest(en, ref, frame0, sp, s_mb, s_ms, c, a);
    __syncthreads();
    if (threadIdx.x < kGroup) {
      c.mod_bits[frame0 + threadIdx.x] = s_mb[threadIdx.x];
      // BPSK: symbol == bit
      c.mod_syms[frame0 + threadIdx.x] =
          c.mod_type == 2 ? s_ms[threadIdx.x] : s_mb[threadIdx.x];
    }
  } else {
    const int8_t* in = llr + frame0 * n;
    for (int i = threadIdx.x; i < kGroup * n; i += blockDim.x)
      en[i] = i % n >= a.punct_start ? 0 : in[i];
  }
  // The word's message block starts at a multiple of 32 bytes and spans a
  // multiple of 32 bytes, so it is cleared in 16-byte stores.
  uint4* msg16 = reinterpret_cast<uint4*>(msg);
  for (int i = threadIdx.x; i < kGroup * a.n_entries * z / 16; i += blockDim.x)
    msg16[i] = make_uint4(0, 0, 0, 0);
  if (kFrame && threadIdx.x < kGroup) s_act[threadIdx.x] = 1;
  __syncthreads();

  // ---- layered MP iterations; group mode stops the word when all 32
  // frames are clean, frame mode freezes each clean frame and stops the
  // word when none is left.  Frame mode: thread f < 32 counts frame f.
  int iters = 0;
  bool alive = true;
  for (int it = 0; it < a.max_iter; ++it) {
    if (a.stop_early) {
      bool dirty;
      if constexpr (kKeepsMap<kStyle>) dirty = word_map<kFrame>(en, unsat, s_cnt, s_act, a);
      else if constexpr (kFrame) dirty = frame_flags(en, s_act, s_dirty, a);
      else dirty = word_dirty(en, a);
      if (!dirty) {
        alive = false;
        break;
      }
    }
    if constexpr (kIsFaid<kStyle>) {
      if (threadIdx.x < 8) {
        s_lut[threadIdx.x] = a.lut[it * 8 + threadIdx.x];
        if constexpr (kStyle == kFaidEf1)
          s_lut_ef[threadIdx.x] = a.lut_ef[it * 8 + threadIdx.x];
      }
    }
    if constexpr (kKeepsMap<kStyle>) {
      if (threadIdx.x < kGroup)
        s_lme[threadIdx.x] = a.stop_early && s_cnt[threadIdx.x] < a.floor_err_count;
    }
    __syncthreads();
    const bool in_floor = a.max_iter - 1 - it <= a.floor_iter_thresh;
    for (int r = 0; r < a.n_rows; ++r) {
      row_update<kStyle, kFrame>(en, msg, s_lut, s_lut_ef, unsat, s_lme, s_act,
                                 in_floor, r, a);
      __syncthreads();
    }
    if constexpr (kFrame) iters += threadIdx.x < kGroup && s_act[threadIdx.x];
    else ++iters;
  }

  // ---- BF tail, skipped when MP stopped clean.  Frame mode: s_act
  // marks the frames found dirty at the round's top; only they flip and
  // run their threshold machines, and thread f < 32 counts frame f's
  // rounds.
  int rounds = 0;
  if constexpr (kBf != kBfNone) {
    if (alive) {
      int8_t* hard2 = kBf == kBf2b1c ? hard2_g + frame0 * n : nullptr;
      for (int i = threadIdx.x; i < kGroup * n; i += blockDim.x) {
        hard[i] = en[i] > 0;
        if constexpr (kBf == kBf2b1c)
          hard2[i] = en[i] >= a.reliability || en[i] <= -a.reliability;
      }
      if (threadIdx.x < kGroup) {
        s_th[threadIdx.x] = a.gamma;
        s_l0[threadIdx.x] = 0;
        s_l1[threadIdx.x] = 0;
        s_t[threadIdx.x] = 1;
        if constexpr (kFrame) s_act[threadIdx.x] = 1;
      }
      __syncthreads();
      const int n_checks = kGroup * a.n_rows * z;
      const int n_items = kGroup * a.n_vote * z;
      for (int round = 0; round < a.bf_max_iter; ++round) {
        if constexpr (kFrame) {
          if (threadIdx.x < kGroup) s_dirty[threadIdx.x] = 0;
          __syncthreads();
        }
        int found = 0;
        for (int i = threadIdx.x; i < n_checks; i += blockDim.x) {
          const int zz = i % z, rest = i / z;
          const int r = rest % a.n_rows, f = rest / a.n_rows;
          // a frame clean at an earlier round no longer flips: it stays clean
          if (kFrame && !s_act[f]) continue;
          const int8_t* hf = hard + static_cast<size_t>(f) * n;
          int acc = 0;
          for (int e = a.row_ptr[r]; e < a.row_ptr[r + 1]; ++e)
            acc ^= hf[a.ent_col[e] * z + wrap(zz + a.ent_shift[e], z)];
          unsat[i] = static_cast<uint8_t>(acc);
          found |= acc;
          if (kFrame && acc) static_cast<volatile int*>(s_dirty)[f] = 1;
        }
        if (!__syncthreads_or(found)) break;
        if constexpr (kFrame) {
          if (threadIdx.x < kGroup) {
            s_act[threadIdx.x] = s_dirty[threadIdx.x];
            rounds += s_dirty[threadIdx.x];
          }
          __syncthreads();
        } else {
          ++rounds;
        }
        if constexpr (kBf == kBfStatic) {
          // the threshold: min(max(each frame's largest vote, 1), cap)
          if (threadIdx.x < kGroup) s_th[threadIdx.x] = 1;
          __syncthreads();
          for (int f = 0; f < kGroup; ++f) {
            if (kFrame && !s_act[f]) continue;
            int mx = 0;
            for (int j = threadIdx.x; j < a.n_vote * z; j += blockDim.x)
              mx = max(mx, col_votes(unsat, f, j / z, j % z, a));
            mx = __reduce_max_sync(0xffffffffu, mx);
            if ((threadIdx.x & 31) == 0 && mx > 1) atomicMax(&s_th[f], mx);
          }
          __syncthreads();
          if (threadIdx.x < kGroup) s_th[threadIdx.x] = min(s_th[threadIdx.x], a.vote_cap);
          __syncthreads();
          // flip every VN whose vote reaches it
          for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
            const int zz = i % z, rest = i / z;
            const int k = rest % a.n_vote, f = rest / a.n_vote;
            if (kFrame && !s_act[f]) continue;
            if (col_votes(unsat, f, k, zz, a) >= s_th[f]) {
              const size_t v = static_cast<size_t>(f) * n + a.vote_col[k] * z + zz;
              hard[v] ^= 1;
            }
          }
          __syncthreads();
        } else {
          // threshold machine; group mode: the word is dirty, so every
          // frame updates; frame mode: the dirty frames do
          if (threadIdx.x < kGroup && (!kFrame || s_act[threadIdx.x])) {
            const int f = threadIdx.x, t = s_t[f];
            int th = t ? s_th[f] : s_th[f] - a.delta;
            const bool max_th = t && s_l0[f] < a.l0_max;
            if (max_th) {
              th = a.gamma + a.alpha;
              ++s_l0[f];
            }
            const bool submax = t && !max_th && s_l1[f] < a.l1_max;
            if (submax) {
              th = a.gamma + a.alpha - a.delta;
              ++s_l1[f];
            }
            if (t && !max_th && !submax) th = a.gamma + a.alpha - 2 * a.delta;
            s_th[f] = max(th, 1);
          }
          if (threadIdx.x < kGroup) s_flip[threadIdx.x] = 0;
          __syncthreads();
          // flip weight-gamma VNs with votes + alpha * (hard != hard_ch) >= Th
          for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
            const int zz = i % z, rest = i / z;
            const int k = rest % a.n_vote, f = rest / a.n_vote;
            if (kFrame && !s_act[f]) continue;
            const int votes = col_votes(unsat, f, k, zz, a);
            const size_t v = static_cast<size_t>(f) * n + a.vote_col[k] * z + zz;
            const int h = hard[v];
            const int h_ch = en[v] > 0;   // hard_ch: the post-MP decision
            if (votes + a.alpha * (h ^ h_ch) >= s_th[f]) {
              if constexpr (kBf == kBf2b1c) {
                // below a threshold of gamma a reliable bit is demoted
                // instead of flipped
                const int h2 = hard2[v];
                if (s_th[f] >= a.gamma) {
                  hard[v] = static_cast<int8_t>(h ^ 1);
                  hard2[v] = static_cast<int8_t>(h2 ^ 1);
                } else if (h2) {
                  hard2[v] = 0;
                } else {
                  hard[v] = static_cast<int8_t>(h ^ 1);
                }
              } else {
                hard[v] = static_cast<int8_t>(h ^ 1);
              }
              atomicOr(&s_flip[f], 1);
            }
          }
          __syncthreads();
          if (threadIdx.x < kGroup && (!kFrame || s_act[threadIdx.x]))
            s_t[threadIdx.x] = s_flip[threadIdx.x];
          __syncthreads();
        }
      }
    }
  }

  if constexpr (kOut == kHard) {
    // ---- the word's final hard decisions; `hard` is the output buffer
    if (!alive)
      for (int i = threadIdx.x; i < kGroup * n; i += blockDim.x) hard[i] = en[i] > 0;
  } else if constexpr (kOut == kStats || kOut == kSim) {
    // ---- per-frame info-bit errors against the reference word (the
    // all-zero word without one): the BF tail's bits where it ran, else
    // en > 0
    const bool use_hard = kBf != kBfNone && alive;
    if (threadIdx.x < kGroup) s_err[threadIdx.x] = 0;
    __syncthreads();
    for (int f = 0; f < kGroup; ++f) {
      const int8_t* src = (use_hard ? hard : en) + static_cast<size_t>(f) * n;
      const int8_t* rf = ref ? ref + (frame0 + f) * static_cast<size_t>(ref_stride) : nullptr;
      int cnt = 0;
      if (rf) {
        for (int v = threadIdx.x; v < a.n_info; v += blockDim.x)
          cnt += (src[v] > 0) ^ (rf[v] != 0);
      } else {
        for (int v = threadIdx.x; v < a.n_info; v += blockDim.x) cnt += src[v] > 0;
      }
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&s_err[f], cnt);
    }
    __syncthreads();
    if (threadIdx.x < kGroup) err_out[frame0 + threadIdx.x] = s_err[threadIdx.x];
  }
  // kEn: `en` is the output buffer
  if (threadIdx.x < kGroup) {
    iters_out[frame0 + threadIdx.x] = iters;
    if constexpr (kOut != kEn) bf_out[frame0 + threadIdx.x] = rounds;
  }
}

template <int kOut, int kStyle, int kBf, bool kFrame>
int launch(const Buffers& b, const CodeArgs& a, const ChanArgs& c, int batch,
           void* stream) {
  // the check map is needed by the map-keeping styles and the BF tail
  const int smem = kKeepsMap<kStyle> || kBf != kBfNone ? kGroup * a.n_rows * a.z : 0;
  if (kOut == kSim && 2 * c.L + 1 > kMaxParams) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t st = cudaFuncSetAttribute(decoder_kernel<kOut, kStyle, kBf, kFrame>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return static_cast<int>(st);
  decoder_kernel<kOut, kStyle, kBf, kFrame><<<batch / kGroup, kThreads, smem,
                                              static_cast<cudaStream_t>(stream)>>>(
      b.llr, b.en, b.msg, b.hard, b.hard2, b.err, b.iters, b.rounds, b.ref, b.ref_stride, a,
      c);
  return static_cast<int>(cudaGetLastError());
}

// Two `case`s of an entry point's switch over (style, BF kind, frame
// mode): the instances of the template for that pair, group and frame.
#define FAID_INSTANCE(OUT, STYLE, BF)                                          \
  case ((STYLE) * 4 + (BF)) * 2:                                               \
    return faid::launch<OUT, STYLE, BF, false>(buffers, *args, chan, batch, stream); \
  case ((STYLE) * 4 + (BF)) * 2 + 1:                                           \
    return faid::launch<OUT, STYLE, BF, true>(buffers, *args, chan, batch, stream);

}  // namespace faid
