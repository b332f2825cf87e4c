// The decoder kernels B, D, E and F: one template over the output, the
// check-node style, the BF post-processor, the stop mode and the message
// width.
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
// frame's own active iterations and rounds.  A frozen frame's state no
// longer changes, so it stays clean: the sweeps skip it.  s_act holds
// the block's per-frame flags.
//
// Styles (compile time): kNms (raw magnitudes, (min * factor) >> 5),
// kOmsSel (magnitudes clipped to 7, selective offsets), kOmsOff (clipped
// magnitudes, a fixed offset: OMS offset mode 0), kFaid (LUT magnitudes,
// EF 0), kFaidEf1 (the per-check swap to the error-floor row) and
// kFaidEf2 (that swap and the one-shot erasure of flip-voted weight-3
// VNs).  The three map-keeping styles, kOmsSel, kFaidEf1 and kFaidEf2,
// need each frame's whole unsatisfied-check map and count at the
// iteration top (EF 2's votes read the map); kNms, kOmsOff and kFaid
// need only "is the word dirty", which the sweep answers with an early
// exit.  BF kinds (compile time): none, static (every column votes;
// threshold min(max vote, cap)), DTBF and 2B1C-DTBF.  Every (style, BF
// kind) pair is instantiated for kernel B, those with a tail for D, those
// without for E (one source a style, style_kernels.cuh), and
// DecoderConfig.for_method's six for F.  stop_early is a runtime flag:
// NMS runs every iteration.
//
// What bounds it on the H100: operations.  A layered iteration does ~20
// int32 operations per edge (70,400 edges a frame on 50G-PON) on state
// that every edge touches twice, so the state has to sit next to the
// ALUs.  A 32-frame word's state is 2.25 MB of int8 messages and 0.56 MB
// of en, too much for one SM; kept in global memory (L2 and HBM), it
// costs a byte gather or scatter there per edge and pass, and a block
// per word leaves half of the 132 SMs idle at batch 2048.
//
// The cluster design:
//  * the state is split by frame.  Every published configuration bounds
//    a stored message by 7 (ops/cuda_decoder.py `msg_bound`), so a
//    message takes 4 bits: a frame is then 17,664 B of en, 36,864 B of
//    messages and 3,072 B of check map on 50G-PON, and a block holds
//    kF = 4 frames (230,400 B of the 232,448 a block may use) in shared
//    memory.  A configuration whose bound is above 7 keeps 8-bit
//    messages and kF = 2.  Global memory carries only the inputs (LLR,
//    reference word or codeword, thresholds) and the outputs;
//  * group mode: a word is a thread-block cluster of 32 / kF blocks (8,
//    or 16 with 8-bit messages), 64 clusters at batch 2048.  Each stop
//    decision of the word (the MP loop's "word dirty", the BF round's
//    break, and with it the DTBF machines' "every frame of a dirty word
//    updates") is an OR over the cluster through distributed shared
//    memory (cluster_or), so alive, the iteration and the round counts
//    come out equal in all its blocks; the MP loop's sweep stops in the
//    whole word at the first unsatisfied check (14% of kernel B's time,
//    scripts/decoder_variants.py, H100 SXM at 700 W);
//  * frame mode needs no OR across blocks and launches no cluster: each
//    frame's state, iterations and rounds depend on its own sweeps only
//    (frozen frames are neither read nor written; a BF tail reactivates
//    every frame and its first sweep refreezes the clean ones, which
//    then neither flip nor count a round; a clean frame's decisions are
//    en > 0 with or without a tail), so a block that leaves its loops
//    when its own frames are frozen gives the counters a word-wide loop
//    gives;
//  * kThreads = 1024 threads map on (frame, zz) of the block's frames,
//    one item a row at kF = 4; within a block row each VN is touched by
//    exactly one check (a column appears once per row and z -> (z + s)
//    mod Z is a bijection), so a row update needs no atomics, only a
//    __syncthreads() before the next row.  The row update waits on
//    shared-memory loads, and 32 warps hide more of that than 16: 1024
//    threads (64 registers, no spills) beat 512 (up to 128) by 13%, and
//    keeping the row's VN indices in registers from pass 1 to pass 2 by
//    another 11% (scripts/decoder_variants.py, H100 SXM at 700 W);
//  * the messages of (row, zz) are packed kPer to a 32-bit word, the
//    row's words of one zz side by side (an odd count of words, so a
//    warp's loads and stores hit 32 banks): 3 loads and 3 stores per
//    (row, zz) at 4 bits, owned by the thread of that (frame, zz);
//  * after MP the message region holds the BF tail's bits: one byte per
//    VN, bit 0 the hard decision, bit 1 the 2B1C reliability bit;
//  * code tables are runtime arguments (row pointers, entry columns and
//    shifts, the message offsets, the voting columns' adjacency, the LUT
//    rows), so the same kernel also runs a toy code; kMaxDeg bounds the
//    per-thread register arrays of one row and the wrapper checks it.
// What holds it back now (H100 SXM at 700 W, FAID_DTBF at 4.0 dB, kernel
// F at 34% of its operation bound): a cluster of 8 needs 8 SMs of one
// GPC, and 15 fit at once, so 64 words run in 5 waves on 120 SMs; a
// barrier a row and shared-memory latency within the row; a sweep that
// finds the word clean re-reads every edge; kernel F's prologue draws on
// those 120 SMs too.
// All arithmetic is int32 with the reference's int8 saturations kept
// explicit; there is no floating point in the kernel.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "staircase.cuh"

namespace faid {

namespace cg = cooperative_groups;

constexpr int kGroup = 32;      // frames per stop word
constexpr int kThreads = 1024;  // threads per block
constexpr int kMaxDeg = 24;     // 50G-PON rows have degree 22-23
constexpr int kSatVar = 31;
constexpr int kSatMsg = 7;
// Returned when no cluster of the launch fits on the device.
constexpr int kNoCluster = 0x10000;

// frames a block and blocks a word's cluster, by message width in bits
template <int kBits>
constexpr int kFrames = kBits == 4 ? 4 : 2;
template <int kBits>
constexpr int kCluster = kGroup / kFrames<kBits>;

// The ids the Python wrappers pass (ops/cuda_decoder.py).
enum Out { kStats = 0, kHard = 1, kEn = 2, kSim = 3 };
enum Style { kNms = 0, kOmsSel = 1, kFaid = 2, kFaidEf1 = 3, kOmsOff = 4, kFaidEf2 = 5 };
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
  const int32_t* msg_off;     // [n_rows + 1] first message word of each row
                              //   in a frame's region (row r: z groups of
                              //   (msg_off[r+1] - msg_off[r]) / z words)
  int msg_words;              // words of a frame's message region
  const int32_t* ef_ptr;      // [n_entries] EF 2: the first adjacency entry of
                              //   the entry's erasing column, -1 where the
                              //   entry erases nothing
  const int32_t* ef_row;      // [3 x erasing columns] their block rows
  const int32_t* ef_shift;    // and shifts
};

struct Buffers {
  const int8_t* llr;   // [B, n_var] channel LLRs (not kernel F)
  int8_t* out;         // [B, n_var] kernel D's hard decisions, kernel E's en
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
constexpr bool kKeepsMap = kStyle == kOmsSel || kStyle == kFaidEf1 || kStyle == kFaidEf2;
template <int kStyle>
constexpr bool kIsFaid = kStyle == kFaid || kStyle == kFaidEf1 || kStyle == kFaidEf2;
// the styles that swap to the error-floor LUT row in the floor window
template <int kStyle>
constexpr bool kSwapsLut = kStyle == kFaidEf1 || kStyle == kFaidEf2;

// The dynamic shared memory of a block of `frames` frames: en, rounded
// to 16 bytes, then the message words, then the check map where the
// style or a BF tail keeps one.  ops/cuda_decoder.py `launch_plan`
// computes the same.
__host__ __device__ inline size_t en_bytes(int frames, int n_var) {
  return (static_cast<size_t>(frames) * n_var + 15) & ~static_cast<size_t>(15);
}
__host__ __device__ inline size_t smem_bytes(int frames, const CodeArgs& a, bool map) {
  return en_bytes(frames, a.n_var) + static_cast<size_t>(frames) * a.msg_words * 4 +
         (map ? static_cast<size_t>(frames) * a.n_rows * a.z : 0);
}

__device__ __forceinline__ int wrap(int i, int z) { return i >= z ? i - z : i; }
__device__ __forceinline__ int sat8(int x) { return min(max(x, -128), 127); }

// Index in a frame's [n_var] of the VN of entry ge at check zz.
__device__ __forceinline__ int vn_index(const CodeArgs& a, int ge, int zz) {
  return __ldg(a.ent_col + ge) * a.z + wrap(zz + __ldg(a.ent_shift + ge), a.z);
}

// Parity of check (r, zz) over bit(v) of its VNs.
template <typename Bit>
__device__ __forceinline__ int check_parity(const CodeArgs& a, int r, int zz, Bit bit) {
  int acc = 0;
  const int e1 = __ldg(a.row_ptr + r + 1);
  for (int e = __ldg(a.row_ptr + r); e < e1; ++e) acc ^= bit(vn_index(a, e, zz));
  return acc;
}

// Group mode: the OR of every thread's `mine` over the word's cluster.
// Call k uses slot s_or[k % 3] of every block: a block with a mark in
// its own slot writes one into each block's slot through distributed
// shared memory (any_unsat marks them as it finds), and after the
// cluster barrier each block reads only its own slot.  Before the
// barrier, thread 0 clears the slot of call k + 1: its last marks (call
// k - 2) and reads (call k - 2) happened before the barrier of call
// k - 1, and the next marks come after this call's barrier.
template <int kCl>
__device__ inline bool cluster_or(int mine, int* s_or, int& slot) {
  if (mine) s_or[slot] = 1;
  __syncthreads();
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x < kCl && s_or[slot]) *cl.map_shared_rank(s_or + slot, threadIdx.x) = 1;
  if (threadIdx.x == 0) s_or[slot == 2 ? 0 : slot + 1] = 0;
  cl.sync();
  const bool any = static_cast<volatile int*>(s_or)[slot];
  slot = slot == 2 ? 0 : slot + 1;
  return any;
}

// A stop decision of the word: over the cluster in group mode, over the
// block in frame mode (see the header).
template <bool kFrame, int kCl>
__device__ __forceinline__ bool decide(int mine, int* s_or, int& slot) {
  if constexpr (kFrame) return __syncthreads_or(mine);
  else return cluster_or<kCl>(mine, s_or, slot);
}

// Any unsatisfied check in the block's frames, from en > 0 (MP); the
// thread's flag.  A thread that finds one marks `seen`, this call's
// cluster_or slot, in every block of the word, and every thread of the
// word stops at the mark: one check is enough to keep the word going.
template <int kF>
__device__ inline int any_unsat(const int8_t* en, const CodeArgs& a, volatile int* seen) {
  const int z = a.z, per_frame = a.n_rows * z;
  int found = 0;
  for (int i = threadIdx.x; i < kF * per_frame && !found && !*seen; i += kThreads) {
    const int f = i / per_frame, j = i - f * per_frame, r = j / z;
    const int8_t* enf = en + f * a.n_var;
    found = check_parity(a, r, j - r * z, [&](int v) { return enf[v] > 0; });
    if (found) {
      cg::cluster_group cl = cg::this_cluster();
      for (int b = 0; b < kGroup / kF; ++b)
        *cl.map_shared_rank(const_cast<int*>(seen), b) = 1;
    }
  }
  return found;
}

// Each block frame's unsatisfied-check map from en > 0 into `unsat`,
// and its count into s_cnt; true when any check of the word is
// unsatisfied.  Frame mode sweeps the active frames only and leaves each
// frame's new flag (count > 0) in s_act.
template <bool kFrame, int kF, int kCl>
__device__ inline bool word_map(const int8_t* en, uint8_t* unsat, int* s_cnt, int* s_act,
                                int* s_or, int& slot, const CodeArgs& a) {
  const int z = a.z, per_frame = a.n_rows * z;
  if (threadIdx.x < kF) s_cnt[threadIdx.x] = 0;
  __syncthreads();
  int found = 0;
  for (int f = 0; f < kF; ++f) {
    if (kFrame && !s_act[f]) continue;
    const int8_t* enf = en + f * a.n_var;
    int cnt = 0;
    for (int j = threadIdx.x; j < per_frame; j += kThreads) {
      const int r = j / z;
      const int acc = check_parity(a, r, j - r * z, [&](int v) { return enf[v] > 0; });
      unsat[f * per_frame + j] = static_cast<uint8_t>(acc);
      cnt += acc;
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&s_cnt[f], cnt);
    found |= cnt;
  }
  const bool any = decide<kFrame, kCl>(found, s_or, slot);
  if (kFrame && threadIdx.x < kF) s_act[threadIdx.x] = s_cnt[threadIdx.x] > 0;
  return any;
}

// Frame mode's sweep for the styles without a map (FAID/EF 0, NMS): each
// active frame's "any unsatisfied check" into s_act, with an early exit
// per frame once one is found; true when any frame of the block is dirty.
template <int kF>
__device__ inline bool frame_flags(const int8_t* en, int* s_act, int* s_dirty,
                                   const CodeArgs& a) {
  const int z = a.z, per_frame = a.n_rows * z;
  if (threadIdx.x < kF) s_dirty[threadIdx.x] = 0;
  __syncthreads();
  volatile int* dirty = s_dirty;
  for (int i = threadIdx.x; i < kF * per_frame; i += kThreads) {
    const int f = i / per_frame;
    if (!s_act[f] || dirty[f]) continue;
    const int j = i - f * per_frame, r = j / z;
    const int8_t* enf = en + f * a.n_var;
    if (check_parity(a, r, j - r * z, [&](int v) { return enf[v] > 0; })) dirty[f] = 1;
  }
  __syncthreads();
  const int mine = threadIdx.x < kF ? s_dirty[threadIdx.x] : 0;
  if (threadIdx.x < kF) s_act[threadIdx.x] = mine;
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

// EF 2: the flip votes of bit j of an erasing column, from adjacency
// entry p on (its 3 checks), in one frame's check map uf.
__device__ __forceinline__ int ef_votes(const uint8_t* uf, int p, int j, const CodeArgs& a) {
  const int z = a.z;
  int votes = 0;
  for (int k = p; k < p + 3; ++k)
    votes += uf[__ldg(a.ef_row + k) * z + wrap(j - __ldg(a.ef_shift + k) + z, z)];
  return votes;
}

// Block row r of one layered iteration for the block's frames.  in_floor,
// s_lme (per frame: few unsatisfied checks) and the check map open the
// error-floor window of the map-keeping styles.  Frame mode skips the
// frozen frames (s_act 0): not a byte of their state is read or written.
//
// EF 2 (faid_tpu/ops/cn_update.py:118-133) zeroes the first contribution
// into a weight-3 VN an iteration where its flip votes (from the
// iteration-top map) reach 3, in a frame of few unsatisfied checks, in
// the floor window, and marks the VN.  That condition holds for the whole
// iteration, rows run in order, and no block column appears twice in a
// block row (ops/cuda_decoder.py `erasing_entries` checks it), so the
// first such contribution is the one from the column's lowest row: the
// entries of a.ef_ptr >= 0.  No per-VN mark is kept.
template <int kStyle, bool kFrame, int kBits, int kF>
__device__ void row_update(int8_t* en, uint32_t* msg, const int* s_lut, const int* s_lut_ef,
                           const uint8_t* unsat, const int* s_lme, const int* s_act,
                           bool in_floor, int r, const CodeArgs& a) {
  constexpr int kPer = 32 / kBits;                       // messages a word
  constexpr int kWords = (kMaxDeg + kPer - 1) / kPer;    // a row's, at most
  constexpr uint32_t kMask = (1u << kBits) - 1;
  const int z = a.z;
  const int e0 = __ldg(a.row_ptr + r), deg = __ldg(a.row_ptr + r + 1) - e0;
  const int odd = deg & 1;
  const int m0 = __ldg(a.msg_off + r), wr = (__ldg(a.msg_off + r + 1) - m0) / z;
  for (int i = threadIdx.x; i < kF * z; i += kThreads) {
    const int f = i / z, zz = i - f * z;
    if (kFrame && !s_act[f]) continue;
    int8_t* enf = en + f * a.n_var;
    uint32_t* mw = msg + f * a.msg_words + m0 + zz * wr;
    bool eff = false;
    if constexpr (kKeepsMap<kStyle>)
      eff = in_floor && s_lme[f] && unsat[(f * a.n_rows + r) * z + zz];
    const int* lut = s_lut;
    if constexpr (kSwapsLut<kStyle>) lut = eff ? s_lut_ef : s_lut;
    // EF 2: the row's edges whose contribution is erased, found before
    // pass 1 so that its registers are free again there
    uint32_t erase = 0;
    if constexpr (kStyle == kFaidEf2) {
      if (in_floor && s_lme[f]) {
        const uint8_t* uf = unsat + f * a.n_rows * z;
#pragma unroll 1
        for (int e = 0; e < deg; ++e) {
          const int p = __ldg(a.ef_ptr + e0 + e);
          if (p >= 0 && ef_votes(uf, p, wrap(zz + __ldg(a.ent_shift + e0 + e), z), a) >= 3)
            erase |= 1u << e;
        }
      }
    }
    uint32_t words[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) words[j] = j * kPer < deg ? mw[j] : 0u;
    // the contributions, four int8 to a register (each is within
    // [-31, 127]): a row's 24 then take 6 registers
    uint32_t vcp[kMaxDeg / 4] = {};
    uint32_t negs = 0;
    int idx[kMaxDeg];   // the row's VNs, from pass 1 to pass 2
    int parity = 0, min1 = kSatVar, min2 = kSatVar;
    // pass 1: contributions, signs, magnitudes, min1/min2
#pragma unroll
    for (int e = 0; e < kMaxDeg; ++e) {
      if (e < deg) {
        idx[e] = vn_index(a, e0 + e, zz);
        const int vn = enf[idx[e]];
        // the message, sign-extended from kBits
        const int m = static_cast<int>(words[e / kPer] << (32 - kBits * (e % kPer + 1))) >>
                      (32 - kBits);
        int v, neg, mag;
        if constexpr (kIsFaid<kStyle>) {
          // clipped to +-31; a zero contribution may borrow En's sign
          v = min(max(max(vn - m, -128), -kSatVar), kSatVar);
          if constexpr (kStyle == kFaidEf2) v = (erase >> e) & 1u ? 0 : v;
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
    // with min1, NMS and OMS the raw |contribution|.  A message is
    // stored in kBits (the wrapper picks 4 only where |message| <= 7
    // holds, else 8, the int8 store's wrap).
#pragma unroll
    for (int j = 0; j < kWords; ++j) words[j] = 0u;
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
        words[e / kPer] |= (static_cast<uint32_t>(nm) & kMask) << (kBits * (e % kPer));
        enf[idx[e]] = static_cast<int8_t>(min(max(v + nm, -kSatVar), kSatVar));
      }
    }
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      if (j * kPer < deg) mw[j] = words[j];
  }
}

// Votes of the voting column k, bit zz, from one frame's check map.
__device__ __forceinline__ int col_votes(const uint8_t* uf, int k, int zz, const CodeArgs& a) {
  const int z = a.z;
  int votes = 0;
  for (int j = a.vote_ptr[k]; j < a.vote_ptr[k + 1]; ++j)
    votes += uf[a.vote_row[j] * z + wrap(zz - a.vote_shift[j] + z, z)];
  return votes;
}

// The block's LLRs into en, the punctured tail zeroed; 16 bytes at a
// time where the rows allow it.
template <int kF>
__device__ inline void llr_ingest(int8_t* en, const int8_t* in, const CodeArgs& a) {
  const int n = a.n_var, total = kF * n;
  if ((n & 15) == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0) {
    const uint4* in16 = reinterpret_cast<const uint4*>(in);
    uint4* en16 = reinterpret_cast<uint4*>(en);
    for (int i = threadIdx.x; i < total / 16; i += kThreads) {
      uint4 v = in16[i];
      const int b = (i * 16) % n;   // the chunk's first bit in its frame
      if (b + 16 > a.punct_start) {
        uint8_t* p = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (b + j >= a.punct_start) p[j] = 0;
      }
      en16[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < total; i += kThreads)
      en[i] = i % n >= a.punct_start ? 0 : in[i];
  }
}

// Kernel F's prologue, the counterpart of pallas_decoder.py:581-626:
// frame f of the block draws its Philox words (stream frame c.frame0 +
// frame0 + f), pushes each through the staircase, mirrored by the
// codeword bit, into en (the punctured tail zeroed), and adds its
// ModCalErr info-bit errors and (even, odd) symbol errors into s_mb and
// s_ms.  The per-bit code is kernel A's (staircase.cuh), and the bits
// of a group of four stay in one thread, as in A, so the counts agree.
template <int kF>
__device__ inline void channel_ingest(int8_t* en, const int8_t* cw, size_t frame0,
                                      const int32_t* sp, int* s_mb, int* s_ms,
                                      const ChanArgs& c, const CodeArgs& a) {
  const int n = a.n_var, groups = (n + 3) / 4;
  const uint2 key = make_uint2(c.key_lo, c.key_hi);
  for (int f = 0; f < kF; ++f) {
    const size_t row = (frame0 + f) * static_cast<size_t>(n);
    int8_t* enf = en + f * n;
    int nb = 0, ns = 0;
    for (int g = threadIdx.x; g < groups; g += kThreads) {
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

// The buffers are separate __restrict__ parameters, and the row update
// keeps its contributions packed: scripts/decoder_variants.py measured
// both to matter when the state lived in global memory.
template <int kOut, int kStyle, int kBf, bool kFrame, int kBits>
__global__ void __launch_bounds__(kThreads, 1)
decoder_kernel(const int8_t* __restrict__ llr, int8_t* __restrict__ out_g,
               int32_t* __restrict__ err_out, int32_t* __restrict__ iters_out,
               int32_t* __restrict__ bf_out, const int8_t* __restrict__ ref, int ref_stride,
               CodeArgs a, ChanArgs c) {
  constexpr int kF = kFrames<kBits>;
  constexpr int kCl = kCluster<kBits>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_lut[8], s_lut_ef[8];
  __shared__ int s_cnt[kF], s_lme[kF];
  __shared__ int s_th[kF], s_l0[kF], s_l1[kF], s_t[kF];
  __shared__ int s_flip[kF], s_err[kF];
  __shared__ int s_act[kF], s_dirty[kF];   // frame mode
  __shared__ int s_or[3];                  // group mode: cluster_or's slots

  const int z = a.z, n = a.n_var;
  const size_t frame0 = static_cast<size_t>(blockIdx.x) * kF;
  int8_t* en = reinterpret_cast<int8_t*>(smem);                    // [kF][n]
  uint32_t* msg = reinterpret_cast<uint32_t*>(smem + en_bytes(kF, n));
  uint8_t* unsat = smem + en_bytes(kF, n) + static_cast<size_t>(kF) * a.msg_words * 4;
  int slot = 0;   // cluster_or's slot
  if (threadIdx.x < 3) s_or[threadIdx.x] = 0;

  // ---- ingest: en = LLR with the punctured tail zeroed; messages = 0
  if constexpr (kOut == kSim) {
    // kernel F: en from the channel (`ref` is the codeword)
    __shared__ int32_t sp[kMaxParams];
    __shared__ int s_mb[kF], s_ms[kF];
    for (int i = threadIdx.x; i < 2 * c.L + 1; i += kThreads) sp[i] = c.params[i];
    if (threadIdx.x < kF) {
      s_mb[threadIdx.x] = 0;
      s_ms[threadIdx.x] = 0;
    }
    __syncthreads();
    channel_ingest<kF>(en, ref, frame0, sp, s_mb, s_ms, c, a);
    __syncthreads();
    if (threadIdx.x < kF) {
      c.mod_bits[frame0 + threadIdx.x] = s_mb[threadIdx.x];
      // BPSK: symbol == bit
      c.mod_syms[frame0 + threadIdx.x] =
          c.mod_type == 2 ? s_ms[threadIdx.x] : s_mb[threadIdx.x];
    }
  } else {
    llr_ingest<kF>(en, llr + frame0 * n, a);
  }
  for (int i = threadIdx.x; i < kF * a.msg_words; i += kThreads) msg[i] = 0u;
  if (kFrame && threadIdx.x < kF) s_act[threadIdx.x] = 1;
  __syncthreads();

  // ---- layered MP iterations; group mode stops the word when all 32
  // frames are clean, frame mode freezes each clean frame and stops the
  // block when none is left.  Frame mode: thread f < kF counts frame f.
  int iters = 0;
  bool alive = true;
  for (int it = 0; it < a.max_iter; ++it) {
    if (a.stop_early) {
      bool dirty;
      if constexpr (kKeepsMap<kStyle>)
        dirty = word_map<kFrame, kF, kCl>(en, unsat, s_cnt, s_act, s_or, slot, a);
      else if constexpr (kFrame) dirty = frame_flags<kF>(en, s_act, s_dirty, a);
      else dirty = cluster_or<kCl>(any_unsat<kF>(en, a, s_or + slot), s_or, slot);
      if (!dirty) {
        alive = false;
        break;
      }
    }
    if constexpr (kIsFaid<kStyle>) {
      if (threadIdx.x < 8) {
        s_lut[threadIdx.x] = a.lut[it * 8 + threadIdx.x];
        if constexpr (kSwapsLut<kStyle>)
          s_lut_ef[threadIdx.x] = a.lut_ef[it * 8 + threadIdx.x];
      }
    }
    if constexpr (kKeepsMap<kStyle>) {
      if (threadIdx.x < kF)
        s_lme[threadIdx.x] = a.stop_early && s_cnt[threadIdx.x] < a.floor_err_count;
    }
    __syncthreads();
    const bool in_floor = a.max_iter - 1 - it <= a.floor_iter_thresh;
    for (int r = 0; r < a.n_rows; ++r) {
      row_update<kStyle, kFrame, kBits, kF>(en, msg, s_lut, s_lut_ef, unsat, s_lme, s_act,
                                            in_floor, r, a);
      __syncthreads();
    }
    if constexpr (kFrame) iters += threadIdx.x < kF && s_act[threadIdx.x];
    else ++iters;
  }

  // ---- BF tail, skipped when MP stopped clean.  Its bits live in the
  // message region, free after MP: hard[v] bit 0 the decision, bit 1
  // the 2B1C reliability bit.  Frame mode: s_act marks the frames found
  // dirty at the round's top; only they flip and run their threshold
  // machines, and thread f < kF counts frame f's rounds.
  uint8_t* hard = reinterpret_cast<uint8_t*>(msg);   // [kF][n]
  int rounds = 0;
  if constexpr (kBf != kBfNone) {
    if (alive) {
      for (int i = threadIdx.x; i < kF * n; i += kThreads) {
        const int v = en[i];
        int h = v > 0;
        if constexpr (kBf == kBf2b1c) h |= (v >= a.reliability || v <= -a.reliability) << 1;
        hard[i] = static_cast<uint8_t>(h);
      }
      if (threadIdx.x < kF) {
        s_th[threadIdx.x] = a.gamma;
        s_l0[threadIdx.x] = 0;
        s_l1[threadIdx.x] = 0;
        s_t[threadIdx.x] = 1;
        if constexpr (kFrame) s_act[threadIdx.x] = 1;
      }
      __syncthreads();
      const int per_frame = a.n_rows * z;
      const int n_items = kF * a.n_vote * z;
      for (int round = 0; round < a.bf_max_iter; ++round) {
        if constexpr (kFrame) {
          if (threadIdx.x < kF) s_dirty[threadIdx.x] = 0;
          __syncthreads();
        }
        int found = 0;
        for (int i = threadIdx.x; i < kF * per_frame; i += kThreads) {
          const int f = i / per_frame, j = i - f * per_frame, r = j / z;
          // a frame clean at an earlier round no longer flips: it stays clean
          if (kFrame && !s_act[f]) continue;
          const uint8_t* hf = hard + f * n;
          const int acc = check_parity(a, r, j - r * z, [&](int v) { return hf[v] & 1; });
          unsat[i] = static_cast<uint8_t>(acc);
          found |= acc;
          if (kFrame && acc) static_cast<volatile int*>(s_dirty)[f] = 1;
        }
        if (!decide<kFrame, kCl>(found, s_or, slot)) break;
        if constexpr (kFrame) {
          if (threadIdx.x < kF) {
            s_act[threadIdx.x] = s_dirty[threadIdx.x];
            rounds += s_dirty[threadIdx.x];
          }
          __syncthreads();
        } else {
          ++rounds;
        }
        if constexpr (kBf == kBfStatic) {
          // the threshold: min(max(each frame's largest vote, 1), cap)
          if (threadIdx.x < kF) s_th[threadIdx.x] = 1;
          __syncthreads();
          for (int f = 0; f < kF; ++f) {
            if (kFrame && !s_act[f]) continue;
            int mx = 0;
            for (int j = threadIdx.x; j < a.n_vote * z; j += kThreads)
              mx = max(mx, col_votes(unsat + f * per_frame, j / z, j % z, a));
            mx = __reduce_max_sync(0xffffffffu, mx);
            if ((threadIdx.x & 31) == 0 && mx > 1) atomicMax(&s_th[f], mx);
          }
          __syncthreads();
          if (threadIdx.x < kF) s_th[threadIdx.x] = min(s_th[threadIdx.x], a.vote_cap);
          __syncthreads();
          // flip every VN whose vote reaches it
          for (int i = threadIdx.x; i < n_items; i += kThreads) {
            const int zz = i % z, rest = i / z;
            const int k = rest % a.n_vote, f = rest / a.n_vote;
            if (kFrame && !s_act[f]) continue;
            if (col_votes(unsat + f * per_frame, k, zz, a) >= s_th[f])
              hard[f * n + a.vote_col[k] * z + zz] ^= 1;
          }
          __syncthreads();
        } else {
          // threshold machine; group mode: the word is dirty, so every
          // frame updates; frame mode: the dirty frames do
          if (threadIdx.x < kF && (!kFrame || s_act[threadIdx.x])) {
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
          if (threadIdx.x < kF) s_flip[threadIdx.x] = 0;
          __syncthreads();
          // flip weight-gamma VNs with votes + alpha * (hard != hard_ch) >= Th
          for (int i = threadIdx.x; i < n_items; i += kThreads) {
            const int zz = i % z, rest = i / z;
            const int k = rest % a.n_vote, f = rest / a.n_vote;
            if (kFrame && !s_act[f]) continue;
            const int votes = col_votes(unsat + f * per_frame, k, zz, a);
            const int v = f * n + a.vote_col[k] * z + zz;
            const int hv = hard[v], h = hv & 1;
            const int h_ch = en[v] > 0;   // hard_ch: the post-MP decision
            if (votes + a.alpha * (h ^ h_ch) >= s_th[f]) {
              if constexpr (kBf == kBf2b1c) {
                // below a threshold of gamma a reliable bit is demoted
                // instead of flipped
                if (s_th[f] >= a.gamma) hard[v] = static_cast<uint8_t>(hv ^ 3);
                else if (hv & 2) hard[v] = static_cast<uint8_t>(h);
                else hard[v] = static_cast<uint8_t>(hv ^ 1);
              } else {
                hard[v] = static_cast<uint8_t>(hv ^ 1);
              }
              atomicOr(&s_flip[f], 1);
            }
          }
          __syncthreads();
          if (threadIdx.x < kF && (!kFrame || s_act[threadIdx.x]))
            s_t[threadIdx.x] = s_flip[threadIdx.x];
          __syncthreads();
        }
      }
    }
  }

  // the decisions: the BF tail's bits where it ran, else en > 0
  const bool use_hard = kBf != kBfNone && alive;
  if constexpr (kOut == kHard) {
    int8_t* out = out_g + frame0 * n;
    for (int i = threadIdx.x; i < kF * n; i += kThreads)
      out[i] = static_cast<int8_t>(use_hard ? hard[i] & 1 : en[i] > 0);
  } else if constexpr (kOut == kEn) {
    int8_t* out = out_g + frame0 * n;
    for (int i = threadIdx.x; i < kF * n; i += kThreads) out[i] = en[i];
  } else {
    // ---- per-frame info-bit errors against the reference word (the
    // all-zero word without one)
    if (threadIdx.x < kF) s_err[threadIdx.x] = 0;
    __syncthreads();
    for (int f = 0; f < kF; ++f) {
      const int8_t* rf = ref ? ref + (frame0 + f) * static_cast<size_t>(ref_stride) : nullptr;
      int cnt = 0;
      for (int v = threadIdx.x; v < a.n_info; v += kThreads) {
        const int bit = use_hard ? hard[f * n + v] & 1 : en[f * n + v] > 0;
        cnt += rf ? bit ^ (rf[v] != 0) : bit;
      }
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&s_err[f], cnt);
    }
    __syncthreads();
    if (threadIdx.x < kF) err_out[frame0 + threadIdx.x] = s_err[threadIdx.x];
  }
  if (threadIdx.x < kF) {
    iters_out[frame0 + threadIdx.x] = iters;
    if constexpr (kOut != kEn) bf_out[frame0 + threadIdx.x] = rounds;
  }
  // Every distributed-shared-memory access (cluster_or's marks) comes
  // before a cluster barrier that all blocks of the word pass, so a
  // block may leave without waiting for the others.
}

// Launches an instance on batch / kF blocks of kThreads threads; group
// mode in clusters of kCl blocks, one 32-frame word each.  With `info`
// set it launches nothing and writes [active clusters (group mode) or
// blocks per SM (frame mode), dynamic shared bytes, frames a block,
// blocks a cluster].
template <int kOut, int kStyle, int kBf, bool kFrame, int kBits>
int launch(const Buffers& b, const CodeArgs& a, const ChanArgs& c, int batch, void* stream,
           int* info) {
  constexpr int kF = kFrames<kBits>;
  constexpr int kCl = kFrame ? 1 : kCluster<kBits>;
  auto kernel = decoder_kernel<kOut, kStyle, kBf, kFrame, kBits>;
  // the check map is needed by the map-keeping styles and the BF tail
  const size_t smem = smem_bytes(kF, a, kKeepsMap<kStyle> || kBf != kBfNone);
  if (kOut == kSim && 2 * c.L + 1 > kMaxParams) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || batch % kGroup) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t st = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
  if (st == cudaSuccess && kCl > 8)
    st = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (st != cudaSuccess) return static_cast<int>(st);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch / kF);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = kFrame ? nullptr : attr;
  cfg.numAttrs = kFrame ? 0 : 1;
  int active = 0;
  if constexpr (kFrame)
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&active, kernel, kThreads, smem);
  else
    st = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (info) {
    info[0] = active;
    info[1] = static_cast<int>(smem);
    info[2] = kF;
    info[3] = kCl;
    return 0;
  }
  if (active == 0) return kNoCluster;
  st = cudaLaunchKernelEx(&cfg, kernel, b.llr, b.out, b.err, b.iters, b.rounds, b.ref,
                          b.ref_stride, a, c);
  if (st != cudaSuccess) return static_cast<int>(st);
  return static_cast<int>(cudaGetLastError());
}

// An instance for a runtime (stop mode, message width):
// cudaErrorNotSupported for a width other than 4 or 8 bits.
template <int kOut, int kStyle, int kBf>
int launch_modes(int frame, int bits, const Buffers& b, const CodeArgs& a, const ChanArgs& c,
                 int batch, void* stream, int* info) {
  if (bits == 4)
    return frame ? launch<kOut, kStyle, kBf, true, 4>(b, a, c, batch, stream, info)
                 : launch<kOut, kStyle, kBf, false, 4>(b, a, c, batch, stream, info);
  if (bits == 8)
    return frame ? launch<kOut, kStyle, kBf, true, 8>(b, a, c, batch, stream, info)
                 : launch<kOut, kStyle, kBf, false, 8>(b, a, c, batch, stream, info);
  return static_cast<int>(cudaErrorNotSupported);
}

// The switch key of a (style, BF kind) pair.
constexpr int pair_key(int style, int bf) { return style * 4 + bf; }

}  // namespace faid
