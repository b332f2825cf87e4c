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
// int32 operations per edge and frame in the op model (70,400 edges a
// frame on 50G-PON) on state that every edge touches twice, so the state
// has to sit next to the ALUs.  A 32-frame word's state is 2.25 MB of int8
// messages and 0.56 MB of en, too much for one SM; kept in global memory
// (L2 and HBM), it costs a byte gather or scatter there per edge and pass,
// and a block per word leaves half of the 132 SMs idle at batch 2048.
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
//    H100 SXM at 700 W, the measurement recorded in PERF.md section 6);
//  * frame mode needs no OR across blocks and launches no cluster: each
//    frame's state, iterations and rounds depend on its own sweeps only
//    (frozen frames keep their state; a BF tail reactivates every frame
//    and its first sweep refreezes the clean ones, which then neither
//    flip nor count a round; a clean frame's decisions are en > 0 with or
//    without a tail), so a block that leaves its loops when its own frames
//    are frozen gives the counters a word-wide loop gives;
//  * frames in lanes: the block's kF frames sit side by side.  en is
//    frame-interleaved, the kF int8 values of a VN in one 32-bit word (kF
//    4) or 16-bit half (kF 2), frame f in byte f; the check map likewise,
//    a byte a frame of each check; and the messages of (row, zz) for the
//    kF frames together, 16 bits an edge (4 frames x 4 bits, or 2 x 8),
//    stored negated and, at 4 bits, biased by 8, so that they enter the
//    lanes with one mask or byte permute.  One thread thus updates a check
//    for all the block's frames: one address computation and one shared
//    load per edge serve kF frames, and the arithmetic runs on packed
//    registers (row_update): the clip of vn - m in 16-bit lanes (Hopper's
//    DPX __viaddmax_s16x2 / __viaddmin_s16x2, a sum and a max or min in
//    one instruction), then signs, magnitudes, min1 / min2, the parity
//    and the selects of pass 2 in byte lanes (a byte compare is a biased
//    add whose bit 7 prmt replicates; FAID's 8-entry LUT is one prmt for
//    four frames).  What differs by frame is a per-byte select: EF 1's
//    and EF 2's floor row, EF 2's erasure, selective OMS's offsets, and in
//    frame mode a frozen frame's bytes, written back unchanged.  The
//    sweeps read a word for all the frames likewise (hard_bytes);
//  * kThreads = 1024 threads: a quad of adjacent threads takes one check
//    of the row, lane q the message words q, q + 4, q + 8 of its (row,
//    zz) (two edges a word, at most 6 edges a lane), and two
//    __shfl_xor_sync steps combine min1, min2 and the parity; 256 checks
//    fill the block on 50G-PON.  Within a block row each VN is touched by
//    exactly one check (a column appears once per row and z -> (z + s) mod
//    Z is a bijection), so a row update needs no atomics, only a
//    __syncthreads() before the next row.  A (row, zz) takes 4 x an odd
//    number of words, side by side, so that a warp's 8 checks x 4 lanes
//    load and store 32 banks; the quad keeps the row's VN indices,
//    contributions and magnitudes in registers from pass 1 to pass 2;
//  * after MP the message region holds the BF tail's state (bf_tail): a
//    byte per VN (the hard decision, the 2B1C reliability bit, the post-MP
//    decision), a copy of the check map for the round's flips to toggle,
//    and the vote tables.  The tail sweeps the checks once and then keeps
//    the map and each frame's count up to date by the flips, so a round
//    reads only the voting columns' checks, in shared memory;
//  * code tables are runtime arguments (row pointers, entry columns and
//    shifts, the message offsets, the voting columns' adjacency, the LUT
//    rows), so the same kernel also runs a toy code; kMaxDeg bounds the
//    per-thread register arrays of one row and the wrapper checks it;
//  * the phase clocks: kernels B and F may take a [3] uint64 buffer
//    (`phases`, null in D and E) to which each block adds its SM cycles of
//    the prologue, MP and the BF tail, thread 0 reading clock64() at the
//    phases' ends; never reset, so a reader takes differences.  In group
//    mode a word's blocks run the same iterations and rounds, so the
//    phases' shares of the cycles are their shares of the launch.
// What holds it back: a cluster of 8 needs 8 SMs of one GPC, and 15 fit
// at once, so 64 words run in 5 waves on 120 SMs; a barrier a row, and
// within the row the quad's shared loads of en, whose four columns meet
// at unrelated shifts (bank conflicts the code decides); a sweep that
// finds the word clean re-reads every edge; kernel F's prologue draws on
// those 120 SMs too.  Where tails run (FAID-2B1C at 3.6 dB, ~10 rounds a
// word) a tail round takes ~0.05 ms of a batch of 2048 frames, its
// opening sweep ~0.03 ms once (chip_smoke.py phase 25).
// All arithmetic is exact integer arithmetic with the reference's int8
// saturations kept explicit; there is no floating point in the kernel.
// Each packed step keeps its lanes apart: a byte lane's values stay
// below 128 where bytes are added or compared, so no carry or borrow
// crosses a lane (the wrapper refuses check-node constants outside int8).
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
  const int32_t* msg_off;     // [n_rows + 1] first word of each row in the
                              //   block's message region (row r: z groups
                              //   of (msg_off[r+1] - msg_off[r]) / z words,
                              //   the kF frames' messages of (r, zz))
  int msg_words;              // words of the block's message region
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
  unsigned long long* phases = nullptr;   // [3] the phase clocks (kernels B
                                          //   and F; null: none)
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
// to 16 bytes, then the block's message words, then the check map where
// the style or a BF tail keeps one.  ops/cuda_decoder.py `launch_plan`
// computes the same.
__host__ __device__ inline size_t en_bytes(int frames, int n_var) {
  return (static_cast<size_t>(frames) * n_var + 15) & ~static_cast<size_t>(15);
}
__host__ __device__ inline size_t smem_bytes(int frames, const CodeArgs& a, bool map) {
  return en_bytes(frames, a.n_var) + static_cast<size_t>(a.msg_words) * 4 +
         (map ? static_cast<size_t>(frames) * a.n_rows * a.z : 0);
}

// The BF tail's layout in the message region (bytes from its start): the
// hard bits [frames][n_var], then the check map the flips toggle
// [frames][n_rows * z], then the vote tables, column bases [n_vote],
// adjacency pointers [n_vote + 1] and entries (at most n_entries), a word
// each.  launch() checks that the region holds it; ops/cuda_decoder.py
// `launch_plan` sizes the region so.
__host__ __device__ inline size_t tail_map_off(int frames, const CodeArgs& a) {
  return en_bytes(frames, a.n_var);
}
__host__ __device__ inline size_t tail_tab_off(int frames, const CodeArgs& a) {
  return tail_map_off(frames, a) + en_bytes(frames, a.n_rows * a.z);
}
__host__ __device__ inline size_t tail_bytes(int frames, const CodeArgs& a) {
  return tail_tab_off(frames, a) + 4 * (2 * static_cast<size_t>(a.n_vote) + 1 + a.n_entries);
}

__device__ __forceinline__ int wrap(int i, int z) { return i >= z ? i - z : i; }
__device__ __forceinline__ int sat8(int x) { return min(max(x, -128), 127); }

// Index in a frame's [n_var] of the VN of entry ge at check zz.
__device__ __forceinline__ int vn_index(const CodeArgs& a, int ge, int zz) {
  return __ldg(a.ent_col + ge) * a.z + wrap(zz + __ldg(a.ent_shift + ge), a.z);
}

// ---- frames in lanes: the block's kF frames in the bytes of a word,
// frame f in byte f (kF = 2: bytes 2 and 3 are zero on a load, and the
// lanes' results there are never stored).

// Element i of an array in lanes (en, MP's check map): kF bytes.
template <int kF>
__device__ __forceinline__ uint32_t load_lanes(const uint8_t* p, int i) {
  if constexpr (kF == 4) return reinterpret_cast<const uint32_t*>(p)[i];
  else return reinterpret_cast<const uint16_t*>(p)[i];
}
template <int kF>
__device__ __forceinline__ void store_lanes(uint8_t* p, int i, uint32_t w) {
  if constexpr (kF == 4) reinterpret_cast<uint32_t*>(p)[i] = w;
  else reinterpret_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(w);
}
__device__ __forceinline__ int frame_byte(uint32_t w, int f) {
  return static_cast<int8_t>(w >> 8 * f);
}

// prmt.b32 in PTX's default mode, where a selector nibble with its top
// bit set replicates the sign of the byte it selects
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
}
// 0xff in each byte whose bit 7 is set, else 0
__device__ __forceinline__ uint32_t sign_bytes(uint32_t x) { return prmt(x, 0u, 0xBA98u); }
// a where the mask's bits are set, else b
__device__ __forceinline__ uint32_t bsel(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}
// 0xff in each byte where x >= y; every byte of x and y is below 128
__device__ __forceinline__ uint32_t ge_bytes(uint32_t x, uint32_t y) {
  return sign_bytes(x + 0x80808080u - y);
}
// bytes 2p and 2p + 1 of w as two 16-bit lanes, sign- or zero-extended
__device__ __forceinline__ uint32_t lanes_sx(uint32_t w, int p) {
  return prmt(w, 0u, p ? 0xB3A2u : 0x9180u);
}
__device__ __forceinline__ uint32_t lanes_zx(uint32_t w, int p) {
  return prmt(w, 0u, p ? 0x4342u : 0x4140u);
}
// the low bytes of the 16-bit lanes of frames 0-1 and 2-3
__device__ __forceinline__ uint32_t lane_bytes(uint32_t l01, uint32_t l23) {
  return prmt(l01, l23, 0x6420u);
}
__device__ __forceinline__ uint32_t splat16(int x) {
  return (static_cast<uint32_t>(x) & 0xffffu) * 0x10001u;
}
// min(x, y) in each 16-bit lane
__device__ __forceinline__ uint32_t min16(uint32_t x, uint32_t y) {
  uint32_t r;
  asm("min.s16x2 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(y));
  return r;
}
// min(max(x + y, lo), hi) in each 16-bit lane: the clip of a sum in two
// instructions (Hopper's DPX add-max, then a min)
__device__ __forceinline__ uint32_t clip_sum(uint32_t x, uint32_t y, uint32_t lo, uint32_t hi) {
  return min16(__viaddmax_s16x2(x, y, lo), hi);
}
// min(max(x + y, lo) + c, hi): the same with a bias c taken off between
__device__ __forceinline__ uint32_t clip_sum(uint32_t x, uint32_t y, uint32_t lo, uint32_t c,
                                             uint32_t hi) {
  return __viaddmin_s16x2(__viaddmax_s16x2(x, y, lo), c, hi);
}
// bit 7 of each byte: the byte is > 0, a hard 1
__device__ __forceinline__ uint32_t hard_bytes(uint32_t w) {
  return ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) & ~w & 0x80808080u;
}

// The parity of check (r, zz) over the decisions en > 0 of the block's
// frames: bit 7 of byte f, frame f's.
template <int kF>
__device__ __forceinline__ uint32_t check_parity(const uint8_t* en, const CodeArgs& a, int r,
                                                 int zz) {
  uint32_t acc = 0;
  const int e1 = __ldg(a.row_ptr + r + 1);
  for (int e = __ldg(a.row_ptr + r); e < e1; ++e)
    acc ^= hard_bytes(load_lanes<kF>(en, vn_index(a, e, zz)));
  return acc;
}

// The frames whose bit 7 is set in w, as bits 0 .. kF - 1.
__device__ __forceinline__ int frame_bits(uint32_t w) {
  return static_cast<int>(((w >> 7) & 0x01010101u) * 0x10204080u >> 28);
}

// Each thread's per-frame values v[f] summed over the warp (their maximum
// with kMax) and added into s[f] (maxed, where above 1) by one shared
// atomic a warp and frame.  Every thread of the block calls it, converged.
template <int kF, bool kMax = false>
__device__ __forceinline__ void warp_flush(const int (&v)[kF], int* s) {
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    const int t = kMax ? __reduce_max_sync(0xffffffffu, v[f]) : __reduce_add_sync(0xffffffffu, v[f]);
    if ((threadIdx.x & 31) == 0 && (kMax ? t > 1 : t != 0)) {
      if (kMax) atomicMax(&s[f], t);
      else atomicAdd(&s[f], t);
    }
  }
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
// An item is a check of all the block's frames.
template <int kF>
__device__ inline int any_unsat(const uint8_t* en, const CodeArgs& a, volatile int* seen) {
  const int z = a.z, checks = a.n_rows * z;
  int found = 0;
  for (int j = threadIdx.x; j < checks && !found && !*seen; j += kThreads) {
    const int r = j / z;
    found = (check_parity<kF>(en, a, r, j - r * z) & 0x80808080u) != 0;
    if (found) {
      cg::cluster_group cl = cg::this_cluster();
      for (int b = 0; b < kGroup / kF; ++b)
        *cl.map_shared_rank(const_cast<int*>(seen), b) = 1;
    }
  }
  return found;
}

// The block's unsatisfied-check map from en > 0 into `unsat`, in lanes (a
// byte 0 or 1 a frame of each check), and each frame's count into s_cnt;
// true when any check of the word is unsatisfied.  Frame mode counts the
// active frames only (a frozen frame's map reads 0) and leaves each
// frame's new flag (count > 0) in s_act.
template <bool kFrame, int kF, int kCl>
__device__ inline bool word_map(const uint8_t* en, uint8_t* unsat, int* s_cnt, int* s_act,
                                int* s_or, int& slot, const CodeArgs& a) {
  const int z = a.z, checks = a.n_rows * z;
  uint32_t act = 0;
#pragma unroll
  for (int f = 0; f < kF; ++f) act |= (!kFrame || s_act[f] ? 1u : 0u) << 8 * f;
  if (threadIdx.x < kF) s_cnt[threadIdx.x] = 0;
  __syncthreads();
  int cnt[kF] = {};
  uint32_t found = 0;
  for (int j = threadIdx.x; j < checks; j += kThreads) {
    const int r = j / z;
    const uint32_t bits = (check_parity<kF>(en, a, r, j - r * z) >> 7) & act;
    store_lanes<kF>(unsat, j, bits);
    found |= bits;
#pragma unroll
    for (int f = 0; f < kF; ++f) cnt[f] += (bits >> 8 * f) & 1;
  }
  warp_flush<kF>(cnt, s_cnt);
  const bool any = decide<kFrame, kCl>(found != 0, s_or, slot);
  if (kFrame && threadIdx.x < kF) s_act[threadIdx.x] = s_cnt[threadIdx.x] > 0;
  return any;
}

// Frame mode's sweep for the styles without a map (FAID/EF 0, NMS): each
// active frame's "any unsatisfied check" into s_act, with an early exit
// once every active frame is found dirty (s_dirty, a bit a frame); true
// when any frame of the block is dirty.
template <int kF>
__device__ inline bool frame_flags(const uint8_t* en, int* s_act, int* s_dirty,
                                   const CodeArgs& a) {
  const int z = a.z, checks = a.n_rows * z;
  int act = 0;
#pragma unroll
  for (int f = 0; f < kF; ++f) act |= (s_act[f] ? 1 : 0) << f;
  if (threadIdx.x == 0) *s_dirty = 0;
  __syncthreads();
  volatile int* dirty = s_dirty;
  for (int j = threadIdx.x; j < checks; j += kThreads) {
    const int d = *dirty;
    if ((d & act) == act) break;
    const int r = j / z;
    const int fresh = frame_bits(check_parity<kF>(en, a, r, j - r * z)) & act & ~d;
    if (fresh) atomicOr(s_dirty, fresh);
  }
  __syncthreads();
  const int mine = threadIdx.x < kF ? (*s_dirty >> threadIdx.x) & 1 : 0;
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
// entry p on (its 3 checks), in MP's check map: a byte a frame.
template <int kF>
__device__ __forceinline__ uint32_t ef_votes(const uint8_t* unsat, int p, int j,
                                             const CodeArgs& a) {
  const int z = a.z;
  uint32_t votes = 0;
  for (int k = p; k < p + 3; ++k)
    votes += load_lanes<kF>(unsat, __ldg(a.ef_row + k) * z + wrap(j - __ldg(a.ef_shift + k) + z, z));
  return votes;
}

// What a row update reads that is fixed for an iteration, in lanes.
struct IterLanes {
  uint32_t lut[2], lut_ef[2];   // FAID's row and error-floor row, a byte an entry
  uint32_t floor;   // 0xff in the bytes of the frames in the floor window
                    //   with few unsatisfied checks (the map-keeping styles)
  uint32_t act;     // frame mode: 0xff in the bytes of the active frames
  uint32_t bt;      // FAID: 0x7f7f7f7f with the sign backtrack, else 0x80808080
};

// The check-node constants c = cste(m) of the kF frames of m (a min1 or
// min2, a byte a frame) and -c, a byte a frame; `factor` is NMS's, eff
// the frames in the floor window.  The wrapper keeps c within int8.
template <int kStyle, int kF>
__device__ __forceinline__ void constants(uint32_t m, uint32_t eff, int factor, const CodeArgs& a,
                                          uint32_t& c, uint32_t& nc) {
  if constexpr (kStyle == kNms || kStyle == kOmsSel) {
    c = nc = 0;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const int mf = (m >> 8 * f) & 0xff;
      // arithmetic >> as the reference's int16 lanes and JAX's int32
      const int x = kStyle == kNms
                        ? min(sat8((mf * factor) >> 5), kSatMsg)
                        : min(offsel(mf, (eff >> 8 * f) & 1, a.factor_1, a.factor_2), kSatMsg);
      c |= (static_cast<uint32_t>(x) & 0xffu) << 8 * f;
      nc |= (static_cast<uint32_t>(-x) & 0xffu) << 8 * f;
    }
  } else {
    // min(m - offset, 7) and max(offset - m, -7) in 16-bit lanes, the
    // latter biased by 0x4000 so that the subtraction borrows nothing
    const uint32_t off = splat16(-a.offset), bias = splat16(0x4000 + a.offset);
    uint32_t cl[2] = {}, nl[2] = {};
#pragma unroll
    for (int p = 0; p < kF / 2; ++p) {
      const uint32_t mp = lanes_zx(m, p);
      cl[p] = __viaddmin_s16x2(mp, off, splat16(kSatMsg));
      nl[p] = __viaddmax_s16x2(bias - mp, splat16(-0x4000), splat16(-kSatMsg));
    }
    c = lane_bytes(cl[0], cl[1]);
    nc = lane_bytes(nl[0], nl[1]);
  }
}

// Block row r of one layered iteration for the block's frames, in lanes:
// a quad of threads a check (zz = i / 4), lane q the message words q, q +
// 4, q + 8 of (r, zz) and their edges 2q, 2q + 1, 2q + 8, 2q + 9, 2q + 16,
// 2q + 17, each for all kF frames at once.  it.floor and the check map
// open the error-floor window of the map-keeping styles.  Frame mode
// writes a frozen frame's bytes back as they were (it.act).
//
// Pass 1: the contribution v = vn - m, clipped in 16-bit lanes, packed to
// bytes (vcp, kept for pass 2), its sign (negs: edge k's at bit 7 - k of
// each frame's byte), its magnitude, and the row's min1 / min2 over the
// lane's edges, which two shuffles a quad combine with the parity.
// Pass 2: the new message, cste1 or cste2 signed, chosen per byte by
// selects; en = clip(v + message), and the message stored negated.
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
__device__ void row_update(uint8_t* en, uint32_t* msg, const uint8_t* unsat,
                           const IterLanes& it, int r, const CodeArgs& a) {
  constexpr int kSlots = (kMaxDeg + 7) / 8;   // message words a lane
  constexpr int kEdges = 2 * kSlots;          // and their edges
  // a stored message is kBias - m: 4 bits biased to 1..15, or an int8
  constexpr int kBias = kBits == 4 ? 8 : 0;
  constexpr int kHi = kIsFaid<kStyle> ? kSatVar : 127;
  const int z = a.z;
  const int e0 = __ldg(a.row_ptr + r), deg = __ldg(a.row_ptr + r + 1) - e0;
  // the row's words a (row, zz): 4 x an odd number (ops/cuda_decoder.py
  // `_row_words`), two edges a word
  const int m0 = __ldg(a.msg_off + r), wr = 4 * ((deg + 7) / 8 | 1);
  const uint32_t lo = splat16(kBias - kSatVar), unbias = splat16(-kBias), hi = splat16(kHi);
  const uint32_t odd = deg & 1 ? 0x80808080u : 0u;
  const unsigned quad = 0xfu << (threadIdx.x & 28);
  for (int i = threadIdx.x; i < 4 * z; i += kThreads) {
    const int zz = i >> 2, q = i & 3;
    uint32_t* mw = msg + m0 + zz * wr;
    // the lane's entries: edge 2q + o at offset o
    const int32_t* cols = a.ent_col + e0 + 2 * q;
    const int32_t* shifts = a.ent_shift + e0 + 2 * q;
    uint32_t eff = 0;   // the frames whose check is in the floor window
    if constexpr (kKeepsMap<kStyle>) eff = it.floor & (load_lanes<kF>(unsat, r * z + zz) * 0xffu);
    // EF 2: the lane's edges whose contribution is erased, edge k's at bit
    // 7 - k of each frame's byte, found before pass 1
    uint32_t erase = 0;
    if constexpr (kStyle == kFaidEf2) {
      if (it.floor) {
#pragma unroll 1
        for (int k = 0; k < kEdges; ++k) {
          const int e = 2 * q + 8 * (k >> 1) + (k & 1);
          if (e >= deg) break;
          const int p = __ldg(a.ef_ptr + e0 + e);
          if (p >= 0) {
            const uint32_t votes =
                ef_votes<kF>(unsat, p, wrap(zz + __ldg(a.ent_shift + e0 + e), z), a);
            erase |= ((votes + 0x7d7d7d7du) & it.floor & 0x80808080u) >> k;
          }
        }
      }
    }
    uint32_t words[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) words[s] = 8 * s + 2 * q < deg ? mw[q + 4 * s] : 0u;
    int idx[kEdges];        // the lane's VNs, from pass 1 to pass 2
    uint32_t vcp[kEdges];   // their contributions, a byte a frame
    uint32_t cmp[kEdges];   // what pass 2 compares with min1
    uint32_t negs = 0, min1 = 0x1f1f1f1fu, min2 = 0x1f1f1f1fu;
    // pass 1: contributions, signs, magnitudes, min1/min2
#pragma unroll
    for (int k = 0; k < kEdges; ++k) {
      const int o = 8 * (k >> 1) + (k & 1), e = 2 * q + o;
      if (e < deg) {
        idx[k] = __ldg(cols + o) * z + wrap(zz + __ldg(shifts + o), z);
        const uint32_t w = load_lanes<kF>(en, idx[k]);
        // v = clip(vn - m): FAID to +-31; NMS and OMS the int8 saturation
        // and the lower clip, up to 31 + 7
        uint32_t vb;
        if constexpr (kBits == 4) {
          const uint32_t x = (k & 1 ? words[k >> 1] >> 4 : words[k >> 1]) & 0x0f0f0f0fu;
          vb = lane_bytes(clip_sum(lanes_sx(w, 0), lanes_zx(x, 0), lo, unbias, hi),
                          clip_sum(lanes_sx(w, 1), lanes_zx(x, 1), lo, unbias, hi));
        } else {
          const uint32_t x = prmt(words[k >> 1], 0u, k & 1 ? 0xB3A2u : 0x9180u);
          vb = lane_bytes(clip_sum(lanes_sx(w, 0), x, lo, hi), 0u);
        }
        if constexpr (kStyle == kFaidEf2) vb &= ~sign_bytes(erase << k);
        vcp[k] = vb;
        // |v| = (v ^ s) + (s & 1) a byte at a time: no carry leaves a byte
        const uint32_t sb = sign_bytes(vb), av = vb ^ sb, one = sb & 0x01010101u;
        uint32_t neg = sb, mag;
        if constexpr (kIsFaid<kStyle>) {
          // the LUT at min(|v|, 7): |v| + 0x78 has bit 7 where |v| >= 8;
          // the four indices go to prmt's selector nibbles in frame order
          const uint32_t y = av + one + 0x78787878u;
          const uint32_t ix = prmt((y | sign_bytes(y)) & 0x07070707u, 0u, 0x3120u);
          const uint32_t sel = ix | ix >> 12;
          mag = prmt(it.lut[0], it.lut[1], sel);
          if constexpr (kSwapsLut<kStyle>)
            mag = bsel(eff, prmt(it.lut_ef[0], it.lut_ef[1], sel), mag);
          // a zero contribution borrows En's sign (|v| + it.bt has bit 7
          // clear only at |v| = 0 with the backtrack)
          neg |= ~(av + one + it.bt) & w;
          cmp[k] = mag;
        } else {
          const uint32_t absv = av + one;
          cmp[k] = absv;
          if constexpr (kStyle == kNms) {
            mag = absv;
          } else {
            const uint32_t y = absv + 0x78787878u;
            mag = (y | sign_bytes(y)) & 0x07070707u;
          }
        }
        negs |= (neg & 0x80808080u) >> k;
        const uint32_t g = ge_bytes(min1, mag), big = bsel(g, min1, mag);
        min1 = bsel(g, mag, min1);
        min2 = bsel(ge_bytes(min2, big), big, min2);
      }
    }
    // the quad's min1, min2 and parity (bit 7 of each byte: the XOR of the
    // byte's sign bits)
    uint32_t par = negs;
    par ^= par << 1;
    par ^= par << 2;
    par ^= par << 4;
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      par ^= __shfl_xor_sync(quad, par, d);
      const uint32_t o1 = __shfl_xor_sync(quad, min1, d), o2 = __shfl_xor_sync(quad, min2, d);
      const uint32_t g = ge_bytes(min1, o1), big = bsel(g, min1, o1);
      min1 = bsel(g, o1, min1);
      const uint32_t m2 = bsel(ge_bytes(min2, o2), o2, min2);
      min2 = bsel(ge_bytes(big, m2), m2, big);
    }
    // each edge's new sign, parity ^ own ^ odd degree, at its bit
    negs ^= (((par ^ odd) & 0x80808080u) >> 5) * 0x3fu;
    // cste1 (from min2) where the edge's magnitude is min1, else cste2,
    // and their negations
    uint32_t c1, n1, c2, n2;
    constants<kStyle, kF>(min2, eff, a.factor_2, a, c1, n1);
    constants<kStyle, kF>(min1, eff, a.factor_1, a, c2, n2);
    const uint32_t min1p = min1 + 0x01010101u;
    const uint32_t wact = kBits == 4 ? it.act : prmt(it.act, 0u, 0x1010u);
    // pass 2: new messages and en.  FAID compares the mapped magnitude
    // with min1, NMS and OMS the raw |contribution|.
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      uint32_t st[2] = {};   // -message, a byte a frame
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 2 * s + h, e = 2 * q + 8 * s + h;
        if (e < deg) {
          const uint32_t two = sign_bytes(cmp[k] + 0x80808080u - min1p);   // cmp != min1
          const uint32_t pos = bsel(two, c2, c1), negm = bsel(two, n2, n1);
          const uint32_t ne = sign_bytes(negs << k);
          const uint32_t nm = bsel(ne, negm, pos);
          st[h] = bsel(ne, pos, negm);
          const uint32_t lo31 = splat16(-kSatVar), hi31 = splat16(kSatVar);
          uint32_t enw;
          if constexpr (kF == 4)
            enw = lane_bytes(clip_sum(lanes_sx(vcp[k], 0), lanes_sx(nm, 0), lo31, hi31),
                             clip_sum(lanes_sx(vcp[k], 1), lanes_sx(nm, 1), lo31, hi31));
          else
            enw = lane_bytes(clip_sum(lanes_sx(vcp[k], 0), lanes_sx(nm, 0), lo31, hi31), 0u);
          if constexpr (kFrame) enw = bsel(it.act, enw, load_lanes<kF>(en, idx[k]));
          store_lanes<kF>(en, idx[k], enw);
        }
      }
      if (8 * s + 2 * q < deg) {
        // 4 bits: byte f holds frame f's nibbles, 8 - m, edge 2j low;
        // 8 bits: the bytes -m of (2j, f0), (2j, f1), (2j + 1, f0), (2j + 1, f1)
        uint32_t word = kBits == 4
                            ? ((st[0] & 0x0f0f0f0fu) | (st[1] << 4 & 0xf0f0f0f0u)) ^ 0x88888888u
                            : prmt(st[0], st[1], 0x5410u);
        if constexpr (kFrame) word = bsel(wact, word, words[s]);
        mw[q + 4 * s] = word;
      }
    }
  }
}

// The block's LLRs into en, in lanes, the punctured tail zeroed: a
// thread reads 4 bytes of each frame's row and writes the 4 VNs' words
// (a 4 x 4 byte transpose) where the rows allow it.
template <int kF>
__device__ inline void llr_ingest(uint8_t* en, const int8_t* in, const CodeArgs& a) {
  const int n = a.n_var;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(in) & 3) == 0) {
    for (int c = threadIdx.x; c < n / 4; c += kThreads) {
      uint32_t row[4] = {};
#pragma unroll
      for (int f = 0; f < kF; ++f) row[f] = reinterpret_cast<const uint32_t*>(in + f * n)[c];
      const uint32_t lo01 = prmt(row[0], row[1], 0x5140u), hi01 = prmt(row[0], row[1], 0x7362u);
      const uint32_t lo23 = prmt(row[2], row[3], 0x5140u), hi23 = prmt(row[2], row[3], 0x7362u);
      // VN 4c + j's word: byte j of each row
      uint32_t w[4];
      if constexpr (kF == 4) {
        w[0] = prmt(lo01, lo23, 0x5410u);
        w[1] = prmt(lo01, lo23, 0x7632u);
        w[2] = prmt(hi01, hi23, 0x5410u);
        w[3] = prmt(hi01, hi23, 0x7632u);
      } else {
        w[0] = lo01 & 0xffffu;
        w[1] = lo01 >> 16;
        w[2] = hi01 & 0xffffu;
        w[3] = hi01 >> 16;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * c + j >= a.punct_start) w[j] = 0;
      if constexpr (kF == 4)
        reinterpret_cast<uint4*>(en)[c] = make_uint4(w[0], w[1], w[2], w[3]);
      else
        reinterpret_cast<uint2*>(en)[c] = make_uint2(w[0] | w[1] << 16, w[2] | w[3] << 16);
    }
  } else {
    for (int v = threadIdx.x; v < n; v += kThreads) {
      uint32_t w = 0;
#pragma unroll
      for (int f = 0; f < kF; ++f)
        w |= static_cast<uint32_t>(static_cast<uint8_t>(in[f * n + v])) << 8 * f;
      store_lanes<kF>(en, v, v >= a.punct_start ? 0u : w);
    }
  }
}

// Kernel F's prologue, the counterpart of pallas_decoder.py:581-626:
// frame f of the block draws its Philox words (stream frame c.frame0 +
// frame0 + f), pushes each through the staircase, mirrored by the
// codeword bit, into en (the punctured tail zeroed), and adds its
// ModCalErr info-bit errors and (even, odd) symbol errors into s_mb and
// s_ms.  The per-bit code is kernel A's (staircase.cuh), and the bits
// of a group of four stay in one thread, as in A; a thread takes a group
// for all the block's frames, so that it writes the 4 VNs' words of en.
template <int kF>
__device__ inline void channel_ingest(uint8_t* en, const int8_t* cw, size_t frame0,
                                      const int32_t* sp, int* s_mb, int* s_ms,
                                      const ChanArgs& c, const CodeArgs& a) {
  const int n = a.n_var, groups = (n + 3) / 4;
  const uint2 key = make_uint2(c.key_lo, c.key_hi);
  // each frame's counts, a byte a frame: a thread takes at most n / 4096
  // groups, fewer than 30 where en fits shared memory, so a byte stays
  // below 120
  uint32_t nbs = 0, nss = 0;
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    uint32_t wv[4] = {};   // VN 4g + j's word
    // one frame at a time, as kernel A draws them (unrolled, the four
    // frames' staircases only lengthen the build)
#pragma unroll 1
    for (int f = 0; f < kF; ++f) {
      const size_t row = (frame0 + f) * static_cast<size_t>(n);
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
          if (bit < a.punct_start) wv[j] |= (static_cast<uint32_t>(q) & 0xffu) << 8 * f;
          e[j] = (bit < a.n_info) & err;
        }
      }
      nbs += static_cast<uint32_t>(e[0] + e[1] + e[2] + e[3]) << 8 * f;
      // QPSK: (even, odd) pairs
      nss += static_cast<uint32_t>((e[0] | e[1]) + (e[2] | e[3])) << 8 * f;
    }
    if (4 * g + 3 < n) {
      if constexpr (kF == 4)
        reinterpret_cast<uint4*>(en)[g] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
      else
        reinterpret_cast<uint2*>(en)[g] = make_uint2(wv[0] | wv[1] << 16, wv[2] | wv[3] << 16);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < n) store_lanes<kF>(en, 4 * g + j, wv[j]);
    }
  }
  int nb[kF], ns[kF];
#pragma unroll
  for (int f = 0; f < kF; ++f) {
    nb[f] = (nbs >> 8 * f) & 0xff;
    ns[f] = (nss >> 8 * f) & 0xff;
  }
  warp_flush<kF>(nb, s_mb);
  warp_flush<kF>(ns, s_ms);
}

// The BF tail (faid_tpu/decoders/bf.py): static BF, DTBF or 2B1C-DTBF on
// the decisions en > 0, at most bf_max_iter rounds, each opened by the
// stop decision of the word (group mode) or of each frame (frame mode).
// Returns the rounds (frame mode: thread f < kF, frame f's).  Its state
// lies in the message region, free after MP (tail_bytes), a frame after
// another rather than in lanes: hard[f][v], bit 0 the decision, bit 1 the
// 2B1C reliability bit, bit 3 the post-MP decision (DTBF's hard_ch); the
// check map [f][check] in unsat (MP's map, in lanes, is not read again)
// and the copy the flips toggle (tmap); the vote tables.
//
// The check map is kept up to date by the flips, not swept each round:
// one opening sweep makes each frame's map (unsat) and count (s_cnt) from
// the post-MP bits; after it, a VN whose decision flips toggles the map
// entries of its checks, which are the entries its votes read (vote_ptr,
// vote_row, vote_shift; every column for static BF), and adds +-1 to its
// frame's count.  Every vote of a round reads the map of the round's top:
// the flips toggle tmap, a copy, which after the round's barrier is
// copied back over unsat.  A 2B1C demote keeps bit 0 and toggles nothing.
// So the map stays the parity of the hard bits, and the stop decisions
// and frame mode's flags read the counts.
//
// A round reads shared memory only: the vote tables are copied there once
// a tail, (column * z) and (row * z | (z - shift) << 16) to a word.  No
// item divides: thread t takes bit zz = t % z of the columns k = t / z,
// t / z + P, ... (P = kThreads / z columns a step; threads from P * z on
// idle), each column's table entries read once for the block's kF frames
// (the opening sweep likewise takes rows).  The flip flags and count
// changes are reduced in the warp before one shared atomic a warp.  The
// threshold machines (thread f < kF, frame f's, in registers) run for the
// next round after each round's barrier, before its stop decision: a
// round the decision ends never reads them, so a round costs one block
// barrier besides the decision's.  Frame mode: s_act marks the frames
// dirty at the round's top; only they flip and run their machines.
template <int kBf, bool kFrame, int kF, int kCl>
__device__ inline int bf_tail(const uint8_t* en, uint8_t* hard, uint8_t* unsat, int* s_cnt,
                              int* s_act, int* s_or, int& slot, const CodeArgs& a) {
  __shared__ int s_th[kF], s_flip[kF];
  const int z = a.z, n = a.n_var, per_frame = a.n_rows * z;
  // hard[f][v] from the interleaved en, a VN's kF frames a thread
  for (int v = threadIdx.x; v < n; v += kThreads) {
    const uint32_t w = load_lanes<kF>(en, v);
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      const int e = frame_byte(w, f);
      int h = e > 0 ? 9 : 0;   // bits 0 and 3
      if constexpr (kBf == kBf2b1c) h |= (e >= a.reliability || e <= -a.reliability) << 1;
      hard[f * n + v] = static_cast<uint8_t>(h);
    }
  }
  if (a.bf_max_iter == 0) {
    __syncthreads();
    return 0;
  }
  uint8_t* tmap = hard + tail_map_off(kF, a);
  int* s_vcol = reinterpret_cast<int*>(hard + tail_tab_off(kF, a));
  int* s_vptr = s_vcol + a.n_vote;
  int* s_vadj = s_vptr + a.n_vote + 1;
  for (int i = threadIdx.x; i <= a.n_vote; i += kThreads) {
    s_vptr[i] = __ldg(a.vote_ptr + i);
    if (i < a.n_vote) s_vcol[i] = __ldg(a.vote_col + i) * z;
  }
  for (int i = threadIdx.x; i < __ldg(a.vote_ptr + a.n_vote); i += kThreads)
    s_vadj[i] = __ldg(a.vote_row + i) * z | (z - __ldg(a.vote_shift + i)) << 16;
  if (threadIdx.x < kF) {
    s_cnt[threadIdx.x] = 0;
    s_flip[threadIdx.x] = 0;
  }
  const int P = kThreads / z, p0 = threadIdx.x / z, zz = threadIdx.x - p0 * z;
  __syncthreads();

  // the opening sweep: each frame's map, in unsat and tmap, and count
  {
    int cnt[kF] = {};
    for (int r = p0 < P ? p0 : a.n_rows; r < a.n_rows; r += P) {
      int acc[kF] = {};
      const int e1 = __ldg(a.row_ptr + r + 1);
      for (int e = __ldg(a.row_ptr + r); e < e1; ++e) {
        const int v = vn_index(a, e, zz);
#pragma unroll
        for (int f = 0; f < kF; ++f) acc[f] ^= hard[f * n + v];
      }
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const int i = f * per_frame + r * z + zz;
        unsat[i] = tmap[i] = static_cast<uint8_t>(acc[f] & 1);
        cnt[f] += acc[f] & 1;
      }
    }
    warp_flush<kF>(cnt, s_cnt);
  }
  __syncthreads();

  // thread f < kF: frame f's threshold machine, and its flag for the
  // stop decision (mine)
  int th = a.gamma, t = 1, l0 = 0, l1 = 0, mine = 0;
  auto machine = [&]() {
    if (threadIdx.x >= kF) return;
    const int f = threadIdx.x;
    mine = s_cnt[f] > 0;
    if constexpr (kFrame) s_act[f] = mine;
    if constexpr (kBf == kBfStatic) {
      s_th[f] = 1;   // max(each frame's largest vote, 1), below
    } else if (!kFrame || mine) {
      // group mode: a round runs only while the word is dirty, so every
      // frame updates; frame mode: the dirty frames do
      th = t ? th : th - a.delta;
      const bool max_th = t && l0 < a.l0_max;
      if (max_th) {
        th = a.gamma + a.alpha;
        ++l0;
      }
      const bool submax = t && !max_th && l1 < a.l1_max;
      if (submax) {
        th = a.gamma + a.alpha - a.delta;
        ++l1;
      }
      if (t && !max_th && !submax) th = a.gamma + a.alpha - 2 * a.delta;
      th = max(th, 1);
      s_th[f] = th;
    }
  };
  machine();

  // the map offset of adjacency entry j's check of bit zz
  auto check_at = [&](int j) {
    const int e = s_vadj[j];
    return (e & 0xffff) + wrap(zz + (e >> 16), z);
  };
  // each frame's votes of bit zz of a column (entries j0 .. j1), from the
  // map of the round's top
  auto votes_of = [&](int j0, int j1, int (&votes)[kF]) {
#pragma unroll
    for (int f = 0; f < kF; ++f) votes[f] = 0;
    for (int j = j0; j < j1; ++j) {
      const uint8_t* u = unsat + check_at(j);
#pragma unroll
      for (int f = 0; f < kF; ++f) votes[f] += u[f * per_frame];
    }
  };
  // that bit flipped in frame f: toggle its checks in tmap; the count's change
  auto toggle = [&](int f, int j0, int j1) {
    int d = 0;
    for (int j = j0; j < j1; ++j) {
      const int i = f * per_frame + check_at(j);
      const uint32_t bit = 1u << 8 * (i & 3);
      d += atomicXor(reinterpret_cast<uint32_t*>(tmap) + (i >> 2), bit) & bit ? -1 : 1;
    }
    return d;
  };
  const int k0 = p0 < P ? p0 : a.n_vote;
  int rounds = 0;
  for (int round = 0; round < a.bf_max_iter; ++round) {
    if (!decide<kFrame, kCl>(mine, s_or, slot)) break;
    if constexpr (kFrame) rounds += mine;
    else ++rounds;
    int on[kF], thr[kF], dcnt[kF] = {};
#pragma unroll
    for (int f = 0; f < kF; ++f) on[f] = !kFrame || s_act[f];
    if constexpr (kBf == kBfStatic) {
      // the threshold: min(max(each frame's largest vote, 1), cap)
      int mx[kF] = {};
      for (int k = k0; k < a.n_vote; k += P) {
        int votes[kF];
        votes_of(s_vptr[k], s_vptr[k + 1], votes);
#pragma unroll
        for (int f = 0; f < kF; ++f) mx[f] = on[f] ? max(mx[f], votes[f]) : mx[f];
      }
      warp_flush<kF, true>(mx, s_th);
      __syncthreads();
#pragma unroll
      for (int f = 0; f < kF; ++f) thr[f] = min(s_th[f], a.vote_cap);
      // flip every VN whose vote reaches it
      for (int k = k0; k < a.n_vote; k += P) {
        const int j0 = s_vptr[k], j1 = s_vptr[k + 1], col = s_vcol[k] + zz;
        int votes[kF];
        votes_of(j0, j1, votes);
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          if (on[f] && votes[f] >= thr[f]) {
            hard[f * n + col] ^= 1;
            dcnt[f] += toggle(f, j0, j1);
          }
        }
      }
      warp_flush<kF>(dcnt, s_cnt);
    } else {
#pragma unroll
      for (int f = 0; f < kF; ++f) thr[f] = s_th[f];
      // flip weight-gamma VNs with votes + alpha * (hard != hard_ch) >= Th
      int flipped = 0;
      for (int k = k0; k < a.n_vote; k += P) {
        const int j0 = s_vptr[k], j1 = s_vptr[k + 1], col = s_vcol[k] + zz;
        int votes[kF];
        votes_of(j0, j1, votes);
#pragma unroll
        for (int f = 0; f < kF; ++f) {
          const int v = f * n + col, hv = hard[v];
          if (on[f] && votes[f] + a.alpha * ((hv ^ hv >> 3) & 1) >= thr[f]) {
            int nv = hv ^ 1;
            if constexpr (kBf == kBf2b1c) {
              // below a threshold of gamma a reliable bit is demoted
              // instead of flipped
              if (thr[f] >= a.gamma) nv = hv ^ 3;
              else if (hv & 2) nv = hv ^ 2;
            }
            hard[v] = static_cast<uint8_t>(nv);
            flipped |= 1 << f;
            if ((nv ^ hv) & 1) dcnt[f] += toggle(f, j0, j1);
          }
        }
      }
      flipped = __reduce_or_sync(0xffffffffu, flipped);
      if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int f = 0; f < kF; ++f)
          if (flipped >> f & 1) s_flip[f] = 1;
      }
      warp_flush<kF>(dcnt, s_cnt);
    }
    __syncthreads();
    // the round's toggles into the map its successor's votes read (the
    // next stop decision's barrier orders them before those reads)
    const int words = kF * per_frame / 4;
    for (int w = threadIdx.x; w < words; w += kThreads)
      reinterpret_cast<uint32_t*>(unsat)[w] = reinterpret_cast<const uint32_t*>(tmap)[w];
    for (int i = 4 * words + threadIdx.x; i < kF * per_frame; i += kThreads) unsat[i] = tmap[i];
    if constexpr (kBf != kBfStatic) {
      if (threadIdx.x < kF) {
        if (!kFrame || mine) t = s_flip[threadIdx.x];
        s_flip[threadIdx.x] = 0;
      }
    }
    machine();
  }
  return rounds;
}

// The buffers are separate __restrict__ parameters: the measurement
// recorded in PERF.md section 6 found that to matter when the state lived
// in global memory.
template <int kOut, int kStyle, int kBf, bool kFrame, int kBits>
__global__ void __launch_bounds__(kThreads, 1)
decoder_kernel(const int8_t* __restrict__ llr, int8_t* __restrict__ out_g,
               int32_t* __restrict__ err_out, int32_t* __restrict__ iters_out,
               int32_t* __restrict__ bf_out, const int8_t* __restrict__ ref, int ref_stride,
               unsigned long long* __restrict__ phases, CodeArgs a, ChanArgs c) {
  constexpr int kF = kFrames<kBits>;
  constexpr int kCl = kCluster<kBits>;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint32_t s_lut[4];            // the iteration's FAID rows, a byte an entry
  __shared__ int s_cnt[kF], s_lme[kF];
  __shared__ int s_err[kF];
  __shared__ int s_act[kF], s_dirty;       // frame mode
  __shared__ int s_or[3];                  // group mode: cluster_or's slots
  __shared__ unsigned long long s_clk[3];  // the phase clocks' lap start, prologue, MP

  // The phase clocks (kernels B and F alone): thread 0 takes its laps, at
  // the start, after the ingest and after MP, in every launch and keeps
  // them in shared memory, not in registers across MP; only the adds to
  // `phases` wait for a buffer (gating the laps on it too cost F's
  // static-BF instance more, the measurement recorded in PERF.md section
  // 6).  The tail adds 0 where none ran.
  constexpr bool kClocks = kOut == kStats || kOut == kSim;
  auto lap = [&](int k) {
    const unsigned long long now = clock64();
    s_clk[k] = now - s_clk[0];
    s_clk[0] = now;
  };
  if (kClocks && threadIdx.x == 0) s_clk[0] = clock64();

  const int n = a.n_var;
  const size_t frame0 = static_cast<size_t>(blockIdx.x) * kF;
  uint8_t* en = smem;                                               // [n] in lanes
  uint32_t* msg = reinterpret_cast<uint32_t*>(smem + en_bytes(kF, n));
  uint8_t* unsat = smem + en_bytes(kF, n) + static_cast<size_t>(a.msg_words) * 4;
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
  // a zero message is stored as 8 at 4 bits (kBias - m)
  const uint32_t zero = kBits == 4 ? 0x88888888u : 0u;
  for (int i = threadIdx.x; i < a.msg_words; i += kThreads) msg[i] = zero;
  if (kFrame && threadIdx.x < kF) s_act[threadIdx.x] = 1;
  __syncthreads();
  if (kClocks && threadIdx.x == 0) lap(1);

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
      else if constexpr (kFrame) dirty = frame_flags<kF>(en, s_act, &s_dirty, a);
      else dirty = cluster_or<kCl>(any_unsat<kF>(en, a, s_or + slot), s_or, slot);
      if (!dirty) {
        alive = false;
        break;
      }
    }
    if constexpr (kIsFaid<kStyle>) {
      if (threadIdx.x < 8) {
        uint8_t* rows = reinterpret_cast<uint8_t*>(s_lut);
        rows[threadIdx.x] = static_cast<uint8_t>(a.lut[it * 8 + threadIdx.x]);
        if constexpr (kSwapsLut<kStyle>)
          rows[8 + threadIdx.x] = static_cast<uint8_t>(a.lut_ef[it * 8 + threadIdx.x]);
      }
    }
    if constexpr (kKeepsMap<kStyle>) {
      if (threadIdx.x < kF)
        s_lme[threadIdx.x] = a.stop_early && s_cnt[threadIdx.x] < a.floor_err_count;
    }
    __syncthreads();
    const bool in_floor = a.max_iter - 1 - it <= a.floor_iter_thresh;
    IterLanes lanes{};
    if constexpr (kIsFaid<kStyle>) {
      lanes.lut[0] = s_lut[0];
      lanes.lut[1] = s_lut[1];
      if constexpr (kSwapsLut<kStyle>) {
        lanes.lut_ef[0] = s_lut[2];
        lanes.lut_ef[1] = s_lut[3];
      }
    }
    lanes.act = ~0u;
#pragma unroll
    for (int f = 0; f < kF; ++f) {
      if (kKeepsMap<kStyle> && in_floor && s_lme[f]) lanes.floor |= 0xffu << 8 * f;
      if (kFrame && !s_act[f]) lanes.act &= ~(0xffu << 8 * f);
    }
    lanes.bt = a.sign_backtrack ? 0x7f7f7f7fu : 0x80808080u;
    for (int r = 0; r < a.n_rows; ++r) {
      row_update<kStyle, kFrame, kBits, kF>(en, msg, unsat, lanes, r, a);
      __syncthreads();
    }
    if constexpr (kFrame) iters += threadIdx.x < kF && s_act[threadIdx.x];
    else ++iters;
  }
  if (kClocks && threadIdx.x == 0) lap(2);

  // ---- BF tail, skipped when MP stopped clean (bf_tail).  Its bits live
  // in the message region, free after MP.
  uint8_t* hard = reinterpret_cast<uint8_t*>(msg);   // [kF][n]
  int rounds = 0;
  if constexpr (kBf != kBfNone) {
    if (alive) rounds = bf_tail<kBf, kFrame, kF, kCl>(en, hard, unsat, s_cnt, s_act, s_or, slot, a);
  }
  if (kClocks && threadIdx.x == 0 && phases != nullptr) {
    const unsigned long long tail = kBf != kBfNone && alive ? clock64() - s_clk[0] : 0;
    atomicAdd(phases, s_clk[1]);
    atomicAdd(phases + 1, s_clk[2]);
    if (tail) atomicAdd(phases + 2, tail);
  }

  // the decisions: the BF tail's bits where it ran, else en > 0; a thread
  // takes a VN's kF frames
  const bool use_hard = kBf != kBfNone && alive;
  if constexpr (kOut == kHard || kOut == kEn) {
    int8_t* out = out_g + frame0 * n;
    for (int v = threadIdx.x; v < n; v += kThreads) {
      const uint32_t w = load_lanes<kF>(en, v);
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const int e = frame_byte(w, f);
        out[f * n + v] = static_cast<int8_t>(
            kOut == kEn ? e : (use_hard ? hard[f * n + v] & 1 : e > 0));
      }
    }
  } else {
    // ---- per-frame info-bit errors against the reference word (the
    // all-zero word without one)
    if (threadIdx.x < kF) s_err[threadIdx.x] = 0;
    __syncthreads();
    int cnt[kF] = {};
    for (int v = threadIdx.x; v < a.n_info; v += kThreads) {
      const uint32_t w = load_lanes<kF>(en, v);
#pragma unroll
      for (int f = 0; f < kF; ++f) {
        const int bit = use_hard ? hard[f * n + v] & 1 : frame_byte(w, f) > 0;
        cnt[f] += ref ? bit ^ (ref[(frame0 + f) * static_cast<size_t>(ref_stride) + v] != 0)
                      : bit;
      }
    }
    warp_flush<kF>(cnt, s_err);
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
  // the tail's walk takes a bit a thread (z <= kThreads), its packed
  // tables a 16-bit map offset, and its state the message region
  if (kBf != kBfNone && (a.z > kThreads || a.n_rows * a.z > 0x10000 ||
                         tail_bytes(kF, a) > static_cast<size_t>(a.msg_words) * 4))
    return static_cast<int>(cudaErrorInvalidValue);
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
                          b.ref_stride, b.phases, a, c);
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
