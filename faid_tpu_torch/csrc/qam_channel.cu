// Kernel G: the 16/64/256-QAM quantile channel.
//
// Replaces faid_tpu/ops/pallas_channel.py `_qam_kernel` (the pallas_call of
// `_build_fused_channel_qam`) together with its wrapper's interleave and
// deinterleave.  The folded max-log demap makes a rail's mod/2 LLRs
// functions of one noise draw, so each I/Q rail of the interleaved
// codeword draws ONE Philox word (the channel's stream, philox.cuh: rail r
// takes word r of the frame, exactly as bit r would in kernel A) and
// mirrors it by the rail's sign bit; every level's LLR and map bit is then
// a step function of the mirrored word ixe on the threshold row of the
// rail's Gray magnitude index m: the exact joint law of the rail's LLRs.
//
// The function is tabulated per row, not walked (ops/qam_plan.py
// `cell_table`, made once per sigma).  Row m's sorted distinct thresholds
// U, with an INT_MAX sentinel, cut the words into cells
// c = 2 #{u in U : u < ixe} + [ixe in U], and each cell holds every level's
// int8 LLR (level 0's before its sign restore) and map bit.  The table is
// int32 [nmag][2^s][6]: entry i of a row is
//   (U[i], 0, cell 2i (2 words), cell 2i + 1 (2 words)),
// U padded with INT_MAX to 2^s entries, 2^s - 1 >= the longest |U|.  Per
// rail: s steps of a branch-free search of ixe in U (the sentinel keeps
// the result inside the row, so the padding never reads as an equal
// value), the equality test against U itself, one 8-byte read of the
// cell, then level 0's sign restore and the quantizer's asymmetric clip,
// in that order.  The walk over the plan's intervals that this replaces
// did 119-699 int32 operations a rail; the search does ~3 a step.
//
// Mapping: a persistent grid (the blocks the card holds at once, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor) loads the table into
// shared memory once per block, each row 8 bytes past a multiple of the
// last (a row is 24 * 2^s bytes, a multiple of the 128 bytes of the 32
// banks: without the skew the rails of one warp, on different rows, would
// meet on one bank at every search step), and strides over (frame, unit).  At depth
// D in 1..3 a thread's unit is the fewest whole Philox calls (4 rails, 2
// symbols, 4 rails a call as 4 bits a call in kernel A) whose interleaved
// bits fill whole interleaver columns: interleaved bit k is decoder
// position (k % D) * (n / D) + k / D, so the unit's bits are D contiguous
// runs of decoder order, which the thread reads (codeword) and writes
// (LLRs, map) as 16-, 8-, 4- or 2-byte words where the sizes and the
// pointers allow, and consecutive threads take consecutive runs.  Other
// depths, and the rails of a frame past its last whole unit, go per
// Philox call through the index map a byte at a time, with the r < rails
// guard.  A word's Philox counter comes from (frame0 + frame, rail / 4)
// alone, never from the launch geometry.
//
// What bounds it on the H100, as measured (chip_smoke.py, PERF.md section
// 6): its bound is the least work of its function on the timed inputs
// (chip_smoke.py `qam_least_ops`, 38-39 int32 operations a rail) at
// 16-QAM, and the bytes (3 a bit: the codeword read, the LLRs and the map
// written) at 64 and 256-QAM.  It runs at 48-65% of that bound timed back
// to back with CUDA events, 54-73% by its own device time (the events add
// the host's launch gaps), 10-57x faster than the walk.  At 256-QAM it
// moves its bytes at ~73% of the memory's rate; at 16-QAM what is left is
// integer issue: a quarter of one Philox call (~20 operations), the s
// dependent shared-memory loads of the search (5-6 at the speed points,
// up to 9 for 256-QAM at 6 bits with every threshold distinct), the cell
// read and a byte permute per output byte.  With the all-zero word every
// rail searches row 0; with codewords the rails of a warp spread over
// the rows, which the row skew keeps on distinct banks.
#include <cuda_runtime.h>

#include <cstdint>

#include "staircase.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kEntryBytes = 24;           // a table entry: 6 int32 words
constexpr int kRowSkew = 8;               // bytes between rows in shared memory
constexpr int kMaxSteps = 12;             // rows of up to 2^12 - 1 cell bounds (the
                                          // most 16-QAM's 2 rows fit in shared memory)
constexpr int kMaxSharedBytes = 232448;   // a block's shared memory on Hopper
constexpr int kStaticSharedBytes = 48 * 1024;

constexpr int gcd_c(int a, int b) { return b ? gcd_c(b, a % b) : a; }

struct Args {
  const int8_t* cw;
  int8_t* llr;
  int8_t* err;
  const int32_t* table;
  int nmag, table_row, steps;        // rows, a row's bytes in `table`, search steps
  int smem_bytes, row_bytes;         // the table in shared memory, its row stride
  int batch, n_var, seg, depth, rails;
  int units, group0, tail_groups;  // per frame: whole units, first tail call, tail calls
  int wide;                        // the runs' pointers and sizes allow wide words
  int clip_lo, clip_hi;
  uint2 key;
  uint32_t round_lo, round_hi, frame0;
};

// A thread's unit at compile-time depth D (1..3): kBits = lcm(2 mod, D)
// interleaved bits, kCalls Philox calls, one run of kRun decoder-order
// bytes in each of the D segments, moved kChunk bytes at a time.
template <int kLevels, int kDepth>
struct Unit {
  static constexpr int kMod = 2 * kLevels;
  static constexpr int kBits = 2 * kMod * kDepth / gcd_c(2 * kMod, kDepth);
  static constexpr int kCalls = kBits / (2 * kMod);
  static constexpr int kRun = kBits / kDepth;
  static constexpr int kWords = (kRun + 3) / 4;
  static constexpr int kChunk = kRun % 16 == 0 ? 16
                                : kRun % 8 == 0 ? 8
                                : kRun % 4 == 0 ? 4
                                : kRun % 2 == 0 ? 2 : 1;
};

// #{u in U : u < x} for kN rails at once: off[r], the byte offset of the
// rail's row in shared memory on entry, is that of entry #{u < x} on exit.
// Step 2^k (largest first) tests entry pos + 2^k - 1; `steps` is s.
template <int kStep, int kN>
__device__ __forceinline__ void search(const char* smem, unsigned (&off)[kN],
                                       const int (&x)[kN], int steps) {
  if constexpr (kStep >= 0) {
    if (kStep < steps) {
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        const int u =
            *reinterpret_cast<const int*>(smem + off[r] + ((1 << kStep) - 1) * kEntryBytes);
        off[r] += u < x[r] ? (1u << kStep) * kEntryBytes : 0u;
      }
    }
    search<kStep - 1, kN>(smem, off, x, steps);
  }
}

// The cell of each rail's mirrored word: llr[r] byte l is level l's LLR
// (level 0 restored and clipped), err[r] byte l its map bit.
template <int kN>
__device__ __forceinline__ void lookup(const char* smem, const Args& a, const int (&ixe)[kN],
                                       const int (&mask)[kN], unsigned (&off)[kN],
                                       uint32_t (&llr)[kN], uint32_t (&err)[kN]) {
  search<kMaxSteps - 1, kN>(smem, off, ixe, a.steps);
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    const int u = *reinterpret_cast<const int*>(smem + off[r]);
    const uint2 cell =
        *reinterpret_cast<const uint2*>(smem + off[r] + (u == ixe[r] ? 16 : 8));
    int q = static_cast<int8_t>(cell.x & 0xFFu);
    q = (q ^ mask[r]) - mask[r];                 // restore level 0's sign,
    q = min(max(q, a.clip_lo), a.clip_hi);       // then the asymmetric clip
    llr[r] = __byte_perm(cell.x, static_cast<uint32_t>(q), 0x3214);
    err[r] = cell.y;
  }
}

// The byte-permute selector that puts byte `from` of the second operand
// into byte `to` of the first.
__device__ __forceinline__ constexpr uint32_t insert_sel(int to, int from) {
  return (0x3210u & ~(0xFu << (4 * to))) | (static_cast<uint32_t>(4 + from) << (4 * to));
}

template <int kRun, int kChunk>
__device__ __forceinline__ void load_run(const int8_t* p, uint32_t (&w)[(kRun + 3) / 4],
                                         bool wide) {
#pragma unroll
  for (int i = 0; i < (kRun + 3) / 4; ++i) w[i] = 0;
  if (!wide) {
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * (i & 3));
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun / kChunk; ++i) {
    if constexpr (kChunk == 16) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
    } else if constexpr (kChunk == 8) {
      const uint2 v = reinterpret_cast<const uint2*>(p)[i];
      w[2 * i] = v.x, w[2 * i + 1] = v.y;
    } else if constexpr (kChunk == 4) {
      w[i] = reinterpret_cast<const uint32_t*>(p)[i];
    } else if constexpr (kChunk == 2) {
      w[i / 2] |= static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(p)[i])
                  << (16 * (i & 1));
    } else {
      w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[i])) << (8 * (i & 3));
    }
  }
}

template <int kRun, int kChunk>
__device__ __forceinline__ void store_run(int8_t* p, const uint32_t (&w)[(kRun + 3) / 4],
                                          bool wide) {
  if (!wide) {
#pragma unroll
    for (int i = 0; i < kRun; ++i) p[i] = static_cast<int8_t>(w[i / 4] >> (8 * (i & 3)));
    return;
  }
#pragma unroll
  for (int i = 0; i < kRun / kChunk; ++i) {
    if constexpr (kChunk == 16)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    else if constexpr (kChunk == 8)
      reinterpret_cast<uint2*>(p)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
    else if constexpr (kChunk == 4)
      reinterpret_cast<uint32_t*>(p)[i] = w[i];
    else if constexpr (kChunk == 2)
      reinterpret_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(w[i / 2] >> (16 * (i & 1)));
    else
      p[i] = static_cast<int8_t>(w[i / 4] >> (8 * (i & 3)));
  }
}

// Unit u of frame f (depth kDepth in 1..3).
template <int kLevels, int kDepth>
__device__ __forceinline__ void run_unit(const char* smem, const Args& a, int f, int u) {
  using U = Unit<kLevels, kDepth>;
  constexpr int kMod = U::kMod, kRun = U::kRun, kWords = U::kWords;
  const size_t base = static_cast<size_t>(f) * a.n_var + static_cast<size_t>(u) * kRun;
  uint32_t in[kDepth][kWords], lo[kDepth][kWords], eo[kDepth][kWords];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (a.cw) {
      load_run<kRun, U::kChunk>(a.cw + base + static_cast<size_t>(d) * a.seg, in[d], a.wide);
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) in[d][i] = 0;
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) lo[d][i] = eo[d][i] = 0;
  }
#pragma unroll
  for (int j = 0; j < U::kCalls; ++j) {
    const uint4 w = faid::channel_words4(u * U::kCalls + j, a.frame0 + f, a.round_lo,
                                         a.round_hi, a.key);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
    int ixe[4], mask[4];
    unsigned off[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = 4 * j + t;                       // the unit's rail
      int m = 0, bit0 = 0;
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        const int k = (r >> 1) * kMod + 2 * l + (r & 1);  // the unit's interleaved bit
        const int d = k % kDepth, i = k / kDepth;
        const int bit = ((in[d][i / 4] >> (8 * (i & 3))) & 0xFFu) != 0;
        if (l == 0) bit0 = bit;
        else m = 2 * m + bit;                        // the first magnitude bit is m's MSB
      }
      mask[t] = -bit0;
      ixe[t] = static_cast<int>(ws[t]) ^ mask[t];
      off[t] = static_cast<unsigned>(m * a.row_bytes);
    }
    uint32_t lw[4], ew[4];
    lookup<4>(smem, a, ixe, mask, off, lw, ew);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int r = 4 * j + t;
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        const int k = (r >> 1) * kMod + 2 * l + (r & 1);
        const int d = k % kDepth, i = k / kDepth;
        lo[d][i / 4] = __byte_perm(lo[d][i / 4], lw[t], insert_sel(i & 3, l));
        eo[d][i / 4] = __byte_perm(eo[d][i / 4], ew[t], insert_sel(i & 3, l));
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const size_t at = base + static_cast<size_t>(d) * a.seg;
    store_run<kRun, U::kChunk>(a.llr + at, lo[d], a.wide);
    store_run<kRun, U::kChunk>(a.err + at, eo[d], a.wide);
  }
}

// Philox call g of frame f (rails 4g .. 4g + 3) through the interleaver's
// index map, a byte at a time: any depth, and a partial call at a frame's
// end (r < rails).
template <int kLevels>
__device__ __forceinline__ void run_call(const char* smem, const Args& a, int f, int g) {
  constexpr int kMod = 2 * kLevels;
  const size_t row = static_cast<size_t>(f) * a.n_var;
  const uint4 w = faid::channel_words4(g, a.frame0 + f, a.round_lo, a.round_hi, a.key);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
  int ixe[4], mask[4], pos[4][kLevels];
  unsigned off[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int r = 4 * g + t;
    const bool live = r < a.rails;
    int m = 0, bit0 = 0;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      const int k = (r >> 1) * kMod + 2 * l + (r & 1);
      pos[t][l] = (k % a.depth) * a.seg + k / a.depth;
      const int bit = live && a.cw ? a.cw[row + pos[t][l]] != 0 : 0;
      if (l == 0) bit0 = bit;
      else m = 2 * m + bit;
    }
    mask[t] = -bit0;
    ixe[t] = static_cast<int>(ws[t]) ^ mask[t];
    off[t] = static_cast<unsigned>(m * a.row_bytes);
  }
  uint32_t lw[4], ew[4];
  lookup<4>(smem, a, ixe, mask, off, lw, ew);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (4 * g + t >= a.rails) break;
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      a.llr[row + pos[t][l]] = static_cast<int8_t>(lw[t] >> (8 * l));
      a.err[row + pos[t][l]] = static_cast<int8_t>(ew[t] >> (8 * l));
    }
  }
}

// Strides item i = f * per_frame + j over the grid without a division a
// step: (f, j) advance by the stride's quotient and remainder.
template <typename Fn>
__device__ __forceinline__ void for_items(int batch, int per_frame, Fn fn) {
  if (per_frame <= 0) return;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int sf = static_cast<int>(stride / per_frame), sj = static_cast<int>(stride % per_frame);
  int f = static_cast<int>(first / per_frame), j = static_cast<int>(first % per_frame);
  while (f < batch) {
    fn(f, j);
    f += sf;
    j += sj;
    if (j >= per_frame) j -= per_frame, ++f;
  }
}

// kLevels = mod_type / 2: 2, 3 or 4 (16, 64, 256-QAM); kDepth 1..3, or 0
// for any depth through the index map.
template <int kLevels, int kDepth>
__global__ void __launch_bounds__(kThreads) qam_channel_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  const int row_words = a.table_row / 8;
  for (int i = threadIdx.x; i < a.nmag * row_words; i += blockDim.x) {
    const int m = i / row_words;
    *reinterpret_cast<uint2*>(smem + m * a.row_bytes + 8 * (i - m * row_words)) =
        reinterpret_cast<const uint2*>(a.table)[i];
  }
  __syncthreads();
  if constexpr (kDepth > 0)
    for_items(a.batch, a.units,
              [&](int f, int u) { run_unit<kLevels, kDepth>(smem, a, f, u); });
  for_items(a.batch, a.tail_groups,
            [&](int f, int g) { run_call<kLevels>(smem, a, f, a.group0 + g); });
}

// The persistent grid: the blocks the card holds at once at this shared
// memory size (cached per device and size), or fewer where the work is less.
template <int kLevels, int kDepth>
cudaError_t launch(Args a, void* stream) {
  static int cached_dev = -1, cached_bytes = -1, cached_blocks = 0;
  const auto kernel = qam_channel_kernel<kLevels, kDepth>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != cached_dev || a.smem_bytes != cached_bytes) {
    if (a.smem_bytes > kStaticSharedBytes) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               a.smem_bytes);
      if (e != cudaSuccess) return e;
    }
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      a.smem_bytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached_dev = dev, cached_bytes = a.smem_bytes, cached_blocks = per_sm * sms;
  }
  const long long work = static_cast<long long>(a.batch) * (a.units > 0 ? a.units : a.tail_groups);
  const int blocks =
      static_cast<int>(work / kThreads + 1 < cached_blocks ? work / kThreads + 1 : cached_blocks);
  kernel<<<blocks, kThreads, a.smem_bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <int kLevels>
cudaError_t launch_depth(Args a, void* stream) {
  constexpr int kMod = 2 * kLevels;
  const int groups = (a.rails + 3) / 4;
  int chunk = 1, bits = 0, calls = 0;
  switch (a.depth) {
    case 1: chunk = Unit<kLevels, 1>::kChunk, bits = Unit<kLevels, 1>::kBits; break;
    case 2: chunk = Unit<kLevels, 2>::kChunk, bits = Unit<kLevels, 2>::kBits; break;
    case 3: chunk = Unit<kLevels, 3>::kChunk, bits = Unit<kLevels, 3>::kBits; break;
    default: break;
  }
  if (bits) {
    calls = bits / (2 * kMod);
    a.units = a.n_var / bits;
    const auto aligned = [chunk](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % chunk == 0;
    };
    a.wide = a.n_var % chunk == 0 && a.seg % chunk == 0 && aligned(a.cw) && aligned(a.llr) &&
             aligned(a.err);
  }
  a.group0 = a.units * calls;
  a.tail_groups = groups - a.group0;
  switch (a.depth) {
    case 1: return launch<kLevels, 1>(a, stream);
    case 2: return launch<kLevels, 2>(a, stream);
    case 3: return launch<kLevels, 3>(a, stream);
    default: return launch<kLevels, 0>(a, stream);
  }
}

}  // namespace

// Kernel G: the QAM LLRs and the ModCalErr map, [batch, n_var] int8 each, in
// decoder order.  `cells` is ops/qam_plan.py `cell_table`, int32
// [nmag][width][6], width = 2^s; (clip_lo, clip_hi) the quantizer's
// asymmetric clip, or the int32 range for the symmetric widths (none).
extern "C" int faid_qam_channel(const void* cw, void* llr, void* err, const void* cells,
                                int nmag, int width, int batch, int n_var, int mod_type,
                                int depth, int clip_lo, int clip_hi, unsigned long long seed,
                                unsigned long long round, unsigned int frame0,
                                void* stream) {
  const int levels = mod_type / 2;
  if ((mod_type != 4 && mod_type != 6 && mod_type != 8) || nmag != 1 << (levels - 1) ||
      width < 2 || width > 1 << kMaxSteps || (width & (width - 1)) || batch < 0 ||
      depth < 1 || n_var < 1 || n_var % mod_type || n_var % depth ||
      reinterpret_cast<uintptr_t>(cells) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem_bytes = static_cast<long long>(nmag) * (width * kEntryBytes + kRowSkew);
  if (smem_bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  Args a{};
  a.cw = static_cast<const int8_t*>(cw);
  a.llr = static_cast<int8_t*>(llr);
  a.err = static_cast<int8_t*>(err);
  a.table = static_cast<const int32_t*>(cells);
  a.nmag = nmag;
  a.table_row = width * kEntryBytes;
  a.smem_bytes = static_cast<int>(smem_bytes);
  a.row_bytes = a.table_row + kRowSkew;
  a.steps = __builtin_ctz(static_cast<unsigned>(width));
  a.batch = batch;
  a.n_var = n_var;
  a.seg = n_var / depth;
  a.depth = depth;
  a.rails = 2 * (n_var / mod_type);
  a.clip_lo = clip_lo;
  a.clip_hi = clip_hi;
  a.key = make_uint2(static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  a.round_lo = static_cast<uint32_t>(round);
  a.round_hi = static_cast<uint32_t>(round >> 32);
  a.frame0 = frame0;
  cudaError_t e = cudaErrorInvalidValue;
  switch (mod_type) {
    case 4: e = launch_depth<2>(a, stream); break;
    case 6: e = launch_depth<3>(a, stream); break;
    case 8: e = launch_depth<4>(a, stream); break;
    default: break;
  }
  return static_cast<int>(e);
}
