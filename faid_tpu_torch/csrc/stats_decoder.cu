// Kernels B and D: the decoder for FAID (EF 0) + DTBF in group stop mode.
//
// Kernel B replaces faid_tpu/ops/pallas_decoder.py `make_stats_decoder`,
// i.e. `_make_kernel(fuse_bf=True, fuse_stats=True, fake_ref=True)`: LLR
// ingest, up to max_iter layered FAID iterations each opened by the
// early-stop syndrome sweep (`syndrome_sweep`, `row_update`), the DTBF
// tail (`bf_tail`), and the per-frame count of info-bit errors against
// the all-zero word.  Outputs err_bits, mp_iters and bf_rounds, [B] int32.
//
// Kernel D replaces `make_full_decoder`, i.e. `_make_kernel(fuse_bf=True)`:
// the same body, one template over `kEmitHard`, that writes the word's
// final hard decisions instead of counting errors: the DTBF tail's bits,
// or en > 0 where MP stopped clean.  Outputs hard [B, n_var] int8 (0/1),
// mp_iters and bf_rounds [B] int32.  The JAX kernel's [C, B, Z] becomes
// build_decoder's [B, n_var] layout.
//
// What bounds it on the H100: bytes.  An MP iteration touches every edge
// twice: it reads en and the message (2 bytes) and writes both back (2
// bytes), 70,400 edges per frame, plus the syndrome sweep's 70,400 hard
// reads.  At batch 2048 one iteration moves ~0.7 GB.  The decoder state of
// a 32-frame word (2.25 MB of messages, 0.56 MB of en) does not fit in one
// SM's 227 KB of shared memory, so it lives in global memory and is served
// from L2 (50 MB) and HBM.
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
//    wrapper; the BF tail's unsatisfied-check map of the word in shared
//    memory (32 x rows x Z bytes, 96 KB for 50G-PON);
//  * code tables as runtime arguments (row pointers, entry columns and
//    shifts, the flip-eligible columns' adjacency, the LUT rows), so the
//    same kernel also runs a toy code; kMaxDeg bounds the per-thread
//    register array of one row's contributions and the wrapper checks it.
// All arithmetic is int32 with explicit clips (the reference's saturating
// int8); there is no floating point in the kernel.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 32;      // frames per stop word == frames per block
constexpr int kThreads = 1024;
constexpr int kMaxDeg = 24;     // 50G-PON rows have degree 22-23
constexpr int kSatVar = 31;
constexpr int kSatMsg = 7;

struct CodeArgs {
  const int32_t* row_ptr;     // [n_rows + 1] first entry of each block row
  const int32_t* ent_col;     // [n_entries] block column of each entry
  const int32_t* ent_shift;   // [n_entries] circulant shift of each entry
  const int32_t* elig_col;    // [n_elig] block columns of weight gamma
  const int32_t* elig_row;    // [n_elig * gamma] their block rows
  const int32_t* elig_shift;  // [n_elig * gamma] and shifts
  const int32_t* lut;         // [max_iter * 8] FAID magnitude rows
  int n_var, n_info, z, n_rows, n_entries, punct_start, max_iter, n_elig;
  int gamma, bf_max_iter, delta, l0_max, l1_max, alpha, offset, sign_backtrack;
};

__device__ __forceinline__ int wrap(int i, int z) { return i >= z ? i - z : i; }

// Any unsatisfied check in the word, computed from en > 0 (MP) with an
// early exit per thread once one is found.
__device__ bool word_dirty(const int8_t* en, const CodeArgs& a) {
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

// Block row r of one layered FAID iteration for every frame of the word.
__device__ void row_update(int8_t* en, int8_t* msg, const int* s_lut, int r,
                           const CodeArgs& a) {
  const int z = a.z;
  const int e0 = a.row_ptr[r], deg = a.row_ptr[r + 1] - e0;
  const int odd = deg & 1;
  for (int i = threadIdx.x; i < kGroup * z; i += blockDim.x) {
    const int zz = i % z, f = i / z;
    int8_t* enf = en + static_cast<size_t>(f) * a.n_var;
    int8_t* msgf = msg + static_cast<size_t>(f) * a.n_entries * z;
    int vc[kMaxDeg];
    uint32_t negs = 0;
    int parity = 0, min1 = kSatVar, min2 = kSatVar;
    // pass 1: contributions, signs with backtrack, LUT magnitudes, min1/min2
#pragma unroll
    for (int e = 0; e < kMaxDeg; ++e) {
      if (e < deg) {
        const int vn = enf[a.ent_col[e0 + e] * z + wrap(zz + a.ent_shift[e0 + e], z)];
        const int m = msgf[(e0 + e) * z + zz];
        const int v = min(max(max(vn - m, -128), -kSatVar), kSatVar);
        vc[e] = v;
        const int neg = (a.sign_backtrack && v == 0 ? vn : v) < 0;
        negs |= static_cast<uint32_t>(neg) << e;
        parity ^= neg;
        const int mag = s_lut[min(abs(v), 7)];
        min2 = min(min2, max(min1, mag));
        min1 = min(mag, min1);
      }
    }
    const int cste1 = min(min2 - a.offset, kSatMsg);
    const int cste2 = min(min1 - a.offset, kSatMsg);
    // pass 2: new messages and en
#pragma unroll
    for (int e = 0; e < kMaxDeg; ++e) {
      if (e < deg) {
        const int v = vc[e];
        const int vres = s_lut[min(abs(v), 7)] == min1 ? cste1 : cste2;
        const int neg = parity ^ static_cast<int>((negs >> e) & 1u) ^ odd;
        const int nm = neg ? -vres : vres;
        msgf[(e0 + e) * z + zz] = static_cast<int8_t>(nm);
        enf[a.ent_col[e0 + e] * z + wrap(zz + a.ent_shift[e0 + e], z)] =
            static_cast<int8_t>(min(max(v + nm, -kSatVar), kSatVar));
      }
    }
  }
}

template <bool kEmitHard>
__global__ void __launch_bounds__(kThreads, 1)
decoder_kernel(const int8_t* __restrict__ llr, int8_t* __restrict__ en_g,
                     int8_t* __restrict__ msg_g, int8_t* __restrict__ hard_g,
                     int32_t* __restrict__ err_out, int32_t* __restrict__ iters_out,
                     int32_t* __restrict__ bf_out, CodeArgs a) {
  extern __shared__ uint8_t unsat[];   // [kGroup][n_rows][z], BF tail only
  __shared__ int s_lut[8];
  __shared__ int s_th[kGroup], s_l0[kGroup], s_l1[kGroup], s_t[kGroup];
  __shared__ int s_flip[kGroup], s_err[kGroup];

  const int z = a.z, n = a.n_var;
  const size_t frame0 = static_cast<size_t>(blockIdx.x) * kGroup;
  const int8_t* in = llr + frame0 * n;
  int8_t* en = en_g + frame0 * n;
  int8_t* hard = hard_g + frame0 * n;
  int8_t* msg = msg_g + frame0 * a.n_entries * z;

  // ---- ingest: en = LLR with the punctured tail zeroed; messages = 0
  for (int i = threadIdx.x; i < kGroup * n; i += blockDim.x)
    en[i] = i % n >= a.punct_start ? 0 : in[i];
  // The word's message block starts at a multiple of 32 bytes and spans a
  // multiple of 32 bytes, so it is cleared in 16-byte stores.
  uint4* msg16 = reinterpret_cast<uint4*>(msg);
  for (int i = threadIdx.x; i < kGroup * a.n_entries * z / 16; i += blockDim.x)
    msg16[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // ---- layered MP iterations; the word stops when all 32 frames are clean
  int iters = 0;
  bool alive = true;
  for (int it = 0; it < a.max_iter; ++it) {
    if (!word_dirty(en, a)) {
      alive = false;
      break;
    }
    if (threadIdx.x < 8) s_lut[threadIdx.x] = a.lut[it * 8 + threadIdx.x];
    __syncthreads();
    for (int r = 0; r < a.n_rows; ++r) {
      row_update(en, msg, s_lut, r, a);
      __syncthreads();
    }
    ++iters;
  }

  // ---- DTBF tail, skipped when MP stopped clean
  int rounds = 0;
  if (alive) {
    for (int i = threadIdx.x; i < kGroup * n; i += blockDim.x) hard[i] = en[i] > 0;
    if (threadIdx.x < kGroup) {
      s_th[threadIdx.x] = a.gamma;
      s_l0[threadIdx.x] = 0;
      s_l1[threadIdx.x] = 0;
      s_t[threadIdx.x] = 1;
    }
    __syncthreads();
    const int n_checks = kGroup * a.n_rows * z;
    for (int round = 0; round < a.bf_max_iter; ++round) {
      int found = 0;
      for (int i = threadIdx.x; i < n_checks; i += blockDim.x) {
        const int zz = i % z, rest = i / z;
        const int r = rest % a.n_rows, f = rest / a.n_rows;
        const int8_t* hf = hard + static_cast<size_t>(f) * n;
        int acc = 0;
        for (int e = a.row_ptr[r]; e < a.row_ptr[r + 1]; ++e)
          acc ^= hf[a.ent_col[e] * z + wrap(zz + a.ent_shift[e], z)];
        unsat[i] = static_cast<uint8_t>(acc);
        found |= acc;
      }
      if (!__syncthreads_or(found)) break;
      ++rounds;
      // threshold machine; the word is dirty, so every frame updates
      if (threadIdx.x < kGroup) {
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
        s_flip[f] = 0;
      }
      __syncthreads();
      // flip weight-gamma VNs with votes + alpha * (hard != hard_ch) >= Th
      const int n_items = kGroup * a.n_elig * z;
      for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
        const int zz = i % z, rest = i / z;
        const int k = rest % a.n_elig, f = rest / a.n_elig;
        const uint8_t* uf = unsat + f * a.n_rows * z;
        int votes = 0;
        for (int j = k * a.gamma; j < (k + 1) * a.gamma; ++j)
          votes += uf[a.elig_row[j] * z + wrap(zz - a.elig_shift[j] + z, z)];
        const size_t v = static_cast<size_t>(f) * n + a.elig_col[k] * z + zz;
        const int h = hard[v];
        const int h_ch = en[v] > 0;   // hard_ch: the post-MP decision
        if (votes + a.alpha * (h ^ h_ch) >= s_th[f]) {
          hard[v] = static_cast<int8_t>(h ^ 1);
          atomicOr(&s_flip[f], 1);
        }
      }
      __syncthreads();
      if (threadIdx.x < kGroup) s_t[threadIdx.x] = s_flip[threadIdx.x];
      __syncthreads();
    }
  }

  if constexpr (kEmitHard) {
    // ---- the word's final hard decisions; `hard` is the output buffer
    if (!alive)
      for (int i = threadIdx.x; i < kGroup * n; i += blockDim.x) hard[i] = en[i] > 0;
  } else {
    // ---- per-frame info-bit errors against the all-zero word
    if (threadIdx.x < kGroup) s_err[threadIdx.x] = 0;
    __syncthreads();
    for (int f = 0; f < kGroup; ++f) {
      const int8_t* src = (alive ? hard : en) + static_cast<size_t>(f) * n;
      int cnt = 0;
      for (int v = threadIdx.x; v < a.n_info; v += blockDim.x) cnt += src[v] > 0;
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(&s_err[f], cnt);
    }
    __syncthreads();
    if (threadIdx.x < kGroup) err_out[frame0 + threadIdx.x] = s_err[threadIdx.x];
  }
  if (threadIdx.x < kGroup) {
    iters_out[frame0 + threadIdx.x] = iters;
    bf_out[frame0 + threadIdx.x] = rounds;
  }
}

template <bool kEmitHard>
int launch(const void* llr, void* en, void* msg, void* hard, void* err_bits,
           void* mp_iters, void* bf_rounds, const CodeArgs& a, int batch, void* stream) {
  const int smem = kGroup * a.n_rows * a.z;
  cudaError_t st = cudaFuncSetAttribute(
      decoder_kernel<kEmitHard>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (st != cudaSuccess) return static_cast<int>(st);
  decoder_kernel<kEmitHard><<<batch / kGroup, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(llr), static_cast<int8_t*>(en),
      static_cast<int8_t*>(msg), static_cast<int8_t*>(hard),
      static_cast<int32_t*>(err_bits), static_cast<int32_t*>(mp_iters),
      static_cast<int32_t*>(bf_rounds), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The code tables and decoder parameters, in the order both entry
// points take them after their buffers.
#define FAID_CODE_PARAMS                                                              \
  const void *row_ptr, const void *ent_col, const void *ent_shift,                    \
      const void *elig_col, const void *elig_row, const void *elig_shift,             \
      const void *lut, int batch, int n_var, int n_info, int z, int n_rows,           \
      int n_entries, int punct_start, int max_iter, int n_elig, int gamma,            \
      int bf_max_iter, int delta, int l0_max, int l1_max, int alpha, int offset,      \
      int sign_backtrack, void *stream
#define FAID_CODE_ARGS                                                                \
  CodeArgs {                                                                          \
    static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(ent_col),       \
        static_cast<const int32_t*>(ent_shift), static_cast<const int32_t*>(elig_col), \
        static_cast<const int32_t*>(elig_row),                                        \
        static_cast<const int32_t*>(elig_shift), static_cast<const int32_t*>(lut),    \
        n_var, n_info, z, n_rows, n_entries, punct_start, max_iter, n_elig, gamma,    \
        bf_max_iter, delta, l0_max, l1_max, alpha, offset, sign_backtrack             \
  }

// Kernel B.  en, msg and hard are scratch of [B, n_var], [B, n_entries,
// z] and [B, n_var] int8.
extern "C" int faid_stats_decoder(const void* llr, void* en, void* msg, void* hard,
                                  void* err_bits, void* mp_iters, void* bf_rounds,
                                  FAID_CODE_PARAMS) {
  return launch<false>(llr, en, msg, hard, err_bits, mp_iters, bf_rounds,
                       FAID_CODE_ARGS, batch, stream);
}

// Kernel D.  en and msg are scratch as for kernel B; hard is the output.
extern "C" int faid_full_decoder(const void* llr, void* en, void* msg, void* hard,
                                 void* mp_iters, void* bf_rounds, FAID_CODE_PARAMS) {
  return launch<true>(llr, en, msg, hard, nullptr, mp_iters, bf_rounds, FAID_CODE_ARGS,
                      batch, stream);
}
