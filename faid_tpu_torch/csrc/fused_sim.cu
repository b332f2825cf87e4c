// Kernel F: one Monte-Carlo round in one kernel, faid_tpu/ops/
// pallas_decoder.py `build_fused_sim` (`_make_kernel(fuse_bf,
// fuse_stats=True, chan=(mod_type, quant_bits))`, body :169, prologue
// :581-626), one instance of decoder.cuh's template per (style, BF kind)
// that DecoderConfig.for_method produces, per message width and per stop
// mode.  The prologue is kernel A's draw and staircase (staircase.cuh)
// on kernel A's stream, so for the same (seed, round, frame0, cw) F's
// counters equal kernel A then kernel B's, frame by frame.
#include "decoder.cuh"

// One (style, BF kind) pair's case: its four instances.
#define FAID_SIM_PAIR(STYLE, BF)                                                            \
  case faid::pair_key(STYLE, BF):                                                           \
    return faid::launch_modes<faid::kSim, STYLE, BF>(frame, bits, buffers, *args, chan, batch, \
                                                     stream, info);

// Frames frame0 .. frame0 + B - 1 of stream round `round` through the
// quantile channel (cw [B, n_var] int8, or null for the all-zero word;
// params [2L+1] int32 thresholds) and the decoder -> err_bits, mp_iters,
// bf_rounds, mod_error_bits, mod_error_symbols, each [B] int32 (bf_rounds
// 0 without a BF tail).  frame: 1 for frame stop mode; bits: the message
// width, 4 or 8.  info: see faid::launch (null to launch).
extern "C" int faid_fused_sim(int style, int bf, int frame, int bits, const void* cw,
                              void* err_bits, void* mp_iters, void* bf_rounds, void* mod_bits,
                              void* mod_syms, const void* params, int mod_type, int L,
                              int clip_lo, int clip_hi, unsigned long long seed,
                              unsigned long long round, unsigned int frame0,
                              const faid::CodeArgs* args, int batch, void* stream, int* info) {
  const faid::Buffers buffers{nullptr,
                              nullptr,
                              static_cast<int32_t*>(err_bits),
                              static_cast<int32_t*>(mp_iters),
                              static_cast<int32_t*>(bf_rounds),
                              static_cast<const int8_t*>(cw),
                              args->n_var};
  const faid::ChanArgs chan{static_cast<const int32_t*>(params),
                            static_cast<int32_t*>(mod_bits),
                            static_cast<int32_t*>(mod_syms),
                            L,
                            clip_lo,
                            clip_hi,
                            mod_type,
                            static_cast<uint32_t>(seed),
                            static_cast<uint32_t>(seed >> 32),
                            static_cast<uint32_t>(round),
                            static_cast<uint32_t>(round >> 32),
                            frame0};
  switch (faid::pair_key(style, bf)) {
    FAID_SIM_PAIR(faid::kNms, faid::kBfNone)
    FAID_SIM_PAIR(faid::kOmsSel, faid::kBfNone)
    FAID_SIM_PAIR(faid::kFaid, faid::kBfDtbf)
    FAID_SIM_PAIR(faid::kOmsSel, faid::kBfStatic)
    FAID_SIM_PAIR(faid::kOmsSel, faid::kBfDtbf)
    FAID_SIM_PAIR(faid::kFaidEf1, faid::kBf2b1c)
    default:
      return static_cast<int>(cudaErrorNotSupported);
  }
}
