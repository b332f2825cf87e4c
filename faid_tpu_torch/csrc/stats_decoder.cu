// Kernel B: the stats decoder, faid_tpu/ops/pallas_decoder.py
// `make_stats_decoder` (`_make_kernel(fuse_bf, fuse_stats=True,
// fake_ref)`), one instance of decoder.cuh's template per (style, BF
// kind) that DecoderConfig.for_method produces and per stop mode.
#include "decoder.cuh"

// llr [B, n_var] int8 -> err_bits, mp_iters, bf_rounds [B] int32, the
// errors counted against ref [B, ref_stride] int8 (its first n_info
// bytes a row), or against the all-zero word when ref is null.  en, msg
// and hard are scratch of [B, n_var], [B, n_entries, z] and [B, n_var]
// int8; hard2 too for 2B1C, else null.  frame: 1 for frame stop mode.
extern "C" int faid_stats_decoder(int style, int bf, int frame, const void* llr, void* en,
                                  void* msg, void* hard, void* hard2, void* err_bits,
                                  void* mp_iters, void* bf_rounds, const void* ref,
                                  int ref_stride, const faid::CodeArgs* args, int batch,
                                  void* stream) {
  const faid::Buffers buffers{
      static_cast<const int8_t*>(llr), static_cast<int8_t*>(en),
      static_cast<int8_t*>(msg),       static_cast<int8_t*>(hard),
      static_cast<int8_t*>(hard2),     static_cast<int32_t*>(err_bits),
      static_cast<int32_t*>(mp_iters), static_cast<int32_t*>(bf_rounds),
      static_cast<const int8_t*>(ref), ref_stride};
  const faid::ChanArgs chan{};
  switch ((style * 4 + bf) * 2 + frame) {
    FAID_INSTANCE(faid::kStats, faid::kNms, faid::kBfNone)
    FAID_INSTANCE(faid::kStats, faid::kOmsSel, faid::kBfNone)
    FAID_INSTANCE(faid::kStats, faid::kFaid, faid::kBfDtbf)
    FAID_INSTANCE(faid::kStats, faid::kOmsSel, faid::kBfStatic)
    FAID_INSTANCE(faid::kStats, faid::kOmsSel, faid::kBfDtbf)
    FAID_INSTANCE(faid::kStats, faid::kFaidEf1, faid::kBf2b1c)
    default:
      return static_cast<int>(cudaErrorNotSupported);
  }
}
