// Kernel E: the MP-only decoder, faid_tpu/ops/pallas_decoder.py
// `make_mp_decoder` (`_make_kernel()`), one instance of decoder.cuh's
// template per method without a BF tail (NMS, OMS) and per stop mode.
#include "decoder.cuh"

// llr [B, n_var] int8 -> en [B, n_var] int8 (the final LLRs), mp_iters
// [B] int32.  msg is scratch of [B, n_entries, z] int8.  frame: 1 for
// frame stop mode.
extern "C" int faid_mp_decoder(int style, int frame, const void* llr, void* en, void* msg,
                               void* mp_iters, const faid::CodeArgs* args, int batch,
                               void* stream) {
  const faid::Buffers buffers{
      static_cast<const int8_t*>(llr), static_cast<int8_t*>(en),
      static_cast<int8_t*>(msg),       nullptr,
      nullptr,                         nullptr,
      static_cast<int32_t*>(mp_iters), nullptr,
      nullptr,                         0};
  const faid::ChanArgs chan{};
  switch ((style * 4 + faid::kBfNone) * 2 + frame) {
    FAID_INSTANCE(faid::kEn, faid::kNms, faid::kBfNone)
    FAID_INSTANCE(faid::kEn, faid::kOmsSel, faid::kBfNone)
    default:
      return static_cast<int>(cudaErrorNotSupported);
  }
}
