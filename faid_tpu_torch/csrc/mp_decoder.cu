// Kernel E: the MP-only decoder, faid_tpu/ops/pallas_decoder.py
// `make_mp_decoder` (`_make_kernel()`): decoder.cuh's template for every
// style without a BF tail, message width and stop mode, instantiated in
// the per-style sources (decoder_<style>.cu).
#include "decoder_entry.cuh"

// llr [B, n_var] int8 -> en [B, n_var] int8 (the final LLRs), mp_iters
// [B] int32.  frame: 1 for frame stop mode; bits: the message width, 4
// or 8.  info: see faid::launch (null to launch).
extern "C" int faid_mp_decoder(int style, int frame, int bits, const void* llr, void* en,
                               void* mp_iters, const faid::CodeArgs* args, int batch,
                               void* stream, int* info) {
  const faid::Buffers buffers{static_cast<const int8_t*>(llr), static_cast<int8_t*>(en),
                              nullptr, static_cast<int32_t*>(mp_iters), nullptr, nullptr, 0};
  return faid::launch_decoder(faid::kEn, style, faid::kBfNone, frame, bits, buffers, *args,
                              batch, stream, info);
}
