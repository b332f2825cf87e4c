// Kernel D: the full decoder, faid_tpu/ops/pallas_decoder.py
// `make_full_decoder` (`_make_kernel(fuse_bf=True)`): decoder.cuh's
// template for every (style, BF kind) pair with a BF tail, message width
// and stop mode, instantiated in the per-style sources
// (decoder_<style>.cu).
#include "decoder_entry.cuh"

// llr [B, n_var] int8 -> hard [B, n_var] int8 0/1, mp_iters, bf_rounds
// [B] int32.  frame: 1 for frame stop mode; bits: the message width, 4
// or 8.  info: see faid::launch (null to launch).
extern "C" int faid_full_decoder(int style, int bf, int frame, int bits, const void* llr,
                                 void* hard, void* mp_iters, void* bf_rounds,
                                 const faid::CodeArgs* args, int batch, void* stream,
                                 int* info) {
  const faid::Buffers buffers{static_cast<const int8_t*>(llr), static_cast<int8_t*>(hard),
                              nullptr, static_cast<int32_t*>(mp_iters),
                              static_cast<int32_t*>(bf_rounds), nullptr, 0};
  return faid::launch_decoder(faid::kHard, style, bf, frame, bits, buffers, *args, batch,
                              stream, info);
}
