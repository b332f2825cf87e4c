// Kernel B: the stats decoder, faid_tpu/ops/pallas_decoder.py
// `make_stats_decoder` (`_make_kernel(fuse_bf, fuse_stats=True,
// fake_ref)`): decoder.cuh's template for every (style, BF kind) pair,
// message width and stop mode, instantiated in the per-style sources
// (decoder_<style>.cu).
#include "decoder_entry.cuh"

// llr [B, n_var] int8 -> err_bits, mp_iters, bf_rounds [B] int32, the
// errors counted against ref [B, ref_stride] int8 (its first n_info
// bytes a row), or against the all-zero word when ref is null.  frame:
// 1 for frame stop mode; bits: the message width, 4 or 8.  info: see
// faid::launch (null to launch).
extern "C" int faid_stats_decoder(int style, int bf, int frame, int bits, const void* llr,
                                  void* err_bits, void* mp_iters, void* bf_rounds,
                                  const void* ref, int ref_stride, const faid::CodeArgs* args,
                                  int batch, void* stream, int* info) {
  const faid::Buffers buffers{static_cast<const int8_t*>(llr), nullptr,
                              static_cast<int32_t*>(err_bits), static_cast<int32_t*>(mp_iters),
                              static_cast<int32_t*>(bf_rounds), static_cast<const int8_t*>(ref),
                              ref_stride};
  return faid::launch_decoder(faid::kStats, style, bf, frame, bits, buffers, *args, batch,
                              stream, info);
}
