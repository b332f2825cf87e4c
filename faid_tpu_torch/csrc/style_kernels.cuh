// The definition of launch_style (declared in decoder_entry.cuh): kernels
// B, D and E of one style.  Each decoder_<style>.cu includes this header
// and instantiates it for its style (FAID_STYLE_KERNELS).  Nothing here
// may name another style's launch_style: nvcc compiles every kernel that
// a translation unit instantiates, called or not, so the entry points'
// dispatch over all six styles (decoder_entry.cuh) stays out of these
// units, and no instance is compiled twice.
#pragma once

#include "decoder.cuh"

namespace faid {

// B for every BF kind, D for the kinds with a tail, E for none: 8 (out,
// BF kind) pairs, each in both widths and stop modes.
template <int kStyle>
int launch_style(int out, int bf, int frame, int bits, const Buffers& b, const CodeArgs& a,
                 int batch, void* stream, int* info) {
  const ChanArgs c{};
  switch (pair_key(out, bf)) {
    case pair_key(kStats, kBfNone):
      return launch_modes<kStats, kStyle, kBfNone>(frame, bits, b, a, c, batch, stream, info);
    case pair_key(kStats, kBfStatic):
      return launch_modes<kStats, kStyle, kBfStatic>(frame, bits, b, a, c, batch, stream, info);
    case pair_key(kStats, kBfDtbf):
      return launch_modes<kStats, kStyle, kBfDtbf>(frame, bits, b, a, c, batch, stream, info);
    case pair_key(kStats, kBf2b1c):
      return launch_modes<kStats, kStyle, kBf2b1c>(frame, bits, b, a, c, batch, stream, info);
    case pair_key(kHard, kBfStatic):
      return launch_modes<kHard, kStyle, kBfStatic>(frame, bits, b, a, c, batch, stream, info);
    case pair_key(kHard, kBfDtbf):
      return launch_modes<kHard, kStyle, kBfDtbf>(frame, bits, b, a, c, batch, stream, info);
    case pair_key(kHard, kBf2b1c):
      return launch_modes<kHard, kStyle, kBf2b1c>(frame, bits, b, a, c, batch, stream, info);
    case pair_key(kEn, kBfNone):
      return launch_modes<kEn, kStyle, kBfNone>(frame, bits, b, a, c, batch, stream, info);
    default:
      return static_cast<int>(cudaErrorNotSupported);
  }
}

}  // namespace faid

// The explicit instantiation of one style's kernels B, D and E.
#define FAID_STYLE_KERNELS(STYLE)                                                             \
  template int faid::launch_style<STYLE>(int, int, int, int, const faid::Buffers&,            \
                                         const faid::CodeArgs&, int, void*, int*);
