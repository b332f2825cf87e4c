// The entry points' dispatch of kernels B, D and E to the per-style
// sources (stats_decoder.cu, full_decoder.cu, mp_decoder.cu include it).
// A per-style source must not include it: with launch_style's definition
// in view (style_kernels.cuh), this switch over the six styles would make
// nvcc compile every style's kernels in that unit.
#pragma once

#include "decoder.cuh"

namespace faid {

// Kernels B (out kStats), D (kHard) and E (kEn) of style kStyle, every BF
// kind, width and stop mode: defined in style_kernels.cuh, instantiated
// once a style, each in its own source (decoder_<style>.cu), so that nvcc
// builds the styles in parallel.
template <int kStyle>
int launch_style(int out, int bf, int frame, int bits, const Buffers& b, const CodeArgs& a,
                 int batch, void* stream, int* info);

// An entry point's launch of kernel B, D or E: cudaErrorNotSupported for
// an id outside the template's.
inline int launch_decoder(int out, int style, int bf, int frame, int bits, const Buffers& b,
                          const CodeArgs& a, int batch, void* stream, int* info) {
  switch (style) {
    case kNms: return launch_style<kNms>(out, bf, frame, bits, b, a, batch, stream, info);
    case kOmsSel: return launch_style<kOmsSel>(out, bf, frame, bits, b, a, batch, stream, info);
    case kFaid: return launch_style<kFaid>(out, bf, frame, bits, b, a, batch, stream, info);
    case kFaidEf1: return launch_style<kFaidEf1>(out, bf, frame, bits, b, a, batch, stream, info);
    case kOmsOff: return launch_style<kOmsOff>(out, bf, frame, bits, b, a, batch, stream, info);
    case kFaidEf2: return launch_style<kFaidEf2>(out, bf, frame, bits, b, a, batch, stream, info);
    default: return static_cast<int>(cudaErrorNotSupported);
  }
}

}  // namespace faid
