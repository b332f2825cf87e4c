// Kernels B, D and E of the NMS style (raw magnitudes, (min * factor) >> 5):
// every BF kind, both message widths and both stop modes
// (style_kernels.cuh).
#include "style_kernels.cuh"

FAID_STYLE_KERNELS(faid::kNms)
