// Kernels B, D and E of FAID with EF 0: every BF kind, both message widths
// and both stop modes (style_kernels.cuh).
#include "style_kernels.cuh"

FAID_STYLE_KERNELS(faid::kFaid)
