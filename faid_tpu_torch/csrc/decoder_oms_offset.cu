// Kernels B, D and E of the simple-offset OMS style (OMS offset mode 0):
// every BF kind, both message widths and both stop modes
// (style_kernels.cuh).
#include "style_kernels.cuh"

FAID_STYLE_KERNELS(faid::kOmsOff)
