// Kernels B, D and E of the selective-OMS style (OMS offset mode 1): every
// BF kind, both message widths and both stop modes (style_kernels.cuh).
#include "style_kernels.cuh"

FAID_STYLE_KERNELS(faid::kOmsSel)
