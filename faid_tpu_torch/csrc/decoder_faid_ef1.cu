// Kernels B, D and E of FAID with EF 1 (the per-check swap to the error-
// floor LUT row): every BF kind, both message widths and both stop modes
// (style_kernels.cuh).
#include "style_kernels.cuh"

FAID_STYLE_KERNELS(faid::kFaidEf1)
