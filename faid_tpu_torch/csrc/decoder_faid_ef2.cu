// Kernels B, D and E of FAID with EF 2 (the swap to the error-floor LUT row
// and the one-shot erasure of flip-voted weight-3 VNs): every BF kind, both
// message widths and both stop modes (style_kernels.cuh).
#include "style_kernels.cuh"

FAID_STYLE_KERNELS(faid::kFaidEf2)
