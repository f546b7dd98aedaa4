// K8's backward (fused_reversible_bwd.cu), its kernel's instances for 4 and
// 5 channels: a source of their own, so that nvcc builds them beside the
// others.

#define K8_BWD_WIDE
#include "fused_reversible_bwd.cu"
