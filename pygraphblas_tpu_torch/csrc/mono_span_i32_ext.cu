// One translation unit of mono.cuh: mono_span at int32 words, the codes the
// algebra added.

#define PGB_MONO_DEFS
#include "mono.cuh"

PGB_SPAN_INSTANCE(int32_t, true);
