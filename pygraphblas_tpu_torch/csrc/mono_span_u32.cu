// One translation unit of mono.cuh: mono_span at uint32 words, both
// instantiations.

#define PGB_MONO_DEFS
#include "mono.cuh"

PGB_SPAN_INSTANCE(uint32_t, false);
PGB_SPAN_INSTANCE(uint32_t, true);
