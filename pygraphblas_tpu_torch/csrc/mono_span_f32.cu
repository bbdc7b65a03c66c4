// One translation unit of mono.cuh: mono_span at float words, both
// instantiations.

#define PGB_MONO_DEFS
#include "mono.cuh"

PGB_SPAN_INSTANCE(float, false);
PGB_SPAN_INSTANCE(float, true);
