// One translation unit of mono.cuh: mono_rows at uint32 words with int16 dm,
// every fold.

#define PGB_MONO_DEFS
#include "mono.cuh"

PGB_ROWS_INSTANCE(uint32_t, int16_t);
