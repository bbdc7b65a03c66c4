// One translation unit of mono.cuh: mono_rows at int32 words with int32 dm,
// every fold.

#define PGB_MONO_DEFS
#include "mono.cuh"

PGB_ROWS_INSTANCE(int32_t, int32_t);
