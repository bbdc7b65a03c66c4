// One translation unit of mono.cuh: mono_rows at float words with int32 dm,
// every fold.

#define PGB_MONO_DEFS
#include "mono.cuh"

PGB_ROWS_INSTANCE(float, int32_t);
