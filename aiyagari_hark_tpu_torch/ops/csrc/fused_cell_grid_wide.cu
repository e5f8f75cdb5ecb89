// fused_cell_grid for 17 labor states or more: the same source, compiled
// for the bounds 32 and the wide mix (lottery_device.cuh) into a library
// of its own, which nvcc builds beside the one for 8 and 16 (the only one
// with the cluster layout: the EGM cluster holds 16 states).  The wrapper
// takes the library by the lane's bound (ops.kernels.lottery_state_bound).
#define AHTT_WIDE_BOUNDS
#include "fused_cell_grid.cu"
