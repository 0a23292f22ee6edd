// The emulation's globals (cuda_emu.h).
#include "cuda_emu.h"

thread_local dim3 threadIdx;
dim3 blockIdx, gridDim, blockDim;
EmuWarp* emu_warps;
std::barrier<>* emu_block_bar;
alignas(128) unsigned char emu_smem[232448];
