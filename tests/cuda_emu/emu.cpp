// The emulation's globals (cuda_emu.h).
#include "cuda_emu.h"

thread_local dim3 threadIdx;
dim3 blockIdx, gridDim, blockDim;
EmuWarp* emu_warps;
std::barrier<>* emu_block_bar;
EmuNamedBars* emu_named_bars;
std::deque<std::barrier<>>* emu_warpgroup_bars;
alignas(1024) unsigned char emu_smem[EMU_SMEM_BYTES];  // the 128-byte swizzle's 1024-byte period
