// A lone 1-D bulk copy through the emulation (hopper_ptx.cuh), for
// tests/test_torch_gather_emulated.py to check before the gather kernels:
// one block of 64 threads; thread 0 arms an mbarrier for `bytes` bytes and
// issues them as two bulk copies (the second half first) from src into
// shared memory at byte `offset`; every thread waits on the barrier's first
// phase and then copies the landed bytes out to dst.  Returns 1 if the
// barrier reported the phase complete before the bytes had landed.
#include "hopper_ptx.cuh"

using namespace dst_hopper;

namespace {

void bulk_selftest_kernel(const unsigned char* src, unsigned char* dst, int bytes, int offset,
                          int* early) {
  unsigned char* smem = dynamic_smem();
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* buf = smem + offset;
  const int half = bytes / 2;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_arrive_expect_tx(bar, bytes);
    if (mbar_try_wait(bar, 0)) *early = 1;  // armed, nothing landed: the phase is open
    bulk_load(buf + half, src + half, bytes - half, bar);
    if (mbar_try_wait(bar, 0)) *early = 1;  // half landed
    bulk_load(buf, src, half, bar);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  for (int i = threadIdx.x; i < bytes; i += 64) dst[i] = buf[i];
}

}  // namespace

extern "C" int emu_bulk_selftest(const void* src, void* dst, int bytes, int offset) {
  int early = 0;
  launch(bulk_selftest_kernel, dim3(1), 64, offset + bytes, nullptr,
         static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst), bytes, offset,
         &early);
  return early;
}
