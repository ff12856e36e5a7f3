// The emulator's launch (cuda_emu.h): each block's threads as std::threads.
#include "cuda_emu.h"

thread_local uint3 threadIdx, blockIdx;
dim3 blockDim, gridDim;
thread_local std::vector<std::vector<emu::Copy>> emu::groups;

namespace emu {

Barrier* block_barrier;
std::vector<Warp>* warps;
unsigned char* dynamic_smem;

void launch(dim3 grid, dim3 block, size_t smem, cudaStream_t, std::function<void()> f) {
  blockDim = block;
  gridDim = grid;
  std::vector<unsigned char> buf(smem + 16);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        Barrier bar;
        bar.n = block.x;
        block_barrier = &bar;
        std::vector<Warp> ws((block.x + 31) / 32);
        for (auto& w : ws) w.bar.n = 32;
        warps = &ws;
        std::fill(buf.begin(), buf.end(), 0xff);
        dynamic_smem = buf.data();
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([&, t, bx, by, bz] {
            threadIdx = {t, 0, 0};
            blockIdx = {bx, by, bz};
            groups.clear();
            f();
          });
        for (auto& th : threads) th.join();
      }
}

}  // namespace emu
