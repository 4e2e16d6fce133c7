// Asynchronous copies to shared memory (cp.async) for the CPU emulation (see
// cuda_runtime.h here). A copy lands only when a __pipeline_wait_prior call
// retires its committed batch, as on the card: a kernel that reads shared
// memory before it waits reads the NaN the emulation filled it with.
#pragma once
#include <cstddef>
#include <cstring>
#include <deque>
#include <vector>

struct EmuAsyncCopy {
  void* dst;
  const void* src;
  size_t bytes, zfill;
};
// This thread's copies: the batches committed, oldest first, then the open one.
inline thread_local std::deque<std::vector<EmuAsyncCopy>> emu_copy_batches;
inline thread_local std::vector<EmuAsyncCopy> emu_copy_open;

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size_and_align,
                                    size_t zfill = 0) {
  emu_copy_open.push_back({dst, src, size_and_align - zfill, zfill});
}
inline void __pipeline_commit() {
  emu_copy_batches.push_back(std::move(emu_copy_open));
  emu_copy_open.clear();
}
inline void __pipeline_wait_prior(size_t prior) {
  while (emu_copy_batches.size() > prior) {
    for (const EmuAsyncCopy& c : emu_copy_batches.front()) {
      std::memcpy(c.dst, c.src, c.bytes);
      std::memset(static_cast<char*>(c.dst) + c.bytes, 0, c.zfill);
    }
    emu_copy_batches.pop_front();
  }
}
