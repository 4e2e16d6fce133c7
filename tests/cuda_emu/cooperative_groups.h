// Thread-block clusters for the CPU emulation (see cuda_runtime.h here): a
// cluster's blocks run at once, `map_shared_rank` is pointer arithmetic between
// their shared-memory buffers.
#pragma once
unsigned emu_cluster_rank();
unsigned emu_cluster_size();
void emu_cluster_sync();
void* emu_map_rank(void* p, unsigned rank);
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return emu_cluster_rank(); }
  unsigned num_blocks() const { return emu_cluster_size(); }
  void sync() const { emu_cluster_sync(); }
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    return static_cast<T*>(emu_map_rank(static_cast<void*>(p), rank));
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
