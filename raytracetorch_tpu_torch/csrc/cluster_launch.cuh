// Persistent launches in thread-block clusters for Hopper (sm_90a), shared
// by the two scatters that sum per-block copies in shared memory across a
// cluster before they add to device memory: kernel K3's band scatter
// (grid_bin.cu) and kernel K4's shared-map scatter (grid_corners.cu).

#pragma once

#include <mutex>

#include <cuda_runtime.h>

namespace rtt {

// The launch configuration of `clusters` clusters of kBlocks blocks of
// `threads` threads, `smem` bytes of dynamic shared memory a block.  `attr`
// must outlive `cfg`.
template <int kBlocks>
void cluster_config(long long clusters, int threads, size_t smem, cudaStream_t stream,
                    cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kBlocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kBlocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// Resident clusters of kBlocks blocks of `threads` threads of `kernel`, with
// `smem` bytes of dynamic shared memory a block, on the current device.  The
// first call for a (device, smem) allows the kernel `max_smem` bytes and
// asks the occupancy calculator; later calls read the answer back (the
// cache is shared by the host threads, under a lock).
template <int kBlocks, class Kernel>
cudaError_t resident_clusters(Kernel kernel, int threads, size_t max_smem, size_t smem,
                              int* out) {
  struct Entry {
    int device;
    size_t smem;
    int count;
  };
  static Entry cache[32];
  static int n_cached = 0;
  static std::mutex lock;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const std::lock_guard<std::mutex> hold(lock);
  for (int j = 0; j < n_cached; ++j)
    if (cache[j].device == device && cache[j].smem == smem) {
      *out = cache[j].count;
      return cudaSuccess;
    }
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(max_smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config<kBlocks>(1, threads, smem, nullptr, cfg, attr);
  e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (*out < 1) return cudaErrorInvalidConfiguration;
  if (n_cached < 32) cache[n_cached++] = {device, smem, *out};
  return cudaSuccess;
}

// Launch `clusters` clusters of kBlocks blocks of `kernel` on `stream`, no
// more than are resident (the caller asks resident_clusters); returns the
// launch's error, then cudaGetLastError().
template <int kBlocks, class Kernel, class... Args>
cudaError_t launch_clusters(Kernel kernel, long long clusters, int threads, size_t smem,
                            cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config<kBlocks>(clusters, threads, smem, stream, cfg, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace rtt
