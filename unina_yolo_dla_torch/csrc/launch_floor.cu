// An empty kernel: what one launch costs the card when the kernel does
// nothing. chip_smoke.py and tools/torch_prepost_probe.py time it the way
// they time the small kernels (normalize, decode, NMS), so those rows can
// be read against the floor every launch pays. No model path calls it.
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int unina_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
