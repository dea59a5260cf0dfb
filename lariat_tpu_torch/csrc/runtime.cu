// C entries shared by the kernel wrappers: the text of a CUDA error code, and
// the device attributes the roofline tool takes its peaks from.
#include <cuda_runtime.h>

extern "C" const char* lariat_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out[0..3] = SM count, maximum SM clock (kHz), memory clock (kHz), memory
// bus width (bits) of device `dev`; returns the first CUDA error, else 0.
extern "C" int lariat_device_attributes(int dev, int* out) {
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrClockRate,
      cudaDevAttrMemoryClockRate, cudaDevAttrGlobalMemoryBusWidth};
  for (int k = 0; k < 4; ++k) {
    const cudaError_t rc = cudaDeviceGetAttribute(&out[k], attrs[k], dev);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}
