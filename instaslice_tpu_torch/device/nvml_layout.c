/* Prints, as one JSON object, the size and field offsets of each nvml.h
 * struct the port's NVML backend lays out with ctypes
 * (instaslice_tpu_torch/device/nvml.py, struct_layout()), and the
 * version word of nvmlGpuInstanceProfileInfo_v2. chip_smoke.py builds it
 * against the CUDA toolkit's nvml.h on the card and compares:
 *
 *   cc -I/usr/local/cuda/include -o nvml_layout nvml_layout.c
 */
#include <stddef.h>
#include <stdio.h>

#include <nvml.h>

static int first = 1;

#define S(T)                                                   \
  printf("%s\"%s\": {\"sizeof\": %zu", first ? "" : ", ", #T, \
         sizeof(T));                                           \
  first = 0
#define F(T, f) printf(", \"%s\": %zu", #f, offsetof(T, f))
#define E() printf("}")

int main(void) {
  printf("{");
  S(nvmlGpuInstancePlacement_t);
  F(nvmlGpuInstancePlacement_t, start);
  F(nvmlGpuInstancePlacement_t, size);
  E();
  S(nvmlMemory_t);
  F(nvmlMemory_t, total);
  F(nvmlMemory_t, free);
  F(nvmlMemory_t, used);
  E();
  S(nvmlGpuInstanceProfileInfo_v2_t);
  F(nvmlGpuInstanceProfileInfo_v2_t, version);
  F(nvmlGpuInstanceProfileInfo_v2_t, id);
  F(nvmlGpuInstanceProfileInfo_v2_t, isP2pSupported);
  F(nvmlGpuInstanceProfileInfo_v2_t, sliceCount);
  F(nvmlGpuInstanceProfileInfo_v2_t, instanceCount);
  F(nvmlGpuInstanceProfileInfo_v2_t, multiprocessorCount);
  F(nvmlGpuInstanceProfileInfo_v2_t, copyEngineCount);
  F(nvmlGpuInstanceProfileInfo_v2_t, decoderCount);
  F(nvmlGpuInstanceProfileInfo_v2_t, encoderCount);
  F(nvmlGpuInstanceProfileInfo_v2_t, jpegCount);
  F(nvmlGpuInstanceProfileInfo_v2_t, ofaCount);
  F(nvmlGpuInstanceProfileInfo_v2_t, memorySizeMB);
  F(nvmlGpuInstanceProfileInfo_v2_t, name);
  E();
  S(nvmlGpuInstanceInfo_t);
  F(nvmlGpuInstanceInfo_t, device);
  F(nvmlGpuInstanceInfo_t, id);
  F(nvmlGpuInstanceInfo_t, profileId);
  F(nvmlGpuInstanceInfo_t, placement);
  E();
  S(nvmlComputeInstanceProfileInfo_t);
  F(nvmlComputeInstanceProfileInfo_t, id);
  F(nvmlComputeInstanceProfileInfo_t, sliceCount);
  F(nvmlComputeInstanceProfileInfo_t, instanceCount);
  F(nvmlComputeInstanceProfileInfo_t, multiprocessorCount);
  F(nvmlComputeInstanceProfileInfo_t, sharedCopyEngineCount);
  F(nvmlComputeInstanceProfileInfo_t, sharedDecoderCount);
  F(nvmlComputeInstanceProfileInfo_t, sharedEncoderCount);
  F(nvmlComputeInstanceProfileInfo_t, sharedJpegCount);
  F(nvmlComputeInstanceProfileInfo_t, sharedOfaCount);
  E();
  S(nvmlComputeInstanceInfo_t);
  F(nvmlComputeInstanceInfo_t, device);
  F(nvmlComputeInstanceInfo_t, gpuInstance);
  F(nvmlComputeInstanceInfo_t, id);
  F(nvmlComputeInstanceInfo_t, profileId);
  F(nvmlComputeInstanceInfo_t, placement);
  E();
  printf(", \"nvmlGpuInstanceProfileInfo_v2\": %u}\n",
         (unsigned)nvmlGpuInstanceProfileInfo_v2);
  return 0;
}
