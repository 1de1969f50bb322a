// Device queries the launch site needs before it sizes a launch.

#include "common.cuh"

// Largest dynamic shared memory one block may request on `device` (the
// opt-in limit), or -1 on error.
BSPS_EXPORT int bsps_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}
