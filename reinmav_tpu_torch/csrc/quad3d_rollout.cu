// The Philox4x32-10 known-answer kernel, and the library's error strings.
//
// K1, the quadrotor3d closed-loop rollout with fused auto-reset (the
// replacement of reinmav_tpu/ops/pallas_rollout.py::
// quad3d_rollout_autoreset_pallas8 :591 and of its no-reset form
// quad3d_rollout_pallas :359), is the Quad3dLoop instance of the closed-loop
// template in closed_loop_rollout.cu.  Its resets draw from Philox4x32-10
// (quad3d_common.cuh, shared with every kernel that draws); the kernel here
// runs that generator on given (counter, key) pairs, so that a run can hold
// it to Random123's known answers (chip_smoke.py, phase 3).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quad3d_common.cuh"

namespace {

constexpr int kThreads = 256;

// Philox4x32-10 on n (counter, key) pairs.
__global__ void philox4x32_10_kernel(const uint32_t* __restrict__ ctr,
                                     const uint32_t* __restrict__ key,
                                     uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]);
  const uint4 r = reinmav::philox4x32_10(c, key[2 * i], key[2 * i + 1]);
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  The entry
// point launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

extern "C" int philox4x32_10_launch(const void* counters, const void* keys, void* out,
                                    long long n, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  philox4x32_10_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(counters), static_cast<const uint32_t*>(keys),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
