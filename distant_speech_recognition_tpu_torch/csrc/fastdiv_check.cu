// Test entry of the shared division policy FastDivOps (dsr_device.h): the
// quotients fast_div<S> gives on arrays of operands, and whether it vouches
// for each, so that a test can hold them to the card's IEEE a / b.  No path
// of the port calls it.
#include "dsr_device.h"
#include "dsr_kernels.h"

namespace {

using namespace dsr;

template <int S>
__global__ void fastdiv_check_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                     float* __restrict__ q, int* __restrict__ ok, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    bool v;
    q[i] = fast_div<S>(a[i], b[i], v);
    ok[i] = v;
  }
}

}  // namespace

extern "C" int dsr_fastdiv_check(const float* a, const float* b, float* q, int* ok, int n,
                                 int scale_exp, cudaStream_t stream) {
  if (n < 1 || (scale_exp != 0 && scale_exp != 32)) return DSR_ERR_ARGS;
  const int threads = 256, blocks = (n + threads - 1) / threads;
  if (scale_exp == 0)
    fastdiv_check_kernel<0><<<blocks, threads, 0, stream>>>(a, b, q, ok, n);
  else
    fastdiv_check_kernel<32><<<blocks, threads, 0, stream>>>(a, b, q, ok, n);
  return static_cast<int>(cudaGetLastError());
}
