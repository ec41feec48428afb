// An empty kernel: the launch floor.  Its device time, one block of one
// thread that does nothing, is the least time any launch takes on the card;
// the kernels whose work is nanoseconds (K3 at the splitter's K, B5's
// narrow variant at its smallest tiles) are read against it.  It replaces
// no TPU kernel and is on no path.
#include "common.cuh"

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int launch_floor_launch(void* stream) {
  launch_floor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
