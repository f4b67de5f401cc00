// Device stage stamps: one thread writes the card's nanosecond clock into a ring of rows.
//
// Replaces no TPU kernel. It is the tracer's (vo_tpu_torch/utils/profiling.py): with the
// tracer on, the VO step's body (odometry/pipeline.py) launches it at each stage boundary, so
// that a CUDA graph's replay, which the host sees as one launch, still says where its device
// time went. Plain version: profiling.write_stamp on the CPU (perf_counter_ns); wrapper: the
// same function for CUDA tensors.
//
// One thread reads %globaltimer and stores buf[row % rows, col]; with `advance` it also moves
// the device counter `row` on, so that the next replay fills the next row and the host never
// reads the counter inside the loop. A launch in stream order runs after the node before it
// and before the node after it, so the stamp is the end of the one stage and the start of the
// next. Bound: launch latency alone (16 bytes moved); nothing to design for.
#include <cuda_runtime.h>

namespace {

__global__ void stage_stamp_kernel(long long* buf, long long* row, int rows, int width, int col, int advance) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long r = *row;
  buf[(r % rows) * width + col] = static_cast<long long>(t);
  if (advance) *row = r + 1;
}

}  // namespace

// buf: int64 [rows, width] contiguous; row: int64 [1]. One launch on `stream`.
extern "C" cudaError_t vo_stage_stamp(void* buf, void* row, int rows, int width, int col, int advance, void* stream) {
  stage_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(buf), static_cast<long long*>(row), rows, width, col, advance);
  return cudaGetLastError();
}
