// threefry.cu — threefry2x32 key streams (fold_in, split, random_bits) for
// Hopper (sm_90a), one launch a call.
//
// Replaces the integer tensor code of utils/prng.py on a card, where each
// call ran as 171 int64 elementwise kernels (an add and its mask, a rotate
// as two shifts, an or and a mask) over a few to a few thousand words.  The
// round code is csrc/threefry.cuh, which the CPU tests build with a host C
// compiler; this file only launches it.
//
// Design.  One thread an output (a key pair, or 32 bits), 256 a block.  The
// counters are the output's index, so no counter tensor exists; the keys
// and fold_in's data are read in place through their strides, so a view
// needs no copy; the output is the int64 tensor the wrapper allocated, in
// the layout the integer code gives.  The work is a few thousand words at
// most: what counts is one launch instead of 171, not bandwidth.  A launch
// goes to the caller's stream, synchronises nothing and allocates nothing,
// so it is captured into a CUDA graph like any other kernel.
//
// Numerics: uint32 adds, xors and rotates, exact on any target.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int NTHREADS = 256;

template <int MODE>
__global__ void __launch_bounds__(NTHREADS)
threefry_kernel(const int64_t* __restrict__ keys,
                const int64_t* __restrict__ data, int64_t value,
                RigTfBatch b, int64_t count, int64_t n,
                int64_t* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * NTHREADS + threadIdx.x;
  if (t < n) rig_tf_one(MODE, keys, data, value, b, count, t, out);
}

template <int MODE>
int launch(const int64_t* keys, const int64_t* data, int64_t value,
           RigTfBatch b, int64_t count, int64_t* out, void* stream) {
  if (b.ndim < 0 || b.ndim > RIG_TF_MAX_DIMS || count <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n = rig_tf_rows(b) * count;
  const int64_t blocks = (n + NTHREADS - 1) / NTHREADS;
  if (n <= 0 || blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  threefry_kernel<MODE><<<(unsigned)blocks, NTHREADS, 0,
                          (cudaStream_t)stream>>>(keys, data, value, b, count,
                                                  n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// keys folded with `data` (one int64 word a row of the batch; NULL: the
// one `value` for every row) -> out [rows, 2]
extern "C" int rig_threefry_fold_in(const int64_t* keys, const int64_t* data,
                                    int64_t value, RigTfBatch b, int64_t* out,
                                    void* stream) {
  return launch<RIG_TF_FOLD_IN>(keys, data, value, b, 1, out, stream);
}

// each key split into `num` -> out [rows, num, 2]
extern "C" int rig_threefry_split(const int64_t* keys, RigTfBatch b,
                                  int64_t num, int64_t* out, void* stream) {
  return launch<RIG_TF_SPLIT>(keys, nullptr, 0, b, num, out, stream);
}

// `count` words of 32 random bits a key -> out [rows, count]
extern "C" int rig_threefry_random_bits(const int64_t* keys, RigTfBatch b,
                                        int64_t count, int64_t* out,
                                        void* stream) {
  return launch<RIG_TF_BITS>(keys, nullptr, 0, b, count, out, stream);
}
