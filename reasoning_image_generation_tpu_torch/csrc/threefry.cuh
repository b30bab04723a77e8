// threefry.cuh — threefry2x32 key streams, one output at a time, in uint32
// arithmetic.
//
// The counterpart of utils/prng.py's integer code (fold_in, split,
// random_bits; jax.random with jax_threefry_partitionable and 32-bit
// types): the same 20 rounds, key schedule and injections, on uint32 words
// that wrap by themselves where the tensor code masks int64 values.  Plain
// C: nvcc builds it into csrc/threefry.cu's kernel, and a host C compiler
// builds it too, so the CPU tests run the very code the card runs.
//
// Keys are int64 words [..., 2] as the port holds them (values in
// [0, 2**32)), read in place through RigTfBatch: any strides, broadcast
// dims (stride 0) included, so a view such as keys[..., 0, :] is read
// without a copy.  Output t of a call is counter t % count of key row
// t / count, the rows in row-major order of the batch:
//   fold_in      count 1; the pair (0, data) -> out[2t], out[2t + 1];
//   split        the pair (0, t % count)      -> out[2t], out[2t + 1];
//   random_bits  the pair (0, t % count)      -> out[t] = a ^ b.
#ifndef RIG_THREEFRY_CUH
#define RIG_THREEFRY_CUH

#include <stdint.h>

#ifdef __CUDACC__
#define RIG_TF_FN static __host__ __device__ __forceinline__
#define RIG_TF_UNROLL _Pragma("unroll")
#else
#define RIG_TF_FN static inline
#define RIG_TF_UNROLL
#endif

#define RIG_TF_MAX_DIMS 8

enum { RIG_TF_FOLD_IN = 0, RIG_TF_SPLIT = 1, RIG_TF_BITS = 2 };

// the key batch: its dims, and the strides, in int64 words, of the keys'
// rows and of fold_in's data along each dim (0 where one broadcasts)
typedef struct {
  int64_t ndim;
  int64_t size[RIG_TF_MAX_DIMS];
  int64_t key[RIG_TF_MAX_DIMS];
  int64_t data[RIG_TF_MAX_DIMS];
  int64_t word;    // from a key's first word to its second
} RigTfBatch;

RIG_TF_FN uint32_t rig_tf_rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// Threefry-2x32, 20 rounds, of the counter pair (*x0, *x1) under the key
// (k0, k1), in place
RIG_TF_FN void rig_threefry2x32(uint32_t k0, uint32_t k1, uint32_t *x0,
                                uint32_t *x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = *x0 + ks[0], b = *x1 + ks[1];
  RIG_TF_UNROLL
  for (int i = 0; i < 5; ++i) {
    RIG_TF_UNROLL
    for (int r = 0; r < 4; ++r) {
      a += b;
      b = rig_tf_rotl(b, rot[i % 2][r]) ^ a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  *x0 = a;
  *x1 = b;
}

// the number of key rows in the batch
RIG_TF_FN int64_t rig_tf_rows(RigTfBatch b) {
  int64_t n = 1;
  for (int64_t d = 0; d < b.ndim; ++d) n *= b.size[d];
  return n;
}

// output t of a call in `mode` (see the head of this file); `data` is
// fold_in's tensor, or NULL for its one value `value`
RIG_TF_FN void rig_tf_one(int mode, const int64_t *keys, const int64_t *data,
                          int64_t value, RigTfBatch b, int64_t count,
                          int64_t t, int64_t *out) {
  int64_t row = t / count;
  const uint32_t c = (uint32_t)(t - row * count);
  int64_t ko = 0, dofs = 0;
  RIG_TF_UNROLL
  for (int d = RIG_TF_MAX_DIMS - 1; d >= 0; --d) {
    if (d < b.ndim) {
      const int64_t i = row % b.size[d];
      row /= b.size[d];
      ko += i * b.key[d];
      dofs += i * b.data[d];
    }
  }
  uint32_t x0 = 0, x1 = c;
  if (mode == RIG_TF_FOLD_IN) x1 = (uint32_t)(data ? data[dofs] : value);
  rig_threefry2x32((uint32_t)keys[ko], (uint32_t)keys[ko + b.word], &x0, &x1);
  if (mode == RIG_TF_BITS) {
    out[t] = (int64_t)(x0 ^ x1);
  } else {
    out[2 * t] = (int64_t)x0;
    out[2 * t + 1] = (int64_t)x1;
  }
}

#endif  // RIG_THREEFRY_CUH
