// poly.cuh — the polygon edge loop shared by the two rasterizers
// (raster.cu, K1; mg_render.cu, K2) for Hopper (sm_90a).
//
// Replaces the per-pixel edge loops of the Pallas TPU kernels
// render_batch_pallas (reasoning_image_generation_tpu/ops/raster_pallas.py,
// _make_kernel) and render_scene_batch_pallas
// (reasoning_image_generation_tpu/models/multigraph/renderer_pallas.py,
// _make_kernel): min squared distance to a closed outline and even-odd
// crossing parity, in float32, bit for bit.
//
// Bound.  The float32 pipe: per pixel and edge the distance step is 16
// operations and the crossing step 6.  Everything that depends on the edge
// alone (ex, ey, 1/len2, ex/safe_ey: two IEEE divisions) is computed once
// per block by one thread per edge into an EdgeRec in shared memory; a pixel
// reads a record as two 16-byte broadcast loads.  No tensor core fits (there
// is no matrix product, and the arithmetic is bit-exact float32), nor does
// TMA (an outline is 512 bytes, read once per block).
//
// Culls, each exact.  A block keeps, per outline, two 64-bit masks of edges
// (one bit per edge, built with __ballot_sync, so every loop over a mask is
// uniform across the warp):
//  - rows mask (edge_spans_rows): an edge both of whose ends lie above every
//    pixel row of the block, or both on or below every row, has
//    (ay > py) != (by > py) false at every pixel there, so it adds nothing
//    to the crossing count;
//  - near mask (seg_near_rect): the stroke ramp is clamped to zero from
//    distance `reach` on, so a pixel needs its exact distance only below
//    reach.  An edge farther than reach + NEAR_MARGIN from the rectangle of
//    the tile's pixel centres (a separating-axis test on x, y and the edge
//    normal, which never overestimates the distance) cannot be the nearest
//    edge of such a pixel.  The min over the near edges equals the true min
//    wherever that is below reach and is no smaller anywhere else, where the
//    ramp is zero either way.  NEAR_MARGIN (half a pixel) covers the float32
//    rounding of the test and of the distance (about 1e-3 px at these
//    coordinates).  fminf is exact, so the order of the edges is free.
//
// Numerics.  Built with -fmad=false; every rounding is written out
// (__fsub_rn, __fmaf_rn, __fdiv_rn) at the sites of the plain PyTorch
// versions (ops/raster.py::_poly_field).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace poly {

constexpr float NEAR_MARGIN = 0.5f;

// One edge a -> b of an outline, with everything the per-pixel steps need
// that does not depend on the pixel.  32 bytes: two float4 loads.
struct __align__(16) EdgeRec {
  float ax, ay, ex, ey;      // start, b - a
  float inv, slope, by, bx;  // 1/(|e|^2 + 1e-9), ex/safe_ey, end
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ EdgeRec edge_record(float ax, float ay, float bx,
                                               float by) {
  EdgeRec r;
  r.ax = ax;
  r.ay = ay;
  r.bx = bx;
  r.by = by;
  r.ex = __fsub_rn(bx, ax);
  r.ey = __fsub_rn(by, ay);
  const float len2 =
      __fadd_rn(__fmaf_rn(r.ex, r.ex, __fmul_rn(r.ey, r.ey)), 1e-9f);
  r.inv = __fdiv_rn(1.0f, len2);
  const float safe_ey = (r.ey == 0.0f) ? 1.0f : r.ey;
  r.slope = __fdiv_rn(r.ex, safe_ey);
  return r;
}

// Edge k of the outline given by its first n vertices (closing back to
// vertex 0) -> tab[k].  One thread per edge, once per block.
__device__ __forceinline__ EdgeRec fill_edge(EdgeRec* tab, const float* vx,
                                             const float* vy, int n, int k) {
  const int kb = (k == n - 1) ? 0 : k + 1;
  const EdgeRec r = edge_record(vx[k], vy[k], vx[kb], vy[kb]);
  tab[k] = r;
  return r;
}

// squared distance of (px, py) to the segment (ax, ay) + t (ex, ey)
__device__ __forceinline__ float seg_d2(float ax, float ay, float ex, float ey,
                                        float inv, float px, float py) {
  const float pxe = __fsub_rn(px, ax);
  const float pye = __fsub_rn(py, ay);
  const float t =
      clamp01(__fmul_rn(__fmaf_rn(pxe, ex, __fmul_rn(pye, ey)), inv));
  const float dx = __fmaf_rn(-t, ex, pxe);
  const float dy = __fmaf_rn(-t, ey, pye);
  return __fmaf_rn(dx, dx, __fmul_rn(dy, dy));
}

// Min squared distance over the edges of `tab` whose bit is set (+inf for
// an empty mask), at R pixels of one column: (px, py[0..R)).  The R chains
// are independent, so one record load feeds R pixels and the float32 pipe
// stays busy.
template <int R>
__device__ __forceinline__ void min_d2(const EdgeRec* tab, uint32_t lo,
                                       uint32_t hi, float px, const float* py,
                                       float* d2) {
#pragma unroll
  for (int r = 0; r < R; ++r) d2[r] = __int_as_float(0x7f800000);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    for (uint32_t m = h ? hi : lo; m; m &= m - 1) {
      const float4* rec = reinterpret_cast<const float4*>(
          tab + (__ffs(m) - 1 + 32 * h));
      const float4 g = rec[0];
      const float inv = rec[1].x;
#pragma unroll
      for (int r = 0; r < R; ++r)
        d2[r] = fminf(d2[r], seg_d2(g.x, g.y, g.z, g.w, inv, px, py[r]));
    }
  }
}

// Even-odd crossing parity over the edges of `tab` whose bit is set, at R
// pixels of one column: bit r of the result is set where (px, py[r]) is
// inside.
template <int R>
__device__ __forceinline__ uint32_t inside(const EdgeRec* tab, uint32_t lo,
                                           uint32_t hi, float px,
                                           const float* py) {
  uint32_t odd = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    for (uint32_t m = h ? hi : lo; m; m &= m - 1) {
      const float4* rec = reinterpret_cast<const float4*>(
          tab + (__ffs(m) - 1 + 32 * h));
      const float4 g = rec[0], q = rec[1];   // q: inv, slope, by, bx
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool cond = (g.y > py[r]) != (q.z > py[r]);
        const float xint = __fmaf_rn(__fsub_rn(py[r], g.y), q.y, g.x);
        odd ^= ((cond && (px < xint)) ? 1u : 0u) << r;
      }
    }
  }
  return odd;
}

// May the edge's crossing condition hold at some py in [ymin, ymax]?
__device__ __forceinline__ bool edge_spans_rows(float ay, float by, float ymin,
                                                float ymax) {
  return !((ay > ymax && by > ymax) || (ay <= ymin && by <= ymin));
}

// Conservative: false only if the segment a..b is farther than R from the
// rectangle with centre (cx, cy) and half extents (hw, hh).  Separating
// axes x, y and the segment's normal; the rectangle is grown by R on each.
__device__ __forceinline__ bool seg_near_rect(float ax, float ay, float bx,
                                              float by, float cx, float cy,
                                              float hw, float hh, float R) {
  if (fminf(ax, bx) > cx + hw + R || fmaxf(ax, bx) < cx - hw - R) return false;
  if (fminf(ay, by) > cy + hh + R || fmaxf(ay, by) < cy - hh - R) return false;
  const float ex = bx - ax, ey = by - ay;
  const float s = fabsf(ey * (cx - ax) - ex * (cy - ay)) -
                  (fabsf(ey) * hw + fabsf(ex) * hh);
  return s <= 0.0f || s * s <= R * R * (ex * ex + ey * ey);
}

// 32 * 3 bytes of one pixel row of a tile, staged in shared memory by the
// warp that owns the tile
constexpr int ROW_BYTES = 32 * 3;
constexpr int ROW_WORDS = ROW_BYTES / 16;

__device__ __forceinline__ void stage_pixel(uint8_t* stage, int row, int col,
                                            const float acc[3]) {
  uint8_t* o = stage + row * ROW_BYTES + col * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o[c] = (uint8_t)fminf(fmaxf(rintf(acc[c]), 0.0f), 255.0f);
}

// May a tile at column x0 of an NHWC u8 image of width W be written as
// 16-byte words?  Every row start is aligned and the tile is whole across.
__device__ __forceinline__ bool tile_aligned(const uint8_t* img, int W,
                                             int x0) {
  return (W * 3) % 16 == 0 && x0 + 32 <= W &&
         (reinterpret_cast<uintptr_t>(img) & 15) == 0;
}

// Write `rows` staged rows of 32 pixels at pixel (x0, y) of an NHWC u8 image
// of H x W: 16-byte words, neighbouring lanes on neighbouring addresses,
// where tile_aligned holds; else byte by byte, guarded.  All lanes of one
// warp call it.
__device__ __forceinline__ void store_rows(const uint8_t* stage, uint8_t* img,
                                           int W, int H, int x0, int y,
                                           int rows, int lane) {
  const int nrows = min(rows, H - y);
  if (tile_aligned(img, W, x0)) {
    const uint4* s4 = reinterpret_cast<const uint4*>(stage);
    for (int i = lane; i < nrows * ROW_WORDS; i += 32) {
      const int row = i / ROW_WORDS, w = i % ROW_WORDS;
      uint8_t* dst = img + ((size_t)(y + row) * W + x0) * 3 + w * 16;
      *reinterpret_cast<uint4*>(dst) = s4[i];
    }
  } else {
    const int nb = min(32, W - x0) * 3;
    for (int i = lane; i < nrows * nb; i += 32) {
      const int row = i / nb, b = i % nb;
      img[((size_t)(y + row) * W + x0) * 3 + b] = stage[row * ROW_BYTES + b];
    }
  }
}

// Write `rows` white rows of 32 pixels at (x0, y), where tile_aligned holds.
__device__ __forceinline__ void store_white(uint8_t* img, int W, int H, int x0,
                                            int y, int rows, int lane) {
  const int nrows = min(rows, H - y);
  const uint4 white = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int i = lane; i < nrows * ROW_WORDS; i += 32) {
    const int row = i / ROW_WORDS, w = i % ROW_WORDS;
    uint8_t* dst = img + ((size_t)(y + row) * W + x0) * 3 + w * 16;
    *reinterpret_cast<uint4*>(dst) = white;
  }
}

}  // namespace poly
