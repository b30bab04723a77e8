// mg_render.cu — multigraph scene renderer (K2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel render_scene_batch_pallas
// (reasoning_image_generation_tpu/models/multigraph/renderer_pallas.py,
// kernel body _make_kernel).  Inputs come from
// models/multigraph/renderer.py::prepare_scene_batch: meta f32 [N, 20, 8],
// shape and mask vertices f32 [N, 3, 64] (x and y apart), lines
// f32 [N, 24, 16]; output is u8 NHWC [N, H, W, 3], written directly (no
// padding to the TPU's 256-lane tiles, no transpose, no crop).
//
// Design.  One block per (scene, 32x16 pixel tile), one thread per pixel.
// The block stages its scene's meta, the 3 shape and 3 mask outlines and the
// 24 lines in shared memory (5.1 KB), then culls each shape and line once
// for the whole tile with the bbox test of the Pallas kernel (a uniform
// branch).  The mask-union SDF is evaluated only where the scene has masks
// and shape 0, the only shape they act on, reaches the tile.  Each thread
// keeps its r, g, b accumulators in registers and writes 3 bytes.
//
// Bound.  Per pixel the work is the polygon edge loop: ~22 float32
// operations and two IEEE divisions per edge, 64 edges per outline, for
// each shape (and mask) whose bbox reaches the tile, plus ~35 operations
// per decoration line that reaches it.  Output is 3 bytes a pixel (123 MB
// for 16 scenes at 1600x1600, 37 us at 3.35 TB/s), inputs are ~7 KB a
// scene, and the operations take longer (~7 GFLOP for 16 generated scenes,
// 104 us at 67 TFLOP/s), so float32 arithmetic bounds the kernel, not
// memory; the per-tile cull is what cuts the work.
//
// Numerics.  The result must equal the plain PyTorch version byte for byte,
// so the source keeps its operation order, uses IEEE division and square
// root, and is built with -fmad=false so that the compiler fuses nothing on
// its own.  The multiply-adds that XLA's CPU backend fuses in the JAX
// package (see renderer.py) are written out as __fmaf_rn at the same sites:
// the edge projection, the distance components and squared distances, the
// crossing abscissa, the line's closest point, the gradient colour lerp and
// the over-compositing of gradient and line colours.  Rounding to u8 is
// rintf (half to even, as torch.round).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NMETA = 20;
constexpr int NCOL = 8;
constexpr int NV = 64;
constexpr int MAX_SHAPES = 3;
constexpr int MAX_MASKS = 3;
constexpr int MAX_LINES = 24;
constexpr int NLIN = 16;
constexpr int TILE_W = 32;
constexpr int TILE_H = 16;

enum {
  R_MODE, R_MASK_VALID, R_VALID, R_BX0, R_BX1, R_BY0, R_BY1, R_LW, R_ALPHA,
  R_GRAD, R_GCX, R_GCY, R_GRMAX, R_GALPHA, R_C0, R_C1 = R_C0 + 3
};
enum {
  L_VALID, L_BX0, L_BX1, L_BY0, L_BY1, L_X0, L_Y0, L_X1, L_Y1, L_LW, L_ALPHA,
  L_RGB
};

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// alpha * clip(lw/2 + 0.5 - d, 0, 1): the Agg-calibrated stroke ramp
__device__ __forceinline__ float band(float lw, float alpha, float d) {
  return __fmul_rn(alpha, clamp01(__fsub_rn(
      __fadd_rn(__fmul_rn(lw, 0.5f), 0.5f), d)));
}

// Signed distance (negative inside) of (px, py) to a closed 64-vertex
// outline: min distance over the edges, even-odd crossing parity.
__device__ __forceinline__ float poly_sd(const float* vx, const float* vy,
                                         float px, float py) {
  float d2 = __int_as_float(0x7f800000);  // +inf
  int cross = 0;
  for (int k = 0; k < NV; ++k) {
    const int kb = (k == NV - 1) ? 0 : k + 1;
    const float ax = vx[k], ay = vy[k], bx = vx[kb], by = vy[kb];
    const float ex = __fsub_rn(bx, ax);
    const float ey = __fsub_rn(by, ay);
    const float len2 = __fadd_rn(__fmaf_rn(ex, ex, __fmul_rn(ey, ey)), 1e-9f);
    const float inv = __fdiv_rn(1.0f, len2);
    const float pxe = __fsub_rn(px, ax);
    const float pye = __fsub_rn(py, ay);
    const float t = clamp01(__fmul_rn(__fmaf_rn(pxe, ex, __fmul_rn(pye, ey)),
                                      inv));
    const float dx = __fmaf_rn(-t, ex, pxe);
    const float dy = __fmaf_rn(-t, ey, pye);
    d2 = fminf(d2, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
    const bool cond = (ay > py) != (by > py);
    const float safe_ey = (ey == 0.0f) ? 1.0f : ey;
    const float xint = __fmaf_rn(__fsub_rn(py, ay), __fdiv_rn(ex, safe_ey), ax);
    cross += (cond && (px < xint)) ? 1 : 0;
  }
  const float dist = __fsqrt_rn(d2);
  return (cross % 2 == 1) ? -dist : dist;
}

__device__ __forceinline__ bool bbox_hit(float bx0, float bx1, float by0,
                                         float by1, float x0, float y0) {
  return bx1 >= x0 && bx0 <= x0 + TILE_W && by1 >= y0 && by0 <= y0 + TILE_H;
}

__global__ void __launch_bounds__(TILE_W * TILE_H)
mg_render_kernel(const float* __restrict__ meta, const float* __restrict__ svx,
                 const float* __restrict__ svy, const float* __restrict__ mvx,
                 const float* __restrict__ mvy, const float* __restrict__ lin,
                 uint8_t* __restrict__ out, int H, int W) {
  __shared__ float s_meta[NMETA * NCOL];
  __shared__ float s_svx[MAX_SHAPES * NV], s_svy[MAX_SHAPES * NV];
  __shared__ float s_mvx[MAX_MASKS * NV], s_mvy[MAX_MASKS * NV];
  __shared__ float s_lin[MAX_LINES * NLIN];
  __shared__ int s_shape_hit[MAX_SHAPES];
  __shared__ int s_line_hit[MAX_LINES];

  const int n = blockIdx.z;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int nthreads = TILE_W * TILE_H;
  for (int i = tid; i < NMETA * NCOL; i += nthreads)
    s_meta[i] = meta[(size_t)n * NMETA * NCOL + i];
  for (int i = tid; i < MAX_SHAPES * NV; i += nthreads) {
    s_svx[i] = svx[(size_t)n * MAX_SHAPES * NV + i];
    s_svy[i] = svy[(size_t)n * MAX_SHAPES * NV + i];
    s_mvx[i] = mvx[(size_t)n * MAX_MASKS * NV + i];
    s_mvy[i] = mvy[(size_t)n * MAX_MASKS * NV + i];
  }
  for (int i = tid; i < MAX_LINES * NLIN; i += nthreads)
    s_lin[i] = lin[(size_t)n * MAX_LINES * NLIN + i];
  __syncthreads();

  // per-tile culling (tile extent in pixels, as the Pallas kernel tests it)
  const float tx0 = (float)(blockIdx.x * TILE_W);
  const float ty0 = (float)(blockIdx.y * TILE_H);
  if (tid < MAX_SHAPES) {
    const float* m = s_meta;
    s_shape_hit[tid] = m[R_VALID * NCOL + tid] > 0.0f &&
        bbox_hit(m[R_BX0 * NCOL + tid], m[R_BX1 * NCOL + tid],
                 m[R_BY0 * NCOL + tid], m[R_BY1 * NCOL + tid], tx0, ty0);
  } else if (tid < MAX_SHAPES + MAX_LINES) {
    const float* l = s_lin + (tid - MAX_SHAPES) * NLIN;
    s_line_hit[tid - MAX_SHAPES] = l[L_VALID] > 0.0f &&
        bbox_hit(l[L_BX0], l[L_BX1], l[L_BY0], l[L_BY1], tx0, ty0);
  }
  __syncthreads();

  const int x = blockIdx.x * TILE_W + threadIdx.x;
  const int y = blockIdx.y * TILE_H + threadIdx.y;
  if (x >= W || y >= H) return;
  const float px = __fadd_rn((float)x, 0.5f);   // pixel centres
  const float py = __fadd_rn((float)y, 0.5f);
  float acc[3] = {255.0f, 255.0f, 255.0f};

  // mask-union SDF: read only by shape 0, and only where it has masks
  const float mode = s_meta[R_MODE * NCOL];
  const bool has_mask = mode > 0.0f;
  float msk = 1e9f;
  if (has_mask && s_shape_hit[0]) {
    for (int mi = 0; mi < MAX_MASKS; ++mi)
      if (s_meta[R_MASK_VALID * NCOL + mi] > 0.0f)
        msk = fminf(msk, poly_sd(s_mvx + mi * NV, s_mvy + mi * NV, px, py));
  }

  for (int s = 0; s < MAX_SHAPES; ++s) {
    if (!s_shape_hit[s]) continue;  // uniform across the block
    const float lw = s_meta[R_LW * NCOL + s];
    const float alpha = s_meta[R_ALPHA * NCOL + s];
    const float sd = poly_sd(s_svx + s * NV, s_svy + s * NV, px, py);
    float a = band(lw, alpha, fabsf(sd));
    if (s == 0) {
      const float hm = has_mask ? 1.0f : 0.0f;
      const float cut = (msk <= 0.0f) ? 1.0f : 0.0f;
      a = __fmul_rn(a, __fsub_rn(1.0f, __fmul_rn(hm, cut)));
    }
    if (s_meta[R_GRAD * NCOL + s] > 0.0f) {
      // radial gradient fill inside the shape, under its stroke
      const float dx = __fsub_rn(px, s_meta[R_GCX * NCOL + s]);
      const float dy = __fsub_rn(py, s_meta[R_GCY * NCOL + s]);
      const float tfrac = clamp01(__fdiv_rn(
          __fsqrt_rn(__fmaf_rn(dx, dx, __fmul_rn(dy, dy))),
          s_meta[R_GRMAX * NCOL + s]));
      const float ga = __fmul_rn(sd < 0.0f ? 1.0f : 0.0f,
                                 s_meta[R_GALPHA * NCOL + s]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float col = __fmaf_rn(
            s_meta[(R_C0 + c) * NCOL + s], __fsub_rn(1.0f, tfrac),
            __fmul_rn(s_meta[(R_C1 + c) * NCOL + s], tfrac));
        acc[c] = __fmaf_rn(acc[c], __fsub_rn(1.0f, ga), __fmul_rn(col, ga));
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) acc[c] = __fmul_rn(acc[c], __fsub_rn(1.0f, a));
    if (s == 0 && mode == 2.0f) {
      // replace_boundary: the mask boundary, stroked inside the base
      const float ma = __fmul_rn(band(lw, alpha, fabsf(msk)),
                                 sd < 0.0f ? 1.0f : 0.0f);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] = __fmul_rn(acc[c], __fsub_rn(1.0f, ma));
    }
  }

  for (int k = 0; k < MAX_LINES; ++k) {
    if (!s_line_hit[k]) continue;  // uniform across the block
    const float* l = s_lin + k * NLIN;
    const float x0 = l[L_X0], y0 = l[L_Y0];
    const float ex = __fsub_rn(l[L_X1], x0);
    const float ey = __fsub_rn(l[L_Y1], y0);
    const float inv = __fdiv_rn(
        1.0f, __fadd_rn(__fmaf_rn(ex, ex, __fmul_rn(ey, ey)), 1e-9f));
    const float t = clamp01(__fmul_rn(
        __fmaf_rn(__fsub_rn(px, x0), ex, __fmul_rn(__fsub_rn(py, y0), ey)),
        inv));
    const float dx = __fsub_rn(px, __fmaf_rn(t, ex, x0));
    const float dy = __fsub_rn(py, __fmaf_rn(t, ey, y0));
    const float a = band(l[L_LW], l[L_ALPHA],
                         __fsqrt_rn(__fmaf_rn(dx, dx, __fmul_rn(dy, dy))));
#pragma unroll
    for (int c = 0; c < 3; ++c)
      acc[c] = __fmaf_rn(acc[c], __fsub_rn(1.0f, a),
                         __fmul_rn(l[L_RGB + c], a));
  }

  uint8_t* o = out + (((size_t)n * H + y) * W + x) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    o[c] = (uint8_t)fminf(fmaxf(rintf(acc[c]), 0.0f), 255.0f);
}

}  // namespace

extern "C" int rig_mg_render(const float* meta, const float* svx,
                             const float* svy, const float* mvx,
                             const float* mvy, const float* lin, uint8_t* out,
                             int N, int H, int W, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || N > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 block(TILE_W, TILE_H);
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, N);
  mg_render_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      meta, svx, svy, mvx, mvy, lin, out, H, W);
  return (int)cudaGetLastError();
}
