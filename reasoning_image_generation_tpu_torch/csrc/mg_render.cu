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
// Bound.  A scene is an outline drawing: a pixel's colour changes only
// within lw/2 + 0.5 px of an edge or a line, or inside a gradient or mask
// shape.  With the culls below the float32 work falls under the time of the
// output's 3 bytes a pixel (123 MB for 16 scenes at 1600x1600, 37 us at
// 3.35 TB/s), so memory bounds the kernel; inputs are 7 KB a scene.  Tensor
// cores do not fit (no matrix product; bit-exact float32 distance and
// parity), nor does TMA (the inputs are read once per block, the output is
// produced in registers and written once).
//
// What holds the kernel above that bound is latency: little work, in few
// places.
//
// Design.  One block of 16 warps per strip of 64 32x16 tiles of one scene,
// in three phases with a block barrier between them and none inside:
//  A. once per block: meta and lines into shared memory; then one thread per
//     edge (2 warps per outline, 3 shapes and 3 masks) builds the edge
//     records (poly.cuh: the divisions are per edge, not per pixel) of the
//     outlines whose bbox reaches the strip's rows, and the rows mask of the
//     crossing test; one thread per line computes the line's constants;
//  B. once per tile, one warp per tile, one lane per edge or line: the near
//     mask of every live outline (reach lw/2 + 0.5, for masks the reach of
//     shape 0, which strokes them) and of the lines, by the conservative
//     segment-to-rectangle test, and from them the tile's plan.  A tile
//     nothing reaches is written white at once, as 16-byte words;
//  C. pixels, one warp per 4 rows of a tile (a warp is one row of 32
//     pixels), the row groups of the remaining tiles going round the warps.
//     Each edge record is loaded once for the 4 rows, whose chains are
//     independent.  The distance runs over the near edges only; the sign
//     (crossing parity, over the rows-mask edges) is computed only where it
//     is read: gradient fill, replace_boundary, the mask union.  A shape
//     with no near edge and no use for its sign is skipped, so are rows
//     outside an artist's bbox (uniform over the warp).  The 4 rows are
//     staged in shared memory and written as 16-byte words
//     (poly::store_rows).
//
// Why each cull is exact.  A skipped artist has alpha 0 at the pixel, and
// acc*(1-0) (+ col*0) returns acc bit for bit.  alpha*clip(lw/2 + 0.5 - d)
// is 0 from d = lw/2 + 0.5 on, whatever d is, so a distance taken over the
// near edges (equal to the true one below reach + margin, never smaller
// elsewhere, +inf for an empty mask) gives the same alpha; the argument for
// the masks is in poly.cuh.  For the mask union msk = min over masks of the
// signed distance: its sign is exact (parity is exact, and a zero distance
// lies within the margin), and |msk| is exact wherever it is below reach
// and no smaller than reach elsewhere, where band(|msk|) is 0 either way.
// The gradient is skipped where the pixel is outside (ga = 0:
// fma(acc, 1, col*0) = acc).
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

#include "poly.cuh"

namespace {

using poly::EdgeRec;

constexpr int NMETA = 20;
constexpr int NCOL = 8;
constexpr int NV = 64;
constexpr int MAX_SHAPES = 3;
constexpr int MAX_MASKS = 3;
constexpr int NOUT = MAX_SHAPES + MAX_MASKS;   // outlines: shapes, then masks
constexpr int MAX_LINES = 24;
constexpr int NLIN = 16;
constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int NTHREADS = TILE_W * TILE_H;
constexpr int NWARPS = TILE_H;
constexpr int STRIP = 4 * NWARPS;              // tiles per block, along x
constexpr int LINE_WARP = 2 * NOUT;            // the warp that owns the lines
constexpr int GROUP = 4;                       // rows staged per store

enum {
  R_MODE, R_MASK_VALID, R_VALID, R_BX0, R_BX1, R_BY0, R_BY1, R_LW, R_ALPHA,
  R_GRAD, R_GCX, R_GCY, R_GRMAX, R_GALPHA, R_C0, R_C1 = R_C0 + 3
};
enum {
  L_VALID, L_BX0, L_BX1, L_BY0, L_BY1, L_X0, L_Y0, L_X1, L_Y1, L_LW, L_ALPHA,
  L_RGB
};

// lw/2 + 0.5: the distance from which the stroke ramp is 0
__device__ __forceinline__ float reach(float lw) {
  return __fadd_rn(__fmul_rn(lw, 0.5f), 0.5f);
}

// alpha * clip(lw/2 + 0.5 - d, 0, 1): the Agg-calibrated stroke ramp
__device__ __forceinline__ float band(float lw, float alpha, float d) {
  return __fmul_rn(alpha, poly::clamp01(__fsub_rn(reach(lw), d)));
}

// Signed distance (negative inside) to an outline at GROUP pixels of one
// column: the distance over its near edges, the sign over its rows-mask
// edges where `sign` asks for it.
__device__ __forceinline__ void poly_sd(const EdgeRec* tab,
                                        const uint32_t* near,
                                        const uint32_t* rows, bool sign,
                                        float px, const float* py, float* sd) {
  float d2[GROUP];
  poly::min_d2<GROUP>(tab, near[0], near[1], px, py, d2);
  const uint32_t in =
      sign ? poly::inside<GROUP>(tab, rows[0], rows[1], px, py) : 0u;
#pragma unroll
  for (int r = 0; r < GROUP; ++r) {
    const float dist = __fsqrt_rn(d2[r]);
    sd[r] = ((in >> r) & 1u) ? -dist : dist;
  }
}

// A tile's plan, the same in every lane: bit s of P_SHAPE: shape s is
// evaluated; of P_SIGN: its crossing parity is read; P_RB: replace_boundary
// strokes the mask boundary; P_NEED_MASK: the mask union is read; P_TODO:
// the tile is not white and is left to the pixel phase.
constexpr uint32_t P_SHAPE = 1u, P_SIGN = 1u << MAX_SHAPES,
                   P_RB = 1u << (2 * MAX_SHAPES),
                   P_NEED_MASK = 1u << (2 * MAX_SHAPES + 1),
                   P_TODO = 1u << (2 * MAX_SHAPES + 2);

__global__ void __launch_bounds__(NTHREADS, 2)
mg_render_kernel(const float* __restrict__ meta, const float* __restrict__ svx,
                 const float* __restrict__ svy, const float* __restrict__ mvx,
                 const float* __restrict__ mvy, const float* __restrict__ lin,
                 uint8_t* __restrict__ out, int H, int W) {
  __shared__ float s_meta[NMETA * NCOL];
  __shared__ float s_lin[MAX_LINES * NLIN];
  __shared__ float4 s_lc[MAX_LINES];            // ex, ey, 1/(|e|^2 + 1e-9)
  __shared__ EdgeRec s_tab[NOUT][NV];
  __shared__ uint32_t s_live[NOUT];             // bbox reaches the strip's rows
  __shared__ uint32_t s_rows_mask[NOUT][2];
  __shared__ uint32_t s_lines_live;
  // per tile of the strip: the near masks, the plan (P_* bits), the lines
  __shared__ uint32_t s_near[STRIP][NOUT][2];
  __shared__ uint32_t s_plan[STRIP], s_lines_near[STRIP];
  __shared__ __align__(16) uint8_t s_stage[NWARPS][GROUP * poly::ROW_BYTES];

  const int n = blockIdx.z;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * TILE_W + lane;
  for (int i = tid; i < NMETA * NCOL; i += NTHREADS)
    s_meta[i] = meta[(size_t)n * NMETA * NCOL + i];
  for (int i = tid; i < MAX_LINES * NLIN; i += NTHREADS)
    s_lin[i] = lin[(size_t)n * MAX_LINES * NLIN + i];
  __syncthreads();

  const int y0 = blockIdx.y * TILE_H;
  const float ty0 = (float)y0;
  const float mode = s_meta[R_MODE * NCOL];
  const bool has_mask = mode > 0.0f;
  // the strip's pixel centres in y; the tile rectangle of the near test
  const float pymin = ty0 + 0.5f, pymax = ty0 + (TILE_H - 0.5f);
  const float rcy = ty0 + TILE_H * 0.5f, rhh = TILE_H * 0.5f - 0.5f;
  const float rhw = TILE_W * 0.5f - 0.5f;

  // ---- A. once per block: records and rows masks, one thread per edge
  if (warp < LINE_WARP) {
    const int o = warp >> 1, half = warp & 1;
    const int s = o < MAX_SHAPES ? o : 0;       // masks act on shape 0 only
    bool live = s_meta[R_VALID * NCOL + s] > 0.0f &&
                s_meta[R_BY1 * NCOL + s] >= ty0 &&
                s_meta[R_BY0 * NCOL + s] <= ty0 + TILE_H;
    if (o >= MAX_SHAPES)
      live = live && has_mask &&
             s_meta[R_MASK_VALID * NCOL + (o - MAX_SHAPES)] > 0.0f;
    bool spans = false;
    if (live) {                                 // uniform over the warp
      const size_t base = ((size_t)n * MAX_SHAPES + (o % MAX_SHAPES)) * NV;
      const float* vx = (o < MAX_SHAPES ? svx : mvx) + base;
      const float* vy = (o < MAX_SHAPES ? svy : mvy) + base;
      const EdgeRec r = poly::fill_edge(s_tab[o], vx, vy, NV, half * 32 + lane);
      spans = poly::edge_spans_rows(r.ay, r.by, pymin, pymax);
    }
    const uint32_t mask = __ballot_sync(0xffffffffu, spans);
    if (lane == 0) {
      s_rows_mask[o][half] = mask;
      if (half == 0) s_live[o] = live;
    }
  } else if (warp == LINE_WARP) {
    bool live = false;
    if (lane < MAX_LINES) {
      const float* l = s_lin + lane * NLIN;
      live = l[L_VALID] > 0.0f && l[L_BY1] >= ty0 && l[L_BY0] <= ty0 + TILE_H;
      const float ex = __fsub_rn(l[L_X1], l[L_X0]);
      const float ey = __fsub_rn(l[L_Y1], l[L_Y0]);
      const float inv = __fdiv_rn(
          1.0f, __fadd_rn(__fmaf_rn(ex, ex, __fmul_rn(ey, ey)), 1e-9f));
      s_lc[lane] = make_float4(ex, ey, inv, 0.0f);
    }
    const uint32_t mask = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_lines_live = mask;
  }
  __syncthreads();

  // ---- B. once per tile, one warp per tile: the near masks, one lane per
  // edge or line, and the tile's plan
  uint8_t* img = out + (size_t)n * H * W * 3;
  const uint32_t lines_live = s_lines_live;
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int t0 = blockIdx.x * STRIP;
  const int nt = min(tiles_x - t0, STRIP);
  for (int ti = warp; ti < nt; ti += NWARPS) {
    const float tx0 = (float)((t0 + ti) * TILE_W);
    const float rcx = tx0 + TILE_W * 0.5f;
    uint32_t near_any = 0;                  // bit o: outline o has a near edge
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      const int s = o < MAX_SHAPES ? o : 0;
      uint32_t lo = 0, hi = 0;
      if (s_live[o] && s_meta[R_BX1 * NCOL + s] >= tx0 &&
          s_meta[R_BX0 * NCOL + s] <= tx0 + TILE_W) {
        const float R = reach(s_meta[R_LW * NCOL + s]) + poly::NEAR_MARGIN;
        const EdgeRec a = s_tab[o][lane], b = s_tab[o][32 + lane];
        lo = __ballot_sync(0xffffffffu, poly::seg_near_rect(
            a.ax, a.ay, a.bx, a.by, rcx, rcy, rhw, rhh, R));
        hi = __ballot_sync(0xffffffffu, poly::seg_near_rect(
            b.ax, b.ay, b.bx, b.by, rcx, rcy, rhw, rhh, R));
      }
      if (lane == 0) {
        s_near[ti][o][0] = lo;
        s_near[ti][o][1] = hi;
      }
      near_any |= ((lo | hi) != 0 ? 1u : 0u) << o;
    }
    bool ln = false;
    if (lane < MAX_LINES && ((lines_live >> lane) & 1u)) {
      const float* l = s_lin + lane * NLIN;
      ln = l[L_BX1] >= tx0 && l[L_BX0] <= tx0 + TILE_W &&
           poly::seg_near_rect(l[L_X0], l[L_Y0], l[L_X1], l[L_Y1], rcx, rcy,
                               rhw, rhh, reach(l[L_LW]) + poly::NEAR_MARGIN);
    }
    const uint32_t lines_near = __ballot_sync(0xffffffffu, ln);
    uint32_t plan = 0;
    bool rb = false;
#pragma unroll
    for (int s = 0; s < MAX_SHAPES; ++s) {
      const bool hit = s_live[s] && s_meta[R_BX1 * NCOL + s] >= tx0 &&
                       s_meta[R_BX0 * NCOL + s] <= tx0 + TILE_W;
      // replace_boundary strokes the mask boundary inside shape 0
      if (s == 0) rb = hit && mode == 2.0f && (near_any >> MAX_SHAPES) != 0;
      const bool sign = s_meta[R_GRAD * NCOL + s] > 0.0f || (s == 0 && rb);
      if (sign) plan |= P_SIGN << s;
      if (hit && (((near_any >> s) & 1u) || sign)) plan |= P_SHAPE << s;
    }
    if (rb) plan |= P_RB;
    if (has_mask && (plan & P_SHAPE) && ((near_any & 1u) || rb))
      plan |= P_NEED_MASK;
    // a tile nothing reaches is written white here and now (P_TODO clear)
    const int x0 = (t0 + ti) * TILE_W;
    if ((plan & (P_SHAPE * 7u)) == 0 && lines_near == 0 &&
        poly::tile_aligned(img, W, x0)) {
      poly::store_white(img, W, H, x0, y0, TILE_H, lane);
    } else {
      plan |= P_TODO;
    }
    if (lane == 0) {
      s_plan[ti] = plan;
      s_lines_near[ti] = lines_near;
    }
  }
  __syncthreads();

  // ---- C. pixels: one warp per GROUP rows of a tile; the row groups of the
  // tiles left to do go round the warps, so a busy tile is shared out
  uint8_t* stage = s_stage[warp];
  int unit = 0;
  for (int ti = 0; ti < nt; ++ti) {
    const uint32_t plan = s_plan[ti];
    if (!(plan & P_TODO)) continue;         // written in B
    for (int g = 0; g < TILE_H; g += GROUP) {
      if (unit++ % NWARPS != warp) continue;
      const int x0 = (t0 + ti) * TILE_W;
      const uint32_t (*near)[2] = s_near[ti];
      const bool rb = plan & P_RB;
      const float px = __fadd_rn((float)(x0 + lane), 0.5f);   // pixel centres
      float py[GROUP], acc[GROUP][3], msk[GROUP];
#pragma unroll
      for (int r = 0; r < GROUP; ++r) {
        py[r] = __fadd_rn((float)(y0 + g + r), 0.5f);
        acc[r][0] = acc[r][1] = acc[r][2] = 255.0f;
        msk[r] = 1e9f;
      }

      // mask-union SDF: read only by shape 0
      if (plan & P_NEED_MASK) {
        for (int o = MAX_SHAPES; o < NOUT; ++o) {
          if (!s_live[o]) continue;
          float sd[GROUP];
          poly_sd(s_tab[o], near[o], s_rows_mask[o], true, px, py, sd);
#pragma unroll
          for (int r = 0; r < GROUP; ++r) msk[r] = fminf(msk[r], sd[r]);
        }
      }

      for (int s = 0; s < MAX_SHAPES; ++s) {
        if (!(plan & (P_SHAPE << s))) continue;   // the tile cull
        const float by0 = s_meta[R_BY0 * NCOL + s];
        const float by1 = s_meta[R_BY1 * NCOL + s];
        if (py[GROUP - 1] < by0 || py[0] > by1) continue;   // the row cull
        const bool grad = s_meta[R_GRAD * NCOL + s] > 0.0f;
        const float lw = s_meta[R_LW * NCOL + s];
        const float alpha = s_meta[R_ALPHA * NCOL + s];
        float sd4[GROUP];
        poly_sd(s_tab[s], near[s], s_rows_mask[s], plan & (P_SIGN << s), px,
                py, sd4);
#pragma unroll
        for (int r = 0; r < GROUP; ++r) {
          // uniform over the warp: a row outside the bbox keeps its colour
          if (py[r] < by0 || py[r] > by1) continue;
          const float sd = sd4[r];
          float a = band(lw, alpha, fabsf(sd));
          if (s == 0) {
            const float hm = has_mask ? 1.0f : 0.0f;
            const float cut = (msk[r] <= 0.0f) ? 1.0f : 0.0f;
            a = __fmul_rn(a, __fsub_rn(1.0f, __fmul_rn(hm, cut)));
          }
          if (grad && sd < 0.0f) {
            // radial gradient fill inside the shape, under its stroke
            const float dx = __fsub_rn(px, s_meta[R_GCX * NCOL + s]);
            const float dy = __fsub_rn(py[r], s_meta[R_GCY * NCOL + s]);
            const float tfrac = poly::clamp01(__fdiv_rn(
                __fsqrt_rn(__fmaf_rn(dx, dx, __fmul_rn(dy, dy))),
                s_meta[R_GRMAX * NCOL + s]));
            const float ga = __fmul_rn(1.0f, s_meta[R_GALPHA * NCOL + s]);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float col = __fmaf_rn(
                  s_meta[(R_C0 + c) * NCOL + s], __fsub_rn(1.0f, tfrac),
                  __fmul_rn(s_meta[(R_C1 + c) * NCOL + s], tfrac));
              acc[r][c] = __fmaf_rn(acc[r][c], __fsub_rn(1.0f, ga),
                                    __fmul_rn(col, ga));
            }
          }
#pragma unroll
          for (int c = 0; c < 3; ++c)
            acc[r][c] = __fmul_rn(acc[r][c], __fsub_rn(1.0f, a));
          if (s == 0 && rb) {
            const float ma = __fmul_rn(band(lw, alpha, fabsf(msk[r])),
                                       sd < 0.0f ? 1.0f : 0.0f);
#pragma unroll
            for (int c = 0; c < 3; ++c)
              acc[r][c] = __fmul_rn(acc[r][c], __fsub_rn(1.0f, ma));
          }
        }
      }

      for (uint32_t lm = s_lines_near[ti]; lm; lm &= lm - 1) {
        const int k = __ffs(lm) - 1;
        const float* l = s_lin + k * NLIN;
        const float4 c4 = s_lc[k];
        const float x0l = l[L_X0], y0l = l[L_Y0];
        const float pxe = __fsub_rn(px, x0l);
#pragma unroll
        for (int r = 0; r < GROUP; ++r) {
          // uniform over the warp: the row cull
          if (py[r] < l[L_BY0] || py[r] > l[L_BY1]) continue;
          const float tt = poly::clamp01(__fmul_rn(
              __fmaf_rn(pxe, c4.x, __fmul_rn(__fsub_rn(py[r], y0l), c4.y)),
              c4.z));
          const float dx = __fsub_rn(px, __fmaf_rn(tt, c4.x, x0l));
          const float dy = __fsub_rn(py[r], __fmaf_rn(tt, c4.y, y0l));
          const float a =
              band(l[L_LW], l[L_ALPHA],
                   __fsqrt_rn(__fmaf_rn(dx, dx, __fmul_rn(dy, dy))));
#pragma unroll
          for (int c = 0; c < 3; ++c)
            acc[r][c] = __fmaf_rn(acc[r][c], __fsub_rn(1.0f, a),
                                  __fmul_rn(l[L_RGB + c], a));
        }
      }

#pragma unroll
      for (int r = 0; r < GROUP; ++r)
        poly::stage_pixel(stage, r, lane, acc[r]);
      __syncwarp();
      poly::store_rows(stage, img, W, H, x0, y0 + g, GROUP, lane);
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int rig_mg_render(const float* meta, const float* svx,
                             const float* svy, const float* mvx,
                             const float* mvy, const float* lin, uint8_t* out,
                             int N, int H, int W, void* stream) {
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int tiles_y = (H + TILE_H - 1) / TILE_H;
  if (N <= 0 || H <= 0 || W <= 0 || N > 65535 || tiles_y > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 block(TILE_W, TILE_H);
  dim3 grid((tiles_x + STRIP - 1) / STRIP, tiles_y, N);
  mg_render_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      meta, svx, svy, mvx, mvy, lin, out, H, W);
  return (int)cudaGetLastError();
}
