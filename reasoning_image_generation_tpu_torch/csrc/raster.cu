// raster.cu — RPM frame rasterizer (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel render_batch_pallas
// (reasoning_image_generation_tpu/ops/raster_pallas.py, kernel body
// _make_kernel).  Inputs come from ops/raster.py::prepare_render_data:
// meta f32 [N, E, 20], vx/vy f32 [N, E, 2, 64], use_grid bool [N]; the grid
// line positions come as kernel arguments; output is u8 NHWC [N, H, W, 3],
// written directly (no padding, transpose or crop).
//
// Bound.  The 3 bytes a pixel of output (201 MB for 256 frames of 512x512,
// 60 us at 3.35 TB/s) bound the kernel; the float32 work that is left after
// the culls below is a tenth of that.  What holds the kernel above its bound
// is latency: little work, in few places.  Inputs are 9 KB a frame.  Tensor
// cores do not fit (no matrix product; bit-exact float32 distance and
// parity), nor does TMA (the inputs are read once per block, the output is
// produced in registers and written once).
//
// Design.  One block of 8 warps per strip of 16 32x32 tiles of one frame, in
// three phases with a block barrier between them and none inside:
//  A. once per block, one warp per element: the wrapped y of each of the 32
//     rows (one fmodf per row, not per pixel), the rows the element can
//     touch (inside its bbox and inside the 3x3 wrap gate) as a 32-bit mask,
//     the edge records of its outlines (poly.cuh: the divisions are per
//     edge, not per pixel) and the rows mask of the crossing test;
//  B. once per tile, one warp per tile: the wrapped x of each column, the
//     columns inside the wrap gate, the tile's extent in wrapped coordinates
//     and from it the near mask of each outline.  A tile that no element and
//     no grid line touches is written white at once, as 16-byte words;
//  C. pixels, one warp per 4 rows of a tile (a warp is one row of 32 pixels;
//     the 8 row groups of a busy tile go to the 8 warps, because one warp
//     alone on a busy tile leaves the others idle).  Elements outer, the 4
//     rows inner, 12 accumulators in registers; each edge record is loaded
//     once for the 4 rows, whose chains are independent.  Rows outside the
//     element's mask are skipped (uniform over the warp), the distance runs
//     over the near edges, the crossing count over the rows-mask edges and
//     only for filled elements.  The 4 rows are staged in shared memory and
//     written as 16-byte words (poly::store_rows).
//
// Why each cull is exact.  Outside an element's bbox (outline, stroke band
// and a margin of at least 3 px) and where the wrap gate is shut, fill alpha
// and stroke alpha are 0 and the composite acc*(1-0) + col*0, then *(1-0),
// returns acc bit for bit, so skipping it moves no byte.  The bbox test is
// made on the very wrapped coordinates the element is evaluated at.  The
// near and rows masks are argued in poly.cuh; K1's reach is band + 0.28,
// where the ramp has reached 0 (NEAR_MARGIN covers the last place by which
// (band - 1) + 1.28 may differ from it).
//
// Numerics.  The result must equal the plain PyTorch version byte for
// byte, so the source keeps its operation order, uses IEEE division and
// square root, and is built with -fmad=false so that the compiler fuses
// nothing on its own.  The fused multiply-adds that XLA's CPU backend forms
// in the JAX package (see ops/raster.py) are written out as __fmaf_rn at the
// same sites.  The floored mod is fmodf plus the sign fix-up torch.remainder
// and jnp.mod both use; rounding to u8 is rintf (half to even, as
// torch.round).
#include <cuda_runtime.h>
#include <stdint.h>

#include "poly.cuh"

constexpr int MAX_GRID_LINES = 15;

// x and y positions of the interior grid lines: a kernel argument, by value
struct GridLines {
  int nx, ny;
  float x[MAX_GRID_LINES], y[MAX_GRID_LINES];
};

namespace {

using poly::EdgeRec;

constexpr int NMETA = 20;
constexpr int MAXV = 64;
constexpr int SMALL_V = 8;
constexpr int MAX_E = 16;
constexpr int TILE = 32;              // tile width and height, one warp wide
constexpr int NWARPS = 8;
constexpr int NTHREADS = TILE * NWARPS;
constexpr int GROUP = 4;              // rows a lane holds at once, and stages
constexpr int STRIP = 2 * NWARPS;     // tiles per block, along x
constexpr int REC_PER_E = MAXV + SMALL_V;   // part 0, then part 1 ('plus')

enum {
  M_VALID, M_FILL, M_STROKE, M_R, M_G, M_B, M_CIRCLE, M_CRESCENT, M_CX, M_CY,
  M_ROUT, M_ICX, M_ICY, M_RIN, M_HASP1, M_BX0, M_BX1, M_BY0, M_BY1, M_SMALL
};

__device__ __forceinline__ float floored_mod(float x, float y) {
  float m = fmodf(x, y);
  if (m != 0.0f && ((y < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, y);
  return m;
}

// c + mod(p - c + half, size) - half: p moved by whole canvases to within
// half a canvas of c
__device__ __forceinline__ float wrapped(float p, float c, float half,
                                         float size) {
  return __fsub_rn(
      __fadd_rn(c, floored_mod(__fadd_rn(__fsub_rn(p, c), half), size)), half);
}

// band is ceil(t/2) + 1; the ramp is the jnp renderer's
// clip((r_full + 1.28 - d)/1.28) with r_full = band - 1, which in float32 is
// not band + 0.28 from band 4 (strokes 5 and 6) on
__device__ __forceinline__ float stroke_alpha(float band, float d) {
  return poly::clamp01(
      __fmul_rn(__fsub_rn(__fadd_rn(__fsub_rn(band, 1.0f), 1.28f), d),
                0.78125f));  // 1/1.28, exact in binary
}

__device__ __forceinline__ float circle_dist(float px, float py, float cx,
                                             float cy, float r) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  return __fsub_rn(__fsqrt_rn(__fmaf_rn(dx, dx, __fmul_rn(dy, dy))), r);
}

__device__ __forceinline__ void composite(float acc[3], const float* m,
                                          float fa, float sa, float wrap_ok) {
  const float a = __fmul_rn(__fmul_rn(fa, m[M_FILL]), wrap_ok);
  const float s = __fmul_rn(sa, wrap_ok);
  const float col[3] = {m[M_R], m[M_G], m[M_B]};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = __fadd_rn(__fmul_rn(acc[c], __fsub_rn(1.0f, a)),
                        __fmul_rn(col[c], a));
    acc[c] = __fmul_rn(v, __fsub_rn(1.0f, s));
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// edges of mask chunk c: chunks 0 and 1 are the halves of part 0 (nv
// edges), chunk 2 is part 1 (8 edges, 'plus' only), chunk 3 stays empty
__device__ __forceinline__ int part_edges(int c, int nv, bool has_p1) {
  return c < 2 ? nv : ((c == 2 && has_p1) ? SMALL_V : 0);
}

// fill alpha and stroke alpha of one outline part at the wrapped pixels of
// GROUP rows of one column
__device__ __forceinline__ void poly_part(const EdgeRec* tab,
                                          const uint32_t* near,
                                          const uint32_t* rows, bool filled,
                                          float band, float pxw,
                                          const float* pyw, float* fa,
                                          float* sa) {
  float d2[GROUP];
  poly::min_d2<GROUP>(tab, near[0], near[1], pxw, pyw, d2);
  const uint32_t in =
      filled ? poly::inside<GROUP>(tab, rows[0], rows[1], pxw, pyw) : 0u;
#pragma unroll
  for (int r = 0; r < GROUP; ++r) {
    sa[r] = stroke_alpha(band, __fsqrt_rn(d2[r]));
    fa[r] = ((in >> r) & 1u) ? 1.0f : 0.0f;
  }
}

// dynamic shared memory: the edge records, then per tile of the strip the
// wrapped x of each column, the near masks and the columns inside the gate
__host__ __device__ constexpr size_t dyn_bytes(int E) {
  return (size_t)E * (REC_PER_E * sizeof(EdgeRec) +
                      STRIP * (TILE * sizeof(float) + 5 * sizeof(uint32_t)));
}

__global__ void __launch_bounds__(NTHREADS, 4)
raster_kernel(const float* __restrict__ meta, const float* __restrict__ vxg,
              const float* __restrict__ vyg,
              const uint8_t* __restrict__ use_grid, const GridLines lines,
              uint8_t* __restrict__ out, int E, int W, int H) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  EdgeRec* s_tab = reinterpret_cast<EdgeRec*>(s_dyn);   // [E][REC_PER_E]
  float* s_pxw = reinterpret_cast<float*>(s_tab + E * REC_PER_E);
  uint32_t* s_near = reinterpret_cast<uint32_t*>(s_pxw + STRIP * E * TILE);
  uint32_t* s_cols_ok = s_near + STRIP * E * 4;         // [STRIP][E]
  __shared__ float s_meta[MAX_E * NMETA];
  __shared__ float s_pyw[MAX_E][TILE];
  __shared__ float s_ymin[MAX_E], s_ymax[MAX_E];
  __shared__ uint32_t s_rows_live[MAX_E];
  // edge masks per element: part 0 low and high half, part 1, empty
  __shared__ uint32_t s_rows_mask[MAX_E][4];
  __shared__ float s_lines_x[MAX_GRID_LINES], s_lines_y[MAX_GRID_LINES];
  // per tile of the strip: the elements that reach it, the row groups to do
  __shared__ uint32_t s_hits[STRIP], s_todo[STRIP];
  __shared__ __align__(16) uint8_t s_stage[NWARPS][GROUP * poly::ROW_BYTES];

  const int n = blockIdx.z;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * TILE + lane;
  const float* m_src = meta + (size_t)n * E * NMETA;
  for (int i = tid; i < E * NMETA; i += NTHREADS) s_meta[i] = m_src[i];
#pragma unroll
  for (int i = 0; i < MAX_GRID_LINES; ++i)   // static indices into the argument
    if (tid == i) {
      s_lines_x[i] = lines.x[i];
      s_lines_y[i] = lines.y[i];
    }
  __syncthreads();

  const float Wf = (float)W, Hf = (float)H;
  const float hw = 0.5f * Wf, hh = 0.5f * Hf;
  const int y0 = blockIdx.y * TILE;

  // ---- A. once per block, one warp per element: rows, records, rows masks
  for (int e = warp; e < E; e += NWARPS) {
    const float* m = s_meta + e * NMETA;
    const int y = y0 + lane;
    const float py = (float)y;
    const float pyw = wrapped(py, m[M_CY], hh, Hf);
    // reference wrap parity: only the 3x3 periodic copies exist
    const bool row_ok = m[M_VALID] > 0.0f && y < H &&
                        fabsf(__fsub_rn(py, pyw)) <= Hf &&
                        pyw >= m[M_BY0] && pyw <= m[M_BY1];
    s_pyw[e][lane] = pyw;
    const uint32_t live = __ballot_sync(0xffffffffu, row_ok);
    const float ymin = warp_min(row_ok ? pyw : __int_as_float(0x7f800000));
    const float ymax = warp_max(row_ok ? pyw : __int_as_float(0xff800000));
    if (lane == 0) {
      s_rows_live[e] = live;
      s_ymin[e] = ymin;
      s_ymax[e] = ymax;
    }
    const bool is_poly = !(m[M_CIRCLE] > 0.0f) && !(m[M_CRESCENT] > 0.0f);
    if (live == 0 || !is_poly) continue;    // uniform over the warp
    EdgeRec* tab = s_tab + e * REC_PER_E;
    const float* vx = vxg + ((size_t)n * E + e) * 2 * MAXV;
    const float* vy = vyg + ((size_t)n * E + e) * 2 * MAXV;
    const int nv = m[M_SMALL] > 0.0f ? SMALL_V : MAXV;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // chunk c: edges 0-31 and 32-63 of part 0, edges 0-7 of part 1, none
      const int np = part_edges(c, nv, m[M_HASP1] > 0.0f);
      const int k = (c == 1) ? lane + 32 : lane;
      bool spans = false;
      if (k < np) {
        const int off = (c < 2) ? 0 : MAXV;
        const EdgeRec r = poly::fill_edge(tab + off, vx + off, vy + off, np, k);
        spans = poly::edge_spans_rows(r.ay, r.by, ymin, ymax);
      }
      const uint32_t mask = __ballot_sync(0xffffffffu, spans);
      if (lane == 0) s_rows_mask[e][c] = mask;
    }
  }
  __syncthreads();

  // ---- B. once per tile, one warp per tile: columns, near masks
  uint8_t* img = out + (size_t)n * H * W * 3;
  constexpr int GROUPS = TILE / GROUP;
  const bool grid_on = use_grid[n] != 0;
  const int tiles_x = (W + TILE - 1) / TILE;
  const int t0 = blockIdx.x * STRIP;
  const int nt = min(tiles_x - t0, STRIP);
  for (int ti = warp; ti < nt; ti += NWARPS) {
    const int x = (t0 + ti) * TILE + lane;
    const float px = (float)x;
    uint32_t hits = 0, rows_busy = 0;
    for (int e = 0; e < E; ++e) {
      const uint32_t live = s_rows_live[e];
      if (live == 0) continue;              // uniform over the block
      const float* m = s_meta + e * NMETA;
      const float pxw = wrapped(px, m[M_CX], hw, Wf);
      const bool col_ok = x < W && fabsf(__fsub_rn(px, pxw)) <= Wf;
      const bool col_in = col_ok && pxw >= m[M_BX0] && pxw <= m[M_BX1];
      const uint32_t ok = __ballot_sync(0xffffffffu, col_ok);
      const uint32_t in = __ballot_sync(0xffffffffu, col_in);
      if (in == 0) continue;                // uniform over the warp
      hits |= 1u << e;
      rows_busy |= live;
      s_pxw[(ti * E + e) * TILE + lane] = pxw;
      if (lane == 0) s_cols_ok[ti * E + e] = ok;
      const bool is_poly = !(m[M_CIRCLE] > 0.0f) && !(m[M_CRESCENT] > 0.0f);
      if (!is_poly) continue;
      const float xmin = warp_min(col_in ? pxw : __int_as_float(0x7f800000));
      const float xmax = warp_max(col_in ? pxw : __int_as_float(0xff800000));
      const float ymin = s_ymin[e], ymax = s_ymax[e];
      const float cx = (xmin + xmax) * 0.5f, cy = (ymin + ymax) * 0.5f;
      const float rw = (xmax - xmin) * 0.5f, rh = (ymax - ymin) * 0.5f;
      const float R = __fadd_rn(m[M_STROKE], 0.28f) + poly::NEAR_MARGIN;
      const EdgeRec* tab = s_tab + e * REC_PER_E;
      const int nv = m[M_SMALL] > 0.0f ? SMALL_V : MAXV;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int np = part_edges(c, nv, m[M_HASP1] > 0.0f);
        const int k = (c == 1) ? lane + 32 : lane;
        bool near = false;
        if (k < np) {
          const EdgeRec r = tab[(c < 2 ? 0 : MAXV) + k];
          near = poly::seg_near_rect(r.ax, r.ay, r.bx, r.by, cx, cy, rw, rh, R);
        }
        const uint32_t mask = __ballot_sync(0xffffffffu, near);
        if (lane == 0) s_near[(ti * E + e) * 4 + c] = mask;
      }
    }
    // rows a grid line can touch: all where a vertical line crosses the tile
    if (grid_on) {
      bool on_x = false;
      for (int i = 0; i < lines.nx; ++i) on_x |= (px == s_lines_x[i]);
      if (__any_sync(0xffffffffu, on_x)) rows_busy = ~0u;
      for (int i = 0; i < lines.ny; ++i) {
        const float r = s_lines_y[i] - (float)y0;
        if (r >= 0.0f && r < (float)TILE) rows_busy |= 1u << (int)r;
      }
    }
    // a tile nothing touches is written white here and now; bit GROUPS of
    // s_todo stays clear, so does bit g where rows g*GROUP.. are white
    uint32_t todo = 0;
    const int x0 = (t0 + ti) * TILE;
    if (rows_busy == 0 && poly::tile_aligned(img, W, x0)) {
      poly::store_white(img, W, H, x0, y0, TILE, lane);
    } else {
      todo = 1u << GROUPS;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g)
        if ((rows_busy >> (g * GROUP)) & ((1u << GROUP) - 1)) todo |= 1u << g;
    }
    if (lane == 0) {
      s_hits[ti] = hits;
      s_todo[ti] = todo;
    }
  }
  __syncthreads();

  // ---- C. pixels: one warp per GROUP rows of a tile, so that the 8 groups
  // of a busy tile go to the 8 warps; elements outer, the rows inner
  uint8_t* stage = s_stage[warp];
  static_assert(GROUPS == NWARPS, "warp w takes row group w of every tile");
  const int g = warp * GROUP;
  for (int ti = 0; ti < nt; ++ti) {
    const uint32_t todo = s_todo[ti];
    if (todo == 0) continue;                // written in B
    const int x0 = (t0 + ti) * TILE;
    if (!((todo >> warp) & 1u) && poly::tile_aligned(img, W, x0)) {
      poly::store_white(img, W, H, x0, y0 + g, GROUP, lane);
      continue;
    }
    float acc[GROUP][3];
#pragma unroll
    for (int r = 0; r < GROUP; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = 255.0f;

    for (uint32_t hm = s_hits[ti]; hm; hm &= hm - 1) {
      const int e = __ffs(hm) - 1;
      const uint32_t rows_live = (s_rows_live[e] >> g) & ((1u << GROUP) - 1);
      if (rows_live == 0) continue;         // uniform over the warp
      const float* m = s_meta + e * NMETA;
      const float pxw = s_pxw[(ti * E + e) * TILE + lane];
      const float wrap_ok =
          ((s_cols_ok[ti * E + e] >> lane) & 1u) ? 1.0f : 0.0f;
      const float cx = m[M_CX], cy = m[M_CY], band = m[M_STROKE];
      const bool is_circle = m[M_CIRCLE] > 0.0f;
      const bool is_crescent = m[M_CRESCENT] > 0.0f;
      const bool filled = m[M_FILL] != 0.0f;
      const bool has_p1 = m[M_HASP1] > 0.0f;
      const EdgeRec* tab = s_tab + e * REC_PER_E;
      const uint32_t* near = s_near + (ti * E + e) * 4;
      float pyw[GROUP], fa[GROUP], sa[GROUP];
#pragma unroll
      for (int r = 0; r < GROUP; ++r) pyw[r] = s_pyw[e][g + r];
      if (is_circle) {
#pragma unroll
        for (int r = 0; r < GROUP; ++r) {
          const float d = circle_dist(pxw, pyw[r], cx, cy, m[M_ROUT]);
          fa[r] = d < 0.0f ? 1.0f : 0.0f;
          sa[r] = stroke_alpha(band, fabsf(d));
        }
      } else if (is_crescent) {
#pragma unroll
        for (int r = 0; r < GROUP; ++r) {
          const float d_out = circle_dist(pxw, pyw[r], cx, cy, m[M_ROUT]);
          const float d_in =
              circle_dist(pxw, pyw[r], m[M_ICX], m[M_ICY], m[M_RIN]);
          fa[r] = (d_out < 0.0f && d_in >= 0.0f) ? 1.0f : 0.0f;
          sa[r] = fmaxf(stroke_alpha(band, fabsf(d_out)),
                        stroke_alpha(band, fabsf(d_in)));
        }
      } else {
        poly_part(tab, near, s_rows_mask[e], filled, band, pxw, pyw, fa, sa);
      }
      // rows outside the element's mask keep their colour (uniform over
      // the warp)
#pragma unroll
      for (int r = 0; r < GROUP; ++r)
        if ((rows_live >> r) & 1u) composite(acc[r], m, fa[r], sa[r], wrap_ok);
      if (has_p1) {
        // part 1 exists only for 'plus' (two 4-vertex rectangles)
        poly_part(tab + MAXV, near + 2, s_rows_mask[e] + 2, filled, band, pxw,
                  pyw, fa, sa);
#pragma unroll
        for (int r = 0; r < GROUP; ++r)
          if ((rows_live >> r) & 1u)
            composite(acc[r], m, fa[r], sa[r], wrap_ok);
      }
    }

    bool on_x = false;
    if (grid_on) {
      const float px = (float)(x0 + lane);
      for (int i = 0; i < lines.nx; ++i) on_x |= (px == s_lines_x[i]);
    }
#pragma unroll
    for (int r = 0; r < GROUP; ++r) {
      if (grid_on) {
        bool on = on_x;
        const float py = (float)(y0 + g + r);
        for (int i = 0; i < lines.ny; ++i) on |= (py == s_lines_y[i]);
        const float keep = on ? 0.0f : 1.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[r][c] = __fmul_rn(acc[r][c], keep);
      }
      poly::stage_pixel(stage, r, lane, acc[r]);
    }
    __syncwarp();
    poly::store_rows(stage, img, W, H, x0, y0 + g, GROUP, lane);
    __syncwarp();
  }
}

}  // namespace

extern "C" int rig_raster_render(const float* meta, const float* vx,
                                 const float* vy, const uint8_t* use_grid,
                                 GridLines lines, uint8_t* out, int N, int E,
                                 int W, int H, void* stream) {
  if (E <= 0 || E > MAX_E || N <= 0 || N > 65535 || W <= 0 || H <= 0 ||
      lines.nx < 0 || lines.nx > MAX_GRID_LINES || lines.ny < 0 ||
      lines.ny > MAX_GRID_LINES)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  if (tiles_y > 65535) return (int)cudaErrorInvalidValue;
  // many element slots need more than the 48 KB a kernel gets unasked;
  // the attribute belongs to the current card, so it is set at every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      raster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn_bytes(MAX_E));
  if (attr != cudaSuccess) return (int)attr;
  dim3 block(TILE, NWARPS);
  dim3 grid((tiles_x + STRIP - 1) / STRIP, tiles_y, N);
  raster_kernel<<<grid, block, dyn_bytes(E), (cudaStream_t)stream>>>(
      meta, vx, vy, use_grid, lines, out, E, W, H);
  return (int)cudaGetLastError();
}
