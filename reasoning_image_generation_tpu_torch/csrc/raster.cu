// raster.cu — RPM frame rasterizer (K1) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel render_batch_pallas
// (reasoning_image_generation_tpu/ops/raster_pallas.py, kernel body
// _make_kernel).  Inputs come from ops/raster.py::prepare_render_data:
// meta f32 [N, E, 20], vx/vy f32 [N, E, 2, 64], use_grid u8 [N]; output is
// u8 NHWC [N, H, W, 3], written directly (no padding, transpose or crop).
//
// Design.  One block per (frame, 32x32 pixel tile), 256 threads, each
// thread owning 4 pixels of one column.  The block stages its frame's meta
// and outlines (~9 KB at E = 8) in shared memory, then culls each element
// once for the whole tile with the conservative bbox test in the wrap-around
// metric (a uniform branch).  Each thread walks the surviving elements in
// painter's order and keeps its r, g, b accumulators in registers.
//
// Bound.  Per pixel the work is the polygon edge loop: ~20 flops and one
// IEEE division per edge, 8 edges for most kinds and 64 for heart and
// rounded_square, over the elements that survive culling.  Output is 3
// bytes a pixel (200 MB for 256 frames of 512x512), so the kernel is
// bound by FP32 issue, not by memory; culling is what cuts the work.
//
// Numerics.  The result must equal the plain PyTorch version byte for
// byte, so the source keeps its operation order, uses IEEE division and
// square root, and is built with -fmad=false so that the compiler fuses
// nothing on its own: inv = 1/(ex^2 + ey^2 + 1e-9) then a multiply;
// ex/safe_ey then a multiply; the stroke ramp times (1/1.28).  The fused
// multiply-adds that XLA's CPU backend forms in the JAX package (see
// ops/raster.py) are written out as __fmaf_rn at the same sites.  The
// floored mod is fmodf plus the sign fix-up torch.remainder and jnp.mod
// both use; rounding to u8 is rintf (half to even, as torch.round).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NMETA = 20;
constexpr int MAXV = 64;
constexpr int SMALL_V = 8;
constexpr int MAX_E = 16;
constexpr int TILE_W = 32;
constexpr int TILE_H = 32;
constexpr int THREADS_Y = 8;
constexpr int ROWS = TILE_H / THREADS_Y;

enum {
  M_VALID, M_FILL, M_STROKE, M_R, M_G, M_B, M_CIRCLE, M_CRESCENT, M_CX, M_CY,
  M_ROUT, M_ICX, M_ICY, M_RIN, M_HASP1, M_BX0, M_BX1, M_BY0, M_BY1, M_SMALL
};

__device__ __forceinline__ float floored_mod(float x, float y) {
  float m = fmodf(x, y);
  if (m != 0.0f && ((y < 0.0f) != (m < 0.0f))) m = __fadd_rn(m, y);
  return m;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float stroke_alpha(float band, float d) {
  return clamp01(__fmul_rn(__fsub_rn(__fadd_rn(band, 0.28f), d),
                           0.78125f));  // 1/1.28, exact in binary
}

// Edge loop over the first n vertices of one outline part, closing back to
// vertex 0: min squared distance and crossing parity at (px, py).
__device__ __forceinline__ void poly_field(const float* vx, const float* vy,
                                           int n, float px, float py,
                                           float* d2_out, bool* inside) {
  float d2 = __int_as_float(0x7f800000);  // +inf
  int cross = 0;
  for (int k = 0; k < n; ++k) {
    const int kb = (k == n - 1) ? 0 : k + 1;
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
  *d2_out = d2;
  *inside = (cross % 2) == 1;
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

__global__ void __launch_bounds__(TILE_W * THREADS_Y)
raster_kernel(const float* __restrict__ meta, const float* __restrict__ vxg,
              const float* __restrict__ vyg,
              const uint8_t* __restrict__ use_grid,
              const float* __restrict__ lines, int n_xlines, int n_ylines,
              uint8_t* __restrict__ out, int E, int W, int H) {
  __shared__ float s_meta[MAX_E * NMETA];
  __shared__ float s_vx[MAX_E * 2 * MAXV];
  __shared__ float s_vy[MAX_E * 2 * MAXV];
  __shared__ int s_hit[MAX_E];

  const int n = blockIdx.z;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int nthreads = TILE_W * THREADS_Y;
  const float* m_src = meta + (size_t)n * E * NMETA;
  const float* vx_src = vxg + (size_t)n * E * 2 * MAXV;
  const float* vy_src = vyg + (size_t)n * E * 2 * MAXV;
  for (int i = tid; i < E * NMETA; i += nthreads) s_meta[i] = m_src[i];
  for (int i = tid; i < E * 2 * MAXV; i += nthreads) {
    s_vx[i] = vx_src[i];
    s_vy[i] = vy_src[i];
  }
  __syncthreads();

  const float Wf = (float)W, Hf = (float)H;
  const float hw = 0.5f * Wf, hh = 0.5f * Hf;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  if (tid < E) {
    // tile culling in the wrap-around metric (conservative: the bbox holds
    // the outline plus the stroke band plus one pixel)
    const float* m = s_meta + tid * NMETA;
    const float ecx = (m[M_BX0] + m[M_BX1]) * 0.5f;
    const float ecy = (m[M_BY0] + m[M_BY1]) * 0.5f;
    const float ehw = (m[M_BX1] - m[M_BX0]) * 0.5f;
    const float ehh = (m[M_BY1] - m[M_BY0]) * 0.5f;
    const float tcx = (float)x0 + TILE_W * 0.5f;
    const float tcy = (float)y0 + TILE_H * 0.5f;
    const float dxw = fabsf(floored_mod(tcx - ecx + hw, Wf) - hw);
    const float dyw = fabsf(floored_mod(tcy - ecy + hh, Hf) - hh);
    s_hit[tid] = (m[M_VALID] > 0.0f) && (dxw <= TILE_W * 0.5f + ehw) &&
                 (dyw <= TILE_H * 0.5f + ehh);
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  const float px = (float)x;
  const bool grid_on = use_grid[n] != 0;

  for (int r = 0; r < ROWS; ++r) {
    const int y = y0 + threadIdx.y + r * THREADS_Y;
    if (y >= H) break;
    const float py = (float)y;
    float acc[3] = {255.0f, 255.0f, 255.0f};

    for (int e = 0; e < E; ++e) {
      if (!s_hit[e]) continue;  // uniform across the block
      const float* m = s_meta + e * NMETA;
      const float cx = m[M_CX], cy = m[M_CY], band = m[M_STROKE];
      const float pxw = __fsub_rn(
          __fadd_rn(cx, floored_mod(__fadd_rn(__fsub_rn(px, cx), hw), Wf)), hw);
      const float pyw = __fsub_rn(
          __fadd_rn(cy, floored_mod(__fadd_rn(__fsub_rn(py, cy), hh), Hf)), hh);
      float fa, sa;
      if (m[M_CIRCLE] > 0.0f) {
        const float d = circle_dist(pxw, pyw, cx, cy, m[M_ROUT]);
        fa = d < 0.0f ? 1.0f : 0.0f;
        sa = stroke_alpha(band, fabsf(d));
      } else if (m[M_CRESCENT] > 0.0f) {
        const float d_out = circle_dist(pxw, pyw, cx, cy, m[M_ROUT]);
        const float d_in = circle_dist(pxw, pyw, m[M_ICX], m[M_ICY], m[M_RIN]);
        fa = (d_out < 0.0f && d_in >= 0.0f) ? 1.0f : 0.0f;
        sa = fmaxf(stroke_alpha(band, fabsf(d_out)),
                   stroke_alpha(band, fabsf(d_in)));
      } else {
        float d2;
        bool inside;
        const int nv = m[M_SMALL] > 0.0f ? SMALL_V : MAXV;
        poly_field(s_vx + e * 2 * MAXV, s_vy + e * 2 * MAXV, nv, pxw, pyw,
                   &d2, &inside);
        fa = inside ? 1.0f : 0.0f;
        sa = stroke_alpha(band, __fsqrt_rn(d2));
      }
      // reference wrap parity: only the 3x3 periodic copies exist
      const float wrap_ok = (fabsf(__fsub_rn(px, pxw)) <= Wf &&
                             fabsf(__fsub_rn(py, pyw)) <= Hf) ? 1.0f : 0.0f;
      composite(acc, m, fa, sa, wrap_ok);
      if (m[M_HASP1] > 0.0f) {
        // part 1 exists only for 'plus' (two 4-vertex rectangles)
        float d2;
        bool inside;
        poly_field(s_vx + e * 2 * MAXV + MAXV, s_vy + e * 2 * MAXV + MAXV,
                   SMALL_V, pxw, pyw, &d2, &inside);
        composite(acc, m, inside ? 1.0f : 0.0f,
                  stroke_alpha(band, __fsqrt_rn(d2)), wrap_ok);
      }
    }

    if (grid_on) {
      bool on = false;
      for (int i = 0; i < n_xlines; ++i) on |= (px == lines[i]);
      for (int i = 0; i < n_ylines; ++i) on |= (py == lines[n_xlines + i]);
      const float keep = on ? 0.0f : 1.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = __fmul_rn(acc[c], keep);
    }

    uint8_t* o = out + (((size_t)n * H + y) * W + x) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c] = (uint8_t)fminf(fmaxf(rintf(acc[c]), 0.0f), 255.0f);
  }
}

}  // namespace

extern "C" int rig_raster_render(const float* meta, const float* vx,
                                 const float* vy, const uint8_t* use_grid,
                                 const float* lines, int n_xlines,
                                 int n_ylines, uint8_t* out, int N, int E,
                                 int W, int H, void* stream) {
  if (E > MAX_E || N <= 0 || W <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  dim3 block(TILE_W, THREADS_Y);
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, N);
  raster_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      meta, vx, vy, use_grid, lines, n_xlines, n_ylines, out, E, W, H);
  return (int)cudaGetLastError();
}
