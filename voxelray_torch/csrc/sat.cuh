// The voxelizer's per-triangle window and 13-axis SAT, shared by K1
// (voxel_accum.cu) and the triangle accel's binning (tri_bin.cu): one copy
// of each, so the two kernels test the same (triangle, cell) pairs with
// the same float32 arithmetic.
//
// sat_window is ops/voxelize.window_bounds (VoxelBuilder.hpp:175-184):
// float divide, truncation toward zero, +2 slack, clamped to the grid.
// tri_box_overlap is ops/sat.tri_box_overlap (VoxelBuilder.hpp:118-162),
// whose expression shapes it follows term for term; built with
// --fmad=false and without fast math, both are bit-equal to the plain
// PyTorch versions.
//
// The including source provides the CUDA runtime (or the host test's
// stand-in for it) before this header.
#pragma once

#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;

struct Tri {
  float p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z;
};

// One of the nine edge-cross axes (sat.py axis_sep): an axis with L1
// norm < 1e-8 never separates.
__device__ __forceinline__ bool axis_sep(const Tri& p, float ax, float ay,
                                         float az, float r) {
  const float l1 = fabsf(ax) + fabsf(ay) + fabsf(az);
  const float d0 = p.p0x * ax + p.p0y * ay + p.p0z * az;
  const float d1 = p.p1x * ax + p.p1y * ay + p.p1z * az;
  const float d2 = p.p2x * ax + p.p2y * ay + p.p2z * az;
  const float tmn = fminf(d0, fminf(d1, d2));
  const float tmx = fmaxf(d0, fmaxf(d1, d2));
  return (l1 >= kEps) && ((tmn > r) || (tmx < -r));
}

__device__ __forceinline__ bool box_axis(float a, float b, float c, float h) {
  const float mn = fminf(a, fminf(b, c));
  const float mx = fmaxf(a, fmaxf(b, c));
  return (mn > h) || (mx < -h);
}

// sat.py tri_box_overlap for one cell center (all inputs finite); v holds
// the triangle's vertices v0, v1, v2.
__device__ __forceinline__ bool tri_box_overlap(float cx, float cy, float cz,
                                                float h, const float* v) {
  Tri p;
  p.p0x = v[0] - cx; p.p0y = v[1] - cy; p.p0z = v[2] - cz;
  p.p1x = v[3] - cx; p.p1y = v[4] - cy; p.p1z = v[5] - cz;
  p.p2x = v[6] - cx; p.p2y = v[7] - cy; p.p2z = v[8] - cz;
  const float e0x = p.p1x - p.p0x, e0y = p.p1y - p.p0y, e0z = p.p1z - p.p0z;
  const float e1x = p.p2x - p.p1x, e1y = p.p2y - p.p1y, e1z = p.p2z - p.p1z;
  const float e2x = p.p0x - p.p2x, e2y = p.p0y - p.p2y, e2z = p.p0z - p.p2z;

  // 1) box axes
  if (box_axis(p.p0x, p.p1x, p.p2x, h) || box_axis(p.p0y, p.p1y, p.p2y, h) ||
      box_axis(p.p0z, p.p1z, p.p2z, h))
    return false;

  // 2) nine edge-cross axes, in sat.py's order
  const float ex[3] = {e0x, e1x, e2x};
  const float ey[3] = {e0y, e1y, e2y};
  const float ez[3] = {e0z, e1z, e2z};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (axis_sep(p, 0.0f, -ez[i], ey[i], h * fabsf(-ez[i]) + h * fabsf(ey[i])))
      return false;
    if (axis_sep(p, ez[i], 0.0f, -ex[i], h * fabsf(ez[i]) + h * fabsf(-ex[i])))
      return false;
    if (axis_sep(p, -ey[i], ex[i], 0.0f, h * fabsf(-ey[i]) + h * fabsf(ex[i])))
      return false;
  }

  // 3) triangle plane: n = cross(e0, e1), s = n . p0, left to right
  const float nx = e0y * e1z - e0z * e1y;
  const float ny = e0z * e1x - e0x * e1z;
  const float nz = e0x * e1y - e0y * e1x;
  const float anx = fabsf(nx), any = fabsf(ny), anz = fabsf(nz);
  const float nl1 = anx + any + anz;
  const float r = h * anx + h * any + h * anz;
  const float s = nx * p.p0x + ny * p.p0y + nz * p.p0z;
  return !((nl1 >= kEps) && (fabsf(s) > r));
}

// The clamped window of a triangle whose nine coordinates p are finite:
// its first cell s[3] and its extents w[3] (0 where the window is empty);
// returns the window's cell count.
__device__ __forceinline__ long long sat_window(const float* p, float ogx,
                                                float ogy, float ogz,
                                                float vs, int nx, int ny,
                                                int nz, int* s, int* w) {
  const float tminx = fminf(p[0], fminf(p[3], p[6]));
  const float tminy = fminf(p[1], fminf(p[4], p[7]));
  const float tminz = fminf(p[2], fminf(p[5], p[8]));
  const float tmaxx = fmaxf(p[0], fmaxf(p[3], p[6]));
  const float tmaxy = fmaxf(p[1], fmaxf(p[4], p[7]));
  const float tmaxz = fmaxf(p[2], fmaxf(p[5], p[8]));
  s[0] = max(0, static_cast<int>((tminx - ogx) / vs));
  s[1] = max(0, static_cast<int>((tminy - ogy) / vs));
  s[2] = max(0, static_cast<int>((tminz - ogz) / vs));
  const int ex = min(nx, static_cast<int>((tmaxx - ogx) / vs) + 2);
  const int ey = min(ny, static_cast<int>((tmaxy - ogy) / vs) + 2);
  const int ez = min(nz, static_cast<int>((tmaxz - ogz) / vs) + 2);
  w[0] = max(ex - s[0], 0);
  w[1] = max(ey - s[1], 0);
  w[2] = max(ez - s[2], 0);
  return static_cast<long long>(w[0]) * w[1] * w[2];
}

__device__ __forceinline__ bool all_finite9(const float* p) {
  return isfinite(p[0]) && isfinite(p[1]) && isfinite(p[2]) &&
         isfinite(p[3]) && isfinite(p[4]) && isfinite(p[5]) &&
         isfinite(p[6]) && isfinite(p[7]) && isfinite(p[8]);
}

}  // anonymous namespace
