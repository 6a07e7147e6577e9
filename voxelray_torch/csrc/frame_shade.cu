// The frame glue for Hopper (sm_90a): camera rays, the closest-hit surface
// and shade + post of render_image, three kernels.
//
// They replace the per-pixel PyTorch ops of voxelray_torch/render/pipeline.py
// on CUDA tensors: make_camera_rays and the 8x128 tiling (camera_rays),
// surface_terms and the light terms (hit_surface), the shade stage, the
// alpha channel and gamma_post (shade_post).  The JAX package runs this
// glue as one XLA jit, with no Pallas kernel, so these kernels are new; their
// plain version is that PyTorch code, which CPU tensors still run.
//
// What bounds them on the H100: memory, and before this file the host.  As
// PyTorch ops the glue was ~215-325 launches and 7 host syncs a 1920x1080
// frame; each pass over the 2,073,600 rays moves a few dozen bytes a ray, so
// the three passes together move ~0.5 GB, ~0.15 ms at 3.35 TB/s.
//
// What the design does about it:
//  - one thread a ray, in the order the trace kernels take the rays (8x128
//    tile order when the frame tiles), so every per-ray read and write is
//    coalesced; shade_post writes the ray's pixel where it lies in the
//    (H, W, 4) framebuffer, and a tile row is 128 neighbouring pixels, so
//    its stores stay whole 2 KB rows;
//  - each frame's constants (the inverse matrices, the light, the clear
//    colour) are kernel arguments, so no tensor is made from a host value:
//    no copy, no sync;
//  - hit_surface writes the shadow query the trace kernels take (world_pos
//    and l_vec (n, 3), light_dist (n,), the admit mask) and a 32-byte record
//    a ray for shade_post: the shading normal and a word of flags and the
//    material row's index, the diffuse term and the light's intensity at the
//    hit.  shade_post reads the three specular numbers of the material row
//    through that index from the material table, which stays in cache.
//
// Numerics: built with --fmad=false and without fast math (see
// ops/kernels/_build.py), so every product and sum rounds on its own, as
// the plain version's PyTorch ops do.  Each expression follows the plain
// version's op order: three-term dot products summed left to right
// (shading.dot3), a Python scalar over a tensor as the tensor's reciprocal
// times the scalar (Tensor.__rtruediv__), div_scalar as one IEEE division,
// Python scalars rounded to float32, min/max/clamp propagating NaN as
// torch.maximum and torch.clamp do, sign as (0 < x) - (x < 0).  Every
// output then equals the plain version's bit for bit, but for the values
// that pass through powf (the specular power, gamma): the CPU's powf and
// the card's may differ by an ulp.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The three kernels' argument blocks, which ops/kernels/frame_shade.py
// mirrors as ctypes structures; each launcher takes one by pointer.  (At
// namespace scope: a launcher with C linkage must not take a type of
// internal linkage, or it is not exported.)

// Camera rays: view_inv's rows 0-2 and proj_inv, row-major (M @ v).
struct RaysArgs {
  float vi[12];
  float pi[16];
  int width, height, tiled, n;
  float *origins, *dirs;  // (n, 3)
};

// The closest hit of the primary traces.  t_tri null: no triangle trace
// (t +inf, id -1, u = v = 0).  boxes non-null: vox_id indexes voxel_aabbs
// (the brute route); else vox_id is a cell of the grid at grid_origin (a
// device float[3]) or, when that is null, at org.
struct SurfaceArgs {
  const float *o, *d, *t_vox;
  const int* vox_id;
  const float* t_tri;
  const int* tri_id;
  const float *bu, *bv;
  const float *tri_n0, *tri_n1, *tri_n2;     // (F, 3)
  const float *tri_uv0, *tri_uv1, *tri_uv2;  // (F, 2)
  const int *tri_mat, *tri_tex;              // (F,)
  const float *materials, *voxel_material;   // (M, 20), (20,)
  const float* textures;                     // (T, tex_h, tex_w, 3)
  const int* tex_meta;                       // (T, tex_levels, 4)
  const float* boxes;                        // (NB, 6) or null
  const float* grid_origin;                  // (3,) or null
  float org[3];
  float vs;
  int nx, ny;
  int has_tri;     // the scene has triangles
  int vox_normal;  // the scene has voxel geometry: voxel hits get its normal
  int n_layers, tex_h, tex_w, tex_levels;
  float light[3];
  float intensity;
  int light_type;  // 0 point, else directional
  int n;
  float *world_pos, *l_vec, *light_dist;  // (n, 3), (n, 3), (n,)
  uint8_t* admit;                         // (n,) hit & facing
  float4* rec;                            // (n, 2)
};

// The shade stage and post.  occluded null: no shadow pass (a facing
// surface is lit).  image: the gamma-corrected (height, width, 4)
// framebuffer, pixel order; else linear RGB (n, 3) in ray order.
struct ShadeArgs {
  const float4* rec;
  const float *d, *l_vec;
  const uint8_t* occluded;
  const float *materials, *voxel_material;
  float clear[3];
  float gamma;
  int n, width, height, tiled, image;
  float* out;
};

namespace {

constexpr int kThreads = 256;
// render_image's tile: 8 rows of 128 pixels (pipeline._TILE_H, _TILE_W)
constexpr int kTileH = 8;
constexpr int kTileW = 128;
// float(2.0 * np.float32(np.pi)), compute_specular's divisor
constexpr float kTwoPi = 2.0f * 3.14159265358979f;
// Material row (io/objload.py MAT_*)
constexpr int kAmbient = 0, kDiffuse = 3, kSpecular = 6, kShininess = 15,
              kIllum = 18, kMatRow = 20;
// The record's flags word: bits 0-2 the flags, then the material code (0:
// the voxel material, m + 1: row m of the material table)
constexpr int kHit = 1, kVoxHit = 2, kFacing = 4, kMatShift = 3;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

// torch.clamp(x, min=lo): NaN stays NaN; -0 against +0 gives lo
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x <= lo ? lo : x;
}

// torch.sign
__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>(0.0f < x) - static_cast<float>(x < 0.0f);
}

// Pixel (px, py) of ray i: row-major, or the tile order of
// pipeline._tile_rays (tiles of kTileH x kTileW pixels, each row by row,
// the tiles stacked column-major).
__device__ __forceinline__ void pixel_of(int i, int width, int height,
                                         int tiled, int& px, int& py) {
  if (!tiled) {
    py = i / width;
    px = i - py * width;
    return;
  }
  const int c = i % kTileW;
  const int q = i / kTileW;
  const int r = q % kTileH;
  const int tile = q / kTileH;
  const int rows = height / kTileH;
  px = (tile / rows) * kTileW + c;
  py = (tile % rows) * kTileH + r;
}

// ---- camera_rays: make_camera_rays (ops/intersect.py), tiled ------------
__global__ void __launch_bounds__(kThreads)
    camera_rays_kernel(const RaysArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  int px, py;
  pixel_of(i, a.width, a.height, a.tiled, px, py);
  // ((arange + 0.5) / size) * 2 - 1, the division one IEEE division
  const float fx =
      ((static_cast<float>(px) + 0.5f) / static_cast<float>(a.width)) * 2.0f -
      1.0f;
  const float fy =
      ((static_cast<float>(py) + 0.5f) / static_cast<float>(a.height)) *
          2.0f -
      1.0f;
  // target = proj_inv[:3] @ (fx, fy, 1, 1), summed left to right
  float t[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = a.pi + 4 * r;
    float acc = m[0] * fx;
    acc = acc + m[1] * fy;
    acc = acc + m[2];
    acc = acc + m[3];
    t[r] = acc;
  }
  const float norm = sqrtf((t[0] * t[0] + t[1] * t[1]) + t[2] * t[2]);
  const float tn0 = t[0] / norm, tn1 = t[1] / norm, tn2 = t[2] / norm;
  float* o = a.origins + 3 * static_cast<size_t>(i);
  float* d = a.dirs + 3 * static_cast<size_t>(i);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float* m = a.vi + 4 * r;
    d[r] = (m[0] * tn0 + m[1] * tn1) + m[2] * tn2;
    o[r] = m[3];
  }
}

// ---- hit_surface: surface_terms (render/pipeline.py) --------------------

// pipeline._sample_texture at the base level (lod=None), repeat
// addressing; layer >= 0.
__device__ __forceinline__ void sample_texture(const SurfaceArgs& a,
                                               int layer, float u_in,
                                               float v_in, float* out) {
  const int lc = min(max(layer, 0), a.n_layers - 1);
  const int* meta = a.tex_meta + static_cast<size_t>(lc) * a.tex_levels * 4;
  const int y0 = meta[0], x0 = meta[1], hh = meta[2], ww = meta[3];
  const float uw = u_in - floorf(u_in);
  const float vw = v_in - floorf(v_in);
  const float u = uw * static_cast<float>(ww) - 0.5f;
  const float v = vw * static_cast<float>(hh) - 0.5f;
  const float xf = floorf(u), yf = floorf(v);
  const float fu = u - xf, fv = v - yf;
  // a NaN coordinate (then every weight is NaN) converts to some integer,
  // which the wrap below keeps inside the texture
  const long long xi = static_cast<long long>(xf);
  const long long yi = static_cast<long long>(yf);
  const float* tex = a.textures + static_cast<size_t>(lc) * a.tex_h *
                                      a.tex_w * 3;
  const float gu = 1.0f - fu, gv = 1.0f - fv;
  float acc[3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    long long xa = xi + (k & 1), ya = yi + (k >> 1);
    xa = xa < 0 ? ww - 1 : (xa >= ww ? 0 : xa);
    ya = ya < 0 ? hh - 1 : (ya >= hh ? 0 : ya);
    const float* px =
        tex + (static_cast<size_t>(ya + y0) * a.tex_w + (xa + x0)) * 3;
    const float wa = (k & 1) ? fu : gu;
    const float wb = (k >> 1) ? fv : gv;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float term = (px[c] * wa) * wb;
      acc[c] = k == 0 ? term : acc[c] + term;
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = acc[c];
}

// shading.cube_normal of the hit cell (or box) vox_id at world position p.
__device__ __forceinline__ void voxel_normal(const SurfaceArgs& a, int id,
                                             const float* p, float* n) {
  const int lin = max(id, 0);
  float c[3];
  if (a.boxes != nullptr) {
    const float* b = a.boxes + 6 * static_cast<size_t>(lin);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = (b[k] + b[k + 3]) * 0.5f;
  } else {
    const long long l = lin;
    const long long nxy = static_cast<long long>(a.nx) * a.ny;
    const long long idx[3] = {l % a.nx, (l / a.nx) % a.ny, l / nxy};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float o = a.grid_origin != nullptr ? a.grid_origin[k] : a.org[k];
      c[k] = o + (static_cast<float>(idx[k]) + 0.5f) * a.vs;
    }
  }
  const float v0 = p[0] - c[0], v1 = p[1] - c[1], v2 = p[2] - c[2];
  const float len = sqrtf(dot3(v0, v1, v2, v0, v1, v2));
  const float d0 = v0 / len, d1 = v1 / len, d2 = v2 / len;
  const float a0 = fabsf(d0), a1 = fabsf(d1), a2 = fabsf(d2);
  const float mx = nan_max(nan_max(a0, a1), a2);
  const bool is_x = mx == a0;
  const bool is_y = !is_x && mx == a1;
  n[0] = is_x ? sign_of(d0) : 0.0f;
  n[1] = is_y ? sign_of(d1) : 0.0f;
  n[2] = (is_x || is_y) ? 0.0f : sign_of(d2);
}

__global__ void __launch_bounds__(kThreads)
    hit_surface_kernel(const SurfaceArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const size_t i3 = 3 * static_cast<size_t>(i);
  const float tv = a.t_vox[i];
  float tt = INFINITY, bu = 0.0f, bv = 0.0f;
  int tid = -1;
  if (a.t_tri != nullptr) {
    tt = a.t_tri[i];
    tid = a.tri_id[i];
    bu = a.bu[i];
    bv = a.bv[i];
  }
  const bool vox_hit = isfinite(tv) && tv < tt;
  const bool tri_hit = isfinite(tt) && !vox_hit;
  const bool hit = vox_hit || tri_hit;
  const float ts = hit ? (vox_hit ? tv : tt) : 1.0f;
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = a.o[i3 + k] + a.d[i3 + k] * ts;

  // the light terms (shading.light_terms)
  float l[3], inten, dist;
  if (a.light_type == 0) {
    const float q0 = a.light[0] - p[0], q1 = a.light[1] - p[1],
                q2 = a.light[2] - p[2];
    dist = sqrtf(dot3(q0, q1, q2, q0, q1, q2));
    l[0] = q0 / dist;
    l[1] = q1 / dist;
    l[2] = q2 / dist;
    inten = (1.0f / (dist * dist)) * a.intensity;
  } else {
    const float len = sqrtf(dot3(a.light[0], a.light[1], a.light[2],
                                 a.light[0], a.light[1], a.light[2]));
    l[0] = a.light[0] / len;
    l[1] = a.light[1] / len;
    l[2] = a.light[2] / len;
    inten = a.intensity;
    dist = 100000.0f;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.world_pos[i3 + k] = p[k];
    a.l_vec[i3 + k] = l[k];
  }
  a.light_dist[i] = dist;
  if (!hit) {
    a.admit[i] = 0;
    a.rec[2 * static_cast<size_t>(i)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    a.rec[2 * static_cast<size_t>(i) + 1] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }

  // the shading normal and the material row
  float n[3] = {0.0f, 0.0f, 0.0f};
  const float* mat = a.voxel_material;
  int code = 0;
  const int t = max(tid, 0);
  if (vox_hit) {
    if (a.vox_normal) voxel_normal(a, a.vox_id[i], p, n);
  } else {
    const float w = (1.0f - bu) - bv;
    const float* n0 = a.tri_n0 + 3 * static_cast<size_t>(t);
    const float* n1 = a.tri_n1 + 3 * static_cast<size_t>(t);
    const float* n2 = a.tri_n2 + 3 * static_cast<size_t>(t);
    float m[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) m[k] = (n0[k] * w + n1[k] * bu) + n2[k] * bv;
    const float len = clamp_min(sqrtf(dot3(m[0], m[1], m[2], m[0], m[1],
                                           m[2])), 1e-20f);
#pragma unroll
    for (int k = 0; k < 3; ++k) n[k] = m[k] / len;
    const int row = a.tri_mat[t];
    mat = a.materials + static_cast<size_t>(row) * kMatRow;
    code = row + 1;
  }

  // shading.compute_diffuse, texture-modulated on a triangle hit
  const float dnl = dot3(n[0], n[1], n[2], l[0], l[1], l[2]);
  const float dn = clamp_min(dnl, 0.0f);
  const bool ambient = mat[kIllum] >= 1.0f;
  float diff[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    diff[k] = mat[kDiffuse + k] * dn + (ambient ? mat[kAmbient + k] : 0.0f);
  if (tri_hit) {
    const int layer = a.tri_tex[t];
    if (layer >= 0) {
      const float w = (1.0f - bu) - bv;
      const float* uv0 = a.tri_uv0 + 2 * static_cast<size_t>(t);
      const float* uv1 = a.tri_uv1 + 2 * static_cast<size_t>(t);
      const float* uv2 = a.tri_uv2 + 2 * static_cast<size_t>(t);
      const float u = (uv0[0] * w + uv1[0] * bu) + uv2[0] * bv;
      const float v = (uv0[1] * w + uv1[1] * bu) + uv2[1] * bv;
      float tex[3];
      sample_texture(a, layer, u, v, tex);
#pragma unroll
      for (int k = 0; k < 3; ++k) diff[k] = diff[k] * tex[k];
    }
  }
  const bool facing = dnl > 0.0f;
  a.admit[i] = facing ? 1 : 0;
  const int bits = kHit | (vox_hit ? kVoxHit : 0) | (facing ? kFacing : 0) |
                   (code << kMatShift);
  a.rec[2 * static_cast<size_t>(i)] =
      make_float4(n[0], n[1], n[2], __int_as_float(bits));
  a.rec[2 * static_cast<size_t>(i) + 1] =
      make_float4(diff[0], diff[1], diff[2], inten);
}

// ---- shade_post: render_rays' shade stage, render_image's post ----------

// shading.compute_specular for view direction d, light l, normal n.
__device__ __forceinline__ void specular(const float* mat, const float* d,
                                         const float* l, const float* n,
                                         float* out) {
  const float sh = clamp_min(mat[kShininess], 4.0f);
  const float energy = (2.0f + sh) / kTwoPi;
  const float v0 = -d[0], v1 = -d[1], v2 = -d[2];
  const float vl = sqrtf(dot3(v0, v1, v2, v0, v1, v2));
  const float w0 = v0 / vl, w1 = v1 / vl, w2 = v2 / vl;
  const float m0 = -l[0], m1 = -l[1], m2 = -l[2];
  const float k = 2.0f * dot3(n[0], n[1], n[2], m0, m1, m2);
  const float r0 = m0 - k * n[0], r1 = m1 - k * n[1], r2 = m2 - k * n[2];
  const float vr = clamp_min(dot3(w0, w1, w2, r0, r1, r2), 0.0f);
  const float s = energy * powf(vr, sh);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = mat[kSpecular + c] * s;
}

__global__ void __launch_bounds__(kThreads)
    shade_post_kernel(const ShadeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float4 r0 = a.rec[2 * static_cast<size_t>(i)];
  const int bits = __float_as_int(r0.w);
  float rgb[3];
  if (!(bits & kHit)) {
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = a.clear[c] * 0.8f;
  } else {
    const float4 r1 = a.rec[2 * static_cast<size_t>(i) + 1];
    const bool facing = bits & kFacing;
    const bool occ = a.occluded != nullptr && a.occluded[i] != 0;
    const bool shadowed = facing ? occ : true;
    const bool lit = facing && !shadowed;
    // triangle CH: 1 unless facing and shadowed -> 0.3; voxel CH: 0.3
    // unless facing and unshadowed -> 1
    const float att = (bits & kVoxHit) ? (lit ? 1.0f : 0.3f)
                                       : ((facing && shadowed) ? 0.3f : 1.0f);
    float spec[3] = {0.0f, 0.0f, 0.0f};
    if (lit) {
      const int code = bits >> kMatShift;
      const float* mat = code == 0
                             ? a.voxel_material
                             : a.materials +
                                   static_cast<size_t>(code - 1) * kMatRow;
      if (!(mat[kIllum] < 2.0f)) {
        const size_t i3 = 3 * static_cast<size_t>(i);
        const float n[3] = {r0.x, r0.y, r0.z};
        specular(mat, a.d + i3, a.l_vec + i3, n, spec);
      }
    }
    const float s = r1.w * att;
    rgb[0] = s * (r1.x + spec[0]);
    rgb[1] = s * (r1.y + spec[1]);
    rgb[2] = s * (r1.z + spec[2]);
  }
  if (!a.image) {
    float* out = a.out + 3 * static_cast<size_t>(i);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c] = rgb[c];
    return;
  }
  int px, py;
  pixel_of(i, a.width, a.height, a.tiled, px, py);
  // pow(clamp(rgba, 0), 1/2.2); the alpha channel's pow(1, g) is 1
  reinterpret_cast<float4*>(a.out)[static_cast<size_t>(py) * a.width + px] =
      make_float4(powf(clamp_min(rgb[0], 0.0f), a.gamma),
                  powf(clamp_min(rgb[1], 0.0f), a.gamma),
                  powf(clamp_min(rgb[2], 0.0f), a.gamma), 1.0f);
}

}  // namespace

// Each launcher takes its argument block by pointer, copies it into the
// kernel's parameters and returns the launch's cudaError_t.
static unsigned blocks_for(int n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

extern "C" int camera_rays_launch(const RaysArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  camera_rays_kernel<<<blocks_for(a->n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hit_surface_launch(const SurfaceArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  hit_surface_kernel<<<blocks_for(a->n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shade_post_launch(const ShadeArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  shade_post_kernel<<<blocks_for(a->n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof of the three argument blocks, which the wrapper's ctypes
// structures must match.
extern "C" void frame_shade_sizes(int* out) {
  out[0] = static_cast<int>(sizeof(RaysArgs));
  out[1] = static_cast<int>(sizeof(SurfaceArgs));
  out[2] = static_cast<int>(sizeof(ShadeArgs));
}
