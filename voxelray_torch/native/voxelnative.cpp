// voxelnative: native runtime pieces around the device compute path.
// Copied from voxelray_tpu/native/voxelnative.cpp.
//
// The reference implements its asset loading and CPU voxelization in C++
// (tinyobjloader; src/VoxelBuilder.hpp).  The hot compute runs on the
// device, but the host-side runtime — OBJ parsing for million-triangle
// scans, the trusted serial oracle voxelizer used as the bit-exactness
// gate, Morton coding and octree node construction — is native here too,
// exposed through a plain C ABI for ctypes.
//
// Semantics transcribed (not copied) from the reference:
//   * 13-axis Akenine-Moller SAT with 1e-8 degenerate-axis skips
//     (VoxelBuilder.hpp:73-162)
//   * per-triangle clamped windows with the +2 slack and
//     truncation-toward-zero (VoxelBuilder.hpp:175-184)
//   * float32 arithmetic with identical expression shapes
//   * 63-bit Morton codes, 21 bits/axis (octTree.hpp:211-238)
//   * pre-order flat node build, leaf when depth >= maxDepth or
//     count <= maxItems (octTree.hpp:319-358)
//
// Build: voxelray_torch/native/__init__.py (g++ -O3 -std=c++17 -fPIC
// -ffp-contract=off -shared, at first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ parsing: positions + fan-triangulated faces.  Returns counts through
// out params; caller allocates via the returned buffers' sizes (two-call
// protocol: first call with null buffers to get counts).
// ---------------------------------------------------------------------------

static inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

static inline const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

int parse_obj(const char* text, long text_len,
              float* verts, long* n_verts,
              int* faces, long* n_faces) {
    const char* p = text;
    const char* end = text + text_len;
    long vcount = 0, fcount = 0;
    const bool counting = (verts == nullptr);

    while (p < end) {
        p = skip_ws(p, end);
        if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
            if (counting) {
                ++vcount;
            } else {
                char* q = nullptr;
                float x = strtof(p + 2, &q);
                float y = strtof(q, &q);
                float z = strtof(q, &q);
                verts[3 * vcount] = x;
                verts[3 * vcount + 1] = y;
                verts[3 * vcount + 2] = z;
                ++vcount;
            }
        } else if (p < end && p[0] == 'f' &&
                   (p + 1 >= end || p[1] == ' ' || p[1] == '\t')) {
            // collect vertex indices of this polygon
            int idx[64];
            int k = 0;
            const char* q = p + 1;
            while (q < end && *q != '\n' && k < 64) {
                q = skip_ws(q, end);
                if (q >= end || *q == '\n' || *q == '#') break;
                char* r = nullptr;
                long i = strtol(q, &r, 10);
                if (r == q) break;
                // skip /vt/vn part
                while (r < end && *r != ' ' && *r != '\t' && *r != '\n')
                    ++r;
                idx[k++] = (i > 0) ? static_cast<int>(i - 1)
                                   : static_cast<int>(vcount + i);
                q = r;
            }
            for (int t = 1; t + 1 <= k - 1; ++t) {
                if (counting) {
                    ++fcount;
                } else {
                    faces[3 * fcount] = idx[0];
                    faces[3 * fcount + 1] = idx[t];
                    faces[3 * fcount + 2] = idx[t + 1];
                    ++fcount;
                }
            }
        }
        p = next_line(p, end);
    }
    *n_verts = vcount;
    *n_faces = fcount;
    return 0;
}

// ---------------------------------------------------------------------------
// Triangle/box SAT — reference predicate, float32 expression shapes.
// ---------------------------------------------------------------------------

struct V3 { float x, y, z; };

static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

static inline bool axis_separates(float ax, float ay, float az, float r,
                                  V3 p0, V3 p1, V3 p2) {
    const float l1 = fabsf(ax) + fabsf(ay) + fabsf(az);
    if (l1 < 1e-8f) return false;
    const float d0 = p0.x * ax + p0.y * ay + p0.z * az;
    const float d1 = p1.x * ax + p1.y * ay + p1.z * az;
    const float d2 = p2.x * ax + p2.y * ay + p2.z * az;
    const float mn = fminf(d0, fminf(d1, d2));
    const float mx = fmaxf(d0, fmaxf(d1, d2));
    return (mn > r) || (mx < -r);
}

static bool tri_box_overlap(V3 c, float h, V3 v0, V3 v1, V3 v2) {
    const V3 p0 = sub(v0, c);
    const V3 p1 = sub(v1, c);
    const V3 p2 = sub(v2, c);
    const V3 e0 = sub(p1, p0);
    const V3 e1 = sub(p2, p1);
    const V3 e2 = sub(p0, p2);

    // box axes
    {
        float mn = fminf(p0.x, fminf(p1.x, p2.x));
        float mx = fmaxf(p0.x, fmaxf(p1.x, p2.x));
        if (mn > h || mx < -h) return false;
        mn = fminf(p0.y, fminf(p1.y, p2.y));
        mx = fmaxf(p0.y, fmaxf(p1.y, p2.y));
        if (mn > h || mx < -h) return false;
        mn = fminf(p0.z, fminf(p1.z, p2.z));
        mx = fmaxf(p0.z, fmaxf(p1.z, p2.z));
        if (mn > h || mx < -h) return false;
    }
    // nine edge-cross axes
    const V3 edges[3] = {e0, e1, e2};
    for (const V3& e : edges) {
        if (axis_separates(0.0f, -e.z, e.y,
                           h * fabsf(-e.z) + h * fabsf(e.y), p0, p1, p2))
            return false;
        if (axis_separates(e.z, 0.0f, -e.x,
                           h * fabsf(e.z) + h * fabsf(-e.x), p0, p1, p2))
            return false;
        if (axis_separates(-e.y, e.x, 0.0f,
                           h * fabsf(-e.y) + h * fabsf(e.x), p0, p1, p2))
            return false;
    }
    // triangle plane
    const float nx = e0.y * e1.z - e0.z * e1.y;
    const float ny = e0.z * e1.x - e0.x * e1.z;
    const float nz = e0.x * e1.y - e0.y * e1.x;
    const float l1 = fabsf(nx) + fabsf(ny) + fabsf(nz);
    if (l1 >= 1e-8f) {
        const float r = h * fabsf(nx) + h * fabsf(ny) + h * fabsf(nz);
        const float s = nx * p0.x + ny * p0.y + nz * p0.z;
        if (fabsf(s) > r) return false;
    }
    return true;
}

// ---------------------------------------------------------------------------
// Serial voxelizer: occupancy bytes (z-major) + duplicate-counting
// set-call counter.  Identical semantics to the Python oracle.
// ---------------------------------------------------------------------------

long voxelize(const float* verts, long n_verts,
              const int* faces, long n_faces,
              float voxel_size,
              const float* bb_min3,
              int nx, int ny, int nz,
              uint8_t* occ /* nx*ny*nz, z-major */) {
    (void)n_verts;
    const float vs = voxel_size;
    const float half = 0.5f * vs;
    const float ox = bb_min3[0], oy = bb_min3[1], oz = bb_min3[2];
    long set_calls = 0;

    for (long t = 0; t < n_faces; ++t) {
        const int i0 = faces[3 * t], i1 = faces[3 * t + 1],
                  i2 = faces[3 * t + 2];
        const V3 v0{verts[3 * i0], verts[3 * i0 + 1], verts[3 * i0 + 2]};
        const V3 v1{verts[3 * i1], verts[3 * i1 + 1], verts[3 * i1 + 2]};
        const V3 v2{verts[3 * i2], verts[3 * i2 + 1], verts[3 * i2 + 2]};
        const float tminx = fminf(v0.x, fminf(v1.x, v2.x));
        const float tminy = fminf(v0.y, fminf(v1.y, v2.y));
        const float tminz = fminf(v0.z, fminf(v1.z, v2.z));
        const float tmaxx = fmaxf(v0.x, fmaxf(v1.x, v2.x));
        const float tmaxy = fmaxf(v0.y, fmaxf(v1.y, v2.y));
        const float tmaxz = fmaxf(v0.z, fmaxf(v1.z, v2.z));

        const int xs = std::max(0, static_cast<int>((tminx - ox) / vs));
        const int ys = std::max(0, static_cast<int>((tminy - oy) / vs));
        const int zs = std::max(0, static_cast<int>((tminz - oz) / vs));
        const int xe = std::min(nx, static_cast<int>((tmaxx - ox) / vs) + 2);
        const int ye = std::min(ny, static_cast<int>((tmaxy - oy) / vs) + 2);
        const int ze = std::min(nz, static_cast<int>((tmaxz - oz) / vs) + 2);

        for (int z = zs; z < ze; ++z) {
            for (int y = ys; y < ye; ++y) {
                for (int x = xs; x < xe; ++x) {
                    const V3 c{ox + (static_cast<float>(x) + 0.5f) * vs,
                               oy + (static_cast<float>(y) + 0.5f) * vs,
                               oz + (static_cast<float>(z) + 0.5f) * vs};
                    if (tri_box_overlap(c, half, v0, v1, v2)) {
                        occ[(static_cast<long>(z) * ny + y) * nx + x] = 1;
                        ++set_calls;
                    }
                }
            }
        }
    }
    return set_calls;
}

// ---------------------------------------------------------------------------
// Morton encode (21 bits/axis) + sort + pre-order octree node build.
// ---------------------------------------------------------------------------

static inline uint64_t spread3(uint64_t v) {
    v &= 0x1FFFFFULL;
    v = (v | (v << 32)) & 0x1F00000000FFFFULL;
    v = (v | (v << 16)) & 0x1F0000FF0000FFULL;
    v = (v | (v << 8)) & 0x100F00F00F00F00FULL;
    v = (v | (v << 4)) & 0x10C30C30C30C30C3ULL;
    v = (v | (v << 2)) & 0x1249249249249249ULL;
    return v;
}

void morton_encode(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                   long n, uint64_t* out) {
    for (long i = 0; i < n; ++i)
        out[i] = spread3(x[i]) | (spread3(y[i]) << 1) | (spread3(z[i]) << 2);
}

void sort_u64(uint64_t* data, long n) {
    std::sort(data, data + n);
}

// Pre-order node build over sorted codes.  Iterative explicit stack (the
// reference needs a 512 MiB thread stack for its recursion; we don't).
// nodes layout per row: children[8], start, count  (int64)
long build_octree_nodes(const uint64_t* codes, long n,
                        int max_depth, long max_items,
                        int64_t* nodes, long max_nodes) {
    const int64_t INVALID = 0xFFFFFFFFLL;
    // frames are ranges awaiting node emission; popping emits the node,
    // links it to its parent, and pushes child ranges in REVERSE so the
    // emission order equals the reference's pre-order recursion
    struct Frame { long begin, end; int depth; long parent; int slot; };
    std::vector<Frame> stack;
    stack.reserve(256);
    long count = 0;

    auto emit = [&](long begin, long end) -> long {
        if (count >= max_nodes) return -1;
        int64_t* row = nodes + count * 10;
        for (int i = 0; i < 8; ++i) row[i] = INVALID;
        row[8] = begin;
        row[9] = end - begin;
        return count++;
    };

    stack.push_back({0, n, 0, -1, 0});
    while (!stack.empty()) {
        Frame f = stack.back();
        stack.pop_back();
        const long node = emit(f.begin, f.end);
        if (node < 0) return -1;
        if (f.parent >= 0) nodes[f.parent * 10 + f.slot] = node;
        if (f.depth >= max_depth || (f.end - f.begin) <= max_items)
            continue;
        const int shift = 3 * (max_depth - 1 - f.depth);
        // find child ranges, then push them reversed
        Frame kids[8];
        int nk = 0;
        long cur = f.begin;
        for (int child = 0; child < 8; ++child) {
            if (cur >= f.end) break;
            const long cbegin = cur;
            while (cur < f.end &&
                   static_cast<int>((codes[cur] >> shift) & 7) == child)
                ++cur;
            if (cbegin == cur) continue;
            kids[nk++] = {cbegin, cur, f.depth + 1, node, child};
        }
        for (int k = nk - 1; k >= 0; --k) stack.push_back(kids[k]);
    }
    return count;
}

}  // extern "C"
