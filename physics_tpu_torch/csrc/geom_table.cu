// The rank-space geometry table [48, NPAD] in one launch: the CUDA version of
// physics_tpu_torch/ops/contact_table.py unified_geom (plain version:
// unified_geom_plain). Not a TPU kernel: the JAX package builds the table
// with XLA's element-wise glue (physics_tpu/ops/contact_table.py:760
// unified_geom). Built from PyTorch operations the table took ~150
// element-wise launches a call (the rotation and the world inverse inertia
// one component at a time, a 48-row stack, the gather by the sort order, a
// zeroed copy), each ~1.4 µs on the card whatever N.
//
// One thread a column r: for r < n it reads body b = order[r] (b = r
// without an order): pos, quat, vel, ω, inverse mass, the body-frame inverse
// inertia, shape type, half extents, friction and restitution, and writes the
// column's 48 rows in unified_geom's layout; for r >= n it writes zeros, so
// the output needs no memset. A warp's stores to a row are 32 consecutive
// floats. Bound: bytes, the 48·NPAD·4 written and 29 f32 read a body
// (1.3 MB at the 4k pile, 10.1 MB at 32,768 packed bodies: 0.40 and 3.0 µs
// at 3.35 TB/s).
//
// Bit for bit with the plain version: quat_to_mat and sandwich are spelled as
// maths/vec3c.py computes them (x·y·2 as (x·y)·2; each Python sum() as
// ((0 + a) + b) + c, whose leading 0 turns a −0 product into +0 as PyTorch's
// 0 + t does), and the library is built with -fmad=false.
//
// Hull mode (per-type boxes given): rows 36:39 hold the body's hull type's
// local-AABB half extents, row 43 is_hull·(1 + type), rows 44:47 the world
// OBB centre pos + R·(local-AABB centre), then 0. The wrapper computes each
// type's local-AABB centre and half extents once a call.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 48;
constexpr int kShapeBox = 2;   // state.SHAPE_BOX
constexpr int kShapeHull = 3;  // state.SHAPE_HULL

struct Bodies {
  const float* pos;          // [N, 3]
  const float* quat;         // [N, 4] (w, x, y, z)
  const float* vel;          // [N, 3]
  const float* omega;        // [N, 3]
  const float* inv_mass;     // [N]
  const float* inv_inertia;  // [N, 3, 3] body frame, row-major
  const int* stype;          // [N]
  const float* params;       // [N, 3] box half extents
  const int* hull_index;     // [N] (hull mode)
  const float* friction;     // [N]
  const float* restitution;  // [N]
  const int* order;          // [N] rank → body, or nullptr (the identity)
  const float* hull_centre;  // [H, 3] local-AABB centre a hull type, or nullptr (box mode)
  const float* hull_half;    // [H, 3] local-AABB half extents a hull type
  int n, nh;
};

__global__ void __launch_bounds__(kThreads) geom_table_kernel(Bodies p, float* __restrict__ geom, int npad) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= npad) return;
  float* col = geom + r;
  if (r >= p.n) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) col[(size_t)k * npad] = 0.f;
    return;
  }
  const int b = p.order != nullptr ? p.order[r] : r;
  const float* q = p.quat + 4 * b;
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  float v[kRows];

  // vec3c.quat_to_mat
  const float ww = w * w, xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y * 2.0f;
  const float wz = w * z * 2.0f;
  const float wy = w * y * 2.0f;
  const float xz = x * z * 2.0f;
  const float yz = y * z * 2.0f;
  const float wx = w * x * 2.0f;
  const float rm[9] = {ww + xx - yy - zz, xy - wz, wy + xz,
                       wz + xy, ww - xx + yy - zz, yz - wx,
                       xz - wy, wx + yz, ww - xx - yy + zz};

  // vec3c.sandwich: R · I⁻¹ · Rᵀ
  const float* m = p.inv_inertia + 9 * b;
  float t[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      t[3 * i + j] = 0.0f + rm[3 * i] * m[j] + rm[3 * i + 1] * m[3 + j] + rm[3 * i + 2] * m[6 + j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      v[3 + 3 * i + j] = 0.0f + t[3 * i] * rm[3 * j] + t[3 * i + 1] * rm[3 * j + 1] + t[3 * i + 2] * rm[3 * j + 2];

  // solve block: pos | world I⁻¹ (3:12) | inv_mass | vel | ω | quat | 0
  const float inv_mass = p.inv_mass[b];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = p.pos[3 * b + c];
    v[13 + c] = p.vel[3 * b + c];
    v[16 + c] = p.omega[3 * b + c];
  }
  v[12] = inv_mass;
  v[19] = w;
  v[20] = x;
  v[21] = y;
  v[22] = z;
  v[23] = 0.f;

  // narrow-phase block: pos | R | half extents | friction | restitution |
  // movable·is_shape | body id | is_shape | tail ×4
  const int st = p.stype[b];
  float is_shape;
#pragma unroll
  for (int c = 0; c < 3; ++c) v[24 + c] = v[c];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[27 + k] = rm[k];
  if (p.hull_centre != nullptr) {
    const int h = min(max(p.hull_index[b], 0), p.nh - 1);
    const float* co = p.hull_centre + 3 * h;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[36 + c] = p.hull_half[3 * h + c];
      v[44 + c] = v[c] + rm[3 * c] * co[0] + rm[3 * c + 1] * co[1] + rm[3 * c + 2] * co[2];
    }
    is_shape = (st == kShapeHull ? 1.0f : 0.0f) * (1.0f + (float)h);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[36 + c] = p.params[3 * b + c];
      v[44 + c] = 0.f;
    }
    is_shape = st == kShapeBox ? 1.0f : 0.0f;
  }
  v[39] = p.friction[b];
  v[40] = p.restitution[b];
  v[41] = (inv_mass > 0.0f ? 1.0f : 0.0f) * is_shape;
  v[42] = (float)b;
  v[43] = is_shape;
  v[47] = 0.f;
#pragma unroll
  for (int k = 0; k < kRows; ++k) col[(size_t)k * npad] = v[k];
}

}  // namespace

// geom [48, npad] (npad >= n) from the per-body arrays (shapes in Bodies);
// hull_centre and hull_half [nh, 3] select hull mode, nullptr box mode;
// order nullptr is the identity order.
extern "C" int gt_geom_table(const float* pos, const float* quat, const float* vel, const float* omega,
                             const float* inv_mass, const float* inv_inertia, const int* stype, const float* params,
                             const int* hull_index, const float* friction, const float* restitution, const int* order,
                             const float* hull_centre, const float* hull_half, float* geom, int n, int nh, int npad,
                             void* stream) {
  if (n < 0 || npad < n || (hull_centre != nullptr && (nh < 1 || hull_half == nullptr || hull_index == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (npad == 0) return (int)cudaSuccess;
  Bodies p = {pos, quat, vel, omega, inv_mass, inv_inertia, stype, params, hull_index,
              friction, restitution, order, hull_centre, hull_half, n, nh};
  geom_table_kernel<<<(npad + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(p, geom, npad);
  return (int)cudaGetLastError();
}
