// Gravity and the velocity integration in one launch: the CUDA version of
// physics_tpu_torch/ops/integrator.py gravity_and_velocities (plain version:
// ops/forces.py apply_gravity, then integrator.py integrate_velocities, the
// non-compat branch). Not a TPU kernel: the JAX package leaves both to XLA's
// element-wise glue (physics_tpu/ops/forces.py apply_gravity,
// physics_tpu/ops/integrator.py integrate_velocities). Built from PyTorch
// operations the pair took 54 element-wise launches a step (the rotation
// matrix alone 35), each ~1.4 µs on the card whatever N.
//
// One thread a body. With kGravity: F' = F + f, f = m·g where inv_mass > 0
// (else 0) or g unscaled, and with kOffset τ' = τ + offset × f. With
// kIntegrate: v' = v + F'·(inv_mass·dt) and ω' = ω + R·(I⁻¹·(Rᵀ·(τ'·dt))),
// τ' less ω × (R·(I·(Rᵀ·ω))) under kGyroscopic, both clamped to
// ±max_velocity under kClamp. An output that the flags leave unchanged
// is not written (its pointer may be NULL). Bound: bytes, 108 read and
// 48 written a body (0.19 µs at 4,096 bodies, 1.5 µs at 32,768, at
// 3.35 TB/s).
//
// Bit for bit with the plain version: every product and sum in its order,
// built with -fmad=false. The 3x3 products are torch.sum over three
// products, whose order on the card is that of PyTorch's reduction kernel:
// over the last (contiguous) dimension (_mv) two threads split the three
// terms, (p0 + p2) + p1; over the middle one (_mtv) one thread adds them
// in order, (p0 + p1) + p2; each term enters as 0 + p, which turns a −0
// product into +0. The gyroscopic cross product is linalg_cross's, which
// PyTorch builds with contracted multiply-adds: a·b − c·d as
// fma(a, b, −(c·d)).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// bf_body_forces flags (physics_tpu_torch/_build.py BF_*)
constexpr int kGravity = 1;
constexpr int kIntegrate = 2;
constexpr int kScaleByMass = 4;
constexpr int kOffset = 8;
constexpr int kGyroscopic = 16;
constexpr int kClamp = 32;

struct Args {
  const float* mass;         // [N]
  const float* inv_mass;     // [N]
  const float* force;        // [N, 3]
  const float* torque;       // [N, 3]
  const float* vel;          // [N, 3]
  const float* omega;        // [N, 3]
  const float* quat;         // [N, 4] (w, x, y, z)
  const float* inv_inertia;  // [N, 3, 3] body frame, row-major
  const float* inertia;      // [N, 3, 3] body frame (kGyroscopic), or nullptr
  float* force_out;          // [N, 3] (kGravity)
  float* torque_out;         // [N, 3] (kGravity and kOffset)
  float* vel_out;            // [N, 3] (kIntegrate)
  float* omega_out;          // [N, 3] (kIntegrate)
  float g[3], offset[3];
  float dt, max_velocity;
  int n, flags;
};

// torch.sum(m * v[:, None, :], dim=-1), one row: integrator._mv
__device__ __forceinline__ float sum_last(float p0, float p1, float p2) {
  return ((0.0f + p0) + (0.0f + p2)) + (0.0f + p1);
}

// torch.sum(m * v[:, :, None], dim=-2), one column: integrator._mtv
__device__ __forceinline__ float sum_mid(float p0, float p1, float p2) {
  return ((0.0f + p0) + (0.0f + p1)) + (0.0f + p2);
}

__device__ __forceinline__ void mv(const float* m, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = sum_last(m[3 * i] * v[0], m[3 * i + 1] * v[1], m[3 * i + 2] * v[2]);
}

__device__ __forceinline__ void mtv(const float* m, const float* v, float* out) {
#pragma unroll
  for (int j = 0; j < 3; ++j) out[j] = sum_mid(m[j] * v[0], m[3 + j] * v[1], m[6 + j] * v[2]);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void __launch_bounds__(kThreads) body_forces_kernel(Args p) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= p.n) return;
  float f[3], tq[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f[c] = p.force[3 * b + c];
    tq[c] = p.torque[3 * b + c];
  }

  // ops/forces.py apply_gravity
  if (p.flags & kGravity) {
    float fg[3];
    const bool movable = p.inv_mass[b] > 0.0f;
    const float m = p.mass[b];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      fg[c] = (p.flags & kScaleByMass) ? (movable ? m * p.g[c] : 0.0f) : p.g[c];
      f[c] = f[c] + fg[c];
      p.force_out[3 * b + c] = f[c];
    }
    if (p.flags & kOffset) {
      const float* o = p.offset;
      const float tau[3] = {o[1] * fg[2] - o[2] * fg[1], o[2] * fg[0] - o[0] * fg[2], o[0] * fg[1] - o[1] * fg[0]};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tq[c] = tq[c] + tau[c];
        p.torque_out[3 * b + c] = tq[c];
      }
    }
  }
  if (!(p.flags & kIntegrate)) return;

  // ops/integrator.py integrate_velocities
  const float im_dt = p.inv_mass[b] * p.dt;
  float v[3], w[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] = p.vel[3 * b + c] + f[c] * im_dt;
    w[c] = p.omega[3 * b + c];
  }

  // maths/quaternion.py to_matrix
  const float* q = p.quat + 4 * b;
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float ww = qw * qw, xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy * 2.0f;
  const float wz = qw * qz * 2.0f;
  const float wy = qw * qy * 2.0f;
  const float xz = qx * qz * 2.0f;
  const float yz = qy * qz * 2.0f;
  const float wx = qw * qx * 2.0f;
  const float rot[9] = {ww + xx - yy - zz, xy - wz, wy + xz,
                        wz + xy, ww - xx + yy - zz, yz - wx,
                        xz - wy, wx + yz, ww - xx - yy + zz};

  float a[3], t[3];
  if (p.flags & kGyroscopic) {
    float l[3];
    mtv(rot, w, a);
    mv(p.inertia + 9 * b, a, t);
    mv(rot, t, l);
    const float cr[3] = {__fmaf_rn(w[1], l[2], -(w[2] * l[1])), __fmaf_rn(w[2], l[0], -(w[0] * l[2])),
                         __fmaf_rn(w[0], l[1], -(w[1] * l[0]))};
#pragma unroll
    for (int c = 0; c < 3; ++c) tq[c] = tq[c] - cr[c];
  }
  float u[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) u[c] = tq[c] * p.dt;
  mtv(rot, u, a);
  mv(p.inv_inertia + 9 * b, a, t);
  mv(rot, t, u);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    w[c] = w[c] + u[c];
    if (p.flags & kClamp) {
      v[c] = clamp(v[c], -p.max_velocity, p.max_velocity);
      w[c] = clamp(w[c], -p.max_velocity, p.max_velocity);
    }
    p.vel_out[3 * b + c] = v[c];
    p.omega_out[3 * b + c] = w[c];
  }
}

}  // namespace

// The per-body arrays as in Args; g and offset [3]; flags BF_* (kGravity,
// kIntegrate, ...): at least one of kGravity and kIntegrate.
extern "C" int bf_body_forces(const float* mass, const float* inv_mass, const float* force, const float* torque,
                              const float* vel, const float* omega, const float* quat, const float* inv_inertia,
                              const float* inertia, float* force_out, float* torque_out, float* vel_out,
                              float* omega_out, float gx, float gy, float gz, float ox, float oy, float oz, float dt,
                              float max_velocity, int n, int flags, void* stream) {
  const bool gravity = flags & kGravity, integrate = flags & kIntegrate;
  if (n < 0 || !(gravity || integrate) || (gravity && force_out == nullptr) ||
      (gravity && (flags & kOffset) && torque_out == nullptr) ||
      (integrate && (vel_out == nullptr || omega_out == nullptr)) ||
      (integrate && (flags & kGyroscopic) && inertia == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Args p = {mass, inv_mass, force, torque, vel, omega, quat, inv_inertia, inertia,
            force_out, torque_out, vel_out, omega_out, {gx, gy, gz}, {ox, oy, oz}, dt, max_velocity, n, flags};
  body_forces_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
