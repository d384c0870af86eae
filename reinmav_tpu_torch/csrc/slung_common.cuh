// Device code of the slung-load envs: their params and one step each of
// reinmav_tpu/envs/quadrotor2d_slungload.py:step (velocity-first Euler) and
// quadrotor3d_slungload.py:step (position-first Euler), in the arithmetic
// of the TPU policy kernels' steps (pallas_ppo_rollout.py::
// _slung2d_step_tiles :239, _slung3d_step_tiles :336).  The closed loops
// (K9, closed_loop_rollout.cu), the fused PPO rollout (K6, ppo_rollout.cu)
// and the off-policy collection (K7) run these same functions through the
// env structs of env_kinds.cuh.  The plain PyTorch twins write the same
// arithmetic in reinmav_tpu_torch/ops/closed_loop_rollout.py.
//
// The tether is taut when |load - quad| >= L.  Each env takes its own
// branch (the TPU kernels compute both and select per lane; a thread here
// computes the one it needs).  The taut branch projects the load back onto
// the tether sphere, so a taut env sits on the knife edge |load - quad| = L,
// where a last-bit difference picks the other branch next step.

#pragma once

#include <cuda_runtime.h>

#include "quad2d_common.cuh"
#include "quad3d_common.cuh"

namespace reinmav {

// Field orders of reinmav_tpu_torch/envs/quadrotor2d_slungload.py::Params
// (_S2_FIELDS) and quadrotor3d_slungload.py::Params (_S3_FIELDS).
struct Slung2dParams {
  float mass, load_mass, dt, gravity, tether_length, pos_limit, vel_limit, ref_x, ref_z, kp, kv,
      tau;
};
struct Slung3dParams {
  float mass, load_mass, dt, gravity, tether_length, pos_limit, vel_limit, ref_x, ref_y, ref_z,
      kp, kv, tau;
};

// 1 / where(n > 0, n, 1) (the envs' _safe_unit).
__device__ __forceinline__ float safe_inv(float n) { return 1.0f / (n > 0.0f ? n : 1.0f); }

// One quadrotor2d-slungload step on s = [x z th vx vz lx lz lvx lvz] under
// [thrust_N, omega]; inv_mml = 1 / (mass + load_mass).  Returns the reward.
__device__ __forceinline__ float slung2d_step(float (&s)[9], float thrust, float w,
                                              const Slung2dParams& p, float inv_mml,
                                              bool& done) {
  const float x = s[0], z = s[1], th = s[2], vx = s[3], vz = s[4];
  const float lx = s[5], lz = s[6], lvx = s[7], lvz = s[8];
  const float dt = p.dt, g = p.gravity, L = p.tether_length, m = p.mass;
  float hz, hx;
  sincosf(th + kHalfPi, &hz, &hx);
  const float tq = thrust / m;  // quad acceleration scale
  const float tqx = tq * hx, tqz = tq * hz;

  const float tx = lx - x, tz = lz - z;
  const float tn = sqrtf(tx * tx + tz * tz);
  const float inv = safe_inv(tn);
  const float ux = tx * inv, uz = tz * inv;

  float npx, npz, nvx, nvz, nlx, nlz, nlvx, nlvz;
  if (tn >= L) {  // taut, velocity FIRST (Q3)
    const float sc = m * L * (lvx * lvx + lvz * lvz);  // scalar subtracted from a vector
    const float proj = ux * (thrust * hx - sc) + uz * (thrust * hz - sc);
    const float lax = inv_mml * (proj * ux);
    const float laz = inv_mml * (proj * uz) + g;
    float lvx_t = lvx + lax * dt, lvz_t = lvz + laz * dt;
    const float lpx_t = lx + lvx_t * dt + 0.5f * lax * dt * dt;
    const float lpz_t = lz + lvz_t * dt + 0.5f * laz * dt * dt;
    const float dzg = laz - g;
    const float tmag = p.load_mass * sqrtf(lax * lax + dzg * dzg);
    const float accx = tqx + (tmag * ux) / m;
    const float accz = tqz + g + (tmag * uz) / m;
    nvx = vx + accx * dt;
    nvz = vz + accz * dt;
    npx = x + nvx * dt + 0.5f * accx * dt * dt;
    npz = z + nvz * dt + 0.5f * accz * dt * dt;
    // The kinematic projection onto the tether circle.
    const float dx = lpx_t - npx, dz = lpz_t - npz;
    const float dinv = safe_inv(sqrtf(dx * dx + dz * dz));
    const float ddx = dx * dinv, ddz = dz * dinv;
    nlx = npx + ddx * L;
    nlz = npz + ddz * L;
    const float rad = (lvx_t - nvx) * ddx + (lvz_t - nvz) * ddz;
    nlvx = lvx_t - rad * ddx;
    nlvz = lvz_t - rad * ddz;
  } else {  // slack
    nlvx = lvx;
    nlvz = lvz + g * dt;
    nlx = lx + nlvx * dt;
    nlz = lz + nlvz * dt + 0.5f * g * dt * dt;
    const float accz = tqz + g;
    nvx = vx + tqx * dt;
    nvz = vz + accz * dt;
    npx = x + nvx * dt + 0.5f * tqx * dt * dt;
    npz = z + nvz * dt + 0.5f * accz * dt * dt;
  }
  s[0] = npx; s[1] = npz; s[2] = th + w * dt; s[3] = nvx; s[4] = nvz;
  s[5] = nlx; s[6] = nlz; s[7] = nlvx; s[8] = nlvz;
  const float lpn = sqrtf(nlx * nlx + nlz * nlz);
  const float lvn = sqrtf(nlvx * nlvx + nlvz * nlvz);
  done = (lpn > p.pos_limit) || (lvn > p.vel_limit);
  return done ? 1.0f : -sqrtf(npx * npx + npz * npz);
}

// One quadrotor3d-slungload step on s = [p(3) q(4) v(3) lp(3) lv(3)] under
// [thrust, wx, wy, wz]; half_dt = dt / 2, inv_mml = 1 / (mass + load_mass).
// The quaternion update is quadrotor3d's (Q4).  Returns the reward.
__device__ __forceinline__ float slung3d_step(float (&s)[16], float thrust, float wx, float wy,
                                              float wz, const Slung3dParams& p, float half_dt,
                                              float inv_mml, bool& done) {
  const float px = s[0], py = s[1], pz = s[2];
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float vx = s[7], vy = s[8], vz = s[9];
  const float lx = s[10], ly = s[11], lz = s[12], lvx = s[13], lvy = s[14], lvz = s[15];
  const float dt = p.dt, g = p.gravity, L = p.tether_length, m = p.mass;
  const BodyZ bz = body_z(s);
  const float tq = thrust / m;
  const float tqx = tq * bz.x, tqy = tq * bz.y, tqz = tq * bz.z;

  const float tx = lx - px, ty = ly - py, tz = lz - pz;
  const float tn = sqrtf(tx * tx + ty * ty + tz * tz);
  const float inv = safe_inv(tn);
  const float ux = tx * inv, uy = ty * inv, uz = tz * inv;

  float npx, npy, npz, nvx, nvy, nvz, nlx, nly, nlz, nlvx, nlvy, nlvz;
  if (tn >= L) {  // taut, position FIRST (old velocity)
    const float sc = m * L * (lvx * lvx + lvy * lvy + lvz * lvz);
    const float proj =
        ux * (thrust * bz.x - sc) + uy * (thrust * bz.y - sc) + uz * (thrust * bz.z - sc);
    const float lax = inv_mml * (proj * ux);
    const float lay = inv_mml * (proj * uy);
    const float laz = inv_mml * (proj * uz) + g;
    const float lpx_t = lx + lvx * dt + 0.5f * lax * dt * dt;
    const float lpy_t = ly + lvy * dt + 0.5f * lay * dt * dt;
    const float lpz_t = lz + lvz * dt + 0.5f * laz * dt * dt;
    const float lvx_t = lvx + lax * dt, lvy_t = lvy + lay * dt, lvz_t = lvz + laz * dt;
    const float dzg = laz - g;
    const float tmag = p.load_mass * sqrtf(lax * lax + lay * lay + dzg * dzg);
    const float accx = tqx + (tmag * ux) / m;
    const float accy = tqy + (tmag * uy) / m;
    const float accz = tqz + g + (tmag * uz) / m;
    npx = px + vx * dt + 0.5f * accx * dt * dt;
    npy = py + vy * dt + 0.5f * accy * dt * dt;
    npz = pz + vz * dt + 0.5f * accz * dt * dt;
    nvx = vx + accx * dt;
    nvy = vy + accy * dt;
    nvz = vz + accz * dt;
    // The kinematic projection onto the tether sphere.
    const float dx = lpx_t - npx, dy = lpy_t - npy, dz = lpz_t - npz;
    const float dinv = safe_inv(sqrtf(dx * dx + dy * dy + dz * dz));
    const float ddx = dx * dinv, ddy = dy * dinv, ddz = dz * dinv;
    nlx = npx + ddx * L;
    nly = npy + ddy * L;
    nlz = npz + ddz * L;
    const float rad = (lvx_t - nvx) * ddx + (lvy_t - nvy) * ddy + (lvz_t - nvz) * ddz;
    nlvx = lvx_t - rad * ddx;
    nlvy = lvy_t - rad * ddy;
    nlvz = lvz_t - rad * ddz;
  } else {  // slack
    nlx = lx + lvx * dt;
    nly = ly + lvy * dt;
    nlz = lz + lvz * dt + 0.5f * g * dt * dt;
    nlvx = lvx;
    nlvy = lvy;
    nlvz = lvz + g * dt;
    const float accz = tqz + g;
    npx = px + vx * dt + 0.5f * tqx * dt * dt;
    npy = py + vy * dt + 0.5f * tqy * dt * dt;
    npz = pz + vz * dt + 0.5f * accz * dt * dt;
    nvx = vx + tqx * dt;
    nvy = vy + tqy * dt;
    nvz = vz + accz * dt;
  }
  const float hw = qw * bz.inv_qn, hx = qx * bz.inv_qn, hy = qy * bz.inv_qn, hz = qz * bz.inv_qn;
  s[3] = qw + half_dt * (-hx * wx - hy * wy - hz * wz);
  s[4] = qx + half_dt * (hw * wx + hy * wz - hz * wy);
  s[5] = qy + half_dt * (hw * wy - hx * wz + hz * wx);
  s[6] = qz + half_dt * (hw * wz + hx * wy - hy * wx);
  s[0] = npx; s[1] = npy; s[2] = npz;
  s[7] = nvx; s[8] = nvy; s[9] = nvz;
  s[10] = nlx; s[11] = nly; s[12] = nlz;
  s[13] = nlvx; s[14] = nlvy; s[15] = nlvz;
  const float lpn = sqrtf(nlx * nlx + nly * nly + nlz * nlz);
  const float vn = sqrtf(nvx * nvx + nvy * nvy + nvz * nvz);
  done = (lpn > p.pos_limit) || (vn > p.vel_limit);
  return done ? 1.0f : -lpn;
}

}  // namespace reinmav
