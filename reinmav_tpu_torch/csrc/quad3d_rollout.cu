// K1: the quadrotor3d closed-loop rollout with fused auto-reset, written for
// NVIDIA Hopper (sm_90a).
//
// Replaces reinmav_tpu/ops/pallas_rollout.py::quad3d_rollout_autoreset_pallas8
// (:591): the step of _closed_loop_step_tiles (:310) with
// tilt_controller_tiles (:241) inside it, repeated over the whole horizon,
// and the U(-1,1)^10 redraw of done envs (_uniform_pm1 :206, applied at
// :440-444).  With autoreset = 0 it is quad3d_rollout_pallas (:359), the
// no-reset variant.  Its plain PyTorch twin, which computes the same thing
// in the same order, is reinmav_tpu_torch/ops/rollout.py::
// quad3d_rollout_reference.
//
// What bounds it on the card: arithmetic.  One env-step is about 150 fp32
// operations (three rsqrt and one sqrt among them), while an env's state
// crosses device memory once per ROLLOUT: 40 B in, 40 B + 4 B (reward sum)
// out.  At a 1000-step horizon that is under 0.1 B of traffic per env-step,
// far on the compute side of the H100's roofline.
//
// What the design does about it: one thread per env; the 10 state floats and
// the reward sum stay in registers across the whole horizon; the (10, B)
// loads and stores coalesce across a warp and happen once at the start and
// once at the end; the 11 params are kernel arguments (the TPU kernel's
// SMEM-versus-baked duality is gone).  A done env redraws its state from
// Philox4x32-10, written out below, with key (seed, 0) and counter
// (env index, step, draw index, 0): three draws give the 10 values.  The
// draw runs only on the rare done branch.  The ragged tail of the batch is
// masked, so any B works.  Speeding it up (several envs per thread for
// instruction-level parallelism, cheaper intrinsics) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Field order of reinmav_tpu_torch/envs/quadrotor3d.py::Params (_Q3_FIELDS).
struct Quad3dParams {
  float mass, dt, gravity, ref_x, ref_y, ref_z, pos_limit, vel_limit, kp, kv, tau;
};

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

// Philox4x32-10 (Salmon et al., SC'11; the Random123 reference): ten rounds,
// the key bumped by the Weyl constants after each.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return c;
}

// U(-1, 1) by mantissa fill to [1, 2), then affine (pallas_rollout.py:206-211).
__device__ __forceinline__ float uniform_pm1(uint32_t bits) {
  const float f12 = __uint_as_float((bits >> 9) | 0x3F800000u);
  return 2.0f * (f12 - 1.0f) - 1.0f;
}

// One controller + dynamics step on s = [px py pz qw qx qy qz vx vy vz].
// Returns the step's reward and sets done.
__device__ __forceinline__ float closed_loop_step(float (&s)[10], const Quad3dParams& p,
                                                  float two_over_tau, float inv_m,
                                                  float half_dt, float pos_lim2,
                                                  float vel_lim2, bool& done) {
  const float px = s[0], py = s[1], pz = s[2];
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float vx = s[7], vy = s[8], vz = s[9];
  const float dt = p.dt, gz = p.gravity;

  // ---- geometric controller (tilt_controller_tiles) ----------------------
  const float ax = p.kp * (px - p.ref_x) + p.kv * vx;
  const float ay = p.kp * (py - p.ref_y) + p.kv * vy;
  const float az = p.kp * (pz - p.ref_z) + p.kv * vz - gz;

  const float an = rsqrtf(ax * ax + ay * ay + az * az);
  const float zbx = ax * an, zby = ay * an, zbz = az * an;
  // xb = yc x zb with yc = (0, 1, 0): (zbz, 0, -zbx), normalised.
  const float xn = rsqrtf(zbz * zbz + zbx * zbx);
  const float xbx = zbz * xn, xbz = -zbx * xn;
  // yb = zb x xb
  const float ybx = zby * xbz;
  const float yby = zbz * xbx - zbx * xbz;
  const float ybz = -zby * xbx;

  // pyquaternion _from_matrix on the transposed [xb yb zb]: rows xb, yb, zb
  // (m01 = xb_y = 0).
  const float m00 = xbx, m02 = xbz;
  const float m10 = ybx, m11 = yby, m12 = ybz;
  const float m20 = zbx, m21 = zby, m22 = zbz;
  float t, dw, dx, dy, dz;
  if (m22 < 0.0f) {
    if (m00 > m11) {  // branch A
      t = 1.0f + m00 - m11 - m22;
      dw = m12 - m21; dx = t; dy = m10; dz = m20 + m02;
    } else {  // branch B
      t = 1.0f - m00 + m11 - m22;
      dw = m20 - m02; dx = m10; dy = t; dz = m12 + m21;
    }
  } else {
    if (m00 < -m11) {  // branch C
      t = 1.0f - m00 - m11 + m22;
      dw = -m10; dx = m20 + m02; dy = m12 + m21; dz = t;
    } else {  // branch D
      t = 1.0f + m00 + m11 + m22;
      dw = t; dx = m12 - m21; dy = m20 - m02; dz = -m10;
    }
  }
  const float scale = 0.5f * rsqrtf(t);
  dw *= scale; dx *= scale; dy *= scale; dz *= scale;

  // qe = conj(q_raw) (x) q_des; rate command from the RAW quaternion.
  const float ew = qw * dw + qx * dx + qy * dy + qz * dz;
  const float ex = qw * dx - qx * dw - qy * dz + qz * dy;
  const float ey = qw * dy + qx * dz - qy * dw - qz * dx;
  const float ez = qw * dz - qx * dy + qy * dx - qz * dw;
  const float sgn = ew > 0.0f ? 1.0f : (ew < 0.0f ? -1.0f : 0.0f);  // sign(0) = 0 (Q10)
  const float k = two_over_tau * sgn;
  const float wx = k * ex, wy = k * ey, wz = k * ez;

  // Body z of the NORMALISED quaternion, shared by thrust and dynamics.
  const float qn2 = qw * qw + qx * qx + qy * qy + qz * qz;
  const float inv_qn = rsqrtf(qn2);
  const float inv_qn2 = inv_qn * inv_qn;
  const float bzx = 2.0f * (qx * qz + qw * qy) * inv_qn2;
  const float bzy = 2.0f * (qy * qz - qw * qx) * inv_qn2;
  const float bzz = 1.0f - 2.0f * (qx * qx + qy * qy) * inv_qn2;
  const float thrust = ax * bzx + ay * bzy + az * bzz;

  // ---- dynamics (envs/quadrotor3d.py:step) --------------------------------
  const float accx = thrust * inv_m * bzx;
  const float accy = thrust * inv_m * bzy;
  const float accz = thrust * inv_m * bzz + gz;

  // Position-first Euler with the old velocity.
  const float npx = px + vx * dt + 0.5f * accx * dt * dt;
  const float npy = py + vy * dt + 0.5f * accy * dt * dt;
  const float npz = pz + vz * dt + 0.5f * accz * dt * dt;
  const float nvx = vx + accx * dt, nvy = vy + accy * dt, nvz = vz + accz * dt;

  // q += 1/2 dt q_hat (x) (0, w), added to the raw stored quaternion.
  const float hw = qw * inv_qn, hx = qx * inv_qn, hy = qy * inv_qn, hz = qz * inv_qn;
  s[3] = qw + half_dt * (-hx * wx - hy * wy - hz * wz);
  s[4] = qx + half_dt * (hw * wx + hy * wz - hz * wy);
  s[5] = qy + half_dt * (hw * wy - hx * wz + hz * wx);
  s[6] = qz + half_dt * (hw * wz + hx * wy - hy * wx);
  s[0] = npx; s[1] = npy; s[2] = npz;
  s[7] = nvx; s[8] = nvy; s[9] = nvz;

  const float pn2 = npx * npx + npy * npy + npz * npz;
  const float vn2 = nvx * nvx + nvy * nvy + nvz * nvz;
  done = (pn2 > pos_lim2) || (vn2 > vel_lim2);
  return done ? 1.0f : -sqrtf(pn2);
}

__global__ void __launch_bounds__(kThreads)
quad3d_rollout_kernel(const float* __restrict__ s_in, float* __restrict__ s_out,
                      float* __restrict__ reward_out, int64_t batch, int horizon,
                      uint32_t seed, int autoreset, Quad3dParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;  // ragged tail

  const float two_over_tau = 2.0f / p.tau;
  const float inv_m = 1.0f / p.mass;
  const float half_dt = 0.5f * p.dt;
  const float pos_lim2 = p.pos_limit * p.pos_limit;
  const float vel_lim2 = p.vel_limit * p.vel_limit;
  const uint32_t env = static_cast<uint32_t>(i);

  float s[10];
#pragma unroll
  for (int d = 0; d < 10; ++d) s[d] = s_in[d * batch + i];
  float reward_sum = 0.0f;

  for (int t = 0; t < horizon; ++t) {
    bool done;
    reward_sum += closed_loop_step(s, p, two_over_tau, inv_m, half_dt, pos_lim2, vel_lim2, done);
    if (autoreset && done) {
      const uint32_t step = static_cast<uint32_t>(t);
      const uint4 b0 = philox4x32_10(make_uint4(env, step, 0u, 0u), seed, 0u);
      const uint4 b1 = philox4x32_10(make_uint4(env, step, 1u, 0u), seed, 0u);
      const uint4 b2 = philox4x32_10(make_uint4(env, step, 2u, 0u), seed, 0u);
      s[0] = uniform_pm1(b0.x); s[1] = uniform_pm1(b0.y);
      s[2] = uniform_pm1(b0.z); s[3] = uniform_pm1(b0.w);
      s[4] = uniform_pm1(b1.x); s[5] = uniform_pm1(b1.y);
      s[6] = uniform_pm1(b1.z); s[7] = uniform_pm1(b1.w);
      s[8] = uniform_pm1(b2.x); s[9] = uniform_pm1(b2.y);
    }
  }

#pragma unroll
  for (int d = 0; d < 10; ++d) s_out[d * batch + i] = s[d];
  reward_out[i] = reward_sum;
}

// Philox4x32-10 on n (counter, key) pairs: the known-answer check of the
// generator the rollout kernel draws its resets from.
__global__ void philox4x32_10_kernel(const uint32_t* __restrict__ ctr,
                                     const uint32_t* __restrict__ key,
                                     uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]);
  const uint4 r = philox4x32_10(c, key[2 * i], key[2 * i + 1]);
  out[4 * i] = r.x;
  out[4 * i + 1] = r.y;
  out[4 * i + 2] = r.z;
  out[4 * i + 3] = r.w;
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Each entry
// point launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

extern "C" int quad3d_rollout_launch(const void* states_in, void* states_out, void* reward_out,
                                     long long batch, int horizon, unsigned int seed,
                                     int autoreset, const void* params_host, void* stream) {
  const float* h = static_cast<const float*>(params_host);
  const Quad3dParams p{h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], h[8], h[9], h[10]};
  const long long blocks = (batch + kThreads - 1) / kThreads;
  quad3d_rollout_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states_in), static_cast<float*>(states_out),
      static_cast<float*>(reward_out), batch, horizon, seed, autoreset, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int philox4x32_10_launch(const void* counters, const void* keys, void* out,
                                    long long n, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  philox4x32_10_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(counters), static_cast<const uint32_t*>(keys),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
