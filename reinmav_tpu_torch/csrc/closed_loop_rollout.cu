// K1, K8 and K9: the closed-loop rollouts of quadrotor3d-v0 (K1),
// quadrotor2d-v0 (K8) and the two slung-load envs (K9) with fused
// auto-reset, one template on the four loop structs of this file
// (env_kinds.cuh's env structs with their own steps), written for NVIDIA
// Hopper (sm_90a).
//
// Replaces reinmav_tpu/ops/pallas_rollout.py::component_rollout (:468,
// pallas_call :492), the scaffold that runs
//   K1  pallas_rollout.py::quad3d_rollout_autoreset_pallas8 (:591), step
//       _closed_loop_step_tiles (:310) with tilt_controller_tiles (:241);
//       and the flat quad3d_rollout_pallas (:359, no reset) and
//       quad3d_rollout_autoreset_pallas (:385);
//   K8  pallas_rollout.py::quad2d_rollout_autoreset_pallas8 (:567), step
//       _quad2d_step_tiles (:520);
//   K9  pallas_slungload.py::slung3d_rollout_pallas8 (:310) and
//       slung2d_rollout_pallas8 (:332), steps _slung3d_step_tiles (:76) and
//       _slung2d_step_tiles (:208);
// each env's classical controller and dynamics repeated over the whole
// horizon, with the U(-1, 1)^D redraw of done envs.  With autoreset = 0 it
// is the no-reset form.  Its plain PyTorch twins, which compute the same
// thing in the same order with the same Philox draws, are
// reinmav_tpu_torch/ops/rollout.py::quad3d_rollout_reference (K1) and
// reinmav_tpu_torch/ops/closed_loop_rollout.py::closed_loop_rollout_reference
// (K8/K9; its steps: LOOP_STEPS there).
//
// What bounds it on the card: instruction issue.  One env-step is about 150
// (quadrotor3d), 60 (quad2d), 140 (slung2d) or 300 (slung3d) FP32
// operations, roots, an atan2 and a sin/cos pair among them, while an env's
// state crosses device memory once per ROLLOUT: 4 D B in and 4 D + 4 B
// out, under 0.1 B per env-step at 1000 steps.
//
// What the design does about it:
// - One thread per env; the D state floats and the reward sum stay in
//   registers for the whole horizon; one coalesced (D, B) load and store;
//   the env's params are kernel arguments (a param sweep runs here, with no
//   baked-constant variant).
// - The loop structs run the TPU kernels' own steps, operation for
//   operation, not the policy kernels' (K6 and K7 keep those, in
//   quad2d_common.cuh and slung_common.cuh, byte for byte: moving their FMA
//   choices once failed the SAC learning gate).  So a physics edit of these
//   envs is now made in two places: here and in those headers, each with its
//   twin in ops/closed_loop_rollout.py (LOOP_STEPS here, KINDS there).
//   Where these steps depart from quad2d_common.cuh::quad2d_step and
//   slung_common.cuh's slung2d_step / slung3d_step:
//   * 1 / mass is formed once per thread with __frcp_rn (the bits of 1.0f /
//     mass) and the steps multiply by it: thrust * inv_m * h and, for the
//     tether's pull on the quad, tmag * u * inv_m, where the headers divide
//     by mass every step (equal bits when mass is a power of two);
//   * done compares squared norms with squared limits (quad2d keeps the
//     folded |v|^2 > 100), where the headers compare norms; the one sqrtf
//     left is the reward's;
//   * the tether has no branch (below); on a slack env its results are the
//     slack branch's bit for bit, except that a -0 in x + 0 becomes +0.
//   The controllers are the shared pd2d_control and geometric_control, with
//   CUDA's accurate atan2f, sincosf and sqrtf.
// - One branch-free tether body.  The TPU kernels compute both branches and
//   select per lane; a thread that took its own branch diverged in nearly
//   every warp, since a taut env's load sits on the tether sphere, where
//   rounding picks the branch of the next step.  Here the slack branch is
//   the taut branch's Euler update with the load's acceleration selected to
//   (0, g) or (0, 0, g) and the tension term selected to 0, so the update
//   runs once; the projection onto the sphere runs for every env and its
//   result is selected.  Selected, never multiplied by zero: a slack env's
//   tether direction may be non-finite.  The taut test stays
//   sqrtf(|load - quad|^2) >= L, the JAX kernels' own.
// - The knife edge rounded as the twin rounds it.  After a taut step the
//   load sits on the sphere, and the next taut test is decided by rounding
//   alone: of the projection's norm, of load = quad + dir * L and of the
//   tether norm.  nvcc contracts a * b + c into one FMA (one rounding), the
//   twin rounds twice, and that shifts the share of taut steps by points
//   (PERF.md), so these three are written with __fmul_rn / __fadd_rn, which
//   are never contracted; the rest of the step keeps its FMAs.
// - The reset is K1's: a done env redraws its state from Philox4x32-10 with
//   key (seed, 0) and counter (env, step, draw, 0), ceil(D / 4) blocks, on
//   its own lane (ops/rollout.py::reset_draws).  A lane that idles costs no
//   issue slot, so a warp-cooperative form (the blocks of all the done lanes
//   of a warp spread over its 32 lanes, gathered with shuffles) saves at most
//   ceil(D / 4) - 1 blocks a warp that resets, and costs registers and a
//   nested loop on every step: on an H100 it ran slower for quad2d and
//   slung3d, barely faster for slung2d, and was taken out (PERF.md).  The
//   ragged tail is masked, so any B works.
// - An optional per-env int32 count (taut env-steps for the slung kinds,
//   done env-steps, which are the resets, for quad2d and quadrotor3d), in a
//   template instance of its own, so the main path (no counts) carries none
//   of it.  K1's loop fixes its auto-reset at compile time (Quad3dLoop<true>
//   and <false>); K8/K9 keep the runtime flag.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "env_kinds.cuh"
#include "quad2d_common.cuh"
#include "quad3d_common.cuh"
#include "slung_common.cuh"

namespace {

using reinmav::BodyZ;
using reinmav::kHalfPi;

constexpr int kThreads = 256;

// quadrotor3d-v0 (K1): _closed_loop_step_tiles (pallas_rollout.py:310) with
// tilt_controller_tiles (:241).  The env struct of env_kinds.cuh (dims,
// kind id, params) with K1's own step: the controller's command carries the
// body z axis of the normalised quaternion, which the dynamics reuse, and
// thrust / mass is thrust * inv_m with inv_m formed once (Quad3dEnv::step,
// K2's and K7's, divides and recomputes body z).  kReset fixes the
// auto-reset at compile time, so the main path's loop carries no test of
// it.  Where this step departs from quad3d_common.cuh's geometric_control
// (which K2, K7 and K9 keep byte for byte), with the same bits on every
// input:
// * pyquaternion's _from_matrix takes branch B or D, selected, not four
//   branches: m11 = |(zbz, zbx)| >= 0 and m00 = zbz / |(zbz, zbx)| has the
//   sign of m22 = zbz, so branch A (m22 < 0, m00 > m11) and branch C
//   (m22 >= 0, m00 < -m11) are never taken, for any input (a NaN takes D).
//   The two candidates' sums are rounded one operation at a time
//   (__fadd_rn), as in the branches, where no product reaches them;
// * sign(ew) is copysign(1, ew) where |ew| > 0, else 0 (NaN included).
template <bool kReset>
struct Quad3dLoop : reinmav::Quad3dEnv {
  static constexpr bool kFixedReset = kReset;
  struct Consts : reinmav::Quad3dEnv::Consts {
    float inv_m;
  };
  using Act = reinmav::GeometricCmd;
  __device__ static Consts consts(const Params& p) {
    return {reinmav::Quad3dEnv::consts(p), 1.0f / p.mass};
  }
  __device__ static void control(const float (&s)[kD], const Params& p, const Consts& c,
                                 Act& cmd) {
    const float px = s[0], py = s[1], pz = s[2];
    const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
    const float vx = s[7], vy = s[8], vz = s[9];

    const float ax = p.kp * (px - p.ref_x) + p.kv * vx;
    const float ay = p.kp * (py - p.ref_y) + p.kv * vy;
    const float az = p.kp * (pz - p.ref_z) + p.kv * vz - p.gravity;

    const float an = rsqrtf(ax * ax + ay * ay + az * az);
    const float zbx = ax * an, zby = ay * an, zbz = az * an;
    // xb = yc x zb with yc = (0, 1, 0): (zbz, 0, -zbx), normalised.
    const float xn = rsqrtf(zbz * zbz + zbx * zbx);
    const float xbx = zbz * xn, xbz = -zbx * xn;
    // yb = zb x xb
    const float ybx = zby * xbz;
    const float yby = zbz * xbx - zbx * xbz;
    const float ybz = -zby * xbx;

    // pyquaternion _from_matrix on the transposed [xb yb zb] (m01 = 0):
    // branch B where m22 < 0, else branch D.
    const float m00 = xbx, m02 = xbz;
    const float m10 = ybx, m11 = yby, m12 = ybz;
    const float m20 = zbx, m21 = zby, m22 = zbz;
    const bool neg = m22 < 0.0f;
    const float t_b = __fsub_rn(__fadd_rn(__fsub_rn(1.0f, m00), m11), m22);
    const float t_d = __fadd_rn(__fadd_rn(__fadd_rn(1.0f, m00), m11), m22);
    const float t = neg ? t_b : t_d;
    const float m20_m02 = __fsub_rn(m20, m02);
    const float m12_m21 = __fsub_rn(m12, m21);
    const float scale = 0.5f * rsqrtf(t);
    const float dw = (neg ? m20_m02 : t_d) * scale;
    const float dx = (neg ? m10 : m12_m21) * scale;
    const float dy = (neg ? t_b : m20_m02) * scale;
    const float dz = (neg ? __fadd_rn(m12, m21) : -m10) * scale;

    // qe = conj(q_raw) (x) q_des; rate command from the RAW quaternion.
    const float ew = qw * dw + qx * dx + qy * dy + qz * dz;
    const float ex = qw * dx - qx * dw - qy * dz + qz * dy;
    const float ey = qw * dy + qx * dz - qy * dw - qz * dx;
    const float ez = qw * dz - qx * dy + qy * dx - qz * dw;
    const float sgn = fabsf(ew) > 0.0f ? copysignf(1.0f, ew) : 0.0f;  // sign(0) = 0 (Q10)
    const float k = c.two_over_tau * sgn;

    // Body z of the NORMALISED quaternion, shared by thrust and dynamics.
    const BodyZ bz = reinmav::body_z(s);
    cmd = {ax * bz.x + ay * bz.y + az * bz.z, k * ex, k * ey, k * ez, bz};
  }
  // counted: the step ended the env (a reset, with auto-reset on).
  __device__ static float step(float (&s)[kD], const Act& cmd, const Params& p,
                               const Consts& c, bool& done, bool& counted) {
    const float px = s[0], py = s[1], pz = s[2];
    const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
    const float vx = s[7], vy = s[8], vz = s[9];
    const float dt = p.dt, tq = cmd.thrust * c.inv_m;
    const BodyZ& bz = cmd.bz;

    const float accx = tq * bz.x;
    const float accy = tq * bz.y;
    const float accz = tq * bz.z + p.gravity;

    const float npx = px + vx * dt + 0.5f * accx * dt * dt;
    const float npy = py + vy * dt + 0.5f * accy * dt * dt;
    const float npz = pz + vz * dt + 0.5f * accz * dt * dt;
    const float nvx = vx + accx * dt, nvy = vy + accy * dt, nvz = vz + accz * dt;

    const float wx = cmd.wx, wy = cmd.wy, wz = cmd.wz;
    const float hw = qw * bz.inv_qn, hx = qx * bz.inv_qn, hy = qy * bz.inv_qn, hz = qz * bz.inv_qn;
    s[3] = qw + c.half_dt * (-hx * wx - hy * wy - hz * wz);
    s[4] = qx + c.half_dt * (hw * wx + hy * wz - hz * wy);
    s[5] = qy + c.half_dt * (hw * wy - hx * wz + hz * wx);
    s[6] = qz + c.half_dt * (hw * wz + hx * wy - hy * wx);
    s[0] = npx; s[1] = npy; s[2] = npz;
    s[7] = nvx; s[8] = nvy; s[9] = nvz;

    const float pn2 = npx * npx + npy * npy + npz * npz;
    const float vn2 = nvx * nvx + nvy * nvy + nvz * nvz;
    done = (pn2 > c.pos_lim2) || (vn2 > c.vel_lim2);
    counted = done;
    return done ? 1.0f : -sqrtf(pn2);
  }
};

// quadrotor2d-v0: _quad2d_step_tiles (pallas_rollout.py:520-563).  The env
// struct of env_kinds.cuh (dims, kind id, params, controller) with the TPU
// kernel's own step.
struct Quad2dLoop : reinmav::Quad2dEnv {
  struct Consts : reinmav::Quad2dEnv::Consts {
    float inv_m, pos_lim2, vel_lim2;
  };
  __device__ static Consts consts(const Params& p) {
    return {reinmav::Quad2dEnv::consts(p), __frcp_rn(p.mass), p.pos_limit * p.pos_limit,
            p.vel_limit * p.vel_limit};
  }
  // counted: the step ended the env (a reset, with auto-reset on).
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done, bool& counted) {
    const float x = s[0], z = s[1], th = s[2], vx = s[3], vz = s[4];
    const float dt = p.dt;
    const float tm = fmaxf(p.thrust_scale * act[0], 0.0f) * c.inv_m;
    float hz, hx;
    sincosf(th + kHalfPi, &hz, &hx);
    const float ax = tm * hx;
    const float az = tm * hz + p.gravity;
    const float nx = x + vx * dt + 0.5f * ax * dt * dt;  // old velocity (Q3)
    const float nz = z + vz * dt + 0.5f * az * dt * dt;
    const float nvx = vx + ax * dt;
    const float nvz = vz + az * dt;
    s[0] = nx; s[1] = nz; s[2] = th + act[1] * dt; s[3] = nvx; s[4] = nvz;
    const float pn2 = nx * nx + nz * nz;
    const float vn2 = nvx * nvx + nvz * nvz;
    done = (pn2 > c.pos_lim2) || (vn2 > 100.0f) || (vn2 > c.vel_lim2);
    counted = done;
    return done ? 1.0f : -sqrtf(pn2);
  }
};

// quadrotor2d-slungload-v0: _slung2d_step_tiles (pallas_slungload.py:208-302),
// velocity-first Euler, on env_kinds.cuh's struct.
struct Slung2dLoop : reinmav::Slung2dEnv {
  struct Consts : reinmav::Slung2dEnv::Consts {
    float inv_m, pos_lim2, vel_lim2;
  };
  __device__ static Consts consts(const Params& p) {
    return {reinmav::Slung2dEnv::consts(p), __frcp_rn(p.mass), p.pos_limit * p.pos_limit,
            p.vel_limit * p.vel_limit};
  }
  // counted: the tether was taut at the start of the step.
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done, bool& counted) {
    const float x = s[0], z = s[1], th = s[2], vx = s[3], vz = s[4];
    const float lx = s[5], lz = s[6], lvx = s[7], lvz = s[8];
    const float thrust = act[0], w = act[1];
    const float dt = p.dt, g = p.gravity, L = p.tether_length, m = p.mass;
    float hz, hx;
    sincosf(th + kHalfPi, &hz, &hx);

    const float tx = lx - x, tz = lz - z;
    const float tn = sqrtf(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(tz, tz)));  // the knife edge
    const float inv = reinmav::safe_inv(tn);
    const float ux = tx * inv, uz = tz * inv;
    const bool taut = tn >= L;

    // The load: the taut branch's acceleration, free fall when slack.
    const float sc = m * L * (lvx * lvx + lvz * lvz);  // a scalar subtracted from a vector
    const float proj = ux * (thrust * hx - sc) + uz * (thrust * hz - sc);
    const float lax_t = proj * ux * c.inv_mml;
    const float laz_t = proj * uz * c.inv_mml + g;
    const float lax = taut ? lax_t : 0.0f;
    const float laz = taut ? laz_t : g;
    const float nlvx = lvx + lax * dt;  // velocity FIRST (Q3)
    const float nlvz = lvz + laz * dt;
    const float nlx = lx + nlvx * dt + 0.5f * lax * dt * dt;
    const float nlz = lz + nlvz * dt + 0.5f * laz * dt * dt;

    // The quad: thrust and the tether's pull, none when slack.
    const float dzg = laz_t - g;
    const float tmag = p.load_mass * sqrtf(lax_t * lax_t + dzg * dzg);
    const float fx = taut ? tmag * ux * c.inv_m : 0.0f;
    const float fz = taut ? tmag * uz * c.inv_m : 0.0f;
    const float tm = thrust * c.inv_m;
    const float ax = tm * hx + fx;
    const float az = tm * hz + g + fz;
    const float nvx = vx + ax * dt;
    const float nvz = vz + az * dt;
    const float npx = x + nvx * dt + 0.5f * ax * dt * dt;
    const float npz = z + nvz * dt + 0.5f * az * dt * dt;

    // The kinematic projection onto the tether circle, kept when taut.
    const float dx = nlx - npx, dz = nlz - npz;
    const float dinv = reinmav::safe_inv(sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dz, dz))));
    const float ddx = dx * dinv, ddz = dz * dinv;
    const float rad = (nlvx - nvx) * ddx + (nlvz - nvz) * ddz;
    s[0] = npx; s[1] = npz; s[2] = th + w * dt; s[3] = nvx; s[4] = nvz;
    s[5] = taut ? __fadd_rn(npx, __fmul_rn(ddx, L)) : nlx;
    s[6] = taut ? __fadd_rn(npz, __fmul_rn(ddz, L)) : nlz;
    s[7] = taut ? nlvx - rad * ddx : nlvx;
    s[8] = taut ? nlvz - rad * ddz : nlvz;
    const float lpn2 = s[5] * s[5] + s[6] * s[6];
    const float lvn2 = s[7] * s[7] + s[8] * s[8];
    done = (lpn2 > c.pos_lim2) || (lvn2 > c.vel_lim2);
    counted = taut;
    return done ? 1.0f : -sqrtf(npx * npx + npz * npz);
  }
};

// quadrotor3d-slungload-v0: _slung3d_step_tiles (pallas_slungload.py:76-192),
// position-first Euler, the quaternion update of quadrotor3d (Q4), on
// env_kinds.cuh's struct.
struct Slung3dLoop : reinmav::Slung3dEnv {
  struct Consts : reinmav::Slung3dEnv::Consts {
    float inv_m, pos_lim2, vel_lim2;
  };
  __device__ static Consts consts(const Params& p) {
    return {reinmav::Slung3dEnv::consts(p), __frcp_rn(p.mass), p.pos_limit * p.pos_limit,
            p.vel_limit * p.vel_limit};
  }
  // counted: the tether was taut at the start of the step.
  __device__ static float step(float (&s)[kD], const float (&act)[kA], const Params& p,
                               const Consts& c, bool& done, bool& counted) {
    const float px = s[0], py = s[1], pz = s[2];
    const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
    const float vx = s[7], vy = s[8], vz = s[9];
    const float lx = s[10], ly = s[11], lz = s[12], lvx = s[13], lvy = s[14], lvz = s[15];
    const float thrust = act[0], wx = act[1], wy = act[2], wz = act[3];
    const float dt = p.dt, g = p.gravity, L = p.tether_length, m = p.mass;
    const BodyZ bz = reinmav::body_z(s);

    const float tx = lx - px, ty = ly - py, tz = lz - pz;
    const float tn = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(tx, tx), __fmul_rn(ty, ty)),
                                     __fmul_rn(tz, tz)));  // the knife edge
    const float inv = reinmav::safe_inv(tn);
    const float ux = tx * inv, uy = ty * inv, uz = tz * inv;
    const bool taut = tn >= L;

    // The load: the taut branch's acceleration, free fall when slack.
    const float sc = m * L * (lvx * lvx + lvy * lvy + lvz * lvz);
    const float proj =
        ux * (thrust * bz.x - sc) + uy * (thrust * bz.y - sc) + uz * (thrust * bz.z - sc);
    const float lax_t = proj * ux * c.inv_mml;
    const float lay_t = proj * uy * c.inv_mml;
    const float laz_t = proj * uz * c.inv_mml + g;
    const float lax = taut ? lax_t : 0.0f;
    const float lay = taut ? lay_t : 0.0f;
    const float laz = taut ? laz_t : g;
    const float nlx = lx + lvx * dt + 0.5f * lax * dt * dt;  // position FIRST (old velocity)
    const float nly = ly + lvy * dt + 0.5f * lay * dt * dt;
    const float nlz = lz + lvz * dt + 0.5f * laz * dt * dt;
    const float nlvx = lvx + lax * dt, nlvy = lvy + lay * dt, nlvz = lvz + laz * dt;

    // The quad: thrust and the tether's pull, none when slack.
    const float dzg = laz_t - g;
    const float tmag = p.load_mass * sqrtf(lax_t * lax_t + lay_t * lay_t + dzg * dzg);
    const float fx = taut ? tmag * ux * c.inv_m : 0.0f;
    const float fy = taut ? tmag * uy * c.inv_m : 0.0f;
    const float fz = taut ? tmag * uz * c.inv_m : 0.0f;
    const float tm = thrust * c.inv_m;
    const float ax = tm * bz.x + fx;
    const float ay = tm * bz.y + fy;
    const float az = tm * bz.z + g + fz;
    const float npx = px + vx * dt + 0.5f * ax * dt * dt;
    const float npy = py + vy * dt + 0.5f * ay * dt * dt;
    const float npz = pz + vz * dt + 0.5f * az * dt * dt;
    const float nvx = vx + ax * dt, nvy = vy + ay * dt, nvz = vz + az * dt;

    // The kinematic projection onto the tether sphere, kept when taut.
    const float dx = nlx - npx, dy = nly - npy, dz = nlz - npz;
    const float dinv = reinmav::safe_inv(sqrtf(
        __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz))));
    const float ddx = dx * dinv, ddy = dy * dinv, ddz = dz * dinv;
    const float rad = (nlvx - nvx) * ddx + (nlvy - nvy) * ddy + (nlvz - nvz) * ddz;

    const float hw = qw * bz.inv_qn, hx = qx * bz.inv_qn, hy = qy * bz.inv_qn, hz = qz * bz.inv_qn;
    s[3] = qw + c.half_dt * (-hx * wx - hy * wy - hz * wz);
    s[4] = qx + c.half_dt * (hw * wx + hy * wz - hz * wy);
    s[5] = qy + c.half_dt * (hw * wy - hx * wz + hz * wx);
    s[6] = qz + c.half_dt * (hw * wz + hx * wy - hy * wx);
    s[0] = npx; s[1] = npy; s[2] = npz;
    s[7] = nvx; s[8] = nvy; s[9] = nvz;
    s[10] = taut ? __fadd_rn(npx, __fmul_rn(ddx, L)) : nlx;
    s[11] = taut ? __fadd_rn(npy, __fmul_rn(ddy, L)) : nly;
    s[12] = taut ? __fadd_rn(npz, __fmul_rn(ddz, L)) : nlz;
    s[13] = taut ? nlvx - rad * ddx : nlvx;
    s[14] = taut ? nlvy - rad * ddy : nlvy;
    s[15] = taut ? nlvz - rad * ddz : nlvz;
    const float lpn2 = s[10] * s[10] + s[11] * s[11] + s[12] * s[12];
    const float vn2 = nvx * nvx + nvy * nvy + nvz * nvz;
    done = (lpn2 > c.pos_lim2) || (vn2 > c.vel_lim2);
    counted = taut;
    return done ? 1.0f : -sqrtf(lpn2);
  }
};

// The controller's output of a loop: its Act type where it declares one
// (Quad3dLoop: the command with the body frame), else kA floats.
template <class Loop, class = void>
struct ActOf {
  using type = float[Loop::kA];
};
template <class Loop>
struct ActOf<Loop, std::void_t<typename Loop::Act>> {
  using type = typename Loop::Act;
};

// Whether a done env resets: the runtime flag, or the loop's compile-time one
// where it fixes it (Quad3dLoop).
template <class Loop, class = void>
struct ResetOn {
  __device__ static bool on(int autoreset) { return autoreset != 0; }
};
template <class Loop>
struct ResetOn<Loop, std::void_t<decltype(Loop::kFixedReset)>> {
  __device__ static constexpr bool on(int) { return Loop::kFixedReset; }
};

template <class Loop, bool kCount>
__global__ void __launch_bounds__(kThreads)
closed_loop_kernel(const float* __restrict__ s_in, float* __restrict__ s_out,
                   float* __restrict__ reward_out, int* __restrict__ counts, int64_t batch,
                   int horizon, uint32_t seed, int autoreset, typename Loop::Params p) {
  constexpr int kD = Loop::kD;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= batch) return;  // ragged tail
  const typename Loop::Consts c = Loop::consts(p);
  const uint32_t env = static_cast<uint32_t>(i);

  float s[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) s[d] = s_in[d * batch + i];
  float reward_sum = 0.0f;
  int count = 0;

  for (int t = 0; t < horizon; ++t) {
    typename ActOf<Loop>::type act;
    Loop::control(s, p, c, act);
    bool done, counted;
    reward_sum += Loop::step(s, act, p, c, done, counted);
    if (kCount) count += counted ? 1 : 0;
    if (ResetOn<Loop>::on(autoreset) && done) {
      reinmav::reset_uniform(s, env, static_cast<uint32_t>(t), seed, 0u);
    }
  }

#pragma unroll
  for (int d = 0; d < kD; ++d) s_out[d * batch + i] = s[d];
  reward_out[i] = reward_sum;
  if (kCount) counts[i] = count;
}

template <class Loop>
cudaError_t launch(const float* s_in, float* s_out, float* reward_out, int* counts,
                   int64_t batch, int horizon, uint32_t seed, int autoreset,
                   const float* params_host, int n_params, cudaStream_t stream) {
  if (n_params != Loop::kParams || batch <= 0) return cudaErrorInvalidValue;
  const auto blocks = static_cast<unsigned int>((batch + kThreads - 1) / kThreads);
  const typename Loop::Params p = Loop::params(params_host);
  if (counts != nullptr) {
    closed_loop_kernel<Loop, true><<<blocks, kThreads, 0, stream>>>(
        s_in, s_out, reward_out, counts, batch, horizon, seed, autoreset, p);
  } else {
    closed_loop_kernel<Loop, false><<<blocks, kThreads, 0, stream>>>(
        s_in, s_out, reward_out, nullptr, batch, horizon, seed, autoreset, p);
  }
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code.
// env_kind: 0 quadrotor3d-v0 (K1; params_host: the 11 floats of
// quad3d_params_vec, states (10, B)), 2 quadrotor2d-v0 (11 floats of
// quad2d_params_vec, (5, B)), 3 quadrotor2d-slungload-v0 (12 floats,
// (9, B)), 4 quadrotor3d-slungload-v0 (13 floats, (16, B)); any other kind,
// or another number of params, is refused with cudaErrorInvalidValue and
// nothing runs.  counts: null, or B int32 that receive each env's count
// (taut env-steps of the slung kinds, done env-steps of quad2d and
// quadrotor3d).
extern "C" int closed_loop_rollout_launch(int env_kind, const void* states_in, void* states_out,
                                          void* reward_out, void* counts, long long batch,
                                          int horizon, unsigned int seed, int autoreset,
                                          const void* params_host, int n_params, void* stream) {
  const auto* s_in = static_cast<const float*>(states_in);
  auto* s_out = static_cast<float*>(states_out);
  auto* r_out = static_cast<float*>(reward_out);
  auto* n_out = static_cast<int*>(counts);
  const auto* h = static_cast<const float*>(params_host);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (env_kind) {
    case reinmav::Quad3dEnv::kKind:
      err = autoreset ? launch<Quad3dLoop<true>>(s_in, s_out, r_out, n_out, batch, horizon, seed,
                                                 autoreset, h, n_params, st)
                      : launch<Quad3dLoop<false>>(s_in, s_out, r_out, n_out, batch, horizon,
                                                  seed, autoreset, h, n_params, st);
      break;
    case Quad2dLoop::kKind:
      err = launch<Quad2dLoop>(s_in, s_out, r_out, n_out, batch, horizon, seed, autoreset, h,
                               n_params, st);
      break;
    case Slung2dLoop::kKind:
      err = launch<Slung2dLoop>(s_in, s_out, r_out, n_out, batch, horizon, seed, autoreset, h,
                                n_params, st);
      break;
    case Slung3dLoop::kKind:
      err = launch<Slung3dLoop>(s_in, s_out, r_out, n_out, batch, horizon, seed, autoreset, h,
                                n_params, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
