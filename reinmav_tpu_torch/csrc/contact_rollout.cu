// K11: the constant-action rollout of the contact envs, MujocoQuadForce-v0
// and MujocoQuadQuat-v0, with MuJoCo's coupled plane contact solved in the
// kernel, written for NVIDIA Hopper (sm_90a).
//
// Replaces reinmav_tpu/ops/pallas_tpuquad.py::contact_rollout_pallas8 (:588,
// pallas_call :602): _contact_kernel (:542), _rigid_substep (:348) with
// contact=True, _coupled_contact (:154), _candidate_sum (:137), _impedance
// (:131) and the candidate geometry (_arm_corners, :78).  Per env and step:
// frame_skip substeps, each with the constant action's wrench (the force
// model's motor mix, or the quat model's central thrust and its kv rate
// servos, re-evaluated in every substep), the fluid drag, the contact solve
// on the unconstrained accelerations, the CoM-offset coupling and the
// exp-map quaternion; Σz += z; a non-finite state resets to (0, 0, init_z)
// at rest.  The contact solve: 48 candidate points (8 core-box corners, 8
// thruster-cap rim points along the guarded steepest-descent direction, 32
// arm-box corners) x 4 pyramid rows n +- mu t, the impedance spline, the
// regulariser Ri = (1 - d) / d kappa, and pgs_iters sweeps of the hybrid
// projected Gauss-Seidel (Gauss-Seidel across the four row types in the
// order (t1, +), (t1, -), (t2, +), (t2, -); mass-split Jacobi across the
// candidates, w = 1 / max(1, n_active)).  Its plain PyTorch twin is
// reinmav_tpu_torch/ops/contact_rollout.py::contact_rollout_reference.
//
// What bounds it on the card: arithmetic.  A contact substep is about 190
// FP32 operations of setup per candidate and, per sweep stage, about 22
// per candidate and four sums over the candidates; 120 sweeps x 4 stages
// make about 1.8 x 10^5 operations per substep on the 16-candidate tier.
// The env's 13 floats cross device memory once per ROLLOUT.  In this
// design the sums, not the FP32 units, set the pace: each stage's four
// sums are 20 warp shuffles, and an SM completes one warp-wide shuffle a
// clock.
//
// What the design does about it: ONE WARP PER ENV.  The TPU kernel keeps,
// per env, about 1,250 loop-invariant floats over the 48 candidates (the
// activity, Ri, and per stage the arm, b and 1 / diag, and the running f):
// one thread cannot hold that in registers.  Here lane l owns candidate l
// and candidate 32 + (l & 15) (lanes 16-31 repeat lanes 0-15's second
// candidate, so every lane ends each sum with the same value), about 52
// floats a lane.  The env's state and the aggregate wrench (F, W) are
// replicated in every lane.  Each stage's four candidate sums are warp
// shuffles in _candidate_sum's order: the first 32 candidates by
// __shfl_xor_sync at offsets 16, 8, 4, 2, 1 (the pairwise halving
// x[:16] + x[16:], ...), candidates 32-47 at offsets 8, 4, 2, 1, then the
// two added.  An env with no arm corner below the plane skips its second
// candidates (the 16-candidate tier): the arm lanes of the first 32 add
// exact zeros, so this is bitwise the 48-candidate sweep; the choice is per
// warp, not the TPU kernel's per tile, and force48 turns it off for the
// check.  An env with no candidate below the plane skips the solve: its
// contact wrench is exactly zero, as the TPU kernel's sweep of masked rows
// gives.  All pgs_iters sweeps always run: the reference has no
// convergence exit.  The file is built with -fmad=false (_build.py) so that
// no product is contracted into an FMA: the twin's order is the kernel's,
// and the active test (z < 0), the f >= 0 projection and the spline's knot
// are knife edges that a last-bit difference moves.  The params (with the
// derived constants and the constant action's wrench, from float64 on the
// host) and the 48 candidates' body points are kernel arguments.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hover_common.cuh"

namespace {

using reinmav::HoverDrag;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCandidates = 48;
constexpr int kScalars = 33;
constexpr int kParams = kScalars + 3 * kCandidates;
// MuJoCo's soft-contact constants: solref (0.02, 1), solimp (0.9, 0.95, 0.001).
constexpr float kContactK = 2770.083102493075f;
constexpr float kContactB = 105.26315789473685f;
constexpr float kImpD0 = 0.9f;
constexpr float kImpSpan = static_cast<float>(0.95 - 0.9);
constexpr float kInvWidth = static_cast<float>(1.0 / 0.001);

// Field order of reinmav_tpu_torch/ops/contact_rollout.py::SCALAR_FIELDS,
// then the candidates' body points.
struct ContactParams {
  float mass, ix, iy, iz, cz, inv_m, inv_ix, inv_iy, inv_iz, gm, dt, init_z;
  float mu, kappa, ee_inv_m, cap_r;
  HoverDrag drag;  // kv, kt, fdx, fdy, fdz, tdx, tdy, tdz
  float total, mx, my, mz, servo, servo_kv, cmd0, cmd1, cmd2;
  float pts[3 * kCandidates];
};
static_assert(sizeof(ContactParams) == kParams * sizeof(float), "params layout");

// One semi-implicit Euler substep of s = [p(3) q(4) v(3) w(3)] in pieces
// (pallas_tpuquad.py::_rigid_substep), so that the contact solve runs
// between the free wrench and the integration: the arithmetic of
// hover_common.cuh::hover_substep, which stays whole there (K5, K6-hover and
// K7 built from these pieces were no longer bitwise their earlier selves:
// nvcc contracted other products into FMAs).  The two copies are kept in
// step by hand; tests/test_torch_contact_rollout.py::
// test_rigid_substep_is_the_hover_substep and
// tests/test_torch_cuda_reinmav_contact.py::test_k11_in_flight_is_k5 hold
// them to each other.

// The rotation matrix of the quaternion s[3:7], row-major, from 1 / |q|^2.
__device__ __forceinline__ void rigid_rotation(const float (&s)[13], float (&r)[9]) {
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float qn2 = qw * qw + qx * qx + qy * qy + qz * qz;
  const float inv = 1.0f / qn2;
  r[0] = 1.0f - 2.0f * (qy * qy + qz * qz) * inv;
  r[1] = 2.0f * (qx * qy - qz * qw) * inv;
  r[2] = 2.0f * (qx * qz + qy * qw) * inv;
  r[3] = 2.0f * (qx * qy + qz * qw) * inv;
  r[4] = 1.0f - 2.0f * (qx * qx + qz * qz) * inv;
  r[5] = 2.0f * (qy * qz - qx * qw) * inv;
  r[6] = 2.0f * (qx * qz - qy * qw) * inv;
  r[7] = 2.0f * (qy * qz + qx * qw) * inv;
  r[8] = 1.0f - 2.0f * (qx * qx + qy * qy) * inv;
}

// The free body's wrench: the thrust total along body z, the gravity force
// gm, the body torque t0 and the fluid drag at the CoM.  f in the world
// frame, t in the body frame.
__device__ __forceinline__ void rigid_free_wrench(const float (&s)[13], const float (&r)[9],
                                                  float total, float gm, const float (&t0)[3],
                                                  float cz, const HoverDrag& k, float (&f)[3],
                                                  float (&t)[3]) {
  const float vx = s[7], vy = s[8], vz = s[9];
  const float ox = s[10], oy = s[11], oz = s[12];
  f[0] = r[2] * total;
  f[1] = r[5] * total;
  f[2] = r[8] * total + gm;

  // Fluid drag (body frame): v_com_b = R^T v + w x c, c = (0, 0, cz).
  const float vb0 = r[0] * vx + r[3] * vy + r[6] * vz + oy * cz;
  const float vb1 = r[1] * vx + r[4] * vy + r[7] * vz - ox * cz;
  const float vb2 = r[2] * vx + r[5] * vy + r[8] * vz;
  const float fb0 = -k.kv * vb0 - k.fx * fabsf(vb0) * vb0;
  const float fb1 = -k.kv * vb1 - k.fy * fabsf(vb1) * vb1;
  const float fb2 = -k.kv * vb2 - k.fz * fabsf(vb2) * vb2;
  t[0] = t0[0] - k.kt * ox - k.tx * fabsf(ox) * ox;
  t[1] = t0[1] - k.kt * oy - k.ty * fabsf(oy) * oy;
  t[2] = t0[2] - k.kt * oz - k.tz * fabsf(oz) * oz;
  f[0] = f[0] + r[0] * fb0 + r[1] * fb1 + r[2] * fb2;
  f[1] = f[1] + r[3] * fb0 + r[4] * fb1 + r[5] * fb2;
  f[2] = f[2] + r[6] * fb0 + r[7] * fb1 + r[8] * fb2;
}

// The gyroscopic term w x (I w), I = diag(ix, iy, iz).
__device__ __forceinline__ void rigid_gyro(const float (&s)[13], float ix, float iy, float iz,
                                           float (&gy)[3]) {
  const float ox = s[10], oy = s[11], oz = s[12];
  gy[0] = oy * (iz * oz) - oz * (iy * oy);
  gy[1] = oz * (ix * ox) - ox * (iz * oz);
  gy[2] = ox * (iy * oy) - oy * (ix * ox);
}

// The integration under the wrench (f, t), in place: the angular
// acceleration, the CoM-offset origin coupling, velocities first, positions
// from the new velocities, the exp-map quaternion update.
__device__ __forceinline__ void rigid_integrate(float (&s)[13], const float (&r)[9],
                                                const float (&f)[3], const float (&t)[3],
                                                const float (&gy)[3], float ix, float iy, float iz,
                                                float cz, float mass, float dt) {
  const float px = s[0], py = s[1], pz = s[2];
  const float qw = s[3], qx = s[4], qy = s[5], qz = s[6];
  const float vx = s[7], vy = s[8], vz = s[9];
  const float ox = s[10], oy = s[11], oz = s[12];
  const float odx = (t[0] - gy[0]) / ix;
  const float ody = (t[1] - gy[1]) / iy;
  const float odz = (t[2] - gy[2]) / iz;
  // Origin coupling: a_o = a_c - R (alpha x c + w x (w x c)).
  const float uc0 = (ody + oz * ox) * cz;
  const float uc1 = (-odx + oz * oy) * cz;
  const float uc2 = -(ox * ox + oy * oy) * cz;
  const float accx = f[0] / mass - (r[0] * uc0 + r[1] * uc1 + r[2] * uc2);
  const float accy = f[1] / mass - (r[3] * uc0 + r[4] * uc1 + r[5] * uc2);
  const float accz = f[2] / mass - (r[6] * uc0 + r[7] * uc1 + r[8] * uc2);

  const float nvx = vx + accx * dt, nvy = vy + accy * dt, nvz = vz + accz * dt;
  const float nox = ox + odx * dt, noy = oy + ody * dt, noz = oz + odz * dt;

  // Exp-map quaternion update: q (x) exp(w dt / 2), renormalised.
  const float rx = nox * dt, ry = noy * dt, rz = noz * dt;
  const float ang = sqrtf(rx * rx + ry * ry + rz * rz);
  const float half = 0.5f * ang;
  const float sinc_half = ang > 1e-9f ? sinf(half) / ang : 0.5f;
  const float dw = cosf(half);
  const float ex = rx * sinc_half, ey = ry * sinc_half, ez = rz * sinc_half;
  const float mqw = qw * dw - qx * ex - qy * ey - qz * ez;
  const float mqx = qw * ex + qx * dw + qy * ez - qz * ey;
  const float mqy = qw * ey - qx * ez + qy * dw + qz * ex;
  const float mqz = qw * ez + qx * ey - qy * ex + qz * dw;
  const float inv_n = rsqrtf(mqw * mqw + mqx * mqx + mqy * mqy + mqz * mqz);

  s[0] = px + nvx * dt;
  s[1] = py + nvy * dt;
  s[2] = pz + nvz * dt;
  s[3] = mqw * inv_n;
  s[4] = mqx * inv_n;
  s[5] = mqy * inv_n;
  s[6] = mqz * inv_n;
  s[7] = nvx;
  s[8] = nvy;
  s[9] = nvz;
  s[10] = nox;
  s[11] = noy;
  s[12] = noz;
}

// One candidate's loop-invariant data and its running forces, per stage k
// (the pyramid rows (t1, +), (t1, -), (t2, +), (t2, -)).
struct Candidate {
  bool act;
  float Ri;
  float arm[4][3], b[4], rd[4], f[4];
};

// The env's quantities every candidate's setup reads.
struct Frame {
  float r[9], pz, vx, vy, vz, ox, oy, oz, al0x, al0y, al0z, aox, aoy, aoz, uwx, uwy, uwz;
};

__device__ __forceinline__ float clip01(float x) {
  x = x < 0.0f ? 0.0f : x;  // NaN passes, as jnp.clip's
  return x > 1.0f ? 1.0f : x;
}

// The candidate at body point (bx, by, bz), a thruster cap's rim point when
// cap (_coupled_contact's per-candidate arithmetic, :201-266).
__device__ __forceinline__ void setup(Candidate& c, float bx, float by, float bz, bool cap,
                                      const Frame& e, const ContactParams& p) {
  const float* r = e.r;
  float rwx = r[0] * bx + r[1] * by + r[2] * bz;
  float rwy = r[3] * bx + r[4] * by + r[5] * bz;
  float rwz = r[6] * bx + r[7] * by + r[8] * bz;
  if (cap) {
    rwx = rwx + p.cap_r * e.uwx;
    rwy = rwy + p.cap_r * e.uwy;
    rwz = rwz + p.cap_r * e.uwz;
  }
  const float zc = e.pz + rwz;
  c.act = zc < 0.0f;
  const float pen = -zc;
  // The contact midpoint relative to the origin: (rwx, rwy, (rwz - pz) / 2).
  const float mzz = 0.5f * (rwz - e.pz);
  const float rbx = r[0] * rwx + r[3] * rwy + r[6] * mzz;
  const float rby = r[1] * rwx + r[4] * rwy + r[7] * mzz;
  const float rbz = r[2] * rwx + r[5] * rwy + r[8] * mzz;
  const float rhx = rbx, rhy = rby, rhz = rbz - p.cz;
  // v_pt = vel + R (w x r_b); a_pt0 = a_o0 + R (alpha0 x r_b).
  const float cbx = e.oy * rbz - e.oz * rby;
  const float cby = e.oz * rbx - e.ox * rbz;
  const float cbz = e.ox * rby - e.oy * rbx;
  const float vpx = e.vx + r[0] * cbx + r[1] * cby + r[2] * cbz;
  const float vpy = e.vy + r[3] * cbx + r[4] * cby + r[5] * cbz;
  const float vpz = e.vz + r[6] * cbx + r[7] * cby + r[8] * cbz;
  const float abx = e.al0y * rbz - e.al0z * rby;
  const float aby = e.al0z * rbx - e.al0x * rbz;
  const float abz = e.al0x * rby - e.al0y * rbx;
  const float apx = e.aox + r[0] * abx + r[1] * aby + r[2] * abz;
  const float apy = e.aoy + r[3] * abx + r[4] * aby + r[5] * abz;
  const float apz = e.aoz + r[6] * abx + r[7] * aby + r[8] * abz;
  // The impedance spline d(pen) and the regulariser.
  const float x = clip01(pen * kInvWidth);
  const float s = x <= 0.5f ? 2.0f * x * x : 1.0f - 2.0f * (1.0f - x) * (1.0f - x);
  const float d = kImpD0 + s * kImpSpan;
  const float dKpen = d * kContactK * pen;
  c.Ri = (1.0f - d) / d * p.kappa;
  // Arms rho x (R^T e): nb / t1b are rows 2 / 1 of R, t2b is -row 0.
  const float aN[3] = {rhy * r[8] - rhz * r[7], rhz * r[6] - rhx * r[8], rhx * r[7] - rhy * r[6]};
  const float aT1[3] = {rhy * r[5] - rhz * r[4], rhz * r[3] - rhx * r[5],
                        rhx * r[4] - rhy * r[3]};
  const float aT2[3] = {rhz * r[1] - rhy * r[2], rhx * r[2] - rhz * r[0],
                        rhy * r[0] - rhx * r[1]};
  // The b rows decompose as P +- mu Q_j.
  const float P = apz - dKpen + kContactB * vpz;
  const float Q1 = apy + kContactB * vpy;
  const float Q2 = -(apx + kContactB * vpx);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float smu = (k & 1) ? -p.mu : p.mu;
    const float* aT = k < 2 ? aT1 : aT2;
#pragma unroll
    for (int i = 0; i < 3; ++i) c.arm[k][i] = aN[i] + smu * aT[i];
    const float diag = p.ee_inv_m + c.arm[k][0] * c.arm[k][0] * p.inv_ix +
                       c.arm[k][1] * c.arm[k][1] * p.inv_iy + c.arm[k][2] * c.arm[k][2] * p.inv_iz +
                       c.Ri;
    c.rd[k] = 1.0f / diag;
    c.b[k] = P + smu * (k < 2 ? Q1 : Q2);
    c.f[k] = 0.0f;
  }
}

// One projected update of the candidate's row k; returns its df.
__device__ __forceinline__ float update(Candidate& c, int k, float eFm, float Wx, float Wy,
                                        float Wz, float w) {
  const float Af = eFm + c.arm[k][0] * Wx + c.arm[k][1] * Wy + c.arm[k][2] * Wz;
  float nf = c.f[k] - w * (Af + c.Ri * c.f[k] + c.b[k]) * c.rd[k];
  nf = nf < 0.0f ? 0.0f : nf;
  const float df = c.act ? nf - c.f[k] : 0.0f;
  c.f[k] = c.f[k] + df;
  return df;
}

// _candidate_sum's halving over the warp's first 32 candidates (lane l holds
// candidate l) and over candidates 32-47 (lane l holds candidate 32 + (l &
// 15)).  Every lane ends with the same bits: each add is commutative.
__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = v + __shfl_xor_sync(kFull, v, off);
  return v;
}

// The coupled contact solve of the warp's env: adds the contact wrench to the
// unconstrained force f and torque t (_coupled_contact).  Returns the tier
// it ran: 0 no contact, 1 the first 16 candidates, 2 all 48.
__device__ __forceinline__ int coupled_contact(const float (&s)[13], const float (&r)[9],
                                                float (&f)[3], float (&t)[3], const float (&gy)[3],
                                                const ContactParams& p, const float (&b0)[3],
                                                const float (&b1)[3], bool cap0, int pgs_iters,
                                                bool force48, int lane) {
  Frame e;
#pragma unroll
  for (int i = 0; i < 9; ++i) e.r[i] = r[i];
  e.pz = s[2];
  e.vx = s[7], e.vy = s[8], e.vz = s[9];
  e.ox = s[10], e.oy = s[11], e.oz = s[12];
  const float ox = e.ox, oy = e.oy, oz = e.oz;
  // Unconstrained accelerations; a_o0 in ORIGIN coordinates.
  const float a0x = f[0] * p.inv_m, a0y = f[1] * p.inv_m, a0z = f[2] * p.inv_m;
  e.al0x = (t[0] - gy[0]) * p.inv_ix;
  e.al0y = (t[1] - gy[1]) * p.inv_iy;
  e.al0z = (t[2] - gy[2]) * p.inv_iz;
  const float u0 = (e.al0y + oz * ox) * p.cz;
  const float u1 = (-e.al0x + oz * oy) * p.cz;
  const float u2 = -(ox * ox + oy * oy) * p.cz;
  e.aox = a0x - (r[0] * u0 + r[1] * u1 + r[2] * u2);
  e.aoy = a0y - (r[3] * u0 + r[4] * u1 + r[5] * u2);
  e.aoz = a0z - (r[6] * u0 + r[7] * u1 + r[8] * u2);
  // The thruster caps' rim direction (radial steepest descent, guarded).
  float uwx = r[8] * r[2], uwy = r[8] * r[5], uwz = r[8] * r[8] - 1.0f;
  const float nu2 = uwx * uwx + uwy * uwy + uwz * uwz;
  const float inv_nu = nu2 > 1e-24f ? rsqrtf(fmaxf(nu2, 1e-30f)) : 0.0f;
  e.uwx = uwx * inv_nu, e.uwy = uwy * inv_nu, e.uwz = uwz * inv_nu;

  Candidate c0, c1;
  setup(c0, b0[0], b0[1], b0[2], cap0, e, p);
  setup(c1, b1[0], b1[1], b1[2], false, e, p);
  if (!__any_sync(kFull, c0.act || c1.act)) return 0;  // no contact: the wrench is zero
  // The 48-candidate tier where an arm corner (candidates 16-47) is below.
  const bool wide = force48 || __any_sync(kFull, (lane >= 16 && c0.act) || c1.act);
  float n_act = sum32(c0.act ? 1.0f : 0.0f);
  if (wide) n_act = n_act + sum16(c1.act ? 1.0f : 0.0f);
  const float w = 1.0f / fmaxf(1.0f, n_act);

  float Fx = 0.0f, Fy = 0.0f, Fz = 0.0f, Wx = 0.0f, Wy = 0.0f, Wz = 0.0f;
  for (int it = 0; it < pgs_iters; ++it) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float smu = (k & 1) ? -p.mu : p.mu;
      const float eF = Fz + smu * (k < 2 ? Fy : -Fx);
      const float eFm = eF * p.inv_m;
      const float df0 = update(c0, k, eFm, Wx, Wy, Wz, w);
      float sdf = sum32(df0);
      float s0 = sum32(c0.arm[k][0] * df0);
      float s1 = sum32(c0.arm[k][1] * df0);
      float s2 = sum32(c0.arm[k][2] * df0);
      if (wide) {
        const float df1 = update(c1, k, eFm, Wx, Wy, Wz, w);
        sdf = sdf + sum16(df1);
        s0 = s0 + sum16(c1.arm[k][0] * df1);
        s1 = s1 + sum16(c1.arm[k][1] * df1);
        s2 = s2 + sum16(c1.arm[k][2] * df1);
      }
      Fz = Fz + sdf;
      if (k < 2) {
        Fy = Fy + smu * sdf;
      } else {
        Fx = Fx - smu * sdf;
      }
      Wx = Wx + s0 * p.inv_ix;
      Wy = Wy + s1 * p.inv_iy;
      Wz = Wz + s2 * p.inv_iz;
    }
  }
  f[0] = f[0] + Fx;
  f[1] = f[1] + Fy;
  f[2] = f[2] + Fz;
  t[0] = t[0] + Wx * p.ix;
  t[1] = t[1] + Wy * p.iy;
  t[2] = t[2] + Wz * p.iz;
  return wide ? 2 : 1;
}

__global__ void __launch_bounds__(kThreads)
contact_rollout_kernel(const float* __restrict__ s_in, float* __restrict__ s_out,
                       float* __restrict__ z_out, int* __restrict__ tiers_out, int64_t batch,
                       int horizon, int frame_skip, int pgs_iters, int force48,
                       const ContactParams p) {
  const int lane = threadIdx.x & 31;
  const int64_t env = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (env >= batch) return;  // the whole warp: the ragged tail

  // This lane's two candidates: l, and 32 + (l & 15); the caps are 8-15.
  const int i0 = lane, i1 = 32 + (lane & 15);
  const float b0[3] = {p.pts[3 * i0], p.pts[3 * i0 + 1], p.pts[3 * i0 + 2]};
  const float b1[3] = {p.pts[3 * i1], p.pts[3 * i1 + 1], p.pts[3 * i1 + 2]};
  const bool cap0 = lane >= 8 && lane < 16;

  float s[13];
#pragma unroll
  for (int d = 0; d < 13; ++d) s[d] = s_in[d * batch + env];
  float z_sum = 0.0f;
  int tiers[3] = {0, 0, 0};

  for (int step = 0; step < horizon; ++step) {
    for (int fs = 0; fs < frame_skip; ++fs) {
      float r[9], f[3], t[3], gy[3];
      float t0[3] = {p.mx, p.my, p.mz};
      if (p.servo != 0.0f) {
        t0[0] = t0[0] + p.servo_kv * (p.cmd0 - s[10]);
        t0[1] = t0[1] + p.servo_kv * (p.cmd1 - s[11]);
        t0[2] = t0[2] + p.servo_kv * (p.cmd2 - s[12]);
      }
      rigid_rotation(s, r);
      rigid_free_wrench(s, r, p.total, p.gm, t0, p.cz, p.drag, f, t);
      rigid_gyro(s, p.ix, p.iy, p.iz, gy);
      ++tiers[coupled_contact(s, r, f, t, gy, p, b0, b1, cap0, pgs_iters, force48 != 0, lane)];
      rigid_integrate(s, r, f, t, gy, p.ix, p.iy, p.iz, p.cz, p.mass, p.dt);
    }
    float total = s[0];
#pragma unroll
    for (int d = 1; d < 13; ++d) total = total + s[d];
    z_sum = z_sum + s[2];
    if (!isfinite(total)) reinmav::hover_reset(s, p.init_z);
  }

  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 13; ++d) s_out[d * batch + env] = s[d];
    z_out[env] = z_sum;
    if (tiers_out != nullptr) {
#pragma unroll
      for (int k = 0; k < 3; ++k) tiers_out[3 * env + k] = tiers[k];
    }
  }
}

}  // namespace

// C interface, bound with ctypes (reinmav_tpu_torch/_build.py).  Launches on
// the given stream, does not synchronise, and returns a CUDA error code.
// params_host: the 177 floats of contact_params_vec; tiers: (B, 3) int32
// counts of the substeps that ran no solve, the 16- and the 48-candidate
// sweep, or null.  Another number of params, B <= 0 or pgs_iters < 0 is
// refused with cudaErrorInvalidValue and nothing runs.
extern "C" int contact_rollout_launch(const void* states_in, void* states_out, void* z_out,
                                      void* tiers, long long batch, int horizon, int frame_skip,
                                      int pgs_iters, int force48, const void* params_host,
                                      int n_params, void* stream) {
  if (n_params != kParams || batch <= 0 || pgs_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ContactParams p;
  const float* h = static_cast<const float*>(params_host);
  float* dst = reinterpret_cast<float*>(&p);
  for (int k = 0; k < kParams; ++k) dst[k] = h[k];
  const long long blocks = (batch + kWarps - 1) / kWarps;
  contact_rollout_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(states_in), static_cast<float*>(states_out),
      static_cast<float*>(z_out), static_cast<int*>(tiers), batch, horizon, frame_skip, pgs_iters,
      force48, p);
  return static_cast<int>(cudaGetLastError());
}
