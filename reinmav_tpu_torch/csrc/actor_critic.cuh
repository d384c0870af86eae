// The flat parameter vector of the 2x64 tanh actor-critic, as K2
// (ppo_rollout.cu) and K3/K4 (ppo_loss.cu, ppo_update.cu) read it and K3/K4
// write its gradient, for an observation of D dims and an action of A:
// Layout<10, 4> for quadrotor3d-v0, Layout<13, 4> for the tpuquad family,
// Layout<5, 2>, Layout<9, 2> and Layout<16, 4> for quadrotor2d-v0 and the
// two slung-load envs.
//
// The layout is reinmav_tpu_torch/rl/networks.py::Layout: the JAX params
// pytree's leaves in jax.tree.leaves order, each raveled row-major, with
// weights as (in, out):
//   log_std (A),
//   pi[0].b (H), pi[0].w (D, H), pi[1].b (H), pi[1].w (H, H),
//   pi_out.b (A), pi_out.w (H, A),
//   vf[0].b (H), vf[0].w (D, H), vf[1].b (H), vf[1].w (H, H),
//   vf_out.b (1), vf_out.w (H, 1).
// The kernels take the two towers' blocks as they are: the block-diagonal
// zeros of the fused (2H, 2H) layer of networks.fused_weights, which the
// TPU kernels multiply, are neither stored nor computed here.

#pragma once

namespace reinmav {
namespace ac {

constexpr int H = 64;  // hidden width of each tower

template <int kD, int kA>
struct Layout {
  static constexpr int D = kD;  // obs dim
  static constexpr int A = kA;  // action dim
  static constexpr int kLogStd = 0;
  // Offsets inside a tower, from its base.
  static constexpr int kB1 = 0;
  static constexpr int kW1 = kB1 + H;
  static constexpr int kB2 = kW1 + D * H;
  static constexpr int kW2 = kB2 + H;
  static constexpr int kTowerHidden = kW2 + H * H;

  static constexpr int kPi = kLogStd + A;
  static constexpr int kPiOutB = kPi + kTowerHidden;
  static constexpr int kPiOutW = kPiOutB + A;
  static constexpr int kVf = kPiOutW + H * A;
  static constexpr int kVfOutB = kVf + kTowerHidden;
  static constexpr int kVfOutW = kVfOutB + 1;
  static constexpr int kNetSize = kVfOutW + H;

  __host__ __device__ static constexpr int tower_base(int tower) { return tower == 0 ? kPi : kVf; }
};

// The same layout for two equal hidden layers of any width h, its offsets
// computed at run time from (D, A, h): the wide K3/K4 instances'
// (ppo_loss_body_wide.cuh), which take the widths as arguments.  Its
// offsets are ops/ppo_loss.py::wide_layout's, which a CPU test holds to
// networks.Layout; the 64-wide instances and K2/K6 keep Layout<kD, kA>.
struct RtLayout {
  int D, A, H;
  int w1, b2, w2, tower_hidden;  // inside a tower, from its base (b1 at 0)
  int pi, pi_out_b, pi_out_w, vf, vf_out_b, vf_out_w, net_size;

  __host__ __device__ RtLayout(int d, int a, int h) : D(d), A(a), H(h) {
    w1 = h;
    b2 = w1 + d * h;
    w2 = b2 + h;
    tower_hidden = w2 + h * h;
    pi = a;  // log_std at 0
    pi_out_b = pi + tower_hidden;
    pi_out_w = pi_out_b + a;
    vf = pi_out_w + h * a;
    vf_out_b = vf + tower_hidden;
    vf_out_w = vf_out_b + 1;
    net_size = vf_out_w + h;
  }

  __host__ __device__ int tower_base(int tower) const { return tower == 0 ? pi : vf; }
};

constexpr float kLog2Pi = 1.8378770664093453f;

}  // namespace ac
}  // namespace reinmav
