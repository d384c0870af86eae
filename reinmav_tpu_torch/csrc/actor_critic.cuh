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

constexpr float kLog2Pi = 1.8378770664093453f;

}  // namespace ac
}  // namespace reinmav
