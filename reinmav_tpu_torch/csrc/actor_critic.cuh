// The flat parameter vector of the 2x64 tanh actor-critic, as K2
// (ppo_rollout.cu) and K3 (ppo_loss.cu) read it and K3 writes its gradient.
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

constexpr int D = 10;  // obs dim (quadrotor3d-v0)
constexpr int A = 4;   // action dim
constexpr int H = 64;  // hidden width of each tower

constexpr int kLogStd = 0;
// Offsets inside a tower, from its base.
constexpr int kB1 = 0;
constexpr int kW1 = kB1 + H;
constexpr int kB2 = kW1 + D * H;
constexpr int kW2 = kB2 + H;
constexpr int kTowerHidden = kW2 + H * H;

constexpr int kPi = kLogStd + A;
constexpr int kPiOutB = kPi + kTowerHidden;
constexpr int kPiOutW = kPiOutB + A;
constexpr int kVf = kPiOutW + H * A;
constexpr int kVfOutB = kVf + kTowerHidden;
constexpr int kVfOutW = kVfOutB + 1;
constexpr int kNetSize = kVfOutW + H;

__host__ __device__ constexpr int tower_base(int tower) { return tower == 0 ? kPi : kVf; }

constexpr float kLog2Pi = 1.8378770664093453f;

}  // namespace ac
}  // namespace reinmav
