// K3 wide with its float32 products as 1xTF32 (ppo_loss_body_wide.cuh,
// REINMAV_WIDE_ONE_TF32: hi hi alone, the lo terms of 3xTF32 dropped): the
// same kernel and C interface, built apart into a library of its own
// (reinmav_tpu_torch/_build.py::load_probe_library) that no training path
// loads.  chip_smoke.py --only wide holds it and the kernel library's
// 3xTF32 against the float64 twin, to show what the lo terms buy and
// whether the float32 gate tells the two apart.

#define REINMAV_WIDE_ONE_TF32 1
#include "../csrc/ppo_loss_wide.cu"
