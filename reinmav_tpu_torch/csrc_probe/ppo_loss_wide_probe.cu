// K3 wide with the body's phase probe on (ppo_loss_body_wide.cuh,
// REINMAV_WIDE_PROBE): the same kernel and C interface, built apart into a
// library of its own (reinmav_tpu_torch/_build.py::load_probe_library) that
// no training path loads; chip_smoke.py --only wide runs it.  Thread 0 of
// each CTA adds its clock64 cycles by phase into the buffer given to
// ppo_wide_probe_set (kProbePhases a CTA, zeroed by the caller); with a
// buffer given to ppo_wide_probe_miss (10 uint64, zeroed), the bf16
// instance counts the h's it recomputed, those the window missed, and
// those farther from the twin's chain than a quarter and half the window.

#define REINMAV_WIDE_PROBE 1
#include "../csrc/ppo_loss_wide.cu"

extern "C" int ppo_wide_probe_set(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(reinmav::ppo_wide::g_wide_probe, &buf, sizeof(buf)));
}

extern "C" int ppo_wide_probe_phases() { return reinmav::ppo_wide::kProbePhases; }

extern "C" int ppo_wide_probe_miss(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(reinmav::ppo_wide::g_wide_miss, &buf, sizeof(buf)));
}
