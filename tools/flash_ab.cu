// Row 9 at head dim 256, for tools/flash_ab.py: the port's
// src/repro_torch/kernels/csrc/flash_attention.cu compiled whole, and one
// more entry that launches flash_tc_kernel (the 64-row design of head dims
// 64 and 128) at 256, the data point the port's flash_wide_kernel was
// designed against.  It is not part of the port.
#include "flash_attention.cu"

// The arguments of repro_flash_attention_tc at D = 256, launching
// flash_tc_kernel<256>.
REPRO_EXPORT int ab_flash_attention_tc256(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Hq, int Hkv, int Sq, int Skv,
                                          int causal, int window,
                                          float scale, float softcap,
                                          void* stream) {
  return static_cast<int>(
      launch_tc<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, scale,
                     softcap, static_cast<cudaStream_t>(stream)));
}
