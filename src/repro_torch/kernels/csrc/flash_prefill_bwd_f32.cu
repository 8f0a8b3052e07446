// The attention backward in f32: the f32 instances of prefill_bwd.cuh,
// which says what the kernels compute and how. flash_prefill_bwd.cu builds
// the bf16 ones.
#include "prefill_bwd.cuh"

extern "C" int flash_prefill_bwd_f32_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dlt,
    const int* q_pos, const int* kv_len, int B, int Sq, int Sk, int H, int KV,
    int hd, int window, float scale, float softcap, int dtype, void* stream) {
  return bwd::entry<float>(q, k, v, out, dout, dq, dk, dv, lse, dlt, q_pos,
                           kv_len, B, Sq, Sk, H, KV, hd, window, scale,
                           softcap, dtype, stream);
}
