// C entry of the whole-model decode kernel (sm_90a). The kernel and its
// design are in decode_model.cuh; its instantiations for 1, 2, 4 and 8 batch
// rows are compiled in decode_model_b<BM>.cu. `sched` is the schedule table
// on the device (kernels/decode_model.py's `schedule()`), `sched_hdr` a host
// copy of its DM_HDR-int header, which must name this call's shapes.
#include "decode_model.cuh"

using namespace mnn;

MNN_API int mnn_decode_model(
    const void* x, const void* lengths, const void* cos, const void* sin,
    const void* wqkv_p, const void* wqkv_s, const void* wqkv_b, const void* qkv_bias,
    const void* wo_p, const void* wo_s, const void* wo_b,
    const void* wgu_p, const void* wgu_s, const void* wgu_b,
    const void* wdn_p, const void* wdn_s, const void* wdn_b,
    const void* in_norm, const void* post_norm, const void* q_norm, const void* k_norm,
    void* k_cache, void* v_cache, void* k_scale, void* v_scale,
    const void* final_norm, const void* head_p, const void* head_s, const void* head_b,
    void* x_out, void* k_rows, void* v_rows, void* k_sc, void* v_sc, void* logits,
    void* token, void* ws, void* counters, void* clocks,
    const void* pre_ffn, const void* post_ffn, const void* cos_l, const void* sin_l,
    int B, int L, int H, int NH, int Hkv, int D, int I, int S, int V, int bits, int bs_h,
    int bs_i, int head_bits, int bs_head, int kv_bits, int window, int sink,
    int write_cache, int ws_floats, int n_counters, int flags, int swa_p, float sm_scale,
    float eps, float softcap, const void* sched, const void* sched_hdr, void* stream) {
  const int gmax = D == 256 ? at_gmax<256>() : AT_GMAX;
  if (B < 1 || B > DM_MAXB || (D != 64 && D != 128 && D != 256) || Hkv < 1 || NH % Hkv ||
      NH / Hkv > gmax || (bits != 2 && bits != 3 && bits != 4 && bits != 8) || (D == 256 && kv_bits == 4) ||
      (kv_bits != 4 && kv_bits != 8 && kv_bits != 16) || bs_h % 32 || bs_i % 32 ||
      H % bs_h || (NH * D) % bs_h || I % bs_i || I % 64 || H % 4)
    return (int)cudaErrorInvalidValue;
  if (head_p && ((head_bits != 4 && head_bits != 8) || bs_head % 32 || H % bs_head || V % 4))
    return (int)cudaErrorInvalidValue;
  if (((flags & DM_SANDWICH) && (!pre_ffn || !post_ffn)) ||
      ((flags & DM_SWA_P) && (swa_p < 1 || !cos_l || !sin_l)) || (!(flags & DM_SWA_P) && swa_p) ||
      ((flags & DM_SOFTCAP) != 0) != (softcap > 0.f))
    return (int)cudaErrorInvalidValue;
  const int* hdr = static_cast<const int*>(sched_hdr);
  if (!sched || !hdr || hdr[H_MAGIC] != DM_MAGIC || hdr[H_B] != B || hdr[H_L] != L ||
      hdr[H_H] != H || hdr[H_NQ] != (NH + 2 * Hkv) * D || hdr[H_I] != I ||
      hdr[H_V] != (head_p ? V : 0) || hdr[H_BITS] != bits ||
      hdr[H_HEAD_BITS] != (head_p ? head_bits : 0) || hdr[H_D] != D || H > 128 * DM_TILE ||
      hdr[H_FLAGS] != flags || hdr[H_SWA_P] != swa_p)
    return (int)cudaErrorInvalidValue;
  DmParams p{};
  p.x = static_cast<const float*>(x);
  p.lengths = static_cast<const int*>(lengths);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.wqkv_p = static_cast<const uint8_t*>(wqkv_p);
  p.wqkv_s = static_cast<const bf16*>(wqkv_s);
  p.wqkv_b = static_cast<const bf16*>(wqkv_b);
  p.qkv_bias = static_cast<const float*>(qkv_bias);
  p.wo_p = static_cast<const uint8_t*>(wo_p);
  p.wo_s = static_cast<const bf16*>(wo_s);
  p.wo_b = static_cast<const bf16*>(wo_b);
  p.wgu_p = static_cast<const uint8_t*>(wgu_p);
  p.wgu_s = static_cast<const bf16*>(wgu_s);
  p.wgu_b = static_cast<const bf16*>(wgu_b);
  p.wdn_p = static_cast<const uint8_t*>(wdn_p);
  p.wdn_s = static_cast<const bf16*>(wdn_s);
  p.wdn_b = static_cast<const bf16*>(wdn_b);
  p.in_norm = static_cast<const float*>(in_norm);
  p.post_norm = static_cast<const float*>(post_norm);
  p.q_norm = static_cast<const float*>(q_norm);
  p.k_norm = static_cast<const float*>(k_norm);
  p.pre_ffn = static_cast<const float*>(pre_ffn);
  p.post_ffn = static_cast<const float*>(post_ffn);
  p.cos_l = static_cast<const float*>(cos_l);
  p.sin_l = static_cast<const float*>(sin_l);
  p.k_cache = static_cast<uint8_t*>(k_cache);
  p.v_cache = static_cast<uint8_t*>(v_cache);
  p.k_scale = static_cast<float*>(k_scale);
  p.v_scale = static_cast<float*>(v_scale);
  p.final_norm = static_cast<const float*>(final_norm);
  p.head_p = static_cast<const uint8_t*>(head_p);
  p.head_s = static_cast<const bf16*>(head_s);
  p.head_b = static_cast<const bf16*>(head_b);
  p.x_out = static_cast<float*>(x_out);
  p.k_rows = static_cast<float*>(k_rows);
  p.v_rows = static_cast<float*>(v_rows);
  p.k_sc = static_cast<float*>(k_sc);
  p.v_sc = static_cast<float*>(v_sc);
  p.logits = static_cast<float*>(logits);
  p.token = static_cast<int*>(token);
  p.counters = static_cast<unsigned*>(counters);
  p.sched = static_cast<const int*>(sched);
  p.clocks = static_cast<long long*>(clocks);
  p.B = B; p.L = L; p.H = H; p.NH = NH; p.Hkv = Hkv; p.D = D; p.I = I; p.S = S; p.V = V;
  p.NQ = (NH + 2 * Hkv) * D;
  p.DQ = NH * D;
  p.bits = bits; p.bs_h = bs_h; p.bs_i = bs_i; p.head_bits = head_bits; p.bs_head = bs_head;
  p.kv_bits = kv_bits; p.window = window; p.sink = sink; p.write_cache = write_cache;
  p.sm_scale = sm_scale; p.eps = eps; p.softcap = softcap;
  p.flags = flags; p.swa_p = swa_p;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  const int bm = B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : 8;
  switch (bm) {
    case 1: return launch_b1(p, wsf, ws_floats, n_counters, hdr, st);
    case 2: return launch_b2(p, wsf, ws_floats, n_counters, hdr, st);
    case 4: return launch_b4(p, wsf, ws_floats, n_counters, hdr, st);
    default: return launch_b8(p, wsf, ws_floats, n_counters, hdr, st);
  }
}

// What the kernel for B batch rows at head dim D and the layers' weight bits
// gets on this card: out = {blocks an SM, shared bytes a block, ring slots,
// SMs, registers a thread, most threads a block, static shared bytes, local
// bytes a thread}. The schedule is built for the first four (grid = blocks
// an SM x SMs).
MNN_API int mnn_decode_model_limits(int B, int D, int bits, int* out) {
  if (B < 1 || B > DM_MAXB || (D != 64 && D != 128 && D != 256) ||
      (bits != 2 && bits != 3 && bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const int bm = B == 1 ? 1 : B == 2 ? 2 : B <= 4 ? 4 : 8;
  switch (bm) {
    case 1: return limits_b1(D, bits, out);
    case 2: return limits_b2(D, bits, out);
    case 4: return limits_b4(D, bits, out);
    default: return limits_b8(D, bits, out);
  }
}
