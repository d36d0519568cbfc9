// The launch plan and shared-memory layout of the two decode kernels
// (ar_decode.cu, decode_step.cu; decode_common.cuh holds their body): the
// path, the rows a cluster decodes, the matrices every CTA holds whole, the
// float offsets of every region of a CTA's shared memory, and each CTA's
// weight image (which flat weight every float of its weight region holds).
//
// It is plain C++ apart from DEC_HD, so that the plan is written once: nvcc
// compiles it into each decode library, whose wrapper asks it for the plan
// and the image (mat_decode_plan, mat_decode_image); g++ compiles this file
// alone for the CPU tests (tests/test_torch_decode_plan.py), which hold the
// same code to the properties the kernels rely on.

#pragma once

#ifdef __CUDACC__
#define DEC_HD __host__ __device__
#else
#define DEC_HD
#endif

namespace dec {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kCluster = 4;              // CTAs a cluster
constexpr int kSmemLimit = 232448;       // dynamic shared memory a CTA may take on an H100

DEC_HD inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// k-slices of one column: the largest power of two <= 32 that keeps
// ks * nc <= kThreads (1 above 128 columns).
DEC_HD inline int k_slices(int nc) {
  int ks = 1;
  while (ks < kWarp && 2 * ks * nc <= kThreads) ks *= 2;
  return ks;
}

// Padded depth of a transposed slice of nc columns over n_in inputs.
DEC_HD inline int slice_depth(int n_in, int nc) {
  const int g = k_slices(nc) % kWarp;
  return n_in + ((g - n_in) % kWarp + kWarp) % kWarp;
}

// Floats of one CTA's part of an (n_in, n_out) matrix cut in `parts` column
// slices (1: the whole matrix).
DEC_HD inline int slice_floats(int n_in, int n_out, int parts) {
  const int nc = cdiv(n_out, parts);
  return nc * slice_depth(n_in, nc);
}

// Offsets into the flat weight buffer (device memory): the fields of
// ops/ar_decode.py's ARDecodeWeights or ops/decode_step.py's
// DecodeStepWeights, in their order, each a contiguous array of the shape
// given there.  Fields a kernel lacks are 0.
struct Weights {
  long long embed_start, embed_act, embed_w, embed_b, ln0, qkvp1_w, qkvp1_b, qkvp2_w, qkvp2_b,
      mlp_w1, mlp_b1, mlp_w2, mlp_b2, lns, head_w1, head_b1, head_ln, head_w2, head_b2, std_row,
      total;
};

// `whole`: the whole decode (ar_decode), else one decode step.
DEC_HD inline Weights weight_layout(bool whole, long long in_dim, long long D, long long nb,
                                    long long adim) {
  Weights w{};
  long long o = 0;
  if (whole) {
    w.embed_start = o; o += D;
    w.embed_act = o;   o += adim * D;
  } else {
    w.embed_w = o;     o += in_dim * D;
    w.embed_b = o;     o += D;
  }
  w.ln0 = o;     o += 2 * D;
  w.qkvp1_w = o; o += nb * D * 4 * D;
  w.qkvp1_b = o; o += nb * 4 * D;
  w.qkvp2_w = o; o += nb * D * 4 * D;
  w.qkvp2_b = o; o += nb * 4 * D;
  w.mlp_w1 = o;  o += nb * D * D;
  w.mlp_b1 = o;  o += nb * D;
  w.mlp_w2 = o;  o += nb * D * D;
  w.mlp_b2 = o;  o += nb * D;
  w.lns = o;     o += nb * 6 * D;
  w.head_w1 = o; o += D * D;
  w.head_b1 = o; o += D;
  w.head_ln = o; o += 2 * D;
  w.head_w2 = o; o += D * adim;
  w.head_b2 = o; o += adim;
  if (whole) { w.std_row = o; o += adim; }
  w.total = o;
  return w;
}

// The matrices that may be local (held whole in every CTA and computed there
// redundantly), as bits of Smem::local, and the order in which they are made
// local while shared memory allows: the whole decode starts with the logits
// (every CTA samples), a decode step with its embedding.
enum Mat { kEmb = 0, kP1, kP2, kM1, kM2, kH1, kH2 };
constexpr int kLocalChoices = 6;

DEC_HD inline int local_order(bool whole, int k) {
  const int whole_order[kLocalChoices] = {kH2, kP1, kP2, kM1, kM2, kH1};
  const int step_order[kLocalChoices] = {kEmb, kP1, kP2, kM1, kM2, kH1};
  return whole ? whole_order[k] : step_order[k];
}

DEC_HD inline int parts_of(int local, int m) {
  return (local >> m) & 1 ? 1 : kCluster;
}

// Floats of the biases and LayerNorm parameters a CTA keeps on chip: per
// block the [q|k|v|p] biases of both attentions, the two MLP biases and the
// six LN vectors, then the head's first bias, LN and last bias, and for a
// decode step the embedding's bias and LN0 (Prm, in this order).
DEC_HD inline int param_floats(bool whole, int D, int nb, int adim) {
  return nb * 16 * D + 3 * D + adim + (whole ? 0 : 3 * D);
}

// Float offsets into a CTA's dynamic shared memory.  The weights and
// parameters are there on the on-chip path only, before x; the activations
// are (R, width) row-major.
struct Smem {
  int local;   // bit m: matrix m held whole in every CTA
  int w_embed, w_blk, blk, o_w1, o_p1, o_q2, o_kv2, o_p2, o_m1, o_m2, w_h1, w_h2, prm;
  int pairs;
  // a buffer a stage output, (R, width) each: no stage writes a buffer that
  // a CTA may still read since the last cluster barrier
  int x, qkv, ya, t1, h1, kv2, q2, yb, t2, h2, u, t3, hv, hh, rep;
  int rep2, logits, emb, smp, q2l, idx;   // the whole decode
  int xin;                          // a decode step
  int scores, red;
  int total;
};

DEC_HD inline Smem smem_layout(bool whole, bool on_chip, int local, int R, int D, int H, int nb,
                               int adim, int n_pos, int in_dim) {
  Smem s{};
  int o = 0;
  s.local = on_chip ? local : 0;
  s.w_embed = s.w_blk = s.w_h1 = s.w_h2 = s.prm = s.o_q2 = -1;
  if (on_chip) {
    if (!whole) { s.w_embed = o; o += slice_floats(in_dim, D, parts_of(local, kEmb)); }
    int b = 0;
    s.o_w1 = b;  b += slice_floats(D, 3 * D, kCluster);
    s.o_p1 = b;  b += slice_floats(D, D, parts_of(local, kP1));
    // a step's cross query (the whole decode's prologue reads Wq2 from device memory)
    if (!whole) { s.o_q2 = b; b += slice_floats(D, D, kCluster); }
    s.o_kv2 = b; b += slice_floats(D, 2 * D, kCluster);
    s.o_p2 = b;  b += slice_floats(D, D, parts_of(local, kP2));
    s.o_m1 = b;  b += slice_floats(D, D, parts_of(local, kM1));
    s.o_m2 = b;  b += slice_floats(D, D, parts_of(local, kM2));
    s.blk = b;
    s.w_blk = o; o += nb * b;
    s.w_h1 = o;  o += slice_floats(D, D, parts_of(local, kH1));
    s.w_h2 = o;  o += slice_floats(D, adim, parts_of(local, kH2));
    s.prm = o;   o += param_floats(whole, D, nb, adim);
    o = (o + 3) & ~3;   // whole 16-byte words: the region is copied as it is
  }
  s.pairs = cdiv(R * H, kCluster);
  const int Dh = D / H;
  int* one[] = {&s.x, &s.ya, &s.t1, &s.h1, &s.q2, &s.yb, &s.t2, &s.h2, &s.u, &s.t3, &s.hv, &s.hh,
                &s.rep};
  for (int* f : one) { *f = o; o += R * D; }
  s.qkv = o;  o += R * 3 * D;
  s.kv2 = o;  o += R * 2 * D;
  s.rep2 = s.logits = s.emb = s.smp = s.q2l = s.idx = s.xin = -1;
  if (whole) {   // rep, smp and q2l are two buffers each: a position ahead
    s.rep2 = o;   o += R * D;
    s.logits = o; o += R * adim;
    s.emb = o;    o += (adim + 1) * D;        // LN0(gelu(.)) of the start row, then each action's
    s.smp = o;    o += 2 * R * (2 * adim + 1);   // a row's gumbel, avail and tail noise
    s.q2l = o;    o += 2 * nb * R * cdiv(D, kCluster);
    s.idx = o;    o += R;
  } else {
    s.xin = o;    o += R * in_dim;
  }
  s.scores = o; o += s.pairs * n_pos;
  s.red = o;    o += s.pairs * Dh > kThreads ? s.pairs * Dh : kThreads;
  s.total = o;
  return s;
}

// Rows a cluster: on chip 2, or 8 where 2 would need more than
// kWaveClusters clusters, so that a large batch still runs in one wave; in
// device memory 4 for the whole decode, 8 for a step.
constexpr int kWaveClusters = 16;   // 4-CTA clusters at once at one CTA an SM (about 22 on an H100)

DEC_HD inline int chip_rows(int B) { return cdiv(B, 2) <= kWaveClusters ? 2 : 8; }
constexpr DEC_HD int device_rows(bool whole) { return whole ? 4 : 8; }

// The layout of a launch over B rows (n_pos: the whole decode's agents, or
// the positions a step's caches hold): on chip if everything split fits,
// then matrices made local in local_order while it still fits; else in
// device memory, all split.
DEC_HD inline Smem plan_layout(bool whole, int B, int D, int H, int nb, int adim, int n_pos,
                               int in_dim) {
  const int R = chip_rows(B);
  Smem s = smem_layout(whole, true, 0, R, D, H, nb, adim, n_pos, in_dim);
  if (4LL * s.total > kSmemLimit)
    return smem_layout(whole, false, 0, device_rows(whole), D, H, nb, adim, n_pos, in_dim);
  for (int k = 0; k < kLocalChoices; ++k) {
    const Smem t = smem_layout(whole, true, s.local | (1 << local_order(whole, k)), R, D, H, nb,
                               adim, n_pos, in_dim);
    if (4LL * t.total <= kSmemLimit) s = t;
  }
  return s;
}

DEC_HD inline bool on_chip(const Smem& s) { return s.prm >= 0; }
DEC_HD inline int plan_rows(bool whole, const Smem& s, int B) {
  return on_chip(s) ? chip_rows(B) : device_rows(whole);
}

// Cluster barriers a position (the whole decode) or a launch (a step).
DEC_HD inline int cluster_barriers(bool whole, const Smem& s, int nb) {
  int split = 0;
  for (int m = kP1; m <= kM2; ++m) split += parts_of(s.local, m) > 1;
  const int n = nb * (4 + split) + (parts_of(s.local, kH1) > 1);
  if (whole) return n + (parts_of(s.local, kH2) > 1);
  return n + 1 + (parts_of(s.local, kEmb) > 1);   // one to start; the logits need none
}

// The local matrices of the recipe's widths (n_embd 64, 2 heads, 2 blocks;
// DCML's whole decode at adim 2 and 101 agents, multi-agent MuJoCo's step
// at 10 agents), which are compiled with those widths as constants: at 2
// rows a cluster every optional matrix of the whole decode is local, and all
// but the head of a step; at 8 rows the second MLP layer stays split too.
constexpr int kWholeRecipe2 = (1 << kP1) | (1 << kP2) | (1 << kM1) | (1 << kM2) | (1 << kH1) |
                              (1 << kH2);
constexpr int kWholeRecipe8 = (1 << kP1) | (1 << kP2) | (1 << kM1) | (1 << kH1) | (1 << kH2);
constexpr int kStepRecipe2 = (1 << kEmb) | (1 << kP1) | (1 << kP2) | (1 << kM1) | (1 << kM2);
constexpr int kStepRecipe8 = (1 << kEmb) | (1 << kP1) | (1 << kP2) | (1 << kM1);

// Whether a launch takes the kernel compiled for the recipe's widths; every
// other on-chip launch takes the generic one.
DEC_HD inline bool recipe_kernel(bool whole, const Smem& s, int B, int D, int H) {
  if (!on_chip(s) || D != 64 || H != 2) return false;
  const int rows = chip_rows(B);
  const int want = whole ? (rows == 2 ? kWholeRecipe2 : kWholeRecipe8)
                         : (rows == 2 ? kStepRecipe2 : kStepRecipe8);
  return s.local == want;
}

// idx[j * ld + k] = base + k * ldw + c0 + j: one CTA's transposed, padded
// part of the (n_in, ldw-wide) matrix at `base` in the flat weights, of
// n_out columns cut in `parts` slices; -1 where it is padding.
inline void slice_image(long long* idx, int rank, long long base, long long ldw, int n_in,
                        int n_out, int parts) {
  const int ncm = cdiv(n_out, parts);
  const int c0 = parts > 1 ? rank * ncm : 0;
  const int nc = n_out - c0 < ncm ? n_out - c0 : ncm;
  const int ld = slice_depth(n_in, ncm);
  for (int j = 0; j < ncm; ++j)
    for (int k = 0; k < ld; ++k)
      idx[(long long)j * ld + k] = j < nc && k < n_in ? base + k * ldw + c0 + j : -1;
}

// CTA `rank`'s weight image: for every float of its weight region (the
// first s.x floats of its shared memory on the on-chip path), the index in
// the flat weights of the value it holds, -1 where it is padding.
inline void weight_image(bool whole, const Smem& s, int rank, int in_dim, int D, int nb,
                         int adim, long long* idx) {
  const Weights w = weight_layout(whole, in_dim, D, nb, adim);
  const long long D4 = 4LL * D;
  for (int t = 0; t < s.x; ++t) idx[t] = -1;
  if (!whole) slice_image(idx + s.w_embed, rank, w.embed_w, D, in_dim, D, parts_of(s.local, kEmb));
  for (int b = 0; b < nb; ++b) {
    long long* blk = idx + s.w_blk + (long long)b * s.blk;
    const long long w1 = w.qkvp1_w + b * D * D4, w2 = w.qkvp2_w + b * D * D4;
    slice_image(blk + s.o_w1, rank, w1, D4, D, 3 * D, kCluster);
    slice_image(blk + s.o_p1, rank, w1 + 3 * D, D4, D, D, parts_of(s.local, kP1));
    if (!whole) slice_image(blk + s.o_q2, rank, w2, D4, D, D, kCluster);
    slice_image(blk + s.o_kv2, rank, w2 + D, D4, D, 2 * D, kCluster);
    slice_image(blk + s.o_p2, rank, w2 + 3 * D, D4, D, D, parts_of(s.local, kP2));
    slice_image(blk + s.o_m1, rank, w.mlp_w1 + b * D * D, D, D, D, parts_of(s.local, kM1));
    slice_image(blk + s.o_m2, rank, w.mlp_w2 + b * D * D, D, D, D, parts_of(s.local, kM2));
  }
  slice_image(idx + s.w_h1, rank, w.head_w1, D, D, D, parts_of(s.local, kH1));
  slice_image(idx + s.w_h2, rank, w.head_w2, adim, D, adim, parts_of(s.local, kH2));
  const long long params[][2] = {{w.qkvp1_b, nb * D4}, {w.qkvp2_b, nb * D4}, {w.mlp_b1, nb * D},
                                 {w.mlp_b2, nb * D},   {w.lns, nb * 6LL * D}, {w.head_b1, D},
                                 {w.head_ln, 2LL * D}, {w.head_b2, adim},     {w.embed_b, D},
                                 {w.ln0, 2LL * D}};
  long long* p = idx + s.prm;
  for (int f = 0; f < (whole ? 8 : 10); ++f)
    for (long long t = 0; t < params[f][1]; ++t) *p++ = params[f][0] + t;
}

}  // namespace dec

// The host entry points, compiled into each decode library (whose wrapper
// asks them) and into the CPU tests' build of this file.  `whole`: 1 for
// the whole decode, 0 for a step; n_pos and in_dim as plan_layout.

// out[0] 1 on chip, 0 in device memory; out[1] rows a cluster; out[2] CTAs a
// cluster; out[3] shared-memory bytes a CTA; out[4] cluster barriers a
// position (the whole decode) or a launch (a step); out[5] the local
// matrices (bit m: dec::Mat m); out[6] 1 where the recipe's kernel runs.
extern "C" void mat_decode_plan(int whole, int B, int n_pos, int in_dim, int D, int H, int nb,
                                int adim, int* out) {
  const dec::Smem s = dec::plan_layout(whole, B, D, H, nb, adim, n_pos, in_dim);
  out[0] = dec::on_chip(s);
  out[1] = dec::plan_rows(whole, s, B);
  out[2] = dec::kCluster;
  out[3] = 4 * s.total;
  out[4] = dec::cluster_barriers(whole, s, nb);
  out[5] = s.local;
  out[6] = dec::recipe_kernel(whole, s, B, D, H);
}

// Shared-memory bytes a CTA of one layout takes (on_chip, local, rows as
// given, not as the plan would choose them).
extern "C" int mat_decode_smem_bytes(int whole, int on_chip, int local, int R, int n_pos,
                                     int in_dim, int D, int H, int nb, int adim) {
  return 4 * dec::smem_layout(whole, on_chip, local, R, D, H, nb, adim, n_pos, in_dim).total;
}

// The weight image of the on-chip layout with these local matrices: returns
// the floats of a CTA's weight region, and with idx set fills idx[rank *
// region + t] for every rank (dec::weight_image).
extern "C" int mat_decode_image(int whole, int local, int in_dim, int D, int nb, int adim,
                                long long* idx) {
  const dec::Smem s = dec::smem_layout(whole, true, local, 1, D, 1, nb, adim, 1, in_dim);
  if (idx != nullptr)
    for (int rank = 0; rank < dec::kCluster; ++rank)
      dec::weight_image(whole, s, rank, in_dim, D, nb, adim, idx + (long long)rank * s.x);
  return s.x;
}

extern "C" int mat_decode_k_slices(int nc) { return dec::k_slices(nc); }
extern "C" int mat_decode_slice_depth(int n_in, int nc) { return dec::slice_depth(n_in, nc); }
