// The launch plan and shared-memory layout of the two decode kernels
// (ar_decode.cu, decode_step.cu; decode_common.cuh holds their body): the
// path, the rows a cluster decodes, the matrices every CTA holds whole, the
// byte offsets of every region of a CTA's shared memory, and each CTA's
// weight image (which unit of the flat weights every unit of its weight
// region holds).
//
// Two trunk types: f32 (esize 4) and bf16 (esize 2).  The trunk's matrices
// (the action embedding, the attention projections, the MLP), its
// activations, caches and exchanged buffers take esize bytes an element; the
// head's matrices and activations, every bias and LayerNorm parameter, the
// scores and the sampling inputs stay f32.  Every region starts at a
// multiple of 4 bytes, so that the f32 layout is the one of an all-f32
// kernel, byte for byte.
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
constexpr int kF32 = 4;                  // bytes of an f32 element

DEC_HD inline int cdiv(int a, int b) { return (a + b - 1) / b; }
DEC_HD inline long long align4(long long bytes) { return (bytes + 3) & ~3LL; }

// k-slices of one column: the largest power of two <= 32 that keeps
// ks * nc <= kThreads (1 above 128 columns).
DEC_HD inline int k_slices(int nc) {
  int ks = 1;
  while (ks < kWarp && 2 * ks * nc <= kThreads) ks *= 2;
  return ks;
}

// Padded depth, in elements of esize bytes, of a transposed slice of nc
// columns over n_in inputs, so that the lanes of a warp (column jj, slice s
// at element jj * depth + s) fall in distinct 4-byte banks: in f32 depth =
// ks (mod 32); in bf16 depth = ks (mod 64), two lanes sharing a word, or 2
// where ks is 1 (a lane a column, each on a word of its own).
DEC_HD inline int slice_depth(int n_in, int nc, int esize = kF32) {
  const int m = kWarp * kF32 / esize;
  const int ks = k_slices(nc);
  const int g = esize == kF32 || ks > 1 ? ks % kWarp : 2;
  return n_in + ((g - n_in) % m + m) % m;
}

// Bytes of one CTA's part of an (n_in, n_out) matrix of esize-byte elements
// cut in `parts` column slices (1: the whole matrix).
DEC_HD inline int slice_bytes(int n_in, int n_out, int parts, int esize) {
  const int nc = cdiv(n_out, parts);
  return (int)align4((long long)nc * slice_depth(n_in, nc, esize) * esize);
}

// Byte offsets into the flat weight buffer (device memory): the fields of
// ops/ar_decode.py's ARDecodeWeights or ops/decode_step.py's
// DecodeStepWeights, in their order, each a contiguous array of the shape
// given there, starting at a multiple of 4 bytes.  The trunk's matrices
// take esize bytes an element, every other field 4.  Fields a kernel lacks
// are 0.
struct Weights {
  long long embed_start, embed_act, embed_w, embed_b, ln0, qkvp1_w, qkvp1_b, qkvp2_w, qkvp2_b,
      mlp_w1, mlp_b1, mlp_w2, mlp_b2, lns, head_w1, head_b1, head_ln, head_w2, head_b2, std_row,
      total;
};

DEC_HD inline long long field(long long* at, long long n, int esize) {
  const long long o = *at;
  *at += align4(n * esize);
  return o;
}

// `whole`: the whole decode (ar_decode), else one decode step.
DEC_HD inline Weights weight_layout(bool whole, long long in_dim, long long D, long long nb,
                                    long long adim, int esize = kF32) {
  Weights w{};
  long long o = 0;
  const int t = esize, f = kF32;
  if (whole) {
    w.embed_start = field(&o, D, t);
    w.embed_act = field(&o, adim * D, t);
  } else {
    w.embed_w = field(&o, in_dim * D, t);
    w.embed_b = field(&o, D, f);
  }
  w.ln0 = field(&o, 2 * D, f);
  w.qkvp1_w = field(&o, nb * D * 4 * D, t);
  w.qkvp1_b = field(&o, nb * 4 * D, f);
  w.qkvp2_w = field(&o, nb * D * 4 * D, t);
  w.qkvp2_b = field(&o, nb * 4 * D, f);
  w.mlp_w1 = field(&o, nb * D * D, t);
  w.mlp_b1 = field(&o, nb * D, f);
  w.mlp_w2 = field(&o, nb * D * D, t);
  w.mlp_b2 = field(&o, nb * D, f);
  w.lns = field(&o, nb * 6 * D, f);
  w.head_w1 = field(&o, D * D, f);
  w.head_b1 = field(&o, D, f);
  w.head_ln = field(&o, 2 * D, f);
  w.head_w2 = field(&o, D * adim, f);
  w.head_b2 = field(&o, adim, f);
  if (whole) w.std_row = field(&o, adim, f);
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

// f32 values of the biases and LayerNorm parameters a CTA keeps on chip: per
// block the [q|k|v|p] biases of both attentions, the two MLP biases and the
// six LN vectors, then the head's first bias, LN and last bias, and for a
// decode step the embedding's bias and LN0 (Prm, in this order).
DEC_HD inline int param_floats(bool whole, int D, int nb, int adim) {
  return nb * 16 * D + 3 * D + adim + (whole ? 0 : 3 * D);
}

// Byte offsets into a CTA's dynamic shared memory.  The weights and
// parameters are there on the on-chip path only, before x; the activations
// are (R, width) row-major.
struct Smem {
  int esize;   // bytes of a trunk element: 4 (f32) or 2 (bf16)
  int local;   // bit m: matrix m held whole in every CTA
  int w_embed, w_blk, blk, o_w1, o_p1, o_q2, o_kv2, o_p2, o_m1, o_m2, w_h1, w_h2, prm;
  int pairs;
  // a buffer a stage output, (R, width) each: no stage writes a buffer that
  // a CTA may still read since the last cluster barrier.  The trunk's in
  // trunk elements, hv and hh (the head) in f32
  int x, qkv, ya, t1, h1, kv2, q2, yb, t2, h2, u, t3, hv, hh, rep;
  int rep2, logits, emb, smp, q2l, idx;   // the whole decode
  int xin;                          // a decode step
  int scores, red;                  // f32
  int total;
};

DEC_HD inline Smem smem_layout(bool whole, bool on_chip, int local, int R, int D, int H, int nb,
                               int adim, int n_pos, int in_dim, int esize = kF32) {
  Smem s{};
  int o = 0;
  const int t = esize;
  s.esize = esize;
  s.local = on_chip ? local : 0;
  s.w_embed = s.w_blk = s.w_h1 = s.w_h2 = s.prm = s.o_q2 = -1;
  if (on_chip) {
    if (!whole) { s.w_embed = o; o += slice_bytes(in_dim, D, parts_of(local, kEmb), t); }
    int b = 0;
    s.o_w1 = b;  b += slice_bytes(D, 3 * D, kCluster, t);
    s.o_p1 = b;  b += slice_bytes(D, D, parts_of(local, kP1), t);
    // a step's cross query (the whole decode's prologue reads Wq2 from device memory)
    if (!whole) { s.o_q2 = b; b += slice_bytes(D, D, kCluster, t); }
    s.o_kv2 = b; b += slice_bytes(D, 2 * D, kCluster, t);
    s.o_p2 = b;  b += slice_bytes(D, D, parts_of(local, kP2), t);
    s.o_m1 = b;  b += slice_bytes(D, D, parts_of(local, kM1), t);
    s.o_m2 = b;  b += slice_bytes(D, D, parts_of(local, kM2), t);
    s.blk = b;
    s.w_blk = o; o += nb * b;
    s.w_h1 = o;  o += slice_bytes(D, D, parts_of(local, kH1), kF32);
    s.w_h2 = o;  o += slice_bytes(D, adim, parts_of(local, kH2), kF32);
    s.prm = o;   o += kF32 * param_floats(whole, D, nb, adim);
    o = (o + 15) & ~15;   // whole 16-byte words: the region is copied as it is
  }
  s.pairs = cdiv(R * H, kCluster);
  const int Dh = D / H;
  const int row = (int)align4((long long)R * D * t);
  int* trunk[] = {&s.x, &s.ya, &s.t1, &s.h1, &s.q2, &s.yb, &s.t2, &s.h2, &s.u, &s.t3};
  for (int* f : trunk) { *f = o; o += row; }
  s.hv = o; o += kF32 * R * D;
  s.hh = o; o += kF32 * R * D;
  s.rep = o; o += row;
  s.qkv = o;  o += (int)align4((long long)R * 3 * D * t);
  s.kv2 = o;  o += (int)align4((long long)R * 2 * D * t);
  s.rep2 = s.logits = s.emb = s.smp = s.q2l = s.idx = s.xin = -1;
  if (whole) {   // rep, smp and q2l are two buffers each: a position ahead
    s.rep2 = o;   o += row;
    s.logits = o; o += kF32 * R * adim;
    // LN0(gelu(.)) of the start row, then each action's
    s.emb = o;    o += (int)align4((long long)(adim + 1) * D * t);
    s.smp = o;    o += kF32 * 2 * R * (2 * adim + 1);   // a row's gumbel, avail and tail noise
    s.q2l = o;    o += kF32 * 2 * nb * R * cdiv(D, kCluster);   // f32 values of the trunk type
    s.idx = o;    o += kF32 * R;
  } else {
    s.xin = o;    o += (int)align4((long long)R * in_dim * t);
  }
  s.scores = o; o += kF32 * s.pairs * n_pos;
  s.red = o;    o += kF32 * (s.pairs * Dh > kThreads ? s.pairs * Dh : kThreads);
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
                               int in_dim, int esize = kF32) {
  const int R = chip_rows(B);
  Smem s = smem_layout(whole, true, 0, R, D, H, nb, adim, n_pos, in_dim, esize);
  if (s.total > kSmemLimit)
    return smem_layout(whole, false, 0, device_rows(whole), D, H, nb, adim, n_pos, in_dim, esize);
  for (int k = 0; k < kLocalChoices; ++k) {
    const Smem t = smem_layout(whole, true, s.local | (1 << local_order(whole, k)), R, D, H, nb,
                               adim, n_pos, in_dim, esize);
    if (t.total <= kSmemLimit) s = t;
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
// at 10 agents), which are compiled with those widths as constants.  In f32,
// at 2 rows a cluster every optional matrix of the whole decode is local,
// and all but the head of a step; at 8 rows the second MLP layer stays split
// too.  In bf16 the trunk's matrices take half the room: every optional
// matrix is local at both row counts.
constexpr int kAllLocal = (1 << kP1) | (1 << kP2) | (1 << kM1) | (1 << kM2) | (1 << kH1);
constexpr DEC_HD int recipe_local(bool whole, int rows, int esize) {
  return esize != kF32 ? (whole ? kAllLocal | (1 << kH2) : kAllLocal | (1 << kEmb))
         : whole       ? (rows == 2 ? kAllLocal : kAllLocal & ~(1 << kM2)) | (1 << kH2)
                       : (rows == 2 ? kAllLocal & ~(1 << kH1)
                                    : kAllLocal & ~(1 << kH1) & ~(1 << kM2)) | (1 << kEmb);
}

// Whether a launch takes the kernel compiled for the recipe's widths; every
// other on-chip launch takes the generic one.
DEC_HD inline bool recipe_kernel(bool whole, const Smem& s, int B, int D, int H) {
  if (!on_chip(s) || D != 64 || H != 2) return false;
  return s.local == recipe_local(whole, chip_rows(B), s.esize);
}

// The units (of `unit` bytes: the trunk element's size) of one CTA's
// transposed, padded part of the (n_in, ldw-wide) matrix of es-byte elements
// at byte `base` of the flat weights, n_out columns cut in `parts` slices:
// element (k, c0 + j) of the matrix lies at element j * depth + k of the
// part, each element es / unit units; -1 where it is padding.
inline void slice_image(long long* idx, int rank, long long base, long long ldw, int n_in,
                        int n_out, int parts, int es, int unit) {
  const int ncm = cdiv(n_out, parts);
  const int c0 = parts > 1 ? rank * ncm : 0;
  const int nc = n_out - c0 < ncm ? n_out - c0 : ncm;
  const int ld = slice_depth(n_in, ncm, es);
  const int per = es / unit;
  for (int j = 0; j < ncm; ++j)
    for (int k = 0; k < ld; ++k)
      for (int q = 0; q < per; ++q)
        idx[((long long)j * ld + k) * per + q] =
            j < nc && k < n_in ? (base + (k * ldw + c0 + j) * es) / unit + q : -1;
}

// CTA `rank`'s weight image: for every unit (s.esize bytes) of its weight
// region (the first s.x bytes of its shared memory on the on-chip path), the
// index of the unit of the flat weights it holds, -1 where it is padding.
// An f32 value of a bf16 layout is two units.
inline void weight_image(bool whole, const Smem& s, int rank, int in_dim, int D, int nb,
                         int adim, long long* idx) {
  const int t = s.esize, u = s.esize;
  const Weights w = weight_layout(whole, in_dim, D, nb, adim, t);
  const long long D4 = 4LL * D;
  for (int k = 0; k < s.x / u; ++k) idx[k] = -1;
  if (!whole)
    slice_image(idx + s.w_embed / u, rank, w.embed_w, D, in_dim, D, parts_of(s.local, kEmb), t, u);
  for (int b = 0; b < nb; ++b) {
    long long* blk = idx + (s.w_blk + (long long)b * s.blk) / u;
    const long long w1 = w.qkvp1_w + b * D * D4 * t, w2 = w.qkvp2_w + b * D * D4 * t;
    slice_image(blk + s.o_w1 / u, rank, w1, D4, D, 3 * D, kCluster, t, u);
    slice_image(blk + s.o_p1 / u, rank, w1 + 3 * D * t, D4, D, D, parts_of(s.local, kP1), t, u);
    if (!whole) slice_image(blk + s.o_q2 / u, rank, w2, D4, D, D, kCluster, t, u);
    slice_image(blk + s.o_kv2 / u, rank, w2 + D * t, D4, D, 2 * D, kCluster, t, u);
    slice_image(blk + s.o_p2 / u, rank, w2 + 3 * D * t, D4, D, D, parts_of(s.local, kP2), t, u);
    slice_image(blk + s.o_m1 / u, rank, w.mlp_w1 + b * D * D * t, D, D, D,
                parts_of(s.local, kM1), t, u);
    slice_image(blk + s.o_m2 / u, rank, w.mlp_w2 + b * D * D * t, D, D, D,
                parts_of(s.local, kM2), t, u);
  }
  slice_image(idx + s.w_h1 / u, rank, w.head_w1, D, D, D, parts_of(s.local, kH1), kF32, u);
  slice_image(idx + s.w_h2 / u, rank, w.head_w2, adim, D, adim, parts_of(s.local, kH2), kF32, u);
  const long long params[][2] = {{w.qkvp1_b, nb * D4}, {w.qkvp2_b, nb * D4}, {w.mlp_b1, nb * D},
                                 {w.mlp_b2, nb * D},   {w.lns, nb * 6LL * D}, {w.head_b1, D},
                                 {w.head_ln, 2LL * D}, {w.head_b2, adim},     {w.embed_b, D},
                                 {w.ln0, 2LL * D}};
  long long* p = idx + s.prm / u;
  for (int f = 0; f < (whole ? 8 : 10); ++f)
    for (long long v = 0; v < params[f][1]; ++v)
      for (int q = 0; q < kF32 / u; ++q) *p++ = (params[f][0] + v * kF32) / u + q;
}

}  // namespace dec

// The host entry points, compiled into each decode library (whose wrapper
// asks them) and into the CPU tests' build of this file.  `whole`: 1 for
// the whole decode, 0 for a step; n_pos and in_dim as plan_layout; esize
// the trunk element's bytes (4 f32, 2 bf16).

// out[0] 1 on chip, 0 in device memory; out[1] rows a cluster; out[2] CTAs a
// cluster; out[3] shared-memory bytes a CTA; out[4] cluster barriers a
// position (the whole decode) or a launch (a step); out[5] the local
// matrices (bit m: dec::Mat m); out[6] 1 where the recipe's kernel runs.
extern "C" void mat_decode_plan(int whole, int B, int n_pos, int in_dim, int D, int H, int nb,
                                int adim, int esize, int* out) {
  const dec::Smem s = dec::plan_layout(whole, B, D, H, nb, adim, n_pos, in_dim, esize);
  out[0] = dec::on_chip(s);
  out[1] = dec::plan_rows(whole, s, B);
  out[2] = dec::kCluster;
  out[3] = s.total;
  out[4] = dec::cluster_barriers(whole, s, nb);
  out[5] = s.local;
  out[6] = dec::recipe_kernel(whole, s, B, D, H);
}

// Shared-memory bytes a CTA of one layout takes (on_chip, local, rows as
// given, not as the plan would choose them).
extern "C" int mat_decode_smem_bytes(int whole, int on_chip, int local, int R, int n_pos,
                                     int in_dim, int D, int H, int nb, int adim, int esize) {
  return dec::smem_layout(whole, on_chip, local, R, D, H, nb, adim, n_pos, in_dim, esize).total;
}

// The weight image of the on-chip layout with these local matrices: returns
// the units (esize bytes) of a CTA's weight region, and with idx set fills
// idx[rank * region + t] for every rank (dec::weight_image).
extern "C" int mat_decode_image(int whole, int local, int in_dim, int D, int nb, int adim,
                                int esize, long long* idx) {
  const dec::Smem s = dec::smem_layout(whole, true, local, 1, D, 1, nb, adim, 1, in_dim, esize);
  const int region = s.x / esize;
  if (idx != nullptr)
    for (int rank = 0; rank < dec::kCluster; ++rank)
      dec::weight_image(whole, s, rank, in_dim, D, nb, adim, idx + (long long)rank * region);
  return region;
}

// The flat weights' bytes (dec::weight_layout).
extern "C" long long mat_decode_weight_bytes(int whole, int in_dim, int D, int nb, int adim,
                                             int esize) {
  return dec::weight_layout(whole, in_dim, D, nb, adim, esize).total;
}

extern "C" int mat_decode_k_slices(int nc) { return dec::k_slices(nc); }
extern "C" int mat_decode_slice_depth(int n_in, int nc, int esize) {
  return dec::slice_depth(n_in, nc, esize);
}
