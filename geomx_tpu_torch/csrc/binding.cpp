// PyTorch binding of the port's CUDA kernels — the one source that
// includes torch/extension.h.  It checks devices, types, shapes and
// contiguity, builds the launch arguments from tensor pointers and
// strides, launches on PyTorch's current stream, and raises if a launch
// is refused.  The Python wrappers in geomx_tpu_torch/ops allocate every
// output and scratch tensor.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include <algorithm>
#include <climits>
#include <initializer_list>
#include <vector>

#include "geomx_kernels.h"

namespace {

void check_launch(int rc, const char* what) {
  TORCH_CHECK(rc == 0, what, " launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(rc)));
}

void check_tensor(const at::Tensor& t, at::ScalarType type, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == type, name, " has the wrong dtype");
}

void check_contiguous(const at::Tensor& t, at::ScalarType type,
                      const char* name) {
  check_tensor(t, type, name);
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

// rows of a [*B, n] tensor: the product of its batch dims
int64_t rows_of(const at::Tensor& t) {
  int64_t rows = 1;
  for (int64_t d = 0; d + 1 < t.dim(); ++d) rows *= t.size(d);
  return rows;
}

// One entry of the copy table: rows of n floats; row r reads src + (r /
// inner) * src_outer + (r % inner) * src_inner (src null: zeros) and
// writes dst + r * dst_stride.
struct Copy {
  const float* src;
  float* dst;
  int64_t n, rows, inner, src_outer, src_inner, dst_stride;
};

// The entries copying the rows of a [*B, n] leaf (arbitrary batch
// strides) to dst + r * dst_stride: the batch dims are merged where their
// strides allow; the last two remaining ones are an entry's two strides,
// and each index of any dims before them is an entry of its own.
void leaf_copies(const at::Tensor& leaf, float* dst, int64_t dst_stride,
                 std::vector<Copy>& out) {
  std::vector<int64_t> size, stride;  // batch dims, merged, size-1 dropped
  for (int64_t d = 0; d + 1 < leaf.dim(); ++d) {
    if (leaf.size(d) == 1) continue;
    if (!size.empty() && stride.back() == leaf.stride(d) * leaf.size(d)) {
      size.back() *= leaf.size(d);
      stride.back() = leaf.stride(d);
    } else {
      size.push_back(leaf.size(d));
      stride.push_back(leaf.stride(d));
    }
  }
  const int64_t m = static_cast<int64_t>(size.size());
  const int64_t inner = m >= 1 ? size[m - 1] : 1;
  const int64_t rows = m >= 2 ? size[m - 2] * inner : inner;
  const int64_t s_inner = m >= 1 ? stride[m - 1] : 0;
  const int64_t s_outer = m >= 2 ? stride[m - 2] : 0;
  int64_t outer = 1;
  for (int64_t d = 0; d + 2 < m; ++d) outer *= size[d];
  const float* base = leaf.data_ptr<float>();
  for (int64_t o = 0; o < outer; ++o) {
    int64_t off = 0;
    for (int64_t d = m - 3, rest = o; d >= 0; --d) {
      off += (rest % size[d]) * stride[d];
      rest /= size[d];
    }
    out.push_back({base + off, dst + o * rows * dst_stride, leaf.size(-1),
                   rows, inner, s_outer, s_inner, dst_stride});
  }
}

// Launches the copy table, GX_MAX_COPIES entries a launch; returns the
// number of launches.
int64_t launch_copies(const std::vector<Copy>& copies, cudaStream_t stream) {
  const int64_t tile = gx_bucket_tile();
  int64_t launches = 0;
  size_t i = 0;
  GxCopyTable table;
  while (i < copies.size()) {
    int64_t units = 0;
    table.count = 0;
    while (i < copies.size() && table.count < GX_MAX_COPIES) {
      const Copy& c = copies[i];
      const int64_t per_row = (c.n + 6) / 4;
      const int64_t nu = per_row * c.rows;
      TORCH_CHECK(nu < INT_MAX && c.n < INT_MAX, "a bucket copy of ",
                  c.rows, " x ", c.n, " elements is too large for one launch");
      if ((units + nu + tile - 1) / tile > INT_MAX) break;
      table.e[table.count] = GxCopy{units, c.src, c.dst, c.src_outer,
                                    c.src_inner, c.dst_stride,
                                    static_cast<int>(c.n),
                                    static_cast<int>(per_row),
                                    static_cast<int>(c.inner), 0};
      units += nu;
      ++table.count;
      ++i;
    }
    table.total_units = units;
    table.total_blocks = static_cast<int>((units + tile - 1) / tile);
    check_launch(gx_bucket_copy(&table, stream), "bucket copy");
    ++launches;
  }
  return launches;
}

void check_layout(const std::vector<at::Tensor>& leaves,
                  const std::vector<at::Tensor>& buckets,
                  const std::vector<int64_t>& bucket_of,
                  const std::vector<int64_t>& offset_of) {
  TORCH_CHECK(!buckets.empty(), "no buckets");
  TORCH_CHECK(leaves.size() == bucket_of.size() &&
                  leaves.size() == offset_of.size(),
              "layout and leaf counts differ");
  const auto batch = buckets[0].sizes().slice(0, buckets[0].dim() - 1);
  for (const auto& b : buckets) {
    check_contiguous(b, at::kFloat, "bucket");
    TORCH_CHECK(b.sizes().slice(0, b.dim() - 1) == batch,
                "buckets differ in their batch dims");
    TORCH_CHECK(b.device() == buckets[0].device(), "buckets on two devices");
  }
  for (size_t i = 0; i < leaves.size(); ++i) {
    const auto& leaf = leaves[i];
    check_tensor(leaf, at::kFloat, "leaf");
    TORCH_CHECK(leaf.device() == buckets[0].device(),
                "leaf and bucket on two devices");
    TORCH_CHECK(leaf.dim() == buckets[0].dim() &&
                    leaf.sizes().slice(0, leaf.dim() - 1) == batch,
                "leaf ", i, " batch dims differ from the buckets'");
    TORCH_CHECK(leaf.stride(-1) == 1 || leaf.size(-1) == 1, "leaf ", i,
                " is not contiguous in its last dim");
    TORCH_CHECK(bucket_of[i] >= 0 &&
                    bucket_of[i] < static_cast<int64_t>(buckets.size()),
                "leaf ", i, " names a missing bucket");
    TORCH_CHECK(offset_of[i] >= 0 &&
                    offset_of[i] + leaf.size(-1) <= buckets[bucket_of[i]].size(-1),
                "leaf ", i, " overruns its bucket");
  }
}

}  // namespace

// leaves [*B, n_i] (last dim contiguous) -> buckets [*B, N_b]; every
// bucket's tail past its last leaf is zero-filled.  One table entry a
// leaf and a pad (more where a leaf's batch strides do not merge into
// two).  Returns launches.
int64_t bucket_flatten(const std::vector<at::Tensor>& leaves,
                       const std::vector<at::Tensor>& buckets,
                       const std::vector<int64_t>& bucket_of,
                       const std::vector<int64_t>& offset_of) {
  check_layout(leaves, buckets, bucket_of, offset_of);
  const c10::cuda::CUDAGuard guard(buckets[0].device());
  const int64_t rows = rows_of(buckets[0]);
  if (rows == 0) return 0;
  std::vector<int64_t> fill(buckets.size(), 0);
  for (size_t i = 0; i < leaves.size(); ++i) {
    fill[bucket_of[i]] =
        std::max(fill[bucket_of[i]], offset_of[i] + leaves[i].size(-1));
  }
  std::vector<Copy> copies;
  copies.reserve(leaves.size() + buckets.size());
  for (size_t i = 0; i < leaves.size(); ++i) {
    if (leaves[i].size(-1) == 0) continue;
    const auto& b = buckets[bucket_of[i]];
    leaf_copies(leaves[i], b.data_ptr<float>() + offset_of[i], b.size(-1),
                copies);
  }
  for (size_t j = 0; j < buckets.size(); ++j) {
    const int64_t total = buckets[j].size(-1);
    if (fill[j] < total) {
      copies.push_back({nullptr, buckets[j].data_ptr<float>() + fill[j],
                        total - fill[j], rows, rows, 0, 0, total});
    }
  }
  return launch_copies(copies, at::cuda::getCurrentCUDAStream());
}

// buckets [*B, N_b] -> leaves [*B, n_i] (contiguous outputs), one table
// entry a leaf.  Returns launches.
int64_t bucket_unflatten(const std::vector<at::Tensor>& buckets,
                         const std::vector<at::Tensor>& leaves,
                         const std::vector<int64_t>& bucket_of,
                         const std::vector<int64_t>& offset_of) {
  check_layout(leaves, buckets, bucket_of, offset_of);
  for (const auto& leaf : leaves) check_contiguous(leaf, at::kFloat, "leaf");
  const c10::cuda::CUDAGuard guard(buckets[0].device());
  const int64_t rows = rows_of(buckets[0]);
  if (rows == 0) return 0;
  std::vector<Copy> copies;
  copies.reserve(leaves.size());
  for (size_t i = 0; i < leaves.size(); ++i) {
    const int64_t n = leaves[i].size(-1);
    if (n == 0) continue;
    const auto& b = buckets[bucket_of[i]];
    copies.push_back({b.data_ptr<float>() + offset_of[i],
                      leaves[i].data_ptr<float>(), n, rows, rows, 0,
                      b.size(-1), n});
  }
  return launch_copies(copies, at::cuda::getCurrentCUDAStream());
}

int64_t select_scratch(int64_t rows, int64_t n) {
  TORCH_CHECK(n > 0 && n < INT_MAX / 2, "row length ", n, " out of range");
  TORCH_CHECK(rows > 0 && rows < 65536, "rows out of range: ", rows);
  return gx_bsc_select_scratch(static_cast<int>(rows), static_cast<int>(n));
}

// g, u, v, new_u, new_v [rows, n]; thr [rows]; vals, idx [rows, k];
// scratch select_scratch(rows, n) int32 words; tie_vals, tie_idx [rows, k].
void bsc_select_pack(const at::Tensor& g, const at::Tensor& u,
                     const at::Tensor& v, const at::Tensor& thr, int64_t k,
                     const at::Tensor& scratch, const at::Tensor& tie_vals,
                     const at::Tensor& tie_idx, const at::Tensor& new_u,
                     const at::Tensor& new_v, const at::Tensor& vals,
                     const at::Tensor& idx) {
  for (const auto* t : {&g, &u, &v, &thr, &new_u, &new_v, &vals, &tie_vals}) {
    check_contiguous(*t, at::kFloat, "select_pack float operand");
  }
  for (const auto* t : {&scratch, &idx, &tie_idx}) {
    check_contiguous(*t, at::kInt, "select_pack int operand");
  }
  TORCH_CHECK(g.dim() == 2, "g must be [rows, n]");
  const int64_t rows = g.size(0), n = g.size(1);
  for (const auto* t : {&u, &v, &new_u, &new_v}) {
    TORCH_CHECK(t->sizes() == g.sizes(), "g, u, v, new_u, new_v differ in shape");
  }
  TORCH_CHECK(k > 0 && k < INT_MAX, "k out of range: ", k);
  const int64_t words = select_scratch(rows, n);
  TORCH_CHECK(thr.numel() == rows, "thr needs one value a row");
  TORCH_CHECK(vals.numel() == rows * k && idx.numel() == rows * k &&
                  tie_vals.numel() == rows * k && tie_idx.numel() == rows * k,
              "vals/idx and the tie buffers must be [rows, k]");
  TORCH_CHECK(scratch.numel() >= words, "select_pack scratch too small");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(scratch.data_ptr()) % 8 == 0,
              "select_pack scratch must be 8-byte aligned");
  const c10::cuda::CUDAGuard guard(g.device());
  check_launch(
      gx_bsc_select_pack(g.data_ptr<float>(), u.data_ptr<float>(),
                         v.data_ptr<float>(), thr.data_ptr<float>(),
                         static_cast<int>(rows), static_cast<int>(n),
                         static_cast<int>(k), scratch.data_ptr<int>(),
                         tie_vals.data_ptr<float>(), tie_idx.data_ptr<int>(),
                         new_u.data_ptr<float>(), new_v.data_ptr<float>(),
                         vals.data_ptr<float>(), idx.data_ptr<int>(),
                         at::cuda::getCurrentCUDAStream()),
      "bsc select/pack");
}

// vals, idx [rows, m] -> out [rows, n]; runs of `run` pairs fold in order.
void bsc_scatter_add(const at::Tensor& vals, const at::Tensor& idx,
                     int64_t run, const at::Tensor& out) {
  check_contiguous(vals, at::kFloat, "vals");
  check_contiguous(idx, at::kInt, "idx");
  check_contiguous(out, at::kFloat, "out");
  TORCH_CHECK(vals.dim() == 2 && idx.sizes() == vals.sizes(),
              "vals and idx must be [rows, m] alike");
  TORCH_CHECK(out.dim() == 2 && out.size(0) == vals.size(0),
              "out must be [rows, n]");
  const int64_t rows = vals.size(0), m = vals.size(1), n = out.size(1);
  TORCH_CHECK(rows > 0 && rows < 65536, "rows out of range: ", rows);
  TORCH_CHECK(m < INT_MAX && n < INT_MAX, "scatter-add sizes out of range");
  TORCH_CHECK(run > 0 && run <= std::max<int64_t>(m, 1), "bad run length ", run);
  const c10::cuda::CUDAGuard guard(vals.device());
  check_launch(gx_bsc_scatter_add(vals.data_ptr<float>(), idx.data_ptr<int>(),
                                  static_cast<int>(rows), static_cast<int>(m),
                                  static_cast<int>(run), static_cast<int>(n),
                                  out.data_ptr<float>(),
                                  at::cuda::getCurrentCUDAStream()),
               "bsc scatter-add");
}

namespace {

// the optional bf16 copy of the new params: null, or n bf16 values
void* cast_ptr(const c10::optional<at::Tensor>& cast, const at::Tensor& p) {
  if (!cast.has_value()) return nullptr;
  check_contiguous(*cast, at::kBFloat16, "cast");
  TORCH_CHECK(cast->numel() == p.numel(), "cast must match the params");
  TORCH_CHECK(cast->device() == p.device(), "cast on another device");
  return cast->data_ptr();
}

void check_elementwise(std::initializer_list<const at::Tensor*> ts,
                       const char* what) {
  const at::Tensor& first = **ts.begin();
  for (const auto* t : ts) {
    check_contiguous(*t, at::kFloat, what);
    TORCH_CHECK(t->sizes() == first.sizes(), what, " operands differ in shape");
    TORCH_CHECK(t->device() == first.device(), what,
                " operands on two devices");
  }
}

}  // namespace

// p, g, m, new_p, new_m: fp32, one shape, contiguous; every element
// independent.  new_p/new_m must not alias the inputs.
void fused_sgd_momentum(const at::Tensor& p, const at::Tensor& g,
                        const at::Tensor& m, double lr, double momentum,
                        const at::Tensor& new_p, const at::Tensor& new_m,
                        const c10::optional<at::Tensor>& cast) {
  check_elementwise({&p, &g, &m, &new_p, &new_m}, "fused_sgd_momentum");
  const c10::cuda::CUDAGuard guard(p.device());
  check_launch(gx_fused_sgd_momentum(
                   p.data_ptr<float>(), g.data_ptr<float>(),
                   m.data_ptr<float>(), p.numel(), static_cast<float>(lr),
                   static_cast<float>(momentum), new_p.data_ptr<float>(),
                   new_m.data_ptr<float>(), cast_ptr(cast, p),
                   at::cuda::getCurrentCUDAStream()),
               "fused_sgd_momentum");
}

// as fused_sgd_momentum, with v/new_v; bc1, bc2 the bias corrections.
// Each constant is rounded once to fp32, 1 - b1 and 1 - b2 from double.
void fused_adam(const at::Tensor& p, const at::Tensor& g, const at::Tensor& m,
                const at::Tensor& v, double bc1, double bc2, double lr,
                double b1, double b2, double eps, const at::Tensor& new_p,
                const at::Tensor& new_m, const at::Tensor& new_v,
                const c10::optional<at::Tensor>& cast) {
  check_elementwise({&p, &g, &m, &v, &new_p, &new_m, &new_v}, "fused_adam");
  const c10::cuda::CUDAGuard guard(p.device());
  check_launch(
      gx_fused_adam(p.data_ptr<float>(), g.data_ptr<float>(),
                    m.data_ptr<float>(), v.data_ptr<float>(), p.numel(),
                    static_cast<float>(bc1), static_cast<float>(bc2),
                    static_cast<float>(lr), static_cast<float>(b1),
                    static_cast<float>(1.0 - b1), static_cast<float>(b2),
                    static_cast<float>(1.0 - b2), static_cast<float>(eps),
                    new_p.data_ptr<float>(), new_m.data_ptr<float>(),
                    new_v.data_ptr<float>(), cast_ptr(cast, p),
                    at::cuda::getCurrentCUDAStream()),
      "fused_adam");
}

// g, r, new_r [rows, n] fp32; packed [rows, ceil(n/2048)*128] int32.
void quantize_2bit(const at::Tensor& g, const at::Tensor& r, double thr,
                   const at::Tensor& packed, const at::Tensor& new_r) {
  check_elementwise({&g, &r, &new_r}, "quantize_2bit");
  check_contiguous(packed, at::kInt, "packed");
  TORCH_CHECK(g.dim() == 2, "g must be [rows, n]");
  const int64_t rows = g.size(0), n = g.size(1);
  TORCH_CHECK(rows > 0 && rows < 65536, "rows out of range: ", rows);
  TORCH_CHECK(n < INT_MAX / 2, "row length ", n, " out of range");
  TORCH_CHECK(packed.dim() == 2 && packed.size(0) == rows &&
                  packed.size(1) == gx_twobit_words(static_cast<int>(n)),
              "packed must be [rows, ceil(n/2048)*128]");
  TORCH_CHECK(packed.device() == g.device(), "packed on another device");
  const c10::cuda::CUDAGuard guard(g.device());
  check_launch(gx_quantize_2bit(g.data_ptr<float>(), r.data_ptr<float>(),
                                static_cast<int>(rows), static_cast<int>(n),
                                static_cast<float>(thr),
                                packed.data_ptr<int>(),
                                new_r.data_ptr<float>(),
                                at::cuda::getCurrentCUDAStream()),
               "quantize_2bit");
}

// packed [rows, parts, ceil(n/2048)*128] int32 -> out [rows, n] fp32, the
// parts summed in order.
void dequantize_2bit(const at::Tensor& packed, int64_t n, double thr,
                     const at::Tensor& out) {
  check_contiguous(packed, at::kInt, "packed");
  check_contiguous(out, at::kFloat, "out");
  TORCH_CHECK(n > 0 && n < INT_MAX / 2, "n out of range: ", n);
  TORCH_CHECK(packed.dim() == 3, "packed must be [rows, parts, words]");
  const int64_t rows = packed.size(0), parts = packed.size(1);
  TORCH_CHECK(rows > 0 && rows < 65536, "rows out of range: ", rows);
  TORCH_CHECK(parts > 0 && parts < INT_MAX, "parts out of range: ", parts);
  TORCH_CHECK(packed.size(2) == gx_twobit_words(static_cast<int>(n)),
              "packed rows must hold ceil(n/2048)*128 words");
  TORCH_CHECK(out.dim() == 2 && out.size(0) == rows && out.size(1) == n,
              "out must be [rows, n]");
  TORCH_CHECK(out.device() == packed.device(), "out on another device");
  const c10::cuda::CUDAGuard guard(packed.device());
  check_launch(gx_dequantize_2bit(packed.data_ptr<int>(),
                                  static_cast<int>(rows),
                                  static_cast<int>(parts),
                                  static_cast<int>(n),
                                  static_cast<float>(thr),
                                  out.data_ptr<float>(),
                                  at::cuda::getCurrentCUDAStream()),
               "dequantize_2bit");
}

// svals fp32, skey int32, out_vals fp32, out_idx int32, all [rows, m]
// contiguous on one device; 0 <= rounds <= GX_MERGE_MAX_ROUNDS.
void merge_sorted_pairs(const at::Tensor& svals, const at::Tensor& skey,
                        int64_t rounds, const at::Tensor& out_vals,
                        const at::Tensor& out_idx) {
  check_contiguous(svals, at::kFloat, "svals");
  check_contiguous(out_vals, at::kFloat, "out_vals");
  for (const auto* t : {&skey, &out_idx}) {
    check_contiguous(*t, at::kInt, "merge int operand");
  }
  TORCH_CHECK(svals.dim() == 2, "svals must be [rows, m]");
  for (const auto* t : {&skey, &out_vals, &out_idx}) {
    TORCH_CHECK(t->sizes() == svals.sizes(), "merge operands differ in shape");
    TORCH_CHECK(t->device() == svals.device(), "merge operands on two devices");
  }
  const int64_t rows = svals.size(0), m = svals.size(1);
  TORCH_CHECK(rows < INT_MAX && m < INT_MAX, "merge sizes out of range");
  TORCH_CHECK(rounds >= 0 && rounds <= GX_MERGE_MAX_ROUNDS,
              "merge rounds out of range: ", rounds);
  const c10::cuda::CUDAGuard guard(svals.device());
  check_launch(gx_merge_sorted_pairs(svals.data_ptr<float>(),
                                     skey.data_ptr<int>(),
                                     static_cast<int>(rows), static_cast<int>(m),
                                     static_cast<int>(rounds),
                                     out_vals.data_ptr<float>(),
                                     out_idx.data_ptr<int>(),
                                     at::cuda::getCurrentCUDAStream()),
               "merge_sorted_pairs");
}

namespace {

// A [B, L, H, D] operand of the attention kernels: fp32 or bf16 (the type
// of q), any strides with the head dim contiguous.
GxSeqOperand seq_operand(const at::Tensor& t, const at::Tensor& q,
                         const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.device() == q.device(), name, " on another device than q");
  TORCH_CHECK(t.scalar_type() == q.scalar_type(), name,
              " must have q's dtype");
  TORCH_CHECK(t.dim() == 4, name, " must be [B, L, H, D]");
  TORCH_CHECK(t.stride(3) == 1, name, " must have a contiguous head dim");
  return GxSeqOperand{t.data_ptr(), t.stride(0), t.stride(1), t.stride(2)};
}

GxAttnDims attn_dims(const at::Tensor& q, const at::Tensor& k, bool causal,
                     double scale) {
  TORCH_CHECK(q.scalar_type() == at::kFloat || q.scalar_type() == at::kBFloat16,
              "attention operands must be fp32 or bf16");
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4, "q, k must be [B, L, H, D]");
  TORCH_CHECK(k.size(0) == q.size(0) && k.size(2) == q.size(2) &&
                  k.size(3) == q.size(3),
              "q and k differ in batch, heads or head dim");
  const int64_t D = q.size(3);
  TORCH_CHECK(D == 8 || D == 16 || D == 32 || D == 64 || D % 128 == 0,
              "head dim ", D, " not in {8, 16, 32, 64} nor a multiple of 128");
  TORCH_CHECK(D > 0 && D / 128 <= 65535, "head dim ", D, " out of range");
  TORCH_CHECK(q.size(0) * q.size(2) <= 65535, "B * H out of range");
  TORCH_CHECK(q.size(1) < INT_MAX && k.size(1) < INT_MAX,
              "sequence too long");
  return GxAttnDims{static_cast<int>(q.size(0)), static_cast<int>(q.size(2)),
                    static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
                    static_cast<int>(D), causal ? 1 : 0,
                    q.scalar_type() == at::kBFloat16 ? 1 : 0,
                    static_cast<float>(scale)};
}

// fp32, contiguous, of the given shape, on q's device
void check_f32(const at::Tensor& t, at::IntArrayRef shape, const at::Tensor& q,
               const char* name) {
  check_contiguous(t, at::kFloat, name);
  TORCH_CHECK(t.sizes() == shape, name, " has the wrong shape");
  TORCH_CHECK(t.device() == q.device(), name, " on another device than q");
}

}  // namespace

// q [B, Lq, H, D], k, v [B, Lk, H, D] -> out [B, Lq, H, D] (contiguous, q's
// dtype) and, when given, lse [B, H, Lq] fp32.
void flash_fwd(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
               bool causal, double scale, const at::Tensor& out,
               const c10::optional<at::Tensor>& lse) {
  const GxAttnDims dims = attn_dims(q, k, causal, scale);
  TORCH_CHECK(v.sizes() == k.sizes(), "k and v differ in shape");
  check_contiguous(out, q.scalar_type(), "out");
  TORCH_CHECK(out.sizes() == q.sizes() && out.device() == q.device(),
              "out must be q's shape on q's device");
  float* lse_ptr = nullptr;
  if (lse.has_value()) {
    check_f32(*lse, {q.size(0), q.size(2), q.size(1)}, q, "lse");
    lse_ptr = lse->data_ptr<float>();
  }
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(gx_flash_fwd(seq_operand(q, q, "q"), seq_operand(k, q, "k"),
                            seq_operand(v, q, "v"), dims, out.data_ptr(),
                            lse_ptr, at::cuda::getCurrentCUDAStream()),
               "flash_fwd");
}

// dq [B, Lq, H, D] fp32 from q, k, v, dout, lse and delta [B, H, Lq] fp32.
void flash_bwd_dq(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
                  const at::Tensor& dout, const at::Tensor& lse,
                  const at::Tensor& delta, bool causal, double scale,
                  const at::Tensor& dq) {
  const GxAttnDims dims = attn_dims(q, k, causal, scale);
  TORCH_CHECK(v.sizes() == k.sizes() && dout.sizes() == q.sizes(),
              "v must match k, dout must match q");
  const std::vector<int64_t> rows{q.size(0), q.size(2), q.size(1)};
  check_f32(lse, rows, q, "lse");
  check_f32(delta, rows, q, "delta");
  check_f32(dq, q.sizes(), q, "dq");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(gx_flash_bwd_dq(seq_operand(q, q, "q"), seq_operand(k, q, "k"),
                               seq_operand(v, q, "v"),
                               seq_operand(dout, q, "dout"),
                               lse.data_ptr<float>(), delta.data_ptr<float>(),
                               dims, dq.data_ptr<float>(),
                               at::cuda::getCurrentCUDAStream()),
               "flash_bwd_dq");
}

// dk, dv [B, Lk, H, D] fp32 from q, k, v, dout, lse and delta.
void flash_bwd_dkv(const at::Tensor& q, const at::Tensor& k,
                   const at::Tensor& v, const at::Tensor& dout,
                   const at::Tensor& lse, const at::Tensor& delta, bool causal,
                   double scale, const at::Tensor& dk, const at::Tensor& dv) {
  const GxAttnDims dims = attn_dims(q, k, causal, scale);
  TORCH_CHECK(v.sizes() == k.sizes() && dout.sizes() == q.sizes(),
              "v must match k, dout must match q");
  const std::vector<int64_t> rows{q.size(0), q.size(2), q.size(1)};
  check_f32(lse, rows, q, "lse");
  check_f32(delta, rows, q, "delta");
  check_f32(dk, k.sizes(), q, "dk");
  check_f32(dv, k.sizes(), q, "dv");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(gx_flash_bwd_dkv(seq_operand(q, q, "q"), seq_operand(k, q, "k"),
                                seq_operand(v, q, "v"),
                                seq_operand(dout, q, "dout"),
                                lse.data_ptr<float>(), delta.data_ptr<float>(),
                                dims, dk.data_ptr<float>(), dv.data_ptr<float>(),
                                at::cuda::getCurrentCUDAStream()),
               "flash_bwd_dkv");
}

// One ring hop: carries m, l [B, H, Lq] and o [B, Lq, H, D] fp32 in, the
// updated carries out; diag selects the causal diagonal mode.
void ring_hop(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
              const at::Tensor& m, const at::Tensor& l, const at::Tensor& o,
              bool diag, double scale, const at::Tensor& m_out,
              const at::Tensor& l_out, const at::Tensor& o_out) {
  const GxAttnDims dims = attn_dims(q, k, diag, scale);
  TORCH_CHECK(v.sizes() == k.sizes(), "k and v differ in shape");
  const std::vector<int64_t> rows{q.size(0), q.size(2), q.size(1)};
  for (const auto* t : {&m, &l, &m_out, &l_out}) check_f32(*t, rows, q, "m/l");
  check_f32(o, q.sizes(), q, "o");
  check_f32(o_out, q.sizes(), q, "o_out");
  const c10::cuda::CUDAGuard guard(q.device());
  check_launch(gx_ring_hop(seq_operand(q, q, "q"), seq_operand(k, q, "k"),
                           seq_operand(v, q, "v"), m.data_ptr<float>(),
                           l.data_ptr<float>(), o.data_ptr<float>(), dims,
                           m_out.data_ptr<float>(), l_out.data_ptr<float>(),
                           o_out.data_ptr<float>(),
                           at::cuda::getCurrentCUDAStream()),
               "ring_hop");
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_fwd", &flash_fwd);
  m.def("flash_bwd_dq", &flash_bwd_dq);
  m.def("flash_bwd_dkv", &flash_bwd_dkv);
  m.def("ring_hop", &ring_hop);
  m.def("merge_sorted_pairs", &merge_sorted_pairs);
  m.def("bucket_flatten", &bucket_flatten);
  m.def("bucket_unflatten", &bucket_unflatten);
  m.def("select_scratch", &select_scratch);
  m.def("bsc_select_pack", &bsc_select_pack);
  m.def("bsc_scatter_add", &bsc_scatter_add);
  m.def("fused_sgd_momentum", &fused_sgd_momentum);
  m.def("fused_adam", &fused_adam);
  m.def("quantize_2bit", &quantize_2bit);
  m.def("dequantize_2bit", &dequantize_2bit);
}
