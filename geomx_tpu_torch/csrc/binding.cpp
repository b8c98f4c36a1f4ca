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

// element offset of row r of a [*B, n] tensor with arbitrary batch strides
int64_t row_offset(const at::Tensor& t, int64_t r) {
  int64_t off = 0;
  for (int64_t d = t.dim() - 2; d >= 0; --d) {
    const int64_t s = t.size(d);
    off += (r % s) * t.stride(d);
    r /= s;
  }
  return off;
}

struct Copy {
  const float* src;  // nullptr: write zeros
  float* dst;
  int64_t n;
};

// Launches the copy table, GX_MAX_COPIES entries a launch; returns the
// number of launches.
int64_t launch_copies(const std::vector<Copy>& copies, cudaStream_t stream) {
  const int64_t tile = gx_bucket_tile();
  int64_t launches = 0;
  size_t i = 0;
  GxCopyTable table;
  while (i < copies.size()) {
    int64_t blocks = 0;
    table.count = 0;
    while (i < copies.size() && table.count < GX_MAX_COPIES) {
      const int64_t nb = (copies[i].n + tile - 1) / tile;
      TORCH_CHECK(nb < INT_MAX, "a bucket copy of ", copies[i].n,
                  " elements is too large for one launch");
      if (blocks + nb > INT_MAX) break;
      table.block_start[table.count] = static_cast<int>(blocks);
      table.src[table.count] = copies[i].src;
      table.dst[table.count] = copies[i].dst;
      table.n[table.count] = copies[i].n;
      blocks += nb;
      ++table.count;
      ++i;
    }
    table.block_start[table.count] = static_cast<int>(blocks);
    table.total_blocks = static_cast<int>(blocks);
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
// bucket's tail past its last leaf is zero-filled.  Returns launches.
int64_t bucket_flatten(const std::vector<at::Tensor>& leaves,
                       const std::vector<at::Tensor>& buckets,
                       const std::vector<int64_t>& bucket_of,
                       const std::vector<int64_t>& offset_of) {
  check_layout(leaves, buckets, bucket_of, offset_of);
  const c10::cuda::CUDAGuard guard(buckets[0].device());
  const int64_t rows = rows_of(buckets[0]);
  std::vector<int64_t> fill(buckets.size(), 0);
  for (size_t i = 0; i < leaves.size(); ++i) {
    fill[bucket_of[i]] =
        std::max(fill[bucket_of[i]], offset_of[i] + leaves[i].size(-1));
  }
  std::vector<Copy> copies;
  copies.reserve(rows * (leaves.size() + buckets.size()));
  for (int64_t r = 0; r < rows; ++r) {
    for (size_t i = 0; i < leaves.size(); ++i) {
      const int64_t n = leaves[i].size(-1);
      if (n == 0) continue;
      const auto& b = buckets[bucket_of[i]];
      copies.push_back({leaves[i].data_ptr<float>() + row_offset(leaves[i], r),
                        b.data_ptr<float>() + r * b.size(-1) + offset_of[i],
                        n});
    }
    for (size_t j = 0; j < buckets.size(); ++j) {
      const int64_t total = buckets[j].size(-1);
      if (fill[j] < total) {
        copies.push_back({nullptr,
                          buckets[j].data_ptr<float>() + r * total + fill[j],
                          total - fill[j]});
      }
    }
  }
  return launch_copies(copies, at::cuda::getCurrentCUDAStream());
}

// buckets [*B, N_b] -> leaves [*B, n_i] (contiguous outputs).  Returns
// launches.
int64_t bucket_unflatten(const std::vector<at::Tensor>& buckets,
                         const std::vector<at::Tensor>& leaves,
                         const std::vector<int64_t>& bucket_of,
                         const std::vector<int64_t>& offset_of) {
  check_layout(leaves, buckets, bucket_of, offset_of);
  for (const auto& leaf : leaves) check_contiguous(leaf, at::kFloat, "leaf");
  const c10::cuda::CUDAGuard guard(buckets[0].device());
  const int64_t rows = rows_of(buckets[0]);
  std::vector<Copy> copies;
  copies.reserve(rows * leaves.size());
  for (int64_t r = 0; r < rows; ++r) {
    for (size_t i = 0; i < leaves.size(); ++i) {
      const int64_t n = leaves[i].size(-1);
      if (n == 0) continue;
      const auto& b = buckets[bucket_of[i]];
      copies.push_back({b.data_ptr<float>() + r * b.size(-1) + offset_of[i],
                        leaves[i].data_ptr<float>() + r * n, n});
    }
  }
  return launch_copies(copies, at::cuda::getCurrentCUDAStream());
}

int64_t select_blocks(int64_t n) {
  TORCH_CHECK(n > 0 && n < INT_MAX / 2, "row length ", n, " out of range");
  return gx_bsc_select_blocks(static_cast<int>(n));
}

// g, u, v, new_u, new_v [rows, n]; thr [rows]; vals, idx [rows, k];
// scratch counts [rows, nblk], before [rows, nblk, 2], totals [rows, 2].
void bsc_select_pack(const at::Tensor& g, const at::Tensor& u,
                     const at::Tensor& v, const at::Tensor& thr, int64_t k,
                     const at::Tensor& counts, const at::Tensor& before,
                     const at::Tensor& totals, const at::Tensor& new_u,
                     const at::Tensor& new_v, const at::Tensor& vals,
                     const at::Tensor& idx) {
  for (const auto* t : {&g, &u, &v, &thr, &new_u, &new_v, &vals}) {
    check_contiguous(*t, at::kFloat, "select_pack float operand");
  }
  for (const auto* t : {&counts, &before, &totals, &idx}) {
    check_contiguous(*t, at::kInt, "select_pack int operand");
  }
  TORCH_CHECK(g.dim() == 2, "g must be [rows, n]");
  const int64_t rows = g.size(0), n = g.size(1);
  for (const auto* t : {&u, &v, &new_u, &new_v}) {
    TORCH_CHECK(t->sizes() == g.sizes(), "g, u, v, new_u, new_v differ in shape");
  }
  TORCH_CHECK(rows > 0 && rows < 65536, "rows out of range: ", rows);
  TORCH_CHECK(k > 0 && k < INT_MAX, "k out of range: ", k);
  const int64_t nblk = select_blocks(n);
  TORCH_CHECK(thr.numel() == rows, "thr needs one value a row");
  TORCH_CHECK(vals.numel() == rows * k && idx.numel() == rows * k,
              "vals/idx must be [rows, k]");
  TORCH_CHECK(counts.numel() >= rows * nblk && before.numel() >= rows * nblk * 2 &&
                  totals.numel() >= rows * 2,
              "select_pack scratch too small");
  const c10::cuda::CUDAGuard guard(g.device());
  check_launch(
      gx_bsc_select_pack(g.data_ptr<float>(), u.data_ptr<float>(),
                         v.data_ptr<float>(), thr.data_ptr<float>(),
                         static_cast<int>(rows), static_cast<int>(n),
                         static_cast<int>(k), counts.data_ptr<int>(),
                         before.data_ptr<int>(), totals.data_ptr<int>(),
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

// svals fp32, skey and rank int32, out_vals fp32, out_idx int32, all
// [rows, m] contiguous on one device; 0 <= rounds <= GX_MERGE_MAX_ROUNDS.
void merge_sorted_pairs(const at::Tensor& svals, const at::Tensor& skey,
                        const at::Tensor& rank, int64_t rounds,
                        const at::Tensor& out_vals, const at::Tensor& out_idx) {
  check_contiguous(svals, at::kFloat, "svals");
  check_contiguous(out_vals, at::kFloat, "out_vals");
  for (const auto* t : {&skey, &rank, &out_idx}) {
    check_contiguous(*t, at::kInt, "merge int operand");
  }
  TORCH_CHECK(svals.dim() == 2, "svals must be [rows, m]");
  for (const auto* t : {&skey, &rank, &out_vals, &out_idx}) {
    TORCH_CHECK(t->sizes() == svals.sizes(), "merge operands differ in shape");
    TORCH_CHECK(t->device() == svals.device(), "merge operands on two devices");
  }
  const int64_t rows = svals.size(0), m = svals.size(1);
  TORCH_CHECK(rows < INT_MAX && m < INT_MAX, "merge sizes out of range");
  TORCH_CHECK(rounds >= 0 && rounds <= GX_MERGE_MAX_ROUNDS,
              "merge rounds out of range: ", rounds);
  const c10::cuda::CUDAGuard guard(svals.device());
  check_launch(gx_merge_sorted_pairs(svals.data_ptr<float>(),
                                     skey.data_ptr<int>(), rank.data_ptr<int>(),
                                     static_cast<int>(rows), static_cast<int>(m),
                                     static_cast<int>(rounds),
                                     out_vals.data_ptr<float>(),
                                     out_idx.data_ptr<int>(),
                                     at::cuda::getCurrentCUDAStream()),
               "merge_sorted_pairs");
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("merge_sorted_pairs", &merge_sorted_pairs);
  m.def("bucket_flatten", &bucket_flatten);
  m.def("bucket_unflatten", &bucket_unflatten);
  m.def("select_blocks", &select_blocks);
  m.def("bsc_select_pack", &bsc_select_pack);
  m.def("bsc_scatter_add", &bsc_scatter_add);
  m.def("fused_sgd_momentum", &fused_sgd_momentum);
  m.def("fused_adam", &fused_adam);
  m.def("quantize_2bit", &quantize_2bit);
  m.def("dequantize_2bit", &dequantize_2bit);
}
