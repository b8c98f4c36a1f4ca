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

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("bucket_flatten", &bucket_flatten);
  m.def("bucket_unflatten", &bucket_unflatten);
  m.def("select_blocks", &select_blocks);
  m.def("bsc_select_pack", &bsc_select_pack);
  m.def("bsc_scatter_add", &bsc_scatter_add);
}
