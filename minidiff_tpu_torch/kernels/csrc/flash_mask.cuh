// The masks of the flash kernels (flash_fwd.cu, flash_bwd.cu): which
// (query row, key column) pairs of one batch*head row keep their scores,
// bounds aside.  The JAX kernels' rules (minidiff_tpu/kernels/attention.py
// _causal_mask :85, _block_live :132, _apply_kv_mask :145, _apply_seg_mask
// :155): causal keeps col <= row; a sliding window (window > 0) keeps
// row - col < window, except the first `sinks` columns (attention sinks),
// which every row keeps; a key-padding row keeps columns whose entry is
// nonzero; segment ids keep pairs of equal ids (-1 marks padding, which
// sees only padding).  The key row is (B, Sk) and the ids (B, S) int32,
// shared by the h heads of a batch row: row bh reads batch bh / h.
#pragma once

struct FlashMask {
  int causal, window, sinks;
  const int* kvm;  // this batch row's key-padding row, or null
  const int* seg;  // this batch row's segment ids, or null

  __device__ __forceinline__ FlashMask(int causal_, int window_, int sinks_, const int* kvm_,
                                       const int* seg_, int bh, int h, int sq, int sk)
      : causal(causal_), window(window_), sinks(window_ > 0 ? sinks_ : 0),
        kvm(kvm_ ? kvm_ + static_cast<size_t>(bh / h) * sk : nullptr),
        seg(seg_ ? seg_ + static_cast<size_t>(bh / h) * sq : nullptr) {}

  // causal, window and sinks of (row, col)
  __device__ __forceinline__ bool band(int row, int col) const {
    return !causal || (row >= col && (window <= 0 || row - col < window || col < sinks));
  }

  // the id of a row (seg_row's argument to keep), -2 where there are none
  // or the row is past n
  __device__ __forceinline__ int id(int row, int n) const {
    return seg != nullptr && row < n ? seg[row] : -2;
  }

  // the key row and ids of (row, col), col in bounds; seg_row = id(row)
  __device__ __forceinline__ bool rows_keep(int col, int seg_row) const {
    return (kvm == nullptr || kvm[col] != 0) && (seg == nullptr || seg[col] == seg_row);
  }

  // whether (row, col) keeps its score, col in bounds; seg_row = id(row).
  // ROWS: a key row or ids may be present.  The kernels are instantiated
  // with and without, so that the masks of a call without them cost what
  // causal and the window cost
  template <bool ROWS>
  __device__ __forceinline__ bool keep(int row, int col, int seg_row) const {
    if constexpr (ROWS) return band(row, col) && rows_keep(col, seg_row);
    return band(row, col);
  }

  // whether key tile [k0, k0 + bk) holds a pair visible to query rows
  // [q0, q0 + bq) under causal, window and sinks (_block_live)
  __device__ __forceinline__ bool tile_live(int q0, int bq, int k0, int bk) const {
    if (!causal) return true;
    if (k0 > q0 + bq - 1) return false;
    return window <= 0 || k0 + bk - 1 >= q0 - (window - 1) || k0 < sinks;
  }
};
