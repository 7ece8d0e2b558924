// Native mask scanner: per-cell bounding boxes, pixel counts and centroid
// sums of an int32 instance mask in one cache-friendly pass.
//
// Host-side replacement for the reference's hottest host path, the Python
// double loop over mask rows that builds cell_pos_dict (reference
// preprocess.py:159-211, utils.py:272-290). ops/extents.py has a torch
// scatter-reduce fallback that computes the same integers.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this toolchain).

#include <cstdint>
#include <limits>

extern "C" {

// mask: row-major int32 H*W. Outputs are arrays of length n_ids
// (callers allocate), indexed by raw cell id; id 0 is background.
// rmin/cmin are initialized to INT32_MAX here; slots with count==0 keep
// sentinel extents and must be masked by the caller.
void mask_scan(const int32_t* mask, int64_t h, int64_t w, int64_t n_ids,
               int32_t* rmin, int32_t* rmax, int32_t* cmin, int32_t* cmax,
               int64_t* count, int64_t* rsum, int64_t* csum) {
  const int32_t kMax = std::numeric_limits<int32_t>::max();
  for (int64_t i = 0; i < n_ids; ++i) {
    rmin[i] = kMax;
    rmax[i] = 0;
    cmin[i] = kMax;
    cmax[i] = 0;
    count[i] = 0;
    rsum[i] = 0;
    csum[i] = 0;
  }
  for (int64_t r = 0; r < h; ++r) {
    const int32_t* row = mask + r * w;
    for (int64_t c = 0; c < w; ++c) {
      const int32_t id = row[c];
      if (id < 0 || id >= n_ids) continue;
      if (r < rmin[id]) rmin[id] = (int32_t)r;
      if (r > rmax[id]) rmax[id] = (int32_t)r;
      if (c < cmin[id]) cmin[id] = (int32_t)c;
      if (c > cmax[id]) cmax[id] = (int32_t)c;
      ++count[id];
      rsum[id] += r;
      csum[id] += c;
    }
  }
}

// Paint an RGB map through a per-cell-id lookup table in one pass:
// out[p] = table[mask[p]] — the native analog of outputs/colorize.py for
// slides too large for comfortable numpy fancy-indexing temporaries.
void lut_paint_rgb(const int32_t* mask, int64_t n_px, const uint8_t* table,
                   int64_t n_ids, uint8_t* out) {
  for (int64_t p = 0; p < n_px; ++p) {
    int32_t id = mask[p];
    if (id < 0 || id >= n_ids) id = 0;
    const uint8_t* src = table + 3 * (int64_t)id;
    uint8_t* dst = out + 3 * p;
    dst[0] = src[0];
    dst[1] = src[1];
    dst[2] = src[2];
  }
}

int32_t ribca_native_abi_version() { return 1; }

}  // extern "C"
