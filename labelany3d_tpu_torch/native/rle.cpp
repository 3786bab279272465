// COCO RLE codec fast path (pycocotools-C equivalent).
//
// The port's copy of labelany3d_tpu/native/rle.cpp. The reference depends
// on pycocotools' C extension for mask decode (src/util.py:10,367). This
// file provides the same hot loops natively: varint counts-string
// decode/encode and column-major run<->mask expansion, exposed through
// ctypes. The mask loops walk the columns instead of dividing every pixel's
// index, with the same results. labelany3d_tpu_torch.native builds it with
// the host compiler at first use; labelany3d_tpu_torch.data.rle falls back
// to numpy when no compiler is present.
//
// Build: g++ -O3 -shared -fPIC rle.cpp -o librle.so

#include <cstdint>
#include <cstring>

extern "C" {

// Decode a compressed counts string into int64 run lengths.
// Returns the number of counts written (<= max_counts).
int64_t rle_from_string(const char* s, int64_t n, int64_t* counts,
                        int64_t max_counts) {
  int64_t m = 0;
  int64_t p = 0;
  while (p < n && m < max_counts) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more && p < n) {
      int64_t c = (int64_t)(unsigned char)s[p] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      p++;
      k++;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (m > 2) x += counts[m - 2];
    counts[m++] = x;
  }
  return m;
}

// Encode run lengths into the compressed counts string.
// Returns bytes written (<= max_out).
int64_t rle_to_string(const int64_t* counts, int64_t m, char* out,
                      int64_t max_out) {
  int64_t p = 0;
  for (int64_t i = 0; i < m; i++) {
    int64_t x = counts[i];
    if (i > 2) x -= counts[i - 2];
    bool more = true;
    while (more && p < max_out) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      out[p++] = (char)(c + 48);
    }
  }
  return p;
}

// Run lengths -> column-major H x W boolean mask (uint8 out, row-major
// buffer of shape H*W; runs fill columns first). A run's start is split into
// (row, column) once; the run then steps down the column, with no division
// per pixel.
void rle_to_mask(const int64_t* counts, int64_t m, int64_t h, int64_t w,
                 uint8_t* mask) {
  memset(mask, 0, (size_t)(h * w));
  int64_t pos = 0;
  uint8_t val = 0;
  const int64_t total = h * w;
  for (int64_t i = 0; i < m && pos < total; i++) {
    int64_t run = counts[i];
    if (run > total - pos) run = total - pos;
    if (val) {
      int64_t col = pos / h;              // column-major index pos
      int64_t row = pos % h;
      for (int64_t j = 0; j < run; j++) {
        mask[row * w + col] = 1;
        if (++row == h) {
          row = 0;
          ++col;
        }
      }
    }
    pos += run;
    val ^= 1;
  }
}

// H x W boolean mask (row-major uint8) -> run lengths; returns count. The
// traversal is column-major: each column top to bottom, left to right.
int64_t mask_to_rle(const uint8_t* mask, int64_t h, int64_t w,
                    int64_t* counts, int64_t max_counts) {
  int64_t m = 0;
  uint8_t cur = 0;
  int64_t run = 0;
  for (int64_t col = 0; col < w; col++) {
    const uint8_t* p = mask + col;
    for (int64_t row = 0; row < h; row++, p += w) {
      const uint8_t v = *p ? 1 : 0;
      if (v == cur) {
        run++;
      } else {
        if (m < max_counts) counts[m++] = run;
        cur = v;
        run = 1;
      }
    }
  }
  if (m < max_counts) counts[m++] = run;
  return m;
}

}  // extern "C"
