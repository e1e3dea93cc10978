// K-weighting of ITU-R BS.1770 (high shelf, then RLB high-pass) and the
// square of its output, in one pass over a line's float32 samples.
//
// Bitwise the same as
//   lfilter(bh, ah, lfilter(bs, as_, x.astype(np.float64))) ** 2
// in scipy: zero initial state, each sample widened to double, each
// second-order section in transposed direct form II with scipy's order of
// operations (sigtools' DOUBLE_filt), the high-pass fed the shelf's output.
// Both a[0] are 1, so scipy's division by a[0] changes nothing. Built with
// -ffp-contract=off, so that no multiply-add is fused.

#include <cstdint>

extern "C" void stylish_k_weighted_square(const float* x, int64_t n,
                                          const double* c, double* out) {
  // c: the shelf's b0 b1 b2 a1 a2, then the high-pass's
  const double sb0 = c[0], sb1 = c[1], sb2 = c[2], sa1 = c[3], sa2 = c[4];
  const double hb0 = c[5], hb1 = c[6], hb2 = c[7], ha1 = c[8], ha2 = c[9];
  double s0 = 0.0, s1 = 0.0, h0 = 0.0, h1 = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double xi = static_cast<double>(x[i]);
    const double y = s0 + sb0 * xi;
    s0 = (s1 + xi * sb1) - y * sa1;
    s1 = xi * sb2 - y * sa2;
    const double v = h0 + hb0 * y;
    h0 = (h1 + y * hb1) - v * ha1;
    h1 = y * hb2 - v * ha2;
    out[i] = v * v;
  }
}
