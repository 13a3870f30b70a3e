// Native scene-tile server: fused patch-crop + bilinear resize.
//
// The reference's whole-scene inference crops every sliding-window patch
// into a materialized (N, p, p, 3) uint8 array and then resizes each patch
// (aerial_image_segmentation_api.py:349-373).  For a 4096x4096 scene at
// patch 1024 / overlap 0.5 that intermediate is ~600 MB of pure memory
// traffic before the model sees a byte.  This server samples each OUTPUT
// pixel's bilinear taps directly from the scene raster, so the host path
// reads the scene once and writes only the (N, out_h, out_w, 3) tile set
// the device actually consumes (the uint8 H2D fast path of
// infer/api.py::patch_and_preprocess).
//
// Arithmetic matches OpenCV's INTER_LINEAR uint8 fixed-point scheme
// (2048-scaled coefficients, round-half-up descale by 2^22) so the native
// path is tile-for-tile comparable with the cv2 fallback; the parity test
// (tests/test_native.py) pins max |delta| <= 1 LSB and exact equality on
// the power-of-two scales the workflow uses (1024 -> 512 is a 2x2 mean).
//
// Built at import time by ssunet_gan_tpu/native/__init__.py (g++ -O3) and
// bound via ctypes; every entry point is plain C ABI.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kCoefBits = 11;                   // OpenCV INTER_RESIZE_COEF_BITS
constexpr int kCoefScale = 1 << kCoefBits;      // 2048
constexpr int kDescaleBits = kCoefBits * 2;     // 22

inline uint8_t descale(int64_t v) {
  int64_t r = (v + (1ll << (kDescaleBits - 1))) >> kDescaleBits;
  return static_cast<uint8_t>(std::min<int64_t>(255, std::max<int64_t>(0, r)));
}

// Per-axis resize plan: source tap index + the two 2048-scaled weights for
// every output coordinate, OpenCV border convention (edge taps collapse).
struct AxisPlan {
  std::vector<int32_t> s0;
  std::vector<int32_t> c0, c1;
};

AxisPlan plan_axis(int64_t src, int64_t dst) {
  AxisPlan p;
  p.s0.resize(dst);
  p.c0.resize(dst);
  p.c1.resize(dst);
  const double scale = static_cast<double>(src) / static_cast<double>(dst);
  for (int64_t x = 0; x < dst; ++x) {
    double fx = (x + 0.5) * scale - 0.5;
    int64_t sx = static_cast<int64_t>(std::floor(fx));
    fx -= sx;
    if (sx < 0) { sx = 0; fx = 0.0; }
    if (sx >= src - 1) { sx = src - 2; fx = 1.0; }
    if (src == 1) { sx = 0; fx = 0.0; }
    p.s0[x] = static_cast<int32_t>(sx);
    int c1 = static_cast<int>(std::lround(fx * kCoefScale));
    p.c0[x] = kCoefScale - c1;
    p.c1[x] = c1;
  }
  return p;
}

struct TileJob {
  const uint8_t* scene;
  int64_t H, W, C;
  const int64_t* coords;  // (n, 2) int64 (y, x) patch origins
  int64_t p;              // square patch side in scene pixels
  int64_t oh, ow;
  uint8_t* out;           // (n, oh, ow, C)
  const AxisPlan* py;
  const AxisPlan* px;
};

void render_tile(const TileJob& j, int64_t k) {
  const int64_t y0 = j.coords[2 * k];
  const int64_t x0 = j.coords[2 * k + 1];
  uint8_t* dst = j.out + k * j.oh * j.ow * j.C;
  const int64_t row_stride = j.W * j.C;
  for (int64_t oy = 0; oy < j.oh; ++oy) {
    const int64_t sy = y0 + j.py->s0[oy];
    const int64_t b0 = j.py->c0[oy], b1 = j.py->c1[oy];
    const uint8_t* r0 = j.scene + sy * row_stride;
    const uint8_t* r1 = r0 + (j.p > 1 ? row_stride : 0);
    uint8_t* drow = dst + oy * j.ow * j.C;
    for (int64_t ox = 0; ox < j.ow; ++ox) {
      const int64_t sx = (x0 + j.px->s0[ox]) * j.C;
      const int64_t a0 = j.px->c0[ox], a1 = j.px->c1[ox];
      const int64_t sx1 = sx + (j.p > 1 ? j.C : 0);
      for (int64_t c = 0; c < j.C; ++c) {
        const int64_t h0 = a0 * r0[sx + c] + a1 * r0[sx1 + c];
        const int64_t h1 = a0 * r1[sx + c] + a1 * r1[sx1 + c];
        drow[ox * j.C + c] = descale(h0 * b0 + h1 * b1);
      }
    }
  }
}

void run_jobs(const TileJob& j, int64_t n, int nthreads) {
  if (nthreads <= 1 || n <= 1) {
    for (int64_t k = 0; k < n; ++k) render_tile(j, k);
    return;
  }
  const int t = std::min<int64_t>(nthreads, n);
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) {
    pool.emplace_back([&, i] {
      for (int64_t k = i; k < n; k += t) render_tile(j, k);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Fused crop+resize of n square patches from an HWC uint8 scene.
// coords: (n, 2) int64 (y, x) origins, each patch p x p fully inside the
// scene (grid_coords guarantees this).  out: (n, oh, ow, C) uint8.
void tile_extract_resize_u8(const uint8_t* scene, int64_t H, int64_t W,
                            int64_t C, const int64_t* coords, int64_t n,
                            int64_t p, int64_t oh, int64_t ow, uint8_t* out,
                            int nthreads) {
  AxisPlan py = plan_axis(p, oh);
  AxisPlan px = plan_axis(p, ow);
  TileJob j{scene, H, W, C, coords, p, oh, ow, out, &py, &px};
  run_jobs(j, n, nthreads);
}

// Plain crop (masks keep full patch resolution): out (n, p, p, C) uint8.
void tile_extract_u8(const uint8_t* scene, int64_t H, int64_t W, int64_t C,
                     const int64_t* coords, int64_t n, int64_t p,
                     uint8_t* out, int nthreads) {
  const int64_t row_stride = W * C;
  const int64_t prow = p * C;
  if (nthreads <= 1 || n <= 1) {
    for (int64_t k = 0; k < n; ++k) {
      const uint8_t* src =
          scene + coords[2 * k] * row_stride + coords[2 * k + 1] * C;
      uint8_t* dst = out + k * p * prow;
      for (int64_t y = 0; y < p; ++y)
        std::memcpy(dst + y * prow, src + y * row_stride, prow);
    }
    return;
  }
  const int t = std::min<int64_t>(nthreads, n);
  std::vector<std::thread> pool;
  pool.reserve(t);
  for (int i = 0; i < t; ++i) {
    pool.emplace_back([&, i] {
      for (int64_t k = i; k < n; k += t) {
        const uint8_t* src =
            scene + coords[2 * k] * row_stride + coords[2 * k + 1] * C;
        uint8_t* dst = out + k * p * prow;
        for (int64_t y = 0; y < p; ++y)
          std::memcpy(dst + y * prow, src + y * row_stride, prow);
      }
    });
  }
  for (auto& th : pool) th.join();
}

int tile_server_abi_version() { return 1; }

}  // extern "C"
