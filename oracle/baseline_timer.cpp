// Baseline re-timing of the reference 2D Gaussian splatting training loop.
//
// The reference (/root/reference/main.cpp) publishes no benchmark numbers and
// only runs inside a Windows GUI, so BASELINE.md requires us to measure the
// C++ per-iteration throughput ourselves (SURVEY.md section 6). This is an
// independent, GUI-free re-implementation of the same algorithm -- forward
// front-to-back rasterization, analytic backward, per-parameter Adam --
// written SoA-style for clarity, compiled with gcc -O2, used ONLY to produce
// the baseline timings the JAX framework is compared against.
//
// Input: a raw float32 RGB image dumped by scripts/dump_target.py
//   header: int32 height, int32 width, then h*w*3 float32s.
// Output: per-iteration wall time and derived throughput, as JSON on stdout.
//
// Usage: baseline_timer <target.bin> <n_splats> <iterations>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <chrono>
#include <vector>

namespace {

constexpr float kBounds = 3.0f;          // reference main.cpp:7
constexpr float kMinThroughput = 1.0f / 256.0f;  // reference main.cpp:8
constexpr float kBeta1 = 0.9f, kBeta2 = 0.99f;   // reference main.cpp:136-137
constexpr float kLr = 0.05f;             // reference main.cpp:715
constexpr float kAdamEps = 1e-15f;       // reference main.cpp:154

// (1 + x/8)^8 fast exponential with flush-to-zero (reference main.cpp:49-83).
inline float fast_exp(float x) {
  x = 1.0f + x * 0.125f;
  if (x < 0.00001814586175896693021059036255f) return 0.0f;
  x *= x;
  x *= x;
  x *= x;
  return x;
}

inline uint32_t u32(uint32_t v) { return v; }

struct U3 { uint32_t x, y, z; };

U3 hash3(U3 v) {  // pcg3d (reference main.cpp:17-24)
  v.x = v.x * 1664525u + 1013904223u;
  v.y = v.y * 1664525u + 1013904223u;
  v.z = v.z * 1664525u + 1013904223u;
  v.x += v.y * v.z; v.y += v.z * v.x; v.z += v.x * v.y;
  v.x ^= v.x >> 16; v.y ^= v.y >> 16; v.z ^= v.z >> 16;
  v.x += v.y * v.z; v.y += v.z * v.x; v.z += v.x * v.y;
  return v;
}

// SoA splat population + gradients + Adam moments.
struct Pop {
  std::vector<float> px, py, sx, sy, rot, op;
  std::vector<float> cr, cg, cb;
  explicit Pop(size_t n)
      : px(n), py(n), sx(n), sy(n), rot(n), op(n), cr(n), cg(n), cb(n) {}
  size_t size() const { return px.size(); }
  void zero() {
    for (auto* v : {&px, &py, &sx, &sy, &rot, &op, &cr, &cg, &cb})
      std::fill(v->begin(), v->end(), 0.0f);
  }
};

void init_pop(Pop& p, int w, int h) {  // reference main.cpp:280-307
  for (size_t i = 0; i < p.size(); i++) {
    U3 r0 = hash3({(uint32_t)i, 0u, 0xFFFFFFFFu});
    U3 r1 = hash3({(uint32_t)i, 1u, 0xFFFFFFFFu});
    const float inv = 1.0f / 4294967296.0f;  // float(0xFFFFFFFF)
    float a0 = (float)r0.x * inv, a1 = (float)r0.y * inv;
    float b0 = (float)r1.x * inv, b1 = (float)r1.y * inv, b2 = (float)r1.z * inv;
    p.px[i] = a0 * (1.0f - a0) + (w - 1) * a0;  // mix(r0, W-1, r0) quirk
    p.py[i] = a1 * (1.0f - a1) + (h - 1) * a1;
    p.sx[i] = 6.0f * (1.0f - b0) + 10.0f * b0;
    p.sy[i] = 6.0f * (1.0f - b1) + 10.0f * b1;
    p.rot[i] = 3.14159265358979f * b2;
    p.cr[i] = p.cg[i] = p.cb[i] = 0.5f;
    p.op[i] = 1.0f;
  }
}

struct CovTerms { float c, s, a, b, d, det; };

CovTerms cov_terms(const Pop& p, size_t i) {
  float c = std::cos(p.rot[i]), s = std::sin(p.rot[i]);
  float l0 = p.sx[i] * p.sx[i], l1 = p.sy[i] * p.sy[i];
  float s11 = l0 * c * c + l1 * s * s;
  float s12 = (l0 - l1) * s * c;
  float s22 = l0 + l1 - s11;
  float det = s11 * s22 - s12 * s12;
  return {c, s, s22 / det, -s12 / det, s11 / det, det};
}

// Per-row x interval from the ellipse quadratic (reference main.cpp:497-509).
inline bool row_range(float px, float py, const CovTerms& t, int y, int w,
                      int* x0, int* x1, float* vy_out) {
  float vy = (float)(y) + 0.5f - py;
  float qb = 2.0f * t.b * vy;
  float qc = t.d * vy * vy - kBounds * kBounds;
  float disc = qb * qb - 4.0f * t.a * qc;
  if (disc < 0.0f) return false;
  float sgn = qb < 0.0f ? -1.0f : 1.0f;
  float k = (-qb - sgn * std::sqrt(disc)) * 0.5f;
  float r0 = k / t.a, r1 = qc / k;
  int lo = (int)(px + (r0 < r1 ? r0 : r1));
  int hi = (int)(px + (r0 < r1 ? r1 : r0));
  if (lo < 0) lo = 0;
  if (hi > w - 1) hi = w - 1;
  if (lo > hi) return false;
  *x0 = lo; *x1 = hi; *vy_out = vy;
  return true;
}

struct Images {
  int w, h;
  std::vector<float> rgb;   // h*w*3, composited color
  std::vector<float> tr;    // h*w, transmittance
  Images(int w_, int h_) : w(w_), h(h_), rgb(w_ * h_ * 3), tr(w_ * h_) {}
  void reset() {
    std::fill(rgb.begin(), rgb.end(), 0.0f);
    std::fill(tr.begin(), tr.end(), 1.0f);
  }
};

// Forward composite (reference main.cpp:418-538) returning pixel-work count.
uint64_t forward(const Pop& p, Images& img) {
  uint64_t work = 0;
  for (size_t i = 0; i < p.size(); i++) {
    CovTerms t = cov_terms(p, i);
    float hy = std::sqrt(t.a * t.det) * kBounds;
    int y0 = (int)(p.py[i] - hy), y1 = (int)(p.py[i] + hy);
    for (int y = y0; y <= y1; y++) {
      if (y < 0 || y >= img.h) continue;
      int x0, x1; float vy;
      if (!row_range(p.px[i], p.py[i], t, y, img.w, &x0, &x1, &vy)) continue;
      float* trow = &img.tr[y * img.w];
      float* crow = &img.rgb[(y * img.w) * 3];
      for (int x = x0; x <= x1; x++) {
        float T = trow[x];
        if (T < kMinThroughput) continue;
        float vx = (float)x + 0.5f - p.px[i];
        float d2 = t.a * vx * vx + 2.0f * t.b * vx * vy + t.d * vy * vy;
        float alpha = fast_exp(-0.5f * d2) * p.op[i];
        float w = T * alpha;
        crow[x * 3 + 0] += w * p.cr[i];
        crow[x * 3 + 1] += w * p.cg[i];
        crow[x * 3 + 2] += w * p.cb[i];
        trow[x] = T * (1.0f - alpha);
        work++;
      }
    }
  }
  return work;
}

// Analytic backward via replay (reference main.cpp:548-712).
uint64_t backward(const Pop& p, const Images& fwd, const std::vector<float>& ref,
                  Images& replay, Pop& g) {
  uint64_t work = 0;
  replay.reset();
  for (size_t i = 0; i < p.size(); i++) {
    CovTerms t = cov_terms(p, i);
    float hy = std::sqrt(t.a * t.det) * kBounds;
    int y0 = (int)(p.py[i] - hy), y1 = (int)(p.py[i] + hy);
    float cosT = t.c, sinT = t.s;
    float sx3 = p.sx[i] * p.sx[i] * p.sx[i];
    float sy3 = p.sy[i] * p.sy[i] * p.sy[i];
    float rotk = (p.sx[i] * p.sx[i] - p.sy[i] * p.sy[i]) /
                 (p.sx[i] * p.sx[i] * p.sy[i] * p.sy[i]);
    for (int y = y0; y <= y1; y++) {
      if (y < 0 || y >= replay.h) continue;
      int x0, x1; float vy;
      if (!row_range(p.px[i], p.py[i], t, y, replay.w, &x0, &x1, &vy)) continue;
      float* trow = &replay.tr[y * replay.w];
      float* crow = &replay.rgb[(y * replay.w) * 3];
      const float* frow = &fwd.rgb[(y * replay.w) * 3];
      const float* rrow = &ref[(y * replay.w) * 3];
      for (int x = x0; x <= x1; x++) {
        float T = trow[x];
        if (T < kMinThroughput) continue;
        float vx = (float)x + 0.5f - p.px[i];
        float d2 = t.a * vx * vx + 2.0f * t.b * vx * vy + t.d * vy * vy;
        float G = fast_exp(-0.5f * d2);
        float alpha = G * p.op[i];
        float gr = frow[x * 3 + 0] - rrow[x * 3 + 0];
        float gg = frow[x * 3 + 1] - rrow[x * 3 + 1];
        float gb = frow[x * 3 + 2] - rrow[x * 3 + 2];
        float w = alpha * T;
        g.cr[i] += gr * w; g.cg[i] += gg * w; g.cb[i] += gb * w;
        crow[x * 3 + 0] += w * p.cr[i];
        crow[x * 3 + 1] += w * p.cg[i];
        crow[x * 3 + 2] += w * p.cb[i];
        float inv1ma = 1.0f / (1.0f - alpha + 1e-15f);
        float dLda =
            gr * (p.cr[i] * T - (frow[x * 3 + 0] - crow[x * 3 + 0]) * inv1ma) +
            gg * (p.cg[i] * T - (frow[x * 3 + 1] - crow[x * 3 + 1]) * inv1ma) +
            gb * (p.cb[i] * T - (frow[x * 3 + 2] - crow[x * 3 + 2]) * inv1ma);
        float dadx = 0.5f * alpha * (2.0f * t.a * vx + 2.0f * t.b * vy);
        float dady = 0.5f * alpha * (2.0f * t.d * vy + 2.0f * t.b * vx);
        g.px[i] += dLda * dadx;
        g.py[i] += dLda * dady;
        float vxx = vx * vx, vxy = vx * vy, vyy = vy * vy;
        g.sx[i] += dLda * alpha / sx3 *
                   (cosT * cosT * vxx + 2.0f * sinT * cosT * vxy + sinT * sinT * vyy);
        g.sy[i] += dLda * alpha / sy3 *
                   (sinT * sinT * vxx - 2.0f * sinT * cosT * vxy + cosT * cosT * vyy);
        g.rot[i] += dLda * alpha * rotk *
                    ((cosT * cosT - sinT * sinT) * vxy - sinT * cosT * (vxx - vyy));
        g.op[i] += dLda * G;
        trow[x] = T * (1.0f - alpha);
        work++;
      }
    }
  }
  return work;
}

struct Adam {
  std::vector<float> m, v;
  explicit Adam(size_t n) : m(n, 0.0f), v(n, 0.0f) {}
};

void adam_update(std::vector<float>& val, const std::vector<float>& grad,
                 Adam& st, float b1t, float b2t, float lo, float hi) {
  for (size_t i = 0; i < val.size(); i++) {
    float m = kBeta1 * st.m[i] + (1.0f - kBeta1) * grad[i];
    float v = kBeta2 * st.v[i] + (1.0f - kBeta2) * grad[i] * grad[i];
    st.m[i] = m;
    st.v[i] = v;
    float mh = m / (1.0f - b1t), vh = v / (1.0f - b2t);
    float out = val[i] - kLr * mh / (std::sqrt(vh) + kAdamEps);
    val[i] = out < lo ? lo : (out > hi ? hi : out);
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr, "usage: %s target.bin n_splats iterations\n", argv[0]);
    return 1;
  }
  FILE* f = std::fopen(argv[1], "rb");
  if (!f) { std::perror("open"); return 1; }
  int32_t h = 0, w = 0;
  if (std::fread(&h, 4, 1, f) != 1 || std::fread(&w, 4, 1, f) != 1) return 1;
  std::vector<float> ref((size_t)h * w * 3);
  if (std::fread(ref.data(), 4, ref.size(), f) != ref.size()) return 1;
  std::fclose(f);

  size_t n = std::strtoul(argv[2], nullptr, 10);
  int iters = std::atoi(argv[3]);

  Pop pop(n), grads(n);
  init_pop(pop, w, h);
  Images img(w, h), replay(w, h);
  Adam a_px(n), a_py(n), a_sx(n), a_sy(n), a_rot(n), a_cr(n), a_cg(n), a_cb(n);
  float b1t = 1.0f, b2t = 1.0f;

  uint64_t total_work = 0;
  double mse = 0.0;
  auto t_start = std::chrono::steady_clock::now();
  for (int it = 0; it < iters; it++) {
    img.reset();
    total_work += forward(pop, img);
    grads.zero();
    total_work += backward(pop, img, ref, replay, grads);
    b1t *= kBeta1;
    b2t *= kBeta2;
    adam_update(pop.cr, grads.cr, a_cr, b1t, b2t, 0.0f, 1.0f);
    adam_update(pop.cg, grads.cg, a_cg, b1t, b2t, 0.0f, 1.0f);
    adam_update(pop.cb, grads.cb, a_cb, b1t, b2t, 0.0f, 1.0f);
    adam_update(pop.px, grads.px, a_px, b1t, b2t, 0.0f, (float)(w - 1));
    adam_update(pop.py, grads.py, a_py, b1t, b2t, 0.0f, (float)(h - 1));
    adam_update(pop.sx, grads.sx, a_sx, b1t, b2t, 1.0f, 1024.0f);
    adam_update(pop.sy, grads.sy, a_sy, b1t, b2t, 1.0f, 1024.0f);
    adam_update(pop.rot, grads.rot, a_rot, b1t, b2t, -1e30f, 1e30f);
    // opacity not optimized (reference default, main.cpp:317)

    if (it == iters - 1) {
      mse = 0.0;
      for (size_t px = 0; px < (size_t)h * w * 3; px++) {
        double d = (img.rgb[px] - ref[px]) * 255.0;
        mse += d * d;
      }
      mse /= (double)h * w * 3;
    }
  }
  auto t_end = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t_end - t_start).count();
  double per_iter_ms = secs / iters * 1e3;
  double pairs_per_s = (double)total_work / secs;
  std::printf(
      "{\"height\": %d, \"width\": %d, \"n_splats\": %zu, \"iterations\": %d, "
      "\"seconds\": %.6f, \"ms_per_iter\": %.4f, \"iters_per_s\": %.3f, "
      "\"splat_pixel_pairs_per_s\": %.4g, \"final_mse255\": %.4f}\n",
      h, w, n, iters, secs, per_iter_ms, iters / secs, pairs_per_s, mse);
  return 0;
}
