// Native preprocessing core for hcmoco_tpu_torch (a copy of
// hcmoco_tpu/native/preproc.cpp).
//
// Replacement for the reference's CPU-bound offline pipeline
// (pycontrast/data/NTURGBD/): the reference burns 16 python processes on
// text parsing, RANSAC and per-frame warps; these kernels do the same work
// single-threaded 10-100x faster and are exposed to python via ctypes
// (no pybind11 needed).
//
// Exposed C ABI:
//   parse_skeleton(path, out, max_records) -> n_records
//     records: [frame, body, joint, x, y, z, dx, dy, cx, cy] per joint line
//   ransac_homography(src, dst, n, thresh, iters, seed, out9) -> inliers
//   warp_perspective_u8(img, h, w, c, hinv9, out, oh, ow) -> 0/1
//
// Built with g++ at first use by hcmoco_tpu_torch/native/__init__.py.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// .skeleton parser
// ---------------------------------------------------------------------------

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\r' || *p == '\n' || *p == '\t'))
    ++p;
  return p;
}

static inline const char* read_double(const char* p, const char* end,
                                      double* out) {
  p = skip_ws(p, end);
  char* q = nullptr;
  *out = strtod(p, &q);
  return q;
}

static inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// Returns the number of (frame, body, joint) records written, or -1.
long parse_skeleton(const char* path, double* out, long max_records) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return -1;
  }
  fclose(f);
  buf[size] = '\0';
  const char* p = buf.data();
  const char* end = buf.data() + size;

  double v = 0;
  p = read_double(p, end, &v);
  long n_frames = (long)v;
  p = next_line(p, end);
  long n = 0;
  for (long fi = 0; fi < n_frames && p < end; ++fi) {
    p = read_double(p, end, &v);
    long n_bodies = (long)v;
    p = next_line(p, end);
    for (long bi = 0; bi < n_bodies && p < end; ++bi) {
      p = next_line(p, end);  // body info line
      p = read_double(p, end, &v);
      long n_joints = (long)v;
      p = next_line(p, end);
      for (long ji = 0; ji < n_joints && p < end; ++ji) {
        double vals[7];
        const char* q = p;
        for (int k = 0; k < 7; ++k) q = read_double(q, end, &vals[k]);
        if (n < max_records) {
          double* r = out + n * 10;
          r[0] = (double)fi;
          r[1] = (double)bi;
          r[2] = (double)ji;
          for (int k = 0; k < 7; ++k) r[3 + k] = vals[k];
        }
        ++n;
        p = next_line(p, end);
      }
    }
  }
  return n <= max_records ? n : -n;  // negative => caller buffer too small
}

// ---------------------------------------------------------------------------
// Homography: normalized DLT (via Jacobi eigen of A^T A) + RANSAC
// ---------------------------------------------------------------------------

// Jacobi eigenvalue iteration for the symmetric 9x9 A^T A; the null-space
// eigenvector (smallest eigenvalue) is the DLT solution.
static void jacobi_smallest_evec(double m[9][9], double* evec) {
  double v[9][9];
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 9; ++j) v[i][j] = (i == j) ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 64; ++sweep) {
    double off = 0;
    for (int i = 0; i < 9; ++i)
      for (int j = i + 1; j < 9; ++j) off += m[i][j] * m[i][j];
    if (off < 1e-24) break;
    for (int i = 0; i < 9; ++i) {
      for (int j = i + 1; j < 9; ++j) {
        if (std::fabs(m[i][j]) < 1e-30) continue;
        double theta = (m[j][j] - m[i][i]) / (2.0 * m[i][j]);
        double t = (theta >= 0 ? 1.0 : -1.0) /
                   (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
        double c = 1.0 / std::sqrt(t * t + 1.0);
        double s = t * c;
        for (int k = 0; k < 9; ++k) {
          double mik = m[i][k], mjk = m[j][k];
          m[i][k] = c * mik - s * mjk;
          m[j][k] = s * mik + c * mjk;
        }
        for (int k = 0; k < 9; ++k) {
          double mki = m[k][i], mkj = m[k][j];
          m[k][i] = c * mki - s * mkj;
          m[k][j] = s * mki + c * mkj;
        }
        for (int k = 0; k < 9; ++k) {
          double vki = v[k][i], vkj = v[k][j];
          v[k][i] = c * vki - s * vkj;
          v[k][j] = s * vki + c * vkj;
        }
      }
    }
  }
  int best = 0;
  for (int i = 1; i < 9; ++i)
    if (m[i][i] < m[best][best]) best = i;
  for (int k = 0; k < 9; ++k) evec[k] = v[k][best];
}

static bool dlt(const double* src, const double* dst, const int* idx,
                int n, double* h9) {
  // normalize
  double ms[2] = {0, 0}, md[2] = {0, 0};
  for (int i = 0; i < n; ++i) {
    int k = idx ? idx[i] : i;
    ms[0] += src[2 * k];
    ms[1] += src[2 * k + 1];
    md[0] += dst[2 * k];
    md[1] += dst[2 * k + 1];
  }
  for (int d = 0; d < 2; ++d) {
    ms[d] /= n;
    md[d] /= n;
  }
  double ss = 0, sd = 0;
  for (int i = 0; i < n; ++i) {
    int k = idx ? idx[i] : i;
    ss += std::hypot(src[2 * k] - ms[0], src[2 * k + 1] - ms[1]);
    sd += std::hypot(dst[2 * k] - md[0], dst[2 * k + 1] - md[1]);
  }
  ss = ss > 1e-12 ? std::sqrt(2.0) * n / ss : 1.0;
  sd = sd > 1e-12 ? std::sqrt(2.0) * n / sd : 1.0;

  double ata[9][9];
  memset(ata, 0, sizeof(ata));
  for (int i = 0; i < n; ++i) {
    int k = idx ? idx[i] : i;
    double sx = (src[2 * k] - ms[0]) * ss;
    double sy = (src[2 * k + 1] - ms[1]) * ss;
    double dx = (dst[2 * k] - md[0]) * sd;
    double dy = (dst[2 * k + 1] - md[1]) * sd;
    double r1[9] = {sx, sy, 1, 0, 0, 0, -sx * dx, -sy * dx, -dx};
    double r2[9] = {0, 0, 0, sx, sy, 1, -sx * dy, -sy * dy, -dy};
    for (int a = 0; a < 9; ++a)
      for (int b = 0; b < 9; ++b)
        ata[a][b] += r1[a] * r1[b] + r2[a] * r2[b];
  }
  double hn[9];
  jacobi_smallest_evec(ata, hn);
  // denormalize: H = Td^-1 * Hn * Ts
  double td_inv[3][3] = {{1.0 / sd, 0, md[0]}, {0, 1.0 / sd, md[1]},
                         {0, 0, 1}};
  double ts[3][3] = {{ss, 0, -ss * ms[0]}, {0, ss, -ss * ms[1]}, {0, 0, 1}};
  double tmp[3][3], hfull[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      tmp[i][j] = 0;
      for (int k = 0; k < 3; ++k)
        tmp[i][j] += td_inv[i][k] * hn[3 * k + j];
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      hfull[i][j] = 0;
      for (int k = 0; k < 3; ++k) hfull[i][j] += tmp[i][k] * ts[k][j];
    }
  if (std::fabs(hfull[2][2]) < 1e-15) return false;
  for (int i = 0; i < 9; ++i) h9[i] = hfull[i / 3][i % 3] / hfull[2][2];
  return true;
}

long ransac_homography(const double* src, const double* dst, long n,
                       double thresh, long iters, long seed, double* out9) {
  if (n < 4) return -1;
  std::mt19937_64 rng((uint64_t)seed);
  std::uniform_int_distribution<long> pick(0, n - 1);
  std::vector<uint8_t> best_mask(n, 0), mask(n, 0);
  long best_count = -1;
  double h[9];
  double t2 = thresh * thresh;
  for (long it = 0; it < iters; ++it) {
    int idx[4];
    for (int k = 0; k < 4; ++k) {
      bool dup;
      do {
        idx[k] = (int)pick(rng);
        dup = false;
        for (int m = 0; m < k; ++m)
          if (idx[m] == idx[k]) dup = true;
      } while (dup);
    }
    if (!dlt(src, dst, idx, 4, h)) continue;
    long count = 0;
    for (long i = 0; i < n; ++i) {
      double x = src[2 * i], y = src[2 * i + 1];
      double w = h[6] * x + h[7] * y + h[8];
      if (std::fabs(w) < 1e-12) {
        mask[i] = 0;
        continue;
      }
      double px = (h[0] * x + h[1] * y + h[2]) / w;
      double py = (h[3] * x + h[4] * y + h[5]) / w;
      double dx = px - dst[2 * i], dy = py - dst[2 * i + 1];
      mask[i] = (dx * dx + dy * dy < t2) ? 1 : 0;
      count += mask[i];
    }
    if (count > best_count) {
      best_count = count;
      best_mask = mask;
    }
  }
  if (best_count < 4) {
    if (!dlt(src, dst, nullptr, (int)n, out9)) return -1;
    return n;
  }
  std::vector<int> inl;
  inl.reserve(best_count);
  for (long i = 0; i < n; ++i)
    if (best_mask[i]) inl.push_back((int)i);
  if (!dlt(src, dst, inl.data(), (int)inl.size(), out9)) return -1;
  return best_count;
}

// ---------------------------------------------------------------------------
// Bilinear inverse perspective warp (uint8 HWC)
// ---------------------------------------------------------------------------

int warp_perspective_u8(const uint8_t* img, long ih, long iw, long c,
                        const double* hinv9, uint8_t* out, long oh,
                        long ow) {
  for (long y = 0; y < oh; ++y) {
    for (long x = 0; x < ow; ++x) {
      double w = hinv9[6] * x + hinv9[7] * y + hinv9[8];
      uint8_t* o = out + (y * ow + x) * c;
      if (std::fabs(w) < 1e-12) {
        memset(o, 0, c);
        continue;
      }
      double sx = (hinv9[0] * x + hinv9[1] * y + hinv9[2]) / w;
      double sy = (hinv9[3] * x + hinv9[4] * y + hinv9[5]) / w;
      long x0 = (long)std::floor(sx), y0 = (long)std::floor(sy);
      if (x0 < -1 || y0 < -1 || x0 > iw - 1 || y0 > ih - 1) {
        memset(o, 0, c);
        continue;
      }
      double fx = sx - x0, fy = sy - y0;
      // tap-wise BORDER_CONSTANT(0): out-of-image taps contribute zero
      // (cv2.warpPerspective default border semantics)
      const bool in00 = x0 >= 0 && y0 >= 0 && x0 < iw && y0 < ih;
      const bool in01 = x0 + 1 >= 0 && y0 >= 0 && x0 + 1 < iw && y0 < ih;
      const bool in10 = x0 >= 0 && y0 + 1 >= 0 && x0 < iw && y0 + 1 < ih;
      const bool in11 =
          x0 + 1 >= 0 && y0 + 1 >= 0 && x0 + 1 < iw && y0 + 1 < ih;
      const uint8_t* base = img + (y0 * iw + x0) * c;
      for (long k = 0; k < c; ++k) {
        double v = (in00 ? base[k] : 0) * (1 - fx) * (1 - fy) +
                   (in01 ? base[c + k] : 0) * fx * (1 - fy) +
                   (in10 ? base[iw * c + k] : 0) * (1 - fx) * fy +
                   (in11 ? base[(iw + 1) * c + k] : 0) * fx * fy;
        o[k] = (uint8_t)(v + 0.5);
      }
    }
  }
  return 0;
}

}  // extern "C"
