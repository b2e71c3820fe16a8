// Host-side native code of leod_tpu_torch (C ABI, loaded via ctypes): a
// copy of leod_tpu/native/host_ops.cpp, of which only this comment
// differs.
//
// The reference relies on external native code for exactly these two
// hot host paths: torchvision's C++/CUDA NMS (yolox/utils/boxes.py:66-78)
// and pycocotools' C COCO matching (metrics/coco_eval.py:16-29). The
// Python modules (ops/nms.py, eval/coco.py) fall back to numpy versions
// with the same results when the library cannot be built.
//
// Built by native/__init__.py into leod_tpu_torch/_build/:
//   g++ -O3 -march=native -shared -fPIC -o libleod_host-<hash>.so host_ops.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Greedy class-aware NMS.
// boxes: [n,4] xyxy (float32), scores [n], class_ids [n] (float32).
// keep_out: caller-allocated [n] int32; returns number kept. Kept indices
// are written in score-descending order.
int leod_nms(const float* boxes, const float* scores, const float* class_ids,
             int n, float iou_threshold, int class_aware, int* keep_out) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return scores[a] > scores[b]; });
  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    areas[i] = std::max(0.f, b[2] - b[0]) * std::max(0.f, b[3] - b[1]);
  }
  std::vector<char> alive(n, 1);
  int n_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (!alive[i]) continue;
    keep_out[n_keep++] = i;
    const float* bi = boxes + 4 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (!alive[j]) continue;
      if (class_aware && class_ids[i] != class_ids[j]) continue;
      const float* bj = boxes + 4 * j;
      float xx0 = std::max(bi[0], bj[0]);
      float yy0 = std::max(bi[1], bj[1]);
      float xx1 = std::min(bi[2], bj[2]);
      float yy1 = std::min(bi[3], bj[3]);
      if (xx0 >= xx1 || yy0 >= yy1) continue;
      float inter = (xx1 - xx0) * (yy1 - yy0);
      float iou = inter / std::max(areas[i] + areas[j] - inter, 1e-16f);
      if (iou > iou_threshold) alive[j] = 0;
    }
  }
  return n_keep;
}

// COCO-style greedy matching for one image/category: IoU computed ONCE,
// then matched at T IoU thresholds for EVERY area range in one call
// (pycocotools computes IoU once per (image, cat) the same way; the
// 4 area ranges only change which GTs are flagged ignore).
//
// dt: [d,4] xywh sorted score-DESC (caller sorts + caps maxDet)
// gt: [g,4] xywh (any order); gt_ignore_base [g] uint8
// thrs: [t] IoU thresholds; area_ranges: [n_areas,2] (lo, hi)
// out: dt_matched [n_areas,t,d] uint8, dt_ig [n_areas,t,d] uint8,
//      npig [n_areas] int32 (count of non-ignored GTs per range)
void leod_coco_eval_image(const double* dt, int d, const double* gt, int g,
                          const uint8_t* gt_ignore_base,
                          const double* thrs, int t,
                          const double* area_ranges, int n_areas,
                          uint8_t* dt_matched, uint8_t* dt_ig,
                          int32_t* npig) {
  std::vector<double> ious((size_t)d * g);
  for (int i = 0; i < d; ++i) {
    const double* db = dt + 4 * i;
    double dx1 = db[0] + db[2], dy1 = db[1] + db[3];
    double da = db[2] * db[3];
    for (int j = 0; j < g; ++j) {
      const double* gb = gt + 4 * j;
      double ix = std::min(dx1, gb[0] + gb[2]) - std::max(db[0], gb[0]);
      double iy = std::min(dy1, gb[1] + gb[3]) - std::max(db[1], gb[1]);
      double inter = (ix > 0 && iy > 0) ? ix * iy : 0.0;
      double ga = gb[2] * gb[3];
      ious[(size_t)i * g + j] = inter / std::max(da + ga - inter, 1e-12);
    }
  }
  std::vector<double> dt_area(d), gt_area(g);
  for (int i = 0; i < d; ++i) dt_area[i] = dt[4 * i + 2] * dt[4 * i + 3];
  for (int j = 0; j < g; ++j) gt_area[j] = gt[4 * j + 2] * gt[4 * j + 3];

  std::memset(dt_matched, 0, (size_t)n_areas * t * d);
  std::memset(dt_ig, 0, (size_t)n_areas * t * d);
  std::vector<uint8_t> gt_ig(g);
  std::vector<int> order(g);
  std::vector<char> gtm(g);
  for (int a = 0; a < n_areas; ++a) {
    double a0 = area_ranges[2 * a], a1 = area_ranges[2 * a + 1];
    int np_a = 0;
    for (int j = 0; j < g; ++j) {
      gt_ig[j] = gt_ignore_base[j] || gt_area[j] < a0 || gt_area[j] > a1;
      np_a += !gt_ig[j];
    }
    npig[a] = np_a;
    // gts iterated non-ignore first, stable (pycocotools gtind sort)
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int x, int y) { return gt_ig[x] < gt_ig[y]; });
    uint8_t* dm = dt_matched + (size_t)a * t * d;
    uint8_t* di = dt_ig + (size_t)a * t * d;
    for (int ti = 0; ti < t; ++ti) {
      std::fill(gtm.begin(), gtm.end(), 0);
      for (int i = 0; i < d; ++i) {
        double best = std::min(thrs[ti], 1.0 - 1e-10);
        int m = -1;
        for (int oj = 0; oj < g; ++oj) {
          int j = order[oj];
          if (gtm[j]) continue;
          // stop once we have a real match and reach the ignore region
          // (pycocotools semantics)
          if (m > -1 && !gt_ig[m] && gt_ig[j]) break;
          double v = ious[(size_t)i * g + j];
          if (v < best) continue;
          best = v;
          m = j;
        }
        if (m == -1) {
          // unmatched dets outside the area range are ignored
          if (dt_area[i] < a0 || dt_area[i] > a1) di[(size_t)ti * d + i] = 1;
          continue;
        }
        dm[(size_t)ti * d + i] = 1;
        di[(size_t)ti * d + i] = gt_ig[m];
        gtm[m] = 1;
      }
    }
  }
}

}  // extern "C"
