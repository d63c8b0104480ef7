// Fast greedy COCO detection<->GT matching (the hot loop of COCOeval).
//
// Plays the role of pycocotools' C extension in the reference
// (mmdet/datasets/pycocotools): per (image, category, area-range), match
// score-sorted detections to ground truth greedily at T IoU thresholds with
// crowd/ignore semantics. Exposed via a plain C ABI for ctypes.
//
// Built by dskd_tpu_torch/native/build.py:
// c++ -O3 -shared -fPIC -o build/coco_match-<key>.so coco_match.cpp
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// IoU of xywh boxes; crowd GT uses intersection-over-detection (IoF).
static inline double iou_xywh(const double* d, const double* g, bool crowd) {
    double dx1 = d[0], dy1 = d[1], dx2 = d[0] + d[2], dy2 = d[1] + d[3];
    double gx1 = g[0], gy1 = g[1], gx2 = g[0] + g[2], gy2 = g[1] + g[3];
    double iw = std::min(dx2, gx2) - std::max(dx1, gx1);
    double ih = std::min(dy2, gy2) - std::max(dy1, gy1);
    if (iw <= 0 || ih <= 0) return 0.0;
    double inter = iw * ih;
    double da = d[2] * d[3];
    double ga = g[2] * g[3];
    double uni = crowd ? da : (da + ga - inter);
    return uni <= 0 ? 0.0 : inter / uni;
}

// dts: (D, 4) xywh sorted desc by score. gts: (G, 4) xywh sorted with
// non-ignored first. gt_ignore/ gt_crowd: (G,). thrs: (T,).
// Outputs: dtm (T*D) matched gt index or -1; dtig (T*D) 0/1.
void coco_match(const double* dts, int64_t D,
                const double* gts, const uint8_t* gt_ignore,
                const uint8_t* gt_crowd, int64_t G,
                const double* thrs, int64_t T,
                int64_t* dtm, uint8_t* dtig) {
    std::vector<double> ious((size_t)D * G);
    for (int64_t d = 0; d < D; ++d)
        for (int64_t g = 0; g < G; ++g)
            ious[d * G + g] = iou_xywh(dts + 4 * d, gts + 4 * g,
                                       gt_crowd[g] != 0);

    std::vector<int64_t> gtm((size_t)T * G);
    std::fill(gtm.begin(), gtm.end(), (int64_t)-1);
    for (int64_t t = 0; t < T; ++t) {
        for (int64_t d = 0; d < D; ++d) {
            double best_iou = std::min(thrs[t], 1 - 1e-10);
            int64_t best = -1;
            for (int64_t g = 0; g < G; ++g) {
                if (gtm[t * G + g] >= 0 && !gt_crowd[g]) continue;
                // found a real match earlier; remaining gts are ignored
                if (best > -1 && !gt_ignore[best] && gt_ignore[g]) break;
                double v = ious[d * G + g];
                if (v < best_iou) continue;
                best_iou = v;
                best = g;
            }
            dtm[t * D + d] = best;
            dtig[t * D + d] = best >= 0 ? gt_ignore[best] : 0;
            if (best >= 0) gtm[t * G + best] = d;
        }
    }
}

}  // extern "C"
