// Greedy AP matcher: the evaluator's hot host loop as native code (the
// port's copy of pqdet_tpu/native/ap_matcher.cpp).
//
// The plain version is Evaluator._match_class_python, a triple loop over
// every detection x IoU threshold x GT box. This C++ core keeps its exact
// semantics, including:
//  - GT sorted easy-first per (file, class) set; `seen` flags per threshold
//  - early break when a pick exists and the difficult region starts
//  - the pick==-1 negative-indexing quirk: difficult[last] decides whether
//    an unmatched detection is dropped instead of counted FP
// Built on first use with g++ into pqdet_tpu_torch/_build/ and bound with
// ctypes (native/matcher.py).

#include <cstdint>
#include <cstring>

extern "C" {

// det_boxes:   (n_det, 4) float, already sorted by descending score
// det_set:     (n_det,) int32 — index of the (file,class) label set, -1 = none
// gt_boxes:    (total_gt, 4) float, concatenated per-set, easy-first
// gt_diff:     (total_gt,) uint8
// set_offsets: (n_sets + 1,) int32 — gt rows [off[s], off[s+1]) per set
// thresholds:  (n_iou,) double
// seen:        (n_iou, total_gt) uint8 workspace, caller-zeroed
// tp, fp:      (n_iou, n_det) uint8 outputs, caller-zeroed
void match_class(const float* det_boxes, const int32_t* det_set, int n_det,
                 const float* gt_boxes, const uint8_t* gt_diff,
                 const int32_t* set_offsets,
                 const double* thresholds, int n_iou, int total_gt,
                 uint8_t* seen, uint8_t* tp, uint8_t* fp) {
    for (int d = 0; d < n_det; ++d) {
        const int set = det_set[d];
        if (set < 0) {
            for (int t = 0; t < n_iou; ++t) fp[t * n_det + d] = 1;
            continue;
        }
        const int g0 = set_offsets[set];
        const int g1 = set_offsets[set + 1];
        const int n_gt = g1 - g0;
        const float* bb = det_boxes + 4 * d;
        const double bb_area = (double)(bb[2] - bb[0] + 1.0f) *
                               (double)(bb[3] - bb[1] + 1.0f);

        // overlaps against this set's GT (VOC +1 convention)
        double overlaps[1024];
        double* ov = overlaps;
        bool heap_ov = n_gt > 1024;
        if (heap_ov) ov = new double[n_gt];
        for (int g = 0; g < n_gt; ++g) {
            const float* gb = gt_boxes + 4 * (g0 + g);
            const double ixmin = gb[0] > bb[0] ? gb[0] : bb[0];
            const double iymin = gb[1] > bb[1] ? gb[1] : bb[1];
            const double ixmax = gb[2] < bb[2] ? gb[2] : bb[2];
            const double iymax = gb[3] < bb[3] ? gb[3] : bb[3];
            const double iw = ixmax - ixmin + 1.0 > 0.0 ? ixmax - ixmin + 1.0 : 0.0;
            const double ih = iymax - iymin + 1.0 > 0.0 ? iymax - iymin + 1.0 : 0.0;
            const double inter = iw * ih;
            const double uni = bb_area +
                (double)(gb[2] - gb[0] + 1.0f) * (double)(gb[3] - gb[1] + 1.0f) -
                inter;
            ov[g] = inter / uni;
        }

        for (int t = 0; t < n_iou; ++t) {
            uint8_t* seen_t = seen + (size_t)t * total_gt + g0;
            int pick = -1;
            double pick_iou = thresholds[t];
            if (pick_iou > 1.0 - 1e-10) pick_iou = 1.0 - 1e-10;
            for (int g = 0; g < n_gt; ++g) {
                if (seen_t[g]) continue;
                if (pick > -1 && !gt_diff[g0 + pick] && gt_diff[g0 + g]) break;
                if (ov[g] < pick_iou) continue;
                pick = g;
                pick_iou = ov[g];
            }
            // pick == -1 indexes the LAST gt (python negative indexing parity)
            const int diff_idx = pick == -1 ? n_gt - 1 : pick;
            if (n_gt > 0 && gt_diff[g0 + diff_idx]) continue;
            if (pick == -1 || seen_t[pick]) {
                fp[(size_t)t * n_det + d] = 1;
                continue;
            }
            tp[(size_t)t * n_det + d] = 1;
            seen_t[pick] = 1;
        }
        if (heap_ov) delete[] ov;
    }
}

}  // extern "C"
