"""COCO-style mAP evaluation, dependency-free (a copy of
myrtle_vision_tpu/eval/coco_eval.py; the port imports nothing of the JAX
package).

Replaces the reference's pycocotools-based distributed CocoEvaluator
(reference: src/myrtle_vision/datasets/coco_eval.py + the pycocotools C
extension) with a numpy implementation of the COCOeval bbox protocol:

  - IoU thresholds 0.50:0.05:0.95, 101 recall points;
  - area ranges all/small/medium/large, maxDets 1/10/100;
  - greedy per-image matching in score order, crowd/ignore semantics;
  - the standard 12-number summary (AP, AP50, AP75, APs/m/l, AR@1/10/100,
    ARs/m/l).

Distributed use: per-host evaluators accumulate their own predictions;
``synchronize_between_processes`` merges evaluator states (the reference
pickles + all_gathers eval images, coco_eval.py:66-69 — here merging is a
plain reduction over prediction dicts, and under one SPMD program a single
host sees the whole eval set, so it is a no-op by default).
"""
from __future__ import annotations

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_xyxy(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray):
    """Pairwise IoU (D, G); against crowd GT the denominator is det area
    (pycocotools semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    union = np.where(iscrowd[None, :].astype(bool), area_d[:, None], union)
    return inter / np.maximum(union, 1e-12)


def _evaluate_img(dt_boxes, dt_scores, gt_boxes, gt_area, gt_crowd,
                  area_rng, max_det):
    """Match one (image, category): returns per-threshold match arrays.

    Returns (dt_matched (T,D), dt_ignore (T,D), gt_ignore (G,), dt_scores).
    """
    T = len(IOU_THRS)
    order = np.argsort(-dt_scores, kind="mergesort")[:max_det]
    dt_boxes = dt_boxes[order]
    dt_scores = dt_scores[order]
    D, G = len(dt_boxes), len(gt_boxes)

    gt_ignore = (
        gt_crowd.astype(bool)
        | (gt_area < area_rng[0])
        | (gt_area > area_rng[1])
    )
    # sort gt: non-ignored first (pycocotools)
    gt_order = np.argsort(gt_ignore, kind="mergesort")
    gt_boxes = gt_boxes[gt_order]
    gt_ignore_sorted = gt_ignore[gt_order]
    gt_crowd_sorted = gt_crowd[gt_order].astype(bool)

    ious = _iou_xyxy(dt_boxes, gt_boxes, gt_crowd_sorted)

    dtm = -np.ones((T, D), np.int64)
    dt_ign = np.zeros((T, D), bool)
    for ti, thr in enumerate(IOU_THRS):
        gtm = -np.ones(G, np.int64)
        for d in range(D):
            best_iou = min(thr, 1 - 1e-10)
            best_g = -1
            for g in range(G):
                # gt already matched (and not crowd) -> skip
                if gtm[g] >= 0 and not gt_crowd_sorted[g]:
                    continue
                # best so far is a real gt; remaining are ignored -> stop
                if (
                    best_g >= 0
                    and not gt_ignore_sorted[best_g]
                    and gt_ignore_sorted[g]
                ):
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou = ious[d, g]
                best_g = g
            if best_g >= 0:
                gtm[best_g] = d
                dtm[ti, d] = best_g
                dt_ign[ti, d] = gt_ignore_sorted[best_g]
        # unmatched dets outside the area range are ignored
        dt_area = (dt_boxes[:, 2] - dt_boxes[:, 0]) * (
            dt_boxes[:, 3] - dt_boxes[:, 1]
        )
        out_of_rng = (dt_area < area_rng[0]) | (dt_area > area_rng[1])
        dt_ign[ti] = dt_ign[ti] | ((dtm[ti] < 0) & out_of_rng)
    n_gt = int(np.sum(~gt_ignore_sorted))
    return dtm, dt_ign, n_gt, dt_scores


class CocoEvaluator:
    """Accumulates predictions and computes the COCO bbox summary.

    ``coco_index``: a datasets.coco.CocoIndex (ground truth).
    ``update(predictions)``: dict image_id -> {"boxes" (N,4 xyxy abs),
    "scores" (N,), "labels" (N,) category ids}.
    """

    def __init__(self, coco_index, iou_types=("bbox",)):
        assert tuple(iou_types) == ("bbox",), "only bbox supported"
        self.coco = coco_index
        self.iou_types = tuple(iou_types)
        self.predictions = {}
        self.img_ids = []
        self.stats = None

    def update(self, predictions):
        for img_id, pred in predictions.items():
            self.img_ids.append(img_id)
            self.predictions[img_id] = {
                "boxes": np.asarray(pred["boxes"], np.float64).reshape(-1, 4),
                "scores": np.asarray(pred["scores"], np.float64).reshape(-1),
                "labels": np.asarray(pred["labels"], np.int64).reshape(-1),
            }

    def synchronize_between_processes(self):
        """Merge across processes. Single-controller SPMD evaluates the full
        set on one host, so this is a no-op; multi-host setups should merge
        ``self.predictions`` dicts across hosts before accumulate()."""

    def merge(self, other: "CocoEvaluator"):
        self.update(other.predictions)

    def accumulate(self):
        cat_ids = self.coco.get_cat_ids()
        img_ids = sorted(set(self.img_ids))
        K, T, R = len(cat_ids), len(IOU_THRS), len(REC_THRS)
        A, M = len(AREA_RNGS), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for ki, cat_id in enumerate(cat_ids):
            # per-image gt/dt for this category
            per_img = []
            for img_id in img_ids:
                anns = [
                    a
                    for a in self.coco.load_anns(img_id)
                    if a["category_id"] == cat_id
                ]
                gt_boxes = np.asarray(
                    [a["bbox"] for a in anns], np.float64
                ).reshape(-1, 4)
                if len(gt_boxes):
                    gt_boxes = gt_boxes.copy()
                    gt_boxes[:, 2:] += gt_boxes[:, :2]
                gt_area = np.asarray(
                    [a["area"] for a in anns], np.float64
                ).reshape(-1)
                gt_crowd = np.asarray(
                    [a.get("iscrowd", 0) for a in anns], np.int64
                ).reshape(-1)
                pred = self.predictions.get(
                    img_id,
                    {"boxes": np.zeros((0, 4)), "scores": np.zeros(0),
                     "labels": np.zeros(0, np.int64)},
                )
                sel = pred["labels"] == cat_id
                per_img.append(
                    (pred["boxes"][sel], pred["scores"][sel], gt_boxes,
                     gt_area, gt_crowd)
                )

            for ai, (aname, arng) in enumerate(AREA_RNGS.items()):
                for mi, max_det in enumerate(MAX_DETS):
                    dtm_all, ign_all, scores_all = [], [], []
                    n_gt_total = 0
                    for dt_b, dt_s, gt_b, gt_a, gt_c in per_img:
                        dtm, dt_ign, n_gt, scores = _evaluate_img(
                            dt_b, dt_s, gt_b, gt_a, gt_c, arng, max_det
                        )
                        dtm_all.append(dtm)
                        ign_all.append(dt_ign)
                        scores_all.append(scores)
                        n_gt_total += n_gt
                    if n_gt_total == 0:
                        continue
                    dtm_cat = np.concatenate(dtm_all, axis=1)
                    ign_cat = np.concatenate(ign_all, axis=1)
                    scores_cat = np.concatenate(scores_all)
                    order = np.argsort(-scores_cat, kind="mergesort")
                    dtm_cat = dtm_cat[:, order]
                    ign_cat = ign_cat[:, order]

                    tps = (dtm_cat >= 0) & ~ign_cat
                    fps = (dtm_cat < 0) & ~ign_cat
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for ti in range(T):
                        tp, fp = tp_sum[ti], fp_sum[ti]
                        rc = tp / n_gt_total
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0.0
                        # precision envelope (monotone from the right)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        self._precision = precision
        self._recall = recall
        return precision, recall

    def _summarize(self, ap=1, iou_thr=None, area="all", max_det=100):
        ai = list(AREA_RNGS).index(area)
        mi = list(MAX_DETS).index(max_det)
        if ap:
            s = self._precision
            if iou_thr is not None:
                ti = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                s = s[ti]
            s = s[:, :, :, ai, mi]
        else:
            s = self._recall
            if iou_thr is not None:
                ti = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                s = s[ti]
            s = s[:, :, ai, mi]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self):
        """Print the standard 12-number COCO summary; returns the stats
        array (stats[0] = AP@[.5:.95], the detection checkpointing metric —
        reference detection/train.py:304-319)."""
        if not hasattr(self, "_precision"):
            self.accumulate()
        rows = [
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all | "
             "maxDets=100 ]", self._summarize(1)),
            ("Average Precision  (AP) @[ IoU=0.50      | area=   all | "
             "maxDets=100 ]", self._summarize(1, 0.5)),
            ("Average Precision  (AP) @[ IoU=0.75      | area=   all | "
             "maxDets=100 ]", self._summarize(1, 0.75)),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small | "
             "maxDets=100 ]", self._summarize(1, None, "small")),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium | "
             "maxDets=100 ]", self._summarize(1, None, "medium")),
            ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large | "
             "maxDets=100 ]", self._summarize(1, None, "large")),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | "
             "maxDets=  1 ]", self._summarize(0, None, "all", 1)),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | "
             "maxDets= 10 ]", self._summarize(0, None, "all", 10)),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=   all | "
             "maxDets=100 ]", self._summarize(0)),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= small | "
             "maxDets=100 ]", self._summarize(0, None, "small")),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium | "
             "maxDets=100 ]", self._summarize(0, None, "medium")),
            ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large | "
             "maxDets=100 ]", self._summarize(0, None, "large")),
        ]
        print("IoU metric: bbox")
        for label, value in rows:
            print(f" {label} = {value:0.3f}")
        self.stats = np.array([v for _, v in rows])
        return self.stats
