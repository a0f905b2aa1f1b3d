"""Detection mAP evaluation (COCO 101-point interpolated AP): the port's
copy of ``eval/detection_map.py`` (numpy only), so the card scores a
precision policy's detections against ``MAP_BUDGETS`` with no JAX.

Behavioral parity with the reference's online evaluator
(communicator/evaluate_inference.py): ``compute_ap`` is the 101-pt
interpolated AP (:131-156), ``ap_per_class`` the per-class P/R/AP/F1
curves reported at the max-F1 operating point (:158-218), and
``match_predictions`` the greedy unique IoU matching at 10 thresholds
0.5:0.05:0.95 (:400-446). The reference runs this math through torch
tensors inside a ROS callback; here it is torch-free numpy driven by
the evaluation driver (host-side bookkeeping — the TPU does detection,
the host does the running score).

Matching subtlety kept bit-identical: candidate (gt, det) pairs are
sorted by IoU descending ONCE, then deduped by detection column, then
deduped by gt column WITHOUT re-sorting (the reference's second
argsort is commented out, evaluate_inference.py:422) — np.unique
returns first occurrences, which after the desc sort are the
highest-IoU pair per index.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# IoU thresholds 0.5:0.05:0.95 (evaluate_inference.py:411).
IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) x (M, 4) xyxy boxes -> (N, M)."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-16)


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Average precision from raw recall/precision curves (COCO 101-pt
    interpolation, evaluate_inference.py:131-156)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    integrate = getattr(np, "trapezoid", np.trapz)
    return float(integrate(np.interp(x, mrec, mpre), x))


def ap_per_class(
    tp: np.ndarray,
    conf: np.ndarray,
    pred_cls: np.ndarray,
    target_cls: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-class precision/recall/AP/F1 (evaluate_inference.py:158-218).

    Args:
      tp: (n_pred, n_iou) bool true-positive matrix from
        ``match_predictions``.
      conf: (n_pred,) confidences.
      pred_cls: (n_pred,) predicted class ids.
      target_cls: (n_gt,) ground-truth class ids.

    Returns:
      (p, r, ap, f1, unique_classes): p/r/f1 are (nc,) at the max-F1
      operating point; ap is (nc, n_iou); unique_classes is (nc,) int32
      over classes present in the ground truth.
    """
    tp = np.atleast_2d(np.asarray(tp, dtype=np.float64))
    order = np.argsort(-conf)
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    unique_classes = np.unique(target_cls)
    nc = unique_classes.shape[0]
    n_iou = tp.shape[1]

    px = np.linspace(0, 1, 1000)
    ap = np.zeros((nc, n_iou))
    p = np.zeros((nc, 1000))
    r = np.zeros((nc, 1000))
    for ci, c in enumerate(unique_classes):
        mask = pred_cls == c
        n_labels = int((target_cls == c).sum())
        if not mask.any() or n_labels == 0:
            continue
        fpc = (1.0 - tp[mask]).cumsum(0)
        tpc = tp[mask].cumsum(0)
        recall = tpc / (n_labels + 1e-16)
        precision = tpc / (tpc + fpc)
        # curves sampled on a fixed 1000-pt confidence grid (conf
        # decreases along the curve, hence the negated interp).
        r[ci] = np.interp(-px, -conf[mask], recall[:, 0], left=0)
        p[ci] = np.interp(-px, -conf[mask], precision[:, 0], left=1)
        for j in range(n_iou):
            ap[ci, j] = compute_ap(recall[:, j], precision[:, j])

    f1 = 2 * p * r / (p + r + 1e-16)
    best = int(f1.mean(0).argmax())
    return p[:, best], r[:, best], ap, f1[:, best], unique_classes.astype(np.int32)


def greedy_match(
    iou: np.ndarray,  # (n_gt, n_pred)
    gt_cls: np.ndarray,
    pred_cls: np.ndarray,
    iou_thresholds: np.ndarray,
) -> np.ndarray:
    """Greedy unique TP matrix from a precomputed IoU matrix — the
    matching core shared by the 2D (axis-aligned) and 3D (rotated BEV)
    evaluators. Candidates need IoU >= thresholds[0] and matching
    class; pairs assign best-IoU-first, one det per gt and one gt per
    det; a matched det is TP at every threshold its IoU clears."""
    n_pred, n_iou = iou.shape[1], len(iou_thresholds)
    correct = np.zeros((n_pred, n_iou), dtype=bool)
    candidate = (iou >= iou_thresholds[0]) & (
        np.asarray(gt_cls)[:, None] == np.asarray(pred_cls)[None, :]
    )
    gt_idx, det_idx = np.nonzero(candidate)
    if gt_idx.shape[0] == 0:
        return correct
    matches = np.stack([gt_idx, det_idx, iou[gt_idx, det_idx]], axis=1)
    if matches.shape[0] > 1:
        matches = matches[matches[:, 2].argsort()[::-1]]
        matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
        matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
    det = matches[:, 1].astype(int)
    correct[det] = matches[:, 2:3] >= iou_thresholds[None, :]
    return correct


def match_predictions(
    pred_boxes: np.ndarray,
    pred_cls: np.ndarray,
    gt_boxes: np.ndarray,
    gt_cls: np.ndarray,
    iou_thresholds: np.ndarray = IOU_THRESHOLDS,
) -> np.ndarray:
    """Greedy unique matching of one frame's predictions to GT.

    Parity with evaluate_inference.py:400-446 (see greedy_match).
    Returns: (n_pred, n_iou) bool TP matrix.
    """
    n_pred, n_iou = pred_boxes.shape[0], len(iou_thresholds)
    if n_pred == 0 or gt_boxes.shape[0] == 0:
        return np.zeros((n_pred, n_iou), dtype=bool)
    iou = box_iou_np(gt_boxes[:, :4], pred_boxes[:, :4])
    return greedy_match(iou, gt_cls, pred_cls, iou_thresholds)


@dataclasses.dataclass
class FrameStats:
    """One frame's matching result, the unit of accumulation."""

    correct: np.ndarray  # (n_pred, n_iou) bool
    conf: np.ndarray  # (n_pred,)
    pred_cls: np.ndarray  # (n_pred,)
    target_cls: np.ndarray  # (n_gt,)


class DetectionEvaluator:
    """Accumulating detection evaluator (the reference's
    EvaluateInference metric core, decoupled from ROS topics).

    Usage: ``add_frame(dets, valid, gts)`` per frame, then ``summary()``
    for aggregate P/R/mAP@0.5/mAP@0.5:0.95/F1. ``observe_prometheus``
    optionally pushes per-class Summaries, parity with the reference's
    port-7658 exporter (evaluate_inference.py:52-61,437-444).
    """

    def __init__(self, iou_thresholds: np.ndarray = IOU_THRESHOLDS) -> None:
        self.iou_thresholds = np.asarray(iou_thresholds)
        self.frames: list[FrameStats] = []

    def add_frame(
        self,
        detections: np.ndarray,
        valid: np.ndarray | None,
        ground_truths: np.ndarray,
    ) -> FrameStats:
        """detections: (max_det, 6) packed [x1, y1, x2, y2, conf, cls]
        rows (+ optional validity mask); ground_truths: (n_gt, 5)
        [x1, y1, x2, y2, cls]."""
        detections = np.asarray(detections)
        if valid is not None:
            detections = detections[np.asarray(valid, dtype=bool)]
        ground_truths = np.asarray(ground_truths).reshape(-1, 5)
        stats = FrameStats(
            correct=match_predictions(
                detections[:, :4],
                detections[:, 5],
                ground_truths[:, :4],
                ground_truths[:, 4],
                self.iou_thresholds,
            ),
            conf=detections[:, 4],
            pred_cls=detections[:, 5],
            target_cls=ground_truths[:, 4],
        )
        self.frames.append(stats)
        return stats

    def summary(self) -> dict[str, float | dict[int, float]]:
        """Aggregate over all frames (the standard eval protocol; the
        reference additionally re-runs ap_per_class per frame, which
        ``per_frame_summaries`` reproduces for the Prometheus path)."""
        if not self.frames:
            return {
                "frames": 0,
                "precision": 0.0,
                "recall": 0.0,
                "f1": 0.0,
                "map50": 0.0,
                "map": 0.0,
                "per_class_ap50": {},
            }
        correct = np.concatenate([f.correct for f in self.frames])
        conf = np.concatenate([f.conf for f in self.frames])
        pred_cls = np.concatenate([f.pred_cls for f in self.frames])
        target_cls = np.concatenate([f.target_cls for f in self.frames])
        p, r, ap, f1, classes = ap_per_class(correct, conf, pred_cls, target_cls)
        return {
            "frames": len(self.frames),
            "precision": float(p.mean()) if p.size else 0.0,
            "recall": float(r.mean()) if r.size else 0.0,
            "f1": float(f1.mean()) if f1.size else 0.0,
            "map50": float(ap[:, 0].mean()) if ap.size else 0.0,
            "map": float(ap.mean()) if ap.size else 0.0,
            "per_class_ap50": {
                int(c): float(ap[i, 0]) for i, c in enumerate(classes)
            },
        }

    def add_frame_from(self, outputs, ground_truths) -> FrameStats:
        """Driver-facing adapter: score one frame from the infer fn's
        output mapping (the 2D contract: packed detections + valid)."""
        return self.add_frame(
            np.asarray(outputs["detections"]),
            np.asarray(outputs["valid"]) if "valid" in outputs else None,
            ground_truths,
        )

    def per_frame_summaries(self):
        """Yield (p, r, ap, f1, classes) per frame — what the reference
        observes into its Prometheus Summaries frame by frame."""
        for f in self.frames:
            yield ap_per_class(f.correct, f.conf, f.pred_cls, f.target_cls)


# --------------------------------------------------------------------------
# 3D (BEV rotated-IoU) evaluation
# --------------------------------------------------------------------------

def _rect_corners_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) [cx, cy, dx, dy, yaw] -> (N, 4, 2) CCW corners."""
    c, s = np.cos(boxes[:, 4]), np.sin(boxes[:, 4])
    hx, hy = boxes[:, 2] / 2, boxes[:, 3] / 2
    local = np.stack(
        [
            np.stack([hx, hy], -1),
            np.stack([-hx, hy], -1),
            np.stack([-hx, -hy], -1),
            np.stack([hx, -hy], -1),
        ],
        axis=1,
    )  # (N, 4, 2)
    rot = np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], axis=1
    )  # (N, 2, 2)
    return np.einsum("nij,nkj->nki", rot, local) + boxes[:, None, :2]


def _clip_polygon_np(poly: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: keep the half-plane left of edge a->b."""
    if len(poly) == 0:
        return poly
    edge = b - a
    rel = poly - a
    side = edge[0] * rel[:, 1] - edge[1] * rel[:, 0]
    out = []
    n = len(poly)
    for i in range(n):
        j = (i + 1) % n
        if side[i] >= 0:
            out.append(poly[i])
            if side[j] < 0:
                t = side[i] / (side[i] - side[j])
                out.append(poly[i] + t * (poly[j] - poly[i]))
        elif side[j] >= 0:
            t = side[i] / (side[i] - side[j])
            out.append(poly[i] + t * (poly[j] - poly[i]))
    return np.asarray(out) if out else np.zeros((0, 2))


def _polygon_area_np(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(
        float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    )


def rotated_bev_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise rotated BEV IoU of (N, 5) x (M, 5) [cx, cy, dx, dy,
    yaw] boxes -> (N, M). Host-side eval oracle, numpy-only — kept
    independent of the device kernel (ops/boxes3d.rotated_iou_bev) so the
    evaluator can cross-check the compiled path."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ca, cb = _rect_corners_np(a), _rect_corners_np(b)
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    out = np.zeros((len(a), len(b)))
    for i in range(len(a)):
        for j in range(len(b)):
            # cheap reject: circumscribed circles disjoint
            if np.hypot(*(a[i, :2] - b[j, :2])) > (
                np.hypot(a[i, 2], a[i, 3]) + np.hypot(b[j, 2], b[j, 3])
            ) / 2:
                continue
            poly = ca[i]
            for k in range(4):
                poly = _clip_polygon_np(poly, cb[j][k], cb[j][(k + 1) % 4])
            inter = _polygon_area_np(poly)
            union = area_a[i] + area_b[j] - inter
            if union > 0:
                out[i, j] = inter / union
    return out


class Detection3DEvaluator(DetectionEvaluator):
    """mAP for 7-dof boxes matched by rotated BEV IoU — the 3D accuracy
    loop the reference runs only for 2D (its 3D path has no evaluator;
    this closes that gap with the same P/R/AP/F1 protocol). Ground
    truths are (n_gt, 8) [cx, cy, cz, dx, dy, dz, yaw, cls]."""

    def add_frame3d(
        self,
        pred_boxes: np.ndarray,   # (n, 7)
        pred_scores: np.ndarray,  # (n,)
        pred_labels: np.ndarray,  # (n,) 1-indexed (OpenPCDet contract)
        ground_truths: np.ndarray,  # (m, 8), cls 0-indexed
    ) -> FrameStats:
        pred_boxes = np.asarray(pred_boxes, np.float64).reshape(-1, 7)
        gts = np.asarray(ground_truths, np.float64)
        # 10-column rows carry [vx, vy] velocity labels (multi-sweep
        # gt3d, io/synthdata.py) — the box metric ignores them
        if gts.ndim != 2 or gts.size == 0:
            gts = gts.reshape(-1, 8)
        if gts.shape[1] not in (8, 10):
            raise ValueError(
                f"ground_truths must have 8 or 10 columns, got {gts.shape[1]}"
            )
        gts = gts[:, :8]
        pred_cls = np.asarray(pred_labels, np.int64) - 1
        if len(pred_boxes) and len(gts):
            iou = rotated_bev_iou_np(
                gts[:, [0, 1, 3, 4, 6]], pred_boxes[:, [0, 1, 3, 4, 6]]
            )
            correct = greedy_match(
                iou, gts[:, 7].astype(np.int64), pred_cls, self.iou_thresholds
            )
        else:
            correct = np.zeros(
                (len(pred_boxes), len(self.iou_thresholds)), dtype=bool
            )
        stats = FrameStats(
            correct=correct,
            conf=np.asarray(pred_scores, np.float64),
            pred_cls=pred_cls,
            target_cls=gts[:, 7].astype(np.int64),
        )
        self.frames.append(stats)
        return stats

    def add_frame_from(self, outputs, ground_truths) -> FrameStats:
        """Driver-facing adapter over the 3D infer contract
        (pred_boxes/pred_scores/pred_labels)."""
        return self.add_frame3d(
            outputs["pred_boxes"],
            outputs["pred_scores"],
            outputs["pred_labels"],
            ground_truths,
        )
