"""Referring-expression grounding evaluation (refcoco family; the port's own
copy of omnivideo_tpu/eval/grounding.py, pure Python).

Role of reference `previous_version/Omni-Video1/nets/third_party/llava/eval/
eval_refcoco.py` (computeIoU + acc@0.5 over refcoco/refcoco+/refcocog splits)
and `model_refcoco.py` (the decode script): one adapter + scorer that plugs
into the eval/vqa.py harness — rows carry mode "grounding", the model's
free-form answer is parsed for a box, and the aggregate is accuracy@IoU0.5.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

_NUM = r"(?<![\w.])[-+]?\d*\.?\d+"  # lookbehind: '50' in 'x1=50', not the '1' in 'x1'


def box_iou(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU of two [x1, y1, x2, y2] boxes, inclusive-pixel convention
    (matches reference computeIoU's +1 areas, eval_refcoco.py:9-21)."""
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, ix2 - ix1 + 1) * max(0.0, iy2 - iy1 + 1)
    area_a = (a[2] - a[0] + 1) * (a[3] - a[1] + 1)
    area_b = (b[2] - b[0] + 1) * (b[3] - b[1] + 1)
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def parse_box(text: str) -> Optional[List[float]]:
    """First 4 numbers in a model answer → [x1, y1, x2, y2], or None.

    Accepts '[0.1, 0.2, 0.5, 0.9]', '(10,20),(50,90)', 'x1=10 y1=20 ...' —
    grounding-tuned VLMs emit many surface forms; like the reference's script
    we only need the 4 coordinates in order.
    """
    nums = re.findall(_NUM, text)
    if len(nums) < 4:
        return None
    x1, y1, x2, y2 = (float(v) for v in nums[:4])
    if x2 < x1:
        x1, x2 = x2, x1
    if y2 < y1:
        y1, y2 = y2, y1
    return [x1, y1, x2, y2]


def score_grounding(prediction: str, gt_xyxy: Sequence[float],
                    iou_threshold: float = 0.5) -> float:
    box = parse_box(prediction)
    if box is None:
        return 0.0
    return float(box_iou(box, gt_xyxy) >= iou_threshold)


def adapt_refcoco(r: Dict) -> Dict:
    """Native refcoco annotation → canonical row.

    The annotation bbox is COCO [x, y, w, h]; ground truth becomes
    [x1, y1, x2, y2] exactly as the reference converts it
    (eval_refcoco.py:58-62)."""
    bbox = r["bbox"]
    if r.get("bbox_format", "xywh") == "xywh":
        gt = [bbox[0], bbox[1], bbox[0] + bbox[2], bbox[1] + bbox[3]]
    else:
        gt = list(bbox)
    sent = r.get("sents") or r.get("sentence") or r.get("text", "")
    return {
        "question_id": r.get("img_id", r.get("question_id")),
        "text": (f"Please provide the bounding box coordinate of the region "
                 f"this sentence describes: {sent}"),
        "image": r.get("image"),
        "answer": gt,
        "category": r.get("dataset", "refcoco"),
        "mode": "grounding",
    }


def grounding_accuracy(results: List[Dict]) -> Dict:
    """acc@0.5 overall and per category (reference prints per split)."""
    by_cat: Dict[str, List[float]] = {}
    for r in results:
        by_cat.setdefault(r.get("category") or "all", []).append(r["score"])
    out = {
        "acc@0.5": sum(r["score"] for r in results) / max(len(results), 1),
        "n": len(results),
    }
    out["per_category"] = {
        c: sum(v) / len(v) for c, v in sorted(by_cat.items())
    }
    return out
