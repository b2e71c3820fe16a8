"""Plain PyTorch YOLOX postprocess: the benchmark's reference NMS.

Per image: score = objectness x the best class probability; boxes at or
over the confidence threshold, the pre-NMS top k of them by a stable
descending sort; greedy NMS within a class (a kept box suppresses every
later box of its class whose IoU exceeds the threshold); the kept rows
first, in score order, up to max_dets, as rows (x0, y0, x1, y1, obj,
class probability, class id). Images are batched along the first axis
and the greedy sweep runs over all of them at once.
"""
from __future__ import annotations

import torch


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = br - tl
    inter = wh[..., 0] * wh[..., 1] * (tl < br).all(-1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.maximum(union, union.new_tensor(1e-16))


def postprocess(preds: torch.Tensor, num_classes: int, conf: float,
                nms_threshold: float, pre_topk: int, max_dets: int):
    """preds [R, A, 4 + 1 + C] (cx, cy, w, h, obj, class probabilities)
    -> (dets [R, max_dets, 7], valid [R, max_dets])."""
    p = preds.float()
    r, a = p.shape[:2]
    cx, cy, w, h = p[..., :4].unbind(-1)
    boxes = torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                         cy + 0.5 * h], -1)
    obj = p[..., 4]
    cls_conf, cls_id = p[..., 5:5 + num_classes].max(-1)
    score = obj * cls_conf
    score = torch.where(score >= conf, score, torch.full_like(score, -float("inf")))
    k = min(pre_topk, a)
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    valid = torch.isfinite(score.gather(1, order))
    b = boxes.gather(1, order[..., None].expand(r, k, 4))
    ids = cls_id.float().gather(1, order)
    sup = (_iou(b, b) > nms_threshold) & (ids[:, None, :] == ids[:, :, None])
    idx = torch.arange(k, device=p.device)
    sup &= idx[None, :] > idx[:, None]
    keep = valid.clone()
    for i in range(k):
        keep &= ~(sup[:, i, :] & keep[:, i:i + 1])
    det = torch.cat([b, obj.gather(1, order)[..., None],
                     cls_conf.gather(1, order)[..., None], ids[..., None]], -1)
    perm = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    if k < max_dets:
        det = torch.nn.functional.pad(det, (0, 0, 0, max_dets - k))
        perm = torch.nn.functional.pad(perm, (0, max_dets - k),
                                       value=max_dets - 1)
    out = det.gather(1, perm[:, :max_dets, None].expand(r, max_dets, 7))
    n = keep.sum(1).clamp(max=max_dets)
    ok = torch.arange(max_dets, device=p.device)[None, :] < n[:, None]
    return torch.where(ok[..., None], out, torch.zeros_like(out)), ok
