"""Offline detection mAP over a val split (counterpart of
`asy_vrnet_tpu/cli/get_map.py`; the reference's utils/utils_map.py pipeline
+ yolo.get_map_txt, yolo.py:391-452), on the card unless `--device cpu`.

Runs `Detector.detect` over every annotation line, one image at a time,
scores in memory (COCO-style AP50 + VOC AP + per-class LAMR) and optionally
writes the reference's ground-truth/ + detection-results/ txt dirs.

  python -m asy_vrnet_tpu_torch.cli.get_map --val-annotation 2007_val.txt \
      --weights logs/last_epoch_weights.npz --classes model_data/waterscenes.txt \
      --radar-root radar

The model flags are `cli/predict.py`'s.  Returns the COCO and VOC results.
"""
from __future__ import annotations

import argparse
import os

from asy_vrnet_tpu_torch.cli.predict import add_model_args, build_model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--val-annotation", required=True)
    p.add_argument("--classes", required=True)
    p.add_argument("--radar-root", default="radar")
    p.add_argument("--conf", type=float, default=0.05)
    p.add_argument("--nms-iou", type=float, default=0.5)
    p.add_argument("--max-det", type=int, default=100)
    p.add_argument("--iou-threshold", type=float, default=0.5)
    p.add_argument("--write-txt", default="", metavar="DIR",
                   help="also write reference-format gt/dr txt dirs")
    p.add_argument("--plot", default="", metavar="DIR",
                   help="write the mAP/LAMR/per-class AP-F1-PR plot artifacts (a no-op "
                        "without matplotlib)")
    add_model_args(p, radar_norm="minmax")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from asy_vrnet_tpu_torch.data.dataset import parse_annotation_line, read_annotation_file
    from asy_vrnet_tpu_torch.data.preprocess import get_classes
    from asy_vrnet_tpu_torch.infer.predictor import Detector
    from asy_vrnet_tpu_torch.metrics.map import DetectionEvaluator

    class_names, num_classes = get_classes(args.classes)
    cfg, model = build_model(args, num_classes)
    det = Detector(cfg, class_names, model=model, conf_thres=args.conf,
                   nms_thres=args.nms_iou, max_det=args.max_det, radar_norm=args.radar_norm)
    ev = DetectionEvaluator(class_names, iou_threshold=args.iou_threshold,
                            max_dets=args.max_det)
    gt_dir = dr_dir = None
    if args.write_txt:
        gt_dir = os.path.join(args.write_txt, "ground-truth")
        dr_dir = os.path.join(args.write_txt, "detection-results")
        os.makedirs(gt_dir, exist_ok=True)
        os.makedirs(dr_dir, exist_ok=True)

    lines = read_annotation_file(args.val_annotation)
    for i, line in enumerate(lines):
        path, gt_boxes, image_id = parse_annotation_line(line)
        image = Image.open(path)
        radar = np.load(os.path.join(args.radar_root, image_id + ".npz"))["arr_0"]
        res = det.detect(image, radar, conf_thres=args.conf)
        # Detector returns (top, left, bottom, right); the evaluator wants xyxy
        det_xyxy = res["boxes"][:, [1, 0, 3, 2]] if len(res["boxes"]) else res["boxes"]
        ev.add_image(det_xyxy, res["scores"], res["classes"],
                     gt_boxes[:, :4], gt_boxes[:, 4].astype(int))
        if gt_dir is not None:
            with open(os.path.join(gt_dir, image_id + ".txt"), "w") as f:
                for b in gt_boxes:
                    f.write(f"{class_names[int(b[4])]} {int(b[0])} {int(b[1])} "
                            f"{int(b[2])} {int(b[3])}\n")
            with open(os.path.join(dr_dir, image_id + ".txt"), "w") as f:
                for b, s, c in zip(det_xyxy, res["scores"], res["classes"]):
                    f.write(f"{class_names[int(c)]} {s:.6f} {int(b[0])} {int(b[1])} "
                            f"{int(b[2])} {int(b[3])}\n")
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{len(lines)} images")

    coco = ev.evaluate("coco")
    voc = ev.evaluate("voc")
    print(f"AP{int(args.iou_threshold * 100)} (COCO 101-pt): {coco['map']:.4f}")
    print(f"mAP  (VOC all-point): {voc['map']:.4f}")
    for name in class_names:
        print(f"  {name}: coco={coco['ap_per_class'][name]:.4f} "
              f"voc={voc['ap_per_class'][name]:.4f}")
    if args.plot:
        from asy_vrnet_tpu_torch.metrics.plots import plot_detection_report

        written = plot_detection_report(args.plot, voc, method_label="AP")
        print(f"wrote {len(written)} plot artifacts to {args.plot}")
    return {"coco": coco, "voc": voc}


if __name__ == "__main__":
    main()
