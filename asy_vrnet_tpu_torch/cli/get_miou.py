"""mIoU over a val split (counterpart of `asy_vrnet_tpu/cli/get_miou.py`;
reference get_miou.py: predict PNGs, then score), on the card unless
`--device cpu`.

  python -m asy_vrnet_tpu_torch.cli.get_miou --val-annotation 2007_val.txt \
      --weights logs/last_epoch_weights.npz --seg-path . --radar-root radar

The model flags are `cli/predict.py`'s.  Returns (hist, ious, pa_recall,
precision) as `metrics/miou.py::compute_miou_dirs` gives them.
"""
from __future__ import annotations

import argparse
import os

from asy_vrnet_tpu_torch.cli.predict import add_model_args, build_model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--val-annotation", required=True)
    p.add_argument("--seg-path", default=".")
    p.add_argument("--radar-root", default="radar")
    p.add_argument("--num-classes", type=int, default=4)
    p.add_argument("--name-classes", nargs="*", default=[
        "background", "free-space", "pier", "vessel", "ship", "boat", "buoy",
        "sailor", "kayak",
    ])
    p.add_argument("--out", default="miou_out")
    add_model_args(p, radar_norm="none")
    args = p.parse_args(argv)

    import numpy as np
    from PIL import Image

    from asy_vrnet_tpu_torch.data.dataset import parse_annotation_line, read_annotation_file
    from asy_vrnet_tpu_torch.infer.predictor import Segmenter
    from asy_vrnet_tpu_torch.metrics.miou import compute_miou_dirs, save_results

    cfg, model = build_model(args, args.num_classes)
    seg = Segmenter(cfg, model=model, radar_norm=args.radar_norm)
    gt_dir = os.path.join(args.seg_path, "VOC2007", "SegmentationClass")
    pred_dir = os.path.join(args.out, "detection-results")
    os.makedirs(pred_dir, exist_ok=True)

    image_ids = []
    print("Get miou.")
    for line in read_annotation_file(args.val_annotation):
        path, _, image_id = parse_annotation_line(line)
        image = Image.open(path)
        radar = np.load(os.path.join(args.radar_root, image_id + ".npz"))["arr_0"]
        seg.get_miou_png(image, radar).save(os.path.join(pred_dir, image_id + ".png"))
        image_ids.append(image_id)
    print("Get predict result done.")

    hist, ious, pa, prec = compute_miou_dirs(
        gt_dir, pred_dir, image_ids, args.num_seg_classes, args.name_classes)
    save_results(args.out, hist, ious, pa, prec, args.name_classes)
    print(f"results saved to {args.out}")
    return hist, ious, pa, prec


if __name__ == "__main__":
    main()
