"""Segmentation prediction CLI (counterpart of
`asy_vrnet_tpu/cli/predict_seg.py`; reference predict_seg.py), on the card
unless `--device cpu`.

  python -m asy_vrnet_tpu_torch.cli.predict_seg --mode predict --image img.jpg \
      --radar radar/1600000000.10000.npz --weights logs/last_epoch_weights.npz

Modes: predict, fps (host clock, or CUDA events with --device-time),
dir_predict, video (needs cv2).  The model flags are `cli/predict.py`'s.
"""
from __future__ import annotations

import argparse
import os

from asy_vrnet_tpu_torch.cli.predict import (
    add_model_args,
    build_model,
    image_pairs,
    load_pair,
    run_video,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", default="predict",
                   choices=["predict", "fps", "dir_predict", "video"])
    p.add_argument("--image")
    p.add_argument("--radar")
    p.add_argument("--video", help="input video path (video mode)")
    p.add_argument("--video-out", default="", help="output video path (video mode)")
    p.add_argument("--num-classes", type=int, default=4, help="detection classes")
    p.add_argument("--mix-type", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--out", default="predict_seg_out")
    p.add_argument("--test-interval", type=int, default=100)
    p.add_argument("--device-time", action="store_true",
                   help="fps mode: CUDA events around the calls (device time) instead "
                        "of the host clock")
    add_model_args(p, radar_norm="none")
    args = p.parse_args(argv)

    from asy_vrnet_tpu_torch.infer.predictor import Segmenter

    cfg, model = build_model(args, args.num_classes)
    seg = Segmenter(cfg, model=model, mix_type=args.mix_type, radar_norm=args.radar_norm)
    os.makedirs(args.out, exist_ok=True)

    if args.mode == "predict":
        image, radar = load_pair(args.image, args.radar)
        out_path = os.path.join(args.out, os.path.basename(args.image))
        seg.detect_image(image, radar).save(out_path)
        print(f"saved {out_path}")
        return out_path
    if args.mode == "fps":
        image, radar = load_pair(args.image, args.radar)
        tact = seg.get_fps(image, radar, args.test_interval, device_time=args.device_time)
        clock = "device time (CUDA events)" if args.device_time else "host clock"
        print(f"{tact:.6f} seconds, {1.0 / tact:.2f} FPS, @batch_size 1 ({clock}, "
              "forward + softmax)")
        return tact
    if args.mode == "dir_predict":
        for name, _, radar_path in image_pairs(args.image, args.radar):
            image, radar = load_pair(os.path.join(args.image, name), radar_path)
            seg.detect_image(image, radar).save(os.path.join(args.out, name))
        print(f"saved to {args.out}")
        return None
    return run_video(args, seg.detect_image)


if __name__ == "__main__":
    main()
