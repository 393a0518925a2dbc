"""Detection prediction CLI (counterpart of `asy_vrnet_tpu/cli/predict.py`;
reference predict.py modes predict / fps / dir_predict / heatmap / video /
export), on the card unless `--device cpu`.

  python -m asy_vrnet_tpu_torch.cli.predict --mode predict --image img.jpg \
      --radar radar/1600000000.10000.npz --weights logs/last_epoch_weights.npz \
      --classes model_data/waterscenes.txt

Modes: predict (boxes printed, drawn into --out), fps (seconds per request
by the host clock, or by CUDA events with --device-time), heatmap,
dir_predict, map_txt (detection-results txts), video (needs cv2), export
(a `torch.export` program, .pt2).  Beside the JAX CLI's flags: --device,
--seg-signed-logits and --radar-norm, so that weights trained with signed
seg logits or on raw radar load and see the input they were trained on.
"""
from __future__ import annotations

import argparse
import os


def add_model_args(p: argparse.ArgumentParser, radar_norm: str) -> None:
    """The model and device flags the inference CLIs share."""
    p.add_argument("--weights", required=True, help="weights-only .npz")
    p.add_argument("--phi", default="nano")
    p.add_argument("--input-size", type=int, default=512)
    p.add_argument("--num-seg-classes", type=int, default=9)
    p.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--seg-signed-logits", action="store_true",
                   help="the corrected seg head (no final ReLU), as the weights were "
                        "trained")
    p.add_argument("--radar-norm", default=radar_norm, choices=["minmax", "none"],
                   help=f"radar input normalisation (default {radar_norm}, the "
                        "wrapper's reference parity)")
    p.add_argument("--device", default="cuda",
                   help="torch device: the card (default) or 'cpu'; no fallback when "
                        "the card is missing")


def build_model(args, num_classes: int):
    """-> (ModelConfig, model on args.device with the weights of
    args.weights, a weights-only npz: the JAX package's layout, read by
    `utils/weights.py::npz_tree` as `train/checkpoint.py::load_weights`
    reads it)."""
    from asy_vrnet_tpu_torch.config import ModelConfig
    from asy_vrnet_tpu_torch.models.efficient_vrnet import create_model

    cfg = ModelConfig(
        num_classes=num_classes, num_seg_classes=args.num_seg_classes, phi=args.phi,
        input_size=(args.input_size, args.input_size),
        compute_dtype=args.compute_dtype, seg_signed_logits=args.seg_signed_logits)
    return cfg, create_model(cfg, args.device, args.weights)


def load_pair(img_path: str, radar_path: str):
    import numpy as np
    from PIL import Image

    return Image.open(img_path), np.load(radar_path)["arr_0"]


def image_pairs(image_dir: str, radar_dir: str, skipped=None):
    """(name, image id, radar path) of each image in image_dir that has
    <id>.npz in radar_dir, by sorted name; `skipped(name, radar_path)` is
    called for the others."""
    from asy_vrnet_tpu_torch.data.dataset import _ID_PATTERN

    for name in sorted(os.listdir(image_dir)):
        if not name.lower().endswith((".jpg", ".png", ".jpeg")):
            continue
        ids = _ID_PATTERN.findall(name)
        image_id = ids[-1] if ids else os.path.splitext(name)[0]
        radar_path = os.path.join(radar_dir, image_id + ".npz")
        if not os.path.exists(radar_path):
            if skipped is not None:
                skipped(name, radar_path)
            continue
        yield name, image_id, radar_path


def import_cv2():
    try:
        import cv2
    except ImportError as e:
        raise SystemExit(f"error: video mode needs OpenCV: {e}") from e
    return cv2


def run_video(args, render) -> int:
    """Reference predict.py video mode (:74-140): each frame through
    render(PIL image, radar) -> PIL image; radar from a single static .npz
    or a directory of per-frame <frame_idx>.npz files.  -> frames."""
    import numpy as np
    from PIL import Image

    cv2 = import_cv2()
    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise SystemExit(f"error: cannot open video {args.video}")
    writer = None
    if args.video_out:
        fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
        size = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        writer = cv2.VideoWriter(args.video_out, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    static_radar = None
    if args.radar and os.path.isfile(args.radar):
        static_radar = np.load(args.radar)["arr_0"]
    frame_idx = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        image = Image.fromarray(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        radar = (static_radar if static_radar is not None
                 else np.load(os.path.join(args.radar, f"{frame_idx}.npz"))["arr_0"])
        out_frame = cv2.cvtColor(np.asarray(render(image, radar)), cv2.COLOR_RGB2BGR)
        if writer is not None:
            writer.write(out_frame)
        frame_idx += 1
    cap.release()
    if writer is not None:
        writer.release()
    print(f"processed {frame_idx} frames" + (f" -> {args.video_out}" if args.video_out else ""))
    return frame_idx


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", default="predict",
                   choices=["predict", "fps", "dir_predict", "heatmap",
                            "map_txt", "video", "export"])
    p.add_argument("--export-path", default="model_data/asy_vrnet.pt2",
                   help="export mode: output program path")
    p.add_argument("--export-batch", type=int, default=1)
    p.add_argument("--export-raw", action="store_true",
                   help="export mode: raw forward only (no decode/NMS)")
    p.add_argument("--video", help="input video path (video mode)")
    p.add_argument("--video-out", default="", help="output video path (video mode)")
    p.add_argument("--image", help="input image path (or dir for dir_predict)")
    p.add_argument("--radar", help="radar .npz path (or dir for dir_predict)")
    p.add_argument("--classes", required=True)
    p.add_argument("--conf", type=float, default=0.3)
    p.add_argument("--nms-iou", type=float, default=0.5)
    p.add_argument("--out", default="predict_out")
    p.add_argument("--test-interval", type=int, default=100)
    p.add_argument("--device-time", action="store_true",
                   help="fps mode: CUDA events around the calls (device time) instead "
                        "of the host clock")
    add_model_args(p, radar_norm="minmax")
    args = p.parse_args(argv)

    from PIL import Image

    from asy_vrnet_tpu_torch.data.preprocess import get_classes
    from asy_vrnet_tpu_torch.infer.predictor import Detector

    class_names, num_classes = get_classes(args.classes)
    cfg, model = build_model(args, num_classes)
    det = Detector(cfg, class_names, model=model, conf_thres=args.conf,
                   nms_thres=args.nms_iou, radar_norm=args.radar_norm)
    os.makedirs(args.out, exist_ok=True)

    if args.mode == "predict":
        image, radar = load_pair(args.image, args.radar)
        res = det.detect(image, radar)
        for box, score, cls in zip(res["boxes"], res["scores"], res["classes"]):
            print(f"{class_names[int(cls)]} {score:.3f} {box.tolist()}")
        out_path = os.path.join(args.out, os.path.basename(args.image))
        det.draw(image, res).save(out_path)
        print(f"saved {out_path}")
        return res
    if args.mode == "fps":
        image, radar = load_pair(args.image, args.radar)
        tact = det.get_fps(image, radar, args.test_interval, device_time=args.device_time)
        clock = "device time (CUDA events)" if args.device_time else "host clock"
        print(f"{tact:.6f} seconds, {1.0 / tact:.2f} FPS, @batch_size 1 ({clock}, "
              "forward + decode + NMS)")
        return tact
    if args.mode == "heatmap":
        image, radar = load_pair(args.image, args.radar)
        heat = det.heatmap(image, radar)
        out_path = os.path.join(args.out, "heatmap.png")
        Image.fromarray((heat * 255).astype("uint8")).save(out_path)
        print(f"saved {out_path}")
        return heat
    if args.mode == "dir_predict":
        for name, _, radar_path in image_pairs(
                args.image, args.radar, lambda n, r: print(f"skip {n}: no radar {r}")):
            image, radar = load_pair(os.path.join(args.image, name), radar_path)
            det.draw(image, det.detect(image, radar)).save(os.path.join(args.out, name))
        print(f"saved to {args.out}")
        return None
    if args.mode == "video":
        return run_video(args, lambda image, radar: det.draw(image, det.detect(image, radar)))
    if args.mode == "export":
        # reference predict.py mode "export_onnx" (:24,170-180): a torch.export
        # program with BOTH inputs (the reference's ONNX export is broken on
        # the dual-input model, yolo.py:353-389)
        from asy_vrnet_tpu_torch.infer.export import export_program

        path = export_program(model, cfg, args.export_path, batch_size=args.export_batch,
                              with_postprocess=not args.export_raw, conf_thres=args.conf,
                              nms_thres=args.nms_iou)
        print(f"exported torch.export program -> {path}")
        return path
    # map_txt
    for name, image_id, radar_path in image_pairs(args.image, args.radar):
        image, radar = load_pair(os.path.join(args.image, name), radar_path)
        det.write_map_txt(image_id, image, radar, args.out)
    print(f"detection-results written to {args.out}")
    return None


if __name__ == "__main__":
    main()
