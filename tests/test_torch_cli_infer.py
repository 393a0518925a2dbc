"""The port's offline-evaluation CLIs against the JAX package's.

voc_annotation is pure Python: on one synthetic VOC tree both CLIs must
write the same files byte for byte (the ImageSets splits, seeded, and the
annotation txts).  The slow test runs r05's trained weights on the 48-image
learnable set at 512^2 through both packages' get_map and get_miou on the
CPU."""
import io
import os
import shutil
from contextlib import redirect_stdout

import numpy as np
import pytest

from torch_parity import one_torch_thread  # noqa: F401

R05 = os.path.join(os.path.dirname(__file__), "..", "model_data", "convergence_tpu_r05",
                   "logs_512c", "best_epoch_weights.npz")
CLASSES = ["pier", "vessel", "ship", "boat"]


def _voc_tree(root):
    """VOC2007 with 9 annotated images: known and unknown classes, a
    difficult object, float coordinates, an image with no object; and 7
    segmentation PNGs."""
    from PIL import Image

    rng = np.random.default_rng(0)
    ann = os.path.join(root, "VOC2007", "Annotations")
    seg = os.path.join(root, "VOC2007", "SegmentationClass")
    os.makedirs(ann)
    os.makedirs(seg)
    for i in range(9):
        objs = []
        for k in range(i % 4):
            name = (CLASSES + ["kayak"])[(i + k) % 5]
            x1, y1 = rng.integers(0, 100, 2)
            difficult = "<difficult>1</difficult>" if (i, k) == (5, 1) else (
                "" if k == 2 else "<difficult>0</difficult>")
            objs.append(f"<object><name>{name}</name>{difficult}<bndbox><xmin>{x1}.7</xmin>"
                        f"<ymin>{y1}</ymin><xmax>{x1 + 20}</xmax><ymax>{y1 + 30}.2</ymax>"
                        "</bndbox></object>")
        with open(os.path.join(ann, f"17000000{i:02d}.1000{i}.xml"), "w") as f:
            f.write(f"<annotation><filename>{i}.jpg</filename>{''.join(objs)}</annotation>")
        if i < 7:
            Image.fromarray(np.full((4, 4), i, np.uint8)).save(
                os.path.join(seg, f"17000000{i:02d}.1000{i}.png"))
    classes = os.path.join(root, "classes.txt")
    with open(classes, "w") as f:
        f.write("\n".join(CLASSES) + "\n")
    return classes


def _written(root, out_dir):
    """Every file the CLIs write: the ImageSets and the year_split txts."""
    files = {}
    sets = os.path.join(root, "VOC2007", "ImageSets")
    for d in (sets, out_dir):
        for base, _, names in os.walk(d):
            for n in names:
                p = os.path.join(base, n)
                with open(p, "rb") as f:
                    files[os.path.relpath(p, root)] = f.read()
    return files


@pytest.mark.parametrize("argv", [["--mode", "0"], ["--mode", "1"], ["--seg"],
                                  ["--mode", "0", "--trainval-percent", "0.6",
                                   "--train-percent", "0.5"]])
def test_voc_annotation_writes_the_jax_files(tmp_path, argv):
    from asy_vrnet_tpu.cli import voc_annotation as jax_cli

    from asy_vrnet_tpu_torch.cli import voc_annotation as port_cli

    root = str(tmp_path / "VOCdevkit")
    classes = _voc_tree(root)
    results = []
    for cli, out in ((jax_cli, "jax_out"), (port_cli, "port_out")):
        out_dir = os.path.join(root, out)
        os.makedirs(out_dir)
        shutil.rmtree(os.path.join(root, "VOC2007", "ImageSets"), ignore_errors=True)
        log = io.StringIO()
        with redirect_stdout(log):
            cli.main(["--voc-path", root, "--classes", classes, "--out-dir", out_dir] + argv)
        files = _written(root, out_dir)
        results.append(({k.replace(out, "OUT"): v for k, v in files.items()},
                        log.getvalue().replace(out, "OUT")))
    (jax_files, jax_log), (port_files, port_log) = results
    assert len(jax_files) >= 4
    assert port_files == jax_files
    assert port_log == jax_log
    if "--seg" not in argv and argv[1] == "0":
        with open(os.path.join(root, "port_out", "2007_train.txt"), "rb") as f:
            assert b"," in f.read()                   # some boxes were written


@pytest.mark.slow
def test_r05_eval_cli_matches_jax():
    """r05's best_epoch_weights.npz on the 48-image learnable set at 512^2
    (phase 15's set: the same writer, size and seed), f32 on the CPU, the
    port's get_map and get_miou against the JAX package's (minutes):
      - at the JAX CLIs' defaults (min-max radar for detection, post-ReLU
        seg logits), against the JAX CLIs themselves;
      - as r05 was trained (raw radar, signed seg logits: the port's
        --radar-norm none --seg-signed-logits), against JAX's Detector and
        Segmenter built so, scored by JAX's DetectionEvaluator and
        compute_miou_dirs; there AP50 and mIoU must also reach 0.95 (the
        JAX evaluation during training: AP50 0.9983, mIoU 0.9642).
    AP50 and mIoU agree within 0.005 in both."""
    import tempfile

    from PIL import Image

    from asy_vrnet_tpu.cli import get_map as jax_map
    from asy_vrnet_tpu.cli import get_miou as jax_miou
    from asy_vrnet_tpu.config import ModelConfig as JaxModelConfig
    from asy_vrnet_tpu.infer.predictor import Detector as JaxDetector
    from asy_vrnet_tpu.infer.predictor import Segmenter as JaxSegmenter
    from asy_vrnet_tpu.metrics.map import DetectionEvaluator
    from asy_vrnet_tpu.metrics.miou import compute_miou_dirs
    from asy_vrnet_tpu.train.checkpoint import load_weights

    from asy_vrnet_tpu_torch.cli import get_map, get_miou
    from asy_vrnet_tpu_torch.data.dataset import parse_annotation_line, read_annotation_file
    from asy_vrnet_tpu_torch.data.synthetic import write_learnable_voc_dataset

    work = tempfile.mkdtemp(prefix="r05_eval_")
    try:
        meta = write_learnable_voc_dataset(os.path.join(work, "set"), num_images=48,
                                           hw=(512, 512))
        common = ["--val-annotation", meta["annotation_path"], "--radar-root",
                  meta["radar_root"], "--weights", R05, "--compute-dtype", "float32"]
        det = ["--classes", meta["classes_path"]]
        seg = ["--seg-path", meta["seg_dataset_path"]]
        port = ["--device", "cpu"]
        trained = ["--radar-norm", "none", "--seg-signed-logits"]
        log = io.StringIO()
        with redirect_stdout(log):
            ap = get_map.main(common + det + port)["coco"]["map"]
            jax_map.main(common + det)
            miou = np.nanmean(get_miou.main(common + seg + port + [
                "--out", os.path.join(work, "port_miou")])[1])
            jax_miou.main(common + seg + ["--out", os.path.join(work, "jax_miou")])
            ap_t = get_map.main(common + det + port + trained)["coco"]["map"]
            miou_t = np.nanmean(get_miou.main(common + seg + port + trained + [
                "--out", os.path.join(work, "port_miou_t")])[1])
        lines = log.getvalue().splitlines()
        jax_ap = [float(l.split()[-1]) for l in lines if l.startswith("AP50 (COCO")][1]
        # the JAX CLI prints mIoU in percent, rounded to 0.01
        jax_miou_v = float([l for l in lines if l.startswith("===> mIoU")][1].split()[2]
                           .rstrip(";")) / 100.0

        # JAX as r05 was trained
        cfg = JaxModelConfig(compute_dtype="float32", seg_signed_logits=True)
        variables = load_weights(R05)
        names = ["pier", "vessel", "ship", "boat"]
        jd = JaxDetector(cfg, variables, names, conf_thres=0.05, radar_norm="none")
        js = JaxSegmenter(cfg, variables)
        ev = DetectionEvaluator(names, iou_threshold=0.5, max_dets=100)
        pngs = os.path.join(work, "jax_pngs")
        os.makedirs(pngs)
        ids = []
        for line in read_annotation_file(meta["annotation_path"]):
            path, gt, image_id = parse_annotation_line(line)
            image = Image.open(path)
            radar = np.load(os.path.join(meta["radar_root"], image_id + ".npz"))["arr_0"]
            res = jd.detect(image, radar)
            ev.add_image(res["boxes"][:, [1, 0, 3, 2]], res["scores"], res["classes"],
                         gt[:, :4], gt[:, 4].astype(int))
            js.get_miou_png(image, radar).save(os.path.join(pngs, image_id + ".png"))
            ids.append(image_id)
        jax_ap_t = ev.evaluate("coco")["map"]
        jax_miou_t = np.nanmean(compute_miou_dirs(
            os.path.join(meta["seg_dataset_path"], "VOC2007", "SegmentationClass"), pngs, ids,
            9, verbose=False)[1])
        print(f"JAX CLI defaults: AP50 port {ap:.4f} jax {jax_ap:.4f}; mIoU port {miou:.4f} "
              f"jax {jax_miou_v:.4f}.  As trained: AP50 port {ap_t:.4f} jax {jax_ap_t:.4f}; "
              f"mIoU port {miou_t:.4f} jax {jax_miou_t:.4f}")
        assert abs(ap - jax_ap) <= 0.005 and abs(miou - jax_miou_v) <= 0.005
        assert abs(ap_t - jax_ap_t) <= 0.005 and abs(miou_t - jax_miou_t) <= 0.005
        assert ap_t >= 0.95 and miou_t >= 0.95
    finally:
        shutil.rmtree(work, ignore_errors=True)
