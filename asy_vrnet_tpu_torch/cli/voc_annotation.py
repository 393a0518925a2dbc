"""VOC annotation prep CLI (counterpart of `asy_vrnet_tpu/cli/voc_annotation.py`;
reference: voc_annotation.py + voc_annotation_seg.py).  Pure Python: the
files it writes are the JAX CLI's, byte for byte.

Modes (same numbering as the reference):
  0 = split ImageSets AND write <year>_train.txt / <year>_val.txt
  1 = splits only
  2 = annotation txts only

  python -m asy_vrnet_tpu_torch.cli.voc_annotation --voc-path VOCdevkit \
      --classes model_data/waterscenes.txt --mode 0
  python -m asy_vrnet_tpu_torch.cli.voc_annotation --seg --voc-path VOCdevkit
"""
from __future__ import annotations

import argparse
import os
import random
import xml.etree.ElementTree as ET


def convert_annotation(voc_path, year, image_id, classes, list_file):
    """Append 'x1,y1,x2,y2,cls' fields for each non-difficult known object."""
    with open(
        os.path.join(voc_path, f"VOC{year}/Annotations/{image_id}.xml"),
        encoding="utf-8",
    ) as in_file:
        root = ET.parse(in_file).getroot()
    for obj in root.iter("object"):
        difficult = obj.find("difficult")
        difficult = int(difficult.text) if difficult is not None else 0
        cls = obj.find("name").text
        if cls not in classes or difficult == 1:
            continue
        box = obj.find("bndbox")
        coords = [
            int(float(box.find(tag).text))
            for tag in ("xmin", "ymin", "xmax", "ymax")
        ]
        list_file.write(" " + ",".join(map(str, coords)) + f",{classes.index(cls)}")


def write_splits(voc_path, year, trainval_percent, train_percent, seg=False, seed=0):
    random.seed(seed)
    if seg:
        src_dir = os.path.join(voc_path, f"VOC{year}/SegmentationClass")
        save_dir = os.path.join(voc_path, f"VOC{year}/ImageSets/Segmentation")
        ids = [f[:-4] for f in os.listdir(src_dir) if f.endswith(".png")]
    else:
        src_dir = os.path.join(voc_path, f"VOC{year}/Annotations")
        save_dir = os.path.join(voc_path, f"VOC{year}/ImageSets/Main")
        ids = [f[:-4] for f in os.listdir(src_dir) if f.endswith(".xml")]
    os.makedirs(save_dir, exist_ok=True)
    num = len(ids)
    tv = int(num * trainval_percent)
    tr = int(tv * train_percent)
    trainval = set(random.sample(range(num), tv))
    train = set(random.sample(sorted(trainval), tr))
    print("train and val size", tv)
    print("train size", tr)
    files = {
        name: open(os.path.join(save_dir, name + ".txt"), "w")
        for name in ("trainval", "test", "train", "val")
    }
    for i, image_id in enumerate(ids):
        line = image_id + "\n"
        if i in trainval:
            files["trainval"].write(line)
            (files["train"] if i in train else files["val"]).write(line)
        else:
            files["test"].write(line)
    for f in files.values():
        f.close()


def write_annotation_txts(voc_path, year, classes, out_dir="."):
    for split in ("train", "val"):
        ids_path = os.path.join(voc_path, f"VOC{year}/ImageSets/Main/{split}.txt")
        with open(ids_path, encoding="utf-8") as f:
            ids = [l.strip() for l in f if l.strip()]
        out_path = os.path.join(out_dir, f"{year}_{split}.txt")
        with open(out_path, "w", encoding="utf-8") as list_file:
            for image_id in ids:
                list_file.write(
                    os.path.abspath(
                        os.path.join(voc_path, f"VOC{year}/JPEGImages/{image_id}.jpg")
                    )
                )
                convert_annotation(voc_path, year, image_id, classes, list_file)
                list_file.write("\n")
        print(f"wrote {out_path}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--voc-path", required=True)
    p.add_argument("--classes")
    p.add_argument("--year", default="2007")
    p.add_argument("--mode", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--trainval-percent", type=float, default=0.8)
    p.add_argument("--train-percent", type=float, default=0.8)
    p.add_argument("--seg", action="store_true",
                   help="segmentation split mode (voc_annotation_seg.py)")
    p.add_argument("--out-dir", default=".")
    args = p.parse_args(argv)

    if args.seg:
        write_splits(args.voc_path, args.year, args.trainval_percent,
                     args.train_percent, seg=True)
        return
    if args.mode in (0, 1):
        print("Generate txt in ImageSets.")
        write_splits(args.voc_path, args.year, args.trainval_percent, args.train_percent)
    if args.mode in (0, 2):
        from asy_vrnet_tpu_torch.data.preprocess import get_classes

        classes, _ = get_classes(args.classes)
        print("Generate 2007_train.txt and 2007_val.txt for train.")
        write_annotation_txts(args.voc_path, args.year, classes, args.out_dir)


if __name__ == "__main__":
    main()
