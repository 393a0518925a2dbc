"""WaterScenes-format joint detection+segmentation+radar dataset, the threaded
loader and the host-to-device prefetch (the port's own copy of
`asy_vrnet_tpu/data/dataset.py`).

Parity with utils/dataloader.py:35-457 (YoloDataset + collate): annotation
lines "path x1,y1,x2,y2,cls ...", timestamp-id regex for the radar .npz and
seg PNG lookup, BICUBIC/NEAREST letterbox, cxcywh absolute-pixel boxes, seg
targets with the trailing ignore class.  Batches come out in fixed shapes
(boxes padded to max_boxes) as numpy arrays; `device_prefetch` moves them to
the card through pinned host memory, one batch ahead of the consumer.  The
augmentation draws from a `default_rng((seed, epoch, index))` per sample and
`DataLoader.__iter__` bumps `dataset.epoch`, as in the JAX package, so the
same seed gives the same batches bit for bit in both.
"""
from __future__ import annotations

import os
import queue
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from asy_vrnet_tpu_torch.data.preprocess import (
    boxes_xyxy_to_cxcywh,
    cvt_color,
    letterbox_boxes,
    letterbox_image,
    letterbox_label,
    normalize_image,
    normalize_radar_minmax,
)

_ID_PATTERN = re.compile(r"\d{10}\.\d{5}")


def parse_annotation_line(line: str) -> tuple[str, np.ndarray, str]:
    """-> (image_path, boxes (N,5) xyxy+cls, timestamp id)."""
    parts = line.strip().split()
    path = parts[0]
    boxes = np.array(
        [list(map(int, b.split(","))) for b in parts[1:]], np.float32
    ).reshape(-1, 5)
    ids = _ID_PATTERN.findall(line)
    image_id = ids[-1] if ids else os.path.splitext(os.path.basename(path))[0]
    return path, boxes, image_id


def _bf16_bits(radar: np.ndarray) -> np.ndarray:
    """f32 -> bf16 (round to nearest even, torch's cast), kept as the int16
    bit pattern so that numpy can slice, flip and stack it."""
    return torch.from_numpy(radar).to(torch.bfloat16).view(torch.int16).numpy()


class WaterScenesDataset:
    """Joint dataset: image + radar map + boxes + segmentation labels."""

    def __init__(
        self,
        annotation_lines: Sequence[str],
        input_shape: tuple[int, int],
        num_classes: int,
        num_seg_classes: int,
        radar_root: str,
        seg_dataset_path: str,
        max_boxes: int = 100,
        radar_norm: str = "none",
        seg_subdir: str = os.path.join("VOC2007", "SegmentationClass"),
        augment: bool = False,
        weather: bool = False,
        flip_prob: float = 0.5,
        seed: int = 0,
        host_normalize: bool = False,
        cache_bytes: int = 0,
        radar_dtype: str = "float32",
    ):
        self.lines = [l for l in annotation_lines if l.strip()]
        self.input_shape = input_shape
        self.num_classes = num_classes
        self.num_seg_classes = num_seg_classes
        self.radar_root = radar_root
        self.seg_dir = os.path.join(seg_dataset_path, seg_subdir)
        self.max_boxes = max_boxes
        self.radar_norm = radar_norm
        # augment=True: a flip consistent over image, boxes, seg and radar,
        # then HSV jitter (and weather, if asked) on the image only.  Off by
        # default: the reference's random branch is dead code and its weather
        # augmentations are disabled (utils/dataloader.py:151-163,
        # train.py:498-508).
        self.augment = augment
        self.weather = weather
        self.flip_prob = flip_prob
        # per-(seed, epoch, sample) augmentation RNG: deterministic and safe
        # under the loader's worker threads; DataLoader bumps `epoch`
        self.seed = seed
        self.epoch = 0
        # False (the lean pipeline): images leave as uint8 HWC and the train
        # and eval steps normalise them on the device
        # (preprocess.maybe_normalize_image_device).  True keeps the
        # reference's host-side preprocess_input (utils/utils.py:43-47).
        self.host_normalize = host_normalize
        # Decoded-sample cache: the post-letterbox, pre-augment bundle (uint8
        # image, NHWC radar, uint8 seg, transformed boxes) up to `cache_bytes`
        # in all; 0 disables.  The budget's check-then-insert runs under a
        # lock (the loader's threads call __getitem__); the decode does not.
        self.cache_bytes = int(cache_bytes)
        self._cache: dict[int, tuple] = {}
        self._cache_used = 0
        self._cache_lock = threading.Lock()
        # 'bfloat16' halves the radar's host-to-device bytes (the largest
        # tensor of a batch); the radar then leaves as a torch.bfloat16
        # tensor.  The default keeps the reference's raw f32
        # (utils/dataloader.py:87).
        if radar_dtype not in ("float32", "bfloat16"):
            raise ValueError(radar_dtype)
        self.radar_dtype = radar_dtype
        # native C++ npz reader (GIL-free) where its library builds; numpy
        # otherwise (host IO, not a device kernel)
        from asy_vrnet_tpu_torch.data import native_io

        self._native_npz = native_io.load_npz if native_io.native_available() else None

    def __len__(self) -> int:
        return len(self.lines)

    def load_raw(self, index: int):
        """(PIL image RGB, boxes xyxy+cls, radar (4,H,W), PIL seg label, id)."""
        from PIL import Image

        path, boxes, image_id = parse_annotation_line(self.lines[index])
        image = cvt_color(Image.open(path))
        radar_path = os.path.join(self.radar_root, image_id + ".npz")
        if self._native_npz is not None:
            radar = self._native_npz(radar_path)
        else:
            radar = np.load(radar_path)["arr_0"]
        seg = Image.open(os.path.join(self.seg_dir, image_id + ".png"))
        return image, boxes, radar, seg, image_id

    def _decoded(self, index: int):
        """Decode + letterbox one sample (cached when cache_bytes allows):
        (img_u8 HWC, boxes cxcywh+cls, radar NHWC, seg_u8 HW, id); the radar
        is f32, or bf16 bits as int16 under radar_dtype 'bfloat16'."""
        cached = self._cache.get(index)
        if cached is not None:
            return cached

        h, w = self.input_shape
        image, boxes, radar, seg, image_id = self.load_raw(index)

        image_lb, nw, nh = letterbox_image(image, (w, h))
        seg_lb = letterbox_label(seg, (w, h))
        boxes_lb = letterbox_boxes(boxes, image.size, (w, h))
        boxes_cxcywh = boxes_xyxy_to_cxcywh(boxes_lb)

        radar = np.asarray(radar, np.float32)
        if self.radar_norm == "minmax":
            radar = normalize_radar_minmax(radar).astype(np.float32)
        # (4,H,W) channel-first on disk -> NHWC
        radar_arr = np.ascontiguousarray(np.transpose(radar, (1, 2, 0)))
        if radar_arr.shape[:2] != (h, w):
            raise ValueError(
                f"radar map {radar_arr.shape} does not match input {h}x{w}"
            )
        if self.radar_dtype == "bfloat16":
            radar_arr = _bf16_bits(radar_arr)

        img_u8 = np.asarray(image_lb)
        seg_u8 = np.asarray(seg_lb)
        bundle = (img_u8, boxes_cxcywh, radar_arr, seg_u8, image_id)
        if self.cache_bytes:
            nbytes = sum(a.nbytes for a in bundle[:4])
            with self._cache_lock:
                if (
                    index not in self._cache
                    and self._cache_used + nbytes <= self.cache_bytes
                ):
                    self._cache[index] = bundle
                    self._cache_used += nbytes
        return bundle

    def __getitem__(self, index: int) -> dict:
        img_u8, boxes_cxcywh, radar_arr, seg_u8, image_id = self._decoded(
            index % len(self)
        )
        if self.augment:
            from asy_vrnet_tpu_torch.data.augment import (
                apply_weather,
                flip_horizontal,
                hsv_jitter,
            )

            aug_rng = np.random.default_rng((self.seed, self.epoch, index))
            if aug_rng.random() < self.flip_prob:
                img_u8, boxes_cxcywh_xyxy, seg_u8, radar_arr = flip_horizontal(
                    img_u8,
                    # flip operates on xyxy; convert back after
                    np.concatenate(
                        [
                            boxes_cxcywh[:, :2] - boxes_cxcywh[:, 2:4] / 2,
                            boxes_cxcywh[:, :2] + boxes_cxcywh[:, 2:4] / 2,
                            boxes_cxcywh[:, 4:5],
                        ],
                        axis=-1,
                    ) if len(boxes_cxcywh) else np.zeros((0, 5), np.float32),
                    seg_u8, radar_arr,
                )
                boxes_cxcywh = boxes_xyxy_to_cxcywh(boxes_cxcywh_xyxy)
            img_u8 = hsv_jitter(np.ascontiguousarray(img_u8), aug_rng)
            if self.weather:
                img_u8 = apply_weather(img_u8, aug_rng)
            radar_arr = np.ascontiguousarray(radar_arr)

        if self.host_normalize:
            img_arr = normalize_image(img_u8).astype(np.float32)
        else:
            img_arr = np.ascontiguousarray(img_u8)
        # clamp ignore labels to num_seg (utils/dataloader.py:92-94), shipped
        # as uint8; the step one-hots it on the device (train_step.seg_onehot_of)
        seg_arr = np.minimum(seg_u8, self.num_seg_classes)
        if seg_arr.dtype != np.uint8:
            seg_arr = seg_arr.astype(
                np.uint8 if self.num_seg_classes < 255 else np.int32
            )
        radar_out = (torch.from_numpy(radar_arr).view(torch.bfloat16)
                     if self.radar_dtype == "bfloat16" else radar_arr)

        gt_boxes = np.zeros((self.max_boxes, 4), np.float32)
        gt_classes = np.zeros((self.max_boxes,), np.int32)
        gt_valid = np.zeros((self.max_boxes,), bool)
        n = min(len(boxes_cxcywh), self.max_boxes)
        if n:
            gt_boxes[:n] = boxes_cxcywh[:n, :4]
            gt_classes[:n] = boxes_cxcywh[:n, 4].astype(np.int32)
            gt_valid[:n] = True

        return {
            "image": img_arr,
            "radar": radar_out,
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "seg_target": seg_arr,
            "image_id": image_id,
        }


def _stack(samples: Sequence[dict]) -> dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if k == "image_id":
            out[k] = vals
        elif isinstance(vals[0], torch.Tensor):
            out[k] = torch.stack(vals)
        else:
            out[k] = np.stack(vals)
    return out


class DataLoader:
    """Minimal epoch iterator with shuffling, drop-last batching,
    background-thread prefetch and a thread pool for per-sample decode.

    The sample work (JPEG/PNG decode, npz parse, letterbox) releases the GIL
    in PIL/numpy/native-IO C code, so `workers` threads overlap it.  A
    worker's exception reaches the consumer, which re-raises it.

    Data parallelism: `batch_size` is the global batch; rank `rank` of
    `world` shuffles the same global order (same seed) and loads only its
    contiguous rows [r*B/n, (r+1)*B/n) of each global batch, as the JAX
    package's P("data") sharding splits it, so every sample is decoded once
    over the ranks.  Augmentation draws per sample from (seed, epoch, index)
    and gives each rank's rows the single loader's values."""

    def __init__(
        self,
        dataset: WaterScenesDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        drop_last: bool = True,
        workers: int = 4,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world or not 0 <= rank < world:
            raise ValueError(f"DataLoader: rank {rank} of {world} cannot split a batch of "
                             f"{batch_size} into equal shards")
        if world > 1 and not drop_last:
            raise ValueError("DataLoader: a last partial batch does not split into equal "
                             "shards; pass drop_last=True for world > 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.workers = workers
        self.rank = rank
        self.world = world

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch += 1  # fresh augmentation stream per epoch
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order) - (self.batch_size - 1 if self.drop_last else 0),
                           self.batch_size)
        ]
        shard = self.batch_size // self.world
        batches = [idxs[self.rank * shard:(self.rank + 1) * shard] for idxs in batches]

        def load_batch(idxs) -> dict:
            if self.workers > 1 and len(idxs) > 1:
                samples = list(pool.map(self.dataset.__getitem__, idxs))
            else:
                samples = [self.dataset[i] for i in idxs]
            return _stack(samples)

        pool = (
            ThreadPoolExecutor(max_workers=self.workers, thread_name_prefix="asyvr-load")
            if self.workers > 1
            else None
        )
        try:
            if self.prefetch <= 0:
                for idxs in batches:
                    yield load_batch(idxs)
                return

            q: queue.Queue = queue.Queue(maxsize=self.prefetch)
            sentinel = object()
            stop = threading.Event()

            def put(item) -> bool:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
                return False

            def worker():
                # A failing sample (missing radar npz, corrupt PNG, ...) must
                # fail the epoch loudly, not truncate it: enqueue the exception
                # and re-raise it in the consuming thread.
                try:
                    for idxs in batches:
                        if not put(load_batch(idxs)):
                            return
                    put(sentinel)
                except BaseException as e:  # noqa: BLE001 — relayed to consumer
                    put(e)

            t = threading.Thread(target=worker, daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is sentinel:
                        break
                    if isinstance(item, BaseException):
                        t.join()
                        raise item
                    yield item
            finally:
                # unblock the producer if the consumer stopped early
                stop.set()
                while not q.empty():
                    q.get_nowait()
                t.join()
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


def device_prefetch(iterator, device: str | torch.device = "cuda") -> Iterator[dict]:
    """Host batches (numpy arrays or CPU tensors) -> batches of tensors on
    `device`; `image_id` (host metadata) passes through untouched.

    On the card each batch is copied into pinned host memory and onto the
    device with `non_blocking` copies on a side stream, issued one batch
    ahead of the one handed out, so a copy overlaps the consumer's work on
    the previous batch.  The consumer's stream waits for the batch's copies
    (an event), and each device tensor is recorded on that stream for the
    allocator.  A pinned buffer is not reused before its copy completes: the
    caching host allocator records the copy's stream and holds the block
    until then.  On the CPU the batch is handed out as tensors, unpinned."""
    dev = torch.device(device)

    def tensors(batch: dict) -> tuple[dict, Optional[list]]:
        batch = dict(batch)
        ids = batch.pop("image_id", None)
        return {k: torch.as_tensor(v) for k, v in batch.items()}, ids

    if dev.type != "cuda":
        for batch in iterator:
            out, ids = tensors(batch)
            if ids is not None:
                out["image_id"] = ids
            yield out
        return

    stream = torch.cuda.Stream(dev)

    def issue(batch: dict):
        host, ids = tensors(batch)
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(dev, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, ids, done

    def hand_out(pending):
        out, ids, done = pending
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for v in out.values():
            v.record_stream(consumer)
        if ids is not None:
            out["image_id"] = ids
        return out

    pending = None
    for batch in iterator:
        nxt = issue(batch)
        if pending is not None:
            yield hand_out(pending)
        pending = nxt
    if pending is not None:
        yield hand_out(pending)


def read_annotation_file(path: str) -> list[str]:
    with open(path, encoding="utf-8") as f:
        return [l for l in f.read().splitlines() if l.strip()]
