#!/usr/bin/env python3
"""Accuracy bars of the PyTorch port's eval paths (the port's counterpart
of ``tools/accuracy_bar.py``).

Trains the flagship (``UNet_R_SS_v2``) briefly on synthetic "city" scenes
(or reuses the checkpoint already in ``--root``), reloads the best
``model.pth`` and scores the same weights on the validation split, tile
by tile at batch 1, under five eval configurations, each against the f32
unfused path:

    f32-unfused | bf16-unfused | bf16-fused | int8-fused (dynamic) |
    int8-fused (calibrated on the validation tiles)

"unfused" is the module composition (``set_fused_stage(False)``),
"fused" the hand-written stage kernels on the card (kernel 1 in bf16,
kernel 7 in int8; their plain versions on the CPU). Every row runs with
TF32 off, so the f32 yardstick is f32. The metrics are the reference's:
thresholded IoU and soft Dice of channels 1.. (``ops/metrics.py``).
``--scene`` also bars the whole-scene path: a (4·size)² scene assembled
from the validation tiles, patched at ``--size`` with overlap 0.5, the
chunked uint8 forward (quantized probabilities), the merge on the device,
and the IoU of the merged masks.

Exit code 1 when the better int8 tile row's IoU is more than 0.005 from
the f32 unfused row (and, with ``--scene``, when the scene's int8 row
is), else 0.

    python3 tools/torch_accuracy_bar.py [--epochs 12] [--n 48] [--size 256]
        [--root DIR] [--skip-train] [--hard] [--scene] [--device cuda]

``--device`` defaults to the card and raises without one; ``--device cpu
--epochs 1 --n 8 --size 64`` rehearses the control flow on the CPU. A
root that holds only the JAX package's ``model.orbax`` is converted first
with ``tools/torch_from_orbax.py``. Imports no JAX and no cv2.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssunet_gan_tpu_torch import resolve_device  # noqa: E402
from ssunet_gan_tpu_torch.config import ExperimentConfig, FilePaths  # noqa: E402
from ssunet_gan_tpu_torch.data.dataset import SegmentationDataset, list_split_ids  # noqa: E402
from ssunet_gan_tpu_torch.data.png import write_image  # noqa: E402
from ssunet_gan_tpu_torch.data.tiling import grid_coords, merge_patches_device  # noqa: E402
from ssunet_gan_tpu_torch.data.transforms import val_transform  # noqa: E402
from ssunet_gan_tpu_torch.infer.api import _chunked_forward, load_model_dir  # noqa: E402
from ssunet_gan_tpu_torch.infer.calibrate import calibrate_int8  # noqa: E402
from ssunet_gan_tpu_torch.ops.metrics import dice_coef, iou_score  # noqa: E402
from ssunet_gan_tpu_torch.ops.spade_kernel import set_fused_spade  # noqa: E402
from ssunet_gan_tpu_torch.ops.stage_kernel import set_fused_stage  # noqa: E402
from ssunet_gan_tpu_torch.ops.stage_kernel_int8 import (  # noqa: E402
    set_int8_calibration,
    set_int8_stage,
)
from ssunet_gan_tpu_torch.train.supervised import run_experiment  # noqa: E402

NAME = "accuracy_bar"
INT8_BAR = 0.005  # |ΔIoU| of the better int8 row from f32-unfused
SCENE_K = 4  # the scene is SCENE_K x SCENE_K validation tiles
OVERLAP = 0.5
SMOOTH = 1e-5
TILE_ROWS = (  # (label, dtype, fused, int8); the calibrated int8 row follows
    ("f32-unfused (API path)", torch.float32, False, False),
    ("bf16-unfused", torch.bfloat16, False, False),
    ("bf16-fused (bench config)", torch.bfloat16, True, False),
    ("int8-fused (dynamic)", torch.bfloat16, True, True),
)
CALIBRATED = ("int8-fused (calibrated)", torch.bfloat16, True, True)
SCENE_ROWS = (
    ("scene f32-unfused", torch.float32, False, False),
    ("scene bf16-fused (bench config)", torch.bfloat16, True, False),
)
SCENE_CALIBRATED = ("scene int8-fused (calibrated)", torch.bfloat16, True, True)


def make_city_dataset(input_root: str, name: str, n: int, size: int, seed: int = 7,
                      hard: bool = False) -> None:
    """Structured synthetic "city" scenes on disk, draw for draw those of
    ``tools/accuracy_bar.py`` ``_make_city_dataset`` (one
    ``np.random.default_rng(seed)``, the same calls in the same order):
    bright building rectangles (class 1) and dark road stripes (class 2)
    over ground texture, per-class mask files, splits ``training`` (n),
    ``validation`` and ``test`` (max(n // 4, 1) each).

    ``hard`` makes the task partly ambiguous, so the model plateaus below
    saturation: masks shifted off the drawn buildings and road widths
    jittered, unlabeled buildings and labels without a building,
    ground-coloured buildings, unlabeled red-ish patches, sensor noise and
    a brightness gradient. Files are written by ``data/png.py``
    ``write_image`` (BGR, as ``cv2.imwrite``)."""
    rng = np.random.default_rng(seed)
    for split, count in (("training", n), ("validation", max(n // 4, 1)),
                         ("test", max(n // 4, 1))):
        img_dir = os.path.join(input_root, name, "images", split)
        os.makedirs(img_dir, exist_ok=True)
        mdirs = []
        for c in range(3):
            d = os.path.join(input_root, name, "annotations", split, str(c))
            os.makedirs(d, exist_ok=True)
            mdirs.append(d)
        for i in range(count):
            img = rng.integers(70, 110, (size, size, 3), np.uint8)
            m = np.zeros((size, size, 3), np.uint8)
            for _ in range(3):  # roads: dark stripes
                t = int(rng.integers(size // 32, size // 16))
                p = int(rng.integers(0, size - t))
                horiz = rng.random() < 0.5
                sl = (slice(p, p + t), slice(None)) if horiz else (slice(None), slice(p, p + t))
                img[sl] = rng.integers(25, 45)
                # hard: the labeled width jitters against the drawn one
                mt = t + int(rng.integers(-t // 2, t // 2 + 1)) if hard else t
                mt = max(mt, 1)
                msl = (slice(p, p + mt), slice(None)) if horiz \
                    else (slice(None), slice(p, p + mt))
                m[..., 2][msl] = 255
            if hard:
                for _ in range(4):  # unlabeled red-ish ground distractors
                    dh = int(rng.integers(size // 20, size // 8))
                    dw = int(rng.integers(size // 20, size // 8))
                    y0 = int(rng.integers(0, size - dh))
                    x0 = int(rng.integers(0, size - dw))
                    img[y0:y0 + dh, x0:x0 + dw] = (
                        int(rng.integers(50, 90)), int(rng.integers(50, 90)),
                        int(rng.integers(120, 180)),
                    )
            for _ in range(10):  # buildings: bright reddish rects (on top)
                bh = int(rng.integers(size // 16, size // 5))
                bw = int(rng.integers(size // 16, size // 5))
                y0 = int(rng.integers(0, size - bh))
                x0 = int(rng.integers(0, size - bw))
                if hard and rng.random() < 0.25:  # ground-coloured building
                    col = tuple(int(v) for v in rng.integers(70, 110, 3))
                else:
                    col = (int(rng.integers(40, 90)), int(rng.integers(40, 90)),
                           int(rng.integers(170, 240)))  # BGR: red-ish roofs
                img[y0:y0 + bh, x0:x0 + bw] = col
                if hard and rng.random() < 0.15:
                    continue  # unlabeled building
                my0, mx0 = y0, x0
                if hard:  # mask misregistration ±3 px
                    my0 = int(np.clip(y0 + rng.integers(-3, 4), 0, size - bh))
                    mx0 = int(np.clip(x0 + rng.integers(-3, 4), 0, size - bw))
                m[my0:my0 + bh, mx0:mx0 + bw, 1] = 255
                m[my0:my0 + bh, mx0:mx0 + bw, 2] = 0
            if hard and rng.random() < 0.3:  # a mask rect with no evidence
                bh = int(rng.integers(size // 16, size // 6))
                bw = int(rng.integers(size // 16, size // 6))
                y0 = int(rng.integers(0, size - bh))
                x0 = int(rng.integers(0, size - bw))
                m[y0:y0 + bh, x0:x0 + bw, 1] = 255
                m[y0:y0 + bh, x0:x0 + bw, 2] = 0
            if hard:  # sensor noise + brightness gradient
                grad = np.linspace(-18, 18, size, dtype=np.float32)
                axis = rng.random() < 0.5
                g2 = grad[None, :, None] if axis else grad[:, None, None]
                noisy = (img.astype(np.float32) + g2
                         + rng.normal(0, 10, img.shape).astype(np.float32))
                img = np.clip(noisy, 0, 255).astype(np.uint8)
            m[..., 0] = 255 - np.maximum(m[..., 1], m[..., 2])  # background
            iid = f"{split}_{i:04d}"
            write_image(os.path.join(img_dir, iid + ".png"), img)
            for c in range(3):
                write_image(os.path.join(mdirs[c], iid + ".png"), m[..., c])


def options(size: int, epochs: int) -> dict:
    """The JAX tool's ``opt_config``: the flagship at ``size``², batch 8,
    Adam 1e-4, BCE-Dice, clip 0.7, bf16 steps."""
    return {
        "name": NAME, "arch": "UNet_R_SS_v2", "epochs": epochs,
        "batch_size": 8, "deep_supervision": False, "input_channels": 3,
        "num_classes": 3, "input_w": size, "input_h": size,
        "loss": "BCEDiceLoss", "optimizer": "Adam", "lr": 1e-4,
        "weight_decay": 1e-7, "momentum": 0.9, "nesterov": False,
        "scheduler": "ConstantLR", "min_lr": 1e-5, "clip": 0.7,
        "early_stopping": -1, "num_workers": 2, "dataset": "city",
        "val_dataset": "city", "img_ext": ".png", "mask_ext": ".png",
        "resume": False, "mixed_precision": "True",
    }


def split_set(root: str, opt: dict, split: str = "validation") -> SegmentationDataset:
    """A split of the city scenes through ``val_transform``: items (uint8
    BGR image, normalized f32 image, f32 {0, 1} masks, meta)."""
    inputs = os.path.join(root, "inputs")
    split_dir = os.path.join(inputs, "city")
    return SegmentationDataset(
        img_ids=list_split_ids(inputs, "city", split, ".png"),
        img_dir=os.path.join(split_dir, "images", split),
        mask_dir=os.path.join(split_dir, "annotations", split),
        img_ext=".png", mask_ext=".png", num_classes=3, transform=val_transform(opt))


def load_best(root: str, opt: dict, device="cuda"):
    """The best checkpoint of ``<root>/models/accuracy_bar`` in eval mode on
    ``device``. A directory with only the JAX package's ``model.orbax``
    raises NotImplementedError naming the converter."""
    return load_model_dir(os.path.join(root, "models", NAME), opt, device)


@contextlib.contextmanager
def eval_modes(fused: bool, int8: bool):
    """The fused eval stages and the int8 mode as a row asks, the SPADE
    mode at its default and TF32 off while active; after, the stages at
    their default, the int8 mode off and TF32 as it was."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    set_fused_stage(fused)
    set_int8_stage(int8)
    set_fused_spade(None)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        set_int8_stage(False)
        set_fused_stage(None)


def evaluate(model, val_ds, label, dtype, fused, int8, device="cuda"):
    """One tile row: each validation item's normalized image at batch 1,
    cast to ``dtype``, through the model under :func:`eval_modes`; IoU and
    Dice of its f32 logits' channels 1.. against the masks. Returns
    (label, mean IoU, mean Dice)."""
    dev = resolve_device(device)
    ious, dices = [], []
    with eval_modes(fused, int8), torch.no_grad():
        for i in range(len(val_ds)):
            item = val_ds[i]  # (ori_img, img, mask, meta)
            x = torch.from_numpy(item[1][None]).to(dev, dtype)
            y = torch.from_numpy(item[2][None]).to(dev)
            out = model(x)
            logits = (out[-1] if isinstance(out, (list, tuple)) else out).float()
            ious.append(float(iou_score(logits[..., 1:], y[..., 1:])))
            dices.append(float(dice_coef(logits[..., 1:], y[..., 1:])))
    return label, float(np.mean(ious)), float(np.mean(dices))


def calibrate(model, val_ds, device="cuda") -> dict:
    """Static int8 scales recorded on the validation tiles (f32, TF32 off)
    and installed; returns them."""
    tiles = np.stack([val_ds[i][1] for i in range(len(val_ds))]).astype(np.float32)
    with eval_modes(False, False):
        return calibrate_int8(model, tiles, batch_size=min(8, len(tiles)), device=device)


def tile_rows(model, val_ds, device="cuda", rows=TILE_ROWS) -> list:
    """The tile rows ``rows``, then the calibrated int8 row; the
    calibration installed for it is cleared after."""
    rows = [evaluate(model, val_ds, *row, device=device) for row in rows]
    calibrate(model, val_ds, device)
    try:
        rows.append(evaluate(model, val_ds, *CALIBRATED, device=device))
    finally:
        set_int8_calibration(None)
    return rows


def tile_bars(rows) -> int:
    """Print the tile table and bars; 1 when the better int8 row's |ΔIoU|
    from the first row passes INT8_BAR."""
    base_iou, base_dice = rows[0][1], rows[0][2]
    print("\n| Eval config | IoU | Dice | ΔIoU | ΔDice |")
    print("|---|---|---|---|---|")
    for label, iou, dice in rows:
        print(f"| {label} | {iou:.4f} | {dice:.4f} | "
              f"{iou - base_iou:+.4f} | {dice - base_dice:+.4f} |")
    d_bf16 = abs(rows[2][1] - base_iou)
    d_int8 = min(abs(rows[3][1] - base_iou), abs(rows[4][1] - base_iou))
    print(f"\nbf16-fused IoU delta: {d_bf16:.4f}  (bar: small)")
    print(f"int8-fused IoU delta (best mode): {d_int8:.4f}  (bar: <= {INT8_BAR})")
    return 0 if d_int8 <= INT8_BAR else 1


def scene_inputs(val_ds, size: int):
    """The SCENE_K² scene of validation images (``val_ds[i % n]``, uint8)
    with its {0, 255} masks, its patch grid at ``size`` and overlap
    OVERLAP, and the uint8 patches: (scene, gt, coords, patches)."""
    n = len(val_ds)
    imgs, masks = [], []
    for i in range(SCENE_K * SCENE_K):
        item = val_ds[i % n]
        imgs.append(item[0])
        masks.append((item[2] > 0.5).astype(np.uint8) * 255)
    rows = lambda ts: np.concatenate(
        [np.concatenate(ts[r * SCENE_K:(r + 1) * SCENE_K], axis=1) for r in range(SCENE_K)],
        axis=0)
    scene, gt = rows(imgs).astype(np.uint8), rows(masks)
    coords = grid_coords(scene.shape[0], scene.shape[1], size, OVERLAP)
    patches = np.stack([scene[y:y + size, x:x + size] for y, x in coords])
    return scene, gt, coords, patches


def scene_iou(model, inputs, label, dtype, fused, int8, device="cuda"):
    """One scene row: the patches through the chunked forward (uint8,
    normalized on the device, ``dtype``, quantized probabilities, the last
    chunk zero-padded), merged on the device; the mean over channels 1..
    of the merged masks' IoU against the scene's. Returns (label, IoU)."""
    scene, gt, coords, patches = inputs
    h, w = scene.shape[:2]
    size = patches.shape[1]
    with eval_modes(fused, int8):
        probs = _chunked_forward(model, patches, dtype, device, quantize_probs=True)
        merged = merge_patches_device(probs, coords, h, w, size, 3,
                                      overlap=OVERLAP).cpu().numpy()
    ious = []
    for c in range(1, 3):
        p_, g_ = merged[..., c] > 0, gt[..., c] > 0
        ious.append(((p_ & g_).sum() + SMOOTH) / ((p_ | g_).sum() + SMOOTH))
    return label, float(np.mean(ious))


def scene_rows(model, val_ds, size: int, device="cuda") -> list:
    """The three scene rows; the calibration is cleared after."""
    inputs = scene_inputs(val_ds, size)
    rows = [scene_iou(model, inputs, *row, device=device) for row in SCENE_ROWS]
    calibrate(model, val_ds, device)
    try:
        rows.append(scene_iou(model, inputs, *SCENE_CALIBRATED, device=device))
    finally:
        set_int8_calibration(None)
    return rows


def scene_bars(rows) -> int:
    """Print the scene table and bar; 1 when the int8 row's |ΔIoU| from the
    first row passes INT8_BAR."""
    base = rows[0][1]
    print("\n| Scene eval config | merged IoU | Δ |")
    print("|---|---|---|")
    for label, iou in rows:
        print(f"| {label} | {iou:.4f} | {iou - base:+.4f} |")
    d8 = abs(rows[2][1] - base)
    print(f"\nscene int8 IoU delta: {d8:.4f}  (bar: <= {INT8_BAR})")
    return 0 if d8 <= INT8_BAR else 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--n", type=int, default=48, help="city train scenes")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "accuracy_bar"))
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse the checkpoint already in --root")
    ap.add_argument("--hard", action="store_true",
                    help="non-saturated regime: label noise and appearance ambiguity")
    ap.add_argument("--scene", action="store_true",
                    help="also bar the whole-scene path (patch, chunked forward, merge)")
    ap.add_argument("--device", default="cuda",
                    help="where to train and score (default the card; cpu rehearses)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    opt = options(args.size, args.epochs)
    make_city_dataset(os.path.join(args.root, "inputs"), "city", args.n, args.size,
                      hard=args.hard)
    try:
        if not args.skip_train:
            cfg = ExperimentConfig(
                file_path=FilePaths(input_path=os.path.join(args.root, "inputs"),
                                    model_path=os.path.join(args.root, "models"),
                                    output_path=os.path.join(args.root, "outputs"),
                                    checkpoint_path=os.path.join(args.root, "ckpt")),
                opt_config=opt, val_config={})
            set_fused_stage(False)  # train with the eval stages unfused, as JAX does
            run_experiment(cfg, use_tensorboard=False, device=device)
        model = load_best(args.root, opt, device)
        val_ds = split_set(args.root, opt)
        rc = tile_bars(tile_rows(model, val_ds, device))
        if args.scene:
            rc = max(rc, scene_bars(scene_rows(model, val_ds, args.size, device)))
    finally:
        set_int8_calibration(None)
        set_int8_stage(False)
        set_fused_stage(None)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
