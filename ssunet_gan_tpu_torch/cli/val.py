"""Test-split evaluation with a per-image CSV and overlays (the JAX
package's cli/val.py; reference scripts/val.py:117-274):

    python -m ssunet_gan_tpu_torch.cli.val --config <file> \
        [--ss_unet_gan true|false] [--device cuda]

The ``val_config.name`` model (its card and ``model.pth`` under
``file_path.model_path``; a GAN generator by default, as the reference
hardcodes) scores every image of ``<input_path>/<val_dataset>/images/test``
at batch 1 in f32, as the JAX package feeds it (on the card the fused
stages take kernel 1's f32 route): IoU and Dice of channels 1.. (the last
head under deep supervision), the per-class GT/RE/GT+RE overlay JPEGs in
``<output_path>/<name>/<class>/`` and ``<output_path>/<name>_result.csv``
of (filename, iou, dice) sorted by filename; prints the means.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from ssunet_gan_tpu_torch import resolve_device
from ssunet_gan_tpu_torch.config import load_experiment_config, load_model_card
from ssunet_gan_tpu_torch.data.dataset import SegmentationDataset, list_split_ids
from ssunet_gan_tpu_torch.data.loader import BatchLoader
from ssunet_gan_tpu_torch.data.transforms import val_transform
from ssunet_gan_tpu_torch.infer.api import load_model_dir
from ssunet_gan_tpu_torch.infer.overlays import save_gt_re_mask
from ssunet_gan_tpu_torch.ops.metrics import dice_coef, foreground_slice, iou_score
from ssunet_gan_tpu_torch.train.step import make_predict_fn
from ssunet_gan_tpu_torch.utils import AverageMeter, str2bool

CSV_COLUMNS = ("filename", "iou", "dice")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="test-split evaluation")
    parser.add_argument("--config", required=True, help="config file")
    parser.add_argument("--ss_unet_gan", type=str2bool, default=True,
                        help="load the model as a GAN generator (val.py:131)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run the model on (default: cuda)")
    return parser.parse_args(argv)


def result_save_to_csv_filename(csv_save_name, result_submission):
    """(filename, iou, dice) CSV sorted by filename (val.py:33-36): the
    text pandas' ``to_csv(index=False)`` writes (floats as their repr)."""
    with open(csv_save_name, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(CSV_COLUMNS)
        for name, iou, dice in sorted(result_submission, key=lambda r: r[0]):
            writer.writerow([name, repr(float(iou)), repr(float(dice))])


def load_eval_model(model_folder: str, name: str, ss_unet_gan: bool, device="cuda"):
    """The card of ``<model_folder>/<name>`` and its ``model.pth``
    (val.py:131-180): a :class:`models.gan.Generator` when ``ss_unet_gan``,
    else the bare arch; returns ``(model, config)``, the model in eval mode
    on ``device``."""
    model_dir = os.path.join(model_folder, name)
    config = load_model_card(model_dir)
    config["name"] = name
    return load_model_dir(model_dir, config, device, generator=bool(ss_unet_gan)), config


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_experiment_config(args.config)
    name = cfg.val_config["name"]
    input_folder = cfg.file_path.input_path
    output_folder = cfg.file_path.output_path

    model, config = load_eval_model(cfg.file_path.model_path, name, args.ss_unet_gan, dev)
    num_classes = config["num_classes"]
    predict = make_predict_fn(model)

    ids = list_split_ids(input_folder, config["val_dataset"], "test", config["img_ext"])
    dataset = SegmentationDataset(
        img_ids=ids,
        img_dir=os.path.join(input_folder, config["val_dataset"], "images", "test"),
        mask_dir=os.path.join(input_folder, config["val_dataset"], "annotations", "test"),
        img_ext=config["img_ext"],
        mask_ext=config["mask_ext"],
        num_classes=num_classes,
        input_channels=config["input_channels"],
        transform=val_transform(config),
    )
    loader = BatchLoader(dataset, 1, num_workers=int(config.get("num_workers", 3)))

    for c in range(num_classes):
        os.makedirs(os.path.join(output_folder, config["name"], str(c)), exist_ok=True)
    csv_save_name = os.path.join(output_folder, config["name"] + "_result.csv")

    avg = {"iou": AverageMeter(), "dice": AverageMeter()}
    result_submission = []
    for ori_img, img, target, meta in loader:
        output = predict(img)
        if isinstance(output, (list, tuple)):
            output = output[-1]  # deep supervision: the last head (val.py:231-236)
        out_m = foreground_slice(output, num_classes)
        tar_m = foreground_slice(torch.from_numpy(target).to(dev), num_classes)
        iou = float(iou_score(out_m, tar_m))
        dice = float(dice_coef(out_m, tar_m))
        result_submission.append([meta["img_id"][0], iou, dice])
        avg["iou"].update(iou, img.shape[0])
        avg["dice"].update(dice, img.shape[0])

        probs = torch.sigmoid(output.float()).cpu().numpy()
        for i in range(len(probs)):
            for idx_c in range(1, num_classes):
                mask = (255 * target[i][..., idx_c]).astype(np.uint8)
                mask_out = (255 * probs[i][..., idx_c]).astype(np.uint8)
                mask_output = np.where(mask_out > 127, 255, 0).astype(np.uint8)
                save_gt_re_mask(output_folder, config, meta, idx_c, i, ori_img, mask,
                                mask_output)

    result_save_to_csv_filename(csv_save_name, result_submission)
    print("IoU: %.4f" % avg["iou"].avg)
    print("dice: %.4f" % avg["dice"].avg)


if __name__ == "__main__":
    main()
