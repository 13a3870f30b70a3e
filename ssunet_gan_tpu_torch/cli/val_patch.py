"""Whole-scene sliding-window evaluation (reference scripts/val_patch.py:444-481;
the JAX package's cli/val_patch.py):

    python -m ssunet_gan_tpu_torch.cli.val_patch --config <file> [--device cuda]

Every ``*_image.*`` scene under ``val_config.full_image_path``, with its
``*_labels.*`` where ``val_config.gt_mask_flag`` is on, goes through the
model of ``val_config.name`` (its card and ``model.pth`` under
``file_path.model_path``): the tile server's tiles, the batched tile
forward, the merge on the device, and the JPEG overlays of classes 1..
into ``<file_path.output_path>/<name>/``.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

from ssunet_gan_tpu_torch.config import coerce_string_bool, load_experiment_config
from ssunet_gan_tpu_torch.infer.api import (
    get_patched_input,
    load_segmentation_models,
    save_image_color_masking,
    segmentation_inference,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="whole-scene evaluation")
    parser.add_argument("--config", required=True, help="config file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run the model on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = load_experiment_config(args.config)
    val_config = cfg.val_config
    output_folder = cfg.file_path.output_path
    gt_mask_flag = coerce_string_bool(val_config.get("gt_mask_flag", False))

    model, config = load_segmentation_models(args.config, device=args.device)
    os.makedirs(os.path.join(output_folder, config["name"]), exist_ok=True)

    scene_glob = os.path.join(val_config["full_image_path"], "*_image.*")
    scenes = sorted(glob(scene_glob))
    if not scenes:
        print(f"no scenes match {scene_glob}")
        return
    for img_path in scenes:
        image_name = os.path.splitext(os.path.basename(img_path))[0]
        print(f"=> {image_name}")
        img_input, img_patch_set, mask_patch_set = get_patched_input(
            img_path, config, gt_mask_flag, raw_uint8=True)
        all_class_mask, gt_class_mask = segmentation_inference(
            model, img_input, img_patch_set, mask_patch_set, config, gt_mask_flag,
            device=args.device)
        save_image_color_masking(output_folder, image_name, img_input, all_class_mask,
                                 gt_class_mask, config, gt_mask_flag)


if __name__ == "__main__":
    main()
