"""End-to-end inference smoke test (the JAX package's cli/smoke_test.py;
reference aerial_image_segmentation_test.py:8-44, its only executable
test):

    python -m ssunet_gan_tpu_torch.cli.smoke_test --config <file> [--device cuda]

The ``val_config.name`` model (:func:`infer.api.load_segmentation_models`)
runs the first ``*_image.*`` scene under ``val_config.full_image_path``
through the whole-scene pipeline (the tile server's uint8 tiles, the
batched bf16 forward on the card, the merge) and writes its overlays
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
    parser = argparse.ArgumentParser(description="end-to-end inference smoke test")
    parser.add_argument("--config", required=True, help="config file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run the model on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = load_experiment_config(args.config)
    val_config = cfg.val_config
    gt_mask_flag = coerce_string_bool(val_config.get("gt_mask_flag", False))

    model, config = load_segmentation_models(args.config, device=args.device)
    scene_glob = os.path.join(val_config["full_image_path"], "*_image.*")
    scenes = sorted(glob(scene_glob))
    if not scenes:
        raise FileNotFoundError(f"no scenes match {scene_glob}")
    img_path = scenes[0]
    image_name = os.path.splitext(os.path.basename(img_path))[0]

    img_input, img_patch_set, mask_patch_set = get_patched_input(
        img_path, config, gt_mask_flag, raw_uint8=True)
    all_class_mask, gt_class_mask = segmentation_inference(
        model, img_input, img_patch_set, mask_patch_set, config, gt_mask_flag,
        device=args.device)
    os.makedirs(os.path.join(cfg.file_path.output_path, config["name"]), exist_ok=True)
    save_image_color_masking(cfg.file_path.output_path, image_name, img_input, all_class_mask,
                             gt_class_mask, config, gt_mask_flag)
    print("smoke test ok:", image_name)


if __name__ == "__main__":
    main()
