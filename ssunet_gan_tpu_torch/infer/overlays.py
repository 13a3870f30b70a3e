"""Colored-overlay writers of whole-scene results (the JAX package's
infer/overlays.py; reference api:255-297, val.py:104-114): ground truth
blended 50% yellow, predictions 50% pink, BGR, written as JPEG through
:func:`data.jpeg.write_image`, so a file equals the JAX package's
``cv2.imwrite`` byte for byte. ``save_contour`` (cv2.findContours) is not
ported (ROADMAP.md)."""

from __future__ import annotations

import os

import numpy as np

from ssunet_gan_tpu_torch.data.jpeg import write_image

YELLOW = np.array([0, 255, 255], np.uint8)  # BGR
PINK = np.array([255, 0, 255], np.uint8)


def _blend(img: np.ndarray, mask: np.ndarray, color: np.ndarray) -> np.ndarray:
    """``img`` where ``mask > 0`` becomes ``0.5·color + 0.5·img`` in float64,
    truncated back to uint8, in place."""
    idx = mask > 0
    img[idx] = (0.5 * color + 0.5 * img[idx]).astype(img.dtype)
    return img


def save_masking(img, mask_gt, mask_out, save_name):
    """GT (yellow) + prediction (pink) overlay (api:255-271)."""
    img = _blend(img, mask_gt, YELLOW)
    write_image(save_name, _blend(img, mask_out, PINK))
    return 0


def save_masking_RE(img, mask_gt, mask_out, save_name):
    """Prediction-only pink overlay (api:274-285)."""
    write_image(save_name, _blend(img, mask_out, PINK))
    return 0


def save_masking_GT(img, mask_gt, mask_out, save_name):
    """GT-only yellow overlay (api:288-297)."""
    write_image(save_name, _blend(img, mask_gt, YELLOW))
    return 0


def save_gt_re_mask(output_folder, config, meta, class_idx, out_idx, ori_img,
                    mask, mask_output):
    """Per-class GT/RE/GT+RE trio (val.py:104-114), into per-class dirs."""
    base = os.path.join(output_folder, config["name"], str(class_idx))
    img_id = meta["img_id"][out_idx]
    save_masking_GT(np.array(ori_img[out_idx]), mask, mask_output,
                    os.path.join(base, img_id + "_GT_masking.jpg"))
    save_masking_RE(np.array(ori_img[out_idx]), mask, mask_output,
                    os.path.join(base, img_id + "_RE_masking.jpg"))
    save_masking(np.array(ori_img[out_idx]), mask, mask_output,
                 os.path.join(base, img_id + "_GT_RE_masking.jpg"))
