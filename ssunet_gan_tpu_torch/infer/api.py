"""Whole-scene inference (reference aerial_image_segmentation_api.py:376-411).

All tiles run through the batched eval forward in fixed chunks of
:data:`INFER_BATCH` (the last chunk zero-padded), sigmoid on the device,
and the masks merge on the device (:func:`data.tiling.merge_patches_device`).

Reference quirks kept as behaviour: ``patch_size`` is 1024 whatever the
model card says (api:330), and tiles are divided by 255 once more after
``Normalize`` (api:362-367) — folded here, with ``Normalize``, into one
per-channel affine applied to uint8 tiles on the device.

With the int8 mode on (:func:`configure_int8`, or
:func:`ops.stage_kernel_int8.set_int8_stage`) the same entry points serve
through the int8 stages, unchanged.

Tile preparation (crop + 1024→512 resize, cv2 or the native tile server),
model loading from a model card and the ground-truth mask branch are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ssunet_gan_tpu_torch import resolve_device
from ssunet_gan_tpu_torch.data.tiling import grid_coords, merge_patches_device
from ssunet_gan_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

INFER_BATCH = 32  # tiles per forward call


def configure_int8(config: Dict, model_dir: Optional[str] = None) -> bool:
    """Apply a model card's ``"int8"`` key (the JAX package's
    ``infer/api.py:80-83, 129-138``): switch the int8 stage mode to it and,
    when it is on and ``model_dir`` holds ``int8_scales.json``
    (:mod:`infer.calibrate`), install those static scales; without the file
    the int8 stages quantize dynamically. A card without the key changes
    nothing. Returns whether the int8 mode is on."""
    from ssunet_gan_tpu_torch.infer.calibrate import load_calibration
    from ssunet_gan_tpu_torch.ops.stage_kernel_int8 import (
        int8_stage_enabled,
        set_int8_calibration,
        set_int8_stage,
    )

    if "int8" in config:
        set_int8_stage(bool(config["int8"]))
        if config["int8"] and model_dir is not None:
            scales = load_calibration(model_dir)
            if scales is not None:
                set_int8_calibration(scales)
                print("=> int8 static calibration installed (%d ranges)" % len(scales))
    return int8_stage_enabled()


def effective_patch_size(h: int, w: int, p_size: int) -> int:
    """Clamp the patch size to the scene's short side (kept even); the
    reference extracts wrong patches from scenes smaller than the patch."""
    eff = min(p_size, h, w)
    if eff != p_size:
        eff -= eff % 2
        print(f"=> scene {h}x{w} smaller than patch {p_size}; using {eff}")
    return eff


def _norm_consts():
    """Normalize + the reference's extra /255 as ``x·a + b`` per channel:
    ``((x − μ·255)/(σ·255))/255``."""
    std = np.asarray(IMAGENET_STD, np.float32) * 255.0
    mean = np.asarray(IMAGENET_MEAN, np.float32) * 255.0
    a = 1.0 / (std * 255.0)
    b = -mean / (std * 255.0)
    return torch.from_numpy(a), torch.from_numpy(b)


def tile_forward(model, x, dtype: Optional[torch.dtype] = None,
                 quantize_probs: bool = False, device="cuda") -> torch.Tensor:
    """One batch of NHWC tiles (tensor or numpy) → sigmoid probabilities
    (NHWC) on ``device``, where the model must be.

    uint8 tiles get the fused normalize affine first; ``dtype`` casts the
    model input. None means ``torch.bfloat16`` on a CUDA device (the served
    configuration, and the only dtype the CUDA kernels take) and keeps the
    incoming dtype (float32 for uint8 tiles) on the CPU. ``quantize_probs``
    returns ``floor(p·255)`` as uint8, the merge's own first step."""
    x = torch.as_tensor(x).to(resolve_device(device))
    if x.dtype == torch.uint8:
        a, b = _norm_consts()
        x = x.float() * a.to(x.device) + b.to(x.device)
    if dtype is None and x.device.type == "cuda":
        dtype = torch.bfloat16
    if dtype is not None:
        x = x.to(dtype)
    with torch.no_grad():
        out = model(x)
    p = torch.sigmoid(out)
    if quantize_probs:
        return torch.floor(p.float() * 255.0).to(torch.uint8)
    return p


def _chunked_forward(model, patches: np.ndarray, dtype=None,
                     device="cuda") -> torch.Tensor:
    """All tiles through :func:`tile_forward` in chunks of INFER_BATCH; the
    last chunk is zero-padded so every call has one shape."""
    dev = resolve_device(device)
    n = len(patches)
    pad = (-n) % INFER_BATCH
    if pad:
        patches = np.concatenate([patches, np.zeros_like(patches[:pad])])
    outs = []
    for i in range(0, len(patches), INFER_BATCH):
        x = torch.from_numpy(np.ascontiguousarray(patches[i:i + INFER_BATCH]))
        outs.append(tile_forward(model, x, dtype, device=dev))
    return torch.cat(outs)[:n]


def segmentation_inference(model, img_input: np.ndarray,
                           img_patch_set: np.ndarray, mask_patch_set,
                           config: Dict, gt_mask_flag: bool,
                           dtype: Optional[torch.dtype] = None,
                           device="cuda"):
    """Batched tile inference + device merge (api:376-411).

    ``img_patch_set`` holds the prepared tiles in :func:`grid_coords` order
    (uint8, or float32 already normalized). The model moves to ``device``;
    ``dtype`` as in :func:`tile_forward` (bf16 on a CUDA device by default).
    Returns (all_class_mask, gt_class_mask): lists of C (H, W) uint8
    masks, on the host."""
    if gt_mask_flag:
        raise NotImplementedError(
            "the ground-truth mask branch needs cv2 and is not ported yet; "
            "see ROADMAP.md"
        )
    dev = resolve_device(device)
    model.to(dev)
    num_classes = config["num_classes"]
    h, w = img_input.shape[0], img_input.shape[1]
    patch_size = effective_patch_size(h, w, config["patch_size"])
    coords = grid_coords(h, w, patch_size, config["patch_overlap"])
    probs = _chunked_forward(model, img_patch_set, dtype, dev)
    merged = merge_patches_device(probs, coords, h, w, patch_size, num_classes,
                                  overlap=config["patch_overlap"]).cpu().numpy()
    masks = [merged[..., c] for c in range(num_classes)]
    return masks, masks
