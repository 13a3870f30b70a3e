"""Sliding-window tiling: the reference's 4-pass patch grid and the
coverage-averaged merge (patch_gen, dataset.py:147-220; patch_merge,
api:119-217), with the merge on the device, and the ground-truth labels'
per-class masks (mask_convert, api:220-236; its resize is
:func:`data.transforms.resize_linear`, ``cv2.resize``'s fixed point).

Merge semantics (the JAX package's ``merge_patches_device``): per-patch
probabilities are floor-quantized to uint8 (the reference's truncating
cast), resized in→patch size with half-pixel bilinear weights and rounded
like cv2's uint8 output, binarized at >127, summed into a canvas with a
coverage count, averaged, and re-binarized with ``floor(avg·255) > 127``.
Every value on the way is a small integer or a multiple of 1/16, so the
f32 arithmetic is exact and the result is bit-equal to the JAX merge.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ssunet_gan_tpu_torch.data.transforms import _linear_taps, resize_linear
from ssunet_gan_tpu_torch.ops.resize import _linear_matrix

# label colour (BGR) of each class in the reference's scene labels
LABEL_COLOURS = {0: (255, 255, 255), 1: (255, 0, 0), 2: (0, 0, 255)}


def grid_coords(img_h: int, img_w: int, p_size: int, overlap: float = 0.5) -> np.ndarray:
    """(N, 2) array of (y, x) patch origins in reference pass order
    (patch_gen, dataset.py:147-220): TL, BR, BL, TR anchored grids."""
    if not 0 <= overlap < 1:
        # the reference divides by zero at overlap=1 (dataset.py:150-152)
        raise ValueError(f"overlap must be in [0, 1), got {overlap}")
    step, i_w, i_h = _grid_geometry(img_h, img_w, p_size, overlap)
    coords: List[Tuple[int, int]] = []
    for i in range(i_w):  # pass 1: top-left anchored
        for j in range(i_h):
            coords.append((j * step, i * step))
    for i in range(i_w):  # pass 2: bottom-right anchored
        for j in range(i_h):
            coords.append((img_h - j * step - p_size, img_w - i * step - p_size))
    for i in range(i_w):  # pass 3: bottom-left
        for j in range(i_h):
            coords.append((img_h - j * step - p_size, i * step))
    for i in range(i_w):  # pass 4: top-right
        for j in range(i_h):
            coords.append((j * step, img_w - i * step - p_size))
    arr = np.asarray(coords, np.int32).reshape(-1, 2)
    if (len(arr) == 0 or (arr < 0).any() or (arr[:, 0] + p_size > img_h).any()
            or (arr[:, 1] + p_size > img_w).any()):
        raise ValueError(
            f"scene {img_h}x{img_w} smaller than patch {p_size} (or bad overlap)"
        )
    return arr


def _grid_geometry(img_h: int, img_w: int, p_size: int, overlap: float):
    step = int(math.ceil((1 - overlap) * p_size))
    i_w = int(math.floor((img_w - p_size) / step)) + 1
    i_h = int(math.floor((img_h - p_size) / step)) + 1
    return step, i_w, i_h


def extract_patches(img: np.ndarray, coords: np.ndarray, p_size: int) -> np.ndarray:
    """Host gather of (N, p, p, C) patches from an HWC scene."""
    out = np.empty((len(coords), p_size, p_size, img.shape[2]), img.dtype)
    for k, (y, x) in enumerate(coords):
        out[k] = img[y:y + p_size, x:x + p_size]
    return out


def patch_gen(img: np.ndarray, mask: np.ndarray, p_size: int, overlap: float = 0.5):
    """The reference's API: (image patches, mask patches) as lists, in
    :func:`grid_coords` order (patch_gen, dataset.py:147-220)."""
    coords = grid_coords(img.shape[0], img.shape[1], p_size, overlap)
    return (list(extract_patches(img, coords, p_size)),
            list(extract_patches(mask, coords, p_size)))


def post_process_resized_mask(resized_mask: np.ndarray) -> np.ndarray:
    """uint8 {0..255} → {0, 255} at threshold 127 (api:33-42)."""
    out = resized_mask.copy()
    out[(out > 127) & (out < 255)] = 255
    out[(out > 0) & (out <= 127)] = 0
    return out


def mask_convert(p_mask: np.ndarray, idx: int, p_size: int) -> np.ndarray:
    """A BGR label patch → class ``idx``'s binary mask resized to
    ``p_size``² (api:220-236): (255,255,255) class 0, (255,0,0) class 1,
    (0,0,255) class 2; other classes take class 0's colour."""
    b, g, r = LABEL_COLOURS.get(idx, LABEL_COLOURS[0])
    hit = (p_mask[:, :, 0] == b) & (p_mask[:, :, 1] == g) & (p_mask[:, :, 2] == r)
    mask = np.where(hit, 255, 0).astype(np.uint8)
    return post_process_resized_mask(resize_linear(mask, p_size, p_size))


def resize_linear_tensor(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """:func:`data.transforms.resize_linear` of (N, H, W) uint8 images on
    their device: the same integer steps in int32, so the result is the
    same bit for bit on every device."""
    y0, y1, b0, b1 = (torch.as_tensor(t, device=x.device) for t in _linear_taps(height, x.shape[1]))
    x0, x1, a0, a1 = (torch.as_tensor(t, device=x.device) for t in _linear_taps(width, x.shape[2]))
    b0, b1, a0, a1 = (t.to(torch.int32) for t in (b0, b1, a0, a1))
    v = x.to(torch.int32)
    rows = (v[:, :, x0] * a0 + v[:, :, x1] * a1) >> 4
    out = (((rows[:, y0] * b0[:, None]) >> 16) + ((rows[:, y1] * b1[:, None]) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


def mask_convert_tensor(p_masks: torch.Tensor, idx: int, p_size: int) -> torch.Tensor:
    """:func:`mask_convert` of (N, p, p, 3) BGR label patches at once, on
    their device: (N, p_size, p_size) uint8, equal to the per-patch
    function bit for bit."""
    b, g, r = LABEL_COLOURS.get(idx, LABEL_COLOURS[0])
    hit = (p_masks[..., 0] == b) & (p_masks[..., 1] == g) & (p_masks[..., 2] == r)
    resized = resize_linear_tensor(hit.to(torch.uint8) * 255, p_size, p_size)
    return torch.where(resized > 127, 255, 0).to(torch.uint8)


def _binarize(probs: torch.Tensor, p_size: int) -> torch.Tensor:
    """(N, in, in, C) probs or uint8 → (N, p, p, C) f32 {0, 1} masks."""
    if probs.dtype == torch.uint8:  # pre-quantized by the forward
        q = probs.float()
    else:
        q = torch.floor(probs.float() * 255.0)
    rm = torch.as_tensor(_linear_matrix(int(probs.shape[1]), p_size, False),
                         device=q.device)
    q = torch.einsum("ph,nhwc->npwc", rm, q)
    q = torch.round(torch.einsum("qw,npwc->npqc", rm, q))
    return (q > 127.0).float()


def _finish(canvas: torch.Tensor, cover: torch.Tensor) -> torch.Tensor:
    cover = torch.where(cover == 0, torch.ones_like(cover), cover)
    final = torch.floor(canvas / cover * 255.0) > 127.0
    return final.to(torch.uint8) * 255


def _merge_general(binary, coords, scene_h, scene_w):
    """Per-patch accumulation (any coordinates)."""
    n, p, _, c = binary.shape
    canvas = binary.new_zeros((scene_h, scene_w, c))
    cover = binary.new_zeros((scene_h, scene_w, 1))
    for k, (y, x) in enumerate(np.asarray(coords)):
        canvas[y:y + p, x:x + p] += binary[k]
        cover[y:y + p, x:x + p] += 1.0
    return _finish(canvas, cover)


def _merge_grid(binary, scene_h, scene_w, step, i_w, i_h):
    """O(canvas) overlap-add for the structured 4-pass grid: each pass is a
    regular lattice (stride ``step``, patch ``p`` with ``p % step == 0``),
    so it reduces to q² statically-shifted block adds of its q×q subtiles
    (q = p/step); passes 2-4 are pass 1 flipped and edge-anchored."""
    n, p, _, c = binary.shape
    q = p // step
    oy_br = scene_h - p - (i_h - 1) * step
    ox_br = scene_w - p - (i_w - 1) * step

    def overlap_add(block):  # (i_w, i_h, p, p, c') i-major pass
        cc = block.shape[-1]
        x = block.permute(1, 0, 2, 3, 4).reshape(i_h, i_w, q, step, q, step, cc)
        rows, cols = i_h + q - 1, i_w + q - 1
        acc = block.new_zeros((rows, cols, step, step, cc))
        for a in range(q):
            for b in range(q):
                acc[a:a + i_h, b:b + i_w] += x[:, :, a, :, b, :, :]
        return acc.permute(0, 2, 1, 3, 4).reshape(rows * step, cols * step, cc)

    # pass → (flipped axes of the (i_w, i_h) lattice, origin)
    specs = [((), 0, 0), ((0, 1), oy_br, ox_br), ((1,), oy_br, 0), ((0,), 0, ox_br)]
    passes = binary.reshape(4, i_w, i_h, p, p, c)
    ones = binary.new_ones((i_w, i_h, p, p, 1))
    canvas = binary.new_zeros((scene_h, scene_w, c))
    cover = binary.new_zeros((scene_h, scene_w, 1))
    for k, (flip, oy, ox) in enumerate(specs):
        blk = passes[k].flip(flip) if flip else passes[k]
        add = overlap_add(blk)
        canvas[oy:oy + add.shape[0], ox:ox + add.shape[1]] += add
        add = overlap_add(ones)
        cover[oy:oy + add.shape[0], ox:ox + add.shape[1]] += add
    return _finish(canvas, cover)


def merge_patches_device(probs: torch.Tensor, coords: np.ndarray, scene_h: int,
                         scene_w: int, p_size: int, num_classes: int,
                         overlap: Optional[float] = None) -> torch.Tensor:
    """Merge (N, in, in, C) tile probabilities (f32/bf16 or uint8) on their
    device into the (H, W, C) uint8 {0, 255} scene mask.

    With ``overlap`` given and ``p_size`` divisible by the grid step (and N
    the grid's tile count), the overlap-add path runs; otherwise the
    general per-patch path."""
    if probs.shape[-1] != num_classes:
        raise ValueError(f"probs have {probs.shape[-1]} classes, expected {num_classes}")
    binary = _binarize(probs, p_size)
    if overlap is not None:
        step, i_w, i_h = _grid_geometry(scene_h, scene_w, p_size, overlap)
        if p_size % step == 0 and len(probs) == 4 * i_w * i_h:
            return _merge_grid(binary, scene_h, scene_w, step, i_w, i_h)
    return _merge_general(binary, coords, scene_h, scene_w)


def patch_merge(img: np.ndarray, masks, p_size: int, config: dict,
                p_overlap: float) -> List[np.ndarray]:
    """The reference's API (api:119-217): ``masks`` a list of (C, h, w)
    probability arrays in :func:`grid_coords` order; returns C (H, W) uint8
    masks, merged on the CPU."""
    coords = grid_coords(img.shape[0], img.shape[1], p_size, p_overlap)
    probs = np.stack([np.transpose(np.asarray(m), (1, 2, 0)) for m in masks])
    merged = merge_patches_device(torch.from_numpy(np.ascontiguousarray(probs)), coords,
                                  img.shape[0], img.shape[1], p_size, config["num_classes"],
                                  overlap=p_overlap).numpy()
    return [merged[..., c] for c in range(config["num_classes"])]
