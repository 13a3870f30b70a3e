"""Whole-scene inference (reference aerial_image_segmentation_api.py:302-435;
the JAX package's infer/api.py).

A model comes from its card and ``model.pth`` (:func:`load_segmentation_models`).
A scene file is cut into the 4-pass patch grid and each patch resized to
the model's tile (:func:`get_patched_input`: by the C++ tile server
:mod:`native` for uint8 tiles, or the reference's float pipeline). All
tiles run through the batched eval forward in fixed chunks of
:data:`INFER_BATCH` (the last chunk zero-padded), sigmoid on the device,
and the masks merge on the device (:func:`data.tiling.merge_patches_device`),
as do the ground-truth masks of the labels beside the scene
(:func:`segmentation_inference`). :func:`pipelined_scene_forward` overlaps
the tile server, the host-to-device copies and the forward.
:func:`save_image_color_masking` writes the JPEG overlays.

Reference quirks kept as behaviour: ``patch_size`` is 1024 whatever the
model card says (api:330), and tiles are divided by 255 once more after
``Normalize`` (api:362-367) — folded here, with ``Normalize``, into one
per-channel affine applied to uint8 tiles on the device.

With the int8 mode on (:func:`configure_int8`, or
:func:`ops.stage_kernel_int8.set_int8_stage`) the same entry points serve
through the int8 stages, unchanged.

With ``mesh`` (a ``parallel.Mesh``; the JAX package's :313-346, 380-397)
each chunk of tiles, rounded to a multiple of the ranks, splits over them:
each rank forwards its contiguous slice (no collective in the eval
forward), and the probabilities are gathered back in tile order before
the merge, which every rank then runs.

Not read here: the JAX package's orbax checkpoint directories (converted
to ``model.pth`` by ``tools/torch_from_orbax.py``), and scenes other than
PNG where PIL does not import (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from ssunet_gan_tpu_torch import native, resolve_device
from ssunet_gan_tpu_torch.config import load_model_card
from ssunet_gan_tpu_torch.data.png import read_image
from ssunet_gan_tpu_torch.data.tiling import (
    extract_patches,
    grid_coords,
    mask_convert_tensor,
    merge_patches_device,
)
from ssunet_gan_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Compose,
    Normalize,
    Resize,
    resize_linear,
)
from ssunet_gan_tpu_torch.infer.overlays import save_masking, save_masking_GT, save_masking_RE
from ssunet_gan_tpu_torch.ops.collectives import all_gather

INFER_BATCH = 32  # tiles per forward call
PATCH_SIZE = 1024  # the reference's hardcoded scene patch (api:330)


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


def load_model_dir(model_dir: str, config: Dict, device="cuda", generator=None):
    """The model of a card (``config``) with the weights of
    ``<model_dir>/model.pth`` (:func:`train.checkpoint.load_model`:
    ``strict=False``), in eval mode on ``device``. ``generator``: True
    builds :class:`models.gan.Generator` (the GAN generator's checkpoint,
    keys under ``net.``), False the bare arch (``build_model``), None the
    bare arch, retried as ``Generator`` when the file lacks its tensors. A
    directory holding only the JAX package's orbax checkpoint raises
    NotImplementedError, one with no checkpoint FileNotFoundError."""
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.models.gan import Generator
    from ssunet_gan_tpu_torch.train.checkpoint import load_model, model_file

    dev = resolve_device(device)
    path = model_file(model_dir)
    print("=> creating model %s" % config["arch"])
    if generator:
        model = Generator.from_config(config, device=dev)
    else:
        model = build_model(config["arch"], config["num_classes"], config["input_channels"],
                            bool(config["deep_supervision"]), device=dev)
    missing = load_model(path, model)["missing"]
    if missing and generator is None:
        # a GAN generator's checkpoint wraps the arch in ``net``
        model = Generator.from_config(config, device=dev)
        missing = load_model(path, model)["missing"]
        if missing:
            raise ValueError(f"{path} lacks {len(missing)} tensors of {config['arch']} "
                             f"(first: {missing[:3]})")
        print("=> loaded as GAN generator checkpoint")
    elif missing:
        print(f"=> {path} lacks {len(missing)} of the model's tensors (first: {missing[:3]}); "
              "they keep their initial values")
    return model.eval()


def load_segmentation_models(config_file: str, device="cuda"):
    """The ``val_config.name`` model of an experiment file, from its card
    and ``model.pth`` in ``file_path.model_path`` (api:302-332; the JAX
    package's :54-142). Returns ``(model, config)``: the model in eval mode
    on ``device`` (:func:`load_model_dir`, the bare arch or a GAN
    generator's ``net.`` checkpoint), the card with ``name``,
    ``patch_size`` 1024 and ``val_config``'s ``patch_overlap``.

    The card's mode keys are applied as global modes: ``fused_spade``
    (:func:`ops.spade_kernel.set_fused_spade`), ``int8`` with the static
    scales of ``int8_scales.json`` beside it (:func:`configure_int8`) and
    ``band_rows`` (:func:`ops.stage_kernel_int8.set_band_rows`);
    ``seg_stack`` (a TPU layout of the JAX package) is read and ignored."""
    from ssunet_gan_tpu_torch.ops.spade_kernel import set_fused_spade
    from ssunet_gan_tpu_torch.ops.stage_kernel_int8 import set_band_rows

    resolve_device(device)
    with open(config_file, "rt") as f:
        config_dict = json.loads(f.read())
    val_config = config_dict["val_config"]
    name = val_config["name"]
    model_dir = os.path.join(config_dict["file_path"]["model_path"], name)

    config = load_model_card(model_dir)
    config["name"] = name
    print("-" * 20)
    for key in config.keys():
        print("%s: %s" % (key, str(config[key])))
    print("-" * 20)

    if "fused_spade" in config:
        set_fused_spade(bool(config["fused_spade"]))
    configure_int8(config, model_dir)
    if "seg_stack" in config:
        print("=> seg_stack %s ignored: the stacked seg dots are a TPU layout" % config["seg_stack"])
    if "band_rows" in config:
        set_band_rows(int(config["band_rows"]) if config["band_rows"] else None)

    model = load_model_dir(model_dir, config, device)
    config["patch_size"] = PATCH_SIZE
    config["patch_overlap"] = val_config["patch_overlap"]
    return model, config


def effective_patch_size(h: int, w: int, p_size: int) -> int:
    """Clamp the patch size to the scene's short side (kept even); the
    reference extracts wrong patches from scenes smaller than the patch."""
    eff = min(p_size, h, w)
    if eff != p_size:
        eff -= eff % 2
        print(f"=> scene {h}x{w} smaller than patch {p_size}; using {eff}")
    return eff


def patch_and_preprocess(img_input: np.ndarray, mask_input: np.ndarray, config: Dict,
                         raw_uint8: bool = False):
    """Patch an in-memory scene and prepare its tiles (api:349-373).

    Returns (tiles, mask patches). ``raw_uint8``: the tile server's uint8
    tiles at ``(input_h, input_w)`` (crop and resize in one pass; the
    forward applies Normalize and /255 on the device) and its crop of the
    masks. Otherwise the reference's pipeline on a thread pool: each patch
    resized to ``input_w``² (:func:`data.transforms.resize_linear`), then
    ``Resize(input_h, input_w)``, ``Normalize`` and ``/255``, float32."""
    p_size = effective_patch_size(img_input.shape[0], img_input.shape[1],
                                  config["patch_size"])
    coords = grid_coords(img_input.shape[0], img_input.shape[1], p_size,
                         config["patch_overlap"])
    in_h, in_w = config["input_h"], config["input_w"]
    if raw_uint8:
        tiles = native.extract_resize_u8(np.ascontiguousarray(img_input), coords, p_size,
                                         in_h, in_w)
        return tiles, native.extract_u8(np.ascontiguousarray(mask_input), coords, p_size)
    image_patches = extract_patches(img_input, coords, p_size)
    mask_patches = extract_patches(mask_input, coords, p_size)
    val_tf = Compose([Resize(in_h, in_w), Normalize()])
    out = np.empty((len(coords), in_h, in_w, 3), np.float32)

    def prep(idx: int) -> None:
        img = resize_linear(image_patches[idx], in_w, in_w)  # the reference's square resize
        out[idx] = val_tf(image=img)["image"].astype(np.float32) / 255.0

    with ThreadPoolExecutor(max_workers=min(8, max(len(coords), 1))) as pool:
        list(pool.map(prep, range(len(coords))))
    return out, mask_patches


def get_patched_input(img_path: str, config: Dict, gt_mask_flag: bool,
                      raw_uint8: bool = False):
    """Read a scene (BGR, as ``cv2.imread``; :func:`data.png.read_image`)
    and, with ``gt_mask_flag``, its labels from the sibling path with
    ``image`` → ``labels`` (api:336-346); patch and prepare its tiles
    (:func:`patch_and_preprocess`). Returns (scene, tiles, mask patches);
    without labels the masks are the scene's own patches."""
    img_input = read_image(img_path)
    mask_input = read_image(img_path.replace("image", "labels")) if gt_mask_flag else img_input
    out, mask_patches = patch_and_preprocess(img_input, mask_input, config,
                                             raw_uint8=raw_uint8)
    return img_input, out, mask_patches


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
    if isinstance(out, (list, tuple)):  # deep supervision: the last head
        out = out[-1]
    p = torch.sigmoid(out)
    if quantize_probs:
        return torch.floor(p.float() * 255.0).to(torch.uint8)
    return p


def _chunking(mesh):
    """(tiles per chunk, this rank's tiles in each, its first): INFER_BATCH
    on one process; under a mesh rounded to a multiple of its ranks
    (api:384), each rank taking a contiguous slice."""
    if mesh is None:
        return INFER_BATCH, INFER_BATCH, 0
    chunk = max(INFER_BATCH // mesh.size * mesh.size, mesh.size)
    per = chunk // mesh.size
    return chunk, per, mesh.rank * per


def _gathered(mesh, local: torch.Tensor, per: int, n: int) -> torch.Tensor:
    """The ranks' slices of every chunk (this rank's ``local``: chunks ×
    ``per`` tiles) back in tile order, the first ``n`` tiles."""
    if mesh is None or mesh.group is None:
        return local[:n]
    every = all_gather(local, mesh.group)  # (ranks, chunks·per, ...)
    every = every.view(mesh.size, -1, per, *local.shape[1:]).transpose(0, 1)
    return every.reshape(-1, *local.shape[1:])[:n]


def _chunked_forward(model, patches: np.ndarray, dtype=None, device="cuda",
                     quantize_probs: bool = False, mesh=None) -> torch.Tensor:
    """All tiles through :func:`tile_forward` in chunks of INFER_BATCH (under
    ``mesh`` this rank's slice of each); the last chunk is zero-padded so
    every call has one shape."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    chunk, per, first = _chunking(mesh)
    n = len(patches)
    pad = (-n) % chunk
    if pad:
        patches = np.concatenate([patches, np.zeros((pad, *patches.shape[1:]), patches.dtype)])
    outs = []
    for i in range(first, len(patches), chunk):
        x = torch.from_numpy(np.ascontiguousarray(patches[i:i + per]))
        outs.append(tile_forward(model, x, dtype, quantize_probs, device=dev))
    return _gathered(mesh, torch.cat(outs), per, n)


def pipelined_scene_forward(model, scene: np.ndarray, config: Dict, dtype=None,
                            quantize_probs: bool = False, device="cuda", mesh=None):
    """Whole-scene tile forward with tile preparation, host-to-device copy
    and forward overlapped (the JAX package's :401-457).

    Chunks of INFER_BATCH uint8 tiles are cut by the tile server on two
    worker threads, into pinned host buffers on a CUDA device; each chunk
    is copied on a side stream, and the forward (Normalize and /255 on the
    device, then :func:`tile_forward`) waits on the copy's event. On the
    CPU the same steps run without streams or pinning. Under ``mesh`` each
    rank cuts and forwards its slice of every chunk, and the probabilities
    are gathered. Returns (probs, coords, p_size) for
    :func:`data.tiling.merge_patches_device`."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    model.to(dev)
    p_size = effective_patch_size(scene.shape[0], scene.shape[1], config["patch_size"])
    coords = grid_coords(scene.shape[0], scene.shape[1], p_size, config["patch_overlap"])
    in_h, in_w = config["input_h"], config["input_w"]
    n = len(coords)
    chunk, per, first = _chunking(mesh)
    n_pad = max(-(-n // chunk), 1) * chunk
    cuda = dev.type == "cuda"
    scene_c = np.ascontiguousarray(scene)

    def prep(i0: int) -> torch.Tensor:
        buf = torch.empty((per, in_h, in_w, scene.shape[2]), dtype=torch.uint8,
                          pin_memory=cuda)
        m = max(min(per, n - i0), 0)
        native.extract_resize_u8(scene_c, coords[i0:i0 + m], p_size, in_h, in_w,
                                 out=buf.numpy()[:m])
        buf[m:] = 0
        return buf

    copies = torch.cuda.Stream(dev) if cuda else None
    outs = []
    with ThreadPoolExecutor(max_workers=2) as pool:
        for fut in [pool.submit(prep, i0) for i0 in range(first, n_pad, chunk)]:
            x = fut.result()
            if cuda:
                with torch.cuda.stream(copies):
                    x = x.to(dev, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(copies)
                torch.cuda.current_stream(dev).wait_event(done)
                # the forward's stream uses a block the copy stream allocated
                x.record_stream(torch.cuda.current_stream(dev))
            outs.append(tile_forward(model, x, dtype, quantize_probs, device=dev))
    return _gathered(mesh, torch.cat(outs), per, n), coords, p_size


def segmentation_inference(model, img_input: np.ndarray,
                           img_patch_set: np.ndarray, mask_patch_set,
                           config: Dict, gt_mask_flag: bool,
                           dtype: Optional[torch.dtype] = None,
                           device="cuda", mesh=None):
    """Batched tile inference + device merge (api:376-411).

    ``img_patch_set`` holds the prepared tiles in :func:`grid_coords` order
    (uint8, or float32 already normalized). The model moves to ``device``;
    ``dtype`` as in :func:`tile_forward` (bf16 on a CUDA device by default).
    With ``gt_mask_flag`` the BGR label patches ``mask_patch_set`` (full
    patch size) become per-class masks at the tile size
    (:func:`data.tiling.mask_convert_tensor`, on ``device``), /255, merged
    as the predictions are. Returns (all_class_mask, gt_class_mask): lists
    of C (H, W) uint8 masks, on the host; without ground truth both are
    the predictions. ``mesh`` shards the tiles over its ranks (on the
    mesh's device), and every rank returns the masks."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    model.to(dev)
    num_classes = config["num_classes"]
    h, w = img_input.shape[0], img_input.shape[1]
    patch_size = effective_patch_size(h, w, config["patch_size"])
    coords = grid_coords(h, w, patch_size, config["patch_overlap"])
    probs = _chunked_forward(model, img_patch_set, dtype, dev, mesh=mesh)
    merged = merge_patches_device(probs, coords, h, w, patch_size, num_classes,
                                  overlap=config["patch_overlap"]).cpu().numpy()
    masks = [merged[..., c] for c in range(num_classes)]
    if not gt_mask_flag:
        return masks, masks
    gt = gt_probs(mask_patch_set, num_classes, config["input_w"], dev)
    gt_merged = merge_patches_device(gt, coords, h, w, patch_size, num_classes,
                                     overlap=config["patch_overlap"]).cpu().numpy()
    return masks, [gt_merged[..., c] for c in range(num_classes)]


def gt_probs(mask_patch_set, num_classes: int, infer_size: int, device) -> torch.Tensor:
    """(N, infer_size, infer_size, C) float32 {0, 1} on ``device``: class
    c's :func:`data.tiling.mask_convert` of each BGR label patch, /255
    (api:400-405), INFER_BATCH patches at a time."""
    out = []
    for i in range(0, len(mask_patch_set), INFER_BATCH):
        chunk = torch.from_numpy(np.ascontiguousarray(
            np.asarray(mask_patch_set[i:i + INFER_BATCH]))).to(device)
        out.append(torch.stack([mask_convert_tensor(chunk, c, infer_size)
                                for c in range(num_classes)], -1).float() / 255.0)
    return torch.cat(out)


def save_image_color_masking(output_folder, image_name, full_img, all_class_mask,
                             gt_class_mask, config: Dict, gt_mask_flag: bool):
    """The overlay JPEGs of classes 1.. into ``<output_folder>/<name>/``
    (api:413-435): ``<image>_<c>_GT_masking.jpg`` (ground truth, yellow),
    ``_RE_masking.jpg`` (prediction, pink) and ``_GT_RE_masking.jpg``
    (both); without ground truth the RE file only."""
    out_dir = os.path.join(output_folder, config["name"])
    os.makedirs(out_dir, exist_ok=True)
    for c in range(1, config["num_classes"]):
        file_name = os.path.join(out_dir, "{:s}_{:d}".format(image_name, c))
        mask_output = all_class_mask[c]
        mask_gt = gt_class_mask[c] if gt_mask_flag else mask_output
        if gt_mask_flag:
            save_masking_GT(np.array(full_img).copy(), mask_gt, mask_output,
                            file_name + "_GT_masking.jpg")
        save_masking_RE(np.array(full_img).copy(), mask_output, mask_output,
                        file_name + "_RE_masking.jpg")
        if gt_mask_flag:
            save_masking(np.array(full_img).copy(), mask_gt, mask_output,
                         file_name + "_GT_RE_masking.jpg")
    return 0
