"""The supervised trainer (the JAX package's train/supervised.py; the
reference's train.py):

    python -m ssunet_gan_tpu_torch.cli.train --config configs/config_v1.json [--device cpu]

:func:`run_experiment` reads the 3-section config, writes the model card
``<model_path>/<name>/config.yml``, builds the model, optimizer, scheduler
and step, trains epoch by epoch on the file-backed splits (or synthetic
scenes) and after each epoch evaluates the val and test splits, steps the
plateau scheduler on the val loss, rewrites ``log.csv`` (the JAX package's
columns, through the ``csv`` module), keeps the best model by val IoU in
``model.pth`` and the resume state in ``train_state.pth`` +
``train_meta.json`` (:mod:`train.checkpoint`), writes TensorBoard scalars
where ``tensorboardX`` imports, and stops early as configured. With
``resume`` it restarts after the saved epoch; ``profile_epoch`` traces that
epoch with ``torch.profiler`` into ``<checkpoint_path>/<name>/profile``.

The host keeps at most two steps in flight before it waits for the card
(supervised.py:135-136), and reads the metrics once per epoch.

With ``mesh`` (``parallel.make_mesh``; supervised.py:115-150, 197-250) the
loop is data-parallel: the batch size is rounded to a multiple of the
ranks × ``accum_steps``, each rank loads only its slice of every global
batch from the one shuffled order, the model starts from rank 0's weights,
and the step averages the gradients (``train/step.py``; the fused train
stages run under the mesh as in one process, so the card key
``fused_train_dp``, which picks the JAX package's ``shard_map`` step, is
accepted and changes nothing). Every rank evaluates the whole val and test
splits, as the JAX package's replicated evaluation, and takes rank 0's
readings, so the plateau schedule, the best model and early stopping
decide alike on every rank; only rank 0 writes the card, ``log.csv``,
checkpoints and TensorBoard. Over several cards:

    torchrun --nproc-per-node N -m ssunet_gan_tpu_torch.cli.train --config <file>

(``main`` starts the process group through ``parallel.initialize_multihost``
when ``torchrun`` has set ``WORLD_SIZE``.)
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from ssunet_gan_tpu_torch import resolve_device
from ssunet_gan_tpu_torch.config import ExperimentConfig, dump_model_card, load_experiment_config
from ssunet_gan_tpu_torch.data.dataset import (
    SegmentationDataset,
    SyntheticDataset,
    list_split_ids,
)
from ssunet_gan_tpu_torch.data.loader import BatchLoader
from ssunet_gan_tpu_torch.data.transforms import train_transform, val_transform
from ssunet_gan_tpu_torch.train import checkpoint as ckpt


def _epoch_mean(metric_list: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The per-epoch means of on-device metric dicts, synced once."""
    if not metric_list:
        return {"loss": 0.0, "iou": 0.0, "dice": 0.0}
    return {k: float(torch.stack([m[k].float() for m in metric_list]).mean().cpu())
            for k in metric_list[0]}


def _mark_step(events: List, device: torch.device) -> None:
    """Record the end of the step just queued and wait for the end of the
    one before it: at most two steps in flight."""
    if device.type != "cuda":
        return
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    events.append(ev)
    if len(events) >= 2:
        events[-2].synchronize()


def train_one_epoch(epoch: int, config: Dict, loader, train_step, lr: float,
                    device="cuda", mesh=None):
    """One pass over ``loader`` (batches of ``(ori, img, mask, meta)``,
    numpy NHWC; under ``mesh`` this rank's slices) through ``train_step``;
    images in bf16 when ``config["mixed_precision"]``. Returns the epoch's
    mean metrics and ``images_per_sec`` (of the global batches)."""
    device = resolve_device(device)
    meters, events = [], []
    n_images = 0
    img_dtype = torch.bfloat16 if config.get("mixed_precision") else torch.float32
    t0 = time.time()
    for _, img, mask, _ in loader:
        x = torch.from_numpy(img).to(device).to(img_dtype)
        y = torch.from_numpy(mask).to(device)
        meters.append(train_step(x, y, lr))
        n_images += img.shape[0] * (1 if mesh is None else mesh.size)
        _mark_step(events, device)
    log = _epoch_mean(meters)
    log["images_per_sec"] = n_images / max(time.time() - t0, 1e-9)
    return log


def evaluate(config: Dict, loader, eval_step, device="cuda", mesh=None) -> Dict[str, float]:
    """Mean metrics of ``eval_step`` over ``loader``, the images in the
    loader's dtype as the JAX package passes them (f32: on the card the
    fused stages then take kernel 1's f32 route, as the JAX package runs
    its stage kernel in f32). ``config`` is accepted for the JAX
    signature. Under ``mesh`` every rank returns rank 0's reading (one
    broadcast), so that the decisions taken on it agree."""
    device = resolve_device(device)
    meters, events = [], []
    for _, img, mask, _ in loader:
        x = torch.from_numpy(img).to(device)
        meters.append(eval_step(x, torch.from_numpy(mask).to(device)))
        _mark_step(events, device)
    log = _epoch_mean(meters)
    if mesh is not None:
        from ssunet_gan_tpu_torch.parallel import replicate

        values = torch.tensor(list(log.values()), dtype=torch.float64, device=mesh.device)
        log = dict(zip(log, replicate(mesh, [values])[0].tolist()))
    return log


LOG_COLUMNS = ("epoch", "lr", "loss", "iou", "dice", "val_loss", "val_iou", "val_dice")


def save_tensorboard(writer, train_log, val_log, test_log, epoch) -> None:
    """9 scalars per epoch (train.py:44-53)."""
    if writer is None:
        return
    for split, log in (("train", train_log), ("val", val_log), ("test", test_log)):
        writer.add_scalar(f"loss/{split}_loss", log["loss"], epoch)
        writer.add_scalar(f"iou/{split}_iou", log["iou"], epoch)
        writer.add_scalar(f"dice/{split}_dice", log["dice"], epoch)


def build_datasets(cfg: ExperimentConfig, synthetic: Optional[int] = None):
    """The train / val / test datasets of the reference's directory layout
    (train.py:356-385), the train split through :func:`train_transform`;
    ``synthetic=N`` gives N seeded synthetic train scenes and N // 4 each
    for val and test instead."""
    config = cfg.opt_config
    if synthetic:
        def make(n, tf, seed):
            return SyntheticDataset(n, config["input_h"], config["input_w"],
                                    config["num_classes"], config["input_channels"],
                                    transform=tf, seed=seed)

        return (make(synthetic, train_transform(config), 1),
                make(max(synthetic // 4, 1), val_transform(config), 2),
                make(max(synthetic // 4, 1), val_transform(config), 3))
    root = cfg.file_path.input_path
    sets = []
    for split, key, tf in (("training", "dataset", train_transform(config)),
                           ("validation", "val_dataset", val_transform(config)),
                           ("test", "val_dataset", val_transform(config))):
        name = config[key]
        sets.append(SegmentationDataset(
            img_ids=list_split_ids(root, name, split, config["img_ext"]),
            img_dir=os.path.join(root, name, "images", split),
            mask_dir=os.path.join(root, name, "annotations", split),
            img_ext=config["img_ext"], mask_ext=config["mask_ext"],
            num_classes=config["num_classes"], input_channels=config["input_channels"],
            transform=tf))
    return tuple(sets)


def _quiet(*args, **kwargs) -> None:
    """``print`` on the ranks after the first."""


def _tensorboard_writer(logdir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:  # TensorBoard is optional, as in the JAX package
        return None
    return SummaryWriter(logdir=logdir)


def _write_log(path: str, log: Dict[str, list]) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(LOG_COLUMNS)
        w.writerows(zip(*(log[k] for k in LOG_COLUMNS)))


def run_experiment(cfg: ExperimentConfig, synthetic: Optional[int] = None,
                   epochs_override: Optional[int] = None, mesh=None,
                   use_tensorboard: bool = True, device="cuda"):
    """The full experiment loop on ``device`` (under ``mesh``, the mesh's);
    returns ``(model, best_iou, log)`` with ``log`` the columns of
    ``log.csv``."""
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.ops.blocks import set_remat
    from ssunet_gan_tpu_torch.ops.losses import get_loss
    from ssunet_gan_tpu_torch.ops.spade_kernel import set_fused_spade
    from ssunet_gan_tpu_torch.train.optim import build_optimizer, build_scheduler
    from ssunet_gan_tpu_torch.train.step import make_eval_step, make_train_step
    from ssunet_gan_tpu_torch.parallel import replicate
    from ssunet_gan_tpu_torch.utils import count_params, seed_everything

    dev = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0  # the rank that writes files and prints
    echo = print if lead else _quiet
    config = cfg.opt_config
    checkpoint_folder = cfg.file_path.checkpoint_path
    model_dir = cfg.model_dir()
    writer = None
    if lead:
        os.makedirs(model_dir, exist_ok=True)
        os.makedirs(checkpoint_folder, exist_ok=True)
        if use_tensorboard:
            writer = _tensorboard_writer(os.path.join(checkpoint_folder, config["name"]))
        dump_model_card(config, model_dir)

    echo("-" * 20)
    for key in config:
        echo("%s: %s" % (key, config[key]))
    echo("-" * 20)

    loss_fn = get_loss(config["loss"])
    if config.get("remat"):
        set_remat(True)
    if "fused_spade" in config:
        set_fused_spade(bool(config["fused_spade"]))  # True: "fast", as in JAX
    model = build_model(config["arch"], config["num_classes"], config["input_channels"],
                        config["deep_supervision"], seed=seed_everything(), device=dev)
    if mesh is not None:
        replicate(mesh, model)
    optimizer = build_optimizer(model.parameters(), config)
    echo("=> creating model %s (%d params)" % (config["arch"], count_params(model)))
    scheduler = build_scheduler(config)
    accum_steps = int(config.get("accum_steps", 1) or 1)
    train_step = make_train_step(model, loss_fn, optimizer, config["num_classes"],
                                 config["deep_supervision"],
                                 clip=float(config.get("clip", 0.0) or 0.0),
                                 accum_steps=accum_steps, mesh=mesh)
    eval_step = make_eval_step(model, loss_fn, config["num_classes"],
                               config["deep_supervision"])

    train_ds, val_ds, test_ds = build_datasets(cfg, synthetic)
    # each microbatch must itself divide over the ranks
    n_data = 1 if mesh is None else mesh.size
    quantum = n_data * accum_steps
    batch_size = max(config["batch_size"] // quantum * quantum, quantum)
    num_workers = int(config.get("num_workers", 3))
    train_loader = BatchLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                               num_workers=num_workers,
                               shard=(0, 1) if mesh is None else (mesh.rank, mesh.size))
    val_loader = BatchLoader(val_ds, 1, num_workers=num_workers)
    test_loader = BatchLoader(test_ds, 1, num_workers=num_workers)

    start_epoch, best_iou = 0, 0.0
    if config.get("resume") and ckpt.has_train_state(model_dir):
        meta = ckpt.restore_train_state(model_dir, model, optimizer)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_iou = float(meta.get("best_iou", 0.0))
        echo(f"=> resumed from epoch {start_epoch} (best_iou {best_iou:.4f})")

    log = OrderedDict((k, []) for k in LOG_COLUMNS)
    trigger = 0
    best_dice = iou_at_best_dice = 0.0
    epochs = epochs_override if epochs_override is not None else config["epochs"]
    profile_epoch = config.get("profile_epoch", -1)

    for epoch in range(start_epoch, epochs):
        echo("{:s} Epoch [{:d}/{:d}]".format(config["arch"], epoch, epochs))
        lr = scheduler.lr(epoch)
        echo("learning rate {:d}: {:f}".format(epoch, lr))
        if epoch == profile_epoch and lead:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda"
                                             else [])
            trace_dir = os.path.join(checkpoint_folder, config["name"], "profile")
            with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(trace_dir)):
                train_log = train_one_epoch(epoch, config, train_loader, train_step, lr, dev,
                                            mesh)
        else:
            train_log = train_one_epoch(epoch, config, train_loader, train_step, lr, dev, mesh)
        val_log = evaluate(config, val_loader, eval_step, dev, mesh)
        scheduler.step_plateau(val_log["loss"])
        test_log = evaluate(config, test_loader, eval_step, dev, mesh)

        if best_dice < test_log["dice"]:
            best_dice, iou_at_best_dice = test_log["dice"], test_log["iou"]
        echo("loss %.4f - iou %.4f - dice %.4f - val_loss %.4f - val_iou %.4f - "
             "val_dice %.4f - test_iou %.4f - test_dice %.4f - Best_dice %.4f - "
             "iou_AtBestDice %.4f (%.1f img/s)"
             % (train_log["loss"], train_log["iou"], train_log["dice"], val_log["loss"],
                val_log["iou"], val_log["dice"], test_log["iou"], test_log["dice"],
                best_dice, iou_at_best_dice, train_log["images_per_sec"]))
        save_tensorboard(writer, train_log, val_log, test_log, epoch)

        for k, v in zip(LOG_COLUMNS, (epoch, lr, train_log["loss"], train_log["iou"],
                                      train_log["dice"], val_log["loss"], val_log["iou"],
                                      val_log["dice"])):
            log[k].append(v)
        if lead:
            _write_log(os.path.join(model_dir, "log.csv"), log)

        trigger += 1
        if val_log["iou"] > best_iou:
            if lead:
                ckpt.save_model(model_dir, model)
            best_iou = val_log["iou"]
            echo("=> saved best model")
            trigger = 0
        if lead:
            ckpt.save_train_state(model_dir, model, optimizer, epoch, {"best_iou": best_iou})

        if config.get("early_stopping", -1) >= 0 and trigger >= config["early_stopping"]:
            echo("=> early stopping")
            break

    if writer is not None:
        writer.close()
    return model, best_iou, log


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="supervised segmentation trainer")
    parser.add_argument("--config", default=None, required=True, help="config file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    return parser.parse_args(argv)


def launched_mesh(device):
    """The data mesh of a ``torchrun`` launch (``WORLD_SIZE`` set):
    ``parallel.initialize_multihost`` on ``device``; None otherwise."""
    if "WORLD_SIZE" not in os.environ:
        return None
    from ssunet_gan_tpu_torch.parallel import initialize_multihost

    mesh = initialize_multihost(device=device)
    if mesh.rank == 0:
        print(f"=> data mesh: {torch.distributed.get_backend(mesh.group)} group of "
              f"{mesh.size} ranks, rank 0 on {mesh.device}")
    return mesh


def main(argv=None) -> None:
    args = parse_args(argv)
    mesh = launched_mesh(args.device)
    try:
        run_experiment(load_experiment_config(args.config), device=args.device, mesh=mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
