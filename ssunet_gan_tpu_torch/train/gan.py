"""The adversarial fine-tuner (the JAX package's train/gan.py; the
reference's train_seg_gan.py):

    python -m ssunet_gan_tpu_torch.cli.train_seg_gan --config configs/config_v1.json [--device cpu]

:func:`run_gan_experiment` writes the model card, rebuilds the generator
from the supervised model's card (``generator_name``; without one, from the
config itself), warm-starts its ``net`` from that model's ``model.pth``
(:func:`warm_start`), builds the SRGAN discriminator at the trainer's width
(``num_classes`` in, k 3, 64 channels, 8 blocks, fc 1024), and trains both
with Adam at ``gan_lr`` through :mod:`train.gan_step`. After each epoch it
evaluates the generator on the val and test splits, rewrites ``log.csv``
(the JAX package's columns; its ``lr`` column holds ``config["lr"]``, a
kept quirk), keeps the best generator by **test** IoU in ``model.pth``
(train_seg_gan.py:528-530), and writes both networks' full train state
(parameters, BatchNorm and spectral buffers, Adam moments) to
``generator_state/`` and ``discriminator_state/``. ``resume`` restarts
after the saved epoch from both; early stopping and TensorBoard (where
``tensorboardX`` imports) as in the supervised trainer.

With ``mesh`` (train/gan.py:121-202) the loop is data-parallel as the
supervised trainer's: the batch size rounded to a multiple of the ranks,
each rank loading its slice of every global batch, both networks starting
from rank 0's weights, the step's gradients averaged before the clamp
(``train/gan_step.py``; G's fused train stages run under the mesh, and the
card key ``fused_train_dp`` is accepted and changes nothing), every rank
evaluating the whole splits and taking rank 0's readings, and only rank 0
writing files.
"""

from __future__ import annotations

import argparse
import os
from collections import OrderedDict
from typing import Optional

import torch

from ssunet_gan_tpu_torch import resolve_device
from ssunet_gan_tpu_torch.config import (
    ExperimentConfig,
    dump_model_card,
    load_experiment_config,
    load_model_card,
)
from ssunet_gan_tpu_torch.data.loader import BatchLoader
from ssunet_gan_tpu_torch.train import checkpoint as ckpt
from ssunet_gan_tpu_torch.train.supervised import (
    LOG_COLUMNS,
    _quiet,
    _tensorboard_writer,
    _write_log,
    build_datasets,
    evaluate,
    launched_mesh,
    save_tensorboard,
    train_one_epoch,
)

# the discriminator the trainer builds (train/gan.py:116-119)
D_KERNEL, D_CHANNELS, D_BLOCKS, D_FC = 3, 64, 8, 1024


def warm_start(cfg: ExperimentConfig, g_config, generator) -> Optional[dict]:
    """Load the supervised model's ``model.pth`` into ``generator.net``
    (models_seg_gan.py:216-233); returns the report, or None where the
    model directory has no checkpoint (the generator then trains from its
    init). A directory with only the JAX package's orbax checkpoint
    raises."""
    gen_dir = cfg.model_dir(g_config["name"])
    try:
        report = ckpt.warm_start_generator(generator, gen_dir)
    except FileNotFoundError:
        print("=> no supervised checkpoint found; generator trains from scratch")
        return None
    print(f"=> warm start from {os.path.join(gen_dir, ckpt.MODEL_FILE)}: "
          f"{len(report['loaded'])} tensors, missing {report['missing']}, "
          f"unmatched {report['unmatched']}")
    return report


def run_gan_experiment(cfg: ExperimentConfig, synthetic: Optional[int] = None,
                       epochs_override: Optional[int] = None, mesh=None,
                       use_tensorboard: bool = True, device="cuda"):
    """The GAN experiment loop on ``device`` (under ``mesh``, the mesh's);
    returns ``(generator, discriminator, best_iou, log)`` with ``log`` the
    columns of ``log.csv``."""
    from ssunet_gan_tpu_torch.models.gan import Discriminator, Generator
    from ssunet_gan_tpu_torch.ops.losses import get_loss
    from ssunet_gan_tpu_torch.ops.spade_kernel import set_fused_spade
    from ssunet_gan_tpu_torch.train.gan_step import make_gan_train_step
    from ssunet_gan_tpu_torch.train.optim import adam
    from ssunet_gan_tpu_torch.train.step import make_eval_step
    from ssunet_gan_tpu_torch.parallel import replicate
    from ssunet_gan_tpu_torch.utils import count_params, seed_everything

    config = cfg.opt_config
    dev = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0  # the rank that writes files and prints
    echo = print if lead else _quiet
    checkpoint_folder = cfg.file_path.checkpoint_path
    model_dir = cfg.model_dir()
    writer = None
    if lead:
        os.makedirs(model_dir, exist_ok=True)
        os.makedirs(checkpoint_folder, exist_ok=True)
        dump_model_card(config, model_dir)
        if use_tensorboard:
            writer = _tensorboard_writer(os.path.join(checkpoint_folder, config["name"]))
    if "fused_spade" in config:
        set_fused_spade(bool(config["fused_spade"]))

    # the generator from the supervised model's card (train_seg_gan.py:445-448)
    generator_name = config["generator_name"]
    g_dir = cfg.model_dir(generator_name)
    if os.path.exists(os.path.join(g_dir, "config.yml")):
        g_config = dict(load_model_card(g_dir), name=generator_name)
    else:
        g_config = dict(config, name=generator_name)
    seed = seed_everything()
    generator = Generator.from_config(g_config, device=dev, seed=seed)
    warm_start(cfg, g_config, generator)
    discriminator = Discriminator(config["num_classes"], D_KERNEL, D_CHANNELS, D_BLOCKS, D_FC,
                                  generator=torch.Generator().manual_seed(seed + 1)).to(dev)
    if mesh is not None:
        replicate(mesh, generator)
        replicate(mesh, discriminator)
    gan_lr = float(config["gan_lr"])
    opt_g, opt_d = adam(generator.parameters()), adam(discriminator.parameters())
    echo("=> GAN: generator %s (%d params), discriminator (%d params)"
          % (g_config["arch"], count_params(generator), count_params(discriminator)))

    seg_loss_fn = get_loss(config["loss"])
    gan_step = make_gan_train_step(generator, discriminator, seg_loss_fn, opt_g, opt_d,
                                   config["num_classes"], mesh=mesh)
    eval_step = make_eval_step(generator, seg_loss_fn, config["num_classes"])

    train_ds, val_ds, test_ds = build_datasets(cfg, synthetic)
    num_workers = int(config.get("num_workers", 3))
    n_data = 1 if mesh is None else mesh.size
    batch_size = max(config["batch_size"] // n_data * n_data, n_data)
    train_loader = BatchLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                               num_workers=num_workers,
                               shard=(0, 1) if mesh is None else (mesh.rank, mesh.size))
    val_loader = BatchLoader(val_ds, 1, num_workers=num_workers)
    test_loader = BatchLoader(test_ds, 1, num_workers=num_workers)

    log = OrderedDict((k, []) for k in LOG_COLUMNS)
    best_iou = best_dice = iou_at_best_dice = 0.0
    trigger = 0
    epochs = epochs_override if epochs_override is not None else config["epochs"]

    # resume (the reference GAN trainer has none): both networks' full state
    start_epoch = 0
    g_state_dir = os.path.join(model_dir, "generator_state")
    d_state_dir = os.path.join(model_dir, "discriminator_state")
    if (config.get("resume") and ckpt.has_train_state(g_state_dir)
            and ckpt.has_train_state(d_state_dir)):
        meta = ckpt.restore_train_state(g_state_dir, generator, opt_g)
        ckpt.restore_train_state(d_state_dir, discriminator, opt_d)
        start_epoch = int(meta.get("epoch", -1)) + 1
        best_iou = float(meta.get("best_iou", 0.0))
        echo(f"=> resumed GAN from epoch {start_epoch} (best_iou {best_iou:.4f})")

    for epoch in range(start_epoch, epochs):
        echo("Epoch [%d/%d]" % (epoch, epochs))
        echo("generator learning rate {:d}: {:f}".format(epoch, gan_lr))
        train_log = train_one_epoch(epoch, config, train_loader, gan_step, gan_lr, dev, mesh)
        val_log = evaluate(config, val_loader, eval_step, dev, mesh)
        test_log = evaluate(config, test_loader, eval_step, dev, mesh)

        if best_dice < test_log["dice"]:
            best_dice, iou_at_best_dice = test_log["dice"], test_log["iou"]
        echo("loss %.4f - iou %.4f - dice %.4f - val_loss %.4f - val_iou %.4f - "
             "val_dice %.4f - test_iou %.4f - test_dice %.4f - Best_dice %.4f - "
             "iou_AtBestDice %.4f (%.1f img/s; d_loss %.4f, adv %.4f)"
             % (train_log["loss"], train_log["iou"], train_log["dice"], val_log["loss"],
                val_log["iou"], val_log["dice"], test_log["iou"], test_log["dice"],
                best_dice, iou_at_best_dice, train_log["images_per_sec"],
                train_log["d_loss"], train_log["adv_loss"]))
        save_tensorboard(writer, train_log, val_log, test_log, epoch)

        for k, v in zip(LOG_COLUMNS, (epoch, config["lr"], train_log["loss"], train_log["iou"],
                                      train_log["dice"], val_log["loss"], val_log["iou"],
                                      val_log["dice"])):
            log[k].append(v)
        if lead:
            _write_log(os.path.join(model_dir, "log.csv"), log)
        trigger += 1

        # the best generator by test IoU (train_seg_gan.py:528-530)
        if test_log["iou"] > best_iou:
            if lead:
                ckpt.save_model(model_dir, generator)
            best_iou = test_log["iou"]
            echo("=> saved best model")
            trigger = 0
        if lead:
            ckpt.save_train_state(g_state_dir, generator, opt_g, epoch, {"best_iou": best_iou})
            ckpt.save_train_state(d_state_dir, discriminator, opt_d, epoch)

        if config.get("early_stopping", -1) >= 0 and trigger >= config["early_stopping"]:
            echo("=> early stopping")
            break

    if writer is not None:
        writer.close()
    return generator, discriminator, best_iou, log


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="adversarial segmentation fine-tuner")
    parser.add_argument("--config", required=True, help="config file")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    mesh = launched_mesh(args.device)
    try:
        run_gan_experiment(load_experiment_config(args.config), device=args.device, mesh=mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
