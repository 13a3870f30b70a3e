"""The multi-card entry path on the CPU: ``torchrun --nproc-per-node 2 -m
ssunet_gan_tpu_torch.cli.train --config <file> --device cpu``, whose
``main`` starts the process group from ``torchrun``'s environment through
``parallel.initialize_multihost`` (gloo on the CPU; NCCL and the card of
``LOCAL_RANK`` on cards) and trains one epoch of a tiny SSUNet on a tree of
PNG files over the 2-rank data mesh.

The train split's augmentations draw from an unseeded generator, so the
run is not compared with one process here (``test_torch_parallel_train.py``
does that through ``run_experiment(mesh=)``); this test holds the launch:
both ranks exit 0 within the time limit, the mesh spans 2 gloo ranks,
only rank 0 prints and writes, and the epoch's log row is finite.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np

from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset
from ssunet_gan_tpu_torch.data.png import write_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = (("training", 4), ("validation", 2), ("test", 2))
SMALL = dict(arch="SSUNet", input_h=32, input_w=32, batch_size=2, num_workers=1,
             mixed_precision="False", name="tiny_ssunet", epochs=1, optimizer="SGD", lr=0.01,
             dataset="pngs", val_dataset="pngs")
LAUNCH_TIMEOUT = 120  # seconds: a rank that hangs fails the test instead of holding the suite


def _png_tree(root, ncls, in_ch, size=32):
    """The reference's directory layout of seeded synthetic PNGs."""
    for k, (split, n) in enumerate(SPLITS):
        ds = SyntheticDataset(n, size, size, ncls, in_ch, seed=100 + k)
        for i in range(n):
            img, _, mask, _ = ds[i]
            img_dir = os.path.join(root, "pngs", "images", split)
            os.makedirs(img_dir, exist_ok=True)
            write_image(os.path.join(img_dir, f"{i:04d}.png"), img)
            for c in range(ncls):
                d = os.path.join(root, "pngs", "annotations", split, str(c))
                os.makedirs(d, exist_ok=True)
                write_image(os.path.join(d, f"{i:04d}.png"),
                            (mask[..., c] * 255).astype(np.uint8))


def test_torchrun_launches_the_trainer_over_two_ranks(tmp_path):
    with open(os.path.join(ROOT, "configs", "config_v1.json")) as f:
        raw = json.load(f)
    raw["file_path"] = {k: str(tmp_path / d) for k, d in (
        ("input_path", "inputs"), ("model_path", "models"), ("output_path", "outputs"),
        ("checkpoint_path", "checkpoint"))}
    raw["opt_config"].update(SMALL)
    opt = raw["opt_config"]
    _png_tree(raw["file_path"]["input_path"], opt["num_classes"], opt["input_channels"])
    config = tmp_path / "config.json"
    config.write_text(json.dumps(raw))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "ssunet_gan_tpu_torch.cli.train", "--config", str(config), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines.count("=> data mesh: gloo group of 2 ranks, rank 0 on cpu") == 1, lines
    assert sum(ln.startswith("=> creating model SSUNet") for ln in lines) == 1, lines
    assert sum(" Epoch [0/1]" in ln for ln in lines) == 1, lines
    model_dir = tmp_path / "models" / "tiny_ssunet"
    with open(model_dir / "log.csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "lr", "loss", "iou", "dice", "val_loss", "val_iou", "val_dice"]
    assert len(rows) == 2 and np.isfinite(np.asarray(rows[1], np.float64)).all(), rows
    assert {"config.yml", "log.csv", "train_state.pth", "train_meta.json"} <= set(
        os.listdir(model_dir))
