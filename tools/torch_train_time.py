"""The flagship's v3 train step on one CUDA card: ms/step through
``train_one_epoch`` (the loader's threads beside it) and of the step alone
on one batch, with the host CPU time per step, in three rounds of 5 steps.

    python3 tools/torch_train_time.py [TAG]    # from the repo root

UNet_R_SS_v2 of configs/config_v1.json, seeded weights, batch 8 of
SyntheticDataset(512, 512), Adam, bf16 activations, 3 warm-up steps. The
step is host-bound (`PERF.md` §5), so compare two trees only inside one
call to the card, in turns (parent, change, parent, change).
"""
import gc
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
from ssunet_gan_tpu_torch.config import load_experiment_config  # noqa: E402
from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset  # noqa: E402
from ssunet_gan_tpu_torch.data.loader import BatchLoader  # noqa: E402
from ssunet_gan_tpu_torch.data.transforms import val_transform  # noqa: E402
from ssunet_gan_tpu_torch.models import build_model  # noqa: E402
from ssunet_gan_tpu_torch.ops.losses import get_loss  # noqa: E402
from ssunet_gan_tpu_torch.train.optim import build_optimizer, build_scheduler  # noqa: E402
from ssunet_gan_tpu_torch.train.step import make_train_step  # noqa: E402
from ssunet_gan_tpu_torch.train.supervised import train_one_epoch  # noqa: E402

BATCH, STEPS, ROUNDS = 8, 5, 3


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else "run"
    dev = torch.device("cuda")
    cfg = load_experiment_config("configs/config_v1.json").opt_config
    ncls, in_ch = cfg["num_classes"], cfg["input_channels"]

    def loader(n, seed):
        ds = SyntheticDataset(n * BATCH, 512, 512, ncls, in_ch, transform=val_transform(cfg),
                              seed=seed)
        return BatchLoader(ds, BATCH, shuffle=False, drop_last=True,
                           num_workers=int(cfg["num_workers"]))

    model = build_model(cfg["arch"], ncls, in_ch, cfg["deep_supervision"], seed=0,
                        device=dev).train()
    step = make_train_step(model, get_loss(cfg["loss"]),
                           build_optimizer(model.parameters(), cfg), ncls,
                           cfg["deep_supervision"], clip=float(cfg["clip"]))
    lr = build_scheduler(cfg).lr(0)
    train_one_epoch(0, cfg, loader(3, 1), step, lr, device=dev)
    batches = iter(loader(1, 9))
    _, img, mask, _ = next(batches)
    batches.close()
    xb = torch.from_numpy(img).to(dev).to(torch.bfloat16)
    yb = torch.from_numpy(mask).to(dev)
    for r in range(ROUNDS):
        gc.collect()
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        train_one_epoch(r + 1, cfg, loader(STEPS, 2 + r), step, lr, device=dev)
        torch.cuda.synchronize()
        dt, dc = time.perf_counter() - t0, time.process_time() - c0
        gc.collect()
        torch.cuda.synchronize()
        t1, c1 = time.perf_counter(), time.process_time()
        for _ in range(STEPS):
            step(xb, yb, lr)
        torch.cuda.synchronize()
        st, sc = time.perf_counter() - t1, time.process_time() - c1
        print(f"{tag} round {r}: epoch {dt / STEPS * 1e3:.2f} ms/step (cpu "
              f"{dc / STEPS * 1e3:.1f}); bare step {st / STEPS * 1e3:.2f} ms/step (cpu "
              f"{sc / STEPS * 1e3:.1f}) on {torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()
