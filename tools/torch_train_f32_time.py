"""The f32 train kernels per flagship step, and the f32 train step's
ms/step, on one CUDA card, for the port in the tree this runs from or the
one given with ``--root``:

    python3 tools/torch_train_f32_time.py [--root DIR] [--tag TAG]

UNet_R_SS_v2 of configs/config_v1.json, seeded weights, batch 8 of
SyntheticDataset(512, 512), Adam, f32 activations (mixed_precision False),
cuDNN's TF32 off. One steady-state v3 step's calls are recorded: its 12
``conv_stats`` (row 2f) and 35 ``fused_conv3`` calls (row 5f), each timed
through its wrapper and summed per mode, with each mode's worst relative
L2 distance from the same conv summed in f64 (``chip_smoke.py``
``conv_f64_errors`` of this tool's tree: the chains in f32, as the plain
versions; the plain f32 version's beside it), and its 30
``fused_wgrad`` calls (row 6f); then one v2 step's 30 ``wgrad`` calls (row
4f) (CUDA events, 3 runs after 1 warm-up); then the f32 v3 step, in three
rounds of 5 steps: through ``train_one_epoch`` (the loader beside it) and
bare, on one batch. Only the wrappers' public names are used, so a parent
tree (unpacked with ``git archive``) runs it too: compare two trees only
inside one call to the card, in turns (parent, change, change, parent).
"""
import argparse
import importlib.util
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

BATCH, HW, WARM, STEPS, ROUNDS = 8, 512, 2, 5, 3


def smoke_module():
    """``chip_smoke.py`` of this tool's own tree (its f64 yardstick), which
    imports the port from ``sys.path``: the tree given with ``--root``."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.getcwd())
    ap.add_argument("--tag", default="run")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smoke = smoke_module()
    from ssunet_gan_tpu_torch.config import load_experiment_config
    from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset
    from ssunet_gan_tpu_torch.data.loader import BatchLoader
    from ssunet_gan_tpu_torch.data.transforms import val_transform
    from ssunet_gan_tpu_torch.models import build_model
    from ssunet_gan_tpu_torch.ops import stage_kernel_train as tst
    from ssunet_gan_tpu_torch.ops import train_bwd as ttb
    from ssunet_gan_tpu_torch.ops.losses import get_loss
    from ssunet_gan_tpu_torch.train.optim import build_optimizer, build_scheduler
    from ssunet_gan_tpu_torch.train.step import make_train_step
    from ssunet_gan_tpu_torch.train.supervised import train_one_epoch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    tag = f"{args.tag} ({root})"
    cfg = load_experiment_config(os.path.join(root, "configs", "config_v1.json")).opt_config
    cfg32 = dict(cfg, mixed_precision=False)
    ncls, in_ch = cfg["num_classes"], cfg["input_channels"]

    def loader(n, seed):
        ds = SyntheticDataset(n * BATCH, HW, HW, ncls, in_ch, transform=val_transform(cfg32),
                              seed=seed)
        return BatchLoader(ds, BATCH, shuffle=False, drop_last=True,
                           num_workers=int(cfg32["num_workers"]))

    model = build_model(cfg["arch"], ncls, in_ch, cfg["deep_supervision"], seed=0,
                        device=dev).train()
    step = make_train_step(model, get_loss(cfg["loss"]), build_optimizer(model.parameters(), cfg),
                           ncls, cfg["deep_supervision"], clip=float(cfg["clip"]))
    lr = build_scheduler(cfg).lr(0)
    train_one_epoch(0, cfg32, loader(WARM, 1), step, lr, device=dev)
    it = iter(loader(1, 9))
    _, img, mask, _ = next(it)
    it.close()
    xb, yb = torch.from_numpy(img).to(dev), torch.from_numpy(mask).to(dev)

    def ms(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    def recorded(module, name, v3):
        calls, fn = [], getattr(module, name)

        def rec(*a, **k):
            calls.append((a, k))
            return fn(*a, **k)

        before = tst._TRAIN_BWD_V3
        tst.set_train_bwd_v3(v3)
        setattr(module, name, rec)
        try:
            step(xb, yb, lr)
            torch.cuda.synchronize()
        finally:
            setattr(module, name, fn)
            tst.set_train_bwd_v3(before)
        return fn, calls

    for module, name, row in ((tst, "conv_stats", "2f"), (ttb, "fused_conv3", "5f")):
        fn, calls = recorded(module, name, True)
        per_mode = defaultdict(lambda: [0, 0.0, 0.0, 0.0])
        for a, k in calls:
            if name == "fused_conv3":
                mode = a[0]
            elif (a[3] if len(a) > 3 else k.get("prologue")) is not None:
                mode = "conv2"
            else:
                mode = "conv1"
            m = per_mode[mode]
            m[0] += 1
            m[1] += ms(lambda: fn(*a, **k))
            kernel, plain = smoke.conv_f64_errors(name, a, k)
            m[2], m[3] = max(m[2], kernel), max(m[3], plain)
        del calls
        torch.cuda.empty_cache()
        print(f"{tag}: {name} f32 (row {row}), {sum(m[0] for m in per_mode.values())} calls of "
              f"one v3 step: {sum(m[1] for m in per_mode.values()):.3f} ms; "
              + ", ".join(f"{md} ({m[0]}) {m[1]:.3f}" for md, m in sorted(per_mode.items()))
              + f" on {card}", flush=True)
        print(f"{tag}: {name} f32 (row {row}), worst rel L2 from an f64 sum per mode, kernel / "
              f"plain f32: " + ", ".join(f"{md} {m[2]:.3g} / {m[3]:.3g}"
                                         for md, m in sorted(per_mode.items())), flush=True)
    fn, calls = recorded(ttb, "fused_wgrad", True)
    per_mode = defaultdict(float)
    for a, k in calls:
        per_mode[a[0]] += ms(lambda: fn(*a, **k))
    print(f"{tag}: fused_wgrad f32 (row 6f), {len(calls)} calls of one v3 step: "
          f"{sum(per_mode.values()):.3f} ms; "
          + ", ".join(f"{m} {v:.3f}" for m, v in sorted(per_mode.items())) + f" on {card}",
          flush=True)
    fn, calls = recorded(tst, "wgrad", False)
    total = sum(ms(lambda: fn(*a, **k)) for a, k in calls)
    print(f"{tag}: wgrad f32 (row 4f), {len(calls)} calls of one v2 step: {total:.3f} ms on {card}",
          flush=True)
    del calls
    torch.cuda.empty_cache()
    for r in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_one_epoch(r + 1, cfg32, loader(STEPS, 2 + r), step, lr, device=dev)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / STEPS * 1e3
        t1 = time.perf_counter()
        for _ in range(STEPS):
            step(xb, yb, lr)
        torch.cuda.synchronize()
        bare = (time.perf_counter() - t1) / STEPS * 1e3
        print(f"{tag}: f32 v3 train step round {r}: epoch {dt:.2f} ms/step, bare step "
              f"{bare:.2f} ms/step (batch {BATCH}, {HW}², {STEPS} steps) on {card}", flush=True)


if __name__ == "__main__":
    main()
