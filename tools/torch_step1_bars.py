"""chip_smoke.py's phase-6 step-1 bars on 8 batches instead of one.

    python3 tools/torch_step1_bars.py      # from the repo root, on one CUDA card

Step 1 of the flagship trainer (UNet_R_SS_v2 of configs/config_v1.json,
seeded weights, batch 8 of SyntheticDataset(512, 512) with seeds 1-8; seed 1
is chip_smoke.py's batch) with the train kernels, with their plain versions
(bf16) and with the f32 module composition, held to chip_smoke.py's bars:
the loss (kernel-f32 <= NOISE_RATIO x plain-f32, kernel-plain <= plain-f32),
each parameter gradient (kernel-plain <= GRAD_KP x plain-f32) and all of
them as one vector. Prints, per batch, which bars held: how often two
correct bf16 paths fall outside them is the bars' false-failure rate.
"""
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from ssunet_gan_tpu_torch.config import load_experiment_config  # noqa: E402
from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset  # noqa: E402
from ssunet_gan_tpu_torch.data.loader import BatchLoader  # noqa: E402
from ssunet_gan_tpu_torch.data.transforms import val_transform  # noqa: E402
from ssunet_gan_tpu_torch.models import build_model, ssunet  # noqa: E402
from ssunet_gan_tpu_torch.ops.losses import get_loss  # noqa: E402


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = load_experiment_config("configs/config_v1.json").opt_config
    ncls, in_ch = cfg["num_classes"], cfg["input_channels"]
    model = build_model(cfg["arch"], ncls, in_ch, cfg["deep_supervision"], seed=cs.SEED,
                        device=dev).train()
    loss_fn = get_loss(cfg["loss"])
    names = [n for n, _ in model.named_parameters()]
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    fused = ssunet.spade_stage
    n_ok = 0
    for seed in range(1, 9):
        ds = SyntheticDataset(8, 512, 512, ncls, in_ch, transform=val_transform(cfg), seed=seed)
        _, img, mask, _ = next(iter(BatchLoader(ds, 8, shuffle=False, drop_last=True,
                                                num_workers=2)))
        x, y = torch.from_numpy(img).to(dev), torch.from_numpy(mask).to(dev)

        def grads(dtype, stage):
            model.load_state_dict(snap)
            model.zero_grad(set_to_none=True)
            with cs.spade_stages_as(stage):
                out = model(x.to(dtype))
                loss = loss_fn(torch.where(torch.isnan(out), torch.zeros_like(out), out), y)
                loss.backward()
            res = [loss.detach()] + [p.grad.detach().clone() for p in model.parameters()]
            model.zero_grad(set_to_none=True)
            return res

        k = grads(torch.bfloat16, fused)
        with cs.plain_train_kernels():
            p = grads(torch.bfloat16, fused)
        f = grads(torch.float32, cs.module_stage)
        e = lambda a, b: cs.rel_l2(a, b)
        loss_ok = e(k[0], f[0]) <= cs.NOISE_RATIO * e(p[0], f[0]) and e(k[0], p[0]) <= e(p[0], f[0])
        bad = [n for n, a, b, c in zip(names, k[1:], p[1:], f[1:])
               if not (bool(torch.isfinite(a.float()).all()) and e(a, b) <= cs.GRAD_KP * e(b, c))]
        flat = lambda ts: torch.cat([t.float().reshape(-1) for t in ts])
        K, P, F_ = flat(k[1:]), flat(p[1:]), flat(f[1:])
        all_ok = e(K, F_) <= cs.NOISE_RATIO * e(P, F_) and e(K, P) <= e(P, F_)
        ok = loss_ok and not bad and all_ok
        n_ok += ok
        print(f"seed {seed}: loss (k-p)/p {(k[0].item() - p[0].item()) / p[0].item():+.3e} "
              f"k-f {e(k[0], f[0]):.3e} p-f {e(p[0], f[0]):.3e} {'ok' if loss_ok else 'FAIL'}; "
              f"all params {'ok' if all_ok else 'FAIL'}; single gradients failing: "
              f"{', '.join(bad) or 'none'}")
        del k, p, f
    print(f"step-1 bars all held on {n_ok} of 8 batches")


if __name__ == "__main__":
    main()
