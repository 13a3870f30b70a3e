"""chip_smoke.py's phase-6 step-1 bars on 8 batches, and their power.

    python3 tools/torch_step1_bars.py [--out FILE]   # repo root, one CUDA card

(``--device cpu --size 64 --batches 2`` rehearses the control flow on the
CPU, where the train kernels' wrappers run their plain versions.)

Step 1 of the flagship trainer (UNet_R_SS_v2 of configs/config_v1.json,
seeded weights, batch 8 of SyntheticDataset(512, 512) with seeds 1-8;
chip_smoke.py's batches are the first STEP1_BATCHES of them) with the train
kernels, with their plain versions (bf16) and with the f32 module
composition. The kernel run is repeated with each of three planted defects,
applied by wrapping one train kernel's wrapper while the run lasts:

  x2map_bias_zeroed   conv1_0's x2map bias gradient (fused_conv3 "seg"'s
                      first stat row) set to 0
  conv2_tap_dropped   one corner tap (0, 0) of conv0_1's conv2 weight
                      gradient (fused_wgrad "conv2") set to 0
  conv1_scaled_1.05   conv0_1's conv1 weight gradient (fused_wgrad "conv1")
                      times 1.05

For the correct kernels and each defect it prints which bars held: the
one-batch bars chip_smoke.py held before on each batch, and the pooled
bars (``chip_smoke.step1_bars``) on the STEP1_BATCHES consecutive batches
starting at each batch (cyclically). How often the correct kernels fail is
the bars' false-failure rate; a defect that holds is one they cannot see.
``--out`` writes every per-batch sum (``chip_smoke.step1_sums``) as JSON.
"""
import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from ssunet_gan_tpu_torch.config import load_experiment_config  # noqa: E402
from ssunet_gan_tpu_torch.data.dataset import SyntheticDataset  # noqa: E402
from ssunet_gan_tpu_torch.data.loader import BatchLoader  # noqa: E402
from ssunet_gan_tpu_torch.data.transforms import val_transform  # noqa: E402
from ssunet_gan_tpu_torch.models import build_model, ssunet  # noqa: E402
from ssunet_gan_tpu_torch.ops.losses import get_loss  # noqa: E402

# the fused stages in the order the backward reaches them
BACKWARD_ORDER = ("conv0_1", "conv1_1", "conv2_1", "conv2_0", "conv1_0", "conv0_0")


def _zero_first_row(out):
    g_seg, sums = out
    sums = sums.clone()
    sums[0] = 0
    return g_seg, sums


def _drop_corner_tap(dw):
    dw = dw.clone()
    dw[:, :, 0, 0] = 0
    return dw


# name: (wrapper, call mode, stage, edit of the wrapper's result)
DEFECTS = {
    "x2map_bias_zeroed": ("fused_conv3", "seg", "conv1_0", _zero_first_row),
    "conv2_tap_dropped": ("fused_wgrad", "conv2", "conv0_1", _drop_corner_tap),
    "conv1_scaled_1.05": ("fused_wgrad", "conv1", "conv0_1", lambda dw: dw * 1.05),
}


@contextlib.contextmanager
def planted(name):
    """The kernel wrapper of defect ``name`` edits its result at one stage."""
    kernel, mode, stage, edit = DEFECTS[name]
    mod = cs.kernel_module(kernel)
    orig = getattr(mod, kernel)
    seen = [0]

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        if cs._arg(args, kwargs, 0, "mode") == mode:
            at = BACKWARD_ORDER[seen[0] % len(BACKWARD_ORDER)]
            seen[0] += 1
            if at == stage:
                out = edit(out)
        return out

    with cs.patched(mod, kernel, wrapped):
        yield
    assert seen[0] == len(BACKWARD_ORDER), f"{name}: {seen[0]} {mode} calls in one step"


def verdict(rows, bad):
    return "; ".join(f"{w} {'held' if ok else 'FAILED'}" for w, *_, ok in rows[:2]) + (
        f"; single gradients failing: {', '.join(bad)}" if bad else "; single gradients held")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="JSON file for the per-batch sums")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512, help="tile side")
    ap.add_argument("--batches", type=int, default=8)
    args = ap.parse_args()
    n_batches, side = args.batches, args.size
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device(args.device)
    print(cs.card_line() if dev.type == "cuda" else "no card: a CPU rehearsal")
    cfg = load_experiment_config("configs/config_v1.json").opt_config
    cfg = dict(cfg, input_h=side, input_w=side)
    ncls, in_ch = cfg["num_classes"], cfg["input_channels"]
    model = build_model(cfg["arch"], ncls, in_ch, cfg["deep_supervision"], seed=cs.SEED,
                        device=dev).train()
    loss_fn = get_loss(cfg["loss"])
    names = [n for n, _ in model.named_parameters()]
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    fused = ssunet.spade_stage
    runs = {"correct": []} | {d: [] for d in DEFECTS}
    for seed in range(1, n_batches + 1):
        ds = SyntheticDataset(8, side, side, ncls, in_ch, transform=val_transform(cfg), seed=seed)
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

        with cs.plain_train_kernels():
            p = grads(torch.bfloat16, fused)
        f = grads(torch.float32, cs.module_stage)
        runs["correct"].append(cs.step1_sums(grads(torch.bfloat16, fused), p, f))
        for d in DEFECTS:
            with planted(d):
                runs[d].append(cs.step1_sums(grads(torch.bfloat16, fused), p, f))
        del p, f
    model.load_state_dict(snap)

    b = cs.STEP1_BATCHES
    summary = {}
    for run, sums in runs.items():
        old = [cs.step1_bars(sums[i:i + 1], names, pooled=False) for i in range(n_batches)]
        new = [cs.step1_bars([sums[(i + j) % n_batches] for j in range(b)], names)
               for i in range(n_batches)]
        for i, ((ok_o, rows_o, bad_o), (ok_n, rows_n, bad_n)) in enumerate(zip(old, new)):
            print(f"{run} batch {i + 1}: one-batch bars {'held' if ok_o else 'FAILED'} "
                  f"({verdict(rows_o, bad_o)}); pooled bars on batches "
                  f"{[(i + j) % n_batches + 1 for j in range(b)]} "
                  f"{'held' if ok_n else 'FAILED'} ({verdict(rows_n, bad_n)})")
            lo, ln = rows_o[0], rows_n[0]
            print(f"{run} batch {i + 1}: loss e_k/e_p/e_kp one batch {lo[1]:.3e}/{lo[2]:.3e}/"
                  f"{lo[3]:.3e}, pooled {ln[1]:.3e}/{ln[2]:.3e}/{ln[3]:.3e}")
        summary[run] = (sum(r[0] for r in old), sum(r[0] for r in new))
    # each single gradient's pooled distances over all eight batches: how
    # far from plain a defect must take it before the bar sees it
    tot = np.sum(runs["correct"], 0)
    ratios = []
    for i, n in enumerate(names):
        kp2, pf2, _, p2, f2 = tot[1 + i, :5]
        e_p, e_kp = np.sqrt(pf2 / max(f2, 1e-300)), np.sqrt(kp2 / max(p2, 1e-300))
        ratios.append((e_kp / max(e_p, 1e-300), n, e_p, e_kp))
    ratios.sort(reverse=True)
    print("largest pooled e_kp/e_p over all batches (correct kernels): " + ", ".join(
        f"{n} {r:.3f} (e_p {e_p:.3e})" for r, n, e_p, _ in ratios[:8]))
    for run, (n_old, n_new) in summary.items():
        print(f"step-1 bars, {run}: one-batch bars held on {n_old} of {n_batches} batches; "
              f"pooled bars ({b} batches) held on {n_new} of {n_batches} windows")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"card": cs.card_line() if dev.type == "cuda" else "cpu", "names": names,
                       "columns": ["kp2", "pf2", "kf2", "p2", "f2", "finite", "kp_p", "pf_f", "numel"],
                       "runs": {r: np.asarray(s).tolist() for r, s in runs.items()}}, fh)
    print(f"wall {time.perf_counter() - t_start:.1f} s")


if __name__ == "__main__":
    main()
