"""Kernel 1's f32 route on one CUDA card: the flagship's six fused stages in
f32 at 512², batch 8, timed beside the stage's plain version and the
``F.conv2d`` f32 convs of the same stage, TF32 off.

    python3 tools/torch_f32_time.py [TAG]    # from the root of a checkout

Each stage signature of ``chip_smoke.stage_signatures`` (the widths of
``configs/config_v1.json``) with seeded weights and BatchNorm statistics,
seeded f32 inputs; per stage the CUDA-event time of ``fused_eval_stage``
(the f32 route: pack once, then launches only) over 5 calls after 2
warm-ups, the plain version's (``fused_stage_reference``) and the same
convs as ``F.conv2d`` calls (main conv over the concatenated parts, the
shortcut, seg, act, γ|β, the head; no modulate), with the card's name and
power limit. The package and ``chip_smoke.py`` are imported from the
working directory, so the same script times two trees; compare them only
inside one call to the card, in turns (parent, change, change, parent).
Prints one JSON line.
"""
import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
from ssunet_gan_tpu_torch.ops import stage_kernel  # noqa: E402
from ssunet_gan_tpu_torch.ops.blocks import BasicBlock  # noqa: E402
from ssunet_gan_tpu_torch.ops.conv import Conv2d  # noqa: E402
from ssunet_gan_tpu_torch.ops.spade import SPADE  # noqa: E402

BATCH, HW, ITERS = 8, 512, 5
FILTERS = (64, 128, 256, 384, 512, 768)


def library_stage(parts, bp, sp, head):
    """The stage's convs as ``F.conv2d`` f32 calls on NCHW views of
    channels-last tensors (each on an input of the right shape)."""
    w1, (s1, _), w2, (s2, _), ws = bp
    wx, _, wm, _, wg, _, wb, _ = sp
    cl = torch.channels_last
    x = torch.cat(parts, -1).permute(0, 3, 1, 2)
    w1 = (w1 * s1[:, None, None, None]).contiguous(memory_format=cl)
    w2 = (w2 * s2[:, None, None, None]).contiguous(memory_format=cl)
    ws = None if ws is None else ws.contiguous(memory_format=cl)
    wx, wm = wx.contiguous(memory_format=cl), wm.contiguous(memory_format=cl)
    wgb = torch.cat([wg, wb]).contiguous(memory_format=cl)
    y = F.conv2d(x, w1, padding=1)
    seg = F.conv2d(y, wx, padding=1)
    act = F.conv2d(seg, wm, padding=1)

    def run():
        h = F.conv2d(x, w1, padding=1)
        o = F.conv2d(h, w2, padding=1)
        if ws is not None:
            o = o + F.conv2d(x, ws)
        F.conv2d(y, wx, padding=1)
        F.conv2d(seg, wm, padding=1)
        F.conv2d(act, wgb, padding=1)
        if head is not None:
            F.conv2d(y, head[0].contiguous(memory_format=cl))
        return o
    return run


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else "run"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    for name, chans, planes, lab, nh, head_cls, level in chip_smoke.stage_signatures(FILTERS, 3, 3):
        block = BasicBlock(sum(chans), planes, generator=gen)
        chip_smoke.random_bn_stats(block, gen)
        block.to(dev).eval()
        spade = SPADE("spadebatch3x3", planes, lab, float(nh), generator=gen).to(dev)
        head = None
        if head_cls:
            final = Conv2d(planes, head_cls, 1, generator=gen).to(dev)
            head = (final.weight, final.bias)
        bp, sp = block.stage_params(), spade.stage_params()
        side = HW >> level
        parts = tuple(torch.randn((BATCH, side, side, c), generator=gen).to(dev) for c in chans)
        with torch.no_grad():
            pk = stage_kernel.pack_stage_f32(chans, bp, sp, head)
            chip_smoke.settle()
            ms = chip_smoke.cuda_ms(lambda: stage_kernel.fused_eval_stage(parts, bp, sp, head, pk),
                                    ITERS)
            plain = chip_smoke.cuda_ms(
                lambda: stage_kernel.fused_stage_reference(parts, bp, sp, head), ITERS)
            lib = chip_smoke.cuda_ms(library_stage(parts, bp, sp, head), ITERS)
        rows.append({"stage": name, "side": side, "ms": ms, "plain_ms": plain, "library_ms": lib})
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib)):
            tot[k] += v
        del parts, block, spade, pk
        torch.cuda.empty_cache()
    print(json.dumps({"tag": tag, "card": chip_smoke.card_line(), "batch": BATCH,
                      "f32_launches": stage_kernel.f32_launches, "stages": rows, **tot}),
          flush=True)


if __name__ == "__main__":
    main()
