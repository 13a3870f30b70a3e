"""The int8 tile forward on one CUDA card: tiles/s and device busy ms of the
flagship and SSUNet, calibrated as ``chip_smoke.py`` phases 8 and 12 do.

    python3 tools/torch_int8_time.py [TAG]    # from the root of a checkout

Full-width ``UNet_R_SS_v2`` and ``SSUNet`` with seeded weights, BatchNorm
statistics set from a seeded batch (``chip_smoke.calibrate_batchnorm``;
SSUNet's head centred), ``calibrate_int8`` on the 8 seeded 512² tiles that
it then forwards through ``tile_forward`` at batch 8: tiles/s over 3
rounds of 5 forwards after 2 warm-ups (host clock, synchronized), device
busy ms per forward from
``torch.profiler`` over 3 forwards (``chip_smoke.profile_kernels``), and
the s8 seams kernel 7 read per forward where the tree counts them. The
package and ``chip_smoke.py`` are imported from the working directory, so
the same script times two trees; compare them only inside one call to the
card, in turns (parent, change, change, parent).
"""
import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402
from ssunet_gan_tpu_torch.infer.api import _norm_consts, tile_forward  # noqa: E402
from ssunet_gan_tpu_torch.infer.calibrate import calibrate_int8  # noqa: E402
from ssunet_gan_tpu_torch.models import build_model  # noqa: E402
from ssunet_gan_tpu_torch.ops import stage_kernel_int8 as q8  # noqa: E402

BATCH, HW, WARM, ITERS, ROUNDS = 8, 512, 2, 5, 3


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else "run"
    dev = torch.device("cuda")
    g = np.random.default_rng(0)
    a, b = (t.to(dev) for t in _norm_consts())
    x = torch.from_numpy(g.integers(0, 256, (BATCH, HW, HW, 3), dtype=np.uint8)).to(dev)
    calib = torch.from_numpy(g.integers(0, 256, (2, HW, HW, 3), dtype=np.uint8)).to(dev)
    calib = calib.float() * a + b
    xn = (x.float() * a + b).cpu().numpy()
    for arch in ("UNet_R_SS_v2", "SSUNet"):
        model = build_model(arch, 3, 3, seed=0, device=dev)
        chip_smoke.calibrate_batchnorm(model, calib)
        if arch == "SSUNet":
            chip_smoke.center_head(model, calib)
        calibrate_int8(model, xn, batch_size=BATCH, device=dev)
        q8.set_int8_stage(True)
        try:
            for _ in range(WARM):
                tile_forward(model, x)
            rates = []
            for _ in range(ROUNDS):
                gc.collect()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ITERS):
                    tile_forward(model, x)
                torch.cuda.synchronize()
                rates.append(BATCH * ITERS / (time.perf_counter() - t0))
            reads = [getattr(q8, "up_reads", None), getattr(q8, "pool_reads", None)]
            launches = q8.launches
            tile_forward(model, x)
            reads = [None if r is None else getattr(q8, k) - r
                     for r, k in zip(reads, ("up_reads", "pool_reads"))]
            launches = q8.launches - launches
            gc.collect()
            busy, wall_ms, _ = chip_smoke.profile_kernels(lambda: tile_forward(model, x), 3)
        finally:
            q8.set_int8_stage(False)
            q8.set_int8_calibration(None)
        print("int8 time:", json.dumps(dict(
            tag=tag, model=arch, tiles_per_s=rates, busy_ms=busy, profiled_wall_ms=wall_ms,
            stages_per_forward=launches, s8_seams_per_forward=reads,
            card=chip_smoke.card_line())))
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
