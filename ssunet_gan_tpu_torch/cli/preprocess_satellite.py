"""Tile aerial colour-label scenes into training patches (the JAX
package's cli/preprocess_satellite.py; reference preprocess_satellite.py):

    python -m ssunet_gan_tpu_torch.cli.preprocess_satellite \
        --input-root ../inputs --image-name chicago --img-size 512

Non-overlapping 512 patches, 3 colour-coded classes, the 80/10/10 scene
split of seed 41 (:mod:`data.preprocess`); runs on the host, without cv2
or sklearn.
"""

from __future__ import annotations

import argparse

from ssunet_gan_tpu_torch.data.preprocess import preprocess_color_label_scenes


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tile colour-label scenes into patches")
    p.add_argument("--input-root", default="../inputs")
    p.add_argument("--image-name", default="chicago")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--patch-size", type=int, default=512)
    p.add_argument("--num-class", type=int, default=3)
    p.add_argument("--stride-frac", type=float, default=1.0,
                   help="stride as a fraction of patch size (1.0 = no overlap)")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    out = preprocess_color_label_scenes(
        args.input_root, args.image_name, args.img_size, args.patch_size,
        args.num_class, args.stride_frac,
    )
    print("wrote", out)
    return out


if __name__ == "__main__":
    main()
