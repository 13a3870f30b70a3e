"""``python -m ssunet_gan_tpu_torch.cli.train --config <file> [--device cuda]``
— the supervised trainer (reference scripts/train.py)."""

from ssunet_gan_tpu_torch.train.supervised import main

if __name__ == "__main__":
    main()
