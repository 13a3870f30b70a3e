"""``python -m ssunet_gan_tpu_torch.cli.train_seg_gan --config <file> [--device cuda]``
— the adversarial fine-tuner (reference scripts/train_seg_gan.py)."""

from ssunet_gan_tpu_torch.train.gan import main

if __name__ == "__main__":
    main()
