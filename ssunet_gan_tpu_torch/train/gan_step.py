"""The adversarial G/D train step (the JAX package's train/gan_step.py;
reference train_seg_gan.py:167-233).

G phase: g_out = G(image), NaN scrubbed; perceptual = seg loss + α·MSE(g_out,
target) + β·BCE(D(g_out), 1) with α 1e-4, β 1e-3; the gradients reach G
through D with D's parameters held constant. D phase: BCE(D(target), 1) +
BCE(D(g_out), 0) on the pre-update generator output, at D's pre-update
parameters; D sees the target in the image's dtype. Every gradient is
clamped to ±0.8 (the reference's ``clip_gradient``, srgan_utils.py:186-195;
the gradients, not the weights as in the supervised step), then both Adams
step at the step's ``lr``. D's BatchNorm running statistics move three
times per step, in the reference's order: D(g_out), D(target), D(g_out).

Two formulations of the same gradients, chosen by :func:`set_joint_gan`
(default joint, as in the JAX package):

- **alternating** (:177): the G phase backward with D's forward on g_out
  (update 1), then D(target) (update 2) and D(g_out.detach()) (update 3)
  and the D phase backward;
- **joint** (:98): one fake forward of D serves both the adversarial term
  (its backward into G only: ``backward(inputs=G's parameters)``) and the
  fake BCE (into D only: ``backward(inputs=D's parameters)``), so D runs
  twice instead of three times. Train-mode BatchNorm normalizes with batch
  statistics, so the shared fake forward has the values of both
  alternating ones. Update 3 is rebuilt from the fake batch's statistics
  b: update 1 = k·r0 + (1−k)·b, so update 3 = k·update 2 + (update 1 −
  k·r0), with the retain factor k = 1 − ``ops/norm.py`` ``MOMENTUM``
  (the JAX package hardcodes 0.9 there, :156).

A discriminator that carries spectral power-iteration state (an
``SNConv2d``) always takes the alternating path, whose three forwards
iterate u and v three times as the reference does (:190).

The metrics (seg loss, foreground IoU and Dice, perceptual, adversarial
and D loss) stay on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ssunet_gan_tpu_torch.ops import norm
from ssunet_gan_tpu_torch.ops.losses import bce_with_logits_loss
from ssunet_gan_tpu_torch.ops.metrics import dice_coef, foreground_slice, iou_score
from ssunet_gan_tpu_torch.ops.spectral import SNConv2d
from ssunet_gan_tpu_torch.train.optim import set_lr

ALPHA = 1e-4  # content (MSE) weight, train_seg_gan.py:172
BETA = 1e-3  # adversarial weight, train_seg_gan.py:173
GRAD_CLIP = 0.8  # train_seg_gan.py:174

_JOINT_GAN = True


def set_joint_gan(enabled: bool) -> None:
    """The joint formulation (True, the default) or the alternating one."""
    global _JOINT_GAN
    _JOINT_GAN = bool(enabled)


def joint_gan_for(discriminator: torch.nn.Module) -> bool:
    """Whether a step with ``discriminator`` takes the joint formulation:
    the mode on and no spectral state in D."""
    return _JOINT_GAN and not any(isinstance(m, SNConv2d) for m in discriminator.modules())


def _params(module: torch.nn.Module) -> List[torch.nn.Parameter]:
    return [p for p in module.parameters() if p.requires_grad]


def _running(bns) -> List[torch.Tensor]:
    return [t.clone() for m in bns for t in (m.running_mean, m.running_var)]


@torch.no_grad()
def _third_update(bns, r0: List[torch.Tensor], u1: List[torch.Tensor]) -> None:
    """running ← k·running + (u1 − k·r0), k = 1 − MOMENTUM: the fake batch's
    update after the real one's, from the statistics it left in u1."""
    keep = 1.0 - norm.MOMENTUM
    bufs = [t for m in bns for t in (m.running_mean, m.running_var)]
    for t, a, b in zip(bufs, r0, u1):
        t.mul_(keep).add_(b - keep * a)


def gan_gradients(generator: torch.nn.Module, discriminator: torch.nn.Module,
                  seg_loss_fn: Callable, image: torch.Tensor, target: torch.Tensor,
                  num_classes: int, alpha: float = ALPHA, beta: float = BETA,
                  grad_clip: float = GRAD_CLIP) -> Dict[str, torch.Tensor]:
    """Both networks' gradients of one step, clamped to ±``grad_clip``, in
    their parameters' ``.grad``; D's running statistics moved three times.
    Both networks are left in training mode. Returns the metrics (device
    tensors)."""
    generator.train()
    discriminator.train()
    g_params, d_params = _params(generator), _params(discriminator)
    for p in g_params + d_params:
        p.grad = None
    g_out = generator(image)
    g_out = torch.where(torch.isnan(g_out), torch.zeros_like(g_out), g_out)
    seg_loss = seg_loss_fn(g_out, target)
    content = (g_out.float() - target.float()).square().mean()
    real = target.to(image.dtype)
    joint = joint_gan_for(discriminator)
    bns = [m for m in discriminator.modules() if isinstance(m, norm.BatchNorm)]
    r0 = _running(bns) if joint else None
    d_fake = discriminator(g_out)  # running-statistics update 1
    adv = bce_with_logits_loss(d_fake, torch.ones_like(d_fake))
    perceptual = seg_loss + alpha * content + beta * adv
    if joint:
        u1 = _running(bns)
        d_real = discriminator(real)  # update 2
        d_loss = (bce_with_logits_loss(d_fake, torch.zeros_like(d_fake))
                  + bce_with_logits_loss(d_real, torch.ones_like(d_real)))
        _third_update(bns, r0, u1)  # update 3, rebuilt
        d_loss.backward(inputs=d_params, retain_graph=True)
        perceptual.backward(inputs=g_params)
    else:
        perceptual.backward(inputs=g_params)
        d_real = discriminator(real)  # update 2
        d_fake = discriminator(g_out.detach())  # update 3
        d_loss = (bce_with_logits_loss(d_fake, torch.zeros_like(d_fake))
                  + bce_with_logits_loss(d_real, torch.ones_like(d_real)))
        d_loss.backward(inputs=d_params)
    grads = [p.grad for p in g_params + d_params if p.grad is not None]
    torch._foreach_clamp_min_(grads, -grad_clip)
    torch._foreach_clamp_max_(grads, grad_clip)
    with torch.no_grad():
        out_m = foreground_slice(g_out, num_classes)
        tar_m = foreground_slice(target, num_classes)
        return {"loss": seg_loss.detach(), "iou": iou_score(out_m, tar_m),
                "dice": dice_coef(out_m, tar_m), "perceptual_loss": perceptual.detach(),
                "adv_loss": adv.detach(), "d_loss": d_loss.detach()}


def make_gan_train_step(generator: torch.nn.Module, discriminator: torch.nn.Module,
                        seg_loss_fn: Callable, opt_g: torch.optim.Optimizer,
                        opt_d: torch.optim.Optimizer, num_classes: int,
                        alpha: float = ALPHA, beta: float = BETA,
                        grad_clip: float = GRAD_CLIP, mesh=None
                        ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(image, target, lr) -> metrics`` over NHWC batches on the
    networks' device: :func:`gan_gradients`, then both optimizers step at
    ``lr``. ``mesh`` (the data-parallel step) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "the data-parallel GAN step (mesh=) is not ported yet; see ROADMAP.md")

    def step(image: torch.Tensor, target: torch.Tensor, lr: float):
        metrics = gan_gradients(generator, discriminator, seg_loss_fn, image, target,
                                num_classes, alpha, beta, grad_clip)
        for opt in (opt_g, opt_d):
            set_lr(opt, lr)
            opt.step()
        return metrics

    return step
